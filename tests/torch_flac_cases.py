"""FLAC device-Rice inputs shared by the CPU tests (the port's twin against
JAX) and the card tests (the CUDA kernel against the twin): golden streams
of every subframe mode, their frames by the C sync index, corrupt frames,
and random-bit lanes, laid into a frame pool of a fixed shape.  Nothing here
imports JAX."""

import numpy as np

from audio_formats_torch import models
from audio_formats_torch.host import native
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.ops import flac_rice

from golden import flac_ref

#: the subframe cases of tests/test_flac_device_rice.py, as (name, kwargs of
#: make_stream)
CASES = [
    ("fixed2", {}),
    ("lpc8", {"mode": "lpc8"}),
    ("constant", {"mode": "constant"}),
    ("verbatim", {"mode": "verbatim"}),
    ("wasted", {"mode": "lpc8", "wasted": 3}),
    ("escape", {"escape_bits": 14}),
    ("rice2", {"rice2": True}),
    ("midside", {"mode": "lpc8", "stereo": "mid_side"}),
    ("leftside", {"stereo": "left_side"}),
    ("bs192", {"bsz": 192, "po": 1}),
]


def make_stream(rng, bps=16, C=2, mode="fixed2", stereo="independent",
                bsz=1024, n=4096, wasted=0, escape_bits=None, rice2=False,
                po=2):
    """A golden FLAC stream (tests/test_flac_device_rice.py's _make)."""
    if mode == "constant":
        x = np.full((n, C), 137, np.int64)
    else:
        x = (2000 * np.sin(np.arange(n * C).reshape(n, C) / 7.0)
             + 300 * rng.standard_normal((n, C))).astype(np.int64)
    x = np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1)
    if wasted:
        x = (x >> wasted) << wasted
    kw = dict(partition_order=po, rice2=rice2)
    if escape_bits is not None:
        kw["escape_bits"] = escape_bits
    if wasted:
        kw["wasted"] = wasted
    return flac_ref.build_flac(x, 44100, bps, block_size=bsz,
                               stereo_mode=stereo, modes=[mode] * C, **kw)


def index(data):
    """Each frame of a FLAC stream by the C sync index: (view, [(byte_off,
    size, rel_bit, bs, chass, bps), ...])."""
    d = models.probe_all(MemorySource(data), "cpu")
    view = d._view
    st = np.array([-1, 0, d._cur_bit // 8], np.int64)
    n, offs, dbits, bs, ca, bps = native.flac_sync_index(
        native.get_lib(), view, int(st[2]), d.bits_per_sample, d.channels,
        65535, 64, st)
    sizes = np.append(np.diff(offs), len(view) - offs[-1])
    return view, [(int(offs[i]), int(sizes[i]), int(dbits[i] - offs[i] * 8),
                   int(bs[i]), int(ca[i]), int(bps[i])) for i in range(n)]


def stream_frames(data):
    """A stream's frames as (view, byte_off, size, rel_bit, bs, chass,
    bps)."""
    view, idx = index(data)
    return [(view,) + f for f in idx]


def case_frames(name, kw):
    """One subframe case's frames, its stream made from a seed of its
    name."""
    rng = np.random.default_rng(len(name))
    return stream_frames(make_stream(rng, **dict({"mode": "fixed2"}, **kw)))


def frames_24bit():
    rng = np.random.default_rng(24)
    return (stream_frames(make_stream(rng, bps=24, mode="lpc8",
                                      stereo="left_side"))
            + stream_frames(make_stream(rng, bps=24, mode="fixed2"))
            + stream_frames(make_stream(rng, bps=24, mode="verbatim",
                                        n=1500)))


def corrupt_frames(seed, how):
    """The frames of three clean streams, indexed clean, then damaged after
    the frame header: byte flips ("flips"), a zeroed 64-byte run
    ("zeroed"), a random first subframe header byte ("headers"), or the
    frame cut short in the pool ("cut")."""
    rng = np.random.default_rng(seed)
    frames = []
    for kw in ({"mode": "fixed2"}, {"mode": "lpc8", "stereo": "mid_side"},
               {"escape_bits": 14, "rice2": True}):
        view, idx = index(make_stream(rng, **kw))
        buf = bytearray(view)
        for off, size, rel, *_ in idx:
            body = off + rel // 8 + 1
            if how == "flips":
                for p in rng.integers(body, off + size, 6):
                    buf[p] ^= int(rng.integers(1, 256))
            elif how == "zeroed":
                z = int(rng.integers(body, off + size - 64))
                buf[z: z + 64] = bytes(64)
            elif how == "headers":
                buf[body - 1] = int(rng.integers(0, 256))
        view = bytes(buf)
        for off, size, *rest in idx:
            if how == "cut":
                size = int(rng.integers(1, size))
            frames.append((view, off, size, *rest))
    return frames


def lanes(frames, L, NPOOL):
    """Frames → the pool [NPOOL, 64] uint32 and the lane arrays (start_bits,
    bs, bps0, chass, int32), padded to L lanes (pad lanes: bs 0).  A pool
    too small for its frames holds what fits, as the builder cuts it."""
    assert len(frames) <= L
    pool, base_bits = flac_rice.build_frame_pool([f[:3] for f in frames],
                                                 NPOOL)
    pool = np.concatenate(
        [pool, np.zeros((NPOOL - pool.shape[0], 64), np.uint32)])
    n = len(frames)
    sb = np.zeros(L, np.int32)
    sb[:n] = base_bits + np.array([f[3] for f in frames], np.int64)
    bs = np.zeros(L, np.int32)
    bs[:n] = [f[4] for f in frames]
    ca = np.zeros(L, np.int32)
    ca[:n] = [f[5] for f in frames]
    bps = np.full(L, 16, np.int32)
    bps[:n] = [f[6] for f in frames]
    return pool, sb, bs, bps, ca


def random_lanes(seed, L, NPOOL, NSAMP):
    """Random pool words with zero runs, subframe header bytes of every type
    planted at most lanes' starts, start bits anywhere in and past the
    pool, random block sizes (some above NSAMP), sample bits and channel
    assignments: (pool, start_bits, bs, bps0, chass)."""
    rng = np.random.default_rng(100 + seed)
    flat = rng.integers(0, 1 << 32, (NPOOL - 2) * 64, dtype=np.uint64)\
        .astype(np.uint32)
    m = rng.random(flat.shape)
    flat[m < 0.3] = 0
    part = (m >= 0.3) & (m < 0.5)
    flat[part] &= rng.integers(0, 1 << 32, int(part.sum()),
                               dtype=np.uint64).astype(np.uint32)
    sb = rng.integers(-40, NPOOL * 2048 + 500, L).astype(np.int32)
    bits = np.unpackbits(flat.astype(">u4").view(np.uint8))
    for p in sb.tolist():
        if 0 <= p < bits.size - 8 and rng.random() < 0.8:
            t = int(rng.choice([0, 1, 8, 9, 10, 11, 12, 13, 3, 16,
                                32 + int(rng.integers(0, 32))]))
            hdr = (t << 1) | int(rng.random() < 0.2)
            bits[p: p + 8] = np.unpackbits(np.array([hdr], np.uint8))
    flat = np.packbits(bits).view(">u4").astype(np.uint32)
    pool = np.concatenate([flat.reshape(-1, 64),
                           np.zeros((2, 64), np.uint32)])
    bs = rng.integers(0, NSAMP + 40, L).astype(np.int32)
    bps = rng.integers(4, 33, L).astype(np.int32)
    ca = rng.integers(0, 11, L).astype(np.int32)
    return pool, sb, bs, bps, ca
