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


# ------------------------------------------------------------ edge lanes
#: the edge cases of the kernel's buffer, ring, partition selects and slow
#: path, each one 32-lane dispatch (a warp) of hand-written subframes
EDGE_CASES = ("unary_block", "unary_wrap", "escape_0_31", "po_0_8",
              "ragged_stops", "clamp_back", "zero_tail")

#: bits a pool block; the wrap of a staging ring of 1, 2 or 4 blocks lies
#: on a multiple of 4 blocks
_BLK_BITS = 64 * 32
_WRAP_BITS = 4 * _BLK_BITS


class _Bits:
    """A big-endian bit writer."""

    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(int(v) >> i) & 1 for i in range(n - 1, -1, -1)]

    def rice(self, v, k):
        ui = (int(v) << 1) ^ (int(v) >> 63)
        q = ui >> k
        self.bits += [0] * q + [1]
        self.put(ui & ((1 << k) - 1), k)


def _subframe(w, rng, bs, order, po, parts, special=None):
    """A fixed-predictor subframe of 16-bit samples (order 0..4) with
    partition order po; parts(i) gives partition i's (param, width or None,
    values): a Rice parameter, or the escape with a raw width.  special:
    (partition, sample index, value, k) of a sample whose bit offset the
    writer returns (its unary run's first bit), else None."""
    w.put((8 + order) << 1, 8)
    for _ in range(order):
        w.put(int(rng.integers(-2000, 2000)) & 0xFFFF, 16)
    w.put(0, 2)
    w.put(po, 4)
    mark = None
    for i in range(1 << po):
        n = (bs >> po) - (order if i == 0 else 0)
        k, width, values = parts(i, n)
        if width is None:
            w.put(k, 4)
            for j, v in enumerate(values):
                if special and (i, j) == special[:2]:
                    mark = len(w.bits)
                w.rice(v, k)
        else:
            w.put(15, 4)
            w.put(width, 5)
            for v in values:
                w.put(int(v) & ((1 << width) - 1), width)
    return mark


def _rice_part(rng, k):
    def parts(i, n):
        return k, None, rng.integers(-(1 << k), 1 << k, n)
    return parts


def _lane(rng, bs, po=2, k=4, order=2, parts=None, special=None):
    """Two independent channels of one lane: (bits, the special sample's
    bit offset or None)."""
    w = _Bits()
    mark = None
    for ci in range(2):
        p = parts or _rice_part(rng, k)
        m = _subframe(w, rng, bs, order, po, p,
                      special if ci == 1 else None)
        mark = m if m is not None else mark
    return w.bits, mark


def _unary_parts(rng, q):
    """Rice k = 1 partitions whose partition 1, sample 5, is a unary run
    of q zeros."""
    def parts(i, n):
        v = rng.integers(-2, 2, n)
        if i == 1:
            ui = (q << 1) | 1
            v[5] = (ui >> 1) ^ -(ui & 1)
        return 1, None, v
    return parts


def edge_lanes(name, L=32, NPOOL=320):
    """One edge case as a 32-lane dispatch (pool [NPOOL, 64] uint32,
    start_bits, bs, bps0, chass), made from a seed of its name; lanes the
    case does not need carry ordinary Rice subframes of mixed partition
    orders, so every warp mixes them.

    unary_block:  unary runs of 60-63 zeros across a block boundary;
    unary_wrap:   the same across a multiple of four blocks (the wrap of a
                  staging ring of 1, 2 or 4 blocks);
    escape_0_31:  escape partitions of raw widths 0 and 31 beside Rice ones;
    po_0_8:       partition orders 0 to 8 side by side;
    ragged_stops: block sizes from 1 to 1024, lanes stopping anywhere;
    clamp_back:   raw 31-bit lanes that run past the pool's end, their
                  cursors moved back by the clamp every 8 samples;
    zero_tail:    Rice lanes that run into the pool's last, zero blocks."""
    rng = np.random.default_rng([len(name), sum(map(ord, name))])
    lanes = []   # (bits, bs, target bit of the mark or None, mark)
    for i in range(L):
        bs, po, spec, parts, order = 1024, int(rng.integers(0, 5)), None, \
            None, 2
        if name in ("unary_block", "unary_wrap") and i % 3 == 0:
            q = 60 + i // 3 % 4
            parts, po, spec = _unary_parts(rng, q), 3, (1, 5)
        elif name == "escape_0_31" and i % 2 == 0:
            widths = (0, 31, None, 31) if i % 4 == 0 else (31, None, 0, 7)

            def parts(p, n, widths=widths):
                wd = widths[p % 4]
                if wd is None:
                    return 3, None, rng.integers(-8, 8, n)
                v = rng.integers(-(1 << 30), 1 << 30, n) if wd == 31 else \
                    rng.integers(-(1 << (wd - 1)), 1 << (wd - 1), n) if wd \
                    else np.zeros(n, np.int64)
                return 0, wd, v
            bs, po = 256, 2
        elif name == "po_0_8":
            po = i % 9
        elif name == "ragged_stops":
            bs = int((1, 2, 31, 100, 513, 777, 1000, 1024)[i % 8])
            po, order = 0, min(2, bs - 1)
        elif name == "clamp_back" and i in (5, 6):
            def parts(p, n):
                return 0, 31, rng.integers(-(1 << 30), 1 << 30, n)
            bs, po = 256, 0
        bits, mark = _lane(rng, bs, po, int(rng.integers(2, 7)), order, parts,
                           (spec[0], spec[1]) if spec else None)
        lanes.append((bits, bs, mark))
    # lay the lanes out; the marked unary runs straddle their boundary
    nbits = (NPOOL - 2) * _BLK_BITS
    pool_bits = np.zeros(NPOOL * _BLK_BITS, np.uint8)
    sb = np.zeros(L, np.int32)
    cur = 0
    tail = {"clamp_back": (5, 6), "zero_tail": (9, 10)}.get(name, ())
    for i, (bits, bs, mark) in enumerate(lanes):
        if i in tail:
            continue
        start = cur + int(rng.integers(0, 32))
        if mark is not None:
            step = _WRAP_BITS if name == "unary_wrap" else _BLK_BITS
            edge = -(-(start + mark + 64) // step) * step
            if name == "unary_block" and (edge // _BLK_BITS) % 4 == 0:
                edge += _BLK_BITS
            start = edge - mark - 30
        pool_bits[start: start + len(bits)] = bits
        sb[i] = start
        cur = -(-(start + len(bits)) // _BLK_BITS) * _BLK_BITS
    assert cur <= nbits - 4 * _BLK_BITS, "edge lanes overflow the pool"
    # the tail lanes start in the pool's last real block and run on
    for j, i in enumerate(tail):
        bits = lanes[i][0]
        start = nbits - 1500 + 700 * j
        n = min(len(bits), nbits - start)
        pool_bits[start: start + n] = bits[:n]
        sb[i] = start
    pool = np.packbits(pool_bits).view(">u4").astype(np.uint32)
    bs = np.array([x[1] for x in lanes], np.int32)
    return (pool.reshape(NPOOL, 64), sb, bs, np.full(L, 16, np.int32),
            np.ones(L, np.int32))
