"""Batched QOA and WAV encode — N independent streams encode in lockstep on
the device.

WAV (``encode_wav_batch``): every stream's float samples become one row of
a single device call that quantizes (exact round-half-up, or TPDF dither)
and packs the payload bytes (K10), byte-exact against the single-stream
WavEncoder.

The reference encodes one stream at a time (QOAEncoder qoa.d:538).  Here
QOA's brute-force 16-scalefactor LMS search (qoa.d:345-383) runs over a
lane axis of (stream, frame, channel) or (stream, channel): one kernel
launch per chunk of lanes serves every stream.

``parallel_frames=False`` is byte-exact vs the streaming single-stream
QoaEncoder (tested): full frames run in lockstep; each stream's final
partial frame finishes with a per-stream call of the same kernel.

``mesh=`` (``parallel/mesh.py``) splits the independent lanes of each
device call into contiguous shards over the mesh's 'data' devices, one
launch a shard; the bytes equal the unsharded call's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import AudioSampleFormat, EncodingOptions
from ..device import device_of
from ..models import qoa as qoa_mod
from ..models.wav import _FMT_INFO, wav_header
from ..models.qoa import (QOA_FRAME_LEN, QOA_LMS_LEN, QOA_MAGIC,
                          _frame_size as _qoa_frame_size)
from ..ops import lms as lms_ops
from ..ops import pcm as pcm_ops
from ..ops.lms import QOA_SLICE_LEN, QOA_SLICES_PER_FRAME
from .window import _prefetch, _to_numpy
from .mesh import mesh_device

#: lanes per device call of the frame-parallel encoder
QOA_CHUNK_LANES = 2048


def encode_qoa_batch(pcms: Sequence[np.ndarray], sample_rate: int,
                     parallel_frames: bool = True, device="cuda",
                     stats: dict = None, mesh=None) -> List[bytes]:
    """Encode N streams of float PCM [(frames, ch)] to QOA byte streams.

    Channel counts may differ per stream; lanes = Σ channels.  ``device``
    is where the search runs: "cuda" (the default) raises when there is no
    GPU; "cpu" runs the kernel's plain PyTorch twin.

    ``parallel_frames=True`` (the default): QOA stores the pre-frame LMS
    state IN each frame header (qoa.d:315-326), so any per-frame starting
    state yields a valid stream.  Every frame starts from the encoder's
    initial state, which makes all frames independent lanes ([streams x
    frames x channels] instead of [streams x channels]), trading a fraction
    of a dB of SNR at each frame boundary (the LMS re-converges within a
    few slices) for a lane count that fills the card.  Each stream's FIRST
    frame is byte-identical to the sequential encoder's.  Pass
    ``parallel_frames=False`` for byte-exact parity with the streaming
    single-stream QoaEncoder.

    If ``stats`` (a dict) is given, ``windows`` (device calls) is recorded,
    and with ``parallel_frames=True`` also ``h2d_bytes`` and ``d2h_bytes``.

    ``mesh`` (a ``parallel.mesh.Mesh``): with ``parallel_frames=True`` each
    chunk's frame lanes split into contiguous shards over the mesh's 'data'
    devices, one search launch (a window) a shard, and the word planes join
    in lane order: the bytes equal the unsharded encode's.  ``device`` then
    defaults to the mesh's first device, and another one raises
    ValueError; the sequential layout runs on that device, as the JAX
    package's runs unsharded.
    """
    if mesh is not None:
        device = mesh_device(device, mesh)
    dev = device_of(device)
    devices = [dev] if mesh is None else mesh.data_devices
    n = len(pcms)
    chans = [p.shape[1] for p in pcms]
    lengths = [p.shape[0] for p in pcms]
    if stats is not None:
        stats["windows"] = 0

    # quantize float input exactly like QoaEncoder.write, on the host
    def _q(p):
        q = pcm_ops.quantize_float_to_int_np(
            np.ascontiguousarray(p).reshape(-1), "s16")
        return q.reshape(-1, p.shape[1])

    if parallel_frames:
        # lazy per-stream quantize: stream i quantizes when its first
        # chunk packs, so the host CPU cost overlaps earlier chunks'
        # upload and search instead of preceding all device work
        class _LazyS16:
            __slots__ = ("cache",)

            def __init__(self):
                self.cache = {}

            def __getitem__(self, i):
                a = self.cache.get(i)
                if a is None:
                    a = self.cache[i] = _q(pcms[i])
                return a

        return _encode_qoa_frames_parallel(
            _LazyS16(), chans, lengths, sample_rate, devices, stats)

    def search(lanes, hist, wts, frame_len):
        out = lms_ops.qoa_encode_frame_scan(
            torch.from_numpy(lanes).to(dev), torch.from_numpy(hist).to(dev),
            torch.from_numpy(wts).to(dev), frame_len)
        if stats is not None:
            stats["windows"] += 1
        return [t.cpu().numpy() for t in out]

    s16 = [_q(p) for p in pcms]
    L = sum(chans)
    lane_of = np.cumsum([0] + chans)
    hist = np.zeros((L, QOA_LMS_LEN), np.int32)
    wts = np.tile(lms_ops.INITIAL_WEIGHTS, (L, 1))
    outs = [bytearray(b"\0" * 8) for _ in range(n)]

    n_full = [ln // QOA_FRAME_LEN for ln in lengths]
    W = max(n_full) if n_full else 0
    for w in range(W):
        lanes = np.zeros((L, QOA_FRAME_LEN), np.int32)
        active = np.zeros(n, bool)
        for i in range(n):
            if w < n_full[i]:
                active[i] = True
                seg = s16[i][w * QOA_FRAME_LEN : (w + 1) * QOA_FRAME_LEN]
                lanes[lane_of[i] : lane_of[i + 1]] = seg.T
        sf, codes, h2, w2 = search(lanes, hist, wts, QOA_FRAME_LEN)
        for i in range(n):
            if not active[i]:
                continue
            sl = slice(lane_of[i], lane_of[i + 1])
            outs[i] += qoa_mod.pack_qoa_frame(
                sample_rate, chans[i], QOA_FRAME_LEN,
                hist[sl], wts[sl], sf[sl], codes[sl])
        upd = np.repeat(active, chans)
        hist[upd] = h2[upd]
        wts[upd] = w2[upd]

    # final partial frames: each finishes with its own call
    for i in range(n):
        rem = lengths[i] - n_full[i] * QOA_FRAME_LEN
        if rem <= 0:
            continue
        sl = slice(lane_of[i], lane_of[i + 1])
        lanes = np.zeros((chans[i], QOA_FRAME_LEN), np.int32)
        lanes[:, :rem] = s16[i][n_full[i] * QOA_FRAME_LEN :].T
        sf, codes, _, _ = search(lanes, hist[sl], wts[sl], rem)
        outs[i] += qoa_mod.pack_qoa_frame(
            sample_rate, chans[i], rem, hist[sl], wts[sl], sf, codes)

    for i in range(n):
        outs[i][0:8] = ((QOA_MAGIC << 32) | lengths[i]).to_bytes(8, "big")
    return [bytes(o) for o in outs]


def _encode_qoa_frames_parallel(s16, chans, lengths, sample_rate, devices,
                                stats=None) -> List[bytes]:
    """Frame-parallel QOA encode: every (stream, frame, channel) is an
    independent lane of a lockstep device call, each frame starting from
    the encoder's initial LMS state {0,0,-2^13,2^14} (qoa.d:568-581) which
    is written into its header.  Per-lane frame lengths let final partial
    frames ride the same call.

    Each chunk of <= QOA_CHUNK_LANES lanes (cut at span boundaries, so a
    frame's channels stay together) uploads int16 rows, launches the
    search, and starts the download of its [lanes, 256] word plane through
    a pinned copy; the host then builds the next chunk's rows while the
    card works.  A chunk's lanes split into contiguous shards over
    `devices`, one upload, search and download a shard."""
    n = len(chans)
    # lane layout: frame-major per stream, channel-minor
    spans = []  # (stream, frame_idx, frame_samples, lane_start)
    by_stream = [[] for _ in range(n)]
    lane = 0
    for i in range(n):
        nf = -(-lengths[i] // QOA_FRAME_LEN) if lengths[i] else 0
        for f in range(nf):
            fs = min(QOA_FRAME_LEN, lengths[i] - f * QOA_FRAME_LEN)
            spans.append((i, f, fs, lane))
            by_stream[i].append((fs, lane))
            lane += chans[i]
    L = lane
    words_all = np.zeros((L, QOA_SLICES_PER_FRAME), np.uint64)
    h2d = d2h = 0
    fetches = []  # (c0, c1, word plane or its host copy)
    si = 0
    while si < len(spans):
        c0 = spans[si][3]
        sj = si
        while sj < len(spans) and \
                spans[sj][3] + chans[spans[sj][0]] - c0 <= QOA_CHUNK_LANES:
            sj += 1
        sj = max(sj, si + 1)
        last = spans[sj - 1]
        c1 = last[3] + chans[last[0]]
        # int16 rows halve the upload (values are s16 by construction)
        rows = np.zeros((c1 - c0, QOA_FRAME_LEN), np.int16)
        flen = np.zeros(c1 - c0, np.int32)
        for (i, f, fs, ls) in spans[si:sj]:
            seg = s16[i][f * QOA_FRAME_LEN : f * QOA_FRAME_LEN + fs]
            rows[ls - c0 : ls - c0 + chans[i], :fs] = seg.T
            flen[ls - c0 : ls - c0 + chans[i]] = fs
        h2d += rows.nbytes + flen.nbytes
        for dev, idx in zip(devices, np.array_split(np.arange(c1 - c0),
                                                    len(devices))):
            if not idx.size:
                continue
            a, b = int(idx[0]), int(idx[-1]) + 1
            words = lms_ops.qoa_encode_frame_words(
                torch.from_numpy(rows[a:b]).to(dev),
                torch.from_numpy(flen[a:b]).to(dev))
            fetches.append((c0 + a, c0 + b, _prefetch(words, False)))
            if stats is not None:
                stats["windows"] += 1
        si = sj
    for (c0, c1, words) in fetches:
        arr = _to_numpy(words)
        d2h += arr.nbytes
        # the int64 plane holds the u64 words' bits
        words_all[c0:c1] = arr.view(np.uint64)
    if stats is not None:
        stats["h2d_bytes"] = h2d
        stats["d2h_bytes"] = d2h
    # constant pre-frame LMS state words (history 0, weights
    # {0,0,-2^13,2^14}) — the frame-parallel contract writes the initial
    # state into every frame header (qoa.d:315-326)
    state_words = (b"\x00" * 8
                   + b"\x00\x00\x00\x00\xe0\x00\x40\x00")
    outs = []
    for i in range(n):
        ch = chans[i]
        parts = [((QOA_MAGIC << 32) | lengths[i]).to_bytes(8, "big")]
        st = state_words * ch
        for (fs, ls) in by_stream[i]:
            ns = (fs + QOA_SLICE_LEN - 1) // QOA_SLICE_LEN
            f_size = _qoa_frame_size(ch, ns)
            hdr = ((ch << 56) | (sample_rate << 32) | (fs << 16) | f_size)
            # interleaved slice-major, channel-minor, as big-endian u64s
            w = words_all[ls : ls + ch, :ns].T.astype(">u8")
            parts.append(hdr.to_bytes(8, "big") + st + w.tobytes())
        outs.append(b"".join(parts))
    return outs


def encode_wav_batch(pcms: Sequence[np.ndarray], sample_rate: int,
                     options: EncodingOptions = None, device="cuda",
                     stats: dict = None, mesh=None) -> List[bytes]:
    """Encode N float streams [(frames, ch)] to WAV byte streams.

    The quantize (TPDF dither or exact round-half-up) and the byte pack run
    as ONE [streams, n] call on ``device``: "cuda" (the default) runs K10
    and raises when there is no GPU; "cpu" runs its plain PyTorch twin.
    The dither noise depends on the seed and the sample's position only,
    and each stream's first write uses ``options.dither_seed``, so each
    stream's bytes equal the single-stream WavEncoder's.  fp32 and fp64
    pass through on the host.

    If ``stats`` (a dict) is given, ``windows`` (device calls),
    ``h2d_bytes`` and ``d2h_bytes`` are recorded.

    ``mesh`` (a ``parallel.mesh.Mesh``) splits the streams' rows over the
    mesh's 'data' devices, one K10 launch a shard
    (``ops.pcm.quantize_pack_rows``): the bytes equal the unsharded
    encode's.  ``device`` then defaults to the mesh's first device, and
    another one raises ValueError.
    """
    options = options or EncodingOptions()
    fmt = options.sample_format
    sample_size, wformat, qkind = _FMT_INFO[fmt]
    n = len(pcms)
    if mesh is not None:
        device = mesh_device(device, mesh)
    dev = device_of(device)
    if stats is not None:
        stats.update(windows=0, h2d_bytes=0, d2h_bytes=0)
    if fmt in (AudioSampleFormat.fp32, AudioSampleFormat.fp64):
        kindstr = "<f4" if fmt == AudioSampleFormat.fp32 else "<f8"
        bodies = [np.ascontiguousarray(p).reshape(-1).astype(kindstr)
                  .tobytes() for p in pcms]
    else:
        flats = [np.ascontiguousarray(p, np.float32).reshape(-1)
                 for p in pcms]
        lens = [f.shape[0] for f in flats]
        maxn = max(lens) if lens else 0
        rows = np.zeros((n, maxn), np.float32)
        for i, f in enumerate(flats):
            rows[i, : lens[i]] = f
        seeds = np.full(n, options.dither_seed & 0xFFFFFFFF, np.int64)
        # quantize and pack on the device: the download is the payload
        # bytes (3 a sample for s24), not an int32 plane
        bodies = pcm_ops.quantize_pack_rows(
            rows, lens, seeds, qkind, sample_size,
            dither=options.enable_dither, device=dev, mesh=mesh)
        if stats is not None:
            n_dev = 1 if mesh is None else mesh.shape["data"]
            stats.update(windows=min(n, n_dev),
                         h2d_bytes=rows.nbytes + seeds.nbytes,
                         d2h_bytes=rows.size * sample_size)
    return [wav_header(wformat, p.shape[1], sample_rate, sample_size,
                       len(body)) + body for p, body in zip(pcms, bodies)]
