"""The QOA lockstep group."""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from ...models.qoa import _F32_RECIP, QoaDecoder
from ...ops import lms as lms_ops
from ..window import GroupContext, _PendingGroup, _prefetch, _upload

#: QOA (frame, channel) lanes per device call (bounds upload and memory)
QOA_WINDOW_LANES = 8192


def group_key(d):
    """The channels of a QOA lane."""
    return d.channels if isinstance(d, QoaDecoder) else None


def decode(ctx: GroupContext, decs: List[QoaDecoder], nch: int):
    """QOA batching: LMS state is in-band per frame (qoa.d:488-503), so
    every frame of every stream is an independent lane — the whole
    group decodes as a few large [lanes, 5120] device calls.  Slice
    payloads ship as int8 (3-bit codes, 4-bit scalefactors) and the
    kernel dequantizes them as it decodes."""
    stats = ctx.stats
    FULL_S = lms_ops.QOA_SLICES_PER_FRAME
    metas = []   # (stream index, f_samples)
    H, Wt, SF, CD = [], [], [], []
    with stats.stage("parse", "qoa", cpu=True):
        for bi, d in enumerate(decs):
            pos = d._byte_pos
            got = 0
            while True:
                p = d._parse_frame_at(pos)
                if p is None:
                    break
                h, w, sf, codes, f_samples, f_size = p
                S = sf.shape[1]
                if S < FULL_S:
                    sf = np.pad(sf, ((0, 0), (0, FULL_S - S)))
                    codes = np.pad(codes,
                                   ((0, 0), (0, FULL_S - S), (0, 0)))
                H.append(h)
                Wt.append(w)
                SF.append(sf.astype(np.int8))
                CD.append(codes.astype(np.int8))
                metas.append((bi, f_samples))
                pos += f_size
                got += f_samples
            d._byte_pos = pos
            d._pos += got
        if metas:
            hist = np.concatenate(H)
            wts = np.concatenate(Wt)
            sf8 = np.concatenate(SF)
            cd8 = np.concatenate(CD)
    pending = []  # (device out [Lc, 5120] int32 or its host copy, Lc)
    L = hist.shape[0] if metas else 0
    for c0 in range(0, L, QOA_WINDOW_LANES):
        sl = slice(c0, min(L, c0 + QOA_WINDOW_LANES))
        arrays = (hist[sl], wts[sl], sf8[sl], cd8[sl])
        with stats.stage("enqueue", "qoa"):
            out = lms_ops.decode_slices(*_upload(ctx.device, *arrays))
            pending.append((_prefetch(out, ctx.to_device), sl.stop - c0))
        stats.window("qoa", sum(a.nbytes for a in arrays))
    # QOA decoders count decoded frames in _pos
    seconds = sum(d._pos / max(1, d.sample_rate) for d in decs)
    return _PendingGroup(pending, functools.partial(
        _pcm, ctx, decs, metas, pending, nch), seconds)


def _pcm(ctx, decs, metas, pending, nch):
    chunks = [arr[:n] for arr, n in ctx.stats.fetched(pending)]
    outputs = [[] for _ in decs]
    flat = np.concatenate(chunks) if chunks else \
        np.zeros((0, lms_ops.QOA_FRAME_LEN), np.int32)
    for k, (bi, f_samples) in enumerate(metas):
        lanes = flat[k * nch: (k + 1) * nch]
        outputs[bi].append(lanes[:, :f_samples].T.astype(np.int16))
    result = []
    for bi, d in enumerate(decs):
        s16 = (np.concatenate(outputs[bi]) if outputs[bi]
               else np.zeros((0, nch), np.int16))
        s16 = s16[: d.length_frames]
        # same float conversion as the facade (qoa.d:825-834)
        result.append(s16.astype(np.float32) * _F32_RECIP)
    return result
