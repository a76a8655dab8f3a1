"""The FLAC lockstep group over the packed wire, and what both FLAC
wires share (the device-Rice wire is ``flac_rice.py``)."""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List

import numpy as np
import torch

from ... import trace
from ...host import native as _native
from ...models.flac import FlacDecoder
from ...ops import lpc as lpc_ops
from ..window import (GroupContext, WindowLoop, _lane_bytes, _PendingGroup,
                      _prefetch, _upload)

#: FLAC frames per device call
FLAC_WINDOW_FRAMES = 12

#: FLAC packed-residual width buckets
_FLAC_W_BUCKETS = (4, 6, 8, 10, 12, 14, 17, 20, 26, 32)
#: overflow plane row buckets for _flac_width_plan
_FLAC_OVF_BUCKETS = (128, 512, 2048)


def group_key(d):
    """The channels of a FLAC lane.  >16 bps lanes ride the exact LPC
    lanes and the full-width output; frames beyond 18 bits take the host
    path per frame inside the group."""
    return d.channels if isinstance(d, FlacDecoder) else None


def _seconds(decs) -> float:
    # FLAC decoders count decoded frames in _frame_pos
    return sum(d._frame_pos / max(1, d.sample_rate) for d in decs)


def _flac_width_plan(w_l, wmax: int, Ln: int, bs: int):
    """Pick the packed residual width for a FLAC window: (wb, Lb).

    Lb == 0: every row packs at wb (the max-width bucket, the plain
    layout).  Lb > 0: rows pack at the smaller wb and the few rows wider
    than wb ship in a separate [Lb, bs] plane (flac_merge_overflow).
    Minimizes uploaded words over the bucket grid."""
    def stride(w):
        return (bs * w + 31) // 32 + 1

    wb_plain = next((x for x in _FLAC_W_BUCKETS if wmax <= x), 32)
    plans = [(Ln * stride(wb_plain), wb_plain, 0)]
    for ws in _FLAC_W_BUCKETS:
        if ws >= wb_plain:
            break
        nov = int(np.count_nonzero(w_l > ws))
        for lb in _FLAC_OVF_BUCKETS:
            if nov + 1 <= lb:
                plans.append(
                    (Ln * stride(ws) + lb * stride(wb_plain), ws, lb))
                break
    _, wb, lb = min(plans)
    return wb, lb


def _flac_host_frame(residual, coeffs, order, shift, chan_assignment,
                     wasted, bps: int) -> np.ndarray:
    """One FLAC frame's channels through exact int64 LPC and the stereo
    stage on the host: [bs, channels] int32, left-justified."""
    samples = lpc_ops.flac_lpc_np(residual, coeffs, order, shift)\
        .astype(np.int32)
    out32 = lpc_ops.flac_post_stereo(
        torch.from_numpy(samples), int(chan_assignment),
        torch.from_numpy(np.ascontiguousarray(wasted, np.int32)),
        32 - bps).numpy()
    return out32.T


def _flac_pcm(decs, outputs, nch):
    """Each FLAC lane's frames, in order, cut to its stream length, as
    float32 PCM."""
    result = []
    for bi, d in enumerate(decs):
        if outputs[bi]:
            s32 = np.concatenate(
                [c[0] if isinstance(c, list) else c for c in outputs[bi]])
        else:
            s32 = np.zeros((0, nch), np.int32)
        if d.length_frames:
            s32 = s32[: d.length_frames]
        result.append((s32.astype(np.float64) * (1.0 / 2147483647.0))
                      .astype(np.float32))
    return result


def _frame_pcm(arr, si: int, bs: int) -> np.ndarray:
    """Frame `si` of a downloaded window: [bs, channels] int32,
    left-justified (an int16 window of <=16-bit lanes shifted back)."""
    if arr.dtype == np.int16:
        return arr[si, :, :bs].T.astype(np.int32) << 16
    return arr[si, :, :bs].T


def decode(ctx: GroupContext, decs: List[FlacDecoder], nch: int):
    """FLAC lockstep over the packed wire: the C host stage Rice-decodes
    W frames per lane, packs the residual rows at the window's bit
    width, and one upload plus one device chain (unpack → overflow
    merge → LPC kernel → stereo decorrelation) runs per window."""
    stats, device = ctx.stats, ctx.device
    B = len(decs)
    W = FLAC_WINDOW_FRAMES
    outputs = [[] for _ in range(B)]
    active = np.ones(B, dtype=bool)
    pending = []  # (dispatch future, [(slot, si, blocksize), ...])

    parse_lib = _native.get_lib()

    def _host_frame(d, bi, bs, ca, residual, coeffs, order, shift,
                    wasted):
        # beyond the 18-bit range of the device lanes: exact int64 on
        # the host
        outputs[bi].append(_flac_host_frame(
            residual, coeffs, order, shift, ca, wasted,
            d.bits_per_sample))

    # multi-lane C surface (af_flac_parse_window_multi): one C call
    # Rice-decodes a whole lane chunk into [B, W*ch, mb_g] batch rows.
    # Requires a uniform streaminfo max_block across the group (it
    # doubles as the C parser's validation bound and row stride) and a
    # bounded parse buffer; otherwise the per-lane path below runs.
    mb_vals = {d._max_block if 0 < d._max_block <= 65535 else 65535
               for d in decs}
    mb_g = mb_vals.pop() if len(mb_vals) == 1 else 0
    fmulti = (parse_lib is not None
              and mb_g > 0
              and B * W * nch * mb_g * 4 <= (512 << 20))
    if fmulti:
        fkeep, fptrs, flens = _lane_bytes(decs)
        fcb = np.zeros(B, np.int64)
        fbps = np.zeros(B, np.int32)
        for bi, d in enumerate(decs):
            fcb[bi] = d._cur_bit
            fbps[bi] = d.bits_per_sample
        # two residual buffers: the dispatch worker packs straight from
        # these rows (af_flac_pack_gather), so window k's rows must
        # survive until its pack completes while window k+1 parses into
        # the OTHER buffer; buf_futs[parity] gates reuse two windows later
        res_bufs = (np.empty((B, W * nch, mb_g), np.int32),
                    np.empty((B, W * nch, mb_g), np.int32))
        res_buf = res_bufs[0]
        cf_buf = np.empty((B, W * nch, 32), np.int32)
        ord_buf = np.empty((B, W * nch), np.int32)
        shf_buf = np.empty((B, W * nch), np.int32)
        was_buf = np.empty((B, W * nch), np.int32)
        bpsb_buf = np.empty((B, W * nch), np.int32)
        meta_buf = np.empty((B, W, 4), np.int64)
        nf_buf = np.zeros(B, np.int32)

    def _parse_chunk_fmulti(lanes):
        gated = []
        for bi in lanes:
            d = decs[bi]
            if d._frame_pos >= d.length_frames > 0:
                active[bi] = False
            else:
                gated.append(bi)
        if gated:
            _native.flac_parse_window_multi(
                parse_lib, gated, fptrs, flens, fcb, fbps,
                nch, mb_g, W, res_buf, cf_buf, ord_buf, shf_buf,
                was_buf, bpsb_buf, meta_buf, nf_buf)
        gset = set(gated)
        return [_post_lane_fmulti(bi) if bi in gset
                else ([], False, 0) for bi in lanes]

    def _take_frames(d, bi, n, meta_l, maxbps, res, cf, orr, sh, wa,
                     bpsr):
        """Walk one lane's parsed frames: wide frames decode on the
        host at once, the others claim an output slot at their parse
        position (so a window mixing both keeps frame order) and join
        the device window."""
        out, prog, mbs = [], False, 0
        dch = d.channels
        capped = False
        for f in range(n):
            if d._frame_pos >= d.length_frames > 0:
                capped = True
                break
            bs, ca = meta_l[f][0], meta_l[f][1]
            d._cur_bit = meta_l[f][3]
            rows = slice(f * dch, f * dch + dch)
            prog = True
            if maxbps[f] > 18:
                _host_frame(d, bi, bs, ca, res[rows, :bs], cf[rows],
                            orr[rows], sh[rows], wa[rows])
                d._frame_pos += bs
                continue
            slot = [None]
            outputs[bi].append(slot)
            out.append((bs, ca, res[rows, :bs], cf[rows], orr[rows],
                        sh[rows], wa[rows], bpsr[rows], slot))
            d._frame_pos += bs
            mbs = max(mbs, bs)
        if capped or n < W:
            active[bi] = False
        return out, prog, mbs

    def _post_lane_fmulti(bi):
        """Per-lane pass over the chunk-parsed batch rows (consumed by
        this window's assembly before the next window's parse
        overwrites them)."""
        d = decs[bi]
        n = int(nf_buf[bi])
        if n == 0:
            active[bi] = False
            return [], False, 0
        meta_l = meta_buf[bi, :n].tolist()
        maxbps = bpsb_buf[bi, : n * nch].reshape(n, nch)\
            .max(axis=1).tolist()
        got = _take_frames(d, bi, n, meta_l, maxbps, res_buf[bi],
                           cf_buf[bi], ord_buf[bi], shf_buf[bi],
                           was_buf[bi], bpsb_buf[bi])
        fcb[bi] = d._cur_bit  # the cap may take fewer frames than parsed
        return got

    def _parse_chunk(lanes):
        return [_parse_lane(bi) for bi in lanes]

    def _parse_lane(bi):
        # per-lane WINDOW parse — ONE C call decodes up to W frames
        # (the entropy stage releases the GIL, so lanes parse
        # concurrently on multi-core hosts)
        d = decs[bi]
        out, prog, mbs = [], False, 0
        if d._frame_pos >= d.length_frames > 0:
            active[bi] = False
            return out, prog, mbs
        if parse_lib is None:
            # pure-Python parser: per-frame
            for _ in range(W):
                if d._frame_pos >= d.length_frames > 0:
                    active[bi] = False
                    break
                p = d._parse_frame_tensors()
                if p is None:
                    active[bi] = False
                    break
                prog = True
                if int(np.max(p[7])) > 18:
                    _host_frame(d, bi, p[0], p[1], p[2], p[3], p[4],
                                p[5], p[6])
                    d._frame_pos += p[0]
                    continue
                slot = [None]
                outputs[bi].append(slot)
                out.append(p + (slot,))
                d._frame_pos += p[0]
                mbs = max(mbs, p[0])
            return out, prog, mbs
        max_block = d._max_block if 0 < d._max_block <= 65535 else 65535
        dch = d.channels
        n, res, cf, orr, sh, wa, bps, meta = _native.flac_parse_window(
            parse_lib, d._view, d._cur_bit, d.bits_per_sample, dch,
            max_block, W)
        maxbps = bps[: n * dch].reshape(n, dch).max(axis=1).tolist() \
            if n else []
        return _take_frames(d, bi, n, meta[:n].tolist(), maxbps, res,
                            cf, orr, sh, wa, bps)

    def _flac_dispatch(rows, ns, keep, residual, coeffs, order, shift,
                       exact, assigns, wasteds, out_shifts, max_bs, S,
                       use_s16, wctx, k):
        # everything per-window arrives as an argument: the enclosing
        # loop rebinds its locals while this runs.  `rows`/`ns` address
        # the parser's residual rows in place; `keep` holds per-lane
        # parse buffers alive until the pack reads them (fmulti rows
        # live in the double-buffered res_bufs, gated by buf_futs).
        Ln = S * nch
        h2d = 0
        n0 = lpc_ops.KERNEL_LAUNCHES
        if parse_lib is not None:
            _i32p = ctypes.POINTER(ctypes.c_int32)
            _u32p = ctypes.POINTER(ctypes.c_uint32)
            _i64p = ctypes.POINTER(ctypes.c_int64)
            with trace.span("pack", ctx=wctx, format="flac", window=k):
                w_l = np.zeros(Ln, np.int32)
                wmax = parse_lib.af_flac_widths_gather(
                    rows.ctypes.data_as(_i64p), Ln, max_bs,
                    ns.ctypes.data_as(_i32p),
                    order.ctypes.data_as(_i32p),
                    w_l.ctypes.data_as(_i32p))
                # residual widths are heavy-tailed (verbatim blocks,
                # high-order partitions): pad every row to the max
                # bucket, or pack small and ship the few wide rows apart
                wb, Lb = _flac_width_plan(w_l, wmax, Ln, max_bs)
                stride = (max_bs * wb + 31) // 32 + 1
                packed = np.empty((Ln, stride), np.uint32)
                warm = np.empty((Ln, 32), np.int32)
                parse_lib.af_flac_pack_gather(
                    rows.ctypes.data_as(_i64p), Ln, max_bs,
                    ns.ctypes.data_as(_i32p),
                    order.ctypes.data_as(_i32p), wb,
                    packed.ctypes.data_as(_u32p), stride,
                    warm.ctypes.data_as(_i32p))
                if Lb:
                    # the wide rows ship packed at the window-max bucket
                    over = np.flatnonzero(w_l > wb)
                    wb2 = next((x for x in _FLAC_W_BUCKETS
                                if wmax <= x), 32)
                    stride2 = (max_bs * wb2 + 31) // 32 + 1
                    order2 = np.full(Lb, max_bs, np.int32)
                    order2[1: 1 + over.size] = order[over]
                    packed2 = np.zeros((Lb, stride2), np.uint32)
                    warm2 = np.zeros((Lb, 32), np.int32)
                    if over.size:
                        rows_o = np.ascontiguousarray(rows[over])
                        ns_o = np.ascontiguousarray(ns[over])
                        parse_lib.af_flac_pack_gather(
                            rows_o.ctypes.data_as(_i64p),
                            int(over.size), max_bs,
                            ns_o.ctypes.data_as(_i32p),
                            np.ascontiguousarray(order[over])
                            .ctypes.data_as(_i32p), wb2,
                            packed2[1:].ctypes.data_as(_u32p),
                            stride2,
                            warm2[1:].ctypes.data_as(_i32p))
                    ovf_idx = np.zeros(Ln, np.int32)
                    ovf_idx[over] = np.arange(1, 1 + over.size)
            keep = None   # parser rows consumed
            nb = packed.nbytes + warm.nbytes
            with trace.span("upload", ctx=wctx, format="flac", window=k,
                            bytes=nb):
                (packed_d, warm_d, coeffs, order_d, shift, exact,
                 assigns, wasteds, out_shifts) = _upload(
                    device, packed, warm, coeffs, order, shift, exact,
                    assigns, wasteds, out_shifts)
            h2d += nb
            with trace.span("launch", ctx=wctx, format="flac", window=k):
                residual_d = lpc_ops.flac_unpack_residuals(
                    packed_d, warm_d, order_d, w=wb, n=max_bs)
            if Lb:
                nb = (packed2.nbytes + warm2.nbytes + order2.nbytes
                      + ovf_idx.nbytes)
                with trace.span("upload", ctx=wctx, format="flac",
                                window=k, bytes=nb):
                    p2_d, w2_d, o2_d, idx_d = _upload(
                        device, packed2, warm2, order2, ovf_idx)
                h2d += nb
                with trace.span("launch", ctx=wctx, format="flac",
                                window=k):
                    res_o = lpc_ops.flac_unpack_residuals(
                        p2_d, w2_d, o2_d, w=wb2, n=max_bs)
                    residual_d = lpc_ops.flac_merge_overflow(
                        residual_d, res_o, idx_d)
        else:
            with trace.span("upload", ctx=wctx, format="flac", window=k,
                            bytes=residual.nbytes):
                (residual_d, coeffs, order_d, shift, exact, assigns,
                 wasteds, out_shifts) = _upload(
                    device, residual, coeffs, order, shift, exact,
                    assigns, wasteds, out_shifts)
            h2d += residual.nbytes
        with trace.span("launch", ctx=wctx, format="flac",
                        window=k) as sp:
            samples = lpc_ops.flac_lpc(
                residual_d, coeffs, order_d, shift, exact
            ).reshape(S, nch, max_bs)
            # <=16-bit lanes (out_shift >= 16): ship int16 losslessly
            # to halve the device->host bytes
            post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                else lpc_ops.flac_post_stereo_batch
            out32 = post(samples, assigns, wasteds, out_shifts)
            out = _prefetch(out32, ctx.to_device)
            sp.set(launches=lpc_ops.KERNEL_LAUNCHES - n0)
        return out, h2d

    with WindowLoop(stats, "flac") as loop:
        buf_futs = [None, None]   # dispatch future per buffer parity
        wpar = 0
        for k in itertools.count():
            if not active.any():
                break
            with loop.window(k, lanes=int(active.sum())):
                if fmulti:
                    # rows of the window that used this buffer (two
                    # windows ago) must be packed before reuse
                    if buf_futs[wpar] is not None:
                        loop.wait(buf_futs[wpar], window=k)
                    res_buf = res_bufs[wpar]
                # host entropy stage: parse up to W frames per stream
                with loop.stage("parse"):
                    live = [bi for bi in range(B) if active[bi]]
                    res = loop.map(
                        _parse_chunk_fmulti if fmulti else _parse_chunk,
                        live)
                    parsed = [[] for _ in range(B)]
                    max_bs = 0
                    progress = False
                    for bi, (lane_out, prog, mbs) in zip(live, res):
                        parsed[bi] = lane_out
                        progress = progress or prog
                        max_bs = max(max_bs, mbs)
                lanes = [(bi, p) for bi in range(B) for p in parsed[bi]]
                if not lanes:
                    if not progress:
                        break
                    continue
                with loop.stage("enqueue"):
                    # bucket the lane count (multiples of 128 past 128)
                    # and the block length, so window shapes repeat
                    n_l = len(lanes)
                    S = max(8, 1 << (n_l - 1).bit_length()) if n_l <= 128 \
                        else -(-n_l // 128) * 128
                    max_bs = -(-max_bs // 1024) * 1024
                    coeffs = np.zeros((S * nch, 32), np.int32)
                    # pad rows: pass-through
                    order = np.full(S * nch, max_bs, np.int32)
                    shift = np.zeros(S * nch, np.int32)
                    exact = np.zeros(S * nch, bool)
                    assigns = np.zeros(S, np.int32)
                    wasteds = np.zeros((S, nch), np.int32)
                    out_shifts = np.zeros(S, np.int32)
                    if parse_lib is not None:
                        # no padded residual scatter: the worker packs
                        # straight from the parser's rows
                        # (af_flac_pack_gather).  rows[l] = address of
                        # that (lane, channel)'s residual row, ns[l] its
                        # valid sample count (reads as 0 beyond); rows
                        # left 0 are all-zero padding rows.
                        rows = np.zeros(S * nch, np.int64)
                        ns = np.zeros(S * nch, np.int32)
                        keep = []      # keepalive for per-lane parse bufs
                        residual = None
                    else:
                        rows = ns = keep = None
                        residual = np.zeros((S * nch, max_bs), np.int32)
                    for si, (bi, p) in enumerate(lanes):
                        bs, ca, res, cf, orr, sh, wa, bps, _slot = p
                        if residual is None:
                            base = res.__array_interface__["data"][0]
                            st0 = res.strides[0]
                            for c in range(nch):
                                rows[si * nch + c] = base + c * st0
                            ns[si * nch: si * nch + nch] = bs
                            keep.append(res)
                        else:
                            residual[si * nch: si * nch + nch, :bs] = res
                        coeffs[si * nch: si * nch + nch] = cf
                        order[si * nch: si * nch + nch] = orr
                        shift[si * nch: si * nch + nch] = sh
                        exact[si * nch: si * nch + nch] = \
                            np.asarray(bps) > 16
                        assigns[si] = ca
                        wasteds[si] = wa
                        out_shifts[si] = 32 - decs[bi].bits_per_sample
                    use_s16 = all(decs[bi].bits_per_sample <= 16
                                  for bi, _ in lanes)
                    fut = loop.submit(
                        _flac_dispatch, rows, ns, keep, residual, coeffs,
                        order, shift, exact, assigns, wasteds, out_shifts,
                        max_bs, S, use_s16, loop.ctx, k)
                stats.window("flac")
                # slots were claimed at parse time, in frame order; p[8]
                # is the frame's slot
                pending.append((fut, [(p[8], si, p[0]) for si, (bi, p)
                                      in enumerate(lanes)]))
                if fmulti:
                    # this window's rows live in res_bufs[wpar]; flip
                    # parity so the next window parses the other buffer
                    buf_futs[wpar] = fut
                    wpar ^= 1
    resolved = []
    for fut, slots in pending:
        out32, h2d = fut.result()
        # counted from the dispatch: the pack picks the window's width
        stats.add("h2d_bytes", h2d, "flac")
        resolved.append((out32, slots))
    return _PendingGroup(resolved, functools.partial(
        _pcm, ctx, decs, outputs, resolved, nch), _seconds(decs))


def _pcm(ctx, decs, outputs, pending, nch):
    for arr, slots in ctx.stats.fetched(pending):
        for slot, si, bs in slots:
            slot[0] = _frame_pcm(arr, si, bs)
    return _flac_pcm(decs, outputs, nch)
