"""The FLAC lockstep group over the device-Rice wire."""

from __future__ import annotations

import functools
import itertools
import time
from typing import List

import numpy as np

from ...host import native as _native
from ...models.flac import FlacDecoder
from ...ops import flac_rice
from ...ops import lpc as lpc_ops
from ..window import (GroupContext, WindowLoop, _lane_bytes, _PendingGroup,
                      _prefetch, _upload)
from .flac import (FLAC_WINDOW_FRAMES, _flac_host_frame, _flac_pcm,
                   _frame_pcm, _seconds)

#: a FLAC group whose streams hold at least this many bytes uploads them
#: once as a corpus and gathers each dispatch's frame pool on the device;
#: a smaller group builds the pool on the host a dispatch
RICE_GATHER_MIN_BYTES = 8 << 20
#: pool blocks a dispatch at most (2^30 bits: the kernel's bit cursors
#: are int32)
RICE_DISPATCH_BLOCKS = 524288


def decode(ctx: GroupContext, decs: List[FlacDecoder], nch: int):
    """FLAC lockstep over the device-Rice wire: the host runs only the
    byte-level frame sync index, one C call a window for every live
    lane; the raw frame bytes cross to the device once, and the
    frame-entropy kernel decodes subframe headers and residuals, which
    the LPC kernel and the stereo stage turn into PCM.  A group of
    RICE_GATHER_MIN_BYTES or more uploads its streams as one corpus and
    gathers each dispatch's frame pool on the device; a smaller one
    builds the pool on the host a dispatch.  The corpus is this call's
    own: concurrent groups never share one.  Frames the device flags
    (corrupt, wider than 18 bits, or an end that does not meet the next
    frame's start) are decoded again on the host."""
    B = len(decs)
    outputs = [[] for _ in range(B)]
    for d in decs:
        if not hasattr(d, "_rice_state"):
            d._rice_state = np.array([-1, 0, d._cur_bit // 8], np.int64)
    blk_b = flac_rice.BLK_W * 4
    total = sum(len(d._view) for d in decs)
    corpus = None
    if total >= RICE_GATHER_MIN_BYTES and total + 3 * blk_b < (1 << 31):
        # every stream's bytes end to end, then the zero tail the
        # gather reads for blocks past the last frame
        zero_off = total + (-total) % 4
        buf = np.zeros(zero_off + 2 * blk_b, np.uint8)
        stream_base = np.zeros(B, np.int64)
        cur = 0
        for bi, d in enumerate(decs):
            nb = len(d._view)
            buf[cur: cur + nb] = np.frombuffer(d._view, np.uint8, nb, 0)
            stream_base[bi] = cur
            cur += nb
        (corpus_d,) = _upload(ctx.device, buf.view(np.int32))
        corpus = (corpus_d, stream_base, zero_off)
        ctx.stats.add("h2d_bytes", buf.nbytes, "flac")
    with WindowLoop(ctx.stats, "flac") as loop:
        pending = _windows(loop, ctx, decs, nch, corpus, outputs)
    # the frame checks, after every window was enqueued: the flags'
    # downloads wait for their window's device chain
    resolved = []
    for fut, slots, base_bits, sizes in pending:
        out, err_d, endb_d, subbps_d = fut.result()
        err = err_d.cpu().numpy()
        endb = endb_d.cpu().numpy().astype(np.int64) - base_bits
        wide = subbps_d.cpu().numpy().max(axis=1) > 18
        # the frame's end, byte-aligned, plus its CRC-16 must meet the
        # next frame's start (sizes 0: a stream's last frame, unchecked)
        chain = ((((endb + 7) // 8) * 8 + 16 != sizes * 8)
                 & (sizes > 0))
        resolved.append((out, err | wide | chain, slots))
    return _PendingGroup(resolved, functools.partial(
        _pcm, ctx, decs, outputs, resolved, nch), _seconds(decs))


def _windows(loop, ctx, decs, nch, corpus, outputs):
    """The window loop: one af_flac_sync_index_multi call a window
    indexes up to W frames of every live lane (each lane's sync state is
    a row of a batch array, written back to its decoder at the end); the
    window's frames go to the device in dispatches.  Returns the pending
    (future, slots, base bits, sizes) a dispatch."""
    lib = _native.get_lib()
    B = len(decs)
    W = FLAC_WINDOW_FRAMES
    active = np.ones(B, dtype=bool)
    keep, ptrs, lens = _lane_bytes(decs)
    bps_in = np.zeros(B, np.int32)
    st_all = np.zeros((B, 3), np.int64)
    for bi, d in enumerate(decs):
        bps_in[bi] = d.bits_per_sample
        st_all[bi] = d._rice_state
    offs_w = np.zeros((B, W), np.int64)
    dbits_w = np.zeros((B, W), np.int64)
    bs_w = np.zeros((B, W), np.int32)
    ca_w = np.zeros((B, W), np.int32)
    bpsf_w = np.zeros((B, W), np.int32)
    n_w = np.zeros(B, np.int32)
    pending = []
    for k in itertools.count():
        if not active.any():
            break
        with loop.window(k, lanes=int(active.sum())):
            with loop.stage("parse", cpu=True):
                live = []
                for bi in np.flatnonzero(active).tolist():
                    d = decs[bi]
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                    else:
                        live.append(bi)
                if live:
                    _native.flac_sync_index_multi(
                        lib, live, ptrs, lens, bps_in, nch, 65535, W,
                        st_all, offs_w, dbits_w, bs_w, ca_w, bpsf_w, n_w)
                # (bi, byte_off, size, rel_bit, bs, ca, bps, chk)
                lanes = []
                for bi in live:
                    n = int(n_w[bi])
                    if n == 0:
                        active[bi] = False
                        continue
                    o = offs_w[bi, :n]
                    end = int(st_all[bi, 2])
                    if n == W and end + 16 <= lens[bi]:
                        # the state's resume byte is the synced next frame
                        nxt, chk_last = end, True
                    else:
                        # a stream's end: no next frame, ship through EOF
                        # and skip the chain check
                        nxt, chk_last = int(lens[bi]), False
                    sizes = (np.append(o[1:], nxt) - o).tolist()
                    rel = (dbits_w[bi, :n] - o * 8).tolist()
                    bsl = bs_w[bi, :n].tolist()
                    lanes.extend(
                        (bi, oi, sizes[i], rel[i], bsl[i],
                         int(ca_w[bi, i]), int(bpsf_w[bi, i]),
                         chk_last if i == n - 1 else True)
                        for i, oi in enumerate(o.tolist()))
                    decs[bi]._frame_pos += sum(bsl)
                    if n < W:
                        active[bi] = False
            if not lanes:
                break
            pending.extend(_submit(loop, ctx, decs, sub, nch, lib, ptrs,
                                   corpus, outputs)
                           for sub in _dispatch_chunks(lanes))
    # chunked reads continue across groups from the sync state
    for bi, d in enumerate(decs):
        d._rice_state[:] = st_all[bi]
    return pending


def _dispatch_chunks(lanes):
    """A window's frames split into dispatches whose pools, with the two
    guard blocks, stay within RICE_DISPATCH_BLOCKS."""
    blk_b = flac_rice.BLK_W * 4
    chunks, cur, blocks = [], [], 0
    for p in lanes:
        nb = -(-p[2] // blk_b)
        if cur and blocks + nb + 2 > RICE_DISPATCH_BLOCKS:
            chunks.append(cur)
            cur, blocks = [], 0
        cur.append(p)
        blocks += nb
    chunks.append(cur)
    return chunks


def _submit(loop, ctx, decs, lanes, nch, lib, lane_addrs, corpus,
            outputs):
    """Build one dispatch, the frame pool (or its gather indices) and the
    per-frame arrays, submit its device chain, and claim each frame's
    output slot.  Returns (future, slots, base bits, sizes)."""
    S = len(lanes)
    with loop.stage("enqueue"):
        max_bs = max(p[4] for p in lanes)
        max_bs = next((x for x in (256, 1024, 4096) if max_bs <= x),
                      -(-max_bs // 4096) * 4096)
        NPOOL = flac_rice.pool_blocks_needed([p[2] for p in lanes])
        t_pb = time.perf_counter()
        if corpus is not None:
            lane_src, cum_dst, base_bits = flac_rice.gather_pool_meta(
                corpus[1], lanes, S, corpus[2])
            pool = None
        else:
            pool, base_bits = flac_rice.build_frame_pool_native(
                lib, lane_addrs, lanes, NPOOL)
            lane_src = cum_dst = None
            ctx.stats.add("h2d_bytes", pool.nbytes, "flac")
        ctx.stats.add("enq_flac_poolbuild_ms",
                      (time.perf_counter() - t_pb) * 1e3)
        bi_c, off_c, size_c, rel_c, bs_c, ca_c, bps_c, chk_c = zip(*lanes)
        start_bits = (base_bits + np.asarray(rel_c, np.int64))\
            .astype(np.int32)
        sizes = np.where(np.asarray(chk_c, bool),
                         np.asarray(size_c, np.int64), 0)
        lane_bps = np.fromiter((decs[bi].bits_per_sample for bi in bi_c),
                               np.int32, S)
        fut = loop.submit(
            _device_chain, ctx, nch, corpus, pool, lane_src, cum_dst,
            start_bits, np.asarray(bs_c, np.int32),
            np.asarray(ca_c, np.int32), np.asarray(bps_c, np.int32),
            (32 - lane_bps).astype(np.int32), NPOOL, max_bs,
            bool((lane_bps <= 16).all()))
    ctx.stats.window("flac")
    slots = []
    for si, (bi, off, bs) in enumerate(zip(bi_c, off_c, bs_c)):
        slot = [None]
        outputs[bi].append(slot)
        slots.append((slot, si, bs, bi, off))
    return fut, slots, base_bits, sizes


def _device_chain(ctx, nch, corpus, pool, lane_src, cum_dst, start_bits,
                  bs_arr, ca_arr, bps_arr, out_shifts, NPOOL, max_bs,
                  use_s16):
    """One dispatch on the device: the pool (gathered from the corpus or
    uploaded) → frame-entropy kernel → LPC kernel → stereo."""
    device = ctx.device
    S = len(start_bits)
    if pool is None:
        corpus_d, _, zero_off = corpus
        ls_d, cum_d = _upload(device, lane_src, cum_dst)
        blocks_d = flac_rice.gather_frame_pool(
            corpus_d, ls_d, cum_d, zero_off, NPOOL, S)
    else:
        (pool_d,) = _upload(device, pool)
        blocks_d = flac_rice.pad_pool(pool_d, NPOOL)
    sb_d, bs_d, bps_d, ca_d, osh_d = _upload(
        device, start_bits, bs_arr, bps_arr, ca_arr, out_shifts)
    ent = flac_rice.flac_frame_entropy(
        blocks_d, sb_d, bs_d, bps_d, ca_d, L=S, NSAMP=max_bs,
        nch=nch, NPOOL=NPOOL)
    Ln = S * nch
    sub_bps = ent["sub_bps"]
    samples = lpc_ops.flac_lpc(
        ent["residual"].reshape(Ln, max_bs),
        ent["coeffs"].reshape(Ln, 32), ent["order"].reshape(Ln),
        ent["shift"].reshape(Ln), (sub_bps > 16).reshape(Ln),
    ).reshape(S, nch, max_bs)
    post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
        else lpc_ops.flac_post_stereo_batch
    out = post(samples, ca_d, ent["wasted"], osh_d)
    return (_prefetch(out, ctx.to_device), ent["err"], ent["end_bits"],
            sub_bps)


def _pcm(ctx, decs, outputs, pending, nch):
    lib = _native.get_lib()
    n_redo = 0
    corrupt = set()      # lanes with a flagged frame the host cannot parse
    for arr, bad, slots in ctx.stats.fetched(pending):
        for slot, si, bs, bi, off in slots:
            if not bad[si]:
                slot[0] = _frame_pcm(arr, si, bs)
                continue
            d = decs[bi]
            nat = _native.flac_parse_frame(
                lib, d._view, off * 8, d.bits_per_sample, nch, 65535)
            if nat is None:
                # the stream ends at an unparseable frame, as in the
                # single-stream decoder: no error, fewer samples
                corrupt.add(bi)
                slot[0] = np.zeros((0, nch), np.int32)
                continue
            slot[0] = _flac_host_frame(
                nat["residual"], nat["coeffs"], nat["order"],
                nat["shift"], nat["chan_assignment"], nat["wasted"],
                d.bits_per_sample)[:bs]
            n_redo += 1
    if n_redo:
        ctx.stats.add("rice_host_redo", n_redo)
    for bi in corrupt:
        ctx.stats.add("flac_truncated_lanes", 1)
        # drop the lane's frames from the unparseable one on (slots are
        # in frame order)
        seen = False
        for c in outputs[bi]:
            seen = seen or c[0].shape[0] == 0
            if seen:
                c[0] = np.zeros((0, nch), np.int32)
    return _flac_pcm(decs, outputs, nch)
