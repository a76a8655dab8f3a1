"""The MP3 lockstep groups: Layer III over the pooled wire, and
Layers I/II."""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List

import numpy as np
import torch

from ... import trace
from ...host import native as _native
from ...models.mp3 import Mp3Decoder
from ...ops import mp3_dsp, mp3_huff
from ..window import (GroupContext, WindowLoop, _lane_bytes, _PendingGroup,
                      _prefetch, _upload)

#: MP3 frames per device call: Layers I/II, Layer III on the CPU, and the
#: step Layer III windows on the card are sized in (mp3_window_frames)
MP3_WINDOW_FRAMES = 24


def mp3_wave_lanes(device: torch.device) -> int:
    """The Huffman kernel's (K3's) lanes that fill `device` in one wave:
    its SMs x the kernel's resident blocks an SM x its threads a block.
    0 off CUDA, where the plain chain runs."""
    if device.type != "cuda":
        return 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * mp3_huff.HUFF_BLOCKS_PER_SM * mp3_huff.HUFF_THREADS


def mp3_window_frames(lanes_per_frame: int, frames_left: int,
                      wave_lanes: int) -> int:
    """Frames a Layer III device window takes, for a group whose frames
    each hold `lanes_per_frame` granule-channel lanes (B x ngr x nch) and
    whose longest lane has `frames_left` frames.  A window is one K3
    launch and one synthesis launch (K15), whose rows are its lanes: the
    window aims at one wave of K3 (`wave_lanes`, mp3_wave_lanes), in
    steps of MP3_WINDOW_FRAMES, then splits the frames evenly over the
    windows that takes, since K14 and K15 run every row of a
    window, live or not.  Never below MP3_WINDOW_FRAMES, which it stays
    where a wave holds no more (the CPU, wave_lanes 0; 1,024 stereo
    MPEG-1 lanes)."""
    step = MP3_WINDOW_FRAMES
    wave = max(step, step * (wave_lanes // (step * lanes_per_frame)))
    if frames_left <= 0:
        return step
    n = -(-frames_left // wave)
    return step * -(-frames_left // (step * n))


def layer3_key(d):
    """(channels, MPEG-1) of a Layer III lane."""
    if isinstance(d, Mp3Decoder) and d._layer == 3:
        return d.channels, d._mpeg1
    return None


def l12_key(d):
    """(channels, layer) of a Layer I/II lane: no bit reservoir, so
    frames are independent subband blocks."""
    if isinstance(d, Mp3Decoder) and d._layer != 3:
        return d.channels, d._layer
    return None


def _seconds(decs) -> float:
    # MP3 decoders count interleaved samples in _cur_sample
    return sum(d._cur_sample / max(1, d.channels) / max(1, d.sample_rate)
               for d in decs)


def decode_l12(ctx: GroupContext, decs: List[Mp3Decoder], key):
    """Layer I/II lockstep: no bit reservoir, so frames are independent
    subband blocks (minimp3.d:286-486).  The host parses W frames per
    lane into scalefactor-applied slot tensors; one batched synthesis
    FIR a window (ops/mp3_dsp.mp3_synth_slots) with carried slot
    history turns the whole group into PCM.  Corrupt frames vanish from
    a lane's slot sequence exactly as in the facade (history kept)."""
    nch = key[0]
    stats = ctx.stats
    W = MP3_WINDOW_FRAMES
    layer = decs[0]._layer
    spf_slots = 12 if layer == 1 else 36
    TS = W * spf_slots
    B = len(decs)
    shist = torch.zeros((B, nch, 16, 32), dtype=torch.float32,
                        device=ctx.device)
    offs = [d._offset for d in decs]
    active = np.ones(B, bool)
    pending = []
    while active.any():
        with stats.stage("parse", "mp3_l12", cpu=True):
            Sarr = np.zeros((B, nch, TS, 32), np.float32)
            n_slots = np.zeros(B, np.int32)
            for bi, d in enumerate(decs):
                if not active[bi]:
                    continue
                got = 0
                while got < W:
                    if offs[bi] >= len(d._view) - 4:
                        active[bi] = False
                        break
                    S2, fb = d._l12_parse_subbands(offs[bi])
                    if S2 is None:
                        if fb:
                            offs[bi] += fb
                            continue
                        active[bi] = False
                        break
                    offs[bi] += fb
                    Sarr[bi, :, got * spf_slots: got * spf_slots
                         + S2.shape[1]] = S2
                    got += 1
                n_slots[bi] = got * spf_slots
                d._cur_sample += got * d._spf * nch
                d._offset = offs[bi]
        if not n_slots.any():
            break
        with stats.stage("enqueue", "mp3_l12"):
            (S_d,) = _upload(ctx.device, Sarr)
            pcm, shist = mp3_dsp.mp3_synth_slots(S_d, shist, nch=nch)
            pending.append((_prefetch(pcm, ctx.to_device), n_slots))
        stats.window("mp3_l12", Sarr.nbytes)
    return _PendingGroup(pending, functools.partial(
        _l12_pcm, ctx, decs, pending, nch), _seconds(decs))


def _l12_pcm(ctx, decs, pending, nch):
    outs = [[] for _ in decs]
    for arr, n_slots in ctx.stats.fetched(pending):   # [B, nch, TS*32]
        for bi in range(len(decs)):
            k = int(n_slots[bi]) * 32
            if k:
                outs[bi].append(arr[bi, :, :k].T)
    result = []
    for bi, d in enumerate(decs):
        full = np.concatenate(outs[bi]) if outs[bi] else \
            np.zeros((0, nch), np.float32)
        full = full[d._start_delay // max(1, nch):]
        if d._total_samples:
            full = full[: d._total_samples // max(1, nch)]
        result.append(np.ascontiguousarray(full, np.float32))
    return result


def decode_layer3(ctx: GroupContext, decs: List[Mp3Decoder], key):
    """Device-Huffman lockstep over the pooled wire: per window the C
    stage parses W frames of every lane (mp3_window_frames: 24 on the
    CPU, sized to the batch on the card) into each frame's main data
    words, side info and quarter-exponent scalefactors of its
    granule-channels (one C call per lane chunk, on the parse pool); the
    frames' words pack into one exact-size u32 pool (frame after frame,
    each granule-channel addressing its frame's words by bit position);
    the dispatch worker uploads it and runs ops/mp3_huff.packed_window —
    the Huffman kernel (K3), the window kernel (K14: dequant, stereo
    mix, reorder, antialias, IMDCT and overlap-add) and the synthesis
    product — with the carried overlap and slot history."""
    lib = _native.get_lib()
    if lib is None:
        raise RuntimeError("the MP3 batch path needs the C host stage "
                           "(host/src/af_host.cc), which did not load")
    nch, mpeg1 = key
    ngr = 2 if mpeg1 else 1
    stats, device = ctx.stats, ctx.device
    B = len(decs)
    LPF = ngr * nch  # lanes a frame
    # the longest lane's frames: its frame index past its position
    frames_left = max(len(d._index_offsets) - int(np.searchsorted(
        d._index_offsets, d._offset)) for d in decs)
    W = mp3_window_frames(B * LPF, frames_left, mp3_wave_lanes(device))
    stats.most("mp3_window_frames", W)
    G = W * ngr
    NL = G * nch
    FW = _native.FRAME_WORDS
    dev_state = {
        "overlap": torch.zeros((B, nch, 32, 18), dtype=torch.float32,
                               device=device),
        "shist": torch.zeros((B, nch, 16, 32), dtype=torch.float32,
                             device=device),
    }
    active = np.ones(B, bool)
    # per-lane state as batch-contiguous rows: the multi-lane C entry
    # (af_mp3_parse_window_packed_multi) derives lane pointers from
    # base + lane * stride
    data_keep, data_ptrs, data_lens = _lane_bytes(decs)
    offs_a = np.zeros(B, np.int64)
    hdr0s = np.zeros((B, 4), np.uint8)
    ffb = np.zeros(B, np.int32)
    rb_all = np.zeros((B, 511), np.uint8)
    rl_all = np.zeros(B, np.int32)
    ist_all = np.zeros((B, 2, 40), np.int32)
    for bi, d in enumerate(decs):
        offs_a[bi] = d._offset
        hdr0s[bi] = np.frombuffer(d._hdr0, np.uint8, 4)
        ffb[bi] = d._free_format_bytes
        cur = d._reserv_buf
        if cur:
            rb_all[bi, : len(cur)] = np.frombuffer(cur, np.uint8)
            rl_all[bi] = min(d._reserv, len(cur))
        ist_all[bi] = d._ist_pos
    flags_all = np.zeros((B, W), np.uint8)
    aa_all = np.zeros((B, G, nch), np.int32)
    wt_all = np.zeros((B, G, nch, 32), np.int32)
    n_out = np.zeros(B, np.int32)
    mw_all = np.zeros(B, np.int32)
    idx_w = np.arange(W)
    win = {}  # this window's host arrays, rebound every window

    def _parse_chunk(lanes):
        gated = []
        for bi in lanes:
            d = decs[bi]
            if offs_a[bi] >= data_lens[bi] - 4 or (
                d._total_samples
                and d._cur_sample >= d._total_samples
            ):
                active[bi] = False
            else:
                gated.append(bi)
        if gated:
            _native.mp3_parse_window_packed_multi(
                lib, gated, data_ptrs, data_lens, offs_a, hdr0s,
                W, ffb, rb_all, rl_all, ist_all, win["bits"],
                mw_all, win["meta"], win["scfq"],
                win["ists"] if nch == 2 else None,
                aa_all, wt_all, flags_all, n_out)
        return gated

    def _post_parse(gated):
        """Frame activity, intensity flags, the rare compaction of
        silent-frame holes to the n_act prefix the window DSP needs,
        and the per-decoder positions.  Returns the window's widest
        lane in words."""
        if not gated:
            return 16
        bits, meta, scfq, ists = (win[k] for k in
                                  ("bits", "meta", "scfq", "ists"))
        g = np.asarray(gated, np.int64)
        ng = n_out[g]
        fl = flags_all[g]
        validm = idx_w[None, :] < ng[:, None]
        actm = ((fl & 1) != 0) & validm
        n_fr_g = actm.sum(1)
        win["win_ist"][g] = (((fl & 4) != 0) & validm).any(1)
        win["n_act"][g] = (n_fr_g * ngr).astype(np.int32)
        pref = actm.cumsum(1)
        hole = np.zeros(g.size, bool)
        nz = n_fr_g > 0
        hole[nz] = pref[nz, n_fr_g[nz] - 1] < n_fr_g[nz]
        for i in np.flatnonzero(hole):
            bi = int(g[i])
            fi = np.flatnonzero(actm[i])
            bits[bi, : len(fi)] = bits[bi, fi]
            li = np.flatnonzero(np.repeat(actm[i], LPF))
            meta[bi, : len(li)] = meta[bi, li]
            scfq[bi, : len(li)] = scfq[bi, li]
            meta[bi, len(li):] = 0
            gi = np.flatnonzero(np.repeat(actm[i], ngr))
            ists[bi, : len(gi)] = ists[bi, gi]
            ists[bi, len(gi):] = 0
        for i, bi in enumerate(gated):
            d = decs[bi]
            d._offset = int(offs_a[bi])
            d._cur_sample += int(n_fr_g[i]) * ngr * 576 * nch
            if ng[i] < W:
                active[bi] = False
        return max(16, int(mw_all[g].max()))

    def _dispatch(pool_w, meta16, scfq, ists, n_act, Wrow, short, h2d,
                  wctx, k):
        with trace.span("upload", ctx=wctx, format="mp3", window=k,
                        bytes=h2d):
            pool_d, meta_d, scf_d, n_act_d = _upload(
                device, pool_w, meta16, scfq, n_act)
            ist_d = None if ists is None else _upload(device, ists)[0]
        with trace.span("launch", ctx=wctx, format="mp3",
                        window=k, lanes=B * NL) as sp:
            n0 = mp3_huff.HUFF_LAUNCHES
            d0 = mp3_dsp.DSP_LAUNCHES
            s0 = mp3_dsp.SYNTH_LAUNCHES
            pcm, dev_state["overlap"], dev_state["shist"] = \
                mp3_huff.packed_window(
                    pool_d, meta_d, scf_d, ist_d, dev_state["overlap"],
                    dev_state["shist"], n_act_d, B=B, G=G, nch=nch,
                    W=Wrow, mpeg1=ngr == 2, short=short)
            out = _prefetch(pcm, ctx.to_device)
            sp.set(launches=mp3_huff.HUFF_LAUNCHES - n0,
                   dsp_launches=mp3_dsp.DSP_LAUNCHES - d0,
                   synth_launches=mp3_dsp.SYNTH_LAUNCHES - s0)
        return out

    pending = []
    short_pats = np.zeros(mp3_huff.N_PATTERNS, bool)
    short_pats[list(mp3_huff.SHORT_PATTERNS)] = True
    with WindowLoop(stats, "mp3") as loop:
        for k in itertools.count():
            if not active.any():
                break
            with loop.window(k, lanes=int(active.sum()), frames=W):
                with loop.stage("parse"):
                    win.update(
                        bits=np.empty((B, W, FW), np.uint32),
                        meta=np.zeros((B, NL, 16), np.int32),
                        scfq=np.zeros((B, NL, 40), np.int16),
                        ists=np.zeros((B, G, 40), np.int16),
                        win_ist=np.zeros(B, bool),
                        n_act=np.zeros(B, np.int32))
                    live = [bi for bi in range(B) if active[bi]]
                    mw_max = _post_parse(loop.map(_parse_chunk, live))
                n_act = win["n_act"]
                if not n_act.any():
                    break
                with loop.stage("enqueue"):
                    meta = win["meta"]
                    L = B * NL
                    with trace.span("pack", format="mp3", window=k):
                        meta16 = mp3_huff.meta16_from_c(meta).reshape(L, 16)
                        # one C pass copies each frame's span of words into
                        # the pool
                        span32 = np.ascontiguousarray(
                            meta16[::LPF, mp3_huff.M_SPAN], np.int32)
                        pool_w = np.empty(int(span32.sum()), np.uint32)
                        u32p = ctypes.POINTER(ctypes.c_uint32)
                        lib.af_u32_pack_prefix_rows(
                            win["bits"].reshape(B * W, FW).ctypes.data_as(
                                u32p),
                            B * W, FW,
                            span32.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int32)),
                            pool_w.ctypes.data_as(u32p))
                    ists = win["ists"].reshape(B * G, 40) \
                        if nch == 2 and win["win_ist"].any() else None
                    short = bool(short_pats[meta[:, :, 10]].any())
                    scfq = win["scfq"].reshape(L, 40)
                    h2d = (pool_w.nbytes + meta16.nbytes + scfq.nbytes
                           + n_act.nbytes
                           + (0 if ists is None else ists.nbytes))
                    fut = loop.submit(_dispatch, pool_w, meta16, scfq, ists,
                                      n_act, mp3_huff.row_width(mw_max),
                                      short, h2d, loop.ctx, k)
                stats.window("mp3", h2d)
                pending.append((fut, n_act))
    # the parse ran against the batch copy of the persistent intensity
    # positions; write them back so the decoders stay consistent
    for bi, d in enumerate(decs):
        d._ist_pos[:] = ist_all[bi]
    pending = [(f.result(), n) for f, n in pending]
    return _PendingGroup(pending, functools.partial(
        _layer3_pcm, ctx, decs, pending, nch), _seconds(decs))


def _layer3_pcm(ctx, decs, pending, nch):
    """Download the pending windows and assemble each lane's PCM (delay
    skip, total-length clamp)."""
    outputs = [[] for _ in decs]
    for pcm, n_act in ctx.stats.fetched(pending):
        for bi in range(len(decs)):
            n = int(n_act[bi])
            if n:
                outputs[bi].append(
                    pcm[bi, :n].transpose(0, 2, 1).reshape(-1, nch))
    result = []
    for bi, d in enumerate(decs):
        pcm = np.concatenate(outputs[bi]) if outputs[bi] else \
            np.zeros((0, nch), np.float32)
        pcm = pcm[d._start_delay // nch:]
        if d._total_samples:
            pcm = pcm[: d._total_samples // nch]
        result.append(pcm)
    return result
