"""Vorbis window pipeline of the batch path: IMDCT + lapped overlap-add.

The reference defers windowing to ``vorbis_finish_frame``
(stb_vorbis2.d:2606-2640): each packet's raw IMDCT output is mixed with the
carried right half of the previous window over the lap region, the finished
region [left_start, right_start) is returned, and [right_start, right_end)
is saved as the next lap.  The single-stream decoder does this per packet
in numpy (models/vorbis.py:_finish_packet); this module runs the same chain
for a whole lockstep group, K packet slots a lane at a time, with the lap
carried on the device.

``vorbis_window_chain`` runs both block sizes' IMDCTs as full-float32
matmuls over the window's stacked lane-channels (ops/mdct.py), then the
lapped chain: on a CUDA device K11, the hand-written kernel of
``csrc/vorbis_win.cu`` (one block a lane-channel, its slots computed side
by side, each mixed with the raw row of the lane's previous valid slot; the
lanes of
``chained_lanes`` run their slots in order within the same launch); on
the CPU its plain PyTorch twin ``lap_chain_torch``.  ``WIN_LAUNCHES``
counts K11's launches.

Window slopes are not computed on the device: Vorbis laps have width
bs0/2 or bs1/2 only, so both slopes (``slope_rows``, bit-equal to
ops/mdct.vorbis_slope) go in as constants.  Offsets are plain indexes.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import _kernels
from . import mdct as mdct_ops
from .mp3_dsp import device_const

#: launches of K11 (af_vorbis_win) in this process
WIN_LAUNCHES = 0
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def slope_rows(bs0: int, bs1: int) -> np.ndarray:
    """The two lap widths' rising slopes, f32 [bs0/2 + bs1/2]: slope(bs0/2)
    then slope(bs1/2) (ops/mdct.vorbis_slope)."""
    return np.concatenate([mdct_ops.vorbis_slope(bs0 // 2),
                           mdct_ops.vorbis_slope(bs1 // 2)])


def vorbis_window_chain(X, ls, rs, re, valid, lap, lap_len, had_prev, *,
                        bs0: int, bs1: int, ch: int):
    """Run K packets of a Vorbis lockstep group through IMDCT + lapped OLA.

    Args:
      X:        [K, L, bs1//2] f32 spectra (L = B*ch lane-channels,
                lane-major); short-block packets occupy [..., :bs0//2].
      ls/rs/re: [K, B] int32 per-packet left_start / right_start /
                right_end (models/vorbis.py:_packet_entropy geometry; a slot
                is short ⇔ rs == bs0//2 and re == bs0).
      valid:    [K, B] int32 — 0 slots leave the lane's carry untouched.
      lap:      [L, bs1//2] f32 carried previous-window right half.
      lap_len:  [B] int32 carried lap width (0, bs0//2 or bs1//2).
      had_prev: [B] int32 — 0 until the lane's first decoded packet (the
                single-stream decoder's ``self._prev is None`` state).

    Returns (pcm [K, L, bs1] left-aligned at 0 and zero past each packet's
    out_len = had_prev ? rs-ls : 0, lap', lap_len', had_prev').
    """
    K, L, h = X.shape
    y1 = mdct_ops.imdct_batch(X.reshape(K * L, h), bs1).reshape(K, L, bs1)
    y0 = None
    if bs0 != bs1:
        h0 = bs0 // 2
        y0 = mdct_ops.imdct_batch(X[..., :h0].reshape(K * L, h0), bs0) \
            .reshape(K, L, bs0)
    return lap_chain(y1, y0, ls, rs, re, valid, lap, lap_len, had_prev,
                     bs0=bs0, bs1=bs1, ch=ch)


def lap_chain(y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, *,
              bs0: int, bs1: int, ch: int):
    """The lapped chain over a window's K slots, after the IMDCT: y1
    [K, L, bs1] (every slot's long IMDCT), y0 [K, L, bs0] (the short IMDCT;
    None when bs0 == bs1); the rest as ``vorbis_window_chain``.  K11 on a
    CUDA device, the twin on the CPU."""
    dev = y1.device
    if dev.type == "cpu":
        return lap_chain_torch(y1, y0, ls, rs, re, valid, lap, lap_len,
                               had_prev, bs0=bs0, bs1=bs1, ch=ch)
    if dev.type != "cuda":
        raise _kernels.KernelArgError(f"lap_chain: no kernel for device "
                                      f"{dev}")
    K, L, _ = y1.shape
    B = _lanes(L, ch)
    out = (torch.empty((K, L, bs1), dtype=torch.float32, device=dev),
           torch.empty((L, bs1 // 2), dtype=torch.float32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))
    # outputs made here need no check
    _launch(dev, y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, out,
            bs0, bs1, ch, ())
    return out


def lap_chain_launch(y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, out,
                     *, bs0: int, bs1: int, ch: int) -> None:
    """K11 into made outputs: out = (pcm [K, L, bs1], lap' [L, bs1/2],
    lap_len' [B], had_prev' [B]), all on y1's CUDA device."""
    K, L, _ = y1.shape
    B, h = _lanes(L, ch), bs1 // 2
    f32, i32 = (torch.float32,), (torch.int32,)
    _launch(y1.device, y1, y0, ls, rs, re, valid, lap, lap_len, had_prev,
            out, bs0, bs1, ch, (
                ("pcm", out[0], f32, (K, L, bs1)),
                ("lap'", out[1], f32, (L, h)),
                ("lap_len'", out[2], i32, (B,)),
                ("had_prev'", out[3], i32, (B,))))


def _lanes(L: int, ch: int) -> int:
    if ch <= 0 or L % ch:
        raise _kernels.KernelArgError(f"lap_chain: {L} lane-channels are "
                                      f"not lanes of {ch} channels")
    return L // ch


def _launch(dev, y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, out,
            bs0, bs1, ch, out_checks) -> None:
    """Check the inputs (and `out_checks`: the outputs a caller made) and
    launch K11 on dev's current stream."""
    global WIN_LAUNCHES
    K, L, _ = y1.shape
    B, h = L // ch, bs1 // 2
    if bs0 == bs1:
        y0 = y1
    f32, i32 = (torch.float32,), (torch.int32,)
    _kernels.check_args("lap_chain", dev, (
        ("y1", y1, f32, (K, L, bs1)), ("y0", y0, f32, (K, L, bs0)),
        ("ls", ls, i32, (K, B)), ("rs", rs, i32, (K, B)),
        ("re", re, i32, (K, B)), ("valid", valid, i32, (K, B)),
        ("lap", lap, f32, (L, h)), ("lap_len", lap_len, i32, (B,)),
        ("had_prev", had_prev, i32, (B,)), *out_checks))
    if L == 0:
        return
    fn, slopes = _entry(dev, bs0, bs1)
    args = (y1.data_ptr(), y0.data_ptr(), ls.data_ptr(), rs.data_ptr(),
            re.data_ptr(), valid.data_ptr(), lap.data_ptr(),
            lap_len.data_ptr(), had_prev.data_ptr(), slopes,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), K, L, ch, bs0, bs1)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("vorbis_win", rc)
    with _launch_lock:
        WIN_LAUNCHES += 1


@functools.lru_cache(maxsize=None)
def _entry(dev: torch.device, bs0: int, bs1: int):
    """K11's C entry and the address of the slopes' constant on `dev`."""
    return (_kernels.load("vorbis_win").af_vorbis_win,
            device_const(slope_rows(bs0, bs1), dev).data_ptr())


def chained_lanes(ls, rs, re, valid, lap_len, *, bs0: int, bs1: int):
    """The lanes K11 runs in order, slot after slot ([B] bool): those where
    a valid slot's new lap y_mix[rs : re] meets its mix [ls, ls +
    min(lap_len, n - ls)), so depends on the lap it was given, and those
    whose geometry leaves the spec's forms (an edge that is not a multiple
    of 4, not 0 <= ls <= rs <= re <= n, a lap width other than bs0/2 or
    bs1/2).  The other lanes' slots each mix with the raw IMDCT row of the
    lane's previous valid slot, and their blocks run side by side.  ls, rs,
    re, valid [K, B] and lap_len [B] int32, on any device."""
    h0, h = bs0 // 2, bs1 // 2
    lap_len = lap_len.to(torch.int64)
    serial = ~((lap_len == 0) | (lap_len == h0) | (lap_len == h))
    serial |= bool((h0 | h) & 3)
    for k in range(ls.shape[0]):
        v = valid[k] != 0
        lsk, rsk, rek = (a[k].to(torch.int64) for a in (ls, rs, re))
        n = torch.where((rsk == h0) & (rek == bs0), bs0, bs1)
        nw = rek - rsk
        mix_len = torch.minimum(lap_len, n - lsk)
        chained = (nw > 0) & (mix_len > 0) & (
            torch.maximum(rsk, lsk)
            < torch.minimum(rsk + nw.clamp(max=h), lsk + mix_len))
        spec = (((lsk | rsk | rek) & 3) == 0) & (0 <= lsk) & (lsk <= rsk) \
            & (rsk <= rek) & (rek <= n) & ((nw == h0) | (nw == h))
        serial |= v & (chained | ~spec)
        lap_len = torch.where(v, nw, lap_len)
    return serial


def lap_chain_torch(y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, *,
                    bs0: int, bs1: int, ch: int):
    """Twin of K11 (and of the JAX package's scan body in
    ``vorbis_window_chain``): for each slot k, on every lane-channel,

      y       = the slot's short IMDCT (zero past bs0) or its long one;
      y_mix   = y·w[t-ls] + lap[t-ls]·w[lw-1-(t-ls)] over
                [ls, ls + min(lap_len, n - ls)), y elsewhere (lw = lap_len's
                slope width, n the block size), zero past bs1;
      pcm[k]  = y_mix[ls:], zero from out_len = had_prev ? rs-ls : 0 on;
      lap'    = y_mix[rs:re] left-aligned, zero past re-rs;

    a slot with valid 0 emits zeros and leaves the carry untouched."""
    K, L, _ = y1.shape
    dev = y1.device
    h0, h = bs0 // 2, bs1 // 2
    sl = device_const(slope_rows(bs0, bs1), dev)
    s0, s1 = sl[:h0], sl[h0:]
    t = torch.arange(bs1, device=dev)[None, :]
    ih = torch.arange(h, device=dev)[None, :]
    lap = lap.clone()
    lap_len = lap_len.clone()
    had_prev = had_prev.clone()
    pcm = torch.zeros((K, L, bs1), dtype=torch.float32, device=dev)

    def per_lc(a):
        return a.repeat_interleave(ch)[:, None]

    zeros = torch.zeros((L, h), dtype=torch.float32, device=dev)
    for k in range(K):
        lsr, rsr, rer, vr = (per_lc(a[k]) for a in (ls, rs, re, valid))
        lpr, hpr = per_lc(lap_len), per_lc(had_prev)
        short = (rsr == h0) & (rer == bs0)
        n = torch.where(short, bs0, bs1)
        y = y1[k]
        if y0 is not None and bs0 != bs1:
            y0k = torch.nn.functional.pad(y0[k], (0, bs1 - bs0))
            y = torch.where(short, y0k, y)
        j = t - lsr
        mix = (j >= 0) & (j < lpr) & (t < n)
        wide = lpr == h
        jf = j.clamp(0, h - 1)
        jr1 = (h - 1 - j).clamp(0, h - 1)
        jr0 = (h0 - 1 - j).clamp(0, h0 - 1)
        w_f = torch.where(wide, s1[jf], s0[jf.clamp(max=h0 - 1)])
        w_r = torch.where(wide, s1[jr1], s0[jr0])
        lap_sh = lap.gather(1, jf)
        y_mix = torch.where(mix, y * w_f + lap_sh * w_r, y)
        ypad = torch.cat([y_mix, zeros], dim=1)
        out_len = torch.where((hpr > 0) & (vr > 0), rsr - lsr, 0)
        out = ypad.gather(1, lsr + t)
        pcm[k] = torch.where(t < out_len, out, 0.0)
        lap_new = torch.where(ih < rer - rsr, ypad.gather(1, rsr + ih), 0.0)
        lap = torch.where(vr > 0, lap_new, lap)
        lap_len = torch.where(valid[k] > 0, re[k] - rs[k], lap_len)
        had_prev = torch.where(valid[k] > 0, 1, had_prev).to(torch.int32)
    return pcm, lap, lap_len.to(torch.int32), had_prev
