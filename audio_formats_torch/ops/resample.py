"""Integer-factor polyphase upsampling for the SILK 8/12/16 kHz -> 48 kHz
output path (reference: dopus.d OpusResampler, a speex-style windowed sinc,
dopus.d:5381+; rebuilt here as a dense polyphase FIR so the device path is
one matmul per block).

SILK internal rates divide 48000 exactly, so upsampling is pure polyphase
interpolation by R in {6, 4, 3}: out[n*R + p] = sum_k h[p + R*k] x[n - k].
The kernel is a Kaiser-windowed sinc; latency is compensated so the
resampler is zero-delay end to end, plus an explicit per-bandwidth
alignment delay matching the libopus decoder's SILK path (so Ogg preskip
trims the same audio a libopus-based player would).

The per-stream read's resamplers are the numpy half of the JAX package's
ops/resample.py, copied.  ``BatchedFittedUpsampler`` is the SILK and hybrid
lockstep groups' upsample: its state stays on the host in float64, and
each packet step's polyphase convolution (the JAX package's
``_poly_conv_rows``, an XLA conv) runs as ``silk_upsample``: on a CUDA
device K13, the hand-written kernel of ``csrc/silk_upsample.cu``; on the
CPU its plain PyTorch twin ``silk_upsample_torch``.  ``UPSAMPLE_LAUNCHES``
counts K13's launches.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import _kernels
from .mp3_dsp import full_fp32

# taps per polyphase branch; total kernel length = 2 * K * R
K = 8


def _kernel(ratio: int) -> np.ndarray:
    n = 2 * K * ratio
    t = (np.arange(n) - (n - 1) / 2.0) / ratio
    cutoff = 0.94
    h = cutoff * np.sinc(cutoff * t)
    beta = 9.0
    w = np.kaiser(n, beta)
    h = h * w
    # normalize each polyphase branch to unit DC gain
    return h


class PolyphaseUpsampler:
    """Streaming upsampler by an integer ratio with zero net latency.

    Group delay of the kernel is K input samples; the first K*ratio output
    samples are dropped once at stream start, and `extra_delay` output
    samples of silence are inserted instead (to mirror the reference
    decoder chain's SILK alignment).
    """

    def __init__(self, ratio: int, extra_delay: int = 0):
        self.ratio = ratio
        h = _kernel(ratio)
        # polyphase matrix: phases[p][k] = h[p + ratio*k], k = 0..2K-1
        self.phases = np.stack(
            [h[p::ratio] for p in range(ratio)]
        )  # [ratio, 2K]
        self.hist = np.zeros(2 * K)
        self._primed = False
        self.extra_delay = extra_delay
        self._carry = np.zeros(0)

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [n] float; returns [n * ratio] float (after stream warmup the
        mapping is exactly ratio samples out per sample in)."""
        n = x.shape[0]
        buf = np.concatenate([self.hist, x])
        # out[m*R + p] = sum_k phases[p][k] * buf[m + (2K-1) - k]
        # via sliding windows: W[m] = buf[m : m + 2K] reversed
        W = np.lib.stride_tricks.sliding_window_view(buf, 2 * K)[:n]
        y = W[:, ::-1] @ self.phases.T  # [n, ratio]
        y = y.reshape(-1)
        self.hist = buf[-2 * K :]
        if not self._primed:
            self._primed = True
            drop = K * self.ratio - self.extra_delay
            lead = np.zeros(max(0, -drop))
            y = np.concatenate([lead, y[max(0, drop) :]])
        # emit at most n*ratio samples per call so packet sample counts
        # stay exact across the stream (surplus from the alignment delay
        # is carried and drained by flush() at EOS / dropped at a mode
        # switch, where the reference crossfades anyway)
        y = np.concatenate([self._carry, y])
        take = n * self.ratio
        self._carry = y[take:]
        return y[:take]

    def flush(self, count: int) -> np.ndarray:
        """Drain `count` more output samples (tail at end of stream)."""
        x = np.zeros((count + self.ratio - 1) // self.ratio + 2 * K)
        n = x.shape[0]
        buf = np.concatenate([self.hist, x])
        W = np.lib.stride_tricks.sliding_window_view(buf, 2 * K)[:n]
        y = (W[:, ::-1] @ self.phases.T).reshape(-1)
        self.hist = buf[-2 * K :]
        y = np.concatenate([self._carry, y])
        self._carry = np.zeros(0)
        return y[:count]


# ---------------------------------------------------------------------------
# Exact mirror of the reference's OpusResampler (the speex-style windowed
# sinc, dopus.d:5381-6240) at quality 3 (Voip) — the quality the reference's
# Opus decoder uses for the SILK 8/12/16 kHz -> 48 kHz path
# (dopus.d:6326: `s.flr.setup(chans, silk_samplerate, 48000, 3)`).
#
# For these integer upsampling ratios the speex state machine reduces to
# the "basic direct" float path (dopus.d:6097): intAdvance = 0,
# fracAdvance = 1, a [denRate, 48] sinc table, and per-output
#   out[m] = Σ_j sinc[frac_m, j] · x[last_m + j]
# with last advancing one input sample every denRate outputs.  The decoder
# feeds silk_resample_delay[bw] samples of silence at init
# (dopus.d:6331/6243) so output aligns with libopus' own SILK resampler.
# ---------------------------------------------------------------------------

_KAISER8 = np.array([
    0.99635258, 1.00000000, 0.99635258, 0.98548012, 0.96759014, 0.94302200,
    0.91223751, 0.87580811, 0.83439927, 0.78875245, 0.73966538, 0.68797126,
    0.63451750, 0.58014482, 0.52566725, 0.47185369, 0.41941150, 0.36897272,
    0.32108304, 0.27619388, 0.23465776, 0.19672670, 0.16255380, 0.13219758,
    0.10562887, 0.08273982, 0.06335451, 0.04724088, 0.03412321, 0.02369490,
    0.01563093, 0.00959968, 0.00527363, 0.00233883, 0.00050000, 0.00000000,
    0.0, 0.0, 0.0, 0.0])  # padded: computeFunc reads table[ind..ind+3]
_K8_OVERSAMPLE = 32


def _compute_func(x: float) -> float:
    """dopus.d computeFunc: cubic interpolation into the Kaiser8 table."""
    y = np.float32(x) * _K8_OVERSAMPLE
    ind = int(np.floor(y))
    frac = float(np.float32(y - ind))
    f2 = frac * frac
    f3 = f2 * frac
    interp3 = -0.1666666667 * frac + 0.1666666667 * f3
    interp2 = frac + 0.5 * f2 - 0.5 * f3
    interp0 = -0.3333333333 * frac + 0.5 * f2 - 0.1666666667 * f3
    interp1 = 1.0 - interp3 - interp2 - interp0
    t = _KAISER8
    return (interp0 * t[ind] + interp1 * t[ind + 1]
            + interp2 * t[ind + 2] + interp3 * t[ind + 3])


def _speex_sinc(cutoff: float, x: float, N: int) -> float:
    ax = abs(np.float32(x))
    if ax < 1.0e-6:
        return np.float32(cutoff)
    if ax > 0.5 * N:
        return np.float32(0.0)
    xx = np.float32(x) * np.float32(cutoff)
    pixx = np.pi * float(xx)
    return np.float32(
        cutoff * np.sin(pixx) / pixx * _compute_func(2.0 * float(ax) / N)
    )


class SpeexResampler:
    """Reference-exact OpusResampler at quality 3, upsampling to 48 kHz.

    State mirrors the D struct: a (filterLen-1)-sample history, lastSample
    initialized to filterLen/2 (skipZeros), sampFracNum phase.  The decoder
    wrapper must feed silk_resample_delay[bw] zeros once after (re)init
    (opus_init_resample, dopus.d:6315-6338)."""

    QUALITY_N = 48      # qualityMap[3].baseLength
    CUTOFF = 0.917      # qualityMap[3].upsampleBandwidth

    def __init__(self, in_rate: int, out_rate: int = 48000):
        import math

        self.in_rate = in_rate
        g = math.gcd(in_rate, out_rate)
        self.num = in_rate // g
        self.den = out_rate // g
        assert self.num == 1 and self.den in (3, 4, 6), \
            "SILK rates divide 48000"
        N = self.QUALITY_N
        table = np.zeros((self.den, N), np.float32)
        for i in range(self.den):
            for j in range(N):
                table[i, j] = _speex_sinc(
                    self.CUTOFF, (j - N // 2 + 1) - i / float(self.den), N)
        self.table = table
        self.hist = np.zeros(N - 1, np.float32)
        self.last = N // 2          # skipZeros
        self.frac = 0

    def reset(self):
        self.hist[:] = 0
        self.last = self.QUALITY_N // 2
        self.frac = 0

    def process(self, x: np.ndarray, out_max: int) -> np.ndarray:
        """Mirror of swrconvert for one channel: consumes as much of ``x``
        as fits, produces at most ``out_max`` samples (float32)."""
        N = self.QUALITY_N
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        buf = np.concatenate([self.hist, x])
        # number of producible outputs: first m with last_m >= n
        m_stop = max(0, (n - self.last) * self.den - self.frac)
        n_out = min(out_max, m_stop)
        if n_out > 0:
            m = np.arange(n_out)
            fr = self.frac + m
            last = self.last + fr // self.den
            phase = fr % self.den
            W = np.lib.stride_tricks.sliding_window_view(buf, N)[last]
            y = np.einsum("mj,mj->m", W.astype(np.float32),
                          self.table[phase]).astype(np.float32)
        else:
            y = np.zeros(0, np.float32)
        fr_end = self.frac + n_out
        last_end = self.last + fr_end // self.den
        self.frac = fr_end % self.den
        consumed = min(n, last_end)
        self.last = last_end - consumed
        self.hist = buf[consumed : consumed + N - 1]
        return y

    def flush(self, count: int) -> np.ndarray:
        """Drain `count` more samples by feeding silence (the stream tail;
        FFmpeg's flush-the-resampler step)."""
        outs = []
        got = 0
        while got < count:
            y = self.process(np.zeros(160, np.float32), count - got)
            outs.append(y)
            got += y.shape[0]
        return (np.concatenate(outs)[:count] if outs
                else np.zeros(0, np.float32))


# ---------------------------------------------------------------------------
# libopus-identified SILK resampler (the production path).
#
# BASELINE.md's Opus contract is measured against the normative decoder at
# 48 kHz.  tools/fit_silk_resampler.py system-identifies libopus' own
# fixed-point SILK output resampler through the opus oracle (decode the
# same packets at the native rate and at 48 kHz; least-squares the LTI map)
# — the fitted polyphase kernels reproduce it to ~81 dB, libopus' own Q15
# rounding floor.  Alignment is inherent: out[den·n + p] sits at exactly
# the 48 kHz stream position libopus emits it at.
# ---------------------------------------------------------------------------

_FIT_PATH = __file__.replace("ops/resample.py",
                             "utils/tables/silk_resampler_fit.npz")
_FIT_CACHE = {}


def _fit_tables():
    if not _FIT_CACHE:
        z = np.load(_FIT_PATH)
        _FIT_CACHE.update(
            {k: z[k] for k in ("h_nb", "h_mb", "h_wb")},
            L=int(z["L"]), A=int(z["A"]),
        )
    return _FIT_CACHE


class FittedUpsampler:
    """Streaming polyphase upsampler with the libopus-identified kernels.

    out[den·n + p] = Σ_k h[p, k] · x[n + A − k]: each output group n needs
    input up to x[n+A], so the stream runs A·den samples short until EOS
    (`flush` drains the tail) — the same delayed-samples shape as the
    reference decoder (dopus.d:6393)."""

    def __init__(self, bandwidth: int):
        t = _fit_tables()
        self.h = [t["h_nb"], t["h_mb"], t["h_wb"]][bandwidth]
        self.den = self.h.shape[0]
        self.L = t["L"]
        self.A = t["A"]
        # x window for output group n: [n+A-L+1, n+A]; keep L+A history
        self._hist = np.zeros(self.L, np.float64)
        self._pending = np.zeros(0, np.float64)  # inputs not yet consumed

    def process(self, x: np.ndarray, out_max: int) -> np.ndarray:
        buf = np.concatenate([self._hist, self._pending,
                              np.asarray(x, np.float64)])
        # x-coordinate c sits at buf index c+L (hist = x[-L..-1]); output
        # group n reads the window x[n+A-L+1 .. n+A] = buf[n+A+1 : n+A+1+L]
        P = buf.shape[0] - self.L  # inputs seen so far (this buffer)
        n_groups = max(0, min(P - self.A, out_max // self.den))
        if n_groups:
            W = np.lib.stride_tricks.sliding_window_view(
                buf, self.L)[self.A + 1 : self.A + 1 + n_groups]
            # h[p, k] multiplies x[n+A-k]: reverse the tap axis
            y = W @ self.h[:, ::-1].T       # [n, den]
            y = y.reshape(-1).astype(np.float32)
        else:
            y = np.zeros(0, np.float32)
        rest = buf[n_groups:]
        self._hist = rest[: self.L]
        self._pending = rest[self.L :]
        return y

    def flush(self, count: int) -> np.ndarray:
        pad = (count + self.den - 1) // self.den + self.A + 1
        y = self.process(np.zeros(pad, np.float64), count)
        return y[:count]

    def reset(self):
        self._hist[:] = 0
        self._pending = np.zeros(0, np.float64)



class BatchedFittedUpsampler:
    """`rows` FittedUpsampler lanes in lockstep: the SILK and hybrid
    groups' upsample (the JAX package's ops/resample.py:300).

    Each ``process`` is one ``silk_upsample`` over the [rows, n_groups +
    L - 1] float32 window of every row at once (one upload, one K13 on a
    CUDA `device`, one download): out[r, n·den + p] = Σ_k h[p, k] ·
    x[r, n + A − k].  The state (hist and pending) stays on the host in
    float64 and uniform across rows, since lockstep groups feed every row
    the same block length; a lane that ends early is drained with
    ``flush_row`` (exact per-row float64) before later blocks zero-feed
    its row, so its tail equals the per-stream decoder's."""

    def __init__(self, bandwidth: int, rows: int, feed: int = 0,
                 device="cuda"):
        t = _fit_tables()
        self.h = np.asarray(
            [t["h_nb"], t["h_mb"], t["h_wb"]][bandwidth], np.float64)
        self.den = self.h.shape[0]
        self.L = int(t["L"])
        self.A = int(t["A"])
        self.rows = rows
        self.device = torch.device(device)
        self._taps = pack_taps(self.h[:, ::-1])
        self._hist = np.zeros((rows, self.L), np.float64)
        self._pending = np.zeros((rows, 0), np.float64)
        #: bytes uploaded and downloaded by ``process``
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        if feed:
            self.process(np.zeros((rows, feed), np.float64), 0)

    def process(self, x: np.ndarray, out_max: int) -> np.ndarray:
        """Feed x [rows, n] (native rate) to every row; returns the
        [rows, n_groups·den] float32 output, at most out_max a row."""
        buf = np.concatenate(
            [self._hist, self._pending, np.asarray(x, np.float64)], axis=1)
        P = buf.shape[1] - self.L
        n_groups = max(0, min(P - self.A, out_max // self.den))
        if n_groups:
            win = np.ascontiguousarray(
                buf[:, self.A + 1: self.A + 1 + n_groups + self.L - 1],
                np.float32)
            xd = torch.from_numpy(win).to(self.device)
            y = silk_upsample(xd, self._taps, n_groups).cpu().numpy()
            self.h2d_bytes += win.nbytes
            self.d2h_bytes += y.nbytes
        else:
            y = np.zeros((self.rows, 0), np.float32)
        rest = buf[:, n_groups:]
        self._hist = rest[:, : self.L]
        self._pending = rest[:, self.L:]
        return y

    def flush_row(self, r: int, count: int) -> np.ndarray:
        """Drain row r's delayed tail (FittedUpsampler.flush, float64)."""
        pad = (count + self.den - 1) // self.den + self.A + 1
        buf = np.concatenate(
            [self._hist[r], self._pending[r], np.zeros(pad)])
        P = buf.shape[0] - self.L
        n_groups = max(0, min(P - self.A, count // self.den))
        if not n_groups:
            return np.zeros(0, np.float32)
        W = np.lib.stride_tricks.sliding_window_view(
            buf, self.L)[self.A + 1: self.A + 1 + n_groups]
        y = (W @ self.h[:, ::-1].T).reshape(-1).astype(np.float32)
        return y[:count]


#: launches of K13 (af_silk_upsample) in this process
UPSAMPLE_LAUNCHES = 0
_launch_lock = threading.Lock()
#: K13's limits: the fitted kernels' taps, and the phase counts it is
#: built for (NB's, MB's and WB's 8, 12 and 16 kHz -> 48 kHz)
FIT_TAPS = 96
DENS = (6, 4, 3)


def silk_upsample_torch(x: torch.Tensor, h_rev: torch.Tensor,
                        G: int) -> torch.Tensor:
    """Twin of K13 (and of the JAX package's ``_poly_conv_rows``, a VALID
    cross-correlation): x [rows, W] f32 with W >= G + L - 1, h_rev [den, L]
    f32 (the taps, reversed) → out [rows, G·den] f32 with

      out[r, g·den + p] = Σ_{k<L} x[r, g + k] · h_rev[p, k],  g < G.

    One matmul of every row's L-sample windows against the taps, in full
    float32 (it raises on a CUDA device that allows TF32 matmuls)."""
    full_fp32(x.device, "the SILK upsample twin")
    rows = x.shape[0]
    den, L = h_rev.shape
    win = x.unfold(1, L, 1)[:, :G].reshape(rows * G, L)
    return (win @ h_rev.T).reshape(rows, G * den)


def silk_upsample(x: torch.Tensor, taps: np.ndarray,
                  G: int) -> torch.Tensor:
    """The polyphase upsample of ``silk_upsample_torch``, with the taps
    h_rev as a host array (``pack_taps``): K13 on a CUDA device (it raises
    where the kernel does not build or launch), the twin on the CPU."""
    dev = x.device
    if dev.type == "cpu":
        return silk_upsample_torch(x, torch.as_tensor(taps), G)
    out = torch.empty((x.shape[0], G * taps.shape[0]), dtype=torch.float32,
                      device=dev)
    silk_upsample_launch(x, taps, G, out)
    return out


def silk_upsample_launch(x, taps: np.ndarray, G: int, out) -> None:
    """K13 into a made output `out` [rows, G·den], on x's CUDA device;
    taps: the host array of ``pack_taps``, which the kernel takes by
    value."""
    global UPSAMPLE_LAUNCHES
    dev = x.device
    if not (isinstance(taps, np.ndarray) and taps.dtype == np.float32
            and taps.flags.c_contiguous):
        raise _kernels.KernelArgError(
            "silk_upsample: taps must be a contiguous float32 host array "
            "(pack_taps), want [den, L]")
    if x.dim() != 2 or taps.ndim != 2:
        raise _kernels.KernelArgError(
            f"silk_upsample: x {list(x.shape)}, taps {list(taps.shape)}, "
            "want [rows, W] and [den, L]")
    rows, W = x.shape
    den, L = taps.shape
    if not (den in DENS and L == FIT_TAPS and G >= 1 and W >= G + L - 1):
        raise _kernels.KernelArgError(
            f"silk_upsample: {G} groups of {den} phases from rows of {W} "
            f"with {L} taps, want den in {DENS}, {FIT_TAPS} taps and "
            "W >= G + L - 1")
    f32 = (torch.float32,)
    _kernels.check_args("silk_upsample", dev, (
        ("x", x, f32, (rows, W)), ("out", out, f32, (rows, G * den))))
    if rows == 0:
        return
    args = (x.data_ptr(), taps.ctypes.data, out.data_ptr(), rows, W, G, den)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = _entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("silk_upsample", rc)
    with _launch_lock:
        UPSAMPLE_LAUNCHES += 1


def pack_taps(h_rev: np.ndarray) -> np.ndarray:
    """K13's by-value tap parameter: h_rev [den, FIT_TAPS] (the taps, tap
    axis reversed) as a contiguous f32 host array; the kernel reads tap k
    of phase p at p·FIT_TAPS + k."""
    return np.ascontiguousarray(h_rev, np.float32)


@functools.lru_cache(maxsize=None)
def _entry():
    """K13's C entry."""
    return _kernels.load("silk_upsample").af_silk_upsample
