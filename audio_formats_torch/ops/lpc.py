"""FLAC LPC synthesis and the post-LPC device stages, in PyTorch.

FLAC reconstructs each sample as ``residual[t] + (Σ coef[j]·s[t-1-j]) >> shift``
(drflac__calculate_prediction_32, drflac.d:1060).  CONSTANT / VERBATIM /
FIXED / LPC subframes all reduce to this one recurrence:

* CONSTANT/VERBATIM → order = blocksize (every sample passes through)
* FIXED k           → the constant coefficient rows below, shift 0
* LPC               → coded coefficients and shift

The per-step truncating shift makes the recurrence non-linear, so it runs
sequentially in time, one lane per (frame, channel) subframe.  Arithmetic
follows drflac's per-subframe dispatch (drflac.d:1055-1110): lanes with
bits-per-sample <= 16 sum in int32 with wraparound, wider (``exact``) lanes
take the exact sum.

``flac_lpc`` dispatches on the tensor's device: a CPU tensor takes the plain
twin ``flac_lpc_torch``; a CUDA tensor takes the hand-written kernel
(``csrc/flac_lpc.cu``), its lanes grouped by kind by a plan kernel whose
plain twin is ``lpc_lane_perm``, or raises.  ``KERNEL_LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _kernels

# Fixed-predictor coefficients (drflac.d:1397-equivalent; FLAC spec):
# s[t] = k-th order polynomial predictor + residual, shift 0.
FIXED_COEFFS = np.zeros((5, 32), dtype=np.int32)
FIXED_COEFFS[1, :1] = [1]
FIXED_COEFFS[2, :2] = [2, -1]
FIXED_COEFFS[3, :3] = [3, -3, 1]
FIXED_COEFFS[4, :4] = [4, -6, 4, -1]

MAX_ORDER = 32

#: launches of the CUDA LPC kernel in this process
KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()

_MASK32 = 0xFFFFFFFF


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (kept as int64)."""
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def _lanes(residual, coeffs, order, shift, exact):
    """numpy arrays → CPU tensors; nothing moves between devices."""
    residual, coeffs, order, shift = (
        torch.as_tensor(x) for x in (residual, coeffs, order, shift))
    if exact is None:
        exact = torch.zeros(residual.shape[0], dtype=torch.bool,
                            device=residual.device)
    return residual, coeffs, order, shift, torch.as_tensor(exact)


def flac_lpc(residual, coeffs, order, shift, exact=None):
    """LPC synthesis over lanes with drflac's dual arithmetic semantics.

    residual: [L, B] int32 — residuals; positions t < order[l] hold the
              warm-up samples verbatim.
    coeffs:   [L, 32] int32 — coeffs[l, j] multiplies s[t-1-j]; zero-padded
              past the order.
    order:    [L] int32; shift: [L] int32 (non-negative).
    exact:    optional [L] bool — lanes needing drflac's exact prediction
              (subframe bps > 16).  False lanes use int32 wraparound.

    Takes numpy arrays or tensors; numpy arrays are read as CPU tensors.
    Returns samples [L, B] int32 on the residual's device.
    """
    residual, coeffs, order, shift, exact = _lanes(
        residual, coeffs, order, shift, exact)
    if residual.device.type == "cpu":
        return flac_lpc_torch(residual, coeffs, order, shift, exact)
    if residual.device.type == "cuda":
        return flac_lpc_cuda(residual, coeffs, order, shift, exact)
    raise _kernels.KernelArgError(
        f"flac_lpc: no kernel for device {residual.device}")


def flac_lpc_torch(residual, coeffs, order, shift, exact=None):
    """Plain PyTorch twin of the CUDA kernel: same contract as flac_lpc.

    The prediction sums in int64; wrap lanes keep its low 32 bits (equal
    to an int32 wraparound sum), exact lanes shift the full sum.  Exact
    for coefficients below 2^31/32 in magnitude, which covers FLAC's
    15-bit precision.  A Python loop over time: the test oracle and the
    on-card comparison, never the CUDA main path."""
    residual, coeffs, order, shift, exact = _lanes(
        residual, coeffs, order, shift, exact)
    L, B = residual.shape
    dev = residual.device
    c = coeffs.to(torch.int64)
    sh = shift.to(torch.int64)
    order = order.to(torch.int64)
    exact = exact.to(torch.bool)
    res = residual.to(torch.int64)
    h = torch.zeros((L, MAX_ORDER), dtype=torch.int64, device=dev)
    out = torch.empty((L, B), dtype=torch.int32, device=dev)
    for t in range(B):
        acc = (h * c).sum(dim=1)
        pred = torch.where(exact, acc >> sh, _wrap32(acc) >> sh)
        r = res[:, t]
        s = torch.where(t < order, r, _wrap32(r + pred))
        out[:, t] = s.to(torch.int32)
        h = torch.cat([s[:, None], h[:, :-1]], dim=1)
    return out


def lpc_lane_key(coeffs, order, exact, B: int) -> torch.Tensor:
    """Each lane's kind, the key the CUDA kernel's warps are grouped by:
    0 for a lane that only copies its residual (order >= B, or no nonzero
    coefficient), else 2·b - 1 + exact for tap bucket b = 1..5 (its last
    nonzero coefficient within 4, 8, 12, 16 or 32 taps).  [L] int64."""
    taps = torch.where(coeffs != 0, torch.arange(1, MAX_ORDER + 1,
                                                 device=coeffs.device), 0)
    taps = torch.where(order >= B, 0, taps.amax(1))
    b = ((taps + 3) >> 2).clamp(max=5)
    return torch.where(b == 0, 0, 2 * b - 1 + exact.to(torch.int64))


def lpc_lane_perm(coeffs, order, exact, B: int) -> torch.Tensor:
    """A permutation of the lanes that groups them by lpc_lane_key (stable
    within a kind), so that 16 consecutive lanes, one warp of the kernel,
    are nearly always of one kind.  [L] int32 on the lanes' device.  The
    plain twin of lpc_plan_cuda, which the CUDA path takes."""
    key = lpc_lane_key(coeffs, order, exact, B)
    return torch.argsort(key, stable=True).to(torch.int32)


def flac_lpc_cuda(residual, coeffs, order, shift, exact):
    """Launch the CUDA LPC kernel (csrc/flac_lpc.cu) on the tensors' card,
    on that card's current stream, its lanes grouped by kind (the plan
    kernel, the card's lpc_lane_perm).  Every argument must already lie on
    one CUDA device, contiguous, with the dtypes of the flac_lpc
    contract."""
    if residual.dim() != 2:
        raise _kernels.KernelArgError("flac_lpc: residual must be [L, B]")
    L, B = residual.shape
    dev = residual.device
    _kernels.check_args("flac_lpc", dev, (
        ("residual", residual, (torch.int32,), (L, B)),
        ("coeffs", coeffs, (torch.int32,), (L, MAX_ORDER)),
        ("order", order, (torch.int32,), (L,)),
        ("shift", shift, (torch.int32,), (L,)),
        ("exact", exact, (torch.bool,), (L,)),
    ))
    out = torch.empty_like(residual)
    if L == 0 or B == 0:
        return out
    perm = torch.empty(L, dtype=torch.int32, device=dev)
    lib = _kernels.load("flac_lpc")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _plan(lib, stream, coeffs, order, exact, perm, B)
        _launch(lib, stream, residual, coeffs, order, shift, exact, perm, out)
    return out


def _plan(lib, stream, coeffs, order, exact, perm, B):
    L = coeffs.shape[0]
    scratch = torch.empty(lib.af_flac_lpc_plan_scratch(L), dtype=torch.int32,
                          device=coeffs.device)
    rc = lib.af_flac_lpc_plan(coeffs.data_ptr(), order.data_ptr(),
                              exact.data_ptr(), scratch.data_ptr(),
                              perm.data_ptr(), L, B, stream)
    _kernels.check_launch("flac_lpc plan", rc)


def _launch(lib, stream, residual, coeffs, order, shift, exact, perm, out):
    global KERNEL_LAUNCHES
    L, B = residual.shape
    rc = lib.af_flac_lpc(residual.data_ptr(), coeffs.data_ptr(),
                         order.data_ptr(), shift.data_ptr(), exact.data_ptr(),
                         perm.data_ptr(), out.data_ptr(), L, B, stream)
    _kernels.check_launch("flac_lpc", rc)
    with _launch_lock:
        KERNEL_LAUNCHES += 1


def lpc_plan_cuda(coeffs, order, exact, B: int) -> torch.Tensor:
    """The plan alone (csrc/flac_lpc.cu af_flac_lpc_plan, three small
    launches): the lane grouping of flac_lpc_cuda, lpc_lane_perm on the
    card.  Arguments as flac_lpc_cuda takes them."""
    L = coeffs.shape[0]
    dev = coeffs.device
    _kernels.check_args("flac_lpc plan", dev, (
        ("coeffs", coeffs, (torch.int32,), (L, MAX_ORDER)),
        ("order", order, (torch.int32,), (L,)),
        ("exact", exact, (torch.bool,), (L,)),
    ))
    perm = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        lib = _kernels.load("flac_lpc")
        with torch.cuda.device(dev):
            _plan(lib, torch.cuda.current_stream(dev).cuda_stream, coeffs,
                  order, exact, perm, B)
    return perm


def flac_lpc_launch(residual, coeffs, order, shift, exact, perm, out):
    """The LPC kernel's launch alone, into `out`, with the lanes in the
    order of `perm` ([L] int32, a permutation of the lanes): flac_lpc_cuda
    without its plan.  The arguments as flac_lpc_cuda checked them.
    Returns out."""
    L, B = residual.shape
    dev = residual.device
    _kernels.check_args("flac_lpc", dev, (
        ("perm", perm, (torch.int32,), (L,)),
        ("out", out, (torch.int32,), (L, B)),
    ))
    lib = _kernels.load("flac_lpc")
    with torch.cuda.device(dev):
        _launch(lib, torch.cuda.current_stream(dev).cuda_stream, residual,
                coeffs, order, shift, exact, perm, out)
    return out


def flac_lpc_np(residual, coeffs, order, shift):
    """Exact int64 host path (mirrors drflac__calculate_prediction_64,
    drflac.d:1101) for subframes with bits-per-sample > 18; also the test
    oracle for the kernel."""
    residual = np.asarray(residual, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=np.int64)
    L, B = residual.shape
    out = np.empty((L, B), dtype=np.int64)
    hist = np.zeros((L, MAX_ORDER), dtype=np.int64)
    order = np.asarray(order)
    shift = np.asarray(shift)
    for t in range(B):
        pred = (hist * coeffs).sum(axis=1) >> shift
        s = np.where(t < order, residual[:, t], residual[:, t] + pred)
        hist[:, 1:] = hist[:, :-1]
        hist[:, 0] = s
        out[:, t] = s
    return out


def flac_post_stereo_batch(samples, chan_assignment, wasted, out_shift):
    """Inter-channel decorrelation + output shift to s32, exactly as
    drflac_read_s32 (drflac.d:2884-2944): decorrelate the *unshifted*
    subframe samples, then shift each channel by
    (32 - streaminfo_bps) + wasted_bits[channel].

    samples: [S, C, B] int32; chan_assignment: [S] (8=left/side,
    9=right/side, 10=mid/side, else independent); wasted: [S, C];
    out_shift: [S] (= 32 - streaminfo bps).
    Returns [S, C, B] int32.  The arithmetic runs in int64 and wraps to
    int32 wherever the int32 reference wraps, so corrupt lanes give the
    same bits too.
    """
    samples = torch.as_tensor(samples)
    dev = samples.device
    ca = torch.as_tensor(chan_assignment, device=dev).to(torch.int64)
    wasted = torch.as_tensor(wasted, device=dev).to(torch.int64)
    out_shift = torch.as_tensor(out_shift, device=dev).to(torch.int64)
    x = samples.to(torch.int64)
    if x.shape[1] == 2:
        c0, c1 = x[:, 0], x[:, 1]
        mid = _wrap32((c0 << 1) | (c1 & 1))
        cand = (
            (ca == 8, c0, _wrap32(c0 - c1)),                  # left/side
            (ca == 9, _wrap32(c1 + c0), c1),                  # right/side
            (ca >= 10, _wrap32(mid + c1) >> 1, _wrap32(mid - c1) >> 1),
        )                                                     # mid/side
        a0, a1 = c0, c1
        for sel, d0, d1 in cand:
            a0 = torch.where(sel[:, None], d0, a0)
            a1 = torch.where(sel[:, None], d1, a1)
        x = torch.stack([a0, a1], dim=1)
    k = (out_shift[:, None] + wasted)[:, :, None]
    return _wrap32(x << k).to(torch.int32)


def flac_post_stereo(samples, chan_assignment, wasted, out_shift):
    """One frame of flac_post_stereo_batch: samples [C, B] int32, scalar
    chan_assignment and out_shift, wasted [C].  Returns [C, B] int32."""
    samples = torch.as_tensor(samples)
    dev = samples.device
    ca = torch.as_tensor(chan_assignment, device=dev).reshape(1)
    wasted = torch.as_tensor(wasted, device=dev).reshape(1, -1)
    out_shift = torch.as_tensor(out_shift, device=dev).reshape(1)
    return flac_post_stereo_batch(samples[None], ca, wasted, out_shift)[0]


def flac_post_stereo_batch_s16(samples, chan_assignment, wasted, out_shift):
    """Batch stereo decorrelation emitting int16: for lanes whose source is
    <= 16 bits the left-justified int32 output is exactly sample << 16, so
    the card can ship half the bytes to the host losslessly
    (s16 == s32 >> 16)."""
    out32 = flac_post_stereo_batch(samples, chan_assignment, wasted,
                                   out_shift)
    return (out32 >> 16).to(torch.int16)


def _u32_words(packed) -> torch.Tensor:
    """uint32 words (numpy uint32, or an int32/uint32 tensor holding their
    bits) → int64 tensor of their unsigned values."""
    if isinstance(packed, np.ndarray):
        packed = torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))
    elif packed.dtype == torch.uint32:
        packed = packed.view(torch.int32)
    return packed.to(torch.int64) & _MASK32


def flac_unpack_residuals(packed, warm, order, w: int, n: int):
    """Unpack fixed-width residual rows (af_host.cc:af_flac_pack) and merge
    the int32 warm-up side channel.

    Rows pack at the window's uniform width w, so 32 samples span exactly
    w words and every sample's word and bit offset are static.

    packed: [L, >= ceil(n·w/32)] uint32 words (numpy uint32, or a tensor
    holding their bits as int32); warm: [L, 32] int32 (samples at positions
    < min(order, 32); constant/verbatim lanes use order = n and keep
    positions >= 32 in the packed stream).
    Returns residual [L, n] int32 on packed's device.
    """
    if n % 32:
        raise ValueError(f"flac_unpack_residuals: n={n} is not a multiple "
                         "of 32")
    words = _u32_words(packed)
    L = words.shape[0]
    dev = words.device
    G = n // 32
    grp = words[:, : G * w].reshape(L, G, w)
    grp = torch.cat(
        [grp, torch.zeros((L, G, 1), dtype=torch.int64, device=dev)], dim=2)
    bit = torch.arange(32, device=dev) * w         # first bit of sample j
    wi, sh = bit >> 5, bit & 31
    a = grp[:, :, wi]
    b = grp[:, :, wi + 1]
    hi = ((a << sh) | (b >> (32 - sh))) & _MASK32  # sample j at the top
    v = hi >> (32 - w)
    v = v - ((v >> (w - 1)) << w)                  # sign-extend w bits
    res = v.reshape(L, n)
    warm = torch.as_tensor(warm, device=dev).to(torch.int64)
    order = torch.as_tensor(order, device=dev)
    pos = torch.arange(n, device=dev)[None, :]
    warm_full = torch.nn.functional.pad(warm, (0, n - 32))
    zu = torch.clamp(order, max=32)[:, None]
    return torch.where(pos < zu, warm_full, res).to(torch.int32)


def flac_merge_overflow(res_small, raw, idx):
    """Merge the overflow plane into the width-packed residual rows.

    A few rows per window need a wider residual width than the window's
    packed width; they ship separately in raw [Lb, n] (row 0 all-zero) and
    idx [L] selects them back (0 = not overflowing).  An exact row gather.
    """
    idx = torch.as_tensor(idx, device=res_small.device).to(torch.int64)
    return torch.where((idx > 0)[:, None], raw[idx], res_small)
