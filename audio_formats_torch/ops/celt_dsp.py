"""CELT synthesis on the device for the Opus lockstep group: the IMDCT
half-transform and the windowed overlap-add (the JAX package's
ops/celt_dsp.py:46 ``celt_imdct_ola``), K12a.

``celt_imdct_ola_packed`` returns the output and the new tail as one
packed [B, frame + 60] tensor, JAX's own ``buf[:, :frame + 60]`` (and
``celt_imdct_ola`` its two column slices): the half-transforms sit at
columns [60, 60 + frame) and the window mix rewrites the first 120
samples of each block.  Two routes, by the block size alone:

* bs == 120 (every short-block frame, and LM0): ``imdct_ola_short``, on a
  CUDA device one launch of K12a's fused kernel (``af_celt_imdct_ola`` of
  ``csrc/celt_ola.cu``), from the spectra to the packed buffer.  Its dot
  products sum in another order than a matmul: it is held to the twin
  within 1e-6 of the peak.
* bs >= 240 (a long block): the IMDCT is one full-float32 ``torch.mm``
  against ``imdct_basis`` (the closed form of models/celt.py
  ``imdct_half``, as the reference's einsum at ``Precision.HIGHEST``),
  written straight into the packed buffer's columns [60, 60 + bs); then
  ``celt_ola`` mixes in place, on a CUDA device K12a's ``af_celt_ola``.

On a CUDA device the matmuls refuse to run with TF32 matmuls allowed.  On
the CPU both routes are the plain twin, ``celt_imdct_ola_packed_torch``,
whose mix is ``celt_ola_inplace_torch`` (``celt_ola_torch`` in place).  ``IMDCT_OLA_LAUNCHES`` and ``OLA_LAUNCHES``
count the two kernels' launches.

Because a block is never shorter than the overlap (bs >= 120), every output
sample depends on at most two IMDCT samples: block j's first 120 samples
are the window mix of the previous block's last 60 raw samples (the carried
tail for j = 0) with its own first 60, and the rest of the block is the
half-transform itself; the new tail is the last block's last 60 raw
samples.

The pitch postfilter and the deemphasis of the decode paths are
data-dependent IIRs that stay on the host, in the C stage (models/celt.py
``apply_raw``), as in the JAX package.  Its device deemphasis,
``deemphasis_scan`` (on no decode path there either), is ported as K12b,
the hand-written kernel of ``csrc/celt_deemph.cu``, with its plain PyTorch
twin ``deemphasis_scan_torch``; ``DEEMPH_LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..models.celt import DEEMPH_COEFF, OVERLAP, imdct_half
from ..utils.tables import celt_tables as CT
from . import _kernels
from .mp3_dsp import device_const, full_fp32
from .pcm import _fma_f32

#: launches of K12a's in-place window mix (af_celt_ola) in this process
OLA_LAUNCHES = 0
#: launches of K12a's fused short-block IMDCT and mix (af_celt_imdct_ola)
IMDCT_OLA_LAUNCHES = 0
#: launches of K12b (af_celt_deemph) in this process
DEEMPH_LAUNCHES = 0
_launch_lock = threading.Lock()

HALF = OVERLAP // 2
#: DEEMPH_COEFF rounded to f32, as K12b takes it
_DEEMPH_C = float(np.float32(DEEMPH_COEFF))
#: the CELT window, f32 [OVERLAP]
WINDOW_F32 = CT.WINDOW.astype(np.float32)
#: the short blocks of ``imdct_ola_short``: 1, 2, 4 or 8 of OVERLAP
SHORT_BLOCKS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def imdct_basis(blocksize: int) -> np.ndarray:
    """Real [blocksize, blocksize] matrix M with half = X @ M.T, equal to
    the reference IMDCT half transform (middle half of the 2N-point
    IMDCT): the JAX package's build, column by column."""
    M = np.zeros((blocksize, blocksize), np.float32)
    for k in range(blocksize):
        e = np.zeros(blocksize)
        e[k] = 1.0
        M[:, k] = imdct_half(e, blocksize, 1.0)
    return M


@functools.lru_cache(maxsize=None)
def _short_basis_t() -> np.ndarray:
    """M.T of the short block, [k, m]: the layout the fused kernel stages."""
    return np.ascontiguousarray(imdct_basis(OVERLAP).T)


def imdct_halves(coeffs: torch.Tensor, blocks: int, blocksize: int,
                 scale: float = 1.0) -> torch.Tensor:
    """The IMDCT half-transform of every block: coeffs [B, blocks *
    blocksize] f32 (short blocks interleaved as the bitstream defines) →
    halves [B, blocks, blocksize], one full-float32 matmul."""
    dev = coeffs.device
    full_fp32(dev, "CELT IMDCT")
    B = coeffs.shape[0]
    X = coeffs.reshape(B, blocksize, blocks).transpose(1, 2) \
        if blocks > 1 else coeffs.reshape(B, 1, blocksize)
    M = device_const(imdct_basis(blocksize), dev)
    return torch.matmul(X * scale, M.T)


def _packed_halves(coeffs, blocks: int, blocksize: int, scale):
    """A packed [B, frame + HALF] f32 buffer holding the IMDCT
    half-transforms at columns [HALF, HALF + frame), its first HALF
    columns unset: one long block goes through one ``torch.mm`` that
    writes there (the view's row stride is cuBLAS's ldc), short blocks
    through ``imdct_halves`` and a copy."""
    B = coeffs.shape[0]
    frame = blocks * blocksize
    buf = torch.empty((B, frame + HALF), dtype=torch.float32,
                      device=coeffs.device)
    if blocks == 1:
        full_fp32(coeffs.device, "CELT IMDCT")
        M = device_const(imdct_basis(blocksize), coeffs.device)
        torch.mm(coeffs if scale == 1.0 else coeffs * scale, M.T,
                 out=buf[:, HALF:])
    else:
        buf[:, HALF:].unflatten(1, (blocks, blocksize)).copy_(
            imdct_halves(coeffs, blocks, blocksize, scale))
    return buf


def celt_imdct_ola_packed(coeffs, tail, blocks: int, blocksize: int,
                          scale=1.0) -> torch.Tensor:
    """``celt_imdct_ola``'s output and new tail as the one packed
    [B, frame + OVERLAP//2] tensor that holds them (what a decode
    downloads): blocks of OVERLAP through ``imdct_ola_short``, longer
    ones through the matmul and ``celt_ola``; K12a on a CUDA device, the
    twin on the CPU."""
    if blocksize == OVERLAP:
        return imdct_ola_short(coeffs, tail, blocks, scale)
    return celt_ola(_packed_halves(coeffs, blocks, blocksize, scale), tail,
                    blocks)


def celt_imdct_ola_packed_torch(coeffs, tail, blocks: int, blocksize: int,
                                scale=1.0) -> torch.Tensor:
    """Plain twin of ``celt_imdct_ola_packed`` on any device: the IMDCT
    matmul into the packed buffer, then ``celt_ola_inplace_torch``."""
    return celt_ola_inplace_torch(
        _packed_halves(coeffs, blocks, blocksize, scale), tail, blocks)


def celt_imdct_ola(coeffs, tail, blocks: int, blocksize: int, scale=1.0):
    """Batched CELT IMDCT + windowed overlap-add.

    coeffs: [B, frame] f32 denormalized spectrum (frame = blocks *
            blocksize, short blocks interleaved)
    tail:   [B, OVERLAP//2] f32 raw un-windowed tail carried from the
            previous frame
    Returns (out [B, frame] pre-postfilter samples, new_tail
    [B, OVERLAP//2]): the two column slices of
    ``celt_imdct_ola_packed``."""
    buf = celt_imdct_ola_packed(coeffs, tail, blocks, blocksize, scale)
    return buf[:, :blocks * blocksize], buf[:, blocks * blocksize:]


def celt_imdct_ola_torch(coeffs, tail, blocks: int, blocksize: int,
                         scale=1.0):
    """Plain twin of ``celt_imdct_ola`` on any device: the column slices
    of ``celt_imdct_ola_packed_torch``."""
    buf = celt_imdct_ola_packed_torch(coeffs, tail, blocks, blocksize, scale)
    return buf[:, :blocks * blocksize], buf[:, blocks * blocksize:]


def celt_ola_torch(halves: torch.Tensor, tail: torch.Tensor):
    """The window mix (and the JAX package's unrolled overlap-add,
    ops/celt_dsp.py:71-82): halves [B, blocks, bs] f32, tail [B, 60] f32 →
    (out [B, blocks * bs], new_tail [B, 60]).  With b0 the previous raw
    samples (tail, or the previous block's last 60), b1 = the block's
    first 60 reversed and u < 60,

      out[j·bs + u]       = fma(b0[u], w[119-u], -(b1[u]·w[u]))
      out[j·bs + 119 - u] = fma(b1[u], w[119-u],   b0[u]·w[u])
      out[j·bs + 120 + i] = halves[j][60 + i],  i < bs - 120

    each product rounded to f32 and each FMA rounded once: the form XLA
    computes on the CPU, where it contracts the reference's
    ``b0·w[119-u] - b1·w[u]`` and ``b0·w[u] + b1·w[119-u]``."""
    B, blocks, bs = halves.shape
    w = device_const(WINDOW_F32, halves.device)
    w_up, w_down = w[:HALF], w.flip(0)[:HALF]   # w[u], w[119-u]
    b0 = torch.cat([tail[:, None, :], halves[:, :-1, bs - HALF:]], dim=1)
    b1 = halves[:, :, :HALF].flip(-1)
    lo = _fma_f32(b0, w_down, -(b1 * w_up))
    hi = _fma_f32(b1, w_down, b0 * w_up).flip(-1)
    out = torch.cat([lo, hi, halves[:, :, HALF:bs - HALF]], dim=-1)
    return out.reshape(B, blocks * bs), halves[:, -1, bs - HALF:].clone()


def celt_ola_inplace_torch(buf: torch.Tensor, tail: torch.Tensor,
                           blocks: int):
    """Twin of K12a's in-place mix: buf [B, frame + 60] f32 holding the
    half-transforms at [60, 60 + frame) gets ``celt_ola_torch``'s output
    in its first `frame` columns (the new tail is already in its last
    60).  Returns buf."""
    B, width = buf.shape
    frame = width - HALF
    out, _ = celt_ola_torch(buf[:, HALF:].unflatten(
        1, (blocks, frame // blocks)), tail)
    buf[:, :frame] = out
    return buf


def celt_ola(buf: torch.Tensor, tail: torch.Tensor, blocks: int = 1):
    """The window mix of ``celt_ola_inplace_torch``, in place in the
    packed buf [B, blocks·bs + 60] (bs >= 120): K12a's ``af_celt_ola`` on
    a CUDA device (it raises where the kernel does not build or launch),
    the twin on the CPU.  Returns buf."""
    global OLA_LAUNCHES
    dev = buf.device
    if dev.type == "cpu":
        return celt_ola_inplace_torch(buf, tail, blocks)
    if buf.dim() != 2 or blocks < 1:
        raise _kernels.KernelArgError(f"celt_ola: buf has shape "
                                      f"{list(buf.shape)} for {blocks} "
                                      "blocks, want [B, blocks * bs + 60]")
    B, width = buf.shape
    frame = width - HALF
    bs = frame // blocks if frame > 0 else 0
    if bs < OVERLAP or bs * blocks != frame:
        raise _kernels.KernelArgError(
            f"celt_ola: a row of {width} is not {blocks} blocks of at least "
            f"{OVERLAP} and the {HALF}-sample tail")
    f32 = (torch.float32,)
    _kernels.check_args("celt_ola", dev, (
        ("buf", buf, f32, (B, width)), ("tail", tail, f32, (B, HALF))))
    if B:
        _, fn, win, _ = _entry(dev)
        _run(dev, fn, "celt_ola", (buf.data_ptr(), tail.data_ptr(), win, B,
                                   blocks, bs))
        with _launch_lock:
            OLA_LAUNCHES += 1
    return buf


def imdct_ola_short(coeffs: torch.Tensor, tail: torch.Tensor, blocks: int,
                    scale=1.0) -> torch.Tensor:
    """The whole stage for blocks of OVERLAP: coeffs [B, blocks·120]
    (interleaved), tail [B, 60] → the packed [B, blocks·120 + 60] output
    of ``celt_imdct_ola_torch``.  K12a's fused ``af_celt_imdct_ola`` on a
    CUDA device (it raises where the kernel does not build or launch), the
    twin on the CPU."""
    dev = coeffs.device
    if dev.type == "cpu":
        return celt_imdct_ola_packed_torch(coeffs, tail, blocks, OVERLAP,
                                           scale)
    out = torch.empty((coeffs.shape[0], blocks * OVERLAP + HALF),
                      dtype=torch.float32, device=dev)
    imdct_ola_short_launch(coeffs, tail, blocks, scale, out)
    return out


def imdct_ola_short_launch(coeffs, tail, blocks: int, scale, out) -> None:
    """K12a's fused kernel into a made packed output `out` [B, blocks·120
    + 60], on coeffs' CUDA device."""
    global IMDCT_OLA_LAUNCHES
    dev = coeffs.device
    if coeffs.dim() != 2 or blocks not in SHORT_BLOCKS:
        raise _kernels.KernelArgError(
            f"celt_imdct_ola: coeffs {list(coeffs.shape)} in {blocks} "
            f"blocks, want [B, blocks * {OVERLAP}] and blocks in "
            f"{SHORT_BLOCKS}")
    B = coeffs.shape[0]
    frame = blocks * OVERLAP
    f32 = (torch.float32,)
    _kernels.check_args("celt_imdct_ola", dev, (
        ("coeffs", coeffs, f32, (B, frame)), ("tail", tail, f32, (B, HALF)),
        ("out", out, f32, (B, frame + HALF))))
    if coeffs.data_ptr() % 16:
        raise _kernels.KernelArgError("celt_imdct_ola: coeffs must start "
                                      "on a 16-byte boundary")
    if B == 0:
        return
    fn, _, win, basis_t = _entry(dev)
    _run(dev, fn, "celt_imdct_ola", (
        coeffs.data_ptr(), tail.data_ptr(), basis_t, win, out.data_ptr(), B,
        blocks, float(scale)))
    with _launch_lock:
        IMDCT_OLA_LAUNCHES += 1


def _run(dev, fn, name, args) -> None:
    """Call a kernel library's entry on dev's current stream and raise on
    its CUDA error code."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch(name, rc)


@functools.lru_cache(maxsize=None)
def _entry(dev: torch.device):
    """K12a's C entries (the fused short-block route, the in-place mix)
    and the addresses of the window's and the transposed short basis's
    constants on `dev`."""
    lib = _kernels.load("celt_ola")
    return (lib.af_celt_imdct_ola, lib.af_celt_ola,
            device_const(WINDOW_F32, dev).data_ptr(),
            device_const(_short_basis_t(), dev).data_ptr())


def deemphasis_scan_torch(x: torch.Tensor, m0: torch.Tensor):
    """Twin of K12b (and of the JAX package's ops/celt_dsp.py:85
    ``deemphasis_scan``): x [B, n] f32, m0 [B] f32 (the carried memory,
    pre-multiplied by c) → (y / 32768 [B, n], m = c·y[n-1] [B]) with
    y[i] = x[i] + c·y[i-1] and c·y[-1] = m0.  The plain recurrence, a
    sample at a time, each product and sum rounded to f32."""
    c = torch.tensor(DEEMPH_COEFF, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    v = m0.clone()
    for i in range(x.shape[1]):
        yi = x[:, i] + v
        y[:, i] = yi
        v = c * yi
    return y / 32768.0, v


def deemphasis_scan(x: torch.Tensor, m0: torch.Tensor):
    """The deemphasis of ``deemphasis_scan_torch``: K12b on a CUDA device
    (it raises where the kernel does not build or launch), the twin on the
    CPU.  x may be a column slice of a wider buffer (rows by stride, as
    ``deemphasis_launch`` takes them); y comes back contiguous."""
    if x.device.type == "cpu":
        return deemphasis_scan_torch(x, m0)
    out = (torch.empty(x.shape, dtype=x.dtype, device=x.device),
           torch.empty_like(m0))
    deemphasis_launch(x, m0, out)
    return out


def _refuse_rows(x, y) -> None:
    """Raise KernelArgError for the row layout ``deemphasis_launch``
    refuses: samples not side by side in a row of x or y, or rows of y
    that overlap."""
    for name, t in (("x", x), ("y", y)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise _kernels.KernelArgError(
                f"celt_deemph: {name} has element stride {t.stride(1)}, "
                "want its rows contiguous")
    raise _kernels.KernelArgError(f"celt_deemph: y's rows overlap (row "
                                  f"stride {y.stride(0)} < {y.shape[1]})")


def deemphasis_launch(x, m0, out) -> None:
    """K12b into made outputs out = (y [B, n], m [B]), on x's CUDA device.
    x and y are taken by rows: each row's samples contiguous, the rows at
    any stride (y's far enough apart not to overlap), so that x can be
    ``celt_imdct_ola``'s output, a column slice of its packed buffer."""
    global DEEMPH_LAUNCHES
    dev = x.device
    y, m = out
    if x.dim() != 2:
        raise _kernels.KernelArgError(f"celt_deemph: x has shape "
                                      f"{list(x.shape)}, want [B, n]")
    B, n = x.shape
    # the rows K12b takes (check_args leaves x's and y's layout to this)
    if n and y.shape == x.shape and not (
            (n == 1 or x.stride(1) == y.stride(1) == 1)
            and (B < 2 or y.stride(0) >= n)):
        _refuse_rows(x, y)
    f32 = (torch.float32,)
    _kernels.check_args("celt_deemph", dev, (
        ("x", x, f32, (B, n)), ("m0", m0, f32, (B,)),
        ("y", y, f32, (B, n)), ("m", m, f32, (B,))), rows=("x", "y"))
    if B == 0:
        return
    _run(dev, _kernels.load("celt_deemph").af_celt_deemph, "celt_deemph",
         (x.data_ptr(), x.stride(0), m0.data_ptr(), y.data_ptr(),
          y.stride(0), m.data_ptr(), B, n, _DEEMPH_C))
    with _launch_lock:
        DEEMPH_LAUNCHES += 1
