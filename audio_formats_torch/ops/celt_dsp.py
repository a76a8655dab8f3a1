"""CELT synthesis on the device for the Opus lockstep group: the IMDCT
half-transform and the windowed overlap-add (the JAX package's
ops/celt_dsp.py:46 ``celt_imdct_ola``).

The IMDCT of a bucket's rows is one full-float32 ``torch.matmul`` against
``imdct_basis`` (the closed form of models/celt.py ``imdct_half``), as the
reference computes it with an einsum at ``Precision.HIGHEST``; on a CUDA
device it refuses to run with TF32 matmuls allowed.  The overlap-add that
follows is ``celt_ola``: on a CUDA device K12a, the hand-written kernel of
``csrc/celt_ola.cu``; on the CPU its plain PyTorch twin ``celt_ola_torch``.
``OLA_LAUNCHES`` counts K12a's launches.

Because a block is never shorter than the overlap (bs >= 120), every output
sample depends on at most two IMDCT samples: block j's first 120 samples
are the window mix of the previous block's last 60 raw samples (the carried
tail for j = 0) with its own first 60, and the rest of the block is a copy;
the new tail is the last block's last 60 raw samples.

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

#: launches of K12a (af_celt_ola) in this process
OLA_LAUNCHES = 0
#: launches of K12b (af_celt_deemph) in this process
DEEMPH_LAUNCHES = 0
_launch_lock = threading.Lock()

HALF = OVERLAP // 2
#: the CELT window, f32 [OVERLAP]
WINDOW_F32 = CT.WINDOW.astype(np.float32)


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


def celt_imdct_ola(coeffs, tail, blocks: int, blocksize: int, scale=1.0):
    """Batched CELT IMDCT + windowed overlap-add.

    coeffs: [B, frame] f32 denormalized spectrum (frame = blocks *
            blocksize, short blocks interleaved)
    tail:   [B, OVERLAP//2] f32 raw un-windowed tail carried from the
            previous frame
    Returns (out [B, frame] pre-postfilter samples, new_tail
    [B, OVERLAP//2]).  The overlap-add is K12a on a CUDA device, the twin
    on the CPU."""
    return celt_ola(imdct_halves(coeffs, blocks, blocksize, scale), tail)


def celt_imdct_ola_torch(coeffs, tail, blocks: int, blocksize: int,
                         scale=1.0):
    """Plain twin of ``celt_imdct_ola`` on any device: the same matmul,
    then ``celt_ola_torch``."""
    return celt_ola_torch(imdct_halves(coeffs, blocks, blocksize, scale),
                          tail)


def celt_ola_torch(halves: torch.Tensor, tail: torch.Tensor):
    """Twin of K12a (and of the JAX package's unrolled overlap-add,
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


def celt_ola(halves: torch.Tensor, tail: torch.Tensor):
    """The overlap-add of ``celt_ola_torch``: K12a on a CUDA device (it
    raises where the kernel does not build or launch), the twin on the
    CPU."""
    dev = halves.device
    if dev.type == "cpu":
        return celt_ola_torch(halves, tail)
    B, blocks, bs = halves.shape
    out = (torch.empty((B, blocks * bs), dtype=torch.float32, device=dev),
           torch.empty((B, HALF), dtype=torch.float32, device=dev))
    _launch(dev, halves, tail, out, ())
    return out


def celt_ola_launch(halves, tail, out) -> None:
    """K12a into made outputs: out = (out [B, blocks * bs], new_tail
    [B, 60]), on halves' CUDA device."""
    B, blocks, bs = halves.shape
    f32 = (torch.float32,)
    _launch(halves.device, halves, tail, out, (
        ("out", out[0], f32, (B, blocks * bs)),
        ("new_tail", out[1], f32, (B, HALF))))


def _launch(dev, halves, tail, out, out_checks) -> None:
    """Check the inputs (and `out_checks`: the outputs a caller made) and
    launch K12a on dev's current stream."""
    global OLA_LAUNCHES
    if halves.dim() != 3:
        raise _kernels.KernelArgError(f"celt_ola: halves has shape "
                                      f"{list(halves.shape)}, want "
                                      "[B, blocks, bs]")
    B, blocks, bs = halves.shape
    if bs < OVERLAP or blocks < 1:
        raise _kernels.KernelArgError(f"celt_ola: {blocks} blocks of {bs}, "
                                      f"want blocks of at least {OVERLAP}")
    f32 = (torch.float32,)
    _kernels.check_args("celt_ola", dev, (
        ("halves", halves, f32, (B, blocks, bs)),
        ("tail", tail, f32, (B, HALF)), *out_checks))
    if B == 0:
        return
    fn, win = _entry(dev)
    args = (halves.data_ptr(), tail.data_ptr(), win, out[0].data_ptr(),
            out[1].data_ptr(), B, blocks, bs)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("celt_ola", rc)
    with _launch_lock:
        OLA_LAUNCHES += 1


@functools.lru_cache(maxsize=None)
def _entry(dev: torch.device):
    """K12a's C entry and the address of the window's constant on `dev`."""
    return (_kernels.load("celt_ola").af_celt_ola,
            device_const(WINDOW_F32, dev).data_ptr())


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
    CPU."""
    if x.device.type == "cpu":
        return deemphasis_scan_torch(x, m0)
    out = (torch.empty_like(x), torch.empty_like(m0))
    deemphasis_launch(x, m0, out)
    return out


def deemphasis_launch(x, m0, out) -> None:
    """K12b into made outputs out = (y [B, n], m [B]), on x's CUDA
    device."""
    global DEEMPH_LAUNCHES
    dev = x.device
    if x.dim() != 2:
        raise _kernels.KernelArgError(f"celt_deemph: x has shape "
                                      f"{list(x.shape)}, want [B, n]")
    B, n = x.shape
    f32 = (torch.float32,)
    _kernels.check_args("celt_deemph", dev, (
        ("x", x, f32, (B, n)), ("m0", m0, f32, (B,)),
        ("y", out[0], f32, (B, n)), ("m", out[1], f32, (B,))))
    if B == 0:
        return
    fn = _kernels.load("celt_deemph").af_celt_deemph
    args = (x.data_ptr(), m0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, n, float(np.float32(DEEMPH_COEFF)))
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("celt_deemph", rc)
    with _launch_lock:
        DEEMPH_LAUNCHES += 1
