"""IMDCT + Vorbis window slopes.

The Vorbis IMDCT (stb_vorbis2.d:1941-2250's radix kernel) is here a single
[N/2, N] matmul per block size — block sizes are few (typically 256/2048 per
stream, spec range 64..8192) and the matrices are built lazily per size.
Spec convention (Vorbis I spec §4.3.6 / MDCT with N output samples from N/2
coefficients):

    y[n] = Σ_{k<N/2} X[k] · cos(π/(2N) · (2n + 1 + N/2) · (2k + 1))

Windows are the spec's sin(π/2·sin²(...)) slopes; overlap-add applies slopes
only in the lapped region (the reference defers windowing to finish_frame,
stb_vorbis2.d:2606-2640, which is equivalent since the window is 0/1
elsewhere).

The numpy half (the matrix, the host FFT IMDCT, the slopes, the host
overlap-add) is the JAX package's, copied.  ``imdct_batch`` is a torch
matmul in full float32: the reference pins ``Precision.HIGHEST``, so on a
CUDA device it refuses to run with TF32 matmuls allowed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .mp3_dsp import device_const, full_fp32


@functools.lru_cache(maxsize=None)
def imdct_matrix(n: int) -> np.ndarray:
    """[n/2, n] float32 IMDCT matrix for block size n.

    The phase (2t+1+m)(2k+1)·π/(2n) is periodic in 4n, so the matrix is a
    gather from a 4n-entry cosine table over an exactly-reduced integer
    phase — both faster to build than 33M transcendental evaluations (the
    8192-block matrix) and more accurate (no large-argument cos)."""
    m = n // 2
    table = np.cos(np.pi / (2.0 * n) * np.arange(4 * n)).astype(np.float32)
    a = ((2 * np.arange(n) + 1 + m) % (4 * n)).astype(np.int32)
    b = (2 * np.arange(m) + 1).astype(np.int32)
    out = np.empty((m, n), np.float32)
    step = max(1, (1 << 22) // n)  # bound temporaries to a few MB
    for r0 in range(0, m, step):
        phase = (b[r0 : r0 + step, None] * a[None, :]) % (4 * n)
        out[r0 : r0 + step] = table[phase]
    return out


@functools.lru_cache(maxsize=None)
def _imdct_fft_tables(n: int):
    """Twiddles for the FFT IMDCT: with m=n/2, A=2t+1+m,
    y[t] = Re(e^{iπA/(4m)} · H[(A-1)/2 mod 2m]) where
    H = 2m·ifft(X·e^{iπk/(2m)}, 2m).  (Same pre/post-twiddle closed form
    as models/celt.py:imdct_half, re-derived for the Vorbis kernel.)"""
    m = n // 2
    pre = np.exp(1j * np.pi * np.arange(m) / (2 * m))
    A = 2 * np.arange(n) + 1 + m
    tw = np.exp(1j * np.pi * (A % (8 * m)) / (4 * m))
    j = ((A - 1) // 2) % (2 * m)
    return pre, tw, j


def imdct_host(X: np.ndarray, n: int) -> np.ndarray:
    """Host IMDCT for the single-stream facade: per-packet device dispatch
    would pay an interconnect round-trip per packet, and a materialized
    [n/2, n] matrix is memory it doesn't need — an O(n log n) f64 FFT
    evaluates the same transform."""
    m = n // 2
    pre, tw, j = _imdct_fft_tables(n)
    z = np.zeros((X.shape[0], 2 * m), np.complex128)
    z[:, :m] = X.astype(np.float64) * pre
    H = np.fft.ifft(z, axis=1) * (2 * m)
    return (tw * H[:, j]).real.astype(np.float32)


@functools.lru_cache(maxsize=None)
def vorbis_slope(length: int) -> np.ndarray:
    """Right-rising window slope of `length` samples:
    w[j] = sin(π/2 · sin²(π/(2L)·(j+0.5)))."""
    j = np.arange(length)
    s = np.sin(np.pi / (2.0 * length) * (j + 0.5))
    return np.sin(np.pi / 2.0 * s * s).astype(np.float32)


def overlap_add(y: np.ndarray, prev: np.ndarray, left_start: int) -> None:
    """In-place lapped mix (vorbis_finish_frame, stb_vorbis2.d:2617-2627):
    y[:, left_start + j] = y[..]*w[j] + prev[:, j]*w[L-1-j], L = prev width.
    """
    L = prev.shape[1]
    if L == 0:
        return
    # clamp to the room actually available: a corrupted packet can declare
    # a short window while the carried lap is long (the reference's
    # max-blocksize-wide buffers make this harmless garbage, not a crash)
    Lu = min(L, y.shape[1] - left_start)
    if Lu <= 0:
        return
    w = vorbis_slope(L)
    seg = y[:, left_start : left_start + Lu]
    y[:, left_start : left_start + Lu] = (seg * w[:Lu] +
                                          prev[:, :Lu] * w[::-1][:Lu])


def imdct_batch(X: torch.Tensor, n: int) -> torch.Tensor:
    """Batched IMDCT for the lockstep scheduler: [L, n/2] spectra (stacked
    lane-channels) → [L, n] raw time windows in one float32 matmul, on X's
    device."""
    full_fp32(X.device, "the Vorbis IMDCT")
    return torch.matmul(X, device_const(imdct_matrix(n), X.device))
