"""The port's CELT device stages against the JAX package's
``ops/celt_dsp.celt_imdct_ola`` and ``deemphasis_scan``, on the CPU.

The IMDCT basis is JAX's bit for bit.  The window mix (``celt_ola_torch``,
and K12a's in-place twin), fed the half-transforms that JAX's einsum
computes, gives JAX's output bit for bit: on the CPU XLA contracts the reference's window mix into
``lo = fma(b0, w[119-u], -(b1·w[u]))`` and ``hi = fma(b1, w[119-u],
b0·w[u])``, and the twin rounds those FMAs exactly.  The whole twin, whose
IMDCT is a torch matmul, cannot give XLA's einsum bits; it is held within
TOL of the peak (it stays within ~7e-7 on these inputs; JAX's own batch
against its facade is held to 1e-5, tests/test_batch.py:489-490).
The deemphasis twin (K12b's twin) steps the recurrence a sample at a time
in f32, where JAX runs an associative scan: it is held within DEEMPH_TOL
of the peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_formats_tpu.ops import celt_dsp as jdsp

from audio_formats_torch.ops import _kernels
from audio_formats_torch.ops import celt_dsp as tdsp

TOL = 4e-6   # max abs error over the peak: the twin against JAX

#: every (blocks, blocksize) of CELT's frames of 120, 240, 480 and 960
#: samples: one long block, or 2^LM short blocks of 120
SHAPES = [(1, 120), (1, 240), (2, 120), (1, 480), (4, 120), (1, 960),
          (8, 120)]


@pytest.mark.parametrize("n", [120, 240, 480, 960])
def test_imdct_basis_equals_jax(n):
    np.testing.assert_array_equal(tdsp.imdct_basis(n), jdsp.imdct_basis(n))


def _jax_halves(co, blocks, bs, scale):
    """JAX's einsum of celt_imdct_ola, alone."""
    B = co.shape[0]
    X = co.reshape(B, bs, blocks).transpose(0, 2, 1) if blocks > 1 \
        else co.reshape(B, 1, bs)
    M = jnp.asarray(jdsp.imdct_basis(bs))
    return np.array(jax.jit(lambda X: jnp.einsum(
        "bjk,mk->bjm", X * scale, M,
        precision=jax.lax.Precision.HIGHEST))(X))


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("blocks,bs", SHAPES)
def test_twin_matches_jax(blocks, bs, B, scale):
    """celt_imdct_ola_packed's [B, frame + 60] result (out, then the new
    tail: JAX's buf[:, :frame + 60]) within TOL of the peak of JAX's (out,
    tail), and celt_imdct_ola its two column slices; on a CPU tensor both
    routes are the twin.  The mix alone, fed
    JAX's own half-transforms, gives JAX's bits, out of place
    (celt_ola_torch) and in place in the packed buffer (celt_ola, whose
    CPU route is celt_ola_inplace_torch)."""
    rng = np.random.default_rng([blocks, bs, B, int(scale * 2)])
    frame = blocks * bs
    co = (rng.standard_normal((B, frame)) * 400).astype(np.float32)
    tail = (rng.standard_normal((B, tdsp.HALF)) * 400).astype(np.float32)
    want = [np.asarray(a) for a in jdsp.celt_imdct_ola(
        co, tail, blocks, bs, scale=scale)]
    args = (torch.from_numpy(co), torch.from_numpy(tail), blocks, bs, scale)
    buf = tdsp.celt_imdct_ola_packed(*args)
    got = tdsp.celt_imdct_ola(*args)
    packed = buf.numpy()
    assert packed.shape == (B, frame + 60) and packed.dtype == np.float32
    assert torch.equal(buf[:, :frame], got[0])
    assert torch.equal(buf[:, frame:], got[1])
    np.testing.assert_array_equal(
        packed, tdsp.celt_imdct_ola_packed_torch(*args).numpy())
    twin = tdsp.celt_imdct_ola_torch(*args)
    assert torch.equal(twin[0], got[0]) and torch.equal(twin[1], got[1])
    for g, w, shape in zip(got, want, [(B, frame), (B, 60)]):
        assert tuple(g.shape) == w.shape == shape
    peak = np.abs(want[0]).max()
    assert np.abs(packed - np.concatenate(want, axis=1)).max() / peak < TOL
    # the mix alone, on JAX's own half-transforms: JAX's bits
    halves = _jax_halves(co, blocks, bs, scale)
    ola = tdsp.celt_ola_torch(torch.from_numpy(halves),
                              torch.from_numpy(tail))
    np.testing.assert_array_equal(ola[0].numpy(), want[0])
    np.testing.assert_array_equal(ola[1].numpy(), want[1])
    buf = torch.full((B, frame + 60), float("nan"))
    buf[:, 60:] = torch.from_numpy(halves.reshape(B, frame))
    assert tdsp.celt_ola(buf, torch.from_numpy(tail), blocks) is buf
    np.testing.assert_array_equal(buf.numpy(), np.concatenate(want, axis=1))
    assert torch.equal(buf[:, :frame], ola[0])
    assert torch.equal(buf[:, frame:], ola[1])


def test_ola_is_not_the_plain_f32_sum():
    """The FMA form matters: the plain f32 products and sum of the
    reference's formula miss JAX's bits on part of the mix region."""
    rng = np.random.default_rng(5)
    co = (rng.standard_normal((16, 960)) * 400).astype(np.float32)
    tail = (rng.standard_normal((16, 60)) * 400).astype(np.float32)
    want = np.asarray(jdsp.celt_imdct_ola(co, tail, 1, 960)[0])
    h = _jax_halves(co, 1, 960, 1.0)[:, 0]
    w = tdsp.WINDOW_F32
    u = np.arange(60)
    b1 = h[:, 59 - u]
    plain = tail * w[119 - u] - b1 * w[u]
    assert (plain != want[:, :60]).any()
    np.testing.assert_array_equal(
        tdsp.celt_ola_torch(torch.from_numpy(h[:, None]),
                            torch.from_numpy(tail))[0].numpy()[:, :60],
        want[:, :60])


def test_ola_rejects_what_it_cannot_take():
    """A tensor on no CPU and no CUDA device, blocks shorter than the
    overlap, or short blocks other than 1, 2, 4 or 8 raise KernelArgError
    (a ValueError)."""
    tail = torch.empty((2, 60), device="meta")
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.celt_ola(torch.empty((2, 1020), device="meta"), tail)
    with pytest.raises(_kernels.KernelArgError, match="at least 120"):
        tdsp.celt_ola(torch.empty((2, 120), device="meta"), tail)
    with pytest.raises(_kernels.KernelArgError, match="at least 120"):
        tdsp.celt_ola(torch.empty((2, 260), device="meta"), tail, 2)
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.imdct_ola_short(torch.empty((2, 960), device="meta"), tail, 8)
    with pytest.raises(_kernels.KernelArgError, match="blocks in"):
        tdsp.imdct_ola_short_launch(
            torch.empty((2, 360), device="meta"), tail, 3, 1.0,
            torch.empty((2, 420), device="meta"))


# ------------------------------------------------- K12b, the deemphasis
DEEMPH_TOL = 1e-6   # max abs error over the peak: the twin against JAX


@pytest.mark.parametrize("B,n", [(512, 960), (3, 100), (1, 120), (7, 1)])
def test_deemphasis_twin_matches_jax(B, n):
    """Three chained calls, each carrying the memory m of the last: the
    twin's sequential f32 recurrence against JAX's associative scan,
    within DEEMPH_TOL of the peak for y and for m (measured at [512, 960],
    amplitude 8000: 2.2e-7 of the peak, a quarter of the samples
    bit-equal).  On a CPU tensor the wrapper is the twin."""
    rng = np.random.default_rng([B, n])
    m_t = rng.uniform(-8000, 8000, B).astype(np.float32)
    m_j = m_t
    for _ in range(3):
        x = rng.uniform(-8000, 8000, (B, n)).astype(np.float32)
        y_j, m_j = (np.asarray(a) for a in jdsp.deemphasis_scan(x, m_j))
        y_w, m_w = tdsp.deemphasis_scan(torch.from_numpy(x),
                                        torch.from_numpy(m_t))
        y_t, m_t = tdsp.deemphasis_scan_torch(torch.from_numpy(x),
                                              torch.from_numpy(m_t))
        assert torch.equal(y_w, y_t) and torch.equal(m_w, m_t)
        y_t, m_t = y_t.numpy(), m_t.numpy()
        assert y_t.shape == y_j.shape == (B, n) and y_t.dtype == np.float32
        assert m_t.shape == m_j.shape == (B,) and m_t.dtype == np.float32
        assert np.abs(y_t - y_j).max() / np.abs(y_j).max() < DEEMPH_TOL
        assert np.abs(m_t - m_j).max() / np.abs(m_j).max() < DEEMPH_TOL


def test_deemphasis_twin_is_the_recurrence():
    """The twin's y[0] takes m0 whole (c·y[-1] = m0), each later sample
    c times the one before, in f32; m = c·y[n-1]."""
    c = np.float32(tdsp.DEEMPH_COEFF)
    x = np.array([[1.0, 2.0, -3.0, 0.5]], np.float32)
    m0 = np.array([4.0], np.float32)
    y, m = tdsp.deemphasis_scan_torch(torch.from_numpy(x),
                                      torch.from_numpy(m0))
    v = m0[0]
    for i in range(4):
        yi = np.float32(x[0, i] + v)
        assert y[0, i].item() == np.float32(yi / np.float32(32768.0))
        v = np.float32(c * yi)
    assert m[0].item() == v


def test_deemphasis_rejects_what_it_cannot_take():
    meta = torch.empty((2, 960), device="meta")
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.deemphasis_scan(meta, torch.empty((2,), device="meta"))
    with pytest.raises(_kernels.KernelArgError, match=r"\[B, n\]"):
        tdsp.deemphasis_launch(meta[0], torch.empty((2,), device="meta"),
                               (meta[0], meta[0]))
