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


@pytest.mark.parametrize("width,start", [(1020, 0), (1021, 1)])
def test_deemphasis_takes_rows_by_stride(width, start):
    """On the CPU, deemphasis_scan of a [:, start:start + 960] view of a
    [B, width] buffer (K12a's packed output, and a view off the 16-byte
    boundary) equals it on the view made contiguous, bit for bit."""
    rng = np.random.default_rng([width, start])
    buf = torch.from_numpy(rng.uniform(-8000, 8000, (6, width)).astype(
        np.float32))
    m0 = torch.from_numpy(rng.uniform(-8000, 8000, 6).astype(np.float32))
    x = buf[:, start:start + 960]
    assert not x.is_contiguous()
    y, m = tdsp.deemphasis_scan(x, m0)
    yc, mc = tdsp.deemphasis_scan(x.contiguous(), m0)
    assert torch.equal(y, yc) and torch.equal(m, mc)


def test_deemphasis_launch_takes_rows_by_stride_only():
    """deemphasis_launch's layout checks come before its device check: on
    meta tensors a row-strided x (and y) gets as far as the refusal of a
    device that is not CUDA, an element stride of 2 or rows of y that
    overlap are refused for themselves."""
    m0 = torch.empty((4,), device="meta")
    wide = torch.empty((4, 1020), device="meta")
    out = (torch.empty((4, 960), device="meta"), m0)
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.deemphasis_launch(wide[:, :960], m0, out)
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.deemphasis_launch(wide[:, 1:961], m0, (wide[:, 60:], m0))
    with pytest.raises(_kernels.KernelArgError, match="contiguous"):
        tdsp.deemphasis_launch(torch.empty((4, 1920), device="meta")[:, ::2],
                               m0, out)
    with pytest.raises(_kernels.KernelArgError, match="contiguous"):
        tdsp.deemphasis_launch(out[0], m0, (torch.empty(
            (4, 1920), device="meta")[:, ::2], m0))
    with pytest.raises(_kernels.KernelArgError, match="overlap"):
        tdsp.deemphasis_launch(out[0], m0, (wide.as_strided(
            (4, 960), (480, 1)), m0))


def _k12b_order(x, m0):
    """K12b's arithmetic in its own order (``csrc/celt_deemph.cu``), in
    numpy f32 over the rows at once: tiles of 1,024; warp w's two sets of
    32 chunks of 4 at 256 w + 128 s + 4 l; each chunk's transfer from a
    zero carry; an inclusive Hillis-Steele scan over the lanes; the
    warps' set totals applied to the tile's carry in turn; the lane's
    exclusive transfer applied to that; the chunk stepped again; the
    tile's last carry handed on."""
    f = np.float32
    c = f(tdsp.DEEMPH_COEFF)
    B, n = x.shape
    y = np.empty_like(x)
    carry = m0.astype(f)
    for t0 in range(0, n, 1024):
        start = t0 + np.arange(4)[:, None, None] * 256 \
            + np.arange(2)[None, :, None] * 128 + np.arange(32) * 4
        k = np.clip(n - start, 0, 4)
        a = np.ones((B, 4, 2, 32), f)
        b = np.zeros((B, 4, 2, 32), f)
        for i in range(4):
            on = i < k
            xi = x[:, np.minimum(start + i, n - 1)]
            b = np.where(on, c * (xi + b), b)
            a = np.where(on, a * c, a)
        for d in (1, 2, 4, 8, 16):
            a, b = (np.concatenate([a[..., :d], a[..., :-d] * a[..., d:]], -1),
                    np.concatenate([b[..., :d], b[..., :-d] * a[..., d:]
                                    + b[..., d:]], -1))
        last = min(n, t0 + 1024) - 1
        for w in range(4):
            uw = carry   # the carry into warp w: the warps before, in turn
            for w2 in range(w):
                for s_ in range(2):
                    uw = a[:, w2, s_, 31] * uw + b[:, w2, s_, 31]
            for s_, base in ((0, uw), (1, a[:, w, 0, 31] * uw
                                      + b[:, w, 0, 31])):
                for lane in range(32):
                    st, kk = start[w, s_, lane], k[w, s_, lane]
                    v = base if lane == 0 else (a[:, w, s_, lane - 1] * base
                                                + b[:, w, s_, lane - 1])
                    for i in range(kk):
                        yi = x[:, st + i] + v
                        y[:, st + i] = yi * f(1 / 32768)
                        v = c * yi
                    if kk and st <= last < st + 4:
                        exit_carry = v
        carry = exit_carry
    return y, carry


@pytest.mark.parametrize("n", [1, 33, 960, 1021, 5000])
def test_k12b_order_within_tolerance_of_twin(n):
    """K12b's order of operations (``_k12b_order``: 120 chunks' entry
    carries from a scan at n = 960, where the twin steps a sample at a
    time) stays within the card tests' 1e-6 of the twin's peak, three
    calls chained through m, amplitude 8000 (1.8e-7 to 2.5e-7 of it at
    n = 960, 1,021 and 5,000)."""
    rng = np.random.default_rng([n, 15])
    m = mt = rng.uniform(-8000, 8000, 16).astype(np.float32)
    for _ in range(3):
        x = rng.uniform(-8000, 8000, (16, n)).astype(np.float32)
        y, m = _k12b_order(x, m)
        yt, mt = (a.numpy() for a in tdsp.deemphasis_scan_torch(
            torch.from_numpy(x), torch.from_numpy(mt)))
        assert np.abs(y - yt).max() / np.abs(yt).max() < 1e-6
        assert np.abs(m - mt).max() / np.abs(mt).max() < 1e-6


def test_deemphasis_rejects_what_it_cannot_take():
    meta = torch.empty((2, 960), device="meta")
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        tdsp.deemphasis_scan(meta, torch.empty((2,), device="meta"))
    with pytest.raises(_kernels.KernelArgError, match=r"\[B, n\]"):
        tdsp.deemphasis_launch(meta[0], torch.empty((2,), device="meta"),
                               (meta[0], meta[0]))
