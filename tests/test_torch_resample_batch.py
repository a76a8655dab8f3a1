"""The port's batched SILK upsample against the JAX package's
``ops/resample.py``, on the CPU.

K13's twin ``silk_upsample_torch`` (one matmul of every row's 96-sample
windows against the reversed taps) gives the bits of JAX's
``_poly_conv_rows`` (an XLA conv at Precision.HIGHEST) at every shape the
SILK and hybrid groups give it: a step of 10-60 ms, so at least 60 groups
a row, for any row count.  With fewer than ~16 groups a row, torch's CPU
matmul and XLA's conv sum in other orders on some row counts; those
shapes are held within RAGGED_TOL of the peak (measured: at most 3.7e-7).
``BatchedFittedUpsampler`` keeps its state in float64 on the host as
JAX's does, so its steps and its per-row flush equal JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

from audio_formats_tpu.ops import resample as jrs

from audio_formats_torch.ops import _kernels
from audio_formats_torch.ops import resample as trs

RAGGED_TOL = 1e-6   # max abs error over the peak, below 16 groups a row
TAPS = 96


def _taps(bw):
    t = jrs._fit_tables()
    h = np.asarray([t["h_nb"], t["h_mb"], t["h_wb"]][bw], np.float64)
    return np.ascontiguousarray(h[:, ::-1], np.float32)


def _rows(rng, rows, G):
    return (rng.standard_normal((rows, G + TAPS - 1)) * 3000).astype(
        np.float32)


def test_fit_tables_equal_jax():
    t, j = trs._fit_tables(), jrs._fit_tables()
    assert (t["L"], t["A"]) == (j["L"], j["A"]) == (TAPS, 32)
    for k in ("h_nb", "h_mb", "h_wb"):
        np.testing.assert_array_equal(t[k], j[k])
    assert [t[k].shape[0] for k in ("h_nb", "h_mb", "h_wb")] == [6, 4, 3]


@pytest.mark.parametrize("rows", [1, 3, 64, 256])
@pytest.mark.parametrize("G", [60, 80, 140, 160, 300, 320, 960])
@pytest.mark.parametrize("bw", [0, 1, 2])
def test_twin_equals_jax_poly_conv(bw, G, rows):
    """At the groups' shapes the twin is JAX's conv bit for bit, and the
    wrapper on a CPU tensor is the twin."""
    h = _taps(bw)
    x = _rows(np.random.default_rng([bw, G, rows]), rows, G)
    want = np.asarray(jrs._poly_conv_rows(x, h, G=G))
    twin = trs.silk_upsample_torch(torch.from_numpy(x), torch.from_numpy(h),
                                   G).numpy()
    got = trs.silk_upsample(torch.from_numpy(x), trs.pack_taps(h),
                            G).numpy()
    assert want.shape == (rows, G * h.shape[0]) and twin.dtype == np.float32
    np.testing.assert_array_equal(twin, want)
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("G", [1, 7, 15])
def test_twin_ragged_groups_within_tolerance(G, rows):
    h = _taps(2)
    x = _rows(np.random.default_rng([G, rows]), rows, G)
    want = np.asarray(jrs._poly_conv_rows(x, h, G=G))
    got = trs.silk_upsample_torch(torch.from_numpy(x), torch.from_numpy(h),
                                  G).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < RAGGED_TOL


def test_twin_reads_only_its_windows():
    """Samples past G + L - 1 in a row change nothing (the wrapper takes
    wider rows, as the twin does)."""
    h = torch.from_numpy(_taps(1))
    x = torch.from_numpy(_rows(np.random.default_rng(3), 4, 80 + 20))
    a = trs.silk_upsample_torch(x[:, : 80 + TAPS - 1].contiguous(), h, 80)
    b = trs.silk_upsample_torch(x, h, 80)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bw,feed", [(0, 4), (1, 9), (2, 12)])
def test_batched_upsampler_equals_jax(bw, feed):
    """Five steps of ragged native blocks (a short first block, as a 10 ms
    step, then 20 ms ones) through the port's and JAX's batched
    upsamplers, a row flushed mid-batch, then two more steps: every step's
    output and the flushed tail are JAX's bits, and so is the state.  The
    taps K13 takes by value (``pack_taps`` of the reversed taps, which the
    upsampler keeps on the host) are JAX's taps, reversed, as f32: entry
    p·96 + k is h[p, 95 - k]."""
    rows = 6
    rate = [8, 12, 16][bw]
    rng = np.random.default_rng([bw, feed])
    t = trs.BatchedFittedUpsampler(bw, rows, feed=feed, device="cpu")
    j = jrs.BatchedFittedUpsampler(bw, rows, feed=feed)
    assert (t.den, t.L, t.A) == (j.den, j.L, j.A)
    packed = t._taps
    assert packed.dtype == np.float32 and packed.shape == (t.den, TAPS)
    assert packed.flags.c_contiguous
    np.testing.assert_array_equal(packed, _taps(bw))
    np.testing.assert_array_equal(trs.pack_taps(_taps(bw)), packed)
    p, k = np.divmod(np.arange(t.den * TAPS), TAPS)
    np.testing.assert_array_equal(packed.reshape(-1), np.asarray(
        j.h, np.float64)[p, TAPS - 1 - k].astype(np.float32))
    for step in range(7):
        T = rate * (10 if step == 0 else 20)
        x = (rng.standard_normal((rows, T)) * 2000).astype(np.float32)
        if step >= 3:
            x[2] = 0.0   # row 2 ended: zero-fed after its flush
        out_max = T * t.den
        got, want = t.process(x, out_max), np.asarray(j.process(x, out_max))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t._hist, j._hist)
        np.testing.assert_array_equal(t._pending, j._pending)
        if step == 2:
            for count in (5 * t.den, 700):
                np.testing.assert_array_equal(t.flush_row(2, count),
                                              j.flush_row(2, count))
    assert t.h2d_bytes > 0 and t.d2h_bytes > 0


def test_flush_row_equals_the_streaming_upsampler():
    """A row of the batch flushed at its end equals FittedUpsampler's own
    flush after the same input: the EOS drain the per-stream read does."""
    rng = np.random.default_rng(11)
    b = trs.BatchedFittedUpsampler(2, 3, feed=12, device="cpu")
    one = trs.FittedUpsampler(2)
    one.process(np.zeros(12, np.float32), 0)
    for _ in range(3):
        x = (rng.standard_normal((3, 320)) * 2000).astype(np.float32)
        got = b.process(x, 960)
        want = one.process(x[1], 960)
        assert np.abs(got[1] - want).max() / np.abs(want).max() < 1e-6
    np.testing.assert_array_equal(b.flush_row(1, 500), one.flush(500))


def test_wrapper_rejects_what_it_cannot_take():
    """A tensor on no CPU and no CUDA device, taps that are not a
    contiguous float32 host array, a tap count other than 96, a phase
    count other than 6, 4 or 3, or rows too short raise KernelArgError (a
    ValueError)."""
    meta = torch.empty((2, 415), device="meta")
    h = np.zeros((3, TAPS), np.float32)
    with pytest.raises(_kernels.KernelArgError, match="CUDA"):
        trs.silk_upsample(meta, h, 320)
    out = torch.empty((2, 960), device="meta")
    for x, hh, G, msg in (
            (meta, np.zeros((3, 95), np.float32), 320, "96 taps"),
            (meta, np.zeros((7, TAPS), np.float32), 320, "den in"),
            (meta, np.zeros((5, TAPS), np.float32), 320, "den in"),
            (meta, np.zeros((3, TAPS)), 320, "float32 host array"),
            (meta, np.zeros((TAPS, 3), np.float32).T, 320,
             "float32 host array"),
            (meta, torch.zeros((3, TAPS)), 320, "float32 host array"),
            (meta, h, 321, "W >= G"),
            (meta[0], h, 320, r"\[rows, W\]")):
        with pytest.raises(_kernels.KernelArgError, match=msg):
            trs.silk_upsample_launch(x, hh, G, out)
