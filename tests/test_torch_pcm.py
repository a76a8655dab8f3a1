"""The port's PCM conversion twins (audio_formats_torch/ops/pcm.py) against
the JAX package's ops/pcm.py on the CPU, bit for bit: the threefry bits,
the int → f32 decode, the exact quantizer, the TPDF dither with its FMA,
and the byte pack.  K10 itself is held to these twins on the card
(tests/test_torch_cuda.py)."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_formats_tpu.ops import pcm as jpcm

from audio_formats_torch.ops import pcm as tpcm

import torch_pcm_cases as cases


@pytest.mark.parametrize("seed", cases.SEEDS)
def test_threefry_uniforms_match_jax_random(seed):
    """fold_in(key(0x7D17), seed), split, uniform: both streams, at the
    first positions and past 65,536."""
    key = jax.random.fold_in(jax.random.key(0x7D17), jnp.uint32(seed))
    k1, k2 = jax.random.split(key)
    n = 70_000
    keys = tpcm.dither_keys(torch.tensor([seed]))
    pos = torch.arange(n)[None, :]
    for i, k in enumerate((k1, k2)):
        want = np.asarray(jax.random.uniform(k, (n,), dtype=jnp.float32))
        got = tpcm._uniform(keys[:, 2 * i:2 * i + 1],
                            keys[:, 2 * i + 1:2 * i + 2], pos)[0].numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_threefry_block_matches_jax():
    """Raw threefry2x32 words against jax.random's on random keys and
    counters, all 32 bits of every input used."""
    from jax._src import prng

    rng = np.random.default_rng(3)
    k = rng.integers(0, 1 << 32, (2,), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, (2, 257), dtype=np.uint64).astype(np.uint32)
    want = prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x))
    got = tpcm.threefry2x32(int(k[0]), int(k[1]),
                            torch.from_numpy(x[0].astype(np.int64)),
                            torch.from_numpy(x[1].astype(np.int64)))
    for g, w in zip(got, np.asarray(want)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("kind", cases.KINDS)
def test_decode_matches_jax_int_to_f32(kind):
    """Every u8 and s16 value, 2^16 sampled s24 and s32 values: the twin
    from payload bytes, bit-equal to JAX's _int_to_f32 and to the
    reference's double math."""
    ints = cases.decode_ints(kind)
    want = np.asarray(jpcm._int_to_f32(ints, kind))
    raw = torch.from_numpy(cases.pack_ints(ints, kind))
    got = tpcm.decode_bytes(raw, kind).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32), cases.int_pcm_to_float_np(ints, kind)
        .view(np.int32))
    np.testing.assert_array_equal(
        tpcm.int_pcm_to_float(ints, kind, device="cpu").view(np.int32),
        want.view(np.int32))


@pytest.mark.parametrize("kind", cases.KINDS)
def test_quantize_nodither_matches_jax(kind):
    """The exact round-half-up at x·scale = k + 0.5 and its neighbours,
    ±1, out-of-range values, ±inf and NaN, then noise."""
    rows, _ = cases.quantize_rows(kind)
    x = np.concatenate([cases.edge_values(kind), rows.reshape(-1)])
    want = np.asarray(jpcm._quantize_nodither(x, kind))
    got = tpcm.quantize_rows_torch(torch.from_numpy(x)[None, :],
                                   torch.zeros(1), kind, False)[0].numpy()
    np.testing.assert_array_equal(got, want)
    if kind != "s32":
        finite = np.isfinite(x)
        np.testing.assert_array_equal(
            got[finite], tpcm.quantize_float_to_int_np(x[finite], kind))


@pytest.mark.parametrize("seed", cases.SEEDS)
@pytest.mark.parametrize("kind", cases.KINDS)
def test_quantize_dither_matches_jax(kind, seed):
    """The dithered quantize (s32: no dither) with the FMA form, bit-equal
    to _quantize_dither, on edge values and noise."""
    rows, _ = cases.quantize_rows(kind)
    x = np.concatenate([cases.edge_values(kind), rows.reshape(-1)])
    if kind == "s32":
        want = np.asarray(jpcm._quantize_nodither(x, kind))
    else:
        want = np.asarray(jpcm._quantize_dither(x, jnp.uint32(seed), kind))
    got = tpcm.quantize_rows_torch(torch.from_numpy(x)[None, :],
                                   torch.tensor([seed]), kind, True)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_dither_needs_the_fma():
    """Over s24 noise the plain left-to-right f32 sum misses JAX on some
    samples, the FMA form on none: the test above would see a twin that
    dropped the FMA."""
    x = np.random.default_rng(6).uniform(-1, 1, 1 << 14).astype(np.float32)
    want = np.asarray(jpcm._quantize_dither(x, jnp.uint32(3), "s24"))
    keys = tpcm.dither_keys(torch.tensor([3]))
    pos = torch.arange(x.size)[None, :]
    u1 = tpcm._uniform(keys[:, 0:1], keys[:, 1:2], pos)[0]
    u2 = tpcm._uniform(keys[:, 2:3], keys[:, 3:4], pos)[0]
    plain = torch.from_numpy(x) * np.float32(8388607.0) + np.float32(0.3125)
    plain = torch.floor(plain + np.float32(0.25) * u1
                        + np.float32(0.125) * u2).to(torch.int32).numpy()
    assert (plain != want).sum() > 0
    got = tpcm.quantize_rows_torch(torch.from_numpy(x)[None, :],
                                   torch.tensor([3]), "s24", True)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_fma_twin_rounds_the_exact_sum():
    """_fma_f32 against exact rational arithmetic, on sums whose f64
    rounding lands on an f32 midpoint (where rounding twice would go
    wrong) and on random ones."""
    f32 = np.float32
    # p = 3 + 1.5·2^-22 is a midpoint of the f32 grid; a tiny c moves the
    # exact sum off it, to one side or the other
    x = np.array([1 + 2.0 ** -23] * 2, f32)
    cs = [-2.0 ** -70, 2.0 ** -70]
    rng = np.random.default_rng(8)
    xr = rng.uniform(-2, 2, 2000).astype(f32)
    for xs, scale, c in [(x[:1], 3.0, cs[0]), (x[1:], 3.0, cs[1]),
                         (xr, 8388607.0, 0.3125), (xr, 127.0, 0.3125)]:
        got = tpcm._fma_f32(torch.from_numpy(xs), scale, c).numpy()
        for g, xv in zip(got, xs):
            exact = Fraction(float(xv)) * Fraction(scale) + Fraction(c)
            assert g == _round_f32(exact), (xv, scale, c)


def _round_f32(q: Fraction) -> np.float32:
    """Round a rational to the nearest f32, ties to even."""
    a = np.float32(float(q))  # within an ulp: check both neighbours
    cands = [np.nextafter(a, np.float32(-np.inf)), a,
             np.nextafter(a, np.float32(np.inf))]
    errs = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(errs)
    ties = [c for c, e in zip(cands, errs) if e == best]
    if len(ties) == 1:
        return ties[0]
    return next(c for c in ties if not (c.view(np.int32) & 1))


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_quantize_pack_rows_matches_jax(kind, dither):
    """Rows of unequal lengths, each with its own seed (0, 7, 2^32-1,
    12345), packed: every row's payload bytes equal _quantize_pack_rows's
    (s24 rows whose length is not a multiple of 4 included)."""
    rows, lens = cases.quantize_rows(kind)
    seeds = [0, 7, 0xFFFFFFFF, 12345]
    bps = cases.KIND_BYTES[kind]
    want = jpcm.quantize_pack_rows(rows, lens, seeds, kind, bps,
                                   dither=dither)
    got = tpcm.quantize_pack_rows(rows, lens, seeds, kind, bps,
                                  dither=dither, device="cpu")
    assert got == want


@pytest.mark.parametrize("kind", ["u8", "s24"])
def test_quantize_pack_long_row_matches_jax(kind):
    """A dithered row longer than 65,536 samples (where JAX's row buckets
    change step) beside a short one."""
    rng = np.random.default_rng(12)
    rows = np.zeros((2, 70_001), np.float32)
    rows[0] = rng.uniform(-1, 1, 70_001)
    rows[1, :300] = rng.uniform(-1, 1, 300)
    lens = [70_001, 300]
    bps = cases.KIND_BYTES[kind]
    want = jpcm.quantize_pack_rows(rows, lens, [5, 0xFFFFFFFF], kind, bps,
                                   dither=True)
    got = tpcm.quantize_pack_rows(rows, lens, [5, 0xFFFFFFFF], kind, bps,
                                  dither=True, device="cpu")
    assert got == want


@pytest.mark.parametrize("dither", [False, True])
def test_quantize_float_to_int_matches_jax(dither):
    x = np.random.default_rng(13).uniform(-1.1, 1.1, 3001).astype(np.float32)
    for kind in ("u8", "s16", "s24"):
        np.testing.assert_array_equal(
            tpcm.quantize_float_to_int(x, kind, dither=dither, seed=9,
                                       device="cpu"),
            jpcm.quantize_float_to_int(x, kind, dither=dither, seed=9))


def test_cuda_tensors_need_the_kernel():
    """A wrapper takes the twin only for CPU tensors; any other device
    takes the kernel or raises."""
    meta = torch.zeros(8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tpcm.decode_bytes(meta, "s16")
    with pytest.raises(ValueError):
        tpcm.quantize_pack(torch.zeros((1, 4), device="meta"), [0], "s16",
                           True)
    with pytest.raises(ValueError):
        tpcm.decode_bytes(torch.zeros(3, dtype=torch.uint8), "s16")
