"""audio_formats_torch.ops.lpc against audio_formats_tpu.ops.lpc on the CPU.

Every comparison is exact equality: these are integer paths, and the same
numpy inputs (made from a seed) go through both packages.  The CUDA kernel
is compared with its twin in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from audio_formats_tpu.ops import lpc as jlpc
from audio_formats_tpu.parallel.batch import _FLAC_W_BUCKETS

from audio_formats_torch.host import native as tnative
from audio_formats_torch.ops import lpc as tlpc

from test_torch_cuda import bucket_lanes


def _residual_for(sig, coeffs, order, shift, exact):
    """Residuals whose LPC synthesis gives back `sig` exactly: the encoder
    side of the recurrence (int64, and int32 wraparound on wrap lanes)."""
    L, B = sig.shape
    s = sig.astype(np.int64)
    acc = np.zeros((L, B), np.int64)
    for j in range(32):
        acc[:, j + 1:] += coeffs[:, j: j + 1].astype(np.int64) * s[:, : B - j - 1]
    wrapped = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    pred = np.where(exact[:, None], acc, wrapped) >> shift[:, None]
    res = s - pred
    res = ((res + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    t = np.arange(B)[None, :]
    return np.where(t < order[:, None], s, res).astype(np.int32)


def lpc_lanes(rng, L, B):
    """A mix of lanes as the decoder issues them: signal lanes (wrap and
    exact, samples within 17 bits, so the reference's limb split is exact),
    random wrap lanes that overflow int32, and pad lanes (order = B).
    Orders 0..32, shifts 0..31.  Returns the kernel's arguments, the
    signals, and which lanes must synthesize back to their signal."""
    kind = rng.integers(0, 4, L)  # 0/1 signal wrap/exact, 2 random, 3 pad
    order = rng.integers(0, 33, L).astype(np.int32)
    shift = rng.integers(0, 32, L).astype(np.int32)
    exact = kind == 1
    coeffs = np.zeros((L, 32), np.int32)
    for l in range(L):
        lim = 1 << (14 if exact[l] else 9)
        coeffs[l, : order[l]] = rng.integers(-lim, lim, order[l])
    t = np.arange(B)
    amp = np.where(kind == 1, 1 << 16, 1 << 14)[:, None]
    sig = (amp * np.sin(2 * np.pi * rng.uniform(0.001, 0.2, (L, 1)) * t)
           + rng.integers(-300, 300, (L, B)))
    sig = np.clip(np.round(sig), -(1 << 17) + 1, (1 << 17) - 1).astype(np.int64)
    residual = _residual_for(sig, coeffs, order, shift, exact)
    rand = kind == 2
    residual[rand] = rng.integers(-(1 << 17), 1 << 17, (rand.sum(), B))
    pad = kind == 3
    order[pad] = B
    coeffs[pad] = 0
    shift[pad] = 0
    exact[pad] = False
    return (residual, coeffs, order, shift, exact), sig, kind < 2


@pytest.mark.parametrize("L,B,seed", [(13, 777, 11), (40, 256, 5),
                                      (70, 96, 9)])
def test_lpc_twin_matches_jax_scan_and_pallas(L, B, seed):
    rng = np.random.default_rng(seed)
    args, sig, is_sig = lpc_lanes(rng, L, B)
    got = tlpc.flac_lpc_torch(*(torch.from_numpy(a) for a in args)).numpy()
    scan = np.asarray(jlpc.flac_lpc_scan(*args))
    np.testing.assert_array_equal(got, scan)
    pallas = np.asarray(jlpc.flac_lpc_pallas(*args, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    # signal lanes synthesize back to their signal
    np.testing.assert_array_equal(got[is_sig], sig[is_sig])


def test_lpc_dispatch_on_cpu_takes_the_twin_and_no_launch(rng):
    args, sig, is_sig = lpc_lanes(rng, 24, 200)
    before = tlpc.KERNEL_LAUNCHES
    got = tlpc.flac_lpc(*args)          # numpy in: CPU tensors
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), tlpc.flac_lpc_torch(*args).numpy())
    assert tlpc.KERNEL_LAUNCHES == before
    # the exact int64 host oracle, stored into int32 as drflac does,
    # agrees on every signal lane
    ref = tlpc.flac_lpc_np(*args[:4]).astype(np.int32)
    np.testing.assert_array_equal(got.numpy()[is_sig], ref[is_sig])
    np.testing.assert_array_equal(
        tlpc.flac_lpc_np(*args[:4]), jlpc.flac_lpc_np(*args[:4]))


def test_lpc_exact_none_means_wrap(rng):
    args, _, _ = lpc_lanes(rng, 16, 128)
    got = tlpc.flac_lpc(*args[:4]).numpy()
    ref = np.asarray(jlpc.flac_lpc_scan(*args[:4]))
    np.testing.assert_array_equal(got, ref)


def test_lpc_cuda_wrapper_rejects_cpu_tensors(rng):
    args, _, _ = lpc_lanes(rng, 4, 64)
    with pytest.raises(ValueError):
        tlpc.flac_lpc_cuda(*(torch.from_numpy(a) for a in args))


def test_fixed_coeffs_match_jax():
    np.testing.assert_array_equal(tlpc.FIXED_COEFFS, jlpc.FIXED_COEFFS)


@pytest.mark.parametrize("w", _FLAC_W_BUCKETS)
def test_unpack_residuals_matches_jax(w):
    rng = np.random.default_rng(100 + w)
    L, n = 9, 256
    stride = (n * w + 31) // 32 + 1
    packed = rng.integers(0, 1 << 32, (L, stride), dtype=np.uint64)\
        .astype(np.uint32)
    warm = rng.integers(-(1 << 31), 1 << 31, (L, 32), dtype=np.int64)\
        .astype(np.int32)
    order = np.array([0, 1, 5, 31, 32, 33, n, 12, 2], np.int32)
    ref = np.asarray(jlpc.flac_unpack_residuals(packed, warm, order, w=w,
                                                n=n))
    got = tlpc.flac_unpack_residuals(packed, warm, order, w=w, n=n)
    np.testing.assert_array_equal(got.numpy(), ref)
    # a tensor holding the words' bits as int32 unpacks the same
    got_t = tlpc.flac_unpack_residuals(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(warm),
        torch.from_numpy(order), w=w, n=n)
    np.testing.assert_array_equal(got_t.numpy(), ref)


@pytest.mark.parametrize("w", [4, 17, 32])
def test_unpack_inverts_the_host_pack(w):
    """The port's C pack (af_flac_pack) and its torch unpack round-trip."""
    import ctypes as ct

    lib = tnative.get_lib()
    assert lib is not None
    rng = np.random.default_rng(w)
    L, n = 6, 1024
    lim = 1 << (w - 1)
    residual = rng.integers(-lim, lim, (L, n)).astype(np.int32)
    order = np.array([0, 3, 32, 40, n, 8], np.int32)
    stride = (n * w + 31) // 32 + 1
    packed = np.zeros((L, stride), np.uint32)
    i32p, u32p = ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint32)
    lib.af_flac_pack(residual.ctypes.data_as(i32p), L, n,
                     order.ctypes.data_as(i32p), w,
                     packed.ctypes.data_as(u32p), stride)
    got = tlpc.flac_unpack_residuals(packed, residual[:, :32], order, w=w,
                                     n=n).numpy()
    np.testing.assert_array_equal(got, residual)


def test_merge_overflow_matches_jax(rng):
    L, n, Lb = 20, 128, 8
    res_small = rng.integers(-(1 << 31), 1 << 31, (L, n), dtype=np.int64)\
        .astype(np.int32)
    raw = rng.integers(-(1 << 31), 1 << 31, (Lb, n), dtype=np.int64)\
        .astype(np.int32)
    raw[0] = 0
    idx = np.zeros(L, np.int32)
    hit = rng.choice(L, Lb - 1, replace=False)
    idx[hit] = np.arange(1, Lb)
    ref = np.asarray(jlpc.flac_merge_overflow(res_small, raw, idx, Lb=Lb))
    got = tlpc.flac_merge_overflow(torch.from_numpy(res_small),
                                   torch.from_numpy(raw), idx)
    np.testing.assert_array_equal(got.numpy(), ref)


def _stereo_inputs(rng, S, C, B, bps):
    # full int32 range: corrupt lanes reach the wraparound corners too
    samples = rng.integers(-(1 << 31), 1 << 31, (S, C, B), dtype=np.int64)\
        .astype(np.int32)
    samples[:, :, : B // 2] >>= 14           # and ordinary small samples
    wasted = rng.integers(0, 4, (S, C)).astype(np.int32)
    out_shift = np.full(S, 32 - bps, np.int32)
    return samples, wasted, out_shift


@pytest.mark.parametrize("ca", range(11))
def test_post_stereo_matches_jax(ca):
    rng = np.random.default_rng(ca)
    C = 2 if ca >= 8 else ca % 2 + 1
    samples, wasted, out_shift = _stereo_inputs(rng, 1, C, 64, 16)
    ref = np.asarray(jlpc.flac_post_stereo(
        samples[0], np.int32(ca), wasted[0], out_shift[0]))
    got = tlpc.flac_post_stereo(torch.from_numpy(samples[0]), ca,
                                torch.from_numpy(wasted[0]), int(out_shift[0]))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("C,bps", [(2, 16), (2, 24), (1, 16), (2, 8)])
def test_post_stereo_batch_and_s16_match_jax(C, bps):
    rng = np.random.default_rng(C * 100 + bps)
    S = 22
    samples, wasted, out_shift = _stereo_inputs(rng, S, C, 96, bps)
    ca = np.arange(S, dtype=np.int32) % 11
    args = (samples, ca, wasted, out_shift)
    targs = [torch.from_numpy(a) for a in args]
    ref = np.asarray(jlpc.flac_post_stereo_batch(*args))
    np.testing.assert_array_equal(
        tlpc.flac_post_stereo_batch(*targs).numpy(), ref)
    ref16 = np.asarray(jlpc.flac_post_stereo_batch_s16(*args))
    got16 = tlpc.flac_post_stereo_batch_s16(*targs)
    assert got16.dtype == torch.int16
    np.testing.assert_array_equal(got16.numpy(), ref16)



# ---------------------------------------------------- lane grouping (K1)
def _twin_through_groups(args, perm, key):
    """The twin run group by group (one group a kind, in the order of the
    permutation), each group's rows scattered back to their lanes."""
    targs = [torch.as_tensor(a) for a in args]
    out = torch.empty_like(targs[0])
    p = perm.to(torch.int64)
    for k in torch.unique(key):
        rows = p[key[p] == k]
        out[rows] = tlpc.flac_lpc_torch(*(a[rows] for a in targs))
    return out


@pytest.mark.parametrize("L,B,seed", [(90, 70, 1), (37, 33, 2), (64, 128, 3),
                                      (13, 40, 4)])
def test_lane_perm_groups_lanes_by_kind(L, B, seed):
    rng = np.random.default_rng(seed)
    args, kind = bucket_lanes(rng, L, B)
    targs = [torch.from_numpy(a) for a in args]
    key = tlpc.lpc_lane_key(targs[1], targs[2], targs[4], B)
    np.testing.assert_array_equal(key.numpy(), kind)
    perm = tlpc.lpc_lane_perm(targs[1], targs[2], targs[4], B)
    assert perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(L))
    ks = key[perm.to(torch.int64)]
    assert bool((ks[1:] >= ks[:-1]).all())   # one run per kind
    want = tlpc.flac_lpc_torch(*targs)
    got = _twin_through_groups(args, perm, key)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("L,B,seed", [(13, 777, 11), (40, 256, 5),
                                      (70, 96, 9)])
def test_lane_perm_groups_keep_the_jax_fixture_output(L, B, seed):
    """The JAX-checked fixture lanes of test_lpc_twin_matches_jax_scan_and_
    pallas, run kind by kind through the permutation: the JAX scan's
    output on every lane."""
    rng = np.random.default_rng(seed)
    args, _, _ = lpc_lanes(rng, L, B)
    targs = [torch.from_numpy(a) for a in args]
    key = tlpc.lpc_lane_key(targs[1], targs[2], targs[4], B)
    perm = tlpc.lpc_lane_perm(targs[1], targs[2], targs[4], B)
    assert sorted(perm.tolist()) == list(range(L))
    got = _twin_through_groups(args, perm, key)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlpc.flac_lpc_scan(*args)))


def test_lane_perm_with_empty_kinds():
    """Only wrap LPC-8 lanes and pass-through lanes, as in the FLAC slice's
    mid channels: the other kinds are empty, the permutation still one."""
    rng = np.random.default_rng(8)
    args, kind = bucket_lanes(rng, 50, 64, kinds=(0, 3))
    targs = [torch.from_numpy(a) for a in args]
    key = tlpc.lpc_lane_key(targs[1], targs[2], targs[4], 64)
    assert set(key.tolist()) <= {0, 3}
    perm = tlpc.lpc_lane_perm(targs[1], targs[2], targs[4], 64)
    assert sorted(perm.tolist()) == list(range(50))
    np.testing.assert_array_equal(
        _twin_through_groups(args, perm, key).numpy(),
        tlpc.flac_lpc_torch(*targs).numpy())
