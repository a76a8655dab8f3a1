"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA GPU and nvcc, and skip elsewhere.  They import
neither jax nor audio_formats_tpu, so they also run where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_formats_torch import BatchDecoder, encode_qoa_batch
from audio_formats_torch.ops import lms as tlms
from audio_formats_torch.ops import lpc as tlpc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _lanes(rng, L, B):
    """Random lanes for kernel-vs-twin: any mix of exact and wrap lanes,
    orders 0..32, shifts 0..31, 15-bit coefficients, some pad lanes."""
    residual = rng.integers(-(1 << 17), 1 << 17, (L, B)).astype(np.int32)
    order = rng.integers(0, 33, L).astype(np.int32)
    coeffs = np.zeros((L, 32), np.int32)
    for l in range(L):
        coeffs[l, : order[l]] = rng.integers(-(1 << 14), 1 << 14, order[l])
    shift = rng.integers(0, 32, L).astype(np.int32)
    exact = rng.random(L) < 0.5
    pad = rng.random(L) < 0.1
    order[pad] = B
    return residual, coeffs, order, shift, exact


@pytest.mark.parametrize("L,B", [(13, 777), (64, 1024), (1000, 96),
                                 (33, 31)])
def test_lpc_kernel_matches_twin(cuda, L, B):
    rng = np.random.default_rng(L + B)
    args = [torch.from_numpy(a).to(cuda) for a in _lanes(rng, L, B)]
    before = tlpc.KERNEL_LAUNCHES
    got = tlpc.flac_lpc(*args)
    torch.cuda.synchronize()
    assert tlpc.KERNEL_LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = tlpc.flac_lpc_torch(*args)
    assert torch.equal(got, want)


def test_lpc_kernel_rejects_bad_arguments(cuda):
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a).to(cuda) for a in _lanes(rng, 8, 64)]
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(ValueError):
        tlpc.flac_lpc(*bad)
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError):
        tlpc.flac_lpc(*bad)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError):
        tlpc.flac_lpc(*bad)


def test_batch_decoder_cuda_equals_cpu(cuda):
    from golden import flac_ref

    rng = np.random.default_rng(7)
    streams = []
    for i, mode in enumerate(("independent", "left_side", "right_side",
                              "mid_side")):
        n = 3000 + 700 * i
        t = np.arange(n)[:, None]
        pcm = np.clip(np.round(
            9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4] / 44100)
            + 300 * rng.standard_normal((n, 2))), -32768, 32767
        ).astype(np.int64)
        streams.append(flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                                           stereo_mode=mode,
                                           modes=["lpc8", "fixed3"]))
    before = tlpc.KERNEL_LAUNCHES
    dec = BatchDecoder(streams, device=cuda)
    res = dec.decode_all(output="device")
    for _, wins in res.windows():
        assert all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    assert dec.stats["group_demotions"] == 0
    assert tlpc.KERNEL_LAUNCHES - before == dec.stats["windows"]
    want = BatchDecoder(streams, device="cpu").decode_all()
    # output="numpy" on the card downloads through pinned async copies
    got_np = BatchDecoder(streams, device=cuda).decode_all()
    for a, b, c in zip(got, want, got_np):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


# ------------------------------------------------------------------- QOA
def _qoa_decode_args(rng, L, S):
    """int32 history and weights (some lanes int32-range, so the predictor
    sum and the weight update wrap), int8 scalefactors and codes, and their
    dequantized [L, 20 S] int32 residuals."""
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 15), 1 << 15, (L, 4)).astype(np.int32)
    wild = rng.random(L) < 0.2
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (wild.sum(), 4))
    sf = rng.integers(0, 16, (L, S)).astype(np.int8)
    codes = rng.integers(0, 8, (L, S, 20)).astype(np.int8)
    deq = tlms.DEQUANT_TAB[sf.astype(np.int64)[..., None], codes].reshape(L, -1)
    return history, weights, sf, codes, deq


@pytest.mark.parametrize("L,T", [(13, 777), (33, 31), (1000, 100),
                                 (64, 5120)])
def test_qoa_decode_kernel_matches_twin(cuda, L, T):
    """The [L, T] int32 form, T not a multiple of the 160-step tile, with
    residuals of any int32 (p + r wraps)."""
    rng = np.random.default_rng(L + T)
    history, weights, _, _, _ = _qoa_decode_args(rng, L, 1)
    deq = rng.integers(-(1 << 31), 1 << 31, (L, T)).astype(np.int32)
    deq[rng.random((L, T)) < 0.7] %= 3000
    args = [torch.from_numpy(a).to(cuda) for a in (history, weights, deq)]
    before = tlms.DECODE_LAUNCHES
    got = tlms.qoa_decode(*args)
    torch.cuda.synchronize()
    assert tlms.DECODE_LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, tlms.qoa_decode_torch(*args))


@pytest.mark.parametrize("L,S", [(13, 256), (33, 7), (1000, 9), (5, 1)])
def test_qoa_decode_slices_kernel_matches_twin(cuda, L, S):
    rng = np.random.default_rng(L * S)
    history, weights, sf, codes, deq = _qoa_decode_args(rng, L, S)
    h, w, sf_d, codes_d, deq_d = (torch.from_numpy(a).to(cuda) for a in
                                  (history, weights, sf, codes, deq))
    want = tlms.qoa_decode_torch(h, w, deq_d)
    before = tlms.DECODE_LAUNCHES
    got = tlms.decode_slices(h, w, sf_d, codes_d)
    got32 = tlms.decode_slices(h, w, sf_d.to(torch.int32),
                               codes_d.to(torch.int32))
    torch.cuda.synchronize()
    assert tlms.DECODE_LAUNCHES == before + 2
    assert torch.equal(got, want) and torch.equal(got32, want)


@pytest.mark.parametrize("L", [13, 33, 1000])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_qoa_encode_kernel_matches_twin(cuda, L, dtype):
    """Per-lane frame lengths around slice edges, full-scale square waves
    (qoa_div's int32 product overflows), noise and some int32-range
    starting states."""
    rng = np.random.default_rng(L)
    t = np.arange(5120)
    period = rng.integers(2, 300, L)[:, None]
    s = np.where((t[None, :] // period) % 2, 32767, -32768)
    noisy = rng.random(L) < 0.4
    s[noisy] = rng.integers(-32768, 32768, (noisy.sum(), 5120))
    flen = rng.choice([0, 1, 19, 20, 21, 2500, 5119, 5120], L).astype(np.int32)
    s = (s * (t[None, :] < flen[:, None])).astype(dtype)
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = np.tile(tlms.INITIAL_WEIGHTS, (L, 1))
    wild = rng.random(L) < 0.2
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (wild.sum(), 4))
    args = [torch.from_numpy(a).to(cuda) for a in (s, history, weights, flen)]
    before = tlms.ENCODE_LAUNCHES
    got = tlms.qoa_encode_frame_scan(*args)
    words = tlms.qoa_encode_frame_words(args[0], args[3])
    torch.cuda.synchronize()
    assert tlms.ENCODE_LAUNCHES == before + 2
    want = tlms.qoa_encode_frame_torch(*args)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    h0 = torch.zeros_like(args[1])
    w0 = torch.from_numpy(np.tile(tlms.INITIAL_WEIGHTS, (L, 1))).to(cuda)
    sf, codes, _, _ = tlms.qoa_encode_frame_torch(args[0], h0, w0, args[3])
    assert torch.equal(words, tlms.pack_words(sf, codes))


def test_qoa_kernels_reject_bad_arguments(cuda):
    rng = np.random.default_rng(3)
    history, weights, sf, codes, deq = _qoa_decode_args(rng, 8, 4)
    h, w, sf_d, codes_d, deq_d = (torch.from_numpy(a).to(cuda) for a in
                                  (history, weights, sf, codes, deq))
    for bad in ((h.to(torch.int64), w, deq_d), (h, w, deq_d.t().contiguous().t()),
                (h, w.cpu(), deq_d)):
        with pytest.raises(ValueError):
            tlms.qoa_decode(*bad)
    for bad in ((h, w, sf_d, codes_d.transpose(1, 2).contiguous()
                 .transpose(1, 2)),
                (h, w.cpu(), sf_d, codes_d),
                (h[:, :3].contiguous(), w, sf_d, codes_d)):
        with pytest.raises(ValueError):
            tlms.decode_slices(*bad)
    s = torch.zeros((8, 5120), dtype=torch.int16, device=cuda)
    flen = torch.full((8,), 5120, dtype=torch.int32, device=cuda)
    for bad in ((s.to(torch.float32), h, w, flen),
                (s.t().contiguous().t(), h, w, flen),
                (s, h.cpu(), w, flen), (s, h, w, flen.to(torch.int64))):
        with pytest.raises(ValueError):
            tlms.qoa_encode_cuda(*bad)


def _qoa_streams():
    from golden import qoa_ref

    rng = np.random.default_rng(9)
    streams = []
    for i in range(4):
        n = 4000 + 3333 * i
        ch = 2 if i % 2 else 1
        x = rng.integers(-9000, 9000, (n, ch)).astype(np.int16)
        streams.append(qoa_ref.encode(x, 44100))
    return streams


def test_batch_decoder_qoa_cuda_equals_cpu(cuda):
    streams = _qoa_streams()
    before = tlms.DECODE_LAUNCHES
    dec = BatchDecoder(streams, device=cuda)
    res = dec.decode_all(output="device")
    for kind, wins in res.windows():
        assert kind == "qoa" and all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    assert dec.stats["group_demotions"] == 0
    assert tlms.DECODE_LAUNCHES - before == dec.stats["windows"]
    want = BatchDecoder(streams, device="cpu").decode_all()
    got_np = BatchDecoder(streams, device=cuda).decode_all()
    for a, b, c in zip(got, want, got_np):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


@pytest.mark.parametrize("parallel_frames", [True, False])
def test_encode_qoa_batch_cuda_equals_cpu(cuda, parallel_frames):
    rng = np.random.default_rng(4)
    pcms = [rng.uniform(-0.6, 0.6, (n, ch)).astype(np.float32)
            for n, ch in ((5120 * 2, 1), (5120 + 1234, 2), (800, 1))]
    stats = {}
    before = tlms.ENCODE_LAUNCHES
    got = encode_qoa_batch(pcms, 44100, parallel_frames=parallel_frames,
                           device=cuda, stats=stats)
    assert tlms.ENCODE_LAUNCHES - before == stats["windows"]
    assert got == encode_qoa_batch(pcms, 44100,
                                   parallel_frames=parallel_frames,
                                   device="cpu")
