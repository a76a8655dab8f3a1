"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need a CUDA GPU and nvcc, and skip elsewhere.  The port's code
under test imports no jax; the MP3 and Vorbis cases build their streams
with the golden coders, which read the spec tables (and the Ogg page
writer) of audio_formats_tpu.  Run
them without the conftest, which sets JAX up for the CPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_formats_torch import (BatchDecoder, encode_qoa_batch,
                                 encode_wav_batch)
from audio_formats_torch.ops import celt_dsp as tcelt
from audio_formats_torch.ops import flac_rice as trice
from audio_formats_torch.ops import lms as tlms
from audio_formats_torch.ops import lpc as tlpc
from audio_formats_torch.ops import mdct as tmdct
from audio_formats_torch.ops import pcm as tpcm
from audio_formats_torch.ops import resample as trs
from audio_formats_torch.ops import vorbis_win as twin
from audio_formats_torch.parallel.groups import flac_rice as rice_groups
from audio_formats_torch.parallel.groups import mp3 as mp3_groups

import torch_flac_cases
import torch_mp3_cases
import torch_opus_cases
import torch_opus_speech_cases
import torch_pcm_cases
import torch_qoa_cases
from torch_mp3_cases import as_frames, mp3_random_lanes

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


def bucket_lanes(rng, L, B, kinds=range(11)):
    """Lanes of the kernel's kinds (ops/lpc.py lpc_lane_key): pass-through
    lanes (order >= B, or no nonzero coefficient), FIXED 1-4, and LPC lanes
    whose last nonzero coefficient falls in each tap bucket, wrap and exact
    interleaved, in a random order.  Returns the arguments and each lane's
    intended kind."""
    kind = rng.choice(list(kinds), L)
    order = np.zeros(L, np.int32)
    coeffs = np.zeros((L, 32), np.int32)
    exact = np.zeros(L, bool)
    hi = {1: 4, 2: 8, 3: 12, 4: 16, 5: 32}
    for l, k in enumerate(kind):
        if k == 0:
            order[l] = B + int(rng.integers(0, 3)) if l % 2 else 0
            if order[l] >= B:
                coeffs[l, :8] = rng.integers(-99, 99, 8)
            continue
        b, exact[l] = (k + 1) // 2, (k + 1) % 2 == 1
        taps = int(rng.integers(hi.get(b - 1, 0) + 1, hi[b] + 1))
        if b == 1 and l % 3 == 0:
            coeffs[l] = tlpc.FIXED_COEFFS[taps]
        else:
            lim = 1 << (14 if exact[l] else 9)
            coeffs[l, :taps] = rng.integers(-lim, lim, taps)
            coeffs[l, taps - 1] = coeffs[l, taps - 1] or 1
        order[l] = min(taps + int(rng.integers(0, 3)), B - 1)
    shift = rng.integers(0, 32, L).astype(np.int32)
    residual = rng.integers(-(1 << 15), 1 << 15, (L, B)).astype(np.int32)
    return (residual, coeffs, order, shift, exact), kind


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


@pytest.mark.parametrize("L,B,kinds", [
    (333, 777, range(11)),       # every kind, wrap and exact interleaved
    (77, 4096, range(11)),       # the slice's block size
    (1001, 65, (0, 3, 4)),       # some kinds empty: pass-through, LPC-8
    (9, 31, (1, 2)),             # FIXED and short LPC only, B < one tile
])
def test_lpc_kernel_every_kind_matches_twin(cuda, L, B, kinds):
    """Every instance the kernel compiles: pass-through lanes, FIXED 1-4,
    LPC in each tap bucket, wrap, exact and mixed warps; L not a multiple
    of the 8 lanes a warp, B not a multiple of the 32-step tile.  The
    wrapper's grouping (the twin's permutation), the window's own order
    and a random order all give the twin's output, and so does a residual
    whose rows are not 16-byte aligned."""
    rng = np.random.default_rng(L + B)
    args, kind = bucket_lanes(rng, L, B, kinds)
    targs = [torch.from_numpy(a).to(cuda) for a in args]
    want = tlpc.flac_lpc_torch(*targs)
    key = tlpc.lpc_lane_key(targs[1], targs[2], targs[4], B)
    assert key.cpu().numpy().tolist() == kind.tolist()
    # the card's grouping is the twin's permutation
    assert torch.equal(tlpc.lpc_plan_cuda(targs[1], targs[2], targs[4], B),
                       tlpc.lpc_lane_perm(targs[1], targs[2], targs[4], B))
    before = tlpc.KERNEL_LAUNCHES
    assert torch.equal(tlpc.flac_lpc(*targs), want)
    assert tlpc.KERNEL_LAUNCHES == before + 1
    for perm in (torch.arange(L, dtype=torch.int32),
                 torch.from_numpy(rng.permutation(L).astype(np.int32))):
        out = torch.full_like(targs[0], -7)
        tlpc.flac_lpc_launch(*targs, perm.to(cuda), out)
        assert torch.equal(out, want)
    # rows 4 bytes off 16-byte alignment take the 4-byte copies
    odd = torch.empty(L * B + 1, dtype=torch.int32, device=cuda)[1:]
    odd = odd.view(L, B).copy_(targs[0])
    assert torch.equal(tlpc.flac_lpc(odd, *targs[1:]), want)


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


# the decode kernel's lanes a block (one a thread) and steps a tile
# (csrc/qoa_lms.cu kDecLanes, kDecTile)
QOA_DEC_BLOCK = 32
QOA_DEC_TILE = 80


def _check_decode_both_forms(cuda, history, weights, sf, codes, deq):
    """The fused form (decode_slices) and the int32 form (qoa_decode), one
    launch each, against the twin."""
    h, w, sf_d, codes_d, deq_d = (torch.from_numpy(a).to(cuda) for a in
                                  (history, weights, sf, codes, deq))
    before = tlms.DECODE_LAUNCHES
    got = tlms.decode_slices(h, w, sf_d, codes_d)
    got32 = tlms.qoa_decode(h, w, deq_d)
    torch.cuda.synchronize()
    assert tlms.DECODE_LAUNCHES == before + 2
    want = tlms.qoa_decode_torch(h, w, deq_d)
    assert torch.equal(got, want) and torch.equal(got32, want)


@pytest.mark.parametrize("L", [1, QOA_DEC_BLOCK - 1, QOA_DEC_BLOCK,
                               QOA_DEC_BLOCK + 1, 6584, 8191, 8192])
@pytest.mark.parametrize("T", [20, QOA_DEC_TILE - 20, QOA_DEC_TILE + 20,
                               5120])
def test_qoa_decode_kernel_lanes_and_lengths_match_twin(cuda, L, T):
    """Lane counts around a block and the main path's windows (full and the
    QOA decode slice's 6,584-lane tail), T around a tile, both forms;
    int32-range weights, and history at +-32768 on some lanes."""
    rng = np.random.default_rng(L * 7 + T)
    history, weights, sf, codes, deq = _qoa_decode_args(rng, L, T // 20)
    edge = rng.random(L) < 0.1
    history[edge] = rng.choice([-32768, 32768], (int(edge.sum()), 4))
    _check_decode_both_forms(cuda, history, weights, sf, codes, deq)


@pytest.mark.parametrize("T", [1, 79, 81, 160, 5120])
def test_qoa_decode_kernel_unaligned_rows_match_twin(cuda, T):
    """Inputs that are not 16-byte aligned take the kernels' 4-byte loads:
    residuals and codes one word past an aligned start; T not a multiple
    of 4 (int32 form), wrapping residuals."""
    L = 45
    rng = np.random.default_rng(T)
    history, weights, _, _, _ = _qoa_decode_args(rng, L, 1)
    deq = rng.integers(-(1 << 31), 1 << 31, (L, T)).astype(np.int32)
    deq[rng.random((L, T)) < 0.7] %= 3000
    h, w = (torch.from_numpy(a).to(cuda) for a in (history, weights))
    buf = torch.empty(L * T + 1, dtype=torch.int32, device=cuda)
    deq_d = buf[1:].view(L, T)
    deq_d.copy_(torch.from_numpy(deq))
    got = tlms.qoa_decode(h, w, deq_d)
    assert torch.equal(got, tlms.qoa_decode_torch(h, w, deq_d))
    S = max(T // 20, 4) // 4 * 4      # whole tiles: only the start differs
    _, _, sf, codes, deq = _qoa_decode_args(rng, L, S)
    sf_d, deq_d = (torch.from_numpy(a).to(cuda) for a in (sf, deq))
    cbuf = torch.empty(codes.size + 4, dtype=torch.int8, device=cuda)
    codes_d = cbuf[4:].view(L, S, 20)
    codes_d.copy_(torch.from_numpy(codes))
    got = tlms.decode_slices(h, w, sf_d, codes_d)
    assert torch.equal(got, tlms.qoa_decode_torch(h, w, deq_d))


def test_qoa_decode_kernel_on_a_side_stream(cuda):
    """Both forms launched on a stream other than the default one."""
    rng = np.random.default_rng(11)
    args = _qoa_decode_args(rng, 300, 256)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        h, w, sf, codes, deq = (torch.from_numpy(a).to(cuda) for a in args)
        got = tlms.decode_slices(h, w, sf, codes)
        got32 = tlms.qoa_decode(h, w, deq)
    side.synchronize()
    want = tlms.qoa_decode_torch(h, w, deq)
    assert torch.equal(got, want) and torch.equal(got32, want)


def test_qoa_decode_launch_alone_matches_wrapper(cuda):
    """qoa_decode_launch writes the wrapper's output into a given tensor,
    and refuses one that is not 16-byte aligned."""
    rng = np.random.default_rng(12)
    h, w, sf, codes, deq = (torch.from_numpy(a).to(cuda) for a in
                            _qoa_decode_args(rng, 70, 12))
    out = torch.full((70, 240), 7, dtype=torch.int32, device=cuda)
    tlms.qoa_decode_launch(h, w, out, scalefactors=sf, codes=codes)
    assert torch.equal(out, tlms.decode_slices(h, w, sf, codes))
    out.fill_(7)
    tlms.qoa_decode_launch(h, w, out, dequantized=deq)
    assert torch.equal(out, tlms.qoa_decode(h, w, deq))
    bad = torch.empty(70 * 240 + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError):
        tlms.qoa_decode_launch(h, w, bad.view(70, 240), dequantized=deq)


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


def _check_encode(cuda, s, history, weights, flen):
    """The encode kernel through both entries, one launch each, against
    the twin: scalefactors, codes and the carried state, and the word
    plane from the encoder's initial state."""
    L = s.shape[0]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (s, history, weights, flen)]
    before = tlms.ENCODE_LAUNCHES
    got = tlms.qoa_encode_frame_scan(*args)
    words = tlms.qoa_encode_frame_words(args[0], args[3])
    torch.cuda.synchronize()
    assert tlms.ENCODE_LAUNCHES == before + 2
    for g, w in zip(got, tlms.qoa_encode_frame_torch(*args)):
        assert torch.equal(g, w)
    h0 = torch.zeros_like(args[1])
    w0 = torch.from_numpy(np.tile(tlms.INITIAL_WEIGHTS, (L, 1))).to(cuda)
    sf, codes, _, _ = tlms.qoa_encode_frame_torch(args[0], h0, w0, args[3])
    assert torch.equal(words, tlms.pack_words(sf, codes))


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_qoa_encode_kernel_slice_edges_match_twin(cuda, dtype):
    """Frame lengths at every slice edge side by side in one block (a
    lane's full slices take the unguarded body, its last partial slice the
    guarded one, and slices past the frame write word 0), L = 30."""
    _check_encode(cuda, *torch_qoa_cases.slice_edge_lanes(dtype))


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_qoa_encode_kernel_ties_match_twin(cuda, dtype):
    """All-zero and constant lanes, where several candidates give the same
    error and the first minimum must win; L = 13."""
    _check_encode(cuda, *torch_qoa_cases.tie_lanes(dtype))


def test_qoa_quantizer_matches_direct_form_on_every_residual(cuda):
    """The encode kernel's quantizer (clamp to ±7, the code as 2m + sign,
    the magnitude by a byte permute) against its direct form on all 2^32
    int32 residuals, for each of the 16 scalefactors."""
    counts = tlms.qoa_quant_mismatches(cuda)
    torch.cuda.synchronize()
    assert counts.tolist() == [0] * 16


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


# ------------------------------------------------------------------- MP3
@pytest.mark.parametrize("L,W", [(1, 20), (300, 20), (5000, 52), (257, 136)])
def test_mp3_huff_kernel_matches_twin(cuda, L, W):
    from audio_formats_torch.ops import mp3_huff

    rng = np.random.default_rng(L + W)
    pool, meta = (torch.from_numpy(a).to(cuda)
                  for a in mp3_random_lanes(rng, L, W))
    before = mp3_huff.HUFF_LAUNCHES
    # q comes from torch.empty: hand the kernel a block of -7s, so a
    # position it does not write shows
    torch.full((L, 576), -7, dtype=torch.int32, device=cuda)
    q, err = mp3_huff.huff_decode(pool, meta, W, 1)
    torch.cuda.synchronize()
    assert mp3_huff.HUFF_LAUNCHES == before + 1
    assert q.device.type == "cuda" and q.dtype == torch.int32
    qt, errt = mp3_huff.huff_decode_torch(pool, meta, W, 1)
    assert torch.equal(q, qt) and torch.equal(err, errt)


@pytest.mark.parametrize("L,W,case", [
    (300, 20, "past_clamp"),   # bit_start past (W - 3) * 32: the window
    (513, 136, "past_clamp"),  # of words reloads backwards
    (600, 4, "random"),        # the narrowest row
    (700, 136, "random"),      # a lane row's width before the frame pool
    (120, 1000, "random"),     # a frame pool's width
    (1000, 52, "no_pairs"),    # every lane bv = 0: count1 and zeros only
    (257, 52, "mixed_pairs"),  # pair counts of every size in one warp
    (400, 52, "wide_linbits"),  # linbits past the tables' 13
])
def test_mp3_huff_kernel_edges_match_twin(cuda, L, W, case):
    """The backward clamp, both ends of the row width, windows without big
    values, linbits wider than any table's, L not a multiple of the
    256-lane block; the plan's offsets and lane order equal their twins'; the
    wrapper's lane
    order, the window's own order and a random order all give the twin's
    q and err."""
    from audio_formats_torch.ops import mp3_huff

    rng = np.random.default_rng(L + W)
    pool, meta = mp3_random_lanes(rng, L, W)
    if case == "past_clamp":
        meta[::2, 0] = rng.integers((W - 3) * 32, W * 32 + 300, (L + 1) // 2)
    elif case == "no_pairs":
        meta[:, 2] = 0
    elif case == "mixed_pairs":
        meta[:, 2] = rng.permutation(np.arange(L) % 290)
    elif case == "wide_linbits":
        meta[:, 8:11] = rng.integers(0, 20, (L, 3))
    pool, meta = (torch.from_numpy(a).to(cuda) for a in (pool, meta))
    qt, errt = mp3_huff.huff_decode_torch(pool, meta, W, 1)
    torch.full((L, 576), -7, dtype=torch.int32, device=cuda)
    q, err = mp3_huff.huff_decode(pool, meta, W, 1)
    assert torch.equal(q, qt) and torch.equal(err, errt)
    offs = mp3_huff._lane_offsets(meta[:, mp3_huff.M_SPAN], 1).to(torch.int32)
    # the card's plan is the twins' offsets and lane order
    offs_c, perm_c = mp3_huff.huff_plan_cuda(meta, 1)
    assert torch.equal(offs_c, offs)
    assert torch.equal(perm_c, mp3_huff.huff_lane_perm(meta))
    for perm in (torch.arange(L, dtype=torch.int32),
                 torch.from_numpy(rng.permutation(L).astype(np.int32))):
        q2 = torch.full((L, 576), -7, dtype=torch.int32, device=cuda)
        e2 = torch.ones(L, dtype=torch.bool, device=cuda)
        mp3_huff.huff_launch(pool, meta, W, offs, perm.to(cuda), q2, e2)
        assert torch.equal(q2, qt) and torch.equal(e2, errt)


@pytest.mark.parametrize("lpf", [2, 4])
def test_mp3_huff_kernel_frames_match_twin(cuda, lpf):
    """Lanes that share their frame's words (lanes_per_frame > 1, the
    batch wire): each reads on into the words of its frame's later lanes
    and zeros past the frame; the plan's offsets are the twin's, and the
    kernel's q and err the twin's."""
    from audio_formats_torch.ops import mp3_huff

    rng = np.random.default_rng(40 + lpf)
    L = 1024
    pool, meta = mp3_random_lanes(rng, L, 28)
    meta, reach = as_frames(meta, lpf)
    W = mp3_huff.row_width(reach)
    pool, meta = (torch.from_numpy(a).to(cuda) for a in (pool, meta))
    qt, errt = mp3_huff.huff_decode_torch(pool, meta, W, lpf)
    torch.full((L, 576), -7, dtype=torch.int32, device=cuda)
    q, err = mp3_huff.huff_decode(pool, meta, W, lpf)
    assert torch.equal(q, qt) and torch.equal(err, errt)
    offs_c, perm_c = mp3_huff.huff_plan_cuda(meta, lpf)
    assert torch.equal(offs_c, mp3_huff._lane_offsets(
        meta[:, mp3_huff.M_SPAN], lpf).to(torch.int32))
    assert torch.equal(perm_c, mp3_huff.huff_lane_perm(meta))


def test_mp3_huff_kernel_rejects_bad_arguments(cuda):
    from audio_formats_torch.ops import mp3_huff

    rng = np.random.default_rng(5)
    pool, meta = (torch.from_numpy(a).to(cuda)
                  for a in mp3_random_lanes(rng, 16, 20))
    for bad in ((pool, meta.to(torch.int32), 20, 1), (pool.cpu(), meta, 20, 1),
                (pool.to(torch.int64), meta, 20, 1),
                (pool, meta.t().contiguous().t(), 20, 1),
                (pool, meta, 1200, 1), (pool, meta, 20, 3)):
        with pytest.raises(ValueError):
            mp3_huff.huff_decode_cuda(*bad)


def _mp3_streams():
    """Golden MP3 streams with PCM in [-1, 1]: mono, LR stereo with short
    blocks and linbits escapes, MS, intensity, a 3-window stream."""
    from golden import mp3_ref

    rng = np.random.default_rng(12)

    def stream(channels, n_frames, mode_ext=None):
        frames = []
        for i in range(n_frames):
            grs = []
            for g in range(2):
                q = np.zeros(576, np.int64)
                idx = rng.choice(400, 60, replace=False)
                q[idx] = rng.integers(-40, 41, 60)
                q[rng.choice(100, 4, replace=False)] = \
                    rng.integers(-900, 901, 4)
                gr = {"q": q, "global_gain": 146}
                if i % 5 == 3:
                    gr["block_type"] = 2
                chans = [dict(gr) for _ in range(channels)]
                if channels == 2:
                    qr = q.copy()
                    qr[200:] = 0
                    chans[1]["q"] = qr
                grs.append(chans)
            frames.append(grs)
        return mp3_ref.build_mp3(frames, channels=channels,
                                 mode_ext=mode_ext)

    return [stream(1, 12), stream(2, 12), stream(2, 12, 2),
            stream(2, 12, [1, 3, 0, 2] * 3), stream(2, 55, 2)]


def test_batch_decoder_mp3_cuda_equals_cpu(cuda):
    from audio_formats_torch.ops import mp3_dsp, mp3_huff

    streams = _mp3_streams()
    before = mp3_huff.HUFF_LAUNCHES
    dsp_before = mp3_dsp.DSP_LAUNCHES
    synth_before = mp3_dsp.SYNTH_LAUNCHES
    dec = BatchDecoder(streams, device=cuda)
    res = dec.decode_all(output="device")
    for kind, wins in res.windows():
        assert kind == "mp3" and all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    assert dec.stats["group_demotions"] == 0
    assert mp3_huff.HUFF_LAUNCHES - before == dec.stats["windows"]
    assert mp3_dsp.DSP_LAUNCHES - dsp_before == dec.stats["windows"]
    assert mp3_dsp.SYNTH_LAUNCHES - synth_before == dec.stats["windows"]
    want = BatchDecoder(streams, device="cpu").decode_all()
    got_np = BatchDecoder(streams, device=cuda).decode_all()
    for a, b, c in zip(got, want, got_np):
        assert a.shape == b.shape and np.abs(b).max() <= 1.0
        # the same torch ops on the card and the CPU: sums in another order
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(c, a)


def test_mp3_launch_spans_count_each_kernel(cuda):
    """Each MP3 Layer III window's launch span reports one K3, one K14
    and one K15 launch."""
    from audio_formats_torch import trace

    dec = BatchDecoder(_mp3_streams(), device=cuda)
    trace.drain()
    trace.enable()
    try:
        dec.decode_all(output="device").sync()
    finally:
        trace.disable()
        spans = trace.drain()["spans"]
    launches = [s["attrs"] for s in spans
                if s["name"] == "launch" and s["attrs"]["format"] == "mp3"]
    assert len(launches) == dec.stats["windows"] > 0
    for attrs in launches:
        assert (attrs["launches"], attrs["dsp_launches"],
                attrs["synth_launches"]) == (1, 1, 1)


#: 30 s stereo MPEG-1 clips, as many as a call of the fma_mp3.b32 cell
MP3_CLIP_FRAMES, MP3_CLIPS = 1148, 32


def _mp3_clips():
    """MP3_CLIPS joint-stereo clips of MP3_CLIP_FRAMES frames: the frames
    of the 55-frame MS stream and the 12-frame intensity stream of
    _mp3_streams, each clip from another frame on, over and over (the
    golden encoder's 320 kbit/s frames are all 1,044 bytes and leave no
    bits in the reservoir, so any sequence of them is a stream)."""
    streams = _mp3_streams()
    fb = 1044
    frames = [s[i: i + fb] for s in (streams[4], streams[3])
              for i in range(0, len(s), fb)]
    return [b"".join(frames[(k * 7 + i) % len(frames)]
                     for i in range(MP3_CLIP_FRAMES))
            for k in range(MP3_CLIPS)]


def test_mp3_windows_sized_to_the_batch(cuda, monkeypatch):
    """Clips of the benchmark cell's shape decode in windows sized to a
    wave of K3 (two of 576 frames on a 132-SM card) and in forced 24-frame
    windows: the PCM of each is within K14_TOL of the peak of the other
    and of the plain chain's on the CPU, for the clips the CPU decodes
    (K3 and K14 act on a lane's rows alone; the product's sums run in
    another order where cuBLAS picks another kernel for the taller
    operand: on the cell's clips the two windows read 1.05e-6 of the
    peak, chip_smoke.py --windows), one K3 launch runs a window, and each
    window span carries its frames."""
    from audio_formats_torch import trace
    from audio_formats_torch.ops import mp3_huff

    clips = _mp3_clips()
    W = mp3_groups.mp3_window_frames(MP3_CLIPS * 4, MP3_CLIP_FRAMES,
                                 mp3_groups.mp3_wave_lanes(cuda))
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert W == 576
    assert W > mp3_groups.MP3_WINDOW_FRAMES

    def run():
        before = mp3_huff.HUFF_LAUNCHES
        dec = BatchDecoder(clips, device=cuda)
        trace.drain()
        trace.enable()
        try:
            pcm = dec.decode_all(output="device").sync().to_numpy()
        finally:
            trace.disable()
            spans = trace.drain()["spans"]
        assert dec.stats["group_demotions"] == 0
        assert mp3_huff.HUFF_LAUNCHES - before == dec.stats["windows"]
        frames = {s["attrs"]["frames"] for s in spans
                  if s["name"] == "window"}
        return pcm, dec.stats, frames

    def gap(a, b):
        assert a.shape == b.shape == (MP3_CLIP_FRAMES * 1152, 2)
        peak = np.abs(b).max()
        assert peak > 0.05
        return np.abs(a - b).max() / peak

    sized, st, frames = run()
    assert st["windows"] == -(-MP3_CLIP_FRAMES // W)
    assert st["mp3_window_frames"] == W and frames == {W}
    plain = BatchDecoder(clips[:2], device="cpu").decode_all()
    monkeypatch.setattr(mp3_groups, "mp3_window_frames",
                        lambda lpf, frames_left, wave: 24)
    small, st24, frames24 = run()
    assert st24["windows"] == -(-MP3_CLIP_FRAMES // 24)
    assert st24["mp3_window_frames"] == 24 and frames24 == {24}
    for a, b in zip(sized, small):
        assert gap(a, b) <= K14_TOL
    for a, b, c in zip(sized, small, plain):
        assert gap(a, c) <= K14_TOL and gap(b, c) <= K14_TOL


def test_mp3_facade_cuda_state_moves_to_cpu(cuda):
    """The facade on the card reads part of a stream; its carried state
    (tensors on the card) loads into a CPU decoder, which reads the rest:
    together equal to one whole CPU read."""
    from audio_formats_torch.io.source import MemorySource
    from audio_formats_torch.models import mp3 as tmp3

    data = _mp3_streams()[3]
    whole = tmp3.Mp3Decoder(MemorySource(data), device="cpu").read(10 ** 6)
    dec = tmp3.Mp3Decoder(MemorySource(data), device=cuda)
    first = dec.read(5 * 1152 + 333)
    assert dec._overlap.device.type == "cuda"
    rest_dec = tmp3.Mp3Decoder(MemorySource(data), device="cpu")
    tmp3.load_state(rest_dec, tmp3.save_state(dec))
    got = np.concatenate([first, rest_dec.read(10 ** 6)])
    assert got.shape == whole.shape and np.abs(whole).max() > 0.05
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


def test_mp3_kernel_launch_failure_raises(cuda, monkeypatch):
    """A failing Huffman launch makes decode_all raise: no lane is demoted
    to the facade, whose Huffman decode runs on the host."""
    import types

    from audio_formats_torch.ops import _kernels

    monkeypatch.setitem(_kernels._libs, "mp3_huff", types.SimpleNamespace(
        af_mp3_huff_plan_scratch=lambda L: 1, af_mp3_huff_plan=lambda *args: 0,
        af_mp3_huff=lambda *args: 700))
    dec = BatchDecoder(_mp3_streams()[:2], device=cuda)
    with pytest.raises(_kernels.KernelError, match="CUDA error 700"):
        dec.decode_all(output="device")
    assert dec.stats["group_demotions"] == 0


def test_mp3_dsp_refuses_tf32(cuda):
    from audio_formats_torch.ops import mp3_dsp

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            mp3_dsp.mp3_synth_slots(torch.zeros((1, 1, 4, 32), device=cuda),
                                    torch.zeros((1, 1, 16, 32), device=cuda),
                                    nch=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------- MP3 window, K14
#: K14 against its twin (spectrum_stage + mp3_window_dsp, torch ops on the
#: card): the IMDCT's and the synthesis's sums in other orders, float32
#: rounding over 18 + 1,088 terms, as a share of the twin's peak
K14_TOL = 1e-5


def _on_card(cuda, win):
    return {k: torch.from_numpy(v).to(cuda) if isinstance(v, np.ndarray)
            else v for k, v in win.items()}


@pytest.mark.parametrize("name", torch_mp3_cases.WINDOW_CASES)
def test_mp3_window_kernel_matches_twin(cuda, name):
    """packed_window's route on the card (K3, K14, the synthesis kernel
    K15) against K3 then the twin (packed_device_stage, mp3_window_dsp) on
    the same lanes, over two chained windows, each route carrying its own
    state: the PCM, overlap' and shist' within K14_TOL of the twin's peak,
    and one K14 and one K15 launch a window."""
    from audio_formats_torch.ops import mp3_dsp, mp3_huff

    case = torch_mp3_cases.window_case(name)
    B, G, nch = case["B"], case["G"], case["nch"]
    opts = {"mpeg1": case["mpeg1"], "short": case["short"]}
    state_k = [torch.from_numpy(case[k]).to(cuda)
               for k in ("overlap", "shist")]
    state_t = [s.clone() for s in state_k]
    for win in case["windows"]:
        w = _on_card(cuda, win)
        before = mp3_dsp.DSP_LAUNCHES
        synth_before = mp3_dsp.SYNTH_LAUNCHES
        pcm_k, *state_k = mp3_huff.packed_window(
            w["pool"], w["meta16"], w["scfq"], w["ist"], *state_k,
            w["n_act"], B=B, G=G, nch=nch, W=w["W"], **opts)
        assert mp3_dsp.DSP_LAUNCHES == before + 1
        assert mp3_dsp.SYNTH_LAUNCHES == synth_before + 1
        xq, aa, wt = mp3_huff.packed_device_stage(
            w["pool"], w["meta16"], w["scfq"], w["W"], B, G, nch,
            ist=w["ist"], **opts)
        pcm_t, *state_t = mp3_dsp.mp3_window_dsp(
            xq, aa, wt, *state_t, w["n_act"], nch=nch, ngr=G)
        for got, want in zip((pcm_k, *state_k), (pcm_t, *state_t)):
            assert got.is_cuda and got.shape == want.shape
            assert bool(torch.isfinite(got).all())
            gap = float((got - want).abs().max() / want.abs().max())
            assert gap <= K14_TOL, (name, gap)


def test_mp3_window_kernel_rejects_bad_arguments(cuda):
    from audio_formats_torch.ops import mp3_dsp

    B, G, nch = 2, 4, 2
    L = B * G * nch
    good = {"q": torch.zeros((L, 576), dtype=torch.int32, device=cuda),
            "meta16": torch.zeros((L, 16), dtype=torch.int16, device=cuda),
            "scfq": torch.zeros((L, 40), dtype=torch.int16, device=cuda),
            "n_act": torch.full((B,), G, dtype=torch.int32, device=cuda),
            "overlap": torch.zeros((B, nch, 32, 18), device=cuda),
            "shist": torch.zeros((B, nch, 16, 32), device=cuda)}
    shape = {"B": B, "G": G, "nch": nch}
    before = mp3_dsp.DSP_LAUNCHES
    operand, _, _ = mp3_dsp.window_dsp_cuda(**good, **shape)
    mp3_dsp.window_dsp_cuda(
        **good, abcd=torch.zeros((B * G, 4, 40), device=cuda), **shape)
    torch.cuda.synchronize()
    assert mp3_dsp.DSP_LAUNCHES == before + 2
    assert operand.shape == (L, 1088) and not bool(operand.any())
    bad = [("q", good["q"].to(torch.int64)), ("q", good["q"][:, :288]),
           ("q", good["q"].t().contiguous().t()),
           ("meta16", good["meta16"].to(torch.int32)),
           ("scfq", good["scfq"].cpu()),
           ("n_act", good["n_act"].to(torch.int64)),
           ("overlap", good["overlap"].transpose(2, 3)),
           ("shist", good["shist"].transpose(2, 3).contiguous()),
           ("abcd", torch.zeros((B * G, 4, 39), device=cuda)),
           ("abcd", torch.zeros((B * G, 4, 40), dtype=torch.float64,
                                device=cuda))]
    for name, t in bad:
        with pytest.raises(ValueError):
            mp3_dsp.window_dsp_cuda(**{**good, name: t}, **shape)
    with pytest.raises(ValueError):
        mp3_dsp.window_dsp_cuda(**good, B=B, G=G, nch=1)
    with pytest.raises(ValueError):
        mp3_dsp.window_dsp_cuda(**good, B=B, G=G, nch=3)
    assert mp3_dsp.DSP_LAUNCHES == before + 2


# ------------------------------------------------ MP3 synthesis, K15
#: K15 against its plain version (operand @ SYNTH_TOEPLITZ, a cuBLAS fp32
#: GEMM): the DCTs of 34 slots and 16 window taps against 1,088-term dot
#: products, sums in other orders, as a share of the twin's peak
K15_TOL = 1e-5


def _gap(got, want):
    assert got.is_cuda and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", torch_mp3_cases.WINDOW_CASES)
def test_mp3_synth_kernel_matches_twin(cuda, name):
    """K15 on K14's operand of two chained windows of each case against
    synth_twin on the same operand: within K15_TOL of the twin's peak, one
    launch a call."""
    from audio_formats_torch.ops import mp3_dsp, mp3_huff

    case = torch_mp3_cases.window_case(name)
    B, G, nch = case["B"], case["G"], case["nch"]
    state = [torch.from_numpy(case[k]).to(cuda) for k in ("overlap", "shist")]
    for win in case["windows"]:
        w = _on_card(cuda, win)
        q, _ = mp3_huff.huff_decode(w["pool"], w["meta16"], w["W"],
                                    w["lanes_per_frame"])
        abcd = None
        if w["ist"] is not None:
            abcd = mp3_huff._window_abcd(
                q, w["meta16"][:, mp3_huff.M_PATTERN].to(torch.int64),
                w["meta16"][:, mp3_huff.M_STEREO].to(torch.int64), w["ist"],
                B * G, nch, case["mpeg1"])
        operand, *state = mp3_dsp.window_dsp_cuda(
            q, w["meta16"], w["scfq"], w["n_act"], *state, abcd, B=B, G=G,
            nch=nch, short=case["short"])
        before = mp3_dsp.SYNTH_LAUNCHES
        got = mp3_dsp.synth_cuda(operand)
        assert mp3_dsp.SYNTH_LAUNCHES == before + 1
        gap = _gap(got, mp3_dsp.synth_twin(operand))
        assert gap <= K15_TOL, (name, gap)


@pytest.mark.parametrize("L", [1, 3, 4, 4097])
def test_mp3_synth_kernel_matches_twin_on_random_rows(cuda, L):
    """Random operands of row counts around K15's block of 4 rows (a
    partial last block, a grid of one block, of 1,025)."""
    from audio_formats_torch.ops import mp3_dsp

    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.normal(0, 0.3, (L, 1088)).astype(np.float32))\
        .to(cuda)
    gap = _gap(mp3_dsp.synth_cuda(x), mp3_dsp.synth_twin(x))
    assert gap <= K15_TOL, (L, gap)


def test_mp3_synth_kernel_rejects_bad_arguments(cuda):
    from audio_formats_torch.ops import mp3_dsp

    L = 8
    good = torch.zeros((L, 1088), device=cuda)
    flat = torch.zeros(L * 1088 + 1, device=cuda)
    before = mp3_dsp.SYNTH_LAUNCHES
    pcm = mp3_dsp.synth_cuda(good)
    torch.cuda.synchronize()
    assert mp3_dsp.SYNTH_LAUNCHES == before + 1
    assert pcm.shape == (L, 576) and not bool(pcm.any())
    empty = mp3_dsp.synth_cuda(good[:0])
    assert empty.shape == (0, 576) and empty.is_cuda
    bad = [good.to(torch.float64), good[:, :1087].contiguous(),
           good.reshape(-1), good.reshape(2, L // 2, 1088),
           good.t().contiguous().t(), good.cpu(),
           flat[1:].view(L, 1088)]
    for t in bad:
        with pytest.raises(ValueError):
            mp3_dsp.synth_cuda(t)
    assert mp3_dsp.SYNTH_LAUNCHES == before + 1


# ------------------------------------------------------------- FLAC Rice
RICE_KEYS = ("residual", "coeffs", "order", "shift", "wasted", "sub_bps",
             "err", "end_bits")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                             if a.dtype == np.uint32 else
                             np.ascontiguousarray(a)).to(dev) for a in arrays]


def _rice_kernel_vs_twin(cuda, args, L, NSAMP, nch, NPOOL):
    """K4 on the card against the twin on the CPU, every output, one
    launch.  Returns the twin's output."""
    want = trice.flac_frame_entropy(*args, L, NSAMP, nch, NPOOL)
    before = trice.RICE_LAUNCHES
    got = trice.flac_frame_entropy(*_on(cuda, *args), L, NSAMP, nch, NPOOL)
    torch.cuda.synchronize()
    assert trice.RICE_LAUNCHES - before == 1
    for k in RICE_KEYS:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), want[k]), k
    return want


@pytest.mark.parametrize("name,kw", torch_flac_cases.CASES,
                         ids=[c[0] for c in torch_flac_cases.CASES])
def test_rice_kernel_matches_twin_on_subframe_cases(cuda, name, kw):
    frames = torch_flac_cases.case_frames(name, kw)
    want = _rice_kernel_vs_twin(
        cuda, torch_flac_cases.lanes(frames, 32, 320), 32, 1024, 2, 320)
    assert not want["err"][:len(frames)].any()


@pytest.mark.parametrize("how", ["flips", "zeroed", "headers", "cut"])
def test_rice_kernel_matches_twin_on_corrupt_frames(cuda, how):
    frames = torch_flac_cases.corrupt_frames(7, how)
    _rice_kernel_vs_twin(cuda, torch_flac_cases.lanes(frames, 32, 320), 32,
                         1024, 2, 320)


def test_rice_kernel_matches_twin_on_24bit_and_cut_pools(cuda):
    frames = torch_flac_cases.frames_24bit()
    _rice_kernel_vs_twin(cuda, torch_flac_cases.lanes(frames, 32, 320), 32,
                         1024, 2, 320)
    # a pool too small for its frames: cursors clamped at its end
    rng = np.random.default_rng(5)
    frames = torch_flac_cases.stream_frames(torch_flac_cases.make_stream(
        rng, bps=24, mode="verbatim", n=16 * 1024))
    _rice_kernel_vs_twin(cuda, torch_flac_cases.lanes(frames, 32, 320), 32,
                         1024, 2, 320)


@pytest.mark.parametrize("seed,L,NSAMP,nch,NPOOL", [
    (0, 32, 1024, 2, 320), (1, 70, 192, 1, 40), (2, 33, 31, 3, 12),
    (3, 100, 100, 2, 2), (4, 5, 7, 1, 3), (5, 257, 4096, 2, 64)])
def test_rice_kernel_matches_twin_on_random_bit_lanes(cuda, seed, L, NSAMP,
                                                      nch, NPOOL):
    _rice_kernel_vs_twin(
        cuda, torch_flac_cases.random_lanes(seed, L, NPOOL, NSAMP), L, NSAMP,
        nch, NPOOL)


@pytest.mark.parametrize("name", torch_flac_cases.EDGE_CASES)
def test_rice_kernel_matches_twin_on_edge_lanes(cuda, name):
    """The new design's edges, a warp each: unary runs across a ring block
    and the ring's wrap, escape widths 0 and 31, partition orders 0 to 8,
    ragged stops, the clamp moving a cursor back, the pool's zero blocks."""
    _rice_kernel_vs_twin(cuda, torch_flac_cases.edge_lanes(name), 32, 1024,
                         2, 320)


def test_rice_launch_alone_matches_wrapper(cuda):
    args = _on(cuda, *torch_flac_cases.random_lanes(9, 64, 40, 256))
    want = trice.flac_frame_entropy(*args, 64, 256, 2, 40)
    out = trice.rice_outputs(64, 256, 2, cuda)
    got = trice.rice_launch(*args, 256, 2, out)
    for k in RICE_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_rice_kernel_rejects_bad_arguments(cuda):
    pool, sb, bs, bps, ca = _on(cuda, *torch_flac_cases.random_lanes(
        1, 8, 10, 64))
    with pytest.raises(ValueError):
        trice.flac_frame_entropy(pool, sb.to(torch.int64), bs, bps, ca, 8,
                                 64, 2, 10)
    with pytest.raises(ValueError):
        trice.flac_frame_entropy(pool[:, :32].contiguous(), sb, bs, bps, ca,
                                 8, 64, 2, 10)
    with pytest.raises(ValueError):
        trice.flac_frame_entropy(pool, sb.cpu(), bs, bps, ca, 8, 64, 2, 10)


def test_gather_pool_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    words[-130:] = 0
    zero_off = (5000 - 130) * 4
    sizes = rng.integers(1, 900, 20)
    src = rng.integers(0, zero_off - 900, 20)
    lanes = [(0, int(o), int(n)) for o, n in zip(src, sizes)]
    S = 23
    lane_src, cum, _ = trice.gather_pool_meta(np.zeros(1, np.int64), lanes,
                                              S, zero_off)
    npool = trice.pool_blocks_needed(sizes) + 3
    want = trice.gather_frame_pool(words, lane_src, cum, zero_off, npool, S)
    got = trice.gather_frame_pool(*_on(cuda, words, lane_src, cum), zero_off,
                                  npool, S)
    assert torch.equal(got.cpu(), want)


def _rice_streams():
    rng = np.random.default_rng(21)
    make = torch_flac_cases.make_stream
    streams = [make(rng, mode="lpc8", stereo="mid_side"),
               make(rng, n=3000), make(rng, mode="lpc8", wasted=2),
               make(rng, mode="verbatim", n=2500),
               make(rng, escape_bits=14, stereo="left_side"),
               make(rng, bps=24, mode="lpc8")]
    # a lane the host cannot parse past its middle: truncated there
    rng = np.random.default_rng(14)
    make(rng)
    bad = bytearray(make(rng, n=3000))
    bad[len(bad) // 2:] = b"\x55" * (len(bad) - len(bad) // 2)
    return streams + [bytes(bad)]


@pytest.mark.parametrize("gather", [False, True])
def test_batch_decoder_rice_cuda_equals_cpu(cuda, gather, monkeypatch):
    """The Rice wire on the card, with the host pool or the gathered one:
    PCM and lane errors equal to the CPU's Rice and packed wires; one K4
    and one K1 launch a dispatch."""
    streams = _rice_streams()
    if gather:
        monkeypatch.setattr(rice_groups, "RICE_GATHER_MIN_BYTES", 0)
    k4, k1 = trice.RICE_LAUNCHES, tlpc.KERNEL_LAUNCHES
    dec = BatchDecoder(streams, device=cuda, flac_wire="rice")
    res = dec.decode_all(output="device")
    for _, wins in res.windows():
        assert all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    n = dec.stats["windows_by_format"]["flac"]
    assert trice.RICE_LAUNCHES - k4 == n and tlpc.KERNEL_LAUNCHES - k1 == n
    assert dec.stats["group_demotions"] == 0
    cpu = BatchDecoder(streams, device="cpu", flac_wire="rice")
    want = cpu.decode_all()
    packed = BatchDecoder(streams, device="cpu").decode_all()
    got_np = BatchDecoder(streams, device=cuda, flac_wire="rice").decode_all()
    for a, b, c, p in zip(got, want, got_np, packed):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
        np.testing.assert_array_equal(p, b)
    assert dec.errors == cpu.errors
    assert dec.stats["rice_host_redo"] == cpu.stats["rice_host_redo"] > 0
    assert dec.stats["flac_truncated_lanes"] == 1


# ------------------------------------------------------------ PCM (K10)
@pytest.mark.parametrize("kind", torch_pcm_cases.KINDS)
def test_pcm_decode_kernel_matches_twin(cuda, kind):
    """Every u8, s16 and s24 value (all 2^24), 2^20 sampled s32 values:
    K10's decode bit-equal to the twin and to the reference's double
    math."""
    if kind == "s24":
        ints = np.arange(-(1 << 23), 1 << 23, dtype=np.int32)
    else:
        ints = torch_pcm_cases.decode_ints(kind, n=1 << 20)
    raw = torch.from_numpy(torch_pcm_cases.pack_ints(ints, kind))
    before = tpcm.DECODE_LAUNCHES
    got = tpcm.decode_bytes(raw.to(cuda), kind).cpu().numpy()
    assert tpcm.DECODE_LAUNCHES - before == 1
    want = tpcm.decode_bytes(raw, kind).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32),
        torch_pcm_cases.int_pcm_to_float_np(ints, kind).view(np.int32))
    # the twin's torch ops give the same bits on the card
    twin = tpcm.decode_bytes_torch(raw.to(cuda), kind).cpu().numpy()
    np.testing.assert_array_equal(twin.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("kind", torch_pcm_cases.KINDS)
def test_pcm_quantize_kernel_matches_twin(cuda, kind, dither, packed):
    """Edge values (x·scale = k + 0.5 and its neighbours, ±1, out of range,
    ±inf, NaN) and noise in rows of unequal lengths, each row's seed
    its own (0, 7, 2^32-1, 12345): packed bytes, and the ints that
    quantize_float_to_int reads back from them."""
    rows, _ = torch_pcm_cases.quantize_rows(kind)
    seeds = torch.tensor([0, 7, 0xFFFFFFFF, 12345])
    x = torch.from_numpy(rows)
    before = tpcm.ENCODE_LAUNCHES
    if packed:
        got = tpcm.quantize_pack(x.to(cuda), seeds, kind, dither).cpu()
        assert tpcm.ENCODE_LAUNCHES - before == 1
        assert torch.equal(got, tpcm.quantize_pack(x, seeds, kind, dither))
    else:
        for row, seed in zip(rows, seeds.tolist()):
            np.testing.assert_array_equal(
                tpcm.quantize_float_to_int(row, kind, dither=dither,
                                           seed=seed, device=cuda),
                tpcm.quantize_float_to_int(row, kind, dither=dither,
                                           seed=seed, device="cpu"))
        assert tpcm.ENCODE_LAUNCHES - before == len(rows)
    # the twin's torch ops give the same values on the card
    twin = tpcm.quantize_rows_torch(x.to(cuda), seeds.to(cuda), kind, dither)
    assert torch.equal(twin.cpu(),
                       tpcm.quantize_rows_torch(x, seeds, kind, dither))


@pytest.mark.parametrize("L,n", [(2, 70_001), (70_000, 3), (1, 1)])
def test_pcm_quantize_kernel_shapes_match_twin(cuda, L, n):
    """A row past 65,536 samples, more rows than a grid's y extent, one
    sample; dithered s24 and s16 bytes."""
    rng = np.random.default_rng(L + n)
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (L, n)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, L, dtype=np.int64))
    for kind in ("s16", "s24"):
        got = tpcm.quantize_pack(x.to(cuda), seeds, kind, True).cpu()
        assert torch.equal(got, tpcm.quantize_pack(x, seeds, kind, True))


def test_pcm_kernels_reject_bad_arguments(cuda):
    raw = torch.zeros(8, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tpcm.decode_bytes(raw[:7], "s16")
    with pytest.raises(ValueError):
        tpcm.decode_launch(raw, "s16", torch.empty(4, device=cuda,
                                                   dtype=torch.float64))
    x = torch.zeros((2, 5), device=cuda)
    with pytest.raises(ValueError):
        tpcm.quantize_pack(x, [0], "s16", True)
    with pytest.raises(ValueError):
        tpcm.quantize_pack(x.double(), [0, 1], "s16", True)
    with pytest.raises(ValueError):
        tpcm.quantize_pack(x.t().contiguous().t(), [0, 1], "s16", True)


def _wav_streams():
    from golden import wav_ref

    rng = np.random.default_rng(17)
    streams = []
    for bits in (8, 16, 24, 32):
        for ch, n in ((1, 3001), (2, 1500)):
            lo, hi = (0, 256) if bits == 8 else \
                (-(1 << (bits - 1)), 1 << (bits - 1))
            ints = rng.integers(lo, hi, n * ch)
            streams.append(wav_ref.build_wav(
                wav_ref.pack_pcm(ints, bits), fmt_tag=1, channels=ch,
                sample_rate=44100, bits=bits))
    return streams


def test_batch_decoder_wav_cuda_equals_cpu(cuda):
    streams = _wav_streams()
    before = tpcm.DECODE_LAUNCHES
    dec = BatchDecoder(streams, device=cuda)
    res = dec.decode_all(output="device")
    for kind, wins in res.windows():
        assert kind == "wav" and all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    assert tpcm.DECODE_LAUNCHES - before == dec.stats["windows"] == 4
    want = BatchDecoder(streams, device="cpu").decode_all()
    got_np = BatchDecoder(streams, device=cuda).decode_all()
    for a, b, c in zip(got, want, got_np):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("fmt", ["s8", "s16", "s24"])
def test_encode_wav_batch_cuda_equals_cpu(cuda, fmt, dither):
    from audio_formats_torch.config import AudioSampleFormat, EncodingOptions

    rng = np.random.default_rng(19)
    pcms = [np.clip(rng.standard_normal((n, ch)) * 0.4, -1.2, 1.2)
            .astype(np.float32) for n, ch in ((44100, 2), (1001, 1), (7, 2))]
    opt = EncodingOptions(sample_format=getattr(AudioSampleFormat, fmt),
                          enable_dither=dither, dither_seed=0xFFFFFFFE)
    before = tpcm.ENCODE_LAUNCHES
    got = encode_wav_batch(pcms, 44100, opt, device=cuda)
    assert tpcm.ENCODE_LAUNCHES - before == 1
    assert got == encode_wav_batch(pcms, 44100, opt, device="cpu")


# ------------------------------------------------------- Vorbis (K11)
VORBIS_CASES = [  # (seed, B, ch, K, bs0, bs1, lies, share of empty slots)
    (1, 6, 2, 8, 512, 2048, False, 0.15), (2, 5, 1, 8, 256, 1024, False, 0.15),
    (3, 40, 2, 8, 512, 2048, True, 0.15), (4, 3, 1, 5, 64, 8192, False, 0.15),
    (5, 4, 2, 8, 512, 512, False, 0.15), (6, 256, 2, 8, 512, 2048, False, 0.15),
    # chained and parallel lanes in one window (a third of the lanes lie)
    (7, 96, 2, 8, 512, 2048, 0.3, 0.15), (8, 64, 1, 8, 256, 1024, 0.3, 0.0),
    # every slot of every lane empty; one slot a window; one block size
    (9, 32, 2, 8, 512, 2048, False, 1.0), (10, 48, 2, 1, 512, 2048, 0.3, 0.15),
    (11, 40, 1, 8, 2048, 2048, False, 0.15)]


def _close(got, want, tol=4e-6):
    peak = float(want.abs().max()) + 1e-9
    assert got.shape == want.shape
    assert float((got - want).abs().max()) / peak < tol


@pytest.mark.parametrize("case", VORBIS_CASES)
def test_vorbis_lap_kernel_matches_twin(cuda, case):
    """K11 against its twin over two windows in a row, on the same IMDCT
    rows: PCM and lap within 4e-6 of the peak, lap_len and had_prev
    equal; where a share of the lanes lie, both of K11's paths run in the
    one launch."""
    seed, B, ch, K, bs0, bs1, lies, empty = case
    state = None
    for w in range(2):
        X, geom, lap, lap_len, had_prev = torch_pcm_cases.vorbis_chain_case(
            seed + 100 * w, B, ch, K, bs0, bs1, lies=lies, empty=empty)
        if state is None:
            state = tuple(torch.from_numpy(a).to(cuda)
                          for a in (lap, lap_len, had_prev))
        Xd, g = torch.from_numpy(X).to(cuda), torch.from_numpy(geom).to(cuda)
        h0 = bs0 // 2
        y1 = tmdct.imdct_batch(Xd.reshape(-1, bs1 // 2), bs1) \
            .reshape(K, -1, bs1)
        y0 = tmdct.imdct_batch(Xd[..., :h0].reshape(-1, h0), bs0) \
            .reshape(K, -1, bs0) if bs0 != bs1 else None
        if isinstance(lies, float) and K > 1:
            chained = twin.chained_lanes(*g, state[1], bs0=bs0, bs1=bs1)
            assert bool(chained.any()) and not bool(chained.all())
        before = twin.WIN_LAUNCHES
        got = twin.lap_chain(y1, y0, *g, *state, bs0=bs0, bs1=bs1, ch=ch)
        assert twin.WIN_LAUNCHES - before == 1
        want = twin.lap_chain_torch(y1, y0, *g, *state, bs0=bs0, bs1=bs1,
                                    ch=ch)
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        state = got[1:]


def test_vorbis_lap_kernel_unaligned_rows_match_twin(cuda):
    """IMDCT rows and outputs that do not start on 16 bytes take K11's
    serial path for every lane, in the same launch: equal to the twin."""
    B, ch, K, bs0, bs1 = 24, 2, 8, 512, 2048
    X, geom, lap, lap_len, had_prev = torch_pcm_cases.vorbis_chain_case(
        12, B, ch, K, bs0, bs1, lies=0.3)
    L, h0 = B * ch, bs0 // 2

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    Xd, g = torch.from_numpy(X).to(cuda), torch.from_numpy(geom).to(cuda)
    y1 = shifted(tmdct.imdct_batch(Xd.reshape(-1, bs1 // 2), bs1)
                 .reshape(K, L, bs1))
    y0 = shifted(tmdct.imdct_batch(Xd[..., :h0].reshape(-1, h0), bs0)
                 .reshape(K, L, bs0))
    st = [torch.from_numpy(a).to(cuda) for a in (lap, lap_len, had_prev)]
    out = (shifted(torch.zeros((K, L, bs1), device=cuda)),
           shifted(torch.zeros((L, bs1 // 2), device=cuda)),
           torch.empty(B, dtype=torch.int32, device=cuda),
           torch.empty(B, dtype=torch.int32, device=cuda))
    twin.lap_chain_launch(y1, y0, *g, *st, out, bs0=bs0, bs1=bs1, ch=ch)
    want = twin.lap_chain_torch(y1, y0, *g, *st, bs0=bs0, bs1=bs1, ch=ch)
    _close(out[0], want[0])
    _close(out[1], want[1])
    assert torch.equal(out[2], want[2]) and torch.equal(out[3], want[3])


def test_vorbis_lap_kernel_rejects_bad_arguments(cuda):
    X, geom, lap, lap_len, had_prev = torch_pcm_cases.vorbis_chain_case(
        1, 2, 2, 2, 512, 2048)
    y1 = torch.zeros((2, 4, 2048), device=cuda)
    y0 = torch.zeros((2, 4, 512), device=cuda)
    g = torch.from_numpy(geom).to(cuda)
    st = [torch.from_numpy(a).to(cuda) for a in (lap, lap_len, had_prev)]
    with pytest.raises(ValueError):
        twin.lap_chain(y1, y0, *g, *st, bs0=512, bs1=2048, ch=3)
    with pytest.raises(ValueError):
        twin.lap_chain(y1, y0[..., :256], *g, *st, bs0=512, bs1=2048, ch=2)
    with pytest.raises(ValueError):
        twin.lap_chain(y1, y0, *g, st[0].cpu(), *st[1:], bs0=512, bs1=2048,
                       ch=2)


def _vorbis_streams():
    from golden import vorbis_ref

    rng = np.random.default_rng(23)
    streams = []
    for ch, bs0, bs1, count in ((1, 512, 512, 11), (2, 512, 2048, 19),
                                (2, 512, 2048, 6), (1, 256, 1024, 14)):
        fix = vorbis_ref.Fixture(channels=ch, bs0=bs0, bs1=bs1,
                                 coupling=ch == 2)
        pattern = [1 if (j % 5) else 0 for j in range(count)]
        frames = []
        for j in range(count):
            lb = bool(pattern[j]) and bs0 != bs1
            n2 = (bs1 if lb else bs0) // 2
            posts = [[int(rng.integers(40, 100)) for _ in range(4)]
                     for _ in range(ch)]
            res = []
            for _ in range(ch):
                r = np.zeros(n2)
                idx = rng.choice(n2, size=n2 // 4, replace=False)
                r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
                res.append(r)
            pl = bool(pattern[j - 1]) if j else True
            nl = bool(pattern[j + 1]) if j + 1 < count else True
            frames.append(fix.audio_packet(posts, res, long_block=lb,
                                           prev_flag=int(pl),
                                           next_flag=int(nl)))
        streams.append(fix.build(frames))
    return streams


def test_batch_decoder_vorbis_cuda_equals_cpu(cuda):
    streams = _vorbis_streams()
    before = twin.WIN_LAUNCHES
    dec = BatchDecoder(streams, device=cuda)
    res = dec.decode_all(output="device")
    for kind, wins in res.windows():
        assert kind == "vorbis" and all(w.device.type == "cuda" for w in wins)
    got = res.sync().to_numpy()
    assert twin.WIN_LAUNCHES - before == dec.stats["windows"] > 0
    assert dec.stats["group_demotions"] == 0
    want = BatchDecoder(streams, device="cpu").decode_all()
    got_np = BatchDecoder(streams, device=cuda).decode_all()
    for a, b, c in zip(got, want, got_np):
        _close(torch.from_numpy(a), torch.from_numpy(b))
        _close(torch.from_numpy(c), torch.from_numpy(b))


def test_vorbis_imdct_refuses_tf32(cuda, monkeypatch):
    from audio_formats_torch.ops._kernels import KernelError

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(KernelError, match="Vorbis IMDCT"):
        tmdct.imdct_batch(torch.zeros((2, 256), device=cuda), 512)


#: K12a's bucket shapes: every (blocks, blocksize) of CELT's frames of 120,
#: 240, 480 and 960 samples, at a few row counts
CELT_SHAPES = [(1, 120), (1, 240), (2, 120), (1, 480), (4, 120), (1, 960),
               (8, 120)]


def _celt_inputs(rng, rows, frame, cuda):
    """Random spectra (or half-transforms) [rows, frame] and tails."""
    return (torch.from_numpy((rng.standard_normal((rows, frame)) * 400)
                             .astype(np.float32)).to(cuda),
            torch.from_numpy((rng.standard_normal((rows, 60)) * 400)
                             .astype(np.float32)).to(cuda))


@pytest.mark.parametrize("rows", [1, 7, 257])
@pytest.mark.parametrize("blocks,bs", CELT_SHAPES)
def test_celt_ola_kernel_matches_twin(cuda, blocks, bs, rows):
    """K12a's in-place mix (one launch) bit-equal to celt_ola_torch on the
    same half-transforms, at every bucket shape; for long blocks the whole
    celt_imdct_ola (the matmul into the packed buffer, then the mix) is
    celt_imdct_ola_torch bit for bit."""
    rng = np.random.default_rng([blocks, bs, rows])
    frame = blocks * bs
    halves, tail = _celt_inputs(rng, rows, frame, cuda)
    buf = torch.full((rows, frame + 60), float("nan"), device=cuda)
    buf[:, 60:] = halves
    before = tcelt.OLA_LAUNCHES
    assert tcelt.celt_ola(buf, tail, blocks) is buf
    want = tcelt.celt_ola_torch(halves.reshape(rows, blocks, bs), tail)
    assert tcelt.OLA_LAUNCHES - before == 1
    for g, w in zip((buf[:, :frame], buf[:, frame:]), want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    if bs == 120:
        return
    for scale in (1.0, 0.5):
        before = tcelt.OLA_LAUNCHES, tcelt.IMDCT_OLA_LAUNCHES
        got = tcelt.celt_imdct_ola_packed(halves, tail, blocks, bs, scale)
        assert (tcelt.OLA_LAUNCHES - before[0],
                tcelt.IMDCT_OLA_LAUNCHES - before[1]) == (1, 0)
        assert torch.equal(got, tcelt.celt_imdct_ola_packed_torch(
            halves, tail, blocks, bs, scale))


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("rows", [1, 7, 512, 4096])
@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_celt_imdct_ola_short_matches_twin(cuda, blocks, rows, scale):
    """Blocks of 120: celt_imdct_ola_packed is one launch of K12a's fused
    kernel (no matmul) into the packed [rows, frame + 60] output, within
    1e-6 of the peak of its twin (its dot products sum in another order
    than cuBLAS's)."""
    rng = np.random.default_rng([blocks, rows, int(scale * 2)])
    co, tail = _celt_inputs(rng, rows, blocks * 120, cuda)
    before = tcelt.OLA_LAUNCHES, tcelt.IMDCT_OLA_LAUNCHES
    got = tcelt.celt_imdct_ola_packed(co, tail, blocks, 120, scale)
    assert (tcelt.OLA_LAUNCHES - before[0],
            tcelt.IMDCT_OLA_LAUNCHES - before[1]) == (0, 1)
    want = tcelt.celt_imdct_ola_packed_torch(co, tail, blocks, 120, scale)
    assert got.shape == want.shape == (rows, blocks * 120 + 60)
    assert got.is_contiguous() and torch.isfinite(got).all()
    assert float((got - want).abs().max()) / float(want.abs().max()) < 1e-6


def test_celt_ola_launch_alone_matches_wrapper(cuda):
    """K12a's fused kernel into a made output equals its wrapper's, bit
    for bit, and writes every sample."""
    co, tail = _celt_inputs(np.random.default_rng(12), 64, 960, cuda)
    want = tcelt.imdct_ola_short(co, tail, 8)
    out = torch.full((64, 1020), float("nan"), device=cuda)
    tcelt.imdct_ola_short_launch(co, tail, 8, 1.0, out)
    assert torch.equal(out, want)


def test_celt_ola_kernel_rejects_bad_arguments(cuda):
    buf = torch.zeros((4, 1020), device=cuda)
    tail = torch.zeros((4, 60), device=cuda)
    for bad in ((buf, tail[:3]), (buf, tail.cpu()), (buf.double(), tail),
                (torch.zeros((4, 120), device=cuda), tail),
                (torch.zeros((4, 2040), device=cuda)[:, ::2], tail),
                (buf, torch.zeros((4, 120), device=cuda)[:, ::2])):
        with pytest.raises(ValueError):
            tcelt.celt_ola(*bad)
    with pytest.raises(ValueError):
        tcelt.celt_ola(buf, tail, 7)
    co = torch.zeros((4, 960), device=cuda)
    out = torch.zeros((4, 1020), device=cuda)
    for args in ((co, tail[:3], 8), (co, tail.cpu(), 8),
                 (co.double(), tail, 8), (co[:, ::2], tail, 4),
                 (co, tail, 3), (co[:, :840], tail, 7),
                 (torch.zeros((4, 1920), device=cuda)[:, ::2], tail, 8),
                 (torch.zeros(4 * 960 + 1, device=cuda)[1:].view(4, 960),
                  tail, 8)):
        with pytest.raises(ValueError):
            tcelt.imdct_ola_short(*args)
    for bad_out in (out[:, :1000], out.cpu(), out.double(),
                    torch.zeros((4, 2040), device=cuda)[:, ::2]):
        with pytest.raises(ValueError):
            tcelt.imdct_ola_short_launch(co, tail, 8, 1.0, bad_out)


def test_celt_imdct_refuses_tf32(cuda, monkeypatch):
    from audio_formats_torch.ops._kernels import KernelError

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(KernelError, match="CELT IMDCT"):
        tcelt.celt_imdct_ola(torch.zeros((2, 960), device=cuda),
                             torch.zeros((2, 60), device=cuda), 1, 960)


def _opus_streams():
    """CELT lanes of the committed corpus (both bucket shapes, a
    stereo-coded lane with a mono header) and a SILK lane (the SILK
    group)."""
    from golden import opus_ref
    from test_opus_silk import SILK_PACKETS

    corpus = torch_opus_cases.load()
    streams = [torch_opus_cases.stream(opus_ref.build_ogg_opus, corpus[i],
                                       n, channels=ch, preskip=ps)
               for i, n, ch, ps in ((0, 60, None, 312), (1, 41, None, 0),
                                    (2, 77, None, 130), (4, 50, None, 312),
                                    (3, 33, 1, 0))]
    streams.append(opus_ref.build_ogg_opus(
        [(bytes.fromhex(h), 960) for h in SILK_PACKETS], channels=1,
        preskip=0))
    return streams


def test_batch_decoder_opus_cuda_equals_cpu(cuda):
    """The Opus group on the card (K12a once a bucket a step) within 1e-5
    of the peak of the CPU decode (the IMDCT matmuls differ in their
    sums)."""
    streams = _opus_streams()
    before = (tcelt.OLA_LAUNCHES + tcelt.IMDCT_OLA_LAUNCHES,
              trs.UPSAMPLE_LAUNCHES)
    dec = BatchDecoder(streams, device=cuda)
    got = dec.decode_all(output="device").sync().to_numpy()
    wbf = dec.stats["windows_by_format"]
    assert (tcelt.OLA_LAUNCHES + tcelt.IMDCT_OLA_LAUNCHES - before[0]
            == wbf["opus"] > 0)
    assert trs.UPSAMPLE_LAUNCHES - before[1] == wbf["opus_silk"] > 0
    assert dec.stats["group_demotions"] == 0
    want = BatchDecoder(streams, device="cpu").decode_all()
    for a, b in zip(got, want, strict=True):
        _close(torch.from_numpy(a), torch.from_numpy(b), tol=1e-5)


def _silk_taps(den):
    """The reversed taps of phase count den as K13's host array."""
    t = trs._fit_tables()
    h = np.asarray(t[{6: "h_nb", 4: "h_mb", 3: "h_wb"}[den]], np.float64)
    return trs.pack_taps(h[:, ::-1])


def _fma_chain(x, h, G):
    """K13's own arithmetic in plain PyTorch: each output one f32 FMA
    chain over the taps, k = 0..95 in order from 0, each FMA rounded once
    (``ops.pcm._fma_f32``)."""
    rows, den = x.shape[0], h.shape[0]
    acc = torch.zeros((rows, G, den), dtype=torch.float32, device=x.device)
    for k in range(h.shape[1]):
        acc = tpcm._fma_f32(x[:, k: k + G, None], h[:, k], acc)
    return acc.reshape(rows, G * den)


@pytest.mark.parametrize("rows", [1, 31, 33, 256, 4096])
@pytest.mark.parametrize("G", [1, 7, 63, 65, 300, 320, 960])
@pytest.mark.parametrize("den", [6, 4, 3])
def test_silk_upsample_kernel_matches_twin(cuda, den, G, rows):
    """K13 (one launch) at every phase count, ragged group counts (a tile
    is 4 x 24 / den groups) and row counts (a tile is 32 rows), and a
    single row; rows wider than G + 95 are read only as far as needed.
    It is bit for bit one FMA chain an output, k in order from 0, and
    within 1e-6 of the peak of its twin, a cuBLAS
    full-float32 matmul.  cuBLAS sums in that order only where the kernel
    it picks for the shape does: for the groups' shapes (256 rows and
    more, 60 groups a row and more), not for a few rows or groups; the
    twin's bits are asserted there."""
    rng = np.random.default_rng([den, G, rows])
    taps = _silk_taps(den)
    h = torch.from_numpy(taps).to(cuda)
    x = torch.from_numpy((rng.standard_normal((rows, G + 95 + G % 3))
                          * 3000).astype(np.float32)).to(cuda)
    before = trs.UPSAMPLE_LAUNCHES
    got = trs.silk_upsample(x, taps, G)
    want = trs.silk_upsample_torch(x, h, G)
    assert trs.UPSAMPLE_LAUNCHES - before == 1
    assert got.shape == want.shape == (rows, G * den)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got, _fma_chain(x, h, G))
    assert float((got - want).abs().max()) / float(want.abs().max()) < 1e-6
    if rows >= 256 and G >= 63:
        assert torch.equal(got, want)


def test_silk_upsample_launch_alone_matches_wrapper(cuda):
    h = _silk_taps(3)
    x = torch.randn((64, 415), device=cuda) * 3000
    want = trs.silk_upsample(x, h, 320)
    out = torch.full_like(want, float("nan"))
    trs.silk_upsample_launch(x, h, 320, out)
    assert torch.equal(out, want)


def test_silk_upsample_kernel_rejects_bad_arguments(cuda):
    from audio_formats_torch.ops._kernels import KernelArgError

    h = _silk_taps(4)
    x = torch.zeros((4, 335), device=cuda)
    out = torch.zeros((4, 960), device=cuda)
    with pytest.raises(KernelArgError, match="W >= G"):
        trs.silk_upsample(x, h, 241)
    with pytest.raises(KernelArgError, match="96 taps"):
        trs.silk_upsample(x, np.ascontiguousarray(h[:, :95]), 240)
    with pytest.raises(KernelArgError, match="float32 host array"):
        trs.silk_upsample_launch(x, torch.from_numpy(h).to(cuda), 240, out)
    with pytest.raises(KernelArgError, match="den in"):
        trs.silk_upsample_launch(x, np.zeros((2, 96), np.float32), 480, out)
    with pytest.raises(KernelArgError, match="on cpu"):
        trs.silk_upsample_launch(x, h, 240, out.cpu())
    with pytest.raises(KernelArgError):
        trs.silk_upsample(x.double(), h, 240)
    with pytest.raises(KernelArgError, match="contiguous"):
        trs.silk_upsample(torch.zeros((4, 670), device=cuda)[:, ::2], h, 240)
    with pytest.raises(KernelArgError, match="want"):
        trs.silk_upsample_launch(x, h, 240, out[:, :959])


def test_silk_upsample_twin_refuses_tf32(cuda, monkeypatch):
    from audio_formats_torch.ops._kernels import KernelError

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(KernelError, match="SILK upsample twin"):
        trs.silk_upsample_torch(torch.zeros((2, 415), device=cuda),
                                torch.from_numpy(_silk_taps(3)).to(cuda),
                                320)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 100, 960, 1021, 2000, 5000])
@pytest.mark.parametrize("B", [1, 5, 512])
def test_deemph_kernel_matches_twin(cuda, B, n):
    """K12b (one launch) within 1e-6 of the peak of its twin, the
    sequential recurrence, for n not a multiple of 4 (1,021: a ragged
    chunk at the row's end), rows of several 1,024-sample tiles (2,000 and
    5,000) and a single row; three calls chained through m."""
    rng = np.random.default_rng([B, n])
    m = mt = torch.from_numpy(rng.uniform(-8000, 8000, B).astype(
        np.float32)).to(cuda)
    for _ in range(3):
        x = torch.from_numpy(rng.uniform(-8000, 8000, (B, n)).astype(
            np.float32)).to(cuda)
        before = tcelt.DEEMPH_LAUNCHES
        y, m = tcelt.deemphasis_scan(x, m)
        yt, mt = tcelt.deemphasis_scan_torch(x, mt)
        assert tcelt.DEEMPH_LAUNCHES - before == 1
        assert y.shape == (B, n) and m.shape == (B,)
        if n:
            assert float((y - yt).abs().max()) / float(yt.abs().max()) < 1e-6
        assert float((m - mt).abs().max()) / float(mt.abs().max()) < 1e-6


@pytest.mark.parametrize("width,start", [(1020, 0), (1021, 1)])
@pytest.mark.parametrize("B", [5, 512])
def test_deemph_kernel_takes_rows_by_stride(cuda, B, width, start):
    """K12b on x = the [:, start:start + 960] view of a [B, width] buffer:
    K12a's packed output (width 1,020, every row on a 16-byte boundary)
    and a view whose rows mostly start off one (width 1,021, start 1: the
    kernel's scalar path for those rows), into y the same view of another
    buffer and into a contiguous y, within 1e-6 of the peak of the twin on
    the same values made contiguous; the buffers' other columns are left
    as they were."""
    rng = np.random.default_rng([B, width])
    buf = torch.from_numpy(rng.uniform(-8000, 8000, (B, width)).astype(
        np.float32)).to(cuda)
    m0 = torch.from_numpy(rng.uniform(-8000, 8000, B).astype(
        np.float32)).to(cuda)
    x = buf[:, start:start + 960]
    assert x.stride() == (width, 1)
    yt, mt = tcelt.deemphasis_scan_torch(x.contiguous(), m0)
    ybuf = torch.full((B, width), 7.0, device=cuda)
    outs = [tcelt.deemphasis_scan(x, m0),
            (ybuf[:, start:start + 960], torch.empty_like(m0))]
    tcelt.deemphasis_launch(x, m0, outs[1])
    for y, m in outs:
        assert float((y - yt).abs().max()) / float(yt.abs().max()) < 1e-6
        assert float((m - mt).abs().max()) / float(mt.abs().max()) < 1e-6
    assert outs[0][0].is_contiguous()
    assert bool((ybuf[:, :start] == 7.0).all())
    assert bool((ybuf[:, start + 960:] == 7.0).all())


def test_deemph_kernel_rejects_bad_arguments(cuda):
    from audio_formats_torch.ops._kernels import KernelArgError

    x = torch.zeros((4, 960), device=cuda)
    m0 = torch.zeros(4, device=cuda)
    with pytest.raises(KernelArgError, match="want"):
        tcelt.deemphasis_scan(x, m0[:3])
    with pytest.raises(KernelArgError, match="want"):
        tcelt.deemphasis_scan(x, m0.cpu())
    with pytest.raises(KernelArgError):
        tcelt.deemphasis_scan(x.double(), m0)
    with pytest.raises(KernelArgError, match="contiguous"):
        tcelt.deemphasis_scan(torch.zeros((4, 1920), device=cuda)[:, ::2],
                              m0)
    with pytest.raises(KernelArgError, match=r"\[B, n\]"):
        tcelt.deemphasis_scan(x[0], m0)
    with pytest.raises(KernelArgError, match="overlap"):
        tcelt.deemphasis_launch(x, m0, (torch.zeros(
            (8, 960), device=cuda).as_strided((4, 960), (480, 1)), m0))


def _speech_streams():
    """Speech corpus lanes of the three groups: mono and stereo SILK, mono
    and stereo hybrid, and 16 mode tours (the mixed group's device
    path)."""
    from golden import opus_ref

    corpus = torch_opus_speech_cases.load()
    kinds = torch_opus_speech_cases.kinds()

    def lane(kind, k, n, ps):
        mi = [i for i, kd in enumerate(kinds) if kd == kind][k]
        return torch_opus_speech_cases.stream(opus_ref.build_ogg_opus,
                                              corpus[mi], n, preskip=ps)

    return ([lane("silk", k, 30 + 9 * k, (0, 312)[k % 2]) for k in range(5)]
            + [lane("hybrid", k, 25 + 7 * k, (312, 0)[k % 2])
               for k in range(5)]
            + [lane("tour", k % 2, 30 + 2 * k, (0, 130, 312)[k % 3])
               for k in range(16)])


def test_batch_decoder_opus_groups_cuda_equals_cpu(cuda):
    """The SILK, hybrid and mixed groups on the card (K13 once a SILK
    step, K12a once a CELT bucket) within 1e-5 of the peak of the CPU
    decode, every lane in its group, no demotion."""
    streams = _speech_streams()
    before = (tcelt.OLA_LAUNCHES + tcelt.IMDCT_OLA_LAUNCHES,
              trs.UPSAMPLE_LAUNCHES)
    dec = BatchDecoder(streams, device=cuda)
    got = dec.decode_all(output="device").sync().to_numpy()
    st = dec.stats
    wbf = st["windows_by_format"]
    assert (tcelt.OLA_LAUNCHES + tcelt.IMDCT_OLA_LAUNCHES - before[0]
            == wbf["opus"] > 0)
    assert trs.UPSAMPLE_LAUNCHES - before[1] == wbf["opus_silk"] > 0
    assert st["group_demotions"] == 0
    assert (st["opus_silk_lanes"], st["opus_hybrid_lanes"],
            st["opus_mixed_lanes"]) == (5, 5, 16)
    want = BatchDecoder(streams, device="cpu").decode_all()
    for a, b in zip(got, want, strict=True):
        _close(torch.from_numpy(a), torch.from_numpy(b), tol=1e-5)


# ------------------------------------------------------------ the facade
def _facade_pcm(fmt, device):
    from audio_formats_torch import AudioStream
    from test_torch_stream import read_all, stream

    s = AudioStream(device).open_from_memory(stream(fmt))
    assert not s.is_error(), s.error_message()
    return read_all(s)


FACADE_LAUNCHES = {"flac": lambda: tlpc.KERNEL_LAUNCHES,
                   "wav": lambda: tpcm.DECODE_LAUNCHES,
                   "qoa": lambda: tlms.DECODE_LAUNCHES}


@pytest.mark.parametrize("fmt", ["flac", "wav", "qoa", "mp3", "vorbis",
                                 "opus", "mod", "xm"])
def test_facade_cuda_equals_cpu(cuda, fmt):
    """AudioStream(device="cuda") read in 1,024-frame chunks equals the
    CPU facade: bit for bit, or within the transform codec's bound of
    the port's tests; FLAC, WAV and QOA launch their kernels (K1, K10,
    K2)."""
    from test_torch_stream import assert_close

    before = FACADE_LAUNCHES.get(fmt, lambda: 0)()
    got = _facade_pcm(fmt, cuda)
    if fmt in FACADE_LAUNCHES:
        assert FACADE_LAUNCHES[fmt]() > before
    assert_close(fmt, got, _facade_pcm(fmt, "cpu"))


@pytest.mark.parametrize("fmt,sample_format,dither", [
    ("wav", "s8", True), ("wav", "s16", True), ("wav", "s16", False),
    ("wav", "s24", True), ("wav", "s24", False), ("qoa", None, False)])
def test_facade_encode_cuda_equals_cpu(cuda, fmt, sample_format, dither):
    """WAV (K10) and QOA (K5) bytes through the card's facade, written in
    chunks, equal the CPU's; each chunk's quantize is one K10 launch."""
    from audio_formats_torch import (AudioSampleFormat, AudioStream,
                                     EncodingOptions)

    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((12000, 2))).astype(np.float32)
    opts = None if sample_format is None else EncodingOptions(
        sample_format=AudioSampleFormat[sample_format],
        enable_dither=dither)
    outs = []
    for device in (cuda, "cpu"):
        before = (tpcm.ENCODE_LAUNCHES, tlms.ENCODE_LAUNCHES)
        s = AudioStream(device).open_to_buffer(fmt, 44100, 2, opts)
        for k in range(0, len(x), 5000):
            s.write_samples_float(x[k: k + 5000])
        outs.append(s.finalize_and_get_encoded_result())
        if device == cuda:
            assert (tpcm.ENCODE_LAUNCHES - before[0],
                    tlms.ENCODE_LAUNCHES - before[1]) == \
                ((3, 0) if fmt == "wav" else (0, 3))
    assert outs[0] is not None and outs[0] == outs[1]


def _read_k1(s):
    from test_torch_stream import stream

    s.open_from_memory(stream("flac"))
    s.read_samples_float(1024)


def _read_k10(s):
    from test_torch_stream import stream

    s.open_from_memory(stream("wav"))
    s.read_samples_float(1024)


def _qoa_k5(s, finish):
    s.open_to_buffer("qoa", 44100, 1)
    s.write_samples_float(np.zeros((100, 1), np.float32))
    finish(s)


@pytest.mark.parametrize("kernel,call", [
    ("flac_lpc", _read_k1), ("pcm_decode", _read_k10),
    ("qoa_encode", lambda s: _qoa_k5(s, lambda s: s.finalize_encoding())),
    ("qoa_encode", lambda s: _qoa_k5(s, lambda s: s.close()))],
    ids=["K1-read", "K10-read", "K5-finalize", "K5-close"])
def test_facade_kernel_error_raises(cuda, kernel, call, monkeypatch):
    """A launch that fails inside K1's, K10's or K5's wrapper raises out
    of read_samples_float, finalize_encoding and close, and never becomes
    the stream's sticky error."""
    from audio_formats_torch import AudioStream
    from audio_formats_torch.ops import _kernels

    check = _kernels.check_launch

    def failing(fn, rc):
        if fn == kernel:
            raise _kernels.KernelError(f"{fn} kernel launch failed: CUDA "
                                       "error 700")
        check(fn, rc)

    monkeypatch.setattr(_kernels, "check_launch", failing)
    s = AudioStream(cuda)
    with pytest.raises(_kernels.KernelError, match="CUDA error 700"):
        call(s)
    assert s.error_message() in (None, "Stream not initialized")


# ------------------------------------------------------------------ mesh
def _mesh_flac_streams():
    from golden import flac_ref

    rng = np.random.default_rng(17)
    streams = []
    for i in range(9):
        n = 3000 + 900 * i
        t = np.arange(n)[:, None]
        pcm = np.clip(np.round(
            9000 * np.sin(2 * np.pi * (200 + 30 * i) * t * [1, 1.4] / 44100)
            + 300 * rng.standard_normal((n, 2))), -32768, 32767
        ).astype(np.int64)
        streams.append(flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                                           stereo_mode="mid_side",
                                           modes=["lpc8", "fixed3"]))
    return streams


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))


def test_mesh_cuda0_x4_matches_unsharded(cuda):
    """Over a mesh that names cuda:0 four times: FLAC packed lanes
    bit-equal to the unsharded run, MP3 lanes within 4e-6 of its peak, a
    K1 or K3 launch a shard window, every window on cuda:0."""
    from audio_formats_torch.ops import mp3_huff
    from audio_formats_torch.parallel import make_mesh

    mesh = make_mesh(4, data=4, devices=["cuda:0"] * 4)
    for streams, counter, exact in (
            (_mesh_flac_streams(), (tlpc, "KERNEL_LAUNCHES"), True),
            (_mp3_streams() * 2, (mp3_huff, "HUFF_LAUNCHES"), False)):
        want = BatchDecoder(streams, device=cuda).decode_all()
        before = getattr(*counter)
        dec = BatchDecoder(streams, mesh=mesh)
        res = dec.decode_all(output="device")
        for _, wins in res.windows():
            assert all(w.device == torch.device("cuda", 0) for w in wins)
        got = res.sync().to_numpy()
        assert dec.stats["group_demotions"] == 0
        assert getattr(*counter) - before == dec.stats["windows"] >= 4
        for a, b in zip(want, got, strict=True):
            assert a.shape == b.shape
            if exact:
                np.testing.assert_array_equal(b, a)
            else:
                assert _rel(a, b) < 4e-6


@pytest.fixture
def two_cuda():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return [torch.device("cuda", k) for k in range(2)]


def test_mesh_two_cards_lanes_on_their_shard(two_cuda):
    """A mesh of two cards: each group's lanes split in two, each half's
    PCM windows on its own card, and every lane equal to the one-card run
    (FLAC and WAV bit for bit, MP3 within 4e-6 of the peak).  Needs two
    cards: one card never runs it."""
    from golden import wav_ref

    from audio_formats_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    wav = [wav_ref.build_wav(
        wav_ref.pack_pcm(rng.integers(-32768, 32768, 2 * n)
                         .astype(np.int32), 16),
        fmt_tag=1, channels=2, sample_rate=44100, bits=16)
        for n in (3000, 5000, 7000, 9000)]
    flac = _mesh_flac_streams()[:6]
    mp3 = _mp3_streams()[1:]   # stereo: one group
    streams = flac + wav + mp3
    mesh = make_mesh(2)
    res = BatchDecoder(streams, mesh=mesh).decode_all(output="device")
    seen = set()
    spans = {"flac": (0, len(flac)), "wav": (len(flac), len(wav)),
             "mp3": (len(flac) + len(wav), len(mp3))}
    for chunk, group in res._finalizers:
        devs = {p[0].device for p in group.pending}
        assert len(devs) == 1
        # a group's first half rides cuda:0, its second half cuda:1
        base, n = spans[group.kind]
        first_half = np.array_split(np.arange(n), 2)[0] + base
        assert devs == {two_cuda[0 if chunk[0] in first_half else 1]}
        seen |= devs
    assert seen == set(two_cuda)
    got = res.sync().to_numpy()
    want = BatchDecoder(streams, device=two_cuda[0]).decode_all()
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        if i < len(flac) + len(wav):
            np.testing.assert_array_equal(b, a)
        else:
            assert _rel(a, b) < 4e-6
