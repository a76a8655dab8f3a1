"""The port's MP3 slice against the JAX package's, on the CPU.

The window DSP, the facade's frame DSP and the Layer I/II synthesis are
held to JAX's on the same inputs and carried state; then one batch of
golden streams — mono, LR, MS, per-frame MS switching, intensity with
mode_ext 1 and 3, intensity switched on mid-stream, MPEG-2 (mono and
intensity), Layer I, Layer II, a multi-window stream, free format, a Xing
tag with encoder delay and padding, a corrupt MP3 lane,
and FLAC and QOA lanes — goes through JAX's ``BatchDecoder`` and the
port's ``BatchDecoder(device="cpu")``.  Transform-codec PCM must agree
within 1e-4 max abs (the ROADMAP bound; the streams' PCM lies in [-1, 1];
the corrupt lane, which reads Huffman pairs past a granule's bits, against
JAX's AudioStream facade), errors, windows and decoded seconds must be
equal.  The ``Mp3Decoder``
facade and carried-state loading are held to JAX's too.  The Layer III
window's sizing rule is checked on its cases, and windows of other sizes,
forced on the CPU, give the 24-frame windows' PCM bit for bit.
"""

import numpy as np
import pytest
import torch

from audio_formats_tpu import AudioStream
from audio_formats_tpu.io.source import MemorySource as JMemorySource
from audio_formats_tpu.models.mp3 import Mp3Decoder as JMp3Decoder
from audio_formats_tpu.ops import mp3_dsp as jdsp
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder, trace
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models import mp3 as tmp3
from audio_formats_torch.ops import mp3_dsp, mp3_huff
from audio_formats_torch.parallel.groups import mp3 as mp3_groups

from golden import flac_ref, mp3_ref, qoa_ref
from test_torch_mp3_huff import mp3_stream, mp3_stream_mpeg2

#: max abs PCM difference allowed against the JAX package (transform codecs)
TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _dsp_inputs(rng, B, G, nch):
    """Sparse quantized spectra with small gains (PCM well inside [-1, 1]),
    any stereo mix, short-block permutations on some granules, any
    antialias counts and window types, carried state, prefix activity."""
    q = (rng.integers(-40, 41, (B, G, nch, 576))
         * (rng.random((B, G, nch, 576)) < 0.2)).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, (B, G, nch, 576)) * 2.0 ** -9)\
        .astype(np.float32)
    mix = rng.uniform(-1, 1, (B, G, 4, 576)).astype(np.float32)
    perm = np.tile(np.arange(576, dtype=np.int32), (B, G, nch, 1))
    shorts = rng.random((B, G, nch)) < 0.3
    perm[shorts] = mp3_huff.PERM[mp3_huff.SHORT_PATTERNS[3]]
    aa = rng.integers(-1, 32, (B, G, nch)).astype(np.int32)
    wt = rng.integers(0, 4, (B, G, nch, 32)).astype(np.int32)
    overlap = rng.uniform(-0.1, 0.1, (B, nch, 32, 18)).astype(np.float32)
    shist = rng.uniform(-0.1, 0.1, (B, nch, 16, 32)).astype(np.float32)
    return q, scale, mix, perm, aa, wt, overlap, shist


def test_window_dsp_matches_jax():
    """The batch path's window DSP takes the spectrum already requantized,
    mixed and reordered (JAX's flags dequant, use_mix, use_perm off)."""
    rng = np.random.default_rng(1)
    B, G, nch = 3, 8, 2
    q, scale, _mix, _perm, aa, wt, overlap, shist = _dsp_inputs(rng, B, G,
                                                                nch)
    xq = (np.sign(q) * np.abs(q) ** (4.0 / 3.0) * scale).astype(np.float32)
    args = (aa, wt, overlap, shist)
    n_act = np.array([8, 5, 0], np.int32)
    pcm, ov, sh = mp3_dsp.mp3_window_dsp(*_t(xq, *args, n_act), nch=nch,
                                         ngr=G)
    pj, ovj, shj = (np.asarray(x) for x in jdsp.mp3_window_dsp(
        xq, None, None, None, *args, n_act, nch=nch, ngr=G, use_perm=False,
        dequant=False, use_mix=False))
    for b in range(B):
        np.testing.assert_allclose(pcm[b, : n_act[b]].numpy(),
                                   pj[b, : n_act[b]], rtol=0, atol=TOL / 10)
    np.testing.assert_allclose(ov.numpy(), ovj, rtol=0, atol=TOL / 10)
    np.testing.assert_allclose(sh.numpy(), shj, rtol=0, atol=TOL / 10)
    assert np.abs(pj).max() > 0.05


def test_frame_dsp_matches_jax():
    rng = np.random.default_rng(2)
    B, G, nch = 2, 4, 2
    args = _dsp_inputs(rng, B, G, nch)
    pcm, ov, sh = mp3_dsp.mp3_frame_dsp(*_t(*args), nch=nch, ngr=G)
    pj, ovj, shj = (np.asarray(x) for x in jdsp.mp3_frame_dsp(
        *args, nch=nch, ngr=G))
    for got, want in ((pcm, pj), (ov, ovj), (sh, shj)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL / 10)
    assert np.abs(pj).max() > 0.05


def test_synth_slots_matches_jax():
    rng = np.random.default_rng(3)
    S = rng.uniform(-0.2, 0.2, (2, 2, 36, 32)).astype(np.float32)
    shist = rng.uniform(-0.2, 0.2, (2, 2, 16, 32)).astype(np.float32)
    pcm, sh = mp3_dsp.mp3_synth_slots(*_t(S, shist), nch=2)
    pj, shj = jdsp.mp3_synth_slots(S, shist, nch=2)
    np.testing.assert_allclose(pcm.numpy(), np.asarray(pj), rtol=0,
                               atol=TOL / 10)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(shj))


# ---------------------------------------------------------------- the batch
def _layer1(seed):
    rng = np.random.default_rng(seed)
    gq = rng.integers(0, 64, size=(5, 32, 12)).tolist()
    scfs = rng.integers(10, 60, size=(5, 32)).tolist()
    return mp3_ref.build_mp3_l1(gq, scfs, ba=6)[0]


def _layer2(seed):
    rng = np.random.default_rng(seed)
    gq = rng.integers(0, 16, size=(4, 3, 30, 12)).tolist()
    scfs = rng.integers(10, 60, size=(4, 30)).tolist()
    return mp3_ref.build_mp3_l2(gq, scfs, ba=4)[0]


def _corrupt(data, seed):
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    for pos in rng.integers(len(b) // 4, len(b), 32):
        b[pos] ^= 0xFF
    return bytes(b)


def _flac(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(3000)[:, None]
    pcm = np.clip(np.round(9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4]
                                         / 44100)
                           + 300 * rng.standard_normal((3000, 2))),
                  -32768, 32767).astype(np.int64)
    return flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                               stereo_mode="mid_side", modes=["lpc8", "lpc8"])


def _qoa(seed):
    rng = np.random.default_rng(seed)
    return qoa_ref.encode(rng.integers(-9000, 9000, (6000, 2))
                          .astype(np.int16), 44100)


CASES = {
    "mono": lambda: mp3_stream(11, channels=1, big=False),
    "lr": lambda: mp3_stream(12),
    "ms": lambda: mp3_stream(13, mode_ext=2),
    "ms_switching": lambda: mp3_stream(
        14, mode_ext=[2, 0, 2, 2, 0, 0, 2, 0, 2, 2]),
    "intensity_1": lambda: mp3_stream(15, mode_ext=1, right_cut=150),
    "intensity_3": lambda: mp3_stream(16, mode_ext=3, right_cut=150),
    "intensity_mid_stream": lambda: mp3_stream(
        17, mode_ext=[0, 0, 0, 1, 0, 0, 1, 1, 0, 0], right_cut=150),
    "multi_window": lambda: mp3_stream(18, n_frames=53, mode_ext=2),
    "free_format": lambda: mp3_stream(26, bitrate_idx=0,
                                      free_format_bytes=1152 * 256 * 125
                                      // 44100),
    "xing_delay_padding": lambda: mp3_stream(27, xing=True,
                                             xing_delay=576 + 100,
                                             xing_padding=576 - 100),
    "mpeg2": lambda: mp3_stream_mpeg2(19),
    "mpeg2_intensity": lambda: mp3_stream_mpeg2(20, channels=2, mode_ext=1),
    "layer1": lambda: _layer1(21),
    "layer2": lambda: _layer2(22),
    "corrupt_mp3": lambda: _corrupt(mp3_stream(23, mode_ext=2), 23),
    "flac": lambda: _flac(24),
    "qoa": lambda: _qoa(25),
}


def _facade(data):
    """JAX's AudioStream decode of `data`."""
    s = AudioStream()
    s.open_from_memory(data)
    assert not s.is_error()
    return s.read_samples_float(10 ** 7)


@pytest.fixture(scope="module")
def batch():
    """One mixed batch through both packages (the port in both output
    modes, which must agree exactly)."""
    names = list(CASES)
    streams = [CASES[n]() for n in names]
    jdec = JaxBatchDecoder(streams)
    ref = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all()
    res = BatchDecoder(streams, device="cpu").decode_all(output="device")
    for _, wins in res.windows():
        assert all(isinstance(w, torch.Tensor) for w in wins)
    for a, b in zip(got, res.sync().to_numpy()):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    return dict(zip(names, zip(got, ref, tdec.errors, jdec.errors))), \
        tdec, jdec


@pytest.mark.parametrize("name", list(CASES))
def test_batch_lane_matches_jax(batch, name):
    lanes, _, _ = batch
    got, ref, err, jerr = lanes[name]
    assert err == jerr
    if ref is None:
        assert got is None
        return
    assert got is not None and got.dtype == np.float32
    assert got.shape == ref.shape
    if name == "flac" or name == "qoa":
        np.testing.assert_array_equal(got, ref)
        return
    assert np.isfinite(got).all()
    if name == "corrupt_mp3":
        # a granule of it reads Huffman pairs past its own bits: the port
        # reads on into its frame's next bits as the reference's facade
        # does, JAX's batch the leftover memory of its np.empty rows
        ref = _facade(CASES[name]())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    if name != "corrupt_mp3":
        assert np.abs(ref).max() <= 1.0 and np.abs(ref).max() > 0.05


def test_batch_stats_match_jax(batch):
    _, tdec, jdec = batch
    assert tdec.stats["group_demotions"] == 0
    assert tdec.stats["windows"] == jdec.stats["windows"]
    assert tdec.stats["decoded_seconds"] == pytest.approx(
        jdec.stats["decoded_seconds"], rel=1e-12)
    for fmt, secs in jdec.stats["decoded_seconds_by_format"].items():
        assert tdec.stats["decoded_seconds_by_format"][fmt] == \
            pytest.approx(secs, rel=1e-12)


# --------------------------------------------------------------- the facade
@pytest.mark.parametrize("name", ["ms", "mpeg2_intensity", "layer2"])
def test_facade_read_seek_tell_matches_jax(name):
    data = CASES[name]()
    a = tmp3.Mp3Decoder(MemorySource(data), device="cpu")
    b = JMp3Decoder(JMemorySource(data))
    assert (a.channels, a.sample_rate, a.length_frames) == \
        (b.channels, b.sample_rate, b.length_frames)
    for n in (1000, 3000):
        x, y = a.read(n), b.read(n)
        assert x.shape == y.shape and x.dtype == np.float32
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)
        assert a.tell() == b.tell()
    target = a.length_frames // 3
    assert a.seek(target) and b.seek(target)
    assert a.tell() == b.tell() == target
    x, y = a.read(10 ** 6), b.read(10 ** 6)
    assert x.shape == y.shape and x.shape[0] > 0
    np.testing.assert_allclose(x, y, rtol=0, atol=TOL)
    assert a.tell() == b.tell() == a.length_frames
    assert not a.seek(a.length_frames + 1)


def test_load_state_continues_a_jax_decode():
    """JAX decodes the first part of a stream (across a facade window and
    into the next); its carried state loads into the port's decoder, which
    decodes the rest: together equal to one whole JAX decode."""
    data = mp3_stream(30, n_frames=80, mode_ext=[2, 0, 2, 1] * 20,
                      right_cut=300)
    whole = JMp3Decoder(JMemorySource(data)).read(10 ** 6)
    jdec = JMp3Decoder(JMemorySource(data))
    first = jdec.read(64 * 1152 + 777)
    dec = tmp3.Mp3Decoder(MemorySource(data), device="cpu")
    tmp3.load_state(dec, tmp3.save_state(jdec))
    assert dec.tell() == jdec.tell()
    rest = dec.read(10 ** 6)
    got = np.concatenate([first, rest])
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)
    assert np.abs(whole).max() > 0.05


def test_mp3_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        BatchDecoder([CASES["ms"]()])


@pytest.mark.parametrize("name,module,fn", [
    ("lr", "mp3_huff", "huff_decode"), ("layer2", "mp3_dsp", "full_fp32"),
    ("flac", "lpc", "flac_lpc"), ("qoa", "lms", "decode_slices")])
def test_kernel_error_is_not_demoted(monkeypatch, name, module, fn):
    """A kernel that does not build, load or launch is no lane's fault:
    decode_all raises it, and no lane is demoted to another path."""
    import importlib

    from audio_formats_torch.ops._kernels import KernelError

    def fail(*args, **kwargs):
        raise KernelError(f"{fn} kernel launch failed: CUDA error 700")

    monkeypatch.setattr(importlib.import_module(
        f"audio_formats_torch.ops.{module}"), fn, fail)
    dec = BatchDecoder([CASES[name](), CASES[name]()], device="cpu")
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0


# ------------------------------------------------ Layer III window sizing
#: K3's lanes in one wave of an H100 SXM (132 SMs)
WAVE_132 = 132 * mp3_huff.HUFF_BLOCKS_PER_SM * mp3_huff.HUFF_THREADS


@pytest.mark.parametrize("lanes_per_frame,frames_left,wave,want", [
    # 32 stereo MPEG-1 lanes of 30 s clips (1,148 frames): two windows of
    # 576 frames, not 792 + 356
    (32 * 4, 1148, WAVE_132, 576),
    # 1,024 stereo MPEG-1 lanes, the default device group: a window of 24
    # frames already holds 98,304 lanes
    (1024 * 4, 1148, WAVE_132, 24),
    # one short stereo stream: its 30 frames rounded up to 24, one window
    (4, 30, WAVE_132, 48),
    # mono MPEG-2 lanes (one granule a frame): 1,024 of them, and 32
    (1024, 1148, WAVE_132, 96),
    (32, 1148, WAVE_132, 1152),
    # never below 24: a frame left, none, a frame wider than a wave
    (128, 1, WAVE_132, 24),
    (128, 0, WAVE_132, 24),
    (8192 * 4, 1148, WAVE_132, 24),
    # the CPU
    (32 * 4, 1148, "cpu", 24),
])
def test_mp3_window_frames(lanes_per_frame, frames_left, wave, want):
    if wave == "cpu":
        wave = mp3_groups.mp3_wave_lanes(torch.device("cpu"))
        assert wave == 0
    W = mp3_groups.mp3_window_frames(lanes_per_frame, frames_left, wave)
    assert W == want
    step = mp3_groups.MP3_WINDOW_FRAMES
    assert W % step == 0 and W >= step
    # a sized window holds no more lanes than a wave, and the windows that
    # take the longest lane are as few as at the wave's own size
    if W > step:
        assert W * lanes_per_frame <= wave
        wave_w = step * (wave // (step * lanes_per_frame))
        assert -(-frames_left // W) == -(-frames_left // wave_w)


def test_huff_wave_constants_match_the_kernel_source():
    """The threads a block and resident blocks an SM that size a window
    are the kernel's own."""
    import os

    src = open(os.path.join(os.path.dirname(mp3_huff.__file__), "..",
                            "csrc", "mp3_huff.cu")).read()
    assert f"constexpr int kThreads = {mp3_huff.HUFF_THREADS};" in src
    assert (f"__launch_bounds__(kThreads, {mp3_huff.HUFF_BLOCKS_PER_SM})"
            in src)


#: Layer III lanes of unequal length (8 to 53 frames), mono and stereo,
#: MPEG-1 and MPEG-2, MS, intensity (on from the start and switched on
#: mid-stream), a Xing tag, free format and a corrupt lane
LAYER3 = ("mono", "lr", "ms", "ms_switching", "intensity_1", "intensity_3",
          "intensity_mid_stream", "multi_window", "free_format",
          "xing_delay_padding", "mpeg2", "mpeg2_intensity", "corrupt_mp3")
#: window sizes the card's rule could give, forced on the CPU: each
#: group's longest stream in one window, and ragged sizes (not multiples
#: of 24) at which lanes end mid-window at other frames
WINDOW_RULES = {
    "whole_stream": lambda lpf, frames_left, wave: max(frames_left, 1),
    "ragged_7": lambda lpf, frames_left, wave: 7,
    "ragged_37": lambda lpf, frames_left, wave: 37,
}


@pytest.fixture(scope="module")
def layer3_24():
    """The Layer III lanes decoded at the CPU's 24-frame windows."""
    streams = [CASES[n]() for n in LAYER3]
    dec = BatchDecoder(streams, device="cpu")
    pcm = dec.decode_all()
    assert dec.stats["mp3_window_frames"] == mp3_groups.MP3_WINDOW_FRAMES
    return streams, pcm


@pytest.mark.parametrize("rule", list(WINDOW_RULES))
def test_window_size_keeps_the_pcm(monkeypatch, layer3_24, rule):
    """A Layer III window of any size gives the PCM of 24-frame windows,
    bit for bit: the overlap and the slot history cross each window edge
    on the device, the reservoir and intensity positions on the host, and
    every op of the plain chain acts on a lane's rows alone, none summing
    across granules or lanes, so no row's sums change order.  The spans
    carry the size: `frames` on each window, K3's lanes on each launch."""
    streams, want = layer3_24
    monkeypatch.setattr(mp3_groups, "mp3_window_frames", WINDOW_RULES[rule])
    dec = BatchDecoder(streams, device="cpu")
    trace.drain()
    trace.enable()
    try:
        got = dec.decode_all()
    finally:
        trace.disable()
        spans = trace.drain()["spans"]
    assert dec.errors == [None] * len(streams)
    for name, a, b in zip(LAYER3, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # four groups, (mono, stereo) x (MPEG-1, MPEG-2): K3's lanes a frame
    decs = [tmp3.Mp3Decoder(MemorySource(s), device="cpu") for s in streams]
    per_frame = {}
    for d in decs:
        key = (d.channels, d._mpeg1)
        per_frame[key] = per_frame.get(key, 0) + d.channels * (
            2 if d._mpeg1 else 1)
    W = WINDOW_RULES[rule](0, max(len(d._index_offsets) for d in decs), 0)
    assert dec.stats["mp3_window_frames"] == W
    if rule == "whole_stream":
        assert dec.stats["windows"] == len(per_frame)
    # a window span each parse (the last finds a group's lanes ended where
    # they filled their last window), a launch span each device window
    by_id = {s["id"]: s for s in spans}
    launches = [s for s in spans if s["name"] == "launch"]
    assert len(launches) == dec.stats["windows"]
    for s in launches:
        w = by_id[s["parent"]]
        assert w["name"] == "window" and 1 <= w["attrs"]["frames"] <= W
        assert s["attrs"]["lanes"] in {w["attrs"]["frames"] * n
                                       for n in per_frame.values()}


def test_layer12_windows_stay_24(monkeypatch):
    """Layers I/II run no Huffman kernel and no product: their windows
    keep 24 frames whatever the Layer III rule gives."""
    rng = np.random.default_rng(31)
    gq = rng.integers(0, 16, size=(30, 3, 30, 12)).tolist()
    scfs = rng.integers(10, 60, size=(30, 30)).tolist()
    streams = [mp3_ref.build_mp3_l2(gq, scfs, ba=4)[0], _layer1(21)]
    want = BatchDecoder(streams, device="cpu")
    want_pcm = want.decode_all()
    monkeypatch.setattr(mp3_groups, "mp3_window_frames",
                        WINDOW_RULES["whole_stream"])
    dec = BatchDecoder(streams, device="cpu")
    for a, b in zip(dec.decode_all(), want_pcm):
        np.testing.assert_array_equal(a, b)
    # 30 Layer II frames: two windows of 24, and the Layer I lane's one
    assert dec.stats["windows_by_format"]["mp3_l12"] == \
        want.stats["windows_by_format"]["mp3_l12"] == 3
    assert dec.stats["mp3_window_frames"] == 0
