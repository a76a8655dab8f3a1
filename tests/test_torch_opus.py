"""The port's Ogg Opus decode against the JAX package's, on the CPU.

The per-stream read (the models copied from the JAX package, their host
stage in the C library) equals JAX's per-stream read bit for bit, on every
mode: the four real CELT packets of tests/test_opus_celt.py, the SILK
packets of tests/test_opus_silk.py, the committed stereo corpus
(tests/torch_opus_cases.py), DTX and silence lanes.  The batch decoder
sends CELT-only mapping-0 lanes through its lockstep group (the IMDCT and
K12a's twin a (blocks, blocksize) bucket a step) and SILK-only lanes
through theirs (K13's twin a packet step; the SILK, hybrid and mixed
groups are held in tests/test_torch_opus_groups.py); its output is held
within TOL of the peak of JAX's facade and of JAX's batch (the bound
tests/test_batch.py:489-490 holds between JAX's batch and its facade).
"""

import collections
import functools

import numpy as np
import pytest

from audio_formats_tpu import AudioStream
from audio_formats_tpu import models as jmodels
from audio_formats_tpu.io.source import MemorySource as JaxMemorySource
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder, models
from audio_formats_torch.errors import AudioFormatError
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models import celt as tcelt
from audio_formats_torch.models import opus as topus
from audio_formats_torch.ops import celt_dsp
from audio_formats_torch.ops._kernels import KernelError
from audio_formats_torch.parallel.groups import opus as opus_groups

from golden import opus_ref
from test_opus_celt import FINAL_RANGES, PACKETS, RMS, SAMPLE_IDX, SAMPLES
from test_opus_silk import SILK_PACKETS

import torch_opus_cases

TOL = 1e-5   # max abs error over the peak: batch against facade


def _close(got, want, tol=TOL):
    assert got is not None and got.shape == want.shape
    assert got.dtype == np.float32
    if want.size:
        peak = np.abs(want).max() + 1e-9
        assert np.abs(got - want).max() / peak < tol


def _facade(data):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    return s.read_samples_float(10 ** 7)


def _read(dec):
    chunks = []
    while True:
        c = dec.read(1 << 16)
        if c.shape[0] == 0:
            break
        chunks.append(c)
    return np.concatenate(chunks) if chunks else \
        np.zeros((0, dec.channels), np.float32)


def _port_read(data, **kw):
    dec = models.probe_all(MemorySource(data), "cpu")
    assert isinstance(dec, topus.OpusDecoder)
    if kw:
        dec = topus.OpusDecoder(MemorySource(data), **kw)
    return _read(dec)


def _jax_read(data):
    return _read(jmodels.probe_all(JaxMemorySource(data)))


@functools.lru_cache(maxsize=None)
def _corpus():
    return torch_opus_cases.load()


def _celt(n=4, preskip=130, channels=1):
    return opus_ref.build_ogg_opus(
        [(bytes.fromhex(h), 480) for h in PACKETS[:n]], channels=channels,
        preskip=preskip)


def _silk(n=4, preskip=0):
    return opus_ref.build_ogg_opus(
        [(bytes.fromhex(h), 960) for h in SILK_PACKETS[:n]], channels=1,
        preskip=preskip)


def _master(mi, n=None, preskip=312, channels=None):
    return torch_opus_cases.stream(opus_ref.build_ogg_opus, _corpus()[mi],
                                   n, channels=channels, preskip=preskip)


def _dtx():
    return opus_ref.build_ogg_opus(
        [opus_ref.dtx_packet()] * 3 + [opus_ref.silence_packet()] * 2,
        channels=1, preskip=0)


def _silence():
    return opus_ref.build_ogg_opus([opus_ref.silence_packet()] * 4,
                                   channels=2, preskip=0)


READ_CASES = {
    "celt_packets": lambda: _celt(),
    "celt_stereo_header": lambda: _celt(3, 312, channels=2),
    "silk_packets": lambda: _silk(),
    "corpus_0": lambda: _master(0),
    "corpus_1_mono_header": lambda: _master(1, 60, channels=1),
    "corpus_2": lambda: _master(2, 80, preskip=0),
    "corpus_3": lambda: _master(3, 120, preskip=130),
    "corpus_mono": lambda: _master(4),
    "dtx": _dtx,
    "silence": _silence,
}


@pytest.mark.parametrize("name", list(READ_CASES))
def test_per_stream_read_equals_jax(name):
    data = READ_CASES[name]()
    got = _port_read(data)
    want = _jax_read(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 0


def test_celt_packets_entropy_and_pcm():
    """The port's CeltDecoder on the four libopus packets: the range
    coder's final state after each (libopus's, tests/test_opus_celt.py)
    and the PCM spot values and RMS checked there against libopus."""
    dec = tcelt.CeltDecoder(output_channels=1)
    outs = []
    for hexpkt, expect in zip(PACKETS, FINAL_RANGES):
        info = topus.parse_packet(bytes.fromhex(hexpkt))
        rd = topus.RangeDecoder(info["frames"][0])
        outs.append(dec.decode_frame(rd, 2 if info["stereo"] else 1,
                                     info["frame_size"], 0, 21))
        assert rd.tell() == len(info["frames"][0]) * 8
        assert (rd.rng & 0xFFFFFFFF) == expect
    out = np.concatenate(outs)
    assert abs(float(np.sqrt((out ** 2).mean())) - RMS) < 1e-6
    for i, v in zip(SAMPLE_IDX, SAMPLES):
        assert abs(float(out[i, 0]) - v) < 1e-6


@pytest.mark.parametrize("reference", [False, True])
def test_resampler_argument_equals_jax_switch(reference, monkeypatch):
    """``OpusDecoder(..., reference_resampler=True)`` is the port's form of
    JAX's AF_TPU_REFERENCE_RESAMPLER switch; both resamplers equal JAX's."""
    data = _silk(preskip=0)
    if reference:
        monkeypatch.setenv("AF_TPU_REFERENCE_RESAMPLER", "1")
    want = _jax_read(data)
    got = _port_read(data, reference_resampler=reference)
    np.testing.assert_array_equal(got, want)


def test_corpus_is_celt_only_and_grouped_by_jax():
    """Every committed packet is CELT-only with one frame size, and JAX's
    BatchDecoder puts every corpus lane in its CELT lockstep group."""
    shapes = collections.Counter()
    for ch, fs, pkts in _corpus():
        sizes = set()
        for p in pkts:
            pk = topus.parse_packet(p)
            assert pk["mode"] == "celt"
            assert pk["stereo"] == (ch == 2)
            sizes.add(pk["frame_size"])
        assert sizes == {fs}
        shapes[ch] += 1
    assert shapes == {2: 4, 1: 1}
    streams = [_master(mi) for mi in range(len(_corpus()))]
    jdec = JaxBatchDecoder(streams)
    assert all(JaxBatchDecoder._opus_eligible(d) for d in jdec.decoders)
    tdec = BatchDecoder(streams, device="cpu")
    assert all(opus_groups.classify(d)[0] == "celt"
               for d in tdec.decoders)


def _batch_lanes():
    """Ragged CELT lanes: JAX's test_batch.py:476-490 pair, corpus
    prefixes of several lengths and preskips, a stereo-coded stream with a
    mono header (scale 0.5 beside the mono master's 1.0 in one bucket),
    DTX and silence lanes, and a SILK lane that rides the SILK group."""
    return [
        _celt(4, 130), _celt(2, 0),
        _master(0, 40, 312), _master(1, 23, 0), _master(2, 57, 130),
        _master(3, 31, 312), _master(0, 11, 130), _master(2, 45, 0),
        _master(4, 30, 312), _master(1, 37, 130, channels=1),
        _master(3, 26, 0, channels=1),
        _dtx(), _silence(), _silk(),
    ]


@pytest.mark.parametrize("output", ["numpy", "device"])
def test_batch_matches_jax(output, monkeypatch):
    streams = _batch_lanes()
    calls, scales = [], []
    imdct_ola = celt_dsp.celt_imdct_ola_packed
    bucket = opus_groups._celt_imdct_bucket

    def counted(*a, **kw):
        calls.append(a[2:4])
        return imdct_ola(*a, **kw)

    def watched(stats, items, blocks, bs, device):
        scales.append({float(p["imdct_scale"]) for _, p in items})
        return bucket(stats, items, blocks, bs, device)

    monkeypatch.setattr(celt_dsp, "celt_imdct_ola_packed", counted)
    monkeypatch.setattr(opus_groups, "_celt_imdct_bucket", watched)
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all(output=output)
    if output == "device":
        got = got.sync().to_numpy()
    jdec = JaxBatchDecoder(streams)
    jgot = jdec.decode_all()
    st = tdec.stats
    assert tdec.errors == jdec.errors == [None] * len(streams)
    assert st["group_demotions"] == 0 and not st.get("lanes_demoted")
    silk = len(streams) - 1
    assert opus_groups.classify(tdec.decoders[silk])[0] != "celt"
    assert st["opus_silk_lanes"] == 1
    for i, data in enumerate(streams):
        want = _facade(data)
        _close(got[i], want)
        _close(got[i], jgot[i])
    # one IMDCT and overlap-add a bucket a step; some steps hold two
    # buckets (short and long blocks), and some bucket mixes scales; the
    # SILK lane's steps are K13's
    n_frames = [sum(len(pk["frames"]) for pk in d._opus_packets)
                for d in tdec.decoders[:silk]]
    wbf = st["windows_by_format"]
    assert len(calls) == wbf["opus"] == st["windows"] - wbf["opus_silk"]
    assert wbf["opus_silk"] == 4
    assert len(calls) > max(n_frames)
    assert {(1, 960), (8, 120), (1, 480)} <= set(calls)
    assert {0.5, 1.0} in scales
    assert st["h2d_bytes_by_format"]["opus"] == st["h2d_bytes"] > 0
    assert st["decoded_seconds_by_format"]["opus"] > 0


def test_probe_puts_opus_first():
    """Opus leads the cascade (stream.d:1586-1838): an Ogg Opus stream of
    any mode gets an OpusDecoder."""
    for data in (_celt(), _silk(), _dtx()):
        assert isinstance(models.probe_all(MemorySource(data), "cpu"),
                          topus.OpusDecoder)


def _lattice_streams():
    """64 stereo CELT lanes of distinct lengths from masters 0-2, and at
    index 13 a lane of master 3, whose frames no other lane holds."""
    streams = [_master(k % 3, 6 + k % 9 + k // 9, 312) for k in range(64)]
    streams[13] = _master(3, 9, 312)
    return streams


def test_per_lane_demotion_keeps_group(monkeypatch):
    """One lane of a 64-lane CELT group faults in its frames' range decode
    (in the group and in the per-stream read): the group bisects, that lane
    alone is demoted and fails, and the 63 others equal a clean batch
    within TOL (not bit for bit: torch's CPU matmul sums a row's products
    in an order that depends on how many rows the bucket has, so a row's
    bits depend on its bucket-mates)."""
    streams = _lattice_streams()
    bad = {bytes(fr) for p in _corpus()[3][2][:9]
           for fr in topus.parse_packet(p)["frames"]}
    clean = [s for i, s in enumerate(streams) if i != 13]
    solo = BatchDecoder(clean, device="cpu").decode_all()

    class Faulty(topus.RangeDecoder):
        def __init__(self, data):
            if bytes(data) in bad:
                raise AudioFormatError("injected lane fault")
            super().__init__(data)

    monkeypatch.setattr(opus_groups, "RangeDecoder", Faulty)
    monkeypatch.setattr(topus, "RangeDecoder", Faulty)
    for output in ("numpy", "device"):
        dec = BatchDecoder(streams, device="cpu")
        out = dec.decode_all(output=output)
        if output == "device":
            out = out.sync().to_numpy()
        assert dec.stats["lanes_demoted"] == 1
        assert any("injected lane fault" in e
                   for e in dec.stats["group_exceptions"])
        assert out[13] is None and dec.errors[13] is not None
        for got, want in zip(out[:13] + out[14:], solo, strict=True):
            _close(got, want)


def test_kernel_error_is_not_demoted(monkeypatch):
    """A K12a that does not build, load or launch is no lane's fault:
    decode_all raises it, and no lane is demoted."""
    def fail(*args, **kwargs):
        raise KernelError("celt_ola kernel launch failed: CUDA error 700")

    monkeypatch.setattr(celt_dsp, "celt_ola", fail)   # K12a, long blocks
    monkeypatch.setattr(celt_dsp, "imdct_ola_short", fail)   # short blocks
    dec = BatchDecoder([_celt(), _master(0, 5)], device="cpu")
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0
