"""The reference's corruption sweep and demotion lattice through the port's
batch decoder.

Each of tests/test_robustness.py's mutations of its QOA, FLAC, WAV and
Vorbis fixtures (truncations, byte flips, a zeroed run, splices, a garbage
prefix) goes, one stream a batch, through ``audio_formats_tpu``'s
BatchDecoder and through ``audio_formats_torch``'s ``BatchDecoder(...,
device="cpu")``, FLAC on both wires (JAX's device-Rice wire under
``AF_TPU_FLAC_DEVICE_RICE=1``): the lane errors must be the same, no group
demoted, and the PCM bit-equal (QOA, FLAC, WAV) or within 4e-6 of the peak
(Vorbis, a transform codec).  Each mutation of its MP3 fixture goes through
the port's batch decoder and two witnesses.  Against JAX's AudioStream
facade: within 4e-6 of the peak over the whole stream, those mutations
included where the reference reads a granule's Huffman pairs past its own
bits (the port's wire ships each frame's main data whole).  Against JAX's
BatchDecoder, its uninitialised host buffers zeroed: the same lane errors,
and within 4e-6 of the peak where JAX's batch keeps to the facade; on the
three mutations where it reads its zeroed rows instead, the port keeps to
the facade and JAX's batch does not.  Each mutation of its Opus fixture
(SILK packets, which unharmed ride the SILK group), of a CELT fixture (25
stereo packets of the committed corpus, tests/torch_opus_cases.py) and of
a hybrid fixture (25 packets of the speech corpus's first hybrid master,
tests/torch_opus_speech_cases.py) goes through the port's batch decoder,
into the Opus group JAX's eligibility tests choose, and is held to JAX's
facade: a lane error where the facade errs at open, else within 1e-5 of
the peak (JAX's own bound between its batch and its facade,
tests/test_batch.py:489-490).  On the hybrid fixture's three splices,
whose granule field runs past their packets, JAX's hybrid group drains
its resampler rows past what the lane owes (486 samples more than its
facade); the port's group drains what the per-stream read drains.

Each mutation of its MOD and XM fixtures takes the per-stream read in
both batch decoders, held bit-equal with the same lane errors.  The
reference's facade sweep runs on the port's ``AudioStream(device="cpu")``
for all eight formats: nothing raises, and the errors and PCM are JAX's
facade's (the transform codecs within their bounds of the peak).

The reference's per-lane demotion test runs on the port, on both FLAC wires:
a fault injected at the wire's host seam for one lane of a 64-lane group
demotes that lane alone, the others stay grouped and bit-exact, and a
KernelError is raised, never demoted around.
"""

import functools

import numpy as np
import pytest

from audio_formats_tpu import AudioStream
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import AudioStream as TorchStream
from audio_formats_torch import BatchDecoder
from audio_formats_torch.errors import AudioFormatError
from audio_formats_torch.host import native as tnative
from audio_formats_torch.models.flac import FlacDecoder
from audio_formats_torch.ops import flac_rice, lpc
from audio_formats_torch.ops._kernels import KernelError
from audio_formats_torch.parallel.groups import opus as opus_groups

from golden import flac_ref, opus_ref

import test_robustness
import torch_opus_cases
import torch_opus_speech_cases

N_MUTATIONS = 14   # 3 truncations, 6 flips, a zeroed run, 3 splices, a prefix


@functools.lru_cache(maxsize=None)
def _mutations(fmt):
    """The reference test's fixture of format `fmt` and its mutations,
    drawn from the reference test's seed in the reference test's order."""
    rng = np.random.default_rng(0xC0FFEE)
    data = test_robustness._fixtures(rng)[fmt]
    return tuple(test_robustness._mutations(data, rng))


def _qoa_mutations():
    return _mutations("qoa")


def _flac_mutations():
    return _mutations("flac")


@functools.lru_cache(maxsize=None)
def _celt_mutations():
    """Mutations of a CELT fixture (the first 25 packets of the corpus's
    first stereo master), drawn as the reference test draws them."""
    data = torch_opus_cases.stream(opus_ref.build_ogg_opus,
                                   torch_opus_cases.load()[0], 25)
    return tuple(test_robustness._mutations(data,
                                            np.random.default_rng(0xCE17)))


@functools.lru_cache(maxsize=None)
def _hybrid_mutations():
    """Mutations of a hybrid fixture (the first 25 packets of the speech
    corpus's first hybrid master), drawn as the reference test draws
    them."""
    master = torch_opus_speech_cases.load()[
        torch_opus_speech_cases.kinds().index("hybrid")]
    data = torch_opus_speech_cases.stream(opus_ref.build_ogg_opus, master,
                                          25)
    return (data,) + tuple(test_robustness._mutations(
        data, np.random.default_rng(0x4B1D)))


def _opus_fixture(fixture):
    """The unharmed Opus fixture and its mutations."""
    if fixture == "silk":
        return (test_robustness._opus_fixture(),) + _mutations("opus")
    if fixture == "celt":
        return (torch_opus_cases.stream(opus_ref.build_ogg_opus,
                                        torch_opus_cases.load()[0], 25),) \
            + _celt_mutations()
    return _hybrid_mutations()


def test_sweep_has_every_mutation():
    for fmt in ("qoa", "flac", "wav", "vorbis", "mp3", "opus", "mod", "xm"):
        assert len(_mutations(fmt)) == N_MUTATIONS
    assert len(_celt_mutations()) == N_MUTATIONS
    assert len(_hybrid_mutations()) == N_MUTATIONS + 1


def _matches_jax(streams, tol=None, **kw):
    """The port's CPU batch decode of `streams` against JAX's: the same
    lane errors, no demotion, and PCM bit-equal (or within `tol` of the
    peak)."""
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu", **kw)
    got = tdec.decode_all()
    assert tdec.errors == jdec.errors
    assert tdec.stats["group_demotions"] == 0
    assert not tdec.stats.get("lanes_demoted")
    for a, b in zip(got, want, strict=True):
        if b is None:
            assert a is None
        elif tol is None:
            assert a is not None and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a is not None and a.shape == b.shape
            if b.size:
                peak = np.abs(b).max() + 1e-9
                assert np.abs(a - b).max() / peak < tol


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_qoa_mutation_matches_jax(k):
    _matches_jax([_qoa_mutations()[k]])


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_wav_mutation_matches_jax(k):
    _matches_jax([_mutations("wav")[k]])


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_vorbis_mutation_matches_jax(k):
    _matches_jax([_mutations("vorbis")[k]], tol=4e-6)


@pytest.mark.parametrize("k", range(N_MUTATIONS))
@pytest.mark.parametrize("fmt", ["mod", "xm"])
def test_module_mutation_matches_jax(fmt, k):
    """MOD and XM lanes take the per-stream read in both packages."""
    _matches_jax([_mutations(fmt)[k]])


#: the bound of each transform codec between the port's facade and JAX's
#: on a damaged stream, relative to the peak; the others are bit-equal
FACADE_TOL = {"mp3": 4e-6, "vorbis": 4e-6, "opus": 1e-5}


def _facade_run(stream):
    """The reference test's drive of one facade: the open's error, else
    up to 200 reads of 4,096 frames, each finite, and the sticky error
    after them.  Returns (error at open, PCM, error after the reads)."""
    if stream.is_error():
        assert isinstance(stream.error_message(), str)
        return stream.error_message(), None, None
    parts = []
    for _ in range(200):
        out = np.asarray(stream.read_samples_float(4096))
        assert np.isfinite(out).all()
        if out.shape[0] == 0:
            break
        parts.append(out)
    if stream.is_error():
        assert isinstance(stream.error_message(), str)
    pcm = np.concatenate(parts) if parts else np.zeros((0, 1), np.float32)
    return None, pcm, stream.error_message()


@pytest.mark.parametrize("fmt", ["mp3", "flac", "qoa", "wav", "vorbis",
                                 "mod", "opus", "xm"])
def test_facade_never_raises_on_corruption(fmt):
    """Twin of tests/test_robustness.py's facade sweep: every mutation of
    the format's fixture goes through the port's AudioStream(device="cpu")
    and JAX's; nothing raises, the PCM is finite, and the errors at open
    and after the reads are JAX's, with the PCM bit-equal (or within the
    transform codec's bound of the peak)."""
    for k, bad in enumerate(_mutations(fmt)):
        t = TorchStream("cpu")
        t.open_from_memory(bad)
        j = AudioStream()
        j.open_from_memory(bad)
        terr, tpcm, tlate = _facade_run(t)
        jerr, jpcm, jlate = _facade_run(j)
        assert (terr, tlate) == (jerr, jlate), (fmt, k)
        if jpcm is None:
            continue
        assert tpcm.shape == jpcm.shape, (fmt, k)
        if fmt not in FACADE_TOL:
            np.testing.assert_array_equal(tpcm, jpcm, err_msg=f"{k}")
        elif jpcm.size:
            assert _rel(tpcm, jpcm) < FACADE_TOL[fmt], (fmt, k)


@pytest.mark.parametrize("wire", ["packed", "rice"])
@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_flac_mutation_matches_jax(k, wire, monkeypatch):
    if wire == "rice":
        monkeypatch.setenv("AF_TPU_FLAC_DEVICE_RICE", "1")
    _matches_jax([_flac_mutations()[k]], flac_wire=wire)


@functools.lru_cache(maxsize=None)
def _lattice_streams():
    """The reference test's 64 FLAC lanes, marked by distinct lengths."""
    streams = []
    for k in range(64):
        n = 2048 + 64 + 7 * k
        t = np.arange(n)[:, None]
        x = np.clip(np.round(
            6000 * np.sin(2 * np.pi * (220 + 3 * k) * t * [1, 1.31] / 44100)
        ), -32768, 32767).astype(np.int64)
        streams.append(flac_ref.build_flac(
            x, 44100, 16, block_size=1024, stereo_mode="mid_side",
            modes=["lpc8", "fixed3"]))
    return tuple(streams)


@pytest.mark.parametrize("wire", ["packed", "rice"])
def test_per_lane_demotion_keeps_group(wire, monkeypatch):
    """One lane of a 64-lane group faults at its wire's host seam (the
    window parse of the packed wire; the frame sync index of the Rice
    wire) and in the single-stream decoder's frame parse: the group
    bisects, that lane alone is demoted and fails, and the 63 others
    equal a clean batch, for output="numpy" and "device"."""
    streams = list(_lattice_streams())
    bad_len = len(streams[13])
    assert sum(len(s) == bad_len for s in streams) == 1
    clean = [s for i, s in enumerate(streams) if i != 13]
    solo = BatchDecoder(clean, device="cpu", flac_wire=wire).decode_all()

    def fault():
        raise AudioFormatError("injected lane fault")

    orig = FlacDecoder._parse_frame_tensors
    monkeypatch.setattr(
        FlacDecoder, "_parse_frame_tensors",
        lambda self: fault() if len(self._view) == bad_len else orig(self))
    if wire == "packed":
        orig_win = tnative.flac_parse_window
        monkeypatch.setattr(
            tnative, "flac_parse_window",
            lambda lib, data, *a: fault() if len(data) == bad_len
            else orig_win(lib, data, *a))
        seam = "flac_parse_window_multi"
    else:
        seam = "flac_sync_index_multi"
    orig_multi = getattr(tnative, seam)

    def multi(lib, lanes, data_ptrs, data_lens, *a):
        if any(int(data_lens[bi]) == bad_len for bi in lanes):
            fault()
        return orig_multi(lib, lanes, data_ptrs, data_lens, *a)

    monkeypatch.setattr(tnative, seam, multi)
    for output in ("numpy", "device"):
        dec = BatchDecoder(streams, device="cpu", flac_wire=wire)
        out = dec.decode_all(output=output)
        if output == "device":
            out = out.sync().to_numpy()
        assert dec.stats["lanes_demoted"] == 1
        assert any("injected lane fault" in e
                   for e in dec.stats["group_exceptions"])
        assert out[13] is None and dec.errors[13] is not None
        for got, want in zip(out[:13] + out[14:], solo, strict=True):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire,module,fn", [
    ("packed", lpc, "flac_lpc"), ("rice", lpc, "flac_lpc"),
    ("rice", flac_rice, "flac_frame_entropy")])
def test_kernel_error_is_not_demoted(wire, module, fn, monkeypatch):
    """A kernel that does not build, load or launch is no lane's fault:
    decode_all raises it on either wire, and no lane is demoted."""
    def fail(*args, **kwargs):
        raise KernelError(f"{fn} kernel launch failed: CUDA error 700")

    monkeypatch.setattr(module, fn, fail)
    dec = BatchDecoder(list(_lattice_streams()[:4]), device="cpu",
                       flac_wire=wire)
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0


def _mp3_facade(data):
    """JAX's AudioStream decode of `data`, or None where it errs."""
    s = AudioStream()
    s.open_from_memory(data)
    return None if s.is_error() else s.read_samples_float(10 ** 7)


def _rel(a, b):
    """max |a - b| over the peak of b."""
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _mp3_first_overrun(data, monkeypatch):
    """Index, in decode order, of the first granule whose big-values
    Huffman pairs the reference reads past the granule's part2_3_length
    (it reads on into the next granule's bits), or None: the port's
    single-stream decoder, whose Python Huffman follows the reference,
    run with the C stage off and its reader watched."""
    from audio_formats_torch.io.source import MemorySource
    from audio_formats_torch.models import mp3 as tmp3

    overran = []
    watch = {}
    count1 = {id(t) for t in tmp3._C1_LUTS}
    decode, huffman = tmp3._HuffReader.decode, tmp3._huffman

    def watched_decode(self, lut):
        if watch and not watch["seen"] and id(lut) in count1:
            watch["seen"] = True  # the big-values pairs are done
            overran.append(self.pos > watch["limit"])
        return decode(self, lut)

    def watched_huffman(br, gr, scf, limit_bits):
        watch.update(seen=False, limit=limit_bits)
        try:
            return huffman(br, gr, scf, limit_bits)
        finally:
            if not watch["seen"]:
                overran.append(br.pos > limit_bits)
            watch.clear()

    with monkeypatch.context() as m:
        m.setattr(tmp3._HuffReader, "decode", watched_decode)
        m.setattr(tmp3, "_huffman", watched_huffman)
        m.setattr(tmp3.native, "get_lib", lambda: None)
        # the module caches the library at its first decode in the process
        m.setattr(tmp3, "_NATIVE_CACHE", [None])
        try:
            dec = tmp3.probe(MemorySource(data), "cpu")
            while dec is not None and dec.read(1 << 16).shape[0]:
                pass
        except AudioFormatError:
            pass
    return next((g for g, o in enumerate(overran) if o), None)


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_mp3_mutation_matches_jax_facade(k):
    """The port's batch decode of each MP3 mutation (a mono MPEG-1 Layer
    III fixture) against JAX's AudioStream facade: a lane error where the
    facade errs, else within 4e-6 of the peak over the whole stream, the
    granules whose Huffman pairs run past their own bits included (the
    port's lanes read on into their frame's next bits, as the facade
    does)."""
    data = _mutations("mp3")[k]
    want = _mp3_facade(data)
    tdec = BatchDecoder([data], device="cpu")
    got = tdec.decode_all()[0]
    assert tdec.stats["group_demotions"] == 0
    if want is None:
        assert got is None and tdec.errors[0] is not None
        return
    assert tdec.errors == [None] and got.shape == want.shape
    assert _rel(got, want) < 4e-6


class _ZeroedNumpy:
    """numpy with ``empty``/``empty_like`` allocating zeros."""

    empty = staticmethod(np.zeros)
    empty_like = staticmethod(np.zeros_like)

    def __getattr__(self, name):
        return getattr(np, name)


#: MP3 mutations where JAX's batch, its Huffman rows zeroed, reads zeros
#: past a granule's bits and so leaves the facade (ROADMAP Queue 3)
JAX_BATCH_OVERRUNS = (3, 5, 7)


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_mp3_mutation_matches_jax_batch(k, monkeypatch):
    """The port's batch decode of each MP3 mutation against JAX's batch:
    the same lane errors, no demotion, and the PCM within 4e-6 of the
    peak, except on JAX_BATCH_OVERRUNS: there JAX's batch reads its
    zeroed rows past a granule's bits, and the port is within 4e-6 of the
    peak of JAX's facade while JAX's batch is not.  JAX's batch builds its
    Huffman bit rows in ``np.empty`` buffers, so where it reads past a
    granule's bits it reads what the process left there, and its PCM
    changes from one decode to the next; here those buffers start
    zeroed."""
    import audio_formats_tpu.parallel.batch as jax_batch

    monkeypatch.setattr(jax_batch, "np", _ZeroedNumpy())
    data = _mutations("mp3")[k]
    if k not in JAX_BATCH_OVERRUNS:
        _matches_jax([data], tol=4e-6)
        return
    want = _mp3_facade(data)
    jdec = JaxBatchDecoder([data])
    jgot = jdec.decode_all()[0]
    tdec = BatchDecoder([data], device="cpu")
    got = tdec.decode_all()[0]
    assert tdec.errors == jdec.errors == [None]
    assert tdec.stats["group_demotions"] == 0
    assert got.shape == jgot.shape == want.shape
    assert _rel(got, want) < 4e-6 <= _rel(jgot, want)


def test_mp3_sweep_overruns_are_the_known_ones(monkeypatch):
    """The mutations where the reference reads Huffman pairs past a
    granule's bits, and those where the batch then differs from the
    facade over the whole stream (none): pinned, so that a change to
    either shows."""
    firsts, differ = [], []
    for k, data in enumerate(_mutations("mp3")):
        firsts.append(_mp3_first_overrun(data, monkeypatch))
        want = _mp3_facade(data)
        if want is None:
            continue
        got = BatchDecoder([data], device="cpu").decode_all()[0]
        if _rel(got, want) >= 4e-6:
            differ.append(k)
    assert firsts == [None, None, None, 7, 1, 2, None, 4, 6, None, None,
                      None, None, None]
    assert differ == []


def _opus_group(cls, d):
    """The Opus group that the eligibility cascade of `cls` (JAX's
    BatchDecoder, or the port's ``classify`` for the port's
    BatchDecoder) picks for decoder d, as both dispatch."""
    if not hasattr(d, "_collect_packets"):
        return None
    if cls is BatchDecoder:
        route = opus_groups.classify(d)
        return route and route[0]
    for group, fn in (("celt", cls._opus_eligible),
                      ("silk", cls._silk_eligible),
                      ("hybrid", cls._hybrid_eligible),
                      ("mixed", cls._opus_mixed_eligible)):
        if fn(d):
            return group
    return None


@pytest.mark.parametrize("fixture,group", [
    ("silk", "silk"), ("celt", "celt"), ("hybrid", "hybrid")])
def test_opus_fixture_rides_its_group(fixture, group):
    """Each Opus fixture, unharmed, rides its lockstep group and keeps
    within 1e-5 of the peak of JAX's facade."""
    data = _opus_fixture(fixture)[0]
    tdec = BatchDecoder([data], device="cpu")
    got = tdec.decode_all()[0]
    assert _opus_group(BatchDecoder, tdec.decoders[0]) == group
    assert tdec.stats.get(f"opus_{group}_lanes", 1) == 1
    assert tdec.stats["group_demotions"] == 0
    s = AudioStream()
    s.open_from_memory(data)
    assert _rel(got, s.read_samples_float(10 ** 7)) < 1e-5


@pytest.mark.parametrize("k", range(N_MUTATIONS))
@pytest.mark.parametrize("fixture", ["silk", "celt", "hybrid"])
def test_opus_mutation_matches_jax_facade(fixture, k):
    """The port's batch decode of each Opus mutation against JAX's
    AudioStream facade: a lane error where the facade errs at open, else
    within 1e-5 of the peak over the whole stream, with no demotion; the
    lane takes the Opus group (or the per-stream read) that JAX's
    eligibility tests give it."""
    data = _opus_fixture(fixture)[1 + k]
    s = AudioStream()
    s.open_from_memory(data)
    tdec = BatchDecoder([data], device="cpu")
    jdec = JaxBatchDecoder([data])
    assert _opus_group(BatchDecoder, tdec.decoders[0]) == \
        _opus_group(JaxBatchDecoder, jdec.decoders[0])
    got = tdec.decode_all()[0]
    assert tdec.stats["group_demotions"] == 0
    if s.is_error():
        assert got is None and tdec.errors == [s.error_message()]
        return
    want = s.read_samples_float(10 ** 7)
    assert not s.is_error()
    assert tdec.errors == [None] and got.shape == want.shape
    if want.size:
        assert _rel(got, want) < 1e-5


def test_hybrid_splices_are_the_known_jax_batch_drains():
    """The hybrid mutations where JAX's batch leaves its facade are the
    three splices (their granule field declares more than their packets
    hold, and JAX's group drains up to its resampler rows' reach); on
    them the port's batch keeps to the facade's length and samples."""
    differ = []
    for k, data in enumerate(_hybrid_mutations()[1:]):
        s = AudioStream()
        s.open_from_memory(data)
        if s.is_error():
            continue
        want = s.read_samples_float(10 ** 7)
        jgot = JaxBatchDecoder([data]).decode_all()[0]
        got = BatchDecoder([data], device="cpu").decode_all()[0]
        assert got.shape == want.shape
        if jgot.shape != want.shape:
            differ.append(k)
            assert jgot.shape[0] == want.shape[0] + 486
    assert differ == [9, 10, 11]
