"""The port's SILK, hybrid and mode-switching Opus lockstep groups against
the JAX package's, on the CPU.

``BatchDecoder(device="cpu")`` runs each group with its kernels' twins: the
SILK group's upsample is K13's twin (tests/test_torch_resample_batch.py
holds it to JAX's conv bit for bit), the hybrid and mixed groups' CELT
buckets the IMDCT matmul and K12a's twin.  Each lane is held within TOL of
the peak of JAX's BatchDecoder and of JAX's per-stream facade (JAX's own
bound between its batch and its facade, tests/test_batch.py:408-430), and
each lane must land in the group JAX puts it in, under the same key, with
no demotion.  Measured on these inputs: the SILK lanes are JAX's batch bit
for bit and within 5e-7 of the peak of the facade (which upsamples in
f64); the hybrid lanes within 1.1e-7 of JAX's batch (the IMDCT matmul is
not XLA's einsum bit for bit) and 5.1e-7 of the facade; the mixed group's
lanes equal the facade bit for bit below OPUS_MIXED_DEVICE_MIN_LANES (host
synthesis) and are within 2e-7 of it and of JAX's batch from it on.

Inputs: the in-repo SILK packets of tests/test_opus_silk.py, and the
committed libopus speech corpus (tests/torch_opus_speech_cases.py: SILK WB,
hybrid FB mono and stereo, and mode tours).
"""

import functools

import numpy as np
import pytest

from audio_formats_tpu import AudioStream
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models import opus as topus
from audio_formats_torch.ops import celt_dsp
from audio_formats_torch.ops import resample as trs
from audio_formats_torch.ops._kernels import KernelError
from audio_formats_torch.parallel.groups import opus as opus_groups

from golden import opus_oracle, opus_ref
from test_opus_silk import SILK_PACKETS

import torch_opus_speech_cases as speech_cases

TOL = 1e-5   # max abs error over the peak: batch against JAX and facade


@functools.lru_cache(maxsize=None)
def _corpus():
    return speech_cases.load()


def _speech(kind, k, n=None, preskip=312):
    """A stream of the first `n` packets of the k-th master of `kind`."""
    mi = [i for i, kd in enumerate(speech_cases.kinds()) if kd == kind][k]
    return speech_cases.stream(opus_ref.build_ogg_opus, _corpus()[mi], n,
                               preskip=preskip)


def _silk_packets(n=None, preskip=0):
    return opus_ref.build_ogg_opus(
        [(bytes.fromhex(h), 960) for h in SILK_PACKETS[:n]], channels=1,
        preskip=preskip)


def _facade(data):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    return s.read_samples_float(10 ** 7)


def _rel(got, want):
    assert got is not None and got.shape == want.shape
    assert got.dtype == np.float32
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9)) \
        if want.size else 0.0


def _route(cls, d):
    """The Opus group the JAX package's eligibility cascade (`cls`, its
    BatchDecoder) puts decoder d in, with its key: CELT, SILK, hybrid,
    mixed, in the form of the port's ``classify``."""
    if cls._opus_eligible(d):
        return "celt", d.channels
    if cls._silk_eligible(d):
        pk0 = d._silk_lockstep[0]
        return "silk", (d.channels, pk0["config"], pk0["stereo"],
                        len(pk0["frames"]))
    if cls._hybrid_eligible(d):
        pk0 = d._silk_lockstep[0]
        return "hybrid", (d.channels, pk0["config"], pk0["stereo"])
    if cls._opus_mixed_eligible(d):
        return "mixed", d.channels
    return None


def _check(streams, routes=None, tol=TOL):
    """Decode `streams` with the port and JAX: the same group and key for
    each lane as JAX (and `routes`' groups, where given), no demotion, no
    lane error, each lane within `tol` of JAX's batch and of the facade.
    Returns the port's decoder and its output."""
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all()
    t_routes = [opus_groups.classify(d) for d in
                BatchDecoder(streams, device="cpu").decoders]
    j_routes = [_route(JaxBatchDecoder, d) for d in
                JaxBatchDecoder(streams).decoders]
    assert t_routes == j_routes
    # a lane no Opus group takes (multistream) has the route None
    groups = [r and r[0] for r in t_routes]
    if routes is not None:
        assert groups == routes
    st = tdec.stats
    assert tdec.errors == jdec.errors == [None] * len(streams)
    assert st["group_demotions"] == 0 and not st.get("lanes_demoted")
    for kind in ("silk", "hybrid", "mixed"):
        assert st.get(f"opus_{kind}_lanes", 0) == groups.count(kind)
    for i, data in enumerate(streams):
        assert _rel(got[i], want[i]) < tol
        assert _rel(got[i], _facade(data)) < tol
    return tdec, got


def test_silk_packets_ragged_batch():
    """JAX's tests/test_batch.py:408-430 lanes: ragged lengths, each lane
    drained at its own end while the others go on; one K13 step a packet
    step."""
    streams = [_silk_packets(), _silk_packets(3), _silk_packets(2, 100)]
    dec, _ = _check(streams, ["silk"] * 3)
    st = dec.stats
    assert st["windows_by_format"] == {"opus_silk": len(SILK_PACKETS)}
    assert st["h2d_bytes_by_format"]["opus"] == st["h2d_bytes"] > 0


def _multiframe():
    singles = [bytes.fromhex(h) for h in SILK_PACKETS]
    toc = singles[0][0] & 0xFC   # the same config, rebuilt as code 3
    pkts = []
    for a, b in zip(singles[::2], singles[1::2]):
        fa, fb = a[1:], b[1:]
        pkts.append((bytes([toc | 3, 0x80 | 2, len(fa)]) + fa + fb, 1920))
    return pkts


def test_silk_multiframe_packets():
    """JAX's tests/test_batch.py:532-555: code-3 packets of two 20 ms
    SILK frames ride one group of their own (frames = 2 in the key)."""
    pkts = _multiframe()
    streams = [opus_ref.build_ogg_opus(pkts, channels=1, preskip=0),
               opus_ref.build_ogg_opus(pkts[:1], channels=1, preskip=0)]
    dec, _ = _check(streams, ["silk", "silk"])
    assert dec.stats["windows_by_format"]["opus_silk"] == len(pkts)
    keys = {opus_groups.classify(d)[1] for d in dec.decoders}
    assert keys == {(1, 9, False, 2)}


def test_corpus_silk_lanes():
    """The corpus's four mono WB SILK masters (20 and 32 kbit/s) as ragged
    prefixes and preskips, and its stereo master: a mono group and a
    stereo group."""
    streams = [_speech("silk", k % 4, 20 + 7 * k, (0, 312)[k % 2])
               for k in range(6)] + [_speech("silk", 4, 25)]
    dec, _ = _check(streams, ["silk"] * 7)
    keys = {opus_groups.classify(d)[1] for d in dec.decoders}
    assert keys == {(1, 9, False, 1), (2, 9, True, 1)}


@pytest.mark.parametrize("stereo", [False, True])
def test_corpus_hybrid_lanes(stereo):
    """The corpus's FB hybrid masters (config 15), mono at 32 and 48
    kbit/s as ragged prefixes, or the stereo master: K13 a step, and the
    CELT layer's buckets through the IMDCT and K12a's twin."""
    if stereo:
        streams = [_speech("hybrid", 4, 30), _speech("hybrid", 4, 18, 0)]
    else:
        streams = [_speech("hybrid", k % 4, 18 + 5 * k, (312, 0)[k % 2])
                   for k in range(5)]
    dec, _ = _check(streams, ["hybrid"] * len(streams))
    st = dec.stats
    steps = max(len(d._opus_packets) for d in dec.decoders)
    assert st["windows_by_format"]["opus_silk"] == steps
    assert st["windows_by_format"]["opus"] >= steps
    assert st["windows"] == sum(st["windows_by_format"].values())


def test_corpus_hybrid_whole_master_drains_its_tail():
    """A whole hybrid master (4 s): the EOS drain adds the CELT delay FIFO
    to the upsampler rows' tail, so the last samples keep to the facade
    (the corpus form of tests/test_opus_silk.py:563)."""
    data = _speech("hybrid", 1, None, 0)
    _, (got,) = _check([data], ["hybrid"])
    want = _facade(data)
    assert _rel(got[-300:], want[-300:]) < TOL
    assert np.abs(want[-300:]).max() > 0


def test_hybrid_eos_drain_includes_celt_fifo():
    """tests/test_opus_silk.py:563 on the port: 8 hybrid packets encoded
    here by libopus; the batch's drained tail equals the facade's."""
    O = opus_oracle
    if O.get_lib() is None:
        pytest.skip("system libopus unavailable")
    rng = np.random.default_rng(5)
    N = 960
    t = np.arange(N * 8) / 48000.0
    sig = (6000 * np.sin(2 * np.pi * 220 * t)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
           + 2000 * np.sin(2 * np.pi * 5000 * t)
           + 700 * rng.standard_normal(t.size))
    sig = np.clip(sig, -32000, 32000).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=36000,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
    pkts = [(enc.encode(sig[n * N: (n + 1) * N]), N) for n in range(8)]
    assert {topus.parse_packet(p)["config"] for p, _ in pkts} <= \
        set(range(12, 16))
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0)
    route = opus_groups.classify(BatchDecoder(
        [data], device="cpu").decoders[0])
    _, (got,) = _check([data], [route[0]])
    assert route[0] in ("hybrid", "mixed")
    want = _facade(data)
    assert _rel(got[-300:], want[-300:]) < TOL


def test_corpus_tour_lanes():
    """The two mode tours (SILK WB, CELT FB, hybrid SWB, a mode every
    ~0.25 s) ride the mixed group; at two lanes it answers its CELT
    syntheses on the host, so they are the facade's bits."""
    streams = [_speech("tour", 0, 60, 312), _speech("tour", 1, 45, 0)]
    dec, got = _check(streams, ["mixed", "mixed"])
    st = dec.stats
    assert st["opus_mixed_host_rounds"] > 0
    assert "opus" not in st["windows_by_format"]
    for g, data in zip(got, streams):
        np.testing.assert_array_equal(g, _facade(data))


def _tour_lanes(n):
    return [_speech("tour", k % 2, 26 + 3 * k, (0, 130, 312)[k % 3])
            for k in range(n)]


@pytest.mark.parametrize("lanes,threshold", [(15, 16), (16, 16), (15, 15)])
def test_mixed_group_device_threshold(lanes, threshold, monkeypatch):
    """The mixed group below OPUS_MIXED_DEVICE_MIN_LANES answers its CELT
    syntheses on the host, and from it on in buckets through the IMDCT and
    K12a (their twins here): 15 and 16 lanes at the default of 16, and 15
    lanes with the constant set to 15.  JAX's switch, its env variable, is
    set to the same value."""
    monkeypatch.setattr(opus_groups, "OPUS_MIXED_DEVICE_MIN_LANES",
                        threshold)
    monkeypatch.setenv("AF_TPU_OPUS_MIXED_DEVICE_MIN_LANES", str(threshold))
    dec, _ = _check(_tour_lanes(lanes), ["mixed"] * lanes)
    st = dec.stats
    device = lanes >= threshold
    assert st["opus_mixed_lanes"] == lanes
    assert (st["windows_by_format"].get("opus", 0) > 0) == device
    assert (st.get("opus_mixed_host_rounds", 0) > 0) == (not device)


def test_mixed_and_every_group_in_one_batch():
    """CELT-only lanes of the in-repo packets, SILK, hybrid and tour
    lanes, and a multistream-free mix of them in one batch: each lane in
    JAX's group, the mixed group on its thread beside the others."""
    from test_opus_celt import PACKETS

    celt = opus_ref.build_ogg_opus(
        [(bytes.fromhex(h), 480) for h in PACKETS], channels=1, preskip=130)
    streams = [celt, _silk_packets(), _speech("silk", 1, 30),
               _speech("hybrid", 2, 20), _speech("tour", 0, 40),
               _speech("silk", 4, 20), _speech("hybrid", 4, 15, 0)]
    _check(streams, ["celt", "silk", "silk", "hybrid", "mixed", "silk",
                     "hybrid"])


def _lace16(n):
    """A self-delimited frame length (RFC 6716 appendix B)."""
    if n < 252:
        return bytes([n])
    return bytes([252 + (n & 3), (n - 252 - (n & 3)) >> 2])


def _multistream(packets, samples):
    """A mapping-family-1 stream of two mono streams: each packet is the
    self-delimited form of a one-frame packet for the first stream, then
    that packet for the second (RFC 7845 §5.1.1, RFC 6716 appendix B)."""
    import struct

    from audio_formats_tpu.io import ogg

    head = (b"OpusHead" + bytes([1, 2]) + struct.pack("<HIh", 0, 48000, 0)
            + bytes([1, 2, 0, 0, 1]))
    tags = b"OpusTags" + struct.pack("<I", 0) + struct.pack("<I", 0)
    pages = [ogg.build_page([head], 7, 0, 0, bos=True),
             ogg.build_page([tags], 7, 1, 0)]
    for k, p in enumerate(packets):
        pkt = p[:1] + _lace16(len(p) - 1) + p[1:] + p
        pages.append(ogg.build_page([pkt], 7, 2 + k, (k + 1) * samples,
                                    eos=k == len(packets) - 1))
    return b"".join(pages)


def test_classify_walks_and_parses_each_lane_once(monkeypatch):
    """A batch of a CELT, a SILK, a hybrid, a mode-tour and a multistream
    lane: one Ogg walk for each mapping-0 lane and one parse for each of
    its packets, wherever the cascade puts it (the CELT test used to walk
    and parse each lane, and each later test again, up to four times),
    none for the multistream lane; each lane in JAX's group and within TOL
    of JAX's batch and of the facade, the PCM that of a batch decoded
    without the counters."""
    from test_opus_celt import PACKETS

    celt = [bytes.fromhex(h) for h in PACKETS]
    streams = [opus_ref.build_ogg_opus([(p, 480) for p in celt],
                                       channels=1, preskip=130),
               _silk_packets(), _speech("hybrid", 2, 20),
               _speech("tour", 0, 40), _multistream(celt, 480)]
    routes = ["celt", "silk", "hybrid", "mixed", None]
    walks, parses = [], []
    collect, parse = topus.OpusDecoder._collect_packets, \
        opus_groups.parse_packet

    def counted_collect(d):
        walks.append(d)
        return collect(d)

    def counted_parse(data):
        parses.append(data)
        return parse(data)

    dec = BatchDecoder(streams, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(topus.OpusDecoder, "_collect_packets", counted_collect)
        m.setattr(opus_groups, "parse_packet", counted_parse)
        got = dec.decode_all()
    lanes = dec.decoders
    assert sorted(next(i for i, d in enumerate(lanes) if d is w)
                  for w in walks) == [0, 1, 2, 3]
    assert len(parses) == sum(len(collect(d)) for d in lanes[:4])
    assert [r and r[0] for r in map(opus_groups.classify, lanes)] == routes
    _, want = _check(streams, routes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reference_resampler_lane_is_mixed():
    """A lane of the reference's speex resampler (JAX's
    AF_TPU_REFERENCE_RESAMPLER, the port's decoder argument) is neither
    SILK- nor hybrid-eligible; the mixed group takes it, as JAX's."""
    for data in (_silk_packets(), _speech("hybrid", 0, 10)):
        d = topus.OpusDecoder(MemorySource(data), reference_resampler=True)
        assert opus_groups.classify(d)[0] == "mixed"
        plain = topus.OpusDecoder(MemorySource(data))
        assert opus_groups.classify(plain)[0] in ("silk", "hybrid")


def test_redundancy_tail_lane_is_demoted():
    """A SILK lane with bytes after a packet's SILK payload (read as a
    mode-transition redundancy tail, which the group cannot splice) makes
    the group raise; the lattice demotes that lane alone to the per-stream
    read, where it equals the facade, and the other lanes equal a clean
    batch (JAX's tests/test_opus_silk.py:611 on the port)."""
    ch, fs, pkts = _corpus()[0]
    tweaked = list(pkts[:12])
    tweaked[3] = tweaked[3] + bytes(8)
    bad = opus_ref.build_ogg_opus([(p, fs) for p in tweaked], channels=ch,
                                  preskip=312)
    clean = [_speech("silk", k % 4, 12 + k, 312) for k in range(7)]
    streams = clean[:3] + [bad] + clean[3:]
    solo = BatchDecoder(clean, device="cpu").decode_all()
    dec = BatchDecoder(streams, device="cpu")
    got = dec.decode_all()
    st = dec.stats
    assert st["lanes_demoted"] == 1
    assert any("SILK redundancy tail in group" in e
               for e in st["group_exceptions"])
    assert dec.errors == [None] * len(streams)
    assert _rel(got[3], _facade(bad)) < TOL
    for g, w in zip(got[:3] + got[4:], solo, strict=True):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("kind", ["silk", "hybrid"])
def test_k13_kernel_error_is_not_demoted(kind, monkeypatch):
    """A K13 that does not build, load or launch is no lane's fault:
    decode_all raises it from the SILK and the hybrid group, and no lane
    is demoted."""
    def fail(*args, **kwargs):
        raise KernelError("silk_upsample kernel launch failed: CUDA error 700")

    monkeypatch.setattr(trs, "silk_upsample", fail)
    dec = BatchDecoder([_speech(kind, 0, 8), _speech(kind, 1, 6)],
                       device="cpu")
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0


@pytest.mark.parametrize("group", ["hybrid", "mixed"])
def test_k12a_kernel_error_is_not_demoted(group, monkeypatch):
    """K12a failing in the hybrid group, and in the mixed group on its own
    thread (16 tour lanes, so the device path): decode_all raises it on
    the main thread once the thread has been joined."""
    def fail(*args, **kwargs):
        raise KernelError("celt_ola kernel launch failed: CUDA error 700")

    monkeypatch.setattr(celt_dsp, "celt_ola", fail)   # K12a, long blocks
    monkeypatch.setattr(celt_dsp, "imdct_ola_short", fail)   # short blocks
    streams = ([_speech("hybrid", 0, 8)] if group == "hybrid"
               else _tour_lanes(16))
    dec = BatchDecoder(streams + [_silk_packets()], device="cpu")
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0
