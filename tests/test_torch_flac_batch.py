"""The port's FLAC slice against the JAX package's, on the CPU.

The same golden FLAC bytes go through ``audio_formats_tpu``'s BatchDecoder
(JAX on its CPU backend) and ``audio_formats_torch``'s
``BatchDecoder(..., device="cpu")``; PCM and per-lane errors must be equal,
for ``output="numpy"`` and for ``decode_all(output="device").to_numpy()``.
"""

import numpy as np
import pytest
import torch

from audio_formats_tpu import AudioStream
from audio_formats_tpu.io import ogg as oggmod
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder
from audio_formats_tpu.parallel import batch as jbatch

from audio_formats_torch import BatchDecoder
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models.flac import FlacDecoder
from audio_formats_torch.parallel import batch as tbatch

from golden import flac_ref, mp3_ref, mod_ref, opus_ref, wav_ref, xm_ref


def _pcm(rng, frames, channels, bps, amp=9000.0, noise=300.0):
    t = np.arange(frames)[:, None]
    f = np.array([1.0, 1.4, 0.7][:channels])
    lim = (1 << (bps - 1)) - 1
    return np.clip(np.round(
        amp * np.sin(2 * np.pi * 300 * t * f / 44100)
        + noise * rng.standard_normal((frames, channels))),
        -lim - 1, lim).astype(np.int64)


def _flac(rng, frames=3000, stereo="mid_side", channels=2, bps=16,
          modes=("lpc8", "fixed3"), **kw):
    pcm = _pcm(rng, frames, channels, bps,
               amp=9000.0 * (1 << (bps - 16)), noise=300.0 * (1 << (bps - 16)))
    return flac_ref.build_flac(pcm, 44100, bps, block_size=1024,
                               stereo_mode=stereo if channels == 2
                               else "independent",
                               modes=list(modes[:channels]), **kw), pcm


def _expected(pcm, bps):
    return ((pcm << (32 - bps)).astype(np.float64)
            * (1.0 / 2147483647.0)).astype(np.float32)


def _both(streams, **kw):
    """Decode with both packages, both output modes; assert the port's two
    modes agree and return (port, jax, port decoder, jax decoder)."""
    jdec = JaxBatchDecoder(streams, **kw)
    ref = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu", **kw)
    got = tdec.decode_all()
    dev_res = BatchDecoder(streams, device="cpu", **kw).decode_all(
        output="device")
    for _, wins in dev_res.windows():
        assert all(isinstance(w, torch.Tensor) for w in wins)
    got_dev = dev_res.sync().to_numpy()
    for a, b in zip(got, got_dev):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    return got, ref, tdec, jdec


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            assert a is not None and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stereo", ["independent", "left_side",
                                    "right_side", "mid_side"])
def test_stereo_assignments_match_jax(stereo):
    rng = np.random.default_rng(len(stereo))
    items = [_flac(rng, 2000 + 900 * i, stereo) for i in range(3)]
    streams = [d for d, _ in items]
    got, ref, tdec, _ = _both(streams)
    _assert_same(got, ref)
    for (_, pcm), g in zip(items, got):
        np.testing.assert_array_equal(g, _expected(pcm, 16))
    assert tdec.stats["group_demotions"] == 0
    assert tdec.stats["windows"] >= 1
    assert tdec.errors == [None] * 3


def test_mono_and_stereo_groups_match_jax(rng):
    mono = [_flac(rng, 2500 + 333 * i, channels=1, modes=("lpc8",))
            for i in range(2)]
    stereo = [_flac(rng, 4100, "mid_side")]
    streams = [d for d, _ in mono + stereo]
    got, ref, tdec, _ = _both(streams)
    _assert_same(got, ref)
    for (_, pcm), g in zip(mono + stereo, got):
        np.testing.assert_array_equal(g, _expected(pcm, 16))
    assert tdec.stats["group_demotions"] == 0


def test_24bit_matches_jax(rng):
    """24-bit frames exceed the device lanes' 18 bits: exact host path."""
    data, pcm = _flac(rng, 6000, "left_side", bps=24, modes=("lpc8", "fixed2"))
    got, ref, tdec, _ = _both([data])
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[0], _expected(pcm, 24))
    assert tdec.stats["group_demotions"] == 0


def _mixed_18bit(rng, bs=256, nf=6):
    """18-bit stereo alternating independent frames (sub_bps 18: device,
    exact lanes) and mid/side frames (side 19 bits: host), so windows mix
    host and device frames."""
    pcm = rng.integers(-2**17, 2**17, (bs * nf, 2)).astype(np.int64)
    out = bytearray(b"fLaC")
    si = flac_ref._BW()
    si.w(bs, 16); si.w(bs, 16); si.w(0, 24); si.w(0, 24)
    si.w(44100, 20); si.w(1, 3); si.w(17, 5); si.w(bs * nf, 36)
    streaminfo = bytes(si.bytes) + b"\0" * 16
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo
    for fi in range(nf):
        mode = "independent" if fi % 2 == 0 else "mid_side"
        out += flac_ref.encode_frame(pcm[fi * bs:(fi + 1) * bs], fi,
                                     44100, 18, mode)
    return bytes(out), pcm


def test_mixed_host_device_window_matches_jax(rng):
    data, pcm = _mixed_18bit(rng)
    got, ref, tdec, _ = _both([data, _flac(rng, 1500)[0]])
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[0], _expected(pcm, 18))
    assert tdec.stats["group_demotions"] == 0


def test_forced_split_width_plane_matches_jax(rng, monkeypatch):
    """Pack-small + overflow plane merged by flac_merge_overflow, forced
    on both packages, against each other and the plain packing."""
    streams = [_flac(rng, 2000 + 997 * i)[0] for i in range(3)]
    plain = BatchDecoder(streams, device="cpu").decode_all()

    def forced(w_l, wmax, Ln, bs):
        assert wmax > 4
        return 4, 512

    monkeypatch.setattr(jbatch, "_flac_width_plan", forced)
    monkeypatch.setattr(tbatch, "_flac_width_plan", forced)
    got, ref, _, _ = _both(streams)
    _assert_same(got, ref)
    _assert_same(got, plain)


def test_width_plan_is_the_jax_plan():
    rng = np.random.default_rng(2)
    for Ln, bs in ((512, 4096), (8, 4096), (96, 1024)):
        w_l = rng.integers(3, 27, Ln).astype(np.int32)
        wmax = int(w_l.max())
        assert tbatch._flac_width_plan(w_l, wmax, Ln, bs) == \
            jbatch._flac_width_plan(w_l, wmax, Ln, bs)
    assert tbatch._FLAC_W_BUCKETS == jbatch._FLAC_W_BUCKETS


def _ogg_flac(native, frames):
    pos = 4
    while True:
        hdr = int.from_bytes(native[pos: pos + 4], "big")
        pos += 4 + (hdr & 0xFFFFFF)
        if hdr >> 31:
            break
    header_pkt = (b"\x7fFLAC" + bytes([1, 0]) + (0).to_bytes(2, "big")
                  + native[:pos])
    body = native[pos:]
    pages = [oggmod.build_page([header_pkt], serial=42, seq=0, granule=0,
                               bos=True)]
    seq = 1
    for i in range(0, len(body), 4000):
        pages.append(oggmod.build_page(
            [body[i: i + 4000]], serial=42, seq=seq,
            granule=frames if i + 4000 >= len(body) else 0,
            eos=i + 4000 >= len(body)))
        seq += 1
    return b"".join(pages)


def test_ogg_flac_matches_jax(rng):
    native, pcm = _flac(rng, 3000, "left_side", modes=("lpc4", "fixed2"))
    data = _ogg_flac(native, 3000)
    got, ref, tdec, _ = _both([data, native])
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[0], _expected(pcm, 16))
    assert tdec.stats["group_demotions"] == 0


def test_corrupt_lane_matches_jax(rng):
    """A corrupt lane gives the same PCM or error in both packages, and the
    good lanes decode exactly as alone."""
    goods = [_flac(rng, 2500 + 500 * i) for i in range(3)]
    b = bytearray(goods[0][0])
    for pos in rng.integers(len(b) // 4, len(b), 32):
        b[pos] ^= 0xFF
    streams = [goods[0][0], bytes(b), goods[1][0], b"\x00" * 64,
               goods[2][0]]
    got, ref, tdec, jdec = _both(streams)
    _assert_same(got, ref)
    assert tdec.errors == jdec.errors
    for i, (_, pcm) in zip((0, 2, 4), goods):
        np.testing.assert_array_equal(got[i], _expected(pcm, 16))


def test_python_parser_path_matches_jax(rng, monkeypatch):
    """Without the C host stage both packages parse in Python and upload
    unpacked residuals; still the same bits."""
    monkeypatch.setenv("AF_TPU_NO_NATIVE", "1")
    items = [_flac(rng, 1500), _flac(rng, 1200, channels=1, modes=("lpc8",))]
    got, ref, _, _ = _both([d for d, _ in items])
    _assert_same(got, ref)
    for (_, pcm), g in zip(items, got):
        np.testing.assert_array_equal(g, _expected(pcm, 16))


def _facade(data, frames=10**6):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    return s.read_samples_float(frames)


@pytest.mark.parametrize("kind", ["16bit", "24bit", "mixed18"])
def test_flac_decoder_read_matches_jax_facade(kind):
    """The port's FlacDecoder.read (the per-stream path demoted lanes take)
    against the JAX package's AudioStream, with the same parse state."""
    rng = np.random.default_rng(len(kind))
    if kind == "16bit":
        data, _ = _flac(rng, 5000, "right_side")
    elif kind == "24bit":
        data, _ = _flac(rng, 3000, "mid_side", bps=24)
    else:
        data, _ = _mixed_18bit(rng)
    ref = _facade(data)
    dec = FlacDecoder(MemorySource(data), device="cpu")
    assert dec.length_frames == ref.shape[0]
    chunks = []
    while True:
        c = dec.read(1500)
        if c.shape[0] == 0:
            break
        chunks.append(c)
    np.testing.assert_array_equal(np.concatenate(chunks), ref)
    assert dec.tell() == dec.length_frames


def test_flac_decoder_parse_state_matches_jax(rng):
    from audio_formats_tpu.io.source import MemorySource as JMemorySource
    from audio_formats_tpu.models.flac import FlacDecoder as JFlacDecoder

    data, _ = _flac(rng, 4000, seektable=True)
    a = FlacDecoder(MemorySource(data), device="cpu")
    b = JFlacDecoder(JMemorySource(data))
    for _ in range(3):
        assert (a._cur_bit, a._frame_pos, a.length_frames) == \
            (b._cur_bit, b._frame_pos, b.length_frames)
        np.testing.assert_array_equal(a.read(1300), b.read(1300))
    assert a.seek(2222) and b.seek(2222)
    np.testing.assert_array_equal(a.read(700), b.read(700))


def _unported_streams(rng):
    s16 = rng.integers(-3000, 3000, 2048)
    q = np.zeros(576, np.int64)
    q[:20] = rng.integers(-5, 6, 20)
    mp3 = mp3_ref.build_mp3([[[{"q": q}], [{"q": q}]]] * 3, channels=1)
    vorbis = oggmod.build_page([b"\x01vorbis" + b"\0" * 23], serial=7,
                               seq=0, granule=0, bos=True)
    return {
        "WAV": wav_ref.build_wav(wav_ref.pack_pcm(s16, 16), fmt_tag=1,
                                 channels=1, sample_rate=44100, bits=16),
        "MP3": mp3,
        "Ogg Vorbis": vorbis,
        "Ogg Opus": opus_ref.build_ogg_opus([opus_ref.silence_packet()] * 2,
                                            channels=1),
        "MOD": mod_ref.build_mod([mod_ref.empty_pattern()], [0],
                                 [(mod_ref.saw_sample(), 64, 0, 0, 0)]),
        "XM": xm_ref.build_xm([xm_ref.empty_rows(4, 4)], [0], [],
                              channels=4),
    }


def test_unported_formats_get_lane_errors(rng):
    fx = _unported_streams(rng)
    good, pcm = _flac(rng, 2000)
    dec = BatchDecoder([good, *fx.values(), b"\x01" * 100], device="cpu")
    out = dec.decode_all()
    np.testing.assert_array_equal(out[0], _expected(pcm, 16))
    for name, err, o in zip(fx, dec.errors[1:], out[1:]):
        assert o is None
        assert err == (f"Cannot decode stream: {name} is not decoded by "
                       "audio_formats_torch yet."), (name, err)
    assert dec.errors[-1] == "Cannot decode stream: unrecognized encoding."


def test_cuda_without_a_gpu_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        BatchDecoder([_flac(rng, 1100)[0]])
