"""The port's WAV slice against the JAX package's, on the CPU: the
single-stream decoder on the reference test's container corner cases, the
batch decoder's WAV groups for every integer kind, the batched and the
streaming encoders for every sample format with and without dither, and
the probe cascade.  Integer PCM must be bit-equal and encoded bytes
byte-equal."""

import struct

import numpy as np
import pytest

from audio_formats_tpu.config import AudioSampleFormat as JFormat
from audio_formats_tpu.config import EncodingOptions as JOptions
from audio_formats_tpu.io.source import ByteSink as JSink
from audio_formats_tpu.io.source import MemorySource as JSource
from audio_formats_tpu.models import wav as jwav
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder
from audio_formats_tpu.parallel.encode import encode_wav_batch as jax_encode

from audio_formats_torch import BatchDecoder, encode_wav_batch, models
from audio_formats_torch.config import AudioSampleFormat, EncodingOptions
from audio_formats_torch.errors import AudioFormatError
from audio_formats_torch.io.source import ByteSink, MemorySource
from audio_formats_torch.models import wav as twav

from golden import wav_ref

BITS = {"u8": 8, "s16": 16, "s24": 24, "s32": 32}


def _ints(rng, bits, n):
    if bits == 8:
        return rng.integers(0, 256, n).astype(np.int32)
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), n) \
        .astype(np.int32)


def _stream(rng, bits, ch, frames, **kw):
    ints = _ints(rng, bits, frames * ch)
    return wav_ref.build_wav(wav_ref.pack_pcm(ints, bits), fmt_tag=1,
                             channels=ch, sample_rate=44100, bits=bits, **kw)


def _odd_final_chunk():
    """s24 mono with 2,001 frames, written by the JAX encoder: the final
    data chunk has an odd size and no pad byte."""
    x = (0.25 * np.sin(2 * np.pi * 440 * np.arange(2001) / 44100))[:, None]
    sink = JSink()
    enc = jwav.WavEncoder(sink, 44100, 1,
                          JOptions(sample_format=JFormat.s24))
    enc.write(x.astype(np.float32))
    enc.finalize()
    data = sink.getvalue()
    assert len(data) & 1
    return data


def _corner_cases():
    rng = np.random.default_rng(21)
    floats = (rng.random(500) * 2 - 1).astype(np.float32)
    return {
        "extensible": _stream(rng, 16, 2, 128, extensible=True),
        "extensible_float": wav_ref.build_wav(
            floats.astype("<f4").tobytes(), fmt_tag=3, channels=1,
            sample_rate=48000, bits=32, extensible=True),
        "chunks_and_trailing_zero": _stream(
            rng, 16, 1, 64,
            extra_chunks=[(b"LIST", b"\x00" * 11), (b"AFAn", b"xyz")])
        + b"\0",
        "odd_final_chunk": _odd_final_chunk(),
        "float64": wav_ref.build_wav(
            floats.astype(np.float64).astype("<f8").tobytes(), fmt_tag=3,
            channels=2, sample_rate=48000, bits=64),
        "u8": _stream(rng, 8, 2, 301),
        "s24_stereo": _stream(rng, 24, 2, 777),
        "s32": _stream(rng, 32, 1, 1000),
        "short_data": _stream(rng, 16, 2, 200)[:-7],
    }


@pytest.mark.parametrize("name", list(_corner_cases()))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decoder_matches_jax(name, dtype):
    data = _corner_cases()[name]
    want_dec = jwav.WavDecoder(JSource(data))
    got_dec = twav.WavDecoder(MemorySource(data), device="cpu")
    assert (got_dec.channels, got_dec.sample_rate, got_dec.length_frames) \
        == (want_dec.channels, want_dec.sample_rate, want_dec.length_frames)
    while True:
        want = want_dec.read(333, dtype=dtype)
        got = got_dec.read(333, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if want.shape[0] == 0:
            break
    assert got_dec.seek(17) and want_dec.seek(17)
    np.testing.assert_array_equal(got_dec.read(50), want_dec.read(50))


@pytest.mark.parametrize("data", [b"RIFF\x04\x00\x00\x00WAVE",
                                  b"RIFF\x24\x00\x00\x00WAVEfmt \x10\x00",
                                  b"RIFF\x00\x00\x00\x00WAVE"])
def test_truncated_file_errors_as_jax(data):
    with pytest.raises(Exception) as want:
        jwav.WavDecoder(JSource(data))
    with pytest.raises(AudioFormatError) as got:
        twav.WavDecoder(MemorySource(data), device="cpu")
    assert str(got.value) == str(want.value)
    jdec = JaxBatchDecoder([data])
    tdec = BatchDecoder([data], device="cpu")
    assert jdec.decode_all() == tdec.decode_all() == [None]
    assert tdec.errors == jdec.errors


def _batch_streams(kind):
    rng = np.random.default_rng(22 + BITS[kind])
    return [_stream(rng, BITS[kind], ch, frames)
            for ch, frames in ((1, 1000), (2, 777), (1, 1), (2, 4096),
                               (1, 0))]


@pytest.mark.parametrize("output", ["numpy", "device"])
@pytest.mark.parametrize("kind", list(BITS))
def test_batch_groups_match_jax(kind, output):
    """Mono and stereo lanes of one kind, one of them empty and one of a
    single frame: the port's group (one K10 call on the card, the twin
    here) bit-equal to JAX's BatchDecoder with both outputs."""
    streams = _batch_streams(kind)
    jdec = JaxBatchDecoder(streams)
    tdec = BatchDecoder(streams, device="cpu")
    want = jdec.decode_all(output=output)
    got = tdec.decode_all(output=output)
    if output == "device":
        assert [k for k, _ in got.windows()] == ["wav"]
        want, got = want.to_numpy(), got.sync().to_numpy()
    assert tdec.errors == jdec.errors
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    st = tdec.stats
    assert st["windows_by_format"] == {"wav": 1}
    # the payload bytes go up as they are
    assert st["h2d_bytes"] == sum(
        a.size for a in want) * BITS[kind] // 8
    assert st["group_demotions"] == 0


def test_mixed_wav_batch_matches_jax():
    """Every kind at once, a float lane (the per-stream read), the corner
    cases and a truncated lane."""
    cc = _corner_cases()
    streams = [s for k in BITS for s in _batch_streams(k)[:2]] + list(
        cc.values()) + [b"RIFF\x04\x00\x00\x00WAVE"]
    jdec = JaxBatchDecoder(streams)
    tdec = BatchDecoder(streams, device="cpu")
    want = jdec.decode_all()
    got = tdec.decode_all()
    assert tdec.errors == jdec.errors
    assert tdec.errors[-1] is not None
    for a, b in zip(got, want, strict=True):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert tdec.stats["windows_by_format"]["wav"] == 4


def _pcms():
    rng = np.random.default_rng(23)
    return [np.clip(rng.standard_normal((n, ch)) * 0.4, -1.2, 1.2)
            .astype(np.float32)
            for n, ch in ((3000, 2), (1001, 1), (4097, 2), (1, 1))]


FORMATS = ["s8", "s16", "s24", "fp32", "fp64"]


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_wav_batch_matches_jax(fmt, dither):
    pcms = _pcms()
    jopt = JOptions(sample_format=getattr(JFormat, fmt),
                    enable_dither=dither, dither_seed=0xFFFFFFF0)
    topt = EncodingOptions(sample_format=getattr(AudioSampleFormat, fmt),
                           enable_dither=dither, dither_seed=0xFFFFFFF0)
    stats = {}
    got = encode_wav_batch(pcms, 44100, topt, device="cpu", stats=stats)
    assert got == jax_encode(pcms, 44100, jopt)
    assert stats["windows"] == (fmt not in ("fp32", "fp64"))


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("fmt", ["s8", "s16", "s24"])
def test_streaming_encoder_matches_jax(fmt, dither):
    """The single-stream WavEncoder over three writes (each write reseeds
    its dither) byte-equal to JAX's, and to the batch encoder on the
    first write alone."""
    x = _pcms()[0]
    jopt = JOptions(sample_format=getattr(JFormat, fmt),
                    enable_dither=dither, dither_seed=41)
    topt = EncodingOptions(sample_format=getattr(AudioSampleFormat, fmt),
                           enable_dither=dither, dither_seed=41)
    jsink, tsink = JSink(), ByteSink()
    jenc = jwav.WavEncoder(jsink, 44100, 2, jopt)
    tenc = twav.WavEncoder(tsink, 44100, 2, topt, device="cpu")
    for a, b in ((0, 1000), (1000, 1000), (1000, 3000)):
        jenc.write(x[a:b])
        tenc.write(x[a:b])
    jenc.finalize()
    tenc.finalize()
    assert tsink.getvalue() == jsink.getvalue()
    one = ByteSink()
    enc = twav.WavEncoder(one, 44100, 2, topt, device="cpu")
    enc.write(x)
    enc.finalize()
    assert one.getvalue() == encode_wav_batch([x], 44100, topt,
                                              device="cpu")[0]


def test_probe_finds_wav_at_its_place():
    """WAV sits after FLAC and before QOA in the cascade; a RIFF stream
    that is not WAVE is not claimed by it."""
    data = _stream(np.random.default_rng(24), 16, 1, 10)
    assert isinstance(models.probe_all(MemorySource(data), "cpu"),
                      twav.WavDecoder)
    riff = b"RIFF" + struct.pack("<I", 4) + b"AVI "
    assert models.probe_all(MemorySource(riff), "cpu") is None


def test_entry_points_default_to_the_card():
    """encode_wav_batch, the decoder and the encoder default to
    device="cuda" and raise where there is no GPU; nothing falls back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    x = _pcms()[0]
    with pytest.raises(RuntimeError):
        encode_wav_batch([x], 44100, EncodingOptions(
            sample_format=AudioSampleFormat.s16))
    data = _batch_streams("s16")[0]
    with pytest.raises(RuntimeError):
        twav.WavDecoder(MemorySource(data))
    with pytest.raises(RuntimeError):
        BatchDecoder([data])
