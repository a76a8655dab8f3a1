"""The port's single-stream facade against the JAX package's, on the CPU.

``audio_formats_torch.AudioStream(device="cpu")`` and
``audio_formats_tpu.AudioStream()`` open the same short stream of each of
the eight formats (tests/torch_stream_cases.py, made from a seed with the
golden coders): from memory, a file and callbacks; reads in chunks of
1,024 frames and of an odd size, in float and double; the metadata; seeks
by frame, and by (pattern, row) for MOD and XM; the sticky error messages.
PCM is bit-equal for FLAC, WAV, QOA, MOD and XM, within 1e-4 max abs for
MP3, 4e-6 of the peak for Vorbis and 1e-5 of the peak for Opus.  The
encoders (WAV in every sample format with and without dither, QOA)
through ``open_to_buffer`` and ``open_to_file``, ``save_as_wav`` and
``to_wav`` give JAX's bytes.  A kernel fault raised inside a device
wrapper comes out of the facade as an exception, never as ``is_error()``.
"""

import functools

import numpy as np
import pytest
import torch

import audio_formats_tpu as jaf

import audio_formats_torch as taf
from audio_formats_torch import (AudioFileFormat, AudioSampleFormat,
                                 AudioStream, EncodingOptions)
from audio_formats_torch.ops import lms, lpc, pcm
from audio_formats_torch.ops._kernels import KernelError

from golden import opus_ref, vorbis_ref
from test_torch_mp3_huff import mp3_stream

import torch_opus_cases
import torch_stream_cases as cases

FORMATS = ("flac", "wav", "qoa", "mp3", "vorbis", "opus", "mod", "xm")
#: the bound of each transform codec against JAX's PCM: (tolerance,
#: relative to the peak); the others are bit-equal
TOL = {"mp3": (1e-4, False), "vorbis": (4e-6, True), "opus": (1e-5, True)}
CHUNK = 1024


@functools.lru_cache(maxsize=None)
def stream(fmt):
    """A short stream of `fmt` (at most ~3 s of audio)."""
    if fmt == "flac":
        return cases.flac_stream(cases.music_s16(1, 66150), block_size=1024)
    if fmt == "wav":
        return cases.wav_stream(cases.music_s16(2, 50000))
    if fmt == "qoa":
        return cases.qoa_stream(cases.music_s16(3, 18000, channels=1))
    if fmt == "mp3":
        return mp3_stream(1, n_frames=60)
    if fmt == "vorbis":
        return cases.vorbis_stream(vorbis_ref, 1, 50)
    if fmt == "opus":
        return torch_opus_cases.stream(opus_ref.build_ogg_opus,
                                       torch_opus_cases.load()[0], 100)
    if fmt == "mod":
        return cases.mod_song(1, 2, rows=12)
    return cases.xm_song(1, 2, rows=12)


def read_all(s, chunk=CHUNK, double=False):
    """Every frame of stream `s`, read in chunks of `chunk`."""
    read = s.read_samples_double if double else s.read_samples_float
    parts = []
    while True:
        c = np.asarray(read(chunk))
        if c.shape[0] == 0:
            break
        parts.append(c)
    assert not s.is_error(), s.error_message()
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def jax_pcm(fmt, double=False):
    return read_all(_jax_open(fmt), double=double)


def _jax_open(fmt):
    s = jaf.AudioStream().open_from_memory(stream(fmt))
    assert not s.is_error(), s.error_message()
    return s


def _open(fmt):
    s = AudioStream("cpu").open_from_memory(stream(fmt))
    assert not s.is_error(), s.error_message()
    return s


def assert_close(fmt, got, want):
    """The port's PCM against JAX's at `fmt`'s bound."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if fmt not in TOL:
        np.testing.assert_array_equal(got, want)
        return
    tol, rel = TOL[fmt]
    err = np.abs(got - want).max() if got.size else 0.0
    if rel:
        err /= np.abs(want).max() + 1e-9
    assert err < tol, (fmt, err)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reads_in_chunks_match_jax(fmt):
    """1,024-frame reads equal JAX's, and so do reads of an odd size,
    which give the same frames (XM pads its last read with silence to the
    size asked, as the reference does); double reads are held to JAX's
    double reads."""
    got = read_all(_open(fmt))
    assert_close(fmt, got, jax_pcm(fmt))
    odd = read_all(_open(fmt), chunk=777)
    assert_close(fmt, odd, read_all(_jax_open(fmt), chunk=777))
    n = min(len(odd), len(got))
    assert n >= len(got) - CHUNK
    np.testing.assert_array_equal(odd[:n], got[:n])
    assert_close(fmt, read_all(_open(fmt), double=True),
                 jax_pcm(fmt, double=True))


@pytest.mark.parametrize("fmt", FORMATS)
def test_open_from_file_and_callbacks(fmt, tmp_path):
    """A file and a callback source decode as memory does."""
    want = read_all(_open(fmt), chunk=4096)
    path = tmp_path / f"in.{fmt}"
    path.write_bytes(stream(fmt))
    with AudioStream("cpu").open_from_file(str(path)) as s:
        np.testing.assert_array_equal(read_all(s, chunk=4096), want)
    data = stream(fmt)
    pos = [0]

    def read(n):
        out = data[pos[0]: pos[0] + n]
        pos[0] += len(out)
        return out

    def seek(off, whence=0):
        pos[0] = off if whence == 0 else pos[0] + off

    s = AudioStream("cpu").open_with_callbacks(read, seek, lambda: len(data))
    np.testing.assert_array_equal(read_all(s, chunk=4096), want)
    s.close()
    assert s.is_error() and not s.is_open_for_reading()


@pytest.mark.parametrize("fmt", FORMATS)
def test_metadata_matches_jax(fmt):
    t, j = _open(fmt), _jax_open(fmt)
    assert t.get_format().value == j.get_format().value == \
        {"vorbis": "ogg"}.get(fmt, fmt)
    for name in ("get_num_channels", "get_samplerate",
                 "get_length_in_frames", "is_module", "can_seek",
                 "realtime_safe", "is_open_for_reading",
                 "is_open_for_writing", "tell_position",
                 "count_module_patterns", "get_module_length"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.is_module() == (fmt in ("mod", "xm"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_seek_and_tell_match_jax(fmt):
    """Seeks by frame (rejected for modules), or by (pattern, row) for
    MOD and XM, answer as JAX's do; the frames read after each equal
    JAX's at the format's bound, and tell_position follows."""
    t, j = _open(fmt), _jax_open(fmt)
    n = len(jax_pcm(fmt))
    if fmt in ("mod", "xm"):
        assert not t.seek_position(100) and not j.seek_position(100)
        seeks = [(1, 0), (0, 5), (1, 11), (0, 0), (7, 0)]
    else:
        seeks = [(n // 3,), (5,), (n - 100,), (0,), (n + 10,), (-1,)]
    for args in seeks:
        assert t.seek_position(*args) == j.seek_position(*args), args
        assert t.tell_position() == j.tell_position(), args
        if fmt in ("mod", "xm"):
            assert t.tell_module_pattern() == j.tell_module_pattern()
            assert t.tell_module_row() == j.tell_module_row()
        assert_close(fmt, t.read_samples_float(1500),
                     np.asarray(j.read_samples_float(1500)))
        assert t.tell_position() == j.tell_position(), args
    assert not t.is_error()


def _garbage():
    return bytes(np.random.default_rng(7).integers(0, 256, 3000, np.uint8))


def _negative(s):
    s.open_from_memory(stream("wav"))
    return s.read_samples_float(-1).shape


def _write_on_decoder(s):
    s.open_from_memory(stream("wav"))
    return s.write_samples_float(np.zeros((10, 2), np.float32))


def _closed(s):
    s.open_from_memory(stream("flac"))
    s.close()
    return (s.read_samples_float(100).shape, s.tell_position(),
            s.seek_position(0))


def _unknown(s):
    s.open_from_memory(_garbage())
    return s.read_samples_float(100).shape, s.get_num_channels()


def _encode_mp3(s):
    return s.open_to_buffer("mp3", 44100, 2).is_open_for_writing()


def _wrong_channels(s):
    s.open_to_buffer("wav", 44100, 2)
    return s.write_samples_float(np.zeros((10, 3), np.float32))


def _missing_file(s):
    return s.open_from_file("/nonexistent/audio.flac").is_open_for_reading()


@pytest.mark.parametrize("case", [_unknown, _negative, _write_on_decoder,
                                  _closed, _encode_mp3, _wrong_channels,
                                  _missing_file],
                         ids=lambda f: f.__name__.strip("_"))
def test_sticky_errors_match_jax(case):
    """Each misuse answers as JAX's facade does, with the same sticky
    error message, and raises nothing."""
    t, j = AudioStream("cpu"), jaf.AudioStream()
    assert t.error_message() == j.error_message() == "Stream not initialized"
    assert case(t) == case(j)
    assert t.is_error() == j.is_error()
    assert t.error_message() == j.error_message()


def _pcm(frames, channels, seed=4):
    rng = np.random.default_rng(seed)
    x = 0.7 * np.sin(2 * np.pi * 330 * np.arange(frames)[:, None] / 44100
                     * np.arange(1, channels + 1))
    return (x + 0.05 * rng.standard_normal((frames, channels)))\
        .astype(np.float32)


def _encode(mod, fmt, x, options, path=None, chunk=3000, finalize=True):
    """x written in chunks through `mod`'s AudioStream; the encoded bytes."""
    s = mod.AudioStream(**({} if mod is jaf else {"device": "cpu"}))
    if path is None:
        s.open_to_buffer(fmt, 44100, x.shape[1], options)
    else:
        s.open_to_file(str(path), fmt, 44100, x.shape[1], options)
    assert s.is_open_for_writing(), s.error_message()
    for k in range(0, len(x), chunk):
        assert s.write_samples_float(x[k: k + chunk]) == \
            len(x[k: k + chunk])
    if not finalize:
        s.close()
        return path.read_bytes()
    if path is None:
        return s.finalize_and_get_encoded_result()
    assert s.finalize_encoding()
    return path.read_bytes()


def _options(mod, sample_format, dither):
    return mod.EncodingOptions(
        sample_format=mod.AudioSampleFormat[sample_format],
        enable_dither=dither, dither_seed=0xBEEF)


@pytest.mark.parametrize("dither", [True, False])
@pytest.mark.parametrize("sample_format", [f.value for f in
                                           AudioSampleFormat])
def test_wav_encode_matches_jax(sample_format, dither, tmp_path):
    """WAV through open_to_buffer and open_to_file, written in chunks (the
    dither's seed advances a write), byte-equal to JAX's."""
    x = _pcm(7001, 2)
    want = _encode(jaf, jaf.AudioFileFormat.wav, x,
                   _options(jaf, sample_format, dither))
    opts = _options(taf, sample_format, dither)
    assert _encode(taf, AudioFileFormat.wav, x, opts) == want
    assert _encode(taf, AudioFileFormat.wav, x, opts,
                   path=tmp_path / "out.wav") == want


def test_qoa_encode_matches_jax(tmp_path):
    """QOA through open_to_buffer and open_to_file, and a stream closed
    unfinalized (close finalizes it), byte-equal to JAX's."""
    x = _pcm(11000, 1)
    want = _encode(jaf, jaf.AudioFileFormat.qoa, x, None)
    assert _encode(taf, AudioFileFormat.qoa, x, None) == want
    assert _encode(taf, "qoa", x, None, path=tmp_path / "a.qoa") == want
    assert _encode(taf, AudioFileFormat.qoa, x, None,
                   path=tmp_path / "b.qoa", finalize=False) == want


@pytest.mark.parametrize("interleaved", [False, True])
def test_save_as_wav_and_to_wav_match_jax(interleaved, tmp_path):
    x = _pcm(5000, 2)
    arg = x.reshape(-1) if interleaved else x
    for opts in (None, (AudioSampleFormat.s16, True),
                 (AudioSampleFormat.s24, False)):
        jo = to = None
        if opts is not None:
            jo = _options(jaf, opts[0].value, opts[1])
            to = _options(taf, opts[0].value, opts[1])
        want = jaf.to_wav(arg, 48000, 2, jo)
        assert taf.to_wav(arg, 48000, 2, to, device="cpu") == want
        taf.save_as_wav(arg, tmp_path / "t.wav", 48000, 2, to, device="cpu")
        jaf.save_as_wav(arg, tmp_path / "j.wav", 48000, 2, jo)
        assert (tmp_path / "t.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes() == want


def test_surface_matches_jax():
    """The port's package exports JAX's names, and its AudioStream has
    every public name and camelCase alias of JAX's."""
    assert set(jaf.__all__) <= set(taf.__all__)
    public = [n for n in dir(jaf.AudioStream) if not n.startswith("_")]
    for name in public:
        # an alias names the same function as JAX's alias does
        assert getattr(AudioStream, name).__name__ == \
            getattr(jaf.AudioStream, name).__name__, name


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for make in (lambda: AudioStream(),
                 lambda: AudioStream(device="cuda"),
                 lambda: taf.to_wav(np.zeros((4, 1), np.float32))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def _fail(*args, **kwargs):
    raise KernelError("kernel launch failed: CUDA error 700")


def _read_flac(s):
    s.open_from_memory(stream("flac"))
    s.read_samples_float(CHUNK)


def _read_wav(s):
    s.open_from_memory(stream("wav"))
    s.read_samples_float(CHUNK)


def _read_qoa(s):
    s.open_from_memory(stream("qoa"))
    s.read_samples_float(CHUNK)


def _write_wav(s):
    s.open_to_buffer(AudioFileFormat.wav, 44100, 1,
                     EncodingOptions(sample_format=AudioSampleFormat.s16))
    s.write_samples_float(np.zeros((100, 1), np.float32))


def _finalize_qoa(s):
    s.open_to_buffer(AudioFileFormat.qoa, 44100, 1)
    s.write_samples_float(np.zeros((100, 1), np.float32))
    s.finalize_encoding()


def _close_qoa(s):
    s.open_to_buffer(AudioFileFormat.qoa, 44100, 1)
    s.write_samples_float(np.zeros((100, 1), np.float32))
    s.close()


@pytest.mark.parametrize("module,fn,call", [
    (lpc, "flac_lpc", _read_flac), (pcm, "decode_bytes", _read_wav),
    (lms, "decode_slices", _read_qoa),
    (pcm, "quantize_pack_rows", _write_wav),
    (lms, "qoa_encode_frame_scan", _finalize_qoa),
    (lms, "qoa_encode_frame_scan", _close_qoa)],
    ids=["K1-read", "K10-read", "K2-read", "K10-write", "K5-finalize",
         "K5-close"])
def test_kernel_error_raises_out_of_the_facade(module, fn, call,
                                               monkeypatch):
    """A kernel that does not build, load or launch is a fault of the
    program, not of the stream: it raises out of the facade call, and the
    stream is not marked in error by it."""
    monkeypatch.setattr(module, fn, _fail)
    s = AudioStream("cpu")
    with pytest.raises(KernelError, match="CUDA error 700"):
        call(s)
    assert s.error_message() in (None, "Stream not initialized")
