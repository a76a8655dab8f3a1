"""The port's ProTracker MOD engine against the JAX package's, on the CPU.

A twin of every test of tests/test_mod.py: each runs the same module
through JAX's ``AudioStream`` and the port's ``AudioStream(device="cpu")``,
holds the PCM bit-equal and the module API's answers equal, and checks
what the reference test checks on the port's output.  The AF_LINEAR
switch is held on the port's own ``DEFAULT_CODEC_CONFIG``.
"""

import numpy as np

from audio_formats_tpu import AudioStream as JaxStream
from audio_formats_tpu.config import DEFAULT_CODEC_CONFIG as JCONFIG
from audio_formats_tpu.io.source import MemorySource as JSource
from audio_formats_tpu.models.mod import ModDecoder as JModDecoder

from audio_formats_torch import AudioFileFormat, AudioStream
from audio_formats_torch.config import DEFAULT_CODEC_CONFIG
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models.mod import ModDecoder

from golden import mod_ref
from test_mod import _simple_mod


def _open(data):
    """The JAX and port facades on `data`, both opened as MOD."""
    j = JaxStream().open_from_memory(data)
    t = AudioStream("cpu").open_from_memory(data)
    assert not t.is_error(), t.error_message()
    assert not j.is_error(), j.error_message()
    assert t.get_format() == AudioFileFormat.mod
    return j, t


def _read(j, t, frames):
    """`frames` read from both; bit-equal; the port's read."""
    a, b = j.read_samples_float(frames), t.read_samples_float(frames)
    assert b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    return b


def _read_to_end(j, t, chunk):
    total = 0
    while True:
        c = _read(j, t, chunk)
        if c.shape[0] == 0:
            return total
        total += c.shape[0]
        assert total < 44100 * 60, "did not stop after one loop"


def test_probe_and_metadata():
    j, t = _open(_simple_mod())
    for name in ("get_samplerate", "get_num_channels", "get_length_in_frames",
                 "is_module", "count_module_patterns", "get_module_length"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.get_samplerate() == 44100.0
    assert t.get_num_channels() == 2
    assert t.get_length_in_frames() == -1
    assert t.is_module()
    assert t.count_module_patterns() == t.get_module_length() == 1
    assert t.rows_in_pattern(0) == j.rows_in_pattern(0) == 64


def test_renders_finite_and_stops_after_loop():
    j, t = _open(_simple_mod())
    total = _read_to_end(j, t, 44100)
    assert abs(total - 64 * 6 * 882) < 2000
    assert not t.is_error()


def test_pitch_of_rendered_tone():
    j, t = _open(_simple_mod(periods=(428,)))
    y = _read(j, t, 44100)[:, 0]
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freq = (np.argmax(spec[10:]) + 10) * 44100 / len(y)
    expect = 3546894.6 / 428 / 64
    assert abs(freq - expect) / expect < 0.02, (freq, expect)


def test_volume_effect():
    loud = _read(*_open(_simple_mod(effect=0xC, param=0x40)), 20000)
    quiet = _read(*_open(_simple_mod(effect=0xC, param=0x10)), 20000)
    assert np.abs(quiet).max() < np.abs(loud).max() * 0.5


def test_speed_effect_changes_pattern_duration():
    total = _read_to_end(*_open(_simple_mod(effect=0xF, param=3)), 44100)
    assert abs(total - 64 * 3 * 882) < 3000, total


def test_chunked_equals_whole():
    data = _simple_mod(periods=(428, 381, 320))
    whole = _read(*_open(data), 10 ** 6)
    j, t = _open(data)
    parts = []
    while True:
        c = _read(j, t, 777)
        if c.shape[0] == 0:
            break
        parts.append(c)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_pattern_row_tracking_and_remaining():
    j, t = _open(_simple_mod())
    rem0 = t.frames_remaining_in_pattern()
    assert rem0 == j.frames_remaining_in_pattern()
    assert abs(rem0 - 64 * 6 * 882) <= 64 * 6 * 882 * 0.02
    _read(j, t, 6 * 882 * 4)
    for name in ("tell_module_row", "tell_module_pattern",
                 "frames_remaining_in_pattern"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.tell_module_row() >= 3
    assert t.tell_module_pattern() == 0
    assert t.frames_remaining_in_pattern() < rem0


def test_seek_pattern_row():
    j, t = _open(_simple_mod())
    assert t.seek_position(0, 32) and j.seek_position(0, 32)
    _read(j, t, 6 * 882 * 2)
    assert t.tell_module_row() == j.tell_module_row()
    assert t.tell_module_row() >= 32
    assert not t.seek_position(100)


def test_not_a_mod_rejected():
    data = bytes(range(256)) * 10
    t = AudioStream("cpu").open_from_memory(data)
    assert t.is_error()
    assert t.error_message() == JaxStream().open_from_memory(data)\
        .error_message()


def test_tell_position_tracks_module_playback():
    j, t = _open(_simple_mod(periods=(428, 320), n_orders=2))
    assert t.tell_position() == 0
    a = _read(j, t, 1000)
    assert t.tell_position() == j.tell_position() == len(a) == 1000
    b = _read(j, t, 500)
    assert t.tell_position() == 1000 + len(b)
    assert t.seek_position(0, 0) and j.seek_position(0, 0)
    assert t.tell_position() == 0
    c = _read(j, t, 64)
    assert t.tell_position() == j.tell_position() == len(c)


def test_af_linear_resampling_switch():
    """AF_LINEAR (pocketmod.d:694-700): nearest by default; the linear mix
    differs from nearest on fractional increments; each equals JAX's; the
    port's own DEFAULT_CODEC_CONFIG plumbs through."""
    pat = mod_ref.empty_pattern()
    pat[0][0] = mod_ref.cell(sample=1, period=428, effect=0, param=0)
    data = mod_ref.build_mod(
        [pat], [0], [(mod_ref.saw_sample(64), 64, 0, 0, 64)])

    d0 = ModDecoder(MemorySource(data), "cpu")
    assert d0.linear_resampling is False
    out_nearest = d0.read(8000)
    np.testing.assert_array_equal(out_nearest,
                                  JModDecoder(JSource(data)).read(8000))

    d1 = ModDecoder(MemorySource(data), "cpu")
    d1.linear_resampling = True
    out_lin = d1.read(8000)
    j1 = JModDecoder(JSource(data))
    j1.linear_resampling = True
    np.testing.assert_array_equal(out_lin, j1.read(8000))
    assert np.abs(out_lin - out_nearest).max() > 1e-6

    DEFAULT_CODEC_CONFIG.mod_linear_resampling = True
    try:
        assert JCONFIG.mod_linear_resampling is False
        d2 = ModDecoder(MemorySource(data), "cpu")
        assert d2.linear_resampling is True
        np.testing.assert_array_equal(d2.read(8000), out_lin)
    finally:
        DEFAULT_CODEC_CONFIG.mod_linear_resampling = False
