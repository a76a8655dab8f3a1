"""The port's FastTracker II XM engine against the JAX package's, on the
CPU.

A twin of every test of tests/test_xm.py: each runs the same module
through JAX's ``AudioStream`` and the port's ``AudioStream(device="cpu")``,
holds the PCM bit-equal and the module API's answers equal, and checks
what the reference test checks on the port's output.  The vectorised
mixer is held to its scalar reference loop in the port as in JAX, and the
XM_LINEAR_INTERPOLATION switch on the port's own ``DEFAULT_CODEC_CONFIG``.
"""

import numpy as np
import pytest

from audio_formats_tpu import AudioStream as JaxStream
from audio_formats_tpu.config import DEFAULT_CODEC_CONFIG as JCONFIG
from audio_formats_tpu.io.source import MemorySource as JSource
from audio_formats_tpu.models.xm import XmDecoder as JXmDecoder

from audio_formats_torch import AudioFileFormat, AudioStream
from audio_formats_torch.config import DEFAULT_CODEC_CONFIG
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models.xm import XmDecoder

from golden import xm_ref
from test_xm import _simple_xm, _square_sample


def _open(data):
    """The JAX and port facades on `data`, both opened as XM."""
    j = JaxStream().open_from_memory(data)
    t = AudioStream("cpu").open_from_memory(data)
    assert not t.is_error(), t.error_message()
    assert not j.is_error(), j.error_message()
    assert t.get_format() == AudioFileFormat.xm
    return j, t


def _read(j, t, frames):
    """`frames` read from both; bit-equal; the port's read."""
    a, b = j.read_samples_float(frames), t.read_samples_float(frames)
    assert b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    return b


def test_probe_and_metadata():
    j, t = _open(_simple_xm())
    for name in ("get_samplerate", "get_num_channels", "get_length_in_frames",
                 "is_module", "count_module_patterns", "get_module_length",
                 "frames_remaining_in_pattern"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.get_samplerate() == 44100.0
    assert t.get_num_channels() == 2
    assert t.get_length_in_frames() == -1
    assert t.is_module()
    assert t.count_module_patterns() == t.get_module_length() == 1
    assert t.rows_in_pattern(0) == j.rows_in_pattern(0) == 16
    assert t.rows_in_pattern(5) == j.rows_in_pattern(5) == -1
    assert t.frames_remaining_in_pattern() == -1


def test_renders_and_stops_after_loop():
    j, t = _open(_simple_xm())
    total = 0
    for _ in range(100):
        c = _read(j, t, 8192)
        if c.shape[0] == 0:
            break
        total += c.shape[0]
    assert total >= 16 * 6 * 882
    assert _read(j, t, 100).shape[0] == 0


def test_tone_pitch_linear():
    j, t = _open(_simple_xm(notes=((0, 49),)))
    y = _read(j, t, 30000)[2000:28000, 0]
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freq = (np.argmax(spec[5:]) + 5) * 44100 / len(y)
    expect = 8363.0 / 32
    assert abs(freq - expect) / expect < 0.03, (freq, expect)


def test_volume_effect_and_key_off():
    loud = _read(*_open(_simple_xm(fx=((0, 0, 0xC, 0x40),))), 8000)
    quiet = _read(*_open(_simple_xm(fx=((0, 0, 0xC, 0x10),))), 8000)
    assert np.abs(quiet[3000:]).max() < np.abs(loud[3000:]).max() * 0.5
    cut = _read(*_open(_simple_xm(notes=((0, 49), (4, 97)))), 44100)
    assert np.abs(cut[30000:]).max() < 1e-4


def test_volume_envelope_decay_and_fadeout():
    env = {"points": [(0, 64), (40, 0)], "sustain_on": False}
    data = _simple_xm(notes=((0, 49),), vol_env=env, fadeout=2000, rows=32)
    y = _read(*_open(data), 60000)[:, 0]
    assert np.abs(y[40000:50000]).max() < np.abs(y[1000:5000]).max() * 0.2


def test_arpeggio_and_portamento_smoke():
    data = _simple_xm(
        rows=32, notes=((0, 49),),
        fx=tuple((r, 0, 0x0, 0x37) for r in range(1, 8))
        + tuple((r, 0, 0x1, 0x08) for r in range(8, 16)))
    y = _read(*_open(data), 70000)
    assert np.abs(y).max() > 0.01
    assert np.all(np.isfinite(y))


def test_pattern_jump_and_seek():
    pat0 = xm_ref.empty_rows(8, 4)
    pat0[0][0] = xm_ref.cell(note=49, instr=1)
    pat1 = xm_ref.empty_rows(8, 4)
    pat1[0][0] = xm_ref.cell(note=61, instr=1)
    data = xm_ref.build_xm([pat0, pat1], [0, 1],
                           [{"samples": [_square_sample()]}], channels=4)
    j, t = _open(data)
    _read(j, t, 8 * 6 * 882 + 100)
    assert t.tell_module_pattern() == j.tell_module_pattern()
    assert t.tell_module_pattern() >= 1
    assert t.seek_position(1, 4) and j.seek_position(1, 4)
    assert t.tell_module_pattern() == 1
    assert t.tell_module_row() == j.tell_module_row()
    assert t.tell_module_row() >= 4
    _read(j, t, 4000)
    assert not t.seek_position(500)


def test_16bit_sample_and_amiga_frequencies():
    data16 = (np.sin(2 * np.pi * np.arange(64) / 64) * 20000)\
        .astype(np.int16)
    ins = [{"samples": [{
        "data": data16, "volume": 64, "loop_type": 1, "loop_start": 0,
        "loop_len": 64, "relative_note": 0, "bits": 16,
    }]}]
    pat = xm_ref.empty_rows(8, 4)
    pat[0][0] = xm_ref.cell(note=49, instr=1)
    data = xm_ref.build_xm([pat], [0], ins, channels=4, linear=False)
    y = _read(*_open(data), 20000)
    assert np.abs(y).max() > 0.01
    assert np.all(np.isfinite(y))


def test_not_an_xm_rejected():
    data = b"Extended Nodule: " + b"\0" * 100
    t = AudioStream("cpu").open_from_memory(data)
    assert t.is_error()
    assert t.error_message() == JaxStream().open_from_memory(data)\
        .error_message()


@pytest.mark.parametrize("loop_type,ls,ll,note", [
    (0, 0, 64, 52), (1, 8, 48, 60), (2, 8, 48, 52), (2, 20, 10, 45)])
def test_vectorized_mixer_matches_scalar(loop_type, ls, ll, note):
    """The port's vectorised per-segment mixer reproduces its per-sample
    reference loop exactly for every loop type (ping-pong phase
    reflection, notes starting below loop_start), and both equal JAX's."""
    wave = (np.sin(2 * np.pi * np.arange(64) / 64) * 120).astype(np.int8)
    instr = {"samples": [{"data": wave, "volume": 64, "finetune": 0,
                          "loop_type": loop_type, "loop_start": ls,
                          "loop_len": ll, "panning": 100,
                          "relative_note": 0, "bits": 8}],
             "sample_of_notes": [0] * 96, "vol_env": None, "fadeout": 512}
    rows = [[(note, 1, 0, 0, 0)]] + [[(0, 0, 0, 0, 0)] for _ in range(15)]
    data = xm_ref.build_xm([rows], [0], [instr], channels=1)
    v = _read(*_open(data), 20000)
    d = XmDecoder(MemorySource(data), "cpu")
    d._chan_segment = d._chan_segment_scalar
    np.testing.assert_array_equal(d.read(20000), v)


def test_tell_position_tracks_module_playback():
    j, t = _open(_simple_xm(rows=32))
    assert t.tell_position() == 0
    a = _read(j, t, 777)
    assert t.tell_position() == j.tell_position() == len(a)
    assert t.seek_position(0, 0) and j.seek_position(0, 0)
    assert t.tell_position() == 0
    b = _read(j, t, 128)
    assert t.tell_position() == j.tell_position() == len(b)


def test_linear_interpolation_switch():
    """XM_LINEAR_INTERPOLATION (libxm.d:50): off by default; on, the
    vectorised mixer equals JAX's, is within 1e-6 of the scalar loop (as
    JAX's test holds its own), and differs from nearest; the port's own
    DEFAULT_CODEC_CONFIG plumbs through."""
    data = _simple_xm(rows=16, notes=((0, 47),))

    d0 = XmDecoder(MemorySource(data), "cpu")
    assert d0.linear_interpolation is False
    out_nearest = d0.read(16000)
    np.testing.assert_array_equal(out_nearest,
                                  JXmDecoder(JSource(data)).read(16000))

    d1 = XmDecoder(MemorySource(data), "cpu")
    d1.linear_interpolation = True
    out_lin = d1.read(16000)
    j1 = JXmDecoder(JSource(data))
    j1.linear_interpolation = True
    np.testing.assert_array_equal(out_lin, j1.read(16000))
    assert np.abs(out_lin - out_nearest).max() > 1e-4

    d2 = XmDecoder(MemorySource(data), "cpu")
    d2.linear_interpolation = True
    d2._chan_segment = d2._chan_segment_scalar
    np.testing.assert_allclose(out_lin, d2.read(16000), atol=1e-6)

    DEFAULT_CODEC_CONFIG.xm_linear_interpolation = True
    try:
        assert JCONFIG.xm_linear_interpolation is False
        d3 = XmDecoder(MemorySource(data), "cpu")
        assert d3.linear_interpolation is True
        np.testing.assert_array_equal(d3.read(16000), out_lin)
    finally:
        DEFAULT_CODEC_CONFIG.xm_linear_interpolation = False


def test_envelope_loop_indices_out_of_range():
    """Corrupt sustain and loop point indices clamp at load: the module
    opens and plays, equal to JAX's."""
    data = _simple_xm(vol_env={
        "points": [(0, 64), (16, 32), (32, 0)],
        "sustain_on": True, "sustain": 250,
        "loop_on": True, "loop_start": 200, "loop_end": 255,
    }, fadeout=1024)
    assert np.isfinite(_read(*_open(data), 2000)).all()


def test_envelope_values_out_of_range_clamped():
    """Envelope values past 64 clamp at load: finite output at unity
    envelope volume, equal to JAX's."""
    data = _simple_xm(vol_env={
        "points": [(0, 60000), (16, 65535), (32, 64)],
        "sustain_on": False, "loop_on": False,
    }, fadeout=0)
    out = _read(*_open(data), 2000)
    assert np.isfinite(out).all()
    assert np.abs(out).max() <= 1.0 + 1e-6
