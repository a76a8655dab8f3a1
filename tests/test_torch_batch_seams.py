"""The seams of the port's BatchDecoder: the orchestrator (parallel/batch.py),
the groups' table and modules (parallel/groups/) and what they share
(parallel/window.py), on the CPU.

A fixed mixed batch, two lanes of each group kind of tests/test_torch_mesh.py
and of MOD and XM, gives for each of the eight formats the device windows,
uploaded bytes and decoded seconds written below: the values the batch
decoder gave before its groups moved into modules of their own (on both
FLAC wires, and with the PCM left on the device, where each group reports
its own seconds).  And a lane fault raised inside the MP3 or packed FLAC
window loop, on the parse pool or on the dispatch worker, leaves no
``af-parse`` or ``af-dispatch`` thread behind ``decode_all``.
"""

import functools
import threading

import pytest

from audio_formats_torch import BatchDecoder
from audio_formats_torch.host import native
from audio_formats_torch.ops import lpc, mp3_huff

from test_torch_mesh import KINDS, assert_lanes_equal, streams
from test_torch_mp3_huff import mp3_stream
from test_torch_trace import _flac_items

FORMATS = ("flac", "mp3", "qoa", "wav", "vorbis", "opus", "mod", "xm")

_SECONDS = {"flac": 0.17199546485260772, "mod": 15.36,
            "mp3": 0.4789115646258503, "opus": 1.4615833333333335,
            "qoa": 0.0419501133786848, "vorbis": 0.029024943310657594,
            "wav": 0.02471655328798186, "xm": 2.972154195011338}
_H2D = {"flac": 73856, "mp3": 17984, "mp3_l12": 294912, "opus": 161160,
        "qoa": 10816, "vorbis": 16640, "wav": 4360}
_WINDOWS = {"flac": 1, "mp3": 1, "mp3_l12": 2, "opus": 11, "opus_silk": 13,
            "qoa": 1, "vorbis": 1, "wav": 1}
#: (FLAC wire, output) -> (windows_by_format, h2d_bytes_by_format,
#: decoded_seconds_by_format) of the batch: the parent's values
WANT = {("packed", "numpy"): (_WINDOWS, _H2D, _SECONDS),
        ("packed", "device"): (_WINDOWS, _H2D, _SECONDS),
        ("rice", "numpy"): (_WINDOWS, dict(_H2D, flac=27648), _SECONDS)}


@functools.lru_cache(maxsize=None)
def _batch():
    return tuple(s for kind in KINDS for s in streams(kind, 2))


@functools.lru_cache(maxsize=None)
def _stats(wire, output):
    items = list(_batch())
    dec = BatchDecoder(items, device="cpu", flac_wire=wire)
    res = dec.decode_all(output=output)
    if output == "device":
        res.sync()
    assert dec.errors == [None] * len(items)
    assert dec.stats["group_demotions"] == 0
    st = dec.stats
    return (st["windows_by_format"], st["h2d_bytes_by_format"],
            st["decoded_seconds_by_format"])


def _of(fmt, by_format):
    """The entries of a by-format dict that belong to format `fmt`
    ("mp3" and "mp3_l12", "opus" and "opus_silk", ...)."""
    return {k: v for k, v in by_format.items() if k.split("_")[0] == fmt}


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_windows_bytes_and_seconds_are_the_parents(fmt):
    for (wire, output), want in WANT.items():
        windows, h2d, seconds = _stats(wire, output)
        assert _of(fmt, windows) == _of(fmt, want[0]), (wire, output)
        assert _of(fmt, h2d) == _of(fmt, want[1]), (wire, output)
        got, exp = _of(fmt, seconds), _of(fmt, want[2])
        assert got.keys() == exp.keys() and exp, (wire, output)
        for k in exp:
            assert got[k] == pytest.approx(exp[k], rel=1e-12, abs=0)


def _once(fn, exc):
    """`fn`, whose first call raises `exc` (a lane fault) instead."""
    calls = []

    def faulty(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise exc
        return fn(*a, **k)
    return faulty


#: (format, where, (module, name) the fault replaces)
FAULTS = [("mp3", "parse", (native, "mp3_parse_window_packed_multi")),
          ("mp3", "dispatch", (mp3_huff, "packed_window")),
          ("flac", "parse", (native, "flac_parse_window_multi")),
          ("flac", "dispatch", (lpc, "flac_lpc"))]


def _window_workers():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("af-dispatch", "af-parse"))]


@pytest.mark.parametrize("fmt,where,target", FAULTS,
                         ids=[f"{f}-{w}" for f, w, _ in FAULTS])
def test_lane_fault_in_window_loop_leaves_no_worker(fmt, where, target,
                                                    monkeypatch):
    """A fault raised inside the window loop (the parse pool's C call, or
    the dispatch worker's device chain) fails the group's first run: the
    lattice bisects and the lanes decode as a clean batch does (FLAC bit
    for bit, MP3 within the mesh tests' TOL of the peak: a row of the CPU
    matmul sums in an order set by its bucket's rows), and the loop's
    workers are gone when decode_all returns."""
    if native.get_lib() is None:
        pytest.skip("the C host stage did not build here")
    items = [mp3_stream(seed, n_frames=60) for seed in (3, 4, 5)] \
        if fmt == "mp3" else _flac_items()
    want = BatchDecoder(items, device="cpu").decode_all()
    assert not _window_workers()
    module, name = target
    monkeypatch.setattr(module, name, _once(
        getattr(module, name), RuntimeError(f"lane fault in the {where}")))
    dec = BatchDecoder(items, device="cpu")
    got = dec.decode_all()
    assert not _window_workers()
    assert dec.stats["group_demotions"] == 1
    assert dec.stats["group_exceptions"] == [
        f"RuntimeError: lane fault in the {where}"]
    assert dec.errors == [None] * len(items)
    assert_lanes_equal(want, got, exact=fmt == "flac")
