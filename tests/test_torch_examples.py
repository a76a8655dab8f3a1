"""The port's examples (examples_torch/) against the JAX package's
(examples/), on the CPU.

Each example runs in this process with ``--device cpu`` on inputs made by
the golden coders (tests/torch_stream_cases.py), and JAX's example runs on
the same inputs: transcode's WAV and QOA outputs, dump_patterns' pattern
files and midi2wav's WAV are byte-equal to JAX's; batch_decode prints the
same line for each stream.  Each exits 0.
"""

import importlib.util
import os
import struct

import pytest

import torch_stream_cases as cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(package, name):
    """examples/<name>.py or examples_torch/<name>.py as a module."""
    path = os.path.join(ROOT, package, name + ".py")
    spec = importlib.util.spec_from_file_location(f"{package}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_both(name, args, tmp_path, capsys, monkeypatch):
    """The port's example with `args` and --device cpu in tmp_path/port,
    then JAX's with the same arguments in tmp_path/jax (outputs named
    relative to each); both must exit 0.  Returns their printed lines."""
    lines = []
    for package, argv in (("examples_torch", [*args, "--device", "cpu"]),
                          ("examples", [name + ".py", *args])):
        cwd = tmp_path / package
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert _example(package, name).main(argv) == 0
        lines.append(capsys.readouterr().out.splitlines())
    return lines


def _same_files(tmp_path, names):
    for n in names:
        port = tmp_path / "examples_torch" / n
        assert port.read_bytes() == (tmp_path / "examples" / n).read_bytes()
    assert sorted(os.listdir(tmp_path / "examples_torch")) == sorted(names)


@pytest.mark.parametrize("kind", ["flac-wav", "mod-wav", "wav-qoa"])
def test_transcode_matches_jax(kind, tmp_path, capsys, monkeypatch):
    """FLAC to dithered s24 WAV with the seek check, a module to WAV (no
    seek check: its length is unknown), and a short mono WAV to QOA."""
    src, dst = kind.split("-")
    data = {"flac": lambda: cases.flac_stream(cases.music_s16(4, 40000),
                                              block_size=1024),
            "mod": lambda: cases.mod_song(4, 1, rows=8),
            "wav": lambda: cases.wav_stream(
                cases.music_s16(5, 11000, channels=1))}[src]()
    inp = tmp_path / f"in.{src}"
    inp.write_bytes(data)
    args = [str(inp), f"out.{dst}"]
    if src == "flac":
        args.append("--check-seeking")
    port, jax = _run_both("transcode", args, tmp_path, capsys, monkeypatch)
    assert port == jax
    _same_files(tmp_path, [f"out.{dst}"])
    if src == "flac":
        assert port[-1] == "seek check: 16/16 windows matched"


@pytest.mark.parametrize("fmt", ["xm", "mod"])
def test_dump_patterns_matches_jax(fmt, tmp_path, capsys, monkeypatch):
    data = cases.xm_song(6, 3, rows=6) if fmt == "xm" else \
        cases.mod_song(6, 3, rows=6)
    inp = tmp_path / f"song.{fmt}"
    inp.write_bytes(data)
    port, jax = _run_both("dump_patterns", [str(inp), "p"], tmp_path,
                          capsys, monkeypatch)
    assert port == jax and len(port) == 4
    _same_files(tmp_path, [f"p-{k:02d}.wav" for k in range(3)])


def test_batch_decode_matches_jax(tmp_path, capsys):
    """One file of each exactly decoded format and a file of garbage: the
    port prints JAX's line for each."""
    files = {
        "a.flac": cases.flac_stream(cases.music_s16(7, 9000),
                                    block_size=1024),
        "b.wav": cases.wav_stream(cases.music_s16(8, 7000)),
        "c.qoa": cases.qoa_stream(cases.music_s16(9, 3000, channels=1)),
        "d.mod": cases.mod_song(7, 1, rows=4),
        "e.xm": cases.xm_song(7, 1, rows=4),
        "f.bin": bytes(range(256)) * 4,
    }
    paths = []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    assert _example("examples_torch", "batch_decode").main(
        [*paths, "--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert _example("examples", "batch_decode").main(paths) == 0
    jax = capsys.readouterr().out.splitlines()
    assert port[:len(paths)] == jax[:len(paths)]
    assert port[len(paths) - 1].endswith(
        "ERROR: Cannot decode stream: unrecognized encoding.")


def _midi():
    """A format-0 MIDI file: a C major arpeggio and a chord, with a tempo
    change, running status and a program change."""
    def var(v):
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append(0x80 | (v & 0x7F))
            v >>= 7
        return bytes(reversed(out))

    trk = bytearray()
    trk += var(0) + b"\xff\x51\x03" + (400000).to_bytes(3, "big")
    trk += var(0) + b"\xc0\x05"
    for k, note in enumerate((60, 64, 67, 72)):
        trk += var(0 if k == 0 else 96) + bytes([0x90, note, 100])
        trk += var(96) + bytes([note, 0])  # running status note-off
    trk += var(0) + bytes([0x90, 60, 90]) + var(0) + bytes([64, 90])
    trk += var(192) + bytes([0x80, 60, 0]) + var(0) + bytes([0x80, 64, 0])
    trk += var(0) + b"\xff\x2f\x00"
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96) + b"MTrk"
            + struct.pack(">I", len(trk)) + bytes(trk))


def test_midi2wav_matches_jax(tmp_path, capsys, monkeypatch):
    (tmp_path / "song.mid").write_bytes(_midi())
    port, jax = _run_both("midi2wav", [str(tmp_path / "song.mid"),
                                       "out.wav"], tmp_path, capsys,
                          monkeypatch)
    assert port == jax == ["rendered 12 events -> out.wav (4.6s)"]
    _same_files(tmp_path, ["out.wav"])
