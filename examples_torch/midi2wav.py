#!/usr/bin/env python3
"""Render a standard MIDI file to WAV with a small FM synthesizer
(reference parity: examples/midi2wav/source/main.d:27-134, which drives a
vendored OPL3 emulator — explicitly NOT part of the library per the
reference's layout; this example likewise keeps the synth out of the
package and only demonstrates the WAV encode path).

The synth here is a simple 2-operator FM voice (sine modulator+carrier,
exponential envelope) rather than an OPL3 gate-level emulation.

Usage:  python examples_torch/midi2wav.py [--device cuda|cpu] song.mid out.wav
"""

import argparse
import struct
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from audio_formats_torch import AudioFileFormat, AudioStream

SR = 44100


def read_varlen(data, i):
    v = 0
    while True:
        b = data[i]
        i += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, i


def parse_midi(data):
    """Returns a list of (time_seconds, on/off, channel, note, velocity)."""
    assert data[:4] == b"MThd"
    ntrk = struct.unpack(">H", data[10:12])[0]
    division = struct.unpack(">H", data[12:14])[0]
    i = 14
    events = []
    for _ in range(ntrk):
        assert data[i : i + 4] == b"MTrk"
        ln = struct.unpack(">I", data[i + 4 : i + 8])[0]
        j = i + 8
        end = j + ln
        t = 0
        status = 0
        tempo = 500000
        abs_events = []
        while j < end:
            dt, j = read_varlen(data, j)
            t += dt
            b = data[j]
            if b & 0x80:
                status = b
                j += 1
            ev = status & 0xF0
            chn = status & 0x0F
            if ev in (0x80, 0x90):
                note, vel = data[j], data[j + 1]
                j += 2
                on = ev == 0x90 and vel > 0
                abs_events.append((t, on, chn, note, vel, None))
            elif ev in (0xA0, 0xB0, 0xE0):
                j += 2
            elif ev in (0xC0, 0xD0):
                j += 1
            elif status == 0xFF:
                meta = data[j]
                ln2, j2 = read_varlen(data, j + 1)
                if meta == 0x51:
                    tempo = int.from_bytes(data[j2 : j2 + 3], "big")
                    abs_events.append((t, None, None, None, None, tempo))
                j = j2 + ln2
            elif status in (0xF0, 0xF7):
                ln2, j2 = read_varlen(data, j)
                j = j2 + ln2
            else:
                j += 1
        events.append(abs_events)
        i = end
    # merge, convert ticks to seconds with tempo map
    merged = sorted([e for tr in events for e in tr], key=lambda e: e[0])
    out = []
    tempo = 500000
    last_tick = 0
    last_time = 0.0
    for e in merged:
        tick = e[0]
        last_time += (tick - last_tick) * tempo / 1e6 / division
        last_tick = tick
        if e[5] is not None:
            tempo = e[5]
        elif e[2] != 9:  # skip percussion channel
            out.append((last_time, e[1], e[2], e[3], e[4]))
    return out


def render(events, tail=1.0):
    if not events:
        return np.zeros((SR, 2), np.float32)
    dur = events[-1][0] + tail
    n = int(dur * SR) + 1
    out = np.zeros(n, np.float64)
    # pair note-on/off per (channel, note)
    active = {}
    notes = []
    for t, on, ch, note, vel in events:
        if on:
            active[(ch, note)] = (t, vel)
        else:
            st = active.pop((ch, note), None)
            if st:
                notes.append((st[0], t, note, st[1]))
    for (ch, note), (t, vel) in active.items():
        notes.append((t, events[-1][0], note, vel))
    for t0, t1, note, vel in notes:
        f = 440.0 * 2 ** ((note - 69) / 12.0)
        m = int((t1 - t0 + 0.4) * SR)
        i0 = int(t0 * SR)
        m = min(m, n - i0)
        if m <= 0:
            continue
        tt = np.arange(m) / SR
        env = np.exp(-3.0 * tt) * np.minimum(1.0, tt * 200)
        gate = tt < (t1 - t0)
        env = env * np.where(gate, 1.0, np.exp(-20.0 * (tt - (t1 - t0))))
        mod = np.sin(2 * np.pi * f * 2.001 * tt) * 1.5 * np.exp(-2.0 * tt)
        out[i0 : i0 + m] += (vel / 127.0) * 0.2 * env * np.sin(
            2 * np.pi * f * tt + mod)
    peak = np.abs(out).max() + 1e-9
    out = (out / max(1.0, peak / 0.9)).astype(np.float32)
    return np.stack([out, out], 1)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("midi", nargs="?")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.output is None:
        print(__doc__)
        return 1
    with open(args.midi, "rb") as f:
        events = parse_midi(f.read())
    pcm = render(events)
    enc = AudioStream(args.device).open_to_file(
        args.output, AudioFileFormat.wav, float(SR), 2)
    enc.write_samples_float(pcm)
    enc.finalize_encoding()
    print(f"rendered {len(events)} events -> {args.output} "
          f"({pcm.shape[0] / SR:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
