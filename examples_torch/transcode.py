#!/usr/bin/env python3
"""Transcode any supported input to WAV or QOA (reference parity:
examples/transcode/source/main.d:12-88).

Decodes in 1024-frame chunks through the streaming API — the same chunked
read contract the reference example exercises — and encodes to 24-bit
dithered WAV by default or QOA with ``-qoa``, both on ``--device``.  With
``--check-seeking`` it additionally runs the reference example's seek test
(main.d:90-162): re-reads windows at random positions and compares them
against the linear decode.

Usage:  python examples_torch/transcode.py [--device cuda|cpu]
            input.{wav,mp3,flac,ogg,opus,qoa,mod,xm}
            output.{wav,qoa} [-qoa] [--check-seeking]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from audio_formats_torch import (AudioFileFormat, AudioSampleFormat,
                                 AudioStream, EncodingOptions)

CHUNK = 1024


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?")
    ap.add_argument("output", nargs="?")
    ap.add_argument("-qoa", action="store_true")
    ap.add_argument("--check-seeking", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.output is None:
        print(__doc__)
        return 1
    inp, outp = args.input, args.output
    want_qoa = args.qoa or outp.endswith(".qoa")

    dec = AudioStream(args.device).open_from_file(inp)
    if dec.is_error():
        print("error:", dec.error_message())
        return 1
    sr = dec.get_samplerate()
    ch = dec.get_num_channels()
    print(f"input: {dec.get_format().value}, {sr:.0f} Hz, {ch} ch")

    if want_qoa:
        enc = AudioStream(args.device).open_to_file(
            outp, AudioFileFormat.qoa, sr, ch)
    else:
        opts = EncodingOptions(sample_format=AudioSampleFormat.s24,
                               enable_dither=True)
        enc = AudioStream(args.device).open_to_file(
            outp, AudioFileFormat.wav, sr, ch, opts)
    if enc.is_error():
        print("error:", enc.error_message())
        return 1

    chunks = []
    total = 0
    while True:
        buf = dec.read_samples_float(CHUNK)
        if buf.shape[0] == 0:
            break
        if args.check_seeking:
            chunks.append(buf.copy())
        enc.write_samples_float(buf)
        total += buf.shape[0]
    enc.flush()
    enc.finalize_encoding()
    print(f"wrote {total} frames -> {outp}")

    if args.check_seeking and total and dec.get_length_in_frames() > 0:
        linear = np.concatenate(chunks)
        rng = np.random.default_rng(1234)
        fails = 0
        for _ in range(16):
            pos = int(rng.integers(0, max(1, total - CHUNK)))
            dec.seek_position(pos)
            win = dec.read_samples_float(min(CHUNK, total - pos))
            if not np.allclose(win, linear[pos : pos + win.shape[0]],
                               atol=1e-6):
                fails += 1
        print(f"seek check: {16 - fails}/16 windows matched")
        return 1 if fails else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
