#!/usr/bin/env python3
"""Dump each pattern of a MOD/XM module to its own WAV file (reference
parity: examples/dump-patterns/source/main.d:11-69).

Seeks to the start of every pattern in playback order, decodes
``frames_remaining_in_pattern`` worth of audio, and writes
``<prefix>-NN.wav``.

Usage:  python examples_torch/dump_patterns.py [--device cuda|cpu] module.{mod,xm} out_prefix
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from audio_formats_torch import AudioFileFormat, AudioStream


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("module", nargs="?")
    ap.add_argument("prefix", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prefix is None:
        print(__doc__)
        return 1
    dec = AudioStream(args.device).open_from_file(args.module)
    if dec.is_error():
        print("error:", dec.error_message())
        return 1
    if not dec.is_module():
        print(f"error: {args.module} is not a module (MOD/XM) stream")
        return 1
    sr = dec.get_samplerate()
    ch = dec.get_num_channels()
    length = dec.get_module_length()
    print(f"{dec.get_format().value}: {dec.count_module_patterns()} "
          f"patterns, order length {length}")
    for pos in range(length):
        if not dec.seek_position(pos, 0):
            print(f"  order {pos}: seek failed")
            continue
        remaining = dec.frames_remaining_in_pattern()
        if remaining <= 0:
            # XM reports -1 (unimplemented in the reference contract);
            # fall back to one full speed-6 pattern estimate
            remaining = int(sr * 0.02) * 6 * dec.rows_in_pattern(
                dec.tell_module_pattern())
        pcm = dec.read_samples_float(remaining)
        out = AudioStream(args.device).open_to_file(
            f"{args.prefix}-{pos:02d}.wav", AudioFileFormat.wav, sr, ch)
        out.write_samples_float(pcm)
        out.finalize_encoding()
        print(f"  order {pos}: {pcm.shape[0]} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
