#!/usr/bin/env python3
"""Batched decode on one torch device — the API this framework adds over
the reference.

The reference is strictly single-stream (stream.d:31-33); its "batch" is a
shell loop around examples/transcode (main.d:71-78).  Here N compressed
streams of mixed formats decode in lockstep on the GPU, and the PCM can
stay on the device — the natural sink of a GPU pipeline is a model on the
same card, and downloading PCM costs more than decoding it.

    python examples_torch/batch_decode.py [--device cuda|cpu] song1.mp3 take2.flac ...

Prints per-stream results and the scheduler's per-stage split.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from audio_formats_torch import BatchDecoder


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    paths = args.paths
    if not paths:
        print(__doc__)
        return 1
    dec = BatchDecoder(paths, device=args.device)

    # device-resident decode: PCM windows stay on the device; sync()
    # blocks until every window is computed there
    result = dec.decode_all(output="device").sync()

    # hand the device tensors to a model here via result.windows(), or
    # download everything:
    pcms = result.to_numpy()
    for path, pcm, err, d in zip(paths, pcms, dec.errors, dec.decoders):
        if err is not None or pcm is None:
            print(f"{path}: ERROR: {err}")
            continue
        secs = pcm.shape[0] / max(1, d.sample_rate)
        peak = float(np.abs(pcm).max()) if pcm.size else 0.0
        print(f"{path}: {pcm.shape[0]} frames x {pcm.shape[1]} ch "
              f"({secs:.2f} s, peak {peak:.3f})")

    s = dec.stats
    print(f"\ndecoded {s['decoded_seconds']:.1f} s total "
          f"({', '.join(f'{k}: {v:.1f}s' for k, v in sorted(s['decoded_seconds_by_format'].items()))}) "
          f"on {dec.device}")
    print(f"stage split: host {s['host_ms']:.0f} ms | enqueue "
          f"{s['enqueue_ms']:.0f} ms | fetch {s['fetch_ms']:.0f} ms | "
          f"{s['windows']} device windows | "
          f"h2d {s['h2d_bytes'] / 1e6:.1f} MB, d2h {s['d2h_bytes'] / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
