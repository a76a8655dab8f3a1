"""The plain reference of the FLAC cells.  FLAC is lossless, so a stream's
answer is the PCM the generator encoded, as the decoder's float32 output
gives it (the sample left-justified to 32 bits, over 2^31 - 1: the JAX
package's and the port's convention).  ``control`` puts that output
through bfloat16, the precision below the float32 the output is stated in.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def pcm_int(truth, frames):
    """The stream's samples, int64 [n, channels]."""
    pcm, lens = truth["pcm"], truth["lens"]
    x = np.concatenate([pcm[f, : lens[f]] for f in frames]).astype(np.int64)
    return x.reshape(x.shape[0], -1)


def as_output(x, bps):
    """Samples as the decoder's float32 output."""
    return ((x << (32 - bps)).astype(np.float64)
            * (1.0 / 2147483647.0)).astype(np.float32)


def expected(corpus, i):
    t = corpus.truth
    return as_output(pcm_int(t, t["frames_of"][i]), t["bps"])


def control(corpus, i):
    want = expected(corpus, i)
    b = want.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def gap(corpus, got, want):
    """The widest gap, in units of the stream's least significant bit
    (2^-15 for 16-bit samples): 1 is one sample value off."""
    lsb = 2.0 ** (1 - corpus.truth["bps"])
    return float(np.max(np.abs(got.astype(np.float64) - want)) / lsb)
