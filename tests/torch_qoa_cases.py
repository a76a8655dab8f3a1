"""QOA encode inputs shared by the CPU tests (the port's twin against JAX)
and the card tests (the CUDA kernel against the twin): lanes whose frame
lengths sit at every slice edge, and lanes where several scalefactors tie.
Each returns (samples [L, 5120], history [L, 4], weights [L, 4], frame_len
[L]) as numpy arrays, samples zero past each frame length."""

import numpy as np

from audio_formats_torch.ops import lms

SLICE_EDGES = [0, 1, 19, 20, 21, 39, 40, 5100, 5119, 5120]


def slice_edge_lanes(dtype, repeats=3):
    """Frame lengths at every slice edge side by side (a lane's full slices,
    its last partial slice and the slices past its frame in one block),
    L = 10 * repeats: tones with noise, every third lane a full-scale
    square wave; every fourth lane from int32-range weights."""
    rng = np.random.default_rng(60)
    flen = np.array(SLICE_EDGES * repeats, np.int32)
    L = flen.size
    t = np.arange(lms.QOA_FRAME_LEN)
    s = np.round(rng.uniform(2000, 30000, (L, 1))
                 * np.sin(2 * np.pi * rng.uniform(20, 4000, (L, 1)) * t
                          / 44100) + rng.normal(0, 300, (L, t.size)))
    s[::3] = np.where((t // rng.integers(2, 50, (L, 1))) % 2, 32767,
                      -32768)[::3]
    s = (np.clip(s, -32768, 32767) * (t[None, :] < flen[:, None]))
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = np.tile(lms.INITIAL_WEIGHTS, (L, 1))
    weights[1::4] = rng.integers(-(1 << 31), 1 << 31, weights[1::4].shape)
    return s.astype(dtype), history, weights, flen


def tie_lanes(dtype):
    """All-zero and constant lanes; on the full-scale lane (32767) and the
    last two lanes several scalefactors reach a slice's least error, so
    the first minimum must win; L = 13."""
    consts = [0, 0, 1, -1, 7, -8, 100, -1000, 32767, -32768, 0, 5, -5]
    L = len(consts)
    flen = np.array([5120, 20, 0, 5120, 39, 5120, 1, 5120, 5119, 5120, 21,
                     40, 5100], np.int32)
    t = np.arange(lms.QOA_FRAME_LEN)
    s = np.array(consts)[:, None] * (t[None, :] < flen[:, None])
    history = np.zeros((L, 4), np.int32)
    weights = np.tile(lms.INITIAL_WEIGHTS, (L, 1))
    history[10:] = [[0, 0, 0, 0], [5, 5, 5, 5], [-5, -5, -5, -5]]
    weights[10:] = 0
    return s.astype(dtype), history, weights, flen
