"""The plain reference of the MP3 cells: each clip's PCM recomputed from the
spectra the generator quantized, in float64 NumPy, by the frozen golden
decoder's steps (golden_mp3.py: dequant, reorder, antialias, IMDCT with
overlap in the window of each block type, the synthesis FIR), vectorised
over granules, with the scalefactors (preflag, scalefac_scale, subblock
gains) and each granule-channel's global gain in the dequantisation, and
joint stereo's mid/side mix.  ``precision="tf32"`` computes the same with each matrix
product's operands rounded to TF32 (10 mantissa bits) and float32 sums,
as a tensor core's TF32 product does: the control.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from . import golden_mp3 as G

_SFB_SHORT = np.array(G.SFB_SHORT_44100)
_SFB_LONG = [4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34, 42,
             50, 54, 76, 158]
#: preflag's added scalefactors of the long bands (ISO 11172-3 table B.6),
#: band 21 (no scalefactor) last
_PRETAB = np.array([0] * 11 + [1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0])
#: each bin's long band; each bin's short band and window, as the bins lie
#: before the reorder (band by band, its three windows one after another)
_LONG_BAND = np.repeat(np.arange(22), _SFB_LONG)
_SHORT_BAND = np.repeat(np.arange(13), 3 * _SFB_SHORT[::3])
_SHORT_WIN = np.concatenate([np.repeat(np.arange(3), w)
                             for w in _SFB_SHORT[::3]])


def _reorder_index():
    """The permutation golden_mp3.reorder_short applies: out = x[idx]."""
    idx = np.zeros(576, np.int64)
    pos = dst = 0
    for i in range(0, len(_SFB_SHORT), 3):
        ln = int(_SFB_SHORT[i])
        for j in range(ln):
            idx[dst: dst + 3] = [pos + j, pos + ln + j, pos + 2 * ln + j]
            dst += 3
        pos += 3 * ln
    return idx


_REORDER = _reorder_index()
_N36 = np.arange(36)[:, None]
_K18 = np.arange(18)[None, :]
_C_LONG = np.cos(np.pi / 72 * (2 * _N36 + 19) * (2 * _K18 + 1))   # [36, 18]
_W_LONG = np.sin(np.pi / 36 * (np.arange(36) + 0.5))
#: the long window of each block type (normal, start, -, stop)
_W_TYPE = np.stack([_W_LONG] * 4)
_W_TYPE[1, 18:24] = 1
_W_TYPE[1, 24:30] = np.sin(np.pi / 12 * (np.arange(6) + 6.5))
_W_TYPE[1, 30:] = 0
_W_TYPE[3, :6] = 0
_W_TYPE[3, 6:12] = np.sin(np.pi / 12 * (np.arange(6) + 0.5))
_W_TYPE[3, 12:18] = 1
_C_SHORT = np.cos(np.pi / 24 * (2 * np.arange(12)[:, None] + 7)
                  * (2 * np.arange(6)[None, :] + 1))               # [12, 6]
_W_SHORT = np.sin(np.pi / 12 * (np.arange(12) + 0.5))


def _tf32(x):
    """Round float32 values to TF32: 10 mantissa bits, to nearest even."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def _matmul(a, b, precision):
    if precision == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b


def exponents(truth, frames):
    """Each bin's dequantisation exponent, in quarter powers of two
    [F, 2, 2, 576]: the global gain less the scalefactors (times 2 or 4
    by scalefac_scale; preflag's table on long blocks), less 8 a subblock
    gain on short blocks, less 2 in mid/side frames (1/sqrt(2))."""
    ms = truth["ms"][frames]
    short = (truth["bt"][frames] == 2)[:, :, None, None]
    mult = 2 * (1 + truth["scale"][frames].astype(np.int64))[..., None]
    sf_l = np.concatenate([truth["sf_l"][frames],
                           np.zeros(truth["sf_l"][frames].shape[:3] + (1,),
                                    np.int64)], 3)
    pre = truth["pre"][frames].astype(np.int64)[..., None]
    long_e = mult * (sf_l + pre * _PRETAB)[..., _LONG_BAND]
    sf_s = np.concatenate([truth["sf_s"][frames],
                           np.zeros(truth["sf_s"][frames].shape[:3] + (1, 3),
                                    np.int64)], 3)
    short_e = mult * sf_s[..., _SHORT_BAND, _SHORT_WIN] \
        + 8 * truth["sbg"][frames][..., _SHORT_WIN]
    gain = truth["gain"][frames] - 4 - 210 - np.where(ms, 2, 0)[:, None, None]
    return gain[..., None] - np.where(short, short_e, long_e)


def decode_clip(truth, frames, precision="f64"):
    """PCM [frames * 1152, 2] of the clip made of bank frames `frames`."""
    dt = np.float32 if precision == "tf32" else np.float64
    q = truth["q"][frames].astype(np.float64)              # [F, 2, 2, 576]
    ms = truth["ms"][frames]
    bt = truth["bt"][frames].reshape(-1)                   # [G]
    short = bt == 2
    x = np.sign(q) * np.abs(q) ** (4.0 / 3.0) \
        * 2.0 ** (exponents(truth, frames) / 4)
    mid, side = x[:, :, 0].copy(), x[:, :, 1].copy()
    x[:, :, 0] = np.where(ms[:, None, None], mid + side, mid)
    x[:, :, 1] = np.where(ms[:, None, None], mid - side, side)
    x = x.reshape(-1, 2, 576).astype(dt)                   # [G, ch, 576]
    G_ = x.shape[0]
    x[short] = x[short][..., _REORDER]
    # antialias butterflies between neighbouring subbands (long blocks)
    xb = x.reshape(G_, 2, 32, 18)
    u = xb[~short, :, 1:, :8].copy()
    d = xb[~short, :, :31, 17:9:-1].copy()
    cs, ca = G._CS.astype(dt), G._CA.astype(dt)
    xl = xb[~short]
    xl[:, :, 1:, :8] = u * cs - d * ca
    xl[:, :, :31, 17:9:-1] = u * ca + d * cs
    xb[~short] = xl
    # IMDCT of each subband: long blocks one 36-point transform, short
    # blocks three 12-point ones at offsets 6, 12, 18
    z = np.zeros((G_, 2, 32, 36), dt)
    z[~short] = _matmul(xb[~short], _C_LONG.T.astype(dt), precision) \
        * _W_TYPE[bt[~short]][:, None, None, :].astype(dt)
    xs = xb[short]
    for j in range(3):
        sub = _matmul(xs[..., j::3], _C_SHORT.T.astype(dt), precision) \
            * _W_SHORT.astype(dt)
        zs = z[short]
        zs[..., 6 + 6 * j: 18 + 6 * j] += sub
        z[short] = zs
    out = z[..., :18].copy()
    out[1:] += z[:-1, ..., 18:]
    out *= G._SIGNMASK.astype(dt)
    # synthesis: slot t of subband sample vectors through the 17-tap FIR
    S = out.transpose(1, 0, 3, 2).reshape(2, G_ * 18, 32)  # [ch, T, 32]
    Tn = S.shape[1]
    Spad = np.concatenate([np.zeros((2, 16, 32), dt), S], 1)
    fir = G._FIR.astype(dt)
    pcm = np.zeros((2, Tn, 32), dt)
    for r in range(17):
        pcm += _matmul(Spad[:, 16 - r: 16 - r + Tn], fir[r].T, precision)
    return pcm.reshape(2, -1).T.astype(np.float64)


def expected(corpus, i):
    return decode_clip(corpus.truth, corpus.truth["frames_of"][i])


def control(corpus, i):
    return decode_clip(corpus.truth, corpus.truth["frames_of"][i], "tf32")


def gap(corpus, got, want):
    """The widest gap of a lane over its reference's peak."""
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))
