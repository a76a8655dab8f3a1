"""MP3 device DSP: requantize → stereo → reorder → antialias → IMDCT → synthesis.

Everything after the Huffman stage is dense linear algebra over
[batch, channel] lanes, in plain PyTorch:

* **Requantize** — sign(q)·|q|^(4/3) times per-coefficient gains (the
  window path dequantizes in ops/mp3_huff.py and skips this).
* **Stereo** — a per-coefficient 2×2 mix (l' = a·l + b·r, r' = c·l + d·r).
* **Reorder** — the short-block permutation, one gather.
* **Antialias** — 8 butterflies per band boundary, masked by the
  per-granule band count (31 long / none short / n-1 mixed).
* **IMDCT 36/12 + overlap-add** — per band a [36]→[36] matrix over
  (18 coeffs ‖ 18 overlap), one per window type (normal/start/short/stop),
  then the frequency inversion.
* **Polyphase synthesis** — the 32-band filterbank as a 17-tap matrix FIR
  over granule slots, W from ``utils/tables/mp3_synth_fir.npz``.

On the card the batch window runs everything from the dequant to the
synthesis product's operand as one hand-written kernel, K14
(``csrc/mp3_dsp.cu``, ``window_dsp_cuda``), over the tables of
``dsp_blob``; ``DSP_LAUNCHES`` counts its launches.  ``mp3_window_dsp``
(after ops/mp3_huff.py ``spectrum_stage``) is its plain twin, which the CPU
takes.  The synthesis of K14's operand is a second kernel, K15
(``synth_cuda``: minimp3's DCT-II of each slot, then its window, over the
tables of ``synth_blob``; ``SYNTH_LAUNCHES``), whose plain version
``synth_twin`` is the product with ``SYNTH_TOEPLITZ``.

Carried per-stream state: IMDCT overlap [C, 32, 18] and the last 16
subband slot vectors [C, 16, 32] (minimp3's mdct_overlap and qmf_state,
minimp3.d:40-45).

The matrix products run in full float32: the reference computes them at
Precision.HIGHEST, so a CUDA call raises while PyTorch may use TF32 for
float32 matmuls rather than change that setting behind the caller's back.
"""

from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch

from . import _kernels
from ._kernels import KernelError

_TABLE_DIR = os.path.join(os.path.dirname(__file__), "..", "utils", "tables")

# Synthesis FIR [17, 32, 32] (see module docstring).
SYNTH_FIR = np.load(os.path.join(_TABLE_DIR, "mp3_synth_fir.npz"))["W"]

# Antialias butterfly coefficients from the spec's ci constants
# (ISO 11172-3 Table B.9 values; equals minimp3's g_aa within float rounding).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
AA_CS = (1.0 / np.sqrt(1.0 + _CI**2)).astype(np.float32)
AA_CA = (np.abs(_CI) / np.sqrt(1.0 + _CI**2)).astype(np.float32)

WIN_NORMAL, WIN_START, WIN_SHORT, WIN_STOP = 0, 1, 2, 3


def _imdct36_matrix() -> np.ndarray:
    n = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    return np.cos(np.pi / 72.0 * (2 * n + 1 + 18) * (2 * k + 1))


def _imdct12_matrix() -> np.ndarray:
    n = np.arange(12)[:, None]
    k = np.arange(6)[None, :]
    return np.cos(np.pi / 24.0 * (2 * n + 1 + 6) * (2 * k + 1))


def _long_window(kind: int) -> np.ndarray:
    n = np.arange(36)
    w = np.sin(np.pi / 36.0 * (n + 0.5))
    if kind == WIN_START:
        w[18:24] = 1.0
        w[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
        w[30:] = 0.0
    elif kind == WIN_STOP:
        w[:6] = 0.0
        w[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
        w[12:18] = 1.0
    return w


def _build_imdct_matrices() -> np.ndarray:
    """[4 window types, 36, 36] mapping (coeffs(18) ‖ overlap(18)) →
    (pcm(18) ‖ overlap'(18))."""
    out = np.zeros((4, 36, 36))
    c36 = _imdct36_matrix()
    for kind in (WIN_NORMAL, WIN_START, WIN_STOP):
        zw = c36 * _long_window(kind)[:, None]  # [36 out, 18 coeff]
        m = np.zeros((36, 36))
        m[:18, :18] = zw[:18].T
        m[18:, :18] = np.eye(18)  # overlap feeds straight into pcm
        m[:18, 18:] = zw[18:].T  # new overlap from coeff tail
        out[kind] = m
    # short: three 12-point IMDCTs at offsets 6, 12, 18 within the 36 frame;
    # coefficients arrive reordered as triples [s0,s1,s2] per frequency line.
    c12 = _imdct12_matrix() * np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))[:, None]
    z = np.zeros((36, 18))
    for j in range(3):
        # window j uses coeffs [j::3]
        z[6 + 6 * j : 18 + 6 * j, j::3] += c12
    m = np.zeros((36, 36))
    m[:18, :18] = z[:18].T
    m[18:, :18] = np.eye(18)
    m[:18, 18:] = z[18:].T
    out[WIN_SHORT] = m
    return out


IMDCT_MATS = _build_imdct_matrices().astype(np.float32)

# frequency inversion (change-sign): odd time samples of odd bands flip
_SIGN = np.ones((32, 18), dtype=np.float32)
_SIGN[1::2, 1::2] = -1.0

# [4, 18, 36] per window type: c(18) -> (pcm(18) ‖ overlap'(18))
UV_MATS = IMDCT_MATS[:, :18, :].copy()

# slot-layout frequency inversion: sign.T broadcast over granules
_SIGN_T = _SIGN.T.copy()  # [18, 32]


def _build_synth_toeplitz() -> np.ndarray:
    """Granule-blocked Toeplitz form of the 17-tap synthesis FIR:
    pcm[g·18+t, j] = Σ_{u,k} Swin[g, u, k]·W_blk[u·32+k, t·32+j] where
    Swin[g] = slot window [g·18, g·18+34) of (shist ‖ S)."""
    W_blk = np.zeros((34 * 32, 18 * 32), np.float32)
    for t in range(18):
        for u in range(t, t + 17):
            r = 16 + t - u
            W_blk[u * 32 : (u + 1) * 32, t * 32 : (t + 1) * 32] = (
                SYNTH_FIR[r].T
            )
    return W_blk


SYNTH_TOEPLITZ = _build_synth_toeplitz()  # [1088, 576]


_consts = {}
_consts_lock = threading.Lock()


def device_const(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Module constant `a` as a tensor on `dev`, uploaded once."""
    key = (id(a), str(dev))
    with _consts_lock:
        t = _consts.get(key)
        if t is None:
            t = torch.from_numpy(a).to(dev)
            _consts[key] = t
    return t


def full_fp32(dev: torch.device, what: str = "MP3 DSP") -> None:
    """Raise unless float32 matrix products on `dev` run in full float32
    (`what` names the stage that needs them)."""
    if dev.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise KernelError(
            f"{what} needs full-float32 matmuls (the reference pins "
            "Precision.HIGHEST): set torch.backends.cuda.matmul.allow_tf32 "
            "= False and torch.set_float32_matmul_precision('highest')")


def _tensor(x, dev, dtype):
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _requant(q, scale):
    return torch.sign(q) * torch.pow(torch.abs(q), 4.0 / 3.0) * scale


def _antialias(xb, aa_bands):
    """Butterflies across each of the first aa_bands band boundaries.
    xb [..., 32, 18] (a new tensor is returned), aa_bands [...]."""
    cs = device_const(AA_CS, xb.device)
    ca = device_const(AA_CA, xb.device)
    u = xb[..., 1:, :8]                  # coeffs 0..7 of bands 1..31
    d = xb[..., :-1, 10:18].flip(-1)     # coeffs 17..10 of bands 0..30
    bmask = (torch.arange(31, device=xb.device)[:, None]
             < aa_bands[..., None, None])
    nu = torch.where(bmask, u * cs - d * ca, u)
    nd = torch.where(bmask, u * ca + d * cs, d)
    out = xb.clone()
    out[..., 1:, :8] = nu
    out[..., :-1, 10:18] = nd.flip(-1)
    return out


def mp3_frame_dsp(q, scale, mix, perm, aa_bands, wtype, overlap, shist,
                  nch: int, ngr: int):
    """Decode the DSP half of MP3 frames for a batch of streams, granule by
    granule (the facade's path).

    q:       [B, ngr, nch, 576] f32 — signed quantized Huffman values
    scale:   [B, ngr, nch, 576] f32 — per-coefficient requant gains
    mix:     [B, ngr, 4, 576]  f32 — stereo mix (a,b,c,d):
             l' = a·l + b·r, r' = c·l + d·r  (read only when stereo)
    perm:    [B, ngr, nch, 576] i32 — short-block reorder permutation
    aa_bands:[B, ngr, nch]      i32 — antialias band-boundary count
    wtype:   [B, ngr, nch, 32]  i32 — per-band window type (0..3)
    overlap: [B, nch, 32, 18]   f32 — carried IMDCT OLA state
    shist:   [B, nch, 16, 32]   f32 — carried subband slot history

    Takes numpy arrays or tensors; runs on q's device (a tensor's, else
    the CPU).  ``ngr`` may cover several frames.  Returns
    (pcm [B, ngr, nch, 576], overlap', shist') as tensors.
    """
    dev = q.device if isinstance(q, torch.Tensor) else torch.device("cpu")
    full_fp32(dev)
    f32 = torch.float32
    q = _tensor(q, dev, f32)
    B = q.shape[0]
    W = device_const(SYNTH_FIR, dev)        # [17, 32, 32]
    mats = device_const(IMDCT_MATS, dev)    # [4, 36, 36]
    sign = device_const(_SIGN, dev)
    overlap = _tensor(overlap, dev, f32)
    shist = _tensor(shist, dev, f32)
    aa_bands = _tensor(aa_bands, dev, torch.int32)
    wtype = _tensor(wtype, dev, torch.int32)
    scale = _tensor(scale, dev, f32)
    if nch == 2:
        mix = _tensor(mix, dev, f32)
    perm = _tensor(perm, dev, torch.int64)
    kinds = torch.arange(4, device=dev)[:, None, None, None, None]
    pcm_all = []
    for g in range(ngr):
        xg = _requant(q[:, g], scale[:, g])
        if nch == 2:
            l, r = xg[:, 0], xg[:, 1]
            a, b, c, d = (mix[:, g, i] for i in range(4))
            xg = torch.stack([a * l + b * r, c * l + d * r], dim=1)
        xg = torch.gather(xg, -1, perm[:, g])
        xb = _antialias(xg.reshape(B, nch, 32, 18), aa_bands[:, g])
        # IMDCT + OLA: every window matrix, then per band select its type
        inp = torch.cat([xb, overlap], dim=-1)        # [B, nch, 32, 36]
        outs = torch.einsum("bcki,wij->wbckj", inp, mats)
        sel = wtype[:, g][None, :, :, :, None] == kinds
        out = torch.where(sel, outs, 0.0).sum(0)      # [B, nch, 32, 36]
        grb = out[..., :18] * sign                    # frequency inversion
        new_overlap = out[..., 18:]
        # synthesis FIR over slots
        S = grb.transpose(-1, -2)                     # [B, nch, 18, 32]
        Sfull = torch.cat([shist, S], dim=2)          # [B, nch, 34, 32]
        wins = torch.stack([Sfull[:, :, 16 - r: 34 - r] for r in range(17)],
                           dim=3)                     # [B, nch, 18, 17, 32]
        pcm = torch.einsum("bctrk,rjk->bctj", wins, W)  # [B, nch, 18, 32]
        overlap = new_overlap
        shist = Sfull[:, :, -16:]
        pcm_all.append(pcm.reshape(B, nch, 576))
    return torch.stack(pcm_all, dim=1), overlap, shist


def mp3_window_dsp(xq, aa_bands, wtype, overlap, shist, n_act, nch: int,
                   ngr: int):
    """Scan-free MP3 window DSP (the batch path).

    The IMDCT+OLA maps (coeffs ‖ overlap) → (pcm ‖ overlap'), and overlap'
    depends only on the granule's own coefficients, so
    pcm_g = U(w_g)·c_g + V(w_{g-1})·c_{g-1} runs for all granules at once;
    the synthesis is a 17-tap FIR over slots, one granule-blocked Toeplitz
    matmul.  Carried state enters only at the window's edges.

    xq [B, ngr, nch, 576] f32 is the requantized spectrum after the stereo
    mix and the short-block reorder (ops/mp3_huff.packed_device_stage);
    aa_bands, wtype, overlap and shist as in mp3_frame_dsp.  ``n_act`` [B]
    int32 is the number of leading active granules per lane (activity must
    be a prefix; the scheduler compacts).  Outputs at granule index >=
    n_act are garbage for the caller to drop.

    Returns (pcm [B, ngr, nch, 576], overlap', shist').
    """
    dev = xq.device
    full_fp32(dev)
    B = xq.shape[0]
    mats = device_const(UV_MATS, dev)  # [4, 18, 36]
    xb = _antialias(xq.reshape(B, ngr, nch, 32, 18), aa_bands)
    # IMDCT: per window type, mask the coefficients and accumulate the
    # [18]→[36] matmul (four K=18 matmuls into one [.., 36] buffer)
    out = torch.zeros(xb.shape[:4] + (36,), dtype=torch.float32, device=dev)
    for w in range(4):
        xw = torch.where((wtype == w)[..., None], xb, 0.0)
        out = out + torch.matmul(xw, mats[w])
    Y = out[..., :18]   # U(w_g)·c_g
    OV = out[..., 18:]  # V(w_g)·c_g = overlap emitted by granule g
    # OLA: granule g adds the previous granule's overlap (carried at g=0)
    ov_stack = torch.cat([overlap[:, None], OV], dim=1)  # [B, G+1, nch, 32, 18]
    grb = Y + ov_stack[:, :ngr]
    # new carried overlap = overlap emitted by the last active granule
    lanes = torch.arange(B, device=dev)
    n_act = n_act.to(device=dev, dtype=torch.int64)
    new_overlap = ov_stack[lanes, n_act]
    # frequency inversion + to slot layout [B, nch, G*18, 32]
    S = grb.transpose(-1, -2) * device_const(_SIGN_T, dev)
    S = S.transpose(1, 2).reshape(B, nch, ngr * 18, 32)
    Sfull = torch.cat([shist, S], dim=2)  # [B, nch, 16+18G, 32]
    # polyphase synthesis as one granule-blocked Toeplitz matmul: window g
    # = slot chunk g ‖ first 16 slots of chunk g+1
    pad = torch.nn.functional.pad(Sfull, (0, 0, 0, 2))
    R = pad.reshape(B, nch, ngr + 1, 18, 32)
    Swin = torch.cat([R[:, :, :ngr], R[:, :, 1:, :16]], dim=3)
    pcm = torch.matmul(Swin.reshape(B * nch * ngr, 34 * 32),
                       device_const(SYNTH_TOEPLITZ, dev))
    pcm = pcm.reshape(B, nch, ngr, 18, 32).transpose(1, 2)\
        .reshape(B, ngr, nch, 576)
    # new slot history = the 16 slots ending at slot 16 + 18*n_act
    hidx = 18 * n_act[:, None] + torch.arange(16, device=dev)
    new_shist = torch.gather(
        Sfull, 2, hidx[:, None, :, None].expand(B, nch, 16, 32))
    return pcm, new_overlap, new_shist


# ------------------------------------------------- K14, the window kernel
#: launches of the CUDA window DSP kernel (af_mp3_window_dsp) in this process
DSP_LAUNCHES = 0
_launch_lock = threading.Lock()

#: int32 word offsets in dsp_blob() (csrc/mp3_dsp.cu reads the same layout)
DSP_UV = 0                         # [4, 18, 36] f32: UV_MATS
DSP_P43 = DSP_UV + 4 * 18 * 36     # [8208] f32: |q|^(4/3)
DSP_BAND = DSP_P43 + 8208          # [48, 576] u8: BAND_IDX
DSP_PERM = DSP_BAND + 48 * 576 // 4  # [48, 576] u16: PERM
DSP_WT = DSP_PERM + 48 * 576 // 2  # [48, 4, 32] u8: window type a band
DSP_AA = DSP_WT + 48 * 4 * 32 // 4  # [48] i8: antialias boundaries
DSP_CS = DSP_AA + 48 // 4          # [8] f32: AA_CS
DSP_CA = DSP_CS + 8                # [8] f32: AA_CA
DSP_POW4 = DSP_CA + 8              # [4] f32: 2^(j/4)
DSP_WORDS = DSP_POW4 + 4

#: 2^(j/4), j = 0..3, rounded once to float32: the kernel's gain
#: 2^(e/4) is ldexp(_POW4[e & 3], e >> 2), correctly rounded
_POW4 = (2.0 ** (np.arange(4) / 4.0)).astype(np.float32)


def _window_tables(nlb: np.ndarray):
    """K14's window types [48 patterns, 4 block types, 32 bands] and
    antialias boundary counts [48], from each pattern's long-band count
    (ops/mp3_huff.py _NLB): the rule of ops/mp3_huff.py spectrum_stage,
    tabulated.  Short and mixed patterns (kind 1, 2) take long windows
    below their long bands and short ones above, and antialias their long
    bands' boundaries; long patterns take the block type's window (3 stop,
    1 start, any other normal) and all 31 boundaries."""
    pat = np.arange(48)
    is_short = np.isin(pat // 16, (1, 2))
    base = np.array([WIN_NORMAL, WIN_START, WIN_NORMAL, WIN_STOP])
    band = np.arange(32)
    wt = np.where(is_short[:, None, None],
                  np.where(band < nlb[:, None, None], WIN_NORMAL, WIN_SHORT),
                  base[None, :, None])
    aa = np.where(is_short, nlb - 1, 31)
    return wt.astype(np.int8), aa.astype(np.int8)


@functools.lru_cache(maxsize=None)
def dsp_blob() -> np.ndarray:
    """The int32 word blob of every table K14 reads (DSP_* offsets): the
    IMDCT matrices, |q|^(4/3), each pattern's band of a position and
    short-block reorder, the window tables, the antialias coefficients and
    _POW4.  Built once, at first use."""
    from . import mp3_huff  # it imports this module

    def words(a):
        return np.ascontiguousarray(a).reshape(-1).view(np.int32)

    wt, aa = _window_tables(mp3_huff._NLB)
    blob = np.concatenate([
        words(UV_MATS), words(mp3_huff._P43),
        words(mp3_huff.BAND_IDX.astype(np.uint8)),
        words(mp3_huff.PERM.astype(np.uint16)), words(wt), words(aa),
        words(AA_CS), words(AA_CA), words(_POW4)])
    assert blob.shape == (DSP_WORDS,)
    return blob


def window_dsp_cuda(q, meta16, scfq, n_act, overlap, shist, abcd=None, *,
                    B: int, G: int, nch: int, short: bool = True):
    """K14 (csrc/mp3_dsp.cu) on the tensors' card, on its current stream:
    a window from the Huffman stage's output to the synthesis product's
    operand in one launch.

    q [L, 576] int32 (L = B·G·nch lanes, lane (b·G + g)·nch + c), meta16
    [L, 16] int16 and scfq [L, 40] int16 as ops/mp3_huff.spectrum_stage
    takes them; n_act [B] int32; overlap [B, nch, 32, 18] and shist [B,
    nch, 16, 32] float32 as mp3_window_dsp; abcd [B·G, 4, 40] float32, the
    intensity mix (ops/mp3_huff._intensity_abcd), or None outside intensity
    windows; short: whether any lane has a short-block pattern.  All
    contiguous on one CUDA device.

    Returns (operand [L, 1088] f32, overlap', shist'): row (b, g, c) of
    the operand holds slots [18g, 18g + 34) of (shist ‖ S), so
    ``operand @ SYNTH_TOEPLITZ`` viewed as [B, G, nch, 576] is the PCM of
    mp3_window_dsp."""
    dev = q.device
    L = B * G * nch
    if nch not in (1, 2) or (abcd is not None and nch != 2):
        raise _kernels.KernelArgError(
            f"window_dsp: {nch} channels"
            + (" with an intensity mix" if abcd is not None else ""))
    want = [("q", q, (torch.int32,), (L, 576)),
            ("meta16", meta16, (torch.int16,), (L, 16)),
            ("scfq", scfq, (torch.int16,), (L, 40)),
            ("n_act", n_act, (torch.int32,), (B,)),
            ("overlap", overlap, (torch.float32,), (B, nch, 32, 18)),
            ("shist", shist, (torch.float32,), (B, nch, 16, 32))]
    if abcd is not None:
        want.append(("abcd", abcd, (torch.float32,), (B * G, 4, 40)))
    _kernels.check_args("window_dsp", dev, want)
    operand = torch.empty((L, 34 * 32), dtype=torch.float32, device=dev)
    new_overlap = torch.empty_like(overlap)
    new_shist = torch.empty_like(shist)
    if L == 0:
        return operand, new_overlap, new_shist
    global DSP_LAUNCHES
    lib = _kernels.load("mp3_dsp")
    blob = device_const(dsp_blob(), dev)
    with torch.cuda.device(dev):
        rc = lib.af_mp3_window_dsp(
            q.data_ptr(), meta16.data_ptr(), scfq.data_ptr(),
            n_act.data_ptr(), overlap.data_ptr(), shist.data_ptr(),
            None if abcd is None else abcd.data_ptr(), blob.data_ptr(), B, G,
            nch, int(short), operand.data_ptr(), new_overlap.data_ptr(),
            new_shist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("window_dsp", rc)
    with _launch_lock:
        DSP_LAUNCHES += 1
    return operand, new_overlap, new_shist


# ------------------------------------ K15, the polyphase synthesis kernel
#: launches of the CUDA synthesis kernel (af_mp3_synth) in this process
SYNTH_LAUNCHES = 0

#: minimp3's g_sec, the secants of its 32-point DCT-II's first stage
#: (mp3d_DCT_II; tools/spec_constants.py holds the same values)
SYNTH_SEC = np.array([
    10.19000816, 0.50060302, 0.50241929, 3.40760851, 0.50547093,
    0.52249861, 2.05778098, 0.51544732, 0.56694406, 1.4841646, 0.53104258,
    0.6468218, 1.16943991, 0.55310392, 0.7881546, 0.97256821, 0.58293498,
    1.06067765, 0.83934963, 0.62250412, 1.72244716, 0.74453628, 0.67480832,
    5.10114861], np.float32)
#: the scales of mp3d_DCT_II's four 8-point stages, in the order
#: tools/gen_mp3_synth.py dct2_32 uses them
SYNTH_DCT_K = np.array([0.70710677, 0.198912367, 0.382683432, 0.50979561,
                        0.54119611, 0.60134488, 0.89997619, 1.30656302,
                        2.56291556], np.float32)
#: mp3d_synth_pair's taps of a slot's outputs 0 (ages 1..8) and 16 (ages
#: 1, 3, .., 15): minimp3 writes them as literals, not in g_win
_PAIR0 = (29, 213, 459, 2037, 5153, 6574, 37489, 75038)
_PAIR16 = (104, 1567, 9727, 64019, -9975, -45, 146, -5)


def _synth_taps():
    """K15's window, from minimp3's mp3d_synth: PCM sample j of output
    slot t is sum over ages r = 0..15 of coef[j, r] V_{t-r}[m[j, r & 1]],
    V_s the 32-point DCT-II of subband slot s (minimp3's order,
    SYNTH_SEC and SYNTH_DCT_K).  g_win's iteration i (rows of 16, i = 14
    down to 0) gives outputs 15 - i (its a sums) and 17 + i (its b sums),
    its step k the ages k and 15 - k; mp3d_synth_pair gives outputs 0 and
    16.  Returns (coef [32, 16] float32, g_win / 32768 exactly; m [32, 2]
    int32).  Output 16 has no even-age taps (coefficient 0)."""
    from ..utils.tables.mp3_tables import SYNTH_WIN

    win = np.asarray(SYNTH_WIN, np.float64).reshape(15, 16)
    coef = np.zeros((32, 16))
    m = np.zeros((32, 2), np.int32)
    for i in range(15):
        w = win[14 - i]
        ja, jb = 15 - i, 17 + i
        for k in range(8):
            w0, w1 = w[2 * k], w[2 * k + 1]
            s = -1.0 if k % 2 else 1.0  # minimp3's S2 steps flip a's sign
            coef[ja, k], coef[ja, 15 - k] = s * w0, -s * w1
            coef[jb, k], coef[jb, 15 - k] = w1, w0
        m[ja] = 16 + ja, 16 - ja
        m[jb] = 48 - jb, jb - 16
    for r in range(1, 9):
        coef[0, r] = _PAIR0[r - 1]
        if r < 8:
            coef[0, 16 - r] = (-1) ** r * _PAIR0[r - 1]
    m[0] = 16, 16
    coef[16, 1::2] = _PAIR16
    return (coef / 32768.0).astype(np.float32), m


#: float32 word offsets in synth_blob() (csrc/mp3_dsp.cu reads the same)
SYN_COEF = 0                 # [32, 16] f32: _synth_taps' coef
SYN_M = SYN_COEF + 32 * 16   # [32, 2] i32: _synth_taps' m
SYN_SEC = SYN_M + 32 * 2     # [24] f32: SYNTH_SEC
SYN_K = SYN_SEC + 24         # [9] f32: SYNTH_DCT_K
SYN_WORDS = SYN_K + 9


@functools.lru_cache(maxsize=None)
def synth_blob() -> np.ndarray:
    """The float32 blob of K15's tables (SYN_* offsets), built once."""
    coef, m = _synth_taps()
    blob = np.concatenate([coef.reshape(-1), m.reshape(-1).view(np.float32),
                           SYNTH_SEC, SYNTH_DCT_K])
    assert blob.shape == (SYN_WORDS,)
    return blob


def synth_twin(operand: torch.Tensor) -> torch.Tensor:
    """K15's plain version: ``operand @ SYNTH_TOEPLITZ``, on the operand's
    device.  operand [L, 1088] float32 as window_dsp_cuda writes it;
    returns pcm [L, 576]."""
    return torch.matmul(operand, device_const(SYNTH_TOEPLITZ,
                                              operand.device))


def synth_cuda(operand: torch.Tensor) -> torch.Tensor:
    """K15 (csrc/mp3_dsp.cu, af_mp3_synth) on the operand's card, on its
    current stream: the polyphase synthesis of K14's operand, minimp3's
    DCT-II of each slot then its window, in float32.

    operand [L, 1088] float32, contiguous and 16-byte aligned on a CUDA
    device (KernelArgError otherwise; L 0 launches nothing): row l holds 34
    subband slots of 32 bands, [18 g, 18 g + 34) of its lane's (history ‖
    slots).  Returns pcm [L, 576] float32, laid out as synth_twin's: slot
    t of row l from the row's slots t + 1 .. t + 16 (SYNTH_FIR's tap 16 is
    zero, so slot t itself adds nothing)."""
    dev = operand.device
    L = operand.shape[0] if operand.dim() == 2 else -1
    _kernels.check_args("synth", dev, [
        ("operand", operand, (torch.float32,), (L, 34 * 32))])
    if operand.data_ptr() % 16:
        raise _kernels.KernelArgError(
            "synth: operand not 16-byte aligned (the kernel reads rows 16 "
            "bytes at a time)")
    pcm = torch.empty((L, 576), dtype=torch.float32, device=dev)
    if L == 0:
        return pcm
    global SYNTH_LAUNCHES
    lib = _kernels.load("mp3_dsp")
    blob = device_const(synth_blob(), dev)
    with torch.cuda.device(dev):
        rc = lib.af_mp3_synth(operand.data_ptr(), blob.data_ptr(), L,
                              pcm.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("synth", rc)
    with _launch_lock:
        SYNTH_LAUNCHES += 1
    return pcm


def mp3_synth_slots(S, shist, nch: int):
    """Polyphase synthesis only — the Layer I/II path (no IMDCT: L1/L2 are
    pure subband codecs, minimp3.d:449-486).

    S: [B, nch, T, 32] scf-applied subband slot vectors
    shist: [B, nch, 16, 32] carried slot history
    Takes numpy arrays or tensors; runs on S's device (a tensor's, else
    the CPU).  Returns (pcm [B, nch, T*32], shist') as tensors.
    """
    dev = S.device if isinstance(S, torch.Tensor) else torch.device("cpu")
    full_fp32(dev)
    S = _tensor(S, dev, torch.float32)
    shist = _tensor(shist, dev, torch.float32)
    W = device_const(SYNTH_FIR, dev)
    B, _, T, _ = S.shape
    Sfull = torch.cat([shist, S], dim=2)  # [B, nch, 16+T, 32]
    wins = torch.stack([Sfull[:, :, 16 - r: 16 - r + T] for r in range(17)],
                       dim=3)  # [B, nch, T, 17, 32]
    pcm = torch.einsum("bctrk,rjk->bctj", wins, W)
    return pcm.reshape(B, nch, T * 32), Sfull[:, :, -16:]
