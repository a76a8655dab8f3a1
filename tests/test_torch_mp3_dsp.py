"""K14, MP3's window kernel (csrc/mp3_dsp.cu), on the CPU: the tables it
reads, its route, and its algorithm.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds it
to its twin there).  Here: every table in ``mp3_dsp.dsp_blob`` equals the
constant the twin uses, or gives the twin's window types and antialias
counts for every pattern and block type; the wrapper refuses CPU tensors,
and ``packed_window`` on the CPU runs the twin without touching it; and a
numpy emulation of the kernel (one (lane, granule) block at a time, its
index math and its tables read out of the blob) gives the twin's PCM and
carried state on every case of ``torch_mp3_cases.WINDOW_CASES``.
"""

import numpy as np
import pytest
import torch

from audio_formats_torch.ops import _kernels, mp3_dsp, mp3_huff

from torch_mp3_cases import WINDOW_CASES, window_case

D = mp3_dsp
#: K14 and its twin sum the IMDCT and the synthesis in other orders:
#: float32 rounding over 18 + 1,088 terms, as a share of the peak
TOL_OF_PEAK = 1e-5


def _blob_parts():
    blob = D.dsp_blob()
    f = blob.view(np.float32)
    return {
        "uv": f[D.DSP_UV:D.DSP_P43].reshape(4, 18, 36),
        "p43": f[D.DSP_P43:D.DSP_BAND],
        "band": blob[D.DSP_BAND:D.DSP_PERM].view(np.uint8).reshape(48, 576),
        "perm": blob[D.DSP_PERM:D.DSP_WT].view(np.uint16).reshape(48, 576),
        "wt": blob[D.DSP_WT:D.DSP_AA].view(np.int8).reshape(48, 4, 32),
        "aa": blob[D.DSP_AA:D.DSP_CS].view(np.int8),
        "cs": f[D.DSP_CS:D.DSP_CA], "ca": f[D.DSP_CA:D.DSP_POW4],
        "pow4": f[D.DSP_POW4:D.DSP_WORDS]}


def test_dsp_blob_holds_the_twins_constants():
    parts = _blob_parts()
    assert D.dsp_blob().shape == (D.DSP_WORDS,)
    np.testing.assert_array_equal(parts["uv"], D.UV_MATS)
    np.testing.assert_array_equal(parts["p43"], mp3_huff._P43)
    np.testing.assert_array_equal(parts["band"], mp3_huff.BAND_IDX)
    np.testing.assert_array_equal(parts["perm"], mp3_huff.PERM)
    np.testing.assert_array_equal(parts["cs"], D.AA_CS)
    np.testing.assert_array_equal(parts["ca"], D.AA_CA)


def test_dsp_gain_is_the_correctly_rounded_power():
    """The kernel's gain ldexp(POW4[e & 3], e >> 2) is 2^(e/4) rounded
    once to float32, over every quarter exponent a window can carry."""
    e = np.arange(-600, 200)
    got = np.ldexp(_blob_parts()["pow4"][e & 3], e >> 2)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  (2.0 ** (e / 4.0)).astype(np.float32))


def test_dsp_window_tables_match_the_device_stage():
    """For every pattern and block type, the window type of each band and
    the antialias count that K14 reads equal packed_device_stage's."""
    pats, bts = np.meshgrid(np.arange(48), np.arange(4), indexing="ij")
    L = pats.size
    meta16 = np.zeros((L, 16), np.int16)   # no Huffman bits to decode
    meta16[:, mp3_huff.M_PATTERN] = pats.ravel()
    meta16[:, mp3_huff.M_BTYPE] = bts.ravel()
    _, aa, wt = mp3_huff.packed_device_stage(
        torch.zeros(1, dtype=torch.int32), torch.from_numpy(meta16),
        torch.zeros((L, 40), dtype=torch.int16), 20, 1, L, 1,
        lanes_per_frame=1)
    parts = _blob_parts()
    np.testing.assert_array_equal(
        parts["wt"][pats.ravel(), bts.ravel()], wt[0, :, 0].numpy())
    np.testing.assert_array_equal(parts["aa"][pats.ravel()],
                                  aa[0, :, 0].numpy())
    assert set(np.unique(parts["wt"])) == {0, 1, 2, 3}


def test_window_dsp_cuda_refuses_cpu_tensors():
    B, G, nch = 1, 2, 2
    L = B * G * nch
    args = (torch.zeros((L, 576), dtype=torch.int32),
            torch.zeros((L, 16), dtype=torch.int16),
            torch.zeros((L, 40), dtype=torch.int16),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros((B, nch, 32, 18)), torch.zeros((B, nch, 16, 32)))
    with pytest.raises(_kernels.KernelArgError):
        D.window_dsp_cuda(*args, B=B, G=G, nch=nch)
    with pytest.raises(_kernels.KernelArgError):
        D.window_dsp_cuda(*args, B=B, G=G, nch=3)


def _tensors(win):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in win.items() if k not in ("W", "lanes_per_frame")}


def test_packed_window_on_the_cpu_runs_the_twin(monkeypatch):
    """A CPU window never reaches the kernel's wrapper, and is the plain
    chain: packed_device_stage, then mp3_window_dsp."""
    def refuse(*a, **k):
        raise AssertionError("window_dsp_cuda called for a CPU window")
    monkeypatch.setattr(D, "window_dsp_cuda", refuse)
    case = window_case("intensity", windows=1)
    win = case["windows"][0]
    t = _tensors(win)
    shape = {k: case[k] for k in ("B", "G", "nch")}
    ov, sh = torch.from_numpy(case["overlap"]), torch.from_numpy(case["shist"])
    got = mp3_huff.packed_window(t["pool"], t["meta16"], t["scfq"], t["ist"],
                                 ov, sh, t["n_act"], W=win["W"],
                                 mpeg1=case["mpeg1"], short=case["short"],
                                 **shape)
    xq, aa, wt = mp3_huff.packed_device_stage(
        t["pool"], t["meta16"], t["scfq"], win["W"], case["B"], case["G"],
        case["nch"], ist=t["ist"], mpeg1=case["mpeg1"], short=case["short"])
    want = D.mp3_window_dsp(xq, aa, wt, ov, sh, t["n_act"], nch=case["nch"],
                            ngr=case["G"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _k14_emulate(q, meta16, scfq, n_act, ov_in, sh_in, abcd, B, G, nch,
                 short):
    """csrc/mp3_dsp.cu's blocks one after another, in numpy float32: its
    tables read out of the blob, its index math, its stages.  Returns
    (operand [L, 1088], overlap', shist'), NaN wherever it wrote nothing."""
    P = _blob_parts()
    f32 = np.float32
    out = np.full((B * G * nch, 34, 32), np.nan, f32)
    ov_out = np.full_like(ov_in, np.nan)
    sh_out = np.full_like(sh_in, np.nan)
    for b in range(B):
        n = min(max(int(n_act[b]), 0), G)
        for g in range(G):
            first = 0 if g > 0 else 1
            info, xb = {}, {}
            for s in range(first, 2):
                lane0 = (b * G + g - 1 + s) * nch
                x = []
                for c in range(nch):
                    m = meta16[lane0 + c].astype(np.int64)
                    bt = int(m[mp3_huff.M_BTYPE])
                    info[s, c] = (min(max(int(m[mp3_huff.M_PATTERN]), 0), 47),
                                  bt if 0 <= bt <= 3 else 0,
                                  int(m[mp3_huff.M_STEREO]))
                    qi = q[lane0 + c].astype(np.int64)
                    e = scfq[lane0 + c][P["band"][info[s, c][0]]]\
                        .astype(np.int64)
                    gain = np.ldexp(P["pow4"][e & 3], e >> 2).astype(f32)
                    v = P["p43"][np.minimum(np.abs(qi), 8207)] * gain
                    x.append(np.where(qi < 0, -v, np.where(qi > 0, v, 0))
                             .astype(f32))
                if abcd is not None:
                    m = abcd[lane0 // nch][:, P["band"][info[s, 0][0]]]
                    l, r = x
                    x = [m[0] * l + m[1] * r, m[2] * l + m[3] * r]
                v = [x[c][P["perm"][info[s, c][0]]] if short else x[c]
                     for c in range(nch)]
                if nch == 2 and abcd is None and info[s, 0][2] & 1:
                    v = [v[0] + v[1], v[0] - v[1]]
                rows = [vc.reshape(32, 18).copy() for vc in v]
                for c, row in enumerate(rows):
                    for kb in range(min(P["aa"][info[s, c][0]], 31)):
                        u = row[kb + 1, :8].copy()
                        d = row[kb, 17:9:-1].copy()
                        row[kb + 1, :8] = u * P["cs"] - d * P["ca"]
                        row[kb, 17:9:-1] = u * P["ca"] + d * P["cs"]
                xb[s] = rows
            for c in range(nch):
                def imdct(s, half):
                    p, bt, _ = info[s, c]
                    mats = P["uv"][P["wt"][p, bt]]          # [32, 18, 36]
                    return np.einsum("kj,kjt->kt", xb[s][c],
                                     mats[:, :, 18 * half: 18 * half + 18])
                prev = imdct(0, 1) if first == 0 else ov_in[b, c]
                sv = (imdct(1, 0) + prev).astype(f32)     # [band, slot]
                sv[1::2, 1::2] *= -1
                row = (b * G + g) * nch + c
                out[row, 16:] = sv.T
                if g + 1 < G:
                    out[row + nch, :16] = sv.T[2:]
                if g == 0:
                    out[row, :16] = sh_in[b, c]
                if g == n - 1:
                    ov_out[b, c] = imdct(1, 1)
                    sh_out[b, c] = sv.T[2:]
                elif n == 0 and g == 0:
                    ov_out[b, c] = ov_in[b, c]
                    sh_out[b, c] = sh_in[b, c]
    return out.reshape(B * G * nch, 1088), ov_out, sh_out


def _gap_of_peak(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_k14_emulation_matches_twin(name):
    """Two chained windows of each case: the emulated kernel's operand,
    times SYNTH_TOEPLITZ and viewed as [B, G, nch, 576], is the twin's PCM,
    and its carried overlap and slot history are the twin's, within
    TOL_OF_PEAK; every operand and state element is written."""
    case = window_case(name)
    B, G, nch = case["B"], case["G"], case["nch"]
    state_t = [torch.from_numpy(case["overlap"]),
               torch.from_numpy(case["shist"])]
    state_e = [case["overlap"], case["shist"]]
    for win in case["windows"]:
        t = _tensors(win)
        q, _ = mp3_huff.huff_decode(t["pool"], t["meta16"], win["W"],
                                    win["lanes_per_frame"])
        xq, aa, wt = mp3_huff.spectrum_stage(
            q, t["meta16"], t["scfq"], B, G, nch, ist=t["ist"],
            mpeg1=case["mpeg1"], short=case["short"])
        pcm_t, *state_t = D.mp3_window_dsp(xq, aa, wt, *state_t, t["n_act"],
                                           nch=nch, ngr=G)
        abcd = None
        if t["ist"] is not None:
            abcd = mp3_huff._window_abcd(
                q, t["meta16"][:, mp3_huff.M_PATTERN].to(torch.int64),
                t["meta16"][:, mp3_huff.M_STEREO].to(torch.int64), t["ist"],
                B * G, nch, case["mpeg1"]).numpy()
        operand, *state_e = _k14_emulate(
            q.numpy(), win["meta16"], win["scfq"], win["n_act"], *state_e,
            abcd, B, G, nch, case["short"])
        for a in (operand, *state_e):
            assert np.isfinite(a).all()
        pcm_e = (operand.astype(np.float64) @ D.SYNTH_TOEPLITZ)\
            .reshape(B, G, nch, 576)
        assert _gap_of_peak(pcm_e, pcm_t.numpy()) <= TOL_OF_PEAK
        for e, w in zip(state_e, state_t):
            assert _gap_of_peak(e, w.numpy()) <= TOL_OF_PEAK


# ------------------------------------------ K15, the polyphase synthesis
#: the emulated K15 on unit impulses against SYNTH_FIR (extracted in
#: float64 and rounded once): float32 rounding at each stage of the DCT and
#: of the window's 16 taps, a few ulps of the peak
IMPULSE_TOL = 1e-6


def _gen_mp3_synth():
    """tools/gen_mp3_synth.py, the generator SYNTH_FIR came from."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "gen_mp3_synth.py")
    spec = importlib.util.spec_from_file_location("gen_mp3_synth", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dct_emulate(y):
    """csrc/mp3_dsp.cu dct32 over the last axis, in numpy float32: minimp3's
    DCT-II in the order of tools/gen_mp3_synth.py dct2_32, each step
    rounded alone, its constants read out of the blob."""
    f = D.synth_blob()
    sec, kc = f[D.SYN_SEC:D.SYN_K], f[D.SYN_K:D.SYN_WORDS]
    y = y.astype(np.float32)
    t = [[None] * 8 for _ in range(4)]
    for i in range(8):
        x0, x1, x2, x3 = y[..., i], y[..., 15 - i], y[..., 16 + i], \
            y[..., 31 - i]
        t0, t1 = x0 + x3, x1 + x2
        t2 = (x1 - x2) * sec[3 * i]
        t3 = (x0 - x3) * sec[3 * i + 1]
        t[0][i] = t0 + t1
        t[1][i] = (t0 - t1) * sec[3 * i + 2]
        t[2][i] = t3 + t2
        t[3][i] = (t3 - t2) * sec[3 * i + 2]
    for x in t:
        xt = x[0] - x[7]
        x[0] = x[0] + x[7]
        x7 = x[1] - x[6]
        x[1] = x[1] + x[6]
        x6 = x[2] - x[5]
        x[2] = x[2] + x[5]
        x5 = x[3] - x[4]
        x[3] = x[3] + x[4]
        x4 = x[0] - x[3]
        x[0] = x[0] + x[3]
        x3 = x[1] - x[2]
        x[1] = x[1] + x[2]
        x[0], x[4] = x[0] + x[1], (x[0] - x[1]) * kc[0]
        x5 = x5 + x6
        x6 = (x6 + x7) * kc[0]
        x7 = x7 + xt
        x3 = (x3 + x4) * kc[0]
        x5 = x5 - x7 * kc[1]
        x7 = x7 + x5 * kc[2]
        x5 = x5 - x7 * kc[1]
        x0 = xt - x6
        xt = xt + x6
        x[1] = (xt + x7) * kc[3]
        x[2] = (x4 + x3) * kc[4]
        x[3] = (x0 - x5) * kc[5]
        x[5] = (x0 + x5) * kc[6]
        x[6] = (x4 - x3) * kc[7]
        x[7] = (xt - x7) * kc[8]
    out = [None] * 32
    for i in range(7):
        out[4 * i] = t[0][i]
        out[4 * i + 1] = t[2][i] + t[3][i] + t[3][i + 1]
        out[4 * i + 2] = t[1][i] + t[1][i + 1]
        out[4 * i + 3] = t[2][i + 1] + t[3][i] + t[3][i + 1]
    out[28], out[29] = t[0][7], t[2][7] + t[3][7]
    out[30], out[31] = t[1][7], t[3][7]
    return np.stack(out, axis=-1)


def _k15_emulate(operand):
    """csrc/mp3_dsp.cu's K15 in numpy float32: the DCT of every slot of
    each [34 x 32] row, then each output sample's window, the pairs of ages
    (k, 15 - k) summed for k = 0..7, its taps read out of the blob.
    Returns pcm [L, 576]."""
    f = D.synth_blob()
    coef = f[D.SYN_COEF:D.SYN_M].reshape(32, 16)
    m = f[D.SYN_M:D.SYN_SEC].view(np.int32).reshape(32, 2)
    L = operand.shape[0]
    V = _dct_emulate(operand.reshape(L, 34, 32))
    pcm = np.empty((L, 18, 32), np.float32)
    for t in range(18):
        for k in range(8):
            # slot t + 16 - r has age r: ages k and 15 - k
            pair = (coef[:, k] * V[:, t + 16 - k, m[:, k & 1]]
                    + coef[:, 15 - k] * V[:, t + 1 + k, m[:, (15 - k) & 1]])
            pcm[:, t] = pair if k == 0 else pcm[:, t] + pair
    return pcm.reshape(L, 576)


def test_synth_blob_holds_minimp3s_constants():
    """K15's constants are the generator's: g_sec, and the taps of g_win
    and mp3d_synth_pair laid out by output sample and age."""
    gen = _gen_mp3_synth()
    g_sec, g_win = gen.load_tables()
    f = D.synth_blob()
    assert f.dtype == np.float32 and f.shape == (D.SYN_WORDS,)
    np.testing.assert_array_equal(f[D.SYN_SEC:D.SYN_K],
                                  g_sec.astype(np.float32))
    coef, m = D._synth_taps()
    np.testing.assert_array_equal(f[D.SYN_COEF:D.SYN_M], coef.reshape(-1))
    np.testing.assert_array_equal(f[D.SYN_M:D.SYN_SEC].view(np.int32),
                                  m.reshape(-1))
    # every tap is a g_win value (or a synth_pair literal) over 32768
    taps = np.abs(coef[np.r_[1:16, 17:32]]) * 32768
    assert set(taps.ravel()) == set(np.abs(g_win))
    assert (m >= 0).all() and (m < 32).all()


def test_k15_dct_is_minimp3s():
    """The emulated kernel's DCT is dct2_32 to within float32 rounding."""
    gen = _gen_mp3_synth()
    g_sec, _ = gen.load_tables()
    y = np.random.default_rng(15).normal(0, 1, (64, 32)).astype(np.float32)
    want = np.stack([gen.dct2_32(row.astype(np.float64), g_sec)
                     for row in y])
    got = _dct_emulate(y)
    assert _gap_of_peak(got, want) <= IMPULSE_TOL


def test_k15_emulation_reproduces_synth_fir():
    """On unit impulses (an operand row a subband sample: slot u, band k)
    the emulated kernel gives SYNTH_FIR's taps where the Toeplitz form puts
    them, output slot t tap 16 + t - u, and zeros elsewhere: the constants
    and the slot alignment are the generator's."""
    eye = np.eye(34 * 32, dtype=np.float32)
    got = _k15_emulate(eye).reshape(34, 32, 18, 32)   # [u, k, t, j]
    want = np.zeros((34, 32, 18, 32))
    for u in range(34):
        for t in range(18):
            if 0 <= 16 + t - u <= 16:
                want[u, :, t] = D.SYNTH_FIR[16 + t - u].T
    assert _gap_of_peak(got, want) <= IMPULSE_TOL
    assert not got[0].any()   # slot 0 of a row: SYNTH_FIR's tap 16 is 0


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_k15_emulation_matches_the_product(name):
    """Two chained windows of each case, on the emulated K14's operand:
    the emulated K15 is the synthesis product (operand @ SYNTH_TOEPLITZ in
    float64) within TOL_OF_PEAK."""
    case = window_case(name)
    B, G, nch = case["B"], case["G"], case["nch"]
    state = [case["overlap"], case["shist"]]
    for win in case["windows"]:
        t = _tensors(win)
        q, _ = mp3_huff.huff_decode(t["pool"], t["meta16"], win["W"],
                                    win["lanes_per_frame"])
        abcd = None
        if t["ist"] is not None:
            abcd = mp3_huff._window_abcd(
                q, t["meta16"][:, mp3_huff.M_PATTERN].to(torch.int64),
                t["meta16"][:, mp3_huff.M_STEREO].to(torch.int64), t["ist"],
                B * G, nch, case["mpeg1"]).numpy()
        operand, *state = _k14_emulate(
            q.numpy(), win["meta16"], win["scfq"], win["n_act"], *state,
            abcd, B, G, nch, case["short"])
        want = operand.astype(np.float64) @ D.SYNTH_TOEPLITZ.astype(
            np.float64)
        got = _k15_emulate(operand)
        assert np.isfinite(got).all()
        assert _gap_of_peak(got, want) <= TOL_OF_PEAK


def test_synth_cuda_refuses_cpu_tensors():
    """A CPU operand never reaches the kernel; synth_twin takes it."""
    x = torch.zeros((2, 1088))
    with pytest.raises(_kernels.KernelArgError):
        D.synth_cuda(x)
    assert D.synth_twin(x).shape == (2, 576)
