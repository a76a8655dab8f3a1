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
