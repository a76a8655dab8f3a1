"""Golden MPEG-1 Layer III test-stream generator + independent numpy DSP.

The encoder emits spec-conformant Layer III bitstreams from *chosen spectral
content*: you hand it quantized values q[576] (+ global_gain) per
granule/channel and it produces valid frames (side info, scalefactors,
big-values/count1 Huffman with region/table selection, optional Xing header
frame with LAME delay/padding).  Because the content is known exactly, the
expected decoder output is computable by an independent numpy pipeline
(dequant → antialias → IMDCT/OLA → synthesis FIR), giving end-to-end
conformance without any external encoder.

Shares only the canonical spec tables with the implementation under test.
A frozen copy of tests/golden/mp3_ref.py that reads the benchmark's own
copies of the spec tables (mp3_tables.py, mp3_synth_fir.npz).
"""

from __future__ import annotations

import os

import numpy as np

from . import mp3_tables as T

SFB_LONG_44100 = [4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34,
                  42, 50, 54, 76, 158]
SFB_SHORT_44100 = [4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 6, 6, 6, 8, 8, 8,
                   10, 10, 10, 12, 12, 12, 14, 14, 14, 18, 18, 18, 22, 22, 22,
                   30, 30, 30, 56, 56, 56]


class _BW:
    def __init__(self):
        self.bits = []

    def w(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def nbits(self):
        return len(self.bits)

    def tobytes(self, pad_to=None):
        bits = self.bits[:]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        if pad_to is not None:
            out.extend(b"\0" * (pad_to - len(out)))
        return bytes(out)


# Huffman encode maps from the canonical tables
_BIG_ENC = []
for codes in T.HUFF_TABLES:
    _BIG_ENC.append({(x, y): (c, l) for c, l, x, y in codes} if codes else None)
_C1_ENC = [{v: (c, l) for c, l, v in T.COUNT1_A},
           {v: (c, l) for c, l, v in T.COUNT1_B}]


def _pick_table(maxval: int) -> int:
    if maxval == 0:
        return 0
    if maxval <= 15:
        return 15
    for t in range(16, 24):
        if 15 + (1 << T.LINBITS[t]) - 1 >= maxval:
            return t
    return 23  # linbits 13: max 8206


def _encode_bigvalue_pair(bw: _BW, x: int, y: int, table: int):
    enc = _BIG_ENC[table]
    linbits = T.LINBITS[table]
    ax, ay = abs(x), abs(y)
    cx = min(ax, 15)
    cy = min(ay, 15)
    code, ln = enc[(cx, cy)]
    bw.w(code, ln)
    for v, cv in ((x, cx), (y, cy)):
        if cv == 15 and linbits:
            bw.w(abs(v) - 15, linbits)
        if cv:
            bw.w(1 if v < 0 else 0, 1)


def encode_granule_data(bw: _BW, q: np.ndarray, block_type: int = 0,
                        sfb_long=None, sfb_short=None):
    """Huffman-encode q[576]; returns side-info fields dict.  Long blocks use
    3 regions; short blocks use the fixed (region0=8) layout."""
    q = np.asarray(q, dtype=np.int64)
    assert q.shape == (576,)
    sfb = ((sfb_short or SFB_SHORT_44100) if block_type == 2
           else (sfb_long or SFB_LONG_44100))
    bounds = np.cumsum([0] + list(sfb))

    # choose big_values: cover all |q|>1 with pairs; extend to sfb boundary
    nz = np.flatnonzero(np.abs(q) > 1)
    big_pairs_end = int(nz[-1]) + 1 if nz.size else 0
    # align up to an sfb boundary so region accounting is simple
    big_end = int(bounds[np.searchsorted(bounds, big_pairs_end, side="left")])
    big_values = big_end // 2
    assert big_values <= 288

    # count1: cover remaining ±1 values in quads
    nz1 = np.flatnonzero(np.abs(q[big_end:]) > 0)
    count1_len = (int(nz1[-1]) + 4) // 4 * 4 if nz1.size else 0
    assert np.all(np.abs(q[big_end : big_end + count1_len]) <= 1)

    # regions (long blocks): split big-values sfbs 2/1/rest
    sfb_end = int(np.searchsorted(bounds, big_end))  # sfbs covering big
    if block_type == 2:
        # window switching implies region_count[0]=8 → 9 sfb entries
        r0_end = int(bounds[min(9, len(bounds) - 1)])
        regions = [(0, min(r0_end, big_end)), (min(r0_end, big_end), big_end)]
        tables = []
        for s, e in regions:
            tables.append(_pick_table(int(np.max(np.abs(q[s:e]))) if e > s else 0))
        tables.append(0)
        region_count = None
    else:
        # region_count is count-1 semantics: r0 → r0+1 sfbs
        r0 = min(2, max(0, sfb_end - 1))
        r1 = min(2, max(0, sfb_end - (r0 + 1) - 1))
        b0 = int(bounds[min(r0 + 1, len(bounds) - 1)])
        b1 = int(bounds[min(r0 + 1 + r1 + 1, len(bounds) - 1)])
        b0 = min(b0, big_end)
        b1 = min(max(b1, b0), big_end)
        regions = [(0, b0), (b0, b1), (b1, big_end)]
        tables = [
            _pick_table(int(np.max(np.abs(q[s:e]))) if e > s else 0)
            for s, e in regions
        ]
        region_count = (r0, r1)

    start_bits = bw.nbits()
    for (s, e), tab in zip(regions, tables):
        if tab == 0:
            assert not np.any(q[s:e]), "table 0 region must be silent"
        for i in range(s, e, 2):
            if tab == 0:
                continue
            _encode_bigvalue_pair(bw, int(q[i]), int(q[i + 1]), tab)

    count1_table = 1  # table B: fixed 4-bit codes
    for i in range(big_end, big_end + count1_len, 4):
        vals = [int(q[i + j]) for j in range(4)]
        mask = 0
        for v in vals:
            mask = (mask << 1) | (1 if v else 0)
        code, ln = _C1_ENC[count1_table][mask]
        bw.w(code, ln)
        for v in vals:
            if v:
                bw.w(1 if v < 0 else 0, 1)

    return {
        "big_values": big_values,
        "tables": tables,
        "region_count": region_count,
        "count1_table": count1_table,
        "part23_extra": bw.nbits() - start_bits,
        "block_type": block_type,
    }


def build_mp3(granules, channels: int, global_gain: int = 214,
              bitrate_idx: int = 14, xing: bool = False,
              xing_delay: int = 0, xing_padding: int = 0,
              free_format_bytes: int = 0, mode_ext=None) -> bytes:
    """granules: list of per-frame lists [ngr][nch] of dicts
    {"q": int[576], "block_type": 0|2}.  44.1 kHz MPEG-1 Layer III.

    mode_ext: None for plain stereo/mono, or an int / per-frame list of
    ints for JOINT stereo (2 = mid/side, 1 = intensity, 3 = both bits);
    frame headers may switch mode_ext mid-stream like real encoders."""
    frames = bytearray()
    joint = mode_ext is not None and channels == 2
    mode = 3 if channels == 1 else (1 if joint else 0)
    h1 = 0xFB  # MPEG1, Layer III, no CRC
    sr_code = 0  # 44100
    exts = None
    if joint:
        exts = (list(mode_ext) if isinstance(mode_ext, (list, tuple))
                else [mode_ext] * len(granules))

    def frame_header(pad=0, fi=0):
        b2 = (bitrate_idx << 4) | (sr_code << 2) | (pad << 1)
        b3 = (mode << 6) | ((exts[min(fi, len(exts) - 1)] << 4) if joint
                            else 0)
        return bytes([0xFF, h1, b2, b3])

    kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320][bitrate_idx]
    frame_bytes = 1152 * kbps * 125 // 44100
    if bitrate_idx == 0:
        # free format: constant frame size chosen by the caller
        assert free_format_bytes > 0
        frame_bytes = free_format_bytes

    def side_info_and_data(frame_granules):
        side = _BW()
        data = _BW()
        side.w(0, 9)  # main_data_begin = 0 (no reservoir)
        side.w(0, 5 if channels == 1 else 3)  # private bits
        for _ in range(channels):
            side.w(0, 4)  # scfsi
        for gr_ch in frame_granules:
            for ch in range(channels):
                info = gr_ch[ch]
                q = info["q"]
                bt = info.get("block_type", 0)
                meta = encode_granule_data(data, q, bt)
                part23 = meta["part23_extra"]  # scalefactor bits are 0
                side.w(part23, 12)
                side.w(meta["big_values"], 9)
                side.w(info.get("global_gain", global_gain), 8)
                side.w(0, 4)  # scalefac_compress = 0 → 0 scf bits
                if bt == 2:
                    side.w(1, 1)  # window switching
                    side.w(2, 2)  # block type short
                    side.w(0, 1)  # not mixed
                    side.w(meta["tables"][0], 5)
                    side.w(meta["tables"][1], 5)
                    side.w(0, 3)
                    side.w(0, 3)
                    side.w(0, 3)  # subblock gains
                else:
                    side.w(0, 1)
                    for t in meta["tables"]:
                        side.w(t, 5)
                    side.w(meta["region_count"][0], 4)
                    side.w(meta["region_count"][1], 3)
                side.w(0, 1)  # preflag
                side.w(0, 1)  # scalefac_scale
                side.w(meta["count1_table"], 1)
        return side, data

    if xing:
        # Xing header frame: empty side info + tag
        side = _BW()
        side.w(0, 9)
        side.w(0, 5 if channels == 1 else 3)
        for _ in range(channels):
            side.w(0, 4)
        for _ in range(2 * channels):
            side.w(0, 59)
        body = side.tobytes()
        tag = b"Xing" + (1).to_bytes(4, "big") + len(granules).to_bytes(4, "big")
        lame = bytearray(b"LAME4.99" + b"\0" * 13)
        d = xing_delay
        p = xing_padding
        lame += bytes([(d >> 4) & 0xFF, ((d & 0xF) << 4) | ((p >> 8) & 0xF),
                       p & 0xFF])
        lame += b"\0" * 11
        payload = frame_header() + body + tag + bytes(lame)
        frames += payload + b"\0" * (frame_bytes - len(payload))

    for fi, frame_granules in enumerate(granules):
        side, data = side_info_and_data(frame_granules)
        payload = frame_header(fi=fi) + side.tobytes() + data.tobytes()
        assert len(payload) <= frame_bytes, (
            f"frame overflow: {len(payload)} > {frame_bytes}"
        )
        frames += payload + b"\0" * (frame_bytes - len(payload))
    return bytes(frames)


# ---------------------------------------------------------------------------
# Independent numpy decode pipeline (long & short blocks, no stereo modes)
# ---------------------------------------------------------------------------

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI**2)
_CA = np.abs(_CI) / np.sqrt(1.0 + _CI**2)
_FIR = np.load(os.path.join(os.path.dirname(__file__),
                            "mp3_synth_fir.npz"))["W"].astype(np.float64)


def dequant(q, global_gain=214):
    q = np.asarray(q, dtype=np.float64)
    scale = 2.0 ** ((global_gain - 4 - 210) / 4.0)
    return np.sign(q) * np.abs(q) ** (4.0 / 3.0) * scale


def reorder_short(x):
    """L3_reorder for non-mixed short blocks at 44.1kHz."""
    out = x.copy()
    pos = 0
    dst = 0
    for i in range(0, len(SFB_SHORT_44100), 3):
        ln = SFB_SHORT_44100[i]
        for j in range(ln):
            out[dst] = x[pos + j]
            out[dst + 1] = x[pos + ln + j]
            out[dst + 2] = x[pos + 2 * ln + j]
            dst += 3
        pos += 3 * ln
    return out


def antialias(x, nbands=31):
    x = x.reshape(32, 18).copy()
    for b in range(nbands):
        for i in range(8):
            u = x[b + 1, i]
            d = x[b, 17 - i]
            x[b + 1, i] = u * _CS[i] - d * _CA[i]
            x[b, 17 - i] = u * _CA[i] + d * _CS[i]
    return x.reshape(576)


def imdct_long(X, overlap, kind=0):
    """X: [32,18]; overlap [32,18]; kind 0=normal 1=start 3=stop."""
    n = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    C = np.cos(np.pi / 72 * (2 * n + 19) * (2 * k + 1))
    w = np.sin(np.pi / 36 * (np.arange(36) + 0.5))
    if kind == 1:
        w[18:24] = 1
        w[24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
        w[30:] = 0
    elif kind == 3:
        w[:6] = 0
        w[6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
        w[12:18] = 1
    z = (X @ C.T) * w  # [32, 36]
    out = overlap + z[:, :18]
    return out, z[:, 18:]


def imdct_short(X, overlap):
    n = np.arange(12)[:, None]
    k = np.arange(6)[None, :]
    C = np.cos(np.pi / 24 * (2 * n + 7) * (2 * k + 1))
    w12 = np.sin(np.pi / 12 * (np.arange(12) + 0.5))
    z = np.zeros((32, 36))
    for j in range(3):
        sub = X[:, j::3] @ C.T * w12  # [32, 12]
        z[:, 6 + 6 * j : 18 + 6 * j] += sub
    out = overlap + z[:, :18]
    return out, z[:, 18:]


_SIGNMASK = np.ones((32, 18))
_SIGNMASK[1::2, 1::2] = -1


def synth_granules(grbufs):
    """grbufs: list of [32,18] (post change-sign); returns pcm [n*576]."""
    S = np.concatenate([g.T for g in grbufs])  # [n*18, 32]
    Spad = np.concatenate([np.zeros((16, 32)), S])
    out = np.zeros((S.shape[0], 32))
    for t in range(S.shape[0]):
        for r in range(17):
            out[t] += _FIR[r] @ Spad[16 + t - r]
    return out.reshape(-1)


def decode_mono(granule_qs, global_gain=214, block_types=None):
    """Full golden decode of mono long/short-block granules."""
    overlap = np.zeros((32, 18))
    grbufs = []
    block_types = block_types or [0] * len(granule_qs)
    for q, bt in zip(granule_qs, block_types):
        x = dequant(q, global_gain)
        if bt == 2:
            x = reorder_short(x)
            X = x.reshape(32, 18)
            out, overlap = imdct_short(X, overlap)
        else:
            x = antialias(x)
            X = x.reshape(32, 18)
            out, overlap = imdct_long(X, overlap, kind=0)
        grbufs.append(out * _SIGNMASK)
    return synth_granules(grbufs)


# ---------------------------------------------------------------------------
# Layer II fixture generator (MPEG-1, 44.1 kHz)
# ---------------------------------------------------------------------------

BITALLOC_CODE_TAB = [
    0, 17, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    0, 17, 18, 3, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16,
    0, 17, 18, 3, 19, 4, 5, 16,
    0, 17, 18, 16,
    0, 17, 18, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    0, 17, 18, 3, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]
DEQ_L12 = [
    3.17891e-07, 2.52311e-07, 2.00259e-07, 1.36239e-07, 1.08133e-07,
    8.58253e-08, 6.35783e-08, 5.04621e-08, 4.00518e-08, 3.07637e-08,
    2.44172e-08, 1.93799e-08, 1.51377e-08, 1.20148e-08, 9.53615e-09,
    7.50925e-09, 5.96009e-09, 4.73053e-09, 3.7399e-09, 2.96836e-09,
    2.35599e-09, 1.86629e-09, 1.48128e-09, 1.17569e-09, 9.32233e-10,
    7.39914e-10, 5.8727e-10, 4.65889e-10, 3.69776e-10, 2.93492e-10,
    2.32888e-10, 1.84843e-10, 1.4671e-10, 1.1643e-10, 9.24102e-11,
    7.3346e-11, 5.82112e-11, 4.62023e-11, 3.66708e-11, 2.91047e-11,
    2.31004e-11, 1.83348e-11, 1.45521e-11, 1.155e-11, 9.16727e-12,
    3.17891e-07, 2.52311e-07, 2.00259e-07, 1.90735e-07, 1.51386e-07,
    1.20155e-07, 1.05964e-07, 8.41035e-08, 6.6753e-08,
]
# 192 kbps mono @ 44.1 kHz MPEG-1: alloc regions (offset, width, bands)
L2_ALLOC = [(0, 4, 3), (16, 4, 8), (32, 3, 12), (40, 2, 7)]
L2_NBANDS = 30


class _MSB:
    def __init__(self):
        self.bits = []

    def w(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def tobytes(self, pad_to):
        bits = self.bits[:]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        assert len(out) <= pad_to, (len(out), pad_to)
        return bytes(out) + b"\0" * (pad_to - len(out))


def _l2_code_for_ba(tab_off, width, ba):
    for c in range(1 << width):
        if BITALLOC_CODE_TAB[tab_off + c] == ba:
            return c
    raise ValueError((tab_off, ba))


def build_mp3_l2(granule_q, scf_idx, ba=3, frames_bitrate_idx=10):
    """Mono MPEG-1 Layer II 44.1 kHz frames.

    granule_q: [n_frames][3][30][12] quantized values (0 .. 2^ba-1)
    scf_idx:   [n_frames][30] 6-bit scalefactor index per band
    All 30 bands use the same bit allocation `ba` (a direct quantizer < 17).
    Returns (bytes, expected_S) where expected_S is [n_frames*36, 32] float
    subband slot vectors (for the synthesis expectation).
    """
    import numpy as np

    out = bytearray()
    S_all = []
    frame_bytes = 1152 * 192 * 125 // 44100
    # the top allocation region (bands 23+) only offers grouped quantizers;
    # keep those bands silent so a single direct `ba` covers the rest
    def band_ba(band):
        return ba if band < 23 else 0

    for q, scfs in zip(granule_q, scf_idx):
        bw = _MSB()
        # bitalloc codes per band
        for band in range(L2_NBANDS):
            off, width = _l2_region(band)
            bw.w(_l2_code_for_ba(off, width, band_ba(band)), width)
        # scfcod = 2 (single scalefactor), only for allocated bands
        for band in range(L2_NBANDS):
            if band_ba(band):
                bw.w(2, 2)
        # scalefactors (mask=4: one 6-bit value) — only for allocated bands
        for band in range(L2_NBANDS):
            if band_ba(band):
                bw.w(scfs[band], 6)
        # sample data: 3 granules x 4 groups x bands x 3 samples
        half = (1 << (ba - 1)) - 1
        for igr in range(3):
            for j in range(4):
                for band in range(L2_NBANDS):
                    if band_ba(band):
                        for k in range(3):
                            bw.w(int(q[igr][band][j * 3 + k]), ba)
        hdr = bytes([0xFF, 0xFD, (frames_bitrate_idx << 4) | 0, 0xC0])
        out += hdr + bw.tobytes(frame_bytes - 4)
        # expectation: S[slot, band] = (q - half) * scf
        S = np.zeros((36, 32))
        for igr in range(3):
            for band in range(L2_NBANDS):
                if not band_ba(band):
                    continue
                scf = DEQ_L12[ba * 3 - 6 + scfs[band] % 3] * \
                    float(1 << 21 >> (scfs[band] // 3))
                for t in range(12):
                    S[igr * 12 + t, band] = \
                        (q[igr][band][t] - half) * scf
        S_all.append(S)
    return bytes(out), np.concatenate(S_all)


def _l2_region(band):
    k = 0
    for off, width, cnt in L2_ALLOC:
        if band < k + cnt:
            return off, width
        k += cnt
    raise ValueError(band)


def _region_iter():
    return []


def synth_expected(S):
    """Synthesis expectation for subband slots S [T, 32] (mono)."""
    import numpy as np

    Spad = np.concatenate([np.zeros((16, 32)), S])
    out = np.zeros((S.shape[0], 32))
    for t in range(S.shape[0]):
        for r in range(17):
            out[t] += _FIR[r] @ Spad[16 + t - r]
    return out.reshape(-1)


def build_mp3_l1(granule_q, scf_idx, ba=4):
    """Mono MPEG-1 Layer I 44.1 kHz frames (288 kbps).

    granule_q: [n_frames][32 bands][12 samples] values in 0..2^ba-1
    scf_idx:   [n_frames][32] 6-bit scalefactor indices
    """
    import numpy as np

    out = bytearray()
    S_all = []
    frame_bytes = (384 * 448 * 125 // 44100) & ~3
    l1_tab_off = 76
    for q, scfs in zip(granule_q, scf_idx):
        bw = _MSB()
        for band in range(32):
            c = 0
            for cand in range(16):
                if BITALLOC_CODE_TAB[l1_tab_off + cand] == ba:
                    c = cand
                    break
            bw.w(c, 4)
        for band in range(32):
            bw.w(scfs[band], 6)
        half = (1 << (ba - 1)) - 1
        for igr in range(3):
            for j in range(4):
                for band in range(32):
                    bw.w(int(q[band][igr * 4 + j]), ba)
        hdr = bytes([0xFF, 0xFF, (14 << 4) | 0, 0xC0])
        out += hdr + bw.tobytes(frame_bytes - 4)
        S = np.zeros((12, 32))
        for band in range(32):
            scf = DEQ_L12[ba * 3 - 6 + scfs[band] % 3] * \
                float(1 << 21 >> (scfs[band] // 3))
            for t in range(12):
                S[t, band] = (q[band][t] - half) * scf
        S_all.append(S)
    return bytes(out), np.concatenate(S_all)


# ---------------------------------------------------------------------------
# MPEG-2 Layer III builder (22.05 kHz): one granule per frame, 9-bit
# scalefac_compress with the ISO 13818-3 partition machinery, no scfsi, no
# preflag bit.  Spec constants inlined (independent of the decoder package).
# ---------------------------------------------------------------------------

SFB_LONG_22050 = [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38,
                  46, 52, 60, 68, 58, 54]
SFB_SHORT_22050 = [4, 4, 4, 4, 4, 4, 4, 4, 4, 6, 6, 6, 6, 6, 6, 8, 8, 8,
                   10, 10, 10, 14, 14, 14, 18, 18, 18, 26, 26, 26, 32, 32,
                   32, 42, 42, 42, 18, 18, 18]
# scalefactor size moduli (normal rows 0..2, intensity rows 3..5) and the
# long-block partition counts table (ISO 13818-3 / minimp3 g_scf_mod +
# g_scf_partitions row 0)
_M2_SCF_MOD = [[5, 5, 4, 4], [5, 5, 4, 1], [4, 3, 1, 1],
               [5, 6, 6, 1], [4, 4, 4, 1], [4, 3, 1, 1]]
_M2_PART_LONG = [6, 5, 5, 5, 6, 5, 5, 5, 6, 5, 7, 3, 11, 10, 0, 0,
                 7, 7, 7, 0, 6, 6, 6, 3, 8, 8, 5, 0]


def _m2_scf_layout(scalefac_compress: int, ist: bool):
    """Mirror of the decoder's MPEG-2 partition walk: returns
    (scf_size[4], scf_count[4]) for the given 9-bit scalefac_compress."""
    sfc = scalefac_compress >> (1 if ist else 0)
    k = 3 if ist else 0
    sizes = [0, 0, 0, 0]
    while sfc >= 0:
        modprod = 1
        for i in range(3, -1, -1):
            sizes[i] = (sfc // modprod) % _M2_SCF_MOD[k][i]
            modprod *= _M2_SCF_MOD[k][i]
        sfc -= modprod
        k += 1
    counts = _M2_PART_LONG[k * 4 : k * 4 + 4]
    return sizes, counts


def build_mp3_mpeg2(granules, channels: int, global_gain: int = 214,
                    bitrate_idx: int = 12, mode_ext=None,
                    ch1_sfc: int = 0, ch1_iscf=None) -> bytes:
    """MPEG-2 Layer III at 22.05 kHz; granules: per-frame [1][nch] dicts
    {"q": int[576], "block_type": 0|2}.

    Intensity-stereo fixtures: mode_ext=1 (or per-frame list), ch1_sfc the
    right channel's scalefac_compress, ch1_iscf the scalefactor values to
    write for it (they become the decoder's ist positions)."""
    frames = bytearray()
    joint = mode_ext is not None and channels == 2
    mode = 3 if channels == 1 else (1 if joint else 0)
    exts = None
    if joint:
        exts = (list(mode_ext) if isinstance(mode_ext, (list, tuple))
                else [mode_ext] * len(granules))
    kbps = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
            160][bitrate_idx]
    frame_bytes = 576 * kbps * 125 // 22050

    def frame_header(fi):
        b2 = (bitrate_idx << 4) | (0 << 2)  # 22050
        b3 = (mode << 6) | ((exts[min(fi, len(exts) - 1)] << 4) if joint
                            else 0)
        return bytes([0xFF, 0xF3, b2, b3])  # MPEG-2, Layer III, no CRC

    for fi, frame_granules in enumerate(granules):
        ist_frame = joint and (exts[min(fi, len(exts) - 1)] & 1)
        side = _BW()
        data = _BW()
        side.w(0, 8 + channels)  # main_data_begin=0 + private bits
        for ch in range(channels):
            info = frame_granules[0][ch]
            q = info["q"]
            bt = info.get("block_type", 0)
            # scalefactor bits precede the Huffman data in part2_3
            scf_bits = 0
            sfc = 0
            ist = bool(ist_frame and ch == 1)
            if ist:
                sfc = ch1_sfc
            sizes, counts = _m2_scf_layout(sfc, ist)
            vals = list(ch1_iscf or []) if ist else []
            vi = 0
            start = data.nbits()
            for i in range(4):
                if counts[i] == 0:
                    break
                for _ in range(counts[i]):
                    if sizes[i]:
                        v = vals[vi] if vi < len(vals) else 0
                        vi += 1
                        data.w(min(v, (1 << sizes[i]) - 2), sizes[i])
            scf_bits = data.nbits() - start
            meta = encode_granule_data(
                data, q, bt,
                sfb_long=SFB_LONG_22050, sfb_short=SFB_SHORT_22050)
            side.w(meta["part23_extra"] + scf_bits, 12)
            side.w(meta["big_values"], 9)
            side.w(info.get("global_gain", global_gain), 8)
            side.w(sfc, 9)
            if bt == 2:
                side.w(1, 1)
                side.w(2, 2)
                side.w(0, 1)  # not mixed
                side.w(meta["tables"][0], 5)
                side.w(meta["tables"][1], 5)
                side.w(0, 3)
                side.w(0, 3)
                side.w(0, 3)
            else:
                side.w(0, 1)
                for t in meta["tables"]:
                    side.w(t, 5)
                side.w(meta["region_count"][0], 4)
                side.w(meta["region_count"][1], 3)
            side.w(0, 1)  # scalefac_scale
            side.w(meta["count1_table"], 1)
        payload = frame_header(fi) + side.tobytes() + data.tobytes()
        assert len(payload) <= frame_bytes, (
            f"frame overflow: {len(payload)} > {frame_bytes}")
        frames += payload + b"\0" * (frame_bytes - len(payload))
    return bytes(frames)
