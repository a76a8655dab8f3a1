"""Seeded MP3 corpus: MPEG-1 Layer III joint stereo CBR frames from chosen
spectra, in array passes.

Every frame has main_data_begin 0 (no bit reservoir), so a frame holds its
own main data and a sequence of frames whose block types follow one
another as an encoder's do is a valid stream: the generator encodes a bank
of frames of each block-type pattern, and a stream is a seeded sequence of
them, long blocks with transients of start, short and stop blocks between.
Each granule-channel carries seeded scalefactors (scalefac_compress,
preflag, scalefac_scale, subblock gains for short blocks, scfsi reuse in
the second granule of an all-long frame) and its own global gain.  The
quantized spectra and every field that scales them are kept: the reference
decodes them again in float64.

Huffman coding follows the spec's tables with an encoder's choices: a
region's table is the one of fewest bits that holds its largest value, and
count1's table the shorter of A and B.
"""

from __future__ import annotations

import numpy as np

from . import bits
from .common import Corpus, lengths_s
from ..ref import mp3_tables as T

#: 44.1 kHz scalefactor band widths (ISO 11172-3 table B.8); short blocks
#: list each band once a window, as the bins lie before the reorder
SFB_LONG = np.array([4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34,
                     42, 50, 54, 76, 158])
SFB_SHORT = np.repeat([4, 4, 4, 4, 6, 8, 10, 12, 14, 18, 22, 30, 56], 3)
_KBPS = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
SIDE_BITS = 256     # MPEG-1 stereo side info
HEADER_BITS = 32
#: scalefac_compress -> (slen1, slen2) (ISO 11172-3 2.4.2.7)
SLEN = np.array([[0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4],
                 [0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3]])
#: preflag's added scalefactors of the 21 long bands (table B.6)
PRETAB = np.array([0] * 11 + [1, 1, 1, 1, 2, 2, 3, 3, 3, 2])
#: the scfsi group of each long band: bands 0-5, 6-10, 11-15, 16-20
SCFSI_GROUP = np.repeat(np.arange(4), [6, 5, 5, 5])
#: block-type patterns of a frame's two granules (both channels alike):
#: long, the start of a transient, a short frame, its stop
PATTERNS = np.array([[0, 0], [1, 2], [2, 2], [2, 3]])


def _tables():
    """Code and length of (x, y) for tables 1..31 as [32, 16, 16] arrays
    (length 0: no such pair), each table's largest value, its linbits."""
    code = np.zeros((32, 16, 16), np.int64)
    ln = np.zeros((32, 16, 16), np.int64)
    for t, entries in enumerate(T.HUFF_TABLES):
        for c, l, x, y in entries:
            code[t, x, y], ln[t, x, y] = c, l
    xmax = np.array([int(np.max(np.nonzero(ln[t])[0], initial=-1))
                     for t in range(32)])
    lin = np.array(T.LINBITS)
    vmax = np.where(lin > 0, 15 + (1 << lin) - 1, xmax)
    vmax[0] = 0
    c1 = np.zeros((2, 16), np.int64)
    l1 = np.zeros((2, 16), np.int64)
    for k, tab in enumerate((T.COUNT1_A, T.COUNT1_B)):
        for c, l, v in tab:
            c1[k, v], l1[k, v] = c, l
    return code, ln, vmax, lin, c1, l1


_CODE, _LEN, _VMAX, _LIN, _C1CODE, _C1LEN = _tables()
_LEN32 = _LEN.astype(np.int32)
#: candidate tables: those the spec defines (4 and 14 do not exist)
_CAND = np.array([t for t in range(1, 32) if _VMAX[t] > 0])


def spectra(rng, short, kinds_p):
    """Quantized spectra [frames, 2 granules, 2 channels, 576] of music
    frames, bench.py's recipe made dense for 320 kbit/s: per granule a
    dense (broadband, falling with frequency), tonal (strong partials on a
    quieter floor) or quiet spectrum, the second channel quieter (the side
    channel of a mid/side frame); short [frames, 2] marks the short-block
    granules."""
    nf = short.shape[0]
    kind = rng.choice(3, size=(nf, 2), p=kinds_p)
    b = np.arange(576)
    top = rng.integers(380, 440, size=(nf, 2, 1, 1))
    env = np.where(b < top, 1.0 / (1.0 + b / 24.0) ** 0.9, 0.0)
    amp = np.choose(kind, [rng.uniform(45, 75, (nf, 2)),
                           rng.uniform(12, 24, (nf, 2)),
                           rng.uniform(1.5, 3, (nf, 2))])[..., None, None]
    chan = np.array([1.0, 0.35])[None, None, :, None]
    mag = amp * chan * env * np.abs(rng.standard_normal((nf, 2, 2, 576)))
    # tonal granules: a few strong partials below bin 300
    tonal = (kind == 1)[..., None, None]
    peaks = rng.random((nf, 2, 2, 576)) < 12 / 300
    mag = np.where(tonal & peaks & (b < 300),
                   rng.uniform(20, 60, (nf, 2, 2, 576)), mag)
    return np.rint(mag).astype(np.int64) * rng.choice([-1, 1],
                                                      (nf, 2, 2, 576))


def _bounds(short):
    """Scalefactor band bounds [n, 23] (long) or [n, 40] padded to 40."""
    bl = np.concatenate([[0], np.cumsum(SFB_LONG)])
    bsh = np.concatenate([[0], np.cumsum(SFB_SHORT)])
    out = np.full((short.size, 40), 576)
    out[~short, : bl.size] = bl
    out[short, : bsh.size] = bsh
    return out


def plan(q, bt):
    """The Huffman plan of granule-channels q [n, 576] of block types bt
    [n]: the big-values end, the regions and their tables, count1's table,
    and each gc's bit length."""
    n = q.shape[0]
    short = bt == 2
    rows = np.arange(n)
    a = np.abs(q).astype(np.int32)
    big = a > 1
    last_big = np.where(big.any(1), 575 - np.argmax(big[:, ::-1], 1), -1)
    bounds = _bounds(short)
    sfb_end = np.argmax(bounds >= (last_big + 1)[:, None], 1)
    big_end = np.where(last_big < 0, 0, bounds[rows, sfb_end])
    nz = a > 0
    last_nz = np.where(nz.any(1), 575 - np.argmax(nz[:, ::-1], 1), -1)
    c1_len = np.where(last_nz >= big_end, (last_nz - big_end + 4) // 4 * 4, 0)
    if np.any(big_end + c1_len > 576):
        raise ValueError("count1 quads run past bin 576")

    # regions: normal long blocks the first 1..3 bands, then 1..3, then
    # the rest (region_count r0 = min(2, bands - 1), r1 = min(2, bands -
    # r0 - 2)); with window switching (start, short, stop) bins 0..35,
    # then the rest
    ws = bt != 0
    r0 = np.minimum(2, np.maximum(0, sfb_end - 1))
    r1 = np.minimum(2, np.maximum(0, sfb_end - r0 - 2))
    b0 = np.where(ws, 36, bounds[rows, np.minimum(r0 + 1, 22)])
    b1 = np.where(ws, big_end, bounds[rows, np.minimum(r0 + r1 + 2, 22)])
    b0 = np.minimum(b0, big_end)
    b1 = np.minimum(np.maximum(b1, b0), big_end)
    pb = np.stack([np.zeros(n, np.int64), b0, b1, big_end], 1) // 2

    # each region's table: the fewest bits among those that hold its max;
    # sums over a region are differences of running sums at its bounds
    px, py = a[:, 0::2], a[:, 1::2]
    cx, cy = np.minimum(px, 15), np.minimum(py, 15)

    def region_sums(v):
        c = np.zeros((n, 289), np.int64)
        np.cumsum(v, 1, out=c[:, 1:])
        at = np.take_along_axis(c, pb, 1)
        return at[:, 1:] - at[:, :-1]

    pair = np.arange(288)[None, :]
    reg_of = (pair >= pb[:, 1:2]).astype(np.int8) + (pair >= pb[:, 2:3])
    pmax = np.where(pair < pb[:, 3:], np.maximum(px, py), 0)
    rmax = np.stack([np.max(np.where(reg_of == r, pmax, 0), 1)
                     for r in range(3)], 1)
    sign_r = region_sums((px > 0).astype(np.int32) + (py > 0))
    over_r = region_sums((px >= 15).astype(np.int32) + (py >= 15))
    cost = np.full((n, 3, 32), np.iinfo(np.int64).max // 4)
    code_r = {}
    for t in _CAND:
        key = _LEN[t].tobytes()
        if key not in code_r:
            code_r[key] = region_sums(_LEN32[t][cx, cy])
        c = code_r[key] + sign_r + _LIN[t] * over_r
        cost[:, :, t] = np.where(rmax <= _VMAX[t], c, cost[:, :, t])
    empty = rmax == 0
    cost[:, :, 0] = np.where(empty, 0, cost[:, :, 0])
    table = np.where(empty, 0, np.argmin(cost, 2))
    big_bits = np.take_along_axis(cost, table[..., None], 2)[..., 0].sum(1)

    # count1 quads from big_end on: the shorter of tables A and B
    qi = big_end[:, None] + 4 * np.arange(144)[None, :]
    in_c1 = qi < (big_end + c1_len)[:, None]
    qj = np.minimum(qi[..., None] + np.arange(4), 575)
    quad = np.where(in_c1[..., None], np.minimum(a[rows[:, None, None], qj],
                                                 1), 0)
    vbits = (quad * np.array([8, 4, 2, 1], np.int32)).sum(2)
    nsign = quad.sum((1, 2))
    csum = [np.where(in_c1, _C1LEN[k][vbits], 0).sum(1) for k in (0, 1)]
    c1t = (csum[1] < csum[0]).astype(np.int64)
    nbits = big_bits + np.minimum(csum[0], csum[1]) + nsign
    return {"part23": nbits, "big_values": big_end // 2, "tables": table,
            "r0": r0, "r1": r1, "count1table": c1t, "pb": pb,
            "reg_of": reg_of, "qj": qj, "in_c1": in_c1, "vbits": vbits,
            "quad": quad}


def fields(q, p):
    """Every main-data field (pos, val, width) [n, k] of the gcs q [n, 576]
    under their plan p, each gc's data from bit 0."""
    n = q.shape[0]
    a = np.abs(q)
    px, py = a[:, 0::2], a[:, 1::2]
    cx, cy = np.minimum(px, 15), np.minimum(py, 15)
    tp = np.take_along_axis(p["tables"], p["reg_of"].astype(np.int64), 1)
    tp = np.where(np.arange(288)[None, :] < p["pb"][:, 3:], tp, 0)
    # big-values fields: code, x's linbits and sign, y's linbits and sign
    lin = _LIN[tp]
    on = tp > 0
    bw = np.stack([np.where(on, _LEN[tp, cx, cy], 0),
                   np.where(on & (px >= 15), lin, 0),
                   on & (px > 0),
                   np.where(on & (py >= 15), lin, 0),
                   on & (py > 0)], 2).reshape(n, -1)
    bv = np.stack([_CODE[tp, cx, cy], px - 15, q[:, 0::2] < 0, py - 15,
                   q[:, 1::2] < 0], 2).reshape(n, -1)
    # count1 quads: code, then the signs of the nonzero values
    in_c1, vbits, quad = p["in_c1"], p["vbits"], p["quad"]
    c1t = p["count1table"][:, None]
    qsign = q[np.arange(n)[:, None, None], p["qj"]] < 0
    cw = np.concatenate([np.where(in_c1, _C1LEN[c1t, vbits], 0)[..., None],
                         quad], 2).reshape(n, -1)
    cv = np.concatenate([_C1CODE[c1t, vbits][..., None], qsign], 2)\
        .reshape(n, -1)
    width = np.concatenate([bw, cw], 1).astype(np.int64)
    val = np.concatenate([bv, cv], 1).astype(np.int64)
    return np.cumsum(width, 1) - width, val, width


def scalefactors(rng, bt, gains):
    """Seeded side information that scales the spectra, for frames of
    block types bt [F, 2] (both channels alike): each granule-channel's
    scalefac_compress, scalefactors, preflag, scalefac_scale, subblock
    gains and global gain (gains: the range of global_gain), and each
    channel's scfsi, set only in frames of two long granules; the second
    granule's reused groups hold the first granule's scalefactors.
    Returns the fields, and each gc's part 2 as (value, width) [n, 36]."""
    F = bt.shape[0]
    shape = (F, 2, 2)
    short = np.broadcast_to((bt == 2)[:, :, None], shape)
    sfc = rng.integers(0, 16, shape)
    slen = SLEN[:, sfc]                                  # [2, F, 2, 2]
    # long blocks: bands 0-10 slen1 bits, 11-20 slen2
    w_l = np.where(np.arange(21) < 11, slen[0][..., None], slen[1][..., None])
    sf_l = np.floor(rng.random(shape + (21,)) * (1 << w_l)).astype(np.int64)
    # short blocks: bands 0-5 slen1 bits, 6-11 slen2, a value a window
    w_s = np.where(np.arange(12)[:, None] < 6, slen[0][..., None, None],
                   slen[1][..., None, None]) * np.ones(3, np.int64)
    sf_s = np.floor(rng.random(shape + (12, 3)) * (1 << w_s)).astype(np.int64)
    scfsi = np.where((bt != 2).all(1)[:, None, None],
                     rng.random((F, 2, 4)) < 0.5, False)
    reuse = scfsi[:, :, SCFSI_GROUP]                     # [F, ch, 21]
    sf_l[:, 1] = np.where(reuse, sf_l[:, 0], sf_l[:, 1])
    sent_l = np.where(np.stack([np.zeros_like(reuse), reuse], 1), 0, w_l)
    pre = ~short & (rng.random(shape) < 0.3)
    scale = rng.random(shape) < 0.3
    sbg = np.where(short[..., None], rng.integers(0, 4, shape + (3,)), 0)
    gain = rng.integers(int(gains[0]), int(gains[1]) + 1, shape)
    sf_l = np.where(short[..., None], 0, sf_l)
    sf_s = np.where(short[..., None, None], sf_s, 0)
    n = F * 4
    val = np.zeros((n, 36), np.int64)
    width = np.zeros((n, 36), np.int64)
    sh = short.reshape(-1)
    val[~sh, :21] = sf_l.reshape(n, 21)[~sh]
    width[~sh, :21] = sent_l.reshape(n, 21)[~sh]
    val[sh] = sf_s.reshape(n, 36)[sh]
    width[sh] = w_s.reshape(n, 36)[sh]
    return {"sfc": sfc, "scfsi": scfsi, "sf_l": sf_l, "sf_s": sf_s,
            "pre": pre, "scale": scale, "sbg": sbg, "gain": gain,
            "part2": (val, width)}


def encode_frames(q, bt, ms, sf, cfg, side=None):
    """Frames (uint8 [F, frame_bytes]) from spectra q [F, 2, 2, 576], block
    types bt [F, 2], mid/side flags [F] and the scaling fields sf (from
    scalefactors; side: the Huffman plan, if made already).  Returns the
    frames and each gc's part2_3_length [F, 4]."""
    F = q.shape[0]
    fbytes = 1152 * int(cfg["bitrate_kbps"]) * 125 // int(cfg["sample_rate"])
    qf = q.reshape(-1, 576)
    bt_gc = np.repeat(bt, 2, axis=1).reshape(-1)
    if side is None:
        side = plan(qf, bt_gc)
    pos, val, width = fields(qf, side)
    p2v, p2w = sf["part2"]
    p2_bits = p2w.sum(1)
    pos = np.concatenate([np.cumsum(p2w, 1) - p2w, pos + p2_bits[:, None]],
                         1)
    val = np.concatenate([p2v, val], 1)
    width = np.concatenate([p2w, width], 1)
    nb = (side["part23"] + p2_bits).reshape(F, 4)
    if np.any(nb.sum(1) > 8 * fbytes - HEADER_BITS - SIDE_BITS) or \
            np.any(nb > 4095):
        raise ValueError("a frame's main data does not fit")
    gc_start = HEADER_BITS + SIDE_BITS + np.cumsum(nb, 1) - nb
    base = (np.arange(F)[:, None] * 8 * fbytes + gc_start).reshape(-1)
    groups = [((base[:, None] + pos)[width > 0], val[width > 0],
               width[width > 0])]
    # header: MPEG-1 Layer III, no CRC, the bit rate, 44.1 kHz, joint
    # stereo with the mid/side bit per frame, the original bit set
    br = _KBPS.index(int(cfg["bitrate_kbps"]))
    hdr = (0xFFFB << 16) | (br << 12) | (0x40 | (ms.astype(np.int64) << 5)
                                         | 0x04)
    fpos = np.arange(F) * 8 * fbytes
    groups.append((fpos, hdr, np.full(F, 32)))
    # side info: main_data_begin and private bits 0, each channel's scfsi,
    # then each granule-channel's 59 bits
    scfsi = (sf["scfsi"].astype(np.int64) << np.arange(3, -1, -1)).sum(2)
    off = np.full(F, HEADER_BITS + 9 + 3)
    for ch in range(2):
        groups.append((fpos + off, scfsi[:, ch], np.full(F, 4)))
        off = off + 4
    g = {k: side[k].reshape(F, 4, *side[k].shape[1:]) for k in
         ("part23", "big_values", "tables", "r0", "r1", "count1table")}
    gsf = {k: sf[k].reshape(F, 4, *sf[k].shape[3:]) for k in
           ("sfc", "pre", "scale", "sbg", "gain")}
    bt4 = bt_gc.reshape(F, 4)
    for i in range(4):
        ws = bt4[:, i] != 0
        tabs = g["tables"][:, i]
        sbg = gsf["sbg"][:, i]
        f = [(nb[:, i], 12), (g["big_values"][:, i], 9),
             (gsf["gain"][:, i], 8), (gsf["sfc"][:, i], 4),
             (ws.astype(np.int64), 1)]
        long_f = [(tabs[:, 0], 5), (tabs[:, 1], 5), (tabs[:, 2], 5),
                  (g["r0"][:, i], 4), (g["r1"][:, i], 3)]
        sw_f = [(bt4[:, i], 2), (np.zeros(F, np.int64), 1),
                (tabs[:, 0], 5), (tabs[:, 1], 5),
                ((sbg[:, 0] << 6) | (sbg[:, 1] << 3) | sbg[:, 2], 9)]
        for (lv, lw), (sv, sw) in zip(long_f, sw_f):
            f.append((np.where(ws, sv, lv), np.where(ws, sw, lw)))
        f += [(gsf["pre"][:, i].astype(np.int64), 1),
              (gsf["scale"][:, i].astype(np.int64), 1),
              (g["count1table"][:, i], 1)]
        for v, w in f:
            w = np.broadcast_to(w, (F,))
            groups.append((fpos + off, v, w))
            off = off + w
    out = np.zeros(F * fbytes, np.uint8)
    for p, v, w in groups:
        out |= bits.pack(p, v, w, F * fbytes)
    return out.reshape(F, fbytes), nb


def bank_patterns(blocks: dict, n: int):
    """Each bank frame's block-type pattern (an index into PATTERNS): as
    many of each as a clip's frames hold on average, two at the least."""
    t, x = float(blocks["transient_rate"]), float(blocks["long_transients"])
    want = np.array([1 - t, t, t * x, t])
    cnt = np.maximum(2, np.floor(want / want.sum() * n).astype(np.int64))
    cnt[0] = n - cnt[1:].sum()
    return np.repeat(np.arange(len(PATTERNS)), cnt)


def clip_patterns(rng, blocks: dict, n_frames: int):
    """A clip's frame patterns: long frames and transients (a start frame,
    with a short frame after it in a share of them, then a stop frame),
    each unit a transient with the configured rate."""
    tr = rng.random(n_frames) < float(blocks["transient_rate"])
    extra = tr & (rng.random(n_frames) < float(blocks["long_transients"]))
    ln = np.where(tr, 2 + extra, 1)
    start = np.cumsum(ln) - ln
    pat = np.zeros(int(ln.sum()), np.int64)
    pat[start[tr]] = 1
    pat[start[extra] + 1] = 2
    pat[start[tr] + ln[tr] - 1] = 3
    return pat[:n_frames]


def build(cfg: dict, traffic: dict, rng) -> Corpus:
    """The config's pool of distinct clips from a bank of frames."""
    sr = int(cfg["sample_rate"])
    N = int(cfg["bank_frames"])
    fbytes = 1152 * int(cfg["bitrate_kbps"]) * 125 // sr
    cap = 8 * fbytes - HEADER_BITS - SIDE_BITS
    mix, blocks = cfg["content"], cfg["blocks"]
    pat = bank_patterns(blocks, N)
    bt = PATTERNS[pat]
    q = spectra(rng, bt == 2, [mix["dense"], mix["tonal"], mix["quiet"]])
    sf = scalefactors(rng, bt, cfg["global_gain"])
    p2_bits = sf["part2"][1].sum(1).reshape(N, 4)
    # a frame whose data does not fit is made quieter until it does
    qf = q.reshape(-1, 576)
    bt_gc = np.repeat(bt, 2, axis=1).reshape(-1)
    side = plan(qf, bt_gc)
    for _ in range(40):
        nb = side["part23"].reshape(N, 4) + p2_bits
        bad = (nb.sum(1) > cap) | (nb > 4095).any(1)
        if not bad.any():
            break
        q[bad] = np.trunc(q[bad] * 0.85).astype(np.int64)
        rows = np.repeat(bad, 4)
        sub = plan(qf[rows], bt_gc[rows])
        for k, v in sub.items():
            side[k][rows] = v
    ms = rng.random(N) < float(cfg["ms_share"])
    frames, nb = encode_frames(q, bt, ms, sf, cfg, side)
    P = int(cfg["distinct_clips"])
    secs = lengths_s(traffic["lengths"], P)
    n_fr = np.maximum(np.rint(secs * sr / 1152).astype(np.int64), 1)
    rng.shuffle(n_fr)
    first = np.searchsorted(pat, np.arange(len(PATTERNS)))
    count = np.bincount(pat, minlength=len(PATTERNS))
    streams, frames_of = [], []
    huff = (nb - p2_bits).sum(1)
    huff_bits = np.zeros(P, np.int64)
    for s in range(P):
        cp = clip_patterns(rng, blocks, int(n_fr[s]))
        ids = first[cp] + rng.integers(0, count[cp])
        frames_of.append(ids)
        streams.append(frames[ids].tobytes())
        huff_bits[s] = huff[ids].sum()
    keep = ("sf_l", "sf_s", "pre", "scale", "sbg", "gain")
    return Corpus(streams=streams, seconds=n_fr * 1152 / sr,
                  work={"huff_gc": n_fr * 4, "huff_bits": huff_bits},
                  truth={"q": q.astype(np.int16), "bt": bt, "ms": ms,
                         "frames_of": frames_of,
                         **{k: sf[k] for k in keep}})
