"""The port's MP3 Huffman stage against the JAX package's, on the CPU.

The twin ``huff_decode_torch`` (what a CPU tensor takes; the CUDA kernel is
held to it on the card in test_torch_cuda.py) must give the q and err of
JAX's ``huff_decode`` on every lane: lanes parsed by the C stage from golden
streams (mono, stereo, linbits escapes, short blocks, MPEG-2), and lanes of
random bits with random side info that drive the row-width clamp and the
count1 bit-limit stop.  On well-formed lanes q must also equal the C
stage's own Huffman decode.  The tables, the dequant, the reorder and the
intensity mix are held to the JAX module's as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_formats_tpu.ops import mp3_dsp as jdsp
from audio_formats_tpu.ops import mp3_huff as jhuff

from audio_formats_torch.host import native
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models.mp3 import Mp3Decoder
from audio_formats_torch.ops import mp3_dsp, mp3_huff
from audio_formats_torch.utils.tables import mp3_tables as T

from golden import mp3_ref
from torch_mp3_cases import as_frames, mp3_random_lanes

#: patterns that have an sfb layout (kind 0..2, sample-rate index 0..8)
VALID_PATTERNS = [p for p in range(48) if mp3_huff._sfb_widths(p)]


# ------------------------------------------------------------ stream fixtures
def mp3_stream(seed, channels=2, n_frames=10, mode_ext=None, big=True,
               shorts=True, right_cut=None, **build):
    """An MPEG-1 Layer III stream of the golden encoder: per granule one of
    four spectra (sparse large values, dense small, linbits escapes, count1
    ones), a short-block frame every fifth, the global gain set so the PCM
    lies in [-1, 1].  right_cut zeroes the right channel's spectrum above
    that coefficient, so intensity bands pan; `build` goes to build_mp3
    (free format, a Xing tag)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        grs = []
        for g in range(2):
            q = np.zeros(576, np.int64)
            k = (i * 2 + g) % 4
            if k == 0:
                idx = rng.choice(300, 40, replace=False)
                q[idx] = rng.integers(-80, 81, 40) if big else \
                    rng.integers(-15, 16, 40)
            elif k == 1:
                idx = rng.choice(500, 120, replace=False)
                q[idx] = rng.integers(-7, 8, 120)
            elif k == 2:  # linbits escapes
                idx = rng.choice(200, 20, replace=False)
                q[idx] = rng.integers(-2000, 2001, 20) if big else \
                    rng.integers(-30, 31, 20)
            else:
                idx = rng.choice(570, 60, replace=False)
                q[idx] = rng.integers(-1, 2, 60)
            gr = {"q": q, "global_gain": 138 if big else 170}
            if shorts and i % 5 == 3:
                gr["block_type"] = 2
            chans = [dict(gr) for _ in range(channels)]
            if right_cut is not None and channels == 2:
                qr = q.copy()
                qr[right_cut:] = 0
                chans[1]["q"] = qr
            grs.append(chans)
        frames.append(grs)
    return mp3_ref.build_mp3(frames, channels=channels, mode_ext=mode_ext,
                             **build)


def mp3_stream_mpeg2(seed, channels=1, n_frames=8, mode_ext=None):
    """An MPEG-2 Layer III stream (22.05 kHz, one granule a frame), short
    blocks every fourth frame, PCM in [-1, 1]; with intensity (mode_ext 1) the right
    channel is silent above coefficient 96 and its scalefactors are the
    intensity positions."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        q = np.zeros(576, np.int64)
        q[rng.choice(400, 45, replace=False)] = rng.integers(-60, 61, 45)
        gr = {"q": q, "global_gain": 162}
        if i % 4 == 2:
            gr["block_type"] = 2
        chans = [gr]
        if channels == 2:
            qr = np.zeros(576, np.int64)
            qr[rng.choice(96, 25, replace=False)] = rng.integers(-30, 31, 25)
            chans.append({"q": qr, "global_gain": 162})
        frames.append([chans])
    return mp3_ref.build_mp3_mpeg2(
        frames, channels=channels, mode_ext=mode_ext, ch1_sfc=2 * 70,
        ch1_iscf=[1, 3, 5, 2, 4, 6, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6])


# ---------------------------------------------------------------------- lanes
def parsed_lanes(data):
    """Every lane of a stream as the C stage parses it for the batch path,
    one 6-frame window after another, in the port's layout: each frame's
    words in the pool once, shared by its ngr * nch lanes.  Returns (pool
    int32, meta16 [L, 16] int16, the C stage's q of each active lane or
    None, lanes a frame, the widest lane reach in words)."""
    lib = native.get_lib()
    dec = Mp3Decoder(MemorySource(data), device="cpu")
    ref = Mp3Decoder(MemorySource(data), device="cpu")
    nch, ngr = dec.channels, (2 if dec._mpeg1 else 1)
    W, FW, lpf = 6, native.FRAME_WORDS, ngr * nch
    st = (np.zeros(511, np.uint8), np.zeros(1, np.int32), dec._ist_pos)
    pools, metas, qrefs, reach = [], [], [], 16
    while dec._offset < len(dec._view) - 4:
        G = W * ngr
        bits = np.empty((W, FW), np.uint32)
        meta = np.zeros((G * nch, 16), np.int32)
        scfq = np.empty((G * nch, 40), np.int16)
        flags = np.zeros(W, np.uint8)
        n, dec._offset, mw, _ist = native.mp3_parse_window_packed(
            lib, dec._view, dec._offset, dec._hdr0, W, ngr, nch, st, bits,
            meta, scfq, np.zeros((G, nch), np.int32),
            np.zeros((G, nch, 32), np.int32), flags,
            ist=np.zeros((G, 40), np.int16) if nch == 2 else None)
        if n == 0:
            break
        reach = max(reach, mw)
        m16 = mp3_huff.meta16_from_c(meta)
        span = m16[::lpf, mp3_huff.M_SPAN]
        for w in range(n):
            pools.append(bits[w, : span[w]])
        metas.append(m16[: n * lpf])
        for w in range(n):
            tq = None
            if flags[w] & 1:
                tq, fb = ref._parse_frame_tensors(ref._offset)
            else:
                fb = ref._parse_frame_tensors(ref._offset)[1]
            ref._offset += fb
            for g in range(ngr):
                for ch in range(nch):
                    qrefs.append(None if tq is None else
                                 tq["q"][0, g, ch].astype(np.int32))
    return (np.concatenate(pools).astype(np.uint32).view(np.int32),
            np.concatenate(metas), qrefs, lpf, reach)


def lane_rows(pool, meta16, lpf):
    """Frame-addressed lanes rebased to one row a lane (lanes_per_frame
    1): each lane's words from its first Huffman word to its frame's end,
    its bit positions from that word.  (pool, meta16)."""
    m = meta16.copy()
    span = meta16[:, mp3_huff.M_SPAN].astype(np.int64)
    offs = mp3_huff._lane_offsets(torch.from_numpy(span), lpf).numpy()
    skip = np.minimum(meta16[:, mp3_huff.M_BIT_START].astype(np.int64) >> 5,
                      span)
    m[:, mp3_huff.M_BIT_START] -= 32 * skip
    m[:, mp3_huff.M_BIT_LIMIT] -= 32 * skip
    m[:, mp3_huff.M_SPAN] = span - skip
    words = [pool[o + k: o + n] for o, k, n in zip(offs, skip, span)]
    return np.concatenate(words + [pool[:0]]), m


def jax_huff(pool, meta16, W):
    """JAX huff_decode on the same lanes: rows rebuilt from the pool with
    zeros past each span, table ids mapped to breakpoint ranks, every
    pattern of the lanes present, the spec's maximum scan lengths."""
    L = meta16.shape[0]
    m = meta16.astype(np.int64)
    pool = pool.view(np.uint32)
    span = m[:, 15]
    offs = np.cumsum(span) - span
    rows = np.zeros((L, W), np.uint32)
    for i in range(L):
        rows[i, : span[i]] = pool[offs[i]: offs[i] + span[i]]
    tabs = m[:, 5:8]
    cids = {int(jhuff.CODE_ID[t]) for t in tabs.ravel()}
    starts, d_pack, rank_of = jhuff.breakpoints_for_window(cids)
    ranks = rank_of[tabs]
    pats = tuple(sorted({int(p) for p in m[:, 12]}))
    q, err = jhuff.huff_decode(
        rows, m[:, 0], m[:, 1], m[:, 2], m[:, 3], m[:, 4],
        ranks[:, 0], ranks[:, 1], ranks[:, 2], m[:, 8], m[:, 9], m[:, 10],
        m[:, 11], m[:, 12], starts, d_pack,
        pats=pats, W=W, NBIG=288, NC1=144)
    return np.asarray(q), np.asarray(err)


def port_huff(pool, meta16, W, lanes_per_frame):
    q, err = mp3_huff.huff_decode(torch.from_numpy(pool),
                                  torch.from_numpy(meta16), W,
                                  lanes_per_frame)
    return q.numpy(), err.numpy()


# ----------------------------------------------------------------------- tests
def test_tables_and_constants_equal_jax():
    for name in ("CODE_ID", "LINBITS_TAB", "BAND_IDX", "BAND_OF_PAIR",
                 "TOTAL_W", "PERM", "_NLB", "_PAN1", "_PAN2"):
        a, b = getattr(mp3_huff, name), getattr(jhuff, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert mp3_huff.SHORT_PATTERNS == jhuff.SHORT_PATTERNS
    for name in ("SYNTH_FIR", "AA_CS", "AA_CA", "IMDCT_MATS", "UV_MATS",
                 "_SIGN_T", "SYNTH_TOEPLITZ"):
        a, b = getattr(mp3_dsp, name), getattr(jdsp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _blob_lookup(blob, tab, peek):
    """The two-level lookup of csrc/mp3_huff.cu in numpy."""
    blob = blob.view(np.uint32).astype(np.int64)
    e = blob[blob[mp3_huff.BLOB_BASES + tab] + (peek >> 11)]
    if e & (1 << 31):
        ext = (e >> 24) & 15
        e = blob[(e & 0xFFFFFF) + ((peek >> (11 - ext)) & ((1 << ext) - 1))]
    return e & 31, (e >> 8) & 15, (e >> 12) & 15


def test_lookup_blob_decodes_every_codeword():
    """Every codeword of every big-values and count1 table, followed by
    random bits, looks up its own length and values; empty tables consume
    nothing."""
    rng = np.random.default_rng(0)
    blob = mp3_huff.HUFF_BLOB
    for t in range(32):
        codes = T.HUFF_TABLES[t]
        if not codes:
            for peek in rng.integers(0, 1 << 19, 16):
                assert _blob_lookup(blob, t, int(peek)) == (0, 0, 0)
            continue
        for code, ln, x, y in codes:
            tail = int(rng.integers(0, 1 << (19 - ln)))
            peek = (code << (19 - ln)) | tail
            assert _blob_lookup(blob, t, peek) == (ln, x, y), (t, code)
    u = blob.view(np.uint32)
    for k, codes in enumerate((T.COUNT1_A, T.COUNT1_B)):
        for code, ln, v in codes:
            for tail in range(1 << (6 - ln)):
                e = int(u[mp3_huff.BLOB_C1 + 64 * k + (code << (6 - ln) | tail)])
                assert (e & 7, e >> 8) == (ln, v)
    assert np.array_equal(u[mp3_huff.BLOB_TOTAL_W:][:48], mp3_huff.TOTAL_W)
    bop = u[mp3_huff.BLOB_BOP: mp3_huff.BLOB_LUT].view(np.uint8)
    assert np.array_equal(bop.reshape(48, 288), mp3_huff.BAND_OF_PAIR)


def test_twin_matches_jax_and_c_stage_on_parsed_lanes():
    """Lanes the C stage parses from golden streams: mono, stereo with
    linbits escapes, short blocks, MS and intensity frames, MPEG-2 mono and
    intensity stereo.  The twin on the frame-addressed pool, on the same
    lanes rebased to a row each, and JAX (one call over all of them, on
    those rows) decode alike."""
    streams = [mp3_stream(1, channels=1, big=False),
               mp3_stream(2, channels=2),
               mp3_stream(3, channels=2, mode_ext=3, right_cut=200),
               mp3_stream_mpeg2(4, channels=1),
               mp3_stream_mpeg2(5, channels=2, mode_ext=1)]
    parts = [parsed_lanes(d) for d in streams]
    W = mp3_huff.row_width(max(p[4] for p in parts))
    q, err = map(np.concatenate, zip(*(port_huff(p[0], p[1], W, p[3])
                                       for p in parts)))
    rows = [lane_rows(p[0], p[1], p[3]) for p in parts]
    pool = np.concatenate([r[0] for r in rows])
    meta16 = np.concatenate([r[1] for r in rows])
    qrefs = [q for p in parts for q in p[2]]
    ql, errl = port_huff(pool, meta16, W, 1)
    qj, errj = jax_huff(pool, meta16, W)
    np.testing.assert_array_equal(q, ql)
    np.testing.assert_array_equal(err, errl)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(err, errj)
    assert not err.any()
    checked = 0
    for lane, qr in enumerate(qrefs):
        if qr is not None:
            np.testing.assert_array_equal(q[lane], qr)
            checked += 1
    assert checked == len(qrefs) == 124
    assert (np.abs(q) > 15).any() and (meta16[:, 12] >= 16).any()


@pytest.mark.parametrize("W", [20, 52])
def test_twin_matches_jax_on_random_lanes(W):
    """Random bits and side info: most lanes run past their bits, so the
    (W - 3) * 32 position clamp and the count1 bit-limit stop decide q."""
    rng = np.random.default_rng(W)
    pool, meta16 = mp3_random_lanes(rng, 600, W)
    q, err = port_huff(pool, meta16, W, 1)
    qj, errj = jax_huff(pool, meta16, W)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(err, errj)
    assert (q != 0).sum() > 100000


def _random_spectra(rng, L):
    q = np.zeros((L, 576), np.int32)
    for i in range(L):
        n = int(rng.integers(0, 576))
        q[i, :n] = rng.integers(-8206, 8207, n) * (rng.random(n) < 0.3)
    return q


def test_dequant_and_reorder_match_jax():
    rng = np.random.default_rng(7)
    L = 96
    q = _random_spectra(rng, L)
    scfq = rng.integers(-200, 40, (L, 40)).astype(np.int16)
    pattern = rng.choice(VALID_PATTERNS, L).astype(np.int32)
    pats = tuple(sorted({int(p) for p in pattern}))
    xq = mp3_huff.dequant(torch.from_numpy(q), torch.from_numpy(scfq),
                          torch.from_numpy(pattern))
    xj = np.asarray(jhuff.dequant(q, scfq, pattern, pats=pats))
    # the port's |q|^(4/3) is the correctly rounded f32 of the f64 power;
    # XLA's f32 mag * cbrt(mag) is a few ulps (< 2e-6 relative) off it
    np.testing.assert_allclose(xq.numpy(), xj, rtol=4e-6, atol=0)
    spats = tuple(p for p in pats if p in jhuff.SHORT_PATTERNS)
    r = mp3_huff.reorder_short(torch.from_numpy(np.array(xj)),
                               torch.from_numpy(pattern))
    rj = np.asarray(jhuff.reorder_short(xj, pattern, spats=spats))
    np.testing.assert_array_equal(r.numpy(), rj)


@pytest.mark.parametrize("mpeg1", [True, False])
def test_intensity_mix_matches_jax(mpeg1):
    """The per-band intensity/MS mix vectors, bit for bit, over long, short
    and mixed layouts, any stereo bits and intensity positions."""
    rng = np.random.default_rng(int(mpeg1))
    BG = 120
    q_r = _random_spectra(rng, BG)
    pat_l = rng.choice(VALID_PATTERNS, BG).astype(np.int32)
    fl = rng.integers(0, 16, BG)
    ist = rng.integers(0, 70 if not mpeg1 else 9, (BG, 40)).astype(np.int32)
    pats = tuple(sorted({int(p) for p in pat_l}))
    args = (pat_l, (fl & 1) == 1, (fl & 2) == 2, (fl & 4) == 4, (fl >> 3) & 1)
    got = mp3_huff._intensity_abcd(
        torch.from_numpy(q_r), *(torch.from_numpy(np.asarray(a))
                                 for a in args),
        torch.from_numpy(ist), mpeg1)
    want = jhuff._intensity_abcd(*(jnp.asarray(a) for a in (q_r, *args, ist)),
                                 pats=pats, mpeg1=mpeg1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_huff_decode_rejects_unknown_device():
    with pytest.raises(ValueError):
        mp3_huff.huff_decode(torch.zeros(4, dtype=torch.int32),
                             torch.zeros((2, 16), dtype=torch.int16,
                                         device="meta"), 20, 1)


def _stage_lanes(rng, W):
    """Random lanes of one window (B 2, G 8, stereo) with every layout (long,
    short, mixed blocks at every sample rate), any stereo bits, block types,
    scalefactors and an intensity plane.  (pool, meta16, scfq, ist)."""
    L = 2 * 8 * 2
    pool, meta16 = mp3_random_lanes(rng, L, W)
    meta16[:, 12] = np.repeat(rng.choice(VALID_PATTERNS, L // 2), 2)
    meta16[:, 13] = np.repeat(rng.integers(0, 16, L // 2), 2)
    meta16[:, 14] = rng.choice([0, 1, 3], L)
    scfq = rng.integers(-40, 8, (L, 40)).astype(np.int16)
    ist = rng.integers(0, 9, (16, 40)).astype(np.int16)
    return pool, meta16, scfq, ist


def _jax_device_stage(pool, meta16, scfq, ist, W, lpf):
    """JAX's packed_device_stage on the same lanes (B 2, G 8, stereo,
    MPEG-1), each lane's row its frame's words with zeros past the span."""
    L = meta16.shape[0]
    m = meta16.astype(np.int64)
    tabs = m[:, 5:8]
    cids = {int(jhuff.CODE_ID[t]) for t in tabs.ravel()}
    starts, d_pack, rank_of = jhuff.breakpoints_for_window(cids)
    span = m[:, 15]
    offs = mp3_huff._lane_offsets(torch.from_numpy(span), lpf).numpy()
    rows = np.zeros((L, W), np.uint32)
    for i in range(L):
        rows[i, : span[i]] = pool.view(np.uint32)[offs[i]: offs[i] + span[i]]
    jmeta = np.concatenate([m[:, :5], rank_of[tabs], m[:, 8:15]], axis=1)
    pats = tuple(sorted({int(p) for p in m[:, 12]}))
    want = jhuff.packed_device_stage(
        rows, jmeta.astype(np.int16), scfq, starts, d_pack, pats=pats,
        spats=tuple(p for p in pats if p in jhuff.SHORT_PATTERNS), W=W,
        NBIG=288, NC1=144, B=2, G=8, nch=2, ist=ist.astype(np.int32),
        mpeg1=True)
    return [np.asarray(a) for a in want]


def test_device_stage_matches_jax():
    """The whole device entropy stage on one window of random lanes, each
    with words of its own (lanes_per_frame 1): Huffman, dequant, the
    intensity mix, the reorder, window types and antialias counts."""
    rng = np.random.default_rng(11)
    W = 28
    pool, meta16, scfq, ist = _stage_lanes(rng, W)
    got = mp3_huff.packed_device_stage(
        torch.from_numpy(pool), torch.from_numpy(meta16),
        torch.from_numpy(scfq), W, 2, 8, 2, ist=torch.from_numpy(ist),
        mpeg1=True, short=True, lanes_per_frame=1)
    want = _jax_device_stage(pool, meta16, scfq, ist, W, 1)
    np.testing.assert_allclose(got[0].numpy(), want[0],
                               rtol=4e-6, atol=0)  # |q|^(4/3), as above
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (want[1] != 31).any()


def test_device_stage_matches_jax_on_frames():
    """The same stage in the batch wire's layout: a frame's words shared by
    its 4 granule-channel lanes (MPEG-1 stereo), bit positions from the
    frame's first word, so a lane that runs past its bits reads on into its
    frame's later lanes' words; the stage's own lanes_per_frame.  JAX
    decodes each lane from its frame's whole row.  MS frames take (M ± S) /
    sqrt 2 of two |q|^(4/3) values, which can cancel to near zero, so the
    tolerance is 4e-6 of the window's peak."""
    rng = np.random.default_rng(12)
    pool, meta16, scfq, ist = _stage_lanes(rng, 28)
    meta16, reach = as_frames(meta16, 4)
    W = mp3_huff.row_width(reach)
    got = mp3_huff.packed_device_stage(
        torch.from_numpy(pool), torch.from_numpy(meta16),
        torch.from_numpy(scfq), W, 2, 8, 2, ist=torch.from_numpy(ist),
        mpeg1=True, short=True)
    want = _jax_device_stage(pool, meta16, scfq, ist, W, 4)
    peak = float(np.abs(want[0]).max())
    assert peak > 0
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=4e-6,
                               atol=4e-6 * peak)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (want[1] != 31).any()


# ---------------------------------------------------- lane order (K3)
def _twin_through_groups(pool, meta16, W, perm):
    """The twin run group by group (one group a big-values pair count, in
    the order of the permutation), each group's lanes cut out of the pool
    with their own words and their q and err scattered back."""
    m = torch.from_numpy(meta16)
    span = meta16[:, mp3_huff.M_SPAN].astype(np.int64)
    offs = np.cumsum(span) - span
    key = m[:, mp3_huff.M_BV].clamp(0, 288)
    q = torch.full((len(meta16), 576), -7, dtype=torch.int32)
    err = torch.ones(len(meta16), dtype=torch.bool)
    p = perm.to(torch.int64)
    for k in torch.unique(key):
        rows = p[key[p] == k]
        words = [pool[offs[r]: offs[r] + span[r]] for r in rows.tolist()]
        gq, gerr = mp3_huff.huff_decode_torch(
            torch.from_numpy(np.concatenate(words + [pool[:0]])),
            m[rows], W, 1)
        q[rows], err[rows] = gq, gerr
    return q.numpy(), err.numpy()


def _check_perm(meta16):
    perm = mp3_huff.huff_lane_perm(torch.from_numpy(meta16))
    assert perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(len(meta16)))
    key = np.clip(meta16[:, mp3_huff.M_BV], 0, 288)[perm.numpy()]
    assert (np.diff(key) >= 0).all()   # one run per pair count
    return perm


@pytest.mark.parametrize("W", [20, 52])
def test_lane_perm_groups_keep_the_twin_output(W):
    """Random-bit lanes: the twin run pair count by pair count through the
    permutation gives the twin's q and err on all lanes."""
    rng = np.random.default_rng(100 + W)
    pool, meta16 = mp3_random_lanes(rng, 300, W)
    meta16[::7, mp3_huff.M_BV] = 0
    perm = _check_perm(meta16)
    q, err = _twin_through_groups(pool, meta16, W, perm)
    qt, errt = port_huff(pool, meta16, W, 1)
    np.testing.assert_array_equal(q, qt)
    np.testing.assert_array_equal(err, errt)


def test_lane_perm_groups_keep_the_jax_output_on_parsed_lanes():
    """Lanes the C stage parses from golden streams (the JAX-checked
    fixture of test_twin_matches_jax_and_c_stage_on_parsed_lanes, a row a
    lane): pair count by pair count through the permutation, JAX's q on
    every lane."""
    parts = [parsed_lanes(d) for d in (mp3_stream(2, channels=2),
                                       mp3_stream_mpeg2(5, channels=2,
                                                        mode_ext=1))]
    rows = [lane_rows(p[0], p[1], p[3]) for p in parts]
    pool = np.concatenate([r[0] for r in rows])
    meta16 = np.concatenate([r[1] for r in rows])
    W = mp3_huff.row_width(max(p[4] for p in parts))
    perm = _check_perm(meta16)
    q, err = _twin_through_groups(pool, meta16, W, perm)
    qj, errj = jax_huff(pool, meta16, W)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(err, errj)


def test_step_counts_follow_the_fsm():
    """huff_decode_steps: the twin's q and err, and each lane's steps are
    its big-values pairs plus at least one count1 step while 2 bv <= 572."""
    rng = np.random.default_rng(3)
    pool, meta16 = mp3_random_lanes(rng, 200, 28)
    meta16[:40, mp3_huff.M_BV] = 0
    q, err, steps = mp3_huff.huff_decode_steps(
        torch.from_numpy(pool), torch.from_numpy(meta16), 28, 1)
    qt, errt = port_huff(pool, meta16, 28, 1)
    np.testing.assert_array_equal(q.numpy(), qt)
    np.testing.assert_array_equal(err.numpy(), errt)
    bv = meta16[:, mp3_huff.M_BV].astype(np.int64)
    c1 = steps.numpy() - np.clip(bv, 0, 288)
    assert ((c1 >= 1) == (2 * bv <= 572)).all()
    assert (c1 <= 144).all() and c1.max() > 1
