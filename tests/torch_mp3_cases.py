"""MP3 window inputs shared by the CPU tests and the card tests: random-bit
lanes for the Huffman stage (K3), and whole windows for the window DSP
(K14 against its twin, ops/mp3_huff.spectrum_stage + ops/mp3_dsp.
mp3_window_dsp).  Everything is numpy; callers move it to their device."""

import numpy as np

from audio_formats_torch.ops import mp3_huff

#: patterns that have an sfb layout (kind 0..2, sample-rate index 0..8)
VALID_PATTERNS = [p for p in range(48) if mp3_huff._sfb_widths(p)]
LONG_PATTERNS = [p for p in VALID_PATTERNS if p < 16]


def mp3_random_lanes(rng, L, W):
    """L lanes of random words (int32 pool) and random side info for the
    Huffman FSM: spans up to the row width, bit limits anywhere up to it,
    any table, region bounds and sfb pattern, a fifth of the lanes near
    the 288-pair maximum (little or no count1)."""
    span = rng.integers(0, W - 3, L)
    pool = rng.integers(0, 2 ** 32, int(span.sum()), dtype=np.uint64)\
        .astype(np.uint32)
    tabs = rng.integers(0, 32, (L, 3))
    meta = np.zeros((L, 16), np.int16)
    meta[:, 0] = rng.integers(0, 8, L)
    meta[:, 1] = meta[:, 0] + rng.integers(0, W * 32, L)
    meta[:, 2] = np.where(rng.random(L) < 0.2, rng.integers(250, 289, L),
                          rng.integers(0, 289, L))
    meta[:, 3] = rng.integers(1, 17, L)
    meta[:, 4] = meta[:, 3] + rng.integers(1, 30, L)
    meta[:, 5:8] = tabs
    meta[:, 8:11] = mp3_huff.LINBITS_TAB[tabs]
    meta[:, 11] = rng.integers(0, 2, L)
    meta[:, 12] = rng.choice(VALID_PATTERNS, L)
    meta[:, 15] = span
    return pool.view(np.int32), meta


def as_frames(meta, lpf):
    """Random lanes regrouped into frames of lpf lanes: a frame's words are
    its lanes' words end to end (the pool as it is), each lane's bit
    positions counted from its frame's first word.  Returns (meta, the
    widest lane reach in words)."""
    m = meta.copy()
    span = meta[:, 15].astype(np.int64)
    start = np.cumsum(span) - span
    shift = 32 * (start - np.repeat(start[::lpf], lpf))
    m[:, 0] += shift
    m[:, 1] += shift
    m[:, 15] = np.repeat(np.add.reduceat(span, np.arange(0, len(span), lpf)),
                         lpf)
    return m, int(max(m[:, 15].max(), (m[:, :2].max() >> 5) + 1))


#: the window DSP's cases: MPEG-1 stereo (MS and LR granules; long, start,
#: stop, short and mixed blocks), mono, MPEG-2 (one granule a frame),
#: intensity windows of MPEG-1 and MPEG-2, a window without short blocks,
#: and lanes that end mid-window or hold no granule
WINDOW_CASES = ("mpeg1_stereo", "mono", "mpeg2", "intensity",
                "intensity_mpeg2", "long_only", "partial")

#: two windows of three lanes of four frames each
WINDOW_LANES, WINDOW_FRAMES = 3, 4


def window_case(name, windows=2):
    """The inputs of `windows` chained windows of case `name`
    (WINDOW_CASES): a dict of the window's shape (B, G, nch, mpeg1, short)
    and the carried state it starts from (overlap [B, nch, 32, 18], shist
    [B, nch, 16, 32], random), and "windows", a list of dicts of one
    window's pooled wire (pool, meta16, W, lanes_per_frame), scfq, ist
    (None outside intensity windows) and n_act."""
    rng = np.random.default_rng(WINDOW_CASES.index(name) + 700)
    nch = 1 if name == "mono" else 2
    mpeg1 = "mpeg2" not in name
    ngr = 2 if mpeg1 else 1
    B, G = WINDOW_LANES, WINDOW_FRAMES * ngr
    L = B * G * nch
    lpf = ngr * nch
    short = name != "long_only"
    intensity = name.startswith("intensity")
    out = []
    for _ in range(windows):
        pool, meta = mp3_random_lanes(rng, L, 28)
        meta, reach = as_frames(meta, lpf)
        pats = LONG_PATTERNS if not short else VALID_PATTERNS
        pattern = rng.choice(pats, L)
        if intensity:  # both channels on one layout, as an encoder writes
            pattern = np.repeat(pattern[::nch], nch)
        meta[:, mp3_huff.M_PATTERN] = pattern
        # block type 2 where the pattern is short or mixed, else normal,
        # start or stop
        meta[:, mp3_huff.M_BTYPE] = np.where(
            pattern >= 16, 2, rng.choice([0, 0, 1, 3], L))
        meta[:, mp3_huff.M_STEREO] = np.repeat(
            rng.integers(0, 16 if intensity else 2, L // nch), nch)
        n_act = np.full(B, G, np.int32)
        if name == "partial":
            n_act[:] = [G, int(rng.integers(1, G)), 0]
        out.append({
            "pool": pool, "meta16": meta, "W": mp3_huff.row_width(reach),
            "lanes_per_frame": lpf,
            "scfq": rng.integers(-40, 8, (L, 40)).astype(np.int16),
            "ist": rng.integers(0, 9, (B * G, 40)).astype(np.int16)
            if intensity else None,
            "n_act": n_act})
    return {"B": B, "G": G, "nch": nch, "mpeg1": mpeg1, "short": short,
            "overlap": rng.normal(0, 0.5, (B, nch, 32, 18))
            .astype(np.float32),
            "shist": rng.normal(0, 0.5, (B, nch, 16, 32)).astype(np.float32),
            "windows": out}
