"""MP3 Layer III Huffman stage and the device side of the batch window.

The host (af_host.cc) walks headers, splices the bit reservoir and decodes
scalefactors; it ships each frame's reservoir-spliced main data as
big-endian u32 words, frame after frame in one exact-size pool, with ~32
bytes of side info for each granule-channel (its *lane*), which addresses
its frame's words by bit position.  On the device every lane is an
independent bitstream, so a window's lanes decode in lockstep:

* ``huff_decode`` — the Huffman FSM (big values with linbits escapes and
  sign bits, then count1 quads), the counterpart of the JAX package's
  ``_huff_core`` (minimp3.d:748-883, af_host.cc af_mp3_huffman).  A CUDA
  tensor takes the hand-written kernel of ``csrc/mp3_huff.cu`` (one thread
  a lane, lanes ordered by pair count by a plan on the card whose twin is
  ``huff_lane_perm``, direct table lookups in shared memory) or raises; a
  CPU tensor
  takes the plain twin ``huff_decode_torch``.  ``HUFF_LAUNCHES`` counts the
  kernel's launches.
* ``dequant``, ``reorder_short``, ``_intensity_abcd`` and
  ``spectrum_stage`` — requantize, short-block reorder, MS or intensity
  mix, window types: plain torch ops, the front half of K14's twin
  (``packed_device_stage`` is the Huffman FSM and this stage).
* ``packed_window`` — one window from the pooled wire to PCM: on the card
  K3, K14 (ops/mp3_dsp.py ``window_dsp_cuda``) and the synthesis kernel
  K15 (ops/mp3_dsp.py ``synth_cuda``);
  on the CPU the twins, through ops/mp3_dsp.py's window DSP.

Both the twin and the kernel read the code tables from one int32 blob
(``HUFF_BLOB``) built here from the spec tables: a two-level lookup, 8 bits
first, for the 32 big-values tables (which dedupe to 16 distinct code
tables, ``CODE_ID``), the count1 tables, ``TOTAL_W`` and ``BAND_OF_PAIR``.

Semantics the kernel and the twin share with the reference, bit for bit:
word ``w`` of a lane reads 0 at or past its span and at or past the row
width ``W``; the big-values phase never checks ``bit_limit`` and clamps the
position to ``(W - 3) * 32`` after each pair; a count1 step is taken only
if its codeword ends within ``bit_limit``; ``err`` is all false.  On the
batch wire a lane's words are its frame's (``lanes_per_frame`` lanes share
them) and W lies past every lane's reach (``row_width``), so a lane reads
what the single-stream decoder reads: its frame's main data, then zeros.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _kernels, mp3_dsp
from .mp3_dsp import WIN_NORMAL, WIN_SHORT, WIN_START, WIN_STOP, device_const
from ..host.native import FRAME_WORDS
from ..utils.tables import mp3_tables as T

N_PATTERNS = 48   # kind(0..2)*16 + sr_idx_my(0..8)

#: launches of the CUDA Huffman kernel (af_mp3_huff) in this process
HUFF_LAUNCHES = 0
_launch_lock = threading.Lock()
#: the kernel's threads (lanes) a block, and the blocks an SM holds at once
#: (csrc/mp3_huff.cu: kThreads, __launch_bounds__(kThreads, 3)): a launch
#: of SMs x HUFF_BLOCKS_PER_SM x HUFF_THREADS lanes fills the card in one
#: wave
HUFF_THREADS = 256
HUFF_BLOCKS_PER_SM = 3


# --------------------------------------------------------------- code tables
def _build_code_ids():
    """Dedupe the 32 big-values tables into distinct code tables (the two
    linbits families share codes; empty tables share id 0)."""
    code_id = np.zeros(34, np.int32)
    lin = np.zeros(34, np.int32)
    lin[:32] = np.asarray(T.LINBITS, np.int32)
    keymap = {}
    for t in range(32):
        codes = T.HUFF_TABLES[t]
        key = tuple(map(tuple, codes)) if codes else ()
        code_id[t] = keymap.setdefault(key, len(keymap))
    return code_id, lin


CODE_ID, LINBITS_TAB = _build_code_ids()


# ------------------------------------------------------------------ patterns
def _sfb_widths(pattern: int):
    """Band widths for pattern = kind*16 + sr_idx_my (af_host.cc layout)."""
    kind, sr_my = divmod(pattern, 16)
    if sr_my > 8:
        return None
    sr = sr_my - (sr_my != 0)  # collapsed index (mp3_side_info)

    def _pad(a, stride):
        a = np.asarray(a, np.int32)
        full = 8 * stride
        if a.size < full:  # tables are zero-terminated; pad the flat tail
            a = np.concatenate([a, np.zeros(full - a.size, np.int32)])
        return a.reshape(8, stride)

    L = _pad(T.SCF_LONG, 23)
    S = _pad(T.SCF_SHORT, 40)
    M = _pad(T.SCF_MIXED, 40)
    if kind == 0:
        tab, n_long, n_short = L[sr], 22, 0
    elif kind == 1:
        tab, n_long, n_short = S[sr], 0, 39
    elif kind == 2:
        tab, n_long, n_short = M[sr], (8 if sr_my >= 6 else 6), 30
    else:
        return None
    nb = n_long + n_short
    widths = [int(x) for x in tab[:nb]]
    # zero-terminated tables may end earlier
    while widths and widths[-1] == 0:
        widths.pop()
    return widths, n_long, n_short, kind, sr_my


def _build_patterns():
    band_idx = np.full((N_PATTERNS, 576), 39, np.int32)
    band_of_pair = np.full((N_PATTERNS, 288), 39, np.int32)
    total_w = np.zeros(N_PATTERNS, np.int32)
    perm = np.tile(np.arange(576, dtype=np.int32), (N_PATTERNS, 1))
    for p in range(N_PATTERNS):
        info = _sfb_widths(p)
        if info is None:
            continue
        widths, n_long, n_short, kind, sr_my = info
        pos = 0
        for b, w in enumerate(widths):
            band_idx[p, pos : pos + w] = b
            pos += w
        total_w[p] = pos
        band_of_pair[p] = band_idx[p, ::2][:288]
        if n_short:
            # reorder permutation (models/mp3.py _reorder_perm_full;
            # minimp3.d:984-1000): new[i] = old[perm[i]]
            n_long_bands = 0
            if kind == 2:
                n_long_bands = 4 if sr_my == 2 else 2
            pm = np.arange(576, dtype=np.int32)
            src = n_long_bands * 18
            dst = src
            sfb = widths[n_long:] + [0, 0, 0]
            i = 0
            while sfb[i]:
                ln = sfb[i]
                stop = False
                for j in range(ln):
                    if dst + 3 > 576 or src + 2 * ln + j >= 576:
                        stop = True
                        break
                    pm[dst] = src + j
                    pm[dst + 1] = src + ln + j
                    pm[dst + 2] = src + 2 * ln + j
                    dst += 3
                if stop:
                    break
                src += 3 * ln
                i += 3
            perm[p] = pm
    return band_idx, band_of_pair, total_w, perm


BAND_IDX, BAND_OF_PAIR, TOTAL_W, PERM = _build_patterns()

#: patterns whose reorder permutation is not the identity
SHORT_PATTERNS = tuple(
    int(p) for p in range(N_PATTERNS)
    if not np.array_equal(PERM[p], np.arange(576))
)

#: n_long_bands per pattern (mixed: 2, or 4 at sr_idx_my==2; short: 0)
_NLB = np.zeros(N_PATTERNS, np.int32)
for _p in range(N_PATTERNS):
    _k, _s = divmod(_p, 16)
    if _k == 2 and _s <= 8:
        _NLB[_p] = 4 if _s == 2 else 2

#: MPEG-1 intensity pan table (minimp3.d:930-940; models/mp3.py
#: _pan_gains), f32 of the same literals so the device mix is bit-equal
_PAN1 = np.array([0.0, 1.0, 0.21132487, 0.78867513, 0.36602540,
                  0.63397460, 0.5, 0.5, 0.63397460, 0.36602540,
                  0.78867513, 0.21132487, 1.0, 0.0], np.float32)

#: MPEG-2 pan gains 2^(-(((ipos+1)>>1) << sh)/4) precomputed in f64 then
#: cast — identical to the host's float(2.0**..) → np.float32 chain
_PAN2 = np.stack([
    np.array([np.float32(2.0 ** (-(((i + 1) >> 1) << sh) / 4.0))
              for i in range(64)], np.float32)
    for sh in range(2)
])


def _layout_info(p: int):
    widths, n_long, n_short, _kind, _sr = _sfb_widths(p)
    return n_long + n_short, len(widths), (3 if n_short else 1), n_long


#: per pattern (n_sfb, n_real bands, max_blocks, n_long); patterns without
#: a layout get (0, 0, 1, 0), which leaves the mix the identity
_LAYOUT = np.array([_layout_info(p) if _sfb_widths(p) else (0, 0, 1, 0)
                    for p in range(N_PATTERNS)], np.int64)

#: |q|^(4/3) for every |q| a lane can hold (15 + 2^13 - 1 = 8206)
_P43 = (np.arange(8208, dtype=np.float64) ** (4.0 / 3.0)).astype(np.float32)


# ------------------------------------------------------------ lookup blob
#: int32 word offsets in HUFF_BLOB (csrc/mp3_huff.cu reads the same layout)
BLOB_BASES = 0       # [32] first-level entry index of each big-values table
BLOB_C1 = 32         # [2][64] count1 entries: ln | vmask << 8
BLOB_TOTAL_W = 160   # [48] TOTAL_W
BLOB_BOP = 208       # [48][288] BAND_OF_PAIR as bytes (3,456 words)
BLOB_LUT = BLOB_BOP + N_PATTERNS * 288 // 4   # big-values entries
_FIRST_BITS = 8      # first-level lookup width of the 19-bit peek
_PTR = 1 << 31


def _build_blob() -> np.ndarray:
    """The lookup blob.  A big-values entry is a leaf ln | x << 8 | y << 12
    (an empty table's leaves are 0: no bits, x = y = 0), or a pointer
    bit31 | ext << 24 | index of a subtable of 2^ext leaves, indexed by the
    next ext bits of the peek.  Prefix codes tile the peek space, so every
    entry is defined."""
    lut = []
    base_of_cid = {}
    for t in range(32):
        cid = int(CODE_ID[t])
        if cid in base_of_cid:
            continue
        base = BLOB_LUT + len(lut)
        base_of_cid[cid] = base
        first = [0] * (1 << _FIRST_BITS)
        lut.extend(first)
        groups = {}
        for code, ln, x, y in T.HUFF_TABLES[t]:
            leaf = ln | (x << 8) | (y << 12)
            if ln <= _FIRST_BITS:
                s = code << (_FIRST_BITS - ln)
                for i in range(1 << (_FIRST_BITS - ln)):
                    lut[base - BLOB_LUT + s + i] = leaf
            else:
                prefix = code >> (ln - _FIRST_BITS)
                groups.setdefault(prefix, []).append((code, ln, leaf))
        for prefix, group in sorted(groups.items()):
            ext = max(ln for _, ln, _ in group) - _FIRST_BITS
            sub = BLOB_LUT + len(lut)
            lut.extend([0] * (1 << ext))
            for code, ln, leaf in group:
                rest = code & ((1 << (ln - _FIRST_BITS)) - 1)
                s = rest << (_FIRST_BITS + ext - ln)
                for i in range(1 << (_FIRST_BITS + ext - ln)):
                    lut[sub - BLOB_LUT + s + i] = leaf
            lut[base - BLOB_LUT + prefix] = _PTR | (ext << 24) | sub
    blob = np.zeros(BLOB_LUT + len(lut), np.int64)
    blob[BLOB_BASES:BLOB_BASES + 32] = [base_of_cid[int(CODE_ID[t])]
                                        for t in range(32)]
    for k, codes in enumerate((T.COUNT1_A, T.COUNT1_B)):
        for code, ln, v in codes:
            s = code << (6 - ln)
            for i in range(1 << (6 - ln)):
                blob[BLOB_C1 + 64 * k + s + i] = ln | (v << 8)
    blob[BLOB_TOTAL_W:BLOB_TOTAL_W + N_PATTERNS] = TOTAL_W
    blob[BLOB_BOP:BLOB_LUT] = BAND_OF_PAIR.astype(np.uint8).reshape(-1)\
        .view(np.uint32)
    blob[BLOB_LUT:] = lut
    return blob.astype(np.uint32).view(np.int32)


HUFF_BLOB = _build_blob()


# ------------------------------------------------------------ Huffman FSM
#: meta16 columns (one int16 row per lane, the window's side-info plane)
(M_BIT_START, M_BIT_LIMIT, M_BV, M_BND0, M_BND1, M_TAB0, M_TAB1, M_TAB2,
 M_LIN0, M_LIN1, M_LIN2, M_C1TAB, M_PATTERN, M_STEREO, M_BTYPE,
 M_SPAN) = range(16)

#: row-width buckets (words) of a window's widest lane reach; the row width
#: W the Huffman stage takes is the bucket plus 4
ROW_BUCKETS = (16, 24, 32, 48, 64, 96, 132, 192, 256, 384, 512, 768,
               FRAME_WORDS)


def row_width(max_words: int) -> int:
    """The row width W of a window whose widest lane reaches `max_words`
    words (af_mp3_parse_window_packed's max_words: a lane's span, or the
    word after its bit_start or bit_limit past it): the smallest bucket
    that holds it, plus 4.  W sets the position clamp (W - 3) * 32, which
    then lies past every word a lane can read and past its bit_limit, so
    the clamp changes nothing the lane decodes: from there it reads zeros,
    as it would unclamped, and its count1 phase has stopped."""
    return next(w for w in ROW_BUCKETS if max_words <= w) + 4


def meta16_from_c(meta: np.ndarray) -> np.ndarray:
    """The [..., 16] int16 side-info plane huff_decode takes (the M_*
    columns), from the C stage's [..., 16] int32 meta rows
    (af_mp3_parse_window_packed: span, bit_start, bit_limit, big_values,
    bnd0, bnd1, the three table ids, count1 table, pattern, stereo bits,
    block type): each region's linbits follow the table ids, and the span
    (the lane's frame's words), clamped to FRAME_WORDS, comes last."""
    tabs = meta[..., 6:9]
    span = np.minimum(meta[..., 0:1], FRAME_WORDS)
    return np.concatenate([meta[..., 1:6], tabs, LINBITS_TAB[tabs],
                           meta[..., 9:13], span], axis=-1).astype(np.int16)


def huff_decode(pool, meta16, W: int, lanes_per_frame: int):
    """Decode big values + count1 for L independent lanes.

    pool:   [N] int32 — every frame's big-endian u32 words (as int32 bits),
            frame after frame; lanes_per_frame consecutive lanes make a
            frame (1: each lane its own words), and frame f starts at the
            sum of the spans of the frames before it
    meta16: [L, 16] int16 — per lane: bit_start, bit_limit (from its
            frame's first word), big_values, bnd0, bnd1, the three region
            table ids (0..31), their linbits, count1 table, sfb pattern,
            stereo bits, block type, span (its frame's words; the lanes of
            a frame give the same)
    W:      the window's row width; words at or past it read 0
    lanes_per_frame: lanes that share a frame's words (L is a multiple):
            the batch wire's ngr * nch, 1 for lanes with words of their
            own; no default, so every caller states its layout

    Returns (q [L, 576] int32, err [L] bool) on meta16's device.
    """
    pool = torch.as_tensor(pool)
    meta16 = torch.as_tensor(meta16)
    dev = meta16.device
    if dev.type == "cpu":
        return huff_decode_torch(pool, meta16, W, lanes_per_frame)
    if dev.type == "cuda":
        return huff_decode_cuda(pool, meta16, W, lanes_per_frame)
    raise _kernels.KernelArgError(f"huff_decode: no kernel for device {dev}")


def _lane_offsets(span: torch.Tensor, lanes_per_frame: int) -> torch.Tensor:
    """Each lane's first pool word: the exclusive cumsum of the spans of
    the frames before its frame (a frame's span is its first lane's)."""
    frame = span.to(torch.int64)[::lanes_per_frame]
    return (torch.cumsum(frame, 0) - frame).repeat_interleave(
        lanes_per_frame)


_M32 = 0xFFFFFFFF


def _shift64(a, b, o):
    """The 32 bits starting at bit o (0..31) of the 64-bit window a‖b
    (int64 tensors holding u32 values)."""
    return ((a << o) | ((b >> (31 - o)) >> 1)) & _M32


def _extract(a, b, c, o, width):
    """Bits [o, o + width) of the 96-bit window a‖b‖c (width 0..19; 0 when
    width == 0)."""
    zero = torch.zeros_like(a)
    for _ in range(2):  # normalize o into [0, 32) by sliding the window
        big = o >= 32
        a, b, c = (torch.where(big, b, a), torch.where(big, c, b),
                   torch.where(big, zero, c))
        o = o - torch.where(big, 32, 0)
    val = _shift64(a, b, o) >> ((32 - width) & 31)
    return torch.where(width > 0, val, 0)


def huff_decode_torch(pool, meta16, W: int, lanes_per_frame: int):
    """Plain PyTorch twin of the CUDA Huffman kernel: same contract as
    huff_decode.  A Python loop over steps, the lanes side by side, with
    per-lane table lookups by gather (int64 holding u32 words): the test
    oracle and the on-card comparison, never the CUDA main path."""
    q, err, _steps = huff_decode_steps(pool, meta16, W, lanes_per_frame)
    return q, err


def huff_decode_steps(pool, meta16, W: int, lanes_per_frame: int):
    """huff_decode_torch, and the steps each lane's FSM runs in the kernel
    ([L] int64: its big-values pairs plus its count1 iterations, the one
    that stops included): what the lanes of a warp wait on each other
    for."""
    dev = meta16.device
    L = meta16.shape[0]
    m = meta16.to(torch.int64)
    span = m[:, M_SPAN]
    offs = _lane_offsets(span, lanes_per_frame)
    words = pool.to(device=dev, dtype=torch.int64) & _M32
    blob = device_const(HUFF_BLOB, dev).to(torch.int64) & _M32
    n_pool = words.shape[0]

    def word(w):
        ok = (w < span) & (w < W)
        i = torch.clamp(offs + w, 0, max(n_pool - 1, 0))
        got = words[i] if n_pool else torch.zeros_like(w)
        return torch.where(ok, got, 0)

    def window(pos):
        w0 = pos >> 5
        return word(w0), word(w0 + 1), word(w0 + 2), pos & 31

    q = torch.zeros((L, 576), dtype=torch.int32, device=dev)
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    if L == 0:
        return q, err, torch.zeros(0, dtype=torch.int64, device=dev)
    bv = m[:, M_BV]
    steps = torch.clamp(bv, 0, 288)
    pattern = m[:, M_PATTERN]
    max_pos = (W - 3) * 32
    bop = torch.from_numpy(BAND_OF_PAIR).to(dev, torch.int64)
    tabs = m[:, M_TAB0:M_TAB2 + 1]
    lins = m[:, M_LIN0:M_LIN2 + 1]
    pos = m[:, M_BIT_START]
    rows = torch.arange(L, device=dev)
    for i in range(min(int(bv.max()), 288)):
        active = i < bv
        band = bop[pattern, i]
        region = torch.where(band >= m[:, M_BND1], 2,
                             torch.where(band >= m[:, M_BND0], 1, 0))
        tab = tabs[rows, region]
        linb = lins[rows, region]
        a, b, c, sh = window(pos)
        peek = _shift64(a, b, sh) >> 13
        e = blob[blob[BLOB_BASES + tab] + (peek >> (19 - _FIRST_BITS))]
        ptr = e >= _PTR
        ext = (e >> 24) & 15
        sub = torch.where(
            ptr, (e & 0xFFFFFF)
            + ((peek >> (19 - _FIRST_BITS - ext)) & ((1 << ext) - 1)), 0)
        e = torch.where(ptr, blob[sub], e)
        ln, x, y = e & 31, (e >> 8) & 15, (e >> 12) & 15
        o = sh + ln
        lx = torch.where(x == 15, linb, 0)
        xv = x + _extract(a, b, c, o, lx)
        o = o + lx
        px = (xv != 0).to(torch.int64)
        xneg = (_extract(a, b, c, o, px) == 1) & (px == 1)
        o = o + px
        ly = torch.where(y == 15, linb, 0)
        yv = y + _extract(a, b, c, o, ly)
        o = o + ly
        py = (yv != 0).to(torch.int64)
        yneg = (_extract(a, b, c, o, py) == 1) & (py == 1)
        o = o + py
        pos = torch.where(active, torch.clamp(pos + o - sh, max=max_pos), pos)
        q[:, 2 * i] = torch.where(active, torch.where(xneg, -xv, xv), 0)\
            .to(torch.int32)
        q[:, 2 * i + 1] = torch.where(active, torch.where(yneg, -yv, yv), 0)\
            .to(torch.int32)

    # count1 quads from position 2*big_values
    tw = torch.from_numpy(TOTAL_W).to(dev, torch.int64)[pattern]
    c1 = BLOB_C1 + 64 * (m[:, M_C1TAB] & 1)
    bit_limit = m[:, M_BIT_LIMIT]
    stopped = torch.zeros(L, dtype=torch.bool, device=dev)
    for j in range(144):
        s0 = 2 * bv + 4 * j
        live = (~stopped) & (s0 <= 572)
        if not bool(live.any()):
            break
        steps = steps + live.to(torch.int64)
        a, b, c, sh = window(pos)
        e = blob[c1 + (_shift64(a, b, sh) >> 26)]
        ln, vmask = e & 7, (e >> 8) & 15
        bit_ok = pos + ln <= bit_limit
        act = live & bit_ok
        o = sh + ln
        for s in range(4):
            pv = act & (s0 < tw if s < 2 else s0 + 2 < tw)
            take = pv & (((vmask >> (3 - s)) & 1) == 1)
            sbit = _extract(a, b, c, o, take.to(torch.int64))
            val = torch.where(take, torch.where(sbit == 1, -1, 1), 0)
            col = torch.clamp(s0 + s, max=575)
            q[rows[act], col[act]] = val[act].to(torch.int32)
            o = o + take.to(torch.int64)
        pos = torch.where(act, torch.clamp(pos + o - sh, max=max_pos), pos)
        stopped = stopped | ~bit_ok | (s0 + 2 >= tw)
    return q, err, steps


def huff_lane_perm(meta16) -> torch.Tensor:
    """A permutation of the lanes by their big-values pair count (stable),
    so that the 32 lanes of one warp of the kernel run about as many steps
    each: the pairs are nearly all of a lane's steps (count1 ran ~1 step a
    lane on the MP3 slice's window).  [L] int32 on meta16's device.  The
    plain twin of the lane order huff_plan_cuda makes on the card."""
    npairs = meta16[:, M_BV].clamp(0, 288)
    return torch.argsort(npairs, stable=True).to(torch.int32)


def huff_decode_cuda(pool, meta16, W: int, lanes_per_frame: int):
    """Launch the CUDA Huffman kernel (csrc/mp3_huff.cu) on the tensors'
    card, on that card's current stream, after its plan (each lane's first
    pool word and the lane order of huff_lane_perm, made on the card).
    pool [N] int32 and meta16 [L, 16] int16, contiguous on one CUDA
    device."""
    dev = meta16.device
    L = meta16.shape[0] if meta16.dim() == 2 else -1
    _kernels.check_args("huff_decode", dev, (
        ("meta16", meta16, (torch.int16,), (L, 16)),
        ("pool", pool, (torch.int32,), (pool.shape[0],)),
    ))
    if not 4 <= W <= FRAME_WORDS + 4:
        raise _kernels.KernelArgError(
            f"huff_decode: row width {W} out of range")
    if lanes_per_frame < 1 or L % lanes_per_frame:
        raise _kernels.KernelArgError(
            f"huff_decode: {L} lanes are not frames of {lanes_per_frame}")
    # the kernel writes every position of q, zeros included
    q = torch.empty((L, 576), dtype=torch.int32, device=dev)
    err = torch.empty(L, dtype=torch.bool, device=dev)
    if L == 0:
        return q, err
    offs = torch.empty(L, dtype=torch.int32, device=dev)
    perm = torch.empty(L, dtype=torch.int32, device=dev)
    lib = _kernels.load("mp3_huff")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _plan(lib, stream, meta16, lanes_per_frame, offs, perm)
        _launch(lib, stream, pool, meta16, W, offs, perm, q, err)
    return q, err


def huff_plan_cuda(meta16, lanes_per_frame: int):
    """The plan alone (csrc/mp3_huff.cu af_mp3_huff_plan, three small
    launches): each lane's first pool word (_lane_offsets, int32) and the
    lane order of huff_lane_perm, made on the card.  meta16 as
    huff_decode_cuda takes it.  Returns (offs, perm), [L] int32 each."""
    dev = meta16.device
    L = meta16.shape[0] if meta16.dim() == 2 else -1
    _kernels.check_args("huff_decode plan", dev, (
        ("meta16", meta16, (torch.int16,), (L, 16)),))
    offs = torch.empty(L, dtype=torch.int32, device=dev)
    perm = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        lib = _kernels.load("mp3_huff")
        with torch.cuda.device(dev):
            _plan(lib, torch.cuda.current_stream(dev).cuda_stream, meta16,
                  lanes_per_frame, offs, perm)
    return offs, perm


def huff_launch(pool, meta16, W: int, offs, perm, q, err):
    """The kernel's launch alone, into q and err, given each lane's first
    pool word (offs [L] int32) and the lane order (perm [L] int32, a
    permutation of the lanes): huff_decode_cuda without its plan.  The
    other arguments as huff_decode_cuda checked them.  Returns (q, err)."""
    L = meta16.shape[0]
    dev = meta16.device
    _kernels.check_args("huff_decode", dev, (
        ("offs", offs, (torch.int32,), (L,)),
        ("perm", perm, (torch.int32,), (L,)),
        ("q", q, (torch.int32,), (L, 576)),
        ("err", err, (torch.bool,), (L,)),
    ))
    lib = _kernels.load("mp3_huff")
    with torch.cuda.device(dev):
        _launch(lib, torch.cuda.current_stream(dev).cuda_stream, pool,
                meta16, W, offs, perm, q, err)
    return q, err


def _plan(lib, stream, meta16, lanes_per_frame, offs, perm):
    L = meta16.shape[0]
    scratch = torch.empty(lib.af_mp3_huff_plan_scratch(L), dtype=torch.int32,
                          device=meta16.device)
    rc = lib.af_mp3_huff_plan(meta16.data_ptr(), L, lanes_per_frame,
                              scratch.data_ptr(), offs.data_ptr(),
                              perm.data_ptr(), stream)
    _kernels.check_launch("huff_decode plan", rc)


def _launch(lib, stream, pool, meta16, W, offs, perm, q, err):
    global HUFF_LAUNCHES
    blob = device_const(HUFF_BLOB, meta16.device)
    rc = lib.af_mp3_huff(pool.data_ptr(), offs.data_ptr(), meta16.data_ptr(),
                         perm.data_ptr(), blob.data_ptr(), blob.shape[0],
                         meta16.shape[0], W, q.data_ptr(), err.data_ptr(),
                         stream)
    _kernels.check_launch("huff_decode", rc)
    with _launch_lock:
        HUFF_LAUNCHES += 1


# ----------------------------------------------------- dequant and stereo
def dequant(q, scfq, pattern):
    """sign(q)·|q|^(4/3)·2^(e/4), the per-sfb quarter-exponents expanded to
    positions by an exact index gather through BAND_IDX.
    q [L, 576] int32, scfq [L, 40] int16, pattern [L] → [L, 576] f32."""
    dev = q.device
    idx = device_const(BAND_IDX, dev).to(torch.int64)[pattern.to(torch.int64)]
    e = torch.gather(scfq.to(torch.float32), 1, idx)
    gain = torch.exp2(e * 0.25)
    mag = device_const(_P43, dev)[q.abs().clamp(max=8207).to(torch.int64)]
    return torch.sign(q).to(torch.float32) * mag * gain


def reorder_short(xq, pattern):
    """The short-block reorder (minimp3.d:984-1000): one gather with each
    lane's PERM[pattern] row (the identity for long patterns)."""
    perm = device_const(PERM, xq.device).to(torch.int64)[pattern.to(torch.int64)]
    return torch.gather(xq, 1, perm)


def _intensity_abcd(q_r, pat_l, is_ms, t_ist, t_ms, sh, ist, mpeg1: bool):
    """Per-band stereo mix vectors [BG, 4, 40] (l' = a·l + b·r,
    r' = c·l + d·r): the device build of models/mp3.py _stereo_mix
    (minimp3.d:963-1000).  The one content dependence, the last band with
    nonzero right-channel spectra, is an amax scatter over BAND_IDX."""
    dev = q_r.device
    BG = q_r.shape[0]
    pat = pat_l.to(torch.int64)
    lay = device_const(_LAYOUT, dev)[pat]
    n_sfb, n_real, mblk, n_long = (lay[:, k:k + 1] for k in range(4))
    idx = torch.arange(40, device=dev)[None, :]
    band = device_const(BAND_IDX, dev).to(torch.int64)[pat]
    nz = torch.zeros((BG, 40), dtype=torch.int32, device=dev).scatter_reduce(
        1, band, (q_r != 0).to(torch.int32), reduce="amax") > 0
    nzi = torch.where(nz & (idx < n_sfb), idx, -1)
    mb_all = nzi.amax(1, keepdim=True).expand(BG, 3)
    mb3 = torch.stack([torch.where(idx % 3 == j, nzi, -1).amax(1)
                       for j in range(3)], dim=1)
    mb = torch.where((mblk == 3) & (n_long == 0), mb3, mb_all)
    # top-band default/copy-down fixups (minimp3.d:969-974)
    ist = ist.to(torch.int64, copy=True)
    default_pos = 3 if mpeg1 else 0
    rows = torch.arange(BG, device=dev)
    for i in range(3):
        has = (i < mblk[:, 0]) & (n_sfb[:, 0] > 0)
        itop = (n_sfb[:, 0] - mblk[:, 0] + i).clamp(0, 39)
        prev = (itop - mblk[:, 0]).clamp(0, 39)
        val = torch.where(mb[:, i] >= prev, default_pos, ist[rows, prev])
        ist[rows[has], itop[has]] = val[has]
    mb_band = mb[:, torch.arange(40, device=dev) % 3]
    cond_w = idx < n_real
    max_pos = 7 if mpeg1 else 64
    cond = (idx > mb_band) & (ist < max_pos) & cond_w
    if mpeg1:
        pan = device_const(_PAN1, dev)
        ic = ist.clamp(0, 6)
        kl, kr = pan[2 * ic], pan[2 * ic + 1]
    else:
        kv = device_const(_PAN2, dev)[sh.to(torch.int64)[:, None],
                                    ist.clamp(0, 63)]
        odd = (ist & 1) == 1
        kl = torch.where(odd, kv, 1.0)
        kr = torch.where(odd, 1.0, kv)
    s = torch.where(t_ms, 1.41421356, 1.0).to(torch.float32)[:, None]
    one = torch.ones((BG, 40), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
    ti = t_ist[:, None]
    im = is_ms[:, None]
    msb = t_ms[:, None] & cond_w   # ms fallback only over real bands
    ms_one = torch.where(msb, one, zero)
    a = torch.where(ti & cond, kl * s, one)
    b = torch.where(ti, torch.where(cond, zero, ms_one),
                    torch.where(im, one, zero))
    c = torch.where(ti, torch.where(cond, kr * s, ms_one),
                    torch.where(im, one, zero))
    d = torch.where(ti, torch.where(cond, zero, torch.where(msb, -one, one)),
                    torch.where(im, -one, one))
    return torch.stack([a, b, c, d], dim=1)


def _window_abcd(q, pattern, stereo, ist, BG: int, nch: int, mpeg1: bool):
    """The intensity window's per-band mix [BG, 4, 40] (_intensity_abcd)
    from the window's q [BG·nch, 576], its lanes' patterns and stereo bits
    (int64 [BG·nch]) and right-channel intensity positions ist [BG, 40]:
    the left channel's layout and flags, the right channel's spectrum."""
    pat_l = pattern.reshape(BG, nch)[:, 0]
    fl = stereo.reshape(BG, nch)[:, 0]
    return _intensity_abcd(
        q.reshape(BG, nch, 576)[:, 1], pat_l, (fl & 1) == 1, (fl & 2) == 2,
        (fl & 4) == 4, (fl >> 3) & 1, ist, mpeg1)


def packed_device_stage(pool, meta16, scfq, W: int, B: int, G: int,
                        nch: int, ist=None, mpeg1: bool = True,
                        short: bool = True, lanes_per_frame: int = None):
    """The device entropy stage of one window: the Huffman FSM, then
    spectrum_stage.

    pool, meta16, lanes_per_frame as huff_decode (L = B·G·nch lanes; by
    default the batch wire's, where the ngr·nch granule-channels of a
    frame share its words); the rest as spectrum_stage.

    Returns (xq [B, G, nch, 576] f32, aa [B, G, nch] i32,
             wt [B, G, nch, 32] i32).
    """
    if lanes_per_frame is None:
        lanes_per_frame = (2 if mpeg1 else 1) * nch
    q, _err = huff_decode(pool, meta16, W, lanes_per_frame)
    return spectrum_stage(q, meta16, scfq, B, G, nch, ist=ist, mpeg1=mpeg1,
                          short=short)


def spectrum_stage(q, meta16, scfq, B: int, G: int, nch: int, ist=None,
                   mpeg1: bool = True, short: bool = True):
    """A window's spectrum from the Huffman stage's q [L, 576] int32:
    dequant → stereo (the intensity 2×2 mix before the reorder when ``ist``
    is given, else the MS butterfly after it) → short-block reorder →
    window types and antialias counts.  With mp3_dsp.mp3_window_dsp after
    it, the plain twin of K14 (mp3_dsp.window_dsp_cuda).

    meta16 [L, 16] as huff_decode; scfq [L, 40] int16 quarter-exponent
    gains; ist [B·G, 40] int16 right-channel intensity positions
    (intensity windows only); short: any short-block lane.

    Returns (xq [B, G, nch, 576] f32, aa [B, G, nch] i32,
             wt [B, G, nch, 32] i32).
    """
    dev = meta16.device
    L = B * G * nch
    pattern = meta16[:, M_PATTERN].to(torch.int64)
    stereo = meta16[:, M_STEREO].to(torch.int64)
    btype = meta16[:, M_BTYPE].to(torch.int64)
    xq = dequant(q, scfq, pattern)
    if nch == 2 and ist is not None:
        # intensity windows: the general per-coefficient 2x2 mix replaces
        # the MS butterfly, applied before the reorder (the host mix
        # coordinates, models/mp3.py _stereo_mix)
        BG = B * G
        abcd = _window_abcd(q, pattern, stereo, ist, BG, nch, mpeg1)
        # per-band -> per-coefficient: an exact index gather
        idx = device_const(BAND_IDX, dev).to(torch.int64)[
            pattern.reshape(BG, nch)[:, 0]]
        exp = torch.gather(abcd, 2, idx[:, None, :].expand(BG, 4, 576))
        l, r = xq.reshape(BG, nch, 576).unbind(1)
        xq = torch.stack([exp[:, 0] * l + exp[:, 1] * r,
                          exp[:, 2] * l + exp[:, 3] * r], dim=1)\
            .reshape(L, 576)
    if short:
        xq = reorder_short(xq, pattern)
    xq = xq.reshape(B, G, nch, 576)
    if nch == 2 and ist is None:
        # stereo bit 0 is the mid/side flag
        msf = ((stereo.reshape(B, G, nch)[:, :, 0] & 1) == 1)[:, :, None, None]
        l, r = xq[:, :, 0], xq[:, :, 1]
        xq = torch.where(msf, torch.stack([l + r, l - r], dim=2), xq)
    # window types / antialias band counts from the pattern + block type
    kind = pattern // 16
    is_short = (kind == 1) | (kind == 2)
    nlb = device_const(_NLB, dev).to(torch.int64)[pattern]
    base_wt = torch.where(btype == 3, WIN_STOP,
                          torch.where(btype == 1, WIN_START, WIN_NORMAL))
    band = torch.arange(32, device=dev)[None, :]
    wt = torch.where(is_short[:, None],
                     torch.where(band < nlb[:, None], WIN_NORMAL, WIN_SHORT),
                     base_wt[:, None])
    aa = torch.where(is_short, nlb - 1, 31)
    return xq, aa.reshape(B, G, nch), wt.reshape(B, G, nch, 32)


def packed_window(pool, meta16, scfq, ist, overlap, shist, n_act, *,
                  B: int, G: int, nch: int, W: int, mpeg1: bool = True,
                  short: bool = True):
    """One MP3 window from the pooled wire to PCM.  On the card: the
    Huffman kernel K3, the window kernel K14 (mp3_dsp.window_dsp_cuda; in
    intensity windows after the mix's _intensity_abcd) and the synthesis
    kernel K15 (mp3_dsp.synth_cuda).  On the CPU the plain chain:
    packed_device_stage, then the scan-free window DSP.  ``ist`` is None
    outside intensity windows.
    Returns (pcm [B, G, nch, 576], overlap', shist')."""
    dev = meta16.device
    if dev.type != "cuda":
        xq, aa, wt = packed_device_stage(pool, meta16, scfq, W, B, G, nch,
                                         ist=ist, mpeg1=mpeg1, short=short)
        return mp3_dsp.mp3_window_dsp(xq, aa, wt, overlap, shist, n_act,
                                      nch=nch, ngr=G)
    mp3_dsp.full_fp32(dev)
    q, _err = huff_decode(pool, meta16, W, (2 if mpeg1 else 1) * nch)
    abcd = None
    if nch == 2 and ist is not None:
        abcd = _window_abcd(q, meta16[:, M_PATTERN].to(torch.int64),
                            meta16[:, M_STEREO].to(torch.int64), ist, B * G,
                            nch, mpeg1)
    operand, new_overlap, new_shist = mp3_dsp.window_dsp_cuda(
        q, meta16, scfq, n_act, overlap, shist, abcd, B=B, G=G, nch=nch,
        short=short)
    pcm = mp3_dsp.synth_cuda(operand)
    return pcm.view(B, G, nch, 576), new_overlap, new_shist
