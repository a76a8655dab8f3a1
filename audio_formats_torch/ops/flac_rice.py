"""FLAC frame entropy on the device: subframe headers and partitioned-Rice
residuals, one lane a frame.

The FLAC device-Rice wire ships the raw frame bytes: the host runs only the
byte-level frame sync index (host/src/af_host.cc af_flac_sync_index_multi);
the frames are laid into one shared pool of big-endian u32 words, each at a
block-aligned offset; everything bit-granular (subframe headers, warm-ups,
LPC coefficients, Rice partitions) decodes here, and the output feeds the
LPC and stereo stages of ops/lpc.py unchanged.

* ``build_frame_pool`` / ``build_frame_pool_native`` (host, numpy or the C
  stage) and ``gather_frame_pool`` (torch ops, from a corpus of every
  stream's bytes uploaded once) assemble the pool; ``pad_pool`` pads an
  uploaded exact-size pool with the trailing zero blocks.
* ``flac_frame_entropy`` decodes the pool.  A CPU tensor takes the plain
  twin ``flac_frame_entropy_torch``; a CUDA tensor takes the hand-written
  kernel of ``csrc/flac_rice.cu`` or raises.  ``RICE_LAUNCHES`` counts the
  kernel's launches.

Semantics the kernel and the twin share with the JAX package's masked FSM,
bit for bit, on clean and corrupt lanes alike: bits outside the pool read
0; every 8 residual samples the cursor is clamped to [0, (NPOOL-2)·2048 -
64]; a unary run stops at 63 with ``err`` set, that sample still emitted;
``err`` is sticky across channels and stops the scan; widths and shift
amounts are masked to 5 bits as the reference masks them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _kernels

#: fixed predictor coefficients (af_host.cc kFixedCoef)
_FIXED_COEF = np.array(
    [[0, 0, 0, 0], [1, 0, 0, 0], [2, -1, 0, 0], [3, -3, 1, 0],
     [4, -6, 4, -1]], np.int32)

#: words per pool block; a frame starts on a block
BLK_W = 64
BLK_BITS = BLK_W * 32
#: residual samples between two cursor clamps
K_SAMP = 8

#: launches of the CUDA frame-entropy kernel (af_flac_rice) in this process
RICE_LAUNCHES = 0
_launch_lock = threading.Lock()

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------- the pool
def pool_blocks_needed(nbytes_each) -> int:
    """Blocks for a shared pool holding every frame at BLK-aligned
    offsets, plus two trailing zero blocks (overrun guard)."""
    blk_b = BLK_W * 4
    return sum(-(-int(nb) // blk_b) for nb in nbytes_each) + 2


def build_frame_pool(frames, NPOOL: int):
    """ONE shared [nused, BLK_W] u32 pool of big-endian words with each raw
    frame at a BLK-aligned offset.  frames: list of (view, byte_off,
    nbytes).  Returns (pool, base_bits [L] int64: each frame's first bit).
    The pool holds only the blocks used (at most NPOOL - 2; frames that do
    not fit are cut); ``pad_pool`` pads it to NPOOL on the device."""
    blk_b = BLK_W * 4
    need = sum(-(-int(nb) // blk_b) for _, _, nb in frames)
    nused = min(need, max(NPOOL - 2, 0))
    pool = np.zeros(nused * blk_b, np.uint8)
    base_bits = np.zeros(len(frames), np.int64)
    cur = 0
    for i, (view, off, nb) in enumerate(frames):
        nb = max(min(int(nb), (nused - cur) * blk_b), 0)
        pool[cur * blk_b: cur * blk_b + nb] = \
            np.frombuffer(view, np.uint8, nb, int(off))
        base_bits[i] = cur * blk_b * 8
        cur += -(-nb // blk_b)
    big = pool.view(">u4").astype(np.uint32)
    return big.reshape(nused, BLK_W), base_bits


def build_frame_pool_native(lib, lane_addrs, lanes, NPOOL: int):
    """:func:`build_frame_pool` in one pass of the C stage
    (af_flac_build_pool: the frame copies and the byteswap).  lane_addrs:
    uint64 [B] base address of each stream; lanes: the scheduler's frame
    tuples (bi, byte_off, nbytes, ...).  Bit-identical to the numpy
    builder."""
    from ..host import native as _native

    blk_b = BLK_W * 4
    n = len(lanes)
    ptrs = np.fromiter((lane_addrs[p[0]] for p in lanes), np.uint64, n)
    offs = np.fromiter((p[1] for p in lanes), np.int64, n)
    sizes = np.fromiter((p[2] for p in lanes), np.int64, n)
    need = int((-(-sizes // blk_b)).sum())
    nused = min(need, max(NPOOL - 2, 0))
    pool = np.zeros(nused * blk_b, np.uint8)
    base_bits = np.zeros(n, np.int64)
    _native.flac_build_pool(lib, ptrs, offs, sizes, blk_b, pool, base_bits)
    return pool.view(np.uint32).reshape(nused, BLK_W), base_bits


def gather_pool_meta(stream_base, lanes, S: int, zero_off: int):
    """Host index arrays for :func:`gather_frame_pool`: (lane_src [S] i32,
    cum_dst [S+1] i32, base_bits [n] i64) from the scheduler's frame tuples
    (bi, byte_off, nbytes, ...).  int32-safe while the corpus stays under
    2 GiB, which the caller checks when it builds the corpus."""
    blk_b = BLK_W * 4
    n = len(lanes)
    nblk = np.fromiter((-(-p[2] // blk_b) for p in lanes), np.int64, n)
    cum = np.zeros(S + 1, np.int32)
    cum[1: n + 1] = np.cumsum(nblk)
    cum[n + 1:] = cum[n]
    lane_src = np.full(S, zero_off, np.int32)
    lane_src[:n] = np.fromiter(
        (stream_base[p[0]] + p[1] for p in lanes), np.int64, n)
    base_bits = cum[:n].astype(np.int64) * (blk_b * 8)
    return lane_src, cum, base_bits


def _as_i32_bits(x) -> torch.Tensor:
    """u32 words (numpy uint32, or a tensor of their bits) → an int32
    tensor of the same bits; nothing moves between devices."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    return x


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (kept as int64)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def gather_frame_pool(corpus_w, lane_src, cum_dst, zero_off: int,
                      NPOOL: int, S: int):
    """The pool of :func:`build_frame_pool`, assembled on the corpus's
    device from a corpus of every stream's raw bytes (uploaded once a
    group) and two small index arrays, in place of a host pool a window.

    corpus_w: [Nw] int32 — the corpus bytes (read as little-endian words),
              with at least two zero blocks after the last stream.
    lane_src: [S] — each lane's first corpus byte (pad lanes: zero_off).
    cum_dst:  [S+1] — cumulative block counts (lane i fills pool blocks
              cum_dst[i] .. cum_dst[i+1] - 1).
    zero_off: the byte offset of the zero tail (4-aligned, below 2^31 -
              256: the byte indices are int32).

    Each pool block is the 256 corpus bytes from its lane's offset, each
    word's four bytes reversed into a big-endian word: the JAX package's
    funnel shift of two little-endian words and byteswap, as one byte
    gather.  Bytes past a frame's end inside its last block carry the
    corpus's next bytes where the host pool has zeros; blocks past
    cum_dst[S] read the zero tail.  Returns [NPOOL, BLK_W] int32 holding
    the big-endian words' bits."""
    corpus_w = _as_i32_bits(corpus_w)
    dev = corpus_w.device
    by = corpus_w.view(torch.uint8)
    blk_b = BLK_W * 4
    lane_src = torch.as_tensor(lane_src, device=dev).to(torch.int64)
    cum = torch.as_tensor(cum_dst, device=dev).to(torch.int64)
    k = torch.arange(NPOOL, device=dev)
    j = (torch.searchsorted(cum, k, right=True) - 1).clamp(0, S - 1)
    src0 = torch.where(k < cum[S], lane_src[j] + (k - cum[j]) * blk_b,
                       int(zero_off))
    idx = src0.to(torch.int32)[:, None] + torch.arange(
        blk_b, dtype=torch.int32, device=dev)
    blocks = by[idx.clamp_(0, by.shape[0] - 1)].view(NPOOL, BLK_W, 4)
    return blocks.flip(-1).view(torch.int32).view(NPOOL, BLK_W)


def pad_pool(pool_dev, NPOOL: int):
    """An uploaded exact-size pool cut or zero-padded to [NPOOL, BLK_W] on
    its device: the trailing zero blocks are the window-overrun guard."""
    pool_dev = _as_i32_bits(pool_dev)
    n = pool_dev.shape[0]
    if n >= NPOOL:
        return pool_dev[:NPOOL]
    return torch.cat([pool_dev, torch.zeros(
        (NPOOL - n, BLK_W), dtype=pool_dev.dtype, device=pool_dev.device)])


# ------------------------------------------------------------ the decoder
def _lanes(blocks, start_bits, bs, bps0, chass):
    """numpy arrays → CPU tensors (the pool as int32 bits); nothing moves
    between devices."""
    return (_as_i32_bits(blocks),) + tuple(
        torch.as_tensor(x) for x in (start_bits, bs, bps0, chass))


def flac_frame_entropy(blocks, start_bits, bs, bps0, chass,
                       L: int, NSAMP: int, nch: int, NPOOL: int):
    """Decode subframe headers and residuals for L frame lanes.

    blocks:     [NPOOL, BLK_W] u32 big-endian words (int32 bits in a
                tensor) — the shared frame pool; its last two blocks are
                zero (the overrun guard).
    start_bits: [L] absolute pool bit of each lane's subframe 0.
    bs:         [L] block size; bps0: [L] the frame's sample bits; chass:
                [L] channel assignment (8 left/side, 9 right/side, 10
                mid/side).

    Returns a dict of tensors on the pool's device: residual [L, nch,
    NSAMP] int32 (warm-ups at [0, order), a constant subframe's value below
    bs, zeros from bs on), coeffs [L, nch, 32], order, shift, wasted,
    sub_bps [L, nch] int32 (constant and verbatim subframes report order ==
    bs), err [L] bool, end_bits [L] int32 (the absolute cursor after the
    last subframe, before byte alignment).
    """
    blocks, start_bits, bs, bps0, chass = _lanes(
        blocks, start_bits, bs, bps0, chass)
    if NPOOL < 2:
        raise _kernels.KernelArgError(
            f"flac_frame_entropy: NPOOL {NPOOL} < 2")
    if blocks.device.type == "cpu":
        return flac_frame_entropy_torch(blocks, start_bits, bs, bps0, chass,
                                        L, NSAMP, nch, NPOOL)
    if blocks.device.type == "cuda":
        return flac_frame_entropy_cuda(blocks, start_bits, bs, bps0, chass,
                                       L, NSAMP, nch, NPOOL)
    raise _kernels.KernelArgError(
        f"flac_frame_entropy: no kernel for device {blocks.device}")


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values held in int64 (32 for 0)."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)
    return torch.where(x == 0, 32, 32 - e)


def _sext(v, n):
    """Sign-extend the n-bit value v (u32 in int64), n masked to 5 bits as
    the reference masks it (no sign bit for n <= 0) → int32 value in
    int64."""
    if isinstance(n, int):
        s = 1 << ((n - 1) & 31) if n > 0 else 0
    else:
        s = torch.where(n > 0, 1 << ((n - 1) & 31), 0)
    return _wrap32((v ^ s) - s)


def _take(hi, w):
    """The first w bits of the u32 hi (w masked to 5 bits as the reference
    masks it; 0 when w <= 0)."""
    if isinstance(w, int):
        return hi >> ((32 - w) & 31) if w > 0 else torch.zeros_like(hi)
    return torch.where(w > 0, hi >> ((32 - w) & 31), 0)


def _funnel(a, b, o):
    """The 32 bits from bit o (0..31) of the 64 bits a‖b (u32 in int64)."""
    return ((a << o) | ((b >> (31 - o)) >> 1)) & _M32


def _unary(w1, w2):
    """Zeros before the first 1 of the 64 bits w1‖w2: (q, q64), q = 63 and
    q64 set when there is none."""
    q64 = (w1 == 0) & (w2 == 0)
    q = torch.where(w1 != 0, _clz32(w1), 32 + _clz32(w2))
    return torch.where(q64, 63, q), q64


def flac_frame_entropy_torch(blocks, start_bits, bs, bps0, chass,
                             L: int, NSAMP: int, nch: int, NPOOL: int):
    """Plain PyTorch twin of the CUDA kernel: the same contract as
    flac_frame_entropy.  The lanes side by side, a Python loop over the
    header fields and the residual samples (the JAX package's scan), pool
    words as int64 holding u32 values: the test oracle and the on-card
    comparison, never the CUDA main path."""
    blocks, start_bits, bs, bps0, chass = _lanes(
        blocks, start_bits, bs, bps0, chass)
    dev = blocks.device
    words = blocks.reshape(-1).to(torch.int64) & _M32
    nw = words.shape[0]
    wz = torch.cat([words, torch.zeros(1, dtype=torch.int64, device=dev)])

    def word(i):
        return wz[torch.where((i >= 0) & (i < nw), i, nw)]

    def top32(p):
        """the 32 bits from bit p; bits outside the pool read 0"""
        return _funnel(word(p >> 5), word((p >> 5) + 1), p & 31)

    i64 = torch.int64
    pos = start_bits.to(i64)
    bs = bs.to(i64)
    bps0 = bps0.to(i64)
    chass = chass.to(i64)
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    fixed = torch.zeros((5, 32), dtype=i64, device=dev)
    fixed[:, :4] = torch.from_numpy(_FIXED_COEF)
    max_pos = (NPOOL - 2) * BLK_BITS - 64
    nblk = -(-NSAMP // K_SAMP)
    iota = torch.arange(NSAMP, device=dev)
    ar4 = torch.arange(4, device=dev)
    outs = {k: [] for k in ("residual", "coeffs", "order", "shift",
                            "wasted", "sub_bps")}

    for ci in range(nch):
        # ---------------- subframe header
        sub_bps = bps0 + (((chass == 8) | (chass == 10)) if ci == 1 else
                          (chass == 9) if ci == 0 else 0)
        hdr = _take(top32(pos), 8)
        pos = pos + 8
        err = err | ((hdr & 0x80) != 0)
        t = (hdr & 0x7E) >> 1
        uq, q64 = _unary(top32(pos), top32(pos + 32))
        has_w = (hdr & 1) == 1
        wasted = torch.where(has_w, uq + 1, 0)
        err = err | (has_w & q64)
        pos = pos + wasted
        err = err | (wasted >= sub_bps)
        sub_bps = (sub_bps - wasted).clamp(min=1)

        is_const = t == 0
        is_verb = t == 1
        is_lpc = (t & 0x20) != 0
        is_fixed = ((t & 0x08) != 0) & ~is_lpc
        err = err | ~(is_const | is_verb | is_lpc | is_fixed)
        order = torch.where(is_lpc, (t & 0x1F) + 1,
                            torch.where(is_fixed, t & 0x07, 0))
        err = err | (is_fixed & (order > 4))

        cval = _sext(_take(top32(pos), sub_bps), sub_bps)
        pos = pos + torch.where(is_const, sub_bps, 0)

        has_res = is_lpc | is_fixed
        warm = torch.zeros((L, 32), dtype=i64, device=dev)
        for i in range(32):
            sel = has_res & (i < order)
            if not bool(sel.any()):
                break
            v = _sext(_take(top32(pos), sub_bps), sub_bps)
            warm[:, i] = torch.where(sel, v, 0)
            pos = pos + torch.where(sel, sub_bps, 0)

        prec = _take(top32(pos), 4)
        err = err | (is_lpc & (prec == 15))
        prec = prec + 1
        pos = pos + torch.where(is_lpc, 4, 0)
        shv = _sext(_take(top32(pos), 5), 5).clamp(min=0)
        pos = pos + torch.where(is_lpc, 5, 0)
        cf = torch.zeros((L, 32), dtype=i64, device=dev)
        for j in range(32):
            sel = is_lpc & (j < order)
            if not bool(sel.any()):
                break
            cf[:, j] = torch.where(sel, _sext(_take(top32(pos), prec), prec),
                                   0)
            pos = pos + torch.where(sel, prec, 0)
        cf = torch.where(is_fixed[:, None], fixed[order.clamp(0, 4)], cf)
        shv = torch.where(is_lpc, shv, 0)

        # residual coding method, partition order, first parameter
        method = _take(top32(pos), 2)
        err = err | (has_res & (method > 1))
        pos = pos + torch.where(has_res, 2, 0)
        pbits = torch.where(method == 0, 4, 5)
        escape = (1 << pbits) - 1
        po = _take(top32(pos), 4)
        pos = pos + torch.where(has_res, 4, 0)
        base_n = bs >> po
        cnt0 = base_n - order
        err = err | (has_res & (cnt0 < 0))
        pr = _take(top32(pos), pbits)
        pos = pos + torch.where(has_res, pbits, 0)
        esc0 = has_res & (pr == escape)
        nb0 = _take(top32(pos), 5)
        pos = pos + torch.where(esc0, 5, 0)

        # verbatim rides the scan as one raw n-bit partition
        raw = is_verb | esc0
        kpar = torch.where(is_verb, sub_bps, torch.where(esc0, nb0, pr))
        cnt = torch.where(is_verb, bs, cnt0)
        wcount = torch.where(has_res, order, 0)
        n_scan = torch.where(is_const | err, 0,
                             torch.where(is_verb, bs, bs - order))
        pbits_l = torch.where(has_res, pbits, 0)
        counts = pbits_l > 0

        # ---------------- residual scan, the cursor clamped each K_SAMP
        rs = torch.zeros((L, nblk * K_SAMP), dtype=i64, device=dev)
        for s in range(nblk * K_SAMP):
            if s % K_SAMP == 0:
                pos = pos.clamp(min=0).clamp(max=max_pos)
                if not bool(((s < n_scan) & ~err).any()):
                    break
            act = (s < n_scan) & ~err
            cross = act & (cnt == 0) & counts
            if bool(cross.any()):
                pr = _take(top32(pos), pbits_l)
                pos = pos + torch.where(cross, pbits_l, 0)
                esc = cross & (pr == escape)
                nb = _take(top32(pos), 5)
                pos = pos + torch.where(esc, 5, 0)
                raw = torch.where(cross, esc, raw)
                kpar = torch.where(cross, torch.where(esc, nb, pr), kpar)
                cnt = torch.where(cross, base_n, cnt)
            # the four words from the cursor's: the unary run and the
            # remainder lie within them
            win = word((pos >> 5)[:, None] + ar4)
            o = pos & 31
            w1 = _funnel(win[:, 0], win[:, 1], o)
            q, q64 = _unary(w1, _funnel(win[:, 1], win[:, 2], o))
            err = err | (act & ~raw & q64)
            r = o + q + 1
            k = (r >> 5)[:, None]
            xy = win.gather(1, torch.cat([k, k + 1], 1))
            rem = _take(_funnel(xy[:, 0], xy[:, 1], r & 31), kpar)
            ui = _wrap32(((q << (kpar & 31)) & _M32) | rem)
            vr = (ui >> 1) ^ -(ui & 1)
            vw = _sext(_take(w1, kpar), kpar)
            v = torch.where(raw, vw, vr)
            adv = torch.where(raw, kpar, q + 1 + kpar)
            pos = pos + torch.where(act, adv, 0)
            cnt = cnt - (act & counts).to(i64)
            rs[:, s] = torch.where(act, v, 0)

        # [warm-ups | residuals], a constant's value, zeros from bs on
        idx = (iota[None, :] - wcount[:, None]).clamp(min=0)
        res = rs.gather(1, idx)
        w_exp = torch.nn.functional.pad(warm, (0, max(NSAMP - 32, 0)))
        res = torch.where(iota < wcount[:, None], w_exp[:, :NSAMP], res)
        res = torch.where(is_const[:, None], cval[:, None], res)
        res = torch.where(iota < bs[:, None], res, 0)

        outs["residual"].append(res)
        outs["coeffs"].append(cf)
        outs["order"].append(torch.where(is_const | is_verb, bs, order))
        outs["shift"].append(shv)
        outs["wasted"].append(wasted)
        outs["sub_bps"].append(sub_bps)

    out = {k: torch.stack(v, dim=1).to(torch.int32)
           for k, v in outs.items()}
    out["err"] = err
    out["end_bits"] = pos.to(torch.int32)
    return out


def flac_frame_entropy_cuda(blocks, start_bits, bs, bps0, chass,
                            L: int, NSAMP: int, nch: int, NPOOL: int):
    """Launch the CUDA frame-entropy kernel (csrc/flac_rice.cu) on the
    tensors' card, on its current stream.  blocks [NPOOL, BLK_W] int32 and
    start_bits, bs, bps0, chass [L] int32, contiguous on one CUDA device.
    Returns the flac_frame_entropy dict."""
    dev = blocks.device
    _check(blocks, start_bits, bs, bps0, chass, L, NPOOL)
    out = rice_outputs(L, NSAMP, nch, dev)
    if L:
        _launch(blocks, start_bits, bs, bps0, chass, NSAMP, nch, out)
    return out


def rice_outputs(L: int, NSAMP: int, nch: int, dev):
    """The output dict of flac_frame_entropy on `dev`, unwritten: the
    kernel writes every element.  order, shift, wasted and sub_bps are
    views of one [4, L, nch] int32 tensor, ``fields``."""
    fields = torch.empty((4, L, nch), dtype=torch.int32, device=dev)
    return {
        "residual": torch.empty((L, nch, NSAMP), dtype=torch.int32,
                                device=dev),
        "coeffs": torch.empty((L, nch, 32), dtype=torch.int32, device=dev),
        "order": fields[0], "shift": fields[1], "wasted": fields[2],
        "sub_bps": fields[3], "fields": fields,
        "err": torch.empty(L, dtype=torch.bool, device=dev),
        "end_bits": torch.empty(L, dtype=torch.int32, device=dev),
    }


def rice_launch(blocks, start_bits, bs, bps0, chass, NSAMP: int, nch: int,
                out):
    """The kernel's launch alone, into `out` (from rice_outputs): what
    flac_frame_entropy_cuda does after its checks and allocations.  Returns
    out."""
    L = start_bits.shape[0]
    _check(blocks, start_bits, bs, bps0, chass, L, blocks.shape[0])
    _kernels.check_args("flac_frame_entropy", blocks.device, (
        ("residual", out["residual"], (torch.int32,), (L, nch, NSAMP)),
        ("coeffs", out["coeffs"], (torch.int32,), (L, nch, 32)),
        ("fields", out["fields"], (torch.int32,), (4, L, nch)),
        ("err", out["err"], (torch.bool,), (L,)),
        ("end_bits", out["end_bits"], (torch.int32,), (L,)),
    ))
    if L:
        _launch(blocks, start_bits, bs, bps0, chass, NSAMP, nch, out)
    return out


def _check(blocks, start_bits, bs, bps0, chass, L, NPOOL):
    dev = blocks.device
    _kernels.check_args("flac_frame_entropy", dev, (
        ("blocks", blocks, (torch.int32,), (NPOOL, BLK_W)),
        ("start_bits", start_bits, (torch.int32,), (L,)),
        ("bs", bs, (torch.int32,), (L,)),
        ("bps0", bps0, (torch.int32,), (L,)),
        ("chass", chass, (torch.int32,), (L,)),
    ))
    if not 2 <= NPOOL <= 1 << 20:
        raise _kernels.KernelArgError(
            f"flac_frame_entropy: NPOOL {NPOOL} out of range (int32 bit "
            "cursors)")


def _launch(blocks, start_bits, bs, bps0, chass, NSAMP, nch, out):
    global RICE_LAUNCHES
    dev = blocks.device
    lib = _kernels.load("flac_rice")
    with torch.cuda.device(dev):
        rc = lib.af_flac_rice(
            blocks.data_ptr(), blocks.shape[0], start_bits.data_ptr(),
            bs.data_ptr(), bps0.data_ptr(), chass.data_ptr(),
            start_bits.shape[0], NSAMP, nch, out["residual"].data_ptr(),
            out["coeffs"].data_ptr(), out["fields"].data_ptr(),
            out["err"].data_ptr(), out["end_bits"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_launch("flac_frame_entropy", rc)
    with _launch_lock:
        RICE_LAUNCHES += 1
