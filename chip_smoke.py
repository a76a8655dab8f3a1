#!/usr/bin/env python3
"""Drive the audio_formats_torch FLAC and QOA slices once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device — a CUDA GPU is present (no fallback), its name and power limit,
   and the C host entropy stage loads;
2. build  — nvcc builds every CUDA kernel from csrc/, all at once;
3. kernel — each kernel against its plain PyTorch twin on the card at the
   main path's shape, bit for bit, both timed: the LPC kernel at 12,288
   lanes x 4,096 samples (and against the exact int64 host oracle on a
   subset of lanes); the QOA decode kernel at 8,192 x 5,120 in both input
   forms (int32 residuals, int8 scalefactors and codes); the QOA encode
   search at 2,048 x 5,120 with frame lengths around slice edges and
   full-scale square waves;
4. FLAC   — ``BatchDecoder(streams, device="cuda").decode_all(output="device")``
   over 512 FLAC lanes cut from 16 synthetic masters (16-bit stereo 44.1 kHz
   mid/side LPC-8, block 4096, 6-10 s), then ``.sync()``; the PCM stays on
   the card, every lane equals its source PCM bit for bit after
   ``.to_numpy()``, no group was demoted, and the LPC kernel launched once
   per window;
5. QOA encode — ``encode_qoa_batch`` over 64 distinct stereo 44.1 kHz
   masters of 4 s (the JAX bench's encode shape: 4,480 frame lanes), one
   search launch per chunk; frames equal to the golden encoder's; the
   sequential layout on 4 masters equal to the streaming QoaEncoder;
6. QOA decode — ``decode_all(output="device")`` over 512 QOA lanes cut as
   frame prefixes (10-35 frames) of the 64 encoded masters: every lane
   equals an independent numpy decode, two equal the golden decoder, each
   master is > 25 dB from its source, one decode launch per window;
7. mixed  — mono lanes, 24-bit lanes (host frames), 18-bit lanes that mix
   host and device frames in one window, corpus lanes, 8 QOA lanes and a
   corrupt FLAC and a corrupt QOA lane in one batch: every other lane
   exact.

Prints a JSON line with the kernels' launches, errors and times, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))  # golden FLAC/QOA coders

SR = 44100
BLOCK = 4096
N_MASTERS = 16
N_LANES = 512
L_KERNEL = 12288      # 512 lanes x 12 frames x 2 channels: one full window
B_KERNEL = 4096
QOA_MASTERS = 64      # bench.py's bench_batch_encode(B=64, secs=4)
QOA_SECONDS = 4
QOA_LANES = 512
QOA_FRAME = 5120
L_QOA_DECODE = 8192   # one full decode window
L_QOA_ENCODE = 2048   # one full encode chunk
F32_RECIP = np.float32(1.0) / np.float32(32767.0)  # QOA's s16 -> float


# --------------------------------------------------------------- corpus
def flac_master(seed: int, seconds: float):
    """One FLAC master: stereo mid/side 16-bit, mixed tonal+noise content
    (the FLAC half of the repo's benchmark corpus).  Returns (bytes, pcm)."""
    from golden import flac_ref

    rng = np.random.default_rng([7, seed])
    frames = int(seconds * SR)
    t = np.arange(frames)[:, None]
    f0 = rng.uniform(80, 800)
    amp = rng.uniform(4000, 16000)
    noise = rng.uniform(100, 1500)
    x = np.clip(
        np.round(
            amp * np.sin(2 * np.pi * f0 * t * [1.0, 1.003] / SR)
            + 0.35 * amp * np.sin(2 * np.pi * 2.7 * f0 * t * [1.0, 0.99] / SR)
            + noise * rng.standard_normal((frames, 2))
        ),
        -32768, 32767,
    ).astype(np.int64)
    data = flac_ref.build_flac(x, SR, 16, block_size=BLOCK,
                               stereo_mode="mid_side", modes=["lpc8", "lpc8"])
    return data, x


def frame_offsets(data: bytes):
    """Byte offsets of every frame, found by a CRC8-validated sync scan."""
    from golden.flac_ref import _crc8

    pos = 4
    while True:
        hdr = data[pos: pos + 4]
        pos += 4 + int.from_bytes(hdr[1:4], "big")
        if hdr[0] & 0x80:
            break
    b = np.frombuffer(data, np.uint8)
    # 14-bit sync + the golden encoder's header shape (block size code 7)
    cand = np.flatnonzero((b[pos:-8] == 0xFF) & ((b[pos + 1:-7] & 0xFC) == 0xF8)
                          & ((b[pos + 2:-6] >> 4) == 7)) + pos
    offs = []
    for i in cand.tolist():
        if offs and i < offs[-1] + 16:
            continue
        # header: 4 fixed bytes, utf8 frame index, 16-bit (bs-1), crc8
        fb = data[i + 4]
        ext = 0 if fb < 0x80 else (
            1 if fb >> 5 == 0b110 else 2 if fb >> 4 == 0b1110 else
            3 if fb >> 3 == 0b11110 else 4 if fb >> 2 == 0b111110 else
            5 if fb >> 1 == 0b1111110 else 6)
        j = i + 5 + ext + 2
        if j < len(data) and _crc8(data[i:j]) == data[j]:
            offs.append(i)
    return offs


def flac_prefix(data: bytes, offs, n_keep: int):
    """The stream cut to its first n_keep frames, with STREAMINFO's total
    sample count patched to match; the whole stream when it is shorter."""
    if len(offs) <= n_keep:
        return data
    body_off = 8  # 4 ('fLaC') + 4 (STREAMINFO block header)
    si = int.from_bytes(data[body_off: body_off + 18], "big")
    shift = 18 * 8 - 108 - 36
    si &= ~(((1 << 36) - 1) << shift)
    si |= (n_keep * BLOCK) << shift
    return (data[:body_off] + si.to_bytes(18, "big")
            + data[body_off + 18: offs[n_keep]])


def build_corpus(n_lanes=N_LANES, n_masters=N_MASTERS, workers=8):
    """n_lanes FLAC lanes cut as frame prefixes of n_masters masters.
    Returns (streams, expected s32-source pcm per lane)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    secs = [6.0 + (i % 5) for i in range(n_masters)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        masters = list(ex.map(flac_master, range(n_masters), secs))
    offs = [frame_offsets(d) for d, _ in masters]
    streams, pcms = [], []
    for k in range(n_lanes):
        mi = k % n_masters
        data, pcm = masters[mi]
        nfr = len(offs[mi])
        keep = nfr - (k // n_masters * 3) % (nfr - 8)
        streams.append(flac_prefix(data, offs[mi], keep))
        pcms.append(pcm[: keep * BLOCK])
    return streams, pcms


def edge_streams(rng, corpus, corpus_pcm):
    """Mono 16-bit lanes, 24-bit stereo lanes, 18-bit lanes mixing host and
    device frames, a few corpus lanes and one corrupt lane (last)."""
    from golden import flac_ref

    streams, pcms, bps = [], [], []

    def tone(frames, ch, bits):
        t = np.arange(frames)[:, None]
        a = 0.3 * (1 << (bits - 1))
        x = (a * np.sin(2 * np.pi * rng.uniform(100, 900) * t
                        * [1.0, 1.01][:ch] / SR)
             + a / 50 * rng.standard_normal((frames, ch)))
        lim = (1 << (bits - 1)) - 1
        return np.clip(np.round(x), -lim - 1, lim).astype(np.int64)

    for i in range(4):
        x = tone(SR + 1234 * i, 1, 16)
        streams.append(flac_ref.build_flac(x, SR, 16, block_size=BLOCK,
                                           modes=["lpc8"]))
        pcms.append(x), bps.append(16)
    for i in range(2):
        x = tone(SR // 2 + 777 * i, 2, 24)
        streams.append(flac_ref.build_flac(x, SR, 24, block_size=BLOCK,
                                           stereo_mode="left_side",
                                           modes=["lpc8", "fixed2"]))
        pcms.append(x), bps.append(24)
    for i in range(2):
        # 18-bit stereo: independent frames (18-bit exact lanes on the
        # card) alternate with mid/side frames (19-bit side: host)
        nf = 6 + i
        x = tone(BLOCK * nf, 2, 18)
        out = bytearray(b"fLaC")
        si = flac_ref._BW()
        si.w(BLOCK, 16); si.w(BLOCK, 16); si.w(0, 24); si.w(0, 24)
        si.w(SR, 20); si.w(1, 3); si.w(17, 5); si.w(BLOCK * nf, 36)
        info = bytes(si.bytes) + b"\0" * 16
        out += bytes([0x80]) + len(info).to_bytes(3, "big") + info
        for fi in range(nf):
            mode = "independent" if fi % 2 == 0 else "mid_side"
            out += flac_ref.encode_frame(x[fi * BLOCK:(fi + 1) * BLOCK], fi,
                                         SR, 18, mode, ["lpc8", "lpc8"])
        streams.append(bytes(out))
        pcms.append(x), bps.append(18)
    for k in range(0, 64, 8):
        streams.append(corpus[k])
        pcms.append(corpus_pcm[k]), bps.append(16)
    bad = bytearray(corpus[1])
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    streams.append(bytes(bad))
    return streams, pcms, bps


def expected_f32(pcm, bits):
    return ((pcm << (32 - bits)).astype(np.float64)
            * (1.0 / 2147483647.0)).astype(np.float32)


def qoa_masters(n=QOA_MASTERS, seconds=QOA_SECONDS):
    """n distinct stereo float masters: two detuned partials under a slow
    swell, plus a little noise, each from its own seed."""
    frames = int(seconds * SR)
    t = np.arange(frames)[:, None] / SR
    out = []
    for i in range(n):
        rng = np.random.default_rng([11, i])
        f0 = rng.uniform(60, 900)
        amp = rng.uniform(0.1, 0.6)
        swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        x = (amp * swell * np.sin(2 * np.pi * f0 * t * [1.0, 1.002])
             + 0.3 * amp * np.sin(2 * np.pi * 3.1 * f0 * t * [1.0, 0.997])
             + amp * rng.uniform(0.005, 0.03)
             * rng.standard_normal((frames, 2)))
        out.append(np.clip(x, -1.0, 1.0).astype(np.float32))
    return out


def qoa_s16(master):
    from audio_formats_torch.ops import pcm

    return pcm.quantize_float_to_int_np(master.reshape(-1), "s16")\
        .reshape(-1, master.shape[1]).astype(np.int16)


def qoa_frame_bytes(ch, samples=QOA_FRAME):
    return 8 + 16 * ch + 8 * (-(-samples // 20)) * ch


def qoa_prefix(data: bytes, keep: int):
    """The QOA stream cut to its first `keep` frames, the file header's
    sample count patched to match.  Returns (bytes, samples per channel)."""
    total = int.from_bytes(data[:8], "big") & 0xFFFFFFFF
    ch = data[8]
    n = min(total, keep * QOA_FRAME)
    body = data[8:] if n == total else data[8: 8 + keep * qoa_frame_bytes(ch)]
    return ((0x716F6166 << 32) | n).to_bytes(8, "big") + body, n


def numpy_qoa_decode(streams):
    """Independent decode of whole QOA streams: every (frame, channel) of
    every stream is one lane (QOA frames carry their LMS state), run as one
    vectorised int32 recurrence with numpy's wraparound.  Returns the s16
    PCM of each stream."""
    from golden import qoa_ref

    dq = np.array(qoa_ref.DEQUANT_TAB, np.int32)
    shifts = np.uint64(57) - np.uint64(3) * np.arange(20, dtype=np.uint64)
    hist, wts, res, meta = [], [], [], []
    for si, data in enumerate(streams):
        total = int.from_bytes(data[:8], "big") & 0xFFFFFFFF
        pos, done = 8, 0
        while done < total:
            hdr = int.from_bytes(data[pos: pos + 8], "big")
            ch, n, size = hdr >> 56, (hdr >> 16) & 0xFFFF, hdr & 0xFFFF
            state = np.frombuffer(data, ">i2", 8 * ch, pos + 8).reshape(ch, 2, 4)
            ns = -(-n // 20)
            words = np.frombuffer(data, ">u8", ns * ch, pos + 8 + 16 * ch)\
                .reshape(ns, ch).T
            codes = ((words[..., None] >> shifts) & np.uint64(7)).astype(np.int64)
            r = np.zeros((ch, QOA_FRAME), np.int32)
            r[:, : ns * 20] = dq[(words >> np.uint64(60)).astype(np.int64)[..., None],
                                 codes].reshape(ch, -1)
            hist.append(state[:, 0])
            wts.append(state[:, 1])
            res.append(r)
            meta.append((si, ch, n))
            pos += size
            done += n
    h = np.concatenate(hist).astype(np.int32)
    w = np.concatenate(wts).astype(np.int32)
    r = np.concatenate(res)
    out = np.empty_like(r)
    for t in range(QOA_FRAME):
        p = (h * w).sum(axis=1, dtype=np.int32) >> 13
        x = np.clip(p + r[:, t], -32768, 32767)
        delta = (r[:, t] >> 4)[:, None]
        w += np.where(h < 0, -delta, delta)
        h = np.concatenate([h[:, 1:], x[:, None]], axis=1)
        out[:, t] = x
    pcm = [[] for _ in streams]
    row = 0
    for si, ch, n in meta:
        pcm[si].append(out[row: row + ch, :n].T)
        row += ch
    return [np.concatenate(p).astype(np.int16) for p in pcm]


# --------------------------------------------------------------- phases
def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernel_lanes(rng, L, B, n_sig):
    """Random lanes for kernel-vs-twin (exact and wrap lanes, orders 0..32,
    shifts 0..31, 15-bit coefficients, pad lanes), whose first n_sig lanes
    are instead built from bounded signals, so the int64 host oracle and the
    signal itself must come back from them.  Returns (args, signal)."""
    residual = rng.integers(-(1 << 17), 1 << 17, (L, B), dtype=np.int32)
    order = rng.integers(0, 33, L).astype(np.int32)
    shift = rng.integers(0, 32, L).astype(np.int32)
    exact = rng.random(L) < 0.5
    lim = np.where(exact, 1 << 14, 1 << 9)
    coeffs = np.zeros((L, 32), np.int32)
    taps = np.arange(32)[None, :] < order[:, None]
    coeffs[taps] = (rng.integers(-(1 << 14), 1 << 14, (L, 32))
                    % (2 * lim[:, None]) - lim[:, None])[taps]
    pad = rng.random(L) < 0.1
    pad[:n_sig] = False
    order[pad] = B
    # signal lanes: |s| < 2^15 (wrap) or 2^17 (exact), residual = s - pred
    t = np.arange(B)
    amp = np.where(exact[:n_sig], 1 << 16, 1 << 14)[:, None]
    sig = np.round(amp * np.sin(2 * np.pi * rng.uniform(1e-3, 0.2, (n_sig, 1))
                                * t)
                   + rng.integers(-300, 300, (n_sig, B))).astype(np.int64)
    acc = np.zeros((n_sig, B), np.int64)
    for j in range(32):
        acc[:, j + 1:] += coeffs[:n_sig, j: j + 1].astype(np.int64) \
            * sig[:, : B - j - 1]
    wrapped = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    pred = np.where(exact[:n_sig, None], acc, wrapped) >> shift[:n_sig, None]
    res = np.where(t[None, :] < order[:n_sig, None], sig, sig - pred)
    residual[:n_sig] = res.astype(np.int32)
    return (residual, coeffs, order, shift, exact), sig


def time_cuda(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(card, L=L_KERNEL, B=B_KERNEL, n_sig=256):
    import torch
    from audio_formats_torch.ops import lpc

    rng = np.random.default_rng(2024)
    args, sig = kernel_lanes(rng, L, B, n_sig)
    dev = torch.device("cuda")
    targs = [torch.from_numpy(a).to(dev) for a in args]
    got = lpc.flac_lpc(*targs)
    torch.cuda.synchronize()
    want = lpc.flac_lpc_torch(*targs)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"LPC kernel != twin: max abs err {err}")
    sub = got[:n_sig].cpu().numpy()
    # drflac stores the exact sum's sample into int32
    oracle = lpc.flac_lpc_np(*(a[:n_sig] for a in args[:4])).astype(np.int32)
    if not (np.array_equal(sub, oracle) and np.array_equal(sub, sig)):
        raise AssertionError("LPC kernel != int64 host oracle on the "
                             "signal lanes")
    for _ in range(3):
        lpc.flac_lpc(*targs)
    ms = time_cuda(lambda: lpc.flac_lpc(*targs), 20)
    plain_ms = time_cuda(lambda: lpc.flac_lpc_torch(*targs), 1)
    print(f"# kernel flac_lpc L={L} B={B}: bit-equal to the twin on all "
          f"lanes, to the int64 oracle on {n_sig}; kernel {ms:.4f} ms, "
          f"twin {plain_ms:.1f} ms [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_qoa_kernels(card):
    """The QOA decode kernel (both forms) at one full window and the encode
    search at one full chunk, each against its twin, bit for bit."""
    import torch
    from audio_formats_torch.ops import lms

    rng = np.random.default_rng(2025)
    dev = torch.device("cuda")
    # decode: random int8 payloads; some lanes with int32-range weights
    L, S = L_QOA_DECODE, QOA_FRAME // 20
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 15), 1 << 15, (L, 4)).astype(np.int32)
    wild = rng.random(L) < 0.05
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (int(wild.sum()), 4))
    h, w = (torch.from_numpy(a).to(dev) for a in (history, weights))
    sf = torch.from_numpy(rng.integers(0, 16, (L, S)).astype(np.int8)).to(dev)
    codes = torch.from_numpy(
        rng.integers(0, 8, (L, S, 20)).astype(np.int8)).to(dev)
    tab = torch.from_numpy(lms.DEQUANT_TAB).to(dev)
    deq = tab[sf.long()[..., None], codes.long()].reshape(L, -1).contiguous()
    fused = lms.decode_slices(h, w, sf, codes)
    plain = lms.qoa_decode(h, w, deq)
    torch.cuda.synchronize()
    want = []
    dec_plain_ms = time_cuda(
        lambda: want.append(lms.qoa_decode_torch(h, w, deq)), 1)
    dec_err = max(int((g.long() - want[0].long()).abs().max())
                  for g in (fused, plain))
    if not (torch.equal(fused, want[0]) and torch.equal(plain, want[0])):
        raise AssertionError(f"QOA decode kernel != twin: max abs err "
                             f"{dec_err}")
    for _ in range(3):
        lms.decode_slices(h, w, sf, codes)
    dec_ms = time_cuda(lambda: lms.decode_slices(h, w, sf, codes), 20)
    dec_deq_ms = time_cuda(lambda: lms.qoa_decode(h, w, deq), 20)
    print(f"# kernel qoa_decode L={L} T={QOA_FRAME}: both forms bit-equal to "
          f"the twin; int8 sf/codes {dec_ms:.4f} ms, int32 residuals "
          f"{dec_deq_ms:.4f} ms, twin {dec_plain_ms:.1f} ms [{card}]")

    # encode: full-scale squares (qoa_div's int32 product overflows),
    # noise and tones; frame lengths around slice edges; carried and
    # int32-range starting states
    L = L_QOA_ENCODE
    t = np.arange(QOA_FRAME)
    kind = (np.arange(L) % 4)[:, None]
    square = np.where((t // rng.integers(2, 400, (L, 1))) % 2, 32767, -32768)
    noise = rng.integers(-32768, 32768, (L, QOA_FRAME))
    tone = (rng.uniform(1000, 30000, (L, 1))
            * np.sin(2 * np.pi * rng.uniform(20, 2000, (L, 1)) * t / SR)
            + rng.normal(0, 200, (L, QOA_FRAME)))
    x = np.clip(np.round(np.select([kind == 0, kind == 1], [square, noise],
                                   tone)), -32768, 32767)
    flen = np.full(L, QOA_FRAME, np.int32)
    flen[:7] = [0, 1, 19, 20, 21, 5119, 5120]
    short = rng.random(L) < 0.1
    short[:7] = False
    flen[short] = rng.integers(0, QOA_FRAME + 1, int(short.sum()))
    x = (x * (t[None, :] < flen[:, None])).astype(np.int16)
    history = np.zeros((L, 4), np.int32)
    weights = np.tile(lms.INITIAL_WEIGHTS, (L, 1))
    carried = rng.random(L) < 0.25
    history[carried] = rng.integers(-32768, 32768, (int(carried.sum()), 4))
    weights[carried] = rng.integers(-32768, 32768, (int(carried.sum()), 4))
    wild = rng.random(L) < 0.02
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (int(wild.sum()), 4))
    args = [torch.from_numpy(a).to(dev) for a in (x, history, weights, flen)]
    got = lms.qoa_encode_frame_scan(*args)
    words = lms.qoa_encode_cuda(*args)[0]
    torch.cuda.synchronize()
    want = []
    enc_plain_ms = time_cuda(
        lambda: want.append(lms.qoa_encode_frame_torch(*args)), 1)
    want = want[0]
    enc_err = max(int((g.long() - v.long()).abs().max())
                  for g, v in zip(got, want))
    if not all(torch.equal(g, v) for g, v in zip(got, want)) or \
            not torch.equal(words, lms.pack_words(want[0], want[1])):
        raise AssertionError(f"QOA encode kernel != twin: max abs err "
                             f"{enc_err}")
    for _ in range(3):
        lms.qoa_encode_cuda(*args)
    enc_ms = time_cuda(lambda: lms.qoa_encode_cuda(*args), 20)
    print(f"# kernel qoa_encode L={L} T={QOA_FRAME}: words, scalefactors, "
          f"codes, history' and weights' equal to the twin; kernel "
          f"{enc_ms:.4f} ms, twin {enc_plain_ms:.1f} ms [{card}]")
    return ({"max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms},
            {"max_abs_err": enc_err, "ms": enc_ms, "plain_ms": enc_plain_ms})


def decode_checked(streams, expect, device, corrupt=()):
    """Run the main path on `streams` and hold every good lane to
    `expect(i)`, its float32 PCM.  The kernel counts are set to 0 just
    before the run and read just after.  Returns (decoder, wall seconds,
    launches by kernel, output)."""
    import torch
    from audio_formats_torch import BatchDecoder
    from audio_formats_torch.ops import lms, lpc

    dec = BatchDecoder(streams, device=device)
    lpc.KERNEL_LAUNCHES = 0
    lms.DECODE_LAUNCHES = 0
    t0 = time.perf_counter()
    res = dec.decode_all(output="device")
    res.sync()
    wall = time.perf_counter() - t0
    launches = {"flac_lpc": lpc.KERNEL_LAUNCHES,
                "qoa_decode": lms.DECODE_LAUNCHES}
    st = dec.stats
    for _, wins in res.windows():
        for w in wins:
            if w.device.type != torch.device(device).type:
                raise AssertionError(f"a PCM window lies on {w.device}")
    if st["group_demotions"] or st.get("lanes_demoted"):
        raise AssertionError(f"demotions: {st.get('group_exceptions')}")
    # every window launches exactly one kernel: LPC (FLAC) or LMS (QOA)
    if sum(launches.values()) != st["windows"]:
        raise AssertionError(f"kernel launches {launches} != windows "
                             f"{st['windows']}")
    out = res.to_numpy()
    for i in range(len(streams)):
        if i in corrupt:
            if out[i] is not None and not np.isfinite(out[i]).all():
                raise AssertionError(f"corrupt lane {i}: non-finite PCM")
            continue
        if dec.errors[i] is not None:
            raise AssertionError(f"lane {i}: {dec.errors[i]}")
        want = expect(i)
        got = out[i]
        if got.shape != want.shape or not np.isfinite(got).all() \
                or not np.array_equal(got, want):
            raise AssertionError(f"lane {i} differs from its expected PCM")
    return dec, wall, launches, out


def phase_qoa_encode(card, masters):
    """encode_qoa_batch over the masters on the card (the frame-parallel
    main path), checked against the golden encoder frame by frame, and the
    sequential layout against the streaming encoder."""
    from golden import qoa_ref

    from audio_formats_torch import encode_qoa_batch
    from audio_formats_torch.config import EncodingOptions
    from audio_formats_torch.io.source import ByteSink
    from audio_formats_torch.models.qoa import QoaEncoder
    from audio_formats_torch.ops import lms

    st = {}
    lms.ENCODE_LAUNCHES = 0
    t0 = time.perf_counter()
    streams = encode_qoa_batch(masters, SR, device="cuda", stats=st)
    wall = time.perf_counter() - t0
    launches = lms.ENCODE_LAUNCHES
    if launches != st["windows"]:
        raise AssertionError(f"QOA encode launches {launches} != windows "
                             f"{st['windows']}")
    # under the frame-parallel layout every frame is a fresh stream's first
    # frame: the golden encoder of that frame's samples alone gives it
    n_frames = -(-masters[0].shape[0] // QOA_FRAME)
    for mi, k in ((0, 0), (1, 0), (2, n_frames // 2), (3, n_frames - 1)):
        s16 = qoa_s16(masters[mi])[k * QOA_FRAME: (k + 1) * QOA_FRAME]
        gold = qoa_ref.encode(s16, SR)[8:]
        off = 8 + k * qoa_frame_bytes(2)
        if streams[mi][off: off + len(gold)] != gold:
            raise AssertionError(f"QOA master {mi} frame {k} != golden")
    for m, data in zip(masters, streams):
        n = m.shape[0]
        size = 8 + (n // QOA_FRAME) * qoa_frame_bytes(2) + \
            (qoa_frame_bytes(2, n % QOA_FRAME) if n % QOA_FRAME else 0)
        if len(data) != size or data[:8] != ((0x716F6166 << 32) | n)\
                .to_bytes(8, "big"):
            raise AssertionError("QOA stream framing")
    seq = encode_qoa_batch(masters[:4], SR, parallel_frames=False,
                           device="cuda")
    for m, data in zip(masters[:4], seq):
        sink = ByteSink()
        enc = QoaEncoder(sink, SR, 2, EncodingOptions(), device="cuda")
        enc.write(m)
        enc.finalize()
        if sink.getvalue() != data:
            raise AssertionError("sequential QOA batch != QoaEncoder")
    secs = sum(m.shape[0] for m in masters) / SR
    print(f"# QOA encode: {len(masters)} stereo masters, {secs:.1f} s of "
          f"audio in {wall:.3f} s wall = {secs / wall:.1f}x realtime; "
          f"windows {st['windows']}, encode launches {launches}, h2d_bytes "
          f"{st['h2d_bytes']}, d2h_bytes {st['d2h_bytes']}; 4 frames equal "
          f"to the golden encoder, sequential layout on 4 masters equal to "
          f"QoaEncoder [{card}]")
    return streams, launches


def qoa_lanes(streams):
    """QOA_LANES lanes cut as frame prefixes (10 to all 35 frames) of the
    encoded masters.  Returns (lanes, [(master, samples)])."""
    lanes, info = [], []
    for k in range(QOA_LANES):
        mi = k % len(streams)
        keep = 10 + (k // len(streams) * 7 + mi) % 26
        data, n = qoa_prefix(streams[mi], keep)
        lanes.append(data)
        info.append((mi, n))
    return lanes, info


def phase_qoa_decode(card, masters, streams):
    from golden import qoa_ref

    t0 = time.perf_counter()
    ref = numpy_qoa_decode(streams)
    print(f"# independent numpy decode of {len(streams)} masters: "
          f"{time.perf_counter() - t0:.1f} s")
    for mi, (m, got) in enumerate(zip(masters, ref)):
        src = qoa_s16(m).astype(np.float64)
        snr = 10 * np.log10((src ** 2).mean()
                            / max(((got - src) ** 2).mean(), 1e-12))
        if got.shape != src.shape or snr <= 25.0:
            raise AssertionError(f"QOA master {mi}: SNR {snr:.1f} dB")
    lanes, info = qoa_lanes(streams)
    dec, wall, launches, out = decode_checked(
        lanes, lambda i: ref[info[i][0]][: info[i][1]].astype(np.float32)
        * F32_RECIP, "cuda")
    if launches["qoa_decode"] != dec.stats["windows"]:
        raise AssertionError(f"QOA decode launches {launches}")
    short = [k for k, (mi, n) in enumerate(info) if n == 10 * QOA_FRAME][:2]
    for k in short:
        gold, _ = qoa_ref.decode(lanes[k])
        if not np.array_equal(out[k], gold.astype(np.float32) * F32_RECIP):
            raise AssertionError(f"QOA lane {k} != golden decoder")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# QOA slice: {len(lanes)} lanes equal to the independent decode "
          f"(lanes {short} also to the golden decoder), every master > 25 "
          f"dB; {secs:.1f} s of audio in {wall:.3f} s wall = "
          f"{secs / wall:.1f}x realtime; h2d_bytes {st['h2d_bytes']}, "
          f"windows {st['windows']}, decode launches "
          f"{launches['qoa_decode']}, host_ms {st['host_ms']:.0f}, "
          f"enqueue_ms {st['enqueue_ms']:.0f} [{card}]")
    return lanes, info, ref, launches["qoa_decode"]


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: this smoke test runs on the card")
    from audio_formats_torch.host import native
    from audio_formats_torch.ops import _kernels

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the C host stage did not build or load")
    print(f"# host stage loaded in {time.perf_counter() - t0:.1f} s")

    # 2. build: one nvcc per source, all started together
    names = ("flac_lpc", "qoa_lms")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        list(ex.map(_kernels.build, names))
    for name in names:
        _kernels.load(name)
    print(f"# nvcc builds of {', '.join(names)}: "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in _kernels.BUILD_LOG.items():
        print(f"#   {name}: nvcc {secs:.2f} s")
        for line in log.strip().splitlines():
            print(f"#   {name}: {line.strip()}")

    # 3. kernels vs twins
    kres = phase_kernel(card)
    dres, eres = phase_qoa_kernels(card)

    # 4. FLAC slice
    t0 = time.perf_counter()
    streams, pcms = build_corpus()
    print(f"# corpus: {len(streams)} lanes, "
          f"{sum(len(s) for s in streams) / 1e6:.1f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    dec, wall, launches, _ = decode_checked(
        streams, lambda i: expected_f32(pcms[i], 16), "cuda")
    if launches["flac_lpc"] != dec.stats["windows"]:
        raise AssertionError(f"LPC launches {launches}")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# FLAC slice: {len(streams)} lanes bit-exact, {secs:.1f} s of "
          f"audio in {wall:.3f} s wall = {secs / wall:.1f}x realtime; "
          f"h2d_bytes {st['h2d_bytes']}, windows {st['windows']}, "
          f"LPC launches {launches['flac_lpc']}, host_ms "
          f"{st['host_ms']:.0f}, enqueue_ms {st['enqueue_ms']:.0f} [{card}]")

    # 5. QOA encode, 6. QOA decode
    masters = qoa_masters()
    qoa_streams, enc_launches = phase_qoa_encode(card, masters)
    q_lanes, q_info, q_ref, dec_launches = phase_qoa_decode(
        card, masters, qoa_streams)

    # 7. mixed batch: FLAC edge lanes (corrupt FLAC lane last), 8 QOA lanes
    # and a corrupt QOA lane
    rng = np.random.default_rng(99)
    e_streams, e_pcms, e_bps = edge_streams(rng, streams, pcms)
    bad_flac = len(e_streams) - 1
    bad = bytearray(q_lanes[8])
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    m_streams = e_streams + q_lanes[:8] + [bytes(bad)]
    bad_qoa = len(m_streams) - 1

    def expect(i):
        if i < bad_flac:
            return expected_f32(e_pcms[i], e_bps[i])
        mi, n = q_info[i - bad_flac - 1]
        return q_ref[mi][:n].astype(np.float32) * F32_RECIP

    mdec, _, m_launches, _ = decode_checked(m_streams, expect, "cuda",
                                            corrupt=(bad_flac, bad_qoa))
    print(f"# mixed lanes (mono 16-bit, 24-bit, 18-bit mixed host/device, "
          f"FLAC corpus, 8 QOA, a corrupt FLAC and a corrupt QOA lane): "
          f"{len(m_streams) - 2} good lanes bit-exact, corrupt lane errors "
          f"{mdec.errors[bad_flac]!r} and {mdec.errors[bad_qoa]!r}, windows "
          f"{mdec.stats['windows']}, launches {m_launches}")

    print(json.dumps({"kernels": [
        {"name": "flac_lpc", "route": "cuda",
         "source": "audio_formats_torch/csrc/flac_lpc.cu",
         "replaces": "audio_formats_tpu/ops/lpc.py:158",
         "launches": launches["flac_lpc"], **kres},
        {"name": "qoa_decode", "route": "cuda",
         "source": "audio_formats_torch/csrc/qoa_lms.cu",
         "replaces": "audio_formats_tpu/ops/lms.py:135",
         "launches": dec_launches, **dres},
        {"name": "qoa_encode", "route": "cuda",
         "source": "audio_formats_torch/csrc/qoa_lms.cu",
         "replaces": "audio_formats_tpu/ops/lms.py:187",
         "launches": enc_launches, **eres},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
