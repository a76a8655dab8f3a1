"""Seeded FLAC corpus: speech-like mono PCM, encoded as libFLAC's level 5
frames are (fixed block size, LPC up to the config's order with quantized
coefficients, partitioned Rice residuals), all in array passes.

Frames are independent in FLAC, but each header carries its frame number.
So the generator encodes a bank of frames for every frame position (a few
variants each) plus each stream's own last, shorter frame, and a stream is
a seeded choice of one variant at each position.  The PCM of every bank
frame is kept: FLAC is lossless, so it is the reference's answer.
"""

from __future__ import annotations

import numpy as np

from . import bits
from .common import Corpus, lengths_s

#: frame header codes (FLAC format, "FRAME_HEADER")
_RATE_CODE = {8000: 4, 16000: 5, 22050: 6, 24000: 7, 32000: 8, 44100: 9,
              48000: 10, 96000: 11}
_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
_BLOCK_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
               1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
#: a tail frame this short is written VERBATIM, as libFLAC does for a
#: block too short for its predictor
_VERBATIM_BELOW = 64


def speech_frames(rng, n_frames: int, n: int, sr: int, mix: dict):
    """[n_frames, n] int16 frames of speech-like sound, one kind a frame:
    voiced (harmonics of f0 under three formants), unvoiced (noise above
    2 kHz) or pause (background noise), each with a level ramp.  Built in
    the frequency domain, one inverse FFT for all frames."""
    kinds = rng.choice(3, size=n_frames, p=[mix["voiced"], mix["unvoiced"],
                                            mix["pause"]])
    nb = n // 2 + 1
    f = np.arange(nb) * (sr / n)
    phase = np.exp(2j * np.pi * rng.random((n_frames, nb)))
    noise = rng.standard_normal((n_frames, nb))
    spec = np.zeros((n_frames, nb), np.complex128)
    # voiced: harmonics at their nearest bins, formant envelope, -6 dB/oct
    v = np.flatnonzero(kinds == 0)
    f0 = rng.uniform(90.0, 240.0, v.size)
    formants = np.stack([rng.uniform(300, 800, v.size),
                         rng.uniform(900, 2300, v.size),
                         rng.uniform(2400, 3200, v.size)], 1)
    h = np.arange(1, int(0.48 * sr / 90.0) + 1)
    hf = f0[:, None] * h[None, :]
    ok = hf < 0.45 * sr
    env = 0.03 + sum(g * np.exp(-0.5 * ((hf - formants[:, i:i + 1]) / bw) ** 2)
                     for i, (g, bw) in enumerate(((1.0, 90.0), (0.6, 120.0),
                                                  (0.3, 160.0))))
    amp = np.where(ok, env / h[None, :], 0.0)
    bins = np.minimum(np.rint(hf / (sr / n)).astype(np.int64), nb - 1)
    rows = np.broadcast_to(v[:, None], bins.shape)
    np.add.at(spec, (rows, bins), amp)
    spec[v] *= phase[v]
    spec[v] += 0.0005 * noise[v] * phase[v]
    # unvoiced: noise shaped to 2-7 kHz
    u = kinds == 1
    shape = 1.0 / (1.0 + np.exp(-(f - 2500.0) / 300.0)) * np.exp(-f / 9000.0)
    spec[u] = noise[u] * phase[u] * shape
    # pause: flat background noise
    spec[kinds == 2] = noise[kinds == 2] * phase[kinds == 2]
    x = np.fft.irfft(spec, n=n, axis=1)
    x /= np.sqrt(np.mean(x * x, axis=1, keepdims=True)) + 1e-12
    level_db = np.choose(kinds, [rng.normal(-30, 5, n_frames),
                                 rng.normal(-40, 5, n_frames),
                                 rng.normal(-62, 3, n_frames)])
    ramp = np.linspace(0, 1, n)[None, :]
    g0, g1 = rng.normal(0, 3, (2, n_frames, 1))
    gain = 32768.0 * 10 ** ((level_db[:, None] + g0 + (g1 - g0) * ramp) / 20)
    x = x * gain + rng.standard_normal((n_frames, n)) * (32768.0 * 10 ** -3.5)
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


def _lpc(x, lens, max_order: int, precision: int):
    """Per frame: the LPC order by libFLAC's bit estimate, the quantized
    coefficients and shift, from the Levinson-Durbin recursion on the
    Hann-tapered frame's autocorrelation."""
    F, n = x.shape
    t = np.arange(n)[None, :]
    w = np.where(t < lens[:, None],
                 np.sin(np.pi * (t + 0.5) / lens[:, None]) ** 2, 0.0)
    xw = x * w
    r = np.stack([np.einsum("ft,ft->f", xw[:, k:], xw[:, :n - k])
                  for k in range(max_order + 1)], 1)
    r[:, 0] = r[:, 0] * (1 + 1e-9) + 1e-9
    a = np.zeros((F, max_order + 1))
    coefs = np.zeros((F, max_order + 1, max_order))
    err = np.zeros((F, max_order + 1))
    err[:, 0] = r[:, 0]
    e = r[:, 0].copy()
    for m in range(1, max_order + 1):
        acc = r[:, m] - np.einsum("fj,fj->f", a[:, 1:m], r[:, m - 1:0:-1])
        k = acc / e
        prev = a[:, 1:m].copy()
        a[:, 1:m] = prev - k[:, None] * prev[:, ::-1]
        a[:, m] = k
        e = e * (1 - k * k)
        err[:, m] = e
        coefs[:, m, :m] = a[:, 1:m + 1]
    # libFLAC's estimate: bits ~ 0.5 log2(error per sample) a sample plus
    # the coefficients and warm-up samples the order costs
    per = np.maximum(err[:, 1:] / np.maximum(lens, 1)[:, None], 1e-12)
    est = 0.5 * np.log2(per) * lens[:, None] \
        + np.arange(1, max_order + 1)[None, :] * (precision + 16)
    order = 1 + np.argmin(est, axis=1)
    c = coefs[np.arange(F), order]
    cmax = np.max(np.abs(c), axis=1)
    _, e2 = np.frexp(np.maximum(cmax, 1e-30))
    shift = np.clip(precision - e2, 0, 15)
    qmax = (1 << (precision - 1)) - 1
    q = np.clip(np.rint(c * (2.0 ** shift)[:, None]), -qmax - 1, qmax)
    q = q.astype(np.int64)
    q[np.arange(max_order)[None, :] >= order[:, None]] = 0
    return order, q, shift


def _utf8(num):
    """FLAC's UTF-8-like frame number code: (uint8[F, 2], lengths)."""
    num = np.asarray(num, np.int64)
    if num.max(initial=0) >= 2048:
        raise ValueError("frame number beyond two code bytes")
    two = num >= 128
    out = np.zeros((num.size, 2), np.int64)
    out[:, 0] = np.where(two, 0xC0 | (num >> 6), num)
    out[:, 1] = 0x80 | (num & 0x3F)
    return out, np.where(two, 2, 1)


def encode_frames(pcm, lens, frame_no, cfg):
    """Encode frames (int16 [F, n], each row's first lens[f] samples) as
    FLAC frames with the given frame numbers.  Returns (bank bytes,
    per-frame byte offsets, byte lengths, LPC order a frame (0: VERBATIM))."""
    F, n = pcm.shape
    bs_full = int(cfg["block_size"])
    precision = int(cfg["qlp_precision"])
    max_order = int(cfg["max_lpc_order"])
    max_p = int(cfg["max_partition_order"])
    bps = int(cfg["bits_per_sample"])
    lens = np.asarray(lens, np.int64)
    x = pcm.astype(np.int64)
    order, q, shift = _lpc(x.astype(np.float64), lens, max_order, precision)
    verbatim = lens < _VERBATIM_BELOW
    order = np.where(verbatim, 0, order)

    # residuals of every sample from `order` on
    xp = np.concatenate([np.zeros((F, max_order), np.int64), x], 1)
    pred = np.zeros((F, n), np.int64)
    for j in range(max_order):
        pred += q[:, j:j + 1] * xp[:, max_order - 1 - j: max_order - 1 - j + n]
    res = x - (pred >> shift[:, None])
    t = np.arange(n)[None, :]
    live = (t >= order[:, None]) & (t < lens[:, None]) & ~verbatim[:, None]
    u = np.where(live, np.where(res >= 0, 2 * res, -2 * res - 1), 0)

    # partition order and Rice parameters: bits ~ count (k + 1) + sum / 2^k
    ks = np.arange(15)
    best_bits = np.full(F, np.inf)
    p_sel = np.zeros(F, np.int64)
    kpart = np.zeros((F, 1 << max_p), np.int64)
    for p in range(max_p + 1):
        if n % (1 << p):
            break
        part = n >> p
        okp = (lens == bs_full) & (part > order) if p else np.ones(F, bool)
        s = u.reshape(F, 1 << p, part).sum(2).astype(np.float64)
        cnt = np.full((F, 1 << p), float(part))
        cnt[:, 0] = (lens if p == 0 else part) - order
        cost = cnt[..., None] * (ks + 1) + s[..., None] / 2.0 ** ks
        tot = cost.min(2).sum(1) + 4 * (1 << p)
        better = okp & (tot < best_bits)
        best_bits = np.where(better, tot, best_bits)
        p_sel = np.where(better, p, p_sel)
        kpart[better, : 1 << p] = np.argmin(cost[better], axis=2)
    part_len = n >> p_sel
    k_of = np.take_along_axis(kpart, t // part_len[:, None], 1)

    # header bytes: sync, codes, frame number, a tail's explicit block size
    rate_code = _RATE_CODE[int(cfg["sample_rate"])]
    full = lens == bs_full
    small = ~full & (lens <= 256)
    bcode = np.where(full, _BLOCK_CODE[bs_full], np.where(small, 6, 7))
    rows_f = np.arange(F)
    hdr = np.zeros((F, 9), np.int64)
    hdr[:, 0] = 0xFF
    hdr[:, 1] = 0xF8
    hdr[:, 2] = (bcode << 4) | rate_code
    hdr[:, 3] = ((int(cfg["channels"]) - 1) << 4) | (_BPS_CODE[bps] << 1)
    fn, fn_len = _utf8(frame_no)
    wp = np.full(F, 4)
    m1 = lens - 1
    for val, cond in ((fn[:, 0], np.ones(F, bool)), (fn[:, 1], fn_len == 2),
                      (m1 >> 8, ~full & ~small), (m1 & 0xFF, ~full)):
        hdr[rows_f[cond], wp[cond]] = val[cond]
        wp = wp + cond
    hdr[rows_f, wp] = bits.crc_rows(hdr.astype(np.uint8), wp, 8)
    hdr_len = wp + 1

    # subframe: header, warm-up, coefficients, residual method and order
    sub_head = 8 + np.where(verbatim, 0,
                            order * bps + 4 + 5 + order * precision + 2 + 4)
    pre = np.zeros((F, n), np.int64)
    first = live & ((t % part_len[:, None]) == 0)
    first |= live & (t == order[:, None])
    pre[first] = 4
    L = np.where(live, (u >> k_of) + 1 + k_of, 0)
    body_bits = np.where(verbatim, lens * bps, (pre + L).sum(1))
    sub_bits = sub_head + body_bits
    frame_len = hdr_len + (sub_bits + 7) // 8 + 2
    offs = np.concatenate([[0], np.cumsum(frame_len)])
    total = int(offs[-1])
    base = 8 * (offs[:-1] + hdr_len)          # each subframe's first bit

    groups = []
    # frame headers, a byte a field
    hb = np.arange(9)[None, :] < hdr_len[:, None]
    groups.append(((8 * (offs[:-1, None] + np.arange(9)[None, :]))[hb],
                   hdr[hb], np.full(int(hb.sum()), 8)))
    # subframe header: 0, type (6), wasted flag 0
    styp = np.where(verbatim, 1, 0x20 | np.maximum(order - 1, 0))
    groups.append((base + 1, styp, np.full(F, 6)))
    # warm-up samples and LPC header fields
    jw = np.arange(max_order)[None, :]
    wm = jw < order[:, None]
    wpos = base[:, None] + 8 + jw * bps
    groups.append((wpos[wm], (x[:, :max_order] & ((1 << bps) - 1))[wm],
                   np.full(int(wm.sum()), bps)))
    lpc = ~verbatim
    after_w = base + 8 + order * bps
    groups.append((after_w[lpc], np.full(int(lpc.sum()), precision - 1),
                   np.full(int(lpc.sum()), 4)))
    groups.append((after_w[lpc] + 4, shift[lpc], np.full(int(lpc.sum()), 5)))
    cpos = after_w[:, None] + 9 + jw * precision
    groups.append((cpos[wm], (q & ((1 << precision) - 1))[wm],
                   np.full(int(wm.sum()), precision)))
    rpos = after_w + 9 + order * precision
    groups.append((rpos[lpc] + 2, p_sel[lpc], np.full(int(lpc.sum()), 4)))
    # residuals: a partition's 4-bit parameter before its first residual,
    # each residual q = u >> k zeros, then a 1 and u's low k bits
    start = base + sub_head
    step = pre + L
    cum = np.cumsum(step, 1) - step
    at = start[:, None] + cum + pre
    groups.append((at[first] - 4, k_of[first], np.full(int(first.sum()), 4)))
    groups.append(((at + (u >> k_of))[live],
                   ((1 << k_of) | (u & ((1 << k_of) - 1)))[live],
                   (k_of + 1)[live]))
    # VERBATIM samples
    vm = verbatim[:, None] & (t < lens[:, None])
    groups.append(((base[:, None] + 8 + t * bps)[vm],
                   (x & ((1 << bps) - 1))[vm], np.full(int(vm.sum()), bps)))

    out = np.zeros(total, np.uint8)
    for pos, val, width in groups:
        out |= bits.pack(pos, val, width, total)
    # CRC-16 of each frame, over everything before it
    idx = offs[:-1, None] + np.arange(int(frame_len.max()))[None, :]
    rows = out[np.minimum(idx, total - 1)]
    crc16 = bits.crc_rows(rows, frame_len - 2, 16)
    end = offs[1:]
    out[end - 2] = crc16 >> 8
    out[end - 1] = crc16 & 0xFF
    return out, offs[:-1], frame_len, order


def _stream_head(cfg, n_samples: int) -> bytes:
    """'fLaC', STREAMINFO, and a VORBIS_COMMENT block (the last)."""
    bs = int(cfg["block_size"])
    sr, ch, bps = (int(cfg[k]) for k in ("sample_rate", "channels",
                                          "bits_per_sample"))
    si = (bs << 16 | bs).to_bytes(4, "big") + (0).to_bytes(6, "big")
    packed = (sr << 44) | ((ch - 1) << 41) | ((bps - 1) << 36) | n_samples
    si += packed.to_bytes(8, "big") + bytes(16)
    vendor = b"reference libFLAC 1.3.2 20170101"
    vc = len(vendor).to_bytes(4, "little") + vendor + (0).to_bytes(4, "little")
    return (b"fLaC" + bytes([0]) + len(si).to_bytes(3, "big") + si
            + bytes([0x84]) + len(vc).to_bytes(3, "big") + vc)


def build(cfg: dict, traffic: dict, rng) -> Corpus:
    """The config's pool of distinct streams, lengths by the traffic's law."""
    sr, bs = int(cfg["sample_rate"]), int(cfg["block_size"])
    P = int(cfg["distinct_utterances"])
    secs = lengths_s(traffic["lengths"], P)
    n_samp = np.maximum(np.rint(secs * sr).astype(np.int64), 1)
    rng.shuffle(n_samp)
    n_fr = -(-n_samp // bs)
    tail = n_samp - bs * (n_fr - 1)
    K = int(cfg["bank_variants"])
    # full frames: K variants at each position some stream reaches
    users = np.bincount(np.concatenate([np.arange(m - 1) for m in n_fr])
                        .astype(np.int64), minlength=int(n_fr.max()))
    k_at = np.minimum(K, users)
    pos_of = np.repeat(np.arange(users.size), k_at)
    first_of = np.concatenate([[0], np.cumsum(k_at)])
    n_bank = int(pos_of.size)
    mix = cfg["content"]
    pcm = speech_frames(rng, n_bank + P, bs, sr, mix)
    lens = np.concatenate([np.full(n_bank, bs), tail])
    frame_no = np.concatenate([pos_of, n_fr - 1])
    data, offs, flen, order = encode_frames(pcm, lens, frame_no, cfg)
    streams, frames_of = [], []
    predicted = np.where(order > 0, lens - order, 0)
    lpc_samples = np.zeros(P, np.int64)
    lpc_madds = np.zeros(P, np.int64)
    for s in range(P):
        m = int(n_fr[s])
        pick = first_of[np.arange(m - 1)] + rng.integers(
            0, np.maximum(k_at[:m - 1], 1))
        ids = np.concatenate([pick, [n_bank + s]]).astype(np.int64)
        frames_of.append(ids)
        body = np.concatenate([data[offs[i]: offs[i] + flen[i]] for i in ids])
        streams.append(_stream_head(cfg, int(n_samp[s])) + body.tobytes())
        lpc_samples[s] = predicted[ids].sum()
        lpc_madds[s] = (predicted[ids] * order[ids]).sum()
    return Corpus(streams=streams, seconds=n_samp / sr,
                  work={"lpc_samples": lpc_samples, "lpc_madds": lpc_madds},
                  truth={"pcm": pcm, "lens": lens, "frames_of": frames_of,
                         "bps": int(cfg["bits_per_sample"])})
