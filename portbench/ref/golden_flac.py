"""Golden FLAC encoder — produces spec-conformant FLAC files with known PCM
content, exercising every subframe type (CONSTANT/VERBATIM/FIXED/LPC),
Rice/Rice2 partitioned residuals (incl. escape partitions), stereo
decorrelation modes, wasted bits, and SEEKTABLE metadata.

FLAC is lossless: decode(encode(x)) must equal x bit-exactly, which makes
this encoder a complete decode-conformance oracle without any external
tooling.  Independent of audio_formats_tpu (plain Python bit packing).  A frozen
copy of tests/golden/flac_ref.py.
"""

from __future__ import annotations

import numpy as np


class _BW:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.n = 0

    def w(self, value: int, bits: int) -> None:
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            self.bytes.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.w(0, 8 - self.n)

    def unary(self, q: int):
        self.w(1, q + 1)  # q zeros then a 1


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8(bw: _BW, val: int) -> None:
    if val < 0x80:
        bw.w(val, 8)
        return
    # capacity with n continuation bytes: (6 - n) + 6*n = 6 + 5n bits
    n = 1
    while val >= (1 << (6 + 5 * n)) and n < 6:
        n += 1
    lead = (0xFF << (7 - n)) & 0xFF
    bw.w(lead | ((val >> (6 * n)) & (0x3F >> n)), 8)
    for i in range(n - 1, -1, -1):
        bw.w(0x80 | ((val >> (6 * i)) & 0x3F), 8)


def _rice_write(bw: _BW, vals, param: int):
    for v in vals:
        v = int(v)
        u = 2 * v if v >= 0 else -2 * v - 1  # zigzag
        bw.unary(u >> param)
        if param:
            bw.w(u & ((1 << param) - 1), param)


FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_residual(x: np.ndarray, coefs, shift: int) -> np.ndarray:
    x = x.astype(np.int64)
    order = len(coefs)
    res = np.empty(len(x) - order, dtype=np.int64)
    for t in range(order, len(x)):
        pred = sum(coefs[j] * x[t - 1 - j] for j in range(order)) >> shift
        res[t - order] = x[t] - pred
    return res


def _best_rice_param(vals: np.ndarray, maxp: int) -> int:
    best, bestbits = 0, None
    for p in range(0, maxp):
        u = np.where(vals >= 0, 2 * vals, -2 * vals - 1)
        bits = int(np.sum((u >> p) + 1 + p))
        if bestbits is None or bits < bestbits:
            best, bestbits = p, bits
    return best


def _write_subframe(bw: _BW, x: np.ndarray, bps: int, mode: str,
                    partition_order: int = 0, rice2: bool = False,
                    wasted: int = 0, escape_bits: int | None = None):
    """mode: 'constant' | 'verbatim' | 'fixed<k>' | 'lpc<k>'"""
    if wasted:
        assert np.all(x % (1 << wasted) == 0)
        x = x >> wasted
        bps = bps - wasted
    if mode == "constant":
        assert np.all(x == x[0])
        bw.w(0, 1); bw.w(0, 6)
        bw.w(1 if wasted else 0, 1)
        if wasted:
            bw.unary(wasted - 1)
        bw.w(int(x[0]), bps)
        return
    if mode == "verbatim":
        bw.w(0, 1); bw.w(1, 6)
        bw.w(1 if wasted else 0, 1)
        if wasted:
            bw.unary(wasted - 1)
        for v in x:
            bw.w(int(v), bps)
        return
    if mode.startswith("fixed"):
        order = int(mode[5:])
        bw.w(0, 1); bw.w(0b001000 | order, 6)
        bw.w(1 if wasted else 0, 1)
        if wasted:
            bw.unary(wasted - 1)
        for v in x[:order]:
            bw.w(int(v), bps)
        res = _fixed_residual(x, order)
    else:
        order = int(mode[3:])
        # simple fixed-point LPC-ish coefficients: reuse polynomial predictor
        # scaled by 2^shift with a slight tweak so it exercises real coeffs
        shift = 5
        base = FIXED_COEF[min(order, 4)] + [0] * max(0, order - 4)
        coefs = [c * (1 << shift) for c in base[:order]]
        if order >= 1:
            coefs[0] += 3  # non-trivial fractional coefficient
        precision = 15
        bw.w(0, 1); bw.w(0b100000 | (order - 1), 6)
        bw.w(1 if wasted else 0, 1)
        if wasted:
            bw.unary(wasted - 1)
        for v in x[:order]:
            bw.w(int(v), bps)
        bw.w(precision - 1, 4)
        bw.w(shift, 5)
        for c in coefs:
            bw.w(int(c), precision)
        res = _lpc_residual(x, coefs, shift)

    # residual coding
    bw.w(1 if rice2 else 0, 2)
    pbits = 5 if rice2 else 4
    escape = 31 if rice2 else 15
    bw.w(partition_order, 4)
    nparts = 1 << partition_order
    base_n = len(x) >> partition_order
    idx = 0
    for p in range(nparts):
        count = base_n - order if p == 0 else base_n
        vals = res[idx : idx + count]
        if escape_bits is not None:
            bw.w(escape, pbits)
            bw.w(escape_bits, 5)
            for v in vals:
                bw.w(int(v), escape_bits)
        else:
            param = _best_rice_param(vals, escape)
            bw.w(param, pbits)
            _rice_write(bw, vals, param)
        idx += count


def encode_frame(samples: np.ndarray, frame_index: int, sample_rate: int,
                 bps: int, stereo_mode: str = "independent",
                 modes=None, **sub_kw) -> bytes:
    """samples: (B, C) ints at `bps`.  stereo_mode:
    independent|left_side|right_side|mid_side."""
    B, C = samples.shape
    chans = []
    sub_bps = []
    if stereo_mode == "independent":
        assignment = C - 1
        for c in range(C):
            chans.append(samples[:, c].astype(np.int64))
            sub_bps.append(bps)
    else:
        assert C == 2
        L = samples[:, 0].astype(np.int64)
        R = samples[:, 1].astype(np.int64)
        side = L - R
        if stereo_mode == "left_side":
            assignment = 8
            chans = [L, side]; sub_bps = [bps, bps + 1]
        elif stereo_mode == "right_side":
            assignment = 9
            chans = [side, R]; sub_bps = [bps + 1, bps]
        else:
            assignment = 10
            mid = (L + R) >> 1
            chans = [mid, side]; sub_bps = [bps, bps + 1]

    hdr = _BW()
    hdr.w(0b11111111111110, 14)
    hdr.w(0, 1)  # reserved
    hdr.w(0, 1)  # fixed blocksize
    # blocksize code: use 16-bit explicit (code 7)
    hdr.w(7, 4)
    hdr.w(0, 4)  # sample rate: from STREAMINFO
    hdr.w(assignment, 4)
    hdr.w({8: 1, 12: 2, 16: 4, 20: 5, 24: 6}.get(bps, 0), 3)
    hdr.w(0, 1)
    _utf8(hdr, frame_index)
    hdr.w(B - 1, 16)
    hdr.align()
    head = bytes(hdr.bytes)
    head += bytes([_crc8(head)])

    body = _BW()
    modes = modes or ["fixed2"] * C
    # predictor order must not exceed the blocksize (tiny final frames):
    # fall back to verbatim, the encoder-side rule libFLAC applies
    def _fit(mode):
        if mode.startswith("fixed") and int(mode[5:]) > B:
            return "verbatim"
        if mode.startswith("lpc") and int(mode[3:]) > B:
            return "verbatim"
        return mode
    for c in range(C):
        _write_subframe(body, chans[c], sub_bps[c], _fit(modes[c]),
                        **sub_kw)
    body.align()
    frame = head + bytes(body.bytes)
    return frame + _crc16(frame).to_bytes(2, "big")


def build_flac(pcm: np.ndarray, sample_rate: int, bps: int,
               block_size: int = 1024, stereo_mode: str = "independent",
               modes=None, seektable: bool = False, **sub_kw) -> bytes:
    """pcm: (frames, channels) ints within ±2^(bps-1)."""
    frames, C = pcm.shape
    out = bytearray(b"fLaC")
    si = _BW()
    si.w(block_size, 16); si.w(block_size, 16)
    si.w(0, 24); si.w(0, 24)
    si.w(sample_rate, 20); si.w(C - 1, 3); si.w(bps - 1, 5)
    si.w(frames, 36)
    streaminfo = bytes(si.bytes) + b"\0" * 16  # md5 unset
    # frames (encode first so the seek table can record offsets)
    offsets = []
    body = bytearray()
    fi = 0
    pos = 0
    while pos < frames:
        n = min(block_size, frames - pos)
        offsets.append((pos, len(body), n))
        body += encode_frame(pcm[pos : pos + n], fi, sample_rate, bps,
                             stereo_mode, modes, **sub_kw)
        fi += 1
        pos += n
    blocks = []
    if seektable:
        st = bytearray()
        for (sample, off, n) in offsets[:: max(1, len(offsets) // 8)]:
            st += sample.to_bytes(8, "big") + off.to_bytes(8, "big") + n.to_bytes(2, "big")
        blocks.append((3, bytes(st)))
    # metadata: streaminfo first, optional seektable, then a padding block
    blocks_all = [(0, streaminfo)] + blocks + [(1, b"\0" * 16)]
    for i, (btype, data) in enumerate(blocks_all):
        last = i == len(blocks_all) - 1
        out += bytes([(0x80 if last else 0) | btype]) + len(data).to_bytes(3, "big") + data
    out += body
    return bytes(out)
