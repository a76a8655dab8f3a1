"""CELT decoder (the MDCT layer of Opus, RFC 6716 §4.3).

Host entropy/parameter stage of the two-stage pipeline: the range-coded
symbol stream (coarse/fine energy, tf, allocation, PVQ pulses) decodes on
the host with exact integer arithmetic, producing the normalized band
spectrum; synthesis (denormalize → IMDCT → overlap-add → postfilter →
deemphasis) is dense tensor math done here in numpy and batched on device
by ops/celt_dsp.py.

Reference parity: dopus.d:1647-3778 (ff_celt_decode_frame and helpers),
celt_band_end dopus.d:6245.  All integer decisions (allocation ILP, qn,
theta trig in Q15) follow the bitstream spec exactly; float synthesis is
validated against libopus to <=1e-4 (SURVEY.md §4 contract).
"""

from __future__ import annotations

import math

import numpy as np

from ..host import native
from ..utils.tables import celt_tables as CT

MAX_BANDS = 21
OVERLAP = 120
SHORT_BLOCKSIZE = 120
MAX_LOG_BLOCKS = 3
MAX_FRAME_SIZE = SHORT_BLOCKSIZE << MAX_LOG_BLOCKS
ENERGY_SILENCE = -28.0
DEEMPH_COEFF = 0.85000610
POSTFILTER_MINPERIOD = 15
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = range(4)

BAND_END = [13, 17, 17, 19, 21]  # per bandwidth NB/MB/WB/SWB/FB

_FREQ_BANDS = CT.FREQ_BANDS
_FREQ_RANGE = CT.FREQ_RANGE


# ------------------------------------------------------------ fixed-point
def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _celt_cos(x: int) -> int:
    """Q15 cos approximation used for theta (dopus.d:2093)."""
    x = (x * x + 4096) >> 13

    def rmul(a, b):
        return (a * b + 16384) >> 15

    x = (32767 - x) + rmul(x, -7651 + rmul(x, 8277 + rmul(-626, x)))
    return 1 + x


def _celt_log2tan(isin: int, icos: int) -> int:
    """Q11 log2(tan) approximation (dopus.d:2110).  Note opus_ilog(x) is
    bit_length (position of highest set bit plus one), not floor(log2)."""
    lc = icos.bit_length()
    ls = isin.bit_length()
    icos <<= 15 - lc
    isin <<= 15 - ls

    def rmul(a, b):
        return (a * b + 16384) >> 15

    return ((ls << 11) - (lc << 11) +
            rmul(isin, rmul(isin, -2597) + 7932) -
            rmul(icos, rmul(icos, -2597) + 7932))


def _bits2pulses(cache, offs, bits):
    low, high = 0, cache[offs]
    bits -= 1
    for _ in range(6):
        center = (low + high + 1) >> 1
        if cache[offs + center] >= bits:
            high = center
        else:
            low = center
    if bits - (-1 if low == 0 else cache[offs + low]) <= \
            cache[offs + high] - bits:
        return low
    return high


def _pulses2bits(cache, offs, pulses):
    return 0 if pulses == 0 else cache[offs + pulses] + 1


def _cwrsi(N, K, i):
    """PVQ index -> pulse vector (RFC 6716 §4.3.4.4; dopus.d:2717)."""
    y = np.zeros(N, np.int64)
    norm = 0
    pos = 0
    U = CT.PVQ_U
    while N > 2:
        if K >= N:
            # lots of pulses: search within row N
            p = U(N, K + 1)
            s = i >= p
            if s:
                i -= p
            k0 = K
            q = U(N, N)
            if q > i:
                K = N
                while True:
                    K -= 1
                    p = U(K, N)
                    if p <= i:
                        break
            else:
                p = U(N, K)
                while p > i:
                    K -= 1
                    p = U(N, K)
            i -= p
            val = (k0 - K) if not s else -(k0 - K)
            norm += val * val
            y[pos] = val
            pos += 1
        else:
            # lots of dimensions
            p = U(K, N)
            q = U(K + 1, N)
            if p <= i < q:
                i -= p
                y[pos] = 0
                pos += 1
            else:
                s = i >= q
                if s:
                    i -= q
                k0 = K
                while True:
                    K -= 1
                    p = U(K, N)
                    if p <= i:
                        break
                i -= p
                val = (k0 - K) if not s else -(k0 - K)
                norm += val * val
                y[pos] = val
                pos += 1
        N -= 1
    # N == 2
    p = 2 * K + 1
    s = i >= p
    if s:
        i -= p
    k0 = K
    K = (i + 1) // 2
    if K:
        i -= 2 * K - 1
    val = (k0 - K) if not s else -(k0 - K)
    norm += val * val
    y[pos] = val
    pos += 1
    # N == 1
    s = -i
    val = K if s == 0 else ((K + s) ^ s)
    norm += val * val
    y[pos] = val
    return y, norm


def _exp_rotation1(X, length, stride, c, s):
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = np.float32(np.float32(c * x2) + np.float32(s * x1))
        X[i] = np.float32(np.float32(c * x1) - np.float32(s * x2))
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = np.float32(np.float32(c * x2) + np.float32(s * x1))
        X[i] = np.float32(np.float32(c * x1) - np.float32(s * x2))


def _exp_rotation(X, length, stride, K, spread):
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    gain = length / (length + (20 - 5 * spread) * K)
    theta = math.pi * gain * gain / 4
    c = np.float32(math.cos(theta))
    s = np.float32(math.sin(theta))
    stride2 = 0
    if length >= stride << 3:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        seg = X[i * length : (i + 1) * length]
        if stride2:
            _exp_rotation1(seg, length, stride2, s, c)
        _exp_rotation1(seg, length, 1, c, s)


def _extract_collapse_mask(y, N, B):
    if B <= 1:
        return 1
    N0 = N // B
    mask = 0
    for i in range(B):
        if np.any(y[i * N0 : (i + 1) * N0] != 0):
            mask |= 1 << i
    return mask


def _renormalize(X, gain=1.0):
    # sequential double accumulation (not np.sum's pairwise order) so the
    # native mirror (af_host.cc:renormalize_c) is bit-identical
    g = 1e-15
    for v in X.tolist():
        g += v * v
    X *= np.float32(gain / math.sqrt(g))


def _haar1(X, N0, stride):
    N0 >>= 1
    for i in range(stride):
        idx0 = stride * (2 * np.arange(N0)) + i
        idx1 = stride * (2 * np.arange(N0) + 1) + i
        x0 = X[idx0].copy()
        x1 = X[idx1].copy()
        X[idx0] = (x0 + x1) * np.float32(math.sqrt(0.5))
        X[idx1] = (x0 - x1) * np.float32(math.sqrt(0.5))


def _interleave_hadamard(X, N0, stride, hadamard):
    Xv = X[: N0 * stride]
    tmp = np.empty(N0 * stride, X.dtype)
    if hadamard:
        ordery = CT.HADAMARD_ORDERY[stride - 2 :]
        for i in range(stride):
            tmp[i::stride] = Xv[ordery[i] * N0 : (ordery[i] + 1) * N0]
    else:
        for i in range(stride):
            tmp[i::stride] = Xv[i * N0 : (i + 1) * N0]
    Xv[:] = tmp


def _deinterleave_hadamard(X, N0, stride, hadamard):
    Xv = X[: N0 * stride]
    tmp = np.empty(N0 * stride, X.dtype)
    if hadamard:
        ordery = CT.HADAMARD_ORDERY[stride - 2 :]
        for i in range(stride):
            tmp[ordery[i] * N0 : (ordery[i] + 1) * N0] = Xv[i::stride]
    else:
        for i in range(stride):
            tmp[i * N0 : (i + 1) * N0] = Xv[i::stride]
    Xv[:] = tmp


def _compute_qn(N, b, offset, pulse_cap, dualstereo):
    N2 = 2 * N - 1
    if dualstereo and N == 2:
        N2 -= 1
    qb = min(b - pulse_cap - (4 << 3), (b + N2 * offset) // N2, 8 << 3)
    if qb < (1 << 3 >> 1):
        return 1
    qn = ((CT.QN_EXP2[qb & 0x7] >> (14 - (qb >> 3))) + 1) >> 1 << 1
    return qn


def imdct_half(src, len2, scale=1.0):
    """Closed form of the ff IMDCT15 half transform (dopus.d:1611):
    pre-twiddle, unnormalized inverse DFT, post-twiddle.  ``src`` is the
    already-strided block of len2 frequency coefficients; output is the
    middle half (len2 samples) of the 2*len2-point IMDCT."""
    len4 = len2 // 2
    n = 2 * len2
    idx = np.arange(len4)
    tw = np.exp(2j * np.pi * (idx + 0.125 + len4) / n)
    in1 = src[0::2].astype(np.float64)           # src[2i]
    in2 = src[::-1][0::2].astype(np.float64)     # src[len2-1-2i]
    tmp = (in2 + 1j * in1) * tw
    z = np.fft.ifft(tmp) * len4                  # DFT with e^{+2pi i jk/N}
    p = z * tw
    out = np.empty(len2)
    out[0::2] = -p.real * scale
    out[1::2] = p.imag[::-1] * scale
    return out


class CeltDecoder:
    """Per-stream CELT state + frame decode (ff_celt_decode_frame parity,
    dopus.d:3568)."""

    def __init__(self, output_channels: int):
        self.output_channels = output_channels
        self.energy = np.zeros((2, MAX_BANDS))
        # fresh decoders start at the silence energy (opus decode init
        # flushes the CELT layer; dopus.d:3744)
        self.prev_energy = np.full((2, 2, MAX_BANDS), ENERGY_SILENCE)
        self.collapse_masks = np.zeros((2, MAX_BANDS), np.int64)
        self.buf = np.zeros((2, 2048))
        self.deemph_coeff = [0.0, 0.0]
        self.pf_period = [0, 0]
        self.pf_period_old = [0, 0]
        self.pf_period_new = [0, 0]
        self.pf_gains = np.zeros((2, 3))
        self.pf_gains_old = np.zeros((2, 3))
        self.pf_gains_new = np.zeros((2, 3))
        self.seed = 0
        self.flushed = False
        self._w2 = CT.WINDOW * CT.WINDOW

    # -------------------------------------------------------------- flush
    def flush(self):
        if self.flushed:
            return
        self.energy[:] = 0.0
        self.prev_energy[:] = ENERGY_SILENCE
        self.buf[:] = 0.0
        self.deemph_coeff = [0.0, 0.0]
        self.pf_period = [0, 0]
        self.pf_period_old = [0, 0]
        self.pf_period_new = [0, 0]
        self.pf_gains[:] = 0.0
        self.pf_gains_old[:] = 0.0
        self.pf_gains_new[:] = 0.0
        self.seed = 0
        self.flushed = True

    def _rng(self):
        self.seed = (1664525 * self.seed + 1013904223) & 0xFFFFFFFF
        return self.seed

    def _rng_s32(self):
        v = self._rng()
        return v - (1 << 32) if v & (1 << 31) else v

    # ------------------------------------------------------- coarse energy
    def _decode_coarse_energy(self, rd):
        s = self
        if rd.tell() + 3 <= s.framebits and rd.dec_bit_logp(3):
            alpha = 0.0
            beta = 1.0 - 4915.0 / 32768.0
            model = CT.COARSE_ENERGY_DIST[s.duration][1]
        else:
            alpha = CT.ALPHA_COEF[s.duration]
            beta = 1.0 - CT.BETA_COEF[s.duration]
            model = CT.COARSE_ENERGY_DIST[s.duration][0]
        prev = [0.0, 0.0]
        for i in range(MAX_BANDS):
            for j in range(s.coded_channels):
                if i < s.startband or i >= s.endband:
                    s.energy[j][i] = 0.0
                    continue
                available = s.framebits - rd.tell()
                if available >= 15:
                    k = min(i, 20) << 1
                    value = float(rd.dec_laplace(model[k] << 7,
                                                 model[k + 1] << 6))
                elif available >= 2:
                    x = rd.dec_cdf(CT.MODEL_ENERGY_SMALL)
                    value = float((x >> 1) ^ -(x & 1))
                elif available >= 1:
                    value = -float(rd.dec_bit_logp(1))
                else:
                    value = -1.0
                s.energy[j][i] = max(-9.0, s.energy[j][i]) * alpha + \
                    prev[j] + value
                prev[j] += beta * value

    def _decode_fine_energy(self, rd):
        s = self
        for i in range(s.startband, s.endband):
            if not s.fine_bits[i]:
                continue
            for j in range(s.coded_channels):
                q2 = rd.dec_bits(s.fine_bits[i])
                offset = (q2 + 0.5) * (1 << (14 - s.fine_bits[i])) / \
                    16384.0 - 0.5
                s.energy[j][i] += offset

    def _decode_final_energy(self, rd, bits_left):
        s = self
        for priority in range(2):
            i = s.startband
            while i < s.endband and bits_left >= s.coded_channels:
                if s.fine_priority[i] != priority or s.fine_bits[i] >= 8:
                    i += 1
                    continue
                for j in range(s.coded_channels):
                    q2 = rd.dec_bits(1)
                    offset = (q2 - 0.5) * \
                        (1 << (14 - s.fine_bits[i] - 1)) / 16384.0
                    s.energy[j][i] += offset
                    bits_left -= 1
                i += 1

    # ---------------------------------------------------------- tf changes
    def _decode_tf_changes(self, rd, transient):
        s = self
        diff = 0
        tf_changed = 0
        tf_select = 0
        bits = 2 if transient else 4
        consumed = rd.tell()
        tf_select_bit = int(s.duration != 0 and
                            consumed + bits + 1 <= s.framebits)
        for i in range(s.startband, s.endband):
            if consumed + bits + tf_select_bit <= s.framebits:
                diff ^= rd.dec_bit_logp(bits)
                consumed = rd.tell()
                tf_changed |= diff
            s.tf_change[i] = diff
            bits = 4 if transient else 5
        tfs = CT.TF_SELECT[s.duration][transient]
        if tf_select_bit and tfs[0][tf_changed] != tfs[1][tf_changed]:
            tf_select = rd.dec_bit_logp(1)
        for i in range(s.startband, s.endband):
            s.tf_change[i] = tfs[tf_select][s.tf_change[i]]

    # ---------------------------------------------------------- allocation
    def _decode_allocation(self, rd):
        s = self
        CH = s.coded_channels
        cap = [0] * MAX_BANDS
        boost = [0] * MAX_BANDS
        threshold = [0] * MAX_BANDS
        bits1 = [0] * MAX_BANDS
        bits2 = [0] * MAX_BANDS
        trim_offset = [0] * MAX_BANDS
        skip_startband = s.startband
        dynalloc = 6
        alloctrim = 5
        extrabits = 0
        skip_bit = 0
        intensitystereo_bit = 0
        dualstereo_bit = 0

        consumed = rd.tell()
        s.spread = SPREAD_NORMAL
        if consumed + 4 <= s.framebits:
            s.spread = rd.dec_cdf(CT.MODEL_SPREAD)

        for i in range(MAX_BANDS):
            cap[i] = (CT.STATIC_CAPS[s.duration][CH - 1][i] + 64) * \
                _FREQ_RANGE[i] << (CH - 1) << s.duration >> 2

        totalbits = s.framebits << 3
        consumed = rd.tell_frac()
        for i in range(s.startband, s.endband):
            quanta = _FREQ_RANGE[i] << (CH - 1) << s.duration
            quanta = min(quanta << 3, max(6 << 3, quanta))
            band_dynalloc = dynalloc
            while consumed + (band_dynalloc << 3) < totalbits and \
                    boost[i] < cap[i]:
                add = rd.dec_bit_logp(band_dynalloc)
                consumed = rd.tell_frac()
                if not add:
                    break
                boost[i] += quanta
                totalbits -= quanta
                band_dynalloc = 1
            if boost[i]:
                dynalloc = max(2, dynalloc - 1)

        if consumed + (6 << 3) <= totalbits:
            alloctrim = rd.dec_cdf(CT.MODEL_ALLOC_TRIM)

        totalbits = (s.framebits << 3) - rd.tell_frac() - 1
        s.anticollapse_bit = 0
        if s.blocks > 1 and s.duration >= 2 and \
                totalbits >= ((s.duration + 2) << 3):
            s.anticollapse_bit = 1 << 3
        totalbits -= s.anticollapse_bit

        if totalbits >= 1 << 3:
            skip_bit = 1 << 3
        totalbits -= skip_bit

        if CH == 2:
            intensitystereo_bit = CT.LOG2_FRAC[s.endband - s.startband]
            if intensitystereo_bit <= totalbits:
                totalbits -= intensitystereo_bit
                if totalbits >= 1 << 3:
                    dualstereo_bit = 1 << 3
                    totalbits -= 1 << 3
            else:
                intensitystereo_bit = 0

        for i in range(s.startband, s.endband):
            trim = alloctrim - 5 - s.duration
            band = _FREQ_RANGE[i] * (s.endband - i - 1)
            duration = s.duration + 3
            scale = duration + CH - 1
            threshold[i] = max(3 * _FREQ_RANGE[i] << duration >> 4, CH << 3)
            trim_offset[i] = trim * (band << scale) >> 6
            if _FREQ_RANGE[i] << s.duration == 1:
                trim_offset[i] -= CH << 3

        # first bisection over the static allocation table rows
        low, high = 1, 11 - 1
        while low <= high:
            center = (low + high) >> 1
            done = total = 0
            for i in range(s.endband - 1, s.startband - 1, -1):
                bandbits = _FREQ_RANGE[i] * CT.STATIC_ALLOC[center][i] \
                    << (CH - 1) << s.duration >> 2
                if bandbits:
                    bandbits = max(0, bandbits + trim_offset[i])
                bandbits += boost[i]
                if bandbits >= threshold[i] or done:
                    done = 1
                    total += min(bandbits, cap[i])
                elif bandbits >= CH << 3:
                    total += CH << 3
            if total > totalbits:
                high = center - 1
            else:
                low = center + 1
        high = low
        low -= 1

        for i in range(s.startband, s.endband):
            bits1[i] = _FREQ_RANGE[i] * CT.STATIC_ALLOC[low][i] \
                << (CH - 1) << s.duration >> 2
            bits2[i] = cap[i] if high >= 11 else \
                _FREQ_RANGE[i] * CT.STATIC_ALLOC[high][i] \
                << (CH - 1) << s.duration >> 2
            if bits1[i]:
                bits1[i] = max(0, bits1[i] + trim_offset[i])
            if bits2[i]:
                bits2[i] = max(0, bits2[i] + trim_offset[i])
            if low:
                bits1[i] += boost[i]
            bits2[i] += boost[i]
            if boost[i]:
                skip_startband = i
            bits2[i] = max(0, bits2[i] - bits1[i])

        # second bisection: interpolation between the two rows
        low, high = 0, 1 << 6
        for _ in range(6):
            center = (low + high) >> 1
            done = total = 0
            for j in range(s.endband - 1, s.startband - 1, -1):
                bandbits = bits1[j] + (center * bits2[j] >> 6)
                if bandbits >= threshold[j] or done:
                    done = 1
                    total += min(bandbits, cap[j])
                elif bandbits >= CH << 3:
                    total += CH << 3
            if total > totalbits:
                high = center
            else:
                low = center

        done = total = 0
        for i in range(s.endband - 1, s.startband - 1, -1):
            bandbits = bits1[i] + (low * bits2[i] >> 6)
            if bandbits >= threshold[i] or done:
                done = 1
            else:
                bandbits = (CH << 3) if bandbits >= CH << 3 else 0
            bandbits = min(bandbits, cap[i])
            s.pulses[i] = bandbits
            total += bandbits

        # band skipping
        s.codedbands = s.endband
        while True:
            j = s.codedbands - 1
            if j == skip_startband:
                totalbits += skip_bit
                break
            remaining = totalbits - total
            bandbits = _cdiv(remaining, _FREQ_BANDS[j + 1] -
                             _FREQ_BANDS[s.startband])
            remaining -= bandbits * (_FREQ_BANDS[j + 1] -
                                     _FREQ_BANDS[s.startband])
            allocation = s.pulses[j] + bandbits * _FREQ_RANGE[j] + \
                max(0, remaining - (_FREQ_BANDS[j] -
                                    _FREQ_BANDS[s.startband]))
            if allocation >= max(threshold[j], (CH + 1) << 3):
                if rd.dec_bit_logp(1):
                    break
                total += 1 << 3
                allocation -= 1 << 3
            total -= s.pulses[j]
            if intensitystereo_bit:
                total -= intensitystereo_bit
                intensitystereo_bit = CT.LOG2_FRAC[j - s.startband]
                total += intensitystereo_bit
            s.pulses[j] = (CH << 3) if allocation >= CH << 3 else 0
            total += s.pulses[j]
            s.codedbands -= 1

        s.intensitystereo = 0
        s.dualstereo = 0
        if intensitystereo_bit:
            s.intensitystereo = s.startband + rd.dec_uint(
                s.codedbands + 1 - s.startband)
        if s.intensitystereo <= s.startband:
            totalbits += dualstereo_bit
        elif dualstereo_bit:
            s.dualstereo = rd.dec_bit_logp(1)

        remaining = totalbits - total
        bandbits = _cdiv(remaining, _FREQ_BANDS[s.codedbands] -
                         _FREQ_BANDS[s.startband])
        remaining -= bandbits * (_FREQ_BANDS[s.codedbands] -
                                 _FREQ_BANDS[s.startband])
        for i in range(s.startband, s.codedbands):
            bts = min(remaining, _FREQ_RANGE[i])
            s.pulses[i] += bts + bandbits * _FREQ_RANGE[i]
            remaining -= bts

        for i in range(s.startband, s.codedbands):
            N = _FREQ_RANGE[i] << s.duration
            prev_extra = extrabits
            s.pulses[i] += extrabits
            if N > 1:
                extrabits = max(0, s.pulses[i] - cap[i])
                s.pulses[i] -= extrabits
                dof = N * CH + int(CH == 2 and N > 2 and not s.dualstereo
                                   and i < s.intensitystereo)
                temp = dof * (CT.LOG_FREQ_RANGE[i] + (s.duration << 3))
                offset = (temp >> 1) - dof * 21  # CELT_FINE_OFFSET
                if N == 2:
                    offset += dof << 1
                if s.pulses[i] + offset < 2 * (dof << 3):
                    offset += temp >> 2
                elif s.pulses[i] + offset < 3 * (dof << 3):
                    offset += temp >> 3
                fine_bits = _cdiv(s.pulses[i] + offset + (dof << 2), dof << 3)
                max_bits = min((s.pulses[i] >> 3) >> (CH - 1), 8)
                max_bits = max(max_bits, 0)
                s.fine_bits[i] = max(0, min(fine_bits, max_bits))
                s.fine_priority[i] = int(
                    s.fine_bits[i] * (dof << 3) >= s.pulses[i] + offset)
                s.pulses[i] -= s.fine_bits[i] << (CH - 1) << 3
            else:
                extrabits = max(0, s.pulses[i] - (CH << 3))
                s.pulses[i] -= extrabits
                s.fine_bits[i] = 0
                s.fine_priority[i] = 1
            if extrabits > 0:
                fineextra = min(extrabits >> (CH + 2), 8 - s.fine_bits[i])
                s.fine_bits[i] += fineextra
                fineextra <<= CH + 2
                s.fine_priority[i] = int(fineextra >= extrabits - prev_extra)
                extrabits -= fineextra
        s.remaining = extrabits

        for i in range(s.codedbands, s.endband):
            s.fine_bits[i] = s.pulses[i] >> (CH - 1) >> 3
            s.pulses[i] = 0
            s.fine_priority[i] = int(s.fine_bits[i] < 1)

    # ------------------------------------------------------- PVQ unquant
    def _alg_unquant(self, rd, X, N, K, spread, blocks, gain):
        idx = rd.dec_uint(CT.PVQ_V(N, K))
        y, norm = _cwrsi(N, K, idx)
        g = np.float32(gain / math.sqrt(norm))
        X[:N] = (y[:N] * g).astype(np.float32)
        _exp_rotation(X, N, blocks, K, spread)
        return _extract_collapse_mask(y, N, blocks)

    # ---------------------------------------------------------- band decode
    def _decode_band(self, rd, band, X, Y, N, b, blocks, lowband,
                     duration, lowband_out, level, gain,
                     lowband_scratch, fill):
        s = self
        N0 = N
        B0 = blocks
        N_B = N // blocks
        N_B0 = N_B
        dualstereo = Y is not None
        split = dualstereo
        time_divide = 0
        recombine = 0
        inv = 0
        mid = 0.0
        side = 0.0
        longblocks = int(B0 == 1)
        cm = 0

        if N == 1:
            x = X
            for _ in range(1 + int(dualstereo)):
                sign = 0
                if s.remaining2 >= 1 << 3:
                    sign = rd.dec_bits(1)
                    s.remaining2 -= 1 << 3
                    b -= 1 << 3
                x[0] = -1.0 if sign else 1.0
                x = Y
            if lowband_out is not None:
                lowband_out[0] = X[0]
            return 1

        if not dualstereo and level == 0:
            tf_change = s.tf_change[band]
            if tf_change > 0:
                recombine = tf_change
            if lowband is not None and \
                    (recombine or ((N_B & 1) == 0 and tf_change < 0)
                     or B0 > 1):
                lowband_scratch[:N] = lowband[:N]
                lowband = lowband_scratch
            for k in range(recombine):
                if lowband is not None:
                    _haar1(lowband, N >> k, 1 << k)
                fill = CT.BIT_INTERLEAVE[fill & 0xF] | \
                    CT.BIT_INTERLEAVE[fill >> 4] << 2
            blocks >>= recombine
            N_B <<= recombine
            while (N_B & 1) == 0 and tf_change < 0:
                if lowband is not None:
                    _haar1(lowband, N_B, blocks)
                fill |= fill << blocks
                blocks <<= 1
                N_B >>= 1
                time_divide += 1
                tf_change += 1
            B0 = blocks
            N_B0 = N_B
            if B0 > 1 and lowband is not None:
                _deinterleave_hadamard(lowband, N_B >> recombine,
                                       B0 << recombine, longblocks)

        cache_off = CT.CACHE_INDEX[(duration + 1) * MAX_BANDS + band]
        if not dualstereo and duration >= 0 and \
                b > CT.CACHE_BITS[cache_off + CT.CACHE_BITS[cache_off]] + 12 \
                and N > 2:
            N >>= 1
            Y = X[N:]
            split = 1
            duration -= 1
            if blocks == 1:
                fill = (fill & 1) | (fill << 1)
            blocks = (blocks + 1) >> 1

        if split:
            qn = 0
            itheta = 0
            delta = 0
            pulse_cap = CT.LOG_FREQ_RANGE[band] + duration * 8
            offset = (pulse_cap >> 1) - \
                (16 if dualstereo and N == 2 else 4)
            qn = 1 if (dualstereo and band >= s.intensitystereo) else \
                _compute_qn(N, b, offset, pulse_cap, dualstereo)
            tell = rd.tell_frac()
            if qn != 1:
                if dualstereo and N > 2:
                    itheta = rd.dec_step(qn // 2)
                elif dualstereo or B0 > 1:
                    itheta = rd.dec_uint(qn + 1)
                else:
                    itheta = rd.dec_tri(qn)
                itheta = itheta * 16384 // qn
            elif dualstereo:
                inv = rd.dec_bit_logp(2) if (
                    b > 2 << 3 and s.remaining2 > 2 << 3) else 0
                itheta = 0
            qalloc = rd.tell_frac() - tell
            b -= qalloc

            orig_fill = fill
            if itheta == 0:
                imid = 32767
                iside = 0
                fill &= (1 << blocks) - 1
                delta = -16384
            elif itheta == 16384:
                imid = 0
                iside = 32767
                fill &= ((1 << blocks) - 1) << blocks
                delta = 16384
            else:
                imid = _celt_cos(itheta)
                iside = _celt_cos(16384 - itheta)
                delta = ((N - 1) << 7) * _celt_log2tan(iside, imid)
                delta = (delta + 16384) >> 15

            mid = imid / 32768.0
            side = iside / 32768.0

            if N == 2 and dualstereo:
                mbits = b
                sbits = (1 << 3) if (itheta != 0 and itheta != 16384) else 0
                mbits -= sbits
                c = int(itheta > 8192)
                s.remaining2 -= qalloc + sbits
                x2 = Y if c else X
                y2 = X if c else Y
                sign = 0
                if sbits:
                    sign = rd.dec_bits(1)
                sign = 1 - 2 * sign
                cm = self._decode_band(rd, band, x2, None, N, mbits, blocks,
                                       lowband, duration, lowband_out,
                                       level, gain, lowband_scratch,
                                       orig_fill)
                y2[0] = -sign * x2[1]
                y2[1] = sign * x2[0]
                X[0] *= np.float32(mid)
                X[1] *= np.float32(mid)
                Y[0] *= np.float32(side)
                Y[1] *= np.float32(side)
                tmp = X[0]
                X[0] = tmp - Y[0]
                Y[0] = tmp + Y[0]
                tmp = X[1]
                X[1] = tmp - Y[1]
                Y[1] = tmp + Y[1]
            else:
                next_lowband2 = None
                next_lowband_out1 = None
                next_level = 0
                if B0 > 1 and not dualstereo and (itheta & 0x3FFF):
                    if itheta > 8192:
                        delta -= delta >> (4 - duration)
                    else:
                        delta = min(0, delta + (N << 3 >> (5 - duration)))
                mbits = max(0, min(_cdiv(b - delta, 2), b))
                sbits = b - mbits
                s.remaining2 -= qalloc
                if lowband is not None and not dualstereo:
                    next_lowband2 = lowband[N:]
                if dualstereo:
                    next_lowband_out1 = lowband_out
                else:
                    next_level = level + 1
                rebalance = s.remaining2
                if mbits >= sbits:
                    cm = self._decode_band(
                        rd, band, X, None, N, mbits, blocks, lowband,
                        duration, next_lowband_out1, next_level,
                        1.0 if dualstereo else gain * mid,
                        lowband_scratch, fill)
                    rebalance = mbits - (rebalance - s.remaining2)
                    if rebalance > 3 << 3 and itheta != 0:
                        sbits += rebalance - (3 << 3)
                    cm |= self._decode_band(
                        rd, band, Y, None, N, sbits, blocks, next_lowband2,
                        duration, None, next_level, gain * side, None,
                        fill >> blocks) << ((B0 >> 1) &
                                            (int(dualstereo) - 1))
                else:
                    cm = self._decode_band(
                        rd, band, Y, None, N, sbits, blocks, next_lowband2,
                        duration, None, next_level, gain * side, None,
                        fill >> blocks) << ((B0 >> 1) &
                                            (int(dualstereo) - 1))
                    rebalance = sbits - (rebalance - s.remaining2)
                    if rebalance > 3 << 3 and itheta != 16384:
                        mbits += rebalance - (3 << 3)
                    cm |= self._decode_band(
                        rd, band, X, None, N, mbits, blocks, lowband,
                        duration, next_lowband_out1, next_level,
                        1.0 if dualstereo else gain * mid,
                        lowband_scratch, fill)
        else:
            q = _bits2pulses(CT.CACHE_BITS, cache_off, b)
            curr_bits = _pulses2bits(CT.CACHE_BITS, cache_off, q)
            s.remaining2 -= curr_bits
            while s.remaining2 < 0 and q > 0:
                s.remaining2 += curr_bits
                q -= 1
                curr_bits = _pulses2bits(CT.CACHE_BITS, cache_off, q)
                s.remaining2 -= curr_bits
            if q != 0:
                K = q if q < 8 else (8 + (q & 7)) << ((q >> 3) - 1)
                cm = self._alg_unquant(rd, X, N, K, s.spread, blocks, gain)
            else:
                cm_mask = (1 << blocks) - 1
                fill &= cm_mask
                if not fill:
                    X[:N] = 0.0
                else:
                    if lowband is None:
                        for j in range(N):
                            X[j] = float(self._rng_s32() >> 20)
                        cm = cm_mask
                    else:
                        for j in range(N):
                            X[j] = lowband[j] + (
                                (1.0 / 256) if self._rng() & 0x8000
                                else (-1.0 / 256))
                        cm = fill
                    _renormalize(X[:N], gain)

        if dualstereo:
            if N != 2:
                # stereo merge (dopus.d:2699)
                xf = X[:N].astype(np.float64)
                yf = Y[:N].astype(np.float64)
                # sequential sums (not BLAS dot) to match renormalize_c's
                # native mirror rounding exactly
                xp = 0.0
                sidesum = 0.0
                for xv, yv in zip(xf.tolist(), yf.tolist()):
                    xp += xv * yv
                    sidesum += yv * yv
                xp *= mid
                e0 = mid * mid + sidesum - 2 * xp
                e1 = mid * mid + sidesum + 2 * xp
                if e0 < 6e-4 or e1 < 6e-4:
                    Y[:N] = X[:N]
                else:
                    g0 = 1.0 / math.sqrt(e0)
                    g1 = 1.0 / math.sqrt(e1)
                    v0 = mid * xf
                    v1 = yf
                    X[:N] = (g0 * (v0 - v1)).astype(np.float32)
                    Y[:N] = (g1 * (v0 + v1)).astype(np.float32)
            if inv:
                Y[:N] *= -1.0
        elif level == 0:
            if B0 > 1:
                _interleave_hadamard(X, N_B >> recombine,
                                     B0 << recombine, longblocks)
            N_B = N_B0
            blocks = B0
            for _ in range(time_divide):
                blocks >>= 1
                N_B <<= 1
                cm |= cm >> blocks
                _haar1(X, N_B, blocks)
            for k in range(recombine):
                cm = CT.BIT_DEINTERLEAVE[cm]
                _haar1(X, N0 >> k, 1 << k)
            blocks <<= recombine
            if lowband_out is not None:
                n = math.sqrt(N0)
                lowband_out[:N0] = n * X[:N0]
            cm &= (1 << blocks) - 1
        return cm

    # --------------------------------------------------------- decode bands
    def _decode_bands(self, rd):
        s = self
        lowband_scratch = np.zeros(8 * 22, np.float32)
        norm = np.zeros(2 * 8 * 100, np.float32)
        norm2 = norm[8 * 100 :]
        totalbits = (s.framebits << 3) - s.anticollapse_bit
        update_lowband = True
        lowband_offset = 0
        s.coeffs[:] = 0.0

        for i in range(s.startband, s.endband):
            band_offset = _FREQ_BANDS[i] << s.duration
            band_size = _FREQ_RANGE[i] << s.duration
            X = s.coeffs[0][band_offset :]
            Y = s.coeffs[1][band_offset :] if s.coded_channels == 2 else None
            consumed = rd.tell_frac()
            if i != s.startband:
                s.remaining -= consumed
            s.remaining2 = totalbits - consumed - 1
            if i <= s.codedbands - 1:
                curr_balance = _cdiv(s.remaining, min(3, s.codedbands - i))
                b = max(0, min(16383, min(s.remaining2 + 1,
                                          s.pulses[i] + curr_balance)))
            else:
                b = 0

            if _FREQ_BANDS[i] - _FREQ_RANGE[i] >= \
                    _FREQ_BANDS[s.startband] and \
                    (update_lowband or lowband_offset == 0):
                lowband_offset = i

            effective_lowband = -1
            cm = [0, 0]
            if lowband_offset != 0 and (s.spread != SPREAD_AGGRESSIVE or
                                        s.blocks > 1 or
                                        s.tf_change[i] < 0):
                effective_lowband = max(
                    _FREQ_BANDS[s.startband],
                    _FREQ_BANDS[lowband_offset] - _FREQ_RANGE[i])
                foldstart = lowband_offset
                while True:
                    foldstart -= 1
                    if _FREQ_BANDS[foldstart] <= effective_lowband:
                        break
                foldend = lowband_offset - 1
                while True:
                    foldend += 1
                    if _FREQ_BANDS[foldend] >= \
                            effective_lowband + _FREQ_RANGE[i]:
                        break
                for j in range(foldstart, foldend):
                    cm[0] |= int(s.collapse_masks[0][j])
                    cm[1] |= int(s.collapse_masks[s.coded_channels - 1][j])
            else:
                cm[0] = cm[1] = (1 << s.blocks) - 1

            if s.dualstereo and i == s.intensitystereo:
                s.dualstereo = 0
                j0 = _FREQ_BANDS[s.startband] << s.duration
                norm[j0:band_offset] = (norm[j0:band_offset] +
                                        norm2[j0:band_offset]) / 2

            if s.dualstereo:
                cm[0] = self._decode_band(
                    rd, i, X, None, band_size, b // 2, s.blocks,
                    norm[effective_lowband << s.duration :]
                    if effective_lowband != -1 else None,
                    s.duration, norm[band_offset:], 0, 1.0,
                    lowband_scratch, cm[0])
                cm[1] = self._decode_band(
                    rd, i, Y, None, band_size, b // 2, s.blocks,
                    norm2[effective_lowband << s.duration :]
                    if effective_lowband != -1 else None,
                    s.duration, norm2[band_offset:], 0, 1.0,
                    lowband_scratch, cm[1])
            else:
                cm[0] = self._decode_band(
                    rd, i, X, Y, band_size, b, s.blocks,
                    norm[effective_lowband << s.duration :]
                    if effective_lowband != -1 else None,
                    s.duration, norm[band_offset:], 0, 1.0,
                    lowband_scratch, cm[0] | cm[1])
                cm[1] = cm[0]

            s.collapse_masks[0][i] = cm[0]
            s.collapse_masks[s.coded_channels - 1][i] = cm[1]
            s.remaining += s.pulses[i] + consumed
            update_lowband = b > band_size << 3

    # -------------------------------------------------------- anticollapse
    def _process_anticollapse(self, ch, X):
        s = self
        for i in range(s.startband, s.endband):
            renorm = False
            depth = (1 + s.pulses[i]) // (_FREQ_RANGE[i] << s.duration)
            thresh = 2.0 ** (-1.0 - 0.125 * depth)
            sqrt_1 = 1.0 / math.sqrt(_FREQ_RANGE[i] << s.duration)
            off = _FREQ_BANDS[i] << s.duration
            prev0 = s.prev_energy[ch][0][i]
            prev1 = s.prev_energy[ch][1][i]
            if s.coded_channels == 1:
                prev0 = max(prev0, s.prev_energy[1][0][i])
                prev1 = max(prev1, s.prev_energy[1][1][i])
            ediff = max(0.0, s.energy[ch][i] - min(prev0, prev1))
            r = 2.0 ** (1 - ediff)
            if s.duration == 3:
                r *= math.sqrt(2)
            r = min(thresh, r) * sqrt_1
            for k in range(1 << s.duration):
                if not (int(s.collapse_masks[ch][i]) & (1 << k)):
                    for j in range(_FREQ_RANGE[i]):
                        X[off + (j << s.duration) + k] = \
                            r if self._rng() & 0x8000 else -r
                    renorm = True
            if renorm:
                _renormalize(
                    X[off : off + (_FREQ_RANGE[i] << s.duration)], 1.0)

    # ---------------------------------------------------------- postfilter
    def _parse_postfilter(self, rd, consumed):
        s = self
        s.pf_gains_new[:] = 0.0
        if s.startband == 0 and consumed + 16 <= s.framebits:
            if rd.dec_bit_logp(1):
                octave = rd.dec_uint(6)
                period = (16 << octave) + rd.dec_bits(4 + octave) - 1
                gain = 0.09375 * (rd.dec_bits(3) + 1)
                tapset = rd.dec_cdf(CT.MODEL_TAPSET) if \
                    rd.tell() + 2 <= s.framebits else 0
                taps = CT.POSTFILTER_TAPS[tapset]
                for ch in range(2):
                    s.pf_period_new[ch] = max(period, POSTFILTER_MINPERIOD)
                    s.pf_gains_new[ch] = np.array(
                        [gain * taps[0], gain * taps[1], gain * taps[2]])
            consumed = rd.tell()
        return consumed

    def _postfilter_transition(self, ch, buf, pos):
        """Comb-filter crossfade old->new period/gains (dopus.d:3287).
        Genuinely IIR: taps can read samples updated earlier in the same
        loop (period < overlap), so this follows the reference's rolling-
        register schedule exactly."""
        g_old = self.pf_gains_old[ch]
        g_new = self.pf_gains[ch]
        if g_new[0] == 0.0 and g_old[0] == 0.0:
            return
        T0 = self.pf_period_old[ch]
        T1 = self.pf_period[ch]
        g00, g01, g02 = g_old
        g10, g11, g12 = g_new
        w2 = self._w2
        d = buf
        x1 = d[pos - T1 + 1]
        x2 = d[pos - T1]
        x3 = d[pos - T1 - 1]
        x4 = d[pos - T1 - 2]
        for i in range(OVERLAP):
            w = w2[i]
            x0 = d[pos + i - T1 + 2]
            d[pos + i] += (
                (1.0 - w) * g00 * d[pos + i - T0] +
                (1.0 - w) * g01 * (d[pos + i - T0 - 1] + d[pos + i - T0 + 1]) +
                (1.0 - w) * g02 * (d[pos + i - T0 - 2] + d[pos + i - T0 + 2]) +
                w * g10 * x2 +
                w * g11 * (x1 + x3) +
                w * g12 * (x0 + x4))
            x4 = x3
            x3 = x2
            x2 = x1
            x1 = x0

    def _postfilter_body(self, ch, buf, pos, length):
        """Comb filter with constant gains (dopus.d:3325); IIR when the
        period is shorter than the span, so scalar with the reference's
        rolling registers."""
        g = self.pf_gains[ch]
        if g[0] == 0.0 or length <= 0:
            return
        T = self.pf_period[ch]
        g0, g1, g2 = g
        d = buf
        x4 = d[pos - T - 2]
        x3 = d[pos - T - 1]
        x2 = d[pos - T]
        x1 = d[pos - T + 1]
        if T - 2 >= length:
            # pure FIR: vectorize
            i = np.arange(length)
            d[pos : pos + length] += (
                g0 * d[pos + i - T] +
                g1 * (d[pos + i - T - 1] + d[pos + i - T + 1]) +
                g2 * (d[pos + i - T - 2] + d[pos + i - T + 2]))
            return
        for i in range(length):
            x0 = d[pos + i - T + 2]
            d[pos + i] += g0 * x2 + g1 * (x1 + x3) + g2 * (x0 + x4)
            x4 = x3
            x3 = x2
            x2 = x1
            x1 = x0

    def _postfilter(self, ch, frame_size):
        s = self
        buf = s.buf[ch]
        length = frame_size
        self._postfilter_transition(ch, buf, 1024)
        s.pf_period_old[ch] = s.pf_period[ch]
        s.pf_gains_old[ch] = s.pf_gains[ch].copy()
        s.pf_period[ch] = s.pf_period_new[ch]
        s.pf_gains[ch] = s.pf_gains_new[ch].copy()
        if length > OVERLAP:
            self._postfilter_transition(ch, buf, 1024 + OVERLAP)
            self._postfilter_body(ch, buf, 1024 + 2 * OVERLAP,
                                  length - 2 * OVERLAP)
            s.pf_period_old[ch] = s.pf_period[ch]
            s.pf_gains_old[ch] = s.pf_gains[ch].copy()
        buf[: 1024 + OVERLAP // 2] = buf[length : length + 1024 + OVERLAP // 2]

    # --------------------------------------------------------- frame decode
    def decode_frame(self, rd, coded_channels, frame_size,
                     startband, endband):
        """Decode one CELT frame; returns [frame_size, output_channels]
        float PCM in [-1, 1) (ff_celt_decode_frame, dopus.d:3568)."""
        params = self.decode_frame_symbols(rd, coded_channels, frame_size,
                                           startband, endband)
        return self.synthesize(params)

    def decode_frame_symbols(self, rd, coded_channels, frame_size,
                             startband, endband):
        """Host entropy/parameter stage only: range decode + band shapes +
        denormalized spectrum; synthesis state (overlap buffer, postfilter,
        deemphasis) is untouched.  Returns the params dict consumed by
        synthesize() (host) or the batched device path (ops/celt_dsp.py +
        apply_raw())."""
        lib = native.get_lib()
        if lib is not None:
            params = self._decode_symbols_native(
                lib, rd, coded_channels, frame_size, startband, endband)
            if params is not None:
                return params
        s = self
        s.flushed = False
        s.coded_channels = coded_channels
        s.startband = startband
        s.endband = endband
        s.framebits = rd.storage * 8
        s.duration = (frame_size // SHORT_BLOCKSIZE).bit_length() - 1
        if s.duration > MAX_LOG_BLOCKS or \
                frame_size != SHORT_BLOCKSIZE << s.duration:
            raise ValueError("invalid CELT frame size")
        s.tf_change = [0] * MAX_BANDS
        s.pulses = [0] * MAX_BANDS
        s.fine_bits = [0] * MAX_BANDS
        s.fine_priority = [0] * MAX_BANDS
        s.coeffs = np.zeros((2, MAX_FRAME_SIZE), np.float32)
        s.collapse_masks[:] = 0

        silence = 0
        consumed = rd.tell()
        if consumed >= s.framebits:
            silence = 1
        elif consumed == 1:
            silence = rd.dec_bit_logp(15)
        if silence:
            consumed = s.framebits
            rd.nbits_total += s.framebits - rd.tell()

        consumed = self._parse_postfilter(rd, consumed)

        transient = 0
        if s.duration != 0 and consumed + 3 <= s.framebits:
            transient = rd.dec_bit_logp(3)
        s.blocks = (1 << s.duration) if transient else 1
        s.blocksize = frame_size // s.blocks

        if coded_channels == 1:
            s.energy[0] = np.maximum(s.energy[0], s.energy[1])

        self._decode_coarse_energy(rd)
        self._decode_tf_changes(rd, transient)
        self._decode_allocation(rd)
        self._decode_fine_energy(rd)
        self._decode_bands(rd)

        anticollapse = 0
        if s.anticollapse_bit:
            anticollapse = rd.dec_bits(1)

        self._decode_final_energy(rd, s.framebits - rd.tell())

        for ch in range(coded_channels):
            if anticollapse:
                self._process_anticollapse(ch, s.coeffs[ch])
            # denormalize
            for i in range(s.startband, s.endband):
                off = _FREQ_BANDS[i] << s.duration
                n = _FREQ_RANGE[i] << s.duration
                norm = 2.0 ** (s.energy[ch][i] + CT.MEAN_ENERGY[i])
                s.coeffs[ch][off : off + n] *= np.float32(norm)

        imdct_scale = 1.0
        if s.output_channels < coded_channels:
            s.coeffs[0][:frame_size] += s.coeffs[1][:frame_size]
            imdct_scale = 0.5
        elif s.output_channels > coded_channels:
            s.coeffs[1][:frame_size] = s.coeffs[0][:frame_size]

        if silence:
            s.energy[:] = ENERGY_SILENCE
            s.coeffs[:] = 0.0

        # ---- state roll (independent of synthesis) ----
        if coded_channels == 1:
            s.energy[1] = s.energy[0]
        for ch in range(2):
            if not transient:
                s.prev_energy[ch][1] = s.prev_energy[ch][0].copy()
                s.prev_energy[ch][0] = s.energy[ch].copy()
            else:
                s.prev_energy[ch][0] = np.minimum(s.prev_energy[ch][0],
                                                  s.energy[ch])
            s.prev_energy[ch][0][: s.startband] = ENERGY_SILENCE
            s.energy[ch][: s.startband] = 0.0
            s.prev_energy[ch][0][s.endband :] = ENERGY_SILENCE
            s.energy[ch][s.endband :] = 0.0
        s.seed = rd.rng & 0xFFFFFFFF
        return {
            "coeffs": s.coeffs,
            "frame_size": frame_size,
            "blocks": s.blocks,
            "blocksize": s.blocksize,
            "imdct_scale": imdct_scale,
        }

    def _decode_symbols_native(self, lib, rd, coded_channels, frame_size,
                               startband, endband):
        """C symbol stage (host/src/af_host.cc:af_celt_decode_symbols):
        same entropy decode + denormalize as the Python body below,
        operating directly on this decoder's state arrays and syncing the
        range-decoder state both ways (hybrid packets enter mid-stream and
        Python continues on the same rd afterwards)."""
        s = self
        st = np.array(
            [rd.offs, rd.end_offs, rd.end_window, rd.nend_bits,
             rd.nbits_total, rd.rng, rd.val, rd.rem,
             getattr(rd, "end_bound", rd.storage)], np.int64)
        collapse = np.zeros((2, MAX_BANDS), np.int32)
        res = native.celt_decode_symbols(
            lib, rd.buf, st, coded_channels,
            frame_size, startband, endband, s.output_channels,
            s.energy, s.prev_energy, collapse, s.seed)
        if res is None:
            return None
        coeffs, out_i, out_d, seed = res
        (rd.offs, rd.end_offs, rd.end_window, rd.nend_bits,
         rd.nbits_total, rd.rng, rd.val, rd.rem) = (int(v) for v in st[:8])
        s.flushed = False
        s.coded_channels = coded_channels
        s.startband = startband
        s.endband = endband
        s.framebits = rd.storage * 8
        s.duration = (frame_size // SHORT_BLOCKSIZE).bit_length() - 1
        s.blocks = int(out_i[0])
        s.blocksize = frame_size // s.blocks
        s.coeffs = coeffs
        s.collapse_masks[:] = collapse
        s.seed = seed
        s.pf_gains_new[:] = 0.0
        if out_i[5]:
            for ch in range(2):
                s.pf_period_new[ch] = int(out_i[3])
                s.pf_gains_new[ch] = out_d[:3]
        return {
            "coeffs": coeffs,
            "frame_size": frame_size,
            "blocks": s.blocks,
            "blocksize": s.blocksize,
            "imdct_scale": float(out_d[3]),
        }

    def synthesize(self, params):
        """Host synthesis: per-block IMDCT + windowed OLA + postfilter +
        deemphasis (the single-stream facade path)."""
        s = self
        frame_size = params["frame_size"]
        blocks = params["blocks"]
        blocksize = params["blocksize"]
        imdct_scale = params["imdct_scale"]
        out = np.zeros((frame_size, s.output_channels), np.float32)
        for ch in range(s.output_channels):
            buf = s.buf[ch]
            coeffs = params["coeffs"][ch].astype(np.float64)
            for j in range(blocks):
                dst = 1024 + j * blocksize
                half = imdct_half(coeffs[j :: blocks][: blocksize],
                                  blocksize, imdct_scale)
                buf[dst + OVERLAP // 2 : dst + OVERLAP // 2 +
                    blocksize] = half
                u = np.arange(OVERLAP // 2)
                w = CT.WINDOW
                b0 = buf[dst + u].copy()
                b1 = buf[dst + OVERLAP - 1 - u].copy()
                buf[dst + u] = b0 * w[OVERLAP - 1 - u] - b1 * w[u]
                buf[dst + OVERLAP - 1 - u] = (b0 * w[u] +
                                              b1 * w[OVERLAP - 1 - u])
            out[:, ch] = self._finish_channel(ch, frame_size)
        return out

    def apply_raw(self, raw, tails, frame_size):
        """Batched-path completion: insert device-produced pre-postfilter
        samples (ops/celt_dsp.celt_imdct_ola) into the overlap buffer, then
        postfilter + deemphasis exactly as the host path."""
        s = self
        out = np.zeros((frame_size, s.output_channels), np.float32)
        for ch in range(s.output_channels):
            buf = s.buf[ch]
            buf[1024 : 1024 + frame_size] = raw[:, ch]
            buf[1024 + frame_size : 1024 + frame_size + OVERLAP // 2] = \
                tails[:, ch]
            out[:, ch] = self._finish_channel(ch, frame_size)
        return out

    def _finish_channel(self, ch, frame_size):
        s = self
        lib = native.get_lib()
        if lib is not None:
            periods = np.array([s.pf_period_old[ch], s.pf_period[ch],
                                s.pf_period_new[ch]], np.int32)
            gains = np.concatenate([s.pf_gains_old[ch], s.pf_gains[ch],
                                    s.pf_gains_new[ch]])
            out, s.deemph_coeff[ch] = native.celt_finish_channel(
                lib, s.buf[ch], frame_size, periods, gains,
                s.deemph_coeff[ch])
            s.pf_period_old[ch] = int(periods[0])
            s.pf_period[ch] = int(periods[1])
            s.pf_gains_old[ch] = gains[0:3].copy()
            s.pf_gains[ch] = gains[3:6].copy()
            return out
        buf = s.buf[ch]
        self._postfilter(ch, frame_size)
        m = s.deemph_coeff[ch]
        sig = buf[1024 - frame_size : 1024].copy()
        acc = np.empty(frame_size)
        for j in range(frame_size):
            tmp = sig[j] + m
            m = tmp * DEEMPH_COEFF
            acc[j] = tmp
        s.deemph_coeff[ch] = m
        return (acc / 32768.0).astype(np.float32)


