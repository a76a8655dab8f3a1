"""SILK decoder (the LP layer of Opus, RFC 6716 §4.2).

Host stage of the two-stage pipeline: all range-coded parameters (stereo
weights, frame type, gains, NLSF two-stage VQ with fixed-point LSF->LPC
conversion, pitch lags, LTP filters, shell-coded excitation) decode with
exact integer arithmetic; synthesis (re-whitening, LTP, short-term LPC,
stereo unmix) runs in SINGLE precision (np.float32 / C float), the
reference's own precision — dopus.d's SILK is FFmpeg's float decoder
(dopus.d:5003-5237), so the remaining distance to libopus (whose SILK is
fixed-point int16) is inherited from the reference, not added here.

Reference parity: ff_silk_decode_superframe dopus.d:5278-5345 and helpers
dopus.d:4573-5237.  The entropy layer is bit-exact (validated against
libopus range fingerprints in tests); PCM is validated against libopus
decoding at the SILK-native rate.
"""

from __future__ import annotations

import numpy as np

from ..errors import AudioFormatError
from ..host import native
from ..utils.tables import silk_tables as ST

SILK_HISTORY = 322
SILK_MAX_LAG = 288 + 2  # 288 + LTP_ORDER//2
LTP_ORDER = 5

BW_NB, BW_MB, BW_WB = 0, 1, 2


def _ilog(x: int) -> int:
    """opus_ilog: position of the highest set bit, i.e. bit_length."""
    return x.bit_length()


def _mulh(a: int, b: int) -> int:
    return (a * b) >> 32


def _round_mull(a: int, b: int, s: int) -> int:
    return ((a * b >> (s - 1)) + 1) >> 1


def _clip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


_F32_ONE = np.float32(1.0)


def _clip1f(v):
    """silk_clip1 at single precision (af_host.cc mirror)."""
    return -_F32_ONE if v < -_F32_ONE else (_F32_ONE if v > _F32_ONE else v)


class _Frame:
    __slots__ = ("coded", "log_gain", "nlsf", "lpc", "output",
                 "lpc_history", "primarylag", "prev_voiced")

    def __init__(self):
        self.coded = False
        self.log_gain = 0
        self.nlsf = [0] * 16
        self.lpc = np.zeros(16, np.float32)
        self.output = np.zeros(2 * SILK_HISTORY, np.float32)
        self.lpc_history = np.zeros(2 * SILK_HISTORY, np.float32)
        self.primarylag = 0
        self.prev_voiced = 0

    def flush(self):
        if not self.coded:
            return
        self.output[:] = 0.0
        self.lpc_history[:] = 0.0
        self.lpc[:] = 0.0
        self.nlsf = [0] * 16
        self.log_gain = 0
        self.primarylag = 0
        self.prev_voiced = 0
        self.coded = False


def _stabilize_lsf(nlsf, order, min_delta):
    """NLSF stabilization (dopus.d:4573)."""
    for _ in range(20):
        min_diff = 0
        k = 0
        for i in range(order + 1):
            low = nlsf[i - 1] if i != 0 else 0
            high = nlsf[i] if i != order else 32768
            diff = (high - low) - min_delta[i]
            if diff < min_diff:
                min_diff = diff
                k = i
        if min_diff == 0:
            return
        if k == 0:
            nlsf[0] = min_delta[0]
        elif k == order:
            nlsf[order - 1] = 32768 - min_delta[order]
        else:
            min_center = sum(min_delta[:k]) + (min_delta[k] >> 1)
            max_center = 32768 - sum(min_delta[k + 1 : order + 1]) - \
                (min_delta[k] >> 1)
            center_val = nlsf[k - 1] + nlsf[k]
            center_val = (center_val >> 1) + (center_val & 1)
            center_val = min(max_center, max(min_center, center_val))
            nlsf[k - 1] = center_val - (min_delta[k] >> 1)
            nlsf[k] = nlsf[k - 1] + min_delta[k]
    # fallback: sort + push
    nlsf[:order] = sorted(nlsf[:order])
    if nlsf[0] < min_delta[0]:
        nlsf[0] = min_delta[0]
    for i in range(1, order):
        if nlsf[i] < nlsf[i - 1] + min_delta[i]:
            nlsf[i] = nlsf[i - 1] + min_delta[i]
    if nlsf[order - 1] > 32768 - min_delta[order]:
        nlsf[order - 1] = 32768 - min_delta[order]
    for i in range(order - 2, -1, -1):
        if nlsf[i] > nlsf[i + 1] - min_delta[i + 1]:
            nlsf[i] = nlsf[i + 1] - min_delta[i + 1]


def _is_lpc_stable(lpc, order):
    """Inverse Levinson stability check, exact Q arithmetic
    (dopus.d:4645)."""
    DC_resp = sum(lpc[:order])
    row = [c * 4096 for c in lpc[:order]]
    totalinvgain = 1 << 30
    if DC_resp >= 4096:
        return False
    k = order - 1
    while True:
        if abs(row[k]) > 16773022:
            return False
        rc = -(row[k] * 128)
        gaindiv = (1 << 30) - _mulh(rc, rc)
        totalinvgain = _mulh(totalinvgain, gaindiv) << 2
        if k == 0:
            return totalinvgain >= 107374
        fbits = _ilog(gaindiv)
        gain = ((1 << 29) - 1) // (gaindiv >> (fbits + 1 - 16))
        error = (1 << 29) - ((gaindiv << (15 + 16 - fbits)) * gain >> 16)
        gain = (gain << 16) + (error * gain >> 13)
        prevrow = row
        row = [0] * order
        for j in range(k):
            x = prevrow[j] - _round_mull(prevrow[k - j - 1], rc, 31)
            row[j] = _round_mull(x, gain, fbits)
        k -= 1


def _lsp2poly(lsp, half_order, off):
    pol = [0] * (half_order + 1)
    pol[0] = 65536
    pol[1] = -lsp[off]
    for i in range(1, half_order):
        pol[i + 1] = pol[i - 1] * 2 - _round_mull(lsp[off + 2 * i], pol[i], 16)
        for j in range(i, 1, -1):
            pol[j] += pol[j - 2] - _round_mull(lsp[off + 2 * i],
                                               pol[j - 1], 16)
        pol[1] -= lsp[off + 2 * i]
    return pol


def _lsf2lpc(nlsf, order):
    """NLSF (Q15) -> float LPC, the spec's fixed-point path
    (dopus.d:4720)."""
    lib = native.get_lib()
    if lib is not None:
        # Q12 coefficients: c/4096 has <=15 significand bits, so the
        # float32 cast is exact
        return native.silk_lsf2lpc(lib, nlsf, order).astype(np.float32)
    ordering = ST.LSF_ORDERING_NBMB if order == 10 else ST.LSF_ORDERING_WB
    lsp = [0] * order
    for k in range(order):
        index = nlsf[k] >> 8
        offset = nlsf[k] & 255
        k2 = ordering[k]
        v = ST.COSINE[index] * 256
        v += (ST.COSINE[index + 1] - ST.COSINE[index]) * offset
        lsp[k2] = (v + 4) >> 3
    p = _lsp2poly(lsp, order >> 1, 0)
    q = _lsp2poly(lsp, order >> 1, 1)
    lpc32 = [0] * order
    for k in range(order >> 1):
        lpc32[k] = -p[k + 1] - p[k] - q[k + 1] + q[k]
        lpc32[order - k - 1] = -p[k + 1] - p[k] + q[k + 1] - q[k]

    lpc = [0] * order
    for i in range(10):
        maxabs = 0
        k = 0
        for j in range(order):
            x = abs(lpc32[j])
            if x > maxabs:
                maxabs = x
                k = j
        maxabs = (maxabs + 16) >> 5
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_base = chirp = 65470 - \
                ((maxabs - 32767) << 14) // ((maxabs * (k + 1)) >> 2)
            for k in range(order):
                lpc32[k] = _round_mull(lpc32[k], chirp, 16)
                chirp = (chirp_base * chirp + 32768) >> 16
        else:
            break
    else:
        i = 10
    if i == 10:
        for k in range(order):
            x = (lpc32[k] + 16) >> 5
            lpc[k] = _clip(x, -32768, 32767)
            lpc32[k] = lpc[k] << 5
    else:
        for k in range(order):
            lpc[k] = (lpc32[k] + 16) >> 5

    i = 1
    while i <= 16 and not _is_lpc_stable(lpc, order):
        chirp_base = chirp = 65536 - (1 << i)
        for k in range(order):
            lpc32[k] = _round_mull(lpc32[k], chirp, 16)
            lpc[k] = (lpc32[k] + 16) >> 5
            chirp = (chirp_base * chirp + 32768) >> 16
        i += 1
    return np.array([c / 4096.0 for c in lpc], np.float32)


class SilkDecoder:
    """Per-stream SILK state + superframe decode
    (ff_silk_decode_superframe, dopus.d:5278)."""

    def __init__(self, output_channels: int):
        self.output_channels = output_channels
        self.frame = [_Frame(), _Frame()]
        self.prev_stereo_weights = [0.0, 0.0]
        self.stereo_weights = [0.0, 0.0]
        self.prev_coded_channels = 0
        self.midonly = 0

    def flush(self):
        self.frame[0].flush()
        self.frame[1].flush()
        self.prev_stereo_weights = [0.0, 0.0]

    # --------------------------------------------------------------- LPC
    def _decode_lpc(self, frame, rd, voiced):
        s = self
        order = 16 if s.wb else 10
        lsf_i1 = rd.dec_cdf(ST.MODEL_LSF_S1[1 if s.wb else 0][voiced])
        lsf_i2 = [0] * order
        for i in range(order):
            index = (ST.LSF_S2_MODEL_SEL_WB[lsf_i1][i] if s.wb else
                     ST.LSF_S2_MODEL_SEL_NBMB[lsf_i1][i])
            lsf_i2[i] = rd.dec_cdf(ST.MODEL_LSF_S2[index]) - 4
            if lsf_i2[i] == -4:
                lsf_i2[i] -= rd.dec_cdf(ST.MODEL_LSF_S2_EXT)
            elif lsf_i2[i] == 4:
                lsf_i2[i] += rd.dec_cdf(ST.MODEL_LSF_S2_EXT)

        lsf_res = [0] * order
        for i in range(order - 1, -1, -1):
            qstep = 9830 if s.wb else 11796
            v = lsf_i2[i] * 1024
            if lsf_i2[i] < 0:
                v += 102
            elif lsf_i2[i] > 0:
                v -= 102
            v = (v * qstep) >> 16
            if i + 1 < order:
                wsel = (ST.LSF_WEIGHT_SEL_WB[lsf_i1][i] if s.wb else
                        ST.LSF_WEIGHT_SEL_NBMB[lsf_i1][i])
                weight = (ST.LSF_PRED_WEIGHTS_WB[wsel][i] if s.wb else
                          ST.LSF_PRED_WEIGHTS_NBMB[wsel][i])
                v += (lsf_res[i + 1] * weight) >> 8
            lsf_res[i] = v

        codebook = (ST.LSF_CODEBOOK_WB[lsf_i1] if s.wb else
                    ST.LSF_CODEBOOK_NBMB[lsf_i1])
        nlsf = [0] * order
        for i in range(order):
            cur = codebook[i]
            prev = codebook[i - 1] if i else 0
            nxt = codebook[i + 1] if i + 1 < order else 256
            weight_sq = (1024 // (cur - prev) + 1024 // (nxt - cur)) << 16
            ipart = _ilog(weight_sq)
            fpart = (weight_sq >> (ipart - 8)) & 127
            y = (32768 if (ipart & 1) else 46214) >> ((32 - ipart) >> 1)
            weight = y + ((213 * fpart * y) >> 16)
            value = cur * 128 + _cdiv(lsf_res[i] * 16384, weight)
            nlsf[i] = _clip(value, 0, 32767)

        _stabilize_lsf(nlsf, order,
                       ST.LSF_MIN_SPACING_WB if s.wb else
                       ST.LSF_MIN_SPACING_NBMB)

        has_lpc_leadin = 0
        lpc_leadin = None
        if s.subframes == 4:
            offset = rd.dec_cdf(ST.MODEL_LSF_INTERPOLATION_OFFSET)
            if offset != 4 and frame.coded:
                has_lpc_leadin = 1
                if offset != 0:
                    nlsf_leadin = [
                        frame.nlsf[i] +
                        ((nlsf[i] - frame.nlsf[i]) * offset >> 2)
                        for i in range(order)
                    ]
                    lpc_leadin = _lsf2lpc(nlsf_leadin, order)
                else:
                    lpc_leadin = frame.lpc[:16].copy()
            else:
                offset = 4
            s.nlsf_interp_factor = offset
        else:
            s.nlsf_interp_factor = 4
        lpc = _lsf2lpc(nlsf, order)
        frame.nlsf[:order] = nlsf
        frame.lpc = np.zeros(16, np.float32)
        frame.lpc[:order] = lpc
        return lpc_leadin, lpc, order, has_lpc_leadin

    # --------------------------------------------------------- excitation
    def _decode_excitation(self, rd, flength, qoffset_high, active, voiced):
        s = self
        lib = native.get_lib()
        if lib is not None:
            # C mirror (af_host.cc:af_silk_excitation); range-decoder
            # state carried in/out so the rest of the frame continues on
            # the same rd
            st = np.array(
                [rd.offs, rd.end_offs, rd.end_window, rd.nend_bits,
                 rd.nbits_total, rd.rng, rd.val, rd.rem,
                 getattr(rd, "end_bound", rd.storage)], np.int64)
            shellblocks = ST.SHELL_BLOCKS[s.bandwidth][s.subframes >> 2]
            out = native.silk_excitation(lib, rd.buf, st, shellblocks,
                                         voiced, qoffset_high, active)
            (rd.offs, rd.end_offs, rd.end_window, rd.nend_bits,
             rd.nbits_total, rd.rng, rd.val, rd.rem) = \
                (int(v) for v in st[:8])
            if flength <= out.shape[0]:
                return out[:flength]
            return np.concatenate(
                [out, np.zeros(flength - out.shape[0], np.float32)])
        seed = rd.dec_cdf(ST.MODEL_LCG_SEED)
        shellblocks = ST.SHELL_BLOCKS[s.bandwidth][s.subframes >> 2]
        ratelevel = rd.dec_cdf(ST.MODEL_EXC_RATE[voiced])
        pulsecount = [0] * shellblocks
        lsbcount = [0] * shellblocks
        for i in range(shellblocks):
            pulsecount[i] = rd.dec_cdf(ST.MODEL_PULSE_COUNT[ratelevel])
            if pulsecount[i] == 17:
                while pulsecount[i] == 17:
                    lsbcount[i] += 1
                    if lsbcount[i] == 10:
                        break
                    pulsecount[i] = rd.dec_cdf(ST.MODEL_PULSE_COUNT[9])
                if lsbcount[i] == 10:
                    pulsecount[i] = rd.dec_cdf(ST.MODEL_PULSE_COUNT[10])

        exc = [0] * (shellblocks * 16)

        def count_children(model, total):
            if total:
                off = ((total - 1 + 5) * (total - 1)) >> 1
                row = ST.MODEL_PULSE_LOCATION[model][off : off + total + 2]
                c0 = rd.dec_cdf(row)
                return c0, total - c0
            return 0, 0

        for i in range(shellblocks):
            if pulsecount[i] == 0:
                continue
            base = 16 * i
            b1 = count_children(0, pulsecount[i])
            pos = 0
            for b in range(2):
                b2 = count_children(1, b1[b])
                for c in range(2):
                    b3 = count_children(2, b2[c])
                    for d in range(2):
                        b4 = count_children(3, b3[d])
                        exc[base + pos] = b4[0]
                        exc[base + pos + 1] = b4[1]
                        pos += 2

        for i in range(shellblocks << 4):
            for _ in range(lsbcount[i >> 4]):
                exc[i] = (exc[i] << 1) | rd.dec_cdf(ST.MODEL_EXCITATION_LSB)

        for i in range(shellblocks << 4):
            if exc[i] != 0:
                sign = rd.dec_cdf(
                    ST.MODEL_EXCITATION_SIGN[active + voiced][qoffset_high][
                        min(pulsecount[i >> 4], 6)])
                if sign == 0:
                    exc[i] = -exc[i]

        out = np.zeros(shellblocks * 16, np.float32)
        qoff = ST.QUANT_OFFSET[voiced][qoffset_high]
        for i in range(shellblocks << 4):
            value = exc[i]
            ev = value * 256 | qoff
            if value < 0:
                ev += 20
            elif value > 0:
                ev -= 20
            seed = (196314165 * seed + 907633515) & 0xFFFFFFFF
            if seed & 0x80000000:
                ev = -ev
            seed = (seed + value) & 0xFFFFFFFF
            out[i] = ev / 8388608.0  # |ev| < 2^24: exact in single
        return out[:flength] if flength <= out.shape[0] else np.concatenate(
            [out, np.zeros(flength - out.shape[0], np.float32)])

    # -------------------------------------------------------- frame decode
    def _decode_frame(self, rd, frame_num, channel, coded_channels,
                      active, active1):
        s = self
        frame = s.frame[channel]

        if coded_channels == 2 and channel == 0:
            n = rd.dec_cdf(ST.MODEL_STEREO_S1)
            wi0 = rd.dec_cdf(ST.MODEL_STEREO_S2) + 3 * (n // 5)
            ws0 = rd.dec_cdf(ST.MODEL_STEREO_S3)
            wi1 = rd.dec_cdf(ST.MODEL_STEREO_S2) + 3 * (n % 5)
            ws1 = rd.dec_cdf(ST.MODEL_STEREO_S3)
            w = [0, 0]
            for i, (wi, ws) in enumerate(((wi0, ws0), (wi1, ws1))):
                w[i] = ST.STEREO_WEIGHTS[wi] + (
                    ((ST.STEREO_WEIGHTS[wi + 1] - ST.STEREO_WEIGHTS[wi])
                     * 6554) >> 16) * (ws * 2 + 1)
            # Q13 weights / 2^13: exact in single
            s.stereo_weights[0] = np.float32((w[0] - w[1]) / 8192.0)
            s.stereo_weights[1] = np.float32(w[1] / 8192.0)
            s.midonly = 0 if active1 else rd.dec_cdf(ST.MODEL_MID_ONLY)

        if not active:
            qoffset_high = rd.dec_cdf(ST.MODEL_FRAME_TYPE_INACTIVE)
            voiced = 0
        else:
            ftype = rd.dec_cdf(ST.MODEL_FRAME_TYPE_ACTIVE)
            qoffset_high = ftype & 1
            voiced = ftype >> 1

        sf_gain = [0.0] * s.subframes
        sf_pitchlag = [0] * s.subframes
        sf_ltptaps = [None] * s.subframes
        for i in range(s.subframes):
            if i == 0 and (frame_num == 0 or not frame.coded):
                x = rd.dec_cdf(ST.MODEL_GAIN_HIGHBITS[active + voiced])
                log_gain = (x << 3) | rd.dec_cdf(ST.MODEL_GAIN_LOWBITS)
                if frame.coded:
                    log_gain = max(log_gain, frame.log_gain - 16)
            else:
                delta_gain = rd.dec_cdf(ST.MODEL_GAIN_DELTA)
                log_gain = _clip(max((delta_gain << 1) - 16,
                                     frame.log_gain + delta_gain - 4),
                                 0, 63)
            frame.log_gain = log_gain
            lg = (log_gain * 0x1D1C71 >> 16) + 2090
            ipart = lg >> 7
            fpart = lg & 127
            lingain = (1 << ipart) + \
                ((-174 * fpart * (128 - fpart) >> 16) + fpart) * \
                ((1 << ipart) >> 7)
            sf_gain[i] = np.float32(lingain / 65536.0)

        lpc_leadin, lpc_body, order, has_lpc_leadin = \
            self._decode_lpc(frame, rd, voiced)

        ltpscale = np.float32(15565.0 / 16384.0)
        if voiced:
            lag_absolute = (not frame_num) or (not frame.prev_voiced)
            if not lag_absolute:
                delta = rd.dec_cdf(ST.MODEL_PITCH_DELTA)
                if delta:
                    primarylag = frame.primarylag + delta - 9
                else:
                    lag_absolute = True
            if lag_absolute:
                lowmodel = [ST.MODEL_PITCH_LOWBITS_NB,
                            ST.MODEL_PITCH_LOWBITS_MB,
                            ST.MODEL_PITCH_LOWBITS_WB][s.bandwidth]
                highbits = rd.dec_cdf(ST.MODEL_PITCH_HIGHBITS)
                lowbits = rd.dec_cdf(lowmodel)
                primarylag = ST.PITCH_MIN_LAG[s.bandwidth] + \
                    highbits * ST.PITCH_SCALE[s.bandwidth] + lowbits
            frame.primarylag = primarylag

            if s.subframes == 2:
                if s.bandwidth == BW_NB:
                    offsets = ST.PITCH_OFFSET_NB10MS[
                        rd.dec_cdf(ST.MODEL_PITCH_CONTOUR_NB10MS)]
                else:
                    offsets = ST.PITCH_OFFSET_MBWB10MS[
                        rd.dec_cdf(ST.MODEL_PITCH_CONTOUR_MBWB10MS)]
            else:
                if s.bandwidth == BW_NB:
                    offsets = ST.PITCH_OFFSET_NB20MS[
                        rd.dec_cdf(ST.MODEL_PITCH_CONTOUR_NB20MS)]
                else:
                    offsets = ST.PITCH_OFFSET_MBWB20MS[
                        rd.dec_cdf(ST.MODEL_PITCH_CONTOUR_MBWB20MS)]
            for i in range(s.subframes):
                sf_pitchlag[i] = _clip(primarylag + offsets[i],
                                       ST.PITCH_MIN_LAG[s.bandwidth],
                                       ST.PITCH_MAX_LAG[s.bandwidth])

            ltpfilter = rd.dec_cdf(ST.MODEL_LTP_FILTER)
            filter_sel = [ST.MODEL_LTP_FILTER0_SEL, ST.MODEL_LTP_FILTER1_SEL,
                          ST.MODEL_LTP_FILTER2_SEL][ltpfilter]
            filter_taps = [ST.LTP_FILTER0_TAPS, ST.LTP_FILTER1_TAPS,
                           ST.LTP_FILTER2_TAPS][ltpfilter]
            for i in range(s.subframes):
                index = rd.dec_cdf(filter_sel)
                # int8 taps / 2^7: exact in single
                sf_ltptaps[i] = (np.array(filter_taps[index], np.float32)
                                 / np.float32(128.0))

            if frame_num == 0:
                ltpscale = np.float32(ST.LTP_SCALE_FACTOR[
                    rd.dec_cdf(ST.MODEL_LTP_SCALE_INDEX)] / 16384.0)

        residual = np.zeros(SILK_MAX_LAG + SILK_HISTORY, np.float32)
        residual[SILK_MAX_LAG : SILK_MAX_LAG + s.flength] = \
            self._decode_excitation(rd, s.flength, qoffset_high,
                                    int(bool(active)), voiced)

        if s.output_channels == channel:
            # mono output: side channel decoded for bit sync only
            frame.prev_voiced = voiced
            frame.coded = True
            return

        # synthesis always runs (even when this channel won't be output)
        # so delta-coded gains and pitch state stay in sync
        # (float path; dopus.d:5168-5226)
        lib = native.get_lib()
        if lib is not None:
            taps = np.zeros((s.subframes, LTP_ORDER), np.float32)
            for i, t in enumerate(sf_ltptaps):
                if t is not None:
                    taps[i] = t
            body16 = np.zeros(16, np.float32)
            body16[: len(lpc_body)] = lpc_body
            lead16 = np.zeros(16, np.float32)
            if lpc_leadin is not None:
                lead16[: len(lpc_leadin)] = lpc_leadin
            native.silk_synth(
                lib, residual, frame.output, frame.lpc_history,
                s.subframes, s.sflength, order, int(voiced),
                int(has_lpc_leadin), int(s.nlsf_interp_factor == 4),
                lead16, body16, np.asarray(sf_gain, np.float32),
                np.asarray(sf_pitchlag, np.int32), taps, float(ltpscale))
            frame.prev_voiced = voiced
            frame.lpc_history[:SILK_HISTORY] = \
                frame.lpc_history[s.flength : s.flength + SILK_HISTORY]
            frame.output[:SILK_HISTORY] = \
                frame.output[s.flength : s.flength + SILK_HISTORY]
            frame.coded = True
            return
        for i in range(s.subframes):
            lpc_coeff = lpc_leadin if (i < 2 and has_lpc_leadin) else lpc_body
            dst_off = SILK_HISTORY + i * s.sflength  # into frame.output
            res_off = SILK_MAX_LAG + i * s.sflength
            lpc_off = SILK_HISTORY + i * s.sflength
            out = frame.output
            lpch = frame.lpc_history
            if voiced:
                if i < 2 or s.nlsf_interp_factor == 4:
                    out_end = -i * s.sflength
                    scale = ltpscale
                else:
                    out_end = -(i - 2) * s.sflength
                    scale = _F32_ONE
                # re-whitening of past output into the residual domain
                # (every op np.float32: bit-identical to af_silk_synth)
                j0 = -sf_pitchlag[i] - LTP_ORDER // 2
                for j in range(j0, out_end):
                    total = out[dst_off + j]
                    for k in range(order):
                        total -= lpc_coeff[k] * out[dst_off + j - k - 1]
                    residual[res_off + j] = \
                        _clip1f(total) * scale / sf_gain[i]
                if out_end:
                    rescale = sf_gain[i - 1] / sf_gain[i]
                    residual[res_off + out_end : res_off] *= rescale
                # LTP synthesis (IIR in the residual)
                taps = sf_ltptaps[i]
                lag = sf_pitchlag[i]
                for j in range(s.sflength):
                    total = residual[res_off + j]
                    for k in range(LTP_ORDER):
                        total += taps[k] * \
                            residual[res_off + j - lag + LTP_ORDER // 2 - k]
                    residual[res_off + j] = total

            # LPC synthesis
            g = sf_gain[i]
            for j in range(s.sflength):
                total = residual[res_off + j] * g
                for k in range(1, order + 1):
                    total += lpc_coeff[k - 1] * lpch[lpc_off + j - k]
                lpch[lpc_off + j] = total
                out[dst_off + j] = _clip1f(total)

        frame.prev_voiced = voiced
        frame.lpc_history[:SILK_HISTORY] = \
            frame.lpc_history[s.flength : s.flength + SILK_HISTORY]
        frame.output[:SILK_HISTORY] = \
            frame.output[s.flength : s.flength + SILK_HISTORY]
        frame.coded = True

    def _unmix_ms(self, flength):
        """Mid/side to L/R with weight interpolation (dopus.d:5241)."""
        s = self
        mid = s.frame[0].output
        side = s.frame[1].output
        m0 = SILK_HISTORY - flength
        s0 = SILK_HISTORY - flength
        w0_prev, w1_prev = (np.float32(v) for v in s.prev_stereo_weights)
        w0, w1 = (np.float32(v) for v in s.stereo_weights)
        n1 = np.float32(ST.STEREO_INTERP_LEN[s.bandwidth])
        # vectorized with the scalar reference's exact per-element op tree
        # (elementwise np.float32: the reference's own precision, and
        # rounding identical to the loop form)
        i = np.arange(flength, dtype=np.float32)
        ramp = i < n1
        in0 = np.where(ramp, w0_prev + i * (w0 - w0_prev) / n1, w0)
        in1 = np.where(ramp, w1_prev + i * (w1 - w1_prev) / n1, w1)
        m2 = mid[m0 - 2 : m0 + flength - 2]
        m1 = mid[m0 - 1 : m0 + flength - 1]
        mc = mid[m0 : m0 + flength]
        sd = side[s0 - 1 : s0 + flength - 1]
        quarter, two, one = (np.float32(0.25), np.float32(2.0), _F32_ONE)
        p0 = quarter * (m2 + two * m1 + mc)
        l = np.clip((one + in1) * m1 + sd + in0 * p0, -one, one)
        r = np.clip((one - in1) * m1 - sd - in0 * p0, -one, one)
        s.prev_stereo_weights = list(s.stereo_weights)
        return l, r

    # ---------------------------------------------------------- superframe
    def decode_superframe(self, rd, bandwidth, coded_channels, duration_ms):
        """Decode one SILK superframe; returns float PCM at the SILK
        native rate [frames, output_channels]."""
        s = self
        if bandwidth > BW_WB or coded_channels > 2 or duration_ms > 60:
            raise AudioFormatError("Opus: invalid SILK parameters")
        nb_frames = 1 + (duration_ms > 20) + (duration_ms > 40)
        s.subframes = duration_ms // nb_frames // 5
        s.sflength = 20 * (bandwidth + 2)
        s.flength = s.sflength * s.subframes
        s.bandwidth = bandwidth
        s.wb = bandwidth == BW_WB

        if coded_channels > s.prev_coded_channels:
            s.frame[1].flush()
        s.prev_coded_channels = coded_channels

        active = [[0] * nb_frames, [0] * nb_frames]
        for i in range(coded_channels):
            for j in range(nb_frames):
                active[i][j] = rd.dec_bit_logp(1)
            if rd.dec_bit_logp(1):
                raise AudioFormatError(
                    "Opus: LBRR frames not yet supported")

        out = np.zeros((nb_frames * s.flength, s.output_channels),
                       np.float32)
        for i in range(nb_frames):
            j = 0
            while j < coded_channels and not s.midonly:
                self._decode_frame(rd, i, j, coded_channels,
                                   active[j][i], active[1][i])
                j += 1
            if s.midonly and s.frame[1].coded:
                s.frame[1].flush()
            if coded_channels == 1 or s.output_channels == 1:
                # one-sample delay, SAME as the stereo unmix timeline
                # (libopus dec_API.c delays mono and MS_to_LR identically;
                # a 2-sample window here put mono-TOC packets one native
                # sample late vs stereo ones — the r1-r4 "coupled stereo
                # 13 dB corner" was exactly this skew)
                seg = s.frame[0].output[
                    SILK_HISTORY - s.flength - 1 : SILK_HISTORY - 1]
                for ch in range(s.output_channels):
                    out[i * s.flength : (i + 1) * s.flength, ch] = seg
            else:
                l, r = self._unmix_ms(s.flength)
                out[i * s.flength : (i + 1) * s.flength, 0] = l
                out[i * s.flength : (i + 1) * s.flength, 1] = r
            s.midonly = 0
        return out


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q
