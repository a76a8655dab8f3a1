"""Ogg Opus: container layer, packet TOC, range decoder, silence/DTX frames.

Parity target: dopus.d.  Implemented this round:

* Ogg-Opus demux: OpusHead (version/channels/preskip/input-rate/gain/mapping,
  dopus.d:7793-7830), OpusTags with R128_TRACK_GAIN (dopus.d:8011),
  duration = last-page granule − preskip at a fixed 48 kHz output
  (dopus.d:7954, 8155-8158), page-anchor seek with preskip-aware
  decode-and-discard positions (stream.d:1177-1188 contract)
* Packet TOC parse: config/bandwidth/frame sizes, stereo flag, frame-count
  codes 0-3 incl. VBR/CBR framing and padding (RFC 6716 §3, dopus.d
  OpusPacket), per-packet sample counts
* The RFC 6716 §4.1 range decoder (dopus.d OpusRangeCoder:707-810) — the
  entropy substrate for CELT/SILK decode
* Silence/DTX handling: zero-length frames and CELT silence frames decode to
  silence with exact sample accounting

CELT-only streams (music; configs 16-31) decode fully via models/celt.py.
SILK-only streams (speech; configs 0-11) decode fully via models/silk.py,
upsampled to 48 kHz with the libopus-identified resampler kernels
(ops/resample.py FittedUpsampler, ~81 dB vs the oracle's own resampler;
``OpusDecoder(src, reference_resampler=True)`` selects the exact mirror of
the reference's speex quality-3 path instead, dopus.d:5381+).  Hybrid streams (configs
12-15)
decode SILK WB + the CELT layer from band 17 on the shared range
decoder, including mode-transition redundancy crossfades.  Multistream
channel mappings (families 1/2/255, e.g. 5.1) are implemented and
oracle-tested (mapping parse + per-stream decode below; libopus A/B in
tests/test_opus_silk.py).  LBRR redundancy frames are rejected with a
clear error — the same behavior as the reference (dopus.d:5313).
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional

import numpy as np

from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..io import ogg
from ..io.source import ByteSource


# ---------------------------------------------------------------------------
# Range decoder (RFC 6716 §4.1)
# ---------------------------------------------------------------------------

class RangeDecoder:
    """Opus range decoder over one frame's bytes.

    Front bits feed the range coder; raw bits are read from the packet tail
    (RFC 6716 §4.1.4).
    """

    SYM_BITS = 8
    CODE_BITS = 32
    SYM_MAX = (1 << 8) - 1
    CODE_TOP = 1 << 31
    CODE_BOT = 1 << 23
    CODE_EXTRA = (32 - 2) % 8 + 1  # 7

    def __init__(self, data: bytes):
        self.buf = data
        self.storage = len(data)
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = self.CODE_BITS + 1 - \
            ((self.CODE_BITS - self.CODE_EXTRA) // self.SYM_BITS) * self.SYM_BITS
        self.rng = 1 << self.CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (self.SYM_BITS - self.CODE_EXTRA))
        self._normalize()

    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        bound = getattr(self, "end_bound", self.storage)
        if self.end_offs < bound:
            self.end_offs += 1
            return self.buf[bound - self.end_offs]
        return 0

    def rebound_end(self, new_size: int) -> None:
        """Shrink the raw-bit (tail) region, e.g. when a redundancy frame
        occupies the end of a hybrid packet (opus_raw_init dopus.d:6269)."""
        self.end_bound = new_size

    def _normalize(self) -> None:
        while self.rng <= self.CODE_BOT:
            self.nbits_total += self.SYM_BITS
            self.rng <<= self.SYM_BITS
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << self.SYM_BITS) | self.rem) >> (self.SYM_BITS - self.CODE_EXTRA)
            self.val = ((self.val << self.SYM_BITS) +
                        (self.SYM_MAX & ~sym)) & (self.CODE_TOP - 1)

    def decode(self, ft: int) -> int:
        """ec_decode: returns fs in [0, ft)."""
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - 1 - min(s, ft - 1)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - 1 - min(s, (1 << bits) - 1)

    def update(self, fl: int, fh: int, ft: int) -> None:
        """ec_dec_update."""
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = int(d < s)
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        """ec_dec_icdf with an inverse CDF table (values scaled to 2^ftb)."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        """ec_dec_uint: uniform in [0, ft)."""
        assert ft > 1
        ft -= 1
        ftb = ft.bit_length()
        if ftb > 8:
            ftb -= 8
            ft1 = (ft >> ftb) + 1
            t = self.decode(ft1)
            self.update(t, t + 1, ft1)
            t = (t << ftb) | self.dec_bits(ftb)
            # clamp on overflow (ec_dec_uint sets the error flag and
            # returns ft; ff clamps to size-1 — dopus.d:952)
            return t if t <= ft else ft
        ft += 1
        t = self.decode(ft)
        self.update(t, t + 1, ft)
        return t

    def tell_frac(self) -> int:
        """ec_tell_frac: bits consumed in 1/8-bit units (dopus.d:896)."""
        nbits = self.nbits_total << 3
        l = self.rng.bit_length()
        r = self.rng >> (l - 16)
        for _ in range(3):
            r = (r * r) >> 15
            b = r >> 16
            l = (l << 1) | b
            r >>= b
        return nbits - l

    def dec_laplace(self, fs: int, decay: int) -> int:
        """Laplace-distributed symbol (ec_laplace_decode; dopus.d:957)."""
        value = 0
        low = 0
        center = self.decode_bin(15)
        if center >= fs:
            value += 1
            low = fs
            fs = 1 + (((32768 - 32 - fs) * (16384 - decay)) >> 15)
            while fs > 1 and center >= low + 2 * fs:
                value += 1
                fs *= 2
                low += fs
                fs = (((fs - 2) * decay) >> 15) + 1
            if fs <= 1:
                distance = (center - low) >> 1
                value += distance
                low += 2 * distance
            if center < low + fs:
                value = -value
            else:
                low += fs
        self.update(low, min(low + fs, 32768), 32768)
        return value

    def dec_cdf(self, model) -> int:
        """Symbol with an ff-style cdf model: model[0] = ft, model[1:] the
        cumulative highs (dopus.d:852)."""
        total = model[0]
        fs = self.decode(total)
        k = 0
        while model[1 + k] <= fs:
            k += 1
        self.update(model[k] if k else 0, model[1 + k], total)
        return k

    def dec_step(self, k0: int) -> int:
        """Step pdf for stereo theta (dopus.d:998)."""
        total = (k0 + 1) * 3 + k0
        fs = self.decode(total)
        k = fs // 3 if fs < (k0 + 1) * 3 else fs - (k0 + 1) * 2
        if k <= k0:
            self.update(3 * k, 3 * (k + 1), total)
        else:
            self.update((k - 1 - k0) + 3 * (k0 + 1),
                        (k - k0) + 3 * (k0 + 1), total)
        return k

    def dec_tri(self, qn: int) -> int:
        """Triangular pdf for mono theta (dopus.d:1012)."""
        import math

        total = ((qn >> 1) + 1) * ((qn >> 1) + 1)
        center = self.decode(total)
        if center < total >> 1:
            k = (math.isqrt(8 * center + 1) - 1) >> 1
            low = k * (k + 1) >> 1
            fs = k + 1
        else:
            k = (2 * (qn + 1) - math.isqrt(8 * (total - center - 1) + 1)) >> 1
            low = total - ((qn + 1 - k) * (qn + 2 - k) >> 1)
            fs = qn + 1 - k
        self.update(low, low + fs, total)
        return k

    def dec_bits(self, bits: int) -> int:
        """Raw bits from the packet tail."""
        window = self.end_window
        available = self.nend_bits
        while available < bits:
            window |= self._read_byte_from_end() << available
            available += self.SYM_BITS
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    def tell(self) -> int:
        return self.nbits_total - self.rng.bit_length()


# ---------------------------------------------------------------------------
# Packet TOC (RFC 6716 §3.1-3.2)
# ---------------------------------------------------------------------------

_CONFIG_FRAME_SIZES = []  # samples at 48 kHz per config 0..31
for _c in range(32):
    if _c < 12:
        _CONFIG_FRAME_SIZES.append(
            [480, 960, 1920, 2880][_c & 3]
        )
    elif _c < 16:
        _CONFIG_FRAME_SIZES.append(480 << (_c & 1))
    else:
        _CONFIG_FRAME_SIZES.append(120 << (_c & 3))


def _lace16(body, off):
    """Read a 1/2-byte Opus frame length (xiph_lacing_16bit)."""
    if off >= len(body):
        return None, off
    n = body[off]
    off += 1
    if n >= 252:
        if off >= len(body):
            return None, off
        n = body[off] * 4 + n
        off += 1
    return n, off


def parse_packet(data: bytes, self_delimited: bool = False):
    """Split an Opus packet into frames (RFC 6716 §3.2; appendix B framing
    when ``self_delimited`` — used for all but the last substream of a
    multistream packet).

    Returns dict(config, stereo, frame_size, frames=[bytes...],
    pkt_size=consumed bytes) or None.
    """
    if len(data) < 1:
        return None
    toc = data[0]
    config = toc >> 3
    stereo = (toc >> 2) & 1
    code = toc & 3
    frame_size = _CONFIG_FRAME_SIZES[config]
    body = data[1:]
    pkt_size = len(data)
    frames: List[bytes] = []
    if code == 0:
        if self_delimited:
            n, off = _lace16(body, 0)
            if n is None or off + n > len(body):
                return None
            frames = [body[off : off + n]]
            pkt_size = 1 + off + n
        else:
            frames = [body]
    elif code == 1:
        if self_delimited:
            n, off = _lace16(body, 0)
            if n is None or off + 2 * n > len(body):
                return None
            frames = [body[off : off + n], body[off + n : off + 2 * n]]
            pkt_size = 1 + off + 2 * n
        else:
            if len(body) & 1:
                return None
            half = len(body) // 2
            frames = [body[:half], body[half:]]
    elif code == 2:
        n1, off = _lace16(body, 0)
        if n1 is None:
            return None
        if self_delimited:
            n2, off = _lace16(body, off)
            if n2 is None or off + n1 + n2 > len(body):
                return None
            frames = [body[off : off + n1], body[off + n1 : off + n1 + n2]]
            pkt_size = 1 + off + n1 + n2
        else:
            if off + n1 > len(body):
                return None
            frames = [body[off : off + n1], body[off + n1 :]]
    else:  # code 3
        if not body:
            return None
        ch = body[0]
        nframes = ch & 0x3F
        vbr = (ch >> 7) & 1
        has_padding = (ch >> 6) & 1
        off = 1
        if nframes == 0:
            return None
        padding = 0
        if has_padding:
            while True:
                if off >= len(body):
                    return None
                p = body[off]
                off += 1
                padding += p if p < 255 else 254
                if p != 255:
                    break
        if vbr:
            sizes = []
            for _ in range(nframes - 1):
                n, off = _lace16(body, off)
                if n is None:
                    return None
                sizes.append(n)
            if self_delimited:
                last, off = _lace16(body, off)
                if last is None:
                    return None
                sizes.append(last)
                pkt_size = 1 + off + sum(sizes) + padding
            else:
                rest = len(body) - padding - off - sum(sizes)
                if rest < 0:
                    return None
                sizes.append(rest)
        else:
            if self_delimited:
                per, off = _lace16(body, off)
                if per is None:
                    return None
                sizes = [per] * nframes
                pkt_size = 1 + off + per * nframes + padding
            else:
                total = len(body) - padding - off
                if total % nframes:
                    return None
                sizes = [total // nframes] * nframes
        if off + sum(sizes) > len(body):
            return None
        for n in sizes:
            frames.append(body[off : off + n])
            off += n
    if frame_size * len(frames) > 5760:  # max 120 ms per packet
        return None
    return {
        "config": config,
        "stereo": stereo,
        "frame_size": frame_size,
        "frames": frames,
        "pkt_size": pkt_size,
        "mode": ("silk" if config < 12 else
                 "hybrid" if config < 16 else "celt"),
    }


class OpusStreamDecoder:
    """Decoder state for ONE elementary Opus stream (a multistream packet
    carries several; mapping family 0 has exactly one).  Mirrors
    OpusStreamContext (dopus.d:731)."""

    def __init__(self, output_channels: int,
                 reference_resampler: bool = False):
        from .celt import CeltDecoder

        self.channels = output_channels
        #: SILK's 48 kHz upsampler: the speex quality-3 mirror of the
        #: reference when True, else the libopus-identified kernels
        self._reference_resampler = reference_resampler
        self._celt = CeltDecoder(output_channels=output_channels)
        self._silk = None
        self._silk_rs = None
        self._silk_bw = None
        #: CELT delay FIFO for hybrid (av_audio_fifo celt_delay,
        #: dopus.d:6424-6466) + resampler deficit + unfinished tail fade
        self._celt_hyb_delay = np.zeros((0, output_channels), np.float32)
        self._delayed = 0
        self._red_carry = None
        self._silk_drop = 0

    #: initial 48 kHz output samples to drop per SILK bandwidth (NB/MB/WB),
    #: calibrated so the speex-Q3 resampled stream aligns at zero lag with
    #: libopus decoding the same packets at 48 kHz
    _SILK_DROP_48 = [2, 2, 2]

    def _flush_silk_resampler(self):
        """Drain the resampler's delayed samples (+ the hybrid CELT FIFO)
        when leaving SILK/hybrid mode or changing the SILK rate
        (opus_flush_resample, dopus.d:6280-6312 / flush_needed
        dopus.d:6520-6553).  Returns the flushed PCM (possibly empty)."""
        n = self._delayed
        if self._silk_rs is None or n <= 0:
            self._silk_rs = None
            self._silk_bw = None
            self._delayed = 0
            self._celt_hyb_delay = self._celt_hyb_delay[:0]
            return np.zeros((0, self.channels), np.float32)
        cols = [rs.flush(n) for rs in self._silk_rs]
        fl = np.stack(cols, 1).astype(np.float32)
        if self._celt_hyb_delay.shape[0]:
            m = min(n, self._celt_hyb_delay.shape[0])
            fl[:m] += self._celt_hyb_delay[:m]
        self._celt_hyb_delay = self._celt_hyb_delay[:0]
        self._apply_red_carry(fl)
        self._silk_rs = None
        self._silk_bw = None
        self._delayed = 0
        return fl

    def drain_tail(self, want: int) -> np.ndarray:
        """EOS drain: `want` more samples from the SILK resampler tail,
        PLUS the pending hybrid CELT delay FIFO and any unfinished
        redundancy fade.  These are the samples the reference's
        delayed_samples bookkeeping defers (dopus.d:6393, FIFO
        dopus.d:6424-6466); dropping the FIFO here would silence the
        CELT layer's contribution to the final `delayed` samples of a
        hybrid stream."""
        cols = [rs.flush(want) for rs in self._silk_rs]
        out = np.stack(cols, 1).astype(np.float32)
        hd = self._celt_hyb_delay
        if hd.shape[0]:
            m = min(out.shape[0], hd.shape[0])
            out[:m] += hd[:m, : out.shape[1]]
            self._celt_hyb_delay = hd[:0]
        self._apply_red_carry(out)
        self._silk_rs = None
        return out

    def decode_packet(self, pk) -> np.ndarray:
        """Single-stream driver: answer each CELT synthesis request from
        decode_packet_gen with the host IMDCT (CeltDecoder.synthesize).
        The batch scheduler drives the same generator but batches the
        requests across lanes (parallel/batch.py
        _decode_opus_mixed_group), so the two paths cannot diverge on
        mode-transition logic."""
        gen = self.decode_packet_gen(pk)
        val = None
        while True:
            try:
                cd, params = gen.send(val)
            except StopIteration as e:
                return e.value
            val = cd.synthesize(params)

    def decode_packet_gen(self, pk):
        """Generator form of the packet decode: yields ``(celt_decoder,
        params)`` for every full CELT frame synthesis and receives the
        synthesized PCM back via ``send``; everything else (SILK
        synthesis, resampler flushes, redundancy crossfades, hybrid delay
        FIFO — dopus.d:6280-6553) runs inline on this stream's state."""
        out = []
        if pk["mode"] == "celt" and self._silk_rs is not None:
            fl = self._flush_silk_resampler()
            if fl.shape[0]:
                out.append(fl)
        for frame in pk["frames"]:
            n = pk["frame_size"]
            if len(frame) == 0:
                # DTX/packet-loss frame: silence
                out.append(np.zeros((n, self.channels), np.float32))
                continue
            if pk["mode"] == "celt":
                # CELT-only bandwidths: configs 16-19 NB, 20-23 WB,
                # 24-27 SWB, 28-31 FB (RFC 6716 §3.1)
                endband = [13, 17, 19, 21][(pk["config"] - 16) >> 2]
                rd = RangeDecoder(frame)
                coded = 2 if pk["stereo"] else 1
                if self._silk is not None:
                    self._silk.flush()  # mode switch (dopus.d:6396)
                params = self._celt.decode_frame_symbols(
                    rd, coded, n, 0, endband)
                pcm = (yield (self._celt, params)).astype(np.float32)
                if self._celt_hyb_delay.shape[0]:
                    # spurious hybrid delay samples: drained (dopus.d:6439)
                    self._celt_hyb_delay = self._celt_hyb_delay[:0]
                self._apply_red_carry(pcm)
                out.append(pcm)
                continue
            if pk["mode"] in ("silk", "hybrid"):
                pcm = yield from self._decode_silk_frame_gen(pk, frame)
                out.append(pcm.astype(np.float32))
                continue
            raise AudioFormatError(
                "Opus: coded %s frames not yet supported" % pk["mode"]
            )
        return np.concatenate(out) if out else \
            np.zeros((0, self.channels), np.float32)

    def _decode_silk_frame_gen(self, pk, frame: bytes):
        from .silk import SilkDecoder

        hybrid = pk["mode"] == "hybrid"
        if hybrid:
            # hybrid: SILK always runs wideband; 10/20 ms only
            bw = 2
            dur_ms = pk["frame_size"] // 48
        else:
            bw = pk["config"] // 4  # 0 NB, 1 MB, 2 WB
            dur_ms = [10, 20, 40, 60][pk["config"] & 3]
        coded = 2 if pk["stereo"] else 1
        if self._silk is None:
            self._silk = SilkDecoder(output_channels=self.channels)
        flush_pcm = None
        if self._silk_rs is not None and self._silk_bw != bw:
            # SILK rate change: flush the old-rate tail first
            # (flush_needed on cur_samplerate != silk_samplerate,
            # dopus.d:6521)
            flush_pcm = self._flush_silk_resampler()
        if self._silk_rs is None or self._silk_bw != bw:
            if self._reference_resampler:
                # the reference's own path: speex quality-3 mirror
                # (dopus.d:6326) with its initial-silence alignment feed
                from ..ops.resample import SpeexResampler

                rate = [8000, 12000, 16000][bw]
                self._silk_rs = [SpeexResampler(rate)
                                 for _ in range(self.channels)]
                delay = [5, 9, 12][bw]
                for rs in self._silk_rs:
                    rs.process(np.zeros(delay, np.float32), 128)
                self._silk_drop = self._SILK_DROP_48[bw]
            else:
                # production path: libopus-identified kernels (~81 dB vs
                # the oracle's own resampler, tools/fit_silk_resampler.py)
                from ..ops.resample import FittedUpsampler

                self._silk_rs = [FittedUpsampler(bw)
                                 for _ in range(self.channels)]
                # warmup zeros so the silk48 stream carries exactly
                # libopus' leading delay.  ONE value per bandwidth, no
                # per-channel-count adjustment: decode_superframe's mono
                # copy and MS unmix now share a one-sample-delay timeline
                # (silk.py decode_superframe), exactly as libopus delays
                # its mono copy and silk_stereo_MS_to_LR identically —
                # so mono-TOC and stereo-TOC packets (which can alternate
                # mid-stream) ride one grid.  The old per-mode skew was
                # the r1-r4 "coupled stereo 13 dB" corner: a 16 kbps
                # stereo encode emits mono-TOC packets, which landed one
                # native sample (3 @48k) off.
                feed = [4, 9, 12][bw]
                for rs in self._silk_rs:
                    rs.process(np.zeros(feed, np.float32), 0)
                self._silk_drop = 0
            self._silk_bw = bw
        rd = RangeDecoder(frame)
        native = self._silk.decode_superframe(rd, bw, coded, dur_ms)
        cols = [rs.process(native[:, c], pk["frame_size"])
                for c, rs in enumerate(self._silk_rs)]
        n48 = min(c.shape[0] for c in cols)
        pcm = np.stack([c[:n48] for c in cols], 1)
        if self._silk_drop:
            # initial alignment drop (calibrated against libopus decoding
            # at 48 kHz: the speex-Q3 chain runs this many samples late);
            # early packets run short — the reference tracks the same
            # shortfall as delayed_samples (dopus.d:6393) and the stream
            # layer's EOS drain makes the count up from the tail
            k = min(self._silk_drop, pcm.shape[0])
            pcm = pcm[k:]
            self._silk_drop -= k
        delayed = self._delayed  # pre-frame value (dopus.d:6374)
        self._delayed += pk["frame_size"] - pcm.shape[0]

        if hybrid:
            # redundancy flag + size (dopus.d:6400-6420), then the CELT
            # layer (bands 17+) continues on the SAME range decoder with
            # the raw-bit region excluding any redundancy tail
            size = len(frame)
            redundancy = 0
            redundancy_pos = 0
            red = None
            if rd.tell() + 37 <= size * 8:
                redundancy = rd.dec_bit_logp(12)
            if redundancy:
                redundancy_pos = rd.dec_bit_logp(1)
                red_size = rd.dec_uint(256) + 2
                size -= red_size
                if size < 0:
                    raise AudioFormatError("Opus: bad redundancy size")
                rd.rebound_end(size)
                if redundancy_pos:
                    self._celt.flush()
                    red = self._decode_red_frame(frame[size:], coded, bw)
            endband = 19 if pk["config"] < 14 else 21
            params = self._celt.decode_frame_symbols(
                rd, coded, pk["frame_size"], 17, endband)
            celt_pcm = (yield (self._celt, params)).astype(np.float32)
            # CELT delay FIFO (dopus.d:6424-6466): the CELT layer is
            # re-aligned to the (resampler-delayed) SILK timeline — only
            # the first len(pcm) samples add now, the tail carries over
            comb = np.concatenate([self._celt_hyb_delay, celt_pcm])
            n = pcm.shape[0]
            pcm += comb[:n, : pcm.shape[1]]
            self._celt_hyb_delay = comb[n:]
            self._apply_red_carry(pcm)
            if red is not None:  # redundancy at frame start (dopus.d:6497)
                self._paste_red_start(pcm, red, delayed)
            elif redundancy:
                self._celt.flush()
                red = self._decode_red_frame(frame[size:], coded, bw)
                self._fade_red_tail(pcm, red, delayed)
            if flush_pcm is not None and flush_pcm.shape[0]:
                pcm = np.concatenate([flush_pcm, pcm])
            return pcm

        # SILK-only: the CELT layer is flushed while SILK packets play
        # (dopus.d:6467); a mode-transition redundancy frame (5 ms CELT at
        # the packet tail, dopus.d:6340+6480-6505) then decodes on the
        # fresh state so a following CELT packet starts from the same
        # energy/overlap memory as libopus
        self._celt.flush()
        self._apply_red_carry(pcm)
        consumed = rd.tell()
        if consumed + 17 <= len(frame) * 8 and pcm.shape[0] >= 240:
            redundancy_pos = rd.dec_bit_logp(1)
            red_size = len(frame) - (consumed + 7) // 8
            if red_size > 0:
                red = self._decode_red_frame(
                    frame[len(frame) - red_size :], coded, bw)
                if redundancy_pos:
                    self._paste_red_start(pcm, red, delayed)
                else:
                    self._fade_red_tail(pcm, red, delayed)
        if flush_pcm is not None and flush_pcm.shape[0]:
            pcm = np.concatenate([flush_pcm, pcm])
        return pcm

    def _decode_red_frame(self, data: bytes, coded: int, bw: int):
        """Decode a 5 ms CELT redundancy frame (opus_decode_redundancy
        dopus.d:6340).  SILK MB redundancy uses the WB CELT layout."""
        if len(data) < 1:
            return None
        endband = [13, 17, 17, 19, 21][min(bw, 4)]
        rd2 = RangeDecoder(data)
        red = self._celt.decode_frame(rd2, coded, 240, 0, endband)
        return red[:, : self.channels].astype(np.float32)

    def _paste_red_start(self, pcm, red, delayed: int) -> None:
        """Redundancy at frame start (dopus.d:6497-6502): memcpy the first
        120 samples at the delayed offset, then fade the next 120
        (out·w² + red·(1−w²))."""
        if red is None or pcm.shape[0] < delayed + 240:
            return
        w2 = self._celt_w2()
        pcm[delayed : delayed + 120] = red[:120]
        seg = slice(delayed + 120, delayed + 240)
        pcm[seg] = pcm[seg] * w2 + red[120:240] * (1 - w2)

    def _fade_red_tail(self, pcm, red, delayed: int) -> None:
        """Redundancy at frame end (dopus.d:6487-6494): fade
        red·w² + out·(1−w²) over the last 120−delayed samples; the
        unfinished part of the fade carries into the NEXT frame
        (redundancy_idx, dopus.d:6471-6478)."""
        if red is None:
            return
        n = pcm.shape[0]
        delayed = min(delayed, 119)
        ln = 120 - delayed
        start = n - 120 + delayed
        if start < 0 or n < ln:
            return
        w2 = self._celt_w2()
        pcm[start : start + ln] = (red[120 : 120 + ln] * w2[:ln]
                                   + pcm[start : start + ln] * (1 - w2[:ln]))
        if delayed:
            self._red_carry = (red, ln)

    def _apply_red_carry(self, pcm) -> None:
        """Continue an unfinished tail fade on the next frame
        (s.redundancy_idx block, dopus.d:6471-6478)."""
        if self._red_carry is None:
            return
        red, idx = self._red_carry
        self._red_carry = None
        ln = 120 - idx
        if ln <= 0 or pcm.shape[0] < ln:
            return
        w2 = self._celt_w2()
        pcm[:ln] = (red[120 + idx : 240] * w2[idx:]
                    + pcm[:ln] * (1 - w2[idx:]))

    @staticmethod
    def _celt_w2():
        from ..utils.tables import celt_tables as CT

        return (CT.WINDOW * CT.WINDOW)[:, None]


# ---------------------------------------------------------------------------
# Decoder (container complete; coded-audio decode lands next round)
# ---------------------------------------------------------------------------

def probe(src: ByteSource, device="cuda"):
    """An OpusDecoder for an Ogg Opus stream, else None.  The decoder
    works on the host; `device` is taken for the cascade's uniform call."""
    view = src.view()
    page = ogg.parse_page(view, 0)
    if page is None:
        return None
    body = view[page.body_offset : page.body_offset + page.body_size]
    if len(body) < 19 or bytes(body[:8]) != b"OpusHead":
        return None
    # the OpusHead magic commits this stream to Opus: a malformed header
    # is a corrupt Opus stream, not "some other format" — surface the
    # specific error instead of falling through the cascade
    return OpusDecoder(src)


def float_to_s16_ref(x: np.ndarray) -> np.ndarray:
    """The reference's float→s16 conversion, bit-exact: Float2IntScaled
    (dopus.d:7923-7926) adds the magic constant 1.5·2^8 + 0.5·2^-15 so the
    IEEE f32 addition itself rounds to the 2^-15 grid (ties-to-even), then
    recovers the integer from the bit pattern and clamps to s16."""
    t = np.ascontiguousarray(x, np.float32) \
        + np.float32(1.5 * (1 << (23 - 15)) + 0.5 / (1 << 15))
    v = t.view(np.int32) - (((150 - 15) << 23) + (1 << 22))
    return np.clip(v, -32768, 32767).astype(np.int16)


class OpusDecoder:
    format = AudioFileFormat.opus
    sample_rate = 48000  # Opus always decodes at 48 kHz (dopus.d:7954)

    #: s16 parity mode: quantize output through the reference's s16 grid
    #: (dopus.d:8098-8105 + stream.d:480) for A/B diff-testing; full-float
    #: output (the default) is strictly more precise (SURVEY §7).
    s16_parity = False

    def __init__(self, src: ByteSource, reference_resampler: bool = False):
        """`reference_resampler`: upsample SILK with the exact mirror of the
        reference's speex quality-3 resampler (dopus.d:6326) in place of
        the libopus-identified kernels (the default)."""
        self._src = src
        self._view = src.view()
        self._reference_resampler = reference_resampler
        self._parse_headers()
        total = ogg.last_granule(self._view, self._serial)
        if total < self.preskip:
            raise AudioFormatError("Opus: invalid granule positions")
        self.length_frames = int(total) - self.preskip
        self._page_index = [
            (off, g) for off, g in ogg.page_offsets(self._view, self._serial)
            if g >= 0
        ]
        self._start_stream()

    def _parse_headers(self) -> None:
        reader = ogg.OggPacketReader(self._view)
        pk = reader.next_packet()
        if pk is None or len(pk[0]) < 19 or pk[0][:8] != b"OpusHead":
            raise AudioFormatError("Opus: missing OpusHead")
        head = pk[0]
        page0 = ogg.parse_page(self._view, 0)
        self._serial = page0.serial
        version = head[8]
        if version & 0xF0:
            raise AudioFormatError("Opus: unsupported version")
        self.channels = head[9]
        self.preskip = struct.unpack_from("<H", head, 10)[0]
        self.input_sample_rate = struct.unpack_from("<I", head, 12)[0]
        self.output_gain_q8 = struct.unpack_from("<h", head, 16)[0]
        self.channel_mapping = head[18]
        if self.channels == 0:
            raise AudioFormatError("Opus: invalid channel count")
        if self.channel_mapping == 0:
            if self.channels > 2:
                raise AudioFormatError("Opus: unsupported channel mapping")
            self.n_streams = 1
            self.n_coupled = self.channels - 1
            self.channel_map = list(range(self.channels))
        elif self.channel_mapping in (1, 2, 255):
            # multistream surround/ambisonic/custom (RFC 7845 §5.1.1;
            # dopus.d:1328-1361)
            if len(head) < 21 + self.channels:
                raise AudioFormatError("Opus: truncated channel mapping")
            if self.channel_mapping == 1 and self.channels > 8:
                raise AudioFormatError("Opus: mapping 1 supports <=8 ch")
            if self.channel_mapping == 2:
                # ambisonics: channel count must be (n+1)^2 for integer
                # n >= 0 (dopus.d:1348-1352)
                order = int(math.isqrt(self.channels)) - 1
                if self.channels != (order + 1) * (order + 1):
                    raise AudioFormatError(
                        "Opus: mapping 2 requires (n+1)^2 channels")
            self.n_streams = head[19]
            self.n_coupled = head[20]
            if (not self.n_streams or self.n_coupled > self.n_streams or
                    self.n_streams + self.n_coupled > 255):
                raise AudioFormatError("Opus: invalid stream counts")
            self.channel_map = list(head[21 : 21 + self.channels])
            for idx in self.channel_map:
                if idx != 255 and idx >= self.n_streams + self.n_coupled:
                    raise AudioFormatError("Opus: invalid channel map")
        else:
            raise AudioFormatError("Opus: unsupported channel mapping")
        pk = reader.next_packet()
        if pk is None or pk[0][:8] != b"OpusTags":
            raise AudioFormatError("Opus: missing OpusTags")
        self.r128_track_gain_q8 = _parse_r128_gain(pk[0])
        self._data_start = reader._pos

    def _start_stream(self) -> None:
        # verify_crc: the reference's Opus page reader rejects bad-CRC
        # pages (dopus.d:7080-7084)
        self._reader = ogg.OggPacketReader(self._view, self._serial,
                                           self._data_start,
                                           verify_crc=True)
        self._pos = 0  # position in output samples (post-preskip)
        self._to_skip = self.preskip
        self._buf = np.zeros((0, self.channels), np.float32)
        self._buf_start = 0
        if self.channel_mapping == 0:
            self._streams = [OpusStreamDecoder(self.channels,
                                               self._reference_resampler)]
        else:
            self._streams = [
                OpusStreamDecoder(2 if i < self.n_coupled else 1,
                                  self._reference_resampler)
                for i in range(self.n_streams)
            ]
        # combined playback gain: OpusHead output gain + R128 track gain
        # (dopus.d:1312-1316), applied as a scalar on decoded floats
        gain_i = max(-32768, min(32767,
                                 self.output_gain_q8 +
                                 self.r128_track_gain_q8))
        self._gain = 10.0 ** (gain_i / (20.0 * 256.0)) if gain_i else 1.0

    def _maybe_s16(self, pcm: np.ndarray) -> np.ndarray:
        """s16 parity mode (diff-testing vs the reference): the reference
        quantizes every Opus sample through s16 on output
        (dopus.d:8098-8105 via Float2IntScaled, then stream.d:480 divides
        by 32767.0f).  Full-float output is the default; setting
        ``s16_parity = True`` reproduces the reference's output grid
        exactly for A/B diffs."""
        if not self.s16_parity:
            return pcm
        return (float_to_s16_ref(pcm).astype(np.float32)
                / np.float32(32767.0))

    # -- frame decode ---------------------------------------------------------
    def _decode_packet(self, data: bytes) -> np.ndarray:
        if self.channel_mapping == 0:
            pk = parse_packet(data)
            if pk is None:
                raise AudioFormatError("Opus: corrupt packet")
            pcm = self._streams[0].decode_packet(pk)
            if self._gain != 1.0:
                pcm = pcm * np.float32(self._gain)
            return self._maybe_s16(pcm.astype(np.float32))
        # multistream (mapping families 1/2/255, dopus.d:6587-6712): the
        # packet concatenates one sub-packet per elementary stream, all but
        # the last with self-delimited framing
        buf = data
        outs = []
        coded = None
        for si in range(self.n_streams):
            pk = parse_packet(buf, self_delimited=(si != self.n_streams - 1))
            if pk is None:
                raise AudioFormatError("Opus: corrupt multistream packet")
            n = pk["frame_size"] * len(pk["frames"])
            if coded is None:
                coded = n
            elif n != coded:
                raise AudioFormatError(
                    "Opus: mismatching substream durations")
            outs.append(self._streams[si].decode_packet(pk))
            buf = buf[pk["pkt_size"]:]
        m = min(o.shape[0] for o in outs)
        pcm = np.zeros((m, self.channels), np.float32)
        for ch in range(self.channels):
            idx = self.channel_map[ch]
            if idx == 255:
                continue
            if idx < 2 * self.n_coupled:
                pcm[:, ch] = outs[idx // 2][:m, idx & 1]
            else:
                pcm[:, ch] = outs[idx - self.n_coupled][:m, 0]
        if self._gain != 1.0:
            pcm = pcm * np.float32(self._gain)
        return self._maybe_s16(pcm)

    # -- read / seek -----------------------------------------------------------
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        chunks = []
        got = 0
        while got < max_frames:
            avail = self._buf.shape[0] - self._buf_start
            if avail == 0:
                if self._pos >= self.length_frames:
                    break
                pk = self._reader.next_packet()
                if pk is None:
                    # drain the SILK resampler tails (+ hybrid CELT
                    # FIFOs) so the stream reaches its granule-declared
                    # length — EVERY substream, routed through the same
                    # channel map as _decode_packet (a 5.1 SILK file
                    # drains all streams, not stream 0 repeated)
                    drained = None
                    # the drain is bounded by what the resamplers
                    # actually OWE (delayed samples + hybrid FIFO), never
                    # by length_frames alone: that is the file's granule
                    # field, and a corrupt stream declaring 2^40 samples
                    # must neither allocate the remainder (MemoryError
                    # out of the public API) nor zero-fill forever under
                    # a read-until-empty consumer — it just ends early,
                    # like any other truncated stream
                    owed = max(
                        (max(sd._delayed, sd._celt_hyb_delay.shape[0])
                         for sd in self._streams
                         if sd._silk_rs is not None),
                        default=0)
                    want = min(self.length_frames - self._pos, owed)
                    if want > 0 and any(sd._silk_rs is not None
                                        for sd in self._streams):
                        outs = []
                        for sd in self._streams:
                            k = sd.channels
                            if sd._silk_rs is not None:
                                o = sd.drain_tail(want)
                                if o.shape[0] < want:
                                    o = np.pad(o, ((0, want - o.shape[0]),
                                                   (0, 0)))
                                outs.append(o)
                            else:
                                outs.append(np.zeros((want, k),
                                                     np.float32))
                        drained = np.zeros((want, self.channels),
                                           np.float32)
                        for ch in range(self.channels):
                            idx = self.channel_map[ch]
                            if idx == 255:
                                continue
                            if idx < 2 * self.n_coupled:
                                drained[:, ch] = outs[idx // 2][:, idx & 1]
                            else:
                                drained[:, ch] = \
                                    outs[idx - self.n_coupled][:, 0]
                    if drained is not None:
                        self._buf = self._maybe_s16(
                            drained * np.float32(self._gain))
                        self._buf_start = 0
                        continue
                    break
                pcm = self._decode_packet(pk[0])
                if self._to_skip:
                    skip = min(self._to_skip, pcm.shape[0])
                    pcm = pcm[skip:]
                    self._to_skip -= skip
                pcm = pcm[: max(0, self.length_frames - self._pos)]
                self._buf = pcm
                self._buf_start = 0
                avail = pcm.shape[0]
                if avail == 0:
                    continue
            take = min(avail, max_frames - got)
            chunks.append(self._buf[self._buf_start : self._buf_start + take])
            self._buf_start += take
            self._pos += take
            got += take
        if not chunks:
            return np.zeros((0, self.channels), dtype=dtype)
        return np.concatenate(chunks).astype(dtype)

    def tell(self) -> int:
        return self._pos

    def _collect_packets(self):
        """All audio packets (for the lockstep batch scheduler's
        pre-scan); leaves the streaming reader untouched."""
        reader = ogg.OggPacketReader(self._view, self._serial,
                                     self._data_start, verify_crc=True)
        pkts = []
        while True:
            pk = reader.next_packet()
            if pk is None:
                break
            pkts.append(pk[0])
        return pkts

    def seek(self, frame: int) -> bool:
        """Page-anchor bisection + decode-and-discard for sample accuracy
        (OggStream.seekPCM dopus.d:7458 + stream.d:1177-1188)."""
        if frame < 0 or frame > self.length_frames:
            return False
        target_granule = frame + self.preskip
        anchor = None
        for off, g in self._page_index:
            if off < self._data_start:
                continue
            if g <= target_granule:
                anchor = (off, g)
            else:
                break
        self._start_stream()
        if anchor is not None:
            self._reader.reset(
                ogg.parse_page(self._view, anchor[0]).body_offset
                + ogg.parse_page(self._view, anchor[0]).body_size
            )
            self._pos = anchor[1] - self.preskip
            self._to_skip = 0
            if self._pos < 0:
                self._to_skip = -self._pos
                self._pos = 0
        to_skip = frame - self._pos
        while to_skip > 0:
            pk = self._reader.next_packet()
            if pk is None:
                return self._pos == frame
            pcm = self._decode_packet(pk[0])
            if self._to_skip:
                s = min(self._to_skip, pcm.shape[0])
                pcm = pcm[s:]
                self._to_skip -= s
            take = min(to_skip, pcm.shape[0])
            if take < pcm.shape[0]:
                self._buf = np.ascontiguousarray(pcm[take:])
                self._buf_start = 0
            self._pos += take
            to_skip -= take
        return True


def _parse_r128_gain(tags: bytes) -> int:
    """R128_TRACK_GAIN from OpusTags (dopus.d:8011)."""
    try:
        pos = 8
        vendor_len = struct.unpack_from("<I", tags, pos)[0]
        pos += 4 + vendor_len
        count = struct.unpack_from("<I", tags, pos)[0]
        pos += 4
        for _ in range(count):
            ln = struct.unpack_from("<I", tags, pos)[0]
            pos += 4
            item = tags[pos : pos + ln]
            pos += ln
            if item.upper().startswith(b"R128_TRACK_GAIN="):
                return int(item.split(b"=", 1)[1])
    except (struct.error, ValueError, IndexError):
        pass
    return 0
