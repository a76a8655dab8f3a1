"""ProTracker MOD playback engine.

Parity target: pocketmod.d — format identification by tag table with the
15-instrument ASCII heuristic (pocketmod.d:724-811), the per-tick state
machine (line decode pocketmod.d:354-528, tick effects pocketmod.d:532-662),
full effect set (arpeggio, slides, vibrato/tremolo LFOs with waveform
select, offset, loops E6x, delays EDx/EEx, retrigger E9x, cut ECx, speed/BPM
Fxx, the nonstandard 8xx/E8x balance), ProTracker default panning, loop
detection via the visited-pattern bitmask (render stops after one full loop,
stream.d:610-612), nearest-sample mixing at 44.1 kHz stereo float
(pocketmod.d:664-721), and pattern/row seek + remaining-samples queries
(stream.d:912-1091).

Tracker playback is control-flow heavy and tiny in CPU cost (a handful of
channels), so it stays host-side on every device, as in the reference
(tracker playback is sequential); the per-tick channel mixing is
numpy-vectorized and tick-granular, making output independent of the
caller's read chunking.  The decoder takes the probe cascade's `device`
only so that asking for a CUDA device without one raises, as every other
decoder of the port does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..io.source import ByteSource
from ..device import device_of

MAX_CHANNELS = 32
PITCH, VOLUME = 1, 2

_TAGS = {
    b"M.K.": 4, b"M!K!": 4, b"FLT4": 4, b"4CHN": 4,
    b"OKTA": 8, b"OCTA": 8, b"CD81": 8, b"FA08": 8,
    b"1CHN": 1, b"2CHN": 2, b"3CHN": 3,
    b"5CHN": 5, b"6CHN": 6, b"7CHN": 7, b"8CHN": 8,
    b"9CHN": 9, b"10CH": 10, b"11CH": 11, b"12CH": 12,
    b"13CH": 13, b"14CH": 14, b"15CH": 15, b"16CH": 16,
    b"17CH": 17, b"18CH": 18, b"19CH": 19, b"20CH": 20,
    b"21CH": 21, b"22CH": 22, b"23CH": 23, b"24CH": 24,
    b"25CH": 25, b"26CH": 26, b"27CH": 27, b"28CH": 28,
    b"29CH": 29, b"30CH": 30, b"31CH": 31, b"32CH": 32,
}

_PERIODS = [856, 808, 762, 720, 678, 640, 604, 570, 538, 508, 480, 453,
            428, 404, 381, 360, 339, 320, 302, 285, 269, 254, 240, 226,
            214, 202, 190, 180, 170, 160, 151, 143, 135, 127, 120, 113]
_PERIOD_TO_NOTE = {p: i for i, p in enumerate(_PERIODS)}

# Finetune adjustment (pocketmod.d:134-151; ProTracker period tables)
_FINETUNE = np.array([
    [0]*36,
    [-6,-6,-5,-5,-4,-3,-3,-3,-3,-3,-3,-3,-3,-3,-2,-3,-2,-2,-2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,0],
    [-12,-12,-10,-11,-8,-8,-7,-7,-6,-6,-6,-6,-6,-6,-5,-5,-4,-4,-4,-3,-3,-3,-3,-2,-3,-3,-2,-3,-3,-2,-2,-2,-2,-2,-2,-1],
    [-18,-17,-16,-16,-13,-12,-12,-11,-10,-10,-10,-9,-9,-9,-8,-8,-7,-6,-6,-5,-5,-5,-5,-4,-5,-4,-3,-4,-4,-3,-3,-3,-3,-2,-2,-2],
    [-24,-23,-21,-21,-18,-17,-16,-15,-14,-13,-13,-12,-12,-12,-11,-10,-9,-8,-8,-7,-7,-7,-7,-6,-6,-6,-5,-5,-5,-4,-4,-4,-4,-3,-3,-3],
    [-30,-29,-26,-26,-23,-21,-20,-19,-18,-17,-17,-16,-15,-14,-13,-13,-11,-11,-10,-9,-9,-9,-8,-7,-8,-7,-6,-6,-6,-5,-5,-5,-5,-4,-4,-4],
    [-36,-34,-32,-31,-27,-26,-24,-23,-22,-21,-20,-19,-18,-17,-16,-15,-14,-13,-12,-11,-11,-10,-10,-9,-9,-9,-7,-8,-7,-6,-6,-6,-6,-5,-5,-4],
    [-42,-40,-37,-36,-32,-30,-29,-27,-25,-24,-23,-22,-21,-20,-18,-18,-16,-15,-14,-13,-13,-12,-12,-10,-10,-10,-9,-9,-9,-8,-7,-7,-7,-6,-6,-5],
    [51,48,46,42,42,38,36,34,32,30,24,27,25,24,23,21,21,19,18,17,16,15,14,14,12,12,12,10,10,10,9,8,8,8,7,7],
    [44,42,40,37,37,35,32,31,29,27,25,24,22,21,20,19,18,17,16,15,15,14,13,12,11,10,10,9,9,9,8,7,7,7,6,6],
    [38,36,34,32,31,30,28,27,25,24,22,21,19,18,17,16,16,15,14,13,13,12,11,11,9,9,9,8,7,7,7,6,6,6,5,5],
    [31,30,29,26,26,25,24,22,21,20,18,17,16,15,14,13,13,12,12,11,11,10,9,9,8,7,8,7,6,6,6,5,5,5,5,5],
    [25,24,23,21,21,20,19,18,17,16,14,14,13,12,11,10,11,10,10,9,9,8,7,7,6,6,6,5,5,5,5,4,4,4,3,4],
    [19,18,17,16,16,15,15,14,13,12,11,10,9,9,9,8,8,18,7,7,7,6,5,6,5,4,5,4,4,4,4,3,3,3,3,3],
    [12,12,12,10,11,11,10,10,9,8,7,7,6,6,6,5,6,5,5,5,5,4,4,4,3,3,3,3,2,3,3,2,2,2,2,2],
    [6,6,6,5,6,6,6,5,5,5,4,4,3,3,3,3,3,3,3,3,3,2,2,2,2,1,2,1,1,1,1,1,1,1,1,1],
], dtype=np.int32)

_SIN = np.array([0x00, 0x19, 0x32, 0x4A, 0x62, 0x78, 0x8E, 0xA2,
                 0xB4, 0xC5, 0xD4, 0xE0, 0xEC, 0xF4, 0xFA, 0xFE])

_ARPEGGIO = np.array([2.0 ** (x / 12.0) for x in range(16)], dtype=np.float32)


def _sin_osc(step: int) -> int:
    x = int(_SIN[step & 0x0F])
    x = x if (step & 0x1F) < 0x10 else 0xFF - x
    return x if step < 0x20 else -x


class _Channel:
    __slots__ = (
        "dirty", "sample", "volume", "balance", "period", "delayed",
        "target", "finetune", "loop_count", "loop_line", "lfo_step",
        "lfo_type", "effect", "param", "param3", "param4", "param7",
        "param9", "paramE1", "paramE2", "paramEA", "paramEB",
        "real_volume", "position", "increment",
    )

    def __init__(self):
        for s in self.__slots__:
            setattr(self, s, 0)
        self.lfo_type = [0, 0]
        self.position = 0.0
        self.increment = 0.0


def probe(src: ByteSource, device="cuda"):
    data = bytes(src.view())
    if len(data) < 600:
        return None
    if not _ident_ok(data):
        return None
    try:
        return ModDecoder(src, device)
    except AudioFormatError:
        return None


def _ident_ok(data: bytes) -> bool:
    if len(data) >= 1084 and data[1080:1084] in _TAGS:
        return True
    if len(data) < 600:
        return False
    for i in range(20):
        ch = data[i]
        if ch != 0 and (ch < 0x20 or ch > 0x7E):
            return False
    for i in range(15):
        for j in range(22):
            ch = data[20 + i * 30 + j]
            if ch != 0 and (ch < 0x20 or ch > 0x7E):
                return False
    return True


class ModDecoder:
    format = AudioFileFormat.mod
    sample_rate = 44100
    channels = 2
    length_frames = -1  # audiostreamUnknownLength (stream.d:1822)

    def __init__(self, src: ByteSource, device="cuda"):
        from ..config import DEFAULT_CODEC_CONFIG

        self.device = device_of(device)

        #: AF_LINEAR parity switch (pocketmod.d:694-700): linear-resampled
        #: mix instead of nearest; also settable per instance after probe
        self.linear_resampling = DEFAULT_CODEC_CONFIG.mod_linear_resampling
        data = bytes(src.view())
        self._data = data
        if len(data) >= 1084 and data[1080:1084] in _TAGS:
            self.num_channels = _TAGS[data[1080:1084]]
            self.length = data[950]
            self.reset = data[951]
            self._order_off = 952
            self._patterns_off = 1084
            self.num_samples = 31
        else:
            self.length = data[470]
            self.reset = data[471]
            self._order_off = 472
            self._patterns_off = 600
            self.num_samples = 15
            self.num_channels = 4
        if self.num_channels > MAX_CHANNELS:
            raise AudioFormatError("MOD: too many channels")
        if self.length == 0 or self.length > 128:
            raise AudioFormatError("MOD: invalid song length")
        if self.reset >= self.length:
            self.reset = 0
        order = data[self._order_off : self._order_off + 128]
        self.order = list(order)
        self.num_patterns = 0
        for i in range(128):
            if order[i] >= 128:
                break
            self.num_patterns = max(self.num_patterns, order[i])
        self.num_patterns += 1
        pattern_bytes = 256 * self.num_channels * self.num_patterns
        header_bytes = self._patterns_off
        for i in range(self.length):
            if header_bytes + 256 * self.num_channels * order[i] > len(data):
                raise AudioFormatError("MOD: pattern out of bounds")
        if header_bytes + pattern_bytes > len(data):
            raise AudioFormatError("MOD: truncated pattern data")

        # sample payloads (8-bit signed), truncated at EOF
        self._smeta = []  # (finetune, volume, loop_start, loop_len, length)
        self._sdata = []
        remaining = len(data) - header_bytes - pattern_bytes
        pos = header_bytes + pattern_bytes
        for i in range(self.num_samples):
            off = 20 + 30 * i + 22
            length = ((data[off] << 8) | data[off + 1]) << 1
            length = min(length if length > 2 else 0, max(0, remaining))
            self._sdata.append(
                np.frombuffer(data, dtype=np.int8, count=length, offset=pos)
                .astype(np.float32)
            )
            pos += length
            remaining -= length
        self._reset_playback()

    # -- playback state ------------------------------------------------------
    def _sample_meta(self, sample: int) -> bytes:
        return self._data[12 + 30 * sample : 12 + 30 * sample + 30]

    def _reset_playback(self) -> None:
        self.chans = [_Channel() for _ in range(self.num_channels)]
        for i, ch in enumerate(self.chans):
            ch.balance = 0x80 + (0x20 if ((i + 1) >> 1) & 1 else -0x20)
        self.ticks_per_line = 6
        self.samples_per_tick = self.sample_rate / 50.0
        self.lfo_rng = 0xBADC0DE
        self.pattern_delay = 0
        self.visited = np.zeros(128, dtype=bool)
        self.loop_count = 0
        self.pattern = 0
        self.line = -1
        self.tick = self.ticks_per_line - 1
        self.sample_in_tick = 0.0
        self._tick_buf = np.zeros((0, 2), np.float32)
        self._tick_pos = 0
        self._frames_told = 0
        self._next_tick()

    # -- line/tick state machine (pocketmod.d:354-662) ------------------------
    def _cell(self, pattern_order_idx: int, line: int, chan: int):
        pos = (self.order[pattern_order_idx] * 64 + line) * self.num_channels * 4
        d = self._data[self._patterns_off + pos + chan * 4 :][:4]
        sample = (d[0] & 0xF0) | (d[2] >> 4)
        period = ((d[0] & 0x0F) << 8) | d[1]
        effect = ((d[2] & 0x0F) << 8) | d[3]
        return sample, period, effect

    def _next_line(self) -> None:
        if self.line == 0:
            self.visited[self.pattern] = True
        self.line += 1
        if self.line == 64:
            self.pattern += 1
            if self.pattern == self.length:
                self.pattern = self.reset
            self.line = 0
        pattern_break = -1
        for i in range(self.num_channels):
            sample, period, effect = self._cell(self.pattern, self.line, i)
            ch = self.chans[i]
            ch.effect = (effect >> 8) if (effect >> 8) != 0xE else (effect >> 4)
            ch.param = (effect & 0xFF) if (effect >> 8) != 0xE else (effect & 0x0F)

            if sample:
                if sample <= self.num_samples:
                    meta = self._sample_meta(sample)
                    ch.sample = sample
                    ch.finetune = meta[2] & 0x0F
                    ch.volume = min(meta[3], 0x40)
                    if ch.effect != 0xED:
                        ch.dirty |= VOLUME
                else:
                    ch.sample = 0

            if period:
                note = _PERIOD_TO_NOTE.get(period, 0)
                period += int(_FINETUNE[ch.finetune][note])
                if ch.effect != 0x3:
                    if ch.effect != 0xED:
                        ch.period = period
                        ch.dirty |= PITCH
                        ch.position = 0.0
                        ch.lfo_step = 0
                    else:
                        ch.delayed = period

            e, p = ch.effect, ch.param
            if e == 0x3:
                ch.param3 = p or ch.param3
                if period:
                    ch.target = period
            elif e == 0x5:
                if period:
                    ch.target = period
            elif e == 0x4:
                ch.param4 = ((p & 0x0F) or (ch.param4 & 0x0F)) | \
                            ((p & 0xF0) or (ch.param4 & 0xF0))
            elif e == 0x7:
                ch.param7 = ((p & 0x0F) or (ch.param7 & 0x0F)) | \
                            ((p & 0xF0) or (ch.param7 & 0xF0))
            elif e == 0xE1:
                ch.paramE1 = p or ch.paramE1
            elif e == 0xE2:
                ch.paramE2 = p or ch.paramE2
            elif e == 0xEA:
                ch.paramEA = p or ch.paramEA
            elif e == 0xEB:
                ch.paramEB = p or ch.paramEB
            elif e == 0x8:
                ch.balance = p
            elif e == 0x9:
                if period != 0 or sample != 0:
                    ch.param9 = p or ch.param9
                    ch.position = float(ch.param9 << 8)
            elif e == 0xB:
                self.pattern = p if p < self.length else 0
                self.line = -1
            elif e == 0xC:
                ch.volume = max(0, min(0x40, p))
                ch.dirty |= VOLUME
            elif e == 0xD:
                pattern_break = (p >> 4) * 10 + (p & 15)
            elif e == 0xE4:
                ch.lfo_type[0] = p
            elif e == 0xE5:
                ch.finetune = p
                ch.dirty |= PITCH
            elif e == 0xE6:
                if p:
                    if not ch.loop_count:
                        ch.loop_count = p
                        self.line = ch.loop_line
                    else:
                        ch.loop_count -= 1
                        if ch.loop_count:
                            self.line = ch.loop_line
                else:
                    ch.loop_line = self.line - 1
            elif e == 0xE7:
                ch.lfo_type[1] = p
            elif e == 0xE8:
                ch.balance = (p << 4) & 0xFF
            elif e == 0xEE:
                self.pattern_delay = p
            elif e == 0xF:
                if p != 0:
                    if p < 0x20:
                        self.ticks_per_line = p
                    else:
                        self.samples_per_tick = self.sample_rate / (0.4 * p)

        if pattern_break != -1:
            self.line = (pattern_break if pattern_break < 64 else 0) - 1
            self.pattern += 1
            if self.pattern == self.length:
                self.pattern = self.reset

    def _lfo(self, ch: _Channel, step: int) -> int:
        t = ch.lfo_type[1 if ch.effect == 7 else 0] & 3
        if t == 0:
            return _sin_osc(step & 0x3F)
        if t == 1:
            return 0xFF - ((step & 0x3F) << 3)
        if t == 2:
            return 0xFF if (step & 0x3F) < 0x20 else -0xFF
        return (self.lfo_rng & 0x1FF) - 0xFF

    def _update_pitch(self, ch: _Channel) -> None:
        ch.increment = 0.0
        if ch.period:
            period = float(ch.period)
            if ch.effect in (0x4, 0x6):
                step = (ch.param4 >> 4) * ch.lfo_step
                rate = ch.param4 & 0x0F
                period += self._lfo(ch, step) * rate / 128.0
            elif ch.effect == 0x0 and ch.param:
                step = (ch.param >> ((2 - self.tick % 3) << 2)) & 0x0F
                period /= float(_ARPEGGIO[step])
            ch.increment = 3546894.6 / (period * self.sample_rate)
        ch.dirty &= ~PITCH

    def _update_volume(self, ch: _Channel) -> None:
        volume = ch.volume
        if ch.effect == 0x7:
            step = ch.lfo_step * (ch.param7 >> 4)
            volume += (self._lfo(ch, step) * (ch.param7 & 0x0F)) >> 6
        ch.real_volume = max(0, min(0x40, volume))
        ch.dirty &= ~VOLUME

    def _pitch_slide(self, ch: _Channel, amount: int) -> None:
        mx = 856 + int(_FINETUNE[ch.finetune][0])
        mn = 113 + int(_FINETUNE[ch.finetune][35])
        ch.period = min(max(ch.period + amount, mn), mx)
        ch.dirty |= PITCH

    def _volume_slide(self, ch: _Channel, param: int) -> None:
        change = (param >> 4) if (param & 0xF0) else -(param & 0x0F)
        ch.volume = max(0, min(0x40, ch.volume + change))
        ch.dirty |= VOLUME

    def _next_tick(self) -> None:
        self.tick += 1
        if self.tick == self.ticks_per_line:
            if self.pattern_delay > 0:
                self.pattern_delay -= 1
            else:
                self._next_line()
            self.tick = 0
        for ch in self.chans:
            param = ch.param
            self.lfo_rng = (0x0019660D * self.lfo_rng + 0x3C6EF35F) & 0xFFFFFFFF
            e = ch.effect
            if e == 0x0:
                ch.dirty |= PITCH
            elif e == 0xE9:
                if not (param and self.tick % param):
                    ch.position = 0.0
                    ch.lfo_step = 0
            elif e == 0xEC:
                if self.tick == param:
                    ch.volume = 0
                    ch.dirty |= VOLUME
            elif e == 0xED:
                if self.tick == param and ch.sample:
                    ch.dirty |= VOLUME | PITCH
                    ch.period = ch.delayed
                    ch.position = 0.0
                    ch.lfo_step = 0
            if self.tick == 0:
                if e == 0xE1:
                    self._pitch_slide(ch, -ch.paramE1)
                elif e == 0xE2:
                    self._pitch_slide(ch, ch.paramE2)
                elif e == 0xEA:
                    self._volume_slide(ch, ch.paramEA << 4)
                elif e == 0xEB:
                    self._volume_slide(ch, ch.paramEB & 15)
            else:
                if e == 0x1:
                    self._pitch_slide(ch, -param)
                elif e == 0x2:
                    self._pitch_slide(ch, param)
                elif e in (0x5, 0x3):
                    if e == 0x5:
                        self._volume_slide(ch, param)
                    rate = ch.param3
                    order = ch.period < ch.target
                    closer = ch.period + (rate if order else -rate)
                    new_order = closer < ch.target
                    ch.period = closer if new_order == order else ch.target
                    ch.dirty |= PITCH
                elif e in (0x6, 0x4):
                    if e == 0x6:
                        self._volume_slide(ch, param)
                    ch.lfo_step += 1
                    ch.dirty |= PITCH
                elif e == 0x7:
                    ch.lfo_step += 1
                    ch.dirty |= VOLUME
                elif e == 0xA:
                    self._volume_slide(ch, param)
            if ch.dirty & VOLUME:
                self._update_volume(ch)
            if ch.dirty & PITCH:
                self._update_pitch(ch)

    # -- mixing (pocketmod.d:664-721, numpy-vectorized) -----------------------
    def _render_channel(self, ch: _Channel, out: np.ndarray, num: int) -> None:
        meta = self._sample_meta(ch.sample)
        sdata = self._sdata[ch.sample - 1]
        loop_start = ((meta[4] << 8) | meta[5]) << 1
        loop_length = ((meta[6] << 8) | meta[7]) << 1
        loop_end = loop_start + loop_length if loop_length > 2 else 0xFFFFFF
        sample_end = 1 + min(loop_end, len(sdata))

        volume = ch.real_volume / float(128 * 64 * 4)
        level_l = volume * (1.0 - ch.balance / 255.0)
        level_r = volume * (ch.balance / 255.0)

        # faithful do/while structure (pocketmod.d:691-719)
        written = 0
        remaining = num
        if ch.increment <= 0 or len(sdata) == 0:
            # zero-length sample (possible in corrupt files): silence —
            # pocketmod's sample_end arithmetic never reads data either
            return
        while True:
            n = int((sample_end - ch.position) / ch.increment)
            n = min(n, remaining)
            if n > 0:
                pos = ch.position + ch.increment * np.arange(n)
                x0 = np.clip(pos.astype(np.int64), 0, len(sdata) - 1)
                if self.linear_resampling:
                    # AF_LINEAR (pocketmod.d:694-698): x1 wraps to the
                    # loop start one sample early
                    t = pos - x0
                    x1 = x0 + 1 - (loop_length
                                   * ((x0 + 1) >= loop_end).astype(np.int64))
                    x1 = np.clip(x1, 0, len(sdata) - 1)
                    s = (1.0 - t) * sdata[x0] + t * sdata[x1]
                else:
                    s = sdata[x0]
                out[written : written + n, 0] += level_l * s
                out[written : written + n, 1] += level_r * s
                ch.position += ch.increment * n
                written += n
            if ch.position >= loop_end:
                ch.position -= loop_length
            elif ch.position >= len(sdata):
                ch.position = -1.0
                break
            remaining -= n
            if n <= 0:
                break

    def _render_tick_chunk(self) -> np.ndarray:
        """Render until the next tick boundary (or pattern stop)."""
        num = int(self.samples_per_tick - self.sample_in_tick)
        num += num == 0  # at least one sample per chunk (pocketmod.d:917)
        out = np.zeros((num, 2), dtype=np.float32)
        for ch in self.chans:
            if ch.sample != 0 and ch.position >= 0.0:
                self._render_channel(ch, out, num)
        self.sample_in_tick += num
        if self.sample_in_tick >= self.samples_per_tick:
            self.sample_in_tick -= self.samples_per_tick
            self._next_tick()
            if self.line == 0 and self.tick == 0:
                if self.visited[self.pattern]:
                    self.visited[:] = False
                    self.loop_count += 1
        return out

    # ------------------------------------------------------------------ API
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        chunks = []
        got = 0
        while got < max_frames:
            avail = self._tick_buf.shape[0] - self._tick_pos
            if avail == 0:
                if self.loop_count >= 1:
                    break  # stream.d:610-612: stop after one loop
                self._tick_buf = self._render_tick_chunk()
                self._tick_pos = 0
                avail = self._tick_buf.shape[0]
                if avail == 0:
                    break
            take = min(avail, max_frames - got)
            chunks.append(self._tick_buf[self._tick_pos : self._tick_pos + take])
            self._tick_pos += take
            got += take
        self._frames_told += got
        if not chunks:
            return np.zeros((0, 2), dtype=dtype)
        return np.concatenate(chunks).astype(dtype)

    # -- module API (stream.d:912-1091) ---------------------------------------
    def count_patterns(self) -> int:
        return self.num_patterns

    def module_length(self) -> int:
        return self.length

    def rows_in_pattern(self, pattern: int) -> int:
        return 64  # stream.d:973-976

    def tell_pattern(self) -> int:
        return self.pattern

    def tell_row(self) -> int:
        return self.line

    def frames_remaining_in_pattern(self) -> int:
        """pocketmod_count_remaining_samples (pocketmod.d:294-352)."""
        result = 0
        ticks_per_line = self.ticks_per_line
        samples_per_tick = self.samples_per_tick
        for line in range(max(self.line, 0), 64):
            brk = False
            for i in range(self.num_channels):
                _s, _p, effect = self._cell(self.pattern, line, i)
                eff = (effect >> 8) if (effect >> 8) != 0xE else (effect >> 4)
                par = (effect & 0xFF) if (effect >> 8) != 0xE else (effect & 0x0F)
                if eff == 0xD:
                    return result + int(ticks_per_line * samples_per_tick)
                if eff == 0xF and par:
                    if par < 0x20:
                        ticks_per_line = par
                    else:
                        samples_per_tick = self.sample_rate / (0.4 * par)
            result += int(ticks_per_line * samples_per_tick)
        return result

    def seek_pattern(self, pattern: int, row: int) -> bool:
        # pocketmod_seek (pocketmod.d:954-962)
        self.line = row
        self.pattern = pattern
        self.tick = 0
        self.sample_in_tick = 0.0
        self._tick_buf = np.zeros((0, 2), np.float32)
        self._tick_pos = 0
        self._frames_told = 0
        return True

    def tell(self) -> int:
        # the reference ASSERTS !isModule() here (stream.d:1209:
        # "seeking doesn't have the same meaning with modules");
        # we return frames emitted since open / last seek_pattern
        # instead -- a strict superset of that contract
        return self._frames_told
