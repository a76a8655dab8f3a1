"""FastTracker II XM playback engine.

Parity target: libxm.d — module/pattern/instrument/sample loading with
delta-coded 8/16-bit samples (libxm.d:400-930), linear & Amiga frequency
tables (libxm.d:1345-1410), volume/panning envelopes with sustain/loop and
fadeout (libxm.d:1968-2035), autovibrato, the per-tick effect engine
(libxm.d:2036-2315: arpeggio with FT2 tempo%3 quirk, portamentos, tone
portamento, vibrato/tremolo with waveform control, volume/panning slides,
offset, jumps/breaks, pattern loop E6y with the FT2 E60 bug, retrigger,
note cut/delay, tremor, multi-retrig, global volume, Kxx key off, extra-fine
portamento), the volume column, sample mixing with loop/ping-pong and
volume ramping (XM_RAMPING, libxm.d:2317-2475), row-loop-count based loop
detection, and the module API incl. pattern/row seek (libxm.d:951-1071).

Playback renders 44.1 kHz stereo float with amplification 0.25 and sample
ramping, matching the reference's build options (XM_RAMPING on, linear
interpolation off, libxm.d:46-51).  It runs on the host on every device, as
in the reference (tracker playback is sequential); the decoder takes the
probe cascade's `device` only so that asking for a CUDA device without one
raises, as every other decoder of the port does.

Effect coverage enumeration vs libxm (xm_handle_note_and_instrument,
libxm.d:1465+, and xm_tick) — every effect the reference implements is
implemented here:

  0 arpeggio · 1/2 porta up/down · 3 tone porta · 4 vibrato · 5/6 porta/
  vibrato + vol slide · 7 tremolo · 8 set pan · 9 sample offset ·
  A vol slide · B position jump · C set volume · D pattern break ·
  E1/E2 fine porta · E4 vibrato ctl · E5 finetune · E6 pattern loop (FT2
  E60 bug) · E7 tremolo ctl · E9 retrig · EA/EB fine vol slides ·
  EC note cut · ED note delay · EE pattern delay · F tempo/BPM ·
  G global vol · H gvol slide · K key off · L set envelope pos ·
  P pan slide · R multi retrig · T tremor · X1/X2 extra-fine porta ·
  volume column 1-5/6/7/8/9/A/B/C/D/E/F (incl. tick-time slides).

Effects the reference does NOT implement (and neither does this engine,
by parity): E3 glissando control, E8 (FT2 set-panning variant), W (sync).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..io.source import ByteSource
from ..device import device_of

NUM_NOTES = 96
MAX_NUM_ROWS = 256
RAMP_POINTS = 0x20
AMIGA = [1712, 1616, 1525, 1440, 1357, 1281, 1209, 1141, 1077, 1017, 961,
         907, 856]
AMIGA_SCALE = 1024

MULTI_RETRIG_ADD = [0.0, -1.0, -2.0, -4.0, -8.0, -16.0, 0.0, 0.0,
                    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 0.0, 0.0]
MULTI_RETRIG_MUL = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2/3, 0.5,
                    1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 2.0]

KEEP_VOLUME, KEEP_PERIOD, KEEP_POSITION, KEEP_ENVELOPE = 1, 2, 4, 8


class _Env:
    __slots__ = ("points", "n", "sustain", "loop_start", "loop_end",
                 "enabled", "sustain_on", "loop_on")

    def __init__(self):
        self.points = []
        self.n = 0
        self.enabled = False
        self.sustain_on = False
        self.loop_on = False
        self.sustain = 0
        self.loop_start = 0
        self.loop_end = 0


class _Sample:
    __slots__ = ("data", "loop_start", "loop_length", "loop_end", "volume",
                 "finetune", "loop_type", "panning", "relative_note", "bits")


class _Instrument:
    __slots__ = ("samples", "sample_of_notes", "vol_env", "pan_env",
                 "vibrato_type", "vibrato_sweep", "vibrato_depth",
                 "vibrato_rate", "fadeout")


class _Slot:
    __slots__ = ("note", "instrument", "volume_column", "effect_type",
                 "effect_param")

    def __init__(self):
        self.note = 0
        self.instrument = 0
        self.volume_column = 0
        self.effect_type = 0
        self.effect_param = 0

    def has_tone_portamento(self):
        return self.effect_type == 3 or self.effect_type == 5 or \
            (self.volume_column >> 4) == 0xF

    def has_arpeggio(self):
        return self.effect_param > 0 and self.effect_type == 0

    def has_vibrato(self):
        return self.effect_type == 4 or self.effect_type == 6 or \
            (self.volume_column >> 4) == 0xB


class _Chan:
    def __init__(self):
        self.instrument: Optional[_Instrument] = None
        self.sample: Optional[_Sample] = None
        self.current: _Slot = _Slot()
        self.note = 0.0
        self.orig_note = 0.0
        self.period = 0.0
        self.frequency = 0.0
        self.step = 0.0
        self.sample_position = -1.0
        self.ping = True
        self.volume = 1.0
        self.panning = 0.5
        self.sustained = True
        self.fadeout_volume = 1.0
        self.volume_envelope_volume = 1.0
        self.panning_envelope_panning = 0.5
        self.volume_envelope_frame_count = 0
        self.panning_envelope_frame_count = 0
        self.autovibrato_ticks = 0
        self.autovibrato_note_offset = 0.0
        self.vibrato_in_progress = False
        self.vibrato_waveform = 0
        self.vibrato_waveform_retrigger = True
        self.vibrato_param = 0
        self.vibrato_ticks = 0
        self.vibrato_note_offset = 0.0
        self.tremolo_param = 0
        self.tremolo_ticks = 0
        self.tremolo_volume = 0.0
        self.tremolo_waveform = 0
        self.tremolo_waveform_retrigger = True
        self.tremor_param = 0
        self.tremor_on = False
        self.arp_in_progress = False
        self.arp_note_offset = 0
        self.note_delay_param = 0
        self.pattern_loop_origin = 0
        self.pattern_loop_count = 0
        self.volume_slide_param = 0
        self.fine_volume_slide_param = 0
        self.global_volume_slide_param = 0
        self.panning_slide_param = 0
        self.portamento_up_param = 0
        self.portamento_down_param = 0
        self.fine_portamento_up_param = 0
        self.fine_portamento_down_param = 0
        self.extra_fine_portamento_up_param = 0
        self.extra_fine_portamento_down_param = 0
        self.tone_portamento_param = 0
        self.tone_portamento_target_period = 0.0
        self.multi_retrig_param = 0
        self.actual_volume = [0.0, 0.0]
        self.target_volume = [0.0, 0.0]
        self.frame_count = 0
        self.end_of_previous_sample = np.zeros(RAMP_POINTS, np.float32)


def probe(src: ByteSource, device="cuda"):
    head = bytes(src.peek(60))
    if len(head) < 60 or head[:17] != b"Extended Module: ":
        return None
    try:
        return XmDecoder(src, device)
    except AudioFormatError:
        return None


class XmDecoder:
    format = AudioFileFormat.xm
    sample_rate = 44100
    channels = 2
    length_frames = -1  # unknown (stream.d:1785)

    def __init__(self, src: ByteSource, device="cuda"):
        from ..config import DEFAULT_CODEC_CONFIG

        self.device = device_of(device)

        #: XM_LINEAR_INTERPOLATION parity switch (libxm.d:50): the
        #: reference distribution ships it OFF; also settable per instance
        self.linear_interpolation = \
            DEFAULT_CODEC_CONFIG.xm_linear_interpolation
        self._load(bytes(src.view()))
        self.rate = 44100
        self.max_loop_count = 1  # stream.d:1781
        self._reset_playback()

    # ------------------------------------------------------------- loading
    def _load(self, d: bytes) -> None:
        if len(d) < 336 or d[:17] != b"Extended Module: " or d[37] != 0x1A:
            raise AudioFormatError("Not an XM module")
        off = 60
        header_size = int.from_bytes(d[off : off + 4], "little")
        self.song_length = int.from_bytes(d[off + 4 : off + 6], "little")
        self.restart_position = int.from_bytes(d[off + 6 : off + 8], "little")
        self.num_channels = int.from_bytes(d[off + 8 : off + 10], "little")
        num_patterns = int.from_bytes(d[off + 10 : off + 12], "little")
        num_instruments = int.from_bytes(d[off + 12 : off + 14], "little")
        flags = int.from_bytes(d[off + 14 : off + 16], "little")
        self.linear = bool(flags & 1)
        self.default_tempo = int.from_bytes(d[off + 16 : off + 18], "little")
        self.default_bpm = int.from_bytes(d[off + 18 : off + 20], "little")
        self.pattern_table = list(d[off + 20 : off + 20 + 256])
        if (self.num_channels == 0 or self.num_channels > 32
                or self.song_length == 0 or self.song_length > 256):
            raise AudioFormatError("XM: bad header")
        if self.restart_position >= self.song_length:
            self.restart_position = 0

        off += header_size
        self.patterns: List[List[List[_Slot]]] = []
        for _ in range(num_patterns):
            ph_len = int.from_bytes(d[off : off + 4], "little")
            num_rows = int.from_bytes(d[off + 5 : off + 7], "little")
            packed = int.from_bytes(d[off + 7 : off + 9], "little")
            num_rows = max(1, min(num_rows, MAX_NUM_ROWS))
            off += ph_len
            if ph_len < 9 or off + packed > len(d):
                # truncated/corrupt pattern data must become the sticky
                # error, not an IndexError (fuzz finding)
                raise AudioFormatError("XM: corrupt pattern data")
            pat = [[_Slot() for _ in range(self.num_channels)]
                   for _ in range(num_rows)]
            if packed:
                p = off
                for r in range(num_rows):
                    for c in range(self.num_channels):
                        if p >= off + packed:
                            break
                        s = pat[r][c]
                        b = d[p]
                        p += 1
                        if b & 0x80:
                            if b & 1:
                                s.note = d[p]; p += 1
                            if b & 2:
                                s.instrument = d[p]; p += 1
                            if b & 4:
                                s.volume_column = d[p]; p += 1
                            if b & 8:
                                s.effect_type = d[p]; p += 1
                            if b & 16:
                                s.effect_param = d[p]; p += 1
                        else:
                            s.note = b
                            s.instrument = d[p]
                            s.volume_column = d[p + 1]
                            s.effect_type = d[p + 2]
                            s.effect_param = d[p + 3]
                            p += 4
                off += packed
            self.patterns.append(pat)
        if num_patterns == 0:
            raise AudioFormatError("XM: no patterns")
        for t in self.pattern_table[: self.song_length]:
            if t >= num_patterns:
                raise AudioFormatError("XM: invalid pattern order table")

        self.instruments: List[_Instrument] = []
        for _ in range(num_instruments):
            ins = _Instrument()
            ins.samples = []
            ins.sample_of_notes = [0] * NUM_NOTES
            ins.vol_env = _Env()
            ins.pan_env = _Env()
            ins.vibrato_type = 0
            ins.vibrato_sweep = 0
            ins.vibrato_depth = 0
            ins.vibrato_rate = 0
            ins.fadeout = 0
            ins_size = int.from_bytes(d[off : off + 4], "little")
            if ins_size == 0 or ins_size > 263:
                ins_size = 263
            if off + 29 > len(d):
                raise AudioFormatError("XM: truncated instrument header")
            num_samples = int.from_bytes(d[off + 27 : off + 29], "little")
            if num_samples > 0:
                if off + 241 > len(d):
                    raise AudioFormatError(
                        "XM: truncated instrument header")
                ins.sample_of_notes = list(d[off + 33 : off + 33 + 96])
                for env, base in ((ins.vol_env, off + 129),
                                  (ins.pan_env, off + 177)):
                    env.points = []
                    for k in range(12):
                        frame = int.from_bytes(
                            d[base + 4 * k : base + 4 * k + 2], "little")
                        value = int.from_bytes(
                            d[base + 4 * k + 2 : base + 4 * k + 4], "little")
                        # spec range is 0..64; the reference keeps raw
                        # u16 values and feeds value/64 into sqrt-pan
                        # panning math, which goes NaN for corrupt data
                        # (libxm.d:2026-2031) — clamp instead (fuzz
                        # finding)
                        env.points.append((frame, min(value, 64)))
                # num_points is clamped to the 12-slot array like the
                # reference (libxm.d:720-725); the sustain/loop indices
                # are raw u8 there and index the fixed array unchecked
                # (UB for >=12 in a release build, libxm.d:1987-2008) —
                # clamp them instead of replicating the out-of-bounds
                # read (fuzz finding)
                ins.vol_env.n = min(d[off + 225], 12)
                ins.pan_env.n = min(d[off + 226], 12)
                ins.vol_env.sustain = min(d[off + 227], 11)
                ins.vol_env.loop_start = min(d[off + 228], 11)
                ins.vol_env.loop_end = min(d[off + 229], 11)
                ins.pan_env.sustain = min(d[off + 230], 11)
                ins.pan_env.loop_start = min(d[off + 231], 11)
                ins.pan_env.loop_end = min(d[off + 232], 11)
                vt, pt = d[off + 233], d[off + 234]
                ins.vol_env.enabled = bool(vt & 1)
                ins.vol_env.sustain_on = bool(vt & 2)
                ins.vol_env.loop_on = bool(vt & 4)
                ins.pan_env.enabled = bool(pt & 1)
                ins.pan_env.sustain_on = bool(pt & 2)
                ins.pan_env.loop_on = bool(pt & 4)
                ins.vibrato_type = d[off + 235]
                ins.vibrato_sweep = d[off + 236]
                ins.vibrato_depth = d[off + 237]
                ins.vibrato_rate = d[off + 238]
                ins.fadeout = int.from_bytes(d[off + 239 : off + 241],
                                             "little")
            off += ins_size
            # sample headers, then payloads
            headers = []
            for _s in range(num_samples):
                if off + 17 > len(d):
                    raise AudioFormatError("XM: truncated sample header")
                length = int.from_bytes(d[off : off + 4], "little")
                loop_start = int.from_bytes(d[off + 4 : off + 8], "little")
                loop_len = int.from_bytes(d[off + 8 : off + 12], "little")
                volume = d[off + 12]
                finetune = int.from_bytes(d[off + 13 : off + 14], "little",
                                          signed=True)
                stype = d[off + 14]
                panning = d[off + 15]
                rel = int.from_bytes(d[off + 16 : off + 17], "little",
                                     signed=True)
                headers.append((length, loop_start, loop_len, volume,
                                finetune, stype, panning, rel))
                off += 40
            for (length, loop_start, loop_len, volume, finetune, stype,
                 panning, rel) in headers:
                smp = _Sample()
                bits = 16 if stype & 0x10 else 8
                smp.bits = bits
                # tolerate truncated sample data (common in the wild;
                # load what's there)
                roff = min(off, len(d))
                avail = len(d) - roff
                if bits == 16:
                    n = min(length, avail) // 2
                    raw = np.frombuffer(d, dtype="<i2", count=n,
                                        offset=roff).astype(np.int32)
                    data = np.cumsum(raw).astype(np.int16)
                    smp.data = data.astype(np.float32) / 32768.0
                    smp.loop_start = loop_start // 2
                    smp.loop_length = loop_len // 2
                    off += length
                else:
                    raw = np.frombuffer(d, dtype=np.int8,
                                        count=min(length, avail),
                                        offset=roff).astype(np.int32)
                    data = np.cumsum(raw).astype(np.int8)
                    smp.data = data.astype(np.float32) / 128.0
                    smp.loop_start = loop_start
                    smp.loop_length = loop_len
                    off += length
                smp.loop_end = smp.loop_start + smp.loop_length
                smp.volume = min(volume, 0x40) / 64.0
                smp.finetune = finetune
                smp.loop_type = stype & 3
                if smp.loop_length == 0:
                    smp.loop_type = 0
                smp.panning = panning / 255.0
                smp.relative_note = rel
                ins.samples.append(smp)
            self.instruments.append(ins)

    # ------------------------------------------------------------- playback
    def _reset_playback(self) -> None:
        self.chans = [_Chan() for _ in range(self.num_channels)]
        self.current_table_index = 0
        self.current_row = 0
        self.current_tick = 0
        self.extra_ticks = 0
        self.remaining_samples_in_tick = 0.0
        self.tempo = self.default_tempo
        self.bpm = self.default_bpm
        self.global_volume = 1.0
        self.amplification = 0.25
        self.volume_ramp = 1.0 / 128.0
        self.next_rand = 24492
        self.position_jump = False
        self.pattern_break = False
        self.jump_dest = 0
        self.jump_row = 0
        self.loop_count = 0
        self._frames_told = 0
        self.row_loop_count = np.zeros(
            (256, MAX_NUM_ROWS), dtype=np.int32
        )
        self.generated_samples = 0
        self._buf = np.zeros((0, 2), np.float32)
        self._buf_pos = 0

    # frequency math (libxm.d:1345-1460)
    def _period(self, note: float) -> float:
        if self.linear:
            return 7680.0 - note * 64.0
        intnote = int(note)
        a = intnote % 12
        octave = int(note / 12.0) - 2
        p1, p2 = AMIGA[a] * AMIGA_SCALE, AMIGA[a + 1] * AMIGA_SCALE
        if octave > 0:
            p1 >>= octave
            p2 >>= octave
        elif octave < 0:
            p1 <<= -octave
            p2 <<= -octave
        t = note - intnote
        return (p1 + t * (p2 - p1)) / AMIGA_SCALE

    def _frequency(self, period: float, note_off: float,
                   period_off: float) -> float:
        if self.linear:
            p = period - 64.0 * note_off - 16.0 * period_off
            return 8363.0 * 2.0 ** ((4608.0 - p) / 768.0)
        if note_off == 0:
            if period + 16.0 * period_off == 0:
                return 0.0
            return 7093789.2 / ((period + 16.0 * period_off) * 2.0)
        # find nearest note for the current period (libxm.d:1410-1448)
        a = octave = 0
        period_s = period * AMIGA_SCALE
        if period_s > AMIGA[0] * AMIGA_SCALE:
            octave = -1
            while period_s > (AMIGA[0] * AMIGA_SCALE << -octave):
                octave -= 1
        elif period_s < AMIGA[12] * AMIGA_SCALE:
            octave = 1
            while period_s < (AMIGA[12] * AMIGA_SCALE >> octave):
                octave += 1
        p1 = p2 = 0
        for i in range(12):
            p1, p2 = AMIGA[i] * AMIGA_SCALE, AMIGA[i + 1] * AMIGA_SCALE
            if octave > 0:
                p1 >>= octave
                p2 >>= octave
            elif octave < 0:
                p1 <<= -octave
                p2 <<= -octave
            if p2 <= period_s <= p1:
                a = i
                break
        note = 12.0 * (octave + 2) + a + (period_s - p1) / (p2 - p1)
        return self._amiga_frequency(
            self._period(note + note_off) + 16.0 * period_off
        )

    @staticmethod
    def _amiga_frequency(period: float) -> float:
        return 0.0 if period == 0 else 7093789.2 / (period * 2.0)

    def _update_frequency(self, ch: _Chan) -> None:
        ch.frequency = self._frequency(
            ch.period, ch.arp_note_offset,
            ch.vibrato_note_offset + ch.autovibrato_note_offset,
        )
        ch.step = ch.frequency / self.rate

    def _waveform(self, wf: int, step: int) -> float:
        step %= 0x40
        if wf == 0:
            return -math.sin(2.0 * math.pi * step / 64.0)
        if wf == 1:
            return (0x20 - step) / 32.0
        if wf == 2:
            return 1.0 if step >= 0x20 else -1.0
        if wf == 3:
            self.next_rand = (self.next_rand * 1103515245 + 12345) & 0xFFFFFFFF
            return ((self.next_rand >> 16) & 0x7FFF) / 16384.0 - 1.0
        if wf == 4:
            return (step - 0x20) / 32.0
        return 0.0

    # -- note / trigger ------------------------------------------------------
    def _trigger_note(self, ch: _Chan, flags: int) -> None:
        if not flags & KEEP_POSITION:
            ch.sample_position = 0.0
            ch.ping = True
        if ch.sample is not None:
            if not flags & KEEP_VOLUME:
                ch.volume = ch.sample.volume
            ch.panning = ch.sample.panning
        if not flags & KEEP_ENVELOPE:
            ch.sustained = True
            ch.fadeout_volume = ch.volume_envelope_volume = 1.0
            ch.panning_envelope_panning = 0.5
            ch.volume_envelope_frame_count = 0
            ch.panning_envelope_frame_count = 0
        ch.vibrato_note_offset = 0.0
        ch.tremolo_volume = 0.0
        ch.tremor_on = False
        ch.autovibrato_ticks = 0
        if ch.vibrato_waveform_retrigger:
            ch.vibrato_ticks = 0
        if ch.tremolo_waveform_retrigger:
            ch.tremolo_ticks = 0
        if not flags & KEEP_PERIOD:
            ch.period = self._period(ch.note)
            self._update_frequency(ch)

    @staticmethod
    def _cut_note(ch: _Chan) -> None:
        ch.volume = 0.0

    def _key_off(self, ch: _Chan) -> None:
        ch.sustained = False
        if ch.instrument is None or not ch.instrument.vol_env.enabled:
            self._cut_note(ch)

    def _pitch_slide(self, ch: _Chan, period_offset: float) -> None:
        if self.linear:
            period_offset *= 4.0
        ch.period = max(0.0, ch.period + period_offset)
        self._update_frequency(ch)

    @staticmethod
    def _volume_slide(ch: _Chan, rawval: int) -> None:
        if (rawval & 0xF0) and (rawval & 0x0F):
            return
        if rawval & 0xF0:
            ch.volume = min(1.0, ch.volume + (rawval >> 4) / 64.0)
        else:
            ch.volume = max(0.0, ch.volume - (rawval & 0x0F) / 64.0)

    @staticmethod
    def _panning_slide(ch: _Chan, rawval: int) -> None:
        if (rawval & 0xF0) and (rawval & 0x0F):
            return
        if rawval & 0xF0:
            ch.panning = min(1.0, ch.panning + (rawval >> 4) / 255.0)
        else:
            ch.panning = max(0.0, ch.panning - (rawval & 0x0F) / 255.0)

    def _tone_portamento(self, ch: _Chan) -> None:
        if ch.tone_portamento_target_period == 0.0:
            return
        if ch.period != ch.tone_portamento_target_period:
            incr = (4.0 if self.linear else 1.0) * ch.tone_portamento_param
            goal = ch.tone_portamento_target_period
            if ch.period > goal:
                ch.period = max(goal, ch.period - incr)
            else:
                ch.period = min(goal, ch.period + incr)
            self._update_frequency(ch)

    def _vibrato(self, ch: _Chan, param: int) -> None:
        ch.vibrato_ticks += param >> 4
        ch.vibrato_note_offset = (
            -2.0 * self._waveform(ch.vibrato_waveform, ch.vibrato_ticks)
            * (param & 0x0F) / 15.0
        )
        self._update_frequency(ch)

    def _tremolo(self, ch: _Chan, param: int, pos: int) -> None:
        step = pos * (param >> 4)
        ch.tremolo_volume = (
            -1.0 * self._waveform(ch.tremolo_waveform, step)
            * (param & 0x0F) / 15.0
        )

    def _arpeggio(self, ch: _Chan, param: int, tick: int) -> None:
        m = tick % 3
        if m == 0:
            ch.arp_in_progress = False
            ch.arp_note_offset = 0
        elif m == 2:
            ch.arp_in_progress = True
            ch.arp_note_offset = param >> 4
        else:
            ch.arp_in_progress = True
            ch.arp_note_offset = param & 0x0F
        self._update_frequency(ch)

    def _autovibrato(self, ch: _Chan) -> None:
        if ch.instrument is None or ch.instrument.vibrato_depth == 0:
            if ch.autovibrato_note_offset:
                ch.autovibrato_note_offset = 0.0
                self._update_frequency(ch)
            return
        instr = ch.instrument
        sweep = 1.0
        if ch.autovibrato_ticks < instr.vibrato_sweep:
            sweep = ch.autovibrato_ticks / instr.vibrato_sweep
        step = (ch.autovibrato_ticks * instr.vibrato_rate) >> 2
        ch.autovibrato_ticks += 1
        ch.autovibrato_note_offset = (
            0.25 * self._waveform(instr.vibrato_type, step)
            * instr.vibrato_depth / 15.0 * sweep
        )
        self._update_frequency(ch)

    # -- row handling (xm_row + handle_note_and_instrument) -------------------
    def _handle_note_and_instrument(self, ch: _Chan, s: _Slot) -> None:
        if s.instrument > 0:
            if s.has_tone_portamento() and ch.instrument is not None \
                    and ch.sample is not None:
                self._trigger_note(ch, KEEP_PERIOD | KEEP_POSITION)
            elif s.note == 0 and ch.sample is not None:
                self._trigger_note(ch, KEEP_POSITION)
            elif s.instrument > len(self.instruments):
                self._cut_note(ch)
                ch.instrument = None
                ch.sample = None
            else:
                ch.instrument = self.instruments[s.instrument - 1]

        if 0 < s.note < 97:
            instr = ch.instrument
            if s.has_tone_portamento() and instr is not None \
                    and ch.sample is not None:
                ch.note = s.note + ch.sample.relative_note \
                    + ch.sample.finetune / 128.0 - 1.0
                ch.tone_portamento_target_period = self._period(ch.note)
            elif instr is None or not instr.samples:
                self._cut_note(ch)
            else:
                si = instr.sample_of_notes[s.note - 1]
                if si < len(instr.samples):
                    # sample ramping: snapshot the old sample's tail
                    tail = np.zeros(RAMP_POINTS, np.float32)
                    for z in range(RAMP_POINTS):
                        tail[z] = self._next_of_sample(ch)
                    ch.end_of_previous_sample = tail
                    ch.frame_count = 0
                    ch.sample = instr.samples[si]
                    ch.orig_note = ch.note = (
                        s.note + ch.sample.relative_note
                        + ch.sample.finetune / 128.0 - 1.0
                    )
                    if s.instrument > 0:
                        self._trigger_note(ch, 0)
                    else:
                        self._trigger_note(ch, KEEP_VOLUME)
                else:
                    self._cut_note(ch)
        elif s.note == 97:
            self._key_off(ch)

        vc = s.volume_column >> 4
        if vc == 5 and s.volume_column > 0x50:
            pass
        elif vc in (1, 2, 3, 4, 5):
            ch.volume = (s.volume_column - 0x10) / 64.0
        elif vc == 8:
            self._volume_slide(ch, s.volume_column & 0x0F)
        elif vc == 9:
            self._volume_slide(ch, (s.volume_column << 4) & 0xFF)
        elif vc == 0xA:
            ch.vibrato_param = (ch.vibrato_param & 0x0F) | \
                ((s.volume_column & 0x0F) << 4)
        elif vc == 0xC:
            ch.panning = (((s.volume_column & 0x0F) << 4)
                          | (s.volume_column & 0x0F)) / 255.0
        elif vc == 0xF:
            if s.volume_column & 0x0F:
                ch.tone_portamento_param = (
                    ((s.volume_column & 0x0F) << 4) | (s.volume_column & 0x0F)
                )

        e, p = s.effect_type, s.effect_param
        if e == 1 and p > 0:
            ch.portamento_up_param = p
        elif e == 2 and p > 0:
            ch.portamento_down_param = p
        elif e == 3 and p > 0:
            ch.tone_portamento_param = p
        elif e == 4:
            if p & 0x0F:
                ch.vibrato_param = (ch.vibrato_param & 0xF0) | (p & 0x0F)
            if p >> 4:
                ch.vibrato_param = (p & 0xF0) | (ch.vibrato_param & 0x0F)
        elif e in (5, 6, 0xA):
            if p > 0:
                ch.volume_slide_param = p
        elif e == 7:
            if p & 0x0F:
                ch.tremolo_param = (ch.tremolo_param & 0xF0) | (p & 0x0F)
            if p >> 4:
                ch.tremolo_param = (p & 0xF0) | (ch.tremolo_param & 0x0F)
        elif e == 8:
            ch.panning = p / 255.0
        elif e == 9:
            if ch.sample is not None and 0 < s.note < 97:
                final = p << (7 if ch.sample.bits == 16 else 8)
                if final >= len(ch.sample.data):
                    ch.sample_position = -1.0
                else:
                    ch.sample_position = float(final)
        elif e == 0xB:
            if p < self.song_length:
                self.position_jump = True
                self.jump_dest = p
                self.jump_row = 0
        elif e == 0xC:
            ch.volume = min(p, 0x40) / 64.0
        elif e == 0xD:
            self.pattern_break = True
            self.jump_row = (p >> 4) * 10 + (p & 0x0F)
        elif e == 0xE:
            sub, sp = p >> 4, p & 0x0F
            if sub == 1:
                if sp:
                    ch.fine_portamento_up_param = sp
                self._pitch_slide(ch, -ch.fine_portamento_up_param)
            elif sub == 2:
                if sp:
                    ch.fine_portamento_down_param = sp
                self._pitch_slide(ch, ch.fine_portamento_down_param)
            elif sub == 4:
                ch.vibrato_waveform = sp & 3
                ch.vibrato_waveform_retrigger = not ((sp >> 2) & 1)
            elif sub == 5:
                if 0 < ch.current.note < 97 and ch.sample is not None:
                    ch.note = ch.current.note + ch.sample.relative_note + \
                        ((sp - 8) << 4) / 128.0 - 1.0
                    ch.period = self._period(ch.note)
                    self._update_frequency(ch)
            elif sub == 6:
                if sp:
                    if sp == ch.pattern_loop_count:
                        ch.pattern_loop_count = 0
                    else:
                        ch.pattern_loop_count += 1
                        self.position_jump = True
                        self.jump_row = ch.pattern_loop_origin
                        self.jump_dest = self.current_table_index
                else:
                    ch.pattern_loop_origin = self.current_row
                    self.jump_row = ch.pattern_loop_origin  # FT2 E60 bug
            elif sub == 7:
                ch.tremolo_waveform = sp & 3
                ch.tremolo_waveform_retrigger = not ((sp >> 2) & 1)
            elif sub == 0xA:
                if sp:
                    ch.fine_volume_slide_param = sp
                self._volume_slide(ch, (ch.fine_volume_slide_param << 4) & 0xFF)
            elif sub == 0xB:
                if sp:
                    ch.fine_volume_slide_param = sp
                self._volume_slide(ch, ch.fine_volume_slide_param)
            elif sub == 0xD:
                if s.note == 0 and s.instrument == 0:
                    if ch.current.effect_param & 0x0F:
                        ch.note = ch.orig_note
                        self._trigger_note(ch, KEEP_VOLUME)
                    else:
                        self._trigger_note(
                            ch, KEEP_VOLUME | KEEP_PERIOD | KEEP_POSITION
                        )
            elif sub == 0xE:
                self.extra_ticks = (p & 0x0F) * self.tempo
        elif e == 0xF:
            if p > 0:
                if p <= 0x1F:
                    self.tempo = p
                else:
                    self.bpm = p
        elif e == 16:
            self.global_volume = min(p, 0x40) / 64.0
        elif e == 17:
            if p > 0:
                ch.global_volume_slide_param = p
        elif e == 21:
            ch.volume_envelope_frame_count = p
            ch.panning_envelope_frame_count = p
        elif e == 25:
            if p > 0:
                ch.panning_slide_param = p
        elif e == 27:
            if p > 0:
                if p >> 4 == 0:
                    ch.multi_retrig_param = (ch.multi_retrig_param & 0xF0) | \
                        (p & 0x0F)
                else:
                    ch.multi_retrig_param = p
        elif e == 29:
            if p > 0:
                ch.tremor_param = p
        elif e == 33:
            sub, sp = p >> 4, p & 0x0F
            if sub == 1:
                if sp:
                    ch.extra_fine_portamento_up_param = sp
                self._pitch_slide(ch, -0.25 * ch.extra_fine_portamento_up_param
                                  if False else -1.0 * ch.extra_fine_portamento_up_param)
            elif sub == 2:
                if sp:
                    ch.extra_fine_portamento_down_param = sp
                self._pitch_slide(ch, 1.0 * ch.extra_fine_portamento_down_param)

    def _post_pattern_change(self) -> None:
        if self.current_table_index >= self.song_length:
            self.current_table_index = self.restart_position

    def _row(self) -> None:
        if self.position_jump:
            self.current_table_index = self.jump_dest
            self.current_row = self.jump_row
            self.position_jump = False
            self.pattern_break = False
            self.jump_row = 0
            self._post_pattern_change()
        elif self.pattern_break:
            self.current_table_index += 1
            self.current_row = self.jump_row
            self.pattern_break = False
            self.jump_row = 0
            self._post_pattern_change()
        pat = self.patterns[self.pattern_table[self.current_table_index]]
        in_a_loop = False
        for i in range(self.num_channels):
            s = pat[self.current_row][i] if self.current_row < len(pat) \
                else _Slot()
            ch = self.chans[i]
            ch.current = s
            if s.effect_type != 0xE or s.effect_param >> 4 != 0xD:
                self._handle_note_and_instrument(ch, s)
            else:
                ch.note_delay_param = s.effect_param & 0x0F
            if not in_a_loop and ch.pattern_loop_count > 0:
                in_a_loop = True
        if not in_a_loop:
            self.loop_count = self.row_loop_count[
                self.current_table_index, self.current_row
            ]
            self.row_loop_count[
                self.current_table_index, self.current_row
            ] += 1
        self.current_row += 1
        if not self.position_jump and not self.pattern_break and (
            self.current_row >= len(pat) or self.current_row >= 256
        ):
            self.current_table_index += 1
            self.current_row = self.jump_row
            self.jump_row = 0
            self._post_pattern_change()

    # -- envelopes ------------------------------------------------------------
    def _envelope_tick(self, ch: _Chan, env: _Env, counter_attr: str,
                       out_attr: str) -> None:
        counter = getattr(ch, counter_attr)
        if env.n < 2:
            if env.n == 1:
                setattr(ch, out_attr, min(1.0, env.points[0][1] / 64.0))
            return
        if env.loop_on:
            loop_start = env.points[env.loop_start][0]
            loop_end = env.points[env.loop_end][0]
            if counter >= loop_end:
                counter -= loop_end - loop_start
        j = 0
        for j in range(env.n - 2):
            if env.points[j][0] <= counter <= env.points[j + 1][0]:
                break
        a, b = env.points[j], env.points[j + 1]
        if counter <= a[0]:
            val = a[1]
        elif counter >= b[0]:
            val = b[1]
        else:
            t = (counter - a[0]) / (b[0] - a[0])
            val = a[1] * (1 - t) + b[1] * t
        setattr(ch, out_attr, val / 64.0)
        if not ch.sustained or not env.sustain_on or \
                counter != env.points[env.sustain][0]:
            counter += 1
        setattr(ch, counter_attr, counter)

    def _envelopes(self, ch: _Chan) -> None:
        if ch.instrument is None:
            return
        if ch.instrument.vol_env.enabled:
            if not ch.sustained:
                ch.fadeout_volume = max(
                    0.0, ch.fadeout_volume - ch.instrument.fadeout / 32768.0
                )
            self._envelope_tick(ch, ch.instrument.vol_env,
                                "volume_envelope_frame_count",
                                "volume_envelope_volume")
        if ch.instrument.pan_env.enabled:
            self._envelope_tick(ch, ch.instrument.pan_env,
                                "panning_envelope_frame_count",
                                "panning_envelope_panning")

    # -- tick ------------------------------------------------------------------
    def _tick(self) -> None:
        if self.current_tick == 0:
            self._row()
        for ch in self.chans:
            self._envelopes(ch)
            self._autovibrato(ch)
            if ch.arp_in_progress and not ch.current.has_arpeggio():
                ch.arp_in_progress = False
                ch.arp_note_offset = 0
                self._update_frequency(ch)
            if ch.vibrato_in_progress and not ch.current.has_vibrato():
                ch.vibrato_in_progress = False
                ch.vibrato_note_offset = 0.0
                self._update_frequency(ch)

            vc = ch.current.volume_column >> 4
            if self.current_tick != 0:
                if vc == 6:
                    self._volume_slide(ch, ch.current.volume_column & 0x0F)
                elif vc == 7:
                    self._volume_slide(ch,
                                       (ch.current.volume_column << 4) & 0xFF)
                elif vc == 0xB:
                    ch.vibrato_in_progress = False
                    self._vibrato(ch, ch.vibrato_param)
                elif vc == 0xD:
                    self._panning_slide(ch, ch.current.volume_column & 0x0F)
                elif vc == 0xE:
                    self._panning_slide(
                        ch, (ch.current.volume_column << 4) & 0xFF)
                elif vc == 0xF:
                    self._tone_portamento(ch)

            e, p = ch.current.effect_type, ch.current.effect_param
            t = self.current_tick
            if e == 0 and p > 0:
                arp_offset = self.tempo % 3
                if arp_offset == 2 and t == 1:
                    ch.arp_in_progress = True
                    ch.arp_note_offset = p >> 4
                    self._update_frequency(ch)
                elif arp_offset >= 1 and t == 0:
                    ch.arp_in_progress = False
                    ch.arp_note_offset = 0
                    self._update_frequency(ch)
                else:
                    self._arpeggio(ch, p, t - arp_offset)
            elif e == 1 and t:
                self._pitch_slide(ch, -ch.portamento_up_param)
            elif e == 2 and t:
                self._pitch_slide(ch, ch.portamento_down_param)
            elif e == 3 and t:
                self._tone_portamento(ch)
            elif e == 4 and t:
                ch.vibrato_in_progress = True
                self._vibrato(ch, ch.vibrato_param)
            elif e == 5 and t:
                self._tone_portamento(ch)
                self._volume_slide(ch, ch.volume_slide_param)
            elif e == 6 and t:
                ch.vibrato_in_progress = True
                self._vibrato(ch, ch.vibrato_param)
                self._volume_slide(ch, ch.volume_slide_param)
            elif e == 7 and t:
                self._tremolo(ch, ch.tremolo_param, ch.tremolo_ticks)
                ch.tremolo_ticks += 1
            elif e == 0xA and t:
                self._volume_slide(ch, ch.volume_slide_param)
            elif e == 0xE:
                sub = p >> 4
                if sub == 9 and t and (p & 0x0F):
                    if not t % (p & 0x0F):
                        self._trigger_note(ch, KEEP_VOLUME)
                        self._envelopes(ch)
                elif sub == 0xC and (p & 0x0F) == t:
                    self._cut_note(ch)
                elif sub == 0xD and ch.note_delay_param == t:
                    self._handle_note_and_instrument(ch, ch.current)
                    self._envelopes(ch)
            elif e == 17 and t:
                gp = ch.global_volume_slide_param
                if not ((gp & 0xF0) and (gp & 0x0F)):
                    if gp & 0xF0:
                        self.global_volume = min(
                            1.0, self.global_volume + (gp >> 4) / 64.0)
                    else:
                        self.global_volume = max(
                            0.0, self.global_volume - (gp & 0x0F) / 64.0)
            elif e == 20:
                if t == p:
                    self._key_off(ch)
            elif e == 25 and t:
                self._panning_slide(ch, ch.panning_slide_param)
            elif e == 27 and t:
                if (ch.multi_retrig_param & 0x0F) and \
                        t % (ch.multi_retrig_param & 0x0F) == 0:
                    self._trigger_note(ch, KEEP_VOLUME | KEEP_ENVELOPE)
                    if not ch.current.volume_column and ch.instrument and \
                            not ch.instrument.vol_env.enabled:
                        v = ch.volume * MULTI_RETRIG_MUL[
                            ch.multi_retrig_param >> 4
                        ] + MULTI_RETRIG_ADD[ch.multi_retrig_param >> 4] / 64.0
                        ch.volume = min(1.0, max(0.0, v))
            elif e == 29 and t:
                x = ch.tremor_param >> 4
                y = ch.tremor_param & 0x0F
                ch.tremor_on = ((t - 1) % (x + y + 2)) > x

            # clamp into sqrt's domain: the reference's sqrtf goes NaN
            # when corrupt panning data escapes [0,1] (libxm.d:2026-2031)
            panning = min(1.0, max(0.0, ch.panning + (
                ch.panning_envelope_panning - 0.5
            ) * (0.5 - abs(ch.panning - 0.5)) * 2.0))
            if ch.tremor_on:
                volume = 0.0
            else:
                volume = min(1.0, max(0.0, ch.volume + ch.tremolo_volume))
                volume *= ch.fadeout_volume * ch.volume_envelope_volume
            ch.target_volume[0] = volume * math.sqrt(1.0 - panning)
            ch.target_volume[1] = volume * math.sqrt(panning)

        self.current_tick += 1
        if self.current_tick >= self.tempo + self.extra_ticks:
            self.current_tick = 0
            self.extra_ticks = 0
        self.remaining_samples_in_tick += self.rate / (self.bpm * 0.4)

    # -- mixing (xm_next_of_sample / xm_sample, per-sample loop) ---------------
    def _next_of_sample(self, ch: _Chan, peek: bool = False) -> float:
        if ch.instrument is None or ch.sample is None or \
                ch.sample_position < 0:
            if ch.frame_count < RAMP_POINTS:
                t = ch.frame_count / RAMP_POINTS
                return float(ch.end_of_previous_sample[ch.frame_count]) * (1 - t)
            return 0.0
        smp = ch.sample
        n = len(smp.data)
        if n == 0:
            return 0.0
        a = int(ch.sample_position)
        u = float(smp.data[min(a, n - 1)])
        if self.linear_interpolation:
            # libxm.d:2338-2400: v per loop type, from the pre-advance
            # position; XM_LERP(u, v, t) = u + t*(v - u)
            t = float(ch.sample_position - a)
            b = a + 1
            if smp.loop_type == 0:
                v = float(smp.data[b]) if b < n else 0.0
            elif smp.loop_type == 1:
                bw = smp.loop_start if b == smp.loop_end else b
                v = float(smp.data[min(bw, n - 1)])
            elif ch.ping:
                bw = a if b >= smp.loop_end else b
                v = float(smp.data[min(bw, n - 1)])
            else:
                v = u
                bw = a if (b == 1 or b - 2 <= smp.loop_start) else b - 2
                u = float(smp.data[min(bw, n - 1)])
            u = u + t * (v - u)
        if not peek:
            if smp.loop_type == 0:
                ch.sample_position += ch.step
                if ch.sample_position >= n:
                    ch.sample_position = -1.0
            elif smp.loop_type == 1:
                ch.sample_position += ch.step
                while ch.sample_position >= smp.loop_end:
                    ch.sample_position -= smp.loop_length
            else:  # ping-pong
                if ch.ping:
                    ch.sample_position += ch.step
                    if ch.sample_position >= smp.loop_end:
                        ch.ping = False
                        ch.sample_position = (
                            (smp.loop_end * 2) - ch.sample_position
                        )
                    if ch.sample_position >= n:
                        ch.ping = False
                        ch.sample_position = n - 1
                else:
                    ch.sample_position -= ch.step
                    if ch.sample_position <= smp.loop_start:
                        ch.ping = True
                        ch.sample_position = (
                            (smp.loop_start * 2) - ch.sample_position
                        )
                    if ch.sample_position <= 0:
                        ch.ping = True
                        ch.sample_position = 0.0
        if ch.frame_count < RAMP_POINTS:
            t = ch.frame_count / RAMP_POINTS
            return float(ch.end_of_previous_sample[ch.frame_count]) * (1 - t) \
                + u * t
        return u

    def _chan_segment(self, ch: _Chan, m: int):
        """Vectorized per-channel mix for m samples within one tick: returns
        the channel's mono contribution [m] and advances position/loop/
        frame-count state exactly as the per-sample reference loop
        (xm_next_of_sample, libxm semantics) would."""
        fc0 = ch.frame_count
        idxs = np.arange(m)
        active = not (ch.instrument is None or ch.sample is None or
                      ch.sample_position < 0)
        if not active:
            ch.frame_count += m
            return None
        smp = ch.sample
        n = len(smp.data)
        if n == 0:
            ch.frame_count += m
            return None
        step = ch.step
        p0 = ch.sample_position
        linear = self.linear_interpolation
        if linear and smp.loop_type == 2:
            # ping-pong + linear: direction-dependent neighbor selection
            # (libxm.d:2369-2400) — the scalar reference loop handles it
            return self._chan_segment_scalar(ch, m)
        if smp.loop_type == 0:
            pos = p0 + step * idxs
            valid = pos < n
            gather = np.minimum(pos.astype(np.int64), n - 1)
            a = np.clip(gather, 0, n - 1)
            u = smp.data[a].astype(np.float64)
            if linear:
                b = a + 1
                v = np.where(b < n, smp.data[np.clip(b, 0, n - 1)], 0.0)
                u = u + (pos - a) * (v - u)
            u = np.where(valid, u, 0.0)
            pend = p0 + step * m
            ch.sample_position = -1.0 if pend >= n else pend
        elif smp.loop_type == 1:
            L = smp.loop_length
            if L <= 0:
                return self._chan_segment_scalar(ch, m)
            pos = p0 + step * idxs
            wrapped = pos >= smp.loop_end
            pos = np.where(
                wrapped,
                smp.loop_start + np.mod(pos - smp.loop_start, L), pos)
            a = np.clip(pos.astype(np.int64), 0, n - 1)
            u = smp.data[a].astype(np.float64)
            if linear:
                b = a + 1
                bw = np.where(b == smp.loop_end, smp.loop_start, b)
                v = smp.data[np.clip(bw, 0, n - 1)].astype(np.float64)
                u = u + (pos - a) * (v - u)
            pend = p0 + step * m
            while pend >= smp.loop_end:
                pend -= L
            ch.sample_position = pend
        else:  # ping-pong: triangle mapping of the unfolded phase
            L = smp.loop_end - smp.loop_start
            if L <= 0 or smp.loop_end > n or step > L or \
                    (not ch.ping and p0 < smp.loop_start):
                return self._chan_segment_scalar(ch, m)
            # phase < L is the pre-reflection (ascending) region and stays
            # LINEAR — including negative phase when the note starts below
            # loop_start (the reference only reflects at the loop edges)
            phi0 = (p0 - smp.loop_start) if ch.ping else \
                (2 * L - (p0 - smp.loop_start))
            phi = phi0 + step * idxs
            mm = np.mod(phi - L, 2 * L)
            pos = np.where(
                phi < L, smp.loop_start + phi,
                smp.loop_start + np.where(mm < L, L - mm, mm - L))
            u = smp.data[np.clip(pos.astype(np.int64), 0, n - 1)].astype(
                np.float64)
            phe = phi0 + step * m
            if phe < L:
                ch.ping = True
                ch.sample_position = smp.loop_start + phe
            else:
                me = float(np.mod(phe - L, 2 * L))
                if me < L:
                    ch.ping = False
                    ch.sample_position = smp.loop_start + (L - me)
                else:
                    ch.ping = True
                    ch.sample_position = smp.loop_start + (me - L)
        if fc0 < RAMP_POINTS:
            k = min(m, RAMP_POINTS - fc0)
            t = (fc0 + idxs[:k]) / RAMP_POINTS
            eops = np.asarray(ch.end_of_previous_sample, np.float64)
            u = np.asarray(u, np.float64)
            u[:k] = eops[fc0 : fc0 + k] * (1 - t) + u[:k] * t
        ch.frame_count += m
        return u

    def _chan_segment_scalar(self, ch: _Chan, m: int):
        vals = np.empty(m)
        for i in range(m):
            vals[i] = self._next_of_sample(ch)
            ch.frame_count += 1
        return vals

    @staticmethod
    def _ramp_volumes(av, tv, r, m):
        """Closed-form per-sample volume ramp: returns [m] volumes as used
        for samples 0..m-1 plus the final state (mirrors the reference's
        clamped approach by +-r per sample)."""
        idxs = np.arange(m)
        if av > tv:
            v = np.maximum(tv, av - r * idxs)
            end = max(tv, av - r * m)
        elif av < tv:
            v = np.minimum(tv, av + r * idxs)
            end = min(tv, av + r * m)
        else:
            v = np.full(m, av)
            end = av
        return v, end

    def _generate(self, numsamples: int) -> np.ndarray:
        out = np.zeros((numsamples, 2), np.float32)
        self.generated_samples += numsamples
        g = self.global_volume * self.amplification
        i = 0
        while i < numsamples:
            if self.remaining_samples_in_tick <= 0:
                self._tick()
                g = self.global_volume * self.amplification
            m = min(numsamples - i, int(self.remaining_samples_in_tick))
            if m <= 0:
                m = 1
            self.remaining_samples_in_tick -= m
            if self.max_loop_count > 0 and \
                    self.loop_count >= self.max_loop_count:
                i += m
                continue
            left = np.zeros(m)
            right = np.zeros(m)
            for ch in self.chans:
                av0, av1 = ch.actual_volume[0], ch.actual_volume[1]
                tv0, tv1 = ch.target_volume[0], ch.target_volume[1]
                u = self._chan_segment(ch, m)
                v0, e0 = self._ramp_volumes(av0, tv0, self.volume_ramp, m)
                v1, e1 = self._ramp_volumes(av1, tv1, self.volume_ramp, m)
                ch.actual_volume[0] = e0
                ch.actual_volume[1] = e1
                if u is None:
                    continue
                left += u * v0
                right += u * v1
            out[i : i + m, 0] = left * g
            out[i : i + m, 1] = right * g
            i += m
        return out

    # ------------------------------------------------------------------ API
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        if self.loop_count >= self.max_loop_count:
            return np.zeros((0, 2), dtype=dtype)  # stream.d:598-600
        out = self._generate(max_frames)
        self._frames_told += out.shape[0]
        return out.astype(dtype)

    # -- module API ------------------------------------------------------------
    def count_patterns(self) -> int:
        return len(self.patterns)

    def module_length(self) -> int:
        return self.song_length

    def rows_in_pattern(self, pattern: int) -> int:
        if pattern < 0 or pattern >= len(self.patterns):
            return -1
        return len(self.patterns[pattern])

    def tell_pattern(self) -> int:
        return self.current_table_index

    def tell_row(self) -> int:
        return self.current_row

    def frames_remaining_in_pattern(self) -> int:
        # xm_count_remaining_samples is unimplemented in the reference
        # (README.md:83); mirror its placeholder behavior
        return -1

    def seek_pattern(self, pattern: int, row: int) -> bool:
        self.current_table_index = pattern
        self.current_row = row
        self.current_tick = 0
        self.remaining_samples_in_tick = 0.0
        self._frames_told = 0
        return True

    def tell(self) -> int:
        # the reference ASSERTS !isModule() here (stream.d:1209:
        # "seeking doesn't have the same meaning with modules");
        # we return frames emitted since open / last seek_pattern
        # instead -- a strict superset of that contract
        return self._frames_told
