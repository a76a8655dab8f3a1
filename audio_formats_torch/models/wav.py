"""WAV codec: RIFF container parse (host) + PCM conversion (device).

Decode parity target: wav.d `WAVDecoder.scan` (wav.d:53-217) — RIFF/WAVE
header, 'fmt ' (incl. WAVE_FORMAT_EXTENSIBLE), 'data' chunk, corrupted
trailing-byte tolerance (wav.d:81-91); `readSamples` conversion semantics
(wav.d:242-344); O(1) byte-offset seek (wav.d:220-237).

Encode parity target: `WAVEncoder` (wav.d:365-605) — RIFF streaming write
with finalize-time backpatch of RIFF/data sizes, s8/s16/s24/f32/f64 output,
TPDF dither (wav.d:679-701).  The reference's finalize bug (sets error on
success, wav.d:604) is intentionally not replicated.

Integer sample math runs on the decoder's or encoder's torch device through
ops/pcm.py (K10 on a CUDA device: the payload bytes go up as they are and
come back as f32, or go up as f32 and come back as payload bytes); the f64
decode path is the reference's double math on the host.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..config import AudioFileFormat, AudioSampleFormat, EncodingOptions
from ..errors import AudioFormatError
from ..io.source import ByteSource, ByteSink
from ..ops import pcm
from ..device import device_of

_LINEAR_PCM = 0x0001
_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE
# KSDATAFORMAT_SUBTYPE_IEEE_FLOAT GUID (wav.d:42-43)
_KSDATAFORMAT_IEEE_FLOAT = bytes(
    [3, 0, 0, 0, 0, 0, 16, 0, 128, 0, 0, 170, 0, 56, 155, 113]
)


def probe(src: ByteSource, device="cuda"):
    """Return a WavDecoder if ``src`` is a RIFF/WAVE stream, else None."""
    head = src.peek(12)
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return WavDecoder(src, device)
    return None


class WavDecoder:
    format = AudioFileFormat.wav

    def __init__(self, src: ByteSource, device="cuda"):
        self.device = device_of(device)
        self._src = src
        self._scan()
        self._frame_pos = 0

    # -- container scan (host) ---------------------------------------------
    def _scan(self) -> None:
        src = self._src
        src.seek(0)
        hdr = src.read_exact(12)
        riff_size = struct.unpack_from("<I", hdr, 4)[0]
        if riff_size < 4:
            raise AudioFormatError("RIFF chunk is too small to contain a format.")

        found_fmt = found_data = False
        audio_format = channels = sample_rate = bits = 0
        data_offset = data_size = 0
        while not src.eof():
            # Corrupted-WAV tolerance: one trailing zero byte (wav.d:81-91).
            if src.remaining() == 1:
                if src.peek(1)[0] == 0:
                    break
            if src.remaining() < 8:
                raise AudioFormatError("Cannot read RIFF chunk header")
            ck = src.read_exact(8)
            ck_id = bytes(ck[:4])
            ck_size = struct.unpack_from("<I", ck, 4)[0]
            if ck_id == b"fmt ":
                if found_fmt:
                    raise AudioFormatError(
                        "Found several 'fmt ' chunks in RIFF file."
                    )
                found_fmt = True
                if ck_size < 16:
                    raise AudioFormatError(
                        "Expected at least 16 bytes in 'fmt ' chunk."
                    )
                body = src.read_exact(ck_size)
                (audio_format, channels, sample_rate, _byte_rate, _block_align,
                 bits) = struct.unpack_from("<HHIIHH", body, 0)
                if audio_format == _WAVE_FORMAT_EXTENSIBLE:
                    # wav.d:137-160: need the 22-byte extension + GUID.
                    if ck_size < 40:
                        raise AudioFormatError(
                            "Expected at least 40 bytes in WAVE_FORMAT_EXTENSIBLE 'fmt ' chunk."
                        )
                    cb_size, _valid_bits, _mask = struct.unpack_from(
                        "<HHI", body, 16
                    )
                    guid = bytes(body[24:40])
                    if guid == _KSDATAFORMAT_IEEE_FLOAT:
                        audio_format = _IEEE_FLOAT
                    else:
                        audio_format = _LINEAR_PCM
                if audio_format not in (_LINEAR_PCM, _IEEE_FLOAT):
                    raise AudioFormatError(
                        "Unsupported audio format, only PCM and IEEE float "
                        "and WAVE_FORMAT_EXTENSIBLE are supported."
                    )
                # pad byte
                if ck_size & 1 and not src.eof():
                    src.seek(1, relative=True)
            elif ck_id == b"data":
                if found_data:
                    raise AudioFormatError(
                        "Found several 'data' chunks in RIFF file."
                    )
                if not found_fmt:
                    raise AudioFormatError("'fmt ' chunk expected before 'data'.")
                found_data = True
                data_offset = src.tell()
                data_size = ck_size
                # skip (with RIFF pad-byte tolerance) but never past EOF —
                # a final odd-sized chunk legally ends the file unpadded
                src.seek(min(ck_size + (ck_size & 1), src.remaining()),
                         relative=True)
            else:
                src.seek(min(ck_size + (ck_size & 1), src.remaining()),
                         relative=True)

        if not (found_fmt and found_data):
            raise AudioFormatError("Expected 'fmt ' and 'data' chunks.")
        if channels == 0 or bits == 0 or bits % 8 != 0:
            raise AudioFormatError("Invalid WAV fmt parameters")
        byte_per_sample = bits // 8
        if audio_format == _IEEE_FLOAT and byte_per_sample not in (4, 8):
            raise AudioFormatError("Unsupported float bit-depth")
        if audio_format == _LINEAR_PCM and byte_per_sample not in (1, 2, 3, 4):
            raise AudioFormatError("Unsupported integer PCM bit-depth")

        self.sample_rate = sample_rate
        self.channels = channels
        self._audio_format = audio_format
        self._byte_per_sample = byte_per_sample
        self._data_offset = data_offset
        frame_bytes = byte_per_sample * channels
        avail = min(data_size, max(0, src.size() - data_offset))
        self.length_frames = avail // frame_bytes

    # -- decode --------------------------------------------------------------
    def _raw_frames(self, frames: int) -> memoryview:
        fb = self._byte_per_sample * self.channels
        start = self._data_offset + self._frame_pos * fb
        return self._src.view()[start : start + frames * fb]

    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        """Decode up to ``max_frames``; returns (n, channels) array."""
        avail = self.length_frames - self._frame_pos
        frames = max(0, min(max_frames, avail))
        if frames == 0:
            return np.zeros((0, self.channels), dtype=dtype)
        raw = self._raw_frames(frames)
        self._frame_pos += frames
        bps = self._byte_per_sample
        n = frames * self.channels
        if self._audio_format == _IEEE_FLOAT:
            kind = "<f4" if bps == 4 else "<f8"
            out = np.frombuffer(raw, dtype=kind, count=n).astype(dtype)
        elif dtype == np.float64:
            ints = _unpack_int_pcm(raw, bps, n)
            out = pcm.int_pcm_to_float(ints, self.kind, dtype=dtype,
                                       device=self.device)
        else:
            b = torch.from_numpy(np.frombuffer(raw, np.uint8, n * bps).copy())
            out = pcm.decode_bytes(b.to(self.device), self.kind).cpu().numpy()
        return out.reshape(frames, self.channels)

    @property
    def kind(self) -> str:
        """The integer sample kind (u8, s16, s24, s32) of a linear-PCM
        stream."""
        return {1: "u8", 2: "s16", 3: "s24", 4: "s32"}[self._byte_per_sample]

    # -- seek/tell (wav.d:220-237) -------------------------------------------
    def seek(self, frame: int) -> bool:
        if frame < 0 or frame > self.length_frames:
            return False
        self._frame_pos = frame
        return True

    def tell(self) -> int:
        return self._frame_pos


def _unpack_int_pcm(raw: memoryview, bps: int, n: int) -> np.ndarray:
    """Byte-stream → int32 lane values (u8 kept unsigned raw; others signed)."""
    if bps == 1:
        return np.frombuffer(raw, dtype=np.uint8, count=n).astype(np.int32)
    if bps == 2:
        return np.frombuffer(raw, dtype="<i2", count=n).astype(np.int32)
    if bps == 4:
        return np.frombuffer(raw, dtype="<i4", count=n).astype(np.int32)
    # 24-bit: assemble three bytes, sign-extend (wav.d:312-318).
    b = np.frombuffer(raw, dtype=np.uint8, count=n * 3).reshape(n, 3)
    v = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    return (v << 8) >> 8


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

_FMT_INFO = {
    AudioSampleFormat.s8: (1, _LINEAR_PCM, "u8"),
    AudioSampleFormat.s16: (2, _LINEAR_PCM, "s16"),
    AudioSampleFormat.s24: (3, _LINEAR_PCM, "s24"),
    AudioSampleFormat.fp32: (4, _IEEE_FLOAT, None),
    AudioSampleFormat.fp64: (8, _IEEE_FLOAT, None),
}


def wav_header(wformat: int, channels: int, sample_rate: int,
               sample_size: int, data_len: int) -> bytes:
    """The 44-byte RIFF/WAVE header (a 16-byte fmt chunk) of a data chunk
    of `data_len` bytes (wav.d:572-605, minus the bug)."""
    frame_size = sample_size * channels
    riff_length = 4 + (4 + 4 + 16) + (4 + 4 + data_len)
    return (b"RIFF" + struct.pack("<I", riff_length & 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<I", 16)
            + struct.pack("<HHIIHH", wformat, channels, sample_rate,
                          sample_rate * frame_size, frame_size,
                          sample_size * 8)
            + b"data" + struct.pack("<I", data_len & 0xFFFFFFFF))


class WavEncoder:
    format = AudioFileFormat.wav

    def __init__(
        self,
        sink: ByteSink,
        sample_rate: int,
        channels: int,
        options: EncodingOptions,
        device="cuda",
    ):
        if channels < 0 or channels > 1024:  # wav.d:400 edge-case guard
            raise AudioFormatError("Can't save a WAV with this number of channels.")
        self.device = device_of(device)
        self._sink = sink
        self.sample_rate = sample_rate
        self.channels = channels
        self._options = options
        self._sample_size, self._wformat, self._qkind = _FMT_INFO[
            options.sample_format
        ]
        self._written_frames = 0
        self._dither_calls = 0
        self._write_header()

    def _header(self, data_len: int) -> bytes:
        return wav_header(self._wformat, self.channels, self.sample_rate,
                          self._sample_size, data_len)

    def _write_header(self) -> None:
        self._header_offset = self._sink.tell()
        self._sink.write(self._header(0))

    def write(self, samples: np.ndarray) -> int:
        """Write interleaved float samples of shape (frames, channels)."""
        frames = samples.shape[0]
        flat = np.ascontiguousarray(samples, dtype=samples.dtype).reshape(-1)
        fmt = self._options.sample_format
        if fmt == AudioSampleFormat.fp32:
            self._sink.write(flat.astype("<f4").tobytes())
        elif fmt == AudioSampleFormat.fp64:
            self._sink.write(flat.astype("<f8").tobytes())
        else:
            # quantize and pack on the device: the bytes come back as they
            # are written
            body, = pcm.quantize_pack_rows(
                flat.astype(np.float32)[None, :], [flat.shape[0]],
                [(self._options.dither_seed + self._dither_calls)
                 & 0xFFFFFFFF],
                self._qkind, self._sample_size,
                dither=self._options.enable_dither, device=self.device)
            self._dither_calls += 1
            self._sink.write(body)
        self._written_frames += frames
        return frames

    def finalize(self) -> None:
        """Backpatch RIFF & data sizes (wav.d:572-605, minus the bug)."""
        s = self._sink
        end = s.tell()
        s.seek(self._header_offset)
        s.write(self._header(
            self._sample_size * self.channels * self._written_frames))
        s.seek(end)

