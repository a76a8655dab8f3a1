"""QOA codec ("Quite OK Audio", qoaformat.org).

Host side: the trivially-parallel container work — big-endian u64 frame
headers, per-channel LMS state words, and 3-bit residual unpacking/packing
(all vectorized numpy bit ops).  Device side, on the decoder's or encoder's
torch device: the LMS predict/update recurrence and the encoder's
16-scalefactor search (ops/lms.py).

Decode parity: qoa_decode_header (qoa.d:413-453), qoa_decode_frame
(qoa.d:455-534), streaming QOADecoder with one-frame buffer and float output
``sample * (1.0f/32767)`` — a float32 reciprocal MULTIPLY, unlike WAV's
divide (qoa.d:825-834) — and O(1) arithmetic seek (qoa.d:720-760).

Encode parity: qoa_encode_frame (qoa.d:295-399), QOAEncoder staging/finalize
(qoa.d:538-699): initial LMS weights {0,0,-(1<<13),1<<14}, round-half-up
input quantization (same as WAV s16 no-dither), header samples-count patch on
finalize.  Output is verified byte-identical to an independent golden
encoder in tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AudioFileFormat, EncodingOptions
from ..errors import AudioFormatError
from ..io.source import ByteSink, ByteSource
from ..ops import lms, pcm
from ..ops.lms import (
    QOA_FRAME_LEN,
    QOA_LMS_LEN,
    QOA_SLICE_LEN,
    QOA_SLICES_PER_FRAME,
)
from .flac import device_of

QOA_MAGIC = 0x716F6166  # 'qoaf'
QOA_MIN_FILESIZE = 16
_F32_RECIP = np.float32(1.0) / np.float32(32767.0)  # qoa.d:825 `F`


def _frame_size(channels: int, slices: int) -> int:
    return 8 + QOA_LMS_LEN * 4 * channels + 8 * slices * channels


def probe(src: ByteSource, device="cuda"):
    head = src.peek(4)
    if len(head) == 4 and bytes(head) == b"qoaf" and src.size() >= QOA_MIN_FILESIZE:
        try:
            return QoaDecoder(src, device)
        except AudioFormatError:
            return None
    return None


class QoaDecoder:
    format = AudioFileFormat.qoa

    def __init__(self, src: ByteSource, device="cuda"):
        self.device = device_of(device)
        self._src = src
        view = src.view()
        file_header = int.from_bytes(view[0:8], "big")
        if (file_header >> 32) != QOA_MAGIC:
            raise AudioFormatError("Not a QOA stream")
        self.length_frames = file_header & 0xFFFFFFFF
        if self.length_frames == 0:
            raise AudioFormatError("Empty QOA stream")
        if len(view) < 16:
            raise AudioFormatError("Truncated QOA stream")
        frame_header = int.from_bytes(view[8:16], "big")
        self.channels = (frame_header >> 56) & 0xFF
        self.sample_rate = (frame_header >> 32) & 0xFFFFFF
        if self.channels == 0 or self.sample_rate == 0:
            raise AudioFormatError("Invalid QOA header")
        self._byte_pos = 8  # cursor just past file header (qoa.d:772-803)
        self._pos = 0  # current frame position (currentPositionFrame)
        self._buf = np.zeros((0, self.channels), dtype=np.int16)
        self._buf_start = 0

    # -- frame decode (host unpack + device LMS scan) -----------------------
    def _parse_frame_at(self, pos: int):
        """Parse one frame's header + slice words; returns
        (history [ch,4], weights [ch,4], sf [ch,S], codes [ch,S,20],
        f_samples, f_size) or None at EOF/corrupt."""
        view = self._src.view()
        ch = self.channels
        need = 8 + QOA_LMS_LEN * 4 * ch
        if len(view) - pos < need:
            return None
        hdr = int.from_bytes(view[pos : pos + 8], "big")
        f_channels = (hdr >> 56) & 0xFF
        f_rate = (hdr >> 32) & 0xFFFFFF
        f_samples = (hdr >> 16) & 0xFFFF
        f_size = hdr & 0xFFFF
        data_size = f_size - need
        num_slices = data_size // 8  # total slice words (all channels)
        max_total = (num_slices // ch) * QOA_SLICE_LEN if ch else 0
        if len(view) - pos < f_size:
            return None
        if (
            f_channels != ch
            or f_rate != self.sample_rate
            or f_samples > max_total
        ):
            return None

        p = pos + 8
        state = np.frombuffer(
            view[p : p + QOA_LMS_LEN * 4 * ch], dtype=">i2"
        ).reshape(ch, 2, 4)
        history = state[:, 0, :].astype(np.int32)
        weights = state[:, 1, :].astype(np.int32)
        p += QOA_LMS_LEN * 4 * ch

        n_slices = (f_samples + QOA_SLICE_LEN - 1) // QOA_SLICE_LEN
        words = np.frombuffer(
            view[p : p + 8 * n_slices * ch], dtype=">u8"
        ).reshape(n_slices, ch)
        sf = (words >> np.uint64(60)).astype(np.int32).T  # [ch, S]
        shifts = np.uint64(57) - np.uint64(3) * np.arange(20, dtype=np.uint64)
        codes = (
            (words[:, :, None] >> shifts[None, None, :]) & np.uint64(7)
        ).astype(np.int32)
        codes = np.transpose(codes, (1, 0, 2))  # [ch, S, 20]
        return history, weights, sf, codes, f_samples, f_size

    # frames per device call on the single-stream facade: QOA frames carry
    # their LMS state in-band, so they batch as independent lanes
    _FACADE_WINDOW = 16

    def _decode_next_frame(self) -> int:
        """Decode a window of frames at the byte cursor into self._buf;
        returns the number of samples per channel decoded (0 at
        EOF/corrupt, matching qoa_decode_frame's return-0 contract)."""
        ch = self.channels
        parsed = []
        pos = self._byte_pos
        while len(parsed) < self._FACADE_WINDOW:
            p = self._parse_frame_at(pos)
            if p is None:
                break
            parsed.append(p)
            pos += p[5]
            if p[4] < QOA_FRAME_LEN:
                break  # short (final) frame ends the window
        if not parsed:
            return 0
        # one device call: a short frame's slices pad to the full frame and
        # its samples past f_samples are dropped
        S = QOA_SLICES_PER_FRAME
        sf = np.zeros((len(parsed) * ch, S), np.int8)
        codes = np.zeros((len(parsed) * ch, S, QOA_SLICE_LEN), np.int8)
        for k, p in enumerate(parsed):
            n = p[2].shape[1]
            sf[k * ch:(k + 1) * ch, :n] = p[2]
            codes[k * ch:(k + 1) * ch, :n] = p[3]
        dev = self.device
        out = lms.decode_slices(
            torch.from_numpy(np.concatenate([p[0] for p in parsed])).to(dev),
            torch.from_numpy(np.concatenate([p[1] for p in parsed])).to(dev),
            torch.from_numpy(sf).to(dev), torch.from_numpy(codes).to(dev),
        ).cpu().numpy()  # [frames*ch, 5120]
        self._buf = np.concatenate([
            out[k * ch:(k + 1) * ch, :p[4]].T.astype(np.int16)
            for k, p in enumerate(parsed)])
        self._buf_start = 0
        self._byte_pos = pos
        return self._buf.shape[0]

    # -- streaming read (qoa.d:806-840) --------------------------------------
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        chunks = []
        got = 0
        while got < max_frames:
            in_store = self._buf.shape[0] - self._buf_start
            if in_store == 0:
                if self._decode_next_frame() == 0:
                    break
                in_store = self._buf.shape[0]
            take = min(in_store, max_frames - got)
            chunks.append(self._buf[self._buf_start : self._buf_start + take])
            self._buf_start += take
            got += take
            self._pos += take
        if not chunks:
            return np.zeros((0, self.channels), dtype=dtype)
        s16 = np.concatenate(chunks, axis=0)
        # float output is s16 * f32(1/32767); double widens the f32 result
        # (qoa.d:825-834: the multiply happens in float).
        f32 = s16.astype(np.float32) * _F32_RECIP
        return f32.astype(dtype)

    # -- seek (qoa.d:720-760: O(1) arithmetic on fixed frame size) -----------
    def seek(self, frame: int) -> bool:
        if frame < 0 or frame > self.length_frames:
            return False
        if frame == self._pos:
            return True
        self._buf = np.zeros((0, self.channels), dtype=np.int16)
        self._buf_start = 0
        frame_index = frame // QOA_FRAME_LEN
        remain = frame - frame_index * QOA_FRAME_LEN
        self._byte_pos = 8 + _frame_size(
            self.channels, QOA_SLICES_PER_FRAME
        ) * frame_index
        self._pos = frame_index * QOA_FRAME_LEN
        if remain > 0:
            n = self._decode_next_frame()
            if n < remain:
                return False
            self._buf_start = remain
            self._pos += remain
        return True

    def tell(self) -> int:
        return self._pos


def pack_qoa_frame(sample_rate: int, ch: int, frame_len: int,
                   history: np.ndarray, weights: np.ndarray,
                   sf: np.ndarray, codes: np.ndarray) -> bytes:
    """Serialize one QOA frame (header + PRE-frame LMS state + slice words,
    qoa.d:295-399); shared by the streaming encoder and the batched one."""
    n_slices = (frame_len + QOA_SLICE_LEN - 1) // QOA_SLICE_LEN
    f_size = _frame_size(ch, n_slices)
    hdr = (ch << 56) | (sample_rate << 32) | (frame_len << 16) | f_size
    out = bytearray(hdr.to_bytes(8, "big"))
    # LMS state words: history then weights, 4 x s16 BE (qoa.d:315-326)
    for c in range(ch):
        for arr in (history, weights):
            w = 0
            for i in range(QOA_LMS_LEN):
                w = (w << 16) | (int(arr[c, i]) & 0xFFFF)
            out += w.to_bytes(8, "big")
    sfu = sf[:, :n_slices].astype(np.uint64)
    cdu = codes[:, :n_slices].astype(np.uint64)
    words = sfu << np.uint64(60)
    shifts = np.uint64(57) - np.uint64(3) * np.arange(20, dtype=np.uint64)
    words |= np.bitwise_or.reduce(cdu << shifts[None, None, :], axis=2)
    # interleaved on slice level: (ch0,s0),(ch1,s0),(ch0,s1)… (qoa.d:330)
    out += np.ascontiguousarray(words.T).astype(">u8").tobytes()
    return bytes(out)


class QoaEncoder:
    format = AudioFileFormat.qoa

    def __init__(
        self,
        sink: ByteSink,
        sample_rate: int,
        channels: int,
        options: EncodingOptions,
        device="cuda",
    ):
        if (
            sample_rate == 0
            or sample_rate > 0xFFFFFF
            or channels == 0
            or channels > 8
        ):
            raise AudioFormatError("Invalid QOA encode parameters")
        self.device = device_of(device)
        self._sink = sink
        self.sample_rate = sample_rate
        self.channels = channels
        # Initial LMS state (qoa.d:568-581): weights {0,0,-2^13,2^14}.
        self._history = np.zeros((channels, 4), dtype=np.int32)
        self._weights = np.tile(lms.INITIAL_WEIGHTS, (channels, 1))
        self._staged = np.zeros((QOA_FRAME_LEN, channels), dtype=np.int32)
        self._count = 0
        self._frames_encoded = 0
        sink.write(b"\0" * 8)  # header placeholder (qoa.d:599-603)

    def write(self, samples: np.ndarray) -> int:
        """samples: (frames, channels) float32/float64 in [-1, 1]."""
        # host quantize: the exact round-half-up, without an
        # upload+download roundtrip of the whole PCM
        s16 = pcm.quantize_float_to_int_np(
            np.ascontiguousarray(samples).reshape(-1), "s16")
        s16 = s16.reshape(-1, self.channels)
        done = 0
        frames = s16.shape[0]
        while done < frames:
            room = QOA_FRAME_LEN - self._count
            take = min(room, frames - done)
            self._staged[self._count : self._count + take] = s16[
                done : done + take
            ]
            self._count += take
            done += take
            if self._count == QOA_FRAME_LEN:
                self._output_frame(QOA_FRAME_LEN)
        return frames

    def _output_frame(self, frame_len: int) -> None:
        ch = self.channels
        samples = np.zeros((ch, QOA_FRAME_LEN), dtype=np.int32)
        samples[:, :frame_len] = self._staged[:frame_len].T
        dev = self.device
        sf, codes, h, w = (t.cpu().numpy() for t in lms.qoa_encode_frame_scan(
            torch.from_numpy(samples).to(dev),
            torch.from_numpy(self._history).to(dev),
            torch.from_numpy(self._weights).to(dev), frame_len))
        out = pack_qoa_frame(
            self.sample_rate, ch, frame_len, self._history, self._weights,
            sf, codes)
        self._history = h
        self._weights = w
        self._sink.write(out)
        self._frames_encoded += frame_len
        self._count = 0

    def finalize(self) -> None:
        if self._count > 0:
            self._output_frame(self._count)
        end = self._sink.tell()
        self._sink.seek(0)
        self._sink.write(
            ((QOA_MAGIC << 32) | self._frames_encoded).to_bytes(8, "big")
        )
        self._sink.seek(end)
