"""FLAC decoder: host framing/Rice entropy stage + device LPC synthesis.

Parity target: drflac.d — STREAMINFO/metadata walk (drflac.d:1901-2118),
frame header incl. UTF-8 coded numbers (drflac.d:1444-1530), subframe header
with side-channel +1 bit and wasted bits (drflac.d:1571-1599), partitioned
Rice/Rice2 residuals (drflac.d:1279-1330), 32/64-bit LPC prediction dispatch
on subframe bits-per-sample > 16 (drflac.d:1055-1110), stereo decorrelation
and s32 output shift (drflac_read_s32, drflac.d:2846-2944), SEEKTABLE seek
with decode-and-discard (drflac.d:1767-1811) and brute-force fallback
(drflac.d:1748).

Output: s32-aligned ints converted to float via double multiply by
1/int.max, matching stream.d:503-508 bit-for-bit (done in host f64).
LPC synthesis and stereo decorrelation run on the decoder's torch device
(ops/lpc.py); frames wider than 18 bits take the exact int64 host path.

Deliberate deviations from reference bugs (documented, spec-correct):
* drflac's Rice escape check compares a 4/5-bit value against 16/32
  (drflac.d:1300-1305) so escaped (verbatim) partitions can never trigger;
  we implement the spec's 15/31 escape correctly.
* CRC-8/CRC-16 are parsed but not validated (same as drflac).

Ogg-encapsulated FLAC (drflac.d:2196-2425) is de-encapsulated to a native
stream by the probe.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import AudioFileFormat
from ..device import device_of
from ..errors import AudioFormatError
from ..host import native
from ..io.bits import BitReaderMSB
from ..io.source import ByteSource
from ..ops import lpc as lpc_ops

_NATIVE_CACHE = []


def _native_lib():
    if not _NATIVE_CACHE:
        _NATIVE_CACHE.append(native.get_lib())
    return _NATIVE_CACHE[0]

_SAMPLE_RATE_TABLE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                      32000, 44100, 48000, 96000]
_BPS_TABLE = [0, 8, 12, -1, 16, 20, 24, -1]

_SF_CONSTANT, _SF_VERBATIM, _SF_FIXED, _SF_LPC = range(4)


def probe(src: ByteSource, device="cuda"):
    head = src.peek(4)
    if len(head) == 4 and bytes(head) == b"fLaC":
        try:
            return FlacDecoder(src, device)
        except AudioFormatError:
            return None
    if len(head) == 4 and bytes(head) == b"OggS":
        return _probe_ogg_flac(src, device)
    return None


def _probe_ogg_flac(src: ByteSource, device):
    """Ogg-encapsulated FLAC (drflac.d:2196-2425).

    The first packet is the FLAC mapping header: 0x7F 'FLAC' major minor
    nheaders(u16 BE) followed by a native 'fLaC' signature and STREAMINFO.
    Audio packets are whole FLAC frames.  Since frames are self-delimiting,
    de-encapsulating the packet bytes back into a native FLAC stream lets
    the native decoder (incl. its device pipeline and seek paths) run
    unchanged."""
    from ..io import ogg

    view = src.view()
    page = ogg.parse_page(view, 0)
    if page is None:
        return None
    first = view[page.body_offset : page.body_offset + page.body_size]
    if len(first) < 13 or bytes(first[:5]) != b"\x7fFLAC":
        return None
    reader = ogg.OggPacketReader(view, page.serial)
    pk = reader.next_packet()
    if pk is None:
        return None
    parts = [pk[0][9:]]  # strip the mapping header: native 'fLaC' + metadata
    while True:
        pk = reader.next_packet()
        if pk is None:
            break
        parts.append(pk[0])
    try:
        return FlacDecoder(MemorySourceLike(b"".join(parts)), device)
    except AudioFormatError:
        return None


def _to(dev, *arrays):
    """numpy arrays (or numpy scalars) → tensors on `dev`."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


class MemorySourceLike:
    """Minimal ByteSource over de-encapsulated bytes (decode is view-based)."""

    def __init__(self, data: bytes):
        self._data = data

    def view(self):
        return memoryview(self._data)


@dataclasses.dataclass
class _SeekPoint:
    sample: int  # first sample (per-channel index * channels? spec: sample number)
    offset: int  # byte offset from first frame
    frame_samples: int


@dataclasses.dataclass
class _Subframe:
    stype: int
    order: int
    wasted: int
    coeffs: np.ndarray  # [32] int32
    shift: int
    bps: int  # effective subframe bits per sample
    residual: np.ndarray  # [B] int32, warmup in [:order]


class FlacDecoder:
    format = AudioFileFormat.flac

    def __init__(self, src: ByteSource, device="cuda"):
        self.device = device_of(device)
        self._src = src
        self._view = src.view()
        self._parse_metadata()
        self._cur_bit = self._first_frame_pos * 8
        self._frame_pos = 0  # absolute frame position of the buffer head
        self._buf = np.zeros((0, self.channels), dtype=np.int32)
        self._buf_start = 0

    # ------------------------------------------------------------- metadata
    def _parse_metadata(self) -> None:
        view = self._view
        if len(view) < 42 or bytes(view[:4]) != b"fLaC":
            raise AudioFormatError("Not a FLAC stream")
        pos = 4
        self._seektable: List[_SeekPoint] = []
        got_streaminfo = False
        while True:
            if pos + 4 > len(view):
                raise AudioFormatError("Truncated FLAC metadata")
            hdr = int.from_bytes(view[pos : pos + 4], "big")
            is_last = (hdr >> 31) & 1
            btype = (hdr >> 24) & 0x7F
            size = hdr & 0xFFFFFF
            body_pos = pos + 4
            if body_pos + size > len(view):
                raise AudioFormatError("Truncated FLAC metadata block")
            if btype == 0:  # STREAMINFO (drflac.d:1901-1930)
                b = BitReaderMSB(view[body_pos : body_pos + size])
                self._min_block = b.read(16)
                self._max_block = b.read(16)
                b.read(24)  # min frame size
                b.read(24)  # max frame size
                self.sample_rate = b.read(20)
                self.channels = b.read(3) + 1
                self.bits_per_sample = b.read(5) + 1
                self.length_frames = b.read(36)
                got_streaminfo = True
            elif btype == 3:  # SEEKTABLE
                n = size // 18
                for i in range(n):
                    p = body_pos + i * 18
                    sample = int.from_bytes(view[p : p + 8], "big")
                    offset = int.from_bytes(view[p + 8 : p + 16], "big")
                    fs = int.from_bytes(view[p + 16 : p + 18], "big")
                    if sample != 0xFFFFFFFFFFFFFFFF:  # skip placeholders
                        self._seektable.append(_SeekPoint(sample, offset, fs))
            pos = body_pos + size
            if is_last:
                break
        if not got_streaminfo:
            raise AudioFormatError("FLAC stream without STREAMINFO")
        if self.sample_rate == 0 or self.channels == 0:
            raise AudioFormatError("Invalid STREAMINFO")
        self._first_frame_pos = pos

    # ---------------------------------------------------------- frame parse
    def _read_utf8(self, b: BitReaderMSB) -> int:
        first = b.read(8)
        if first < 0x80:
            return first
        n = 0
        mask = 0x40
        while first & mask:
            n += 1
            mask >>= 1
        if n == 0 or n > 6:
            raise AudioFormatError("Invalid UTF-8 coded number")
        value = first & (0x3F >> n)
        for _ in range(n):
            c = b.read(8)
            if (c & 0xC0) != 0x80:
                raise AudioFormatError("Invalid UTF-8 continuation")
            value = (value << 6) | (c & 0x3F)
        return value

    def _parse_frame(self, b: BitReaderMSB):
        """Parse one frame at the reader's position; returns
        (blocksize, chan_assignment, subframes list) or raises."""
        sync = b.read(14)
        if sync != 0x3FFE:
            raise AudioFormatError("Bad FLAC frame sync")
        b.read(1)  # reserved
        b.read(1)  # blocking strategy
        bs_code = b.read(4)
        sr_code = b.read(4)
        chan_assignment = b.read(4)
        bps_code = b.read(3)
        b.read(1)  # reserved
        self._read_utf8(b)  # frame/sample number (unused: we track position)
        if bs_code == 1:
            blocksize = 192
        elif 2 <= bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = b.read(8) + 1
        elif bs_code == 7:
            blocksize = b.read(16) + 1
        elif bs_code >= 8:
            blocksize = 256 << (bs_code - 8)
        else:
            raise AudioFormatError("Reserved FLAC block size code")
        if sr_code <= 11:
            pass
        elif sr_code == 12:
            b.read(8)
        elif sr_code in (13, 14):
            b.read(16)
        else:
            raise AudioFormatError("Invalid FLAC sample rate code")
        bps = _BPS_TABLE[bps_code]
        if bps == -1:
            raise AudioFormatError("Reserved FLAC bits-per-sample code")
        if bps == 0:
            bps = self.bits_per_sample
        b.read(8)  # CRC-8 (stored, not validated — as drflac)

        if chan_assignment <= 7:
            nch = chan_assignment + 1
        elif chan_assignment <= 10:
            nch = 2
        else:
            raise AudioFormatError("Reserved FLAC channel assignment")
        if nch != self.channels:
            raise AudioFormatError("FLAC frame channel count mismatch")

        subframes = []
        for ci in range(nch):
            sub_bps = bps
            if chan_assignment in (8, 10) and ci == 1:
                sub_bps += 1  # side channel +1 bit (drflac.d:1579-1584)
            elif chan_assignment == 9 and ci == 0:
                sub_bps += 1
            subframes.append(self._parse_subframe(b, blocksize, sub_bps))
        b.align_to_byte()
        b.read(16)  # CRC-16 (stored, not validated)
        return blocksize, chan_assignment, subframes

    def _parse_subframe(self, b: BitReaderMSB, blocksize: int, bps: int) -> _Subframe:
        header = b.read(8)
        if header & 0x80:
            raise AudioFormatError("Invalid FLAC subframe padding bit")
        t = (header & 0x7E) >> 1
        wasted = 0
        if header & 0x01:
            wasted = b.read_unary() + 1
        if wasted >= bps:
            # a corrupt/malicious wasted-bits count would drive the effective
            # sample width to <= 0 (negative shift counts downstream)
            raise AudioFormatError("Invalid FLAC subframe wasted-bits count")
        bps -= wasted
        coeffs = np.zeros(32, dtype=np.int32)
        shift = 0
        if t == 0:
            stype, order = _SF_CONSTANT, 0
            v = b.read_signed(bps)
            residual = np.full(blocksize, v, dtype=np.int32)
            order = blocksize  # pass-through for every t (ops/lpc.py contract)
        elif t == 1:
            stype = _SF_VERBATIM
            residual = np.array(
                [b.read_signed(bps) for _ in range(blocksize)], dtype=np.int32
            )
            order = blocksize
        elif t & 0x20:
            stype = _SF_LPC
            order = (t & 0x1F) + 1
            warmup = [b.read_signed(bps) for _ in range(order)]
            precision = b.read(4)
            if precision == 15:
                raise AudioFormatError("Invalid FLAC LPC precision")
            precision += 1
            shift = b.read_signed(5)
            for j in range(order):
                coeffs[j] = b.read_signed(precision)
            residual = self._read_residual(b, blocksize, order)
            residual[:order] = warmup
        elif t & 0x08:
            stype = _SF_FIXED
            order = t & 0x07
            if order > 4:
                raise AudioFormatError("Reserved FLAC subframe type")
            warmup = [b.read_signed(bps) for _ in range(order)]
            coeffs[:] = lpc_ops.FIXED_COEFFS[order]
            residual = self._read_residual(b, blocksize, order)
            residual[:order] = warmup
        else:
            raise AudioFormatError("Reserved FLAC subframe type")
        return _Subframe(stype, order, wasted, coeffs, max(shift, 0), bps,
                         residual)

    def _read_residual(self, b: BitReaderMSB, blocksize: int, order: int) -> np.ndarray:
        method = b.read(2)
        if method > 1:
            raise AudioFormatError("Unsupported FLAC residual coding method")
        param_bits = 4 if method == 0 else 5
        escape = 15 if method == 0 else 31
        partition_order = b.read(4)
        out = np.zeros(blocksize, dtype=np.int32)
        idx = order
        n_partitions = 1 << partition_order
        base = blocksize >> partition_order
        for p in range(n_partitions):
            count = base - order if p == 0 else base
            if count < 0 or idx + count > blocksize:
                raise AudioFormatError("Invalid FLAC residual partitioning")
            param = b.read(param_bits)
            if param == escape:
                nbits = b.read(5)
                if nbits == 0:
                    out[idx : idx + count] = 0
                else:
                    for i in range(count):
                        out[idx + i] = b.read_signed(nbits)
            else:
                read_unary = b.read_unary
                read = b.read
                vals = out[idx : idx + count]
                for i in range(count):
                    q = read_unary()
                    u = (q << param) | read(param)
                    vals[i] = (u >> 1) ^ -(u & 1)
            idx += count
        return out

    # --------------------------------------------------------------- decode
    def _parse_frame_tensors(self):
        """Host entropy stage for the frame at the bit cursor; returns
        (blocksize, chan_assignment, residual [C,B], coeffs, order, shift,
        wasted, max_bps) or None at EOF/corrupt.  Advances the cursor."""
        if self._cur_bit >= len(self._view) * 8 - 15:
            return None
        lib = _native_lib()
        if lib is not None:
            max_block = self._max_block if 0 < self._max_block <= 65535 else 65535
            nat = native.flac_parse_frame(
                lib, self._view, self._cur_bit, self.bits_per_sample,
                self.channels, max_block,
            )
            if nat is None:
                return None
            self._cur_bit = nat["end_bits"]
            return (
                nat["blocksize"], nat["chan_assignment"], nat["residual"],
                nat["coeffs"], nat["order"], nat["shift"], nat["wasted"],
                nat["bps"],
            )
        b = BitReaderMSB(self._view)
        b.seek_bits(self._cur_bit)
        try:
            blocksize, chan_assignment, subframes = self._parse_frame(b)
        except AudioFormatError:
            return None
        self._cur_bit = b.tell_bits()
        residual = np.stack([s.residual for s in subframes])  # [C, B]
        order = np.array([s.order for s in subframes], dtype=np.int32)
        shift = np.array([s.shift for s in subframes], dtype=np.int32)
        coeffs = np.stack([s.coeffs for s in subframes])
        wasted = np.array([s.wasted for s in subframes], dtype=np.int32)
        return (blocksize, chan_assignment, residual, coeffs, order, shift,
                wasted, np.array([s.bps for s in subframes], dtype=np.int32))

    def _decode_next_frame(self) -> int:
        """Decode the frame at the bit cursor into self._buf (s32-aligned
        ints).  Returns samples per channel (0 on EOF)."""
        parsed = self._parse_frame_tensors()
        if parsed is None:
            return 0
        (blocksize, chan_assignment, residual, coeffs, order, shift, wasted,
         bps) = parsed
        self._buf = self._frame_s32(chan_assignment, residual, coeffs,
                                    order, shift, wasted, bps).T  # [B, C]
        self._buf_start = 0
        return blocksize

    def _frame_s32(self, chan_assignment, residual, coeffs, order, shift,
                   wasted, bps) -> np.ndarray:
        """One frame's LPC + decorrelation → [C, B] s32-aligned numpy."""
        if int(np.max(bps)) > 18:
            # beyond the 18-bit range of the device lanes: exact int64 and
            # post-stereo on the host
            samples = lpc_ops.flac_lpc_np(residual, coeffs, order, shift)
            # drflac stores into int32
            samples = torch.from_numpy(samples.astype(np.int32))
            dev = torch.device("cpu")
        else:
            # drflac's per-subframe 32/64-bit dispatch (drflac.d:1055-1110):
            # bps>16 lanes take the exact path, others wraparound int32
            dev = self.device
            samples = lpc_ops.flac_lpc(*_to(dev, residual, coeffs, order,
                                            shift, np.asarray(bps) > 16))
        out = lpc_ops.flac_post_stereo(
            samples, *_to(dev, np.int32(chan_assignment), wasted,
                          np.int32(32 - self.bits_per_sample)))
        return out.cpu().numpy()

    # frames per device call on the single-stream facade (FLAC frames are
    # independent, so they batch as lanes; per-frame dispatch pays one
    # host<->device round-trip per ~90 ms of audio)
    _FACADE_WINDOW = 32

    def _decode_window_into_buf(self) -> int:
        """Parse up to _FACADE_WINDOW frames and synthesize them with one
        batched device call; falls back to the per-frame path for ragged
        windows (blocksize change, >18-bit subframes, EOF tail)."""
        parsed = []
        while len(parsed) < self._FACADE_WINDOW:
            p = self._parse_frame_tensors()
            if p is None:
                break
            parsed.append(p)
            if p[0] != parsed[0][0]:
                break  # blocksize change (final frame): keep shapes static
        if not parsed:
            return 0
        C = self.channels
        n_same = 1
        while (n_same < len(parsed) and
               parsed[n_same][0] == parsed[0][0]):
            n_same += 1
        prefix, rest = parsed[:n_same], parsed[n_same:]
        if any(int(np.max(p[7])) > 18 for p in prefix):
            prefix, rest = [], parsed  # >18-bit subframes: exact host path
        bufs = []
        if prefix:
            # pad to the static window width with silent frames (FLAC
            # frames are independent; pad output is sliced away)
            n_real = len(prefix)
            B = prefix[0][0]
            W = self._FACADE_WINDOW
            if n_real < W:
                pad = (B, 0, np.zeros((C, B), np.int32),
                       np.zeros((C, 32), np.int32),
                       np.zeros(C, np.int32), np.zeros(C, np.int32),
                       np.zeros(C, np.int32), prefix[0][7])
                prefix = prefix + [pad] * (W - n_real)
            residual = np.stack([p[2] for p in prefix]).reshape(W * C, B)
            coeffs = np.stack([p[3] for p in prefix]).reshape(W * C, -1)
            order = np.stack([p[4] for p in prefix]).reshape(W * C)
            shift = np.stack([p[5] for p in prefix]).reshape(W * C)
            bps = np.stack([p[7] for p in prefix]).reshape(W * C)
            dev = self.device
            samples = lpc_ops.flac_lpc(*_to(dev, residual, coeffs, order,
                                            shift, bps > 16))
            out = lpc_ops.flac_post_stereo_batch(
                samples.reshape(W, C, B), *_to(
                    dev, np.array([p[1] for p in prefix], np.int32),
                    np.stack([p[6] for p in prefix]),
                    np.full(W, 32 - self.bits_per_sample, np.int32)))
            out = out.cpu().numpy()
            bufs.append(
                out.transpose(0, 2, 1).reshape(W * B, C)[: n_real * B])
        for p in rest:
            bufs.append(self._frame_s32(p[1], *p[2:]).T)
        self._buf = np.concatenate(bufs, axis=0)
        self._buf_start = 0
        return self._buf.shape[0]

    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        # Invariant: _frame_pos is the absolute per-channel index of
        # self._buf[0]; _buf_start is the consumed prefix of the buffer.
        chunks = []
        got = 0
        while got < max_frames:
            avail = self._buf.shape[0] - self._buf_start
            if avail == 0:
                next_pos = self._frame_pos + self._buf.shape[0]
                if self.length_frames and next_pos >= self.length_frames:
                    break  # don't scan past the known end (stream.d:499-500)
                n = self._decode_window_into_buf()
                if n == 0:
                    break
                self._frame_pos = next_pos
                avail = n
            take = min(avail, max_frames - got)
            chunks.append(self._buf[self._buf_start : self._buf_start + take])
            self._buf_start += take
            got += take
        if not chunks:
            return np.zeros((0, self.channels), dtype=dtype)
        s32 = np.concatenate(chunks, axis=0)
        # float = s32 * (1.0 / int.max) in double, then narrowed
        # (stream.d:503-512).
        f = s32.astype(np.float64) * (1.0 / 2147483647.0)
        return f.astype(dtype)

    # ----------------------------------------------------------------- seek
    def tell(self) -> int:
        return self._frame_pos + self._buf_start

    def seek(self, frame: int) -> bool:
        if frame < 0 or frame > self.length_frames:
            return False
        cur = self.tell()
        if frame == cur:
            return True
        if frame == self.length_frames:
            # always succeed for end-of-stream (stream.d:1123-1125)
            self._cur_bit = len(self._view) * 8
            self._frame_pos = frame
            self._buf = np.zeros((0, self.channels), dtype=np.int32)
            self._buf_start = 0
            return True
        # If the target is inside the current buffer, just move the cursor.
        if self._frame_pos <= frame < self._frame_pos + self._buf.shape[0]:
            self._buf_start = frame - self._frame_pos
            return True

        start_bit = self._first_frame_pos * 8
        start_frame = 0
        if self._seektable:
            # closest seekpoint at or before the target (drflac.d:1781-1803);
            # seekpoint sample numbers are per-channel sample indices.
            best = None
            for sp in self._seektable:
                if sp.sample <= frame and (best is None or sp.sample > best.sample):
                    best = sp
            if best is not None:
                start_bit = (self._first_frame_pos + best.offset) * 8
                start_frame = best.sample
        # Linear forward decode from the current frame when it's closer.
        frame_end = self._frame_pos + self._buf.shape[0]
        if frame_end <= frame and frame_end > start_frame and self._buf.shape[0] > 0:
            start_bit = self._cur_bit
            start_frame = frame_end

        self._cur_bit = start_bit
        self._frame_pos = start_frame
        self._buf = np.zeros((0, self.channels), dtype=np.int32)
        self._buf_start = 0
        # decode-and-discard until the frame containing the target
        while True:
            n = self._decode_next_frame()
            if n == 0:
                return False
            if self._frame_pos + n > frame:
                self._buf_start = frame - self._frame_pos
                return True
            self._frame_pos += n
            self._buf = np.zeros((0, self.channels), dtype=np.int32)
