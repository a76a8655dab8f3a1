"""The port's speech Ogg Opus corpus: real libopus SILK, hybrid and
mode-switching packets, committed as data (``torch_opus_speech.bin``) so
that neither the CPU tests nor the card need libopus.

Recipe (``encode_masters``, run once where libopus is installed,
``python tests/torch_opus_speech_cases.py`` rewrites the file): seeded
synthetic 48 kHz speech (a glottal pulse train whose f0 glides over
90-250 Hz, through three moving formant resonators, in syllables with
pauses), encoded by ``golden.opus_oracle.OracleEncoder`` with
OPUS_APPLICATION_VOIP, 20 ms frames, its mode forced with ctl 11002
(OPUS_SET_FORCE_MODE) and its bandwidth set:

- SILK: four mono masters and a stereo one, wideband (config 9), at 20
  and 32 kbit/s, 4 s;
- hybrid: four mono masters and a stereo one, fullband (config 15), at 32
  and 48 kbit/s, 4 s;
- tour: two mono masters that change mode every ~0.25 s (SILK WB, CELT
  FB, hybrid SWB in turn) at 24-40 kbit/s, 4 s.

``encode_masters`` asserts what keeps every lane in its lockstep group:
each SILK master is one (config, stereo, frames) shape with no redundancy
tail, each hybrid master one (config, stereo) shape of single frames, and
each tour master holds all three modes.

File layout (little-endian), that of tests/torch_opus_cases.py with its
own magic: b"AFOPUSS1", u32 masters; per master u8 channels, u16 frame
size (48 kHz samples), u32 packets, then each packet as u16 length and its
bytes.  ``MASTERS`` gives each master's kind in file order.

This module imports numpy only (libopus inside ``encode_masters``), so the
card's smoke test can read the corpus with it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_opus_speech.bin")
MAGIC = b"AFOPUSS1"
RATE = 48000
FRAME = 960   # 20 ms
SECONDS = 4.0
#: (seed, kind, channels, bit rate) of each master, in file order
MASTERS = (
    (1, "silk", 1, 20000), (2, "silk", 1, 32000), (3, "silk", 1, 20000),
    (4, "silk", 1, 32000), (5, "silk", 2, 32000),
    (6, "hybrid", 1, 32000), (7, "hybrid", 1, 48000),
    (8, "hybrid", 1, 32000), (9, "hybrid", 1, 48000),
    (10, "hybrid", 2, 48000),
    (11, "tour", 1, 24000), (12, "tour", 1, 40000),
)
#: OPUS_SET_FORCE_MODE (opus_private.h) and its modes
FORCE_MODE = 11002
MODE_SILK, MODE_HYBRID, MODE_CELT = 1000, 1001, 1002
#: the tour's (mode, bandwidth name) in turn, ~0.25 s (12 or 13 packets) each
TOUR = ((MODE_SILK, "WIDEBAND"), (MODE_CELT, "FULLBAND"),
        (MODE_HYBRID, "SUPERWIDEBAND"))


def kinds():
    """Each master's kind ("silk", "hybrid" or "tour"), in file order."""
    return [k for _, k, _, _ in MASTERS]


def speech(seed: int, channels: int, seconds: float = SECONDS) -> np.ndarray:
    """Seeded synthetic speech, int16 [frames, channels]: a glottal pulse
    train (f0 gliding over 90-250 Hz) through three formant resonators
    whose centres move, in syllables of 0.12-0.35 s between pauses of
    0.08-0.4 s, with a little aspiration noise.  A stereo master's second
    channel is the first delayed and scaled, plus its own noise."""
    rng = np.random.default_rng([47, seed])
    n = int(round(seconds * RATE))
    t = np.arange(n) / RATE
    f0 = 170.0 + 80.0 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t
                               + rng.uniform(0, 6.3))
    phase = np.cumsum(f0) / RATE
    exc = np.zeros(n)
    exc[1:][np.diff(np.floor(phase)) > 0] = 1.0
    # a glottal pulse's shape: a short decaying ramp
    exc = np.convolve(exc, np.hanning(48) * np.linspace(1, 0.2, 48))[:n]
    exc += 0.03 * rng.standard_normal(n)
    # syllables and pauses
    env = np.zeros(n)
    pos = int(rng.integers(0, 4000))
    while pos < n:
        m = int(rng.uniform(0.12, 0.35) * RATE)
        seg = np.hanning(m) ** 0.5 * rng.uniform(0.5, 1.0)
        env[pos: pos + m] = seg[: n - pos]
        pos += m + int(rng.uniform(0.08, 0.4) * RATE)
    # three resonators, centres moving a 10 ms block at a time
    out = np.zeros(n)
    lo, hi = np.array([300.0, 900.0, 2400.0]), np.array([800.0, 2200.0,
                                                         3100.0])
    rates = rng.uniform(0.5, 2.5, 3)
    offs = rng.uniform(0, 6.3, 3)
    state = np.zeros((3, 2))
    blk = 480
    for b0 in range(0, n, blk):
        x = exc[b0: b0 + blk] * env[b0: b0 + blk]
        tt = b0 / RATE
        y = np.zeros_like(x)
        for f in range(3):
            fc = lo[f] + (hi[f] - lo[f]) * (0.5 + 0.5 * np.sin(
                2 * np.pi * rates[f] * tt + offs[f]))
            r = np.exp(-np.pi * (70.0 + 40.0 * f) / RATE)
            a1, a2 = 2 * r * np.cos(2 * np.pi * fc / RATE), -r * r
            y1, y2 = state[f]
            g = (1 - r) * (1.5 - 0.4 * f)
            for i in range(x.shape[0]):
                v = g * x[i] + a1 * y1 + a2 * y2
                y[i] += v
                y2, y1 = y1, v
            state[f] = (y1, y2)
        out[b0: b0 + blk] = y
    out *= 0.5 / (np.abs(out).max() + 1e-12)
    if channels == 2:
        d = int(rng.integers(5, 40))
        right = 0.8 * np.concatenate([np.zeros(d), out[:-d]]) \
            + 0.004 * rng.standard_normal(n)
        out = np.stack([out, right], 1)
    else:
        out = out[:, None]
    return np.clip(np.round(out * 32767), -32768, 32767).astype(np.int16)


def _encoder(oo, channels, rate):
    enc = oo.OracleEncoder(channels=channels, bitrate=rate,
                           application=oo.OPUS_APPLICATION_VOIP,
                           signal=oo.OPUS_SIGNAL_VOICE)
    if channels == 2:
        oo.get_lib().opus_encoder_ctl(_handle(enc),
                                      oo.OPUS_SET_FORCE_CHANNELS, 2)
    return enc


def _handle(enc):
    import ctypes

    return ctypes.c_void_p(enc._enc)


def _set(oo, enc, mode, bandwidth):
    lib = oo.get_lib()
    lib.opus_encoder_ctl(_handle(enc), oo.OPUS_SET_BANDWIDTH,
                         getattr(oo, "OPUS_BANDWIDTH_" + bandwidth))
    lib.opus_encoder_ctl(_handle(enc), FORCE_MODE, mode)


def _silk_tail(pkts, channels):
    """Whether any SILK frame of `pkts` leaves bits unread (a redundancy
    tail, which sends a lane out of the SILK group): the port's SILK
    decoder over each frame, as the group reads them."""
    from audio_formats_torch.models.opus import RangeDecoder, parse_packet
    from audio_formats_torch.models.silk import SilkDecoder

    dec = SilkDecoder(output_channels=channels)
    for p in pkts:
        pk = parse_packet(p)
        for fr in pk["frames"]:
            rd = RangeDecoder(fr)
            dec.decode_superframe(rd, pk["config"] // 4,
                                  2 if pk["stereo"] else 1,
                                  [10, 20, 40, 60][pk["config"] & 3])
            if rd.tell() + 17 <= len(fr) * 8:
                return True
    return False


def encode_masters():
    """The corpus: [(channels, frame size, [packet bytes])], made with the
    system libopus; asserts each master's shape (see the module's
    docstring)."""
    from golden import opus_oracle as oo

    from audio_formats_torch.models.opus import parse_packet

    masters = []
    for seed, kind, ch, rate in MASTERS:
        pcm = speech(seed, ch)
        enc = _encoder(oo, ch, rate)
        n_pk = pcm.shape[0] // FRAME
        pkts = []
        for i in range(n_pk):
            if kind == "silk":
                _set(oo, enc, MODE_SILK, "WIDEBAND")
            elif kind == "hybrid":
                _set(oo, enc, MODE_HYBRID, "FULLBAND")
            else:
                mode, bw = TOUR[(i * 4 // 50) % len(TOUR)]
                _set(oo, enc, mode, bw)
            pkts.append(enc.encode(pcm[i * FRAME: (i + 1) * FRAME]))
        parsed = [parse_packet(p) for p in pkts]
        if kind == "silk":
            keys = {(pk["mode"], pk["config"], pk["stereo"],
                     len(pk["frames"])) for pk in parsed}
            assert keys == {("silk", 9, ch == 2, 1)}, (seed, keys)
            assert not _silk_tail(pkts, ch), seed
        elif kind == "hybrid":
            keys = {(pk["mode"], pk["config"], pk["stereo"],
                     len(pk["frames"])) for pk in parsed}
            assert keys == {("hybrid", 15, ch == 2, 1)}, (seed, keys)
        else:
            modes = {pk["mode"] for pk in parsed}
            assert modes == {"silk", "celt", "hybrid"}, (seed, modes)
        masters.append((ch, FRAME, pkts))
    return masters


def write(masters, path=PATH):
    parts = [MAGIC, struct.pack("<I", len(masters))]
    for ch, fs, pkts in masters:
        parts.append(struct.pack("<BHI", ch, fs, len(pkts)))
        for p in pkts:
            parts.append(struct.pack("<H", len(p)) + p)
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def load(path=PATH):
    """The committed corpus: [(channels, frame size, [packet bytes])], in
    the order of MASTERS."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not an Opus speech corpus file")
    (n,) = struct.unpack_from("<I", data, 8)
    off = 12
    masters = []
    for _ in range(n):
        ch, fs, count = struct.unpack_from("<BHI", data, off)
        off += 7
        pkts = []
        for _ in range(count):
            (ln,) = struct.unpack_from("<H", data, off)
            pkts.append(data[off + 2: off + 2 + ln])
            off += 2 + ln
        masters.append((ch, fs, pkts))
    if off != len(data):
        raise ValueError(f"{path}: {len(data) - off} bytes past the corpus")
    return masters


def stream(build_ogg_opus, master, n_packets=None, preskip=312):
    """An Ogg Opus stream of the first `n_packets` packets of `master`
    (all by default), built by golden.opus_ref.build_ogg_opus."""
    ch, fs, pkts = master
    return build_ogg_opus([(p, fs) for p in pkts[:n_packets]], channels=ch,
                          preskip=preskip)


if __name__ == "__main__":
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    m = encode_masters()
    write(m)
    print(f"{PATH}: {os.path.getsize(PATH)} bytes, "
          f"{sum(len(p) for _, _, p in m)} packets")
