"""The port's CELT-only Ogg Opus corpus: real libopus packets, committed as
data (``torch_opus_celt.bin``) so that neither the CPU tests nor the card
need libopus.

Recipe (``encode_masters``, run once where libopus is installed,
``python tests/torch_opus_cases.py`` rewrites the file): seeded synthetic
48 kHz music (tones with vibrato, noise, and decaying clicks that make the
encoder pick short blocks), encoded by ``golden.opus_oracle.OracleEncoder``
with OPUS_APPLICATION_AUDIO, OPUS_SIGNAL_MUSIC, fullband, 20 ms frames:
four stereo masters of 4 s at 96–128 kbit/s and one mono master of 1 s at
64 kbit/s.  libopus codes all of them CELT-only.

File layout (little-endian): b"AFOPUSC1", u32 masters; per master u8
channels, u16 frame size (48 kHz samples), u32 packets, then each packet as
u16 length and its bytes.

This module imports numpy only (libopus inside ``encode_masters``), so the
card's smoke test can read the corpus with it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_opus_celt.bin")
MAGIC = b"AFOPUSC1"
RATE = 48000
FRAME = 960   # 20 ms
#: (seed, channels, seconds, bit rate) of each master
MASTERS = ((1, 2, 4.0, 96000), (2, 2, 4.0, 112000), (3, 2, 4.0, 128000),
           (4, 2, 4.0, 104000), (5, 1, 1.0, 64000))


def music(seed: int, channels: int, seconds: float) -> np.ndarray:
    """Seeded synthetic music, int16 [frames, channels]: a few tones with
    vibrato and their own pan, band-limited noise, and decaying clicks every
    0.2–0.6 s."""
    rng = np.random.default_rng([31, seed])
    n = int(round(seconds * RATE))
    t = np.arange(n) / RATE
    out = np.zeros((n, channels))
    for _ in range(4):
        f0 = rng.uniform(110.0, 1800.0)
        vib = 1.0 + 0.004 * np.sin(2 * np.pi * rng.uniform(3, 7) * t)
        phase = 2 * np.pi * np.cumsum(f0 * vib) / RATE
        tone = rng.uniform(0.04, 0.12) * np.sin(phase + rng.uniform(0, 6.3))
        pan = rng.uniform(0.2, 0.8, channels)
        out += tone[:, None] * pan[None, :]
    noise = rng.standard_normal((n, channels))
    kernel = np.hanning(9)
    noise = np.stack([np.convolve(noise[:, c], kernel / kernel.sum(),
                                  mode="same") for c in range(channels)], 1)
    out += 0.02 * noise
    pos = int(rng.integers(2000, 9000))
    while pos < n:
        m = min(n - pos, 4800)
        env = np.exp(-np.arange(m) / rng.uniform(200.0, 900.0))
        click = rng.uniform(0.2, 0.45) * env * rng.standard_normal(m)
        out[pos:pos + m] += click[:, None] * rng.uniform(0.5, 1.0, channels)
        pos += int(rng.integers(int(0.2 * RATE), int(0.6 * RATE)))
    return np.clip(np.round(out * 32767), -32768, 32767).astype(np.int16)


def encode_masters():
    """The corpus: [(channels, frame size, [packet bytes])], made with the
    system libopus."""
    from golden import opus_oracle as oo

    masters = []
    for seed, ch, secs, rate in MASTERS:
        enc = oo.OracleEncoder(channels=ch, bitrate=rate,
                               application=oo.OPUS_APPLICATION_AUDIO,
                               signal=oo.OPUS_SIGNAL_MUSIC,
                               bandwidth=oo.OPUS_BANDWIDTH_FULLBAND)
        pcm = music(seed, ch, secs)
        pkts = [enc.encode(pcm[i:i + FRAME])
                for i in range(0, pcm.shape[0] - FRAME + 1, FRAME)]
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
    """The committed corpus: [(channels, frame size, [packet bytes])]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not an Opus corpus file")
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


def stream(build_ogg_opus, master, n_packets=None, channels=None,
           preskip=312):
    """An Ogg Opus stream of the first `n_packets` packets of `master`
    (all by default), with `channels` in its header (the master's by
    default: 1 on a stereo master gives a stereo-coded stream with a mono
    header), built by golden.opus_ref.build_ogg_opus."""
    ch, fs, pkts = master
    pkts = pkts[:n_packets]
    return build_ogg_opus([(p, fs) for p in pkts],
                          channels=ch if channels is None else channels,
                          preskip=preskip)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    m = encode_masters()
    write(m)
    print(f"{PATH}: {os.path.getsize(PATH)} bytes, "
          f"{sum(len(p) for _, _, p in m)} packets")
