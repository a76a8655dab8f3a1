"""Streams of every format for the port's facade tests and for
chip_smoke.py's facade phase, made from a seed with numpy and the in-repo
golden coders.

Imports nothing of JAX or of the JAX package: the Vorbis builder, whose
golden module imports tables of the JAX package, is taken as an argument
(the tests pass tests/golden's module, chip_smoke.py its copy loaded with
the port's tables).
"""

from __future__ import annotations

import numpy as np

from golden import flac_ref, mod_ref, qoa_ref, wav_ref, xm_ref

SR = 44100


def music_s16(seed: int, frames: int, channels: int = 2) -> np.ndarray:
    """int64 s16 PCM [frames, channels]: two detuned partials under a
    slow swell, and a little noise."""
    rng = np.random.default_rng([5, seed])
    t = np.arange(frames)[:, None] / SR
    f0 = rng.uniform(80, 800)
    amp = rng.uniform(4000, 12000)
    det = np.array([1.0, 1.003, 0.997, 1.006][:channels])
    swell = 0.7 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
    x = (amp * swell * np.sin(2 * np.pi * f0 * t * det)
         + 0.3 * amp * np.sin(2 * np.pi * 2.7 * f0 * t * det[::-1])
         + rng.uniform(100, 800) * rng.standard_normal((frames, channels)))
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


def flac_stream(pcm: np.ndarray, block_size: int = 4096) -> bytes:
    """A 16-bit FLAC stream of `pcm` (mid/side LPC-8 when stereo)."""
    stereo = pcm.shape[1] == 2
    return flac_ref.build_flac(
        pcm, SR, 16, block_size=block_size,
        stereo_mode="mid_side" if stereo else "independent",
        modes=["lpc8"] * pcm.shape[1])


def wav_stream(pcm: np.ndarray, bits: int = 16) -> bytes:
    """A linear-PCM WAV stream of integer `pcm` [frames, channels]."""
    return wav_ref.build_wav(wav_ref.pack_pcm(pcm.reshape(-1), bits),
                             fmt_tag=1, channels=pcm.shape[1],
                             sample_rate=SR, bits=bits)


def qoa_stream(pcm: np.ndarray) -> bytes:
    """The golden QOA encoder's stream of s16 `pcm` (slow: ~9 s a second
    of stereo audio on one core)."""
    return qoa_ref.encode(pcm.astype(np.int16), SR)


def vorbis_stream(vorbis_ref, seed: int, packets: int) -> bytes:
    """A stereo coupled Ogg Vorbis stream (block sizes 512/2048): random
    floor posts and grid residues, mostly long blocks with a short pair
    every so often."""
    rng = np.random.default_rng([23, seed])
    fix = vorbis_ref.Fixture(channels=2, bs0=512, bs1=2048, coupling=True)
    pattern = [1] * packets
    for j in range(3, packets - 2, 12):
        pattern[j] = pattern[j + 1] = 0
    pkts = []
    for j in range(packets):
        n2 = (2048 if pattern[j] else 512) // 2
        posts = [[int(rng.integers(40, 100)) for _ in range(4)]
                 for _ in range(2)]
        res = []
        for _ in range(2):
            r = np.zeros(n2)
            idx = rng.choice(n2, n2 // 4, replace=False)
            r[idx] = rng.integers(-5, 6, idx.size) * fix.vq_delta
            res.append(r)
        pkts.append(fix.audio_packet(
            posts, res, long_block=bool(pattern[j]),
            prev_flag=pattern[j - 1] if j else 1,
            next_flag=pattern[j + 1] if j + 1 < packets else 1))
    return fix.build(pkts)


def _mod_samples():
    """Three looped 8-bit instruments: a saw, a square and a sine."""
    n = np.arange(64)
    sine = np.round(100 * np.sin(2 * np.pi * n / 64)).astype(np.int8)
    square = np.where(n < 32, 90, -90).astype(np.int8)
    return [(mod_ref.saw_sample(64), 64, 0, 0, 64),
            (square, 48, 0, 0, 64),
            (sine, 56, 0, 0, 64)]


#: MOD effects a song draws from: none, arpeggio, portamento up and down,
#: vibrato, volume slide, set volume (the parameter is drawn at random)
_MOD_EFFECTS = (0x0, 0x0, 0x0, 0x0, 0x1, 0x2, 0x4, 0xA, 0xC)


def mod_song(seed: int, n_orders: int, rows: int = 64) -> bytes:
    """A 4-channel M.K. module of `n_orders` distinct patterns played in
    order: notes of the three instruments on random rows of every channel,
    with effects.  Each pattern breaks to the next after `rows` rows; at
    speed 6 and 125 BPM a row lasts 5,292 frames (0.12 s)."""
    rng = np.random.default_rng([29, seed])
    pats = []
    for _ in range(n_orders):
        pat = mod_ref.empty_pattern()
        for r in range(rows):
            for c in range(4):
                if rng.random() < 0.3:
                    fx = int(rng.choice(_MOD_EFFECTS))
                    param = int(rng.integers(0, 64)) if fx == 0xC else \
                        int(rng.integers(1, 16)) * (17 if fx == 0x4 else 1)
                    pat[r][c] = mod_ref.cell(
                        sample=int(rng.integers(1, 4)),
                        period=int(rng.choice(mod_ref.PERIODS[6:30])),
                        effect=fx, param=param)
        if rows < 64:
            last = pat[rows - 1][3]
            pat[rows - 1][3] = last[:2] + bytes([(last[2] & 0xF0) | 0xD, 0])
        pats.append(pat)
    return mod_ref.build_mod(pats, list(range(n_orders)), _mod_samples())


def _xm_instruments():
    """A looped 8-bit square with a volume envelope and fadeout, a
    ping-pong 16-bit sine, and a one-shot 8-bit saw."""
    n = np.arange(64)
    square = np.where(n < 32, 100, -100).astype(np.int8)
    sine = np.round(20000 * np.sin(2 * np.pi * n / 64)).astype(np.int16)
    saw = np.linspace(-110, 110, 2048).astype(np.int8)
    return [
        {"samples": [{"data": square, "volume": 64, "loop_type": 1,
                      "loop_start": 0, "loop_len": 64, "relative_note": 0,
                      "bits": 8}],
         "vol_env": {"points": [(0, 64), (24, 40), (96, 0)],
                     "sustain_on": False}, "fadeout": 1024},
        {"samples": [{"data": sine, "volume": 48, "loop_type": 2,
                      "loop_start": 8, "loop_len": 48, "relative_note": 12,
                      "bits": 16}]},
        {"samples": [{"data": saw, "volume": 56, "loop_type": 0,
                      "loop_start": 0, "loop_len": 0, "relative_note": -12,
                      "bits": 8}]},
    ]


#: XM effects a song draws from: none, arpeggio, portamento up and down,
#: vibrato, volume slide, set volume, set panning
_XM_EFFECTS = (0x0, 0x0, 0x0, 0x0, 0x1, 0x2, 0x4, 0xA, 0xC, 0x8)


def xm_song(seed: int, n_orders: int, rows: int = 64,
            channels: int = 4) -> bytes:
    """An XM module of `n_orders` distinct patterns of `rows` rows played in
    order (linear frequencies, speed 6, 125 BPM: a row lasts 5,292
    frames): notes of the three instruments on random rows with effects,
    volume-column values and key-offs."""
    rng = np.random.default_rng([31, seed])
    pats = []
    for _ in range(n_orders):
        pat = xm_ref.empty_rows(rows, channels)
        for r in range(rows):
            for c in range(channels):
                u = rng.random()
                if u < 0.25:
                    fx = int(rng.choice(_XM_EFFECTS))
                    param = int(rng.integers(0, 64)) if fx == 0xC else \
                        int(rng.integers(0, 256)) if fx == 0x8 else \
                        int(rng.integers(1, 16)) * (17 if fx == 0x4 else 1)
                    vol = int(rng.integers(0x10, 0x51)) \
                        if rng.random() < 0.3 else 0
                    pat[r][c] = xm_ref.cell(
                        note=int(rng.integers(37, 73)),
                        instr=int(rng.integers(1, 4)), vol=vol, fx=fx,
                        param=param)
                elif u < 0.28:
                    pat[r][c] = xm_ref.cell(note=97)  # key off
        pats.append(pat)
    return xm_ref.build_xm(pats, list(range(n_orders)), _xm_instruments(),
                           channels=channels)



def dryrun_items(n_lanes: int, mp3_ref, opus_ref, vorbis_ref,
                 silk_packets) -> list:
    """The JAX package's multi-device dryrun lanes, built as its
    __graft_entry__.py builds them: n_lanes // 2 stereo Layer III lanes and
    as many mid/side FLAC lanes, two Layer II lanes, a SILK-only and a
    mode-switching Opus lane, two Vorbis lanes.  The golden MP3, Opus and
    Vorbis builders and the SILK packets (hex) are taken as arguments, as
    vorbis_stream takes its builder."""
    rng = np.random.default_rng(0)
    frames = []
    for i in range(4):
        grs = []
        for _g in range(2):
            q = np.zeros(576, np.int64)
            q[rng.choice(300, 25, replace=False)] = rng.integers(-20, 21, 25)
            gr = {"q": q}
            if i == 2:
                gr["block_type"] = 2
            grs.append([dict(gr), dict(gr.copy())])
        frames.append(grs)
    mp3_data = mp3_ref.build_mp3(frames, channels=2, mode_ext=[0, 2, 0, 2])
    t = np.arange(3000)[:, None]
    x = np.clip(np.round(
        9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4] / SR)), -32768,
        32767).astype(np.int64)
    flac_data = flac_ref.build_flac(x, SR, 16, block_size=1024,
                                    stereo_mode="mid_side",
                                    modes=["lpc8", "fixed3"])
    gq = rng.integers(0, 16, size=(3, 3, 30, 12)).tolist()
    scfs = rng.integers(0, 60, size=(3, 30)).tolist()
    l2_data = mp3_ref.build_mp3_l2(gq, scfs, ba=4)[0]
    silk_pkts = [(bytes.fromhex(h), 960) for h in silk_packets]
    cpkt, cn = opus_ref.silence_packet(config=17)
    mixed_pkts = [silk_pkts[0], silk_pkts[1], (cpkt, cn),
                  silk_pkts[2 % len(silk_pkts)], (cpkt, cn)]
    fix = vorbis_ref.Fixture(channels=1)
    vframes = []
    for _ in range(6):
        r = np.zeros(fix.bs0 // 2)
        idx = rng.choice(len(r), 30, replace=False)
        r[idx] = rng.integers(-5, 6, 30) * fix.vq_delta
        vframes.append(fix.audio_packet([[60, 70, 80, 90]], [r]))
    half = n_lanes // 2
    return ([mp3_data] * half + [flac_data] * half + [l2_data, l2_data]
            + [opus_ref.build_ogg_opus(silk_pkts, channels=1, preskip=0),
               opus_ref.build_ogg_opus(mixed_pkts, channels=1, preskip=0)]
            + [fix.build(vframes)] * 2)
