"""PCM and Vorbis-window inputs shared by the CPU tests (the port's twins
against JAX) and the card tests (K10 and K11 against the twins), and the
reference's double-math decode."""

import numpy as np

SCALE = {"u8": 127.0, "s16": 32767.0, "s24": 8388607.0, "s32": 2147483648.0}
KIND_BYTES = {"u8": 1, "s16": 2, "s24": 3, "s32": 4}
KINDS = ("u8", "s16", "s24", "s32")
SEEDS = (0, 7, 0xFFFFFFFF)


def int_pcm_to_float_np(x: np.ndarray, kind: str) -> np.ndarray:
    """The reference's decode scaling in double math (wav.d:297-330), the
    JAX package's host golden model: int32 samples (u8 raw 0..255) → f32."""
    xf = x.astype(np.float64)
    if kind == "u8":
        return ((xf - 128.0) / 127.0).astype(np.float32)
    return (xf / SCALE[kind]).astype(np.float32)


def pack_ints(ints: np.ndarray, kind: str) -> np.ndarray:
    """int32 samples (u8 raw 0..255) → their little-endian payload bytes,
    uint8."""
    bps = KIND_BYTES[kind]
    u = ints.astype(np.int64) & 0xFFFFFFFF
    return np.stack([(u >> (8 * i)) & 0xFF for i in range(bps)], -1) \
        .astype(np.uint8).reshape(-1)


def decode_ints(kind: str, rng=None, n=1 << 16) -> np.ndarray:
    """Every u8 and s16 value; n random s24 and s32 values with the
    extremes."""
    if kind == "u8":
        return np.arange(256, dtype=np.int32)
    if kind == "s16":
        return np.arange(-32768, 32768, dtype=np.int32)
    bits = 8 * KIND_BYTES[kind]
    rng = rng or np.random.default_rng(81)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    v = rng.integers(lo, hi + 1, n, dtype=np.int64)
    v[:6] = (lo, lo + 1, -1, 0, 1, hi)
    return v.astype(np.int32)


def edge_values(kind: str) -> np.ndarray:
    """f32 values around the quantizer's decisions: x·scale = k + 0.5 and
    the f32 neighbours on each side, for k across the range; ±1 and their
    neighbours; zeros, tiny values, out-of-range values, ±inf and NaN."""
    scale = SCALE[kind]
    ks = np.concatenate([np.arange(-40, 40), np.round(
        np.linspace(-scale, scale - 1, 200))]).astype(np.float64)
    mid = ((ks + 0.5) / scale).astype(np.float32)
    f = np.float32
    vals = [mid, np.nextafter(mid, f(np.inf)), np.nextafter(mid, f(-np.inf)),
            np.nextafter(np.nextafter(mid, f(np.inf)), f(np.inf)),
            np.array([1, -1, 0, -0.0, 1e-30, -1e-30, 1e-45, 2.5, -7.0,
                      1e30, -1e30, np.inf, -np.inf, np.nan], np.float32),
            np.nextafter(np.float32([1, -1]), f(0)),
            np.nextafter(np.float32([1, -1]), f(np.inf))]
    return np.concatenate(vals).astype(np.float32)


def quantize_rows(kind: str, rng=None, lengths=(1000, 777, 1024, 5)):
    """Rows [L, max(lengths)] of f32 samples zero past each row's length:
    noise at three levels (clipping in the loudest) with each kind's edge
    values in the first row.  Returns (rows, lens)."""
    rng = rng or np.random.default_rng(82)
    n = max(lengths)
    rows = np.zeros((len(lengths), n), np.float32)
    for i, ln in enumerate(lengths):
        rows[i, :ln] = rng.standard_normal(ln) * (0.05, 0.5, 1.5)[i % 3]
    e = edge_values(kind)[:lengths[0]]
    rows[0, :e.size] = e
    return rows, np.array(lengths)


# ------------------------------------------------------- Vorbis window chain
def vorbis_geometry(n: int, long_block: bool, prev_long: bool,
                    next_long: bool, bs0: int):
    """(left_start, right_start, right_end) of a packet of block size n
    (models/vorbis.py:_packet_entropy)."""
    if long_block and not prev_long:
        ls = (n - bs0) >> 2
    else:
        ls = 0
    if long_block and not next_long:
        return ls, (n * 3 - bs0) >> 2, (n * 3 + bs0) >> 2
    return ls, n // 2, n


def vorbis_chain_case(seed: int, B: int, ch: int, K: int, bs0: int,
                      bs1: int, *, lies=False, empty: float = 0.15):
    """One window of the Vorbis lapped chain: spectra X [K, B*ch, bs1/2]
    (short slots fill [:bs0/2]), geometry [4, K, B] (ls, rs, re, valid) of
    mixed long and short packets with their transitions, empty (valid 0)
    slots, and a carry (lap [L, bs1/2], lap_len [B], had_prev [B]) where
    the first lanes are unprimed and the others carry a lap of either
    width.  ``lies``: each long packet's prev/next flags are drawn at
    random instead of from its neighbours (what a damaged stream gives);
    a float: the share of lanes, drawn at random, whose packets lie.
    ``empty``: the share of empty slots.  Returns numpy arrays (X, geom,
    lap, lap_len, had_prev)."""
    rng = np.random.default_rng(seed)
    h0, h = bs0 // 2, bs1 // 2
    L = B * ch
    X = np.zeros((K, L, h), np.float32)
    geom = np.zeros((4, K, B), np.int32)
    lap = np.zeros((L, h), np.float32)
    lap_len = np.zeros(B, np.int32)
    had_prev = np.zeros(B, np.int32)
    for b in range(B):
        prev_long = bool(rng.random() < 0.7)
        if b >= 2:
            had_prev[b] = 1
            lap_len[b] = h if prev_long else h0
            lap[b * ch:(b + 1) * ch, :lap_len[b]] = \
                rng.standard_normal((ch, lap_len[b])) * 0.3
        kinds = rng.random(K + 1) < (0.75 if bs0 != bs1 else 1.0)
        lane_lies = lies if isinstance(lies, bool) \
            else bool(rng.random() < lies)
        for k in range(K):
            if rng.random() < empty:
                continue  # an empty slot
            lb = bool(kinds[k])
            if lane_lies:
                pl, nl = bool(rng.random() < 0.5), bool(rng.random() < 0.5)
            else:
                pl, nl = prev_long, bool(kinds[k + 1])
            n = bs1 if lb else bs0
            geom[:3, k, b] = vorbis_geometry(n, lb, pl, nl, bs0)
            geom[3, k, b] = 1
            X[k, b * ch:(b + 1) * ch, :n // 2] = \
                rng.standard_normal((ch, n // 2)) * 0.02
            prev_long = lb
    return X, geom, lap, lap_len, had_prev
