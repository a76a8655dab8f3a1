"""PCM sample-format conversion: int → f32, the exact quantizer, the TPDF
threefry dither and the byte pack.

The numeric core of WAV decode and encode (wav.d:242-344 decode scaling,
wav.d:475-553 quantization, wav.d:679-701 TPDF dither).  On a CUDA tensor
every entry runs K10, the hand-written kernel of ``csrc/pcm.cu``; on a CPU
tensor it runs the plain PyTorch twin in this module, which gives the same
bits.  ``DECODE_LAUNCHES`` and ``ENCODE_LAUNCHES`` count K10's launches.

Bit-exactness, against the JAX package's ``ops/pcm.py``:

* **Decode** (int → f32): the correctly rounded f32 quotient ``s / scale``
  (u8: ``(b - 128) / 127``; s32: the f32 of ``s`` times 2^-31, exact).
  JAX reaches it with a TwoSum refinement of the TPU's divide; torch's f32
  divide and CUDA's ``__fdiv_rn`` are IEEE, so they give it directly.
* **Quantize, no dither**: ``floor(x * scale + 0.5)`` of the clamped x,
  computed exactly (u8/s16/s24 in f64, where the product and the sum are
  exact whenever the floor depends on them; s32 in f32, where the scale is
  a power of two), then clamped to ±scale.
* **Dither** (every kind but s32): ``floor(fma(x, scale, 0.3125) + 0.25 u1
  + 0.125 u2)``, each step rounded to f32.  XLA contracts JAX's
  ``x * scale + 0.3125`` into an FMA on the CPU; the plain left-to-right
  f32 sum differs on ~7% of samples.  u1, u2 are JAX's threefry uniforms
  (``jax.random.fold_in(jax.random.key(0x7D17), seed)``, split in two,
  partitionable threefry): the noise at position p of a row depends on the
  seed and p only.
* NaN quantizes to 0 and every value saturates to the int32 range, as
  XLA's float → int convert does.

Torch has no shift, add or compare for uint32, so the twin carries the
threefry words as int64 masked to 32 bits.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _kernels

# Quantization scales per sample format (wav.d: 127.0 / 32767.0 / 8388607.0).
SCALE = {"u8": 127.0, "s16": 32767.0, "s24": 8388607.0, "s32": 2147483648.0}
#: bytes a sample of each integer kind
KIND_BYTES = {"u8": 1, "s16": 2, "s24": 3, "s32": 4}
_KIND_CODE = {"u8": 0, "s16": 1, "s24": 2, "s32": 3}

#: the dither's root key, jax.random.key(0x7D17) (ops/pcm.py of the JAX
#: package)
DITHER_KEY = (0, 0x7D17)

#: launches of K10's decode entry (af_pcm_decode) in this process
DECODE_LAUNCHES = 0
#: launches of K10's quantize entry (af_pcm_quantize) in this process
ENCODE_LAUNCHES = 0
_launch_lock = threading.Lock()

_M32 = 0xFFFFFFFF


def quantize_float_to_int_np(x: np.ndarray, kind: str) -> np.ndarray:
    """Exact no-dither quantize in double math (reference semantics
    wav.d:487-525): what the QOA encoders feed their search."""
    scale = SCALE[kind]
    xd = np.clip(x.astype(np.float64), -1.0, 1.0)
    k = np.floor(xd * scale + 0.5)
    k = np.clip(k, -scale, scale)
    return k.astype(np.int32)


# ---------------------------------------------------------------------------
# Threefry-2x32 (the twin; csrc/pcm.cu has the kernel's)
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011, as jax.random): key
    (k0, k1), counter (x0, x1), all int64 tensors (or ints) holding uint32
    values, broadcast together.  Returns the two output words, int64."""
    k0, k1, x0, x1 = (torch.as_tensor(v, dtype=torch.int64)
                      for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def dither_keys(seeds: torch.Tensor):
    """The two uniform streams' keys of each row's seed: int64 [L, 4]
    (k1 word 0, k1 word 1, k2 word 0, k2 word 1) on seeds' device.
    fold_in(key(0x7D17), seed), then split in two."""
    s = seeds.to(torch.int64) & _M32
    ka, kb = threefry2x32(DITHER_KEY[0], DITHER_KEY[1], torch.zeros_like(s), s)
    k1 = threefry2x32(ka, kb, 0, 0)
    k2 = threefry2x32(ka, kb, 0, 1)
    return torch.stack([k1[0], k1[1], k2[0], k2[1]], dim=-1)


def _uniform(ka, kb, pos):
    """f32 uniforms in [0, 1) at positions `pos` of the stream with key
    (ka, kb): the xor of threefry's two words, its top 23 bits as a
    mantissa (jax.random.uniform)."""
    a, b = threefry2x32(ka, kb, 0, pos)
    bits = ((a ^ b) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# Twins
# ---------------------------------------------------------------------------

def int_to_f32_torch(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Twin of the JAX package's ``_int_to_f32``: int32 samples (u8 as raw
    0..255) → f32, the correctly rounded quotient.  The divisor is a
    tensor: on a CUDA device torch divides by a Python scalar as a multiply
    by its reciprocal, which is not correctly rounded."""
    xf = (x.to(torch.int32) - 128 if kind == "u8" else x).to(torch.float32)
    return xf / torch.tensor(SCALE[kind], dtype=torch.float32,
                             device=x.device)


def unpack_bytes_torch(raw: torch.Tensor, kind: str) -> torch.Tensor:
    """Little-endian payload bytes (uint8 [n * bytes]) → int32 [n]: u8 kept
    raw 0..255, the others signed."""
    bps = KIND_BYTES[kind]
    b = raw.reshape(-1, bps).to(torch.int64)
    v = b[:, 0]
    for i in range(1, bps):
        v = v | (b[:, i] << (8 * i))
    if kind != "u8":
        sign = 1 << (8 * bps - 1)
        v = (v ^ sign) - sign
    return v.to(torch.int32)


def decode_bytes_torch(raw: torch.Tensor, kind: str) -> torch.Tensor:
    """Twin of K10's decode: payload bytes → f32 samples."""
    return int_to_f32_torch(unpack_bytes_torch(raw, kind), kind)


def _fma_f32(x: torch.Tensor, scale, c) -> torch.Tensor:
    """The f32 rounding of the exact ``x * scale + c`` (an FMA), for f32 x
    and f32 scale and c (numbers, or tensors that broadcast with x).

    The product is exact in f64 (24 × 24 bits).  The f64 sum may round, and
    rounding it once more to f32 could then land on the wrong side of an
    f32 midpoint, so this computes the sum's exact error (TwoSum in f64):
    where the f64 sum is exactly an f32 midpoint and the error is not zero,
    the exact sum lies beyond the midpoint on the error's side, and the
    result is the f32 neighbour on that side.  Elsewhere the f64 sum and
    the exact sum lie between the same two midpoints (f64 rounding never
    crosses one: midpoints are f64 numbers), so they round alike."""
    p = x.to(torch.float64) * scale
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.to(torch.float32)
    toward = torch.where(s > r.to(torch.float64),
                         torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    other = torch.nextafter(r, toward)
    mid = (r.to(torch.float64) + other.to(torch.float64)) * 0.5
    tie = (s == mid) & (err != 0)
    lo = torch.minimum(r, other)
    hi = torch.maximum(r, other)
    return torch.where(tie, torch.where(err > 0, hi, lo), r)


def _to_int32(k: torch.Tensor, scale: float) -> torch.Tensor:
    """Clamp to ±scale, NaN → 0, saturate to int32 (XLA's convert)."""
    k = torch.nan_to_num(k.to(torch.float64), nan=0.0)
    k = k.clamp(-scale, scale).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return k.to(torch.int32)


def quantize_rows_torch(x: torch.Tensor, seeds: torch.Tensor, kind: str,
                        dither: bool) -> torch.Tensor:
    """Twin of K10's quantize: f32 rows [L, n] → int32 [L, n].  Without
    dither (or for s32) the JAX package's ``_quantize_nodither``; with
    dither ``_quantize_dither`` with each row's seed (int [L])."""
    x = x.to(torch.float32)
    scale = SCALE[kind]
    if not dither or kind == "s32":
        xc = x.clamp(-1.0, 1.0)
        if kind == "s32":
            # the scale is a power of two: the f32 product is exact
            k = torch.floor(xc * np.float32(scale) + np.float32(0.5))
        else:
            # exact: the f64 product and, where the floor depends on it,
            # the f64 sum
            k = torch.floor(xc.to(torch.float64) * scale + 0.5)
        return _to_int32(k, scale)
    L, n = x.shape
    keys = dither_keys(seeds.reshape(L).to(x.device))
    out = torch.empty((L, n), dtype=torch.int32, device=x.device)
    # a few million samples at a time bound the int64 temporaries
    step = max(1, (1 << 22) // max(1, L))
    for p0 in range(0, n, step):
        pos = torch.arange(p0, min(n, p0 + step), dtype=torch.int64,
                           device=x.device)[None, :]
        u1 = _uniform(keys[:, 0:1], keys[:, 1:2], pos)
        u2 = _uniform(keys[:, 2:3], keys[:, 3:4], pos)
        y = _fma_f32(x[:, p0:p0 + step], scale, 0.3125)
        y = y + np.float32(0.25) * u1
        y = y + np.float32(0.125) * u2
        out[:, p0:p0 + step] = _to_int32(torch.floor(y), scale)
    return out


def pack_rows_torch(k: torch.Tensor, kind: str) -> torch.Tensor:
    """int32 rows [L, n] → their little-endian payload bytes, uint8
    [L, n * bytes] (u8 biased by 128, wav.d:489)."""
    L, n = k.shape
    ku = k.to(torch.int64) & _M32
    if kind == "u8":
        return ((ku + 128) & 0xFF).to(torch.uint8)
    parts = [(ku >> (8 * i)) & 0xFF for i in range(KIND_BYTES[kind])]
    return torch.stack(parts, dim=-1).reshape(L, n * len(parts)) \
        .to(torch.uint8)


# ---------------------------------------------------------------------------
# Wrappers: the twin on a CPU tensor, K10 on a CUDA tensor
# ---------------------------------------------------------------------------

def _device_check(fn, t):
    if t.device.type not in ("cpu", "cuda"):
        raise _kernels.KernelArgError(f"{fn}: no kernel for device "
                                      f"{t.device}")
    return t.device.type == "cuda"


def decode_bytes(raw: torch.Tensor, kind: str) -> torch.Tensor:
    """Payload bytes (uint8 [n * bytes], little-endian) → f32 [n] on raw's
    device."""
    if kind not in KIND_BYTES:
        raise ValueError(f"decode_bytes: kind {kind!r}")
    if raw.numel() % KIND_BYTES[kind]:
        raise _kernels.KernelArgError(
            f"decode_bytes: {raw.numel()} bytes is not a whole number of "
            f"{kind} samples")
    if not _device_check("decode_bytes", raw):
        return decode_bytes_torch(raw, kind)
    out = torch.empty(raw.numel() // KIND_BYTES[kind], dtype=torch.float32,
                      device=raw.device)
    decode_launch(raw, kind, out)
    return out


def decode_launch(raw: torch.Tensor, kind: str, out: torch.Tensor) -> None:
    """K10's decode into a made output: out f32 [n], raw uint8 [n * bytes]
    on the same CUDA device."""
    global DECODE_LAUNCHES
    n = out.numel()
    _kernels.check_args("decode_bytes", raw.device, (
        ("raw", raw, (torch.uint8,), (n * KIND_BYTES[kind],)),
        ("out", out, (torch.float32,), (n,))))
    if n == 0:
        return
    lib = _kernels.load("pcm")
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = lib.af_pcm_decode(raw.data_ptr(), out.data_ptr(), n,
                               _KIND_CODE[kind], stream)
    _kernels.check_launch("pcm_decode", rc)
    with _launch_lock:
        DECODE_LAUNCHES += 1


def _rows_args(x, seeds):
    x = torch.as_tensor(x)
    if x.dim() != 2:
        raise _kernels.KernelArgError("quantize: rows must be [L, n]")
    seeds = torch.as_tensor(seeds).reshape(-1)
    if seeds.numel() != x.shape[0]:
        raise _kernels.KernelArgError(
            f"quantize: {seeds.numel()} seeds for {x.shape[0]} rows")
    return x, (seeds.to(torch.int64) & _M32)


def quantize_pack(x, seeds, kind: str, dither: bool) -> torch.Tensor:
    """Quantize f32 rows [L, n] and pack each row's payload bytes: uint8
    [L, n * bytes], exactly the WAV data bytes of each row."""
    x, seeds = _rows_args(x, seeds)
    if not _device_check("quantize_pack", x):
        return pack_rows_torch(quantize_rows_torch(x, seeds, kind, dither),
                               kind)
    L, n = x.shape
    out = torch.empty((L, n * KIND_BYTES[kind]), dtype=torch.uint8,
                      device=x.device)
    quantize_launch(x, seeds, kind, dither, out)
    return out


def quantize_launch(x, seeds, kind: str, dither: bool, out) -> None:
    """K10's quantize into a made output: x f32 [L, n] and seeds [L] on a
    CUDA device; out uint8 [L, n * bytes]."""
    global ENCODE_LAUNCHES
    L, n = x.shape
    seeds32 = seeds.to(device=x.device, dtype=torch.int64) \
        .to(torch.int32).contiguous()
    _kernels.check_args("quantize", x.device, (
        ("x", x, (torch.float32,), (L, n)),
        ("seeds", seeds32, (torch.int32,), (L,)),
        ("out", out, (torch.uint8,), (L, n * KIND_BYTES[kind]))))
    if L == 0 or n == 0:
        return
    lib = _kernels.load("pcm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.af_pcm_quantize(x.data_ptr(), seeds32.data_ptr(),
                                 out.data_ptr(), L, n, _KIND_CODE[kind],
                                 int(bool(dither) and kind != "s32"),
                                 stream)
    _kernels.check_launch("pcm_quantize", rc)
    with _launch_lock:
        ENCODE_LAUNCHES += 1


# ---------------------------------------------------------------------------
# numpy entry points (the JAX package's public functions)
# ---------------------------------------------------------------------------

def int_pcm_to_float(x: np.ndarray, kind: str, dtype=np.float32,
                     device="cuda") -> np.ndarray:
    """int PCM (int32; u8 as raw 0..255) → float on `device`.  float64
    matches the reference's double math on the host."""
    if dtype == np.float64 or x.shape[0] == 0:
        xf = x.astype(np.float64)
        out = (xf - 128.0) / 127.0 if kind == "u8" else xf / SCALE[kind]
        return out.astype(dtype)
    # the decode reads payload bytes: the u8 byte is the raw value itself
    t = torch.from_numpy(np.ascontiguousarray(x, np.int32))
    raw = t.to(torch.uint8) if kind == "u8" else \
        pack_rows_torch(t[None, :], kind).reshape(-1)
    return decode_bytes(raw.to(device), kind).cpu().numpy()


def quantize_float_to_int(x: np.ndarray, kind: str, *, dither: bool,
                          seed: int = 0, device="cuda") -> np.ndarray:
    """Quantize float PCM to signed ints (symmetric ±scale) on `device`:
    the packed payload bytes, read back as ints."""
    if x.shape[0] == 0:
        return np.zeros(0, dtype=np.int32)
    rows = torch.from_numpy(np.ascontiguousarray(x, np.float32)[None, :])
    w = quantize_pack(rows.to(device), torch.tensor([seed & _M32]), kind,
                      dither)
    k = unpack_bytes_torch(w[0].cpu(), kind)
    return (k - 128 if kind == "u8" else k).numpy()


def quantize_pack_rows(rows, lens, seeds, kind: str, sample_size: int, *,
                       dither: bool, device="cuda", mesh=None):
    """Batched encode: rows [L, n] float32 (zero-padded), lens [L] valid
    sample counts, one seed a row.  Quantize and pack on `device`; returns
    a list of L byte strings, each row's exact WAV data payload.

    ``mesh`` (a ``parallel.mesh.Mesh``) splits the rows and their seeds
    into contiguous shards over its 'data' devices, one K10 launch a
    shard: a row's noise comes from its own seed and its positions, so the
    bytes equal the unsharded call's.  ``device`` then defaults to the
    mesh's first device, and another one raises ValueError."""
    if sample_size != KIND_BYTES[kind]:
        raise ValueError(f"{kind} has {KIND_BYTES[kind]} bytes a sample, "
                         f"not {sample_size}")
    rows = np.ascontiguousarray(rows, np.float32)
    seeds = np.asarray(seeds, np.int64)
    devices = [device]
    if mesh is not None:
        from ..parallel.mesh import mesh_device

        mesh_device(device, mesh)
        devices = mesh.data_devices
    shards = []
    for dev, idx in zip(devices, np.array_split(np.arange(len(rows)),
                                                len(devices))):
        if idx.size:
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            x = torch.from_numpy(rows[sl]).to(dev)
            shards.append((sl, quantize_pack(x, torch.from_numpy(seeds[sl]),
                                             kind, dither)))
    out = []
    # every shard is enqueued before the first download waits on its device
    for sl, w in shards:
        w = w.cpu().numpy()
        out.extend(w[i, : sample_size * int(lens[sl.start + i])].tobytes()
                   for i in range(w.shape[0]))
    return out
