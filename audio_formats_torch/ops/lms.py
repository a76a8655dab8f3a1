"""QOA LMS predictor: decode recurrence and the encoder's scalefactor search.

QOA ("Quite OK Audio") reconstructs each sample from a 4-tap sign-sign LMS
predictor plus a dequantized 3-bit residual (qoa.d:231-261).  The recurrence
is sequential in time but parallel across (streams × channels × frames):
QOA frame headers carry the LMS state (qoa.d:413-455), so decode
parallelizes across frames too.  Every function here runs one lane per
(frame, channel).

Bit-exactness: everything is int32 with two's-complement wraparound and
arithmetic right shifts, exactly as the reference's D `int` ops
(qoa_lms_predict qoa.d:231, qoa_lms_update qoa.d:241, qoa_div qoa.d:263).
The plain twins compute in int64 and wrap to int32 explicitly; the encoder's
squared error is a 64-bit sum of u32 terms (qoa.d:357-368).

Encoder search: the reference brute-forces all 16 scalefactors sequentially
per slice (qoa.d:345-383); here the 16 candidates run side by side, with
first-index tie-breaking to match the reference's strict `<` best-error
update.

Each entry point dispatches on the tensor's device: a CPU tensor takes the
plain twin (``qoa_decode_torch``, ``qoa_encode_frame_torch``); a CUDA tensor
takes the hand-written kernels of ``csrc/qoa_lms.cu`` or raises.
``DECODE_LAUNCHES`` and ``ENCODE_LAUNCHES`` count the kernels' launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _kernels

QOA_SLICE_LEN = 20
QOA_SLICES_PER_FRAME = 256
QOA_FRAME_LEN = QOA_SLICE_LEN * QOA_SLICES_PER_FRAME  # 5120
QOA_LMS_LEN = 4

# Spec tables (qoa.d:150-215; defined by the QOA format spec, qoaformat.org:
# quant_tab maps residual -8..8 -> 3-bit code; scalefactor_tab[s] =
# round((s+1)^2.75); reciprocal_tab = ceil(2^16 / sf); dequant_tab[s][q] =
# round(sf * {0.75,-0.75,2.5,-2.5,4.5,-4.5,7,-7}[q])).
QUANT_TAB = np.array(
    [7, 7, 7, 5, 5, 3, 3, 1, 0, 0, 2, 2, 4, 4, 6, 6, 6], dtype=np.int32
)
SCALEFACTOR_TAB = np.round(
    np.power(np.arange(1, 17, dtype=np.float64), 2.75)
).astype(np.int32)
RECIPROCAL_TAB = ((1 << 16) + SCALEFACTOR_TAB - 1) // SCALEFACTOR_TAB
_DQT_BASE = np.array([0.75, -0.75, 2.5, -2.5, 4.5, -4.5, 7.0, -7.0])
DEQUANT_TAB = np.array(
    [
        [int(np.floor(sf * b + 0.5)) if sf * b > 0 else -int(np.floor(-sf * b + 0.5))
         for b in _DQT_BASE]
        for sf in SCALEFACTOR_TAB
    ],
    dtype=np.int32,
)

#: the encoder's initial LMS weights (qoa.d:568-581); history starts at 0
INITIAL_WEIGHTS = np.array([0, 0, -(1 << 13), 1 << 14], dtype=np.int32)

#: launches of the CUDA decode kernel (af_qoa_decode) in this process
DECODE_LAUNCHES = 0
#: launches of the CUDA encode kernel (af_qoa_encode) in this process
ENCODE_LAUNCHES = 0
_launch_lock = threading.Lock()

_MASK32 = 0xFFFFFFFF


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (kept as int64)."""
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def _predict(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(Σ h·w) >> 13 with int32 wraparound (qoa.d:231-238); h, w int64
    holding int32 values, summed over the last axis."""
    return _wrap32(_wrap32(h * w).sum(-1)) >> 13


def _update(h, w, recon, residual):
    """Sign-sign LMS update (qoa.d:241-254): w += ±(residual >> 4) by the
    sign of h, then recon shifts into h.  All int64 holding int32 values."""
    delta = (residual >> 4)[..., None]
    w = _wrap32(w + torch.where(h < 0, -delta, delta))
    h = torch.cat([h[..., 1:], recon[..., None]], dim=-1)
    return h, w


def _as_tensors(*arrays):
    """numpy arrays → CPU tensors; tensors pass through on their device."""
    return tuple(torch.as_tensor(a) for a in arrays)


def _check(fn: str, dev: torch.device, want) -> None:
    """Raise unless every (name, tensor, dtypes, shape) lies contiguous on
    the CUDA device `dev` with one of the dtypes and the shape."""
    for name, t, dtypes, shape in want:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{fn}: {name} on {t.device}, want {dev} "
                             "(a CUDA device)")
        if t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {t.dtype}{list(t.shape)}, "
                             f"want {dtypes[0]}{list(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def qoa_decode(history, weights, dequantized):
    """Run the LMS decode recurrence.

    history, weights: [L, 4] int32 (from frame headers)
    dequantized:      [L, T] int32 (residuals already through DEQUANT_TAB)
    Returns reconstructed samples [L, T] int32 in s16 range, on
    dequantized's device.  Takes numpy arrays or tensors.
    """
    history, weights, dequantized = _as_tensors(history, weights, dequantized)
    if dequantized.device.type == "cpu":
        return qoa_decode_torch(history, weights, dequantized)
    if dequantized.device.type == "cuda":
        return qoa_decode_cuda(history, weights, dequantized=dequantized)
    raise ValueError(f"qoa_decode: no kernel for device {dequantized.device}")


def qoa_decode_torch(history, weights, dequantized):
    """Plain PyTorch twin of the CUDA decode kernel: same contract as
    qoa_decode.  A Python loop over time in int64 with explicit int32
    wraps: the test oracle and the on-card comparison, never the CUDA
    main path."""
    history, weights, dequantized = _as_tensors(history, weights, dequantized)
    L, T = dequantized.shape
    dev = dequantized.device
    h = history.to(device=dev, dtype=torch.int64)
    w = weights.to(device=dev, dtype=torch.int64)
    r = dequantized.to(torch.int64)
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    for t in range(T):
        rt = r[:, t]
        recon = torch.clamp(_wrap32(_predict(h, w) + rt), -32768, 32767)
        h, w = _update(h, w, recon, rt)
        out[:, t] = recon.to(torch.int32)
    return out


def qoa_decode_cuda(history, weights, dequantized=None, scalefactors=None,
                    codes=None):
    """Launch the CUDA decode kernel (csrc/qoa_lms.cu) on the tensors' card,
    on that card's current stream.  Give either `dequantized` [L, T] int32,
    or int8 `scalefactors` [L, S] and `codes` [L, S, 20] (T = 20·S; the
    kernel looks DEQUANT_TAB up itself).  Every tensor must already lie on
    one CUDA device, contiguous, with these dtypes."""
    global DECODE_LAUNCHES
    L = history.shape[0] if history.dim() == 2 else -1
    if dequantized is not None:
        dev = dequantized.device
        T = dequantized.shape[-1]
        data = (("dequantized", dequantized, (torch.int32,), (L, T)),)
    else:
        dev = codes.device
        S = scalefactors.shape[-1]
        T = S * QOA_SLICE_LEN
        data = (("scalefactors", scalefactors, (torch.int8,), (L, S)),
                ("codes", codes, (torch.int8,), (L, S, QOA_SLICE_LEN)))
    _check("qoa_decode", dev, (
        ("history", history, (torch.int32,), (L, QOA_LMS_LEN)),
        ("weights", weights, (torch.int32,), (L, QOA_LMS_LEN)),
    ) + data)
    if dequantized is None and codes.data_ptr() % 4:
        raise ValueError("qoa_decode: codes must start 4-byte aligned")
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    if L == 0 or T == 0:
        return out
    lib = _kernels.load("qoa_lms")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.af_qoa_decode(
            history.data_ptr(), weights.data_ptr(),
            None if dequantized is None else dequantized.data_ptr(),
            None if dequantized is not None else scalefactors.data_ptr(),
            None if dequantized is not None else codes.data_ptr(),
            out.data_ptr(), L, T, stream)
    if rc != 0:
        raise RuntimeError(f"qoa_decode kernel launch failed: CUDA error {rc}")
    with _launch_lock:
        DECODE_LAUNCHES += 1
    return out


def decode_slices(history, weights, scalefactors, codes):
    """Decode QOA slices: dequantize 3-bit codes, then run the LMS
    recurrence.

    history, weights: [L, 4] int32; scalefactors: [L, S] int8 or int32
    (0..15); codes: [L, S, 20] int8 or int32 (0..7).
    Returns samples [L, S*20] int32 on codes' device.  On a CUDA device the
    kernel dequantizes as it decodes; on the CPU a table gather feeds the
    twin.
    """
    history, weights, scalefactors, codes = _as_tensors(
        history, weights, scalefactors, codes)
    dev = codes.device
    if dev.type == "cuda":
        return qoa_decode_cuda(history, weights,
                               scalefactors=scalefactors.to(torch.int8),
                               codes=codes.to(torch.int8))
    if dev.type != "cpu":
        raise ValueError(f"decode_slices: no kernel for device {dev}")
    tab = torch.from_numpy(DEQUANT_TAB)
    deq = tab[scalefactors.to(torch.int64)[..., None], codes.to(torch.int64)]
    return qoa_decode_torch(history, weights, deq.reshape(codes.shape[0], -1))


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _lane_lengths(frame_len, L: int, dev) -> torch.Tensor:
    """Scalar or per-lane [L] frame length → an int32 [L] tensor on dev."""
    return torch.as_tensor(frame_len, dtype=torch.int32).to(dev).expand(L)\
        .contiguous()


def qoa_encode_frame_scan(samples, history, weights, frame_len):
    """Encode one QOA frame worth of samples for L independent lanes.

    samples:   [L, 5120] int16 or int32 (s16 values; zero past frame_len)
    history:   [L, 4] int32, weights: [L, 4] int32 — carried LMS state
    frame_len: scalar OR per-lane [L] int32 (samples per channel in this
               frame, <= 5120)

    Returns (scalefactors [L, 256] int32, codes [L, 256, 20] int32,
    history' [L, 4] int32, weights' [L, 4] int32) on samples' device.  The
    host packs codes into big-endian u64 slice words and discards slices
    past ceil(frame_len / 20).
    """
    samples, history, weights = _as_tensors(samples, history, weights)
    dev = samples.device
    if dev.type == "cpu":
        return qoa_encode_frame_torch(samples, history, weights, frame_len)
    if dev.type != "cuda":
        raise ValueError(f"qoa_encode_frame_scan: no kernel for device {dev}")
    words, h, w = qoa_encode_cuda(samples, history, weights,
                                  _lane_lengths(frame_len, samples.shape[0],
                                                dev))
    sf, codes = unpack_words(words)
    return sf, codes, h, w


def qoa_encode_frame_words(samples, frame_len):
    """Frame-parallel QOA encode: the scalefactor search from the encoder's
    initial LMS state {h=0, w=0,0,-2^13,2^14} (qoa.d:568-581), packed into
    slice words on the device, so the only download is 8 B per slice.

    samples: [L, 5120] int16/int32 (s16 values).  frame_len: scalar or
    per-lane [L] int32.

    Returns one int64 plane [L, 256] holding the bits of each big-endian
    u64 slice word, sf<<60 | code_t<<(57-3t) (qoa.d:330-339); torch has no
    uint64 shifts, so a word with sf >= 8 reads negative.
    """
    (samples,) = _as_tensors(samples)
    L = samples.shape[0]
    dev = samples.device
    h0 = torch.zeros((L, QOA_LMS_LEN), dtype=torch.int32, device=dev)
    w0 = torch.from_numpy(INITIAL_WEIGHTS).to(dev).expand(L, -1).contiguous()
    if dev.type == "cpu":
        sf, codes, _, _ = qoa_encode_frame_torch(samples, h0, w0, frame_len)
        return pack_words(sf, codes)
    if dev.type != "cuda":
        raise ValueError(f"qoa_encode_frame_words: no kernel for device {dev}")
    words, _, _ = qoa_encode_cuda(samples, h0, w0,
                                  _lane_lengths(frame_len, L, dev))
    return words


def pack_words(sf: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sf [L, S], codes [L, S, 20] → the int64 word plane [L, S].  The two
    32-bit halves combine as hi·2^32 + lo with hi read as signed, which is
    exact in int64 (no shift past bit 63)."""
    c = codes.to(torch.int64)
    # code 9 straddles bit 32 (bits 30..32), hence the >>2 / &3
    hi = sf.to(torch.int64) << 28
    for t in range(9):
        hi = hi | (c[..., t] << (25 - 3 * t))
    hi = hi | (c[..., 9] >> 2)
    lo = (c[..., 9] & 3) << 30
    for t in range(10, QOA_SLICE_LEN):
        lo = lo | (c[..., t] << (57 - 3 * t))
    return _wrap32(hi) * (1 << 32) + lo


def unpack_words(words: torch.Tensor):
    """The int64 word plane [L, S] → (sf [L, S], codes [L, S, 20]), int32."""
    sf = (words >> 60) & 15
    shifts = 57 - 3 * torch.arange(QOA_SLICE_LEN, device=words.device)
    codes = (words[..., None] >> shifts) & 7
    return sf.to(torch.int32), codes.to(torch.int32)


def qoa_encode_frame_torch(samples, history, weights, frame_len):
    """Plain PyTorch twin of the CUDA encode kernel: same contract and
    outputs as qoa_encode_frame_scan.  A Python loop over slices and
    steps, the 16 candidate scalefactors side by side, in int64 with
    explicit int32 wraps; the test oracle and the on-card comparison,
    never the CUDA main path."""
    samples, history, weights = _as_tensors(samples, history, weights)
    dev = samples.device
    L = samples.shape[0]
    flen = _lane_lengths(frame_len, L, dev).to(torch.int64)
    x = samples.to(torch.int64)
    recip = torch.from_numpy(RECIPROCAL_TAB).to(dev, torch.int64)  # [16]
    qtab = torch.from_numpy(QUANT_TAB).to(dev, torch.int64)        # [17]
    dqtab = torch.from_numpy(DEQUANT_TAB).to(dev, torch.int64)     # [16, 8]
    cand = torch.arange(16, device=dev)[None, :]
    rows = torch.arange(L, device=dev)
    h = history.to(device=dev, dtype=torch.int64)
    w = weights.to(device=dev, dtype=torch.int64)
    sf_out = torch.zeros((L, QOA_SLICES_PER_FRAME), dtype=torch.int32,
                         device=dev)
    codes_out = torch.zeros((L, QOA_SLICES_PER_FRAME, QOA_SLICE_LEN),
                            dtype=torch.int32, device=dev)
    # slices past every lane's frame_len are inactive everywhere: sf 0,
    # codes 0, state kept — what the zero-initialized outputs already hold
    max_len = int(flen.clamp(0, QOA_FRAME_LEN).max()) if L else 0
    n_slices = -(-max_len // QOA_SLICE_LEN)
    for s in range(n_slices):
        slice_len = (flen - s * QOA_SLICE_LEN).clamp(0, QOA_SLICE_LEN)
        hh = h[:, None, :].expand(L, 16, QOA_LMS_LEN)
        ww = w[:, None, :].expand(L, 16, QOA_LMS_LEN)
        err = torch.zeros((L, 16), dtype=torch.int64, device=dev)
        codes = torch.zeros((L, 16, QOA_SLICE_LEN), dtype=torch.int64,
                            device=dev)
        for t in range(QOA_SLICE_LEN):
            active = (t < slice_len)[:, None]                    # [L, 1]
            sample = x[:, s * QOA_SLICE_LEN + t][:, None]        # [L, 1]
            predicted = _predict(hh, ww)                         # [L, 16]
            residual = _wrap32(sample - predicted)
            # qoa_div (qoa.d:263-269): fixed-point reciprocal, round away
            n = _wrap32(residual * recip + (1 << 15)) >> 16
            n = n + torch.sign(residual) - torch.sign(n)
            quantized = qtab[n.clamp(-8, 8) + 8]
            dequantized = dqtab[cand, quantized]
            recon = torch.clamp(_wrap32(predicted + dequantized),
                                -32768, 32767)
            e = _wrap32(sample - recon)
            err = torch.where(active, err + ((e * e) & _MASK32), err)
            nh, nw = _update(hh, ww, recon, dequantized)
            hh = torch.where(active[..., None], nh, hh)
            ww = torch.where(active[..., None], nw, ww)
            codes[:, :, t] = torch.where(active, quantized, 0)
        # the first minimum wins (the reference's strict `<`, qoa.d:376)
        best = torch.argmin(err, dim=1)
        keep = (slice_len > 0)[:, None]
        h = torch.where(keep, hh[rows, best], h)
        w = torch.where(keep, ww[rows, best], w)
        sf_out[:, s] = best.to(torch.int32)
        codes_out[:, s] = codes[rows, best].to(torch.int32)
    return sf_out, codes_out, h.to(torch.int32), w.to(torch.int32)


def qoa_encode_cuda(samples, history, weights, frame_len):
    """Launch the CUDA encode kernel (csrc/qoa_lms.cu) on the tensors' card,
    on that card's current stream.  samples [L, 5120] int16 or int32,
    history and weights [L, 4] int32, frame_len [L] int32, all contiguous
    on one CUDA device.  Returns (words [L, 256] int64, history' [L, 4],
    weights' [L, 4])."""
    global ENCODE_LAUNCHES
    if samples.dim() != 2:
        raise ValueError("qoa_encode: samples must be [L, 5120]")
    L = samples.shape[0]
    dev = samples.device
    _check("qoa_encode", dev, (
        ("samples", samples, (torch.int16, torch.int32), (L, QOA_FRAME_LEN)),
        ("history", history, (torch.int32,), (L, QOA_LMS_LEN)),
        ("weights", weights, (torch.int32,), (L, QOA_LMS_LEN)),
        ("frame_len", frame_len, (torch.int32,), (L,)),
    ))
    words = torch.empty((L, QOA_SLICES_PER_FRAME), dtype=torch.int64,
                        device=dev)
    h_out = torch.empty_like(history)
    w_out = torch.empty_like(weights)
    if L == 0:
        return words, h_out, w_out
    lib = _kernels.load("qoa_lms")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.af_qoa_encode(
            samples.data_ptr(), samples.element_size(), history.data_ptr(),
            weights.data_ptr(), frame_len.data_ptr(), words.data_ptr(),
            h_out.data_ptr(), w_out.data_ptr(), L, stream)
    if rc != 0:
        raise RuntimeError(f"qoa_encode kernel launch failed: CUDA error {rc}")
    with _launch_lock:
        ENCODE_LAUNCHES += 1
    return words, h_out, w_out
