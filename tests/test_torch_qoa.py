"""audio_formats_torch's QOA ops and codec against audio_formats_tpu's, on
the CPU.

Every comparison is exact equality: QOA is integer throughout, and the same
numpy inputs (made from a seed) go through both packages.  The extreme
inputs provoke each int32 wraparound of the reference: the predictor sum,
``p + r`` before the s16 clamp, the weight update and ``residual * recip``
in qoa_div.  The CUDA kernels are compared with these twins in
test_torch_cuda.py.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from audio_formats_tpu.config import EncodingOptions as JEncodingOptions
from audio_formats_tpu.io.source import ByteSink as JByteSink
from audio_formats_tpu.io.source import MemorySource as JMemorySource
from audio_formats_tpu.models import qoa as jqoa
from audio_formats_tpu.ops import lms as jlms
from audio_formats_tpu.ops.lpc import default_platform

from audio_formats_torch.config import EncodingOptions
from audio_formats_torch.io.source import ByteSink, MemorySource
from audio_formats_torch.models import qoa as tqoa
from audio_formats_torch.ops import lms as tlms

from golden import qoa_ref

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "audio_formats_torch", "csrc", "qoa_lms.cu")


def _sig(frames, channels, rng, amp=0.7):
    """The signal of tests/test_qoa.py, in s16."""
    t = np.arange(frames)[:, None]
    f = 220.0 * (1 + np.arange(channels))[None, :]
    x = amp * np.sin(2 * np.pi * f * t / 44100.0)
    x += 0.1 * rng.standard_normal((frames, channels))
    return np.clip(np.round(x * 20000), -32768, 32767).astype(np.int16)


@functools.lru_cache(maxsize=None)
def _golden_stream(frames, channels):
    """(s16 source, golden QOA bytes); encoded once per module."""
    s16 = _sig(frames, channels, np.random.default_rng(frames + channels))
    return s16, qoa_ref.encode(s16, 44100)


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("name", ["QUANT_TAB", "SCALEFACTOR_TAB",
                                  "RECIPROCAL_TAB", "DEQUANT_TAB"])
def test_tables_match_jax(name):
    got, want = getattr(tlms, name), getattr(jlms, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _cu_table(src, name):
    body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)])


def test_kernel_source_tables_and_identities():
    """The CUDA source's constant tables are the spec's, and the encode
    kernel's arithmetic quant/dequant equals the table lookups."""
    with open(_CSRC) as f:
        src = f.read()
    np.testing.assert_array_equal(_cu_table(src, "kDequant").reshape(16, 8),
                                  tlms.DEQUANT_TAB)
    np.testing.assert_array_equal(_cu_table(src, "kReciprocal"),
                                  tlms.RECIPROCAL_TAB)
    v = np.arange(-8, 9)
    m = np.minimum(np.abs(v) >> 1, 3)
    np.testing.assert_array_equal(2 * m + (v < 0), tlms.QUANT_TAB)
    np.testing.assert_array_equal(tlms.DEQUANT_TAB[:, 1::2],
                                  -tlms.DEQUANT_TAB[:, 0::2])


# ------------------------------------------------------------------ decode
def _decode_lanes(kind):
    """L = 9, T = 641 lanes as tests/test_qoa.py's Pallas test; "extreme"
    lanes carry int32-range history, weights and residuals, so the
    predictor sum, p + r and the weight update all wrap."""
    rng = np.random.default_rng(7)
    L, T = 9, 641
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 14), 1 << 14, (L, 4)).astype(np.int32)
    deq = rng.integers(-2000, 2000, (L, T)).astype(np.int32)
    if kind == "extreme":
        big = (-(1 << 31), 1 << 31)
        weights = rng.integers(*big, (L, 4)).astype(np.int32)
        deq = rng.integers(*big, (L, T)).astype(np.int32)
        deq[:, ::7] = np.int32(2**31 - 1)
        acc = (history.astype(np.int64) * weights).sum(1)
        assert np.any(np.abs(acc) >= 1 << 31)           # predictor wraps
        p = (((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)) >> 13
        assert np.any(np.abs(p + deq[:, 0]) >= 1 << 31)  # p + r wraps
    return history, weights, deq


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_qoa_decode_matches_jax(kind, ref):
    history, weights, deq = _decode_lanes(kind)
    if ref == "scan":
        want = np.asarray(jlms.qoa_decode_scan(history, weights, deq))
    else:
        want = np.asarray(jlms.qoa_decode_pallas(
            history, weights, deq, interpret=default_platform() == "cpu"))
    got = tlms.qoa_decode_torch(history, weights, deq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tlms.qoa_decode(torch.from_numpy(history), torch.from_numpy(weights),
                        torch.from_numpy(deq)).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_decode_slices_matches_jax(dtype):
    rng = np.random.default_rng(11)
    L, S = 5, 7
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 15), 1 << 15, (L, 4)).astype(np.int32)
    sf = rng.integers(0, 16, (L, S)).astype(dtype)
    codes = rng.integers(0, 8, (L, S, 20)).astype(dtype)
    want = np.asarray(jlms.decode_slices(history, weights, sf, codes))
    got = tlms.decode_slices(history, weights, sf, codes)
    assert got.shape == (L, S * 20) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ encode
_FRAME_LENS = np.array([0, 1, 19, 21, 5119, 5120], np.int32)


def _encode_lanes():
    """L = 6 lanes, one per frame length in _FRAME_LENS: full-scale square
    waves (a residual near 65535 times recip 65536 overflows qoa_div's
    int32 product), noise and a tone; zero past each frame length.  Lane
    3 starts from an int32-range LMS state."""
    rng = np.random.default_rng(5)
    t = np.arange(tlms.QOA_FRAME_LEN)
    s = np.stack([
        np.where((t // 37) % 2, 32767, -32768),
        np.where((t // 5) % 2, 32767, -32768),
        rng.integers(-32768, 32768, t.size),
        np.round(20000 * np.sin(t / 30.0)),
        np.where((t // 200) % 2, 32767, -32768),
        rng.integers(-300, 300, t.size),
    ]).astype(np.int32)
    s *= t[None, :] < _FRAME_LENS[:, None]
    history = np.zeros((6, 4), np.int32)
    weights = np.tile(tlms.INITIAL_WEIGHTS, (6, 1))
    history[3] = [100, -200, 32767, -32768]
    weights[3] = [1 << 30, -(1 << 30), 2**31 - 1, -(1 << 31)]
    return s, history, weights


def test_qoa_encode_frame_matches_jax_scan():
    s, history, weights = _encode_lanes()
    want = [np.asarray(a) for a in jlms.qoa_encode_frame_scan(
        s, history, weights, _FRAME_LENS)]
    got = tlms.qoa_encode_frame_torch(s, history, weights, _FRAME_LENS)
    for g, w, name in zip(got, want, ("sf", "codes", "history", "weights")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_qoa_encode_frame_words_match_jax():
    s, _, _ = _encode_lanes()
    hi, lo = (np.asarray(a).astype(np.uint64)
              for a in jlms.qoa_encode_frame_words(s.astype(np.int16),
                                                   _FRAME_LENS))
    want = (hi << np.uint64(32)) | lo
    assert (want >> np.uint64(63)).any()    # sf >= 8: reads negative in int64
    got = tlms.qoa_encode_frame_words(torch.from_numpy(s.astype(np.int16)),
                                      _FRAME_LENS)
    assert got.dtype == torch.int64 and got.shape == (6, 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    sf, codes = tlms.unpack_words(got)
    np.testing.assert_array_equal(tlms.pack_words(sf, codes), got)


# ------------------------------------------------------------- codec layer
def _read_all(dec, frames, chunk=None):
    if chunk is None:
        return dec.read(frames + 100)
    parts = []
    while True:
        c = dec.read(chunk)
        if c.shape[0] == 0:
            break
        parts.append(c)
    return np.concatenate(parts)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frames", [123, 5120, 5121, 7000])
def test_qoa_decoder_read_matches_jax(frames, channels):
    s16, data = _golden_stream(frames, channels)
    dec = tqoa.QoaDecoder(MemorySource(data), device="cpu")
    ref = jqoa.QoaDecoder(JMemorySource(data))
    assert (dec.length_frames, dec.channels, dec.sample_rate) == \
        (ref.length_frames, ref.channels, ref.sample_rate) == \
        (frames, channels, 44100)
    got = _read_all(dec, frames)
    want = _read_all(ref, frames)
    assert got.shape == (frames, channels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    golden, _ = qoa_ref.decode(data)
    np.testing.assert_array_equal(
        got, golden.astype(np.float32) * (np.float32(1.0) / np.float32(32767.0)))
    assert dec.tell() == ref.tell() == frames


def test_qoa_decoder_chunked_reads_match_jax():
    _, data = _golden_stream(11000, 2)
    got = _read_all(tqoa.QoaDecoder(MemorySource(data), device="cpu"),
                    11000, chunk=777)
    want = _read_all(jqoa.QoaDecoder(JMemorySource(data)), 11000, chunk=777)
    np.testing.assert_array_equal(got, want)
    whole = tqoa.QoaDecoder(MemorySource(data), device="cpu").read(11000)
    np.testing.assert_array_equal(got, whole)


def test_qoa_decoder_seek_matches_jax():
    frames = 6000  # crosses a frame boundary (5120)
    _, data = _golden_stream(frames, 1)
    dec = tqoa.QoaDecoder(MemorySource(data), device="cpu")
    ref = jqoa.QoaDecoder(JMemorySource(data))
    for target in (-1, frames + 1, 0, frames - 1, frames, 19, 5119, 5120,
                   5500):
        ok = dec.seek(target)
        assert ok == ref.seek(target), target
        if ok:
            assert dec.tell() == ref.tell() == target
            np.testing.assert_array_equal(dec.read(32), ref.read(32))


def test_qoa_probe_rejects_corrupt_magic():
    assert tqoa.probe(MemorySource(b"qoaX" + b"\0" * 32), "cpu") is None
    assert tqoa.probe(MemorySource(b"qoaf" + b"\0" * 32), "cpu") is None


def _encode(enc_cls, sink, rate, x, opts, step, **kw):
    enc = enc_cls(sink, rate, x.shape[1], opts, **kw)
    for i in range(0, x.shape[0], step):
        enc.write(x[i: i + step])
    enc.finalize()
    return sink.getvalue()


@pytest.mark.parametrize("frames,channels,rate,step", [
    (60, 1, 44100, 10**9), (60, 2, 44100, 10**9), (5130, 1, 44100, 10**9),
    (5130, 2, 44100, 10**9), (8000, 2, 48000, 300)])
def test_qoa_encoder_matches_jax_and_golden(frames, channels, rate, step):
    s16 = _sig(frames, channels, np.random.default_rng(frames * channels))
    x = s16.astype(np.float64) / 32767.0  # exact: quantizes back to s16
    got = _encode(tqoa.QoaEncoder, ByteSink(), rate, x, EncodingOptions(),
                  step, device="cpu")
    want = _encode(jqoa.QoaEncoder, JByteSink(), rate, x, JEncodingOptions(),
                   step)
    assert got == want
    assert got == qoa_ref.encode(s16, rate)
