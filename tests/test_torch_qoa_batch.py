"""The port's batched QOA decode and encode against the JAX package's, on
the CPU.

The same bytes (QOA streams from the golden encoder, FLAC streams from the
golden FLAC encoder) go through ``audio_formats_tpu``'s BatchDecoder and
``audio_formats_torch``'s ``BatchDecoder(..., device="cpu")``: PCM, lane
errors and decoded seconds must be equal, for ``output="numpy"`` and for
``decode_all(output="device").to_numpy()``.  ``encode_qoa_batch`` must give
the JAX package's bytes in both layouts.
"""

import functools

import numpy as np
import pytest
import torch

from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder
from audio_formats_tpu.parallel.encode import \
    encode_qoa_batch as jax_encode_qoa_batch

from audio_formats_torch import BatchDecoder, encode_qoa_batch
from audio_formats_torch.parallel.groups import qoa as qoa_groups
from audio_formats_torch.parallel import encode as tencode

from golden import flac_ref, qoa_ref


@functools.lru_cache(maxsize=None)
def _qoa_streams():
    """The QOA inputs of tests/test_batch.py::test_qoa_batched_group_bit_exact:
    mono and stereo, short final frames; encoded once per module."""
    rng = np.random.default_rng(1234)
    streams = []
    for i in range(4):
        n = 4000 + 3333 * i
        ch = 2 if i % 2 else 1
        t = np.arange(n)[:, None]
        x = np.clip(np.round(
            11000 * np.sin(2 * np.pi * (200 + 60 * i) * t
                           * ([1, 1.3] if ch == 2 else [1]) / 44100)
            + 500 * rng.standard_normal((n, ch))), -32768, 32767
        ).astype(np.int16)
        streams.append(qoa_ref.encode(x, 44100))
    return tuple(streams)


def _decode_both(streams):
    """Decode with both packages, and with the port in both output modes;
    returns (port numpy, port device→numpy, jax, port decoder, jax decoder,
    port device-mode decoder)."""
    jdec = JaxBatchDecoder(streams)
    ref = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all()
    ddec = BatchDecoder(streams, device="cpu")
    res = ddec.decode_all(output="device")
    for kind, wins in res.windows():
        assert all(isinstance(w, torch.Tensor) for w in wins)
        if kind == "qoa":
            # [lanes, 5120] int32 samples, as in the JAX package
            assert all(w.dtype == torch.int32 and w.shape[1] == 5120
                       for w in wins)
    return got, res.sync().to_numpy(), ref, tdec, jdec, ddec


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            assert a is not None and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_qoa_batch_decode_matches_jax():
    streams = list(_qoa_streams())
    got, got_dev, ref, tdec, jdec, ddec = _decode_both(streams)
    _assert_same(got, ref)
    _assert_same(got_dev, ref)
    want_s = jdec.stats["decoded_seconds_by_format"]["qoa"]
    assert want_s > 0
    for dec in (tdec, ddec):
        assert dec.stats["decoded_seconds_by_format"] == {"qoa": want_s}
        assert dec.stats["windows"] == 2   # one window per channel count
        assert dec.stats["group_demotions"] == 0
        assert dec.stats["h2d_bytes"] > 0


def test_qoa_batch_decode_splits_windows(monkeypatch):
    """More lanes than a window holds: several windows, the same PCM."""
    streams = list(_qoa_streams())
    want = JaxBatchDecoder(streams).decode_all()
    monkeypatch.setattr(qoa_groups, "QOA_WINDOW_LANES", 3)
    dec = BatchDecoder(streams, device="cpu")
    _assert_same(dec.decode_all(), want)
    # mono: 1 + 3 frame lanes; stereo: (2 + 3) frames x 2 channels
    assert dec.stats["windows"] == 2 + 4


def _flac(rng, frames, stereo):
    t = np.arange(frames)[:, None]
    pcm = np.clip(np.round(9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4]
                                         / 44100)
                           + 300 * rng.standard_normal((frames, 2))),
                  -32768, 32767).astype(np.int64)
    return flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                               stereo_mode=stereo, modes=["lpc8", "fixed3"])


def test_mixed_flac_qoa_batch_with_corrupt_lane_matches_jax(rng):
    """FLAC and QOA lanes in one batch run as concurrent groups; a corrupt
    QOA lane (32 bytes flipped past the header, as tests/test_robustness.py
    does) must leave every other lane as the JAX package decodes it."""
    qoa = _qoa_streams()
    bad = bytearray(qoa[3])
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    streams = [_flac(rng, 3000, "mid_side"), qoa[0], qoa[1], bytes(bad),
               _flac(rng, 2500, "left_side"), qoa[2]]
    got, got_dev, ref, tdec, jdec, _ = _decode_both(streams)
    _assert_same(got, ref)
    _assert_same(got_dev, ref)
    assert tdec.errors == jdec.errors
    assert tdec.stats["group_demotions"] == 0
    for fmt in ("flac", "qoa"):
        assert tdec.stats["decoded_seconds_by_format"][fmt] == \
            pytest.approx(jdec.stats["decoded_seconds_by_format"][fmt],
                          rel=0, abs=1e-9)
    solo = BatchDecoder([qoa[0], qoa[2]], device="cpu").decode_all()
    _assert_same([got[1], got[5]], solo)


def _sig(rng, n, ch, f0=330.0, amp=0.35):
    """The signal of tests/test_batch_encode.py."""
    t = np.arange(n)[:, None]
    mults = (np.arange(ch) * 0.37 + 1.0)[None, :]
    return (amp * np.sin(2 * np.pi * f0 * t * mults / 44100.0)
            + 0.01 * rng.standard_normal((n, ch))).astype(np.float32)


def _encode_inputs():
    """The inputs of tests/test_batch_encode.py: exact full frames, a short
    final frame in stereo, a stream shorter than one frame, ragged long."""
    rng = np.random.default_rng(1234)
    return [_sig(rng, 5120 * 2, 1), _sig(rng, 5120 * 2 + 1234, 2),
            _sig(rng, 800, 1), _sig(rng, 5120 * 3 + 20, 2)]


@functools.lru_cache(maxsize=None)
def _jax_encoded(parallel_frames):
    return jax_encode_qoa_batch(_encode_inputs(), 44100,
                                parallel_frames=parallel_frames)


@pytest.mark.parametrize("parallel_frames", [True, False])
def test_encode_qoa_batch_matches_jax(parallel_frames):
    stats = {}
    got = encode_qoa_batch(_encode_inputs(), 44100,
                           parallel_frames=parallel_frames, device="cpu",
                           stats=stats)
    assert got == _jax_encoded(parallel_frames)
    if parallel_frames:
        # 2 + 3x2 + 1 + 4x2 frame lanes in one chunk
        assert stats == {"windows": 1, "h2d_bytes": 17 * (5120 * 2 + 4),
                         "d2h_bytes": 17 * 256 * 8}
    else:
        # 3 lockstep frame windows, then 3 final partial frames
        assert stats == {"windows": 6}


def test_encode_qoa_batch_splits_chunks(monkeypatch):
    """Chunks cut at span boundaries: a stereo frame's two lanes never
    straddle two device calls.  Frame-parallel streams encode
    independently, so two of the streams alone give their bytes of the
    whole batch."""
    pcms = _encode_inputs()[1:3]
    monkeypatch.setattr(tencode, "QOA_CHUNK_LANES", 3)
    stats = {}
    got = encode_qoa_batch(pcms, 44100, device="cpu", stats=stats)
    assert got == list(_jax_encoded(True)[1:3])
    # frame lanes [2 | 2 | 2 1]
    assert stats["windows"] == 3


def test_encode_qoa_batch_cuda_without_a_gpu_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        encode_qoa_batch([_sig(rng, 100, 1)], 44100)
