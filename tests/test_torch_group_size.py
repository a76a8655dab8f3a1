"""``BatchDecoder(..., group_size=n)`` on the port, on the CPU: the lockstep
group width of the JAX package's BatchDecoder (its parallel/batch.py
``group_size``).  Lanes of each batch format decoded in groups of two give
the PCM of the default grouping, and as many device windows as JAX's
BatchDecoder with the same ``group_size``."""

import numpy as np
import pytest

from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder

from golden import vorbis_ref, wav_ref
from test_torch_mp3_batch import _flac, _qoa
from test_torch_mp3_huff import mp3_stream
from test_torch_vorbis import _frames

FORMATS = ["flac", "mp3", "qoa", "wav", "vorbis"]


def _streams(fmt):
    """Three lanes of `fmt`, of unequal lengths."""
    rng = np.random.default_rng(FORMATS.index(fmt))
    if fmt == "flac":
        return [_flac(s) for s in (31, 32, 33)]
    if fmt == "mp3":
        return [mp3_stream(s, channels=1, big=False, n_frames=n)
                for s, n in ((34, 7), (35, 30), (36, 12))]
    if fmt == "qoa":
        return [_qoa(s) for s in (37, 38, 39)]
    if fmt == "wav":
        return [wav_ref.build_wav(
            wav_ref.pack_pcm(rng.integers(-32768, 32768, 2 * n)
                             .astype(np.int32), 16),
            fmt_tag=1, channels=2, sample_rate=44100, bits=16)
            for n in (1000, 3000, 2000)]
    fix = vorbis_ref.Fixture(channels=1)
    return [fix.build(_frames(fix, rng, c)) for c in (6, 9, 4)]


@pytest.mark.parametrize("fmt", FORMATS + ["mixed"])
def test_group_size_keeps_the_pcm_and_jax_windows(fmt):
    streams = [s for f in FORMATS for s in _streams(f)] if fmt == "mixed" \
        else _streams(fmt)
    base = BatchDecoder(streams, device="cpu")
    want = base.decode_all()
    dec = BatchDecoder(streams, device="cpu", group_size=2)
    got = dec.decode_all()
    assert dec.errors == base.errors == [None] * len(streams)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jdec = JaxBatchDecoder(streams, group_size=2)
    jdec.decode_all()
    assert dec.stats["windows"] == jdec.stats["windows"]
    assert dec.stats["windows"] > base.stats["windows"]
