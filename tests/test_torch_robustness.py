"""The reference's corruption sweep through the port's batch decoder.

Each of tests/test_robustness.py's mutations of its QOA fixture (truncations,
byte flips, a zeroed run, splices, a garbage prefix) goes, one stream a
batch, through ``audio_formats_tpu``'s BatchDecoder and through
``audio_formats_torch``'s ``BatchDecoder(..., device="cpu")``: the PCM must
be bit-equal, the lane errors the same, and no group demoted.  The FLAC and
MP3 halves of the sweep are still to come.
"""

import functools

import numpy as np
import pytest

from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder

import test_robustness

N_MUTATIONS = 14   # 3 truncations, 6 flips, a zeroed run, 3 splices, a prefix


@functools.lru_cache(maxsize=None)
def _qoa_mutations():
    """The reference test's QOA fixture and its mutations, drawn from the
    reference test's seed in the reference test's order."""
    rng = np.random.default_rng(0xC0FFEE)
    data = test_robustness._fixtures(rng)["qoa"]
    return tuple(test_robustness._mutations(data, rng))


def test_sweep_has_every_mutation():
    assert len(_qoa_mutations()) == N_MUTATIONS


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_qoa_mutation_matches_jax(k):
    streams = [_qoa_mutations()[k]]
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all()
    assert tdec.errors == jdec.errors
    assert tdec.stats["group_demotions"] == 0
    assert not tdec.stats.get("lanes_demoted")
    for a, b in zip(got, want, strict=True):
        if b is None:
            assert a is None
        else:
            assert a is not None and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
