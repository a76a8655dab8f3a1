"""The reference's corruption sweep and demotion lattice through the port's
batch decoder.

Each of tests/test_robustness.py's mutations of its QOA and FLAC fixtures
(truncations, byte flips, a zeroed run, splices, a garbage prefix) goes, one
stream a batch, through ``audio_formats_tpu``'s BatchDecoder and through
``audio_formats_torch``'s ``BatchDecoder(..., device="cpu")``, FLAC on both
wires (JAX's device-Rice wire under ``AF_TPU_FLAC_DEVICE_RICE=1``): the PCM
must be bit-equal, the lane errors the same, and no group demoted.  The MP3
half of the sweep is still to come.

The reference's per-lane demotion test runs on the port, on both FLAC wires:
a fault injected at the wire's host seam for one lane of a 64-lane group
demotes that lane alone, the others stay grouped and bit-exact, and a
KernelError is raised, never demoted around.
"""

import functools

import numpy as np
import pytest

from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder
from audio_formats_torch.errors import AudioFormatError
from audio_formats_torch.host import native as tnative
from audio_formats_torch.models.flac import FlacDecoder
from audio_formats_torch.ops import flac_rice, lpc
from audio_formats_torch.ops._kernels import KernelError

from golden import flac_ref

import test_robustness

N_MUTATIONS = 14   # 3 truncations, 6 flips, a zeroed run, 3 splices, a prefix


@functools.lru_cache(maxsize=None)
def _qoa_mutations():
    """The reference test's QOA fixture and its mutations, drawn from the
    reference test's seed in the reference test's order."""
    rng = np.random.default_rng(0xC0FFEE)
    data = test_robustness._fixtures(rng)["qoa"]
    return tuple(test_robustness._mutations(data, rng))


@functools.lru_cache(maxsize=None)
def _flac_mutations():
    """The same for the reference test's FLAC fixture."""
    rng = np.random.default_rng(0xC0FFEE)
    data = test_robustness._fixtures(rng)["flac"]
    return tuple(test_robustness._mutations(data, rng))


def test_sweep_has_every_mutation():
    assert len(_qoa_mutations()) == N_MUTATIONS
    assert len(_flac_mutations()) == N_MUTATIONS


def _matches_jax(streams, **kw):
    """The port's CPU batch decode of `streams` against JAX's: the same
    lane errors, bit-equal PCM, no demotion."""
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu", **kw)
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


@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_qoa_mutation_matches_jax(k):
    _matches_jax([_qoa_mutations()[k]])


@pytest.mark.parametrize("wire", ["packed", "rice"])
@pytest.mark.parametrize("k", range(N_MUTATIONS))
def test_flac_mutation_matches_jax(k, wire, monkeypatch):
    if wire == "rice":
        monkeypatch.setenv("AF_TPU_FLAC_DEVICE_RICE", "1")
    _matches_jax([_flac_mutations()[k]], flac_wire=wire)


@functools.lru_cache(maxsize=None)
def _lattice_streams():
    """The reference test's 64 FLAC lanes, marked by distinct lengths."""
    streams = []
    for k in range(64):
        n = 2048 + 64 + 7 * k
        t = np.arange(n)[:, None]
        x = np.clip(np.round(
            6000 * np.sin(2 * np.pi * (220 + 3 * k) * t * [1, 1.31] / 44100)
        ), -32768, 32767).astype(np.int64)
        streams.append(flac_ref.build_flac(
            x, 44100, 16, block_size=1024, stereo_mode="mid_side",
            modes=["lpc8", "fixed3"]))
    return tuple(streams)


@pytest.mark.parametrize("wire", ["packed", "rice"])
def test_per_lane_demotion_keeps_group(wire, monkeypatch):
    """One lane of a 64-lane group faults at its wire's host seam (the
    window parse of the packed wire; the frame sync index of the Rice
    wire) and in the single-stream decoder's frame parse: the group
    bisects, that lane alone is demoted and fails, and the 63 others
    equal a clean batch, for output="numpy" and "device"."""
    streams = list(_lattice_streams())
    bad_len = len(streams[13])
    assert sum(len(s) == bad_len for s in streams) == 1
    clean = [s for i, s in enumerate(streams) if i != 13]
    solo = BatchDecoder(clean, device="cpu", flac_wire=wire).decode_all()

    def fault():
        raise AudioFormatError("injected lane fault")

    orig = FlacDecoder._parse_frame_tensors
    monkeypatch.setattr(
        FlacDecoder, "_parse_frame_tensors",
        lambda self: fault() if len(self._view) == bad_len else orig(self))
    if wire == "packed":
        orig_win = tnative.flac_parse_window
        monkeypatch.setattr(
            tnative, "flac_parse_window",
            lambda lib, data, *a: fault() if len(data) == bad_len
            else orig_win(lib, data, *a))
        seam = "flac_parse_window_multi"
    else:
        seam = "flac_sync_index_multi"
    orig_multi = getattr(tnative, seam)

    def multi(lib, lanes, data_ptrs, data_lens, *a):
        if any(int(data_lens[bi]) == bad_len for bi in lanes):
            fault()
        return orig_multi(lib, lanes, data_ptrs, data_lens, *a)

    monkeypatch.setattr(tnative, seam, multi)
    for output in ("numpy", "device"):
        dec = BatchDecoder(streams, device="cpu", flac_wire=wire)
        out = dec.decode_all(output=output)
        if output == "device":
            out = out.sync().to_numpy()
        assert dec.stats["lanes_demoted"] == 1
        assert any("injected lane fault" in e
                   for e in dec.stats["group_exceptions"])
        assert out[13] is None and dec.errors[13] is not None
        for got, want in zip(out[:13] + out[14:], solo, strict=True):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire,module,fn", [
    ("packed", lpc, "flac_lpc"), ("rice", lpc, "flac_lpc"),
    ("rice", flac_rice, "flac_frame_entropy")])
def test_kernel_error_is_not_demoted(wire, module, fn, monkeypatch):
    """A kernel that does not build, load or launch is no lane's fault:
    decode_all raises it on either wire, and no lane is demoted."""
    def fail(*args, **kwargs):
        raise KernelError(f"{fn} kernel launch failed: CUDA error 700")

    monkeypatch.setattr(module, fn, fail)
    dec = BatchDecoder(list(_lattice_streams()[:4]), device="cpu",
                       flac_wire=wire)
    with pytest.raises(KernelError, match="CUDA error 700"):
        dec.decode_all()
    assert dec.stats["group_demotions"] == 0
