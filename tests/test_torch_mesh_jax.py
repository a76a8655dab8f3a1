"""The port's sharded runs against the JAX package's, on the CPU.

The JAX package shards one window tensor over 8 virtual CPU devices
(tests/conftest.py) and lets XLA partition it; the port runs each shard of
a lockstep group as a group of its own (parallel/mesh.py).  On the streams
of tests/test_parallel.py the port's run over a mesh that names the CPU
device 8 times must equal its unsharded run and JAX's sharded run: FLAC bit
for bit, MP3 and Vorbis within 1e-5 of the peak (tests/test_parallel.py's
bound).  The batch encoders are byte-equal three ways (sharded, unsharded,
JAX's ``mesh=``) on the JAX dryrun's encode streams
(__graft_entry__.py:277-287), and ``audio_formats_torch.entry``'s step
equals JAX's ``entry()`` step.
"""

import jax
import numpy as np

import __graft_entry__ as jentry
from audio_formats_tpu.config import (AudioSampleFormat as JFormat,
                                      EncodingOptions as JOptions)
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder
from audio_formats_tpu.parallel import encode as jenc

from audio_formats_torch import (AudioSampleFormat, BatchDecoder,
                                 EncodingOptions, encode_qoa_batch,
                                 encode_wav_batch, entry)

from golden import flac_ref
from test_parallel import _mp3_streams
from test_torch_mesh import (TOL, assert_lanes_equal, cpu_mesh, jax_mesh,
                             speech)


def _three_ways(streams, exact, device_output=False):
    """The port unsharded, the port over 8 x cpu, JAX over 8 CPU devices:
    the port's sharded lanes against the other two."""
    def run(dec):
        res = dec.decode_all(output="device" if device_output else "numpy")
        return res.to_numpy() if device_output else res

    base = run(BatchDecoder(streams, device="cpu"))
    got = run(BatchDecoder(streams, mesh=cpu_mesh(8)))
    jax_got = [np.asarray(a) for a in
               run(JaxBatchDecoder(streams, mesh=jax_mesh(8)))]
    assert_lanes_equal(base, got, exact)
    assert_lanes_equal(jax_got, got, exact)


def test_mesh_sharded_mp3_matches_unsharded_and_jax(rng):
    _three_ways(_mp3_streams(rng, 8), exact=False)


def test_mesh_sharded_flac_matches_unsharded_and_jax():
    x = np.clip(
        np.round(9000 * np.sin(2 * np.pi * 330 * np.arange(4096 * 6)[:, None]
                               / 44100.0)), -32768, 32767).astype(np.int64)
    data = flac_ref.build_flac(x, 44100, 16, block_size=4096,
                               modes=["lpc8"])
    _three_ways([data] * 8, exact=True)


def test_mesh_sharded_vorbis_device_matches_unsharded_and_jax(rng):
    """tests/test_parallel.py:54's streams, with output="device": the
    port's K11 chain a shard, JAX's window chain sharded on its lane
    axis."""
    from golden import vorbis_ref

    fix = vorbis_ref.Fixture(channels=1, bs0=512, bs1=2048)
    frames = []
    for j in range(6):
        lb = bool((j // 2) % 2)
        n2 = (fix.bs1 if lb else fix.bs0) // 2
        r = np.zeros(n2)
        idx = rng.choice(n2, size=n2 // 4, replace=False)
        r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
        prev_long = bool(((j - 1) // 2) % 2) if j > 0 else True
        next_long = bool(((j + 1) // 2) % 2) if j + 1 < 6 else True
        frames.append(fix.audio_packet(
            [[60, 70, 80, 90]], [r], long_block=lb,
            prev_flag=1 if prev_long else 0,
            next_flag=1 if next_long else 0))
    _three_ways([fix.build(frames)] * 8, exact=False, device_output=True)


def test_mixed_opus_under_16_lanes_takes_the_device_path_as_jax():
    """Six mode-tour lanes over a 4-device mesh: the port's mixed group
    answers its CELT syntheses on the device path (JAX's rule under a mesh,
    its batch.py:2901), within 1e-5 of the peak of JAX's sharded run and of
    the port's unsharded run (the host path below 16 lanes)."""
    s = [speech("tour", k % 2, 18 + 4 * k, (0, 130, 312)[k % 3])
         for k in range(6)]
    dec = BatchDecoder(s, mesh=cpu_mesh(4))
    got = dec.decode_all()
    assert dec.stats["windows_by_format"]["opus"] > 0
    assert "opus_mixed_host_rounds" not in dec.stats
    jdec = JaxBatchDecoder(s, mesh=jax_mesh(4))
    want = [np.asarray(a) for a in jdec.decode_all()]
    assert dec.errors == jdec.errors == [None] * 6
    assert_lanes_equal(want, got, False)
    base = BatchDecoder(s, device="cpu")
    assert_lanes_equal(base.decode_all(), got, False)
    assert base.stats["opus_mixed_host_rounds"] > 0


def test_qoa_encode_sharded_is_byte_equal_three_ways():
    pcms = entry._encode_pcms(8)
    st = {}
    got = encode_qoa_batch(pcms, 44100, mesh=cpu_mesh(8), stats=st)
    assert got == encode_qoa_batch(pcms, 44100, device="cpu")
    assert got == jenc.encode_qoa_batch(pcms, 44100, mesh=jax_mesh(8))
    # the 8 streams' 32 frame lanes are one chunk: a search a shard
    assert st["windows"] == 8


def test_wav_encode_sharded_is_byte_equal_three_ways():
    pcms = entry._encode_pcms(8)
    opt = EncodingOptions(sample_format=AudioSampleFormat.s24)
    st = {}
    got = encode_wav_batch(pcms, 44100, opt, mesh=cpu_mesh(8), stats=st)
    assert got == encode_wav_batch(pcms, 44100, opt, device="cpu")
    assert got == jenc.encode_wav_batch(
        pcms, 44100, JOptions(sample_format=JFormat.s24), mesh=jax_mesh(8))
    assert st["windows"] == 8


def test_entry_step_matches_jax_entry():
    """The port's entry() step on the CPU against JAX's entry() step on
    the same example inputs (JAX's, fitted to the port's signature),
    within 1e-5 of each output's peak."""
    fn, args = entry.entry("cpu")
    jfn, jargs = jentry.entry()
    got = fn(*args)
    want = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert_lanes_equal([np.asarray(w) for w in want],
                       [g.numpy() for g in got], False, tol=TOL)
