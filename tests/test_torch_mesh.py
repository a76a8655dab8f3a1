"""The port's multi-device surface on the CPU: ``parallel/mesh.py`` and
``BatchDecoder(..., mesh=)`` over meshes that name the CPU device 4 and 8
times.

Every BatchDecoder group kind decodes 13 lanes over data=4 and 8 lanes over
8 shards, each lane held to the same lanes' unsharded run and to the JAX
package's run over as many virtual CPU devices: FLAC (both wires), QOA,
WAV, MOD and XM bit for bit, MP3, Vorbis and Opus within 1e-5 of the peak
(the JAX package's sharded bound, tests/test_parallel.py:37).
The meshes of the device-plan and sync tests name ``cpu:0`` .. ``cpu:3``:
distinct torch devices on which tensors land on the CPU, so a test can tell
the shards' devices apart.  tests/test_torch_mesh_wide.py runs every kind
with 8 lanes over 8, tests/test_torch_mesh_jax.py holds the port's sharded
runs to the JAX package's, and tests/test_torch_mesh_dryrun.py runs the
entry points (files of their own, so that pytest-xdist runs them side by
side: the QOA and MP3 twins cost ~1-2 s a shard).
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder
from audio_formats_tpu.parallel.mesh import make_mesh as jax_make_mesh

from audio_formats_torch import BatchDecoder, entry
from audio_formats_torch.parallel import (batch_channel_sharding,
                                          batch_sharding, make_mesh,
                                          shard_batch)
from audio_formats_torch.parallel import batch as tbatch
from audio_formats_torch.parallel import groups

from golden import flac_ref, opus_ref, qoa_ref, vorbis_ref, wav_ref
from test_mod import _simple_mod
from test_opus_silk import SILK_PACKETS
from test_torch_mp3_batch import (_corrupt, _facade, _flac, _layer1,
                                  _layer2)
from test_torch_mp3_huff import mp3_stream
from test_torch_vorbis import _frames
from test_xm import _simple_xm

import torch_opus_cases as music_cases
import torch_opus_speech_cases as speech_cases

TOL = 1e-5   # of the peak: sharded float lanes against unsharded

KINDS = ("flac", "flac_rice", "mp3_l1", "mp3_l2", "mp3_l3", "qoa", "wav",
         "vorbis", "celt", "silk", "hybrid", "opus_mixed", "mod", "xm")
#: kinds whose PCM is integer-exact whatever the sharding
EXACT = ("flac", "flac_rice", "qoa", "wav", "mod", "xm")


# ------------------------------------------------------------ the streams
def speech(kind, k, n, preskip=312):
    """A stream of the first `n` packets of the k-th speech master of
    `kind` ("silk", "hybrid" or "tour")."""
    mi = [i for i, kd in enumerate(speech_cases.kinds()) if kd == kind][k]
    return speech_cases.stream(opus_ref.build_ogg_opus,
                               speech_cases.load()[mi], n, preskip=preskip)


def rice_flac(seed):
    """A short stereo FLAC stream of 256-sample blocks: the Rice wire's CPU
    twin loops over a dispatch's block samples."""
    rng = np.random.default_rng(seed)
    n = 700 + 37 * (seed % 7)
    t = np.arange(n)[:, None]
    pcm = np.clip(np.round(8000 * np.sin(2 * np.pi * 300 * t * [1, 1.4]
                                         / 44100)
                           + 200 * rng.standard_normal((n, 2))),
                  -32768, 32767).astype(np.int64)
    return flac_ref.build_flac(pcm, 44100, 16, block_size=256,
                               stereo_mode="mid_side", modes=["lpc8", "lpc8"])


def _one(kind, i):
    rng = np.random.default_rng(1000 * KINDS.index(kind) + i)
    if kind == "flac":
        return _flac(100 + i)
    if kind == "flac_rice":
        return rice_flac(100 + i)
    if kind == "mp3_l1":
        return _layer1(200 + i)
    if kind == "mp3_l2":
        return _layer2(300 + i)
    if kind == "mp3_l3":
        return mp3_stream(400 + i, channels=1, big=False, n_frames=3 + i % 4)
    if kind == "qoa":
        # one short mono frame a stream: the golden encoder is slow
        return qoa_ref.encode(rng.integers(-9000, 9000, (900 + 50 * i, 1))
                              .astype(np.int16), 44100)
    if kind == "wav":
        n = 500 + 90 * i
        return wav_ref.build_wav(
            wav_ref.pack_pcm(rng.integers(-32768, 32768, 2 * n)
                             .astype(np.int32), 16),
            fmt_tag=1, channels=2, sample_rate=44100, bits=16)
    if kind == "vorbis":
        fix = vorbis_ref.Fixture(channels=1)
        return fix.build(_frames(fix, rng, 3 + i % 4))
    if kind == "celt":
        return music_cases.stream(opus_ref.build_ogg_opus,
                                  music_cases.load()[i % 4], 4 + i % 5,
                                  preskip=(0, 130, 312)[i % 3])
    if kind == "silk":
        if i == 0:
            return opus_ref.build_ogg_opus(
                [(bytes.fromhex(h), 960) for h in SILK_PACKETS],
                channels=1, preskip=0)
        return speech("silk", 1, 6 + i % 5)
    if kind == "hybrid":
        return speech("hybrid", 2, 5 + i % 4, (0, 312)[i % 2])
    if kind == "opus_mixed":
        return speech("tour", i % 2, 20 + 3 * (i % 4), (0, 130, 312)[i % 3])
    if kind == "mod":
        return _simple_mod(periods=(428 - 20 * (i % 4),))
    if kind == "xm":
        return _simple_xm(rows=8, notes=((0, 49 + i % 5),))
    raise ValueError(kind)


def streams(kind, n):
    """n lanes of a BatchDecoder group kind (MOD and XM: the per-stream
    read), of unequal lengths where the format allows."""
    return [_one(kind, i) for i in range(n)]


def wire(kind):
    return "rice" if kind == "flac_rice" else "packed"


def cpu_mesh(n, distinct=False):
    """A data-n mesh on the CPU: "cpu" n times, or cpu:0 .. cpu:n-1."""
    devs = [torch.device("cpu", k) for k in range(n)] if distinct \
        else ["cpu"] * n
    return make_mesh(n, data=n, devices=devs)


def jax_mesh(n):
    """The JAX package's data-n mesh of its virtual CPU devices
    (tests/conftest.py)."""
    return jax_make_mesh(n, data=n, model=1, devices=jax.devices("cpu")[:n])


def jax_decode(s, kind, data):
    """The JAX package's BatchDecoder over a data-`data` mesh (its FLAC
    Rice wire is switched on by AF_TPU_FLAC_DEVICE_RICE).  Returns (the
    decoder, its PCM as numpy)."""
    env = {"AF_TPU_FLAC_DEVICE_RICE": "1" if wire(kind) == "rice" else "0"}
    with mock.patch.dict(os.environ, env):
        jdec = JaxBatchDecoder(s, mesh=jax_mesh(data))
        out = jdec.decode_all()
    return jdec, [None if a is None else np.asarray(a) for a in out]


def assert_lanes_equal(want, got, exact, tol=TOL):
    """Each lane of `got` against `want` (entry.compare_lanes): bit for
    bit, or within `tol` of the peak.  Returns the largest error over the
    peak."""
    return entry.compare_lanes(want, got, lambda i: exact, tol)


# --------------------------------------------------------------- the mesh
def test_make_mesh_raises_without_cuda_devices():
    """Without ``devices`` the mesh is of CUDA devices, and this box has
    none: no fallback to the CPU."""
    assert torch.cuda.device_count() == 0
    for n in (None, 1, 8):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh(n)
    with pytest.raises(RuntimeError):
        make_mesh(2, devices=["cuda:0", "cuda:1"])


def test_make_mesh_raises_with_too_few_devices():
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(8, devices=["cpu"] * 7)
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(4, data=4, model=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("n,data,model,want", [
    (8, None, 1, (8, 1)), (8, 4, 2, (4, 2)), (4, None, 2, (2, 2)),
    (6, 3, 1, (3, 1))])
def test_make_mesh_shape(n, data, model, want):
    mesh = make_mesh(n, data=data, model=model, devices=["cpu"] * n)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == want
    assert mesh.shape == {"data": want[0], "model": want[1]}
    assert mesh.data_devices == [torch.device("cpu")] * want[0]


def test_mesh_keeps_device_order_and_indices():
    devs = [torch.device("cpu", k) for k in range(4)]
    mesh = make_mesh(4, data=2, model=2, devices=devs)
    assert mesh.devices.tolist() == [devs[:2], devs[2:]]
    assert mesh.data_devices == [devs[0], devs[2]]


@pytest.mark.parametrize("rows", [8, 13, 3])
def test_shard_batch_splits_the_leading_axis(rows):
    """shard_batch: every leaf's leading axis in data contiguous pieces,
    sized as np.array_split gives them; an uneven count is fine."""
    mesh = cpu_mesh(4, distinct=True)
    x = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
    tree = {"x": x, "pair": (torch.from_numpy(x.copy()), 7)}
    out = shard_batch(tree, mesh)
    want = np.array_split(x, 4)
    for pieces in (out["x"], out["pair"][0]):
        assert len(pieces) == 4
        for p, w in zip(pieces, want):
            assert isinstance(p, torch.Tensor)
            np.testing.assert_array_equal(p.numpy(), w)
    assert out["pair"][1] == 7
    plan = batch_sharding(mesh)
    np.testing.assert_array_equal(
        plan.gather(plan.split(x)).numpy(), x)


def test_batch_channel_sharding_round_trip():
    """Batch on 'data', channels on 'model': each piece is its lanes'
    channel, and gather joins the grid back."""
    mesh = make_mesh(4, data=2, model=2, devices=["cpu"] * 4)
    x = torch.arange(8 * 2 * 3 * 2).reshape(8, 2, 3, 2)
    plan = batch_channel_sharding(mesh, 4, channel_axis=1)
    grid = plan.split(x)
    assert torch.equal(grid[1][0], x[4:, 0:1])
    assert torch.equal(grid[0][1], x[:4, 1:2])
    assert torch.equal(plan.gather(grid), x)
    assert batch_channel_sharding(mesh, 1).spec == ("data",)


def test_mesh_module_imports_no_jax():
    code = ("import sys; import audio_formats_torch.parallel.mesh; "
            "import audio_formats_torch.entry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'audio_formats_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_device_other_than_the_mesh_first_raises():
    mesh = cpu_mesh(4, distinct=True)
    with pytest.raises(ValueError, match="mesh's first device"):
        BatchDecoder([], device="cpu:1", mesh=mesh)
    assert BatchDecoder([], device="cpu:0", mesh=mesh).device == \
        torch.device("cpu", 0)
    assert BatchDecoder([], mesh=mesh).device == torch.device("cpu", 0)


# -------------------------------------------------- every group, sharded
def check_group_kind(kind, lanes, data):
    """`lanes` lanes of `kind` over a data-`data` mesh against the
    unsharded run and the JAX package's run over `data` devices: the same
    PCM and errors, no demotion, each shard's windows its own; the mixed
    Opus group, under 16 lanes, on the device path only under the mesh, as
    the JAX package's."""
    s = streams(kind, lanes)
    base = BatchDecoder(s, device="cpu", flac_wire=wire(kind))
    want = base.decode_all()
    dec = BatchDecoder(s, mesh=cpu_mesh(data), flac_wire=wire(kind))
    got = dec.decode_all()
    jdec, jax_got = jax_decode(s, kind, data)
    assert dec.errors == base.errors == jdec.errors == [None] * lanes
    assert dec.stats["group_demotions"] == 0
    assert_lanes_equal(want, got, kind in EXACT)
    assert_lanes_equal(jax_got, got, kind in EXACT)
    wb, wd = base.stats["windows_by_format"], dec.stats["windows_by_format"]
    if kind == "opus_mixed":
        assert wb == {} and base.stats["opus_mixed_host_rounds"] > 0
        assert wd["opus"] > 0 and "opus_mixed_host_rounds" not in dec.stats
        return
    assert wb.keys() == wd.keys()
    for fmt in wd:
        assert wd[fmt] >= wb[fmt]
        if fmt not in ("opus", "opus_silk"):
            # every window of these formats runs each of its shard's lanes
            assert wd[fmt] >= min(lanes, data)


@pytest.mark.parametrize("kind", KINDS)
def test_group_kind_13_lanes_over_4(kind):
    check_group_kind(kind, 13, 4)


# ---------------------------------------------- the shard plan and sync
GROUP_FNS = ("flac", "l12", "wav", "vorbis", "silk", "opus_mixed", "mp3")
PLAN = (("flac", 6, "flac"), ("mp3_l1", 5, "l12"), ("wav", 3, "wav"),
        ("vorbis", 4, "vorbis"), ("mp3_l3", 5, "mp3"),
        ("opus_mixed", 3, "opus_mixed"))


def test_each_group_call_gets_its_shard_device(monkeypatch):
    """Every group call (the mixed Opus group's on its thread too) receives
    the device of its shard: group_size 4, each chunk split over cpu:0 ..
    cpu:3 as np.array_split gives it, an empty shard running nothing."""
    calls = []

    def recorded(e):
        def record(ctx, decs, key):
            calls.append((e.name, decs, ctx.device))
            return e.decode(ctx, decs, key)
        return e._replace(decode=record) if e.name in GROUP_FNS else e

    monkeypatch.setattr(groups, "TABLE", tuple(map(recorded, groups.TABLE)))
    items, want = [], []
    devs = [torch.device("cpu", k) for k in range(4)]
    for kind, n, fn in PLAN:
        lanes = list(range(len(items), len(items) + n))
        items += streams(kind, n)
        for c in range(0, n, 4):
            for dev, idx in zip(devs, np.array_split(lanes[c: c + 4], 4)):
                if idx.size:
                    want.append((fn, tuple(int(i) for i in idx), dev))
    dec = BatchDecoder(items, mesh=cpu_mesh(4, distinct=True), group_size=4)
    got = dec.decode_all()
    assert dec.errors == [None] * len(items)
    calls = [(name, tuple(next(i for i, d in enumerate(dec.decoders)
                               if d is x) for x in decs), device)
             for name, decs, device in calls]
    assert sorted(calls, key=str) == sorted(want, key=str)
    assert set(dec.devices_used) == set(devs)
    assert all(g is not None for g in got)


def test_sync_synchronizes_every_device_used(monkeypatch):
    """DeviceBatchResult.sync() waits on each device the shards used, once
    each (the repair: it waited on the decoder's first device only)."""
    seen = []
    monkeypatch.setattr(tbatch, "_synchronize", seen.append)
    items = streams("flac", 5) + streams("wav", 3)
    res = BatchDecoder(items, mesh=cpu_mesh(4, distinct=True)) \
        .decode_all(output="device")
    assert res.sync() is res
    assert sorted(seen, key=str) == \
        [torch.device("cpu", k) for k in range(4)]
    seen.clear()
    BatchDecoder(items, device="cpu").decode_all(output="device").sync()
    assert seen == [torch.device("cpu")]


def test_device_output_stays_with_its_shard():
    """output="device": each group's PCM windows are the shard's, and
    to_numpy() gives the numpy output."""
    items = streams("flac", 6) + streams("wav", 4)
    mesh = cpu_mesh(4, distinct=True)
    res = BatchDecoder(items, mesh=mesh).decode_all(output="device")
    kinds = [k for k, _ in res.windows()]
    assert sorted(kinds) == ["flac"] * 4 + ["wav"] * 4
    want = BatchDecoder(items, device="cpu").decode_all()
    assert_lanes_equal(want, res.to_numpy(), True)


def test_corrupt_lane_in_shard_two_demotes_only_itself():
    """13 MP3 lanes over data=4 (shards of 4, 3, 3, 3 lanes), lane 8 of
    shard 2 corrupt: it alone leaves the grouped path, and every lane,
    itself included, equals the unsharded run.  The other lanes equal the
    JAX package's run over 4 devices, and the corrupt one JAX's facade: a
    granule of it reads Huffman pairs past its own bits, which JAX's batch
    fills from the leftover memory of its rows
    (tests/test_torch_mp3_batch.py holds the lane so too)."""
    s = streams("mp3_l3", 13)
    s[8] = _corrupt(mp3_stream(23, mode_ext=2), 23)
    base = BatchDecoder(s, device="cpu")
    want = base.decode_all()
    dec = BatchDecoder(s, mesh=cpu_mesh(4, distinct=True))
    got = dec.decode_all()
    jdec, jax_got = jax_decode(s, "mp3_l3", 4)
    assert dec.errors == base.errors == jdec.errors
    jax_got[8] = _facade(s[8])
    assert_lanes_equal(jax_got, got, False)
    assert all(e is None for i, e in enumerate(dec.errors) if i != 8)
    assert dec.stats.get("lanes_demoted", 0) <= 1
    assert base.stats.get("lanes_demoted", 0) == \
        dec.stats.get("lanes_demoted", 0)
    assert_lanes_equal(want, got, False)
