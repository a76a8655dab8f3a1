"""``audio_formats_torch.entry.dryrun_multichip`` on the CPU: the step with
lanes over 'data' and channels over 'model', the scheduler and both batch
encoders over meshes that name the CPU device 4 and 8 times, each held to
its unsharded run; with the port's own WAV and QOA lanes, and with the
golden-built lanes of the JAX package's dryrun (__graft_entry__.py:154-237).
"""

import numpy as np
import pytest

from audio_formats_torch import entry

from golden import mp3_ref, opus_ref, vorbis_ref
from test_opus_silk import SILK_PACKETS

import torch_stream_cases


def jax_dryrun_items(n_devices):
    """The JAX package's dryrun lanes (__graft_entry__.py:154-235)."""
    return torch_stream_cases.dryrun_items(max(8, n_devices), mp3_ref,
                                           opus_ref, vorbis_ref,
                                           SILK_PACKETS)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_runs(n, capsys):
    out = entry.dryrun_multichip(n, devices=["cpu"] * n)
    assert out["mesh"] == {"data": n // 2, "model": 2}
    assert out["step_pcm"] == (8, 2, 2, 576)
    assert out["lanes"] == 8
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': ")
    assert line.endswith("sharded==unsharded")


def test_dryrun_multichip_on_the_jax_dryrun_lanes():
    items = jax_dryrun_items(8)
    out = entry.dryrun_multichip(8, devices=["cpu"] * 8, items=items)
    assert out["lanes"] == len(items) == 14
    assert "flac rice wire x4" in out["kinds"]


def test_dryrun_on_an_odd_count_has_no_model_axis():
    mesh_args = entry.pmesh.make_mesh(3, data=3, model=1, devices=["cpu"] * 3)
    args = entry._example_inputs(B=8)
    step = entry.sharded_step(mesh_args, args)
    fn, targs = entry.entry("cpu")
    want = fn(*targs)
    for w, g in zip(want, step):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


def test_entry_points_default_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        entry.dryrun_multichip(2)
