"""Every BatchDecoder group kind of tests/test_torch_mesh.py with 8 lanes
over a mesh that names the CPU device 8 times: a lane a shard, each lane
held to the unsharded run and to the JAX package's run over 8 virtual CPU
devices (FLAC on both wires, QOA, WAV, MOD and XM bit for bit, MP3, Vorbis
and Opus within 1e-5 of the peak)."""

import pytest

from test_torch_mesh import KINDS, check_group_kind


@pytest.mark.parametrize("kind", KINDS)
def test_group_kind_8_lanes_over_8(kind):
    check_group_kind(kind, 8, 8)
