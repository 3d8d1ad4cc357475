"""`rdeic_torch.parallel.mesh` against `rdeic_tpu.parallel.mesh` on the CPU:
`make_mesh`'s shapes and its ValueError, case for case with
tests/test_parallel.py; the rows each dp index owns against where JAX's
`batch_sharding` places a batch over `jax.devices()[:dp * tp]` (the 8
virtual host devices of tests/conftest.py), on a mesh of devices and on a
process mesh, for dp in {1, 2, 4} and tp in {1, 2}; `init_distributed` with
an explicit coordinator in two gloo processes, without an environment (a
no-op), and a start that was asked for and fails."""
import re

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rdeic_torch.parallel.mesh import Mesh, init_distributed, make_mesh, shard_rows
from rdeic_tpu.parallel import mesh as j_mesh
from tests.torch_port_dist import Workers

CPUS = [torch.device("cpu")] * 8  # where JAX's 8 host devices stand


@pytest.mark.parametrize("dp,tp", [(4, 2), (None, 1), (3, 2), (None, 3)])
def test_make_mesh_shapes_and_refusals_are_jaxs(dp, tp):
    try:
        want = j_mesh.make_mesh(dp=dp, tp=tp).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{re.escape(str(e))}$"):
            make_mesh(dp=dp, tp=tp, devices=CPUS)
        return
    assert make_mesh(dp=dp, tp=tp, devices=CPUS).shape == dict(want)


def _jax_rows(dp: int, tp: int, batch: int) -> dict:
    """{flat mesh position: (first row, stop)} of a batch placed by
    batch_sharding on a dp x tp mesh of the first dp * tp host devices."""
    mesh = j_mesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    arr = jax.device_put(np.arange(batch * 3, dtype=np.float32).reshape(
        batch, 3), j_mesh.batch_sharding(mesh))
    flat = list(mesh.devices.flat)
    rows = {}
    for shard in arr.addressable_shards:
        index = shard.index[0]
        rows[flat.index(shard.device)] = (index.start or 0,
                                          batch if index.stop is None
                                          else index.stop)
    return rows


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_rows_land_where_batch_sharding_places_them(dp, tp):
    batch = 8
    want = _jax_rows(dp, tp, batch)
    devices = make_mesh(dp=dp, tp=tp, devices=CPUS[:dp * tp])
    ranks = make_mesh(dp=dp, tp=tp, devices=list(range(dp * tp)))
    assert ranks.grid == tuple(tuple(range(i * tp, (i + 1) * tp))
                               for i in range(dp))
    for pos, (start, stop) in want.items():
        rows = shard_rows(batch, dp, pos // tp)
        assert (rows.start, rows.stop) == (start, stop)
        rank_rows = Mesh(ranks.grid, rank=pos).rows(batch)
        assert (rank_rows.start, rank_rows.stop) == (start, stop)
    assert len(devices.devices()) == dp
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(batch + 1, 2, 0)


def test_init_distributed_with_a_coordinator(tmp_path):
    first, second = Workers("all_reduce", tmp_path).results()
    assert first == second == {"sum": 3.0, "backend": "gloo"}


def test_init_distributed_without_an_environment_does_nothing(monkeypatch):
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    mesh = make_mesh(devices=[torch.device("cpu")])
    assert mesh.shape == {"dp": 1, "tp": 1} and not mesh.distributed


def test_a_start_that_was_asked_for_and_fails_raises():
    """JAX's function swallows a failed start without a coordinator; the
    port raises whenever a start was asked for (here: no rank given)."""
    with pytest.raises((RuntimeError, ValueError)):
        init_distributed("127.0.0.1:1", num_processes=2, process_id=None,
                         device="cpu")
    assert not dist.is_initialized()
