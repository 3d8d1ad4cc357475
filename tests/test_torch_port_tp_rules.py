"""Tensor-parallel placement rules, rdeic_torch against rdeic_tpu on the CPU:
the port's `params_shardings` marks as sharded exactly the leaves that the
JAX `params_shardings` puts on "tp" (on the 8-device virtual mesh of
tests/conftest.py), for the micro RDEIC with a CLIP tower and LPIPS and for
a micro CLIP tower alone, at tp = 2 and 4; each sharded tensor splits on
its output axis (dim 0 here, the flax kernel's last axis) into contiguous
blocks in tp order; a kernel whose output axis does not divide by tp (63,
as tests/test_parallel.py's) stays replicated, as a norm does; a mesh of
one process refuses tp > 1."""
import copy

import jax
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec as P
from torch import nn

from rdeic_torch.models import blocks
from rdeic_torch.models import clip as t_clip
from rdeic_torch.parallel.mesh import (make_mesh, param_spec, params_shardings,
                                       shard_params)
from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils.checkpoint_io import state_to_flat
from rdeic_torch.utils.fast_init import flax_path
from rdeic_tpu.models import clip as j_clip
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.parallel.mesh import params_shardings as j_params_shardings
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, one_torch_thread_per_module)


def jax_sharded(template, tp: int) -> set:
    """The flat paths the JAX rule puts on "tp" at dp x tp = 8."""
    specs = j_params_shardings(template, j_make_mesh(dp=8 // tp, tp=tp))
    return {"/".join(k) for k, v in flatten_dict(specs).items()
            if v.spec != P()}


def port_sharded(model, tp: int) -> set:
    """The flat flax paths of the port's parameters that its rule shards,
    checked to split dim 0 into tp contiguous blocks in tp order."""
    mesh = make_mesh(dp=8 // tp, tp=tp, devices=[torch.device("cpu")] * 8)
    out = set()
    for name, s in params_shardings(model, mesh).items():
        p = model.get_parameter(name)
        assert s.shape == tuple(p.shape) and s.tp == tp and s.index == 0
        if s.sharded:
            assert s.dim == 0
            step = p.shape[0] // tp
            assert [s.block(i) for i in range(tp)] == [
                slice(i * step, (i + 1) * step) for i in range(tp)]
            out.add("/".join(flax_path(name, p)[0]))
    return out


@pytest.fixture(scope="module")
def micro_with_clip():
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=(64, 64), include_clip=True,
                                 include_lpips=True), jax.random.PRNGKey(0))
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="meta")
    tm.attach_clip()
    with torch.device("meta"):
        from rdeic_torch.models.lpips import LPIPS  # noqa: PLC0415

        tm.lpips = LPIPS("alex")
    return template, tm


@pytest.mark.parametrize("tp", [2, 4])
def test_micro_rdeic_marks_the_jax_leaves(micro_with_clip, tp):
    template, tm = micro_with_clip
    want = jax_sharded(template, tp)
    assert want  # the rule shards something at the micro widths
    assert port_sharded(tm, tp) == want
    # every leaf of the template is a port parameter or buffer
    names = {"/".join(flax_path(k, v)[0])
             for k, v in list(tm.named_parameters()) + list(tm.named_buffers())}
    assert names == {"/".join(k) for k in flatten_dict(template)}


@pytest.mark.parametrize("tp", [2, 4])
def test_micro_clip_tower_marks_the_jax_leaves(tp):
    cfg = dict(width=32, heads=4, layers=3, penultimate=False)
    template = jax.eval_shape(
        lambda r: j_clip.OpenCLIPTextEncoder(**cfg).init(
            r, jax.numpy.zeros((1, 77), jax.numpy.int32)),
        jax.random.PRNGKey(0))["params"]
    with torch.device("meta"):
        tm = t_clip.OpenCLIPTextEncoder(**cfg)
    want = jax_sharded(template, tp)
    assert {k.rsplit("/", 2)[-2] for k in want} == {
        "in_proj", "out_proj", "mlp_fc", "mlp_proj"}
    assert port_sharded(tm, tp) == want


class _Odd(nn.Module):
    """tests/test_parallel.py's leaves as port layers."""

    def __init__(self):
        super().__init__()
        self.attn = nn.Module()
        self.attn.to_q = blocks.Linear(64, 64, bias=False)
        self.odd = nn.Module()
        self.odd.to_q = blocks.Linear(64, 63, bias=False)
        self.norm = blocks.LayerNorm(64)


def test_an_indivisible_output_axis_stays_replicated():
    model = _Odd()
    mesh = make_mesh(dp=4, tp=2, devices=[torch.device("cpu")] * 8)
    got = params_shardings(model, mesh)
    assert param_spec("odd.to_q.weight", model.odd.to_q.weight) == 0
    assert got["attn.to_q.weight"].sharded
    assert got["attn.to_q.weight"].block(1) == slice(32, 64)
    assert not got["odd.to_q.weight"].sharded
    assert got["odd.to_q.weight"].block() == slice(None)
    assert not got["norm.weight"].sharded and not got["norm.bias"].sharded
    # the JAX rule on the same leaves, in the flax layout
    flat = state_to_flat(model.state_dict())
    template = {tuple(k.split("/")): jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in flat.items()}
    from flax.traverse_util import unflatten_dict  # noqa: PLC0415

    assert jax_sharded(unflatten_dict(template), 2) == {"attn/to_q/kernel"}


def test_a_mesh_of_one_process_refuses_tp():
    model = _Odd()
    mesh = make_mesh(dp=1, tp=2, devices=[torch.device("cpu")] * 2)
    assert not mesh.distributed
    with pytest.raises(ValueError, match="tensor-parallel placement"):
        shard_params(model, mesh)
    assert model.attn.to_q.tp is None and model.attn.to_q.weight.shape == (64, 64)
    # tp = 1 places nothing, on any mesh
    shard_params(model, make_mesh(dp=2, tp=1, devices=[torch.device("cpu")] * 2))
    assert model.attn.to_q.tp is None and model.attn.to_q.weight.shape == (64, 64)
