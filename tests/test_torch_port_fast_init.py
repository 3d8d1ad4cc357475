"""`rdeic_torch.utils.fast_init.fast_random_init` against the JAX package's
`fast_random_params(model, hw, seed=seed, device=False)` on the CPU, at the
micro config of both phases: every tensor bit-equal, carried across by
utils/convert.py's rule; with the frozen tensors cast to bf16 on the `meta`
model first, they are made in bf16 directly, equal to the JAX values
rounded, and the rest stay fp32."""
import copy

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.train.trainer import cast_frozen, is_frozen_float, trainable_predicate
from rdeic_torch.utils.convert import load_jax_params
from rdeic_torch.utils.fast_init import flax_path, fast_random_init
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.utils.fast_init import fast_random_params
from tests.torch_port_helpers import MICRO

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")


def jax_values(is_refine: bool, seed: int) -> dict:
    jm = JaxRDEIC(**copy.deepcopy(MICRO), is_refine=is_refine)
    tree = fast_random_params(jm, (64, 64), seed=seed, device=False)
    return load_jax_params({"/".join(k): v
                            for k, v in flatten_dict(tree).items()})


@pytest.mark.parametrize("is_refine", [False, True])
def test_fast_init_is_the_jax_tree_bit_for_bit(is_refine):
    want = jax_values(is_refine, seed=5)
    tm = TorchRDEIC(**copy.deepcopy(MICRO), is_refine=is_refine, device="meta")
    fast_random_init(tm, "cpu", seed=5)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
    # the rule's three kinds of leaves all occur
    assert torch.equal(got["vq_embed_prob"], torch.zeros_like(got["vq_embed_prob"]))
    assert (got["denoiser.base.out_norm.GroupNorm_0.weight"] == 1).all()
    assert got["uncond_context"].std() > 0


@pytest.mark.parametrize("is_refine", [False, True])
def test_fast_init_makes_frozen_tensors_in_bf16(is_refine):
    want = jax_values(is_refine, seed=7)
    tm = TorchRDEIC(**copy.deepcopy(MICRO), is_refine=is_refine, device="meta")
    cast_frozen(tm, torch.bfloat16)  # on meta: nothing is allocated
    fast_random_init(tm, "cpu", seed=7)
    pred = trainable_predicate(tm.sd_locked)
    frozen = 0
    for k, v in tm.state_dict().items():
        if is_frozen_float(k, v, pred):
            frozen += 1
            assert v.dtype == torch.bfloat16, k
            assert torch.equal(v, want[k].to(torch.bfloat16)), k
        else:
            assert v.dtype == torch.float32, k
            assert torch.equal(v, want[k]), k
    assert frozen > 0 and tm.vq_embed_prob.dtype == torch.float32


def test_flax_path_inverts_convert_leaf():
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="meta")
    state = tm.state_dict()
    path, shape = flax_path("denoiser.base.out_conv.weight",
                            state["denoiser.base.out_conv.weight"])
    assert path[-1] == "kernel" and shape == (3, 3, 16, 4)  # HWIO
    path, shape = flax_path("denoiser.base.time_embed.fc1.weight",
                            state["denoiser.base.time_embed.fc1.weight"])
    assert path[-1] == "kernel" and shape == (16, 64)  # (in, out)
    path, _ = flax_path("vae.encoder.norm_out.GroupNorm_0.weight",
                        state["vae.encoder.norm_out.GroupNorm_0.weight"])
    assert path[-1] == "scale"
    assert flax_path("vq_embed_prob", state["vq_embed_prob"])[0] == ("vq_embed_prob",)
    assert np.prod(flax_path("compression.quantize.embedding",
                             state["compression.quantize.embedding"])[1]) > 0
