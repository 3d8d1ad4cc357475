"""`remat_policy: "dots"` (selective activation checkpointing of the UNet
blocks), on the CPU at the micro config: values and gradients bit-equal to
whole-block recompute and to no recompute, the recompute running no
convolution or matrix product again (their outputs are kept), and equal to
the JAX package's `nn.remat(..., policy=checkpoint_dots)` at the fp32
parity limit (ATOL-scale: 2e-4 of each gradient's max)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rdeic_torch.models.unet import DOTS_OPS, NoiseEstimator
from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.train.trainer import trainable_parameters
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.test_torch_port_train_model import jax_grads_in_port_layout
from tests.torch_port_helpers import MICRO, n, random_flat_params, t, unflatten
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

# fp32 parity, relative to each tensor's max |gradient|, or to FLOOR x the
# largest gradient where a tensor's own is zero but for rounding: the
# timestep embedding's weights reach eps only through per-channel biases
# right before GroupNorms, which remove the channel mean (their gradients
# read ~1e-6 of 42 here, and two JAX runs, with and without remat, already
# differ by 2e-2 of that)
REL = 2e-4
FLOOR = 1e-3


def config(use_checkpoint: bool, policy) -> dict:
    cfg = copy.deepcopy(MICRO)
    cfg["control_stage_config"]["params"].update(use_checkpoint=use_checkpoint,
                                                  remat_policy=policy)
    return cfg


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    hint = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 16)).astype(np.float32)
    cot = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    return x, hint, ctx, np.array([17, 250]), cot


@pytest.fixture(scope="module")
def flat():
    return random_flat_params(JaxRDEIC(**copy.deepcopy(MICRO)), (64, 64), seed=1)


class CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def port_run(flat, inputs, use_checkpoint, policy):
    """(eps, {name: gradient} of the control branch, the bridges, x and the
    hint, the aten ops the backward ran) for sum(eps * cot)."""
    tm = TorchRDEIC(**config(use_checkpoint, policy), device="cpu")
    tm.load_state_dict(load_jax_params(flat), strict=True)
    params = trainable_parameters(tm)
    params = {k: p for k, p in params.items() if k.startswith("denoiser.")}
    x, hint, ctx, tt, cot = inputs
    xs = {"x": t(x).requires_grad_(), "hint": t(hint).requires_grad_()}
    eps = tm.denoiser(xs["x"], torch.from_numpy(tt), t(ctx), xs["hint"])
    leaves = {**params, **xs}
    with CountOps() as ops:
        grads = torch.autograd.grad((eps * t(cot)).sum(), list(leaves.values()))
    return eps.detach(), dict(zip(leaves, grads)), ops.counts


@pytest.fixture(scope="module")
def runs(flat, inputs):
    return {name: port_run(flat, inputs, ckpt, policy)
            for name, ckpt, policy in (("none", False, None),
                                       ("blocks", True, None),
                                       ("dots", True, "dots"))}


def test_dots_gives_the_bits_of_whole_block_recompute(runs):
    eps, grads, _ = runs["dots"]
    for other in ("blocks", "none"):
        o_eps, o_grads, _ = runs[other]
        assert torch.equal(eps, o_eps), other
        for k, g in grads.items():
            assert torch.equal(g, o_grads[k]), (other, k)


def test_dots_keeps_the_products_and_recomputes_the_rest(runs):
    """In the backward, whole-block recompute runs every block's
    convolutions and products again; dots runs none of them again (their
    outputs were kept), but still recomputes the rest (here the GroupNorm's
    statistics)."""
    _, _, blocks = runs["blocks"]
    _, _, dots = runs["dots"]
    _, _, plain = runs["none"]
    conv = torch.ops.aten.convolution.default
    assert blocks.get(conv, 0) > 0
    for op in DOTS_OPS:
        assert dots.get(op, 0) == plain.get(op, 0), op
    var_mean = [op for op in blocks if "var_mean" in str(op) or "mean" in str(op)]
    assert var_mean and all(dots.get(op, 0) > plain.get(op, 0) for op in var_mean)


def test_dots_matches_jax_checkpoint_dots(runs, flat, inputs):
    jm = JaxRDEIC(**config(True, "dots"))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    x, hint, ctx, tt, cot = inputs
    den = params["denoiser"]
    train = {k: v for k, v in den.items() if k != "base"}

    def loss(train, x, hint):
        p = dict(params, denoiser=dict(den, **train))
        eps = jm.apply_model(p, x, jnp.asarray(tt), jnp.asarray(ctx), hint)
        return jnp.sum(eps * cot), eps

    (_, j_eps), (g_train, g_x, g_hint) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(train, jnp.asarray(x), jnp.asarray(hint))
    eps, grads, _ = runs["dots"]
    np.testing.assert_allclose(n(eps), np.asarray(j_eps), atol=2e-4)
    want = {f"denoiser.{k}": v for k, v in
            jax_grads_in_port_layout(g_train).items()}
    want.update(x=torch.from_numpy(np.array(g_x)),
                hint=torch.from_numpy(np.array(g_hint)))
    assert set(want) == set(grads)
    floor = FLOOR * max(np.abs(w.numpy()).max() for w in want.values())
    for k, g in grads.items():
        w = want[k].numpy()
        err = np.abs(n(g) - w).max() / max(np.abs(w).max(), floor)
        assert err <= REL, f"{k}: {err:.3g}"


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        NoiseEstimator(model_channels=16, channel_mult=(1,), num_res_blocks=1,
                       attention_resolutions=(), remat_policy="offload")
