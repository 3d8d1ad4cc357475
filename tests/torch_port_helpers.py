"""Shared pieces of the rdeic_torch parity tests: the micro config, random
JAX params with every leaf filled (flax's zero-inits included, so the control
branch and the zero projections are really checked), and the moves between
the two frameworks."""
import copy

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC

ATOL = 2e-4  # fp32 module parity, as tests/test_torch_parity.py

# the structure of tests/helpers.py:micro_rdeic
MICRO = dict(
    control_stage_config=dict(params=dict(
        in_channels=4, out_channels=4, hint_channels=8, model_channels=16,
        num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
        num_head_channels=8, context_dim=16, control_model_ratio=0.5,
        control_scale=1.0)),
    unet_config=dict(params=dict(num_head_channels=8)),
    first_stage_config=dict(params=dict(
        embed_dim=4, ddconfig=dict(ch=8, ch_mult=[1, 2], num_res_blocks=1))),
    preprocess_config=dict(params=dict(
        in_nc=16, out_nc=4, N=8, M=8, slice_num=2, slice_ch=[4, 4],
        codebook_size=32)),
    fixed_step=2, used_timesteps=300, timesteps=1000,
)


def random_leaf(path: str, shape, rng: np.random.Generator) -> np.ndarray:
    """Fan-in scaled kernels, near-one norm scales, small biases: every leaf
    random, with activations kept O(1) through the stacks."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        x = rng.normal(size=shape) / np.sqrt(fan_in)
    elif leaf == "scale":
        x = 1.0 + 0.2 * rng.normal(size=shape)
    elif leaf == "embedding":
        x = 0.5 * rng.normal(size=shape)
    else:
        x = 0.2 * rng.normal(size=shape)
    return x.astype(np.float32)


def random_flat_params(jax_model, image_hw, seed=0) -> dict:
    """{"vae/encoder/.../kernel": array} for every leaf of `init_params`,
    from shapes alone (no init program is compiled)."""
    template = jax.eval_shape(
        lambda r: jax_model.init_params(r, image_hw=image_hw),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {"/".join(k): random_leaf("/".join(k), v.shape, rng)
            for k, v in sorted(flatten_dict(template).items())}


def unflatten(flat: dict) -> dict:
    from flax.traverse_util import unflatten_dict  # noqa: PLC0415

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def micro_pair(seed=0, image_hw=(64, 64)):
    """(jax model, jax params, torch model on the CPU) sharing random weights."""
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    flat = random_flat_params(jm, image_hw, seed)
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    tm.load_state_dict(load_jax_params(flat), strict=True)
    return jm, jax.tree_util.tree_map(jax.numpy.asarray, unflatten(flat)), tm.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_per_module():
    """The module's tests and fixtures on one torch thread. Micro models are
    many small ops; beside the other test workers' thread pools, each op's
    pool fights theirs for the cores (a file of 20 s alone took minutes in
    the suite). Import it into a test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
