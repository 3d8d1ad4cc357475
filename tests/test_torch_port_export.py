"""The port's weights out to the JAX package, at the micro config with a
CLIP tower on the CPU: rdeic_tpu's `save_params_npz` -> the port
(`load_npz_weights`) -> the port's `save_params_npz` gives the same file,
key for key and bit for bit, fp32 and with the leaves JAX's
`cast_inference_params` stores in bf16 (both write them as fp32); rdeic_tpu's
`load_params_npz` of a file the port wrote from weights of its own gives
the JAX model the port's decode within ATOL (2e-4). The conversion CLI:
test_torch_port_convert_cli.py."""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils import checkpoint_io as t_io
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.utils import checkpoint_io as j_io
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    ATOL, MICRO, n, one_torch_thread_per_module, random_leaf, t, unflatten)


@pytest.fixture(scope="module")
def clip_flat():
    """Random flat JAX params of the micro RDEIC with a CLIP tower."""
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=(64, 64), include_clip=True),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    return jm, {"/".join(k): random_leaf("/".join(k), v.shape, rng)
                for k, v in sorted(flatten_dict(template).items())}


def read(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_a_jax_export_round_trips_bit_for_bit(clip_flat, tmp_path, bf16):
    _, flat = clip_flat
    params = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    if bf16:
        params = JaxRDEIC.cast_inference_params(params, jnp.bfloat16)
    j_io.save_params_npz(str(tmp_path / "jax.npz"), jax.device_get(params))
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    tm.attach_clip()
    if bf16:
        tm.cast_inference_params(torch.bfloat16)
    t_io.load_npz_weights(tm, tmp_path / "jax.npz")
    assert (next(tm.denoiser.parameters()).dtype
            == (torch.bfloat16 if bf16 else torch.float32))
    t_io.save_params_npz(tmp_path / "port.npz", tm)
    want, got = read(tmp_path / "jax.npz"), read(tmp_path / "port.npz")
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype == np.float32, key
        assert got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key
    # the re-exports are utils/convert.py's, not copies
    assert t_io.load_params_npz(tmp_path / "port.npz").keys() == want.keys()


def test_jax_loads_the_ports_file_and_decodes_as_the_port(clip_flat, tmp_path):
    """Weights the port made (the JAX ones scaled leaf by leaf in torch)
    through the port's file into rdeic_tpu's `load_params_npz`."""
    jm, flat = clip_flat
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    t_io.load_npz_weights(tm, _save(tmp_path / "seed.npz", flat))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for v in tm.state_dict().values():
            v.mul_(1 + 0.1 * torch.randn(v.shape, generator=gen))
    t_io.save_params_npz(tmp_path / "port.npz", tm)
    params = j_io.load_params_npz(str(tmp_path / "port.npz"))
    rng = np.random.default_rng(12)
    c_latent = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    guide_hint = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jm.jitted_decode(steps=2)(params, jnp.asarray(c_latent),
                                     jnp.asarray(guide_hint), key)
    relay, steps = _jax_noise(key, c_latent.shape, 2)
    got = tm.decode_pipeline(t(c_latent), t(guide_hint), 2,
                             relay_noise=relay, step_noise=steps)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def _save(path, flat) -> Path:
    np.savez(path, **flat)
    return path
