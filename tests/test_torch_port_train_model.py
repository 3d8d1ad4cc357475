"""The independent-phase training loss, rdeic_torch against rdeic_tpu on the
CPU at the micro config: the compression model's training forward, and
`loss_fn`'s loss, logs and the gradient of every trainable tensor against
`jax.value_and_grad`, from the same weights and the noise of JAX's own key
sequence."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.train.trainer import trainable_parameters
from rdeic_torch.utils.convert import convert_leaf
from tests.torch_port_helpers import MICRO, micro_pair, n, t

# fp32 on both sides; the loss is a sum of O(1) terms. Gradients are held
# per tensor against max |g| of that tensor: the two frameworks sum ~10^3-
# to 10^4-term convolutions and the CVQ softmax in other orders, which
# leaves ~1e-5 of max at most; a dropped or doubled term moves whole
# entries. Some gradients are zero but for rounding (a per-channel bias or
# the timestep projection right before a GroupNorm, which removes the
# channel mean): those are held against GRAD_FLOOR of the largest gradient.
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-5


def jax_train_noise(tm: TorchRDEIC, img: np.ndarray, rng) -> dict:
    """The draws of rdeic_tpu's `loss_fn(params, img, rng)`, in the port's
    `train_noise` layout: rng -> (in, t, loss); in -> (posterior,
    compression), whose key is split once per slice (compression.py:414)."""
    shapes = tm.train_noise(torch.zeros(img.shape))
    rng_in, rng_t, rng_loss = jax.random.split(rng, 3)
    rng_z, rng_like = jax.random.split(rng_in)
    uniform = []
    for u in shapes["uniform"]:
        rng_like, sub = jax.random.split(rng_like)
        uniform.append(t(jax.random.uniform(sub, tuple(u.shape), jnp.float32,
                                            -0.5, 0.5)))
    z_shape = tuple(shapes["posterior"].shape)
    return dict(
        posterior=t(jax.random.normal(rng_z, z_shape, jnp.float32)),
        t=torch.from_numpy(np.array(jax.random.randint(
            rng_t, (img.shape[0],), 0, tm.used_timesteps))).long(),
        eps=t(jax.random.normal(rng_loss, z_shape, jnp.float32)),
        uniform=uniform)


def jax_grads_in_port_layout(j_grads) -> dict:
    return {convert_leaf("/".join(k), np.asarray(v))[0]:
            convert_leaf("/".join(k), np.asarray(v))[1]
            for k, v in flatten_dict(j_grads).items()}


def assert_grads_close(got: dict, want: dict) -> None:
    floor = GRAD_FLOOR * max(np.abs(want[k].numpy()).max() for k in got)
    for name, g in got.items():
        w = want[name].numpy()
        err = np.abs(n(g) - w).max() / max(np.abs(w).max(), floor)
        assert err <= GRAD_REL, f"{name}: max|diff|/max|g| {err:.3g}"


@pytest.fixture(scope="module")
def pair():
    return micro_pair(seed=0)


def _img(seed=4, shape=(2, 64, 64, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_compression_training_forward_matches_jax(pair):
    jm, params, tm = pair
    h = np.random.default_rng(1).normal(size=(2, 16, 16, 16)).astype(np.float32)
    rng = jax.random.PRNGKey(2)
    want = jax.jit(lambda p, x: jm.compression.apply(
        {"params": p}, x, rng=rng, training=True))(params["compression"], h)
    noise, key = [], rng
    for c in tm.compression.slice_ch:
        key, sub = jax.random.split(key)
        noise.append(t(jax.random.uniform(sub, (2, 8, 8, c), jnp.float32,
                                          -0.5, 0.5)))
    with torch.no_grad():
        got = tm.compression(t(h), noise=noise, training=True)
    assert set(got) == set(want)
    np.testing.assert_array_equal(n(got["vq_indices"]),
                                  np.asarray(want["vq_indices"]))
    for key in ("c_latent", "guide_hint", "y_likelihoods", "q_likelihoods",
                "z"):
        np.testing.assert_allclose(n(got[key]), np.asarray(want[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["emb_loss"].item(), float(want["emb_loss"]),
                               rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="noise"):
        tm.compression(t(h), training=True)


@pytest.fixture(scope="module")
def loss_run(pair):
    jm, params, tm = pair
    img = _img()
    rng = jax.random.PRNGKey(7)
    (j_loss, j_logs), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jnp.asarray(img), rng), has_aux=True))(params)
    noise = jax_train_noise(tm, img, rng)
    params_t = trainable_parameters(tm)
    loss, logs = tm.loss_fn(t(img), noise=noise)
    grads = torch.autograd.grad(loss, list(params_t.values()))
    return dict(j_loss=float(j_loss), j_logs=j_logs, j_grads=j_grads,
                loss=loss.item(), logs=logs, noise=noise, img=img,
                grads=dict(zip(params_t, grads)))


def test_loss_and_logs_match_jax(loss_run):
    r = loss_run
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=LOSS_RTOL)
    assert set(r["logs"]) == set(r["j_logs"])
    for key, want in r["j_logs"].items():  # _z_hyper: O(1) values, as above
        np.testing.assert_allclose(n(r["logs"][key]), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=key)


def test_every_trainable_gradient_matches_jax(loss_run, pair):
    _, params, tm = pair
    want = jax_grads_in_port_layout(loss_run["j_grads"])
    got = loss_run["grads"]
    # the trainable set: the compression model, the control module and the
    # bridges; the base UNet and the VAE stay frozen under sd_locked
    assert any(k.startswith("compression.") for k in got)
    assert any(k.startswith("denoiser.control.") for k in got)
    assert not any(k.startswith(("denoiser.base.", "vae.")) for k in got)
    assert_grads_close(got, want)


def test_checkpointed_denoiser_gives_the_same_gradients(loss_run, pair):
    """use_checkpoint recomputes the blocks in the backward: the same loss
    and the same gradients as keeping the activations."""
    _, _, tm = pair
    cfg = copy.deepcopy(MICRO)
    cfg["control_stage_config"]["params"]["use_checkpoint"] = True
    tc = TorchRDEIC(**cfg, device="cpu")
    tc.load_state_dict(tm.state_dict())
    params_t = trainable_parameters(tc)
    loss, _ = tc.loss_fn(t(loss_run["img"]), noise=loss_run["noise"])
    grads = torch.autograd.grad(loss, list(params_t.values()))
    assert loss.item() == loss_run["loss"]
    for name, g in zip(params_t, grads):
        torch.testing.assert_close(g, loss_run["grads"][name], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("parameterization", ["x0", "v"])
def test_unported_training_options_raise(parameterization):
    """The x0 and v parameterizations are ported (their losses against
    JAX's: tests/test_torch_port_train_settings.py): each builds and its
    loss runs, and what stays refused is a parameterization the JAX loss
    does not know either; `remat_policy: "dots"` is ported and builds."""
    tm = TorchRDEIC(**copy.deepcopy(MICRO), parameterization=parameterization,
                    device="cpu")
    loss, _ = tm.loss_fn(torch.zeros(1, 64, 64, 3), generator=torch.Generator())
    assert tm.parameterization == parameterization and torch.isfinite(loss)
    tm.parameterization = "score"
    with pytest.raises(NotImplementedError, match="score"):
        tm.loss_fn(torch.zeros(1, 64, 64, 3), generator=torch.Generator())
    cfg = copy.deepcopy(MICRO)
    cfg["control_stage_config"]["params"]["remat_policy"] = "dots"
    assert TorchRDEIC(**cfg, device="cpu").denoiser.remat_policy == "dots"
    # the refine phase is ported: it runs
    tm = TorchRDEIC(**copy.deepcopy(MICRO), is_refine=True, device="cpu")
    loss, logs = tm.loss_fn(torch.zeros(1, 64, 64, 3), generator=torch.Generator())
    assert torch.isfinite(loss) and {"l_mse", "l_lpips"} <= set(logs)


def test_generator_noise_has_the_loss_fns_shapes(pair):
    _, _, tm = pair
    img = t(_img(seed=5, shape=(1, 64, 128, 3)))
    noise = tm.train_noise(img, torch.Generator().manual_seed(0))
    assert noise["posterior"].shape == noise["eps"].shape == (1, 32, 64, 4)
    assert [tuple(u.shape) for u in noise["uniform"]] == [(1, 16, 32, 4)] * 2
    assert noise["uniform"][0].abs().max() <= 0.5
    assert 0 <= int(noise["t"].min()) and int(noise["t"].max()) < 300
    loss, logs = tm.loss_fn(img, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and logs["_z_hyper"].shape == (1, 4, 8, 8)
