"""Data-parallel training of the refine phase, rdeic_torch over two gloo
processes against the JAX `Trainer` under `make_mesh(dp=2)` on the CPU, at
the micro config: one micro-step of the refine recipe (accumulation 1,
lr 2e-5) on a global batch of 4, each rank stepping on its 2 rows with the
global batch's noise. The logs, the codebook and its usage; AdamW's first
moment as the refine test holds gradients (with the port's own move under
a +-1e-6 nudge of the images, which marks the tensors behind LeakyReLU's
kink); the stepped weights; both ranks' weights bit-equal."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.train.trainer import trainable_parameters
from rdeic_torch.utils.convert import convert_leaf
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.train import trainer as j_trainer
from tests.test_torch_port_refine import (
    LR,
    _img,
    _rel,
    assert_refine_grads_close,
    jax_refine_noise,
    refine_pair,
)
from tests.test_torch_port_train_model import LOSS_RTOL, jax_grads_in_port_layout
from tests.torch_port_dist import Workers
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, n, one_torch_thread_per_module, t)

GLOBAL_B = 4


@pytest.fixture(scope="module")
def refine_ddp(tmp_path_factory):
    """JAX's step on the dp = 2 mesh, the port's two ranks (running while
    JAX compiles) and the port's gradient moves under image nudges."""
    jm, params, tm, _ = refine_pair(seed=0)
    img = _img(31, (GLOBAL_B, 64, 64, 3))
    _, step_rng = jax.random.split(jax.random.PRNGKey(3))  # as the JAX step
    noise = jax_refine_noise(tm, img, step_rng)
    work = tmp_path_factory.mktemp("refine_ddp")
    torch.save(dict(config=dict(copy.deepcopy(MICRO), is_refine=True),
                    state=tm.state_dict(), imgs=[t(img)], noise=[noise],
                    accumulate=1, lr=LR, dp=2, tp=1), work / "inputs.pt")
    job = Workers("train", work)
    mesh = j_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    jt = j_trainer.Trainer(jm, learning_rate=LR, accumulate_grad_batches=1,
                           mesh=mesh)
    state = jt.init_state(params, jax.random.PRNGKey(3))
    state, j_logs = jt.step(state, jnp.asarray(img))
    params_t = trainable_parameters(tm)

    def port_grads(x):
        loss, _ = tm.loss_fn(t(x), noise=noise)
        return dict(zip(params_t, torch.autograd.grad(
            loss, list(params_t.values()))))

    grads = port_grads(img)
    moves = dict.fromkeys(grads, 0.0)
    for eps in (1e-6, -1e-6):
        for k, g in port_grads(img * (1 + eps)).items():
            moves[k] = max(moves[k], _rel(g, n(grads[k])))
    return dict(state=jax.device_get(state), j_logs=jax.device_get(j_logs),
                moves=moves, ranks=job.results())


def test_refine_logs_and_codebook_match_jax_under_its_mesh(refine_ddp):
    j_logs, state = refine_ddp["j_logs"], refine_ddp["state"]
    je = state.train_params["compression"]["quantize"]["embedding"]
    jp = state.frozen_params["vq_embed_prob"]
    for rank in refine_ddp["ranks"]:
        assert rank["rows"] == [(0, 2)] or rank["rows"] == [(2, 4)]
        (logs,) = rank["logs"]
        assert set(logs) == set(j_logs)
        for key, want in j_logs.items():
            np.testing.assert_allclose(n(logs[key]), np.asarray(want),
                                       rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(n(rank["prob"][0]), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(n(rank["codebook"][0]), np.asarray(je),
                                   atol=2 * LR + 1e-6)


def test_refine_gradient_and_weights_match_jax_under_its_mesh(refine_ddp):
    """The refine test's rules: AdamW's first moment (0.1 x the gradient
    after one step) within 1e-4 of max or twice the port's nudge move; the
    weights where the gradient is well above rounding, within 2 lr
    elsewhere."""
    state = refine_ddp["state"]
    j_mu = jax_grads_in_port_layout(state.opt_state[0].mu)  # no MultiSteps
    j_params = {convert_leaf("/".join(k), np.asarray(v))[0]:
                convert_leaf("/".join(k), np.asarray(v))[1].numpy()
                for k, v in flatten_dict(state.train_params).items()}
    for rank in refine_ddp["ranks"]:
        assert set(rank["exp_avg"]) == set(j_mu)
        assert_refine_grads_close(rank["exp_avg"], j_mu, refine_ddp["moves"])
        for name, p in rank["params"].items():
            got, want = n(p), j_params[name]
            g = np.abs(j_mu[name].numpy()) / 0.1
            firm = (g > 1e-2 * g.max()) & (g > 1e-6)
            atol = 1e-5 if name == "compression.quantize.embedding" else 1e-7
            np.testing.assert_allclose(got[firm], want[firm], rtol=1e-6,
                                       atol=atol, err_msg=name)
            assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-3) + 1e-7, name


def test_refine_ranks_hold_the_same_weights_bit_for_bit(refine_ddp):
    a, b = (r["state"] for r in refine_ddp["ranks"])
    for key in a:
        assert torch.equal(a[key], b[key]), key
