"""Data-parallel training, rdeic_torch over two gloo processes against the
JAX `Trainer` under `make_mesh(dp=2)` on the CPU, at the micro config: two
micro-steps at accumulate_grad_batches=2 on a global batch of 4, each rank
stepping on its 2 rows with the global batch's noise; per step the logs
(grad_norm too), the codebook and its usage, after the AdamW update the
mean gradient and the trainable weights, at test_torch_port_train_loop's
tolerances; both ranks hold the same weights, bit for bit. A `dp=1, tp=2`
world (each rank the whole batch) is bit-equal to one process. And guards:
on this batch a codebook update or a contrastive loss taken on a rank's
rows alone misses the whole batch's, so the gather is needed."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.models.compression import vq_codebook_update, vq_logits
from rdeic_torch.train.trainer import Trainer
from rdeic_torch.utils.convert import convert_leaf
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.train import trainer as j_trainer
from tests.test_torch_port_train_loop import LR, _img, micro_train_pair
from tests.test_torch_port_train_model import (
    GRAD_FLOOR,
    LOSS_RTOL,
    assert_grads_close,
    jax_grads_in_port_layout,
    jax_train_noise,
)
from tests.torch_port_dist import Workers
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, n, one_torch_thread_per_module, t)

GLOBAL_B = 4


def port_inputs(tm, imgs, noise, dp, tp, accumulate=2, config=MICRO):
    return dict(config=copy.deepcopy(config), state=tm.state_dict(),
                imgs=[t(i) for i in imgs], noise=noise, accumulate=accumulate,
                lr=LR, dp=dp, tp=tp)


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The JAX Trainer on a dp = 2 mesh of two host devices, and the port's
    two ranks at dp = 2 and at dp = 1, tp = 2, from the same weights, images
    and noise. The ranks run while JAX compiles."""
    jm, params, tm = micro_train_pair(seed=0)
    imgs = [_img(21, (GLOBAL_B, 64, 64, 3)), _img(22, (GLOBAL_B, 64, 64, 3))]
    rng, keys = jax.random.PRNGKey(3), []
    for _ in imgs:
        rng, step_rng = jax.random.split(rng)  # as the JAX step splits
        keys.append(step_rng)
    noise = [jax_train_noise(tm, img, k) for img, k in zip(imgs, keys)]
    jobs = {}
    for dp, tp in ((2, 1), (1, 2)):
        work = tmp_path_factory.mktemp(f"dp{dp}_tp{tp}")
        torch.save(port_inputs(tm, imgs, noise, dp, tp), work / "inputs.pt")
        jobs[dp, tp] = Workers("train", work)
    mesh = j_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    jt = j_trainer.Trainer(jm, accumulate_grad_batches=2, mesh=mesh)
    state = jt.init_state(params, jax.random.PRNGKey(3))
    j_logs, j_codebook = [], []
    for img in imgs:
        state, logs = jt.step(state, jnp.asarray(img))
        # the host copy keeps the step's input placement, so the second call
        # reuses the compiled step (its outputs come back sharded)
        state = jax.device_get(state)
        j_logs.append(jax.device_get(logs))
        j_codebook.append(
            (state.train_params["compression"]["quantize"]["embedding"],
             state.frozen_params["vq_embed_prob"]))
    return dict(tm=tm, imgs=imgs, noise=noise, j_logs=j_logs,
                j_codebook=j_codebook, state=state,
                ranks=jobs[2, 1].results(), tp_ranks=jobs[1, 2].results())


def test_each_rank_steps_on_its_rows(ddp_run):
    assert [r["rows"] for r in ddp_run["ranks"]] == [[(0, 2)] * 2,
                                                     [(2, 4)] * 2]


def test_step_logs_match_jax_under_its_mesh(ddp_run):
    for rank in ddp_run["ranks"]:
        for logs, j_logs in zip(rank["logs"], ddp_run["j_logs"]):
            assert set(logs) == set(j_logs)
            for key, want in j_logs.items():
                np.testing.assert_allclose(n(logs[key]), np.asarray(want),
                                           rtol=LOSS_RTOL, err_msg=key)


def test_codebook_updates_like_jax_under_its_mesh(ddp_run):
    """The codebook update takes the whole batch's hyper latent on every
    rank: the usage EMA to 1e-6, the codebook to the weights' bound."""
    for rank in ddp_run["ranks"]:
        for e, p, (je, jp) in zip(rank["codebook"], rank["prob"],
                                  ddp_run["j_codebook"]):
            np.testing.assert_allclose(n(p), np.asarray(jp), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(n(e), np.asarray(je),
                                       atol=2 * LR + 1e-6)


def assert_step_matches_jax(rank: dict, state, mu_of_state) -> None:
    """AdamW's first moment held as the gradients are; the stepped weights
    where the mean gradient is well above rounding, and within 2 lr
    elsewhere (test_torch_port_train_loop's rule)."""
    j_mu = jax_grads_in_port_layout(mu_of_state(state))
    assert set(rank["exp_avg"]) == set(j_mu)
    assert_grads_close(rank["exp_avg"], j_mu)
    j_params = {convert_leaf("/".join(k), np.asarray(v))[0]:
                convert_leaf("/".join(k), np.asarray(v))[1].numpy()
                for k, v in flatten_dict(state.train_params).items()}
    floor = GRAD_FLOOR * max(np.abs(v.numpy()).max() for v in j_mu.values())
    for name, p in rank["params"].items():
        got, want, g = n(p), j_params[name], np.abs(j_mu[name].numpy())
        firm = g > 1e-2 * max(g.max(), floor)
        atol = 1e-5 if name == "compression.quantize.embedding" else 1e-7
        np.testing.assert_allclose(got[firm], want[firm], rtol=1e-6,
                                   atol=atol, err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-3) + 1e-7, name


def test_mean_gradient_and_weights_match_jax_under_its_mesh(ddp_run):
    for rank in ddp_run["ranks"]:
        assert_step_matches_jax(
            rank, ddp_run["state"],
            lambda s: s.opt_state.inner_opt_state[0].mu)


def test_ranks_hold_the_same_weights_bit_for_bit(ddp_run):
    a, b = (r["state"] for r in ddp_run["ranks"])
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    for x, y in zip(*(r["logs"] for r in ddp_run["ranks"])):
        for key in x:
            assert torch.equal(x[key], y[key]), key


def test_tp_group_ranks_equal_one_process(ddp_run):
    """`trainer.mesh: {dp: 1, tp: 2}` as train.py reads it: both ranks take
    the whole batch (the batch is sharded over dp alone), so the step is
    one process's, bit for bit (the sum of two equal gradients over two is
    exact)."""
    tm = copy.deepcopy(ddp_run["tm"])
    trainer = Trainer(tm, learning_rate=LR, accumulate_grad_batches=2)
    logs = [trainer.step(t(img), noise=nz)
            for img, nz in zip(ddp_run["imgs"], ddp_run["noise"])]
    for rank in ddp_run["tp_ranks"]:
        assert rank["rows"] == [(0, GLOBAL_B)] * 2
        for got, want in zip(rank["logs"], logs):
            for key in want:
                assert torch.equal(got[key], want[key]), key
        for key, v in tm.state_dict().items():
            assert torch.equal(rank["state"][key], v), key


def test_rank_local_codebook_and_contrastive_terms_would_miss(ddp_run):
    """Guards of the gather. On this batch a codebook update from one rank's
    rows alone (its usage and closest rows) misses the whole batch's, which
    the JAX update matches above, by far more than the codebook's limits,
    and the two ranks would part. The contrastive term picks, per code, the
    n // K closest and the n // 2 farthest of all n rows; at the micro
    config its 0.07-temperature softmax is saturated (the term is 0 to
    rounding whole or halved), so it is read with the rows and codes 10x
    closer together, where the mean of the per-rank terms (n halved)
    misses the whole batch's by more than the loss tolerance."""
    tm = ddp_run["tm"]
    with torch.no_grad():
        _, cond = tm.get_input(t(ddp_run["imgs"][0]), ddp_run["noise"][0])
    z = cond["z_hyper"].reshape(-1, tm.compression.N)  # the whole batch
    halves = z.reshape(GLOBAL_B, -1, z.shape[-1]).split(GLOBAL_B // 2)
    halves = [h.reshape(-1, z.shape[-1]) for h in halves]
    emb, prob = tm.compression.quantize.embedding.detach(), tm.vq_embed_prob
    whole_emb, whole_prob = vq_codebook_update(emb, prob, z)
    for rows in halves:
        e, p = vq_codebook_update(emb, prob, rows)
        assert (e - whole_emb).abs().max() > 100 * (2 * LR + 1e-6)
        assert ((p - whole_prob).abs() > 1e-6 * whole_prob.abs()).any()
    quant = tm.compression.quantize
    with torch.no_grad():
        assert float(quant._contrastive(vq_logits(z, emb))) == 0.0
        whole = quant._contrastive(vq_logits(z * 0.1, emb * 0.1))
        local = torch.stack([quant._contrastive(vq_logits(h * 0.1, emb * 0.1))
                             for h in halves]).mean()
    assert abs(float(local - whole)) > 100 * LOSS_RTOL * abs(float(whole))
