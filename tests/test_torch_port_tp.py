"""Tensor-parallel training, rdeic_torch over gloo processes after
`shard_params` against the JAX `Trainer` after `shard_params` under
`make_mesh(dp, tp, jax.devices()[:dp * tp])`, at the micro config: here
dp = 1, tp = 2 (test_torch_port_tp_dp.py runs dp = 2, tp = 2 with the same
checks). Two micro-steps at accumulate_grad_batches=2 on a global batch of
4 from the same weights, images and noise: the logs (grad_norm too)
within LOSS_RTOL (1e-5); the mean gradient (AdamW's first moment) within
1e-4 of its tensor's max (GRAD_FLOOR of the largest at least); the
weights where that gradient is firm to 1e-6 and within 2 lr elsewhere
(test_torch_port_ddp's rule), both against JAX and against the port's
plain Trainer (tp = 1). The ranks' replicated tensors are bit-equal and
their blocks are the contiguous tp blocks; the gathered `step_N.pt`
holds whole tensors, resumes at tp = 1 and takes a step there; a tp = 1
checkpoint resumes in the sharded ranks, each taking its block."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from rdeic_torch.train.trainer import Trainer, trainable_parameters
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.parallel.mesh import shard_params as j_shard_params
from rdeic_tpu.train import trainer as j_trainer
from tests.test_torch_port_ddp import assert_step_matches_jax, port_inputs
from tests.test_torch_port_train_loop import LR, _img, micro_train_pair
from tests.test_torch_port_train_model import (
    LOSS_RTOL,
    assert_grads_close,
    jax_train_noise,
)
from tests.torch_port_dist import Workers
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    n, one_torch_thread_per_module, t)

GLOBAL_B = 4


def exp_avg_of(state: dict, names: list) -> dict:
    """AdamW's first moments of a `Trainer.save` file, by parameter name
    (the optimizer's state is keyed by the index in `Trainer.params`)."""
    return {names[i]: st["exp_avg"]
            for i, st in state["optimizer"]["state"].items()}


def tp_run(tmp_path_factory, dp: int, tp: int) -> dict:
    """The port's ranks at (dp, tp), its plain Trainer, and the JAX Trainer
    after shard_params on the (dp, tp) mesh, from the same weights, images
    and noise; the ranks run while JAX compiles, and then load the plain
    Trainer's checkpoint."""
    jm, params, tm = micro_train_pair(seed=0)
    imgs = [_img(31, (GLOBAL_B, 64, 64, 3)), _img(32, (GLOBAL_B, 64, 64, 3))]
    rng, keys = jax.random.PRNGKey(3), []
    for _ in imgs:
        rng, step_rng = jax.random.split(rng)  # as the JAX step splits
        keys.append(step_rng)
    noise = [jax_train_noise(tm, img, k) for img, k in zip(imgs, keys)]
    work = tmp_path_factory.mktemp(f"tp_dp{dp}_tp{tp}")
    plain_model = copy.deepcopy(tm)
    plain = Trainer(plain_model, learning_rate=LR, accumulate_grad_batches=2)
    plain_logs = [plain.step(t(img), noise=nz) for img, nz in zip(imgs, noise)]
    plain.save(work / "plain.pt")
    inputs = port_inputs(tm, imgs, noise, dp, tp)
    inputs["resume"] = str(work / "plain.pt")
    torch.save(inputs, work / "inputs.pt")
    ranks = Workers("tp", work, world=dp * tp)

    mesh = j_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    jt = j_trainer.Trainer(jm, accumulate_grad_batches=2, mesh=mesh)
    state = jt.init_state(j_shard_params(params, mesh), jax.random.PRNGKey(3))
    placed = jax.tree_util.tree_map(lambda x: x.sharding, state)

    def replace(host, sharding):
        """A leaf back in its first placement (the sharded ones on the
        mesh, the rest uncommitted), so the second call reuses the compiled
        step."""
        return (jax.device_put(host, sharding)
                if isinstance(sharding, NamedSharding) else host)

    j_logs = []
    for img in imgs:
        state, logs = jt.step(state, jnp.asarray(img))
        state = jax.tree_util.tree_map(replace, jax.device_get(state), placed)
        j_logs.append(jax.device_get(logs))
    results = ranks.results()
    ckpt = torch.load(work / "ckpt.pt", weights_only=True)
    names = list(plain.params)
    return dict(tm=tm, imgs=imgs, noise=noise, j_logs=j_logs,
                state=jax.device_get(state), ranks=results, ckpt=ckpt,
                ckpt_path=work / "ckpt.pt", names=names, plain=plain,
                plain_logs=plain_logs,
                plain_state=torch.load(work / "plain.pt", weights_only=True),
                tp=tp)


def gathered(run) -> dict:
    """The ranks' gathered step as test_torch_port_ddp's `rank` dict."""
    ckpt = run["ckpt"]
    return {"params": {k: ckpt["model"][k] for k in run["names"]},
            "exp_avg": exp_avg_of(ckpt, run["names"])}


def check_blocks_and_replicas(run) -> None:
    """Each rank holds tp index (rank % tp)'s block of every sharded
    kernel; the ranks' replicated trainable tensors are bit-equal after the
    steps, and their sharded ones are the gathered tensors' blocks."""
    tp, ckpt = run["tp"], run["ckpt"]
    for r, rank in enumerate(run["ranks"]):
        assert rank["blocks"]
        for name, (lo, hi) in rank["blocks"].items():
            rows = ckpt["model"][name].shape[0]
            assert (lo, hi) == (r % tp * rows // tp, (r % tp + 1) * rows // tp)
            if name in rank["params"]:
                assert torch.equal(rank["params"][name],
                                   ckpt["model"][name][lo:hi]), name
        for name, p in rank["params"].items():
            if name not in rank["blocks"]:
                assert torch.equal(p, run["ranks"][0]["params"][name]), name
    for other in run["ranks"][1:]:
        for x, y in zip(run["ranks"][0]["logs"], other["logs"]):
            for key in x:
                assert torch.equal(x[key], y[key]), key


def check_logs(run) -> None:
    for rank in run["ranks"]:
        for logs, j_logs, p_logs in zip(rank["logs"], run["j_logs"],
                                        run["plain_logs"]):
            assert set(logs) == set(j_logs) == set(p_logs)
            for key, want in j_logs.items():
                np.testing.assert_allclose(n(logs[key]), np.asarray(want),
                                           rtol=LOSS_RTOL, err_msg=key)
                np.testing.assert_allclose(n(logs[key]), n(p_logs[key]),
                                           rtol=LOSS_RTOL, err_msg=key)


def check_step_against_jax(run) -> None:
    assert_step_matches_jax(gathered(run), run["state"],
                            lambda s: s.opt_state.inner_opt_state[0].mu)


def check_step_against_one_process(run) -> None:
    """The gathered first moments and weights against the plain Trainer's,
    by the same rule as against JAX."""
    got, plain = gathered(run), run["plain"]
    want_mu = exp_avg_of(run["plain_state"], run["names"])
    assert set(got["exp_avg"]) == set(want_mu)
    assert_grads_close(got["exp_avg"], want_mu)
    top = max(v.abs().max().item() for v in want_mu.values())
    for name, p in plain.params.items():
        d = (got["params"][name] - p.detach()).abs()
        g = want_mu[name].abs()
        firm = g > 1e-2 * max(g.max().item(), 1e-5 * top)
        atol = 1e-5 if name == "compression.quantize.embedding" else 1e-7
        assert (d[firm] <= atol + 1e-6 * p.detach().abs()[firm]).all(), name
        assert d.max().item() <= 2 * LR * (1 + 1e-3) + 1e-7, name


def check_resume_at_tp1(run) -> None:
    """The gathered file holds whole tensors (the plain model's shapes),
    loads into a tp = 1 Trainer with its moments, and steps there."""
    ckpt, tm = run["ckpt"], copy.deepcopy(run["tm"])
    assert ckpt["step"] == 2 and ckpt["grad_sum"] is None
    for k, v in tm.state_dict().items():
        assert ckpt["model"][k].shape == v.shape, k
    trainer = Trainer(tm, learning_rate=LR, accumulate_grad_batches=2)
    trainer.load(run["ckpt_path"])
    assert trainer.step_count == 2
    for k, p in trainer.params.items():
        assert torch.equal(p.detach(), ckpt["model"][k]), k
    for i, (k, p) in enumerate(trainer.params.items()):
        if i in ckpt["optimizer"]["state"]:
            assert torch.equal(trainer.optimizer.state[p]["exp_avg"],
                               ckpt["optimizer"]["state"][i]["exp_avg"]), k
    logs = trainer.step(t(run["imgs"][0]), noise=run["noise"][0])
    assert all(np.isfinite(n(v)).all() for v in logs.values())


def check_tp1_checkpoint_resumes_sharded(run) -> None:
    """Each rank's sharded trainer took its block of the plain Trainer's
    whole tensors and moments, and the replicated ones whole."""
    state = run["plain_state"]
    mu = exp_avg_of(state, run["names"])
    for rank in run["ranks"]:
        assert rank["resumed_step"] == 2
        for name, p in rank["resumed"].items():
            lo, hi = rank["blocks"].get(name, (None, None))
            assert torch.equal(p, state["model"][name][lo:hi]), name
            if name in mu:
                assert torch.equal(rank["resumed_exp_avg"][name],
                                   mu[name][lo:hi]), name


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp_run(tmp_path_factory, dp=1, tp=2)


def test_trainable_leaves_are_sharded(run):
    sharded = set(run["ranks"][0]["blocks"]) & set(
        trainable_parameters(copy.deepcopy(run["tm"])))
    assert any(".to_q." in k for k in sharded)
    assert any(".emb_proj." in k for k in sharded)


def test_blocks_and_replicated_tensors(run):
    check_blocks_and_replicas(run)


def test_logs_match_jax_and_one_process(run):
    check_logs(run)


def test_step_matches_jax_after_shard_params(run):
    check_step_against_jax(run)


def test_step_matches_one_process(run):
    check_step_against_one_process(run)


def test_gathered_checkpoint_resumes_at_tp1(run):
    check_resume_at_tp1(run)


def test_tp1_checkpoint_resumes_sharded(run):
    check_tp1_checkpoint_resumes_sharded(run)
