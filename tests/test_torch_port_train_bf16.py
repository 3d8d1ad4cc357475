"""bf16 training, rdeic_torch against rdeic_tpu on the CPU at the micro
config: one independent-phase micro-step with `set_compute_dtype(bf16)` and
`Trainer(frozen_dtype=bf16)` on both sides (the JAX `Trainer` after
`set_compute_dtype(jnp.bfloat16)`), the train state across dtypes, the
`ckpt_keep` pruning. The refine phase's bf16 step is in
test_torch_port_refine_bf16.py, the CLI on the repo's bf16 recipes in
test_torch_port_train_bf16_cli.py. Each test runs on one torch thread
(`one_torch_thread`): beside the other test workers, the many small bf16
CPU ops of a micro-step took minutes instead of seconds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.inference import load_model
from rdeic_torch.train.trainer import (
    Trainer,
    list_checkpoints,
    prune_checkpoints,
    trainable_predicate,
)
from rdeic_torch.utils.convert import convert_leaf
from rdeic_tpu.train import trainer as j_trainer
from tests.test_torch_port_train_loop import _img, micro_train_pair
from tests.test_torch_port_train_model import jax_grads_in_port_layout, jax_train_noise
from tests.torch_port_helpers import MICRO, micro_pair, n, t
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")

LR = 2e-5  # the bf16 recipes' learning rate
BF16 = torch.bfloat16
# bf16 tolerances. Each bf16 run rounds every layer's output to 8
# significant bits, and the port's and XLA's round at other places (XLA
# also keeps excess precision inside its fusions), so the two bf16 steps
# land about as far from each other as each from the fp32 step. Readings at
# the micro config (seed 0): logs within 1.1e-2 of JAX's (grad_norm; the
# loss terms 9e-4 independent, 3.2e-3 refine), held to 2^-6, which a x1.05
# fault reads outside of. The trainable gradients, as AdamW's first
# moment, three ways:
# - by relative L2 over each group of tensors (denoiser, synthesis, rate):
#   port vs JAX 3.4e-2 / 1.9e-2 / 1.7e-2 independent and 4.5e-2 / 1.3e-2 /
#   1.4e-2 refine, where the port's own bf16 step reads 3.6e-2 / 1.8e-2 /
#   1.5e-2 and 4.5e-2 / 1.3e-2 / 1.3e-2 from its fp32 step: held to 2^-4;
# - by the ratio of each group's norms, |ratio - 1| (a scale error, which
#   the L2 limit is too wide to see): at most 1.3e-2 independent and
#   8.6e-3 refine, held to 2^-5, which a x1.05 fault reads outside of
#   (>= 4.8e-2);
# - by direction, 1 - cosine of each tensor whose largest gradient is over
#   1e-2 of the largest of all (76 of 275 tensors; below it the bf16 noise
#   swamps the gradient): at most 1.6e-3 independent and 1.7e-3 refine,
#   held to 2^-8, which a layout fault (the tensor's first axis rolled by
#   one place) reads outside of in every such tensor.
# No limit on the distance to JAX's bf16 step tells the port's bf16 step
# from its fp32 one: from the same weights and noise the fp32 step reads
# 2.8e-2 / 1.2e-2 / 1.2e-2 and 3.7e-2 / 1.4e-2 / 1.6e-2 by group, |ratio -
# 1| <= 7.6e-3 and 1 - cosine <= 1.9e-3, inside every limit above (the two
# bf16 runs round at other places, so each lands as far from the other as
# from fp32). The distance from the port's own fp32 step tells an
# all-fp32 step apart: the bf16 step must keep at least 2^-8 by group
# (OFF_FP32; it reads 3.6e-2 / 1.8e-2 / 1.5e-2), where an fp32 step reads
# 0 (test_bf16_step_lies_off_the_fp32_step). A step computing in fp32 on
# the bf16-stored frozen weights reads 2.1e-2 / 8.7e-3 / 1.1e-2 there (and
# 2.2e-2 / 9.0e-3 / 1.0e-2 from JAX): no gradient limit tells it from the
# bf16 step, so the layers' compute dtypes
# (test_bf16_step_keeps_the_recipe_dtypes) and test_torch_port_bf16_bits.py
# hold that and where the step rounds.
# The codebook after its update mixes in hyper-latent rows made from the
# bf16 VAE encoder's feature: held to 2^-6 of its max.
LOG_TOL = 2.0 ** -6
GRAD_TOL = 2.0 ** -4
NORM_TOL = 2.0 ** -5
COS_TOL = 2.0 ** -8
FIRM = 1e-2  # a tensor's share of the largest gradient that the cosine reads
OFF_FP32 = 2.0 ** -8
CODEBOOK_TOL = 2.0 ** -6
FAULT_SCALE = 1.05
EMB = "compression.quantize.embedding"
SYNTHESIS = ("compression.decoder.", "compression.out.")


def grad_group(name: str) -> str:
    if name.startswith("denoiser."):
        return "denoiser"
    return "synthesis" if name.startswith(SYNTHESIS) else "rate"


def rel_l2(got: dict, want: dict, names) -> float:
    diff = sum(float(((n(got[k]) - n(want[k])) ** 2).sum()) for k in names)
    return (diff / sum(float((n(want[k]) ** 2).sum()) for k in names)) ** 0.5


def norm_ratio(got: dict, want: dict, names) -> float:
    """|norm of got / norm of want - 1| over the tensors `names` together."""
    a, b = (sum(float((n(d[k]).astype(np.float64) ** 2).sum()) for k in names)
            for d in (got, want))
    return abs((a / b) ** 0.5 - 1)


def one_minus_cos(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = (n(x).ravel().astype(np.float64) for x in (got, want))
    return float(1 - g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))


def bf16_step(jm, params, tm, img, noise_fn):
    """One micro-step (accumulation 1, lr LR) in bf16 on both sides from
    the same weights, image and noise: (JAX state, JAX logs, port trainer,
    port logs, the port's state before the step)."""
    jm.set_compute_dtype(jnp.bfloat16)
    jt = j_trainer.Trainer(jm, learning_rate=LR, frozen_dtype=jnp.bfloat16)
    state = jt.init_state(params, jax.random.PRNGKey(3))
    _, step_rng = jax.random.split(jax.random.PRNGKey(3))  # as the JAX step
    noise = noise_fn(tm, img, step_rng)
    state, j_logs = jt.step(state, jnp.asarray(img))
    tm.set_compute_dtype(BF16, cast_weights=False)
    tt = Trainer(tm, learning_rate=LR, frozen_dtype=BF16)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    logs = tt.step(t(img), noise=noise)
    return dict(state=jax.device_get(state), j_logs=jax.device_get(j_logs),
                tt=tt, logs=logs, before=before, tm=tm, noise=noise)


def check_bf16_step(r) -> dict:
    """The checks of a bf16 step against JAX's (see the module's limits);
    returns the readings."""
    tt, tm, state = r["tt"], r["tm"], r["state"]
    reads = {}
    assert set(r["logs"]) == set(r["j_logs"])
    for key, want in r["j_logs"].items():
        got, want = float(r["logs"][key]), float(want)
        reads[key] = abs(got - want) / abs(want)
        assert reads[key] <= LOG_TOL < abs(got * FAULT_SCALE - want) / abs(want), key
    # the gradients: AdamW's first moment after one step is 0.1 x them
    j_mu = jax_grads_in_port_layout(state.opt_state[0].mu)
    mu = {k: tt.optimizer.state[p]["exp_avg"] for k, p in tt.params.items()}
    assert set(mu) == set(j_mu)
    faulty = {k: v * FAULT_SCALE for k, v in mu.items()}
    for group in ("denoiser", "synthesis", "rate"):
        names = [k for k in mu if grad_group(k) == group]
        reads[group] = rel_l2(mu, j_mu, names)
        assert reads[group] <= GRAD_TOL, (group, reads[group])
        reads[f"{group} norm"] = norm_ratio(mu, j_mu, names)
        fault = norm_ratio(faulty, j_mu, names)
        assert reads[f"{group} norm"] <= NORM_TOL < fault, (group, reads, fault)
    gmax = max(np.abs(v.numpy()).max() for v in j_mu.values())
    firm = [k for k, v in j_mu.items() if np.abs(v.numpy()).max() > FIRM * gmax]
    cos = {k: one_minus_cos(mu[k], j_mu[k]) for k in firm}
    reads["direction"] = max(cos.values())
    for k in firm:
        fault = one_minus_cos(torch.roll(mu[k], 1, 0), j_mu[k])
        assert cos[k] <= COS_TOL < fault, (k, cos[k], fault)
    # the updated trainable weights: fp32; the first AdamW update is
    # lr * g / (|g| + 1e-8), lr * sign(g) where |g| is well above the bf16
    # noise (1e-2 of the largest gradient and 1e-1 of the tensor's own), so
    # there the two sides move alike; elsewhere by at most 2 lr
    j_params = {convert_leaf("/".join(k), np.asarray(v))[0]:
                convert_leaf("/".join(k), np.asarray(v))[1].numpy()
                for k, v in flatten_dict(state.train_params).items()}
    for name, p in tt.params.items():
        assert p.dtype == torch.float32 and p.grad is None, name
        got, want = n(p), j_params[name]
        if name == EMB:
            reads["codebook"] = np.abs(got - want).max() / np.abs(want).max()
            assert reads["codebook"] <= CODEBOOK_TOL
            continue
        g = np.abs(j_mu[name].numpy())
        firm = (g > 1e-1 * g.max()) & (g > 1e-2 * gmax)
        np.testing.assert_allclose(got[firm], want[firm], rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-3) + 1e-7, name
    # the frozen tensors: bf16, bit-equal after the step and to JAX's cast
    j_frozen = flatten_dict(state.frozen_params)
    pred = trainable_predicate(tm.sd_locked)
    now = tm.state_dict()
    for key, v in j_frozen.items():
        name, want = convert_leaf("/".join(key), np.asarray(v, np.float32))
        if name == "vq_embed_prob":
            assert now[name].dtype == torch.float32 and v.dtype == jnp.float32
            continue
        assert now[name].dtype == BF16 and v.dtype == jnp.bfloat16, name
        assert not pred(tuple(name.split("."))), name
        assert torch.equal(now[name], r["before"][name]), name
        assert torch.equal(now[name].float(), want), name
    return reads


@pytest.fixture(scope="module")
def independent_run():
    jm, params, tm = micro_train_pair(seed=0)
    return bf16_step(jm, params, tm, _img(11), jax_train_noise)


def test_bf16_independent_step_matches_jax(independent_run):
    reads = check_bf16_step(independent_run)
    assert reads["loss"] > 0  # bf16 really ran on one side or the other


def test_bf16_step_keeps_the_recipe_dtypes(independent_run):
    """Frozen weights bf16 (the base UNet, the VAE, the context), the
    trainable weights, their AdamW moments and the codebook usage fp32; the
    denoiser's layers compute in bf16, the compression model in fp32."""
    tm, tt = independent_run["tm"], independent_run["tt"]
    state = tm.state_dict()
    assert state["uncond_context"].dtype == BF16
    assert state["vq_embed_prob"].dtype == torch.float32
    assert all(state[k].dtype == BF16 for k in state
               if k.startswith(("vae.", "denoiser.base.")))
    for p in tt.params.values():
        st = tt.optimizer.state[p]
        assert p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert tm.denoiser.control.time_embed.fc1.compute_dtype == BF16
    assert tm.vae.decoder.conv_in.Conv_0.compute_dtype == BF16
    assert tm.compression.out.Conv_0.compute_dtype == torch.float32


def test_bf16_step_lies_off_the_fp32_step(independent_run):
    """The bf16 step's gradients keep at least OFF_FP32 by group from an
    fp32 step of the port from the same weights, image and noise; the fp32
    step, against itself, reads 0. Its distance to JAX's bf16 step (in the
    message) is within the module's limits, as the bf16 step's is."""
    _, _, tm = micro_train_pair(seed=0)
    tt = Trainer(tm, learning_rate=LR)
    tt.step(t(_img(11)), noise=independent_run["noise"])
    fp32 = {k: tt.optimizer.state[p]["exp_avg"] for k, p in tt.params.items()}
    bf16 = independent_run["tt"]
    mu = {k: bf16.optimizer.state[p]["exp_avg"] for k, p in bf16.params.items()}
    j_mu = jax_grads_in_port_layout(independent_run["state"].opt_state[0].mu)
    for group in ("denoiser", "synthesis", "rate"):
        names = [k for k in mu if grad_group(k) == group]
        off, to_jax = rel_l2(mu, fp32, names), rel_l2(fp32, j_mu, names)
        assert rel_l2(fp32, fp32, names) < OFF_FP32 <= off, (group, off, to_jax)


# -- the train state across dtypes ------------------------------------------------
def _train(tm, frozen_dtype, path):
    """One micro-step with its AdamW update, saved to `path`."""
    tt = Trainer(tm, frozen_dtype=frozen_dtype)
    tt.step(t(_img(20, (1, 64, 64, 3))), generator=torch.Generator().manual_seed(0))
    tt.save(path)
    return tt


@pytest.mark.parametrize("saved,resumed", [(BF16, BF16), (None, BF16), (BF16, None)])
def test_train_state_resumes_across_dtypes(tmp_path, saved, resumed):
    """A bf16-frozen `step_N.pt` resumes into a bf16-frozen trainer bit for
    bit; an fp32 one into a bf16-frozen trainer (the frozen tensors
    rounded to bf16, the rest bit for bit); a bf16 one into an fp32 trainer
    (the frozen tensors upcast)."""
    _, _, tm = micro_train_pair(seed=2)
    if saved is not None:
        tm.set_compute_dtype(BF16, cast_weights=False)
    tt = _train(tm, saved, tmp_path / "step_1.pt")
    _, _, fresh = micro_pair(seed=3)
    other = Trainer(fresh, frozen_dtype=resumed)
    other.load(tmp_path)
    assert other.step_count == 1
    pred = trainable_predicate(True)
    for k, v in tm.state_dict().items():
        got = fresh.state_dict()[k]
        frozen = k != "vq_embed_prob" and not pred(tuple(k.split(".")))
        assert got.dtype == (resumed if frozen and resumed else torch.float32), k
        assert torch.equal(got, v.to(got.dtype)), k
    for name, p in tt.params.items():  # AdamW's moments: fp32, as saved
        for key in ("exp_avg", "exp_avg_sq"):
            a = tt.optimizer.state[p][key]
            b = other.optimizer.state[other.params[name]][key]
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


def test_bf16_train_state_serves_on_an_fp32_model(tmp_path):
    """`inference.load_model` on a bf16-trained `step_N.pt`: an fp32 model
    whose frozen weights are the bf16 values upcast."""
    _, _, tm = micro_train_pair(seed=2)
    tm.set_compute_dtype(BF16, cast_weights=False)
    _train(tm, BF16, tmp_path / "checkpoints" / "step_1.pt")
    yaml = pytest.importorskip("yaml")
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    model = load_model(str(tmp_path / "model.yaml"),
                       str(tmp_path / "checkpoints"), torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, tm.state_dict()[k].float()), k
    assert model.denoiser.base.out_conv.compute_dtype == torch.float32


@pytest.mark.parametrize("keep,left", [(2, [4, 5]), (1, [5]), (-1, [1, 2, 3, 4, 5])])
def test_ckpt_keep_prunes_all_but_the_newest(tmp_path, keep, left):
    for step in (1, 2, 3, 4, 5):
        (tmp_path / f"step_{step}.pt").write_bytes(b"")
    (tmp_path / "metrics.jsonl").write_text("")
    gone = prune_checkpoints(tmp_path, keep)
    assert list_checkpoints(tmp_path) == left
    assert sorted(gone + left) == [1, 2, 3, 4, 5]
    assert (tmp_path / "metrics.jsonl").exists()
