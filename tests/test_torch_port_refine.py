"""The refine-phase training slice, rdeic_torch against rdeic_tpu on the CPU
at the micro config: LPIPS (AlexNet and VGG16), the d = 512 plain flash
backward against the Pallas kernels in interpret mode, the VAE decoder's
per-block checkpointing, the sampler's per-step recompute, the refine
`loss_fn` (loss, logs and every trainable gradient against
`jax.value_and_grad`, on the noise of JAX's key sequence), one refine
`Trainer` step against the JAX `Trainer`, the weight loading and the CLI."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.diffusion import spaced as t_spaced
from rdeic_torch.models.lpips import LPIPS, load_lin_weights
from rdeic_torch.models.vae import AutoencoderKL
from rdeic_torch.ops.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
)
from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import (
    Trainer,
    trainable_parameters,
    trainable_predicate,
)
from rdeic_torch.utils.convert import convert_leaf, load_jax_params, load_npz_weights
from rdeic_tpu.models.lpips import LPIPS as JaxLPIPS
from rdeic_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rdeic_tpu.ops.flash_attention import _flash_backward, _flash_forward
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.train import trainer as j_trainer
from rdeic_tpu.utils.checkpoint_io import save_params_npz
from tests.test_torch_port_train_loop import _write_images
from tests.test_torch_port_train_model import (
    GRAD_FLOOR,
    GRAD_REL,
    LOSS_RTOL,
    jax_grads_in_port_layout,
)
from tests.torch_port_helpers import (
    MICRO,
    micro_pair,
    n,
    random_flat_params,
    random_leaf,
    t,
    unflatten,
)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")

LR = 2e-5  # the refine recipe's learning rate


def _img(seed, shape=(2, 64, 64, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _jax_value_and_vjp(fn, x, cotangent):
    """fn(x) and the vjp of `cotangent`, in one jitted program."""
    def both(a, c):
        out, vjp = jax.vjp(fn, a)
        return out, vjp(c)[0]

    return jax.jit(both)(jnp.asarray(x), jnp.asarray(cotangent))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(n(got) - want).max() / np.abs(want).max())


# -- LPIPS ---------------------------------------------------------------------
@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_and_its_input_gradient_match_jax(net):
    """Carried random weights (the published backbones are not in the
    repository); B = 2 at 32x32, the smallest size the AlexNet taps allow.
    fp32 limit 1e-5 of max: the distance is a mean of O(1) terms and its
    gradient a sum over the taps, in other orders."""
    jnet = JaxLPIPS(net=net)
    probe = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda r: jnet.init(r, probe, probe)["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat = {"/".join(k): random_leaf("/".join(k), v.shape, rng)
            for k, v in sorted(flatten_dict(shapes).items())}
    tnet = LPIPS(net)
    tnet.load_state_dict(load_jax_params(flat), strict=True)
    x, y = _img(2, (2, 32, 32, 3)), _img(3, (2, 32, 32, 3))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    dd = np.array([1.0, -0.5], np.float32)  # a cotangent per image
    j_d, j_dx = _jax_value_and_vjp(
        lambda a: jnet.apply({"params": params}, a, y), x, dd)
    xt = t(x).requires_grad_()
    d = tnet(xt, t(y))
    (dx,) = torch.autograd.grad(d, xt, t(dd))
    assert d.shape == (2,)
    np.testing.assert_allclose(n(d), np.asarray(j_d), rtol=1e-5)
    assert _rel(dx, j_dx) <= 1e-5


def test_lpips_loads_published_lin_heads(tmp_path):
    """The lpips package's alex.pth holds only `lin{i}.model.1.weight`; the
    file is not in the repository, so a synthetic one is written."""
    lp = LPIPS("alex")
    heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
             for i, c in enumerate((64, 192, 384, 256, 256))}
    torch.save(heads, tmp_path / "alex.pth")
    backbone = {k: v.clone() for k, v in lp.backbone.state_dict().items()}
    load_lin_weights(lp, tmp_path / "alex.pth")
    for i in range(5):
        assert torch.equal(getattr(lp, f"lin{i}").weight,
                           heads[f"lin{i}.model.1.weight"])
    for k, v in lp.backbone.state_dict().items():
        assert torch.equal(v, backbone[k])
    heads["lin4.model.1.weight"] = torch.rand(1, 512, 1, 1)  # a vgg head
    torch.save(heads, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="lin4"):
        load_lin_weights(lp, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="alex"):
        LPIPS("squeeze")


# -- flash backward at d = 512 ------------------------------------------------
def test_flash_backward_plain_d512_matches_pallas_interpret():
    """The VAE decoder's head dim at a ragged L (72 = 2 blocks of 32 + 8):
    the Pallas kernels mask the padded rows and columns. Limits as at d = 16
    and 64 (tests/test_torch_port_train_ops.py)."""
    shape = (1, 72, 1, 512)
    q, k, v, do = (np.random.default_rng(s).normal(size=shape).astype(np.float32)
                   for s in range(4))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    j_out, j_lse = _flash_forward(jq, jk, jv, block_q=32, block_k=32,
                                  interpret=True, save_residuals=True)
    j_grads = _flash_backward(jq, jk, jv, j_out, j_lse, jdo, block_q=32,
                              block_k=32, interpret=True)
    o, lse = flash_attention_lse_plain(t(q), t(k), t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-5)
    grads = flash_attention_bwd_plain(t(q), t(k), t(v), o, lse, t(do))
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


# -- the micro models ----------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return micro_pair(seed=0)


def refine_pair(seed=0):
    """(jax model, jax params, torch model, flat params) of the micro config
    with is_refine: the LPIPS subtree too. The codebook usage is set as
    micro_train_pair sets it (a random negative usage overflows the
    codebook update in both frameworks)."""
    cfg = dict(copy.deepcopy(MICRO), is_refine=True)
    jm = JaxRDEIC(**copy.deepcopy(cfg))
    flat = random_flat_params(jm, (64, 64), seed)
    k = flat["vq_embed_prob"].shape[0]
    flat["vq_embed_prob"] = np.where(np.arange(k) % 2, 1.0 / k, 0.0).astype(np.float32)
    tm = TorchRDEIC(**cfg, device="cpu")
    tm.load_state_dict(load_jax_params(flat), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, unflatten(flat)), tm, flat


@pytest.fixture(scope="module")
def jax_decode(pair):
    """(z, dy, the JAX decoder's image and its vjp of dy at z)."""
    jm, params, _ = pair
    z = np.random.default_rng(5).normal(size=(2, 32, 32, 4)).astype(np.float32)
    dy = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return (z, dy, *_jax_value_and_vjp(lambda a: jm.vae.apply(
        {"params": params["vae"]}, a, method=JaxAutoencoderKL.decode), z, dy))


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_vae_decoder_with_and_without_checkpoint_matches_jax(
        pair, jax_decode, use_checkpoint):
    """The decoder's output and the gradient at its input latent, with the
    per-block recompute on and off, against the JAX decode's vjp. fp32
    limits 2e-4 (module parity) on the image and 1e-5 of max on the
    gradient."""
    _, _, tm = pair
    z, dy, j_img, j_dz = jax_decode
    vae = AutoencoderKL(embed_dim=4, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                        use_checkpoint=use_checkpoint)
    vae.load_state_dict(tm.vae.state_dict())
    zt = t(z).requires_grad_()
    img = vae.decode(zt)
    (dz,) = torch.autograd.grad(img, zt, t(dy))
    np.testing.assert_allclose(n(img), np.asarray(j_img), atol=2e-4)
    assert _rel(dz, j_dz) <= 1e-5
    ref = tm.vae.decode(zt)  # the same weights without the recompute
    torch.testing.assert_close(img, ref, rtol=0, atol=0)
    torch.testing.assert_close(dz, torch.autograd.grad(ref, zt, t(dy))[0],
                               rtol=1e-6, atol=1e-7)


def test_sampler_remat_steps_gives_the_same_loss_and_gradients(pair):
    """spaced.sample with each step recomputed in the backward, nested in
    the denoiser's own per-block checkpoints: the same loss and gradients
    (the counterpart of tests/test_refine_training.py's scan_remat test)."""
    _, _, tm = pair
    cfg = copy.deepcopy(MICRO)
    cfg["control_stage_config"]["params"]["use_checkpoint"] = True
    tc = TorchRDEIC(**cfg, device="cpu")
    tc.load_state_dict(tm.state_dict())
    params = {k: p for k, p in trainable_parameters(tc).items()
              if k.startswith("denoiser.")}  # the control branch and bridges
    rng = np.random.default_rng(7)
    x_T, hint, *steps = (t(rng.normal(size=s).astype(np.float32))
                         for s in ((2, 32, 32, 4), (2, 32, 32, 8),
                                   (2, 32, 32, 4), (2, 32, 32, 4)))
    ctx = tc.get_learned_conditioning(2)
    coeffs = t_spaced.make_spaced_coefficients(tc.schedule, 300, 2)
    runs = []
    for remat in (False, True):
        x = t_spaced.sample(lambda x, tt: tc.denoiser(x, tt, ctx, hint),
                            x_T, coeffs, noise=steps, remat_steps=remat)
        loss = (x ** 2).mean()
        runs.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert runs[0][0].item() == runs[1][0].item()
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# -- the refine loss -----------------------------------------------------------
def jax_refine_noise(tm: TorchRDEIC, img: np.ndarray, rng) -> dict:
    """The draws of rdeic_tpu's refine `loss_fn(params, img, rng)`, in the
    port's `train_noise` layout: rng -> (in, t, loss); in -> (posterior,
    compression: one split per slice); loss -> (relay noise, sampler); the
    sampler splits once per step (diffusion/spaced.py)."""
    shapes = tm.train_noise(torch.zeros(img.shape))
    rng_in, _, rng_loss = jax.random.split(rng, 3)
    rng_z, rng_like = jax.random.split(rng_in)
    uniform = []
    for u in shapes["uniform"]:
        rng_like, sub = jax.random.split(rng_like)
        uniform.append(t(jax.random.uniform(sub, tuple(u.shape), jnp.float32,
                                            -0.5, 0.5)))
    rng_noise, rng_sample = jax.random.split(rng_loss)
    c_shape = tuple(shapes["relay"].shape)
    steps = []
    for _ in shapes["steps"]:
        rng_sample, key = jax.random.split(rng_sample)
        steps.append(t(jax.random.normal(key, c_shape, jnp.float32)))
    return dict(
        posterior=t(jax.random.normal(rng_z, tuple(shapes["posterior"].shape),
                                      jnp.float32)),
        uniform=uniform,
        relay=t(jax.random.normal(rng_noise, c_shape, jnp.float32)),
        steps=steps)


@pytest.fixture(scope="module")
def refine_run():
    """One refine micro-step from the same weights, image and noise on both
    sides. JAX: one `Trainer.step` (accumulation 1, the refine recipe's lr),
    which is `jax.value_and_grad` of `jm.loss_fn` followed by AdamW and the
    codebook update in one compiled program; after one step AdamW's first
    moment is 0.1 x that gradient. (A second compiled program, of
    value_and_grad alone, would cost another ~30 s here.) Port: `loss_fn`
    and its gradients, the same with the image nudged by +-1e-6 (see
    assert_refine_grads_close), then `Trainer.step`."""
    jm, params, tm, flat = refine_pair(seed=0)
    img = _img(4)
    jt = j_trainer.Trainer(jm, learning_rate=LR, accumulate_grad_batches=1)
    state = jt.init_state(params, jax.random.PRNGKey(3))
    _, step_rng = jax.random.split(jax.random.PRNGKey(3))  # as the JAX step
    noise = jax_refine_noise(tm, img, step_rng)
    params_t = trainable_parameters(tm)

    def port_grads(x):
        loss, logs = tm.loss_fn(t(x), noise=noise)
        grads = torch.autograd.grad(loss, list(params_t.values()))
        return loss, logs, dict(zip(params_t, grads))

    loss, logs, grads = port_grads(img)
    moves = dict.fromkeys(grads, 0.0)
    for eps in (1e-6, -1e-6):
        for k, g in port_grads(img * (1 + eps))[2].items():
            moves[k] = max(moves[k], _rel(g, n(grads[k])))
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    state, j_logs = jt.step(state, jnp.asarray(img))
    tt = Trainer(tm, learning_rate=LR)
    step_logs = tt.step(t(img), noise=noise)
    return dict(loss=loss.item(), logs=logs, grads=grads, moves=moves,
                state=jax.device_get(state), j_logs=jax.device_get(j_logs),
                step_logs=step_logs, tt=tt, tm=tm, before=before, flat=flat)


def assert_refine_grads_close(got: dict, want: dict, moves: dict) -> None:
    """Each tensor within GRAD_REL (1e-4) of its max, as in the independent
    phase; or, where a +-1e-6 nudge of the image alone moves the port's
    gradient of that tensor further, within twice that move. Such a tensor
    sits behind an activation at LeakyReLU's kink (the compression model's
    synthesis side): an input that lands within rounding of 0 takes one
    slope in one framework and the other in the other. With another draw
    (seed 1, image 11) compression.decoder.ResidualBlock_4.conv1's bias read
    1.19e-4, and the nudge moved it by 1.19e-4 in the port alone."""
    floor = GRAD_FLOOR * max(np.abs(want[k].numpy()).max() for k in got)
    for name, g in got.items():
        w = want[name].numpy()
        err = np.abs(n(g) - w).max() / max(np.abs(w).max(), floor)
        limit = max(GRAD_REL, 2 * moves[name])
        assert err <= limit, f"{name}: max|diff|/max|g| {err:.3g} > {limit:.3g}"


def _jax_grads(r) -> dict:
    """The JAX step's gradients: AdamW's first moment after one step / 0.1."""
    mu = jax_grads_in_port_layout(r["state"].opt_state[0].mu)  # no MultiSteps
    return {k: v / np.float32(0.1) for k, v in mu.items()}


def test_refine_loss_and_logs_match_jax(refine_run):
    r = refine_run
    j_logs = {k: v for k, v in r["j_logs"].items() if k != "grad_norm"}
    assert set(j_logs) == {"l_simple", "l_mse", "l_lpips", "l_guide", "l_bpp",
                           "q_bpp", "l_emb", "loss"}
    assert set(r["logs"]) == set(j_logs) | {"_z_hyper"}
    np.testing.assert_allclose(r["loss"], float(j_logs["loss"]), rtol=LOSS_RTOL)
    for key, want in j_logs.items():
        np.testing.assert_allclose(n(r["logs"][key]), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=key)


def test_every_refine_gradient_matches_jax(refine_run):
    """The gradient reaches the compression model and the control branch
    through both sampler steps, the VAE decoder and LPIPS; the base UNet,
    the VAE and LPIPS stay frozen (no gradient is computed for them)."""
    want = _jax_grads(refine_run)
    got = refine_run["grads"]
    assert any(k.startswith("compression.") for k in got)
    assert any(k.startswith("denoiser.control.") for k in got)
    assert not any(k.startswith(("denoiser.base.", "vae.", "lpips."))
                   for k in got)
    assert set(got) == set(want)
    assert_refine_grads_close(got, want, refine_run["moves"])


def test_refine_noise_draws_have_the_loss_fns_shapes(refine_run):
    tm = refine_run["tm"]
    img = t(_img(5, (1, 64, 128, 3)))
    noise = tm.train_noise(img, torch.Generator().manual_seed(0))
    assert set(noise) == {"posterior", "uniform", "relay", "steps"}
    assert noise["relay"].shape == noise["posterior"].shape == (1, 32, 64, 4)
    assert [tuple(s.shape) for s in noise["steps"]] == [(1, 32, 64, 4)] * 2
    loss, logs = tm.loss_fn(img, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and logs["l_lpips"].ndim == 0


def test_refine_trainer_step_matches_jax(refine_run):
    """The step's logs (grad_norm too) within 1e-5; AdamW's first moment
    held as the gradients are; the stepped parameters where the gradient is
    well above rounding and far above AdamW's eps of 1e-8 (there the first
    update, lr * g / (|g| + 1e-8), is lr * sign(g) on both sides), and
    within 2 lr elsewhere (see test_torch_port_train_loop)."""
    r = refine_run
    assert set(r["step_logs"]) == set(r["j_logs"])
    for key, want in r["j_logs"].items():
        np.testing.assert_allclose(n(r["step_logs"][key]), np.asarray(want),
                                   rtol=1e-5, err_msg=key)
    tt, state = r["tt"], r["state"]
    j_mu = jax_grads_in_port_layout(state.opt_state[0].mu)
    mu = {name: tt.optimizer.state[p]["exp_avg"] for name, p in tt.params.items()}
    assert_refine_grads_close(mu, j_mu, r["moves"])
    j_params = {convert_leaf("/".join(k), np.asarray(v))[0]:
                convert_leaf("/".join(k), np.asarray(v))[1].numpy()
                for k, v in flatten_dict(state.train_params).items()}
    for name, p in tt.params.items():
        got, want = n(p), j_params[name]
        g = np.abs(j_mu[name].numpy()) / 0.1
        firm = (g > 1e-2 * g.max()) & (g > 1e-6)
        atol = 1e-5 if name == "compression.quantize.embedding" else 1e-7
        np.testing.assert_allclose(got[firm], want[firm], rtol=1e-6, atol=atol,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-3) + 1e-7, name


def test_refine_step_keeps_lpips_vae_and_base_frozen(refine_run):
    tm, before = refine_run["tm"], refine_run["before"]
    assert not any(p.requires_grad for p in tm.lpips.parameters())
    assert not trainable_predicate(True)(("lpips", "lin0", "weight"))
    assert not any(k.startswith("lpips.") for k in refine_run["tt"].params)
    for name, v in tm.state_dict().items():
        if name.startswith(("lpips.", "vae.", "denoiser.base.", "uncond_context")):
            assert torch.equal(v, before[name]), name


# -- weights and the CLI ---------------------------------------------------------
def test_load_npz_weights_on_a_refine_model(tmp_path, refine_run):
    """A refine export carries LPIPS: loaded strictly. An independent-phase
    export has none: the refine model keeps its own, as the JAX warm start
    does; an independent model skips a file's LPIPS subtree."""
    flat = refine_run["flat"]
    save_params_npz(tmp_path / "refine.npz", unflatten(flat))
    fresh = TorchRDEIC(**copy.deepcopy(MICRO), is_refine=True, device="cpu")
    assert load_npz_weights(fresh, tmp_path / "refine.npz") == []
    for k, v in refine_run["before"].items():
        assert torch.equal(fresh.state_dict()[k], v), k
    phase1 = {k: v for k, v in flat.items() if not k.startswith("lpips/")}
    save_params_npz(tmp_path / "phase1.npz", unflatten(phase1))
    other = TorchRDEIC(**copy.deepcopy(MICRO), is_refine=True, device="cpu")
    own = {k: v.clone() for k, v in other.lpips.state_dict().items()}
    assert load_npz_weights(other, tmp_path / "phase1.npz") == ["lpips"]
    for k, v in other.lpips.state_dict().items():
        assert torch.equal(v, own[k])
    indep = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    assert not hasattr(indep, "lpips")
    assert load_npz_weights(indep, tmp_path / "refine.npz") == []


def test_cli_runs_one_refine_step_on_cpu(tmp_path, capsys):
    yaml = pytest.importorskip("yaml")
    lst = _write_images(tmp_path)
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(lst), "out_size": 64}},
        "data_loader": {"batch_size": 2, "shuffle": True, "drop_last": True}}))
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    run = tmp_path / "run"
    (tmp_path / "train.yaml").write_text(yaml.safe_dump({
        "data": {"target": "rdeic_tpu.data.dataset.DataModule",
                 "params": {"train_config": str(tmp_path / "data.yaml"),
                            "val_config": None}},
        "model": {"config": str(tmp_path / "model.yaml"),
                  "overrides": {"is_refine": True}},
        "trainer": {"seed": 1, "accumulate_grad_batches": 1,
                    "learning_rate": LR, "log_every_n_steps": 1,
                    "ckpt_every_n_steps": 10, "out_dir": str(run)}}))
    assert t_cli.main(["--config", str(tmp_path / "train.yaml"),
                       "--max_steps", "1", "--device", "cpu"]) == 0
    assert "refine phase" in capsys.readouterr().out
    (row,) = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().split("\n") if line]
    assert row["step"] == 1 and np.isfinite(row["loss"]) and row["grad_norm"] > 0
    assert {"l_mse", "l_lpips"} <= set(row)
    state = torch.load(run / "checkpoints" / "step_1.pt", weights_only=True)
    assert any(k.startswith("lpips.") for k in state["model"])
