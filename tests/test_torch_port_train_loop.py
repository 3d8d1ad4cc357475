"""The training loop, rdeic_torch against rdeic_tpu on the CPU at the micro
config: two `Trainer` steps with gradient accumulation against the JAX
`Trainer` (optax.adamw under MultiSteps, the CVQ codebook update on every
call), the trainable predicate, the train state's save and load, the data
pipeline, and `python -m rdeic_torch.train` for two steps."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from rdeic_torch import inference as t_inference
from rdeic_torch.data.dataset import DataModule, LICDataset
from rdeic_torch.inference import process
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import Trainer, trainable_predicate
from rdeic_torch.utils import image as t_image
from rdeic_torch.utils.convert import convert_leaf
from rdeic_tpu.train import trainer as j_trainer
from rdeic_tpu.utils import image as j_image
from tests.test_torch_port_train_model import (
    GRAD_FLOOR,
    assert_grads_close,
    jax_grads_in_port_layout,
    jax_train_noise,
)
from tests.torch_port_helpers import MICRO, micro_pair, n, t

LR = 2e-5  # the micro model's learning_rate (RDEIC's default)


def _img(seed, shape=(2, 64, 64, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def micro_train_pair(seed):
    """micro_pair with a code-usage EMA a run can have: half the codes never
    used (the update re-seeds them from the batch), half used evenly. A
    random-normal usage would be negative in places, which makes the update's
    exp() overflow to inf and the codebook NaN, in both frameworks."""
    jm, params, tm = micro_pair(seed=seed)
    k = tm.compression.codebook_size
    usage = np.where(np.arange(k) % 2, 1.0 / k, 0.0).astype(np.float32)
    params = dict(params, vq_embed_prob=jnp.asarray(usage))
    with torch.no_grad():
        tm.vq_embed_prob.copy_(t(usage))
    return jm, params, tm


@pytest.fixture(scope="module")
def two_steps():
    """Two micro-steps at accumulate_grad_batches=2 on both sides: the first
    only accumulates, the second applies AdamW to the mean gradient; both
    update the codebook."""
    jm, params, tm = micro_train_pair(seed=0)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    imgs = [_img(11), _img(12)]
    jt = j_trainer.Trainer(jm, accumulate_grad_batches=2)
    state = jt.init_state(params, jax.random.PRNGKey(3))
    tt = Trainer(tm, accumulate_grad_batches=2)
    rng = jax.random.PRNGKey(3)
    out = dict(j_logs=[], logs=[], j_codebook=[], codebook=[])
    for img in imgs:
        rng, step_rng = jax.random.split(rng)  # as the JAX step splits state.rng
        noise = jax_train_noise(tm, img, step_rng)
        state, logs = jt.step(state, jnp.asarray(img))
        out["j_logs"].append(jax.device_get(logs))
        out["j_codebook"].append(jax.device_get(
            (state.train_params["compression"]["quantize"]["embedding"],
             state.frozen_params["vq_embed_prob"])))
        out["logs"].append(tt.step(t(img), noise=noise))
        out["codebook"].append((n(tm.compression.quantize.embedding).copy(),
                                n(tm.vq_embed_prob).copy()))
        if len(out["logs"]) == 1:
            out["after_first"] = {k: v.detach().clone()
                                  for k, v in tm.state_dict().items()}
    out.update(jm=jm, state=jax.device_get(state), tm=tm, tt=tt, before=before)
    return out


def test_step_logs_match_jax(two_steps):
    for logs, j_logs in zip(two_steps["logs"], two_steps["j_logs"]):
        assert set(logs) == set(j_logs)
        for key, want in j_logs.items():
            np.testing.assert_allclose(n(logs[key]), np.asarray(want),
                                       rtol=1e-5, err_msg=key)


def test_codebook_updates_on_every_call_like_jax(two_steps):
    """Call 1 emits no optimizer update (MultiSteps), but the codebook and
    its usage EMA move on both calls."""
    first = two_steps["after_first"]
    before = two_steps["before"]
    emb = "compression.quantize.embedding"
    assert not torch.equal(first[emb], before[emb])
    assert not torch.equal(first["vq_embed_prob"], before["vq_embed_prob"])
    for name, v in first.items():
        if name not in (emb, "vq_embed_prob"):
            assert torch.equal(v, before[name]), name
    for (e, p), (je, jp) in zip(two_steps["codebook"], two_steps["j_codebook"]):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-6, atol=1e-9)
        # the codebook after the step: the same bound as the parameters below
        np.testing.assert_allclose(e, np.asarray(je), atol=2 * LR + 1e-6)


def test_mean_gradient_and_step_match_jax(two_steps):
    """AdamW's first moment after the one update is 0.1 x the mean of the two
    micro-batch gradients on both sides: those are compared as gradients.
    The stepped parameters are compared where the mean gradient is well
    above rounding (|g| > 1e-2 of the scale the gradients are held to, which
    they match to 1e-4 of): the first AdamW update is lr * g / (|g| + 1e-8),
    so there both sides move by the same lr * sign(g); elsewhere a gradient
    at rounding level may flip sign between the frameworks, and the
    parameters may differ by up to 2 * lr."""
    tt, state = two_steps["tt"], two_steps["state"]
    j_mu = jax_grads_in_port_layout(state.opt_state.inner_opt_state[0].mu)
    mu = {name: tt.optimizer.state[p]["exp_avg"] for name, p in tt.params.items()}
    assert_grads_close(mu, j_mu)
    j_params = {convert_leaf("/".join(k), np.asarray(v))[0]:
                convert_leaf("/".join(k), np.asarray(v))[1].numpy()
                for k, v in flatten_dict(state.train_params).items()}
    floor = GRAD_FLOOR * max(np.abs(v.numpy()).max() for v in j_mu.values())
    for name, p in tt.params.items():
        got, want, g = n(p), j_params[name], np.abs(j_mu[name].numpy())
        firm = g > 1e-2 * max(g.max(), floor)
        # the codebook update after the step mixes in hyper-latent rows, on
        # which the two frameworks agree to 1e-5 (the compression forward)
        atol = 1e-5 if name == "compression.quantize.embedding" else 1e-7
        np.testing.assert_allclose(got[firm], want[firm], rtol=1e-6, atol=atol,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-3) + 1e-7, name


def test_frozen_weights_stay_bit_equal(two_steps):
    """The base UNet, the VAE and uncond_context, under sd_locked: no
    gradient is computed for them and they never move."""
    tm, before = two_steps["tm"], two_steps["before"]
    params = dict(tm.named_parameters())
    pred = trainable_predicate(True)
    for name, v in tm.state_dict().items():
        if name != "vq_embed_prob" and not pred(tuple(name.split("."))):
            assert torch.equal(v, before[name]), name
            assert name not in params or not params[name].requires_grad


@pytest.mark.parametrize("sd_locked", [True, False])
def test_trainable_predicate_matches_jax(sd_locked):
    jm, params, _ = micro_pair(seed=0)
    j_pred = j_trainer.trainable_predicate(sd_locked)
    t_pred = trainable_predicate(sd_locked)
    keys = ["/".join(k) for k in flatten_dict(params)]
    for key in keys:
        name = convert_leaf(key, np.zeros((1, 1)))[0]
        assert t_pred(tuple(name.split("."))) == j_pred(tuple(key.split("/"))), key
    # unlocked, the base UNet's decoder blocks and output head train too
    base = [k for k in keys if k.startswith("denoiser/base/")
            and j_pred(tuple(k.split("/")))]
    assert bool(base) == (not sd_locked)


def test_train_state_saves_and_loads(tmp_path):
    _, _, tm = micro_train_pair(seed=2)
    tt = Trainer(tm, accumulate_grad_batches=2, use_ema=True)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):  # one update, then half of the next accumulation
        logs = tt.step(t(_img(20)), generator=gen)
        assert all(torch.isfinite(v).all() for v in logs.values())
    tt.save(tmp_path / "state.pt")
    _, _, fresh = micro_pair(seed=3)
    other = Trainer(fresh, accumulate_grad_batches=2, use_ema=True)
    other.load(tmp_path / "state.pt")
    assert other.step_count == 3
    for (k, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(tt._grad_sum, other._grad_sum):
        assert torch.equal(a, b)
    for k in tt.ema:
        assert torch.equal(tt.ema[k], other.ema[k])
    sa, sb = tt.optimizer.state_dict(), other.optimizer.state_dict()
    for i, st in sa["state"].items():
        assert torch.equal(st["exp_avg_sq"], sb["state"][i]["exp_avg_sq"])
    with pytest.raises(NotImplementedError, match="orbax"):
        other.load(tmp_path)


def _write_images(folder, count=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(count):
        p = folder / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, (80 + i, 100, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    (folder / "train.list").write_text("\n".join(paths) + "\n")
    return folder / "train.list"


def test_crops_and_augment_match_jax(tmp_path):
    import random

    from PIL import Image

    lst = _write_images(tmp_path, 1)
    pil = Image.open(lst.read_text().split()[0]).convert("RGB")
    np.testing.assert_array_equal(t_image.center_crop_arr(pil, 48),
                                  j_image.center_crop_arr(pil, 48))
    for seed in range(3):
        np.testing.assert_array_equal(
            t_image.random_crop_arr(pil, 48, rng=random.Random(seed)),
            j_image.random_crop_arr(pil, 48, rng=random.Random(seed)))
        arr = np.asarray(pil)
        np.testing.assert_array_equal(
            t_image.augment(arr, rotation=True, rng=random.Random(seed)),
            j_image.augment(arr, rotation=True, rng=random.Random(seed)))


def test_dataset_and_loader(tmp_path):
    lst = _write_images(tmp_path)
    ds = LICDataset(str(lst), out_size=64, crop_type="random", seed=0)
    item = ds[0]
    assert item["jpg"].shape == (64, 64, 3) and item["txt"] == ""
    assert -1 <= item["jpg"].min() and item["jpg"].max() <= 1
    with pytest.raises(ValueError):
        LICDataset(str(lst), crop_type="bogus")
    cfg = {"dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                       "params": {"file_list": str(lst), "out_size": 64}},
           "data_loader": {"batch_size": 2, "shuffle": True, "drop_last": True,
                           "seed": 1}}
    batches = list(DataModule(train_config=cfg).train_dataloader())
    assert len(batches) == 2
    assert tuple(batches[0]["jpg"].shape) == (2, 64, 64, 3)
    assert batches[0]["jpg"].dtype == torch.float32


def test_cli_trains_two_steps_on_cpu_and_resumes(tmp_path):
    """`python -m rdeic_torch.train` for two steps on a temporary image
    folder, then a resume from its `checkpoints` directory for a third; then
    `python -m rdeic_torch.inference` serves that directory's last step, and
    its image equals `process()` on the trained model, bit for bit."""
    yaml = pytest.importorskip("yaml")
    lst = _write_images(tmp_path)
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(lst), "out_size": 64}},
        "data_loader": {"batch_size": 2, "shuffle": True, "drop_last": True}}))
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    run = tmp_path / "run"

    def train_yaml(resume):
        return yaml.safe_dump({
            "data": {"target": "rdeic_tpu.data.dataset.DataModule",
                     "params": {"train_config": str(tmp_path / "data.yaml"),
                                "val_config": None}},
            "model": {"config": str(tmp_path / "model.yaml"), "resume": resume},
            "trainer": {"seed": 1, "accumulate_grad_batches": 2,
                        "learning_rate": 1e-4, "log_every_n_steps": 1,
                        "ckpt_every_n_steps": 2, "out_dir": str(run),
                        "mesh": {"dp": None, "tp": 1}}})

    (tmp_path / "train.yaml").write_text(train_yaml(None))
    assert t_cli.main(["--config", str(tmp_path / "train.yaml"),
                       "--max_steps", "2", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().split("\n") if line]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    assert (run / "checkpoints" / "step_2.pt").exists()

    (tmp_path / "resume.yaml").write_text(train_yaml(str(run / "checkpoints")))
    t_cli.main(["--config", str(tmp_path / "resume.yaml"), "--max_steps", "3",
                "--device", "cpu"])
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().split("\n") if line]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert (run / "checkpoints" / "step_3.pt").exists()

    photo = lst.read_text().split()[0]  # 80x100: padded to 128x128
    t_inference.main(["--ckpt", str(run / "checkpoints"),
                      "--config", str(tmp_path / "model.yaml"),
                      "--input", photo, "--output", str(tmp_path / "served"),
                      "--device", "cpu"])
    served = np.array(Image.open(tmp_path / "served" / "img_0.png"))
    model = instantiate_from_config(load_yaml(str(tmp_path / "model.yaml")),
                                    device="cpu")
    trained = Trainer(model)
    trained.load(run / "checkpoints" / "step_3.pt")
    assert trained.step_count == 3
    arr = np.array(Image.open(photo).convert("RGB"))
    img01 = torch.from_numpy(t_image.to_float01(t_image.pad(arr, 64))[None])
    recon, _ = process(model.eval(), img01, 2, str(tmp_path / "ref.rdeic"),
                       torch.Generator().manual_seed(231))
    assert served.shape == arr.shape
    np.testing.assert_array_equal(served, recon[:arr.shape[0], :arr.shape[1]])
