"""`python -m rdeic_torch.train`'s loop against the root train.py's on the
CPU: the batches the CLI feeds the trainer (train.py reads one batch
first and trains from the loader's second pass), the checkpoints a run
leaves, and validation and the image logger in the loop at the micro
config, which change nothing of the training."""
import contextlib
import io
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rdeic_torch.data import dataset as t_dataset
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import latest_checkpoint, list_checkpoints
from rdeic_tpu.data import dataset as j_dataset
from rdeic_tpu.utils import checkpoint_io as j_ckpt
from tests.test_torch_port_train_loop import _write_images
from tests.torch_port_helpers import MICRO
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")

ROOT = Path(__file__).resolve().parents[1]
# every training YAML of the repo (test_every_training_yaml_is_listed)
TRAIN_YAMLS = ["train_rdeic.yaml", "train_rdeic_v5e.yaml",
               "train_rdeic_refine_v5e.yaml", "train_rdeic_refine_b4_probe.yaml",
               "finetune_ood.yaml", "finetune_ood_resume.yaml"]
N_IMAGES = 11  # passes of 5, 2 and 1 batches at the YAMLs' B = 2, 4, 8


def test_every_training_yaml_is_listed():
    found = sorted(p.name for p in (ROOT / "configs").glob("*.yaml")
                   if "trainer" in yaml.safe_load(p.read_text()))
    assert found == sorted(TRAIN_YAMLS)


def _file_list(folder: Path, n: int = N_IMAGES) -> str:
    """n images of varied sizes, so that the random crop's scale and offset
    draws show."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = folder / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40 + 3 * i, 48 + 2 * (i % 4), 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    (folder / "train.list").write_text("\n".join(paths) + "\n")
    return str(folder / "train.list")


def _data_yaml(tmp_path: Path, name: str) -> tuple[Path, dict]:
    """The data config of training YAML `name` with its `data_loader` as it
    is and its dataset on the test's images: 32 px random crops and flips,
    seeded (the YAMLs leave the dataset's `rng` unseeded)."""
    train = yaml.safe_load((ROOT / "configs" / name).read_text())
    data = yaml.safe_load((ROOT / train["data"]["params"]["train_config"])
                          .read_text())
    data["dataset"]["params"].update(
        file_list=_file_list(tmp_path), out_size=32, crop_type="random",
        use_hflip=True, seed=3)
    path = tmp_path / "data.yaml"
    path.write_text(yaml.safe_dump(data))
    return path, data["data_loader"]


def _jax_batches_as_train_py_reads_them(config: Path, passes: int = 2):
    """rdeic_tpu's DataModule driven as train.py drives it: one
    `next(iter(loader))`, a wait until that pass's worker blocks (its queue
    full, or its batches done, and no item decoded for half a second), then
    `passes` passes. ([jpg batch], items the abandoned pass decoded, the
    loader)."""
    loader = j_dataset.DataModule(train_config=str(config)).train_dataloader()
    decoded = [0]
    ds_cls = type(loader.dataset)
    getitem = ds_cls.__getitem__

    def counting(self, idx):
        out = getitem(self, idx)
        decoded[0] += 1
        return out

    first = iter(loader)
    ds_cls.__getitem__ = counting
    try:
        next(first)
        q, worker = first.gi_frame.f_locals["q"], first.gi_frame.f_locals["t"]
        deadline, last, since = time.monotonic() + 60, -1, time.monotonic()
        while time.monotonic() < deadline:
            if decoded[0] != last:
                last, since = decoded[0], time.monotonic()
            elif ((q.full() or not worker.is_alive())
                  and time.monotonic() - since > 0.5):
                break
            time.sleep(0.02)
        else:
            raise AssertionError("the abandoned pass's worker never blocked")
        abandoned = decoded[0]
    finally:
        ds_cls.__getitem__ = getitem
    want = [b["jpg"] for _ in range(passes) for b in loader]
    return want, abandoned, loader


class FedTrainer:
    """A stand-in for `Trainer` that records the images the CLI feeds it and
    saves and loads only its step."""

    fed: list = []

    def __init__(self, model, **_):
        self.step_count = 0

    def step(self, img, generator=None):
        FedTrainer.fed.append(img.numpy().copy())
        self.step_count += 1
        return {"loss": torch.tensor(0.0)}

    def save(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step_count}, path)

    def load(self, path):
        self.step_count = torch.load(latest_checkpoint(path))["step"]


def _fake_cli(monkeypatch, tmp_path, data_config, trainer=None, resume=None):
    """A train YAML on `data_config` whose model and trainer are stand-ins:
    the CLI's own loader, loop and checkpoint cadence around them."""
    monkeypatch.setattr(t_cli, "build_model",
                        lambda cfg, device: types.SimpleNamespace(is_refine=False))
    monkeypatch.setattr(t_cli, "Trainer", FedTrainer)
    FedTrainer.fed = []
    cfg = {"data": {"target": "rdeic_tpu.data.dataset.DataModule",
                    "params": {"train_config": str(data_config),
                               "val_config": None}},
           "model": {"config": "unused.yaml", "resume": resume},
           "trainer": {"seed": 1, "log_every_n_steps": 1000,
                       "ckpt_every_n_steps": 1000,
                       "image_log_every_n_steps": 1000,
                       "out_dir": str(tmp_path / "run"), **(trainer or {})}}
    path = tmp_path / f"train_{len(list(tmp_path.glob('train_*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("name", TRAIN_YAMLS)
def test_cli_trains_on_the_batches_train_py_trains_on(tmp_path, monkeypatch,
                                                       name, resume):
    """Two passes of the port CLI's training batches equal those train.py
    trains on (the loader's second and third passes, after the draws of the
    first pass's abandoned worker), under the training YAML's
    `data_loader`. A resumed run restarts the loader as train.py's does,
    so it trains on the same stream from its start."""
    config, loader_kw = _data_yaml(tmp_path, name)
    want, abandoned, j_loader = _jax_batches_as_train_py_reads_them(config)
    per_pass = len(j_loader)
    assert abandoned == min(per_pass, 2 + 2) * loader_kw["batch_size"]
    steps = 2 * per_pass
    start = 0
    if resume:  # a first run of one step, saved, then the resume
        first = _fake_cli(monkeypatch, tmp_path, config,
                          {"ckpt_every_n_steps": 1})
        assert t_cli.main(["--config", str(first), "--max_steps", "1",
                           "--device", "cpu"]) == 0
        np.testing.assert_array_equal(FedTrainer.fed[0], want[0])
        start = 1
    train = _fake_cli(monkeypatch, tmp_path, config,
                      resume=str(tmp_path / "run" / "checkpoints") if resume
                      else None)
    assert t_cli.main(["--config", str(train), "--max_steps",
                       str(start + steps), "--device", "cpu"]) == 0
    assert len(FedTrainer.fed) == steps == len(want)
    for i, (got, ref) in enumerate(zip(FedTrainer.fed, want)):
        np.testing.assert_array_equal(got, ref, err_msg=f"batch {i}")


def test_first_batch_leaves_the_state_of_an_abandoned_pass(tmp_path):
    """`first_batch` gives the pass's first batch and leaves the epoch and
    the dataset's `rng` where the JAX loader's blocked worker leaves them;
    with `prefetch` 0 (an unbounded queue) the worker decodes the whole
    pass."""
    config, _ = _data_yaml(tmp_path, "train_rdeic.yaml")
    for prefetch in (2, 0):
        cfg = yaml.safe_load(config.read_text())
        cfg["data_loader"]["prefetch"] = prefetch
        config.write_text(yaml.safe_dump(cfg))
        port = t_dataset.DataModule(train_config=str(config)).train_dataloader()
        first = port.first_batch()
        want, _, ref = _jax_batches_as_train_py_reads_them(config, passes=0)
        assert port.epoch == ref.epoch == 1
        assert port.dataset.rng.getstate() == ref.dataset.rng.getstate()
        assert first["jpg"].shape == (2, 32, 32, 3)


def test_loader_keeps_its_draws_under_thread_switching(tmp_path):
    """The worker thread makes every draw in item order: with the
    interpreter switching threads every microsecond and a consumer that
    stalls, two passes give the same batches as the dataset read in order
    on one thread."""
    import random  # noqa: PLC0415
    import sys  # noqa: PLC0415

    config, _ = _data_yaml(tmp_path, "train_rdeic.yaml")
    port = t_dataset.DataModule(train_config=str(config)).train_dataloader()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        for _ in range(2):
            for batch in port:
                time.sleep(0.01)
                got.append(batch["jpg"].numpy())
    finally:
        sys.setswitchinterval(switch)
    ds = t_dataset.DataModule(train_config=str(config)).train_dataloader().dataset
    want = []
    for epoch in range(2):
        idx = list(range(len(ds)))
        random.Random(epoch).shuffle(idx)
        want += [np.stack([ds[i]["jpg"] for i in idx[k: k + 2]])
                 for k in range(0, len(idx) - 1, 2)]
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_loader_hands_a_worker_failure_to_the_consumer(tmp_path):
    config, _ = _data_yaml(tmp_path, "train_rdeic.yaml")
    port = t_dataset.DataModule(train_config=str(config)).train_dataloader()

    def unreadable(path):
        raise OSError(f"cannot read {path}")

    port.dataset._load_uncached = unreadable
    with pytest.raises(OSError, match="cannot read"):
        list(port)


def test_final_checkpoint_is_not_pruned(tmp_path, monkeypatch):
    """ckpt_keep 3 (configs/finetune_ood.yaml), a save every 2 steps and 7
    steps: rdeic_tpu's save_train_checkpoint in train.py's cadence (keep 3
    at steps 2, 4, 6, the default keep=-1 at the end) leaves four step
    checkpoints, and so does the port's CLI."""
    ood = yaml.safe_load((ROOT / "configs" / "finetune_ood.yaml").read_text())
    keep = ood["trainer"]["ckpt_keep"]
    assert keep == 3
    state = types.SimpleNamespace(
        step=np.int32(0), rng=np.zeros(2, np.uint32), ema_params=None,
        frozen_params={"w": np.zeros(4, np.float32),
                       "vq_embed_prob": np.zeros(2, np.float32)},
        train_params={"a": np.ones(3, np.float32)},
        opt_state={"m": np.zeros(3, np.float32)})
    ref_dir = tmp_path / "ref"
    for step in range(1, 8):
        if step % 2 == 0:
            j_ckpt.save_train_checkpoint(str(ref_dir), step, state, keep=keep)
    j_ckpt.save_train_checkpoint(str(ref_dir), 7, state)
    want = j_ckpt.list_checkpoints(str(ref_dir))
    assert want == [2, 4, 6, 7]

    config, _ = _data_yaml(tmp_path, "finetune_ood.yaml")
    train = _fake_cli(monkeypatch, tmp_path, config,
                      {"ckpt_every_n_steps": 2, "ckpt_keep": keep})
    assert t_cli.main(["--config", str(train), "--max_steps", "7",
                       "--device", "cpu"]) == 0
    assert list_checkpoints(tmp_path / "run" / "checkpoints") == want


# -- the loop with validation and the image logger, at the micro config -------

def _micro_run(tmp_path: Path, name: str, val_every: int, image_every: int):
    """`python -m rdeic_torch.train` for 4 steps of B = 2 on 64 px crops,
    validating on two 64 px centre crops (one a batch) every `val_every`
    steps and logging images every `image_every`. (metrics rows, stdout is
    the caller's.)"""
    lst = _write_images(tmp_path)
    val = tmp_path / "val.list"
    val.write_text("\n".join(lst.read_text().split()[:2]) + "\n")
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(lst), "out_size": 64,
                               "seed": 0}},
        "data_loader": {"batch_size": 2, "shuffle": True, "drop_last": True}}))
    (tmp_path / "val.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(val), "out_size": 64,
                               "crop_type": "center", "use_hflip": False}},
        "data_loader": {"batch_size": 1, "shuffle": False,
                        "drop_last": False}}))
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    run = tmp_path / name
    (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump({
        "data": {"target": "rdeic_tpu.data.dataset.DataModule",
                 "params": {"train_config": str(tmp_path / "data.yaml"),
                            "val_config": str(tmp_path / "val.yaml")}},
        "model": {"config": str(tmp_path / "model.yaml")},
        "trainer": {"seed": 1, "learning_rate": 1e-4, "log_every_n_steps": 1,
                    "ckpt_every_n_steps": 100, "val_check_interval": val_every,
                    "image_log_every_n_steps": image_every,
                    "out_dir": str(run)}}))
    assert t_cli.main(["--config", str(tmp_path / f"{name}.yaml"),
                       "--max_steps", "4", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines() if line]
    return rows, run


@pytest.fixture(scope="module")
def micro_runs(tmp_path_factory):
    """The same 4 steps with validation every 2 steps and images every 3,
    and with neither."""
    tmp = tmp_path_factory.mktemp("loop")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with_val = _micro_run(tmp, "with", val_every=2, image_every=3)
    without = _micro_run(tmp, "without", val_every=0, image_every=1000)
    return with_val, without, out.getvalue()


def test_cli_validates_and_logs_images_at_their_steps(micro_runs):
    (rows, run), _, stdout = micro_runs
    val = [r for r in rows if "usage" in r]
    train = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in val] == [2, 4]
    for r in val:
        assert set(r) == {"step", "avg_bpp", "avg_psnr", "avg_ms_ssim",
                          "avg_lpips", "usage"}
        assert all(np.isfinite(r[k]) for k in ("avg_bpp", "avg_psnr",
                                               "avg_lpips", "usage"))
        assert np.isnan(r["avg_ms_ssim"])  # 64 px: under MS-SSIM's 176
        assert 0 < r["usage"] <= 1
    assert "validation @ 2: {" in stdout and "validation @ 4: {" in stdout
    logs = run / "image_log"
    assert sorted(p.name for p in logs.iterdir()) == ["step_3"]
    for panel in ("target", "vae_rec", "samples"):
        with Image.open(logs / "step_3" / f"{panel}.png") as im:
            assert im.size == (128, 64)  # the batch's two images in a row
    bpp = float((logs / "step_3" / "bpp.txt").read_text())
    assert bpp > 0
    assert list_checkpoints(run / "checkpoints") == [4]


def test_validation_leaves_the_training_unchanged(micro_runs):
    """Validation and the image logger draw from generators of their own
    and read their own data: the losses and gradients of every step equal
    those of the run without them, bit for bit, and so do the weights."""
    (rows, run), (rows_without, run_without), _ = micro_runs
    train = [r for r in rows if "loss" in r]
    assert len(train) == len(rows_without) == 4
    for a, b in zip(train, rows_without):
        assert set(a) == set(b)
        for k in a:
            if k != "steps_per_sec":
                assert a[k] == b[k], (a["step"], k)
    sa = torch.load(run / "checkpoints" / "step_4.pt", weights_only=True)["model"]
    sb = torch.load(run_without / "checkpoints" / "step_4.pt",
                    weights_only=True)["model"]
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_val_dataloader_reads_the_list_in_order(tmp_path):
    """No shuffle whatever the config says, `drop_last` and the batch from
    the config (both validation YAMLs: 1 and false), as rdeic_tpu's."""
    lst = _write_images(tmp_path, 5)
    for name in ("lic_valid.yaml", "ood_valid.yaml"):
        cfg = yaml.safe_load((ROOT / "configs" / "dataset" / name).read_text())
        assert cfg["data_loader"] == {"batch_size": 1, "shuffle": False,
                                      "drop_last": False}
    cfg["dataset"]["params"].update(file_list=str(lst), out_size=64)
    cfg["data_loader"].update(batch_size=2, shuffle=True)
    port = t_dataset.DataModule(val_config=cfg).val_dataloader()
    ref = j_dataset.DataModule(val_config=cfg).val_dataloader()
    assert len(port) == len(ref) == 3
    got = [b["jpg"].numpy() for b in port]
    want = [b["jpg"] for b in ref]
    assert [g.shape[0] for g in got] == [2, 2, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert t_dataset.DataModule().val_dataloader() is None
