"""The port's own checkpoints, on the CPU at the micro config: a directory
of `Trainer.save` files resumes and serves from its largest step (step_10
over step_9), a refine run's LPIPS weights are dropped for a serving model,
an orbax checkpoint of the JAX package stays refused, and a `resume` that
names an absent or empty directory starts training fresh, as the root
train.py does."""
import copy
import json

import pytest
import torch
import yaml

from rdeic_torch.inference import load_model
from rdeic_torch.pipeline.rdeic import RDEIC
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import Trainer, latest_checkpoint, list_checkpoints
from tests.test_torch_port_train_loop import _write_images
from tests.torch_port_helpers import MICRO


def _micro(tmp_path, **overrides):
    """A micro RDEIC with torch's default init, and its model YAML."""
    params = {**copy.deepcopy(MICRO), **overrides}
    config = tmp_path / "model.yaml"
    config.write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    torch.manual_seed(0)
    return RDEIC(**params, device="cpu"), config


def _save(trainer, path, step):
    """Save the train state as step `step`, after moving one weight so that
    each step's file holds other weights."""
    with torch.no_grad():
        trainer.model.compression.quantize.embedding.add_(float(step))
    trainer.step_count = step
    trainer.save(path / f"step_{step}.pt")
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_the_largest_step_wins(tmp_path):
    """step_10 over step_9 (not in string order), past an orbax `step_11`
    directory and a stray name: `Trainer.load` and the serving
    `load_model` both take step 10's weights from the directory."""
    model, config = _micro(tmp_path)
    trainer = Trainer(model)
    ckpts = tmp_path / "checkpoints"
    _save(trainer, ckpts, 9)
    want = _save(trainer, ckpts, 10)
    (ckpts / "step_11").mkdir()
    (ckpts / "step_12.pt.tmp").write_bytes(b"")
    assert list_checkpoints(ckpts) == [9, 10]
    assert latest_checkpoint(ckpts) == ckpts / "step_10.pt"
    assert latest_checkpoint(ckpts / "step_9.pt") == ckpts / "step_9.pt"

    other = Trainer(_micro(tmp_path)[0])
    other.load(ckpts)
    assert other.step_count == 10
    served = load_model(str(config), str(ckpts), torch.device("cpu"))
    for got in (other.model.state_dict(), served.state_dict()):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_a_refine_state_serves_without_its_lpips(tmp_path):
    """A refine run's state holds LPIPS weights; the serving model has no
    LPIPS, so they are dropped and every other weight loads strictly."""
    model, config = _micro(tmp_path, is_refine=True)
    assert any(k.startswith("lpips.") for k in model.state_dict())
    want = _save(Trainer(model), tmp_path / "checkpoints", 4)
    served = load_model(str(config), str(tmp_path / "checkpoints"),
                        torch.device("cpu"))
    got = served.state_dict()
    assert set(got) == {k for k in want if not k.startswith("lpips.")}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_orbax_checkpoints_stay_refused(tmp_path):
    """A directory of orbax `step_N` directories (the JAX package's) is
    refused by serving and by the trainer, naming the ROADMAP item."""
    model, config = _micro(tmp_path)
    orbax = tmp_path / "orbax"
    (orbax / "step_5").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the rest"):
        load_model(str(config), str(orbax), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="orbax"):
        Trainer(model).load(orbax)


@pytest.mark.parametrize("resume", ["absent", "empty"])
def test_resume_from_no_checkpoint_starts_fresh(tmp_path, capsys, resume):
    """`model.resume` naming an absent directory, or an empty one, starts
    from step 0 without raising (as `configs/finetune_ood_resume.yaml`
    does on its first run), and the run writes its first checkpoint."""
    lst = _write_images(tmp_path)
    _, config = _micro(tmp_path)
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(lst), "out_size": 64}},
        "data_loader": {"batch_size": 2}}))
    ckpts = tmp_path / "run" / "checkpoints"
    if resume == "empty":
        ckpts.mkdir(parents=True)
    (tmp_path / "train.yaml").write_text(yaml.safe_dump({
        "data": {"target": "rdeic_tpu.data.dataset.DataModule",
                 "params": {"train_config": str(tmp_path / "data.yaml")}},
        "model": {"config": str(config), "resume": str(ckpts)},
        "trainer": {"log_every_n_steps": 1, "out_dir": str(tmp_path / "run")}}))
    assert t_cli.main(["--config", str(tmp_path / "train.yaml"),
                       "--max_steps", "1", "--device", "cpu"]) == 0
    assert "training starts fresh" in capsys.readouterr().out
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1]
    assert list_checkpoints(ckpts) == [1]
