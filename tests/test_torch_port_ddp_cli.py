"""`python -m rdeic_torch.train` at world 2: two processes with torchrun's
environment (gloo, `--device cpu`) train a micro model on a YAML with
`trainer.mesh: {dp: 2}` for two steps. Rank 0 alone writes `metrics.jsonl`
and the checkpoint; the logs and the weights match a one-process run of
the same YAML with `dp: ~`; a resume from that
checkpoint at world 2 takes a third step; the ranks of an unseeded
dataset read the same batches; `dp: 2` in one plain process is refused
with make_mesh's ValueError."""
import json

import numpy as np
import pytest
import torch
import yaml

from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import trainable_parameters
from tests.test_torch_port_train_loop import _write_images
from tests.test_torch_port_train_model import GRAD_FLOOR
from tests.torch_port_dist import Ranks, Workers
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, n, one_torch_thread_per_module)

LR = 1e-4
CODEBOOK = "compression.quantize.embedding"


def _recipe(tmp_path, run, dp, resume=None):
    """A train YAML on 4 PNGs (crops seeded), global batch 2, accumulation
    2."""
    lst = tmp_path / "train.list"
    if not lst.exists():
        _write_images(tmp_path)
        (tmp_path / "data.yaml").write_text(yaml.safe_dump({
            "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                        "params": {"file_list": str(lst), "out_size": 64,
                                   "seed": 0}},
            "data_loader": {"batch_size": 2, "shuffle": True,
                            "drop_last": True}}))
        (tmp_path / "model.yaml").write_text(yaml.safe_dump(
            {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    path = tmp_path / f"{run.name}_{dp}_{bool(resume)}.yaml"
    path.write_text(yaml.safe_dump({
        "data": {"target": "rdeic_tpu.data.dataset.DataModule",
                 "params": {"train_config": str(tmp_path / "data.yaml"),
                            "val_config": None}},
        "model": {"config": str(tmp_path / "model.yaml"), "resume": resume},
        "trainer": {"seed": 1, "accumulate_grad_batches": 2,
                    "learning_rate": LR, "log_every_n_steps": 1,
                    "ckpt_every_n_steps": 2, "out_dir": str(run),
                    "mesh": {"dp": dp, "tp": 1}}}))
    return path


def _rows(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines() if line]


def _train(config, steps):
    return ["-m", "rdeic_torch.train", "--config", str(config),
            "--max_steps", str(steps), "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 2 in two processes and, meanwhile, world 1 in this one."""
    tmp = tmp_path_factory.mktemp("ddp_cli")
    two, one = tmp / "two", tmp / "one"
    ranks = Ranks(_train(_recipe(tmp, two, 2), 2), world=2)
    assert t_cli.main(_train(_recipe(tmp, one, None), 2)[2:]) == 0
    outs = ranks.wait()
    return dict(tmp=tmp, two=two, one=one, outs=outs)


def test_rank_zero_alone_writes_the_files(runs):
    two = runs["two"]
    assert [r["step"] for r in _rows(two)] == [1, 2]  # one row a step
    assert sorted(p.name for p in (two / "checkpoints").iterdir()) == \
        ["step_2.pt"]
    first, second = runs["outs"]
    assert "mesh {'dp': 2, 'tp': 1}" in first and "step 2:" in first
    assert "step 2:" not in second and "done" not in second


def assert_usage_close(got, want, codebook) -> None:
    """The code usage EMA to 1e-6, summed over each set of copies of one
    code. A fresh model's usage is 0, so the first update re-seeds every
    code from its closest row, and codes closest to one row become copies;
    a later row nearest to such copies takes the first of them in one run
    and, its hyper latent an ulp away at another batch size, another in
    the next. Copies are told by their distance after the run: a later
    update pulls a used code by at most e^-10 of its distance to its
    closest row (under 1e-3 here), where distinct codes lie ~1 apart."""
    near = np.abs(codebook[:, None] - codebook[None]).max(-1) < 1e-3
    group = np.arange(len(codebook))  # connected sets of near codes
    for _ in range(len(codebook)):
        group = np.array([group[near[i]].min() for i in range(len(group))])
    for g in np.unique(group):
        members = group == g
        np.testing.assert_allclose(got[members].sum(), want[members].sum(),
                                   rtol=1e-6, atol=1e-9,
                                   err_msg=str(np.flatnonzero(members)))


def test_world_two_matches_one_process(runs):
    """The logs to 1e-5; the stepped weights as test_torch_port_train_loop
    holds them: where the mean gradient (AdamW's first moment / 0.1) is well
    above rounding, to rtol 1e-6; elsewhere within 2 lr (the first update is
    lr * sign(g), and a gradient at rounding level may flip its sign); the
    frozen weights bit-equal; the code usage as `assert_usage_close`."""
    two, one = _rows(runs["two"]), _rows(runs["one"])
    for a, b in zip(two, one):
        for key in set(a) - {"steps_per_sec", "step"}:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    got, want = (torch.load(r / "checkpoints" / "step_2.pt", weights_only=True)
                 for r in (runs["two"], runs["one"]))
    assert got["step"] == want["step"] == 2
    model = instantiate_from_config(
        load_yaml(str(runs["tmp"] / "model.yaml")), device="cpu")
    names = list(trainable_parameters(model))
    mu = {names[i]: n(st["exp_avg"]) / 0.1
          for i, st in want["optimizer"]["state"].items()}
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in mu.values())
    for key, w in want["model"].items():
        g, w = n(got["model"][key]), n(w)
        if key == "vq_embed_prob":
            assert_usage_close(g, w, n(want["model"][CODEBOOK]))
        elif key not in mu:
            assert np.array_equal(g, w), key
        else:
            grad = np.abs(mu[key])
            firm = grad > 1e-2 * max(grad.max(), floor)
            atol = 1e-5 if key == CODEBOOK else 1e-7
            np.testing.assert_allclose(g[firm], w[firm], rtol=1e-6, atol=atol,
                                       err_msg=key)
            assert np.abs(g - w).max() <= 2 * LR * (1 + 1e-3) + 1e-7, key


def test_world_two_resumes(runs):
    two, tmp = runs["two"], runs["tmp"]
    config = _recipe(tmp, two, 2, resume=str(two / "checkpoints"))
    first, _ = Ranks(_train(config, 3), world=2).wait()
    assert "[resumed the train state at step 2]" in first
    assert [r["step"] for r in _rows(two)] == [1, 2, 3]
    assert (two / "checkpoints" / "step_3.pt").exists()


def test_ranks_of_an_unseeded_dataset_read_the_same_batches(runs, tmp_path):
    """Without `seed` a dataset seeds its crops from the OS: the ranks take
    rank 0's stream, so they read one global batch."""
    torch.save({"file_list": str(runs["tmp"] / "train.list")},
               tmp_path / "inputs.pt")
    first, second = Workers("loader", tmp_path).results()
    for a, b in zip(first["batches"], second["batches"]):
        assert torch.equal(a, b)


def test_dp_above_the_world_is_refused(tmp_path):
    config = _recipe(tmp_path, tmp_path / "refused", 2)
    with pytest.raises(ValueError, match=r"dp\*tp=2 != #devices=1"):
        t_cli.main(_train(config, 1)[2:])
