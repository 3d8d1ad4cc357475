"""`python -m rdeic_torch.train` at tp = 2: two processes with torchrun's
environment (gloo, `--device cpu`) train a micro model on a YAML with
`trainer.mesh: {dp: 1, tp: 2}` for two steps, its kernels placed by
`shard_params`, an image log at step 2 (both ranks compute it, since the
layers need both; rank 0 writes it). Rank 0 alone writes `metrics.jsonl`,
the image log and the checkpoint, whose tensors are whole (the gather);
the logs match a one-process run of the same YAML within 1e-5 and the
weights by test_torch_port_ddp_cli's rule (rtol 1e-6 where the mean
gradient is firm, within 2 lr elsewhere, the frozen ones bit-equal: the
frozen base kernels come back whole from their shards), and so does the
image log's bpp."""
import pytest
import torch
import yaml

from rdeic_torch.train import cli as t_cli
from tests import test_torch_port_ddp_cli as ddp_cli
from tests.test_torch_port_ddp_cli import _recipe, _rows, _train
from tests.torch_port_dist import Ranks
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    one_torch_thread_per_module)


def _tp_recipe(tmp, run, tp):
    path = _recipe(tmp, run, None)
    cfg = yaml.safe_load(path.read_text())
    cfg["trainer"].update(mesh={"dp": 1, "tp": tp}, image_log_every_n_steps=2)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tp = 2 in two processes and, meanwhile, one process."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    two, one = tmp / "two", tmp / "one"
    ranks = Ranks(_train(_tp_recipe(tmp, two, 2), 2), world=2)
    assert t_cli.main(_train(_tp_recipe(tmp, one, 1), 2)[2:]) == 0
    outs = ranks.wait()
    return dict(tmp=tmp, two=two, one=one, outs=outs)


def test_rank_zero_alone_writes_whole_tensors(runs):
    two, one = runs["two"], runs["one"]
    assert [r["step"] for r in _rows(two)] == [1, 2]
    assert sorted(p.name for p in (two / "checkpoints").iterdir()) == \
        ["step_2.pt"]
    assert sorted(p.name for p in (two / "image_log" / "step_2").iterdir()) \
        == ["bpp.txt", "samples.png", "target.png", "vae_rec.png"]
    first, second = runs["outs"]
    assert "mesh {'dp': 1, 'tp': 2}" in first and "step 2:" in first
    assert "step 2:" not in second and "done" not in second
    got, want = (torch.load(r / "checkpoints" / "step_2.pt", weights_only=True)
                 for r in (two, one))
    for key, w in want["model"].items():
        assert got["model"][key].shape == w.shape, key
    assert (two / "image_log" / "step_2" / "bpp.txt").read_text() == \
        (one / "image_log" / "step_2" / "bpp.txt").read_text()


def test_tp_two_matches_one_process(runs):
    ddp_cli.test_world_two_matches_one_process(runs)
