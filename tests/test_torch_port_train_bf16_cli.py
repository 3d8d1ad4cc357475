"""`python -m rdeic_torch.train` on the repo's bf16 recipes
(`configs/train_rdeic_v5e.yaml`, `train_rdeic_refine_v5e.yaml`) at the
micro config on the CPU: the YAMLs' trainer and model settings as they are
(bf16 compute and frozen storage, `fast_init`, `ckpt_keep`; the refine
recipe's `remat_policy: dots` and its warm start from a phase-1 `.npz`), two
steps, a resume, and the last step served by
`python -m rdeic_torch.inference`. On one torch thread, as
test_torch_port_train_bf16.py."""
import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rdeic_torch import inference as t_inference
from rdeic_torch.inference import process
from rdeic_torch.pipeline.rdeic import RDEIC
from rdeic_torch.registry import instantiate_from_config, load_yaml
from rdeic_torch.train import cli as t_cli
from rdeic_torch.train.trainer import (
    cast_frozen,
    is_frozen_float,
    list_checkpoints,
    trainable_predicate,
)
from rdeic_torch.utils import image as t_image
from rdeic_torch.utils.convert import convert_leaf, load_train_state_weights
from rdeic_torch.utils.fast_init import fast_random_init
from rdeic_tpu.utils.checkpoint_io import save_params_npz
from tests.test_torch_port_train_loop import _write_images, micro_train_pair
from tests.torch_port_helpers import MICRO
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _recipe(tmp_path, name, run, resume):
    """The repo's YAML `name` with its trainer and model settings as they
    are, the data, the model config and the output moved to the test's own:
    a micro model, a list of written images, log and checkpoint every
    step."""
    yaml = pytest.importorskip("yaml")
    cfg = load_yaml(str(ROOT / "configs" / name))
    lst = _write_images(tmp_path)
    (tmp_path / "data.yaml").write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": str(lst), "out_size": 64}},
        "data_loader": {"batch_size": 1, "shuffle": True, "drop_last": True}}))
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    cfg["data"]["params"] = {"train_config": str(tmp_path / "data.yaml"),
                             "val_config": None}
    cfg["model"]["config"] = str(tmp_path / "model.yaml")
    cfg["model"]["resume"] = resume
    cfg["trainer"].update(out_dir=str(run), log_every_n_steps=1,
                          ckpt_every_n_steps=1)
    path = tmp_path / f"{name}.{'resume' if resume else 'fresh'}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, path, lst


@pytest.mark.parametrize("name", ["train_rdeic_v5e.yaml",
                                  "train_rdeic_refine_v5e.yaml"])
def test_cli_trains_the_bf16_recipes_resumes_and_serves(tmp_path, name, capsys):
    """Two steps of the recipe (compute_dtype and frozen_dtype bf16,
    fast_init from trainer.seed, its ckpt_keep; the refine recipe also
    is_refine and remat_policy "dots" on both UNets, and warm-starts from a
    phase-1 `.npz`, keeping its fast-init LPIPS), a resume from the
    checkpoints directory for a third, and
    `python -m rdeic_torch.inference` on the last step, equal to
    `process()` on that step's weights bit for bit."""
    run = tmp_path / "run"
    resume = None
    if "refine" in name:  # the recipe warm-starts from a phase-1 export
        jm, params, _ = micro_train_pair(seed=4)  # a usage a run can have
        save_params_npz(tmp_path / "phase1.npz", jax.device_get(params))
        resume = str(tmp_path / "phase1.npz")
    cfg, path, lst = _recipe(tmp_path, name, run, resume)
    tcfg = cfg["trainer"]
    assert tcfg["compute_dtype"] == tcfg["frozen_dtype"] == "bfloat16"
    assert tcfg["fast_init"] is True and tcfg["ckpt_keep"] in (1, 2)
    assert t_cli.main(["--config", str(path), "--max_steps", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[compute dtype: bfloat16]" in out
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(list(r.values())).all() for r in rows)
    assert ("refine phase" in out) == ("refine" in name)
    ckpts = run / "checkpoints"
    assert list_checkpoints(ckpts) == [1, 2][-tcfg["ckpt_keep"]:]
    state = torch.load(ckpts / "step_2.pt", weights_only=True)
    pred = trainable_predicate(True)
    for k, v in state["model"].items():
        frozen = k != "vq_embed_prob" and not pred(tuple(k.split(".")))
        assert v.dtype == (BF16 if frozen else torch.float32), k
    if resume:  # frozen tensors never move: the export's, in bf16
        with np.load(resume) as export:
            for key in export.files:
                k, v = convert_leaf(key, export[key])
                if k in state["model"] and is_frozen_float(k, v, pred):
                    assert torch.equal(state["model"][k], v.to(BF16)), k
        # LPIPS, absent from the export: fast_init's, from trainer.seed
        own = RDEIC(**copy.deepcopy(MICRO), is_refine=True, device="meta")
        cast_frozen(own, BF16)
        fast_random_init(own, "cpu", seed=tcfg["seed"])
        for k, v in own.lpips.state_dict().items():
            assert torch.equal(state["model"][f"lpips.{k}"], v), k
    _, path, _ = _recipe(tmp_path, name, run, str(ckpts))
    t_cli.main(["--config", str(path), "--max_steps", "3", "--device", "cpu"])
    assert list_checkpoints(ckpts) == [2, 3][-tcfg["ckpt_keep"]:]

    photo = lst.read_text().split()[0]  # 80x100: padded to 128x128
    t_inference.main(["--ckpt", str(ckpts), "--config", str(tmp_path / "model.yaml"),
                      "--input", photo, "--output", str(tmp_path / "served"),
                      "--device", "cpu"])
    served = np.array(Image.open(tmp_path / "served" / "img_0.png"))
    model = instantiate_from_config(load_yaml(str(tmp_path / "model.yaml")),
                                    device="cpu")
    load_train_state_weights(model, ckpts / "step_3.pt")
    arr = np.array(Image.open(photo).convert("RGB"))
    img01 = torch.from_numpy(t_image.to_float01(t_image.pad(arr, 64))[None])
    recon, _ = process(model.eval(), img01, 2, str(tmp_path / "ref.rdeic"),
                       torch.Generator().manual_seed(231))
    np.testing.assert_array_equal(served, recon[:arr.shape[0], :arr.shape[1]])
