"""rdeic_torch stands alone: no module of it (nor chip_smoke.py) imports JAX,
its libraries or rdeic_tpu; importing the pipeline, the trainer or the CLIs
pulls in neither JAX nor the yaml and PIL that only reading configs and
images needs; chip_smoke.py's configs equal the model and training YAMLs."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rdeic_tpu"}


def _port_sources():
    return sorted((ROOT / "rdeic_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_rdeic_tpu_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_pipeline_import_pulls_no_jax_yaml_or_pil():
    code = ("import sys, rdeic_torch.pipeline.rdeic, rdeic_torch.inference, "
            "rdeic_torch.inference_partition, rdeic_torch.models.clip, "
            "rdeic_torch.pipeline.tiled, rdeic_torch.tiled_inference, "
            "rdeic_torch.entropy.device_rans, "
            "rdeic_torch.utils.torch_convert, "
            "rdeic_torch.train, rdeic_torch.train.trainer, "
            "rdeic_torch.train.cli, rdeic_torch.data.dataset, "
            "rdeic_torch.parallel, rdeic_torch.parallel.mesh, "
            "rdeic_torch.parallel.tensor, rdeic_torch.utils.checkpoint_io, "
            "rdeic_torch.convert_checkpoint; "
            "bad = {'jax', 'flax', 'yaml', 'PIL', 'rdeic_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_config_equals_the_model_yaml():
    yaml = pytest.importorskip("yaml")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = yaml.safe_load((ROOT / "configs" / "model" / "rdeic.yaml").read_text())
    assert want["target"] == "rdeic_tpu.pipeline.rdeic.RDEIC"
    assert chip_smoke.MODEL_CONFIG == want["params"]
    train = yaml.safe_load((ROOT / "configs" / "train_rdeic.yaml").read_text())
    data = yaml.safe_load((ROOT / "configs" / "dataset" / "lic_train.yaml").read_text())
    assert train["model"]["config"] == "./configs/model/rdeic.yaml"
    assert train["data"]["params"]["train_config"] == "./configs/dataset/lic_train.yaml"
    assert chip_smoke.TRAIN_CONFIG == {
        "learning_rate": train["trainer"]["learning_rate"],
        "accumulate_grad_batches": train["trainer"]["accumulate_grad_batches"],
        "batch_size": data["data_loader"]["batch_size"],
        "out_size": data["dataset"]["params"]["out_size"]}
    refine = yaml.safe_load(
        (ROOT / "configs" / "train_rdeic_refine_v5e.yaml").read_text())
    refine_data = yaml.safe_load(
        (ROOT / "configs" / "dataset" / "lic_train_refine_v5e.yaml").read_text())
    assert refine["model"]["config"] == "./configs/model/rdeic.yaml"
    assert refine["model"]["overrides"]["is_refine"] is True
    assert (refine["data"]["params"]["train_config"]
            == "./configs/dataset/lic_train_refine_v5e.yaml")
    assert chip_smoke.REFINE_CONFIG == {
        "learning_rate": refine["trainer"]["learning_rate"],
        "accumulate_grad_batches": refine["trainer"]["accumulate_grad_batches"],
        "batch_size": refine_data["data_loader"]["batch_size"],
        "out_size": refine_data["dataset"]["params"]["out_size"]}
    assert chip_smoke.REFINE_MODEL_CONFIG == {**want["params"], "is_refine": True}


@pytest.mark.parametrize("name", ["train_rdeic_v5e.yaml", "train_rdeic_refine_v5e.yaml",
                                  "train_rdeic_refine_b4_probe.yaml",
                                  "finetune_ood.yaml", "finetune_ood_resume.yaml"])
def test_chip_smoke_bf16_recipe_equals_the_yamls(name):
    """Every bf16 training YAML sets chip_smoke's BF16_RECIPE, and
    REFINE_DOTS_MODEL_CONFIG is the model YAML under
    train_rdeic_refine_v5e.yaml's overrides."""
    yaml = pytest.importorskip("yaml")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = yaml.safe_load((ROOT / "configs" / name).read_text())
    assert {k: cfg["trainer"][k] for k in chip_smoke.BF16_RECIPE} == \
        chip_smoke.BF16_RECIPE
    if name != "train_rdeic_refine_v5e.yaml":
        return
    from rdeic_torch.train.cli import _deep_update  # noqa: PLC0415

    want = yaml.safe_load((ROOT / "configs" / "model" / "rdeic.yaml").read_text())
    _deep_update(want["params"], cfg["model"]["overrides"])
    assert chip_smoke.REFINE_DOTS_MODEL_CONFIG == want["params"]
