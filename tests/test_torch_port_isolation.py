"""rdeic_torch stands alone: no module of it (nor chip_smoke.py) imports JAX,
its libraries or rdeic_tpu; importing the pipeline pulls in neither JAX nor
the CLI-only yaml and PIL; chip_smoke.py's config equals the model YAML."""
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
    code = ("import sys, rdeic_torch.pipeline.rdeic, rdeic_torch.inference; "
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
