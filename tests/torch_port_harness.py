"""Shared pieces of the harness parity tests: the root scripts run in this
process on a test's JAX model, their CSVs read back, the JAX split
sequences handed to the port's harnesses as `noise()`, and a pair of
metric suites on the same LPIPS weights."""
import contextlib
import csv
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from rdeic_torch.utils.convert import load_jax_params
from rdeic_torch.utils.metrics import MetricSuite as TorchSuite
from rdeic_tpu.utils.metrics import MetricSuite as JaxSuite
from tests.test_torch_port_metrics import _jax_lpips_params
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import unflatten

ROOT = Path(__file__).resolve().parent.parent
STEPS = 2  # the root scripts' default --steps
# a harness row's metrics against the root script's: its reconstruction
# may differ by one level at a few pixels (the fp32 decodes agree within
# 2e-4 before to_uint8), which moves these by ~1e-6; NIQE and BRISQUE are
# features of the image itself, so a level moves them more
METRIC_TOL = {"psnr": dict(rtol=1e-4), "ssim": dict(atol=1e-4),
              "ms_ssim": dict(atol=1e-4), "lpips": dict(atol=1e-4),
              "niqe": dict(rtol=1e-3), "brisque": dict(rtol=1e-3)}


def root_module(name: str):
    """A root script (e.g. "baseline_inference", "experiments.run_ood")."""
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(name, fromlist=["main"])
    finally:
        sys.path.remove(str(ROOT))


def run_root(name: str, argv: list, jm, params, suite) -> str:
    """The root script's main() with `argv`, on the test's JAX model,
    params and metric suite (its decode programs are then the ones the
    test reuses); returns what it printed."""
    mod = root_module(name)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(mod, "MetricSuite", lambda: suite)
        if hasattr(mod, "instantiate_from_config"):
            mp.setattr(mod, "instantiate_from_config", lambda cfg: jm)
            mp.setattr(mod, "load_inference_params", lambda path: params)
        mp.setattr(sys, "argv", [name, *argv])
        mod.main()
    return out.getvalue()


def read_csv(path: Path) -> tuple[list, list]:
    """(header, rows as dicts of strings)."""
    with path.open() as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def jax_noise(seed: int, shape) -> callable:
    """`noise()` of the port's harnesses: each call the next split of
    PRNGKey(seed) through decode_pipeline's draws."""
    key = [jax.random.PRNGKey(seed)]

    def noise() -> dict:
        key[0], sub = jax.random.split(key[0])
        relay, steps = _jax_noise(sub, shape, STEPS)
        return {"relay_noise": relay, "step_noise": steps}

    return noise


def suites(seed: int):
    """(JAX suite, port suite) scoring LPIPS(alex) on the same random
    weights, carried from the JAX net."""
    flat = _jax_lpips_params("alex", seed=seed)
    return (JaxSuite(lpips_params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                         unflatten(flat))),
            TorchSuite(lpips_params=load_jax_params(flat)))


def check_metrics(got: dict, want: dict, names) -> None:
    """Each metric of a row against the root CSV's string (NaN to NaN)."""
    for n in names:
        if want[n] == "nan":
            assert np.isnan(float(got[n])), n
        else:
            np.testing.assert_allclose(float(got[n]), float(want[n]),
                                       **METRIC_TOL[n], err_msg=n)


def save_images(folder: Path, sizes, seed: int) -> list:
    """Random uint8 PNGs im0.png, im1.png, ... of `sizes` in `folder`."""
    from PIL import Image  # noqa: PLC0415

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, hw in enumerate(sizes):
        paths.append(folder / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            paths[-1])
    return paths
