"""`python -m rdeic_torch.convert_checkpoint` against the root
convert_checkpoint.py on the CPU, at the micro config: on a synthetic SD
state dict (the base UNet, the VAE, CLIP), a CC state dict (compression
and control, DDP `module.` prefixes, and one base key over the SD one,
which the merge must take) and an LPIPS `alex.pth` with the lpips
package's `lins.{i}` keys, both write the same keys and shapes, and every
converted leaf, the LPIPS heads and `uncond_context` (the port's CLIP tower
on the empty prompt) agree within 1e-5; the leaves the checkpoints do not
hold stay random, each framework's own."""
import copy
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from rdeic_torch import convert_checkpoint as t_convert
from rdeic_torch.utils import checkpoint_io as t_io
from rdeic_torch.utils.torch_convert import convert_state_dict
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.test_torch_port_export import read
from tests.test_torch_port_sync_path import synthetic_sd
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, one_torch_thread_per_module)

ROOT = Path(__file__).resolve().parents[1]
ALEX = (64, 192, 384, 256, 256)  # the LPIPS(alex) heads' widths


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both CLIs on the same synthetic checkpoints: the SD dict (the base
    UNet, the VAE, CLIP) and the CC dict (compression and control, and one
    base key over the SD one, which the merge must take), a `lins.{i}`
    alex.pth; the port's `missing` list from its own converter."""
    ws = tmp_path_factory.mktemp("convert")
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=(64, 64), include_clip=True),
        jax.random.PRNGKey(0))
    sd = synthetic_sd(jm, template, seed=2)
    cc_prefix = ("control_model.", "preprocess_model.")
    cc = {k: v for k, v in sd.items() if k.startswith(cc_prefix)}
    base = {k: v for k, v in sd.items() if not k.startswith(cc_prefix)}
    over = next(k for k in base if k.startswith("model.diffusion_model."))
    base[over] = base[over] * 3.0  # the CC dict's copy wins
    cc[over] = sd[over]
    torch.save({"state_dict": base}, ws / "sd.ckpt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in cc.items()}},
               ws / "cc.ckpt")
    gen = torch.Generator().manual_seed(4)
    torch.save({f"lins.{i}.model.1.weight": torch.randn(1, c, 1, 1, generator=gen)
                for i, c in enumerate(ALEX)}, ws / "alex.pth")
    (ws / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    args = ["--config", str(ws / "m.yaml"), "--sd_ckpt", str(ws / "sd.ckpt"),
            "--cc_ckpt", str(ws / "cc.ckpt"), "--lpips_ckpt",
            str(ws / "alex.pth"), "--image_size", "64"]
    t_convert.main([*args, "--out", str(ws / "port.npz"), "--device", "cpu"])
    argv = sys.argv
    sys.argv = ["convert_checkpoint.py", *args, "--out", str(ws / "jax.npz")]
    try:
        runpy.run_path(str(ROOT / "convert_checkpoint.py"), run_name="__main__")
    finally:
        sys.argv = argv
    meta = t_convert.template(str(ws / "m.yaml"), torch.device("meta"), 0)
    merged = {**base, **cc}
    _, missing = convert_state_dict(merged, meta)
    # the leaf of the key both dicts hold, as the CC dict's value converts
    (name, value), = convert_state_dict({over: cc[over]}, meta)[0].items()
    return dict(port=read(ws / "port.npz"), jax=read(ws / "jax.npz"),
                missing={m.split(" <- ")[0] for m in missing},
                over=t_io.jax_leaf(name, value))


def test_convert_cli_writes_the_root_clis_keys_and_shapes(converted):
    port, want = converted["port"], converted["jax"]
    assert set(port) == set(want)
    for key, w in want.items():
        assert port[key].shape == w.shape and port[key].dtype == w.dtype, key


def test_convert_cli_converts_as_the_root_cli(converted):
    port, want, missing = converted["port"], converted["jax"], converted["missing"]
    random_lpips = {k for k in want if k.startswith("lpips/")
                    and not k.startswith("lpips/lin")}
    compared = set(want) - missing - random_lpips
    assert "uncond_context" in compared and "lpips/lin4/kernel" in compared
    assert any(k.startswith("clip/") for k in compared)
    assert len(compared) > 0.8 * len(want)
    for key in sorted(compared):
        np.testing.assert_allclose(port[key], want[key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)


def test_the_cc_dict_updates_the_sd_dict(converted):
    key, want = converted["over"]
    np.testing.assert_array_equal(converted["port"][key], want)
