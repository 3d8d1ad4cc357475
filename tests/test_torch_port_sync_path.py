"""`sync_path`, the SD 2.1 torch checkpoint of the training YAMLs, converted by
the port's own key map against rdeic_tpu's `convert_state_dict` on the CPU.

No download: a synthetic SD-keyed state dict holds, for every leaf of the
JAX micro template, a random array in the torch layout under the key the
JAX map gives it. The port's converted tensors must equal the JAX
conversion carried across, bit for bit, with the same `missing` list; with
`sync_control` the control module takes the base UNet's weights, tiled and
truncated. The training CLI's `build_model` converts only when the file
exists and no `resume` is set (train.py's rule), into each parameter's own
dtype. At full width the key map is read on a `meta` port model against
`jax.eval_shape` of the JAX template: nothing is allocated."""
import copy

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.train import cli as torch_train_cli
from rdeic_torch.utils import torch_convert as t_conv
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.utils import torch_convert as j_conv
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, one_torch_thread_per_module)

CONTROL = "control_model.control_model."


def _template(jm, image_hw=(64, 64), include_clip=False):
    return jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=image_hw, include_clip=include_clip),
        jax.random.PRNGKey(0))


def synthetic_sd(jm, template, seed=0, drop=()) -> dict:
    """{SD key: random torch-layout tensor} for every leaf the JAX map
    names, but keys starting with one of `drop`."""
    rng = np.random.default_rng(seed)
    dec_pos = j_conv.dec_upsample_positions(jm)
    sd = {}
    for path, leaf in sorted(flatten_dict(template).items()):
        if path[0] in ("uncond_context", "lpips"):
            continue
        key, transform = j_conv.torch_key_for(path, dec_pos)
        s = tuple(leaf.shape)
        if transform is j_conv._t_conv:
            s = (s[3], s[2], s[0], s[1])
        elif transform is j_conv._t_linear:
            s = (s[1], s[0])
        if not key.startswith(drop):
            sd[key] = torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def micro():
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = _template(jm)
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="meta")
    return jm, template, tm


def _jax_convert(jm, template, sd, sync):
    params, missing = j_conv.convert_state_dict(sd, template, jm,
                                                sync_control=sync)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()
            if not isinstance(v, jax.ShapeDtypeStruct)}
    return load_jax_params(flat), missing


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("drop", [(), (CONTROL,)], ids=["whole", "no_control"])
def test_converted_tensors_and_missing_equal_jax(micro, sync, drop):
    jm, template, tm = micro
    sd = synthetic_sd(jm, template, drop=drop)
    # a DDP checkpoint: nested state_dict, `module.` prefixes
    wrapped = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    want, j_missing = _jax_convert(jm, template, sd, sync)
    used = set()
    got, missing = t_conv.convert_state_dict(wrapped, tm, sync_control=sync,
                                             used_keys=used)
    assert sorted(missing) == sorted(j_missing)
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.dtype == torch.float32
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    n_control = sum(k.startswith("denoiser.control.") for k in got)
    if drop and not sync:
        assert n_control == 0 and any(CONTROL[:-1] in m for m in missing)
    else:
        assert n_control > 0
    assert used <= set(sd)


def test_sync_control_tiles_and_truncates_the_base_weights(micro):
    """A control conv narrower than the base's (ratio 0.5) takes the base
    weight repeated along out and in channels, then cut to its shape."""
    jm, template, tm = micro
    sd = synthetic_sd(jm, template, drop=(CONTROL,))
    got, _ = t_conv.convert_state_dict(sd, tm, sync_control=True)
    name = "denoiser.control.in_1.res.in_conv.Conv_0.weight"
    base = sd["model.diffusion_model.input_blocks.1.0.in_layers.2.weight"]
    want_shape = tuple(tm.state_dict()[name].shape)
    assert base.shape != want_shape
    want = base.numpy()
    for dim in (0, 1):
        reps = [1] * 4
        reps[dim] = -(-want_shape[dim] // want.shape[dim])
        want = np.take(np.tile(want, reps), range(want_shape[dim]), axis=dim)
    np.testing.assert_array_equal(got[name].numpy(), want)
    assert t_conv._tile_truncate(np.zeros((3, 5)), (2, 4, 1)) is None


def test_the_upsample_positions_follow_the_port_unet(micro):
    jm, _, tm = micro
    assert t_conv.dec_upsample_positions(tm) == j_conv.dec_upsample_positions(jm)


def test_full_width_key_map_on_meta_equals_jax():
    """Every leaf of the full-width model with its CLIP tower: the same
    paths and shapes as the JAX template, and the same SD key for each (the
    `missing` list of an empty checkpoint names each leaf with its key)."""
    jm = JaxRDEIC()
    template = _template(jm, include_clip=True)
    tm = TorchRDEIC(device="meta")
    tm.attach_clip()
    flax_shapes = {"/".join(k): tuple(v.shape)
                   for k, v in flatten_dict(template).items()}
    port_shapes = {}
    for name, tensor in tm.state_dict(keep_vars=True).items():
        assert tensor.device.type == "meta"
        path, shape = t_conv.flax_path(name, tensor)
        port_shapes["/".join(path)] = shape
    assert port_shapes == flax_shapes
    _, j_missing = j_conv.convert_state_dict({}, template, jm)
    _, missing = t_conv.convert_state_dict({}, tm)
    assert sorted(missing) == sorted(j_missing)
    assert len(missing) == len(flax_shapes) - 1  # uncond_context is kept
    assert all(" <- " in m for m in missing)


# -- the training CLI ---------------------------------------------------------
def _cfg(tmp_path, overrides, resume=None, trainer=None) -> dict:
    model = tmp_path / "model.yaml"
    model.write_text(yaml.safe_dump({"target": "rdeic_tpu.pipeline.rdeic.RDEIC",
                                     "params": copy.deepcopy(MICRO)}))
    cfg = {"model": {"config": str(model), "overrides": overrides},
           "trainer": trainer or {}}
    if resume is not None:
        cfg["model"]["resume"] = resume
    return cfg


@pytest.fixture(scope="module")
def sd_file(tmp_path_factory, micro):
    jm, template, _ = micro
    sd = synthetic_sd(jm, template, seed=1, drop=(CONTROL,))
    path = tmp_path_factory.mktemp("sd") / "v2-1_512-ema-pruned.ckpt"
    torch.save({"state_dict": sd, "global_step": 3}, path)
    want, missing = _jax_convert(jm, template, sd, sync=True)
    return path, want, missing


def _build(cfg):
    torch.manual_seed(0)
    return torch_train_cli.build_model(cfg, torch.device("cpu"))


def test_build_model_converts_an_existing_file(tmp_path, sd_file, capsys):
    path, want, missing = sd_file
    model = _build(_cfg(tmp_path, {"sync_path": str(path),
                                   "synch_control": True}))
    assert (f"[synced base weights from {path}; {len(missing)} keys stay "
            "random]") in capsys.readouterr().out
    state = model.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0, msg=key)
    fresh = _build(_cfg(tmp_path, {})).state_dict()
    kept = set(state) - set(want)
    assert kept and all(torch.equal(state[k], fresh[k]) for k in kept)


def test_build_model_converts_into_each_parameters_dtype(tmp_path, sd_file):
    """The repo's bf16 recipe: `fast_init` on meta with the frozen tensors
    made in bf16, then the conversion into them, rounded once."""
    path, want, _ = sd_file
    model = _build(_cfg(tmp_path, {"sync_path": str(path),
                                   "synch_control": True},
                        trainer={"frozen_dtype": "bfloat16", "fast_init": True}))
    state = model.state_dict()
    assert state["denoiser.base.out_conv.weight"].dtype == torch.bfloat16
    assert state["denoiser.control.in_1.res.in_conv.Conv_0.weight"].dtype == torch.float32
    for key, value in want.items():
        torch.testing.assert_close(state[key], value.to(state[key].dtype),
                                   rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("case", ["absent", "resume"])
def test_build_model_skips_an_absent_file_or_a_resumed_run(tmp_path, sd_file,
                                                           capsys, case):
    path = tmp_path / "absent.ckpt" if case == "absent" else sd_file[0]
    resume = str(tmp_path / "runs" / "checkpoints") if case == "resume" else None
    model = _build(_cfg(tmp_path, {"sync_path": str(path)}, resume=resume))
    assert "synced" not in capsys.readouterr().out
    fresh = _build(_cfg(tmp_path, {}, resume=resume)).state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, fresh[key]), key
