"""The port's image listing and training dataset against the reference's,
and the port's refusals naming the ROADMAP item that brings each feature.

`rdeic_torch.inference.list_images` lists what the root `inference.py`
lists (`rdeic_tpu.data.dataset.list_image_files`), and
`rdeic_torch.data.dataset.LICDataset` caches decoded images as the
reference's does (`cache_size`, which the repo's dataset YAMLs set).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from rdeic_torch import inference as torch_inference
from rdeic_torch.data import dataset as torch_dataset
from rdeic_torch.data.dataset import LICDataset, list_image_files
from rdeic_torch.registry import instantiate_from_config
from rdeic_torch.train import cli as torch_train_cli
from rdeic_tpu.data import dataset as tpu_dataset
from tests.torch_port_helpers import MICRO

ROOT = Path(__file__).resolve().parents[1]


def _image(path: Path, seed: int, hw=(40, 48)) -> None:
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(path)


def test_list_images_lists_what_the_reference_cli_lists(tmp_path):
    """A nested directory, a .tif, an upper-case .PNG and a non-image file:
    the same files in the same order as the reference; a file path is taken
    as it is."""
    for i, rel in enumerate(("b.png", "a.jpg", "sub/deeper/c.webp", "sub/D.PNG",
                             "e.tif", "sub/f.jpeg", "z.bmp")):
        _image(tmp_path / rel, i)
    (tmp_path / "notes.txt").write_text("not an image")
    (tmp_path / "dir.png").mkdir()  # a directory with an image suffix
    got = torch_inference.list_images(tmp_path)
    want = tpu_dataset.list_image_files(str(tmp_path))
    assert got == want
    assert got == list_image_files(str(tmp_path))
    names = [Path(p).relative_to(tmp_path).as_posix() for p in got]
    assert names == ["a.jpg", "b.png", "sub/D.PNG", "sub/deeper/c.webp",
                     "sub/f.jpeg", "z.bmp"]
    assert torch_inference.list_images(tmp_path / "e.tif") == [
        str(tmp_path / "e.tif")]


def _file_list(tmp_path, n=3) -> str:
    paths = [tmp_path / f"img{i}.png" for i in range(n)]
    for i, p in enumerate(paths):
        _image(p, 10 + i, hw=(40 + 4 * i, 48))
    listing = tmp_path / "train.list"
    listing.write_text("\n".join(str(p) for p in paths) + "\n")
    return str(listing)


def test_licdataset_cache_matches_the_reference(tmp_path):
    """cache_size=2 on three images, the same seed: identical items, the
    same first-in first-out eviction at the cap, and a cached image served
    after its file is deleted."""
    listing = _file_list(tmp_path)
    kw = dict(out_size=32, crop_type="random", use_hflip=True, seed=3,
              cache_size=2)
    port, ref = LICDataset(listing, **kw), tpu_dataset.LICDataset(listing, **kw)
    for idx in (0, 1, 2, 0, 2):
        a, b = port[idx], ref[idx]
        assert a["txt"] == b["txt"] == ""
        np.testing.assert_array_equal(a["jpg"], b["jpg"])
        assert list(port._cache) == list(ref._cache)
        assert len(port._cache) <= 2
    assert list(port._cache) == [port.paths[2], port.paths[0]]
    Path(port.paths[2]).unlink()
    np.testing.assert_array_equal(port[2]["jpg"], ref[2]["jpg"])


def test_licdataset_without_cache_keeps_nothing(tmp_path):
    listing = _file_list(tmp_path, n=2)
    kw = dict(out_size=32, crop_type="center", seed=5)
    port, ref = LICDataset(listing, **kw), tpu_dataset.LICDataset(listing, **kw)
    for idx in (0, 1, 0):
        np.testing.assert_array_equal(port[idx]["jpg"], ref[idx]["jpg"])
    assert port.cache_size == 0 and port._cache == {}


@pytest.mark.parametrize("name", ["lic_train_v5e.yaml",
                                  "lic_train_refine_v5e.yaml",
                                  "lic_train_refine_b4.yaml"])
def test_dataset_yamls_with_cache_size_build(tmp_path, name):
    cfg = yaml.safe_load((ROOT / "configs" / "dataset" / name).read_text())
    assert cfg["dataset"]["params"]["cache_size"] == 64
    cfg["dataset"]["params"]["file_list"] = _file_list(tmp_path, n=2)
    cfg["dataset"]["params"]["out_size"] = 32
    ds = instantiate_from_config(cfg["dataset"])
    assert isinstance(ds, LICDataset) and ds.cache_size == 64
    assert ds[1]["jpg"].shape == (32, 32, 3)


@pytest.mark.parametrize("seed", [None, 7])
def test_train_loader_gives_the_reference_batches(tmp_path, seed):
    """rdeic_torch's and rdeic_tpu's DataModule, built from one YAML, give
    the same `jpg` batches in the same order over two epochs, with
    `data_loader.seed` set and left at its default (0). Five images in
    batches of two: each epoch drops the fifth, another one each time."""
    loader = {"batch_size": 2, "shuffle": True, "drop_last": True}
    if seed is not None:
        loader["seed"] = seed
    config = tmp_path / "data.yaml"
    config.write_text(yaml.safe_dump({
        "dataset": {"target": "rdeic_tpu.data.dataset.LICDataset",
                    "params": {"file_list": _file_list(tmp_path, n=5),
                               "out_size": 32, "crop_type": "random",
                               "use_hflip": True, "seed": 3}},
        "data_loader": loader}))
    port = torch_dataset.DataModule(train_config=str(config)).train_dataloader()
    ref = tpu_dataset.DataModule(train_config=str(config)).train_dataloader()
    assert len(port) == len(ref) == 2
    for _ in range(2):
        got = [batch["jpg"].numpy() for batch in port]
        want = [batch["jpg"] for batch in ref]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_no_message_names_a_roadmap_item_by_number():
    """Item numbers move at every re-anchor of ROADMAP.md; messages name the
    item by its subject."""
    stale = re.compile(r"Queue \d+ item \d+")
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted((ROOT / "rdeic_torch").rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if stale.search(line)]
    assert hits == []


@pytest.mark.parametrize("argv,item", [
    (["--sampler", "ddim"], "DDIM and CFG"),
    (["--guidance_scale", "3.0"], "DDIM and CFG"),
    (["--bf16"], "bf16"),
])
def test_inference_cli_refusals_name_the_item(tmp_path, argv, item):
    """The flags that waited for the ROADMAP item `item` are accepted now:
    with each, the CLI gets as far as the one refusal left, a checkpoint
    directory without a `step_N.pt` (here an orbax `step_3` directory of the
    JAX package), which names its own item."""
    (tmp_path / "step_3").mkdir()
    with pytest.raises(NotImplementedError,
                       match=re.escape("ROADMAP Queue 1, the rest")) as exc:
        torch_inference.main(["--ckpt", str(tmp_path), "--input", str(tmp_path),
                              "--output", str(tmp_path / "out"),
                              "--device", "cpu", *argv])
    assert item not in str(exc.value)


# the repo's bf16 recipe keys (compute_dtype, frozen_dtype, fast_init) are
# accepted: with them the CLI gets as far as the refusal a model override
# asks for
BF16_RECIPE = {"compute_dtype": "bfloat16", "frozen_dtype": "bfloat16",
               "fast_init": True}


class _PastBuildModel(Exception):
    """Raised where the CLI, past `build_model`, builds the trainer."""


@pytest.mark.parametrize("trainer,overrides,item", [
    ({"mesh": {"dp": 2}}, {}, "multi-device"),
    ({}, {"sync_path": "sd21.ckpt"}, "training settings"),
    ({}, {"parameterization": "x0"}, "training settings"),
    ({}, {"parameterization": "v"}, "training settings"),
    (BF16_RECIPE, {"sync_path": "sd21.ckpt"}, "training settings"),
    (BF16_RECIPE, {"parameterization": "v"}, "training settings"),
])
def test_train_cli_refusals_name_the_item(tmp_path, monkeypatch, trainer,
                                          overrides, item):
    """`trainer.mesh` above one device is multi-device training now: in one
    plain process (a world of one) `dp: 2` is refused by make_mesh's
    ValueError, as train.py's `make_mesh` refuses more dp than devices, and
    no ROADMAP item is named (torchrun's ranks run it:
    test_torch_port_ddp_cli.py). The "training settings" are accepted
    too: with each (`sync_path` naming an absent file, which train.py
    skips, or the `x0` / `v` loss) the CLI gets past `build_model` to the
    trainer, with the setting in the model."""
    model = tmp_path / "model.yaml"
    model.write_text(yaml.safe_dump({
        "target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    config = tmp_path / "train.yaml"
    config.write_text(yaml.safe_dump({
        "model": {"config": str(model), "overrides": overrides},
        "trainer": trainer}))
    argv = ["--config", str(config), "--device", "cpu"]
    if item == "multi-device":
        with pytest.raises(ValueError,
                           match=re.escape("dp*tp=2 != #devices=1")) as exc:
            torch_train_cli.main(argv)
        assert "ROADMAP" not in str(exc.value)
        return
    if item != "training settings":
        with pytest.raises(NotImplementedError,
                           match=re.escape(f"ROADMAP Queue 1, {item}")):
            torch_train_cli.main(argv)
        return
    built = []

    def trainer_after_build(model, **_):
        built.append(model)
        raise _PastBuildModel

    monkeypatch.setattr(torch_train_cli, "Trainer", trainer_after_build)
    with pytest.raises(_PastBuildModel):
        torch_train_cli.main(argv)
    assert built[0].parameterization == overrides.get("parameterization", "eps")

