"""`python -m rdeic_torch.inference_partition` on the CPU against the root
inference_partition.py: a mixed-size directory and a JAX micro `.npz` give
the same PNG names, the same CSV columns and rows, and each stream file the
one `rdeic_torch.inference.process` writes for that image alone (and the
root CLI writes); the threaded codec stage writes and decodes what a serial
run does; captions without a local VLM fall back to empty prompts through
the CLIP tower; `--dp 2` with a micro-batch it does not divide is
refused."""
import copy
import csv
import gzip
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from PIL import Image

from rdeic_torch import inference as t_inference
from rdeic_torch import inference_partition as t_partition
from rdeic_torch.utils.image import pad, to_float01
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.utils.checkpoint_io import save_params_npz
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, random_flat_params, random_leaf, unflatten, one_torch_thread_per_module)

ROOT = Path(__file__).resolve().parents[1]
# (name, H, W): two padded sizes in one chunk of 2 and a tail, one alone
IMAGES = [("a", 49, 77), ("b", 40, 70), ("c", 70, 60), ("d", 64, 100)]
ARGS = ["--steps", "2", "--batch_size", "2", "--micro_batch_size", "1",
        "--seed", "5"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("partition")
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    np.savez(ws / "p.npz", **random_flat_params(jm, (64, 64), seed=1))
    (ws / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    rng = np.random.default_rng(2)
    (ws / "in").mkdir()
    for name, h, w in IMAGES:
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            ws / "in" / f"{name}.png")
    return ws


def _common(ws, out):
    return ["--ckpt", str(ws / "p.npz"), "--config", str(ws / "m.yaml"),
            "--input", str(ws / "in"), "--output", str(ws / out), *ARGS]


@pytest.fixture(scope="module")
def runs(ws):
    old = sys.argv
    try:
        sys.argv = ["inference_partition.py", *_common(ws, "jax"),
                    "--platform", "cpu"]
        runpy.run_path(str(ROOT / "inference_partition.py"), run_name="__main__")
    finally:
        sys.argv = old
    t_partition.main([*_common(ws, "torch"), "--device", "cpu"])
    return ws / "jax", ws / "torch"


def _csv(path: Path):
    with (path / "metrics.csv").open() as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_same_pngs_and_csv_columns_as_the_root_cli(runs):
    jax_out, torch_out = runs
    names = sorted(p.name for p in torch_out.glob("*.png"))
    assert names == sorted(p.name for p in jax_out.glob("*.png")) == \
        [f"{n}.png" for n, _, _ in IMAGES]
    for name, h, w in IMAGES:
        assert np.array(Image.open(torch_out / f"{name}.png")).shape == (h, w, 3)
    cols, rows = _csv(torch_out)
    j_cols, j_rows = _csv(jax_out)
    assert cols == j_cols == ["name", "bpp", "psnr", "ms_ssim", "lpips",
                              "time", "caption"]
    # chunks group by group, in the order each group's first image comes:
    # a, b, then d (64x128), then c (128x64)
    assert [r["name"] for r in rows] == [r["name"] for r in j_rows]
    for r, jr in zip(rows, j_rows):
        assert float(r["bpp"]) == float(jr["bpp"])  # the same stream sizes
        assert r["ms_ssim"] == "nan" and r["caption"] == ""


def test_streams_are_process_streams_and_the_root_clis(runs, ws, tmp_path):
    jax_out, torch_out = runs
    model = t_inference.load_model(str(ws / "m.yaml"), str(ws / "p.npz"),
                                   torch.device("cpu"))
    for name, _, _ in IMAGES:
        arr = np.array(Image.open(ws / "in" / f"{name}.png"))
        img01 = torch.from_numpy(to_float01(pad(arr, 64))[None])
        stream = tmp_path / f"{name}.rdeic"
        t_inference.process(model, img01, 2, str(stream),
                            torch.Generator().manual_seed(0))
        got = (torch_out / "bitstreams" / f"{name}.rdeic").read_bytes()
        assert got == stream.read_bytes(), name
        assert got == (jax_out / "bitstreams" / f"{name}.rdeic").read_bytes(), name


def test_threaded_serving_equals_a_serial_run(ws, tmp_path):
    model = t_inference.load_model(str(ws / "m.yaml"), str(ws / "p.npz"),
                                   torch.device("cpu"))
    items = [(name, pad(np.array(Image.open(ws / "in" / f"{name}.png")), 64))
             for name, _, _ in IMAGES]
    chunks = t_partition.make_chunks(items, 2)
    assert [[n for n, _ in c] for c in chunks] == [["a", "b"], ["d"], ["c"]]
    (tmp_path / "threaded").mkdir()
    (tmp_path / "serial").mkdir()
    got = list(t_partition.serve(model, chunks, tmp_path / "threaded", steps=2,
                                 micro=1,
                                 generator=torch.Generator().manual_seed(4)))
    gen = torch.Generator().manual_seed(4)
    for (chunk, out, bpps, _), want_chunk in zip(got, chunks):
        assert chunk is want_chunk
        w_bpps, c_latent, guide_hint = t_partition.codec_stage(
            model, chunk, tmp_path / "serial")
        assert bpps == w_bpps
        want = t_partition.sample_stage(model, c_latent, guide_hint, steps=2,
                                        micro=1, generator=gen)
        np.testing.assert_array_equal(out, want.numpy())
        for name, _ in chunk:
            assert ((tmp_path / "threaded" / f"{name}.rdeic").read_bytes()
                    == (tmp_path / "serial" / f"{name}.rdeic").read_bytes())


def test_captions_fall_back_to_empty_prompts_through_clip(ws, tmp_path, capsys):
    """With --use_captions and a merges file, a weights file with a CLIP
    tower conditions on CLIP of the (empty) captions; no local VLM, so the
    JAX CLI's fallback line."""
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=(64, 64), include_clip=True),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    flat = {"/".join(k): random_leaf("/".join(k), v.shape, rng)
            for k, v in sorted(flatten_dict(template).items())}
    save_params_npz(str(tmp_path / "clip.npz"), unflatten(flat))
    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wb") as f:
        f.write(b"header\nt h\nth e</w>\n")
    (tmp_path / "one").mkdir()
    Image.open(ws / "in" / "a.png").save(tmp_path / "one" / "a.png")
    t_partition.main([
        "--ckpt", str(tmp_path / "clip.npz"), "--config", str(ws / "m.yaml"),
        "--input", str(tmp_path / "one"), "--output", str(tmp_path / "out"),
        "--use_captions", "--caption_model", str(tmp_path / "no_vlm"),
        "--bpe_vocab", str(vocab), "--device", "cpu", *ARGS])
    printed = capsys.readouterr().out
    assert "[captioning unavailable: " in printed
    assert re.search(r"averages: bpp=[\d.]+, psnr=[\d.]+, ms_ssim=nan, "
                     r"lpips=[\d.]+, time=[\d.]+", printed)
    assert np.array(Image.open(tmp_path / "out" / "a.png")).shape == (49, 77, 3)


def test_dp_is_refused_naming_multi_device(ws, tmp_path):
    """`--dp 2` is data-parallel serving now (test_torch_port_serve_dp.py);
    what stays refused is the root CLI's assertion, a micro-batch (here 1)
    that --dp does not divide, and no ROADMAP item is named."""
    with pytest.raises(ValueError,
                       match=re.escape("--micro_batch_size 1 must divide by "
                                       "--dp 2")) as exc:
        t_partition.main([*_common(ws, "dp"), "--dp", "2", "--device", "cpu"])
    assert "multi-device" not in str(exc.value)


def test_full_fp32_holds_while_any_thread_holds_a_scope():
    """The numerics flags are the process's: when the sampler's scope opens
    first, the codec's opens in its thread, and the sampler's closes while
    the codec is still inside, TF32 stays off and the deterministic choice
    on for the codec; the flags from before come back when the last scope
    closes. (Saving and restoring per scope turned TF32 back on there.)"""
    import threading

    from rdeic_torch.utils.backend import full_fp32

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
              matmul.allow_tf32)
    cudnn.allow_tf32, cudnn.benchmark, matmul.allow_tf32 = True, True, True
    inside, release, seen = threading.Event(), threading.Event(), []

    def codec():
        with full_fp32(deterministic=True):
            inside.set()
            release.wait(10)
            seen.append((cudnn.allow_tf32, cudnn.deterministic,
                         cudnn.benchmark, matmul.allow_tf32))

    try:
        worker = threading.Thread(target=codec)
        with full_fp32():  # the sampler's scope, opened first
            worker.start()
            assert inside.wait(10)
        release.set()  # the codec reads the flags after the sampler's exit
        worker.join(10)
        assert seen == [(False, True, False, False)]
        assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
                matmul.allow_tf32) == (True, before[1], True, True)
    finally:
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32) = before
