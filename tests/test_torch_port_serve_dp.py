"""`python -m rdeic_torch.inference_partition --dp 2` on the CPU: two model
replicas (both on the CPU, where JAX's host devices stand) serve each
micro-batch's rows from a thread each. The streams are byte-equal to
`--dp 1`'s and to the root inference_partition.py's at `--dp 2` (8 host
devices); the reconstructions within 1e-5 of `--dp 1`'s (each replica
decodes half the rows: a library convolution may sum in another order at
another batch size); a chunk's ragged tail micro-batch runs on one device,
with the root CLI's message; a micro-batch that --dp does not divide is
refused; `sample_stage` over two replicas draws each micro-batch's noise
as one process does."""
import copy
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rdeic_torch import inference as t_inference
from rdeic_torch import inference_partition as t_partition
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, one_torch_thread_per_module, random_flat_params)

ROOT = Path(__file__).resolve().parents[1]
# (name, H, W): a and b share a padded size (a micro-batch of 2, split over
# the replicas), d and c are alone (tails of 1)
IMAGES = [("a", 49, 77), ("b", 40, 70), ("c", 70, 60), ("d", 64, 100)]
ARGS = ["--steps", "2", "--batch_size", "2", "--micro_batch_size", "2",
        "--seed", "5"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("serve_dp")
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
    for dp in (1, 2):
        t_partition.main([*_common(ws, f"dp{dp}"), "--dp", str(dp),
                          "--device", "cpu"])
    old = sys.argv
    try:
        sys.argv = ["inference_partition.py", *_common(ws, "jax"),
                    "--dp", "2", "--platform", "cpu"]
        runpy.run_path(str(ROOT / "inference_partition.py"),
                       run_name="__main__")
    finally:
        sys.argv = old


def test_streams_are_dp1s_and_the_root_clis(ws, runs):
    for name, _, _ in IMAGES:
        got = (ws / "dp2" / "bitstreams" / f"{name}.rdeic").read_bytes()
        assert got == (ws / "dp1" / "bitstreams" / f"{name}.rdeic").read_bytes()
        assert got == (ws / "jax" / "bitstreams" / f"{name}.rdeic").read_bytes()


def test_reconstructions_are_dp1s(ws, runs):
    """The PNGs: uint8 roundings of images within 1e-5 (as
    test_sample_stage_over_two_replicas holds them), so at most 1 apart."""
    for name, h, w in IMAGES:
        got = np.array(Image.open(ws / "dp2" / f"{name}.png")).astype(int)
        want = np.array(Image.open(ws / "dp1" / f"{name}.png")).astype(int)
        assert got.shape == (h, w, 3)
        assert np.abs(got - want).max() <= 1, name


def test_sample_stage_over_two_replicas(ws, capsys):
    """A chunk of 3 in micro-batches of 2: the first split over the two
    replicas, within 1e-5 of one process's; the tail of 1 on the first
    replica, bit-equal to one process's, with the root CLI's message."""
    model = t_inference.load_model(str(ws / "m.yaml"), str(ws / "p.npz"),
                                   torch.device("cpu"))
    rng = np.random.default_rng(7)
    c_latent = torch.from_numpy(rng.normal(size=(3, 8, 8, 4)).astype(np.float32))
    guide = torch.from_numpy(
        rng.normal(size=(3, 8, 8, 8)).astype(np.float32))
    opts = dict(steps=2, micro=2)
    want = t_partition.sample_stage(model, c_latent, guide,
                                    generator=torch.Generator().manual_seed(3),
                                    **opts)
    got = t_partition.sample_stage(model, c_latent, guide,
                                   generator=torch.Generator().manual_seed(3),
                                   replicas=[model, copy.deepcopy(model)],
                                   **opts)
    assert "[dp] tail micro-batch of 1 not divisible by --dp 2" in \
        capsys.readouterr().out
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2:], want[2:], rtol=0, atol=0)


def test_micro_batch_that_dp_does_not_divide_is_refused(ws):
    with pytest.raises(ValueError, match="must divide by --dp 2"):
        t_partition.main([*_common(ws, "odd"), "--micro_batch_size", "1",
                          "--dp", "2", "--device", "cpu"])
