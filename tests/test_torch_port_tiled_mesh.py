"""Tiled serving over a data-parallel mesh (`tiled_inference --use_mesh`)
against rdeic_tpu.pipeline.tiled with `make_mesh(dp=2)` over two of the
8 virtual host devices, on the CPU at the micro width: a JAX-written v2
stream of 15 tiles decoded in tile batches of 4, so the last batch of 3 is
padded to 4 by repeating its last tile; each batch's noise is JAX's split at the
padded size (JAX draws it inside the jitted decode at the padded shape);
two port replicas (both on the CPU) decode half a batch each from a thread
each. The image is within the tiled tolerance (2e-4) of JAX's; each batch's
real tiles are `decode_pipeline` of the padded batch's rows to 1e-5 (a
replica decodes half the rows); a mesh of one device pads nothing and is
the run without it, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from rdeic_torch.pipeline import tiled as tt
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.pipeline import tiled as jt
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    micro_pair, one_torch_thread_per_module)

STEPS, TILE_BATCH, DP = 2, 4, 2


def _padded_noise(key, n, shape):
    """JAX's draws: a split of `key` per tile batch, each batch's key through
    decode_pipeline's draws at the batch's size padded to a multiple of DP."""
    out = []
    for a, b in tt.tile_batches(n, TILE_BATCH):
        key, sub = jax.random.split(key)
        padded = b - a + (-(b - a)) % DP
        relay, steps = _jax_noise(sub, (padded, *shape), STEPS)
        out.append({"relay_noise": relay, "step_noise": steps})
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    jm, params, tm = micro_pair(seed=0)
    tmp = tmp_path_factory.mktemp("tiled_mesh")
    img = np.random.default_rng(5).uniform(size=(1, 96, 160, 3)).astype(
        np.float32)
    path = str(tmp / "jax.rdeic")
    jt.tiled_compress_xctx(jm, params, img, path, tile=64, overlap=32)
    key = jax.random.PRNGKey(9)
    mesh = j_make_mesh(dp=DP, tp=1, devices=jax.devices()[:DP])
    want = np.asarray(jt.tiled_decompress_decode(
        jm, params, path, key, steps=STEPS, tile_batch=TILE_BATCH, mesh=mesh))
    strings, zshape = tt.read_tiled(path)
    cl, gh, *_ = tt.decode_tile_latents(tm, strings, zshape)
    noise = _padded_noise(key, cl.shape[0], tuple(cl.shape[1:]))
    tm._codec = None
    return dict(tm=tm, path=path, want=want, cl=cl, gh=gh, noise=noise)


def test_mesh_decode_matches_jax_under_its_mesh(mesh_run):
    tm = mesh_run["tm"]
    assert mesh_run["cl"].shape[0] == 15  # batches of 4, 4, 4, 3: one padded
    got = tt.tiled_decompress_decode(tm, mesh_run["path"], steps=STEPS,
                                     tile_batch=TILE_BATCH,
                                     noise=mesh_run["noise"],
                                     replicas=[tm, tm])
    assert got.shape == mesh_run["want"].shape
    np.testing.assert_allclose(got.numpy(), mesh_run["want"], atol=2e-4)


def test_each_padded_batch_is_one_decode_of_its_rows(mesh_run):
    tm, cl, gh, noise = (mesh_run[k] for k in ("tm", "cl", "gh", "noise"))
    recon = tt._batched_tile_decode(tm, cl, gh, STEPS, "ddpm", TILE_BATCH,
                                    noise, None, replicas=[tm, tm])
    for j, (a, b) in enumerate(tt.tile_batches(cl.shape[0], TILE_BATCH)):
        pad = (-(b - a)) % DP
        rows = [cl[a:b], gh[a:b]]
        if pad:
            rows = [torch.cat([r, r[-1:].repeat(pad, 1, 1, 1)]) for r in rows]
        alone = tm.decode_pipeline(*rows, STEPS, **noise[j])[:b - a]
        torch.testing.assert_close(recon[a:b], alone, rtol=0, atol=1e-5)


def test_one_device_mesh_is_the_run_without_it(mesh_run):
    tm = mesh_run["tm"]
    runs = [tt.tiled_decompress_decode(
        tm, mesh_run["path"], steps=STEPS, tile_batch=TILE_BATCH,
        generator=torch.Generator().manual_seed(2), replicas=replicas)
        for replicas in ([tm], [])]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
