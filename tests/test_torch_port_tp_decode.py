"""Serving under tensor-parallel weights (the counterpart of
__graft_entry__.py's `_dryrun_sharded_decode`): a micro RDEIC after
`shard_params` on four gloo processes, dp = 2 x tp = 2, decodes a batch
of 2 with the relay sampler and the VAE, each dp row its row and the two
tp ranks of a row the same one, against JAX's `jitted_decode` under
`shard_params` on a 2 x 2 mesh with the batch on "dp", given the JAX
draws as noise: within ATOL (2e-4, the fp32 module parity of
tests/test_torch_parity.py); the tp ranks of a row bit-equal. Under the
same sharded weights every rank codes an image to the stream the
unsharded port writes, byte for byte, and decodes it back to the same
latents (the compression model holds no sharded leaf)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_tpu.parallel.mesh import batch_sharding
from rdeic_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdeic_tpu.parallel.mesh import shard_params as j_shard_params
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_dist import Workers
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    ATOL, MICRO, micro_pair, n, one_torch_thread_per_module, t)

DP, TP, B, STEPS = 2, 2, 2, 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, params, tm = micro_pair(seed=4)
    rng = np.random.default_rng(6)
    c_latent = rng.normal(size=(B, 16, 16, 4)).astype(np.float32)
    guide_hint = rng.normal(size=(B, 16, 16, 8)).astype(np.float32)
    img01 = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    relay, steps = _jax_noise(key, c_latent.shape, STEPS)
    work = tmp_path_factory.mktemp("tp_decode")
    torch.save(dict(config=copy.deepcopy(MICRO), state=tm.state_dict(),
                    dp=DP, tp=TP, img01=t(img01),
                    decode=dict(c_latent=t(c_latent), guide_hint=t(guide_hint),
                                steps=STEPS, noise=dict(relay_noise=relay,
                                                        step_noise=steps))),
               work / "inputs.pt")
    ranks = Workers("tp", work, world=DP * TP)
    path = work / "unsharded.rdeic"
    tm.apply_condition_compress(t(img01), path, 64, 64)
    mesh = j_make_mesh(dp=DP, tp=TP, devices=jax.devices()[:DP * TP])
    sharded = j_shard_params(params, mesh)
    cl, gh = (jax.device_put(jnp.asarray(x), batch_sharding(mesh))
              for x in (c_latent, guide_hint))
    with mesh:
        want = jm.jitted_decode(steps=STEPS)(sharded, cl, gh, key)
    return dict(ranks=ranks.results(), want=np.asarray(want),
                stream=path.read_bytes(),
                latents=tm.apply_condition_decompress(path))


def test_tp_ranks_of_a_row_decode_the_same_rows(run):
    ranks = run["ranks"]
    for r in range(0, DP * TP, TP):
        assert run["ranks"][r]["blocks"]
        for other in ranks[r + 1:r + TP]:
            assert torch.equal(ranks[r]["decode"], other["decode"])


def test_decode_matches_jax_under_shard_params(run):
    got = torch.cat([run["ranks"][r]["decode"] for r in range(0, DP * TP, TP)])
    assert got.shape == run["want"].shape == (B, 32, 32, 3)
    np.testing.assert_allclose(n(got), run["want"], atol=ATOL)


def test_the_codec_under_sharded_weights_writes_the_unsharded_stream(run):
    for rank in run["ranks"]:
        assert rank["stream"] == run["stream"]
        for got, want in zip(rank["latents"], run["latents"]):
            assert torch.equal(got, want)
