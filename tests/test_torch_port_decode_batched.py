"""`RDEIC.decode_batched`, rdeic_torch against rdeic_tpu on the CPU at the
micro config: B = 5 in chunks of 2 (a ragged tail padded with the first rows
and sliced off), each chunk handed the noise of the JAX key it gets from its
split sequence; `micro >= B` is one `decode_pipeline` call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    ATOL, micro_pair, n, t, one_torch_thread_per_module)

B, MICRO_B, STEPS = 5, 2, 2


@pytest.fixture(scope="module")
def batch():
    jm, params, tm = micro_pair(seed=2)
    rng = np.random.default_rng(6)
    c_latent = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    guide_hint = rng.normal(size=(B, 8, 8, 8)).astype(np.float32)
    return jm, params, tm, c_latent, guide_hint


def chunk_noise(key, b, micro, shape):
    """The noise rdeic_tpu's decode_batched draws: one split of `key` per
    chunk of `micro` rows (pipeline/rdeic.py:530-535), each chunk's key
    through decode_pipeline's draws."""
    out = []
    for _ in range(0, b + (-b) % micro, micro):
        key, sub = jax.random.split(key)
        relay, steps = _jax_noise(sub, (micro, *shape), STEPS)
        out.append({"relay_noise": relay, "step_noise": steps})
    return out


def test_micro_chunks_match_jax(batch):
    jm, params, tm, c_latent, guide_hint = batch
    key = jax.random.PRNGKey(11)
    want = jm.decode_batched(params, jnp.asarray(c_latent),
                             jnp.asarray(guide_hint), key, STEPS,
                             micro=MICRO_B)
    noise = chunk_noise(key, B, MICRO_B, c_latent.shape[1:])
    assert len(noise) == 3  # 5 rows: two chunks and a padded tail
    got = tm.decode_batched(t(c_latent), t(guide_hint), STEPS, micro=MICRO_B,
                            noise=noise)
    assert got.shape == (B, 16, 16, 3)  # the micro VAE upsamples 2x
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def test_each_chunk_is_decode_pipeline_of_its_rows(batch):
    """Chunk by chunk, bit for bit; the padded tail's first row is the
    batch's last."""
    _, _, tm, c_latent, guide_hint = batch
    noise = chunk_noise(jax.random.PRNGKey(12), B, MICRO_B, c_latent.shape[1:])
    got = tm.decode_batched(t(c_latent), t(guide_hint), STEPS, micro=MICRO_B,
                            noise=noise)
    rows = [0, 1, 2, 3, 4, 0]
    for j, k in enumerate(range(0, 6, MICRO_B)):
        idx = rows[k:k + MICRO_B]
        want = tm.decode_pipeline(t(c_latent[idx]), t(guide_hint[idx]), STEPS,
                                  **noise[j])
        cut = want[:B - k] if k + MICRO_B > B else want
        torch.testing.assert_close(got[k:k + MICRO_B], cut, rtol=0, atol=0)


@pytest.mark.parametrize("micro", [None, B, 8])
def test_micro_at_or_past_the_batch_is_the_direct_path(batch, micro):
    jm, params, tm, c_latent, guide_hint = batch
    key = jax.random.PRNGKey(13)
    want = jm.decode_batched(params, jnp.asarray(c_latent),
                             jnp.asarray(guide_hint), key, STEPS, micro=micro)
    relay, steps = _jax_noise(key, c_latent.shape, STEPS)
    noise = [{"relay_noise": relay, "step_noise": steps}]
    got = tm.decode_batched(t(c_latent), t(guide_hint), STEPS, micro=micro,
                            noise=noise)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    direct = tm.decode_pipeline(t(c_latent), t(guide_hint), STEPS,
                                relay_noise=relay, step_noise=steps)
    torch.testing.assert_close(got, direct, rtol=0, atol=0)


def test_a_generator_feeds_the_chunks_in_turn(batch):
    _, _, tm, c_latent, guide_hint = batch
    got = tm.decode_batched(t(c_latent), t(guide_hint), STEPS, micro=MICRO_B,
                            generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    rows = [0, 1, 2, 3, 4, 0]
    want = torch.cat([tm.decode_pipeline(t(c_latent[rows[k:k + 2]]),
                                         t(guide_hint[rows[k:k + 2]]), STEPS,
                                         generator=gen)
                      for k in range(0, 6, 2)])[:B]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="3 chunks"):
        tm.decode_batched(t(c_latent), t(guide_hint), STEPS, micro=MICRO_B,
                          noise=chunk_noise(jax.random.PRNGKey(0), 4, 2,
                                            c_latent.shape[1:]))
