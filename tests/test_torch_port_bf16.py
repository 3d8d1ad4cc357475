"""bf16 serving, rdeic_torch against rdeic_tpu on the CPU: the tensors
`set_compute_dtype` casts are the ones the JAX package's
`cast_inference_params` casts; the compression model and the codec stay fp32
(a bf16 encoder's feature codes to the JAX coder's bytes, and a stream
written under fp32 decodes to the same latents under bf16, bit for bit); the
bf16 decode agrees with JAX's bf16 `jitted_decode` within a bf16 tolerance
that a planted x1.05 fault reads outside of."""
import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.models.vae import Normalize
from rdeic_torch.ops.fused_groupnorm import group_norm_plain
from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils.bitstream import write_body
from rdeic_torch.utils.convert import convert_leaf, load_jax_params
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.torch_port_helpers import (
    MICRO,
    micro_pair,
    n,
    random_flat_params,
    t,
    unflatten,
)

LATENT = (1, 16, 16, 4)
# A bf16 result rounds every layer's output to 8 significant bits; XLA on
# the CPU also skips some roundings inside its fusions (excess precision), so
# the two bf16 runs round at different places and each lands up to ~2^-7 of
# max from the fp32 result (1.0-1.1e-2 here). A bf16 run is held to the
# fp32 result at 2^-6 of max, and the two bf16 runs to each other at twice
# that, 2^-5; a x1.05 fault reads ~5e-2 against either.
BF16_TOL = 2.0 ** -6
BF16_PAIR_TOL = 2.0 ** -5
FAULT_SCALE = 1.05


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("is_refine", [False, True])
def test_cast_set_equals_the_jax_rule(is_refine):
    """Every tensor `set_compute_dtype(bf16)` casts is a leaf that
    `cast_inference_params` casts, and the reverse (CLIP aside: the port
    builds none); every other tensor stays fp32."""
    cfg = dict(copy.deepcopy(MICRO), is_refine=is_refine)
    jm = JaxRDEIC(**copy.deepcopy(cfg))
    flat = random_flat_params(jm, (64, 64))
    cast = flatten_dict(JaxRDEIC.cast_inference_params(unflatten(flat)))
    want = {convert_leaf("/".join(k), np.zeros(v.shape))[0]
            for k, v in cast.items() if v.dtype == jnp.bfloat16}
    tm = TorchRDEIC(**cfg, device="cpu")
    tm.load_state_dict(load_jax_params(flat), strict=True)
    tm.set_compute_dtype(torch.bfloat16)
    state = tm.state_dict()
    got = {k for k, v in state.items() if v.dtype == torch.bfloat16}
    assert got == want
    assert {k for k, v in state.items() if v.dtype == torch.float32} == \
        set(state) - got
    assert not any(k.startswith(("compression.", "vq_embed_prob")) for k in got)
    assert any(k.startswith("lpips.") for k in got) == is_refine


@pytest.fixture(scope="module")
def pairs():
    """(jax model, fp32 params, bf16 params, torch fp32 model, torch bf16
    model), both torch models from the same weights."""
    jm, params, tm32 = micro_pair(seed=3)
    _, _, tm16 = micro_pair(seed=3)
    tm16.set_compute_dtype(torch.bfloat16)
    jm.set_compute_dtype(jnp.bfloat16)
    return jm, params, JaxRDEIC.cast_inference_params(params), tm32, tm16


def _image(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)


def _bytes(out) -> bytes:
    buf = io.BytesIO()
    write_body(buf, out["shape"], out["strings"])
    return buf.getvalue()


def test_bf16_encoder_feature_codes_to_the_jax_bytes(pairs):
    jm, _, params16, _, tm16 = pairs
    with torch.no_grad():
        _, feature = tm16.encode_first_stage(t(_image()) * 2 - 1)
    assert feature.dtype == torch.float32
    got = tm16.codec().compress(feature)
    want = jm.codec(params16).compress(jnp.asarray(n(feature)))
    assert _bytes(got) == _bytes(want)


def test_fp32_stream_decodes_to_the_same_latents_under_bf16(pairs, tmp_path):
    _, _, _, tm32, tm16 = pairs
    stream = tmp_path / "fp32.rdeic"
    tm32.apply_condition_compress(t(_image()), stream, 64, 64)
    for a, b in zip(tm32.apply_condition_decompress(stream),
                    tm16.apply_condition_decompress(stream)):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def _decode_noise(rng, shape, steps):
    rng_init, rng_loop = jax.random.split(rng)
    relay = t(jax.random.normal(rng_init, shape, jnp.float32))
    out = []
    for _ in range(steps):
        rng_loop, key = jax.random.split(rng_loop)
        out.append(t(jax.random.normal(key, shape, jnp.float32)))
    return relay, out


@pytest.mark.parametrize("sampler,guidance", [("ddpm", 1.0), ("ddim", 2.0)])
def test_bf16_decode_matches_jax_bf16(pairs, sampler, guidance):
    jm, params, params16, tm32, tm16 = pairs
    rng = np.random.default_rng(4)
    cl = rng.normal(size=LATENT).astype(np.float32)
    gh = rng.normal(size=(*LATENT[:3], 8)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm.jitted_decode(steps=2, sampler=sampler,
                                       guidance_scale=guidance)(
        params16, jnp.asarray(cl), jnp.asarray(gh), key))
    relay, steps = _decode_noise(key, LATENT, 2)
    kw = dict(sampler=sampler, guidance_scale=guidance, relay_noise=relay,
              step_noise=steps)
    got = n(tm16.decode_pipeline(t(cl), t(gh), 2, **kw))
    ref32 = n(tm32.decode_pipeline(t(cl), t(gh), 2, **kw))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert 0 < _rel(got, ref32)  # bf16 really ran
    assert _rel(got, want) <= BF16_PAIR_TOL < _rel(got * FAULT_SCALE, want)
    assert _rel(got, ref32) <= BF16_TOL < _rel(got * FAULT_SCALE, ref32)
    assert _rel(want, ref32) <= BF16_TOL


def test_vae_group_norm_keeps_fp32_statistics():
    """The VAE's Normalize (F.group_norm) on bf16 input and weights rounds
    the fp32 result once: within half a bf16 ulp of the fp32 computation on
    the same values (statistics in bf16 would miss by far more at a mean of
    40)."""
    torch.manual_seed(0)
    norm = Normalize(64)
    with torch.no_grad():
        norm.GroupNorm_0.weight.normal_()
        norm.GroupNorm_0.bias.normal_()
    x = (torch.randn(2, 64, 16, 16) * 3 + 40).bfloat16()
    want = group_norm_plain(x.float(), norm.GroupNorm_0.weight.bfloat16().float(),
                            norm.GroupNorm_0.bias.bfloat16().float(), 32, 1e-6)
    got = norm.bfloat16()(x)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert (err <= 2.0 ** -8 * want.abs() + 1e-3).all(), err.max()
