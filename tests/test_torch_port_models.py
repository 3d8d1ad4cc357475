"""rdeic_torch modules against rdeic_tpu on the CPU, at micro widths, with the
same random weights carried across by `load_jax_params` (every leaf random,
flax's zero-inits included)."""
import jax
import numpy as np
import pytest
import torch

from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.models.compression import CompressionModel as JaxComp
from rdeic_tpu.models.vae import AutoencoderKL as JaxVAE
from tests.torch_port_helpers import ATOL, micro_pair, n, t


@pytest.fixture(scope="module")
def pair():
    return micro_pair(seed=0)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _flat(params):
    from flax.traverse_util import flatten_dict  # noqa: PLC0415

    return {"/".join(k): v for k, v in flatten_dict(params).items()}


def test_every_leaf_maps_by_one_rule(pair):
    jm, params, tm = pair
    sd = load_jax_params({k: np.asarray(v) for k, v in _flat(params).items()})
    assert set(sd) == set(tm.state_dict())
    with pytest.raises(RuntimeError):  # a missing leaf fails the strict load
        tm.load_state_dict({k: v for k, v in sd.items()
                            if not k.endswith("out_conv.weight")}, strict=True)


def test_vae_encode_hc_and_decode(pair):
    jm, params, tm = pair
    img = _rand((1, 32, 48, 3), 1, 0.5)
    want = jax.jit(lambda p, x: jm.vae.apply(
        {"params": p}, x, method=JaxVAE.encode_hc))(params["vae"], img)
    with torch.no_grad():
        got = tm.vae.encode_hc(t(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL)
    z = _rand((1, 16, 24, 4), 2)
    want = jax.jit(lambda p, z: jm.vae.apply(
        {"params": p}, z, method=JaxVAE.decode))(params["vae"], z)
    with torch.no_grad():
        got = tm.vae.decode(t(z))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def test_noise_estimator(pair):
    """Base + control at micro width: the control branch, the zero-conv
    bridges and the zero projections all carry random weights."""
    jm, params, tm = pair
    x = _rand((2, 16, 24, 4), 3)
    hint = _rand((2, 16, 24, 8), 4)
    ctx = _rand((2, 77, 16), 5)
    ts = np.array([299, 150], np.int32)
    want = jax.jit(lambda p, *a: jm.denoiser.apply({"params": p}, *a))(
        params["denoiser"], x, ts, ctx, hint)
    with torch.no_grad():
        got = tm.denoiser(t(x), torch.from_numpy(ts), t(ctx), t(hint))
    assert np.abs(np.asarray(want)).max() > 0.1  # not a vanishing output
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def test_compression_methods(pair):
    jm, params, tm = pair
    jc, tc = jm.compression, tm.compression
    cp = {"params": params["compression"]}

    def japply(method, *args):
        return jc.apply(cp, *args, method=getattr(JaxComp, method))

    feat = _rand((1, 16, 16, 16), 6)
    with torch.no_grad():
        y, z = tc.analyze(t(feat))
        jy, jz = japply("analyze", feat)
        np.testing.assert_allclose(n(y), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(n(z), np.asarray(jz), atol=ATOL)
        zq, idx = tc.vq_quant(t(jz))
        jzq, jidx = japply("vq_quant", jz)
        np.testing.assert_array_equal(n(idx), np.asarray(jidx))
        np.testing.assert_array_equal(n(zq), np.asarray(jzq))
        np.testing.assert_array_equal(n(tc.vq_lookup(idx)),
                                      np.asarray(japply("vq_lookup", jidx)))
        hyper = tc.hyper_decode(t(jzq))
        jhyper = japply("hyper_decode", jzq)
        np.testing.assert_allclose(n(hyper), np.asarray(jhyper), atol=ATOL)
        h = np.asarray(jhyper)
        prev = _rand((1, 8, 8, 4), 7)
        anchor = _rand((1, 8, 8, 4), 8)
        for idx_ in (0, 1):
            yp = None if idx_ == 0 else prev
            got = tc.params_anchor(idx_, t(h), None if yp is None else t(yp))
            want = japply("params_anchor", idx_, h, yp)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL)
            ctx = want[2]
            got = tc.params_nonanchor(idx_, t(h), None if ctx is None else t(ctx),
                                      t(anchor))
            want = japply("params_nonanchor", idx_, h, ctx, anchor)
            for g, w in zip(got, want):
                np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL)
        y_hat = _rand((1, 8, 8, 8), 9)
        for g, w in zip(tc.synthesize(t(y_hat)), japply("synthesize", y_hat)):
            np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL)
