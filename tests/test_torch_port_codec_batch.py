"""The codec's batch routes against its single-image ones, the committed
golden stream and the JAX package's `decompress_batch`: one run of the
passes over B images gives each image the stream `compress` writes for it
alone, and `decompress_batch` row i is `decompress` of stream i alone, bit
for bit."""
import io

import jax
import numpy as np
import pytest
import torch

from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.pipeline.codec import CompressionCodec
from rdeic_torch.utils.bitstream import write_body
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.models.compression import CompressionModel as JaxCompressionModel
from rdeic_tpu.pipeline.codec import CompressionCodec as JaxCodec
from tests.test_torch_port_codec import DATA, SMALL, SPECIAL
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    unflatten, one_torch_thread_per_module)

B = 4


@pytest.fixture(scope="module")
def batch():
    """The golden model, ported and in JAX, and a batch whose first image
    is the golden input; the rest random at its shape."""
    with np.load(DATA) as data:
        flat = {k: data[k] for k in data.files if k not in SPECIAL}
        golden = {k: data[k] for k in SPECIAL}
    model = CompressionModel(**SMALL)
    model.load_state_dict(load_jax_params(flat), strict=True)
    rest = np.random.default_rng(3).normal(
        size=(B - 1, *golden["__input__"].shape[1:])).astype(np.float32) * 2
    x = np.concatenate([golden["__input__"], rest])
    jax_codec = JaxCodec(JaxCompressionModel(**SMALL),
                         {"params": jax.tree_util.tree_map(
                             jax.numpy.asarray, unflatten(flat))}, fused=False)
    codec = CompressionCodec(model.eval())
    return dict(codec=codec, jax_codec=jax_codec, x=x, golden=golden,
                outs=codec.compress_batch(torch.from_numpy(x)))


def _bytes(out) -> bytes:
    buf = io.BytesIO()
    write_body(buf, out["shape"], out["strings"])
    return buf.getvalue()


def test_the_golden_image_keeps_its_golden_stream(batch):
    assert len(batch["outs"]) == B
    assert _bytes(batch["outs"][0]) == batch["golden"]["__stream__"].tobytes()


@pytest.mark.parametrize("i", range(B))
def test_each_stream_is_the_single_image_stream(batch, i):
    single = batch["codec"].compress(torch.from_numpy(batch["x"][i:i + 1]))
    assert batch["outs"][i]["strings"] == single["strings"]
    assert batch["outs"][i]["shape"] == single["shape"]


def test_streams_equal_the_jax_batch_streams(batch):
    want = batch["jax_codec"].compress_batch(jax.numpy.asarray(batch["x"]))
    assert [o["strings"] for o in batch["outs"]] == [o["strings"] for o in want]


def test_decompress_batch_rows_are_each_stream_decoded_alone(batch):
    codec = batch["codec"]
    c_latent, guide_hint = codec.decompress_batch(batch["outs"])
    assert c_latent.shape[0] == guide_hint.shape[0] == B
    for i, out in enumerate(batch["outs"]):
        c_i, g_i = codec.decompress(out["strings"], out["shape"])
        torch.testing.assert_close(c_latent[i:i + 1], c_i, rtol=0, atol=0)
        torch.testing.assert_close(guide_hint[i:i + 1], g_i, rtol=0, atol=0)
    # the encoder's own synthesis of the golden image, bit for bit
    enc_c, enc_g = codec.compress(
        torch.from_numpy(batch["x"][:1]))["latents"]
    torch.testing.assert_close(c_latent[:1], enc_c, rtol=0, atol=0)
    torch.testing.assert_close(guide_hint[:1], enc_g, rtol=0, atol=0)


def test_decompress_batch_matches_jax(batch):
    c_latent, guide_hint = batch["codec"].decompress_batch(batch["outs"])
    j_c, j_g = batch["jax_codec"].decompress_batch(batch["outs"])
    # 1e-5 absolute and relative: see test_torch_port_codec's golden decode
    np.testing.assert_allclose(c_latent.numpy(), np.asarray(j_c),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(guide_hint.numpy(), np.asarray(j_g),
                               atol=1e-5, rtol=1e-5)


def test_lanes_container_is_refused_naming_device_rans(batch):
    out = batch["outs"][0]
    lanes = {"strings": out["strings"] + [[b"\0"]], "shape": out["shape"]}
    with pytest.raises(NotImplementedError, match="device_rans"):
        batch["codec"].decompress_batch([lanes])
    with pytest.raises(NotImplementedError, match="device_rans"):
        batch["codec"].decompress(lanes["strings"], lanes["shape"])


def test_a_batch_of_streams_of_two_shapes_is_refused(batch):
    out = batch["outs"][0]
    other = {"strings": out["strings"], "shape": (2, 1)}
    with pytest.raises(ValueError, match="one shape"):
        batch["codec"].decompress_batch([out, other])
