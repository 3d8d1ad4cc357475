"""rdeic_torch's codec against the committed golden bitstream and against the
JAX coder: the same params and input must give the same bytes, and the
golden bytes must decode to the golden latents."""
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from rdeic_torch.entropy import coder as t_coder
from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.ops import gaussian as t_gaussian
from rdeic_torch.pipeline.codec import CompressionCodec
from rdeic_torch.utils.bitstream import read_body, write_body
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.entropy import coder as j_coder

DATA = Path(__file__).parent / "data" / "golden_codec.npz"
# the model of tests/test_golden_bitstream.py
SMALL = dict(in_nc=8, out_nc=4, N=8, M=8, slice_num=2, slice_ch=(4, 4),
             codebook_size=32)
SPECIAL = ("__input__", "__stream__", "__c_latent__", "__guide_hint__")


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA) as data:
        flat = {k: data[k] for k in data.files if k not in SPECIAL}
        special = {k: data[k] for k in SPECIAL}
    model = CompressionModel(**SMALL)
    model.load_state_dict(load_jax_params(flat), strict=True)
    return CompressionCodec(model.eval()), special


def test_compress_writes_the_golden_bytes(golden):
    codec, data = golden
    out = codec.compress(torch.from_numpy(data["__input__"]))
    buf = io.BytesIO()
    write_body(buf, out["shape"], out["strings"])
    assert buf.getvalue() == data["__stream__"].tobytes()


def test_golden_bytes_decode_to_the_golden_latents(golden):
    codec, data = golden
    strings, shape = read_body(io.BytesIO(data["__stream__"].tobytes()))
    c_latent, guide_hint = codec.decompress(strings, shape)
    out = codec.compress(torch.from_numpy(data["__input__"]))
    enc_latent, enc_hint = out["latents"]
    torch.testing.assert_close(c_latent, enc_latent, rtol=0, atol=0)
    torch.testing.assert_close(guide_hint, enc_hint, rtol=0, atol=0)
    # 1e-5, relative as well as absolute: values reach ~10, where an fp32 ulp
    # is ~1e-6, after ~20 convolutions summed in another order than XLA's
    np.testing.assert_allclose(c_latent.numpy(), data["__c_latent__"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(guide_hint.numpy(), data["__guide_hint__"],
                               atol=1e-5, rtol=1e-5)


def test_rans_bytes_match_the_jax_coder():
    table_args = t_gaussian.build_cdf_tables(t_gaussian.get_scale_table())
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, size=4000).astype(np.int32)
    sym = np.round(rng.normal(size=4000) * (1 + idx / 4)).astype(np.int32)
    sym[:5] = [0, 10_000, -10_000, 70_000, -3]  # escapes past the tables
    t_table = t_coder.CdfTable(*table_args)
    stream = t_coder.rans_encode(sym, idx, t_table)
    assert stream == j_coder.rans_encode(sym, idx, j_coder.CdfTable(*table_args))
    with t_coder.RansDecoder() as dec:
        dec.set_stream(stream)
        first = dec.decode_stream(idx[:1500], t_table)
        rest = dec.decode_stream(idx[1500:], t_table)
    np.testing.assert_array_equal(np.concatenate([first, rest]), sym)


def test_uniform_packing_matches_jax():
    idx = np.random.default_rng(1).integers(0, 16384, size=(1, 12, 8))
    packed = t_coder.pack_uniform(idx, 16384)
    assert packed == j_coder.pack_uniform(idx, 16384)
    np.testing.assert_array_equal(
        t_coder.unpack_uniform(packed, idx.size, 16384), idx.reshape(-1))
    with pytest.raises(ValueError):
        t_coder.pack_uniform(np.array([32]), 32)
