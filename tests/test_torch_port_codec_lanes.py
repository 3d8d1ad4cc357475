"""The codec's interleaved-lane routes, rdeic_torch against rdeic_tpu on the
CPU at the micro width: under each RDEIC_RANS_* setting the streams are the
JAX codec's byte for byte (v1, v2, adaptive K, the device encoder's v1
containers, batches with K pinned from image 0), the decoded (c_latent,
guide_hint) match the JAX codec's within the codec's 1e-5 and equal the
port's own encoder synthesis bit for bit, each route ran (the host shared-
stream route below RDEIC_RANS_DEVICE_MIN_LANES, the lane decoder above it),
and a codec decodes a stream of another K than its own."""
import io
import warnings

import jax
import numpy as np
import pytest
import torch

from rdeic_torch.entropy import device_rans
from rdeic_torch.pipeline import codec as tcodec
from rdeic_torch.pipeline.codec import CompressionCodec, parse_lane_header
from rdeic_torch.utils.bitstream import write_body
from rdeic_tpu.pipeline.codec import CompressionCodec as JaxCodec
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    micro_pair, one_torch_thread_per_module)

ENV = ("RDEIC_RANS_DEVICE_ENC", "RDEIC_RANS_SHARED", "RDEIC_RANS_OVERHEAD_PCT",
       "RDEIC_RANS_DEVICE_MIN_LANES")
# setting -> (K, environment); the route each one takes is in ROUTES
SETTINGS = {
    "v1": (8, {"RDEIC_RANS_SHARED": "0", "RDEIC_RANS_OVERHEAD_PCT": "0"}),
    "v2_host": (8, {"RDEIC_RANS_OVERHEAD_PCT": "0"}),
    "v2_device": (64, {"RDEIC_RANS_OVERHEAD_PCT": "0"}),
    "v2_min_lanes_4": (8, {"RDEIC_RANS_OVERHEAD_PCT": "0",
                           "RDEIC_RANS_DEVICE_MIN_LANES": "4"}),
    "adaptive": (128, {}),
    "device_enc": (8, {"RDEIC_RANS_DEVICE_ENC": "1"}),
}
# setting -> (container version, the decoder that reads it)
ROUTES = {"v1": (1, "decode_pass"), "v2_host": (2, "host"),
          "v2_device": (2, "decode_pass_shared"),
          "v2_min_lanes_4": (2, "decode_pass_shared"),
          "adaptive": (2, "host"), "device_enc": (1, "decode_pass")}
B = 3


@pytest.fixture(scope="module")
def micro():
    jm, params, tm = micro_pair(seed=4)
    # what the codec codes: the micro VAE's feature of B images (16 x 24)
    img = np.random.default_rng(8).uniform(size=(B, 32, 48, 3))
    x = tm.feature(torch.from_numpy(img.astype(np.float32))).numpy()
    jax_codec = JaxCodec(jm.compression, {"params": params["compression"]},
                         fused=False, lanes=8)
    return dict(tm=tm, x=x, jax_codec=jax_codec, cache={})


def _env(monkeypatch, settings: dict) -> None:
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in settings.items():
        monkeypatch.setenv(key, value)


def port_codec(micro, monkeypatch, setting: str) -> CompressionCodec:
    k, env = SETTINGS[setting]
    _env(monkeypatch, env)
    return CompressionCodec(micro["tm"].compression, lanes=k)


def jax_codec(micro, setting: str) -> JaxCodec:
    """The module's JAX codec set as its constructor sets it under the
    setting's environment (its pass programs stay compiled)."""
    k, env = SETTINGS[setting]
    jc = micro["jax_codec"]
    jc.shared = env.get("RDEIC_RANS_SHARED", "1") == "1"
    jc.auto_lanes_pct = float(env.get("RDEIC_RANS_OVERHEAD_PCT", "2.0"))
    jc.device_min_lanes = int(env.get("RDEIC_RANS_DEVICE_MIN_LANES", "32"))
    jc.device_enc = env.get("RDEIC_RANS_DEVICE_ENC", "0") == "1"
    if jc.lanes != k:
        jc.lanes = k
        jc._build_interleaved()
    return jc


def jax_streams(micro, setting: str, batch: bool):
    key = (setting, batch)
    if key not in micro["cache"]:
        jc = jax_codec(micro, setting)
        x = jax.numpy.asarray(micro["x"] if batch else micro["x"][:1])
        micro["cache"][key] = (jc.compress_batch(x) if batch
                               else [jc.compress(x)])
    return micro["cache"][key]


def _bytes(out) -> bytes:
    buf = io.BytesIO()
    write_body(buf, out["shape"], out["strings"])
    return buf.getvalue()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_stream_and_decode_match_jax(micro, monkeypatch, setting):
    codec = port_codec(micro, monkeypatch, setting)
    out = codec.compress(torch.from_numpy(micro["x"][:1]))
    (want,) = jax_streams(micro, setting, batch=False)
    assert len(out["strings"]) == 3
    assert _bytes(out) == _bytes(want)
    ver, k, _ = parse_lane_header(out["strings"][2][0])
    assert ver == ROUTES[setting][0]
    if setting == "adaptive":
        assert k < SETTINGS[setting][0]  # the flush overhead shrank K
    counts = {fn: getattr(device_rans, fn).launches
              for fn in ("decode_pass", "decode_pass_shared")}
    before = dict(codec.host_routes)
    c_latent, guide_hint = codec.decompress(out["strings"], out["shape"])
    # CPU tensors count no launch: the route shows in which plain version
    # ran, read through the host-route counter and a spy below
    assert counts == {fn: getattr(device_rans, fn).launches for fn in counts}
    host = codec.host_routes["shared_decode"] - before["shared_decode"]
    assert host == (ROUTES[setting][1] == "host")
    enc_c, enc_g = out["latents"]
    torch.testing.assert_close(c_latent, enc_c, rtol=0, atol=0)
    torch.testing.assert_close(guide_hint, enc_g, rtol=0, atol=0)
    j_c, j_g = jax_codec(micro, setting).decompress(want["strings"],
                                                    want["shape"])
    np.testing.assert_allclose(c_latent.numpy(), np.asarray(j_c), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(guide_hint.numpy(), np.asarray(j_g), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("setting", ["v1", "v2_device", "v2_min_lanes_4"])
def test_lane_routes_run_their_decoder(micro, monkeypatch, setting):
    """The lane decoder a stream's version names runs once a pass."""
    codec = port_codec(micro, monkeypatch, setting)
    out = codec.compress(torch.from_numpy(micro["x"][:1]))
    calls = []
    name = ROUTES[setting][1]
    real = getattr(device_rans, name)
    monkeypatch.setattr(device_rans, name,
                        lambda *a: calls.append(1) or real(*a))
    codec.decompress(out["strings"], out["shape"])
    assert len(calls) == 2 * len(codec.bounds)


@pytest.mark.parametrize("setting", ["v1", "adaptive", "v2_device",
                                     "device_enc"])
def test_batches_match_jax_with_k_pinned_from_image_0(micro, monkeypatch,
                                                      setting):
    codec = port_codec(micro, monkeypatch, setting)
    outs = codec.compress_batch(torch.from_numpy(micro["x"]))
    want = jax_streams(micro, setting, batch=True)
    assert [_bytes(o) for o in outs] == [_bytes(o) for o in want]
    ks = {parse_lane_header(o["strings"][2][0])[:2] for o in outs}
    assert len(ks) == 1  # one version and K for the batch
    c_latent, guide_hint = codec.decompress_batch(outs)
    for i, out in enumerate(outs):
        c_i, g_i = codec.decompress(out["strings"], out["shape"])
        torch.testing.assert_close(c_latent[i:i + 1], c_i, rtol=0, atol=0)
        torch.testing.assert_close(guide_hint[i:i + 1], g_i, rtol=0, atol=0)


def test_a_codec_decodes_streams_of_any_k(micro, monkeypatch):
    """A codec without lanes (and one of another K) reads the lanes
    containers of every setting, to the encoder's latents; its own K is
    kept for what it writes next."""
    streams = {}
    for setting in ("v1", "v2_host", "v2_device", "adaptive"):
        codec = port_codec(micro, monkeypatch, setting)
        streams[setting] = codec.compress(torch.from_numpy(micro["x"][1:2]))
    _env(monkeypatch, {})
    for lanes in (0, 16):
        reader = CompressionCodec(micro["tm"].compression, lanes=lanes)
        for out in streams.values():
            c_latent, guide_hint = reader.decompress(out["strings"],
                                                     out["shape"])
            torch.testing.assert_close(c_latent, out["latents"][0], rtol=0,
                                       atol=0)
            torch.testing.assert_close(guide_hint, out["latents"][1], rtol=0,
                                       atol=0)
        assert reader.lanes == lanes
        plain = reader.compress(torch.from_numpy(micro["x"][:1]))
        assert len(plain["strings"]) == (3 if lanes else 2)


def test_device_encoder_overflow_encodes_on_the_host(micro, monkeypatch):
    """On the kernel's overflow flag the batch is coded on the host, as the
    JAX package does: the host route's stream, a warning, one count."""
    codec = port_codec(micro, monkeypatch, "device_enc")
    real = device_rans.encode_lanes

    def overflowing(*args):
        words, nwords, _ = real(*args)
        return words, nwords, torch.tensor(True)

    monkeypatch.setattr(device_rans, "encode_lanes", overflowing)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = codec.compress(torch.from_numpy(micro["x"][:1]))
    assert any("overflowed" in str(w.message) for w in caught)
    assert codec.host_routes["encode_after_overflow"] == 1
    monkeypatch.setattr(device_rans, "encode_lanes", real)
    _env(monkeypatch, {})  # the same codec without the device encoder
    host = CompressionCodec(micro["tm"].compression, lanes=8)
    assert _bytes(out) == _bytes(host.compress(torch.from_numpy(
        micro["x"][:1])))


def test_symbols_past_int16_refuse_to_code_as_in_jax(micro, monkeypatch):
    x = micro["x"][:1] * 1e6
    jc = jax_codec(micro, "v2_device")
    with pytest.raises(OverflowError):
        jc.compress(jax.numpy.asarray(x))
    for setting in ("v2_device", "device_enc"):
        with pytest.raises(OverflowError, match="int16"):
            port_codec(micro, monkeypatch, setting).compress(
                torch.from_numpy(x))


def test_mixed_or_malformed_batches_are_refused(micro, monkeypatch):
    codec = port_codec(micro, monkeypatch, "v1")
    lanes = codec.compress(torch.from_numpy(micro["x"][:1]))
    _env(monkeypatch, {})
    two = CompressionCodec(micro["tm"].compression).compress(
        torch.from_numpy(micro["x"][:1]))
    lanes.pop("latents")
    two.pop("latents")
    with pytest.raises(ValueError, match="all alike"):
        codec.decompress_batch([lanes, two])
    other = port_codec(micro, monkeypatch, "v2_device").compress(
        torch.from_numpy(micro["x"][:1]))
    with pytest.raises(ValueError, match="one version and K"):
        codec.decompress_batch([lanes, other])
    assert tcodec.lane_header(5, None) == np.asarray(
        [0x80000005], "<u4").tobytes()
