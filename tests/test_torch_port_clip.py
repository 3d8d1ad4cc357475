"""The CLIP text tower and its tokenizer, rdeic_torch against rdeic_tpu on the
CPU: the byte-BPE tokenizer on a merges file the test writes (punctuation,
HTML entities, non-ASCII text, truncation at 77 tokens), `tokenize_empty`,
the encoder in its penultimate and full forms from the same weights, and the
model's CLIP conditioning: a weights file with a `clip/` subtree attaches a
tower, one without leaves the model without."""
import copy
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.models import clip as t_clip
from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils.convert import load_jax_params, load_npz_weights
from rdeic_tpu.models import clip as j_clip
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.utils.checkpoint_io import save_params_npz
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    ATOL, MICRO, n, random_leaf, unflatten, one_torch_thread_per_module)

MERGES = ["t h", "th e</w>", "a</w> _", "o f</w>", "c a", "ca t</w>", "p h",
          "ph o", "pho t", "phot o</w>", "i n", "in g</w>", "s t", "st o",
          "sto p</w>", "a n", "an d</w>", ". .", ".. .</w>"]

TEXTS = [
    "",
    "the cat",
    "A photo of THE cat!!! ... and... the dog's toys, isn't it?",
    "fish &amp; chips &lt;b&gt; &amp;amp; &quot;quoted&quot;",
    "café naïve — 東京 🚀 über",
    "12 cats & 3.5 dogs; (stop) [stop] {stop}",
    " ".join(["photo of the cat"] * 40),  # past 77 tokens: cut to fit
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("bpe") / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(p, "wb") as f:
        f.write(("bpe header line\n" + "\n".join(MERGES) + "\n").encode())
    return str(p)


def test_tokenizer_matches_jax(vocab):
    got = t_clip.SimpleTokenizer(vocab).tokenize(TEXTS)
    want = j_clip.SimpleTokenizer(vocab).tokenize(TEXTS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(TEXTS), t_clip.CONTEXT_LENGTH)
    assert (got[:, 0] == t_clip.SOT_TOKEN).all()
    assert got[-1, -1] == t_clip.EOT_TOKEN  # the long text fills all 77


@pytest.mark.parametrize("text", TEXTS[1:6])
def test_encode_matches_jax(vocab, text):
    assert (t_clip.SimpleTokenizer(vocab).encode(text)
            == j_clip.SimpleTokenizer(vocab).encode(text))


def test_bytes_to_unicode_and_tokenize_empty_match_jax():
    assert t_clip._bytes_to_unicode() == j_clip._bytes_to_unicode()
    np.testing.assert_array_equal(t_clip.tokenize_empty(3),
                                  j_clip.tokenize_empty(3))
    assert (t_clip.SOT_TOKEN, t_clip.EOT_TOKEN, t_clip.VOCAB_SIZE) == \
        (j_clip.SOT_TOKEN, j_clip.EOT_TOKEN, j_clip.VOCAB_SIZE)


def _random_params(module, tokens, seed):
    template = jax.eval_shape(lambda r: module.init(r, tokens)["params"],
                              jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {"/".join(k): random_leaf("/".join(k), v.shape, rng)
            for k, v in sorted(flatten_dict(template).items())}


@pytest.mark.parametrize("penultimate", [True, False])
def test_encoder_matches_jax(vocab, penultimate):
    cfg = dict(width=32, heads=4, layers=3, penultimate=penultimate)
    tokens = t_clip.SimpleTokenizer(vocab).tokenize(TEXTS[:4])
    jm = j_clip.OpenCLIPTextEncoder(**cfg)
    flat = _random_params(jm, jnp.asarray(tokens), seed=1)
    want = jm.apply({"params": unflatten(flat)}, jnp.asarray(tokens))
    tm = t_clip.OpenCLIPTextEncoder(**cfg)
    tm.load_state_dict(load_jax_params(flat), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (4, 77, 32)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    blocks = [k for k in flat if k.startswith("resblock_")]
    assert {k.split("/")[0] for k in blocks} == \
        {f"resblock_{i}" for i in range(2 if penultimate else 3)}


def test_config_target_builds_the_encoder():
    assert t_clip.OpenCLIPTextConfig(layer="last").build().n_blocks == 24
    assert t_clip.OpenCLIPTextConfig().penultimate


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """A micro RDEIC with a CLIP tower in JAX (`include_clip`) and its
    weights in a `save_params_npz` file."""
    jm = JaxRDEIC(**copy.deepcopy(MICRO))
    template = jax.eval_shape(
        lambda r: jm.init_params(r, image_hw=(64, 64), include_clip=True),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    flat = {"/".join(k): random_leaf("/".join(k), v.shape, rng)
            for k, v in sorted(flatten_dict(template).items())}
    path = tmp_path_factory.mktemp("clip") / "params.npz"
    save_params_npz(str(path), unflatten(flat))
    return jm, jax.tree_util.tree_map(jnp.asarray, unflatten(flat)), path


def test_a_file_with_clip_attaches_a_tower_that_conditions_as_jax(clip_pair, vocab):
    jm, params, path = clip_pair
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    assert not hasattr(tm, "clip")
    load_npz_weights(tm, path)
    assert hasattr(tm, "clip") and tm.clip.n_blocks == 23
    tokens = t_clip.SimpleTokenizer(vocab).tokenize(TEXTS[1:3])
    want = jm.get_learned_conditioning(params, jnp.asarray(tokens))
    got = tm.get_learned_conditioning(2, torch.from_numpy(tokens))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    # no tokens: the stored empty prompt, as JAX
    np.testing.assert_array_equal(n(tm.get_learned_conditioning(2)),
                                  np.asarray(jm.get_learned_conditioning(params, batch=2)))


def test_a_file_without_clip_loads_strictly_and_attaches_none(clip_pair, tmp_path):
    _, params, _ = clip_pair
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()
            if k[0] != "clip"}
    path = tmp_path / "noclip.npz"
    save_params_npz(str(path), unflatten(flat))
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    load_npz_weights(tm, path)
    assert not hasattr(tm, "clip")
    tokens = torch.from_numpy(t_clip.tokenize_empty(2))
    torch.testing.assert_close(tm.get_learned_conditioning(2, tokens),
                               tm.uncond_context.expand(2, -1, -1))
    # a training warm start drops the subtree, as the JAX package's does
    tm2 = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    load_npz_weights(tm2, clip_pair[2], with_clip=False)
    assert not hasattr(tm2, "clip")


def test_cast_inference_params_casts_clip_as_jax(clip_pair):
    _, params, path = clip_pair
    tm = TorchRDEIC(**copy.deepcopy(MICRO), device="cpu")
    load_npz_weights(tm, path)
    tm.cast_inference_params(torch.bfloat16)
    want = {top: {str(x.dtype) for x in jax.tree_util.tree_leaves(sub)}
            for top, sub in JaxRDEIC.cast_inference_params(params).items()}
    assert want["clip"] == {"bfloat16"}
    got = dict(tm.named_parameters())
    got.update(tm.named_buffers())
    for name, tensor in got.items():
        assert {str(tensor.dtype).removeprefix("torch.")} == \
            want[name.split(".")[0]], name
