"""OpenCLIP ViT-H/14 text tower and its tokenizer (counterpart of
rdeic_tpu/models/clip.py).

The tower maps 77 tokens to [B, 77, width] context for the UNets' cross
attention. "Penultimate" runs every transformer block but the last, then the
final LayerNorm. Attribute names mirror the flax parameter paths
(`resblock_{i}.in_proj`, `token_embedding`, `ln_final`), so
rdeic_torch.utils.convert maps a `clip/` subtree leaf by leaf.

Numerics as the JAX module: the Dense layers compute in fp32 whatever their
storage dtype (`blocks.Linear`), the LayerNorms promote (fp32 statistics,
the wider of the input's and the weights' dtypes out), the causal mask is
added to fp32 logits, and the MLP's GELU is exact. The 77-token attention is
plain tensor code here as there, where it runs outside any Pallas kernel.

The empty prompt, which is all RDEIC needs by default, is [SOT, EOT, 0, ...]
(`tokenize_empty`); captions take the byte-BPE `SimpleTokenizer`, which reads
a merges file (bpe_simple_vocab_16e6.txt.gz) the caller supplies.
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rdeic_torch.models.blocks import Linear

SOT_TOKEN = 49406
EOT_TOKEN = 49407
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


class PromotedLayerNorm(nn.LayerNorm):
    """A flax LayerNorm without `dtype`: fp32 statistics and arithmetic,
    output in the wider of the input's and the weights' dtypes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(out)


class TextTransformerBlock(nn.Module):
    """Pre-LN attention (one fused `in_proj`) and a GELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = PromotedLayerNorm(width, eps=1e-5)
        self.in_proj = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)
        self.ln_2 = PromotedLayerNorm(width, eps=1e-5)
        self.mlp_fc = Linear(width, 4 * width)
        self.mlp_proj = Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, seq, width = x.shape
        d = width // self.heads
        q, k, v = (t.reshape(b, seq, self.heads, d)
                   for t in self.in_proj(self.ln_1(x)).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
        attn = torch.softmax(logits + mask, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, seq, width)
        x = x + self.out_proj(out)
        h = F.gelu(self.mlp_fc(self.ln_2(x)), approximate="none")
        return x + self.mlp_proj(h)


class OpenCLIPTextEncoder(nn.Module):
    """Text tower: tokens [B, 77] -> hidden states [B, 77, width], after the
    penultimate block (or every block) and `ln_final`."""

    def __init__(self, width: int = 1024, heads: int = 16, layers: int = 24,
                 vocab_size: int = VOCAB_SIZE,
                 context_length: int = CONTEXT_LENGTH,
                 penultimate: bool = True):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        n_blocks = layers - 1 if penultimate else layers
        for i in range(n_blocks):
            self.add_module(f"resblock_{i}", TextTransformerBlock(width, heads))
        self.n_blocks = n_blocks
        self.ln_final = PromotedLayerNorm(width, eps=1e-5)
        if self.token_embedding.device.type != "meta":
            with torch.no_grad():  # the flax initialisers
                self.token_embedding.normal_(0.0, 0.02)
                self.positional_embedding.normal_(0.0, 0.01)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding[tokens.long()] + self.positional_embedding[None]
        seq = tokens.shape[1]
        mask = torch.triu(torch.full((seq, seq), float("-inf"),
                                     device=x.device), diagonal=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"resblock_{i}")(x, mask)
        return self.ln_final(x)


def tokenize_empty(batch: int = 1) -> np.ndarray:
    """Token ids for the empty prompt."""
    t = np.zeros((batch, CONTEXT_LENGTH), dtype=np.int32)
    t[:, 0] = SOT_TOKEN
    t[:, 1] = EOT_TOKEN
    return t


@lru_cache()
def _bytes_to_unicode() -> dict:
    """Every byte -> a printable character (CLIP's byte-level BPE alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# the JAX package's ASCII approximation of CLIP's unicode word pattern (the
# \p classes need the `regex` module)
WORD_PATTERN = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


class SimpleTokenizer:
    """CLIP byte-BPE tokenizer over a gzip merges file (caption
    conditioning only)."""

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        tokens = []
        for tok in WORD_PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """[len(texts), context_length] int32: SOT, the text's tokens cut to
        fit, EOT, zeros."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [SOT_TOKEN] + self.encode(text)[:context_length - 2] + [EOT_TOKEN]
            out[i, :len(toks)] = toks
        return out


class OpenCLIPTextConfig:
    """Registry target for the cond_stage_config YAML node."""

    def __init__(self, freeze: bool = True, layer: str = "penultimate", **_):
        self.freeze = freeze
        self.penultimate = layer == "penultimate"

    def build(self) -> OpenCLIPTextEncoder:
        return OpenCLIPTextEncoder(penultimate=self.penultimate)
