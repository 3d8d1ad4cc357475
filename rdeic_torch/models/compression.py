"""Learned compression model (counterpart of rdeic_tpu/models/compression.py).

NCHW inside; every public method takes and returns NHWC, as the JAX methods
do, so the codec and the tests see the same layout. The same methods serve
encode and decode, which is what keeps the entropy parameters bit-identical
on both sides, and the training forward (noisy likelihoods, CVQ losses).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rdeic_torch.models.blocks import Conv, nchw, nhwc, pixel_shuffle
from rdeic_torch.ops import ckbd
from rdeic_torch.ops.gaussian import likelihood, ste_round


class ResidualBlock(nn.Module):
    """Two 3x3 convs + LeakyReLU(0.01), 1x1 adaptor when channels change."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.adaptor = Conv(cin, cout, 1) if cin != cout else None
        self.conv1 = Conv(cin, cout, 3)
        self.conv2 = Conv(cout, cout, 3)

    def forward(self, x):
        identity = x if self.adaptor is None else self.adaptor(x)
        h = F.leaky_relu(self.conv1(x), 0.01)
        h = F.leaky_relu(self.conv2(h), 0.01)
        return h + identity


class ResidualBlockWithStride(nn.Module):
    """Stride-2 residual downsampling block (slope 0.1 after conv2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride=2)
        self.conv2 = Conv(cout, cout, 3)
        self.downsample = Conv(cin, cout, 1, stride=2)

    def forward(self, x):
        h = F.leaky_relu(self.conv1(x), 0.01)
        h = F.leaky_relu(self.conv2(h), 0.1)
        return h + self.downsample(x)


class ResidualBlockUpsample(nn.Module):
    """Sub-pixel (1x1 conv + depth-to-space) upsampling block (slope 0.1
    after the 3x3 conv)."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__()
        self.r = r
        self.subpel_conv = Conv(cin, cout * r * r, 1)
        self.conv = Conv(cout, cout, 3)
        self.upsample = Conv(cin, cout * r * r, 1)

    def forward(self, x):
        h = F.leaky_relu(pixel_shuffle(self.subpel_conv(x), self.r), 0.01)
        h = F.leaky_relu(self.conv(h), 0.1)
        return h + pixel_shuffle(self.upsample(x), self.r)


def _chain(module: nn.Module, specs) -> list[str]:
    """Add (class, cin, cout) blocks under flax's auto-names (ResidualBlock_0,
    ..., ResidualBlockWithStride_0, ...); return the names in call order."""
    counts: dict[str, int] = {}
    names = []
    for cls, cin, cout in specs:
        n = counts.get(cls.__name__, 0)
        counts[cls.__name__] = n + 1
        name = f"{cls.__name__}_{n}"
        module.add_module(name, cls(cin, cout))
        names.append(name)
    return names


class _Chain(nn.Module):
    def forward(self, x):
        for name in self.plan:
            x = getattr(self, name)(x)
        return x


class AnalysisTransform(_Chain):
    """g_a: VAE feature -> y, one stride 2."""

    def __init__(self, in_nc: int, M: int):
        super().__init__()
        R, S = ResidualBlock, ResidualBlockWithStride
        self.plan = _chain(self, [(R, in_nc, M), (R, M, M), (R, M, M),
                                  (R, M, M), (S, M, M), (R, M, M), (R, M, M),
                                  (R, M, M)])
        self.conv_out = Conv(M, M, 3)
        self.plan.append("conv_out")


class SynthesisTransform(_Chain):
    """g_s: y_hat -> guide_hint feature, one x2 upsample."""

    def __init__(self, M: int):
        super().__init__()
        self.conv_in = Conv(M, M, 3)
        R, U = ResidualBlock, ResidualBlockUpsample
        self.plan = ["conv_in"] + _chain(
            self, [(R, M, M)] * 3 + [(U, M, M)] + [(R, M, M)] * 4)


class HyperEncoder(_Chain):
    def __init__(self, M: int, N: int):
        super().__init__()
        R, S = ResidualBlock, ResidualBlockWithStride
        self.plan = _chain(self, [(R, M, N), (R, N, N), (S, N, N), (S, N, N)])


class HyperDecoder(_Chain):
    def __init__(self, N: int, M: int):
        super().__init__()
        R, U = ResidualBlock, ResidualBlockUpsample
        self.plan = _chain(self, [(U, N, M), (U, M, M), (R, M, M * 3 // 2),
                                  (R, M * 3 // 2, M * 2)])


class ChannelContextEX(nn.Module):
    """5x5-conv fusion of the slices decoded so far -> per-slice context."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        self.conv1 = Conv(cin, 224, 5)
        self.conv2 = Conv(224, 128, 5)
        self.conv3 = Conv(128, out_dim, 5)

    def forward(self, x):
        h = F.gelu(self.conv1(x))
        h = F.gelu(self.conv2(h))
        return self.conv3(h)


class EntropyParametersEX(nn.Module):
    """1x1-conv fusion producing a slice's (scales, means)."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        self.conv1 = Conv(cin, out_dim * 5 // 3, 1)
        self.conv2 = Conv(out_dim * 5 // 3, out_dim * 4 // 3, 1)
        self.conv3 = Conv(out_dim * 4 // 3, out_dim, 1)

    def forward(self, x):
        h = F.gelu(self.conv1(x))
        h = F.gelu(self.conv2(h))
        return self.conv3(h)


def vq_logits(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """[n, K] negative squared L2 distance of each row to every code."""
    return (2.0 * (z_flat @ embedding.T) - (embedding * embedding).sum(-1)[None, :]
            - (z_flat * z_flat).sum(-1, keepdim=True))


CODEBOOK_DECAY = 0.99  # EMA rate of the codebook usage


@torch.no_grad()
def vq_codebook_update(embedding: torch.Tensor, embed_prob: torch.Tensor,
                       z_flat: torch.Tensor):
    """CVQ-VAE 'closest'-anchor reinitialisation: (new embedding, new usage).

    An EMA of each code's usage, then every code pulled towards its closest
    input row with a strength that fades as the code gets used. The trainer
    applies it after the optimizer, on every call."""
    d = vq_logits(z_flat, embedding)
    k = embedding.shape[0]
    counts = torch.bincount(torch.argmax(d, dim=1), minlength=k)
    usage = counts.to(embed_prob.dtype) / d.shape[0]
    new_prob = embed_prob * CODEBOOK_DECAY + usage * (1 - CODEBOOK_DECAY)
    random_feat = z_flat[torch.argmax(d, dim=0)]
    alpha = torch.exp(-(new_prob * k * 10) / (1 - CODEBOOK_DECAY) - 1e-3)[:, None]
    return embedding * (1 - alpha) + random_feat * alpha, new_prob


class VectorQuantiser(nn.Module):
    """CVQ-VAE codebook over the hyper latent: the training forward
    (commitment + codebook + contrastive loss, straight-through output) and
    the inference lookups."""

    beta = 0.25

    def __init__(self, num_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(num_embed, embed_dim).uniform_(-1.0 / num_embed,
                                                       1.0 / num_embed))

    def logits(self, z_flat: torch.Tensor) -> torch.Tensor:
        """Negative squared L2 distance to every code, in full fp32."""
        return vq_logits(z_flat, self.embedding)

    def forward(self, z: torch.Tensor, training: bool = True):
        """z NHWC [B, h, w, D] -> (z_q, loss, indices [B, h, w])."""
        b, h, w, d = z.shape
        z_flat = z.reshape(-1, d)
        logits = self.logits(z_flat.detach())
        indices = torch.argmax(logits, dim=1)
        z_q = self.embedding[indices].reshape(z.shape)
        loss = z.new_zeros(())
        if training:
            loss = (self.beta * torch.mean((z_q.detach() - z) ** 2)
                    + torch.mean((z_q - z.detach()) ** 2)
                    + self._contrastive(logits))
            z_q = z + (z_q - z).detach()
        return z_q, loss, indices.reshape(b, h, w)

    def _contrastive(self, logits: torch.Tensor) -> torch.Tensor:
        """Per code: the mean of its n // K closest rows as the positive,
        its n // 2 farthest rows as the negatives, a 0.07-temperature
        softmax; only the selected values matter, so top-k stands in for a
        sort."""
        n = logits.shape[0]
        lt = logits.T  # [K, n]
        n_pos = max(1, n // self.embedding.shape[0])
        dis_pos = torch.topk(lt, n_pos, dim=1).values.mean(dim=1, keepdim=True)
        dis_neg = -torch.topk(-lt, n // 2, dim=1).values
        dis = torch.cat([dis_pos, dis_neg], dim=1) / 0.07
        return -torch.mean(torch.log_softmax(dis, dim=1)[:, 0])

    def quant(self, z: torch.Tensor):
        """z NHWC [B, h, w, D] -> (z_q NHWC, indices [B, h, w]); ties take
        the first code, as jnp.argmax does."""
        b, h, w, d = z.shape
        indices = torch.argmax(self.logits(z.reshape(-1, d)), dim=1)
        return self.embedding[indices].reshape(z.shape), indices.reshape(b, h, w)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, h, w] -> z_q NHWC."""
        return self.embedding[indices.reshape(-1).long()].reshape(
            tuple(indices.shape) + (self.embedding.shape[1],))


class CompressionModel(nn.Module):
    """Checkerboard + channel-slice autoregressive compression model."""

    def __init__(self, in_nc: int = 512, out_nc: int = 4, N: int = 256,
                 M: int = 256, slice_num: int = 10,
                 slice_ch: Sequence[int] = (8, 8, 8, 8, 16, 16, 32, 32, 64, 64),
                 codebook_size: int = 16384):
        super().__init__()
        if sum(slice_ch) != M or len(slice_ch) != slice_num:
            raise ValueError("slice_ch must have slice_num entries summing to M")
        self.M, self.N = M, N
        self.slice_num = slice_num
        self.slice_ch = tuple(slice_ch)
        self.codebook_size = codebook_size
        self.encoder = AnalysisTransform(in_nc, M)
        self.hyper_enc = HyperEncoder(M, N)
        self.hyper_dec = HyperDecoder(N, M)
        self.decoder = SynthesisTransform(M)
        self.out = Conv(M, out_nc, 3)
        self.quantize = VectorQuantiser(codebook_size, N)
        done = 0
        for i, c in enumerate(self.slice_ch):
            self.add_module(f"local_context_{i}", Conv(c, 2 * c, 5))
            if i:
                self.add_module(f"channel_context_{i}",
                                ChannelContextEX(done, 2 * c))
            ctx = 2 * c if i else 0
            self.add_module(f"ep_anchor_{i}",
                            EntropyParametersEX(ctx + 2 * M, 2 * c))
            self.add_module(f"ep_nonanchor_{i}",
                            EntropyParametersEX(2 * c + ctx + 2 * M, 2 * c))
            done += c

    # All methods take and return NHWC.
    def analyze(self, x: torch.Tensor):
        """x [B, H, W, in_nc] -> (y, z)."""
        y = self.encoder(nchw(x))
        return nhwc(y), nhwc(self.hyper_enc(y))

    def vq_quant(self, z: torch.Tensor):
        return self.quantize.quant(z)

    def vq_lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.quantize.lookup(indices)

    def hyper_decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return nhwc(self.hyper_dec(nchw(z_q)))

    def params_anchor(self, idx: int, hyper_params: torch.Tensor,
                      y_hat_prev: torch.Tensor | None):
        """(scales, means, channel_ctx) of slice idx's anchor half;
        y_hat_prev is the concat of the slices decoded so far (None for 0)."""
        hyper = nchw(hyper_params)
        if idx == 0:
            channel_ctx = None
            inp = hyper
        else:
            channel_ctx = getattr(self, f"channel_context_{idx}")(nchw(y_hat_prev))
            inp = torch.cat([channel_ctx, hyper], dim=1)
        scales, means = torch.chunk(getattr(self, f"ep_anchor_{idx}")(inp), 2, dim=1)
        return (nhwc(scales), nhwc(means),
                None if channel_ctx is None else nhwc(channel_ctx))

    def params_nonanchor(self, idx: int, hyper_params: torch.Tensor,
                         channel_ctx: torch.Tensor | None,
                         slice_anchor: torch.Tensor):
        """(scales, means) of slice idx's non-anchor half given its
        dequantized anchor half (checkerboard local context)."""
        local_ctx = getattr(self, f"local_context_{idx}")(nchw(slice_anchor))
        parts = [local_ctx]
        if idx:
            parts.append(nchw(channel_ctx))
        parts.append(nchw(hyper_params))
        params = getattr(self, f"ep_nonanchor_{idx}")(torch.cat(parts, dim=1))
        scales, means = torch.chunk(params, 2, dim=1)
        return nhwc(scales), nhwc(means)

    def synthesize(self, y_hat: torch.Tensor):
        """y_hat -> (c_latent [B, 2h, 2w, out_nc], guide_hint [B, 2h, 2w, M])."""
        guide_hint = self.decoder(nchw(y_hat))
        return nhwc(self.out(guide_hint)), nhwc(guide_hint)

    def forward(self, x: torch.Tensor, noise: Sequence[torch.Tensor] | None = None,
                training: bool = True) -> dict:
        """The rate-estimation forward: x [B, H, W, in_nc] -> dict of
        c_latent, guide_hint, y_likelihoods, q_likelihoods, emb_loss, z (the
        hyper latent) and vq_indices. Training takes `noise`, one U(-0.5,
        0.5) tensor per slice of y's shape [B, h, w, slice_ch[i]]."""
        if training and (noise is None or len(noise) != self.slice_num):
            raise ValueError(f"training needs {self.slice_num} uniform noise "
                             "tensors, one per slice")
        y, z = self.analyze(x)
        z_q, emb_loss, vq_indices = self.quantize(z, training=training)
        hyper_params = self.hyper_decode(z_q)
        y_hat_slices, y_likelihoods, q_likelihoods = [], [], []
        for idx, y_slice in enumerate(torch.split(y, self.slice_ch, dim=-1)):
            slice_anchor, slice_nonanchor = ckbd.ckbd_split(y_slice)
            y_hat_prev = torch.cat(y_hat_slices, dim=-1) if idx else None
            scales_a, means_a, channel_ctx = self.params_anchor(
                idx, hyper_params, y_hat_prev)
            scales_a, means_a = ckbd.ckbd_anchor(scales_a), ckbd.ckbd_anchor(means_a)
            slice_anchor = ste_round(slice_anchor - means_a) + means_a
            scales_na, means_na = self.params_nonanchor(
                idx, hyper_params, channel_ctx, slice_anchor)
            scales_na = ckbd.ckbd_nonanchor(scales_na)
            means_na = ckbd.ckbd_nonanchor(means_na)
            scales = ckbd.ckbd_merge(scales_a, scales_na)
            means = ckbd.ckbd_merge(means_a, means_na)
            _, q_like = likelihood(y_slice, scales, means)
            y_like = q_like
            if training:
                _, y_like = likelihood(y_slice, scales, means, noise=noise[idx])
            slice_nonanchor = ste_round(slice_nonanchor - means_na) + means_na
            y_hat_slices.append(slice_anchor + slice_nonanchor)
            y_likelihoods.append(y_like)
            q_likelihoods.append(q_like)
        c_latent, guide_hint = self.synthesize(torch.cat(y_hat_slices, dim=-1))
        return dict(c_latent=c_latent, guide_hint=guide_hint,
                    y_likelihoods=torch.cat(y_likelihoods, dim=-1),
                    q_likelihoods=torch.cat(q_likelihoods, dim=-1),
                    emb_loss=emb_loss, z=z, vq_indices=vq_indices)
