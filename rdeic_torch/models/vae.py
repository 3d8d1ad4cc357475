"""SD 2.1 VAE, AutoencoderKL (counterpart of rdeic_tpu/models/vae.py).

NCHW inside; `encode_hc` and `decode` take and return NHWC. GroupNorm here is
the VAE's `Normalize` (eps 1e-6, plain `F.group_norm`), not GroupNorm32: the
JAX package runs it through flax's stock GroupNorm, no Pallas kernel. The
mid-block attention is single-head over h*w tokens (d = C) and goes through
ops.attention, which sends it to the flash kernel on the card.

The decoder's `use_checkpoint` (the refine phase backpropagates through it)
recomputes each ResnetBlock and the AttnBlock in the backward instead of
keeping their activations, as `nn.remat` does in the JAX package.

Dtypes follow the JAX package's (models/blocks.py): the encoder and decoder
stacks compute in the compute dtype (bf16 after `RDEIC.set_compute_dtype`,
whatever the weights' storage dtype; their `conv_in` takes the fp32 image or
latent to it); `Normalize` keeps fp32 statistics and rounds its output once
to its input's dtype. The layers the JAX package builds without `dtype`
(the encoder's and decoder's `conv_out`, `quant_conv`, `post_quant_conv`)
promote (`PromotedConv`): they take an fp32 input, so they compute in fp32
on bf16 weights, and the 512-ch feature, the moments and the decoded image
leave in fp32: the compression model and the stream format stay fp32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rdeic_torch.models.blocks import (
    Conv,
    Conv2d,
    PromotedConv,
    find_denominator,
    nchw,
    nhwc,
)
from rdeic_torch.ops.attention import attention


class Normalize(nn.Module):
    """flax GroupNorm with `dtype=x.dtype`: fp32 statistics and affine, one
    rounding to the input's dtype (torch's own kernel where the weights
    share the input's dtype)."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(find_denominator(channels, 32),
                                        channels, eps=1e-6)

    def forward(self, x):
        gn = self.GroupNorm_0
        if gn.weight.dtype == x.dtype:
            return gn(x)
        return F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                            gn.bias.float(), gn.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = Normalize(cin)
        self.conv1 = Conv(cin, cout, 3)
        self.norm2 = Normalize(cout)
        self.conv2 = Conv(cout, cout, 3)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial grid."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = Normalize(channels)
        self.q = Conv(channels, channels, 1)
        self.k = Conv(channels, channels, 1)
        self.v = Conv(channels, channels, 1)
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.norm(x)
        # [B, C, H, W] -> [B, H*W, 1, C]: one head of width C
        q, k, v = (nhwc(f(hidden)).reshape(b, h * w, 1, c)
                   for f in (self.q, self.k, self.v))
        out = attention(q, k, v).reshape(b, h, w, c)
        return x + self.proj_out(nchw(out))


class Downsample(nn.Module):
    """Stride-2 conv with the SD VAE's asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class VAEEncoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True, in_channels: int = 3):
        super().__init__()
        self.conv_in = Conv(in_channels, ch, 3)
        self.plan = []
        cin = ch
        for i, mult in enumerate(ch_mult):
            for j in range(num_res_blocks):
                name = f"down_{i}_block_{j}"
                self.add_module(name, ResnetBlock(cin, ch * mult))
                self.plan.append(name)
                cin = ch * mult
            if i != len(ch_mult) - 1:
                name = f"down_{i}_downsample"
                self.add_module(name, Downsample(cin))
                self.plan.append(name)
        self.mid_block_1 = ResnetBlock(cin, cin)
        self.mid_attn_1 = AttnBlock(cin)
        self.mid_block_2 = ResnetBlock(cin, cin)
        self.norm_out = Normalize(cin)
        out_ch = 2 * z_channels if double_z else z_channels
        self.conv_out = PromotedConv(cin, out_ch, 3)

    def forward(self, x):
        """x [B, 3, H, W] in [-1, 1] -> (moments, 512-ch feature before
        conv_out), both fp32."""
        h = self.conv_in(x.to(self.conv_in.Conv_0.compute_dtype))
        for name in self.plan:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        feature = F.silu(self.norm_out(h)).float()
        return self.conv_out(feature), feature


class VAEDecoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, block_in, 3)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self.plan = []
        cin = block_in
        for i in reversed(range(len(ch_mult))):
            cout = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                name = f"up_{i}_block_{j}"
                self.add_module(name, ResnetBlock(cin, cout))
                self.plan.append(name)
                cin = cout
            if i != 0:
                name = f"up_{i}_upsample"
                self.add_module(name, Upsample(cin))
                self.plan.append(name)
        self.norm_out = Normalize(cin)
        self.conv_out = PromotedConv(cin, out_ch, 3)

    def _block(self, block: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if (self.use_checkpoint and torch.is_grad_enabled()
                and isinstance(block, (ResnetBlock, AttnBlock))):
            return checkpoint(block, h, use_reentrant=False)
        return block(h)

    def forward(self, z):
        """z [B, C, h, w] -> image [B, 3, H, W], fp32."""
        h = self.conv_in(z.to(self.conv_in.Conv_0.compute_dtype))
        for block in (self.mid_block_1, self.mid_attn_1, self.mid_block_2,
                      *(getattr(self, name) for name in self.plan)):
            h = self._block(block, h)
        return self.conv_out(F.silu(self.norm_out(h)).float())


def sample_diagonal_gaussian(mean: torch.Tensor, logvar: torch.Tensor,
                             noise: torch.Tensor) -> torch.Tensor:
    """A posterior sample mean + exp(logvar / 2) * noise, with the caller's
    standard-normal `noise`."""
    return mean + torch.exp(0.5 * logvar) * noise


class AutoencoderKL(nn.Module):
    """VAE with the quant/post-quant 1x1 convs and the encode_hc twin output."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 use_checkpoint: bool = False):
        super().__init__()
        self.encoder = VAEEncoder(ch, ch_mult, num_res_blocks, embed_dim)
        self.decoder = VAEDecoder(ch, ch_mult, num_res_blocks,
                                  z_channels=embed_dim,
                                  use_checkpoint=use_checkpoint)
        self.quant_conv = PromotedConv(2 * embed_dim, 2 * embed_dim, 1)
        self.post_quant_conv = PromotedConv(embed_dim, embed_dim, 1)

    def encode_moments(self, x: torch.Tensor):
        """x NHWC in [-1, 1] -> (mean, logvar) of the latent posterior, NHWC."""
        mean, logvar, _ = self.encode_hc(x)
        return mean, logvar

    def encode_hc(self, x: torch.Tensor):
        """x NHWC in [-1, 1] -> (mean, logvar, feature), NHWC: the latent
        posterior and the 512-ch feature the compression model codes."""
        moments, feature = self.encoder(nchw(x))
        mean, logvar = torch.chunk(self.quant_conv(moments), 2, dim=1)
        return nhwc(mean), nhwc(torch.clamp(logvar, -30.0, 20.0)), nhwc(feature)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z NHWC latent -> image NHWC in about [-1, 1]."""
        return nhwc(self.decoder(self.post_quant_conv(nchw(z))))
