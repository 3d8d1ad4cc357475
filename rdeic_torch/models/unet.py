"""SD 2.1 UNet + the ControlNet-XS-style dual noise estimator (counterpart of
rdeic_tpu/models/unet.py).

NCHW inside; `NoiseEstimator.forward` (the dual UNet) and
`forward_unconditional` (the base UNet alone, the unconditional branch of
classifier-free guidance) take and return NHWC. Every GroupNorm32 goes
through the GroupNorm(+SiLU) kernel on the card and every self-attention
over >= 1024 tokens through the flash kernel. With `use_checkpoint`,
training recomputes each encoder, middle and decoder block in the backward
instead of keeping its activations (the JAX package's `nn.remat` around the
same blocks).

A module computes in its weights' dtype (bf16 after
`RDEIC.set_compute_dtype`): the entry points take x, the guide hint and the
context to it, and `embed_time` the fp32 sinusoidal embedding, as a flax
layer with `dtype` takes its inputs; GroupNorm statistics and the softmax
stay fp32 inside.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rdeic_torch.models.blocks import (
    Conv,
    GroupNorm32,
    find_denominator,
    nchw,
    nhwc,
    timestep_embedding,
)
from rdeic_torch.ops.attention import attention


class TimeEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        """t_emb: the fp32 sinusoidal embedding, taken to the weights' dtype."""
        return self.fc2(F.silu(self.fc1(t_emb.to(self.fc1.weight.dtype))))


class ResBlock(nn.Module):
    """UNet residual block with timestep-embedding injection."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(cin, silu=True)
        self.in_conv = Conv(cin, cout, 3)
        self.emb_proj = nn.Linear(emb_dim, cout)
        self.out_norm = GroupNorm32(cout, silu=True)
        self.out_conv = nn.Conv2d(cout, cout, 3, padding=1)
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(self.out_norm(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, context=None):
        """x [B, L, C]; context [B, Lk, Ck] (None: self-attention)."""
        context = x if context is None else context
        b, lq, _ = x.shape
        lk = context.shape[1]
        q = self.to_q(x).reshape(b, lq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(b, lk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(b, lk, self.heads, self.dim_head)
        out = attention(q, k, v).reshape(b, lq, self.heads * self.dim_head)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return h * F.gelu(gate)


class BasicTransformerBlock(nn.Module):
    """flax LayerNorm's eps is 1e-6 (torch's default is 1e-5)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff_geglu = GEGLU(dim, dim * 4)
        self.ff_out = nn.Linear(dim * 4, dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) -> linear proj -> transformer block -> proj."""

    def __init__(self, ch: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.block_0 = BasicTransformerBlock(inner, heads, dim_head, context_dim)
        self.proj_out = nn.Linear(inner, ch)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hidden = self.norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        hidden = self.block_0(self.proj_in(hidden), context)
        hidden = self.proj_out(hidden).transpose(1, 2).reshape(b, c, h, w)
        return x + hidden


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class EncoderBlock(nn.Module):
    """One input block: conv_in, a ResBlock [+ SpatialTransformer], or a
    Downsample."""

    def __init__(self, kind: str, cin: int, cout: int, emb_dim: int,
                 heads: int = 0, dim_head: int = 0, context_dim: int = 0):
        super().__init__()
        if kind == "conv":
            self.conv_in = Conv(cin, cout, 3)
        elif kind == "down":
            self.down = Downsample(cout)
        else:
            self.res = ResBlock(cin, cout, emb_dim)
            if kind == "res_attn":
                self.attn = SpatialTransformer(cout, heads, dim_head, context_dim)
        self.kind = kind

    def forward(self, x, emb, context):
        if self.kind == "conv":
            return self.conv_in(x)
        if self.kind == "down":
            return self.down(x)
        h = self.res(x, emb)
        if self.kind == "res_attn":
            h = self.attn(h, context)
        return h


class DecoderBlock(nn.Module):
    """One output block: ResBlock [+ attn] [+ Upsample]."""

    def __init__(self, cin: int, cout: int, emb_dim: int, has_attn: bool,
                 has_upsample: bool, heads: int = 0, dim_head: int = 0,
                 context_dim: int = 0):
        super().__init__()
        self.res = ResBlock(cin, cout, emb_dim)
        self.attn = (SpatialTransformer(cout, heads, dim_head, context_dim)
                     if has_attn else None)
        self.up = Upsample(cout) if has_upsample else None

    def forward(self, x, emb, context):
        h = self.res(x, emb)
        if self.attn is not None:
            h = self.attn(h, context)
        if self.up is not None:
            h = self.up(h)
        return h


class MiddleBlock(nn.Module):
    def __init__(self, ch: int, emb_dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.res1 = ResBlock(ch, ch, emb_dim)
        self.attn = SpatialTransformer(ch, heads, dim_head, context_dim)
        self.res2 = ResBlock(ch, ch, emb_dim)

    def forward(self, x, emb, context):
        return self.res2(self.attn(self.res1(x, emb), context), emb)


def _enc_plan(model_channels, channel_mult, num_res_blocks, attention_resolutions):
    """(kind, out_ch) of each input block."""
    plan = [("conv", model_channels)]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = mult * model_channels
            plan.append(("res_attn" if ds in attention_resolutions else "res", ch))
        if level != len(channel_mult) - 1:
            plan.append(("down", ch))
            ds *= 2
    return plan


def _dec_plan(model_channels, channel_mult, num_res_blocks, attention_resolutions):
    """(out_ch, has_attn, has_upsample) of each output block."""
    plan = []
    ds = 2 ** (len(channel_mult) - 1)
    for level in reversed(range(len(channel_mult))):
        ch = channel_mult[level] * model_channels
        for i in range(num_res_blocks + 1):
            has_up = level != 0 and i == num_res_blocks
            plan.append((ch, ds in attention_resolutions, has_up))
            if has_up:
                ds //= 2
    return plan


class UNetModel(nn.Module):
    """SD 2.1 denoising UNet (used here as the frozen base of the
    NoiseEstimator)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, context_dim: int = 1024):
        super().__init__()
        mc = model_channels
        emb = mc * 4
        self.model_channels = mc
        self.time_embed = TimeEmbed(mc, emb)
        cin = in_channels
        self.enc_out_channels = []
        self.input_blocks = []
        for i, (kind, ch) in enumerate(_enc_plan(
                mc, channel_mult, num_res_blocks, attention_resolutions)):
            heads = ch // num_head_channels if kind == "res_attn" else 0
            block = EncoderBlock(kind, cin, ch, emb, heads, num_head_channels,
                                 context_dim)
            self.add_module(f"in_{i}", block)
            self.input_blocks.append(block)
            self.enc_out_channels.append(ch)
            cin = ch
        mid = channel_mult[-1] * mc
        self.mid = MiddleBlock(mid, emb, mid // num_head_channels,
                               num_head_channels, context_dim)
        self.mid_out_channels = mid
        skips = list(self.enc_out_channels)
        self.dec_out_channels = []
        self.output_blocks = []
        h = mid
        for i, (ch, has_attn, has_up) in enumerate(_dec_plan(
                mc, channel_mult, num_res_blocks, attention_resolutions)):
            heads = ch // num_head_channels if has_attn else 0
            block = DecoderBlock(h + skips.pop(), ch, emb, has_attn, has_up,
                                 heads, num_head_channels, context_dim)
            self.add_module(f"out_{i}", block)
            self.output_blocks.append(block)
            self.dec_out_channels.append(ch)
            h = ch
        self.out_norm = GroupNorm32(mc, silu=True)
        self.out_conv = nn.Conv2d(mc, out_channels, 3, padding=1)

    def embed_time(self, t):
        return self.time_embed(timestep_embedding(t, self.model_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """The base UNet alone: x [B, H, W, C], t [B], context [B, L,
        context_dim] -> eps [B, H, W, out], in the weights' dtype."""
        dtype = self.out_conv.weight.dtype
        emb = self.embed_time(t)
        context = context.to(dtype)
        h = nchw(x.to(dtype))
        skips = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            skips.append(h)
        h = self.mid(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), emb, context)
        return nhwc(self.out_conv(self.out_norm(h)))


class ControlModule(nn.Module):
    """Ratio-width copy of the UNet encoder + middle; its input is the
    latent concatenated with the guide hint."""

    def __init__(self, in_channels: int = 4, hint_channels: int = 256,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 16, context_dim: int = 1024,
                 control_model_ratio: float = 0.2):
        super().__init__()
        full = model_channels
        mc = int(full * control_model_ratio)
        emb = full * 4
        self.model_channels = full
        # the time embedding runs at full width
        self.time_embed = TimeEmbed(full, emb)
        cin = in_channels + hint_channels
        self.enc_out_channels = []
        self.input_blocks = []
        for i, (kind, ch) in enumerate(_enc_plan(
                mc, channel_mult, num_res_blocks, attention_resolutions)):
            if kind == "res_attn":
                dim_head = find_denominator(ch, num_head_channels)
                heads = ch // dim_head
            else:
                dim_head = heads = 0
            block = EncoderBlock(kind, cin, ch, emb, heads, dim_head, context_dim)
            self.add_module(f"in_{i}", block)
            self.input_blocks.append(block)
            self.enc_out_channels.append(ch)
            cin = ch
        mid = channel_mult[-1] * mc
        dim_head = find_denominator(mid, num_head_channels)
        self.mid = MiddleBlock(mid, emb, mid // dim_head, dim_head, context_dim)
        self.mid_out_channels = mid

    def embed_time(self, t):
        return self.time_embed(timestep_embedding(t, self.model_channels))


class NoiseEstimator(nn.Module):
    """Frozen base UNet + trainable control, bridged by zero convs: both
    encoders run in lock step and the control features are added into the
    base at every block, the middle, and every decoder input."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, hint_channels: int = 256,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, ctrl_num_head_channels: int = 16,
                 context_dim: int = 1024, control_model_ratio: float = 0.2,
                 control_scale: float = 1.0, use_checkpoint: bool = False,
                 remat_policy: str | None = None):
        super().__init__()
        if remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy {remat_policy!r}: the port recomputes whole "
                "blocks only (ROADMAP Queue 1, training settings)")
        self.use_checkpoint = use_checkpoint
        common = dict(in_channels=in_channels, model_channels=model_channels,
                      num_res_blocks=num_res_blocks,
                      attention_resolutions=tuple(attention_resolutions),
                      channel_mult=tuple(channel_mult), context_dim=context_dim)
        self.base = UNetModel(out_channels=out_channels,
                              num_head_channels=num_head_channels, **common)
        self.control = ControlModule(hint_channels=hint_channels,
                                     num_head_channels=ctrl_num_head_channels,
                                     control_model_ratio=control_model_ratio,
                                     **common)
        self.context_dim = context_dim
        self.hint_channels = hint_channels
        self.control_scale = control_scale
        # the 1x1 bridges (flax zero-initialises them; a checkpoint sets them)
        base_enc = self.base.enc_out_channels
        ctrl_enc = self.control.enc_out_channels
        self.enc_zero_convs = []
        for i, (cc, cb) in enumerate(zip(ctrl_enc, base_enc)):
            conv = nn.Conv2d(cc, cb, 1)
            self.add_module(f"enc_zero_convs_out_{i}", conv)
            self.enc_zero_convs.append(conv)
        self.middle_block_out = nn.Conv2d(self.control.mid_out_channels,
                                          self.base.mid_out_channels, 1)
        # the first targets the middle's output, the rest the output of the
        # base decoder block before them
        targets = [self.base.mid_out_channels] + self.base.dec_out_channels[:-1]
        self.dec_zero_convs = []
        for i, (cc, cb) in enumerate(zip(reversed(ctrl_enc), targets)):
            conv = nn.Conv2d(cc, cb, 1)
            self.add_module(f"dec_zero_convs_out_{i}", conv)
            self.dec_zero_convs.append(conv)

    def _block(self, block: nn.Module, *args) -> torch.Tensor:
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                guide_hint: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 4], t [B], context [B, L, context_dim], guide_hint
        [B, H, W, hint] -> eps [B, H, W, 4], in the weights' dtype."""
        base, ctrl, run = self.base, self.control, self._block
        dtype = base.out_conv.weight.dtype
        x, context = x.to(dtype), context.to(dtype)
        emb_base = base.embed_time(t)
        emb_ctrl = ctrl.embed_time(t)
        scale = self.control_scale * self.control_scale
        h_base = nchw(x)
        h_ctrl = nchw(torch.cat([x, guide_hint.to(dtype)], dim=-1))
        skips_base, skips_ctrl = [], []
        for blk_b, blk_c, zc in zip(base.input_blocks, ctrl.input_blocks,
                                    self.enc_zero_convs):
            h_base = run(blk_b, h_base, emb_base, context)
            h_ctrl = run(blk_c, h_ctrl, emb_ctrl, context)
            h_base = h_base + zc(h_ctrl) * scale
            skips_base.append(h_base)
            skips_ctrl.append(h_ctrl)
        h_base = run(base.mid, h_base, emb_base, context)
        h_ctrl = run(ctrl.mid, h_ctrl, emb_ctrl, context)
        h_base = h_base + self.middle_block_out(h_ctrl) * scale
        for blk_b, zc in zip(base.output_blocks, self.dec_zero_convs):
            h_base = h_base + zc(skips_ctrl.pop()) * scale
            h_base = torch.cat([h_base, skips_base.pop()], dim=1)
            h_base = run(blk_b, h_base, emb_base, context)
        return nhwc(base.out_conv(base.out_norm(h_base)))

    def forward_unconditional(self, x: torch.Tensor, t: torch.Tensor,
                              context: torch.Tensor) -> torch.Tensor:
        """The base UNet alone, without the control branch: the
        unconditional eps of classifier-free guidance."""
        return self.base(x, t, context)
