"""GroupNorm(+SiLU) forward: a hand-written Triton kernel and its plain version.

Replaces the forward Pallas kernels of ``rdeic_tpu/ops/fused_groupnorm.py``:
``_gn_fwd_kernel`` (whole slab, through ``_run_fwd``) and the row-chunked
pair ``_gn_csum_kernel`` + ``_gn_affine_kernel`` (``_run_fwd_chunked``).
The TPU split between a whole-slab and a chunked kernel exists only to fit
VMEM; one design serves every shape here.

Layout: NCHW (the port's internal layout), so the ``C/G * H * W`` elements
of one (batch, group) pair are one contiguous span. Two launches:

1. ``_gn_stats``: grid (B*G, chunks); each program sums one chunk of one
   span into a partial (sum x, sum x^2) pair in fp32. No atomics: every
   partial has its own slot, so the result is the same on every run.
2. ``_gn_apply``: grid (B*G, chunks); each program reduces its span's
   partials in a fixed order, forms mean and 1/sqrt(var + eps), and writes
   y = x * w + off (w = inv * scale[c], off = bias[c] - mean * w), then SiLU
   when asked, in the input dtype.

Bound on the H100: memory. The function must read x once and write y once
(2 * numel * itemsize bytes at 3.35 TB/s); the kernel reads x twice, so it
can reach at most two thirds of that bound (a later PR can keep a span's
chunk in registers between the passes where it fits).

``group_norm`` runs the plain version for a tensor on the CPU and the kernel
for a tensor on the card; on the card it never falls back.
"""
from __future__ import annotations

import functools

import torch

BLOCK = 4096  # elements of one span a program handles
_DTYPES = (torch.float32, torch.bfloat16)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over NCHW `x` with fp32 statistics (var = E[x^2] - mean^2,
    clamped at 0, as flax computes it), output in the input dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = torch.clamp((xf * xf).mean(dim=-1) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    cg = c // groups
    w = inv.repeat_interleave(cg, dim=1) * weight.float()[None]  # [B, C]
    off = bias.float()[None] - mean.repeat_interleave(cg, dim=1) * w
    shape = (b, c) + (1,) * (x.dim() - 2)
    y = x.float() * w.reshape(shape) + off.reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton  # noqa: PLC0415 (absent where there is no card)
    import triton.language as tl  # noqa: PLC0415

    @triton.jit
    def _gn_stats(x_ptr, part_ptr, span, nchunk, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < span
        base = row.to(tl.int64) * span
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        slot = (row * nchunk + chunk) * 2
        tl.store(part_ptr + slot, tl.sum(x, axis=0))
        tl.store(part_ptr + slot + 1, tl.sum(x * x, axis=0))

    @triton.jit
    def _gn_apply(x_ptr, y_ptr, part_ptr, w_ptr, b_ptr, span, n, hw, cg,
                  groups, nchunk, eps, SILU: tl.constexpr, BLOCK: tl.constexpr,
                  NCHUNK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        g = row % groups
        pidx = tl.arange(0, NCHUNK)
        pmask = pidx < nchunk
        slots = (row * nchunk + pidx) * 2
        s = tl.sum(tl.load(part_ptr + slots, mask=pmask, other=0.0), axis=0)
        ss = tl.sum(tl.load(part_ptr + slots + 1, mask=pmask, other=0.0),
                    axis=0)
        mean = s / n
        var = tl.maximum(ss / n - mean * mean, 0.0)
        inv = 1.0 / tl.sqrt(var + eps)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < span
        ch = g * cg + offs // hw
        w = tl.load(w_ptr + ch, mask=mask, other=0.0).to(tl.float32) * inv
        off = tl.load(b_ptr + ch, mask=mask, other=0.0).to(tl.float32) - mean * w
        base = row.to(tl.int64) * span
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        y = x * w + off
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return _gn_stats, _gn_apply


def _check(x, weight, bias, groups):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"group_norm takes NCHW with C % groups == 0, got "
                         f"{tuple(x.shape)} and {groups} groups")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"group_norm takes contiguous {_DTYPES}, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")
    c = x.shape[1]
    for p in (weight, bias):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError("group_norm weight/bias must be contiguous [C] "
                             "on the input's device")


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW `x`: fp32 statistics, input-dtype output.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise). `group_norm.launches` counts kernel launches (two per call: the
    stats pass, then the apply pass) and `group_norm.shapes` tallies calls
    by (B, C, H, W, groups, eps, silu, dtype).
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    _check(x, weight, bias, groups)
    b, c, h, w = x.shape
    span = (c // groups) * h * w
    nchunk = -(-span // BLOCK)
    stats, apply = _kernels()
    part = torch.empty((b * groups, nchunk, 2), device=x.device,
                       dtype=torch.float32)
    y = torch.empty_like(x)
    grid = (b * groups, nchunk)
    with torch.cuda.device(x.device):
        stats[grid](x, part, span, nchunk, BLOCK=BLOCK, num_warps=8)
        group_norm.launches += 1
        apply[grid](x, y, part, weight, bias, span, float(span), h * w,
                    c // groups, groups, nchunk, float(eps), SILU=bool(silu),
                    BLOCK=BLOCK, NCHUNK=max(2, 1 << (nchunk - 1).bit_length()),
                    num_warps=8)
        group_norm.launches += 1
    key = (b, c, h, w, groups, float(eps), bool(silu),
           str(x.dtype).removeprefix("torch."))
    group_norm.shapes[key] = group_norm.shapes.get(key, 0) + 1
    return y


group_norm.launches = 0
group_norm.shapes = {}
