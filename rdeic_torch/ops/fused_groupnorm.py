"""GroupNorm(+SiLU): the hand-written kernels, their plain versions, and the
autograd function that joins them.

Replaces the Pallas kernels of ``rdeic_tpu/ops/fused_groupnorm.py``. The
forward ``_gn_fwd_kernel`` (whole slab, ``_run_fwd``) and the row-chunked
pair ``_gn_csum_kernel`` + ``_gn_affine_kernel`` (``_run_fwd_chunked``)
become one CUDA kernel, ``rdeic_torch/csrc/group_norm_fwd.cu``; the backward
``_gn_bwd_kernel`` (whole slab, ``_group_norm_bwd``) and the chunked pair
``_gn_bstat_kernel`` + ``_gn_bdx_kernel`` (``_run_bwd_chunked``) become one
Triton moments + dx pair. The TPU split between a whole-slab and a chunked
kernel exists only to fit VMEM; one design serves every shape here.

Forward, one launch (the .cu file's header has the design): one
thread-block cluster of up to 8 CTAs per (batch, group) span of C/G * H * W
elements; each CTA sums its slice, the cluster combines the partial
(sum x, sum x^2) pairs in rank order through distributed shared memory (no
atomics: the same result on every run), and each CTA writes
y = x * w + off (w = inv * scale[c], off = bias[c] - mean * w), then SiLU
when asked, in the input dtype. Under autograd it also stores the span's
mean and 1/std ((B, G) fp32): the backward rebuilds x_hat from x and these,
so no second slab is saved. `group_norm_plan` (pure Python, tested on the
CPU) picks the cluster size, the slices and the shared memory.

Backward, two launches over (batch, channel) spans of H * W elements, with
dp = dy through the SiLU when fused (p = x_hat * g + b,
dp = dy * sigmoid(p) * (1 + p * (1 - sigmoid(p)))):

1. ``_gn_bstat``: grid (B*C, chunks); per-chunk partial sums of dp and
   dp * x_hat, each in its own slot (no atomics, fixed-order reduce).
2. small torch reductions, as ``_run_bwd_chunked`` does in jnp: dscale and
   dbias over the batch, the group moments m1 = mean(dp * g) and
   m2 = mean(dp * g * x_hat);
3. ``_gn_bdx``: grid (B*C, chunks); dx = inv * (dp * g - m1 - x_hat * m2).

Bound on the H100: memory. The forward must read x and write y
(2 * numel * itemsize bytes at 3.35 TB/s) and reads x from HBM once where a
slice fits a CTA's shared memory (every shape of the paths); the backward
must read x and dy and write dx (3 * numel * itemsize) and reads x and dy
twice, so it reaches at most two thirds of its bound.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rdeic_torch import build

BLOCK = 4096  # elements of one span a backward program handles
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtypes
_DTYPES = tuple(_DTYPE_CODES)
# The forward kernel's launch plan (csrc/group_norm_fwd.cu)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100
SCRATCH_BYTES = 320  # the kernel's reduction scratch ahead of the slice
MAX_CLUSTER = 8  # CTAs in a cluster: the portable limit
CTA_BYTES = 16384  # span bytes per CTA below which the cluster stays smaller
MAX_THREADS = 512


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 statistics for fp32 and bf16; float64 stays float64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _per_channel(v: torch.Tensor, cg: int, ndim: int) -> torch.Tensor:
    """(B, G) -> (B, C, 1, ...) broadcastable against an `ndim`-dim x."""
    v = v.repeat_interleave(cg, dim=1)
    return v.reshape(v.shape + (1,) * (ndim - 2))


def group_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         silu: bool = False):
    """(y, mean, inv): GroupNorm over NCHW `x` with fp32 statistics
    (var = E[x^2] - mean^2, clamped at 0, as flax computes it), y in the
    input dtype, mean and 1/std as (B, G)."""
    ct = _compute_dtype(x.dtype)
    b, c = x.shape[:2]
    xf = x.to(ct).reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = torch.clamp((xf * xf).mean(dim=-1) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    cg = c // groups
    w = inv.repeat_interleave(cg, dim=1) * weight.to(ct)[None]  # [B, C]
    off = bias.to(ct)[None] - mean.repeat_interleave(cg, dim=1) * w
    shape = (b, c) + (1,) * (x.dim() - 2)
    y = x.to(ct) * w.reshape(shape) + off.reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), mean, inv


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """The output of `group_norm_fwd_plain`."""
    return group_norm_fwd_plain(x, weight, bias, groups, eps, silu)[0]


def group_norm_bwd_plain(x, weight, bias, mean, inv, dy, groups: int,
                         silu: bool = False):
    """(dx, dscale, dbias) by the formulas of the backward kernels (not
    through autograd), from the saved input and (B, G) mean and 1/std."""
    ct = _compute_dtype(x.dtype)
    b, c = x.shape[:2]
    cg = c // groups
    nd = x.dim()
    xhat = (x.to(ct) - _per_channel(mean.to(ct), cg, nd)) \
        * _per_channel(inv.to(ct), cg, nd)
    shape = (1, c) + (1,) * (nd - 2)
    g = weight.to(ct).reshape(shape)
    dyf = dy.to(ct)
    if silu:
        p = xhat * g + bias.to(ct).reshape(shape)
        sig = torch.sigmoid(p)
        dp = dyf * sig * (1.0 + p * (1.0 - sig))
    else:
        dp = dyf
    dims = tuple(range(2, nd))
    sdp = dp.sum(dim=dims)  # [B, C]
    sdpx = (dp * xhat).sum(dim=dims)
    n = cg * x[0, 0].numel()
    gc = weight.to(ct)[None]
    m1 = (sdp * gc).reshape(b, groups, cg).sum(-1) / n
    m2 = (sdpx * gc).reshape(b, groups, cg).sum(-1) / n
    dx = _per_channel(inv.to(ct), cg, nd) * (
        dp * g - _per_channel(m1, cg, nd) - xhat * _per_channel(m2, cg, nd))
    return (dx.to(x.dtype), sdpx.sum(0).to(weight.dtype),
            sdp.sum(0).to(bias.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    import triton  # noqa: PLC0415 (absent where there is no card)
    import triton.language as tl  # noqa: PLC0415

    @triton.jit
    def _dp_xhat(x_ptr, dy_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, row, hw,
                 channels, groups, cg, offs, mask, SILU: tl.constexpr):
        """(dp, x_hat, inv, gamma, group row) of one chunk of a (b, c) span."""
        c = row % channels
        grow = (row // channels) * groups + c // cg
        mean = tl.load(mean_ptr + grow)
        inv = tl.load(inv_ptr + grow)
        gamma = tl.load(w_ptr + c).to(tl.float32)
        base = row.to(tl.int64) * hw
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean) * inv
        if SILU:
            p = xhat * gamma + tl.load(b_ptr + c).to(tl.float32)
            sig = tl.sigmoid(p)
            dp = dy * sig * (1.0 + p * (1.0 - sig))
        else:
            dp = dy
        return dp, xhat, inv, gamma, grow

    @triton.jit
    def _gn_bstat(x_ptr, dy_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, part_ptr,
                  hw, channels, groups, cg, nchunk, SILU: tl.constexpr,
                  BLOCK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < hw
        dp, xhat, _, _, _ = _dp_xhat(x_ptr, dy_ptr, mean_ptr, inv_ptr, w_ptr,
                                     b_ptr, row, hw, channels, groups, cg,
                                     offs, mask, SILU)
        dp = tl.where(mask, dp, 0.0)
        slot = (row * nchunk + chunk) * 2
        tl.store(part_ptr + slot, tl.sum(dp, axis=0))
        tl.store(part_ptr + slot + 1, tl.sum(dp * xhat, axis=0))

    @triton.jit
    def _gn_bdx(x_ptr, dy_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, m1_ptr,
                m2_ptr, dx_ptr, hw, channels, groups, cg, SILU: tl.constexpr,
                BLOCK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        offs = chunk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < hw
        dp, xhat, inv, gamma, grow = _dp_xhat(
            x_ptr, dy_ptr, mean_ptr, inv_ptr, w_ptr, b_ptr, row, hw, channels,
            groups, cg, offs, mask, SILU)
        m1 = tl.load(m1_ptr + grow)
        m2 = tl.load(m2_ptr + grow)
        dx = inv * (dp * gamma - m1 - xhat * m2)
        base = row.to(tl.int64) * hw
        tl.store(dx_ptr + base + offs, dx.to(dx_ptr.dtype.element_ty),
                 mask=mask)

    return _gn_bstat, _gn_bdx


def _check(x, weight, bias, groups, *same_as_x):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"group_norm takes NCHW with C % groups == 0, got "
                         f"{tuple(x.shape)} and {groups} groups")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"group_norm takes contiguous {_DTYPES}, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")
    for t in same_as_x:
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError("group_norm gradients must match x: contiguous "
                             f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    for p in (weight, bias):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError("group_norm weight/bias must be contiguous [C] "
                             "on the input's device")


def _shape_key(shape, dtype, groups, eps, silu):
    """The tally key of a call: (B, C, H, W, groups, eps, silu, dtype)."""
    b, c, h, w = shape
    return (b, c, h, w, groups, eps, bool(silu),
            str(dtype).removeprefix("torch."))


def _tally(fn, key, launches: int) -> None:
    """One call of `fn` (`launches` kernel launches), tallied by shape."""
    fn.launches += launches
    fn.shapes[key] = fn.shapes.get(key, 0) + 1


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GroupNormPlan(NamedTuple):
    """How the forward kernel covers one (batch, group) span."""
    span: int  # elements of a span: C/G * H * W
    cluster: int  # CTAs of the span's cluster (1..MAX_CLUSTER)
    chunk: int  # span elements a CTA takes (the last CTA may take fewer)
    threads: int  # threads of a CTA
    vec: bool  # 16-byte loads and stores
    resident: bool  # the slice lives in shared memory: x is read once
    smem_bytes: int  # dynamic shared memory of a CTA

    def slices(self) -> list[tuple[int, int]]:
        """[lo, hi) of each CTA of a cluster, in rank order."""
        return [(r * self.chunk, min(self.span, (r + 1) * self.chunk))
                for r in range(self.cluster)]


@functools.lru_cache(maxsize=None)
def group_norm_plan(shape: tuple, groups: int, itemsize: int,
                    aligned: bool = True,
                    smem_limit: int = SMEM_LIMIT) -> GroupNormPlan:
    """The forward kernel's launch plan for NCHW `shape` in `groups`.

    The cluster grows by one CTA per CTA_BYTES of span, up to MAX_CLUSTER;
    each CTA takes a slice of `chunk` elements, a multiple of the 16-byte
    vector when the vector path runs (H * W a multiple of it and `aligned`
    pointers), so a vector never crosses a channel or a slice. The slice
    stays in shared memory (`resident`) when it fits `smem_limit` beside the
    scratch; otherwise the kernel streams it twice from global memory.
    """
    _, c, h, w = shape
    hw = h * w
    span = (c // groups) * hw
    per_vec = 16 // itemsize
    vec = aligned and hw % per_vec == 0
    unit = per_vec if vec else 1
    cluster = min(MAX_CLUSTER, max(1, _cdiv(span * itemsize, CTA_BYTES)))
    chunk = _cdiv(_cdiv(span, cluster), unit) * unit
    cluster = _cdiv(span, chunk)  # no CTA without elements
    resident = SCRATCH_BYTES + chunk * itemsize <= smem_limit
    smem = SCRATCH_BYTES + (chunk * itemsize if resident else 0)
    # about four vectors (or elements) a thread, 128 to MAX_THREADS threads
    threads = min(MAX_THREADS, max(128, _cdiv(chunk // unit, 128) * 32))
    return GroupNormPlan(span, cluster, chunk, threads, vec, resident, smem)


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_group_norm()))
    vp = ctypes.c_void_p
    lib.rdeic_group_norm_fwd.restype = ctypes.c_int
    lib.rdeic_group_norm_fwd.argtypes = [vp] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, vp]
    lib.rdeic_group_norm_error_string.restype = ctypes.c_char_p
    lib.rdeic_group_norm_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_args(shape, groups, dtype, weight_dtype, bias_dtype, eps, silu,
              aligned, plan=None):
    """(the launch's integers as a C int array, the tally key) for one call
    signature, built once: the host path of a call is then one ctypes call
    of nine arguments. `plan` defaults to `group_norm_plan`."""
    if weight_dtype != bias_dtype or weight_dtype not in _DTYPE_CODES:
        raise ValueError("group_norm weight and bias must share fp32 or bf16, "
                         f"got {weight_dtype} and {bias_dtype}")
    b, c, h, w = shape
    if plan is None:
        plan = group_norm_plan(tuple(shape), groups, dtype.itemsize, aligned)
    if max(plan.span, b * groups * plan.cluster) >= 2 ** 31:  # int32 args
        raise ValueError(f"group_norm takes spans and grids < 2^31, got "
                         f"{shape} in {groups} groups")
    ints = (b * groups, plan.span, h * w, c // groups, groups, plan.cluster,
            plan.chunk, plan.threads, plan.smem_bytes, plan.resident,
            plan.vec, silu, _DTYPE_CODES[dtype], _DTYPE_CODES[weight_dtype])
    key = _shape_key(shape, dtype, groups, eps, silu)
    return (ctypes.c_int * len(ints))(*ints), key


def _launch_fwd(x, weight, bias, groups, eps, silu, stats: bool,
                plan: GroupNormPlan | None = None):
    """One launch of the forward kernel: y, and (mean, inv) when `stats`
    (else None, None). `plan` defaults to `group_norm_plan` of x."""
    _check(x, weight, bias, groups)
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch_fwd(x, weight, bias, groups, eps, silu, stats, plan)
    y = torch.empty_like(x)
    mean = inv = None
    if stats:
        mean, inv = torch.empty((2, x.shape[0], groups), device=x.device,
                                dtype=torch.float32)
    if x.numel() == 0:
        return y, mean, inv
    args, key = _fwd_args(x.shape, groups, x.dtype, weight.dtype, bias.dtype,
                          float(eps), bool(silu), x.data_ptr() % 16 == 0, plan)
    lib = _fwd_library()
    err = lib.rdeic_group_norm_fwd(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        mean.data_ptr() if stats else None, inv.data_ptr() if stats else None,
        args, eps, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = (lib.rdeic_group_norm_error_string(err).decode() if err > 0
               else "unsupported plan or dtype")
        raise RuntimeError(f"group_norm_fwd launch failed: {msg}")
    _tally(group_norm, key, 1)
    return y, mean, inv


def group_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, silu: bool = False):
    """(y, mean, inv) of GroupNorm(+SiLU) over NCHW `x`. CUDA tensors launch
    the forward kernel once (counted in `group_norm.launches`); CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return group_norm_fwd_plain(x, weight, bias, groups, eps, silu)
    return _launch_fwd(x, weight, bias, groups, eps, silu, stats=True)


def group_norm_bwd(x, weight, bias, mean, inv, dy, groups: int,
                   silu: bool = False):
    """(dx, dscale, dbias). CUDA tensors launch the moments and dx kernels
    (two launches, counted in `group_norm_bwd.launches`) around small torch
    reductions; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return group_norm_bwd_plain(x, weight, bias, mean, inv, dy, groups,
                                    silu)
    _check(x, weight, bias, groups, dy)
    b, c, h, w = x.shape
    if mean.shape != (b, groups) or inv.shape != (b, groups):
        raise ValueError(f"mean and inv must be (B, G) = {(b, groups)}")
    hw, cg = h * w, c // groups
    block = min(BLOCK, max(128, _pow2(hw)))
    nchunk = -(-hw // block)
    bstat, bdx = _bwd_kernels()
    part = torch.empty((b * c, nchunk, 2), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x)
    grid = (b * c, nchunk)
    mean, inv = mean.contiguous(), inv.contiguous()
    with torch.cuda.device(x.device):
        bstat[grid](x, dy, mean, inv, weight, bias, part, hw, c, groups, cg,
                    nchunk, SILU=bool(silu), BLOCK=block, num_warps=4)
        sums = part.sum(dim=1).reshape(b, c, 2)
        sdp, sdpx = sums[..., 0], sums[..., 1]
        gc = weight.float()[None]
        n = float(cg * hw)
        m1 = ((sdp * gc).reshape(b, groups, cg).sum(-1) / n).contiguous()
        m2 = ((sdpx * gc).reshape(b, groups, cg).sum(-1) / n).contiguous()
        bdx[grid](x, dy, mean, inv, weight, bias, m1, m2, dx, hw, c, groups,
                  cg, SILU=bool(silu), BLOCK=block, num_warps=4)
    _tally(group_norm_bwd,
           _shape_key(x.shape, x.dtype, groups, None, silu), 2)
    return dx, sdpx.sum(0).to(weight.dtype), sdp.sum(0).to(bias.dtype)


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        y, mean, inv = group_norm_fwd(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, inv)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = group_norm_bwd(x, weight, bias, mean, inv,
                                           dy.contiguous(), ctx.groups,
                                           ctx.silu)
        return dx, dscale, dbias, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW `x`: fp32 statistics, input-dtype output,
    differentiable through the backward kernels.

    CPU tensors take the plain versions; CUDA tensors launch the kernels (or
    raise). `group_norm.launches` counts forward kernel launches (one per
    call) and `group_norm.shapes` tallies calls by (B, C, H, W, groups, eps,
    silu, dtype); `group_norm_bwd` keeps the same for the backward (two
    launches per call: moments, then dx; eps is None there). Without
    autograd the forward runs alone and stores no statistics, which spares
    the serving path the autograd function's host time and two allocations.
    """
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, weight, bias, groups, eps, silu)
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    return _launch_fwd(x, weight, bias, groups, eps, silu, stats=False)[0]


for _fn in (group_norm, group_norm_bwd):
    _fn.launches = 0
    _fn.shapes = {}
