"""GroupNorm(+SiLU): the hand-written kernels, their plain versions, and the
autograd function that joins them.

Replaces the Pallas kernels of ``rdeic_tpu/ops/fused_groupnorm.py``. The
forward ``_gn_fwd_kernel`` (whole slab, ``_run_fwd``) and the row-chunked
pair ``_gn_csum_kernel`` + ``_gn_affine_kernel`` (``_run_fwd_chunked``)
become one CUDA kernel, ``rdeic_torch/csrc/group_norm_fwd.cu``; the backward
``_gn_bwd_kernel`` (whole slab, ``_group_norm_bwd``) and the chunked pair
``_gn_bstat_kernel`` + ``_gn_bdx_kernel`` (``_run_bwd_chunked``) become one
CUDA kernel, ``rdeic_torch/csrc/group_norm_bwd.cu``. The TPU split between a
whole-slab and a chunked kernel exists only to fit VMEM; one design serves
every shape here. Each .cu file's header has its design.

Forward, one launch: one thread-block cluster of up to 8 CTAs per (batch,
group) span of C/G * H * W elements; each CTA sums its slice, the cluster
combines the partial (sum x, sum x^2) pairs in rank order through
distributed shared memory (no atomics: the same result on every run), and
each CTA writes y = x * w + off (w = inv * scale[c], off = bias[c] - mean *
w), then SiLU when asked, in the input dtype. Under autograd it also stores
the span's mean and 1/std ((B, G) fp32): the backward rebuilds x_hat from x
and these, so no second slab is saved. `group_norm_plan` (pure Python,
tested on the CPU) picks the cluster size, the slices and the shared memory.

Backward, one launch, clusters as the forward's (`group_norm_bwd_plan`),
with dp = dy through the SiLU when fused (p = x_hat * g + b,
dp = dy * sigmoid(p) * (1 + p * (1 - sigmoid(p)))): each CTA forms x_hat and
dp of its slice, keeps them in shared memory, and sums (dp, dp * x_hat) per
channel; the cluster adds each channel's partials in rank order through
distributed shared memory and forms the group moments m1 = mean(dp * g) and
m2 = mean(dp * g * x_hat); each CTA writes dx = inv * (dp * g - m1 - x_hat *
m2); and the last span of a group to finish sums dscale and dbias over the
batch in b order (an integer arrival counter picks it; no value is added
atomically, so every run gives the same bits).

Bound on the H100: memory. The forward must read x and write y
(2 * numel * itemsize bytes at 3.35 TB/s) and reads x from HBM once where a
slice fits a CTA's shared memory (every shape of the paths); the backward
must read x and dy and write dx (3 * numel * itemsize) and reads x and dy
once where a slice is resident (every shape of the training paths), twice
where the span streams.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rdeic_torch import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtypes
_DTYPES = tuple(_DTYPE_CODES)
# The forward kernel's launch plan (csrc/group_norm_fwd.cu)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100
SCRATCH_BYTES = 320  # the kernel's reduction scratch ahead of the slice
MAX_CLUSTER = 8  # CTAs in a cluster: the portable limit
CTA_BYTES = 16384  # span bytes per CTA below which the cluster stays smaller
MAX_THREADS = 512
# The backward kernel's launch plan (csrc/group_norm_bwd.cu): shared-memory
# floats ahead of the channel partials, and units (16-byte vectors, or
# elements) of one phase-1 task
BWD_HEAD_FLOATS = 72
BWD_TASK_UNITS = 128


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


class GroupNormBwdPlan(NamedTuple):
    """How the backward kernel covers one (batch, group) span."""
    span: int  # elements of a span: C/G * H * W
    cluster: int  # CTAs of the span's cluster (1..MAX_CLUSTER)
    chunk: int  # span elements a CTA takes (the last CTA may take fewer)
    threads: int  # threads of a CTA
    vec: bool  # 16-byte loads and stores
    resident: bool  # x_hat and dp of the slice stay in shared memory
    nch: int  # channel partials a CTA has room for
    tasks: int  # phase-1 tasks (a warp each) a CTA has room for
    smem_bytes: int  # dynamic shared memory of a CTA

    def slices(self) -> list[tuple[int, int]]:
        """[lo, hi) of each CTA of a cluster, in rank order."""
        return [(r * self.chunk, min(self.span, (r + 1) * self.chunk))
                for r in range(self.cluster)]


@functools.lru_cache(maxsize=None)
def group_norm_bwd_plan(shape: tuple, groups: int, itemsize: int,
                        aligned: bool = True,
                        smem_limit: int = SMEM_LIMIT) -> GroupNormBwdPlan:
    """The backward kernel's launch plan for NCHW `shape` in `groups`.

    As `group_norm_plan`, but a resident slice keeps two fp32 arrays (x_hat
    and dp, whatever the input dtype), so the cluster grows by one CTA per
    CTA_BYTES of 8 bytes an element. Ahead of the slice sit the head
    (BWD_HEAD_FLOATS), the channel partials (2 floats for each channel a
    slice can touch: at most (chunk - 1) // (H * W) + 2, and no more than
    C/G) and the task partials (2 floats for each task: BWD_TASK_UNITS
    units of one channel), rounded up to 16 bytes.
    """
    _, c, h, w = shape
    hw = h * w
    cg = c // groups
    span = cg * hw
    per_vec = 16 // itemsize
    vec = aligned and hw % per_vec == 0
    unit = per_vec if vec else 1
    cluster = min(MAX_CLUSTER, max(1, _cdiv(span * 8, CTA_BYTES)))
    chunk = _cdiv(_cdiv(span, cluster), unit) * unit
    cluster = _cdiv(span, chunk)  # no CTA without elements
    nch = min(cg, (chunk - 1) // hw + 2)
    tasks = nch * _cdiv(hw // unit, BWD_TASK_UNITS)
    head = _cdiv(BWD_HEAD_FLOATS + 2 * nch + 2 * tasks, 4) * 4
    resident = 4 * (head + 2 * chunk) <= smem_limit
    smem = 4 * (head + (2 * chunk if resident else 0))
    threads = min(MAX_THREADS, max(128, _cdiv(chunk // unit, 128) * 32))
    return GroupNormBwdPlan(span, cluster, chunk, threads, vec, resident, nch,
                            tasks, smem)


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_group_norm_bwd()))
    vp = ctypes.c_void_p
    lib.rdeic_group_norm_bwd.restype = ctypes.c_int
    lib.rdeic_group_norm_bwd.argtypes = [vp] * 11 + [
        ctypes.POINTER(ctypes.c_int), vp]
    lib.rdeic_group_norm_bwd_error_string.restype = ctypes.c_char_p
    lib.rdeic_group_norm_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_args(shape, groups, dtype, weight_dtype, bias_dtype, silu, aligned,
              plan=None):
    """(the launch's integers as a C int array, the tally key) for one call
    signature, built once, as `_fwd_args`. `plan` defaults to
    `group_norm_bwd_plan`."""
    if weight_dtype != bias_dtype or weight_dtype not in _DTYPE_CODES:
        raise ValueError("group_norm weight and bias must share fp32 or bf16, "
                         f"got {weight_dtype} and {bias_dtype}")
    b, c, h, w = shape
    if plan is None:
        plan = group_norm_bwd_plan(tuple(shape), groups, dtype.itemsize,
                                   aligned)
    if max(plan.span, b * groups * plan.cluster, b * c * 2) >= 2 ** 31:
        raise ValueError(f"group_norm takes spans and grids < 2^31, got "
                         f"{shape} in {groups} groups")
    ints = (b * groups, plan.span, h * w, c // groups, groups, c, b,
            plan.cluster, plan.chunk, plan.threads, plan.smem_bytes,
            plan.resident, plan.vec, plan.nch, silu, _DTYPE_CODES[dtype],
            _DTYPE_CODES[weight_dtype])
    key = _shape_key(shape, dtype, groups, None, silu)
    return (ctypes.c_int * len(ints))(*ints), key


_SCRATCH: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, groups: int, nsums: int):
    """The backward kernel's scratch on `device`: per-group arrival counters
    (int32 zeros; a launch leaves them at zero for the next) and `nsums`
    fp32 of per-(b, c) sums, made once and grown when a call needs more.
    The launches that share them are ordered on one stream."""
    arrivals, sums = _SCRATCH.get(device.index, (None, None))
    if arrivals is None or arrivals.numel() < groups:
        arrivals = torch.zeros(max(groups, 32), device=device,
                               dtype=torch.int32)
    if sums is None or sums.numel() < nsums:
        sums = torch.empty(max(nsums, 1 << 16), device=device,
                           dtype=torch.float32)
    _SCRATCH[device.index] = arrivals, sums
    return arrivals, sums


def _launch_bwd(x, weight, bias, mean, inv, dy, groups, silu,
                plan: GroupNormBwdPlan | None = None):
    """One launch of the backward kernel: (dx, dscale, dbias). `plan`
    defaults to `group_norm_bwd_plan` of x."""
    _check(x, weight, bias, groups, dy)
    b, c = x.shape[:2]
    for t in (mean, inv):
        if (t.shape != (b, groups) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"mean and inv must be contiguous fp32 (B, G) = "
                             f"{(b, groups)} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch_bwd(x, weight, bias, mean, inv, dy, groups, silu,
                               plan)
    dx = torch.empty_like(x)
    dsb = torch.empty((2, c), device=x.device, dtype=weight.dtype)
    dscale, dbias = dsb.unbind(0)
    if x.numel() == 0:
        return dx, dscale.zero_(), dbias.zero_()
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    args, key = _bwd_args(x.shape, groups, x.dtype, weight.dtype, bias.dtype,
                          bool(silu), aligned, plan)
    arrivals, sums = _scratch(x.device, groups, 2 * b * c)
    lib = _bwd_library()
    ptr = dsb.data_ptr()
    err = lib.rdeic_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), ptr,
        ptr + c * dsb.element_size(), sums.data_ptr(), arrivals.data_ptr(),
        args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = (lib.rdeic_group_norm_bwd_error_string(err).decode() if err > 0
               else "unsupported plan or dtype")
        raise RuntimeError(f"group_norm_bwd launch failed: {msg}")
    _tally(group_norm_bwd, key, 1)
    return dx, dscale, dbias


def group_norm_bwd(x, weight, bias, mean, inv, dy, groups: int,
                   silu: bool = False):
    """(dx, dscale, dbias) from the forward's (B, G) fp32 mean and 1/std.
    CUDA tensors launch the backward kernel once (counted in
    `group_norm_bwd.launches`); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return group_norm_bwd_plain(x, weight, bias, mean, inv, dy, groups,
                                    silu)
    return _launch_bwd(x, weight, bias, mean, inv, dy, groups, silu)


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
    silu, dtype); `group_norm_bwd` keeps the same for the backward (one
    launch per call; eps is None there). Without autograd the forward runs
    alone and stores no statistics, which spares the serving path the
    autograd function's host time and two allocations.
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
