"""The tensor-core arithmetic of the flash kernels, emulated on the CPU.

Shared by the tests that hold the kernels' numeric design to the Pallas
kernels and to the plain versions (`tests/test_torch_port_tf32_split.py`,
`tests/test_torch_port_tf32_rounding.py`,
`tests/test_torch_port_flash_d16.py`, `tests/test_torch_port_flash_bf16.py`,
`tests/test_torch_port_flash_bwd_d64_bf16.py`,
`tests/test_torch_port_flash_bwd_d16_bf16.py`):
TF32 rounding and the 3xTF32 split of `rdeic_torch/csrc/flash_mma.cuh`,
bf16 rounding and truncation, `mma.sync`'s rounding toward zero (TF32 and
bf16 products), the
d = 64 backward kernels' tile order, and the shared-memory banks that a
fragment read touches; and `one_torch_thread`, the fixture these files
run under.
"""
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import flash_attention_lse_plain

_DROP = 0x1FFF  # the 13 low mantissa bits fp32 has and TF32 has not


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test on one torch thread. An emulation is thousands of small
    tensor ops; beside the other test workers, each op's thread pool fights
    theirs for the cores and a test of seconds takes minutes. Import it
    into a test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna's
    rounding, done as the kernels do it: add bit 12, clear the 13 bits)."""
    bits = x.float().view(torch.int32).to(torch.int64)
    out = ((bits + 0x1000) & ~_DROP).to(torch.int32)
    return out.view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: the 13 low bits dropped."""
    return (x.float().view(torch.int32) & ~_DROP).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_round(x)
    return big, tf32_truncate(x.float() - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 from 3xTF32: small * big + big * small + big * big,
    each product of TF32 values exact in fp32 and summed in fp32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 pass: both operands rounded once."""
    return tf32_round(a) @ tf32_round(b)


def mm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# -- the tensor core's rounding ----------------------------------------------
# mma.sync rounds the sum it returns toward zero, not to nearest. Modelled
# here: each pass's 8 TF32 products are summed exactly (float64) with the
# accumulator given to it, and the result is truncated to fp32.


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 x to fp32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as 8-deep mma.sync steps of three passes each (small * big,
    big * small, big * big), every pass rounded toward zero (rz32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    steps = a.shape[-1] // 8

    def step_sums(x, y):  # [step, ..., M, N]: each step's exact sum
        return (x.double().unflatten(-1, (steps, 8)).movedim(-2, 0)
                @ y.double().unflatten(-2, (steps, 8)).movedim(-3, 0))

    passes = [step_sums(x, y) for x, y in ((as_, bb), (ab, bs), (ab, bb))]
    c = torch.as_tensor(c, dtype=torch.float32)
    for i in range(steps):
        for p in passes:
            c = rz32(c.double() + p[i])
    return c


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as __floats2bfloat162_rn), in fp32."""
    return x.to(torch.bfloat16).float()


def bf16_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x cut to bf16 (its top 16 bits: toward zero), in fp32."""
    return (x.float().view(torch.int32) & ~0xFFFF).view(torch.float32)


def mma_bf16(a: torch.Tensor, b: torch.Tensor, c=0.0) -> torch.Tensor:
    """c + a @ b as 16-deep bf16 mma.sync steps (m16n8k16): a and b hold
    bf16 values, so every product is exact; each step's exact sum joins the
    accumulator and is rounded toward zero (rz32)."""
    steps = a.shape[-1] // 16
    drop = (1 << 29) - 1  # the mantissa bits float64 has beyond fp32's 23
    sums = (a.double().unflatten(-1, (steps, 16)).movedim(-2, 0)
            @ b.double().unflatten(-2, (steps, 16)).movedim(-3, 0))
    c = torch.as_tensor(c, dtype=torch.float32)
    # fast: the accumulator stays float64, each step's sum truncated in
    # place to fp32's 24 bits (rz32 wherever the sums stay in fp32's normal
    # range, as an accumulator's do); a result outside it takes rz32 step
    # by step
    acc = c.double() + sums[0]
    for i in range(steps):
        if i:
            acc.add_(sums[i])
        acc.view(torch.int64).bitwise_and_(~drop)
    out = acc.float()
    if (((out.abs() < 2.0 ** -126) & (out != 0)) | out.isinf()).any():
        out = c
        for i in range(steps):
            out = rz32(out.double() + sums[i])
    return out


# -- the d = 64 backward kernels' tile order ---------------------------------
D64 = 64
BT, KC = 64, 32  # flash_attn_bwd.cu d64: block tile rows, streamed chunk rows


def d64_inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D64)).astype(np.float32))
            for _ in range(3)]


def backward_d64_tiles(q, k, v, o, lse, do, mm, acc=None):
    """(dq, dk, dv) in the order of `flash_dq_d64` and `flash_dkv_d64`, every
    product by mm, and `acc(x, a, b)` (default x + mm(a, b)) taking the
    products into the accumulators dq, dk and dv. Both pad L to 64-row
    tiles with zero rows; rows are
    independent, so a block's warp slices are one batch dimension here.
    dq: each q row's lse comes from the forward, its di = rowsum(dO O) from
    its own dO and O; K and V stream in 32-key chunks: S = mm(Q, K^T),
    P = exp(S scale - lse) (0 on a padded row or key), dP = mm(dO, V^T),
    dS = P (dP - di) scale, dq += mm(dS, K). dkv: each key row streams Q and
    dO in 32-row chunks, lse and di by column (di from the dq pass):
    S^T = mm(K, Q^T), P^T = exp(S^T scale - lse) (0 on a padded q row),
    dP^T = mm(V, dO^T), dS^T = P^T (dP^T - di) scale, dv += mm(P^T, dO),
    dk += mm(dS^T, Q)."""
    if acc is None:
        def acc(x, a, b):
            return x + mm(a, b)
    b, seq, h, d = q.shape
    scale = d ** -0.5
    pad = -seq % BT
    qh, kh, vh, oh, doh = (
        torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, pad))
        for x in (q, k, v, o, do))  # [B, H, Lp, D]
    rows = torch.arange(seq + pad)
    valid = rows < seq
    lse_p = torch.nn.functional.pad(lse.reshape(b, h, seq), (0, pad))
    di = (doh * oh).sum(-1)  # [B, H, Lp]: 0 on the padded rows
    zero = torch.zeros((), dtype=q.dtype)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, seq + pad, KC):
        cols = slice(c0, c0 + KC)
        # dq: every q row against keys c0.. (chunks of the streamed K / V)
        s = mm(qh, kh[:, :, cols].transpose(-1, -2))
        mask = valid[:, None] & valid[cols][None, :]
        p = torch.where(mask, torch.exp(s * scale - lse_p[..., None]), zero)
        ds = p * (mm(doh, vh[:, :, cols].transpose(-1, -2)) - di[..., None]) * scale
        dq = acc(dq, ds, kh[:, :, cols])
        # dkv: every key row against q rows c0.. (chunks of the streamed Q / dO)
        st = mm(kh, qh[:, :, cols].transpose(-1, -2))
        pt = torch.where(valid[cols][None, :],
                         torch.exp(st * scale - lse_p[..., None, cols]), zero)
        dpt = mm(vh, doh[:, :, cols].transpose(-1, -2))
        dst = pt * (dpt - di[..., None, cols]) * scale
        dv = acc(dv, pt, doh[:, :, cols])
        dk = acc(dk, dst, qh[:, :, cols])
    return tuple(x[:, :, :seq].permute(0, 2, 1, 3) for x in (dq, dk, dv))


def d64_bwd_inputs(b, seq, h, seed):
    """fp32 q, k, v, dO, and the float64 forward's o and lse rounded to
    fp32 (the backward kernels start from the forward's)."""
    q, k, v = d64_inputs(b, seq, h, seed)
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    o, lse = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    return q, k, v, o.float(), lse.float(), do


def rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


# -- shared-memory banks -----------------------------------------------------
def banks(addrs) -> list:
    """The 4-byte banks (of 32) that float addresses fall on."""
    return [a % 32 for a in addrs]


def ldmatrix_phases(stride, swizzle=False, rows=BT):
    """Each 8-row matrix of one ldmatrix.x4 (RowA and RowB of flash_mma.cuh
    at a corner of multiples of 8): its 8 lanes' 16-byte rows, as the float
    addresses they cover, for every corner row a warp uses of a tile of
    `rows` rows."""
    for r0 in range(0, rows, 8):
        for c in (0, 4):
            addrs = []
            for r in range(r0, r0 + 8):
                col = c ^ (r & 4) if swizzle else c
                addrs += [r * stride + col + j for j in range(4)]
            yield addrs
