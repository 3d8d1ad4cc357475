"""The numeric design of the tensor-core flash kernels, on the CPU.

`rdeic_torch/csrc/flash_attn_{fwd,bwd}.cu` take every fp32 product of the
VAE's d = 512 attention, and `flash_fwd_d64`, `flash_dq_d64` and
`flash_dkv_d64` every fp32 product of the UNet's d = 64 attention, forward
and backward, on the tensor cores in TF32 (10 mantissa bits), as
three products of a 3xTF32 split (`csrc/flash_mma.cuh`): big = x rounded to
TF32 (to nearest, ties away from zero), small = x - big, which the tensor
core reads as TF32 by dropping its low 13 bits. This file emulates that
arithmetic in torch and holds it, in the plain forward and backward formulas
of `rdeic_torch.ops.flash_attention` and in the d = 64 kernels' own tile
order, to float64, to the Pallas kernels in interpret mode and to the plain
version within the limits that chip_smoke.py holds the kernels to on the
card; it shows that one TF32 pass breaks them, and that bf16 values are
exact in TF32, so a bf16 x bf16 tile product needs one pass. It also
counts the shared-memory banks of every fragment read of the d = 64
backward's tile layout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from rdeic_tpu.ops.flash_attention import _flash_backward, _flash_forward

D = 512
# chip_smoke.py's limits for fp32: the forward's output absolutely, the lse
# and the gradients relative to the max of each
O_TOL = 2e-5
REL_TOL = 1e-4
CASES = [(1, 130, 1), (2, 130, 2), (1, 1000, 1), (2, 1000, 2)]  # B, L, H
_DROP = 0x1FFF  # the 13 low mantissa bits fp32 has and TF32 has not


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


def forward(q, k, v, mm):
    """(o, lse) of the plain forward, [B, L, H, D] in, every product by mm;
    the softmax in the inputs' dtype."""
    b, seq, h, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, L, D]
    s = mm(qh, kh.transpose(-1, -2)) * d ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    o = mm(torch.exp(s - lse[..., None]), vh)
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, seq)


def backward(q, k, v, o, lse, do, mm):
    """(dq, dk, dv) by the formulas of flash_attention_bwd_plain, every
    product by mm."""
    b, seq, h, d = q.shape
    scale = d ** -0.5
    qh, kh, vh, oh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, o, do))
    p = torch.exp(mm(qh, kh.transpose(-1, -2)) * scale
                  - lse.reshape(b, h, seq)[..., None])
    di = (doh * oh).sum(-1)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - di[..., None]) * scale
    grads = (mm(ds, kh), mm(ds.transpose(-1, -2), qh),
             mm(p.transpose(-1, -2), doh))
    return tuple(g.permute(0, 2, 1, 3) for g in grads)


def _inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D)).astype(np.float32))
            for _ in range(4)]


def _reads(mm, b, seq, h, seed):
    """Errors of the forward and backward with products by mm against
    float64 on the same fp32 inputs: {o: max abs, lse / dq / dk / dv: max
    abs over max}. The backward of both starts from the float64 forward's
    o and lse rounded to fp32, as the kernels start from the forward's."""
    q, k, v, do = _inputs(b, seq, h, seed)
    o64, lse64 = forward(*(x.double() for x in (q, k, v)), mm_exact)
    o, lse = forward(q, k, v, mm)
    o32, l32 = o64.float(), lse64.float()
    want = backward(*(x.double() for x in (q, k, v, o32)), l32.double(),
                    do.double(), mm_exact)
    got = backward(q, k, v, o32, l32, do, mm)
    reads = {"o": (o.double() - o64).abs().max().item(),
             "lse": ((lse.double() - lse64).abs().max()
                     / lse64.abs().max()).item()}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        reads[name] = ((g.double() - w).abs().max() / w.abs().max()).item()
    return reads


def _within(reads) -> bool:
    return reads["o"] <= O_TOL and all(reads[n] <= REL_TOL
                                       for n in ("lse", "dq", "dk", "dv"))


def test_emulation_follows_the_plain_formulas():
    """With exact products, forward() and backward() are the port's plain
    versions (float64, so only the order of sums differs)."""
    q, k, v, do = (x.double() for x in _inputs(1, 130, 2, 7))
    o, lse = forward(q, k, v, mm_exact)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)
    for got, want in zip(backward(q, k, v, o, lse, do, mm_exact),
                         flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_fp32_to_the_truncated_bits(seed):
    """big + small equals x but for small's dropped bits, at most 2^-21 of
    |x|; big alone is x within half a TF32 ulp (2^-11 of |x|)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32))
    big, small = split(x)
    assert ((big.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert torch.equal(tf32_round(big), big) and torch.equal(tf32_truncate(small), small)


@pytest.mark.parametrize("b,seq,h", CASES)
def test_3xtf32_holds_the_fp32_limits(b, seq, h):
    reads = _reads(mm_3xtf32, b, seq, h, seed=seq + h)
    assert _within(reads), reads


@pytest.mark.parametrize("b,seq,h", CASES)
def test_one_tf32_pass_breaks_the_fp32_limits(b, seq, h):
    reads = _reads(mm_tf32, b, seq, h, seed=seq + h)
    assert not _within(reads), reads
    assert reads["o"] > O_TOL, reads  # the forward alone already fails


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_values_are_exact_in_tf32(seed):
    """Every bf16 value (8 significant bits) is a TF32 value, so a bf16 x
    bf16 tile product in one TF32 pass is the fp32 product of the same
    values, and the split of a bf16 operand has a zero small part."""
    q, k, _, _ = _inputs(1, 130, 1, seed)
    qb = q[0, :, 0].bfloat16().float()
    kb = k[0, :, 0].bfloat16().float()
    assert torch.equal(tf32_round(qb), qb) and torch.equal(tf32_truncate(qb), qb)
    assert torch.equal(split(kb)[1], torch.zeros_like(kb))
    every = torch.arange(-(2 ** 15), 2 ** 15, dtype=torch.int32).to(torch.int16)
    values = every.view(torch.bfloat16).float()
    finite = values[torch.isfinite(values)]
    assert torch.equal(tf32_round(finite), finite)
    assert torch.equal(mm_tf32(qb, kb.T), mm_exact(qb, kb.T))


# -- the d = 64 forward kernel's tile order ---------------------------------
D64 = 64
D64_CASES = [(1, 1000, 2), (2, 1536, 1)]  # B, L, H: a ragged and a path L


def forward_d64_tiles(q, k, v, mm):
    """(o, lse) in the order of `flash_fwd_d64`, every product by mm: the q
    rows in 16-row warp slices (padded to 64-row blocks with zero rows),
    each streaming 64-row K / V tiles (the tail zero-filled and its scores
    masked to -1e30) through an online softmax: S = mm(Q, K^T) * scale,
    m' = max(m, rowmax S), P = exp(S - m'), l = l exp(m - m') + rowsum P,
    O = O exp(m - m') + mm(P, V); then O / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30)). Rows are independent, so the slices are
    one batch dimension here."""
    b, seq, h, d = q.shape
    scale = d ** -0.5
    pad = -seq % 64
    qh, kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, pad))
                  for x in (q, k, v))  # [B, H, Lp, D]
    slices = qh.reshape(b, h, -1, 16, d)  # [B, H, warp slices, 16, D]
    m = torch.full(slices.shape[:-1], -1e30, dtype=q.dtype)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(slices)
    cols = torch.arange(64)
    for k0 in range(0, seq, 64):
        kt = kh[:, :, None, k0:k0 + 64]  # [B, H, 1, 64, D]
        vt = vh[:, :, None, k0:k0 + 64]
        s = mm(slices, kt.transpose(-1, -2)) * scale
        s = torch.where(k0 + cols < seq, s, torch.tensor(-1e30, dtype=q.dtype))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    o = (acc * (1.0 / lc)[..., None]).reshape(b, h, -1, d)[:, :, :seq]
    lse = (m + torch.log(lc)).reshape(b, h, -1)[:, :, :seq]
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, seq)


def _d64_inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D64)).astype(np.float32))
            for _ in range(3)]


def _d64_references(q, k, v):
    """The Pallas kernel in interpret mode and the port's plain version."""
    pallas = _flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            block_q=512, block_k=512, interpret=True)
    return torch.from_numpy(np.array(pallas)), flash_attention_plain(q, k, v)


def test_d64_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the tile order gives the plain
    output and lse: only the order of sums differs."""
    q, k, v = (x.double() for x in _d64_inputs(2, 200, 3, 5))
    o, lse = forward_d64_tiles(q, k, v, mm_exact)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", D64_CASES)
def test_d64_3xtf32_holds_the_fp32_limit(b, seq, h):
    """3xTF32 in the kernel's tile order lands within 2e-5 of the Pallas
    kernel and of the plain version, and its lse within 1e-4 of max."""
    q, k, v = _d64_inputs(b, seq, h, seq + h)
    o, lse = forward_d64_tiles(q, k, v, mm_3xtf32)
    for want in _d64_references(q, k, v):
        assert (o - want).abs().max().item() <= O_TOL
    want_lse = flash_attention_lse_plain(q, k, v)[1]
    assert ((lse - want_lse).abs().max() / want_lse.abs().max()).item() <= REL_TOL


@pytest.mark.parametrize("b,seq,h", D64_CASES)
def test_d64_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    q, k, v = _d64_inputs(b, seq, h, seq + h)
    o, _ = forward_d64_tiles(q, k, v, mm_tf32)
    for want in _d64_references(q, k, v):
        assert (o - want).abs().max().item() > O_TOL


# -- the d = 64 backward kernels' tile order --------------------------------
BT, KC = 64, 32  # flash_attn_bwd.cu d64: block tile rows, streamed chunk rows
D64_BWD_CASES = [(1, 1000, 2), (2, 1024, 1)]  # B, L, H: a ragged and a path L


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


def _d64_bwd_inputs(b, seq, h, seed):
    """fp32 q, k, v, dO, and the float64 forward's o and lse rounded to
    fp32 (the backward kernels start from the forward's)."""
    q, k, v = _d64_inputs(b, seq, h, seed)
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    o, lse = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    return q, k, v, o.float(), lse.float(), do


def _rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def _d64_bwd_references(q, k, v, o, lse, do):
    """{name: (dq, dk, dv)}: the Pallas kernels in interpret mode and the
    port's plain version on the same fp32 inputs."""
    pallas = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                             jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                             block_q=512, block_k=512, interpret=True)
    return {"pallas": tuple(torch.from_numpy(np.array(g)) for g in pallas),
            "plain": flash_attention_bwd_plain(q, k, v, o, lse, do)}


def test_d64_backward_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the kernels' tile order gives the
    plain backward: only the order of sums differs."""
    q, k, v, o, lse, do = (x.double() for x in _d64_bwd_inputs(2, 200, 3, 9))
    got = backward_d64_tiles(q, k, v, o, lse, do, mm_exact)
    for g, want in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", D64_BWD_CASES)
def test_d64_backward_3xtf32_holds_the_fp32_limit(b, seq, h):
    """3xTF32 in the kernels' tile order lands within 1e-4 of max of the
    Pallas kernels and of the plain version, for dq, dk and dv."""
    inputs = _d64_bwd_inputs(b, seq, h, seq + h)
    got = backward_d64_tiles(*inputs, mm_3xtf32)
    for name, want in _d64_bwd_references(*inputs).items():
        reads = [_rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= REL_TOL, (name, reads)


@pytest.mark.parametrize("b,seq,h", D64_BWD_CASES)
def test_d64_backward_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    """One TF32 pass per product misses the limit on every gradient."""
    inputs = _d64_bwd_inputs(b, seq, h, seq + h)
    got = backward_d64_tiles(*inputs, mm_tf32)
    for name, want in _d64_bwd_references(*inputs).items():
        reads = [_rel(g, w) for g, w in zip(got, want)]
        assert min(reads) > REL_TOL, (name, reads)


# -- the tensor core's rounding, over the L-long sums of dq, dk and dv --------
# mma.sync rounds the sum it returns toward zero, not to nearest. Modelled
# here: each pass's 8 TF32 products are summed exactly (float64) with the
# accumulator given to it, and the result is truncated to fp32. The kernels
# take every pass into the running accumulators, so every pass drops up to
# an ulp of them, always toward zero, and the error grows with L (the card
# reads ~1e-5 of max at L = 1024 and 5e-5 on dk at [2, 4096, 5, 64]).


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


def acc_into(x, a, b):
    """Every pass taken into the accumulator itself (`accumulate_step`)."""
    return mma_3xtf32(a, b, x)


def acc_partials(x, a, b):
    """The remedy: each 8-deep step's three passes sum from zero, and that
    sum is added to the accumulator in fp32 (to nearest)."""
    for k0 in range(0, a.shape[-1], 8):
        x = x + mma_3xtf32(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
    return x


def _rz_reads(seq, acc) -> list:
    """(dq, dk, dv) errors over max against float64, at (1, seq, 1), with
    every product on the modelled tensor core."""
    inputs = _d64_bwd_inputs(1, seq, 1, seq + 1)
    want = flash_attention_bwd_plain(*(x.double() for x in inputs))
    got = backward_d64_tiles(*inputs, mma_3xtf32, acc)
    return [_rel(g, w) for g, w in zip(got, want)]


def test_d64_backward_rounding_toward_zero_grows_with_l_in_one_accumulator():
    """The kernels' order reads ~1e-5 of max at L = 1024, as the card reads
    at L = 1000-1024, and the error grows with L."""
    short, long = _rz_reads(256, acc_into), _rz_reads(1024, acc_into)
    assert min(long) > 5e-6, long
    assert all(b > 2 * a for a, b in zip(short, long)), (short, long)


def test_d64_backward_per_step_partials_keep_the_error_flat():
    """With per-step partials added in fp32 the error stays at a few 1e-6
    of max and does not grow from L = 256 to 1024: the remedy, if a longer
    L ever needs the margin (it costs the kernels registers)."""
    short, long = _rz_reads(256, acc_partials), _rz_reads(1024, acc_partials)
    assert max(long) < 5e-6, long
    assert max(long) < 1.5 * max(short), (short, long)


# -- shared-memory banks of the d = 64 backward's fragment reads -------------
TS = 68  # flash_attn_bwd.cu d64::TS: row stride in floats, not swizzled


def _banks(addrs) -> list:
    """The 4-byte banks (of 32) that float addresses fall on."""
    return [a % 32 for a in addrs]


def _ldmatrix_phases(stride, swizzle=False):
    """Each 8-row matrix of one ldmatrix.x4 (RowA and RowB of flash_mma.cuh
    at a corner of multiples of 8): its 8 lanes' 16-byte rows, as the float
    addresses they cover, for every corner row a warp uses."""
    for r0 in range(0, BT, 8):
        for c in (0, 4):
            addrs = []
            for r in range(r0, r0 + 8):
                col = c ^ (r & 4) if swizzle else c
                addrs += [r * stride + col + j for j in range(4)]
            yield addrs


def _row_pair_reads(stride, swizzle=False):
    """The B reads of `accumulate` (P or dS times a streamed tile): lane
    (g, t) reads rows 8 kk + 2t and 8 kk + 2t + 1 at column 8 n + g; one
    32-lane phase per (kk, n, row of the pair)."""
    for kk in range(KC // 8):
        for n in range(64 // 8):
            for e in (0, 1):
                addrs = []
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r, c = 8 * kk + 2 * t + e, 8 * n + g
                    addrs.append(r * stride + (c ^ (r & 4) if swizzle else c))
                yield addrs


def test_d64_backward_fragment_reads_hit_32_banks():
    """The tiles of the d = 64 backward (stride 68, no swizzle) are read as
    ldmatrix A and B^T fragments (Q, dO, O in dq; K, V in dkv; the streamed
    tiles' scores) and as row-pair B fragments (the streamed tile in dq +=
    dS K, dv += P^T dO and dk += dS^T Q): every phase hits 32 distinct
    banks. cp.async writes 16 bytes a lane, 8 lanes a phase: 32 banks too.
    The forward's swizzled stride 72 would put the row-pair read two-way on
    its banks."""
    for phase in _ldmatrix_phases(TS):
        assert sorted(_banks(phase)) == list(range(32))
    for phase in _row_pair_reads(TS):
        assert sorted(_banks(phase)) == list(range(32))
    for lane0 in range(0, 64 * 16, 8):  # 64 rows of 16 chunks of 4 floats
        addrs = [(i // 16) * TS + (i % 16) * 4 + j
                 for i in range(lane0, lane0 + 8) for j in range(4)]
        assert sorted(_banks(addrs)) == list(range(32))
    # the forward's K layout, swizzled stride 72: ldmatrix conflict-free,
    # the row-pair read not
    for phase in _ldmatrix_phases(72, swizzle=True):
        assert sorted(_banks(phase)) == list(range(32))
    assert all(len(set(_banks(p))) == 16 for p in _row_pair_reads(72, True))


def test_d64_backward_row_terms_are_read_as_broadcasts():
    """dkv reads lse and di of q columns 8 n + 2t, 2t + 1 (float2): the
    8 lanes of one t share an address, the 4 addresses take 8 banks."""
    for c0 in range(0, BT, KC):
        for n in range(KC // 8):
            addrs = {c0 + 8 * n + 2 * (lane & 3) for lane in range(32)}
            banks = [b for a in addrs for b in _banks((a, a + 1))]
            assert len(addrs) == 4 and len(set(banks)) == 8
