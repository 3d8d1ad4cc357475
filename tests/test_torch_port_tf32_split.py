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
exact in TF32, so a bf16 x bf16 tile product needs one pass. The d = 64
forward runs on `wgmma` (three instructions an 8-deep step), whose
rounding the emulation takes as the card shows it (`wgmma_3xtf32`,
`tests/torch_port_tf32.py`); the file checks the layout of the forward's
V^T operand. The emulation lives in `tests/torch_port_tf32.py`; the d = 64
backward's own design on `wgmma` (its rounding over long sums, per-tile
partials, planes and banks) is held in
`tests/test_torch_port_flash_bwd_d64_fp32.py`.
"""
import math

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
from tests.torch_port_tf32 import (
    backward_d64_tiles,
    d64_bwd_inputs,
    d64_inputs,
    mm_3xtf32,
    mm_exact,
    mm_tf32,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
    split,
    swizzle128,
    tf32_round,
    tf32_truncate,
    wgmma_3xtf32,
    wgmma_reads,
    wgmma_tf32,
)

D = 512
# chip_smoke.py's limits for fp32: the forward's output absolutely, the lse
# and the gradients relative to the max of each
O_TOL = 2e-5
REL_TOL = 1e-4
CASES = [(1, 130, 1), (2, 130, 2), (1, 1000, 1), (2, 1000, 2)]  # B, L, H


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
D64_CASES = [(1, 1000, 2), (2, 1536, 1)]  # B, L, H: a ragged and a path L
LOG2E = 1.4426950408889634


def forward_d64_tiles(q, k, v, mm):
    """(o, lse) in the order of `flash_fwd_d64` (wgmma, 3xTF32), every
    tile's product by mm from zero: the q rows in the consumers' 64-row
    slices (two a 128-row block, padded with zero rows), each streaming
    64-key K / V tiles (the tail zero-filled and its scores masked to
    -1e30) through an online softmax in log2 units: S = mm(Q, K^T),
    m' = max(m, rowmax(S) c) with c = d^-1/2 log2(e), P = 2^(S c - m'),
    alpha = 2^(m - m'), l = l alpha + rowsum P, and P V into a partial from
    zero that joins O by one fma, O = fma(O, alpha, mm(P, V)); then
    O / max(l, 1e-30) and lse = m ln 2 + ln max(l, 1e-30). Rows are
    independent, so the slices are one batch dimension here."""
    b, seq, h, d = q.shape
    c = d ** -0.5 * LOG2E
    pad, padk = -seq % 128, -seq % 64
    qh = torch.nn.functional.pad(q.permute(0, 2, 1, 3), (0, 0, 0, pad))
    kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, padk))
              for x in (k, v))  # [B, H, Lp, D]
    slices = qh.reshape(b, h, -1, 64, d)  # [B, H, consumer slices, 64, D]
    neg = torch.tensor(-1e30, dtype=q.dtype)
    m = torch.full(slices.shape[:-1], -1e30, dtype=q.dtype)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(slices)
    cols = torch.arange(64)
    for k0 in range(0, seq, 64):
        kt = kh[:, :, None, k0:k0 + 64]  # [B, H, 1, 64, D]
        vt = vh[:, :, None, k0:k0 + 64]
        s = torch.where(k0 + cols < seq, mm(slices, kt.transpose(-1, -2)), neg)
        m_new = torch.maximum(m, s.amax(-1) * c)
        p = torch.exp2(s * c - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = mm(p, vt)
        if q.dtype == torch.float64:
            acc = acc * alpha[..., None] + pv
        else:  # one fma: the product exact in float64, one rounding
            acc = (acc.double() * alpha[..., None].double() + pv.double()).float()
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    o = (acc * (1.0 / lc)[..., None]).reshape(b, h, -1, d)[:, :, :seq]
    lse = (m * math.log(2.0) + torch.log(lc)).reshape(b, h, -1)[:, :, :seq]
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, seq)


def _d64_references(q, k, v):
    """The Pallas kernel in interpret mode and the port's plain version."""
    pallas = _flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            block_q=512, block_k=512, interpret=True)
    return torch.from_numpy(np.array(pallas)), flash_attention_plain(q, k, v)


def test_d64_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the tile order gives the plain
    output and lse: only the order of sums differs."""
    q, k, v = (x.double() for x in d64_inputs(2, 200, 3, 5))
    o, lse = forward_d64_tiles(q, k, v, mm_exact)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", D64_CASES)
def test_d64_3xtf32_holds_the_fp32_limit(b, seq, h):
    """3xTF32 on wgmma in the kernel's tile order (each instruction's terms
    cut and its sum rounded toward zero, as the card's wgmma does: the
    model of `tests/torch_port_tf32.py`) lands within 2e-5 of the Pallas
    kernel and of the plain version, and its lse within 1e-4 of max."""
    q, k, v = d64_inputs(b, seq, h, seq + h)
    o, lse = forward_d64_tiles(q, k, v, wgmma_3xtf32)
    for want in _d64_references(q, k, v):
        assert (o - want).abs().max().item() <= O_TOL
    want_lse = flash_attention_lse_plain(q, k, v)[1]
    assert ((lse - want_lse).abs().max() / want_lse.abs().max()).item() <= REL_TOL


@pytest.mark.parametrize("b,seq,h", D64_CASES)
def test_d64_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    """One TF32 wgmma pass a product, in the same order, misses 2e-5."""
    q, k, v = d64_inputs(b, seq, h, seq + h)
    o, _ = forward_d64_tiles(q, k, v, wgmma_tf32)
    for want in _d64_references(q, k, v):
        assert (o - want).abs().max().item() > O_TOL


def _vt_slot(key: int) -> int:
    """flash_attn_fwd.cu d64: the k slot of key `key` of a 64-key tile in
    V^T (within each 8 keys, slot t is key 2t and slot t + 4 key 2t + 1)."""
    x = key & 7
    return (key & ~7) + (4 + (x >> 1) if x & 1 else x >> 1)


def test_d64_vt_operand_is_v_transposed_in_the_fragment_order():
    """The producer writes V^T of a 64-key tile as P V's K-major B operand,
    (d, slot) at atom slot // 32, `swizzle128(d, 4 (slot % 32))`: every
    4-byte word once. `wgmma`'s read of 8-deep step kk (32 (kk % 4) bytes
    into atom kk // 4) gives B[slot][d] = V[key][d] of the slot's key, and
    P's accumulator fragment taken in the order c0, c2, c1, c3 as the A
    operand puts the same key at each slot, so A B = P V exactly."""
    rng = np.random.default_rng(3)
    v = rng.integers(-64, 64, size=(64, 64))  # [key][d]
    p = rng.integers(0, 8, size=(64, 64))  # [q row][key]
    words = np.full(2 * 8192 // 4, 10 ** 6)
    for key in range(64):
        slot = _vt_slot(key)
        for d in range(64):
            words[((slot // 32) * 8192 + swizzle128(d, 4 * (slot % 32))) // 4] = v[key, d]
    assert (words != 10 ** 6).all()
    b = np.empty((64, 64), dtype=np.int64)  # [slot][d], as wgmma reads it
    for kk in range(8):
        start = (kk // 4) * 8192 + 32 * (kk % 4)
        for s in range(8):
            for d in range(64):
                b[8 * kk + s, d] = words[wgmma_reads(start, d, 4 * s) // 4]
    a = np.empty_like(p)  # [row][slot]: the A fragments, lane (g, t)
    for kk in range(8):
        for m0 in range(0, 64, 16):
            for g in range(8):
                for t in range(4):
                    c = [p[m0 + g, 8 * kk + 2 * t], p[m0 + g, 8 * kk + 2 * t + 1],
                         p[m0 + g + 8, 8 * kk + 2 * t],
                         p[m0 + g + 8, 8 * kk + 2 * t + 1]]
                    a0, a1, a2, a3 = c[0], c[2], c[1], c[3]
                    a[m0 + g, 8 * kk + t], a[m0 + g + 8, 8 * kk + t] = a0, a1
                    a[m0 + g, 8 * kk + t + 4] = a2
                    a[m0 + g + 8, 8 * kk + t + 4] = a3
    for key in range(64):
        np.testing.assert_array_equal(b[_vt_slot(key)], v[key])
    np.testing.assert_array_equal(a @ b, p @ v)


# -- the d = 64 backward kernels' tile order --------------------------------
D64_BWD_CASES = [(1, 1000, 2), (2, 1024, 1)]  # B, L, H: a ragged and a path L


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
    q, k, v, o, lse, do = (x.double() for x in d64_bwd_inputs(2, 200, 3, 9))
    got = backward_d64_tiles(q, k, v, o, lse, do, mm_exact)
    for g, want in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", D64_BWD_CASES)
def test_d64_backward_3xtf32_holds_the_fp32_limit(b, seq, h):
    """3xTF32 in the kernels' tile order lands within 1e-4 of max of the
    Pallas kernels and of the plain version, for dq, dk and dv."""
    inputs = d64_bwd_inputs(b, seq, h, seq + h)
    got = backward_d64_tiles(*inputs, mm_3xtf32)
    for name, want in _d64_bwd_references(*inputs).items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= REL_TOL, (name, reads)


@pytest.mark.parametrize("b,seq,h", D64_BWD_CASES)
def test_d64_backward_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    """One TF32 pass per product misses the limit on every gradient."""
    inputs = d64_bwd_inputs(b, seq, h, seq + h)
    got = backward_d64_tiles(*inputs, mm_tf32)
    for name, want in _d64_bwd_references(*inputs).items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert min(reads) > REL_TOL, (name, reads)
