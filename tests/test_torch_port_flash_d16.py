"""The numeric design and the shared-memory layout of the d = 16 flash
forward on the tensor cores (`flash_fwd_d16` in
`rdeic_torch/csrc/flash_attn_fwd.cu`), on the CPU.

The kernel takes every fp32 product on the tensor cores as 3xTF32
(`csrc/flash_mma.cuh`), runs the online softmax in log2 units (the scale
times log2(e), then exp2), splits each 128-key tile between two key halves
of 4 warps that merge at the end, and sums each tile's P V from zero into a
partial that joins the accumulator in fp32, because `mma.sync` rounds its
sums toward zero. This file emulates that order (`forward_d16_tiles`) with
the rounding modelled (`tests/torch_port_tf32.py` `mma_3xtf32`) and holds
it to float64, to the Pallas kernel in interpret mode and to the plain
version within the limits chip_smoke.py holds the kernel to on the card
(output 2e-5 absolute, lse 1e-4 of max); it shows that one TF32 pass breaks
them and that one accumulator for the whole L lets the error grow, and it
counts the banks of every fragment read of the kernel's tile layout.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import (
    flash_attention_lse_plain,
    flash_attention_plain,
)
from rdeic_tpu.ops.flash_attention import _flash_forward
from tests.torch_port_tf32 import (
    banks,
    ldmatrix_phases,
    mm_exact,
    mm_tf32,
    mma_3xtf32,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

D = 16
BQ, BK, HK = 64, 128, 64  # d16::BQ, BK and a key half's keys
S = D + 4  # d16::S: the row stride of the Q, K and V tiles, in floats
O_TOL = 2e-5  # chip_smoke.py's fp32 limit on the output, absolute
LSE_TOL = 1e-4  # and on the lse, relative to its max
NEG = -1e30


def forward_d16_tiles(q, k, v, mm, one_accumulator=False):
    """(o, lse) in the order of `flash_fwd_d16`, every product by mm. The q
    rows (padded to 64-row blocks with zero rows) are independent, so they
    are one batch dimension here. Key half `half` of every 128-key tile
    (keys 64 half.. of it; the tail zero-filled and its scores masked to
    -1e30) streams through its own online softmax in log2 units: S = mm(Q,
    K^T), m' = max(m, rowmax S * c) with c = d^-1/2 log2(e), P =
    2^(S c - m'), l = l 2^(m - m') + rowsum P, O = O 2^(m - m') + mm(P, V)
    from zero (with `one_accumulator`, mm takes O itself as its
    accumulator instead). A half with no key below L adds nothing. The
    halves merge: m = max(m0, m1), l = l0 2^(m0 - m) + l1 2^(m1 - m), O
    likewise; then O / max(l, 1e-30) and lse = m ln 2 + ln max(l, 1e-30)."""
    b, seq, h, d = q.shape
    c = d ** -0.5 * math.log2(math.e)
    pad = -seq % BQ
    qh = torch.nn.functional.pad(q.permute(0, 2, 1, 3), (0, 0, 0, pad))
    padk = -seq % BK
    kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, padk))
              for x in (k, v))  # [B, H, Lk, D]
    neg = torch.tensor(NEG, dtype=q.dtype)
    halves = []
    for half in (0, 1):
        m = torch.full(qh.shape[:-1], NEG, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qh)
        for t0 in range(0, seq, BK):
            k0 = t0 + half * HK
            if k0 >= seq:
                continue
            kt, vt = kh[:, :, k0:k0 + HK], vh[:, :, k0:k0 + HK]
            s = mm(qh, kt.transpose(-1, -2))
            s = torch.where(k0 + torch.arange(HK) < seq, s, neg)
            m_new = torch.maximum(m, s.amax(-1) * c)
            p = torch.exp2(s * c - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            if one_accumulator:
                acc = mma_3xtf32(p, vt, acc * alpha[..., None])
            else:
                acc = acc * alpha[..., None] + mm(p, vt)
            m = m_new
        halves.append((m, l, acc))
    (m0, l0, o0), (m1, l1, o1) = halves
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    l = torch.clamp(l0 * a0 + l1 * a1, min=1e-30)
    o = (o0 * a0[..., None] + o1 * a1[..., None]) / l[..., None]
    lse = m * math.log(2.0) + torch.log(l)
    return (o[:, :, :seq].permute(0, 2, 1, 3),
            lse[:, :, :seq].reshape(b * h, seq))


def _inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D)).astype(np.float32))
            for _ in range(3)]


def _pallas(q, k, v):
    """The Pallas forward in interpret mode: (o, lse)."""
    o, lse = _flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            block_q=128, block_k=128, interpret=True,
                            save_residuals=True)
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))


def _reads(o, lse, q, k, v) -> dict:
    """max |o - want| against the Pallas kernel, the plain version and
    float64, and the lse's error over its max against float64."""
    o64, lse64 = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    return {"pallas": (o - _pallas(q, k, v)[0]).abs().max().item(),
            "plain": (o - flash_attention_plain(q, k, v)).abs().max().item(),
            "float64": (o.double() - o64).abs().max().item(),
            "lse": ((lse.double() - lse64).abs().max()
                    / lse64.abs().max()).item()}


def _within(reads) -> bool:
    return (max(reads[k] for k in ("pallas", "plain", "float64")) <= O_TOL
            and reads["lse"] <= LSE_TOL)


def test_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the key halves, the log2 units and
    the merge give the plain output and lse: only the order of sums
    differs. L = 200 ends in a tile whose second half is partly past L;
    L = 50 leaves the second half empty."""
    for b, seq, h in ((2, 200, 3), (1, 50, 2)):
        q, k, v = (x.double() for x in _inputs(b, seq, h, seq))
        o, lse = forward_d16_tiles(q, k, v, mm_exact)
        want_o, want_lse = flash_attention_lse_plain(q, k, v)
        torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", [(1, 300, 2), (1, 1536, 1), (2, 77, 1)])
def test_3xtf32_with_rounding_toward_zero_holds_the_fp32_limits(b, seq, h):
    """Every product as 8-deep mma.sync steps of three passes rounded
    toward zero, in the kernel's order: within 2e-5 of the Pallas kernel,
    the plain version and float64, the lse within 1e-4 of max."""
    q, k, v = _inputs(b, seq, h, seq + h)
    reads = _reads(*forward_d16_tiles(q, k, v, mma_3xtf32), q, k, v)
    assert _within(reads), reads


@pytest.mark.parametrize("b,seq,h", [(1, 300, 2), (1, 1536, 1)])
def test_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    q, k, v = _inputs(b, seq, h, seq + h)
    reads = _reads(*forward_d16_tiles(q, k, v, mm_tf32), q, k, v)
    assert reads["float64"] > O_TOL, reads


def test_per_tile_partials_keep_the_error_flat_in_l():
    """With one accumulator for the whole L (every pass of P V rounded
    toward zero into it), the error grows with L; with each tile's P V
    summed from zero and added in fp32, as the kernel does, it stays
    below half of that at the longer L, and does not grow."""
    reads = {}
    for seq in (512, 4096):
        q, k, v = _inputs(1, seq, 1, seq)
        o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))
        for one in (False, True):
            o, _ = forward_d16_tiles(q, k, v, mma_3xtf32, one_accumulator=one)
            reads[seq, one] = (o.double() - o64).abs().max().item()
    assert reads[4096, True] > 1.5 * reads[512, True], reads
    assert reads[4096, False] < 0.5 * reads[4096, True], reads
    assert reads[4096, False] < 1.5 * reads[512, False], reads


def _row_pair_reads(stride):
    """V's B fragments in P V: lane (g, t) reads rows 8 kk + 2t and
    8 kk + 2t + 1 at column 8 n + g; one 32-lane phase per (kk, n, row of
    the pair), over a key half's 64 rows."""
    for kk in range(HK // 8):
        for n in range(D // 8):
            for e in (0, 1):
                yield [(8 * kk + 2 * (lane & 3) + e) * stride + 8 * n
                       + (lane >> 2) for lane in range(32)]


def test_fragment_reads_hit_32_banks():
    """Row stride 20 (20 mod 32, no swizzle): the ldmatrix phases of Q (A
    fragments, 64 rows) and K (B = K^T, the 128 rows of a tile, both
    halves) and V's row-pair reads hit 32 distinct banks. cp.async writes
    16 bytes a lane, 8 lanes a phase over two rows: at most two-way. Both
    key halves and both buffers start at multiples of 32 floats."""
    for rows in (BQ, BK):
        for phase in ldmatrix_phases(S, rows=rows):
            assert sorted(banks(phase)) == list(range(32))
    for phase in _row_pair_reads(S):
        assert sorted(banks(phase)) == list(range(32))
    for lane0 in range(0, BK * D // 4, 8):  # rows of 4 chunks of 4 floats
        addrs = [(i // 4) * S + (i % 4) * 4 + j
                 for i in range(lane0, lane0 + 8) for j in range(4)]
        assert max(np.bincount(banks(addrs))) <= 2
    assert (HK * S) % 32 == 0 and (BK * S) % 32 == 0


def test_grid_and_shared_memory():
    """Two blocks of 8 warps per SM: 46,080 bytes of Q, K and V tiles
    each; the serving path's short shape [1, 1536, 8, 16] has 192 blocks
    for 2 x 132 slots, one wave."""
    smem = 4 * (BQ * S + 2 * 2 * BK * S)
    assert smem == 46080 and 2 * smem <= 232448
    assert 4 * 32 * 12 <= 2 * BK * S  # the merge's state fits a K tile
    assert math.ceil(1536 / BQ) * 8 <= 2 * 132
