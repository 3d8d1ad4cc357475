"""The numeric design and the shared-memory layout of the d = 16 flash
backward on the tensor cores (`flash_dq_d16` and `flash_dkv_d16` in
`rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels keep a 64-row tile (q rows in dq, keys in dkv) and stream the
other side in 128-row tiles, each split between two halves of 4 warps that
take 64 rows of it in 32-row chunks and add their accumulators at the end.
Every fp32 product is 3xTF32 (`csrc/flash_mma.cuh`); P is one exp2 of the
scores in log2 units; and each chunk's products with P or dS sum from zero
into a partial that is added to the accumulator in fp32, because `mma.sync`
rounds its sums toward zero. This file emulates that order
(`backward_d16_tiles`) with the rounding modelled (`tests/torch_port_tf32.py`
`mma_3xtf32`) and holds dq, dk and dv to float64, to the Pallas kernels in
interpret mode and to the plain version within chip_smoke.py's fp32 limit
(1e-4 of max); it shows that one TF32 pass breaks the limit and that one
running accumulator lets the error grow with L where the partials keep it
flat, and it counts the banks of every shared-memory access of the kernels'
layout and checks their grid and shared memory.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
)
from rdeic_tpu.ops.flash_attention import _flash_backward
from tests.torch_port_tf32 import (
    banks,
    ldmatrix_phases,
    mm_exact,
    mm_tf32,
    mma_3xtf32,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
)

D = 16
BT, BS, HS, CH = 64, 128, 64, 32  # d16:: kept tile, streamed tile, half, chunk
S = D + 4  # d16::S: the planes' row stride, and the fp32 raw tiles'
PLANE = BS * S  # d16::kPlane
REL_TOL = 1e-4  # chip_smoke.py's fp32 limit on dq, dk and dv, of max
LOG2E = math.log2(math.e)
SMEM_LIMIT, SMS = 232448, 132


def _chunks(seq):
    """(first row, half) of every 32-row chunk the kernels stream, in order:
    half h of a 128-row tile takes its rows 64 h.., and a half wholly past
    L is skipped."""
    for t0 in range(0, seq, BS):
        for half in (0, 1):
            first = t0 + half * HS
            if first < seq:
                for c0 in range(0, HS, CH):
                    yield first + c0, half


def backward_d16_tiles(q, k, v, o, lse, do, mm, one_accumulator=False):
    """(dq, dk, dv) in the order of `flash_dq_d16` and `flash_dkv_d16`,
    every product by mm. Kept rows are independent, so they are one batch
    dimension here; the streamed side is padded with zero rows. Scores in
    log2 units: c = d^-1/2 log2(e), lse2 = lse log2(e), P = 2^(S c - lse2),
    dS = P (dP scale - di scale). dq: keys past L are masked to P = 0, di =
    rowsum(dO O) of its own rows. dkv: lse2 = +inf past L (P^T = 0 there),
    di from the dq pass. Each chunk's dS K (dq), P^T dO and dS^T Q (dkv)
    sums from zero by mm and is added to its half's accumulator in fp32;
    with `one_accumulator`, `mma_3xtf32` takes the accumulator itself as C
    instead. The halves' accumulators are added at the end, half 0 first."""
    b, seq, h, d = q.shape
    scale = d ** -0.5
    c = scale * LOG2E
    pad = -seq % BS
    qh, kh, vh, oh, doh = (
        torch.nn.functional.pad(x.permute(0, 2, 1, 3), (0, 0, 0, pad))
        for x in (q, k, v, o, do))  # [B, H, Lp, D]
    rows = torch.arange(seq + pad)
    lse2 = torch.nn.functional.pad(lse.reshape(b, h, seq) * LOG2E, (0, pad))
    di = (doh * oh).sum(-1)  # [B, H, Lp]: 0 on the padded rows
    dis = di * scale
    zero = torch.zeros((), dtype=q.dtype)

    def take(acc, a, x):
        if one_accumulator:
            return mma_3xtf32(a, x, acc)
        return acc + mm(a, x)

    dq = [torch.zeros_like(qh) for _ in (0, 1)]
    dk = [torch.zeros_like(kh) for _ in (0, 1)]
    dv = [torch.zeros_like(vh) for _ in (0, 1)]
    lse2_kv = torch.where(rows < seq, lse2, torch.tensor(math.inf, dtype=q.dtype))
    for c0, half in _chunks(seq):
        cols = slice(c0, c0 + CH)
        # dq: every q row against keys c0.. of the streamed K / V
        s = mm(qh, kh[:, :, cols].transpose(-1, -2))
        p = torch.exp2(s * c - lse2[..., None])
        p = torch.where(rows[cols][None, :] < seq, p, zero)
        ds = p * (mm(doh, vh[:, :, cols].transpose(-1, -2)) * scale
                  - dis[..., None])
        dq[half] = take(dq[half], ds, kh[:, :, cols])
        # dkv: every key row against q rows c0.. of the streamed Q / dO
        st = mm(kh, qh[:, :, cols].transpose(-1, -2))
        pt = torch.exp2(st * c - lse2_kv[..., None, cols])
        dst = pt * (mm(vh, doh[:, :, cols].transpose(-1, -2)) * scale
                    - dis[..., None, cols])
        dv[half] = take(dv[half], pt, doh[:, :, cols])
        dk[half] = take(dk[half], dst, qh[:, :, cols])
    return tuple((x[0] + x[1])[:, :, :seq].permute(0, 2, 1, 3)
                 for x in (dq, dk, dv))


def _inputs(b, seq, h, seed):
    """fp32 q, k, v, dO, and the float64 forward's o and lse rounded to
    fp32 (the backward kernels start from the forward's)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, seq, h, D))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    return q, k, v, o.float(), lse.float(), do


def _references(q, k, v, o, lse, do):
    """{name: (dq, dk, dv)}: float64, the Pallas kernels in interpret mode
    and the port's plain version, on the same fp32 inputs."""
    pallas = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                             jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                             block_q=128, block_k=128, interpret=True)
    return {"float64": flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o)), lse.double(), do.double()),
            "pallas": tuple(torch.from_numpy(np.array(g)) for g in pallas),
            "plain": flash_attention_bwd_plain(q, k, v, o, lse, do)}


def test_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the halves, the chunks, the log2
    units and the masks give the plain backward: only the order of sums
    differs. L = 200 ends in a tile whose second half is partly past L;
    L = 50 leaves the second half empty."""
    for b, seq, h in ((2, 200, 3), (1, 50, 2)):
        q, k, v, o, lse, do = (x.double() for x in _inputs(b, seq, h, seq))
        got = backward_d16_tiles(q, k, v, o, lse, do, mm_exact)
        for g, want in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do)):
            torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", [(1, 77, 2), (2, 300, 1), (1, 1024, 1)])
def test_3xtf32_with_rounding_toward_zero_holds_the_fp32_limit(b, seq, h):
    """Every product as 8-deep mma.sync steps of three passes rounded toward
    zero, in the kernels' order: dq, dk and dv within 1e-4 of max of
    float64, the Pallas kernels and the plain version."""
    inputs = _inputs(b, seq, h, seq + h)
    got = backward_d16_tiles(*inputs, mma_3xtf32)
    for name, want in _references(*inputs).items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= REL_TOL, (name, reads)


@pytest.mark.parametrize("b,seq,h", [(1, 77, 2), (1, 1024, 1)])
def test_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    """One TF32 pass per product misses the limit on every gradient."""
    inputs = _inputs(b, seq, h, seq + h)
    got = backward_d16_tiles(*inputs, mm_tf32)
    want = _references(*inputs)["float64"]
    reads = [rel(g, w) for g, w in zip(got, want)]
    assert min(reads) > REL_TOL, reads


def test_chunk_partials_keep_the_error_flat_in_l():
    """With one running accumulator (every pass rounded toward zero into
    dq, dk and dv) the error grows with L; with each chunk's products summed
    from zero and added in fp32, as the kernels do, it stays below half of
    that at the longer L and does not grow."""
    reads = {}
    for seq in (512, 2048):
        inputs = _inputs(1, seq, 1, seq)
        want = flash_attention_bwd_plain(*(x.double() for x in inputs))
        for one in (False, True):
            got = backward_d16_tiles(*inputs, mma_3xtf32, one_accumulator=one)
            reads[seq, one] = max(rel(g, w) for g, w in zip(got, want))
    assert reads[2048, True] > 1.5 * reads[512, True], reads
    assert reads[2048, False] < 0.5 * reads[2048, True], reads
    assert reads[2048, False] < 1.5 * reads[512, False], reads


# -- shared-memory banks -----------------------------------------------------
def _unit_rc(j):
    """d16::unit_rc: 4-float unit j of a 128 x 16 tile as (row, column)."""
    q, e = j >> 3, j & 7
    return (q >> 2) * 8 + (q & 3) + (e >> 2) * 4, (e & 3) * 4


def _row_pair_reads(base):
    """The B reads of `accumulate` (P or dS times the streamed chunk): lane
    (g, t) reads rows base + 8 kk + 2t and + 1 at column 8 n + g; one 32-lane
    phase per (kk, n, row of the pair)."""
    for kk in range(CH // 8):
        for n in range(D // 8):
            for e in (0, 1):
                yield [(base + 8 * kk + 2 * (lane & 3) + e) * S + 8 * n
                       + (lane >> 2) for lane in range(32)]


def test_fragment_reads_hit_32_banks():
    """The planes (stride 20, not swizzled) are read as B^T by ldmatrix for
    the scores (every 8-row phase of the 128 rows) and as B at row pairs for
    the products with P or dS (every chunk of both halves): each phase hits
    32 distinct banks, in every plane (planes start at multiples of 32
    floats)."""
    for phase in ldmatrix_phases(S, rows=BS):
        assert sorted(banks(phase)) == list(range(32))
    for base in range(0, BS, CH):
        for phase in _row_pair_reads(base):
            assert sorted(banks(phase)) == list(range(32))
    assert PLANE % 32 == 0


def test_split_pass_and_copies_hit_32_banks():
    """cp.async lands fp32 raw tiles 16 bytes a lane, and the split pass
    reads them and writes the big and small planes as float4, at the same
    stride 20; 128-bit accesses go 8 lanes a phase, and unit_rc gives the 8
    lanes 4 units of row r and 4 of row r + 4, 32 distinct banks. The plain
    order (4 units of row r, then of row r + 1) would be two-way. The 1024
    units of a pair cover both tiles once."""
    units = [_unit_rc(j) for j in range(BS * D // 4)]
    assert sorted(units) == [(r, c) for r in range(BS) for c in range(0, D, 4)]
    for j0 in range(0, len(units), 8):
        addrs = [r * S + c + x for r, c in units[j0:j0 + 8] for x in range(4)]
        assert sorted(banks(addrs)) == list(range(32))
    plain = [(r * S + c + x) for r in (0, 1) for c in range(0, D, 4)
             for x in range(4)]
    assert max(np.bincount(banks(plain))) == 2


def test_row_terms_are_read_as_broadcasts():
    """dkv reads lse2 and di scale of q columns 8 n + 2t, 2t + 1 (float2):
    the 8 lanes of one t share an address, the 4 addresses take 8 banks."""
    for c0 in range(0, BS, CH):
        for n in range(CH // 8):
            addrs = {c0 + 8 * n + 2 * (lane & 3) for lane in range(32)}
            hit = [b for a in addrs for b in banks((a, a + 1))]
            assert len(addrs) == 4 and len(set(hit)) == 8


def test_grid_and_shared_memory():
    """dq: two raw buffers of the streamed pair and its big and small planes
    (80 KB; fp32 only: bf16 at d = 16 has kernels of its own); dkv adds lse
    and di (83 KB). Two blocks of 8 warps per SM: [2, 1024, 8, 16] gives
    256 blocks for 264 slots (one wave), [2, 4096, 4, 16] 512. The halves'
    merge (16 floats a lane in dkv) fits in the planes."""
    raw32 = 2 * BS * S  # floats a raw buffer (d16::kRaw)
    dq32 = 2 * raw32 + 4 * PLANE
    dkv32 = dq32 + 6 * BS
    assert 4 * dq32 == 81920 and 4 * dkv32 == 84992
    assert 2 * 4 * dkv32 <= SMEM_LIMIT
    assert 4 * 32 * 16 <= 4 * PLANE
    for (b, seq, h), blocks in (((2, 1024, 8), 256), ((2, 4096, 4), 512)):
        assert math.ceil(seq / BT) * b * h == blocks
    assert 256 <= 2 * SMS
