"""The numeric design and the shared-memory layout of the bf16 flash
backward at d = 16 on the bf16 tensor cores (`flash_dq_d16_bf16` and
`flash_dkv_d16_bf16` in `rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels hold their tiles in shared memory as bf16 (64 kept rows, 128
streamed rows a tile in 32-row chunks) and take every product as
`mma.sync.m16n8k16` with bf16 operands and fp32 accumulators. At d = 16,
S = Q K^T and dP = dO V^T (dkv: their transposes) are one 16-deep step
from zero; P = 2^(S c - lse2) in log2 units, dS = P (dP scale - di scale);
then dq += dS K over the keys, dv += P^T dO and dk += dS^T Q over the q
rows, each in 16-deep steps into one accumulator, P and dS as two bf16
terms (big = x cut to bf16, small = bf16(x - big): `pack_split_trunc`;
the small term's product first at each step). That is the d = 64 kernels'
arithmetic with one step over d and the big term cut rather than rounded,
so this file runs the emulation of
`tests/test_torch_port_flash_bwd_d64_bf16.py` (`scores_bf16`,
`accumulate_bf16`, with `mma.sync`'s rounding toward zero modelled by
`tests/torch_port_tf32.py` `mma_bf16`) at d = 16 with `big_of =
bf16_truncate`: the tiles change no sum.

It holds dq, dk and dv to float64, to the plain version and to the Pallas
kernels in interpret mode at the card's limit (2^-8 + 1e-4 of max|plain|
after the bf16 store, `chip_smoke.py` `REL_TOL`), reads the rule that
chose two terms of P and of dS and the rule that let one accumulator go
without per-chunk partials, and checks the ldmatrix lanes, the banks of
every copy and fragment read under the d = 16 swizzle, and the grid,
shared memory and waves.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import flash_attention_bwd_plain
from rdeic_tpu.ops.flash_attention import _flash_backward
from tests.test_torch_port_flash_bwd_d64_bf16 import (
    _inputs,
    _on_rows,
    _take,
    accumulate_bf16,
    backward_bf16_tiles,
    scores_bf16,
)
from tests.torch_port_tf32 import (
    banks,
    bf16_round,
    bf16_truncate,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
)

D = 16
BT, BS, KC, NT = 64, 128, 32, 128  # d16_bf16:: kept, streamed, chunk, threads
ROW_BYTES = 2 * D


def _swizzled_byte(r, c):
    """Byte address of chunk c (8 bf16 values) of row r of a d = 16 tile
    (flash_bf16.cuh: chunk c of row r at c ^ ((r >> 2) & 1))."""
    return r * ROW_BYTES + ((c ^ ((r >> 2) & 1)) << 4)


def _lane16(lane):
    """flash_bf16.cuh `Lane16`: the byte offsets of the lane's ldmatrix row
    at a corner, for A (and B with .trans) and for B without .trans."""
    sw = (lane >> 2) & 1
    a = (((lane & 7) + ((lane >> 3) & 1) * 8) << 5) + (((lane >> 4) ^ sw) << 4)
    b = (((lane & 7) + (lane >> 4) * 8) << 5) + ((((lane >> 3) & 1) ^ sw) << 4)
    return a, b


def _banks(byte_addrs):
    """The 4-byte banks of 16-byte chunks at these byte addresses."""
    return sorted(banks([a // 4 + w for a in byte_addrs for w in range(4)]))
# d16_bf16::kDqSmemBytes (Q, dO, O, three K / V pairs) and kDkvSmemBytes
# (K, V, three Q / dO pairs, their rows' lse2 and di scale)
DQ_SMEM = 3 * BT * ROW_BYTES + 6 * BS * ROW_BYTES
DKV_SMEM = 2 * BT * ROW_BYTES + 6 * BS * ROW_BYTES + 3 * 2 * BS * 4
SMEM_PER_SM, SMS, REGS_PER_SM = 233472, 132, 65536
REL_TOL = 2.0 ** -8 + 1e-4  # the card's limit on dq, dk, dv, of max|plain|
HALF = REL_TOL / 2  # the precision rule's bound on a term choice's reading
FAULT_SCALE = 1.05
P_TERMS = DS_TERMS = 2  # the kernels take P and dS as big + small (the rule)
BIG = bf16_truncate  # pack_split_trunc's big term
# (B, L, H, rows): the training path's d = 16 shapes ([2, 4096, 4, 16] as
# one head: its heads are alike), L = 1000 with B = 2, H = 3, and L = 8192
# on 256 kept rows a side (each row's sums are its own)
RULE_SHAPES = [(2, 1024, 8, None), (1, 4096, 1, None), (2, 1000, 3, None),
               (1, 8192, 1, 256)]


def _inputs16(b, seq, h, seed):
    return _inputs(b, seq, h, seed, d=D)


def accumulate_partials(sc: dict, rows=KC):
    """`accumulate_bf16` (two terms) with each `rows`-row chunk's products
    summed from zero into a partial that joins the accumulator in fp32 (to
    nearest): the fp32 kernel's order at d = 16, which the bf16 kernels
    leave out (the rule in
    `test_rounding_toward_zero_over_l_8192_needs_no_partials`)."""
    (_, ds_r), (p_c, ds_c) = sc["rows"], sc["cols"]
    qh, kh, doh = sc["q"], sc["k"], sc["do"]
    dq = torch.zeros(ds_r.shape[:-1] + (D,))
    dk = torch.zeros(p_c.shape[:2] + (p_c.shape[-1], D))
    dv = torch.zeros_like(dk)
    for t0 in range(0, qh.shape[-2], rows):
        t = slice(t0, t0 + rows)
        dq = dq + _take(torch.zeros_like(dq), ds_r[..., t], kh[..., t, :],
                        DS_TERMS, False, BIG)
        dv = dv + _take(torch.zeros_like(dv), p_c[..., t, :].transpose(-1, -2),
                        doh[..., t, :], P_TERMS, False, BIG)
        dk = dk + _take(torch.zeros_like(dk), ds_c[..., t, :].transpose(-1, -2),
                        qh[..., t, :], DS_TERMS, False, BIG)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _references(q, k, v, o, lse, do):
    """{name: (dq, dk, dv)} on the same values: float64, the plain version
    in fp32 (the card's comparison) and the Pallas kernels in interpret
    mode on the values in fp32."""
    got = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                          jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                          block_q=512, block_k=512, interpret=True)
    return {"float64": flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o)), lse.double(), do.double()),
            "plain": flash_attention_bwd_plain(q, k, v, o, lse, do),
            "pallas": tuple(torch.from_numpy(np.array(g)) for g in got)}


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 77, 2), (1, 130, 2)])
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products and P and dS unrounded (float64), the log2
    units and the padded rows give the plain backward at d = 16: only the
    order of sums differs. L = 77 is shorter than one streamed tile, 130
    ends two rows into the second."""
    inputs = [x.double() for x in _inputs16(b, seq, h, seq + h)]
    got = backward_bf16_tiles(*inputs, exact=True)
    for g, want in zip(got, flash_attention_bwd_plain(*inputs)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 1000, 2)])
def test_two_terms_hold_the_limit_against_pallas_and_plain(b, seq, h):
    """P and dS as two bf16 terms, every step rounded toward zero: dq, dk
    and dv within half the limit of float64, the plain version and the
    Pallas kernels before the bf16 store, and within the limit of the plain
    version after it; a planted x1.05 fault reads beyond the limit."""
    inputs = _inputs16(b, seq, h, seq + 7 * h)
    got = backward_bf16_tiles(*inputs, big_of=BIG)
    refs = _references(*inputs)
    for name, want in refs.items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= HALF, (name, reads)
    stored = [rel(bf16_round(g), w) for g, w in zip(got, refs["plain"])]
    fault = [rel(bf16_round(g) * FAULT_SCALE, w)
             for g, w in zip(got, refs["plain"])]
    assert max(stored) <= REL_TOL and min(fault) > REL_TOL, (stored, fault)


@functools.lru_cache(maxsize=None)
def _rule_reads(b, seq, h, rows_a_side):
    """{(p_terms, ds_terms): [dq, dk, dv]}: max |error| over max|plain|
    before the bf16 store, against the plain version on the same values,
    for one term of both and for two (rows: `rows_a_side` spread over L,
    or all)."""
    inputs = _inputs16(b, seq, h, seq + h)
    rows = (None if rows_a_side is None
            else torch.arange(0, seq, seq // rows_a_side)[:rows_a_side])
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    sc = scores_bf16(*inputs, rows)
    return {terms: [rel(g, w) for g, w in zip(
                accumulate_bf16(sc, *terms, big_of=BIG), want)]
            for terms in ((1, 1), (2, 2))}


@pytest.mark.parametrize("b,seq,h,rows", RULE_SHAPES)
def test_two_terms_read_within_half_the_limit(b, seq, h, rows):
    """At every shape of the rule, P and dS as two terms read at most half
    the limit on dq, dk and dv (the rule's condition for the terms the
    kernels take)."""
    reads = _rule_reads(b, seq, h, rows)
    assert max(reads[2, 2]) <= HALF, reads


def test_the_rule_takes_two_terms_of_p_and_of_ds():
    """The rule: P (dv = P^T dO) and dS (dq = dS K, dk = dS^T Q) each take
    one bf16 term only if it reads at most half the card's limit at every
    d = 16 training shape and at L = 1000 and 8192; otherwise two. Each
    output has its own reading: one term of dS reads up to ~2.08e-3 of max
    on dq ([2, 1024, 8, 16]) and ~2.13e-3 on dk (L = 1000), one term of P
    ~2.24e-3 on dv, each past half the limit (2.003e-3), as at d = 64. So
    the kernels take two terms of each."""
    reads = {shape: _rule_reads(*shape) for shape in RULE_SHAPES}
    one = [max(r[1, 1][i] for r in reads.values()) for i in range(3)]
    assert min(one) > HALF, (one, reads)  # dq, dk (dS) and dv (P) each
    assert (P_TERMS, DS_TERMS) == (2, 2)


def test_rounding_toward_zero_over_l_8192_needs_no_partials():
    """mma.sync rounds each step's sum toward zero, and dq, dk and dv each
    take 2 L / 16 steps into one accumulator. At L = 8192, on 256 rows a
    side, against the same terms summed in float64, that rounding moves the
    result by ~2.8e-5 of max: under a fortieth of half the limit (5.0e-5),
    the rule's bound for keeping per-chunk partials, so the kernels keep
    one accumulator. Partials (the fp32 kernel's order) would cut it to
    ~6e-6; the total stays within half the limit either way."""
    inputs = _inputs16(1, 8192, 1, 11)
    rows = torch.arange(0, 8192, 32)
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    sc = scores_bf16(*inputs, rows)
    got = accumulate_bf16(sc, big_of=BIG)
    exact = accumulate_bf16(sc, exact_sums=True)
    rz = [rel(g, e) for g, e in zip(got, exact)]
    partials = [rel(g, e) for g, e in zip(accumulate_partials(sc), exact)]
    total = [rel(g, w) for g, w in zip(got, want)]
    assert 0 < max(rz) < HALF / 40, rz
    assert max(partials) < max(rz) / 2, (partials, rz)
    assert max(total) <= HALF, total


def test_truncated_split_sums_to_within_2_to_the_minus_16():
    """`pack_split_trunc` (flash_bf16.cuh): big = x cut to bf16 (its top 16
    bits), small = bf16(x - big), x - big exact in fp32 and below one bf16
    ulp of x; big + small is within 2^-16 |x| of x (`pack_split`, which
    rounds big to nearest, 2^-17, at one more conversion a pair)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000)
                         .astype(np.float32)) * 3.0
    big = BIG(x)
    assert (big.abs() <= x.abs()).all() and torch.equal(bf16_round(big), big)
    small = bf16_round(x - big)
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -16 * x.double().abs()).all()
    assert err.max() > 2.0 ** -18 * x.double().abs().max()


# -- the tiles in shared memory ----------------------------------------------
def test_ldmatrix_lanes_address_the_fragments_in_order():
    """Every fragment read of the two kernels, at the rows it starts from.
    The kept tile's A fragment (Q, dO, O in dq; K, V in dkv) at rows 16 w
    and the streamed tile read with .trans for the products with P and dS
    (K in dq; Q, dO in dkv; rows = the 16-deep step's keys or q rows, at
    c0 + 16 kk) take `Lane16.a`: matrix m must be rows 8 (m & 1).., chunk
    m >> 1 (a0..a3; b0, b1 of d columns 0..7, then of 8..15). The streamed
    tile read without .trans for S and dP (K, V; Q, dO: rows = n) takes
    `Lane16.b`: rows 8 (m >> 1).., chunk m & 1 (b0, b1 of n-tile 0, then
    of n-tile 1). Both at the swizzled chunk."""
    kept = [16 * w for w in range(NT // 32)]
    streamed = [c0 + 16 * i for c0 in range(0, BS, KC) for i in range(KC // 16)]
    for lane in range(32):
        m = lane >> 3
        a, b = _lane16(lane)
        for r0 in kept + streamed:
            assert r0 * ROW_BYTES + a == _swizzled_byte(
                r0 + 8 * (m & 1) + (lane & 7), m >> 1)
        for r0 in streamed:
            assert r0 * ROW_BYTES + b == _swizzled_byte(
                r0 + 8 * (m >> 1) + (lane & 7), m & 1)


@pytest.mark.parametrize("rows", [BT, BS])
def test_copies_and_fragment_reads_hit_32_banks(rows):
    """`load_tile` with 128 threads writes a tile 16 bytes a lane, a phase
    of 8 lanes on 4 rows x 2 chunks; every ldmatrix matrix (with or without
    .trans) is 8 rows at one chunk: each hits all 32 banks at every row of
    a kept (64-row) and a streamed (128-row) tile under the d = 16 swizzle
    (chunk c of row r at c ^ ((r >> 2) & 1))."""
    for i0 in range(0, rows * 2, 8):
        addrs = [_swizzled_byte(i // 2, i % 2) for i in range(i0, i0 + 8)]
        assert _banks(addrs) == list(range(32))
    for r0 in range(0, rows, 8):
        for c in range(2):
            addrs = [_swizzled_byte(r, c) for r in range(r0, r0 + 8)]
            assert _banks(addrs) == list(range(32))


def test_row_terms_hit_32_banks():
    """dkv's lse2 and di scale of a streamed tile: thread i copies (4-byte
    cp.async) and then turns in place word i of the lse row and word
    BS + i of the di row, 32 consecutive words a warp; the warps read them
    as float2 at columns c0 + 8 n + 2 t, 4 addresses shared by 8 lanes
    each, 8 banks, no conflict."""
    for base in (0, BS):
        for w0 in range(0, NT, 32):
            assert sorted(a % 32 for a in range(base + w0, base + w0 + 32)) \
                == list(range(32))
        for c0 in range(0, BS, KC):
            for n in range(KC // 8):
                addrs = {base + c0 + 8 * n + 2 * (lane & 3)
                         for lane in range(32)}
                hit = {x % 32 for a in addrs for x in (a, a + 1)}
                assert len(addrs) == 4 and len(hit) == 8


def test_grid_shared_memory_and_waves():
    """64-row kept tiles of 4 warps, a ring of three 128-row streamed tile
    pairs. dq: Q, dO, O and three K / V pairs, 30 KB; dkv: K, V, three
    Q / dO pairs and their rows' lse2 and di scale, 31 KB: static shared
    memory (no cudaFuncSetAttribute for the size), four blocks per SM by
    shared memory (1 KB reserved a block) and by registers
    (`__launch_bounds__(128, 4)`: at most 128 a thread). [2, 4096, 4, 16]
    gives 512 blocks (0.97 waves of 528 slots), [2, 1024, 8, 16] 256."""
    assert DQ_SMEM == 30720 and DKV_SMEM == 31744
    assert max(DQ_SMEM, DKV_SMEM) <= 48 * 1024
    assert 4 * (DKV_SMEM + 1024) <= SMEM_PER_SM
    assert REGS_PER_SM // (4 * NT) == 128
    for (b, seq, h), blocks in (((2, 4096, 4), 512), ((2, 1024, 8), 256)):
        assert math.ceil(seq / BT) * b * h == blocks
    assert [round(n / (4 * SMS), 2) for n in (512, 256)] == [0.97, 0.48]


def test_probe_variants_apply_to_the_kernels():
    """`rdeic_torch/tools/flash_bwd_probe.py` (the card probes PERF.md
    cites) changes the `d16_bf16` kernels by text substitutions: each of
    its variants still finds its text in csrc/flash_attn_bwd.cu, changes
    only that namespace, and a text that is not there raises."""
    from rdeic_torch import build
    from rdeic_torch.tools.flash_bwd_probe import VARIANTS, variant_source

    src = build.FLASH_BWD_SRC.read_text()
    head = src[:src.index("namespace d16_bf16 {")]
    tail = src[src.index("}  // namespace d16_bf16"):]
    for name, edits in VARIANTS["d16_bf16"].items():
        got = variant_source(src, edits, "d16_bf16")
        assert got != src and got.startswith(head) and got.endswith(tail), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], "d16_bf16")
