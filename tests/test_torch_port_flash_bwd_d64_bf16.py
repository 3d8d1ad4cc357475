"""The numeric design and the shared-memory layout of the bf16 flash
backward at d = 64 on the bf16 tensor cores (`flash_dq_d64_bf16` and
`flash_dkv_d64_bf16` in `rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels hold their tiles in shared memory as bf16 and take every
product as `mma.sync.m16n8k16` with bf16 operands and fp32 accumulators.
S = Q K^T and dP = dO V^T (dkv: their transposes, the same sums) go over d
in four 16-deep steps from zero; P = 2^(S c - lse2) in log2 units (c =
d^-1/2 log2(e), lse2 = lse log2(e)), dS = P (dP scale - di scale); then
dq += dS K over the keys, dv += P^T dO and dk += dS^T Q over the q rows,
each in 16-deep steps into one accumulator, P and dS taken as two bf16
terms (big = bf16(x), small = bf16(x - big); the small term's product
first at each step). The tiles (64 kept rows, 64-row streamed tiles in
32-row chunks) change no sum: each score is its own 64-long dot product,
and each accumulator takes its 16-deep steps in key (or q row) order
whatever the tiles. A padded key (dq) or q row (dkv) adds exact zeros.

This file emulates that arithmetic (`backward_bf16_tiles`) with
`mma.sync`'s rounding toward zero modelled (`tests/torch_port_tf32.py`
`mma_bf16`) and holds it to float64, to the plain version and to the
Pallas kernels in interpret mode at the limit the card holds the bf16
backward to: 2^-8 + 1e-4 of max|plain| against the plain version's
unrounded fp32 result, after the kernels' bf16 store (`chip_smoke.py`
`REL_TOL`). It reads the rule that chose two terms for P and for dS, the
rounding toward zero over L = 8192, the ldmatrix lane offsets and the
banks of every copy and fragment read, and the kernels' grid and shared
memory.
"""
import functools
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
from tests.test_torch_port_flash_bf16 import (
    _chunk_bytes,
    _lane,
    _swizzled_words,
)
from tests.torch_port_tf32 import (
    banks,
    bf16_round,
    mma_bf16,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
)

D = 64
BT, KC, NT = 64, 32, 128  # d64_bf16:: tile rows (kept, streamed), chunk, threads
ROW_BYTES = 2 * D
DQ_SMEM = 8 * BT * ROW_BYTES  # d64_bf16::kDqSmemBytes: Q, dO, 3 K / V pairs
DKV_SMEM = 8 * BT * ROW_BYTES + 3 * 2 * BT * 4  # + 3 lse / di rows
SMEM_PER_SM, SMS, REGS_PER_SM = 233472, 132, 65536
REL_TOL = 2.0 ** -8 + 1e-4  # the card's limit on dq, dk, dv, of max|plain|
HALF = REL_TOL / 2  # the precision rule's bound on a term choice's reading
FAULT_SCALE = 1.05
LOG2E = math.log2(math.e)
P_TERMS = DS_TERMS = 2  # the kernels take P and dS as big + small (the rule)
# (B, L, H, rows): the training path's d = 64 shapes ([2, 4096, 5, 64] as
# one head: its heads are alike), L = 1000 with B = 2, H = 3, and L = 8192
# on 256 kept rows a side (each row's sums are its own)
RULE_SHAPES = [(2, 1024, 10, None), (1, 4096, 1, None), (2, 1000, 3, None),
               (1, 8192, 1, 256)]


def _inputs(b, seq, h, seed, d=D):
    """bf16 q, k, v, dO [B, L, H, d] from normal draws (numpy, from the
    seed), and the float64 forward's o rounded to bf16 and lse to fp32, as
    the lse forward kernel hands them on; all as fp32 tensors."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (bf16_round(torch.from_numpy(
        rng.standard_normal((b, seq, h, d)).astype(np.float32)))
        for _ in range(4))
    o, lse = flash_attention_lse_plain(q.double(), k.double(), v.double())
    return q, k, v, bf16_round(o.float()), lse.float(), do


def _take(acc, x, b, terms, exact, big_of=bf16_round):
    """acc + x b in 16-deep steps along x's last axis: x as `terms` bf16
    terms (1: bf16(x); 2: big = big_of(x), small = bf16(x - big), the small
    term's step, then the big term's), each step's exact sum rounded toward
    zero into acc (`mma_bf16`); with `exact`, x as it is, summed in
    float64."""
    if exact:
        return acc + x @ b
    if terms == 1:
        return mma_bf16(bf16_round(x), b, acc)
    big = big_of(x)
    steps = x.shape[-1] // 16
    a = torch.stack([bf16_round(x - big).unflatten(-1, (steps, 16)),
                     big.unflatten(-1, (steps, 16))], -2).flatten(-3)
    bb = b.unflatten(-2, (steps, 16))
    return mma_bf16(a, torch.stack([bb, bb], -3).flatten(-4, -2), acc)


def backward_bf16_tiles(q, k, v, o, lse, do, p_terms=P_TERMS,
                        ds_terms=DS_TERMS, rows=None, exact=False,
                        exact_sums=False, big_of=bf16_round):
    """(dq, dk, dv) of the kernels' arithmetic ([B, L, H, D]; with `rows` an
    index of L, dq of those q rows and dk, dv of those keys):
    `accumulate_bf16` of `scores_bf16`."""
    sc = scores_bf16(q, k, v, o, lse, do, rows, exact)
    return accumulate_bf16(sc, p_terms, ds_terms, exact or exact_sums, big_of)


def scores_bf16(q, k, v, o, lse, do, rows=None, exact=False) -> dict:
    """P and dS as the kernels form them, with L padded to 64-row tiles
    (P = dS = 0 past L: the kernels add exact zeros there): S and dP by
    four 16-deep steps over d from zero, P = 2^(fp32(S c - lse2)), dS = P
    fp32(dP scale - di scale), di = rowsum(dO O) in fp32. "rows": P and dS
    of the q rows `rows` (all by default) against every key, for dq;
    "cols": of every q row against the keys `rows`, for dk and dv (the same
    tensors when `rows` is None). With `exact`, float64 and nothing rounded.
    Also the padded [B, H, Lp, D] q, k and dO."""
    b, seq, h, d = q.shape
    dt = torch.float64 if exact else torch.float32
    scale = d ** -0.5
    c = scale * LOG2E if exact else float(torch.tensor(scale * LOG2E))
    pad = -seq % BT
    qh, kh, vh, oh, doh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).to(dt), (0, 0, 0, pad)) for x in (q, k, v, o, do))
    lse2 = (lse.to(dt) * (LOG2E if exact else torch.tensor(LOG2E))).to(dt)
    lse2 = torch.nn.functional.pad(lse2.reshape(b, h, seq), (0, pad))
    dis = ((doh.double() * oh.double()).sum(-1).to(dt)
           * torch.tensor(scale, dtype=dt))
    lp = seq + pad
    real = torch.arange(lp) < seq

    def p_ds(qi, ki):
        """P and dS [B, H, |qi|, |ki|], 0 past L, 128 keys at a time."""
        p = torch.zeros(qh.shape[:2] + (len(qi), len(ki)), dtype=dt)
        ds = torch.zeros_like(p)
        for k0 in range(0, len(ki), 128):
            kb = ki[k0:k0 + 128]
            if exact:
                s = qh[..., qi, :] @ kh[..., kb, :].transpose(-1, -2)
                dp = doh[..., qi, :] @ vh[..., kb, :].transpose(-1, -2)
                pb = torch.exp2(s * c - lse2[..., qi, None])
                dsb = pb * (dp * scale - dis[..., qi, None])
            else:
                s = mma_bf16(qh[..., qi, :], kh[..., kb, :].transpose(-1, -2))
                dp = mma_bf16(doh[..., qi, :], vh[..., kb, :].transpose(-1, -2))
                pb = torch.exp2((s.double() * c
                                 - lse2[..., qi, None].double()).float())
                dsb = pb * (dp.double() * scale
                            - dis[..., qi, None].double()).float()
            mask = real[qi][:, None] & real[kb][None, :]
            p[..., k0:k0 + 128] = torch.where(mask, pb, 0.0)
            ds[..., k0:k0 + 128] = torch.where(mask, dsb, 0.0)
        return p, ds

    every = torch.arange(lp)
    if rows is None:
        p, ds = p_ds(every, every)
        by_rows, by_cols = (p[..., :seq, :], ds[..., :seq, :]), (p[..., :seq],
                                                                 ds[..., :seq])
    else:
        by_rows, by_cols = p_ds(rows, every), p_ds(every, rows)
    return {"rows": by_rows, "cols": by_cols, "q": qh, "k": kh, "do": doh}


def accumulate_bf16(sc: dict, p_terms=P_TERMS, ds_terms=DS_TERMS,
                    exact_sums=False, big_of=bf16_round):
    """dq += dS K over the keys, dv += P^T dO and dk += dS^T Q over the q
    rows, one 64-row streamed tile after another, by `_take` (with
    `exact_sums`, every sum in float64; `big_of` makes a two-term split's
    big term); returned as [B, L, H, D] of the selected rows."""
    (_, ds_r), (p_c, ds_c) = sc["rows"], sc["cols"]
    qh, kh, doh = sc["q"], sc["k"], sc["do"]
    acc = torch.float64 if exact_sums else qh.dtype
    d = qh.shape[-1]
    dq = torch.zeros(ds_r.shape[:-1] + (d,), dtype=acc)
    dk = torch.zeros(p_c.shape[:2] + (p_c.shape[-1], d), dtype=acc)
    dv = torch.zeros_like(dk)
    for t0 in range(0, qh.shape[-2], BT):
        tile = slice(t0, t0 + BT)
        dq = _take(dq, ds_r[..., tile], kh[..., tile, :], ds_terms,
                   exact_sums, big_of)
        dv = _take(dv, p_c[..., tile, :].transpose(-1, -2), doh[..., tile, :],
                   p_terms, exact_sums, big_of)
        dk = _take(dk, ds_c[..., tile, :].transpose(-1, -2), qh[..., tile, :],
                   ds_terms, exact_sums, big_of)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _references(q, k, v, o, lse, do, pallas=False):
    """{name: (dq, dk, dv)} on the same values: float64, the plain version
    in fp32 (the card's comparison) and, with `pallas`, the Pallas kernels
    in interpret mode on the values in fp32 (their bf16 route would round
    their outputs to bf16)."""
    refs = {"float64": flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o)), lse.double(), do.double()),
            "plain": flash_attention_bwd_plain(q, k, v, o, lse, do)}
    if pallas:
        got = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                              jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                              block_q=512, block_k=512, interpret=True)
        refs["pallas"] = tuple(torch.from_numpy(np.array(g)) for g in got)
    return refs


def _on_rows(grads, rows):
    """dq, dk, dv of the rows `rows` (all rows when None)."""
    return grads if rows is None else tuple(g[:, rows] for g in grads)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 40, 2), (1, 130, 2)])
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products and P and dS unrounded (float64), the tiles,
    the log2 units and the padded rows give the plain backward: only the
    order of sums differs. L = 40 is shorter than one tile, 130 ends two
    rows into the third."""
    inputs = [x.double() for x in _inputs(b, seq, h, seq + h)]
    got = backward_bf16_tiles(*inputs, exact=True)
    for g, want in zip(got, flash_attention_bwd_plain(*inputs)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 1000, 2)])
def test_two_terms_hold_the_limit_against_pallas_and_plain(b, seq, h):
    """P and dS as two bf16 terms, every step rounded toward zero: dq, dk
    and dv within half the limit of float64, the plain version and the
    Pallas kernels before the bf16 store, and within the limit of the plain
    version after it; a planted x1.05 fault reads beyond the limit."""
    inputs = _inputs(b, seq, h, seq + 7 * h)
    got = backward_bf16_tiles(*inputs)
    for name, want in _references(*inputs, pallas=True).items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= HALF, (name, reads)
    plain = _references(*inputs)["plain"]
    stored = [rel(bf16_round(g), w) for g, w in zip(got, plain)]
    fault = [rel(bf16_round(g) * FAULT_SCALE, w) for g, w in zip(got, plain)]
    assert max(stored) <= REL_TOL and min(fault) > REL_TOL, (stored, fault)


@functools.lru_cache(maxsize=None)
def _rule_reads(b, seq, h, rows_a_side):
    """{(p_terms, ds_terms): [dq, dk, dv]}: max |error| over max|plain|
    before the bf16 store, against the plain version on the same values,
    for one term of both and for two (rows: `rows_a_side` spread over L,
    or all)."""
    inputs = _inputs(b, seq, h, seq + h)
    rows = (None if rows_a_side is None
            else torch.arange(0, seq, seq // rows_a_side)[:rows_a_side])
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    sc = scores_bf16(*inputs, rows)
    return {terms: [rel(g, w) for g, w in zip(accumulate_bf16(sc, *terms),
                                              want)]
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
    d = 64 training shape and at L = 1000 and 8192; otherwise two. One term
    of P reads up to ~2.8e-3 of max on dv and one of dS ~2.1e-3 on dq and
    dk, past half the limit (2.0e-3): dS K and dS^T Q cancel (each row of
    dS sums to about zero), and P's rounding does not average out in
    P^T dO either. Stored to bf16, one term would land within ~4% of the
    limit. So the kernels take two terms of each."""
    reads = {shape: _rule_reads(*shape) for shape in RULE_SHAPES}
    p_one = max(r[1, 1][2] for r in reads.values())
    ds_one = max(max(r[1, 1][:2]) for r in reads.values())
    assert p_one > HALF and ds_one > HALF, reads
    assert (P_TERMS, DS_TERMS) == (2, 2)


def test_rounding_toward_zero_over_l_8192_stays_far_below_the_limit():
    """mma.sync rounds each step's sum toward zero, and dq, dk and dv each
    take L / 16 steps of each term into one accumulator. At L = 8192, on
    256 rows a side, against the same terms summed in float64, that
    rounding moves the result by < 1e-4 of max, a fortieth of half the
    limit, and the total stays within half the limit: the kernels keep one
    accumulator, without per-chunk partials."""
    inputs = _inputs(1, 8192, 1, 11)
    rows = torch.arange(0, 8192, 32)
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    sc = scores_bf16(*inputs, rows)
    got = accumulate_bf16(sc)
    exact = accumulate_bf16(sc, exact_sums=True)
    rz = [rel(g, e) for g, e in zip(got, exact)]
    total = [rel(g, w) for g, w in zip(got, want)]
    assert max(rz) < 1e-4 and max(rz) > 0, rz
    assert max(total) <= HALF, total


def test_two_terms_sum_to_within_2_to_the_minus_17():
    """`pack_split` (flash_bf16.cuh): big = bf16(x), small = bf16(x - big),
    x - big exact in fp32; big + small is within 2^-17 |x| of x."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000)
                         .astype(np.float32)) * 3.0
    big = bf16_round(x)
    small = bf16_round(x - big)
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -17 * x.double().abs()).all()


# -- the tiles in shared memory ----------------------------------------------
def test_ldmatrix_lanes_address_the_fragments_in_order():
    """Every fragment read of the two kernels, at the rows it starts from:
    the kept tile's A fragments (rows 16 w + Lane::ar, chunks ca) for Q,
    dO, O (dq) and K, V (dkv); the streamed tile's B fragments without
    .trans for S and dP (chunk rows c0 + 16 np + Lane::br, chunks cb) and
    with .trans for the products with P and dS (rows c0 + 16 kk + Lane::ar,
    chunks ca). Matrix m of an ldmatrix.x4 (lanes 8m..8m + 7) must hold
    a_m of A, b0 / b1 of n-tiles 0, 1 of B; and `Lane`'s offsets are the
    swizzle's at every such row (a multiple of 8 plus the lane's row)."""
    for m in range(4):
        for lane in range(8 * m, 8 * m + 8):
            ar, br, ac, bc = _lane(lane)
            assert (ar // 8, ac) == (m & 1, m >> 1)  # A and B with .trans
            assert (br // 8, bc) == (m >> 1, m & 1)  # B without .trans
    starts = ([16 * w for w in range(4)]
              + [c0 + 16 * i for c0 in range(0, BT, KC) for i in range(2)])
    for lane in range(32):
        ar, br, ac, bc = _lane(lane)
        for r0 in starts:
            for j in range(D // 16):
                for row, c, which in ((r0 + ar, 2 * j + ac, "a"),
                                      (r0 + br, 2 * j + bc, "b")):
                    assert (4 * _swizzled_words(D, row, c)
                            == row * ROW_BYTES + _chunk_bytes(lane, j, which))


def test_copies_and_fragment_reads_hit_32_banks():
    """cp.async writes a tile 16 bytes a lane, 8 lanes a phase on one row's
    8 chunks; each ldmatrix matrix (with or without .trans) is 8 rows at one
    chunk: all 32 banks, at every row and chunk. The lse / di rows land 4
    bytes a thread, 32 consecutive words a warp; dkv reads them as float2
    at columns 8 n + 2t: 4 addresses shared by 8 lanes each, 8 banks, no
    conflict."""
    for i0 in range(0, BT * D // 8, 8):
        words = [_swizzled_words(D, i // (D // 8), i % (D // 8)) + w
                 for i in range(i0, i0 + 8) for w in range(4)]
        assert sorted(banks(words)) == list(range(32))
    for r0 in range(0, BT, 8):
        for c in range(D // 8):
            words = [_swizzled_words(D, r, c) + w
                     for r in range(r0, r0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
    for w0 in range(0, NT, 32):
        assert sorted(banks(range(w0, w0 + 32))) == list(range(32))
    for base in (0, BT):  # the lse, then the di row of a buffer
        for c0 in range(0, BT, KC):
            for n in range(KC // 8):
                addrs = {base + c0 + 8 * n + 2 * (lane & 3) for lane in range(32)}
                hit = [x for a in addrs for x in banks((a, a + 1))]
                assert len(addrs) == 4 and len(set(hit)) == 8


def test_grid_shared_memory_and_waves():
    """64-row kept tiles of 4 warps. dq: Q, dO and a ring of three K / V
    pairs (O passes through the third K buffer), 64 KB, three blocks per SM
    by shared memory (1 KB reserved a block) and by registers (at most 168
    a thread; ptxas: 167). dkv: K, V, three Q / dO pairs and their lse and
    di rows, 65.5 KB; at 168 registers it spills, so two blocks per SM (at
    most 255; ptxas: 252). Each kernel gives 640 blocks at [2, 4096, 5, 64]
    and 320 at [2, 1024, 10, 64]: dq 1.6 and 0.8 waves of 396 slots, dkv
    2.4 and 1.2 of 264."""
    assert DQ_SMEM == 65536 and DKV_SMEM == 67072
    assert 3 * (DQ_SMEM + 1024) <= SMEM_PER_SM < 4 * (DQ_SMEM + 1024)
    assert 2 * (DKV_SMEM + 1024) <= SMEM_PER_SM
    assert REGS_PER_SM // (3 * NT) // 8 * 8 == 168
    assert REGS_PER_SM // (2 * NT) - 1 == 255  # the ISA's limit a thread
    for (b, seq, h), blocks in (((2, 4096, 5), 640), ((2, 1024, 10), 320)):
        assert math.ceil(seq / BT) * b * h == blocks
    waves = {per_sm: [round(n / (per_sm * SMS), 2) for n in (640, 320)]
             for per_sm in (3, 2)}
    assert waves == {3: [1.62, 0.81], 2: [2.42, 1.21]}
