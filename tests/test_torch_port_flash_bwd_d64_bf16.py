"""The numeric design and the shared-memory layout of the bf16 flash
backward at d = 64 on wgmma (`flash_dq_d64_bf16` and `flash_dkv_d64_bf16`
in `rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels keep a 64-row tile (q rows in dq, keys in dkv: one consumer
warpgroup a block, two blocks an SM) and stream 64-row tiles of the other
side, which TMA writes into shared memory in the 128-byte swizzle. Every product
is a `wgmma` with bf16 operands and fp32 accumulators. S = Q K^T and
dP = dO V^T (dkv: S^T = K Q^T and dP^T = V dO^T, the same sums) take
shared-memory operands, four 16-deep steps over d from zero; P = 2^(S c -
lse2) in log2 units (c = d^-1/2 log2(e), lse2 = lse log2(e)) and dS = P
(dP scale - di scale) are formed in the accumulator registers; then dq +=
dS K over the keys, dv += P^T dO and dk += dS^T Q over the q rows, one
16-deep step after another into one accumulator, P and dS taken from
registers as two bf16 terms (big = bf16(x), small = bf16(x - big)), each
term's step a `wgmma` of its own, the small one first. The tiles change no
sum: each score is its own 64-long dot product, and each accumulator takes
its steps in key (or q row) order whatever the tiles. A padded key (dq) or
q row (dkv) adds exact zeros.

This file emulates that arithmetic (`backward_bf16_tiles`) with `wgmma`'s
rounding as the card shows it (`tests/torch_port_tf32.py` `wgmma_bf16`:
each term cut two bits below the largest one's ulp, the sum rounded toward
zero; the functions take it as `mm=MM`, and default to `mma.sync`'s
model, `mma_bf16`, for the d = 16 and 512 files that run them) and holds it to float64, to the plain version and to the Pallas
kernels in interpret mode at the limit the card holds the bf16 backward
to: 2^-8 + 1e-4 of max|plain| against the plain version's unrounded fp32
result, after the kernels' bf16 store (`chip_smoke.py` `REL_TOL`). It reads
the rule that chose two terms for P and for dS, the rounding over L =
8192, the two terms' sum, the swizzled tiles as each operand reads them,
the accumulator -> A-fragment mapping of P^T and dS^T, the prologue's and
the row terms' addresses, and the kernels' grid, shared memory, waves and
register exchange.
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
from tests.torch_port_tf32 import (
    bf16_round,
    mma_bf16,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
    swizzle128,
    wgmma_bf16,
    wgmma_reads,
)

D = 64
NWG, BLOCKS = 1, 2  # d64_bf16:: consumer warpgroups a block, blocks an SM
BM, BN, NT, STAGES = 64 * NWG, 64, 128 * (NWG + 1), 4
TILE = 64 * D * 2  # d64_bf16::kTile: bytes of 64 rows of one tensor
ROW_TERMS = 2 * BN * 4  # d64_bf16::kRowTerms: lse and di of 64 q rows
DQ_SMEM = 1024 + 3 * NWG * TILE + 2 * STAGES * TILE  # Q, dO, O; K, V rings
DKV_SMEM = 1024 + 2 * NWG * TILE + 2 * STAGES * TILE + STAGES * ROW_TERMS
LAUNCH_REGS, PRODUCER_REGS, CONSUMER_REGS = 128, 24, 232
SMEM_PER_SM, SMS, REGS_PER_SM = 233472, 132, 65536
REL_TOL = 2.0 ** -8 + 1e-4  # the card's limit on dq, dk, dv, of max|plain|
HALF = REL_TOL / 2  # the precision rule's bound on a term choice's reading
FAULT_SCALE = 1.05
LOG2E = math.log2(math.e)
P_TERMS = DS_TERMS = 2  # the kernels take P and dS as big + small (the rule)
# the kernels' products: `wgmma` (the emulation below defaults to
# `mma.sync`'s model, `mma_bf16`, for the d = 16 and 512 files that take it)
MM = wgmma_bf16
# (B, L, H, rows): the training path's d = 64 shapes ([2, 4096, 5, 64] as
# one head: its heads are alike), L = 1000 with B = 2, H = 3, and L = 8192
# on 256 rows a side (each row's sums are its own)
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


def _take(acc, x, b, terms, exact, big_of=bf16_round, mm=mma_bf16):
    """acc + x b in 16-deep steps along x's last axis, each step by `mm`
    (`wgmma_bf16`: one instruction a step; `mma_bf16`: each step's exact
    sum rounded toward zero): x as `terms` bf16 terms (1: bf16(x); 2: big =
    big_of(x), small = bf16(x - big), the small term's step, then the big
    term's); with `exact`, x as it is, summed in float64."""
    if exact:
        return acc + x @ b
    if terms == 1:
        return mm(bf16_round(x), b, acc)
    big = big_of(x)
    steps = x.shape[-1] // 16
    a = torch.stack([bf16_round(x - big).unflatten(-1, (steps, 16)),
                     big.unflatten(-1, (steps, 16))], -2).flatten(-3)
    bb = b.unflatten(-2, (steps, 16))
    return mm(a, torch.stack([bb, bb], -3).flatten(-4, -2), acc)


def backward_bf16_tiles(q, k, v, o, lse, do, p_terms=P_TERMS,
                        ds_terms=DS_TERMS, rows=None, exact=False,
                        exact_sums=False, big_of=bf16_round, mm=mma_bf16):
    """(dq, dk, dv) of the kernels' arithmetic ([B, L, H, D]; with `rows` an
    index of L, dq of those q rows and dk, dv of those keys):
    `accumulate_bf16` of `scores_bf16`, every product by `mm`."""
    sc = scores_bf16(q, k, v, o, lse, do, rows, exact, mm=mm)
    return accumulate_bf16(sc, p_terms, ds_terms, exact or exact_sums,
                           big_of, mm)


def scores_bf16(q, k, v, o, lse, do, rows=None, exact=False, mm=mma_bf16,
                padded_p=False) -> dict:
    """P and dS as the kernels form them, with L padded to 64-row tiles: S
    and dP by 16-deep `mm` steps over d from zero, P = 2^(fp32(S c
    - lse2)), dS = P fp32(dP scale - di scale), di = rowsum(dO O) in fp32,
    P = dS = 0 past L (the dq kernel masks its keys past L; with
    `padded_p`, P = 1 on a padded q row, as the dkv kernel forms it from
    its zero-filled Q, dO, lse and di). "rows": P and dS of the q rows
    `rows` (all by default) against every key, for dq; "cols": of every q
    row against the keys `rows`, for dk and dv (the same tensors when
    `rows` is None). With `exact`, float64 and nothing rounded. Also the
    padded [B, H, Lp, D] q, k and dO."""
    b, seq, h, d = q.shape
    dt = torch.float64 if exact else torch.float32
    scale = d ** -0.5
    c = scale * LOG2E if exact else float(torch.tensor(scale * LOG2E))
    pad = -seq % BN
    qh, kh, vh, oh, doh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).to(dt), (0, 0, 0, pad)) for x in (q, k, v, o, do))
    lse2 = (lse.to(dt) * (LOG2E if exact else torch.tensor(LOG2E))).to(dt)
    lse2 = torch.nn.functional.pad(lse2.reshape(b, h, seq), (0, pad))
    dis = ((doh.double() * oh.double()).sum(-1).to(dt)
           * torch.tensor(scale, dtype=dt))
    lp = seq + pad
    real = torch.arange(lp) < seq

    def p_ds(qi, ki):
        """P and dS [B, H, |qi|, |ki|], 128 keys at a time."""
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
                s = mm(qh[..., qi, :], kh[..., kb, :].transpose(-1, -2))
                dp = mm(doh[..., qi, :], vh[..., kb, :].transpose(-1, -2))
                pb = torch.exp2((s.double() * c
                                 - lse2[..., qi, None].double()).float())
                dsb = pb * (dp.double() * scale
                            - dis[..., qi, None].double()).float()
            keep = real[kb][None, :] & (True if padded_p else real[qi][:, None])
            p[..., k0:k0 + 128] = torch.where(keep, pb, 0.0)
            ds[..., k0:k0 + 128] = torch.where(keep, dsb, 0.0)
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
                    exact_sums=False, big_of=bf16_round, mm=mma_bf16):
    """dq += dS K over the keys, dv += P^T dO and dk += dS^T Q over the q
    rows by `_take` (`big_of` makes a two-term split's big term, `mm` takes
    each step), one accumulator each over the whole L (the streamed tiles
    take their steps in order into it; with `exact_sums`, every sum in
    float64); returned as [B, L, H, D] of the selected rows."""
    (_, ds_r), (p_c, ds_c) = sc["rows"], sc["cols"]
    qh, kh, doh = sc["q"], sc["k"], sc["do"]
    acc = torch.float64 if exact_sums else qh.dtype
    d = qh.shape[-1]
    dq = torch.zeros(ds_r.shape[:-1] + (d,), dtype=acc)
    dk = torch.zeros(p_c.shape[:2] + (p_c.shape[-1], d), dtype=acc)
    dv = torch.zeros_like(dk)
    dq = _take(dq, ds_r, kh, ds_terms, exact_sums, big_of, mm)
    dv = _take(dv, p_c.transpose(-1, -2), doh, p_terms, exact_sums, big_of,
               mm)
    dk = _take(dk, ds_c.transpose(-1, -2), qh, ds_terms, exact_sums, big_of,
               mm)
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
    """P and dS as two bf16 terms, every product by `wgmma`'s rounding: dq,
    dk and dv within half the limit of float64, the plain version and the
    Pallas kernels before the bf16 store, and within the limit of the
    plain version after it; a planted x1.05 fault reads beyond the
    limit."""
    inputs = _inputs(b, seq, h, seq + 7 * h)
    got = backward_bf16_tiles(*inputs, mm=MM)
    for name, want in _references(*inputs, pallas=True).items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= HALF, (name, reads)
    plain = _references(*inputs)["plain"]
    stored = [rel(bf16_round(g), w) for g, w in zip(got, plain)]
    fault = [rel(bf16_round(g) * FAULT_SCALE, w) for g, w in zip(got, plain)]
    assert max(stored) <= REL_TOL and min(fault) > REL_TOL, (stored, fault)


@functools.lru_cache(maxsize=None)
def _rule_reads(b, seq, h, rows_a_side):
    """{(p_terms, ds_terms): [dq, dk, dv]} under `wgmma`'s rounding: max
    |error| over max|plain| before the bf16 store, against the plain
    version on the same values, for one term of both and for two (rows:
    `rows_a_side` spread over L, or all); and under "rz", the two terms'
    reading against the same terms summed in float64 (what the rounding
    of the sums moves)."""
    inputs = _inputs(b, seq, h, seq + h)
    rows = (None if rows_a_side is None
            else torch.arange(0, seq, seq // rows_a_side)[:rows_a_side])
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    sc = scores_bf16(*inputs, rows, mm=MM)
    reads = {terms: accumulate_bf16(sc, *terms, mm=MM)
             for terms in ((1, 1), (2, 2))}
    exact = accumulate_bf16(sc, exact_sums=True)
    out = {terms: [rel(g, w) for g, w in zip(got, want)]
           for terms, got in reads.items()}
    out["rz"] = [rel(g, e) for g, e in zip(reads[2, 2], exact)]
    return out


@pytest.mark.parametrize("b,seq,h,rows", RULE_SHAPES)
def test_two_terms_read_within_half_the_limit(b, seq, h, rows):
    """At every shape of the rule, under `wgmma`'s rounding, P and dS as two
    terms read at most half the limit on dq, dk and dv (the rule's
    condition for the terms the kernels take)."""
    reads = _rule_reads(b, seq, h, rows)
    assert max(reads[2, 2]) <= HALF, reads


def test_the_rule_takes_two_terms_of_p_and_of_ds():
    """The rule: P (dv = P^T dO) and dS (dq = dS K, dk = dS^T Q) each take
    one bf16 term only if it reads at most half the card's limit at every
    d = 64 training shape and at L = 1000 and 8192; otherwise two. Under
    `wgmma`'s rounding one term of P reads up to ~2.3e-3 of max on dv and
    one of dS ~3.2e-3 on dq and ~2.4e-3 on dk, past half the limit
    (2.0e-3): dS K and dS^T Q cancel (each row of dS sums to about zero),
    and P's rounding does not average out in P^T dO either. Two terms read
    ~2e-5. So the kernels take two terms of each."""
    reads = {shape: _rule_reads(*shape) for shape in RULE_SHAPES}
    p_one = max(r[1, 1][2] for r in reads.values())
    ds_one = max(max(r[1, 1][:2]) for r in reads.values())
    two = max(max(r[2, 2]) for r in reads.values())
    assert p_one > HALF and ds_one > HALF and two < HALF / 50, reads
    assert (P_TERMS, DS_TERMS) == (2, 2)


def test_rounding_toward_zero_over_l_8192_stays_far_below_the_limit():
    """`wgmma` cuts each term two bits below the largest one's ulp and
    rounds each instruction's sum toward zero, and dq, dk and dv each take
    L / 16 steps of each term into one accumulator. At L = 8192 (256 rows a
    side), against the same terms summed in float64, that moves the result
    by < 1e-4 of max, a fortieth of half the limit, and the total stays
    within half the limit: the kernels keep one accumulator, without
    per-tile partials."""
    reads = _rule_reads(1, 8192, 1, 256)
    assert 0 < max(reads["rz"]) < 1e-4, reads
    assert max(reads[2, 2]) <= HALF, reads


def test_two_terms_sum_to_within_2_to_the_minus_17():
    """`pack_split` (flash_bf16.cuh): big = bf16(x), small = bf16(x - big),
    x - big exact in fp32; big + small is within 2^-17 |x| of x."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000)
                         .astype(np.float32)) * 3.0
    big = bf16_round(x)
    small = bf16_round(x - big)
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -17 * x.double().abs()).all()


def test_padded_q_rows_add_exact_zeros():
    """In dkv a q row past L lands as zeros (Q, dO, lse, di), so P^T = 1 and
    dS^T = 0 there; under `wgmma`'s cut (which aligns an instruction's
    terms to the largest) its products with dO = 0 and Q = 0 leave dk and
    dv bit for bit as the same sums without those rows. L = 130 ends two
    rows into its third 64-row tile."""
    inputs = _inputs(1, 130, 2, 5)
    masked = accumulate_bf16(scores_bf16(*inputs, mm=MM), mm=MM)
    padded = accumulate_bf16(scores_bf16(*inputs, mm=MM, padded_p=True),
                             mm=MM)
    for a, b in zip(masked[1:], padded[1:]):
        assert torch.equal(a, b)


# -- the tiles, fragments and addresses -------------------------------------
def _tile_smem(dense: np.ndarray) -> np.ndarray:
    """A 64-row bf16 tile (128-byte rows) as TMA writes it under
    CU_TENSOR_MAP_SWIZZLE_128B from a 1024-aligned base: 16-bit words at
    `swizzle128`; every word once."""
    rows, n = dense.shape
    smem = np.full(rows * n, -1)
    for r in range(rows):
        for c in range(n):
            at = swizzle128(r, 2 * c)
            assert smem[at // 2] == -1
            smem[at // 2] = dense[r, c]
    assert (smem >= 0).all()
    return smem


@pytest.mark.parametrize("role", ["k_major", "mn_major"])
def test_swizzled_tiles_read_back_as_each_operand(role):
    """Every 64-row tile TMA writes (Q, dO, O, K, V of 64 rows) is read
    back by `wgmma` as the dense tile. K-major (the scores' A and B: Q and
    K, dO and V in dq, K and Q, V and dO in dkv): the descriptor steps by
    2 (32 bytes, 16 values) along the row each 16-deep step. MN-major (the
    products' B: K in dq, dO and Q in dkv, k = the streamed rows): it steps
    by 128 (2048 bytes, 16 rows) each step, every row's 64 values across
    the N dimension."""
    dense = np.random.default_rng(1).integers(0, 2 ** 15, size=(64, D))
    smem = _tile_smem(dense)
    got = np.empty_like(dense)
    for step in range(4):
        if role == "k_major":  # row r, values 16 step + c
            for r in range(64):
                for c in range(16):
                    got[r, 16 * step + c] = smem[
                        wgmma_reads(32 * step, r, 2 * c) // 2]
        else:  # k = rows 16 step + c, n = the row's 64 values
            for c in range(16):
                for n in range(D):
                    got[16 * step + c, n] = smem[
                        wgmma_reads(2048 * step, c, 2 * n) // 2]
    np.testing.assert_array_equal(got, dense)


def _acc_coords(w, lane, j, i):
    """(row, column) of accumulator register d[4 j + i] of warp w's lane in
    a 64 x N `wgmma` accumulator (flash_hopper.cuh's header)."""
    g, t = lane >> 2, lane & 3
    return 16 * w + g + 8 * (i >> 1), 8 * j + 2 * t + (i & 1)


def _a_coords(w, lane, kk, e):
    """The two (row, k) values of register a[e] of warp w's lane in the A
    operand (from registers) of 16-deep step kk, the lower k in the low
    half."""
    g, t = lane >> 2, lane & 3
    row = 16 * w + g + 8 * (e & 1)
    k = 16 * kk + 2 * t + 8 * (e >> 1)
    return (row, k), (row, k + 1)


def test_accumulator_fragments_are_the_a_fragments_of_p_t_and_ds_t():
    """`pack_terms` packs x[8 kk + 2 e] and x[8 kk + 2 e + 1] of a 64 x 64
    accumulator (S, dP in dq; S^T, dP^T in dkv, rows = keys) into register
    e of step kk's A operand: those two accumulator values must be the A
    fragment's (row, k) and (row, k + 1) at every warp, lane, step and
    register, so that P^T dO, dS^T Q and dS K read P^T, dS^T and dS with no
    exchange between lanes; and the 128 threads of a warpgroup hold each
    value once."""
    seen = set()
    for w in range(4):
        for lane in range(32):
            for kk in range(BN // 16):
                for e in range(4):
                    lo, hi = (_acc_coords(w, lane, (8 * kk + 2 * e + x) // 4,
                                          (8 * kk + 2 * e + x) % 4)
                              for x in (0, 1))
                    assert (lo, hi) == _a_coords(w, lane, kk, e)
                    seen.update((lo, hi))
    assert seen == {(r, c) for r in range(64) for c in range(BN)}


def test_di_quads_and_row_terms_address_every_value_once():
    """dq's prologue: lane t of a quad reads 16-byte chunks 2 t and 2 t + 1
    of its rows g and g + 8 of dO and O (swizzle128 of the row and byte
    16 (2 t + c)), so a quad covers every byte of its two rows once. dkv's
    producer lane l copies lse and di of the stage's q rows 2 l and
    2 l + 1 to words 2 l.. (lse) and 64 + 2 l.. (di) of the stage's row
    terms, and a consumer lane t reads them as float2 at columns 8 n + 2 t,
    the columns of its accumulator values."""
    for rr in range(64):
        got = sorted(swizzle128(rr, 16 * (2 * t + cc)) + i
                     for t in range(4) for cc in range(2) for i in range(16))
        assert got == list(range(128 * rr, 128 * rr + 128))
    written = {}
    for lane in range(32):
        for e in range(2):
            row = 2 * lane + e
            written[4 * row] = ("lse", row)
            written[4 * BN + 4 * row] = ("di", row)
    assert len(written) == ROW_TERMS // 4
    for lane in range(32):
        t = lane & 3
        for n in range(BN // 8):
            col = 8 * n + 2 * t
            for e in range(2):
                assert written[4 * (col + e)] == ("lse", col + e)
                assert written[4 * BN + 4 * (col + e)] == ("di", col + e)
                assert _acc_coords(0, lane, n, e)[1] == col + e


def test_grid_shared_memory_and_waves():
    """Two blocks of 256 threads per SM, each a consumer warpgroup of 64
    kept rows and a producer warpgroup. dq: Q, dO and O of 64 q rows and a
    ring of four K / V stages of 64 keys, 89 KB; dkv: K and V of 64 keys,
    four Q / dO stages and their rows' lse and di, 83 KB: two blocks fit
    the SM's 228 KB with their 1 KB reserved each, three do not. The
    launch has 128 registers a thread (65536 over 512); the producer gives
    back 104 a thread to 24, which covers the consumer's raise to 232, and
    a dkv consumer holds 192 of fragments (dk and dv, S^T and dP^T, the
    two terms of P^T and dS^T). Each kernel gives 640 blocks at
    [2, 4096, 5, 64] and 320 at [2, 1024, 10, 64]: 2.42 and 1.21 waves of
    264 slots, the last wave's blocks one an SM."""
    assert (DQ_SMEM, DKV_SMEM) == (91136, 84992)
    for smem in (DQ_SMEM, DKV_SMEM):
        assert BLOCKS * (smem + 1024) <= SMEM_PER_SM < 3 * (smem + 1024)
    assert LAUNCH_REGS == REGS_PER_SM // (BLOCKS * NT) // 8 * 8
    assert 128 * (LAUNCH_REGS - PRODUCER_REGS) >= 128 * NWG * (
        CONSUMER_REGS - LAUNCH_REGS)
    assert 3 * 64 < CONSUMER_REGS
    blocks = {seq: math.ceil(seq / BM) * b * h
              for (b, seq, h) in ((2, 4096, 5), (2, 1024, 10))}
    assert blocks == {4096: 640, 1024: 320}
    assert [round(n / (BLOCKS * SMS), 2) for n in blocks.values()] == [2.42,
                                                                       1.21]


def test_probe_variants_apply_to_the_kernels():
    """`rdeic_torch/tools/flash_bwd_probe.py --d 64` (the card probes
    PERF.md cites) changes the `d64_bf16` kernels by text substitutions:
    each of its variants still finds its text in csrc/flash_attn_bwd.cu,
    changes only that namespace, and a text that is not there raises."""
    from rdeic_torch import build
    from rdeic_torch.tools.flash_bwd_probe import VARIANTS, variant_source

    src = build.FLASH_BWD_SRC.read_text()
    head = src[:src.index("namespace d64_bf16 {")]
    tail = src[src.index("}  // namespace d64_bf16"):]
    for name, edits in VARIANTS["d64_bf16"].items():
        got = variant_source(src, edits, "d64_bf16")
        assert got != src and got.startswith(head) and got.endswith(tail), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], "d64_bf16")
