"""The numeric design and the shared-memory layout of the fp32 flash
backward at d = 64 on TF32 wgmma (`flash_dq_d64` and `flash_dkv_d64` in
`rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels keep 128 rows a block (q rows in dq, keys in dkv: two consumer
warpgroups of 64; in the half blocks of a last wave 64, both warpgroups
taking the streamed tiles in turn) and stream 32-row tiles of the other
side, which TMA loads raw and a producer warpgroup splits into the
operands `wgmma` reads.
Every fp32 product is three TF32 `wgmma` an 8-deep step, small * big, big *
small, big * big (big = x rounded to TF32, small = x - big as the tensor
core reads it). S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T and dP^T = V
dO^T) run over d from zero; P = 2^(fp32(S c - lse2)) in log2 units (c =
d^-1/2 log2(e), lse2 = lse log2(e)) and dS = P fp32(dP scale - di scale)
are formed in the accumulator registers (the kernels form P (dP - di) and
multiply dq and dk by the scale, 1/8, at the end: the same bits, as
`test_the_scale_at_the_end_gives_the_same_bits` holds); then each tile's
dq = dS K, dv = P^T dO and dk = dS^T Q run over its 32 streamed rows from
zero, and that
partial joins the running sum by one fp32 add (in a half block each
warpgroup's sum, the two then added). A padded key (dq) is masked and a
padded q row (dkv) adds exact zeros.

This file emulates that arithmetic (`backward_tiles`) with `wgmma`'s
rounding as the card shows it (`tests/torch_port_tf32.py` `wgmma_3xtf32`:
each term cut two bits below the largest one's ulp, each instruction's sum
rounded toward zero) and holds it to float64, to the plain version and to
the Pallas kernels in interpret mode at the limit the card holds the fp32
backward to: 1e-4 of max|plain| (`chip_smoke.py` `REL_TOL`). It reads one
TF32 pass against three, per-tile partials against one accumulator over
L = 1024 and 8192, the swizzled planes as each operand reads them, the
accumulator -> A-fragment mapping of P and dS, the banks of the producer's
split and the consumers' writes, the blocks' kept rows, and the kernels'
grid, shared memory, waves and registers.
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
    banks,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
    swizzle128,
    wgmma_3xtf32,
    wgmma_reads,
    wgmma_tf32,
)

D = 64
# flash_attn_bwd.cu d64:: consumer warpgroups, kept rows, streamed rows,
# stages of each ring, threads
NWG, BM, BN, STAGES, NT = 2, 128, 32, 2, 384
ATOM, SATOM = 64 * 128, BN * 128  # bytes: 64 / BN rows of 32 fp32
KEPT, PLANE, TPLANE = 2 * ATOM, 2 * SATOM, ATOM
RAW = 2 * PLANE
DQ_OP, DKV_OP = 4 * PLANE + 2 * TPLANE, 4 * PLANE + 4 * TPLANE
ROWS = STAGES * 2 * BN * 4
DQ_SMEM = 1024 + STAGES * (RAW + DQ_OP) + 2 * NWG * KEPT
DKV_SMEM = 1024 + STAGES * (RAW + DKV_OP) + 2 * NWG * KEPT + 2 * ROWS
LAUNCH_REGS = 168
DQ_REGS, DKV_REGS = (56, 224), (40, 232)  # producer, consumer
SMEM_PER_BLOCK, SMS, REGS_PER_SM = 232448, 132, 65536
REL_TOL = 1e-4  # the card's limit on dq, dk, dv, of max|plain|
FAULT_SCALE = 1.05
LOG2E = math.log2(math.e)
MM = wgmma_3xtf32  # the kernels' products


def _inputs(b, seq, h, seed):
    """fp32 q, k, v, dO [B, L, H, D] from normal draws (numpy, from the
    seed), and the float64 forward's o and lse rounded to fp32 (the
    backward kernels start from the forward's)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, seq, h, D))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_lse_plain(q.double(), k.double(), v.double())
    return q, k, v, o.float(), lse.float(), do


def _fma(a, b, c):
    """fmaf: a b + c rounded once to fp32."""
    return (a.double() * b + c.double()).float()


def _exp2(x):
    return torch.exp2(x.double()).float()


def scores_fp32(q, k, v, o, lse, do, rows=None, exact=False, mm=MM,
                padded_p=False) -> dict:
    """P and dS as the kernels form them, L padded to 32-row tiles. "rows":
    dS of the q rows `rows` (all by default) against every key, as dq forms
    them (S = mm(Q, K^T), dP = mm(dO, V^T), keys past L masked); "cols": P^T
    and dS^T of the keys `rows` against every q row, as dkv forms them
    (S^T = mm(K, Q^T), dP^T = mm(V, dO^T); a q row past L masked, or, with
    `padded_p`, formed from its zero Q, dO, lse and di as the kernel does).
    Each product from zero by `mm`; the softmax in fp32 with the kernels'
    roundings: c = fp32(scale log2(e)), lse2 = fp32(lse log2(e)), di =
    rowsum(dO O) in fp32, dis = fp32(di scale), P = exp2(fma(S, c, -lse2)),
    dS = P fma(dP, scale, -dis). With `exact`, float64 and nothing rounded.
    Also the padded [B, H, Lp, D] q, k and dO."""
    b, seq, h, d = q.shape
    dt = torch.float64 if exact else torch.float32
    scale = d ** -0.5
    if exact:
        c, l2e = scale * LOG2E, LOG2E
    else:
        scale = float(np.float32(scale))
        l2e = float(np.float32(LOG2E))
        c = float(np.float32(np.float32(scale) * np.float32(LOG2E)))
    pad = -seq % BN
    qh, kh, vh, oh, doh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).to(dt), (0, 0, 0, pad))
        for x in (q, k, v, o, do))
    lse2 = torch.nn.functional.pad(
        (lse.to(dt) * l2e).to(dt).reshape(b, h, seq), (0, pad))
    di = (doh.double() * oh.double()).sum(-1).to(dt)
    dis = (di * scale).to(dt)
    lp = seq + pad
    real = torch.arange(lp) < seq
    every = torch.arange(lp)
    qi = every if rows is None else rows

    def softmax(s, dp, l2, ds_, keep):
        if exact:
            p = torch.exp2(s * c - l2)
            return torch.where(keep, p, 0.0), torch.where(
                keep, p * (dp * scale - ds_), 0.0)
        p = _exp2(_fma(s, c, -l2))
        g = p * _fma(dp, scale, -ds_)
        return torch.where(keep, p, 0.0), torch.where(keep, g, 0.0)

    prod = (lambda x, y: x @ y) if exact else mm
    ds_rows = torch.zeros(qh.shape[:2] + (len(qi), lp), dtype=dt)
    for k0 in range(0, lp, 256):
        kb = every[k0:k0 + 256]
        s = prod(qh[..., qi, :], kh[..., kb, :].transpose(-1, -2))
        dp = prod(doh[..., qi, :], vh[..., kb, :].transpose(-1, -2))
        _, ds_rows[..., k0:k0 + 256] = softmax(
            s, dp, lse2[..., qi, None], dis[..., qi, None],
            real[kb][None, :] & real[qi][:, None])
    ki = qi
    p_cols = torch.zeros(qh.shape[:2] + (len(ki), lp), dtype=dt)
    ds_cols = torch.zeros_like(p_cols)
    for q0 in range(0, lp, 256):
        qb = every[q0:q0 + 256]
        st = prod(kh[..., ki, :], qh[..., qb, :].transpose(-1, -2))
        dpt = prod(vh[..., ki, :], doh[..., qb, :].transpose(-1, -2))
        keep = (torch.ones(len(ki), len(qb), dtype=torch.bool) if padded_p
                else real[qb][None, :].expand(len(ki), -1))
        p_cols[..., q0:q0 + 256], ds_cols[..., q0:q0 + 256] = softmax(
            st, dpt, lse2[..., None, qb], dis[..., None, qb], keep)
    return {"rows": ds_rows, "cols": (p_cols, ds_cols), "q": qh, "k": kh,
            "do": doh, "seq": seq}


def _take(x, y, partials, exact, mm=MM, halves=False):
    """x [.., M, Lp] @ y [.., Lp, D] over the Lp streamed rows. exact:
    float64. partials: each 32-row tile's product by `mm` from zero, the
    tiles' partials added in order in fp32 (the kernels' full blocks); with
    `halves`, the even tiles' and the odd tiles' each so, then the two
    added (a half block's two warpgroups). Else one accumulator: `mm` over
    all of Lp, every step into it."""
    if exact:
        return x @ y
    if not partials:
        return mm(x, y)
    t = x.shape[-1] // BN
    parts = mm(x.unflatten(-1, (t, BN)).movedim(-2, -3),
               y.unflatten(-2, (t, BN)))  # [.., T, M, D]
    sums = [torch.zeros_like(parts[..., 0, :, :]) for _ in range(2)]
    for j in range(t):
        w = j % 2 if halves else 0
        sums[w] = sums[w] + parts[..., j, :, :]
    return sums[0] + sums[1] if halves else sums[0]


def accumulate_fp32(sc: dict, partials=True, exact=False, mm=MM,
                    halves=False):
    """dq = dS K, dv = P^T dO, dk = dS^T Q over the streamed rows (`_take`),
    as [B, L, H, D] of the selected rows."""
    p_c, ds_c = sc["cols"]
    qh, kh, doh = sc["q"], sc["k"], sc["do"]
    dq = _take(sc["rows"], kh, partials, exact, mm, halves)
    dv = _take(p_c, doh, partials, exact, mm, halves)
    dk = _take(ds_c, qh, partials, exact, mm, halves)
    seq = sc["seq"]
    out = []
    for g in (dq, dk, dv):
        if g.shape[-2] > seq:  # all rows: drop the padded ones
            g = g[..., :seq, :]
        out.append(g.permute(0, 2, 1, 3))
    return tuple(out)


def backward_tiles(q, k, v, o, lse, do, rows=None, exact=False, mm=MM,
                   partials=True, halves=False):
    """(dq, dk, dv) of the kernels' arithmetic (with `rows`, dq of those q
    rows and dk, dv of those keys; with `halves`, as half blocks sum)."""
    sc = scores_fp32(q, k, v, o, lse, do, rows, exact, mm=mm)
    return accumulate_fp32(sc, partials, exact, mm, halves)


def _references(q, k, v, o, lse, do):
    """{name: (dq, dk, dv)}: float64, the plain version in fp32 (the
    card's comparison) and the Pallas kernels in interpret mode."""
    got = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                          jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                          block_q=512, block_k=512, interpret=True)
    return {"float64": flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o)), lse.double(),
                do.double()),
            "plain": flash_attention_bwd_plain(q, k, v, o, lse, do),
            "pallas": tuple(torch.from_numpy(np.array(g)) for g in got)}


def _on_rows(grads, rows):
    return grads if rows is None else tuple(g[:, rows] for g in grads)


TILE_SHAPES = [(2, 200, 3), (1, 40, 2), (1, 130, 2)]


@pytest.mark.parametrize("b,seq,h", TILE_SHAPES)
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products (float64), the tiles, the log2 units, the
    masks and the padded rows give the plain backward: only the order of
    sums differs. L = 40 is shorter than one 128-row kept tile and ends a
    quarter into the second 32-row tile; 130 ends two rows into the fifth."""
    inputs = [x.double() for x in _inputs(b, seq, h, seq + h)]
    got = backward_tiles(*inputs, exact=True)
    for g, want in zip(got, flash_attention_bwd_plain(*inputs)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("halves", [False, True], ids=["full", "halves"])
@pytest.mark.parametrize("b,seq,h", TILE_SHAPES)
def test_three_passes_hold_the_limit_against_pallas_and_plain(b, seq, h,
                                                              halves):
    """Three TF32 passes on `wgmma`'s rounding in the kernels' order, as a
    full block sums (every tile in turn) and as a half block does (even
    and odd tiles apart, then added): dq, dk and dv within a tenth of the
    limit of float64, the plain version and the Pallas kernels in
    interpret mode; a planted x1.05 fault reads beyond the limit."""
    inputs = _inputs(b, seq, h, seq + 7 * h)
    got = backward_tiles(*inputs, halves=halves)
    refs = _references(*inputs)
    for name, want in refs.items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= REL_TOL / 10, (name, reads)
    fault = [rel(g * FAULT_SCALE, w) for g, w in zip(got, refs["plain"])]
    assert min(fault) > REL_TOL, fault


@pytest.mark.parametrize("b,seq,h", [(1, 130, 2), (1, 512, 1)])
def test_one_tf32_pass_breaks_the_limit(b, seq, h):
    """One TF32 `wgmma` a product (fp32 operands read truncated), in the
    same order, misses 1e-4 of max on every gradient: the kernels take
    three passes."""
    inputs = _inputs(b, seq, h, seq + 7 * h)
    got = backward_tiles(*inputs, mm=wgmma_tf32)
    want = flash_attention_bwd_plain(*inputs)
    reads = [rel(g, w) for g, w in zip(got, want)]
    assert min(reads) > REL_TOL, reads


@functools.lru_cache(maxsize=None)
def _l_reads(seq, rows_a_side):
    """{partials: [dq, dk, dv]}: max |error| over max|float64| with per-tile
    partials (True) and with one accumulator (False), at (1, seq, 1) on
    `rows_a_side` rows spread over L (all rows when None)."""
    inputs = _inputs(1, seq, 1, seq + 1)
    rows = (None if rows_a_side is None
            else torch.arange(0, seq, seq // rows_a_side)[:rows_a_side])
    want = _on_rows(flash_attention_bwd_plain(
        *(x.double() for x in inputs)), rows)
    sc = scores_fp32(*inputs, rows)
    return {part: [rel(g, w) for g, w in zip(accumulate_fp32(sc, part), want)]
            for part in (True, False)}


L_SHAPES = [(1024, None), (8192, 96)]


def test_per_tile_partials_keep_the_error_flat_in_l():
    """With per-tile partials the fp32 error against float64 does not grow
    from L = 1024 to L = 8192 (at most 1.5x, and under 2e-5 of max, a
    fifth of the limit): `wgmma`'s rounding toward zero stays that of one
    32-row tile."""
    short, long = (_l_reads(*s)[True] for s in L_SHAPES)
    assert max(long) <= 1.5 * max(short) and max(long) < 2e-5, (short, long)


def test_one_accumulator_error_grows_with_l():
    """Without partials, every step's sum taken into one running
    accumulator, `wgmma` rounds each toward zero and the error grows with
    L: at L = 8192 it reads more than twice the partials' reading and more
    than at L = 1024 (the mma.sync design read 7.2e-5 of max on the card
    there)."""
    reads = {s: _l_reads(*s) for s in L_SHAPES}
    short, long = (reads[s][False] for s in L_SHAPES)
    assert max(long) > 2 * max(reads[L_SHAPES[1]][True]), reads
    assert max(long) > max(short), reads


def test_padded_q_rows_add_exact_zeros():
    """In dkv a q row past L lands as zeros (Q, dO, lse, di), so P^T = 1
    and dS^T = 0 there; under `wgmma`'s cut (each instruction's terms
    aligned to the largest) their products with dO^T = 0 and Q^T = 0 leave
    dk and dv bit for bit as the same sums without those rows. L = 130 ends
    two rows into its fifth 32-row tile."""
    inputs = _inputs(1, 130, 2, 5)
    masked = accumulate_fp32(scores_fp32(*inputs))
    padded = accumulate_fp32(scores_fp32(*inputs, padded_p=True))
    for a, b in zip(masked[1:], padded[1:]):
        assert torch.equal(a, b)


# -- the planes, fragments and addresses -------------------------------------
def _slot(x: int) -> int:
    """d64::slot_of: the k slot of streamed row x in a transposed plane."""
    e = x & 7
    return (x & ~7) + (4 + (e >> 1) if e & 1 else e >> 1)


def _split_tile_writes():
    """The byte addresses of d64::split_tile, per producer thread tid and
    iteration it: (row, d) of the float4 it reads and writes (chunk c of
    row `lane`), and the transposed words it writes."""
    for tid in range(128):
        lane, wq = tid & 31, tid >> 5
        for it in range(4):
            c = wq + 4 * it
            at = (c >> 3) * SATOM + swizzle128(lane, 16 * (c & 7))
            trans = [swizzle128(4 * c + e, 4 * _slot(lane)) for e in range(4)]
            yield tid, it, lane, c, at, trans


def test_split_tile_covers_every_value_once():
    """split_tile's float4 chunk c of row `lane` is d 4c..4c + 3 of that
    row in the K-major plane (two BN-row atoms, d 0-31 and 32-63) and the
    same values at rows d of the transposed plane, slot `_slot(lane)`:
    over the producer's 128 threads every byte of both planes once."""
    kmajor, trans = set(), set()
    for _, _, lane, c, at, tr in _split_tile_writes():
        for e in range(4):
            d = 4 * c + e
            want = (d >> 5) * SATOM + swizzle128(lane, 4 * (d & 31))
            assert at + 4 * e == want
            kmajor.add(at + 4 * e)
            assert tr[e] == swizzle128(d, 4 * _slot(lane))
            trans.add(tr[e])
    assert kmajor == set(range(0, PLANE, 4))
    assert trans == set(range(0, TPLANE, 4))


def test_split_and_kept_writes_hit_32_banks():
    """The producer's float4 reads and writes (8 lanes a 128-byte phase)
    and its transposed 4-byte writes (a warp a phase), and a consumer
    warp's writes of its kept small terms (load_kept: lane (g, t) at row
    16 w + g (+ 8), column 8 kk + t (+ 4)), each hit 32 distinct banks."""
    phases = {}
    for tid, it, _, _, at, trans in _split_tile_writes():
        warp, lane = tid >> 5, tid & 31
        phases.setdefault(("f4", warp, it, lane >> 3), []).extend(
            at // 4 + e for e in range(4))
        for e in range(4):
            phases.setdefault(("t", warp, it, e), []).append(trans[e] // 4)
    for key, words in phases.items():
        assert sorted(banks(words)) == list(range(32)), key
    for w in range(4):
        for kk in range(8):
            for i in range(4):
                words = []
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r = 16 * w + g + 8 * (i & 1)
                    col = 8 * kk + t + 4 * (i >> 1)
                    words.append(((col >> 5) * ATOM
                                  + swizzle128(r, 4 * (col & 31))) // 4)
                assert sorted(banks(words)) == list(range(32)), (w, kk, i)


def _words(dense: np.ndarray, rows: int, atom: int) -> np.ndarray:
    """A rows x 64 fp32 tile in two swizzled atoms of `atom` bytes (d 0-31,
    32-63): one word a value."""
    smem = np.full(2 * atom // 4, -1)
    for r in range(rows):
        for d in range(64):
            at = (d >> 5) * atom + swizzle128(r, 4 * (d & 31))
            smem[at // 4] = dense[r, d]
    assert (smem >= 0).all()
    return smem


@pytest.mark.parametrize("rows,atom", [(BN, SATOM), (64, ATOM)],
                         ids=["streamed", "kept"])
def test_k_major_planes_read_back_as_the_operand(rows, atom):
    """A streamed plane (TMA's raw tile and the split big and small planes:
    32 rows, the scores' B) and a kept small plane (64 rows, the first
    pass's A) are read by `wgmma` at 8-deep step kk from the descriptor at
    atom kk // 4 + 32 (kk % 4) bytes: row r, value i is (r, 8 kk + i)."""
    dense = np.random.default_rng(1).integers(0, 2 ** 20, size=(rows, 64))
    smem = _words(dense, rows, atom)
    got = np.empty_like(dense)
    for kk in range(8):
        start = (kk >> 2) * atom + 32 * (kk & 3)
        for r in range(rows):
            for i in range(8):
                got[r, 8 * kk + i] = smem[wgmma_reads(start, r, 4 * i) // 4]
    np.testing.assert_array_equal(got, dense)


def test_transposed_planes_and_fragments_give_the_products():
    """The producer writes a streamed tile X (32 rows x 64) transposed as
    the products' B (n = d, k = slots, K-major): (d, slot) at
    `swizzle128(d, 4 slot)`. `wgmma`'s read of step kk (start 32 kk) gives
    B[slot][d] = X[row of the slot][d], and the consumers' `terms` take the
    accumulator of P (64 x 32: d[4 j + i] at row g + 8 (i >> 1), column
    8 j + 2 t + (i & 1)) as the TF32 A fragment of step kk (a[e] =
    d[4 kk + (0, 2, 1, 3)[e]]; a0..a3 at (g, t), (g + 8, t), (g, t + 4),
    (g + 8, t + 4)), which puts the same row at each slot: A B = P X
    exactly, every accumulator value taken once."""
    rng = np.random.default_rng(3)
    x = rng.integers(-64, 64, size=(BN, 64))  # [streamed row][d]
    p = rng.integers(0, 8, size=(64, BN))  # [kept row][streamed row]
    words = np.full(TPLANE // 4, 10 ** 6)
    for r in range(BN):
        for d in range(64):
            words[swizzle128(d, 4 * _slot(r)) // 4] = x[r, d]
    assert (words != 10 ** 6).all()
    bmat = np.empty((BN, 64), dtype=np.int64)  # [slot][d], as wgmma reads it
    for kk in range(BN // 8):
        for s in range(8):
            for d in range(64):
                at = wgmma_reads(32 * kk, d, 4 * s)
                bmat[8 * kk + s, d] = words[at // 4]
    a = np.full((64, BN), 10 ** 6, dtype=np.int64)  # [kept row][slot]
    seen = set()
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for kk in range(BN // 8):
                for e in range(4):
                    j = 4 * kk + (0, 2, 1, 3)[e]  # the accumulator register
                    n, i = j // 4, j % 4
                    row = 16 * w + g + 8 * (i >> 1)
                    col = 8 * n + 2 * t + (i & 1)
                    seen.add((row, col))
                    arow = 16 * w + g + 8 * (e & 1)
                    aslot = 8 * kk + t + 4 * (e >> 1)
                    assert row == arow
                    a[arow, aslot] = p[row, col]
    assert seen == {(r, c) for r in range(64) for c in range(BN)}
    for r in range(BN):
        np.testing.assert_array_equal(bmat[_slot(r)], x[r])
    np.testing.assert_array_equal(a @ bmat, p @ x)


def test_the_scale_at_the_end_gives_the_same_bits():
    """The kernels form dS / scale = P (dP - di) and multiply dq and dk by
    the scale (d^-1/2 = 1/8) at the end. A power of two commutes with every
    fp32 rounding and with `wgmma`'s cut (terms aligned to the largest, cut
    at a fixed number of bits below it), so the bits are those of P
    fp32(dP scale - di scale) summed as they are: the partials of one tile
    and their fp32 sum over tiles."""
    rng = np.random.default_rng(4)
    p, dp, di = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.uniform(0, 1, (64, 64)), rng.standard_normal((64, 64)) * 3,
        rng.standard_normal((64, 1)) * 3))
    scale = float(np.float32(D ** -0.5))
    ds = p * _fma(dp, scale, -(di * scale))
    ds_unscaled = p * (dp - di)
    assert torch.equal(ds_unscaled * scale, ds)
    k = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    assert torch.equal(_take(ds_unscaled, k, True, False) * scale,
                       _take(ds, k, True, False))


def grid_of(b, seq, h, sms=SMS):
    """d64::grid_of: (128-row tiles a b*h, tiles in full blocks, tiles in
    half blocks): the tiles of a last wave that would fill half the SMs or
    less run as two half blocks each."""
    tiles = math.ceil(seq / BM)
    n = tiles * b * h
    rem = n % sms
    halves = rem if 0 < rem and 2 * rem <= sms else 0
    return tiles, n - halves, halves


def _blocks(tiles, full, halves):
    """d64::Block of every block of the two launches: (b*h, first kept row,
    rows, warpgroup 1's first streamed tile, their step)."""
    for t in range(full):
        yield t // tiles, (t % tiles) * BM, 128, 0, 1
    for i in range(2 * halves):
        t = full + (i >> 1)
        yield t // tiles, (t % tiles) * BM + 64 * (i & 1), 64, 1, 2


@pytest.mark.parametrize("b,seq,h", [(2, 4096, 5), (2, 1024, 10),
                                     (1, 8192, 2), (2, 40, 3), (2, 1000, 3)])
def test_blocks_cover_every_kept_row_once(b, seq, h):
    """The blocks of `grid_of`'s two launches cover each b*h's kept rows
    once: a full block 128 rows (64 a consumer warpgroup, every streamed
    tile to both), a half block 64 (both warpgroups on them, taking the
    streamed tiles in turn, each tile once between them); the full blocks
    are whole waves of one block an SM."""
    tiles, full, halves = grid_of(b, seq, h)
    assert full % SMS == 0 or halves == 0
    nk = math.ceil(seq / BN)
    seen = set()
    for bh, r0, rows, first1, step in _blocks(tiles, full, halves):
        for r in range(r0, r0 + rows):
            assert (bh, r) not in seen
            seen.add((bh, r))
        taken = [*range(0, nk, step), *range(first1, nk, step)]
        each = 2 if step == 1 else 1  # both warpgroups, or one of them
        assert sorted(taken) == sorted(list(range(nk)) * each)
    assert seen == {(bh, r) for bh in range(b * h)
                    for r in range(tiles * BM)}


def test_grid_shared_memory_waves_and_registers():
    """One block of 384 threads an SM: dq 193 KB (two raw K / V stages of
    32 rows, two operand stages of K, V and K^T big and small, and the kept
    Q and dO small planes of 128 rows), dkv 226 KB (the operand stages add
    Q^T and dO^T, and the rows' lse and di): each fits a block's 227 KB
    with its barriers, and a third operand stage would not. 168 registers
    a thread at launch (65536 over 384, to 8); the exchange gives dq's
    consumers 224 and dkv's 232, which the producers' 56 and 40 pay for,
    and a dkv consumer's live values (K's and V's big terms 64, dk and dv
    64, one partial 32, one product's terms 32, dS^T 16) fit its 232 (in
    a half block the partial is 16: two 32-column halves of d, since the
    card's ptxas spilled one register with 32).
    Each kernel has 320 128-row tiles at [2, 4096, 5, 64] and 160 at
    [2, 1024, 10, 64]: 2.42 and 1.21 waves of 132 SMs, whose last waves'
    tiles run as two half blocks each."""
    assert (DQ_SMEM, DKV_SMEM) == (197632, 231424)
    for smem, op in ((DQ_SMEM, DQ_OP), (DKV_SMEM, DKV_OP)):
        assert smem + 64 <= SMEM_PER_BLOCK < smem + op
    assert LAUNCH_REGS == REGS_PER_SM // NT // 8 * 8
    for prod, cons in (DQ_REGS, DKV_REGS):
        assert 128 * prod + 128 * NWG * cons <= NT * LAUNCH_REGS
        assert prod % 8 == 0 and cons % 8 == 0 and cons > LAUNCH_REGS
    assert 64 + 64 + 32 + 32 + 16 < DKV_REGS[1]
    assert 64 + 64 + 16 + 32 + 16 < 64 + 64 + 32 + 32 + 16
    blocks = {seq: math.ceil(seq / BM) * b * h
              for (b, seq, h) in ((2, 4096, 5), (2, 1024, 10))}
    assert blocks == {4096: 320, 1024: 160}
    assert [round(n / SMS, 2) for n in blocks.values()] == [2.42, 1.21]
    # the last waves' 56 and 28 tiles as half blocks: two full waves and
    # 112 half blocks, one full wave and 56 half blocks
    assert grid_of(2, 4096, 5) == (32, 264, 56)
    assert grid_of(2, 1024, 10) == (8, 132, 28)
    assert grid_of(1, 8192, 2) == (64, 128, 0)  # one wave: no halves


def test_probe_variants_apply_to_the_kernels():
    """`rdeic_torch/tools/flash_bwd_probe.py --d 64 --dtype fp32` changes
    the `d64` kernels by text substitutions: each of its variants still
    finds its text in csrc/flash_attn_bwd.cu, changes only that namespace,
    and a text that is not there raises."""
    from rdeic_torch import build
    from rdeic_torch.tools.flash_bwd_probe import VARIANTS, variant_source

    src = build.FLASH_BWD_SRC.read_text()
    head = src[:src.index("namespace d64 {")]
    tail = src[src.index("}  // namespace d64\n"):]
    assert VARIANTS["d64"]
    for name, edits in VARIANTS["d64"].items():
        got = variant_source(src, edits, "d64")
        assert got != src and got.startswith(head) and got.endswith(tail), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], "d64")
