"""The numeric design and the shared-memory layout of the fp32 flash
backward at d = 512 on TF32 wgmma (`flash_dq_d512` and `flash_dkv_d512` in
`rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

A cluster of eight blocks along d takes one 64-row kept tile (q rows in
dq, keys in dkv); block `rank` holds d 64 rank.. of every tensor. Each
block sums its partial S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T, dP^T =
V dO^T) over its 64 of d from zero, three TF32 `wgmma` an 8-deep step
(small * big, big * small, big * big); the eight partials of each entry
are added in rank order, ((p0 + p1) + p2) ... + p7, by the block that
reduces it, which forms its P and dS and sends them back, so every block
holds the same P and dS. The
streamed operands are the raw tiles as TMA lands them (the tensor core
reads an fp32 operand truncated to TF32: the raw value is its own big
term) with small = x - trunc(x); the kept ones and P and dS are split to
nearest (big = TF32 of x, small = x - big). P = 2^(fp32(S c - lse2)) in
log2 units and dS / scale = P (dP - di); each 32-row streamed tile's
dq = dS K, dv = P^T dO and dk = dS^T Q over the block's 64 columns run from
zero into a partial; two consumers take the even and the odd tiles, each
adding its partials in fp32, and the two sums add at the end (even
first); dq and dk are multiplied by the scale last.

This file emulates that arithmetic (`backward_cluster`) with `wgmma`'s
rounding as the card shows it (`tests/torch_port_tf32.py` `wgmma_chain`)
and holds it to float64, to the plain version and to the Pallas kernels in
interpret mode at the card's limit, 1e-4 of max|plain| (`chip_smoke.py`
`REL_TOL`). It reads one TF32 pass against three, the truncated big term
against a rounded one, per-tile partials against one accumulator over L,
the splitters' planes and banks, the exchange's pieces and slots, the
order of the stages' waits (no cycle), and the kernels' grid, cluster
rounds, shared memory and registers.
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
    split,
    swizzle128,
    tf32_truncate,
    wgmma_chain,
    wgmma_reads,
    wgmma_tf32,
)

D = 512
# flash_attn_bwd.cu d512:: blocks a cluster, a block's d, kept rows,
# streamed rows, threads; the producer's four warps split, two on the small
# planes and two on the transposed ones
CL, DC, BM, BN, NT = 8, 64, 64, 32, 384
SATOM, TPLANE, KEPT = BN * 128, 64 * 128, 2 * 64 * 128  # bytes
PLANE = 2 * SATOM
# a score slot (raw tiles and small planes of both streamed tensors) and
# a product slot (transposed planes, big and small: K^T; Q^T and dO^T)
SCORE, DQ_TRANS, DKV_TRANS = 4 * PLANE, 2 * TPLANE, 4 * TPLANE
DQ_SLOTS, DKV_SLOTS, TRANS_SLOTS = 3, 3, 2
# the exchange, one area the consumers take in turns: a block's slot of
# pieces (4 warps x 32 lanes x 16 bytes), CL slots an area; the sums'
# slots: dq 8 bytes a lane (dS), dkv 16 (P, dS)
SLOT, AREA = 2048, CL * 2048
DQ_SUM_AREA, DKV_SUM_AREA = CL * 4 * 32 * 8, CL * 4 * 32 * 16
DQ_SMEM = (1024 + DQ_SLOTS * SCORE + TRANS_SLOTS * DQ_TRANS + 2 * KEPT
           + AREA + DQ_SUM_AREA)
DKV_SMEM = (1024 + DKV_SLOTS * SCORE + TRANS_SLOTS * DKV_TRANS + 2 * KEPT
            + AREA + DKV_SUM_AREA + DKV_SLOTS * 2 * BN * 4)
LAUNCH_REGS = 168
DQ_REGS, DKV_REGS = (56, 224), (56, 224)  # producer, consumer
SMEM_PER_BLOCK, SMS, REGS_PER_SM = 232448, 132, 65536
# clusters of eight the H100 runs at once (cudaOccupancyMaxActiveClusters,
# which chip_smoke.py logs: the card reads 15 for both kernels; 8 x 15 =
# 120 of its 132 SMs, a cluster's blocks sharing a GPC)
CLUSTERS_AT_ONCE = 15
REL_TOL = 1e-4  # the card's limit on dq, dk, dv, of max|plain|
BWD512_F64_TOL = 2e-5  # chip_smoke.py's limit against float64 at L = 8192
FAULT_SCALE = 1.05
LOG2E = math.log2(math.e)
PATH_SHAPES = [(2, 4096, 1), (1, 1024, 1)]


def _inputs(b, seq, h, seed):
    """fp32 q, k, v, dO [B, L, H, D] from normal draws (numpy, from the
    seed), and the float64 forward's o and lse rounded to fp32."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, seq, h, D))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_lse_plain(q.double(), k.double(), v.double())
    return q, k, v, o.float(), lse.float(), do


def split_trunc(x: torch.Tensor):
    """The streamed operands' split: big = x as the tensor core reads it
    (truncated to TF32), small = x - trunc(x) (exact), read truncated."""
    big = tf32_truncate(x)
    return big, tf32_truncate(x.float() - big)


def mm_kernel(a: torch.Tensor, b: torch.Tensor, b_split=split_trunc):
    """a @ b from zero as the kernels take each product: per 8-deep step
    three wgmma, small * big, big * small, big * big; a (the kept operand,
    or P / dS) split to nearest, b (a streamed tile) by `b_split`."""
    (ab, as_), (bb, bs) = split(a), b_split(b)
    n = a.shape[-1] // 8
    a_seq = torch.stack([x.unflatten(-1, (n, 8)) for x in (as_, ab, ab)],
                        -2).flatten(-3)
    b_seq = torch.stack([x.unflatten(-2, (n, 8)) for x in (bb, bs, bb)],
                        -3).flatten(-4, -2)
    return wgmma_chain(0.0, a_seq, b_seq, 8)


def mm_rounded(a, b):
    """mm_kernel with the streamed operand split to nearest too (the big
    term rounded, as the d = 64 kernels' producers make it)."""
    return mm_kernel(a, b, split)


def mm_one_pass(a, b):
    """One TF32 wgmma an 8-deep step: both operands read truncated."""
    return wgmma_tf32(a, b)


def _fma(a, b, c):
    """fmaf: a b + c rounded once to fp32."""
    return (a.double() * b + c.double()).float()


def cluster_scores(a, b, mm, exact=False):
    """a [.., M, D] against b [.., N, D]: each block's partial a_r b_r^T
    over its 64 of d by `mm`, the CL partials added in rank order in fp32
    (float64 and a @ b^T with `exact`)."""
    if exact:
        return a @ b.transpose(-1, -2)
    a_r = torch.stack(a.split(DC, -1))  # [CL, .., M, DC]
    b_r = torch.stack(b.split(DC, -1)).transpose(-1, -2)
    parts = mm(a_r, b_r)
    s = parts[0]
    for r in range(1, CL):
        s = s + parts[r]
    return s


def take(x, y, mm, partials=True, exact=False):
    """x [.., M, Lp] @ y [.., Lp, D] over the streamed rows: each 32-row
    tile's product from zero by `mm`, the even tiles' partials added in
    fp32 in order and the odd tiles' apart (the two consumers), then the
    two added; without `partials` one accumulator, every step into it."""
    if exact:
        return x @ y
    if not partials:
        return mm(x, y)
    t = x.shape[-1] // BN
    parts = mm(x.unflatten(-1, (t, BN)).movedim(-2, -3),
               y.unflatten(-2, (t, BN)))  # [.., T, M, D]
    sums = [torch.zeros_like(parts[..., 0, :, :]) for _ in range(2)]
    for j in range(t):
        sums[j % 2] = sums[j % 2] + parts[..., j, :, :]
    return sums[0] + sums[1]


def backward_cluster(q, k, v, o, lse, do, rows=None, mm=mm_kernel,
                     partials=True, exact=False, mask_padded=False):
    """(dq, dk, dv) of the kernels' arithmetic, [B, L, H, D]; with `rows`,
    dq of those q rows and dk, dv of those keys. L is padded to 64 rows of
    zeros. dq masks keys past L; dkv takes a padded q row as the kernel
    lands it (zero Q, dO, lse and di: P^T = 1, dS^T = 0), or with
    `mask_padded` as P^T = dS^T = 0. `exact`: float64, nothing rounded."""
    b, seq, h, _ = q.shape
    dt = torch.float64 if exact else torch.float32
    scale = D ** -0.5
    if exact:
        c, l2e = scale * LOG2E, LOG2E
    else:
        scale = float(np.float32(scale))
        l2e = float(np.float32(LOG2E))
        c = float(np.float32(np.float32(scale) * np.float32(LOG2E)))
    pad = -seq % BM
    qh, kh, vh, oh, doh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).to(dt), (0, 0, 0, pad))
        for x in (q, k, v, o, do))
    lse2 = torch.nn.functional.pad(
        (lse.to(dt) * l2e).to(dt).reshape(b, h, seq), (0, pad))
    # di: each block's partial over its d, added in rank order
    di = sum((doh[..., DC * r:DC * (r + 1)].double()
              * oh[..., DC * r:DC * (r + 1)].double()).sum(-1).to(dt)
             for r in range(CL))
    lp = seq + pad
    real = torch.arange(lp) < seq
    sel = torch.arange(lp) if rows is None else torch.as_tensor(rows)

    def softmax(s, dp, l2, d_i, keep):
        if exact:
            p = torch.exp2(s * c - l2)
            p = torch.where(keep, p, 0.0)
            return p, p * (dp - d_i)
        p = torch.exp2(_fma(s, c, -l2).double()).float()
        p = torch.where(keep, p, 0.0)
        return p, p * (dp - d_i)

    prod = (lambda x, y: x @ y) if exact else mm
    # dq: the kept q rows `sel` against every key
    s = cluster_scores(qh[..., sel, :], kh, mm, exact)
    dp = cluster_scores(doh[..., sel, :], vh, mm, exact)
    _, ds = softmax(s, dp, lse2[..., sel, None], di[..., sel, None],
                    real[None, :].expand(len(sel), -1))
    dq = take(ds, kh, prod, partials, exact) * scale
    # dkv: the kept keys `sel` against every q row
    st = cluster_scores(kh[..., sel, :], qh, mm, exact)
    dpt = cluster_scores(vh[..., sel, :], doh, mm, exact)
    keep = (real[None, :] if mask_padded else torch.ones(1, lp, dtype=bool))
    pt, dst = softmax(st, dpt, lse2[..., None, :], di[..., None, :],
                      keep.expand(len(sel), -1))
    dv = take(pt, doh, prod, partials, exact)
    dk = take(dst, qh, prod, partials, exact) * scale
    out = []
    for g in (dq, dk, dv):
        if rows is None:
            g = g[..., :seq, :]
        out.append(g.permute(0, 2, 1, 3))
    return tuple(out)


def _on_rows(grads, rows):
    return grads if rows is None else tuple(g[:, rows] for g in grads)


def _spread(seq, n):
    """n rows spread over L, the last among them (a ragged tile's)."""
    return sorted(set(np.linspace(0, seq - 1, n).astype(int).tolist()))


@functools.lru_cache(maxsize=None)
def _references(b, seq, h, n_rows):
    """(inputs, rows, {name: (dq, dk, dv) on the rows}): float64, the
    plain version in fp32 (the card's comparison) and the Pallas kernels
    in interpret mode."""
    inputs = _inputs(b, seq, h, seq + 7 * h)
    rows = None if n_rows is None else _spread(seq, n_rows)
    q, k, v, o, lse, do = inputs
    got = _flash_backward(*(jnp.asarray(x.numpy()) for x in (q, k, v, o)),
                          jnp.asarray(lse.numpy()), jnp.asarray(do.numpy()),
                          block_q=512, block_k=512, interpret=True)
    refs = {"float64": flash_attention_bwd_plain(
                *(x.double() for x in inputs)),
            "plain": flash_attention_bwd_plain(*inputs),
            "pallas": tuple(torch.from_numpy(np.array(g)) for g in got)}
    return inputs, rows, {n: _on_rows(r, rows) for n, r in refs.items()}


# (b, seq, h, rows a side: all when None)
TILE_SHAPES = [(2, 200, 2, None), (1, 130, 1, None), (1, 1000, 1, 96)]


@pytest.mark.parametrize("b,seq,h,n", TILE_SHAPES)
def test_cluster_order_follows_the_plain_formulas(b, seq, h, n):
    """With exact products (float64), the blocks' partials over d, the
    tiles, the log2 units, the masks and the padded rows give the plain
    backward: only the order of sums differs. L = 130 ends two rows into
    its fifth 32-row tile and its third 64-row kept tile."""
    inputs = [x.double() for x in _inputs(b, seq, h, seq + h)]
    rows = None if n is None else _spread(seq, n)
    got = backward_cluster(*inputs, rows=rows, exact=True)
    want = _on_rows(flash_attention_bwd_plain(*inputs), rows)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h,n", TILE_SHAPES)
def test_three_passes_hold_the_limit_against_pallas_and_plain(b, seq, h, n):
    """Three TF32 passes on `wgmma`'s rounding in the kernels' order (the
    cluster's rank-order sum, the consumers' even and odd tiles): dq, dk
    and dv within a tenth of the limit of float64, the plain version and
    the Pallas kernels in interpret mode; a planted x1.05 fault reads
    beyond the limit."""
    inputs, rows, refs = _references(b, seq, h, n)
    got = backward_cluster(*inputs, rows=rows)
    for name, want in refs.items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= REL_TOL / 10, (name, reads)
    fault = [rel(g * FAULT_SCALE, w) for g, w in zip(got, refs["plain"])]
    assert min(fault) > REL_TOL, fault


def test_one_tf32_pass_breaks_the_limit():
    """One TF32 `wgmma` a product (fp32 operands read truncated), in the
    same order, misses 1e-4 of max on every gradient: the kernels take
    three passes."""
    inputs, rows, refs = _references(1, 130, 1, None)
    got = backward_cluster(*inputs, rows=rows, mm=mm_one_pass)
    reads = [rel(g, w) for g, w in zip(got, refs["plain"])]
    assert min(reads) > REL_TOL, reads


@functools.lru_cache(maxsize=None)
def _path_reads(b, seq, h, n_rows):
    """{mm name: [dq, dk, dv] against float64} on n_rows a side."""
    inputs = _inputs(b, seq, h, seq + 3)
    rows = _spread(seq, n_rows)
    want = _on_rows(flash_attention_bwd_plain(
        *(x.double() for x in inputs)), rows)
    return {name: [rel(g, w) for g, w in zip(
        backward_cluster(*inputs, rows=rows, mm=mm), want)]
        for name, mm in (("trunc", mm_kernel), ("round", mm_rounded))}


@pytest.mark.parametrize("b,seq,h", PATH_SHAPES)
def test_truncated_big_term_holds_half_the_limit(b, seq, h):
    """The streamed tiles as TMA lands them are their own big term (the
    tensor core truncates), with small = x - trunc(x): at each path shape
    (32 rows a side) dq, dk and dv read within half the limit of float64,
    and within 2x of the same design with the big term rounded to
    nearest (which a producer would have to write)."""
    reads = _path_reads(b, seq, h, 32)
    assert max(reads["trunc"]) <= REL_TOL / 2, reads
    assert max(reads["trunc"]) <= 2 * max(reads["round"]), reads


@functools.lru_cache(maxsize=None)
def _l_reads(seq, n_rows):
    """{partials: [dq, dk, dv]}: max |error| over max|float64| with
    per-tile partials (True) and with one accumulator (False), at
    (1, seq, 1) on n_rows a side."""
    inputs = _inputs(1, seq, 1, seq + 1)
    rows = _spread(seq, n_rows)
    want = _on_rows(flash_attention_bwd_plain(
        *(x.double() for x in inputs)), rows)
    return {part: [rel(g, w) for g, w in zip(
        backward_cluster(*inputs, rows=rows, partials=part), want)]
        for part in (True, False)}


L_SHAPES = [(1024, 32), (8192, 32)]


def test_per_tile_partials_keep_the_error_flat_in_l():
    """With per-tile partials the fp32 error against float64 does not grow
    from L = 1024 to 8192 (at most 2x, chip_smoke.py's rule) and stays
    under BWD512_F64_TOL, the card's limit there, which is 5x the
    emulation's reading at 8192; one accumulator reads more at 8192."""
    short, long = (_l_reads(*s)[True] for s in L_SHAPES)
    assert max(long) <= 2 * max(short), (short, long)
    assert 5 * max(long) <= BWD512_F64_TOL, long
    one = _l_reads(*L_SHAPES[1])[False]
    assert max(one) > max(long), (one, long)


def test_padded_q_rows_add_exact_zeros():
    """In dkv a q row past L lands as zeros (Q, dO, lse, di), so P^T = 1
    and dS^T = 0 there; under `wgmma`'s cut their products with dO^T = 0
    and Q^T = 0 leave dk and dv bit for bit as the same sums with those
    rows masked. L = 130 pads 62 rows."""
    inputs = _inputs(1, 130, 1, 5)
    rows = list(range(0, 130, 13))
    kernel = backward_cluster(*inputs, rows=rows)
    masked = backward_cluster(*inputs, rows=rows, mask_padded=True)
    for a, b in zip(kernel[1:], masked[1:]):
        assert torch.equal(a, b)


# -- the planes, the exchange and the addresses ------------------------------
def _slot(x: int) -> int:
    """d64::slot_of: the k slot of streamed row x in a transposed plane."""
    e = x & 7
    return (x & ~7) + (4 + (e >> 1) if e & 1 else e >> 1)


def _splitter_chunks(warps):
    """(tid, warp, iteration, lane, chunk c, byte of the chunk in a
    K-major plane, the transposed words it writes) of d512::small_plane
    and trans_planes in a group of `warps` warps: thread tid takes chunks
    c = tid / 32 + warps i of row `lane`."""
    for tid in range(32 * warps):
        lane, ws = tid & 31, tid >> 5
        for it, c in enumerate(range(ws, DC // 4, warps)):
            at = (c >> 3) * SATOM + swizzle128(lane, 16 * (c & 7))
            trans = [swizzle128(4 * c + e, 4 * _slot(lane)) for e in range(4)]
            yield tid, ws, it, lane, c, at, trans


@pytest.mark.parametrize("warps", [1, 2, 3])
def test_splitters_cover_every_value_once(warps):
    """A group of one, two or three splitting warps (the groups the
    kernels and the probe's variants take) covers a loaded BN x 64 tile once:
    chunk c of row `lane` is d 4c..4c + 3 at the raw tile's bytes (TMA's
    two swizzled boxes, d 0-31 and 32-63), where the small plane takes its
    small terms, and at rows d, slot `_slot(lane)` of the transposed
    planes: every byte of each plane once."""
    kmajor, trans = [], []
    for _, _, _, lane, c, at, tr in _splitter_chunks(warps):
        for e in range(4):
            d = 4 * c + e
            assert at + 4 * e == (d >> 5) * SATOM + swizzle128(lane, 4 * (d & 31))
            kmajor.append(at + 4 * e)
            assert tr[e] == swizzle128(d, 4 * _slot(lane))
            trans.append(tr[e])
    assert sorted(kmajor) == list(range(0, PLANE, 4))
    assert sorted(trans) == list(range(0, TPLANE, 4))


@pytest.mark.parametrize("warps", [1, 2, 3])
def test_splitter_reads_and_writes_hit_32_banks(warps):
    """A splitting warp's float4 reads of the raw tile and writes of the
    small plane (8 lanes a 128-byte phase) and its transposed 4-byte
    writes (a warp a phase) each hit 32 distinct banks."""
    phases = {}
    for tid, ws, it, lane, _, at, trans in _splitter_chunks(warps):
        phases.setdefault(("f4", ws, it, lane >> 3), []).extend(
            at // 4 + e for e in range(4))
        for e in range(4):
            phases.setdefault(("t", ws, it, e), []).append(trans[e] // 4)
    for key, words in phases.items():
        assert sorted(banks(words)) == list(range(32)), key


@pytest.mark.parametrize("rows,atom", [(BN, SATOM), (64, 64 * 128)],
                         ids=["streamed", "kept"])
def test_k_major_planes_read_back_as_the_operand(rows, atom):
    """A raw streamed tile (TMA's two boxes: the scores' B big term), its
    small plane (the same layout) and a kept small plane (64 rows, the
    first pass's A) are read by `wgmma` at 8-deep step kk from the
    descriptor at atom kk // 4 + 32 (kk % 4) bytes: row r, value i is
    (r, 8 kk + i) of the block's 64 columns of d."""
    dense = np.random.default_rng(1).integers(0, 2 ** 20, size=(rows, DC))
    smem = np.full(2 * atom // 4, -1)
    for r in range(rows):
        for d in range(DC):
            smem[((d >> 5) * atom + swizzle128(r, 4 * (d & 31))) // 4] = \
                dense[r, d]
    assert (smem >= 0).all()
    got = np.empty_like(dense)
    for kk in range(DC // 8):
        start = (kk >> 2) * atom + 32 * (kk & 3)
        for r in range(rows):
            for i in range(8):
                got[r, 8 * kk + i] = smem[wgmma_reads(start, r, 4 * i) // 4]
    np.testing.assert_array_equal(got, dense)


def test_transposed_planes_and_fragments_give_the_products():
    """The splitters write a streamed tile X (32 rows x the block's 64 of
    d) transposed (d as rows, (d, slot) at `swizzle128(d, 4 slot)`), the
    products' B; `wgmma` reads step kk from 32 kk bytes; the consumers'
    d64::terms take the accumulator of P (64 x 32) as the TF32 A fragment
    of step kk (a[e] = acc[4 kk + (0, 2, 1, 3)[e]]): A B = P X exactly."""
    rng = np.random.default_rng(3)
    x = rng.integers(-64, 64, size=(BN, DC))
    p = rng.integers(0, 8, size=(64, BN))
    words = np.full(TPLANE // 4, 10 ** 6)
    for r in range(BN):
        for d in range(DC):
            words[swizzle128(d, 4 * _slot(r)) // 4] = x[r, d]
    bmat = np.empty((BN, DC), dtype=np.int64)
    for kk in range(BN // 8):
        for s in range(8):
            for d in range(DC):
                bmat[8 * kk + s, d] = words[wgmma_reads(32 * kk, d, 4 * s) // 4]
    a = np.full((64, BN), 10 ** 6, dtype=np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for kk in range(BN // 8):
                for e in range(4):
                    j = 4 * kk + (0, 2, 1, 3)[e]
                    n, i = j // 4, j % 4
                    row, col = 16 * w + g + 8 * (i >> 1), 8 * n + 2 * t + (i & 1)
                    assert row == 16 * w + g + 8 * (e & 1)
                    a[row, 8 * kk + t + 4 * (e >> 1)] = p[row, col]
    np.testing.assert_array_equal(a @ bmat, p @ x)


def _piece(u):
    """d512::exchange's piece u (= 4 hf + n) of a lane: its accumulator
    indices of S and of dP (n-tile n, row half hf: 4 n + 2 hf + e)."""
    i = 4 * (u & 3) + 2 * (u >> 2)
    return [("s", i), ("s", i + 1), ("dp", i), ("dp", i + 1)]


def test_exchange_pieces_cover_the_scores_once():
    """Piece u of every lane of every consumer warp goes to block u, which
    reduces it: a lane's 16 bytes at 512 w + 16 lane of a 2 KB slot. Piece u
    holds the S and dP values of the same two entries (row 16 w + g +
    8 hf, columns 8 n + 2 t + e), so the reducing lane forms their P and dS
    itself. Over the 4 warps, 32 lanes and CL pieces every value of the
    64 x 32 S and dP tiles goes to one block once; each block reduces an
    eighth of every warp's values (the work is even); a slot is each
    warp's 512 bytes whole (32 banks a float4 phase of 8 lanes), and the
    sums' slots (8 bytes a lane in dq, 16 in dkv) likewise."""
    seen = {}
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for u in range(CL):
                entries = set()
                for which, j in _piece(u):
                    n, i = j // 4, j % 4
                    key = (which, 16 * w + g + 8 * (i >> 1),
                           8 * n + 2 * t + (i & 1))
                    assert key not in seen
                    seen[key] = u
                    entries.add(key[1:])
                assert len(entries) == 2  # S and dP of the same two entries
    assert len(seen) == 2 * 64 * BN
    per_block = [sum(1 for v in seen.values() if v == u) for u in range(CL)]
    assert per_block == [2 * 64 * BN // CL] * CL
    for w in range(4):
        words = {(512 * w + 16 * lane) // 4 + e for lane in range(32)
                 for e in range(4)}
        assert words == set(range(128 * w, 128 * w + 128))
        for ph in range(4):
            phase = [(512 * w + 16 * lane) // 4 + e
                     for lane in range(8 * ph, 8 * ph + 8) for e in range(4)]
            assert sorted(banks(phase)) == list(range(32))
        for nbytes in (8, 16):
            sums = [(w * 32 * nbytes + nbytes * lane) // 4 + e
                    for lane in range(32) for e in range(nbytes // 4)]
            assert sorted(sums) == list(range(sums[0], sums[0] + len(sums)))
    assert (DQ_SUM_AREA, DKV_SUM_AREA) == (CL * 1024, CL * 2048)


def test_rank_order_gives_every_block_the_same_bits():
    """The reducer adds the eight partials in rank order and sends that
    sum to every block, so all blocks run the same softmax on the same
    bits; another order gives other bits (which is why the order is
    fixed): fp32 sums of eight partials, in rank order and reversed,
    differ somewhere."""
    rng = np.random.default_rng(9)
    parts = torch.from_numpy(rng.standard_normal((CL, 64, BN)).astype(np.float32))
    fwd = parts[0]
    for r in range(1, CL):
        fwd = fwd + parts[r]
    back = parts[CL - 1]
    for r in range(CL - 2, -1, -1):
        back = back + parts[r]
    assert not torch.equal(fwd, back)


def test_di_slots_cover_the_area_once():
    """dq's partial di: consumer 0's lane t = 0 of row rw (and rw + 8) of
    each block pushes it to slot [rank][row] of every block (4 bytes by
    st.async, CL x 64 x 4 = 2 KB a block, the barrier's expected bytes), in
    consumer 1's sums area, which its exchanges take only after both
    consumers have read di; each thread then adds its rows' CL partials in
    rank order."""
    seen = set()
    for rank in range(CL):
        for w in range(4):
            for g in range(8):
                for half in range(2):
                    at = 4 * (BM * rank + 16 * w + g + 8 * half)
                    assert at not in seen
                    seen.add(at)
    assert seen == set(range(0, CL * BM * 4, 4))
    assert CL * BM * 4 <= DQ_SUM_AREA


def rounds(b, seq, h, at_once=CLUSTERS_AT_ONCE):
    """(clusters, rounds of `at_once`) of a launch: one cluster a 64-row
    kept tile of each b*h."""
    n = math.ceil(seq / BM) * b * h
    return n, math.ceil(n / at_once)


def test_grid_shared_memory_rounds_and_registers():
    """One block of 384 threads an SM: dq 185 KB (a score ring of three
    slots of raw K and V and their small planes, 32 KB each; a product ring
    of two slots of K^T big and small; the kept Q and dO small planes; one
    parts area of 16 KB and one sums area of 8 KB, dS alone), dkv 226 KB
    (three score slots, two product slots of Q^T and dO^T, a sums area of
    16 KB, P and dS, and each score slot's rows' lse and di): each fits a
    block's 227 KB with its barriers; dkv fits no fourth score slot (dq
    does, and the probe's dq_slots4 read no faster). 168 registers a
    thread at launch (65536 over 384, to 8); setmaxnreg gives both
    kernels' consumers 224, paid by the producers' 56. A dq consumer's
    live values: Q's and dO's big terms 64, dq 32, S and dP 32, dS's terms
    32, the partial 32; dkv's, while dv's product runs: K's and V's big
    terms 64, dk and dv 64, dS^T 16 (for dk's product next), P^T's terms
    32, the partial 32. Clusters of eight, 15 at once: [2, 4096, 1, 512]
    128 clusters in 9 rounds, [1, 1024, 1, 512] 16 in 2 (the second of
    one), the card tests' [2, 1000, 2, 512] 64 in 5 and [2, 4097, 2, 512]
    260 in 18."""
    assert (DQ_SMEM, DKV_SMEM) == (189440, 231168)
    for smem in (DQ_SMEM, DKV_SMEM):
        assert smem + 8 * 29 <= SMEM_PER_BLOCK
    assert DKV_SMEM + SCORE > SMEM_PER_BLOCK >= DQ_SMEM + SCORE
    assert LAUNCH_REGS == REGS_PER_SM // NT // 8 * 8
    for prod, cons in (DQ_REGS, DKV_REGS):
        assert 128 * prod + 256 * cons <= NT * LAUNCH_REGS
        assert prod % 8 == 0 and cons % 8 == 0 and cons > LAUNCH_REGS
    assert 64 + 32 + 32 + 32 + 32 < DQ_REGS[1]
    assert 64 + 64 + 16 + 32 + 32 < DKV_REGS[1]
    assert 2 * 128 * (DC // 2) * 4 <= SCORE  # the merge's hand-over
    assert CL * DC == D and CL * CLUSTERS_AT_ONCE <= SMS
    assert rounds(2, 4096, 1) == (128, 9)
    assert rounds(1, 1024, 1) == (16, 2)
    assert rounds(2, 1000, 2) == (64, 5)
    assert rounds(2, 4097, 2) == (260, 18)
    assert rounds(1, 8192, 1) == (128, 9)


def _run_protocol(nk, slots):
    """Steps the barriers' order of one block until every actor is done
    (True) or none can move (False): the first `slots` loads at the start
    (the producer); the small-plane splitters (tile j once loaded); the
    transposed-plane splitters (tile j once loaded and product slot j % 2's
    products of tile j - 2 are done); and two consumers on alternate tiles:
    scores once the small planes are made, the exchange once the other
    consumer's exchange of tile j - 1 is done, then, once the transposed
    planes are made, the load of tile j + slots into the slot (the refill:
    the consumer's own scores and exchange are done with it, and the
    transposed split with its raw tiles) and the products."""
    done = {("L", j) for j in range(min(slots, nk))}
    consumer = {
        kh: [(x, j) for j in range(kh, nk, 2)
             for x in ("S", "X", "R", "P")] for kh in range(2)}
    actors = {
        "small": [("A", j) for j in range(nk)],
        "trans": [("T", j) for j in range(nk)],
        "c0": consumer[0], "c1": consumer[1],
    }

    def ready(step):
        x, j = step
        if x == "A":
            return ("L", j) in done
        if x == "T":
            return ("L", j) in done and (j < TRANS_SLOTS
                                         or ("P", j - TRANS_SLOTS) in done)
        if x == "S":
            return ("A", j) in done
        if x == "X":
            return ("S", j) in done and (j == 0 or ("X", j - 1) in done)
        return ("T", j) in done  # R, P

    moved = True
    while moved:
        moved = False
        for queue in actors.values():
            while queue and ready(queue[0]):
                step = queue.pop(0)
                done.add(step)
                if step[0] == "R" and step[1] + slots < nk:
                    done.add(("L", step[1] + slots))
                moved = True
    return all(not q for q in actors.values())


@pytest.mark.parametrize("slots", [DQ_SLOTS, DKV_SLOTS], ids=["dq", "dkv"])
def test_the_rings_waits_have_no_cycle(slots):
    """Every tile count from 1 to 11 runs to its end: the loads, the two
    splitter groups (small planes, transposed planes), the two consumers,
    their refills of the score slots and their turns at the exchange area
    wait on one another in no cycle."""
    for nk in range(1, 12):
        assert _run_protocol(nk, slots), nk


def test_probe_variants_apply_to_the_kernels():
    """`rdeic_torch/tools/flash_bwd_probe.py --d 512 --dtype fp32` changes
    the `d512` kernels by text substitutions: each of its variants still
    finds its text in csrc/flash_attn_bwd.cu, changes only that namespace,
    and a text that is not there raises."""
    from rdeic_torch import build
    from rdeic_torch.tools.flash_bwd_probe import (NAMESPACES, VARIANTS,
                                                   variant_source)

    assert NAMESPACES[512, "fp32"] == "d512"
    src = build.FLASH_BWD_SRC.read_text()
    head = src[:src.index("namespace d512 {")]
    tail = src[src.index("}  // namespace d512\n"):]
    assert {"no_exchange", "no_split"} <= set(VARIANTS["d512"])
    for name, edits in VARIANTS["d512"].items():
        got = variant_source(src, edits, "d512")
        assert got != src and got.startswith(head) and got.endswith(tail), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], "d512")
