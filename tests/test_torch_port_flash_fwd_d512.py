"""The d = 512 flash forward on `wgmma` and TMA (`flash_fwd_d512`, fp32,
and `flash_fwd_d512_bf16` in `rdeic_torch/csrc/flash_attn_fwd.cu`), on the
CPU.

fp32: a cluster of four blocks along d takes a 64-row q tile; block r
holds d 128 r.. of Q, K, V and O. Each block sums its partial scores over
its 128 of d from zero (3xTF32: three `wgmma` an 8-deep step, small * big,
big * small, big * big); the four partials join in rank order,
((p0 + p1) + p2) + p3 (warp w's rows in block w, which sends the sum back),
so every block runs the same softmax (log2 units) and P V over its 128
columns of O, each 32-key tile into a partial from zero that joins O by one
fma. Two consumer warpgroups a block take the even and the odd key tiles,
each with its own softmax state and O, and merge at the end. bf16: one
block a 64-row q tile, two consumer warpgroups each summing the partial
scores over its 256 of d (16-deep `wgmma` steps from zero), p0 + p1 in
both, P as one bf16 term into one accumulator (the order of
`forward_bf16_tiles` at d = 512, `tests/test_torch_port_flash_bf16.py`,
whose d-halves and 32-key tiles are this kernel's), every instruction
under the card's `wgmma` rounding.

This file holds both orders to the plain version, to float64 and to the
Pallas kernel in interpret mode at the card's limits (fp32: O within 2e-5,
lse within 1e-4 of max; bf16: two bf16 ulps of max|plain|, one term of P
only if it reads at most half of that); shows that one TF32 pass breaks
the fp32 limit, that per-tile partials keep the fp32 error flat in L where
one accumulator's grows, and the rule's reading of one against two bf16
terms of P; reads back each plane and box as `wgmma` reads it (the
splitters' K and V^T planes, Q's small term, bf16 V as the 256-wide
MN-major operand over four TMA boxes); counts the banks of the splitters'
copies and of the exchange slots; and checks grid, shared memory,
registers and waves at every path shape.
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
from rdeic_torch.tools.flash_fwd_probe import VARIANTS, variant_source
from rdeic_tpu.ops.flash_attention import _flash_forward
from tests.test_torch_port_flash_bf16 import (
    LIMIT,
    P_TERMS,
    _inputs as bf16_inputs,
    _reads as bf16_reads,
    forward_bf16_tiles,
)
from tests.torch_port_tf32 import (
    banks,
    mm_exact,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    swizzle128,
    wgmma_3xtf32,
    wgmma_bf16,
    wgmma_reads,
    wgmma_tf32,
)

D = 512
CL, DC = 4, 128  # d512: blocks a cluster, d a block
BQ, BK = 64, 32  # q rows a tile, keys a tile (both kernels)
O_TOL, LSE_TOL = 2e-5, 1e-4  # chip_smoke.py's fp32 limits
LOG2E = 1.4426950408889634
SMS = 132
SMEM_LIMIT = 232448  # bytes a block may use
# flash_attn_fwd.cu d512::kSmemBytes and d512_bf16::kSmemBytes
SMEM_FP32 = 1024 + 2 * 4 * 16384 + 2 * 16384 + 4 * 8192 + 4 * 8192
SMEM_BF16 = 1024 + 8 * 8192 + 2 * 2 * 8 * 4096 + 2 * 2 * 8192
CASES = [(2, 200, 2), (1, 130, 1), (1, 1000, 1)]  # B, L, H
# the d = 512 shapes of the paths: serving, refine training (lse),
# validation, batched and tiled serving, the card-against-CPU checks
PATH_SHAPES = [(1, 6144, 1), (2, 4096, 1), (1, 4096, 1), (2, 6144, 1),
               (4, 6144, 1), (4, 4096, 1), (7, 4096, 1), (8, 4096, 1),
               (15, 4096, 1), (1, 1024, 1)]


def fp32_inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D))
                             .astype(np.float32)) for _ in range(3)]


def _fma(acc, alpha, pv):
    """fmaf(acc, alpha, pv) elementwise: the product exact in float64, one
    rounding to fp32."""
    return (acc.double() * alpha.double()[..., None] + pv.double()).float()


def forward_d512_tiles(q, k, v, mm, partials=True, rows=None):
    """(o, lse) in the order of `flash_fwd_d512`, every product by mm. The
    q rows (the first `rows` of them, or all) padded to 64-row tiles and the
    keys to 32-key tiles (the tail zero-filled, its scores masked to -1e30);
    rows are independent, so the tiles are one batch dimension here.
    S = ((p0 + p1) + p2) + p3 in fp32, p_r = mm(Q_r, K_r^T) over block r's
    128 of d from zero. Two consumers take the even and the odd tiles, each
    its own online softmax in log2 units: m' = max(m, rowmax(S) c),
    c = d^-1/2 log2(e), P = 2^(S c - m'), alpha = 2^(m - m'),
    l = l alpha + rowsum P; P V with `partials` (the kernel): each tile's
    product from zero joins O by one fma, O = fma(O, alpha, mm(P, V)); else
    one accumulator, O = mm(P, V, O alpha), as a tensor core chain over the
    consumer's tiles. They merge: m = max(m0, m1), a_i = 2^(m_i - m),
    l = l0 a0 + l1 a1, O = O0 a0 + O1 a1; then O / max(l, 1e-30) and
    lse = m ln 2 + ln l. In float64 with mm_exact: the plain formulas up to
    the order of sums."""
    b, seq, h, d = q.shape
    nq = seq if rows is None else rows
    c = d ** -0.5 * LOG2E
    qh = torch.nn.functional.pad(q[:, :nq].permute(0, 2, 1, 3),
                                 (0, 0, 0, -nq % BQ))
    kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3),
                                      (0, 0, 0, -seq % BK)) for x in (k, v))
    s = None
    for r in range(CL):
        sl = slice(DC * r, DC * (r + 1))
        part = mm(qh[..., sl], kh[..., sl].transpose(-1, -2))
        s = part if s is None else s + part
    neg = torch.tensor(-1e30, dtype=q.dtype)
    cols = torch.arange(BK)
    exact = q.dtype == torch.float64
    state = []
    for consumer in range(2):
        m = torch.full(qh.shape[:-1], -1e30, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qh)
        for k0 in range(BK * consumer, seq, 2 * BK):
            st = torch.where(k0 + cols < seq, s[..., k0:k0 + BK], neg)
            m_new = torch.maximum(m, st.amax(-1) * c)
            p = torch.exp2(st * c - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            vt = vh[:, :, k0:k0 + BK]
            if partials:
                pv = mm(p, vt)
                acc = (acc * alpha[..., None] + pv if exact
                       else _fma(acc, alpha, pv))
            else:
                acc = mm(p, vt, acc * alpha[..., None])
            m = m_new
        state.append((m, l, acc))
    (m0, l0, o0), (m1, l1, o1) = state
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    l = l0 * a0 + l1 * a1
    acc = o0 * a0[..., None] + o1 * a1[..., None]
    lc = torch.clamp(l, min=1e-30)
    o = (acc * (1.0 / lc)[..., None])[:, :, :nq]
    lse = (m * math.log(2.0) + torch.log(lc))[:, :, :nq]
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, nq)


def _pallas(q, k, v):
    """The Pallas forward in interpret mode on the same fp32 inputs."""
    o = _flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                       block_q=128, block_k=128, interpret=True)
    return torch.from_numpy(np.array(o))


# -- fp32: the cluster's order ------------------------------------------------
@pytest.mark.parametrize("b,seq,h", [(2, 200, 2), (1, 130, 1), (1, 20, 1)])
def test_fp32_tile_and_cluster_order_follows_the_plain_formulas(b, seq, h):
    """With exact products (float64), the four blocks' partial scores, the
    32-key tiles, the log2 units, the masked tail, the per-tile partials and
    the two consumers' merge give the plain output and lse: only the order
    of sums differs. L = 20 leaves the odd tiles' consumer none."""
    q, k, v = (x.double() for x in fp32_inputs(b, seq, h, seq + h))
    o, lse = forward_d512_tiles(q, k, v, mm_exact)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", CASES)
def test_fp32_3xtf32_holds_the_limits(b, seq, h):
    """3xTF32 on wgmma in the cluster's order (each instruction's terms cut
    and its sum rounded toward zero, the model of `tests/torch_port_tf32.py`)
    lands within 2e-5 of the plain version, of float64 and of the Pallas
    kernel, and its lse within 1e-4 of max; a planted x1.05 fault does
    not."""
    q, k, v = fp32_inputs(b, seq, h, seq + h)
    o, lse = forward_d512_tiles(q, k, v, wgmma_3xtf32)
    o64, lse64 = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    for want in (flash_attention_plain(q, k, v), o64, _pallas(q, k, v)):
        assert (o.double() - want.double()).abs().max().item() <= O_TOL
    assert ((lse.double() - lse64).abs().max()
            / lse64.abs().max()).item() <= LSE_TOL
    assert (o.double() * 1.05 - o64).abs().max().item() > O_TOL


@pytest.mark.parametrize("b,seq,h", CASES[:2])
def test_fp32_one_tf32_pass_breaks_the_limit(b, seq, h):
    """One TF32 wgmma pass a product, in the same order, misses 2e-5."""
    q, k, v = fp32_inputs(b, seq, h, seq + h)
    o, _ = forward_d512_tiles(q, k, v, wgmma_tf32)
    o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))
    assert (o.double() - o64).abs().max().item() > O_TOL


def test_fp32_per_tile_partials_stay_flat_in_l():
    """wgmma rounds its sums toward zero. Per-tile P V partials joined by an
    fma (the kernel) keep the output's error against float64 flat from
    L = 512 to 4096 (64 q rows of each), where one accumulator a consumer,
    rounded toward zero 12 times a tile over its half of L, drifts: it
    reads more at 4096 than at 512 and more than the partials do."""
    err = {}
    for seq in (512, 4096):
        q, k, v = fp32_inputs(1, seq, 1, 9)
        o64, _ = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
        o64 = o64[:, :BQ]
        for partials in (True, False):
            o, _ = forward_d512_tiles(q, k, v, wgmma_3xtf32, partials,
                                      rows=BQ)
            err[seq, partials] = (o.double() - o64).abs().max().item()
    assert err[4096, True] <= 1.5 * err[512, True], err
    assert err[4096, False] > 1.5 * err[512, False], err
    assert err[4096, False] > 2 * err[4096, True], err
    assert max(err.values()) <= O_TOL, err


# -- bf16: the two warpgroups' order --------------------------------------------
@pytest.mark.parametrize("b,seq,h", CASES)
def test_bf16_one_against_two_terms_of_p(b, seq, h):
    """The rule for P's precision under the d = 512 bf16 kernel's order and
    the whole `wgmma` model: one bf16 term reads at most half the card's
    limit (one bf16 ulp of max|plain|) against the plain version, float64
    and Pallas, so the kernel keeps one; two terms read no more; the lse is
    within 1e-4 of max and a planted x1.05 fault reads beyond the limit."""
    q, k, v = bf16_inputs(b, seq, h, D, seq + h + 1)
    reads = {}
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms, mm=wgmma_bf16)
        reads[terms] = bf16_reads(o, lse, q, k, v, pallas=terms == P_TERMS)
    one = reads[P_TERMS]
    assert max(one[key] for key in ("plain", "float64", "pallas")) <= LIMIT / 2
    assert reads[2]["plain"] <= one["plain"], reads
    assert one["lse"] <= LSE_TOL and one["fault"] > LIMIT, reads


# -- the planes and boxes as wgmma reads them ----------------------------------
def test_fp32_k_planes_and_q_small_read_back_as_k_major_operands():
    """K (and the producer's K big and small, which keep its layout) lands
    as four TMA boxes of 32 keys x 32 fp32 of d, 4096 bytes apart; Q's small
    term as four 64-row atoms, 8192 apart. The B read of S's 8-deep step kk
    (box kk // 4, 32 (kk % 4) bytes in) gives K[key][8 kk..], and the A
    read gives Q[row][8 kk..]."""
    rng = np.random.default_rng(5)
    for rows, box in ((BK, 4096), (BQ, 8192)):
        dense = rng.integers(0, 2 ** 20, size=(rows, DC))
        words = np.full(4 * box // 4, -1)
        for r in range(rows):
            for col in range(DC):
                words[((col >> 5) * box + swizzle128(r, 4 * (col & 31))) // 4] = \
                    dense[r, col]
        assert (words >= 0).all()
        for kk in range(DC // 8):
            start = (kk >> 2) * box + 32 * (kk & 3)
            for r in range(rows):
                for e in range(8):
                    assert words[wgmma_reads(start, r, 4 * e) // 4] == \
                        dense[r, 8 * kk + e]


def _vt_slot(key: int) -> int:
    """The k slot of key `key` of a 32-key tile in V^T (within each 8 keys,
    slot t is key 2t and slot t + 4 key 2t + 1)."""
    x = key & 7
    return (key & ~7) + (4 + (x >> 1) if x & 1 else x >> 1)


def test_fp32_vt_plane_is_v_transposed_in_the_fragment_order():
    """The producer reads the loaded V tile (lane = key, chunk c = d
    4c..4c + 3 of box c // 8) and writes V^T, d rows of 32 slots, (d, slot)
    at `swizzle128(d, 4 slot)`: every word once. `wgmma`'s B read of half hf
    (64 rows from 8192 hf) and step kk (32 kk bytes in) gives
    B[slot][d] = V[key][d] of the slot's key, and P's accumulator fragment
    taken in the order c0, c2, c1, c3 as the A operand puts the same key at
    each slot, so A B = P V exactly."""
    rng = np.random.default_rng(3)
    v = rng.integers(-64, 64, size=(BK, DC))  # [key][d]
    p = rng.integers(0, 8, size=(BQ, BK))  # [q row][key]
    loaded = np.full(4 * 4096 // 4, 10 ** 6)
    for key in range(BK):
        for d in range(DC):
            loaded[((d >> 5) * 4096 + swizzle128(key, 4 * (d & 31))) // 4] = \
                v[key, d]
    vt = np.full(DC * 128 // 4, 10 ** 6)
    for wq in range(4):
        for it in range(DC // 16):
            c = wq + 4 * it
            for lane in range(32):
                at = (c >> 3) * 4096 + swizzle128(lane, 16 * (c & 7))
                for e in range(4):
                    vt[swizzle128(4 * c + e, 4 * _vt_slot(lane)) // 4] = \
                        loaded[at // 4 + e]
    assert (vt != 10 ** 6).all()
    b = np.empty((BK, DC), dtype=np.int64)  # [slot][d], as wgmma reads it
    for hf in range(2):
        for kk in range(BK // 8):
            start = 8192 * hf + 32 * kk
            for s in range(8):
                for d in range(64):
                    b[8 * kk + s, 64 * hf + d] = vt[wgmma_reads(start, d, 4 * s) // 4]
    a = np.empty_like(p)  # [row][slot]: the A fragments, lane (g, t)
    for kk in range(BK // 8):
        for m0 in range(0, BQ, 16):
            for g in range(8):
                for t in range(4):
                    cf = [p[m0 + g, 8 * kk + 2 * t], p[m0 + g, 8 * kk + 2 * t + 1],
                          p[m0 + g + 8, 8 * kk + 2 * t],
                          p[m0 + g + 8, 8 * kk + 2 * t + 1]]
                    a[m0 + g, 8 * kk + t], a[m0 + g + 8, 8 * kk + t] = cf[0], cf[2]
                    a[m0 + g, 8 * kk + t + 4] = cf[1]
                    a[m0 + g + 8, 8 * kk + t + 4] = cf[3]
    for key in range(BK):
        np.testing.assert_array_equal(b[_vt_slot(key)], v[key])
    np.testing.assert_array_equal(a @ b, p @ v)


def test_bf16_v_boxes_read_as_the_256_wide_mn_major_operand():
    """bf16 V lands as eight TMA boxes of 32 keys x 64 values of d, 4096
    bytes apart; a warpgroup's half of d is four of them, and `wgmma` reads
    them as the MN-major B of a 256-wide product: 16 keys a step (2048
    bytes), 64 columns an atom, the descriptor's leading byte offset (4096)
    from one atom to the next. Every (key, column) of the half reads back;
    Q's and K's halves read K-major, four boxes of 64 d each."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 2 ** 15, size=(BK, D))
    smem = {}
    for key in range(BK):
        for d in range(D):
            smem[(d >> 6) * 4096 + swizzle128(key, 2 * (d & 63))] = v[key, d]
    assert len(smem) == BK * D
    for wg in range(2):
        base = 4 * wg * 4096
        for kk in range(BK // 16):
            for r in range(16):
                for n in range(D // 2):
                    at = wgmma_reads(base + 2048 * kk + (n >> 6) * 4096, r,
                                     2 * (n & 63))
                    assert smem[at] == v[16 * kk + r, 256 * wg + n]
        for kk in range(D // 2 // 16):  # K-major: the step's 32 bytes
            start = base + (kk >> 2) * 4096 + 32 * (kk & 3)
            for r in range(BK):
                for e in range(16):
                    at = wgmma_reads(start, r, 2 * e)
                    assert smem[at] == v[r, 256 * wg + 16 * kk + e]


def test_splitter_copies_and_exchange_slots_hit_32_banks():
    """The fp32 splitters' V^T pass: a warp reads one chunk of 32 keys
    (float4, a phase of 8 lanes on 8 rows: 32 banks) and writes one word of
    32 slots of one V^T row (32 banks); their K split reads and writes 16
    bytes a lane, 8 consecutive chunks a phase; the three warps' chunks
    c = warp + 3 i cover the 32 once. The exchange, a warp's 16 rows in a
    2 KB slot (fp32: float4 i of a lane at 512 i + 16 lane) or a
    warpgroup's in 8 KB (bf16: float4 i of thread tc at 2048 i + 16 tc): a
    warp's store or load is 512 contiguous bytes, 32 banks a phase, and
    the floats fill the slot once."""
    for c in range(32):
        for ph in range(4):
            words = [((c >> 3) * 4096 + swizzle128(lane, 16 * (c & 7))) // 4 + w
                     for lane in range(8 * ph, 8 * ph + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
        for e in range(4):
            words = [swizzle128(4 * c + e, 4 * _vt_slot(lane)) // 4
                     for lane in range(32)]
            assert sorted(banks(words)) == list(range(32))
    assert sorted(ws + 3 * i for ws in range(3) for i in range(11)
                  if ws + 3 * i < 32) == list(range(32))
    for i0 in range(0, 4096 // 16, 8):
        words = [4 * i + w for i in range(i0, i0 + 8) for w in range(4)]
        assert sorted(banks(words)) == list(range(32))
    for threads, stride in ((32, 512), (128, 2048)):
        seen = np.zeros(threads * 16, dtype=int)
        for tc in range(threads):
            for i in range(4):
                for w in range(4):
                    seen[(stride * i + 16 * tc) // 4 + w] += 1
                if tc % 8 == 0:
                    words = [(stride * i + 16 * x) // 4 + w
                             for x in range(tc, tc + 8) for w in range(4)]
                    assert sorted(banks(words)) == list(range(32))
        assert (seen == 1).all()


# -- grid, shared memory, registers and waves ---------------------------------
@pytest.mark.parametrize("b,seq,h", PATH_SHAPES)
def test_grid_shared_memory_registers_and_waves(b, seq, h):
    """fp32: a cluster of four blocks a 64-row q tile, 230,400 bytes a
    block (two operand stages of 64 KB, two V tiles as loaded, 16 KB each,
    Q's small term 32 KB, the exchange slots 4 x 8 KB), one block an SM,
    384 threads; setmaxnreg moves the splitters' registers (168 -> 56) to
    the two consumers (168 -> 224), each holding Q big (64), O (64), a
    half's P V partial (32), S (16) and P's two terms (32). bf16: a block a
    64-row tile, 230,400 bytes (Q 64 KB, two stages of K and V, 32 KB each,
    the exchange 2 x 16 KB), one block an SM; setmaxnreg moves the
    producer's registers (168 -> 24) to the consumers (168 -> 240), which
    hold O's half (128) and S (16). The waves at the shape, on 132 SMs (a
    fp32 cluster takes four)."""
    assert SMEM_FP32 == SMEM_BF16 == 230400 <= SMEM_LIMIT < 2 * SMEM_FP32
    assert 128 * (168 - 56) >= 256 * (224 - 168)
    assert 64 + 64 + 32 + 16 + 32 <= 224
    assert 128 * (168 - 24) >= 256 * (240 - 168) and 128 + 16 + 8 <= 240 - 64
    tiles = math.ceil(seq / BQ) * b * h
    fp32_blocks, bf16_blocks = CL * tiles, tiles
    assert fp32_blocks % CL == 0 and fp32_blocks <= 65535 * CL
    waves = {"fp32": fp32_blocks / SMS, "bf16": bf16_blocks / SMS}
    if (b, seq, h) == (1, 6144, 1):
        assert fp32_blocks == 384 and bf16_blocks == 96
        assert 2 < waves["fp32"] < 3 and waves["bf16"] < 1
    if (b, seq, h) == (2, 4096, 1):
        assert fp32_blocks == 512 and bf16_blocks == 128 <= SMS
    assert waves["fp32"] == CL * waves["bf16"]


@pytest.mark.parametrize("namespace", ["d512", "d512_bf16"])
def test_probe_variants_apply_to_the_d512_kernels(namespace):
    """`tools/flash_fwd_probe.py --d 512` changes the d = 512 kernels by
    text substitutions inside their namespaces: each VARIANTS entry matches
    this source and changes it only there; a text that is gone raises."""
    from rdeic_torch import build

    src = build.FLASH_SRC.read_text()
    head = src[:src.index(f"namespace {namespace} {{")]
    for name, edits in VARIANTS[namespace].items():
        got = variant_source(src, edits, namespace)
        assert got != src and got.startswith(head), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], namespace)
