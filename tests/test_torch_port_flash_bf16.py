"""The numeric design and the shared-memory layout of the bf16 flash
forward (`flash_fwd_d64_bf16` and `flash_fwd_d512_bf16` on `wgmma` in
`rdeic_torch/csrc/flash_attn_fwd.cu`), on the CPU.
(`flash_fwd_d16_bf16` takes the same order, `TILES[16]`, and is held to it
in `tests/test_torch_port_flash_d16_bf16.py`.)

Both kernels hold their tiles in shared memory as bf16 and take every
product in 16-deep steps with bf16 operands and fp32 accumulators:
S = Q K^T in one pass (bf16 products are exact in fp32), the online
softmax in log2 units, and P V with P rounded to bf16. This file emulates
their tile orders (`forward_bf16_tiles`) with each step's sum rounded
toward zero (`tests/torch_port_tf32.py` `mma_bf16`; `wgmma` also cuts each
term to two bits below the largest one's ulp, `wgmma_bf16`, which moves
the d = 64 forward by under 1% of a bf16 ulp: held below), and holds the
result to float64, to the plain version and to the Pallas kernel in
interpret mode on the same bf16 inputs, at the limit the card holds the
kernels to (two bf16 ulps of max|plain|, `chip_smoke.py` `flash_tol`). It
reads P as one bf16 term and as two (hi = bf16(P), lo = bf16(P - hi)),
which decides the kernels' choice, counts the banks of every copy and
fragment read of the swizzled tiles (the chunk order of the 128-byte
swizzle of the TMA tiles), and checks that the 128-byte-swizzled tiles
that TMA writes and `wgmma` reads give back the dense tile. The d = 512
kernel's own tiles, exchange and registers are held in
`tests/test_torch_port_flash_fwd_d512.py`.
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
    bf16_round,
    mma_bf16,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    swizzle128,
    wgmma_bf16,
    wgmma_reads,
)

# per head dim: (q rows a block, keys a tile, d-slices that sum S apart);
# d = 16: a consumer warpgroup of 64 q rows, 64-key TMA tiles; d = 64: two
# consumer warpgroups of 64 q rows, 128-key TMA tiles; d = 512: two
# consumer warpgroups splitting d, 32-key TMA tiles
TILES = {16: (64, 64, 1), 64: (128, 128, 1), 512: (64, 32, 2)}
NEG = -1e30
FAULT_SCALE = 1.05
LIMIT = 2.0  # the card's limit on the output: two bf16 ulps of max|plain|
LSE_TOL = 1e-4  # and on the lse, relative to its max (fp32 in both)
P_TERMS = 1  # the kernels take P as one bf16 term (the rule below)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _pv(p, v, p_terms, acc, mm=mma_bf16):
    """acc + P V in 16-key steps by mm, each rounded toward zero: P as one
    bf16 term (the kernels), or with p_terms = 2 as hi and lo, the lo
    term's step and then the hi term's at each step."""
    hi = bf16_round(p)
    if p_terms == 1:
        return mm(hi, v, acc)
    lo = bf16_round(p - hi)
    # interleave the terms by 16-key step: [lo_0, hi_0, lo_1, hi_1, ...]
    steps = p.shape[-1] // 16
    a = torch.stack([lo.unflatten(-1, (steps, 16)),
                     hi.unflatten(-1, (steps, 16))], -2).flatten(-3)
    vv = v.unflatten(-2, (steps, 16))
    b = torch.stack([vv, vv], -3).flatten(-4, -2)
    return mm(a, b, acc)


def forward_bf16_tiles(q, k, v, p_terms=1, partials=False, exact=False,
                       mm=mma_bf16):
    """(o, lse) in the order of the bf16 kernels at head dim d = 16, 64 or
    512;
    q, k, v hold bf16 values ([B, L, H, D]). The q rows are independent, so
    they are one batch dimension here. Keys stream in tiles of BK (the tail
    zero-filled and its scores masked to -1e30). S = Q K^T: each of the
    d-slices (d = 512: two halves of 256) is summed from zero by 16-deep
    mma steps and the slices join in fp32. Online softmax in log2 units:
    m' = max(m, rowmax S * c) with c = d^-1/2 log2(e), P = 2^(S c - m'),
    l = l 2^(m - m') + rowsum P (fp32, from P unrounded; the kernels keep a
    lane's part of each row sum and add the parts at the end, an order of
    fp32 sums not modelled here). P V: P rounded to
    bf16 (p_terms = 1) or taken as hi + lo (2), into the accumulator
    rescaled by 2^(m - m') (one accumulator for the whole L), or with
    `partials` into a partial from zero that joins O 2^(m - m') in fp32.
    Then O / max(l, 1e-30), which the kernels round to bf16 as they store
    it (returned unrounded here), and lse = m ln 2 + ln l. Every 16-deep
    step by mm (default `mma_bf16`: its exact sum rounded toward zero;
    `wgmma_bf16` also cuts each term as `wgmma` does). With `exact`, every
    step is float64 and P is not rounded."""
    b, seq, h, d = q.shape
    _, bk, slices = TILES[d]
    dt = torch.float64 if exact else torch.float32
    c = d ** -0.5 * math.log2(math.e)
    qh = q.permute(0, 2, 1, 3).to(dt)
    padk = -seq % bk
    kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3).to(dt),
                                      (0, 0, 0, padk)) for x in (k, v))
    # S for 256 keys at a time: the tiles' scores do not depend on the
    # softmax state
    w = d // slices
    s_all = torch.zeros(qh.shape[:-1] + (kh.shape[-2],), dtype=dt)
    for c0 in range(0, kh.shape[-2], 256):
        for j in range(slices):
            a = qh[..., j * w:(j + 1) * w]
            bt = kh[..., c0:c0 + 256, j * w:(j + 1) * w].transpose(-1, -2)
            s_all[..., c0:c0 + 256] += (a @ bt if exact else mm(a, bt))
    m = torch.full(qh.shape[:-1], NEG, dtype=dt)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, seq, bk):
        vt = vh[:, :, k0:k0 + bk]
        s = s_all[..., k0:k0 + bk]
        s = torch.where(k0 + torch.arange(bk) < seq, s,
                        torch.tensor(NEG, dtype=dt))
        m_new = torch.maximum(m, s.amax(-1) * c)
        p = torch.exp2(s * c - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        if exact:
            acc = acc * alpha[..., None] + p @ vt
        elif partials:
            acc = acc * alpha[..., None] + _pv(p, vt, p_terms, 0.0, mm)
        else:
            acc = _pv(p, vt, p_terms, acc * alpha[..., None], mm)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = acc / l[..., None]
    lse = m * math.log(2.0) + torch.log(l)
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, seq)


def _inputs(b, seq, h, d, seed):
    """bf16 q, k, v from normal draws (numpy, from the seed)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, d))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _pallas(q, k, v):
    """The Pallas forward in interpret mode on the same bf16 inputs."""
    o = _flash_forward(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                         for x in (q, k, v)),
                       block_q=128, block_k=128, interpret=True)
    return torch.from_numpy(np.array(o.astype(jnp.float32)))


def _reads(o, lse, q, k, v, pallas=False) -> dict:
    """The emulation's output rounded to bf16 (as the kernels store it)
    against the plain version (bf16: the card's comparison), float64 and,
    with `pallas`, the Pallas kernel, in bf16 ulps of max|plain|; a planted
    x1.05 fault on the output, likewise; and the lse's error over its max
    against float64."""
    o = o.to(torch.bfloat16).float()
    plain = flash_attention_plain(q, k, v).float()
    o64, lse64 = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    ulp = bf16_ulp(plain.abs().max().item())
    out = {"plain": (o - plain).abs().max().item() / ulp,
           "float64": (o.double() - o64).abs().max().item() / ulp,
           "fault": (o * FAULT_SCALE - plain).abs().max().item() / ulp,
           "lse": ((lse.double() - lse64).abs().max()
                   / lse64.abs().max()).item()}
    if pallas:
        out["pallas"] = (o - _pallas(q, k, v)).abs().max().item() / ulp
    return out


def test_tile_order_follows_the_plain_formulas():
    """With exact products and P unrounded (float64), the tiles, the
    d-slices, the log2 units and the masked tail give the plain output and
    lse: only the order of sums differs. L = 200 ends in a partial tile at
    both head dims; L = 40 is shorter than one d = 64 tile."""
    for b, seq, h, d in ((2, 200, 3, 64), (1, 40, 2, 64), (2, 200, 2, 512),
                         (1, 70, 1, 512)):
        q, k, v = (x.double() for x in _inputs(b, seq, h, d, seq + d))
        o, lse = forward_bf16_tiles(q, k, v, exact=True)
        want_o, want_lse = flash_attention_lse_plain(q, k, v)
        torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


# (B, L, H, D, against Pallas too): micro shapes, L = 1000 with B = 2 and
# H = 3, and the longest L at each head dim that runs in seconds here
READ_SHAPES = [(1, 40, 2, 64, True), (2, 200, 3, 64, True),
               (1, 70, 1, 512, True), (2, 200, 2, 512, True),
               (2, 1000, 3, 64, True), (2, 1000, 3, 512, False),
               (1, 4096, 1, 64, False), (1, 2048, 1, 512, False)]


@pytest.mark.parametrize("b,seq,h,d,pallas", READ_SHAPES)
def test_one_bf16_term_of_p_reads_at_most_half_the_limit(b, seq, h, d, pallas):
    """The rule for P's precision: P V takes P as one bf16 term only if that
    reads at most half the card's limit, one bf16 ulp of max|plain|, against
    the plain version, float64 and Pallas; else as two (hi + lo). One term
    reads at most 1.0 at every shape (its unrounded error is ~0.2 ulp), so
    the kernels take one (P_TERMS); two terms read no more. The lse is
    within 1e-4 of max, and a planted x1.05 fault reads beyond the limit."""
    q, k, v = _inputs(b, seq, h, d, seq + d + h)
    reads = {}
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms)
        reads[terms] = _reads(o, lse, q, k, v, pallas and terms == P_TERMS)
    one = reads[P_TERMS]
    assert max(one[key] for key in ("plain", "float64", "pallas")
               if key in one) <= LIMIT / 2, reads
    assert reads[2]["plain"] <= one["plain"], reads
    assert one["lse"] <= LSE_TOL and one["fault"] > LIMIT, reads


def test_rounding_toward_zero_is_small_beside_the_rounding_of_p():
    """mma.sync rounds each step's sum toward zero, and the kernels take
    P V into one accumulator over the whole L (the d = 16 kernels give
    each tile a partial from zero that joins O in fp32). On the unrounded
    fp32 output against float64, in bf16 ulps of max: with two terms of P
    that rounding is what is left, and per-tile partials cut it; with the
    one term the kernels take, P's own rounding (0.2-0.3 ulp, under the half
    ulp that keeps the stored output within one ulp) is what shows, and the
    accumulator's order moves the error by less than 1% of an ulp, so the
    kernels spend no registers on partials."""
    q, k, v = _inputs(1, 2048, 1, 64, 7)
    o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))
    ulp = bf16_ulp(o64.abs().max().item())
    err = {}
    for terms in (1, 2):
        for partials in (False, True):
            o, _ = forward_bf16_tiles(q, k, v, terms, partials)
            err[terms, partials] = (o.double() - o64).abs().max().item() / ulp
    assert err[2, False] > 1.5 * err[2, True], err
    assert abs(err[1, False] - err[1, True]) < 0.01, err
    assert err[1, False] < 0.5 and err[1, False] > 20 * err[2, False], err


# -- the tiles in shared memory ----------------------------------------------
def _lane(lane):
    """flash_bf16.cuh `Lane`: the lane's ldmatrix rows (A and V with .trans;
    K) and its chunk within each 16-column step (A, V; K)."""
    return ((lane & 7) + ((lane >> 3) & 1) * 8, (lane & 7) + (lane >> 4) * 8,
            lane >> 4, (lane >> 3) & 1)


def _chunk_bytes(lane, j, which):
    """`Lane.ca[j]` (which = "a") or `Lane.cb[j]` ("b"): the byte offset,
    in its row, of the lane's chunk of 16-column step j."""
    ac, bc = _lane(lane)[2:]
    return ((2 * j + (ac if which == "a" else bc)) ^ (lane & 7)) << 4


def _swizzled_words(d, r, c):
    """4-byte word address of chunk c (8 bf16 values) of row r of a
    swizzled D-wide tile: chunk c ^ (r & 7) of the row."""
    return r * d // 2 + (c ^ (r & 7)) * 4


def test_ldmatrix_lanes_address_the_fragments_in_order():
    """Matrix m of an ldmatrix.x4 is read from the addresses of lanes
    8m..8m + 7. For A (Q; P at d = 512) it must be rows 8 (m & 1).., columns
    8 (m >> 1).. of the 16 x 16 corner (a0..a3); for K (B without .trans,
    rows = keys) rows 8 (m >> 1).., columns 8 (m & 1).. (b0, b1 of n-tile
    0, then of n-tile 1); for V (B with .trans, rows = keys) as for A. And
    `Lane`'s precomputed offsets are the swizzle's, at every corner (rows a
    multiple of 8, so row & 7 = lane & 7)."""
    for m in range(4):
        for lane in range(8 * m, 8 * m + 8):
            ar, br, ac, bc = _lane(lane)
            assert (ar // 8, ac) == (m & 1, m >> 1)
            assert (br // 8, bc) == (m >> 1, m & 1)
            assert ar % 8 == br % 8 == lane % 8
    for lane in range(32):
        ar, br, ac, bc = _lane(lane)
        for r0 in (0, 16, 48, 112):
            for j in range(4):
                for c0 in (0, 8, 56):  # 64-column blocks of a d = 512 row
                    for row, c, which in ((r0 + ar, 2 * j + ac, "a"),
                                          (r0 + br, 2 * j + bc, "b")):
                        assert (4 * _swizzled_words(512, row, c0 + c)
                                == row * 1024 + c0 * 16
                                + _chunk_bytes(lane, j, which))


@pytest.mark.parametrize("d", [64])
def test_copies_and_fragment_reads_hit_32_banks(d):
    """The swizzle: cp.async writes 16 bytes a lane, a phase of 8 lanes
    taking 8 consecutive chunks of one row; every ldmatrix matrix (with or
    without .trans: the same 8 row addresses) is 8 consecutive rows at one
    chunk. Each hits all 32 banks, at every row and chunk of a tile."""
    rows = TILES[d][0]
    for i0 in range(0, rows * d // 8, 8):
        words = [_swizzled_words(d, i // (d // 8), i % (d // 8)) + w
                 for i in range(i0, i0 + 8) for w in range(4)]
        assert sorted(banks(words)) == list(range(32))
    for r0 in range(0, rows, 8):
        for c in range(d // 8):
            words = [_swizzled_words(d, r, c) + w
                     for r in range(r0, r0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))


def test_grid_shared_memory_and_waves():
    """d = 64: 128-row q tiles, two consumer warpgroups of 64 rows and a
    producer warpgroup (384 threads), Q and a ring of four 128-key K / V
    tiles, 148,480 bytes with the alignment slack; one block per SM, whose
    registers setmaxnreg moves from the producer (24) to the consumers
    (240); the serving shapes give 240 blocks on 132 SMs (1.82 waves) and
    120 (one wave)."""
    smem64 = 1024 + 2 * 64 * 128 + 2 * 4 * 128 * 128
    assert smem64 == 148480 and smem64 <= 232448 < 2 * smem64
    assert 128 * 24 + 2 * 128 * 240 <= 65536
    assert math.ceil(6144 / 128) * 5 == 240 and 132 < 240 <= 2 * 132
    assert math.ceil(1536 / 128) * 10 == 120 <= 132


# -- d = 64 on wgmma ---------------------------------------------------------
def test_wgmma_cut_moves_the_d64_forward_by_under_a_hundredth_of_an_ulp():
    """The rounding model the reads above take for d = 64 (each 16-deep
    step's exact sum rounded toward zero) against the whole `wgmma` model
    (each term also cut two bits below the largest one's ulp): at one and
    at two terms of P, the unrounded outputs differ by under 1% of a bf16
    ulp of max|plain|, and the lse by under 1e-6 of its max."""
    q, k, v = _inputs(2, 300, 2, 64, 11)
    ulp = bf16_ulp(flash_attention_plain(q, k, v).float().abs().max().item())
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms)
        o_w, lse_w = forward_bf16_tiles(q, k, v, p_terms=terms, mm=wgmma_bf16)
        assert (o - o_w).abs().max().item() < 0.01 * ulp
        assert ((lse - lse_w).abs().max() / lse.abs().max()).item() < 1e-6


@pytest.mark.parametrize("b,seq,h", [(1, 384, 2), (2, 130, 3)])
def test_p_terms_under_the_wgmma_order(b, seq, h):
    """P as one bf16 term and as two under the d = 64 kernel's order
    (128-key tiles) with the whole `wgmma` model: one term reads at most
    half the card's limit against the plain version, float64 and Pallas,
    so the kernel keeps one; two terms read no more; the lse is within
    1e-4 of max and a planted x1.05 fault reads beyond the limit."""
    q, k, v = _inputs(b, seq, h, 64, seq + h)
    reads = {}
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms, mm=wgmma_bf16)
        reads[terms] = _reads(o, lse, q, k, v, pallas=terms == P_TERMS)
    one = reads[P_TERMS]
    assert max(one[key] for key in ("plain", "float64", "pallas")) <= LIMIT / 2
    assert reads[2]["plain"] <= one["plain"], reads
    assert one["lse"] <= LSE_TOL and one["fault"] > LIMIT, reads


@pytest.mark.parametrize("elem,rows", [(2, 64), (2, 128), (4, 64)])
def test_swizzled_tiles_reconstruct_the_dense_tile(elem, rows):
    """A tile that TMA writes in the 128-byte swizzle (one 128-byte box row
    per token: 64 bf16, or 32 fp32 of one half of d) holds every byte once,
    and `wgmma` reads the dense tile back from it: K-major (Q, K; bf16
    steps of 32 bytes, fp32 steps of 32 bytes = 8 values) and, for bf16,
    MN-major (V: 16 rows a step, 2048 bytes apart)."""
    n = 128 // elem
    rng = np.random.default_rng(rows + elem)
    dense = rng.integers(0, 2 ** 15, size=(rows, n))
    smem = np.full(rows * 128 // elem, -1)
    for r in range(rows):
        for c in range(n):
            at = swizzle128(r, c * elem)
            assert at % elem == 0
            smem[at // elem] = dense[r, c]
    assert (smem >= 0).all()  # a permutation of the tile's words
    got = np.empty_like(dense)
    for step in range(128 // 32):  # K-major: 32-byte steps along the row
        for r in range(rows):
            for c in range(32 // elem):
                col = step * 32 // elem + c
                got[r, col] = smem[wgmma_reads(32 * step, r, c * elem) // elem]
    np.testing.assert_array_equal(got, dense)
    if elem == 2:  # MN-major: 16 rows (k) a step, 64 n contiguous
        got = np.empty_like(dense)
        for step in range(rows // 16):
            for r in range(16):
                for c in range(n):
                    got[16 * step + r, c] = smem[
                        wgmma_reads(2048 * step, r, 2 * c) // 2]
        np.testing.assert_array_equal(got, dense)
