"""The bf16 flash forward at d = 16 on `wgmma` (`flash_fwd_d16_bf16` in
`rdeic_torch/csrc/flash_attn_fwd.cu`), on the CPU.

A block owns 64 q rows (one consumer warpgroup, Q's A fragment in
registers) and streams 64-key K and V tiles that TMA writes in the 32-byte
swizzle. Per tile S = Q K^T is one `m64n64k16` (all of d in one 16-deep
step, K K-major), the online softmax runs in log2 units, and P V is four
`m64n16k16` with P as one bf16 term from registers and V MN-major, into
one accumulator for the whole L (rescaled by the tile's alpha first). Its
order is `forward_bf16_tiles` at `TILES[16]` (tests/test_torch_port_flash_
bf16.py); this file runs it under the card's `wgmma` rounding
(`wgmma_bf16`) and holds it to float64, to the plain version and to the
Pallas kernel in interpret mode on the same bf16 inputs at the card's limit
(two bf16 ulps of max|plain|, `chip_smoke.py` `flash_tol`), reads again the
rule that lets P be one term and the accumulator go without per-tile
partials in this order, reads the swizzled tiles back as `wgmma` reads them
(K K-major, V MN-major, layout type 3), counts the banks of the 32-byte
swizzle's core matrices, and checks grid, shared memory, registers and
waves.
"""
import math

import numpy as np
import pytest
import torch

from rdeic_torch.ops.flash_attention import (
    flash_attention_lse_plain,
    flash_attention_plain,
)
from tests.test_torch_port_flash_bf16 import (
    LIMIT,
    LSE_TOL,
    P_TERMS,
    TILES,
    _inputs,
    _reads,
    bf16_ulp,
    forward_bf16_tiles,
)
from tests.torch_port_tf32 import (
    banks,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    swizzled,
    wgmma_bf16,
    wgmma_reads,
)

D = 16
BQ, BK, STAGES, NT = 64, 64, 8, 160  # d16_bf16::BQ, BK, STAGES, NT
ROW = 2 * D  # bytes of a tile row
SMEM_BYTES = 2 * STAGES * BK * ROW  # the K ring and the V ring, static
SMS = 132
# the d = 16 shapes of the paths: serving, training (lse), validation,
# batched and tiled serving, and the card's checks
PATH_SHAPES = [(1, 6144, 4), (1, 1536, 8), (2, 4096, 4), (2, 1024, 8),
               (1, 4096, 4), (1, 1024, 8), (2, 6144, 4), (2, 1536, 8),
               (4, 4096, 4), (4, 1024, 8), (15, 4096, 4), (2, 1000, 3),
               (1, 8192, 4)]


def test_the_kernel_tiles_are_the_emulated_ones():
    assert TILES[D] == (BQ, BK, 1)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 77, 2), (1, 300, 1),
                                   (1, 20, 1)])
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products and P unrounded (float64), the 64-key tiles,
    the log2 units and the masked tail give the plain output and lse: only
    the order of sums differs. L = 20 is shorter than one tile."""
    q, k, v = (x.double() for x in _inputs(b, seq, h, D, seq + h))
    o, lse = forward_bf16_tiles(q, k, v, exact=True)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


# (B, L, H, against Pallas too): a partial last tile with H = 2, the
# serving L = 1536, an L under two tiles with B = 2, two keys past two
# tiles, an L inside one tile, and the longest L that runs in seconds here
READ_SHAPES = [(1, 300, 2, True), (1, 1536, 1, True), (2, 77, 1, True),
               (1, 130, 1, True), (1, 20, 2, True), (1, 4096, 1, False)]


@pytest.mark.parametrize("b,seq,h,pallas", READ_SHAPES)
def test_one_bf16_term_of_p_reads_at_most_half_the_limit(b, seq, h, pallas):
    """P as one bf16 term in the kernel's order under `wgmma`'s rounding
    reads at most half the card's limit (one bf16 ulp of max|plain|)
    against the plain version, float64 and Pallas after the bf16 store; two
    terms read no more; the lse is within 1e-4 of max."""
    q, k, v = _inputs(b, seq, h, D, seq + h)
    reads = {}
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms, mm=wgmma_bf16)
        reads[terms] = _reads(o, lse, q, k, v, pallas and terms == P_TERMS)
    one = reads[P_TERMS]
    assert max(one[key] for key in ("plain", "float64", "pallas")
               if key in one) <= LIMIT / 2, reads
    assert reads[2]["plain"] <= one["plain"], reads
    assert one["lse"] <= LSE_TOL, reads


@pytest.mark.parametrize("b,seq,h", [(1, 300, 2), (2, 77, 1)])
def test_a_planted_fault_reads_beyond_the_limit(b, seq, h):
    """The emulated output scaled by 1.05 reads beyond two bf16 ulps of
    max|plain|, and so does its lse shifted by 1e-4 of max: the limits see
    a fault of that size."""
    q, k, v = _inputs(b, seq, h, D, seq + h)
    o, lse = forward_bf16_tiles(q, k, v, mm=wgmma_bf16)
    reads = _reads(o, lse, q, k, v)
    assert reads["fault"] > LIMIT, reads
    shifted = lse + 2 * LSE_TOL * lse.abs().max()
    assert _reads(o, shifted, q, k, v)["lse"] > LSE_TOL


def test_rounding_toward_zero_is_small_beside_the_rounding_of_p():
    """The fp32 kernel at d = 16 sums each tile's P V from zero into a
    partial, because `wgmma` rounds toward zero. With P as one bf16 term,
    P's own rounding is what shows on the unrounded output against float64
    (under half an ulp of max), and the accumulator's order moves it by
    less than 1% of an ulp at L = 4096 in this kernel's order (64-key
    tiles, four 16-key `wgmma` a tile), so the kernel keeps no partials;
    with two terms (hi + lo) the rounding toward zero is what is left, and
    partials would cut it."""
    q, k, v = _inputs(1, 4096, 1, D, 11)
    o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))
    ulp = bf16_ulp(o64.abs().max().item())
    err = {}
    for terms in (1, 2):
        for partials in (False, True):
            o, _ = forward_bf16_tiles(q, k, v, terms, partials, mm=wgmma_bf16)
            err[terms, partials] = (o.double() - o64).abs().max().item() / ulp
    assert err[2, False] > 1.5 * err[2, True], err
    assert abs(err[1, False] - err[1, True]) < 0.01, err
    assert err[1, False] < 0.5 and err[1, False] > 20 * err[2, False], err


# -- the tiles in shared memory ----------------------------------------------
def test_the_32_byte_swizzle_reads_back_as_the_wgmma_operands():
    """TMA writes a 64-key tile of 32-byte rows in the 32-byte swizzle (key
    r's byte b at `swizzled(32 r + b, 32)`). Read as `wgmma` reads layout
    type 3 with 8-row groups 256 bytes apart: K-major (S's B), key r's 16
    values of d in one 16-deep step; MN-major (P V's B, one 16-column atom),
    16 keys a step, 512 bytes apart, each key's row of d."""
    rng = np.random.default_rng(6)
    dense = rng.integers(0, 2 ** 15, size=(BK, D))
    smem = {swizzled(ROW * r + 2 * d, ROW): dense[r, d]
            for r in range(BK) for d in range(D)}
    assert sorted(smem) == list(range(0, BK * ROW, 2))
    for r in range(BK):  # K-major: row = key, bytes along d
        for d in range(D):
            assert smem[wgmma_reads(0, r, 2 * d, row_bytes=ROW)] == dense[r, d]
    for kk in range(BK // 16):  # MN-major: row = key of the step, bytes along d
        for r in range(16):
            for n in range(D):
                at = wgmma_reads(512 * kk, r, 2 * n, row_bytes=ROW)
                assert smem[at] == dense[16 * kk + r, n]


@pytest.mark.parametrize("rows", [BK, 128])
def test_copies_and_fragment_reads_hit_32_banks(rows):
    """What the tensor core reads at once of a tile TMA wrote, a core matrix
    (8 rows of a 16-byte chunk), covers all 32 banks in the 32-byte swizzle,
    at every row of a 64-key tile (the kernel's) or a 128-key one (the
    probe's `bk128_blocks2`); in the dense layout rows r and r + 4 of
    32-byte rows share their 4 banks."""
    for c in range(2):
        for r0 in range(0, rows, 8):
            words = [swizzled(ROW * r + 16 * c, ROW) // 4 + w
                     for r in range(r0, r0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
            dense = [(ROW * r + 16 * c) // 4 + w for r in range(r0, r0 + 8)
                     for w in range(4)]
            assert max(np.bincount(banks(dense))) == 2


def test_grid_shared_memory_and_waves():
    """One block a 64-row q tile, 160 threads (a consumer warpgroup and the
    producer warp): 32 KB of static shared memory (eight stages of a 64-key
    K and V tile; under the 48 KB a launch takes without
    cudaFuncSetAttribute), three blocks an SM by shared memory and by
    registers (at most 136 a thread, `__launch_bounds__(160, 3)`)."""
    assert SMEM_BYTES == 32768 <= 48 * 1024
    assert 3 * (SMEM_BYTES + 1024) <= 233472
    assert 3 * NT * 136 <= 65536


@pytest.mark.parametrize("b,seq,h", PATH_SHAPES)
def test_blocks_and_waves_at_the_path_shapes(b, seq, h):
    """The blocks at the shape: the serving shape [1, 6144, 4, 16] gives
    384 blocks for 396 slots, one wave."""
    blocks = math.ceil(seq / BQ) * b * h
    if (b, seq, h) == (1, 6144, 4):
        assert blocks == 384 <= 3 * SMS
    assert b * h <= 65535
