"""The numeric design and the shared-memory layout of the bf16 flash
forward at d = 16 on the bf16 tensor cores (`flash_fwd_d16_bf16` in
`rdeic_torch/csrc/flash_attn_fwd.cu`), on the CPU.

The kernel holds its tiles in shared memory as bf16 (64 q rows, 128 keys a
tile), takes S = Q K^T as one `mma.sync.m16n8k16` per 8 keys (all of d in
one 16-deep step), runs the online softmax in log2 units, and takes P V
with P as one bf16 term into one accumulator for the whole L. Its tile
order is `forward_bf16_tiles` at `TILES[16]` (tests/test_torch_port_flash_
bf16.py), with `mma.sync`'s rounding toward zero modelled (`mma_bf16`);
this file holds it to float64, to the plain version and to the Pallas
kernel in interpret mode on the same bf16 inputs at the card's limit (two
bf16 ulps of max|plain|, `chip_smoke.py` `flash_tol`), reads the rule that
lets P be one term and the accumulator go without per-tile partials, and
counts the banks of the d = 16 swizzle (chunk c of row r at
c ^ ((r >> 2) & 1)) for every copy and ldmatrix read, and the kernel's
grid, shared memory and waves.
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
)

D = 16
BQ, BK, NT = 64, 128, 128  # d16_bf16::BQ, BK, NT
ROW_BYTES = 2 * D
SMEM_BYTES = (BQ + 6 * BK) * ROW_BYTES  # Q, three K and three V buffers
SMS = 132


def test_the_kernel_tiles_are_the_emulated_ones():
    assert TILES[D] == (BQ, BK, 1)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 3), (1, 77, 2), (1, 300, 1)])
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products and P unrounded (float64), the 128-key tiles,
    the log2 units and the masked tail give the plain output and lse: only
    the order of sums differs. L = 77 is shorter than one tile."""
    q, k, v = (x.double() for x in _inputs(b, seq, h, D, seq + h))
    o, lse = forward_bf16_tiles(q, k, v, exact=True)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


# (B, L, H, against Pallas too): a partial last tile with H = 2, the
# serving L = 1536, an L shorter than one tile with B = 2, and the longest
# L that runs in seconds here
READ_SHAPES = [(1, 300, 2, True), (1, 1536, 1, True), (2, 77, 1, True),
               (1, 4096, 1, False)]


@pytest.mark.parametrize("b,seq,h,pallas", READ_SHAPES)
def test_one_bf16_term_of_p_reads_at_most_half_the_limit(b, seq, h, pallas):
    """P as one bf16 term, rounded toward zero in every mma step, reads at
    most half the card's limit (one bf16 ulp of max|plain|) against the
    plain version, float64 and Pallas after the bf16 store; two terms read
    no more; the lse is within 1e-4 of max."""
    q, k, v = _inputs(b, seq, h, D, seq + h)
    reads = {}
    for terms in (1, 2):
        o, lse = forward_bf16_tiles(q, k, v, p_terms=terms)
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
    o, lse = forward_bf16_tiles(q, k, v)
    reads = _reads(o, lse, q, k, v)
    assert reads["fault"] > LIMIT, reads
    shifted = lse + 2 * LSE_TOL * lse.abs().max()
    assert _reads(o, shifted, q, k, v)["lse"] > LSE_TOL


def test_rounding_toward_zero_is_small_beside_the_rounding_of_p():
    """The fp32 kernel at d = 16 sums each tile's P V from zero into a
    partial, because mma.sync rounds toward zero. With P as one bf16 term,
    P's own rounding is what shows on the unrounded output against float64
    (under half an ulp of max), and the accumulator's order moves it by
    less than 1% of an ulp at L = 4096, so the kernel keeps no partials;
    with two terms (hi + lo) the rounding toward zero is what is left, and
    partials would cut it."""
    q, k, v = _inputs(1, 4096, 1, D, 11)
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
def _swizzled_byte(r, c):
    """Byte address of chunk c (8 bf16 values) of row r of a d = 16 tile."""
    return r * ROW_BYTES + ((c ^ ((r >> 2) & 1)) << 4)


def _lane16(lane):
    """flash_bf16.cuh `Lane16`: the byte offsets of the lane's ldmatrix row
    at a corner, for A (and B with .trans) and for B without .trans."""
    sw = (lane >> 2) & 1
    a = (((lane & 7) + ((lane >> 3) & 1) * 8) << 5) + (((lane >> 4) ^ sw) << 4)
    b = (((lane & 7) + (lane >> 4) * 8) << 5) + ((((lane >> 3) & 1) ^ sw) << 4)
    return a, b


def test_lane_offsets_address_the_fragments_in_order():
    """Matrix m of an ldmatrix.x4 is read from the rows of lanes 8m..8m + 7.
    For A (Q) and V (.trans, rows = keys) it must be rows 8 (m & 1).., chunk
    m >> 1 (a0..a3; b0, b1 of d columns 0..7, then of 8..15); for K (rows =
    keys) rows 8 (m >> 1).., chunk m & 1 (b0, b1 of keys 0..7, then of
    8..15). `Lane16` gives those rows at the swizzled chunk, at every corner
    the kernel reads (a multiple of 16 rows)."""
    for lane in range(32):
        m = lane >> 3
        a, b = _lane16(lane)
        for r0 in range(0, BK, 16):
            assert r0 * ROW_BYTES + a == _swizzled_byte(
                r0 + 8 * (m & 1) + (lane & 7), m >> 1)
            assert r0 * ROW_BYTES + b == _swizzled_byte(
                r0 + 8 * (m >> 1) + (lane & 7), m & 1)


def _banks(byte_addrs):
    """The 4-byte banks of 16-byte chunks at these byte addresses."""
    return sorted(banks([a // 4 + w for a in byte_addrs for w in range(4)]))


@pytest.mark.parametrize("rows", [BQ, BK])
def test_copies_and_fragment_reads_hit_32_banks(rows):
    """cp.async writes 16 bytes a lane, a phase of 8 lanes taking 4 rows of
    2 chunks (`load_tile`'s order); every ldmatrix matrix (with or without
    .trans: the same 8 row addresses) is 8 rows at one chunk. With the
    swizzle each hits all 32 banks at every row of a tile; without it an
    ldmatrix matrix would put rows r and r + 4 on the same 4 banks."""
    for i0 in range(0, rows * 2, 8):
        addrs = [_swizzled_byte(i // 2, i % 2) for i in range(i0, i0 + 8)]
        assert _banks(addrs) == list(range(32))
    for r0 in range(0, rows, 8):
        for c in range(2):
            addrs = [_swizzled_byte(r, c) for r in range(r0, r0 + 8)]
            assert _banks(addrs) == list(range(32))
            plain = [r * ROW_BYTES + 16 * c for r in range(r0, r0 + 8)]
            assert max(np.bincount(_banks(plain))) == 2


def test_grid_shared_memory_and_waves():
    """64-row q tiles of 4 warps, Q and three K / V buffers of 128 keys:
    26 KB of static shared memory (no cudaFuncSetAttribute below 48 KB),
    four blocks per SM by shared memory and by registers (at most 128 a
    thread, `__launch_bounds__(128, 4)`). Every d = 16 path shape is one
    wave on 132 SMs: the serving shapes give 384 and 192 blocks, the
    training ones 512 and 256, for 528 slots."""
    assert SMEM_BYTES == 26624 and SMEM_BYTES <= 48 * 1024
    assert 4 * (SMEM_BYTES + 1024) <= 233472
    assert 4 * NT * 128 <= 65536
    blocks = {shape: math.ceil(shape[1] / BQ) * shape[0] * shape[2]
              for shape in ((1, 6144, 4), (1, 1536, 8), (2, 4096, 4),
                            (2, 1024, 8))}
    assert list(blocks.values()) == [384, 192, 512, 256]
    assert max(blocks.values()) <= 4 * SMS
