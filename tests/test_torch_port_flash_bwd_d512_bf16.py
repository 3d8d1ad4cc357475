"""The numeric design and the shared-memory layout of the bf16 flash
backward at d = 512 on the bf16 tensor cores (`flash_dq_d512_bf16` and
`flash_dkv_d512_bf16` in `rdeic_torch/csrc/flash_attn_bwd.cu`), on the CPU.

Both kernels hold their tiles in shared memory as bf16 and take every
product as `mma.sync.m16n8k16` with bf16 operands and fp32 accumulators.
Each score of S = Q K^T and dP = dO V^T (dkv: their transposes, the same
sums) is one warp's 16 x 16 patch over the whole of d: 32 16-deep steps
from zero. P = 2^(S c - lse2) in log2 units, dS = P (dP scale - di scale);
then dq += dS K over the keys, dv += P^T dO and dk += dS^T Q over the q
rows, each in 16-deep steps into one accumulator, P and dS as two bf16
terms (big = x cut to bf16, small = bf16(x - big): `pack_split_trunc`; the
small term's product first at each step). The tiles (dq: 64 kept q rows,
16-key streamed tiles; dkv: 32 kept keys, 32-row q tiles) change no sum:
each accumulator takes its 16-deep steps in key (or q row) order whatever
the tiles, so this file runs the emulation of
`tests/test_torch_port_flash_bwd_d64_bf16.py` (`scores_bf16`,
`accumulate_bf16`, `mma.sync`'s rounding toward zero modelled by
`tests/torch_port_tf32.py` `mma_bf16`) at d = 512 with `big_of =
bf16_truncate`.

It holds dq, dk and dv to float64, to the plain version and to the Pallas
kernels in interpret mode at the card's limit (2^-8 + 1e-4 of max|plain|
after the bf16 store, `chip_smoke.py` `REL_TOL`), reads the rule that
chose two terms of P and of dS and the rule that let one accumulator go
without per-chunk partials (on rows spread over L at L = 4096 and 8192:
each row's sums are its own), and checks the ldmatrix lanes, the banks of
every copy, fragment read and exchange slot, and the grid, shared memory,
waves and L2 -> SM bytes.
"""
import functools
import math

import pytest
import torch

from rdeic_torch.ops.flash_attention import flash_attention_bwd_plain
from tests.test_torch_port_flash_bf16 import (
    _chunk_bytes,
    _lane,
    _swizzled_words,
)
from tests.test_torch_port_flash_bwd_d16_bf16 import _references
from tests.test_torch_port_flash_bwd_d64_bf16 import (
    _inputs,
    _on_rows,
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

D = 512
NT = 256  # d512_bf16:: threads a block (8 warps)
DQ_KEPT, DQ_STREAM, KV_KEPT, KV_STREAM = 64, 16, 32, 32
ROW_BYTES = 2 * D
SLOT = 2 * 32 * 4  # words of a patch's exchange slot
# d512_bf16::kDqSmemBytes: Q, dO, two K / V buffers, four slots, di;
# kDkvSmemBytes: K, V, two Q / dO buffers with lse2 and di scale, 8 slots
DQ_SMEM = 2 * DQ_KEPT * ROW_BYTES + 4 * DQ_STREAM * ROW_BYTES + 4 * SLOT * 4 \
    + DQ_KEPT * 4
DKV_SMEM = 2 * KV_KEPT * ROW_BYTES + 4 * KV_STREAM * ROW_BYTES \
    + 2 * 2 * KV_STREAM * 4 + 8 * SLOT * 4
SMEM_PER_BLOCK, SMS, REGS_PER_SM = 232448, 132, 65536
REL_TOL = 2.0 ** -8 + 1e-4  # the card's limit on dq, dk, dv, of max|plain|
HALF = REL_TOL / 2  # the precision rule's bound on a term choice's reading
FAULT_SCALE = 1.05
P_TERMS = DS_TERMS = 2  # the kernels take P and dS as big + small (the rule)
BIG = bf16_truncate  # pack_split_trunc's big term
# (B, L, H, rows): the refine path's shape and [1, 1024, 1, 512] on 128
# kept rows a side at L = 4096 (each row's sums are its own), L = 1000 with
# B = 2, H = 2, and L = 8192 on 128 rows a side
RULE_SHAPES = [(2, 4096, 1, 128), (1, 1024, 1, None), (2, 1000, 2, None),
               (1, 8192, 1, 128)]


def _inputs512(b, seq, h, seed):
    return _inputs(b, seq, h, seed, d=D)


@pytest.mark.parametrize("b,seq,h", [(2, 100, 2), (1, 10, 2), (1, 130, 1)])
def test_tile_order_follows_the_plain_formulas(b, seq, h):
    """With exact products and P and dS unrounded (float64), the log2
    units and the padded rows give the plain backward at d = 512: only the
    order of sums differs. L = 10 is shorter than one 16-key tile, 130 ends
    two rows past two 64-row q tiles."""
    inputs = [x.double() for x in _inputs512(b, seq, h, seq + h)]
    got = backward_bf16_tiles(*inputs, exact=True)
    for g, want in zip(got, flash_attention_bwd_plain(*inputs)):
        torch.testing.assert_close(g, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("b,seq,h", [(2, 200, 2), (1, 600, 1)])
def test_two_terms_hold_the_limit_against_pallas_and_plain(b, seq, h):
    """P and dS as two bf16 terms (the big one cut), every step rounded
    toward zero: dq, dk and dv within half the limit of float64, the plain
    version and the Pallas kernels before the bf16 store, and within the
    limit of the plain version after it; a planted x1.05 fault reads beyond
    the limit."""
    inputs = _inputs512(b, seq, h, seq + 7 * h)
    got = backward_bf16_tiles(*inputs, big_of=BIG)
    refs = _references(*inputs)
    for name, want in refs.items():
        reads = [rel(g, w) for g, w in zip(got, want)]
        assert max(reads) <= HALF, (name, reads)
    stored = [rel(bf16_round(g), w) for g, w in zip(got, refs["plain"])]
    fault = [rel(bf16_round(g) * FAULT_SCALE, w)
             for g, w in zip(got, refs["plain"])]
    assert max(stored) <= REL_TOL and min(fault) > REL_TOL, (stored, fault)


def _rows(seq, rows_a_side):
    return (None if rows_a_side is None
            else torch.arange(0, seq, seq // rows_a_side)[:rows_a_side])


@functools.lru_cache(maxsize=None)
def _scores(b, seq, h, rows_a_side):
    """The inputs' P and dS as the kernels form them, and the plain
    version's dq, dk, dv on the same rows."""
    inputs = _inputs512(b, seq, h, seq + h)
    rows = _rows(seq, rows_a_side)
    return (scores_bf16(*inputs, rows),
            _on_rows(flash_attention_bwd_plain(*inputs), rows))


@functools.lru_cache(maxsize=None)
def _rule_reads(b, seq, h, rows_a_side):
    """{(p_terms, ds_terms): [dq, dk, dv]}: max |error| over max|plain|
    before the bf16 store, against the plain version on the same values,
    for one term of both and for two."""
    sc, want = _scores(b, seq, h, rows_a_side)
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
    one bf16 term only if it reads at most half the card's limit (2.003e-3
    of max) on dq, dk and dv at the refine shape, [1, 1024, 1, 512], L =
    1000 and L = 8192; otherwise two. One term of dS reads ~2.26e-3 on dq
    ([1, 1024, 1, 512]) and ~2.30e-3 (L = 1000), past half (dk stays at
    ~1.9e-3), and one term of P ~3.05e-3 on dv (L = 1000): so two terms of
    each, as at d = 16 and 64. Two terms read <= ~3.4e-5."""
    reads = {shape: _rule_reads(*shape) for shape in RULE_SHAPES}
    one = [max(r[1, 1][i] for r in reads.values()) for i in range(3)]
    assert one[0] > HALF and one[2] > HALF, (one, reads)  # dS on dq, P on dv
    assert max(max(r[2, 2]) for r in reads.values()) < HALF / 40, reads
    assert (P_TERMS, DS_TERMS) == (2, 2)


def test_rounding_toward_zero_over_l_8192_needs_no_partials():
    """mma.sync rounds each step's sum toward zero: the 32 steps of each
    score over d, and the 2 L / 16 steps of dq, dk and dv into one
    accumulator. At L = 8192, on 128 rows a side, against the same P and dS
    terms summed in float64, that rounding moves the result by ~3e-5 of
    max: under a fortieth of half the limit (5.0e-5), the rule's bound for
    keeping per-chunk partials, so the kernels keep one accumulator; the
    total stays within half the limit."""
    sc, want = _scores(1, 8192, 1, 128)
    got = accumulate_bf16(sc, big_of=BIG)
    exact = accumulate_bf16(sc, exact_sums=True)
    rz = [rel(g, e) for g, e in zip(got, exact)]
    total = [rel(g, w) for g, w in zip(got, want)]
    assert 0 < max(rz) < HALF / 40, rz
    assert max(total) <= HALF, total


# -- the tiles in shared memory ----------------------------------------------
def _patch_rows():
    """The first rows of every 16-row corner the kernels read: kept tiles'
    patches (dq: Q, dO at 16 p; dkv: K, V at 16 (p & 1)) and streamed
    tiles' (dq: K, V at 0; dkv: Q, dO at 16 (p >> 1)), and the 16-deep
    steps of the products (dq: K at 0; dkv: Q, dO at 16 kk)."""
    return sorted({16 * p for p in range(4)} | {0, 16})


def test_ldmatrix_lanes_address_the_fragments_in_order():
    """Every fragment read of the two kernels, at the rows it starts from
    (a multiple of 16, so row & 7 = lane & 7). The score patches read their
    A tile (Q, dO; K, V) at rows + Lane::ar and their B tile without .trans
    (K, V; Q, dO) at rows + Lane::br, step kk of d at byte (kk >> 2) 128 +
    ca[kk & 3] (A) or cb[kk & 3] (B); the products read the streamed tile
    with .trans at rows + Lane::ar, the warp's 64 columns w.. at byte
    128 w + ca[np]. Each must be the swizzle's address of the lane's row
    and chunk: matrix m of an ldmatrix.x4 holds a_m of A, b0 / b1 of
    n-tiles 0, 1 of B."""
    for m in range(4):
        for lane in range(8 * m, 8 * m + 8):
            ar, br, ac, bc = _lane(lane)
            assert (ar // 8, ac) == (m & 1, m >> 1)  # A and B with .trans
            assert (br // 8, bc) == (m >> 1, m & 1)  # B without .trans
    for lane in range(32):
        ar, br, ac, bc = _lane(lane)
        for r0 in _patch_rows():
            for kk in range(D // 16):
                c0 = 8 * (kk >> 2)  # the chunk of 64 columns
                for row, c, which in ((r0 + ar, c0 + 2 * (kk & 3) + ac, "a"),
                                      (r0 + br, c0 + 2 * (kk & 3) + bc, "b")):
                    assert (4 * _swizzled_words(D, row, c) == row * ROW_BYTES
                            + 128 * (kk >> 2) + _chunk_bytes(lane, kk & 3, which))


@pytest.mark.parametrize("rows", [DQ_STREAM, KV_KEPT, DQ_KEPT])
def test_copies_and_fragment_reads_hit_32_banks(rows):
    """`load_tile` with 256 threads writes a tile 16 bytes a lane, a phase
    of 8 lanes on 8 consecutive chunks of one row; every ldmatrix matrix
    (with or without .trans) is 8 rows at one chunk: each hits all 32
    banks at every row of a 16-, 32- and 64-row tile under the swizzle
    (chunk c of row r at c ^ (r & 7))."""
    chunks = D // 8
    for i0 in range(0, rows * chunks, 8):
        words = [_swizzled_words(D, i // chunks, i % chunks) + w
                 for i in range(i0, i0 + 8) for w in range(4)]
        assert sorted(banks(words)) == list(range(32))
    for r0 in range(0, rows, 8):
        for c in range(chunks):
            words = [_swizzled_words(D, r, c) + w
                     for r in range(r0, r0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))


def test_di_pass_and_slots_hit_32_banks():
    """dq's di pass: kParts = 256 / 64 = 4 threads a row, thread (r, part)
    on chunk (4 i + part + 4 (r & 1)) mod 64 of dO and O at step i: the 8
    lanes of a 16-byte phase (two rows) hit 32 banks (with no shift on odd
    rows they would hit 16, two-way); each row's 64 chunks once. The
    exchange slots: lane l reads and writes 16 bytes at word 4 l (+ 128
    for the second half) of its patch's slot, a phase of 8 lanes on 32
    consecutive words. dkv's lse2 / di scale rows: float2 at columns
    16 (p >> 1) + 8 n + 2 t, 4 addresses shared by 8 lanes each."""
    parts = NT // DQ_KEPT
    for tid0 in range(0, NT, 8):
        for i in range(D // 8 // parts):
            words = []
            for tid in range(tid0, tid0 + 8):
                r, part = tid // parts, tid % parts
                c = (parts * i + part + 4 * (r & 1)) % (D // 8)
                words += [_swizzled_words(D, r, c) + w for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
    for r in range(DQ_KEPT):
        part_chunks = sorted((parts * i + part + 4 * (r & 1)) % (D // 8)
                             for part in range(parts)
                             for i in range(D // 8 // parts))
        assert part_chunks == list(range(D // 8))
    for half in range(2):
        for lane0 in range(0, 32, 8):
            words = [half * 128 + 4 * lane + w
                     for lane in range(lane0, lane0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
    for base in (0, KV_STREAM):
        for p in range(4):
            for n in range(2):
                addrs = {base + 16 * (p >> 1) + 8 * n + 2 * (lane & 3)
                         for lane in range(32)}
                hit = {x % 32 for a in addrs for x in (a, a + 1)}
                assert len(addrs) == 4 and len(hit) == 8


def test_grid_shared_memory_waves_and_l2_bytes():
    """One block of 8 warps per SM (`__launch_bounds__(256, 1)`: at most
    255 registers a thread, for the 128 fp32 accumulators: dq 64 rows x 64
    columns, dkv 32 keys x 64 columns of dk and of dv). dq: Q, dO, two
    16-key K / V buffers, four slots and di, 196.3 KB; dkv: K, V, two 32-row
    Q / dO buffers, their rows' terms and eight slots, 200.5 KB; neither
    leaves room for a second block. At [2, 4096, 1, 512] dq runs 128 blocks
    (0.97 waves on 132 SMs) and dkv 256 (1.94). Each kept tile reads the
    whole streamed pair (2 KB a row) once: L / kept rows x L x 2 KB x B H,
    1.07 GB for dq and 2.15 GB for dkv (4.3 GB for the parent's 32-row
    tiles in both), from L2: the tensors are 16 MB."""
    assert DQ_SMEM == 200960 and DKV_SMEM == 205312
    for smem in (DQ_SMEM, DKV_SMEM):
        assert smem <= SMEM_PER_BLOCK < 2 * (smem + 1024)
    assert REGS_PER_SM // NT - 1 == 255
    b, seq, h = 2, 4096, 1
    blocks = {"dq": math.ceil(seq / DQ_KEPT) * b * h,
              "dkv": math.ceil(seq / KV_KEPT) * b * h}
    assert blocks == {"dq": 128, "dkv": 256}
    assert [round(n / SMS, 2) for n in blocks.values()] == [0.97, 1.94]
    l2 = {k: seq // kept * seq * 2 * ROW_BYTES * b * h
          for k, kept in (("dq", DQ_KEPT), ("dkv", KV_KEPT))}
    assert [round(x / 1e9, 2) for x in l2.values()] == [1.07, 2.15]


def test_probe_variants_apply_to_the_kernels():
    """`rdeic_torch/tools/flash_bwd_probe.py --d 512` (the card probes
    PERF.md cites) changes the `d512_bf16` kernels by text substitutions:
    each of its variants still finds its text in csrc/flash_attn_bwd.cu,
    changes only that namespace, and a text that is not there raises."""
    from rdeic_torch import build
    from rdeic_torch.tools.flash_bwd_probe import VARIANTS, variant_source

    src = build.FLASH_BWD_SRC.read_text()
    head = src[:src.index("namespace d512_bf16 {")]
    tail = src[src.index("}  // namespace d512_bf16"):]
    assert {"one_term", "copies_only", "dq_kept32"} <= set(VARIANTS["d512_bf16"])
    for name, edits in VARIANTS["d512_bf16"].items():
        got = variant_source(src, edits, "d512_bf16")
        assert got != src and got.startswith(head) and got.endswith(tail), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], "d512_bf16")
