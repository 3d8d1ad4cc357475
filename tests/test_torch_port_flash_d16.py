"""The fp32 d = 16 flash forward on `wgmma` (`flash_fwd_d16_split` and
`flash_fwd_d16` in `rdeic_torch/csrc/flash_attn_fwd.cu`), on the CPU.

The split kernel writes, once a call, every (b, h, 64-key tile)'s operand
image: K's TF32 big term (rounded to nearest) and small term in the
64-byte swizzle, and V^T's two terms in the 128-byte swizzle with each 8
keys in P's permuted fragment order. The main kernel copies a tile's image
into its ring and runs four consumer warpgroups a 64-row q tile, consumer
c taking the key tiles j with j % 4 = c, each with its own online softmax
(log2 units); per tile S = Q K^T from zero (3xTF32: three `wgmma` an 8-deep
step, small * big, big * small, big * big), P V from zero (in two groups
of four 8-key steps, one chain) into a partial that joins O by one fma;
the consumers merge in order at the end.

This file emulates that order (`forward_d16_tiles`) under the card's
`wgmma` rounding (`tests/torch_port_tf32.py` `wgmma_3xtf32`) and holds it
to float64, to the plain version and to the Pallas kernel in interpret
mode at the card's limits (output 2e-5 absolute, lse 1e-4 of max); shows
that one TF32 pass breaks the limit and that one accumulator over a
consumer's tiles lets the error grow where the per-tile partials keep it
flat; reads the images back as `wgmma` reads them (S's B operand in the
64-byte swizzle, P V's in the 128-byte one, P's accumulator fragment as
the A operand); counts the banks of the 64-byte swizzle's reads and of the
consumers' merge; and checks the grid, shared memory, registers, scratch
and waves at every path shape.
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
from tests.torch_port_tf32 import (
    banks,
    mm_exact,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    split,
    swizzle128,
    swizzled,
    wgmma_3xtf32,
    wgmma_reads,
    wgmma_tf32,
)

D = 16
BQ, BK, NC = 64, 64, 4  # d16::BQ, BK, NC: q rows a block, keys a tile, consumers
STAGES = 8
O_TOL, LSE_TOL = 2e-5, 1e-4  # chip_smoke.py's fp32 limits
FWD16_F64_TOL = 4e-6  # chip_smoke.py's limit on the card's error vs float64
LOG2E = 1.4426950408889634
NEG = -1e30
SMS = 132
IMAGE = 4 * BK * D * 4  # d16::kImage: K big, K small, V^T big, V^T small
SMEM = 1024 + STAGES * IMAGE  # d16::kSmemBytes
NT = 128 * (NC + 1)
# the d = 16 shapes of the paths: serving, training (lse), validation,
# batched and tiled serving
PATH_SHAPES = [(1, 6144, 4), (1, 1536, 8), (2, 4096, 4), (2, 1024, 8),
               (1, 4096, 4), (1, 1024, 8), (2, 6144, 4), (2, 1536, 8),
               (4, 4096, 4), (4, 1024, 8), (3, 4096, 4), (3, 1024, 8),
               (15, 4096, 4), (15, 1024, 8)]


def _fma(acc, alpha, pv):
    """fmaf(acc, alpha, pv) elementwise: the product exact in float64, one
    rounding to fp32."""
    return (acc.double() * alpha.double()[..., None] + pv.double()).float()


def forward_d16_tiles(q, k, v, mm, partials=True, rows=None):
    """(o, lse) in the order of `flash_fwd_d16`, every product by mm. The
    q rows (the first `rows`, or all) and the keys are padded to 64-row
    and 64-key tiles (the key tail zero, its scores masked to -1e30); rows
    are independent, so the q tiles are one batch dimension here. S = mm(Q,
    K^T) from zero. Consumer c takes the tiles j % NC = c: m' = max(m,
    rowmax(S) c), c = d^-1/2 log2(e), P = 2^(S c - m'), alpha = 2^(m - m'),
    l = l alpha + rowsum P; with `partials` (the kernel) each tile's
    P V = mm(P, V) from zero joins O by one fma, O = fma(O, alpha, P V);
    else one accumulator, O = mm(P, V, O alpha), a tensor-core chain over
    the consumer's tiles. The consumers merge in order: m = max(m0, m_c),
    a_0 = 2^(m0 - m), a_c = 2^(m_c - m), l = l0 a_0 + l_c a_c, O likewise;
    then O (1 / max(l, 1e-30)) and lse = m ln 2 + ln max(l, 1e-30). In
    float64 with mm_exact: the plain formulas up to the order of sums."""
    b, seq, h, d = q.shape
    nq = seq if rows is None else rows
    c = d ** -0.5 * LOG2E
    qh = torch.nn.functional.pad(q[:, :nq].permute(0, 2, 1, 3),
                                 (0, 0, 0, -nq % BQ))
    kh, vh = (torch.nn.functional.pad(x.permute(0, 2, 1, 3),
                                      (0, 0, 0, -seq % BK)) for x in (k, v))
    nk = kh.shape[-2] // BK
    s = mm(qh, kh.transpose(-1, -2))
    s = torch.where(torch.arange(nk * BK) < seq, s,
                    torch.tensor(NEG, dtype=q.dtype))
    exact = q.dtype == torch.float64
    state = []
    for cons in range(NC):
        m = torch.full(qh.shape[:-1], NEG, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qh)
        tiles = range(cons, nk, NC)
        ps, alphas = [], []
        for j in tiles:
            st = s[..., BK * j:BK * (j + 1)]
            m_new = torch.maximum(m, st.amax(-1) * c)
            p = torch.exp2(st * c - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            ps.append(p)
            alphas.append(alpha)
            m = m_new
        if partials and ps:  # each tile's P V from zero, all in one call
            vt = torch.stack([vh[:, :, BK * j:BK * (j + 1)] for j in tiles])
            pvs = mm(torch.stack(ps), vt)
            for pv, alpha in zip(pvs, alphas):
                acc = acc * alpha[..., None] + pv if exact else _fma(acc, alpha, pv)
        for j, p, alpha in ([] if partials else zip(tiles, ps, alphas)):
            acc = mm(p, vh[:, :, BK * j:BK * (j + 1)], acc * alpha[..., None])
        state.append((m, l, acc))
    m, l, acc = state[0]
    for m_1, l_1, o_1 in state[1:]:
        mx = torch.maximum(m, m_1)
        a_0, a_1 = torch.exp2(m - mx), torch.exp2(m_1 - mx)
        l = l * a_0 + l_1 * a_1
        acc = acc * a_0[..., None] + o_1 * a_1[..., None]
        m = mx
    lc = torch.clamp(l, min=1e-30)
    o = (acc * (1.0 / lc)[..., None])[:, :, :nq]
    lse = (m * math.log(2.0) + torch.log(lc))[:, :, :nq]
    return o.permute(0, 2, 1, 3), lse.reshape(b * h, nq)


def _inputs(b, seq, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, seq, h, D)).astype(np.float32))
            for _ in range(3)]


def _pallas(q, k, v):
    """The Pallas forward in interpret mode on the same fp32 inputs."""
    o = _flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                       block_q=128, block_k=128, interpret=True)
    return torch.from_numpy(np.array(o))


# -- the order ---------------------------------------------------------------
def test_tile_order_follows_the_plain_formulas():
    """With exact products (float64), the 64-key tiles, the four consumers'
    softmax in log2 units, the masked tail, the per-tile partials and the
    merge in consumer order give the plain output and lse: only the order of
    sums differs. L = 300 ends in a partial fifth tile (consumer 0 takes
    two), L = 100 leaves the third and fourth consumer no tile, L = 20 all
    but the first."""
    for b, seq, h in ((2, 300, 3), (1, 100, 2), (1, 20, 1)):
        q, k, v = (x.double() for x in _inputs(b, seq, h, seq + h))
        o, lse = forward_d16_tiles(q, k, v, mm_exact)
        want_o, want_lse = flash_attention_lse_plain(q, k, v)
        torch.testing.assert_close(o, want_o, atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(lse, want_lse, atol=1e-12, rtol=1e-12)


# (B, L, H): a partial last tile with H = 2, the serving L = 1536, an L
# under two tiles with B = 2, one two keys past two tiles, one inside a tile
READ_SHAPES = [(1, 300, 2), (1, 1536, 1), (2, 77, 1), (1, 130, 1), (1, 20, 2)]


@pytest.mark.parametrize("b,seq,h", READ_SHAPES)
def test_3xtf32_with_rounding_toward_zero_holds_the_fp32_limits(b, seq, h):
    """3xTF32 on `wgmma` in the kernel's order (each instruction's terms cut
    and its sum rounded toward zero, the model of `tests/torch_port_tf32.py`)
    lands within 2e-5 of the plain version, of float64 and of the Pallas
    kernel, and its lse within 1e-4 of max; a planted x1.05 fault does
    not."""
    q, k, v = _inputs(b, seq, h, seq + h)
    o, lse = forward_d16_tiles(q, k, v, wgmma_3xtf32)
    o64, lse64 = flash_attention_lse_plain(*(x.double() for x in (q, k, v)))
    for want in (flash_attention_plain(q, k, v), o64, _pallas(q, k, v)):
        assert (o.double() - want.double()).abs().max().item() <= O_TOL
    assert ((lse.double() - lse64).abs().max()
            / lse64.abs().max()).item() <= LSE_TOL
    assert (o.double() * 1.05 - o64).abs().max().item() > O_TOL


@pytest.mark.parametrize("b,seq,h", READ_SHAPES[:2])
def test_one_tf32_pass_breaks_the_fp32_limit(b, seq, h):
    """One TF32 `wgmma` pass a product, in the same order, misses 2e-5."""
    q, k, v = _inputs(b, seq, h, seq + h)
    o, _ = forward_d16_tiles(q, k, v, wgmma_tf32)
    o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))
    assert (o.double() - o64).abs().max().item() > O_TOL


def test_per_tile_partials_keep_the_error_flat_in_l():
    """`wgmma` rounds its sums toward zero. The per-tile P V partials joined
    by an fma (the kernel) keep the output's error against float64 flat
    from L = 512 to 4096 (64 q rows of each), where one accumulator a
    consumer, rounded toward zero 24 times a tile over its quarter of L,
    drifts: it reads more at 4096 than at 512 and more than the partials
    do. The card's reading at L = 1024 and 8192 is held to chip_smoke.py's
    FWD16_F64_TOL, more than five times the emulation's here."""
    err = {}
    for seq in (512, 4096):
        q, k, v = _inputs(1, seq, 1, 9)
        o64 = flash_attention_plain(*(x.double() for x in (q, k, v)))[:, :BQ]
        for partials in (True, False):
            o, _ = forward_d16_tiles(q, k, v, wgmma_3xtf32, partials, rows=BQ)
            err[seq, partials] = (o.double() - o64).abs().max().item()
    assert err[4096, True] <= 1.5 * err[512, True], err
    assert err[4096, False] > 1.5 * err[512, False], err
    assert err[4096, False] > 2 * err[4096, True], err
    assert 5 * err[512, True] <= FWD16_F64_TOL, err


# -- the images as wgmma reads them -------------------------------------------
def _slot(key: int) -> int:
    """V^T's slot of key `key` of a 32-key atom (within each 8 keys, slot t
    is key 2t and slot t + 4 key 2t + 1)."""
    x = key & 7
    return (key & ~7) + (4 + (x >> 1) if x & 1 else x >> 1)


def split_image(k_tile, v_tile):
    """A tile's image as `flash_fwd_d16_split` writes it, as a dict byte ->
    value of each 4-byte word: thread t takes key t // 4 and d 4 (t % 4)..;
    K's terms at `swizzled(key 64 + 16 c, 64)` (a float4) of planes 0 and 1,
    V^T's at atom key // 32, `swizzle128(d, 4 slot)` of planes 2 and 3."""
    kb, ks = split(k_tile)
    vb, vs = split(v_tile)
    img = {}
    for t in range(256):
        key, c = t >> 2, t & 3
        at = swizzled(key * 64 + 16 * c, 64)
        for e in range(4):
            img[at + 4 * e] = kb[key, 4 * c + e].item()
            img[4096 + at + 4 * e] = ks[key, 4 * c + e].item()
            vat = (key >> 5) * 2048 + swizzle128(4 * c + e, 4 * _slot(key & 31))
            img[8192 + vat] = vb[key, 4 * c + e].item()
            img[12288 + vat] = vs[key, 4 * c + e].item()
    return img, (kb, ks, vb, vs)


def test_images_read_back_as_the_wgmma_operands():
    """Every word of the 16 KB image is written once. S's B operand, read as
    `wgmma` reads a K-major tile of 64-byte rows in the 64-byte swizzle
    (layout type 2, 8-row groups 512 bytes apart, the second 8-deep step 32
    bytes in), gives K's terms [key][d]; P V's B operand, read in the
    128-byte swizzle (V^T: 16 rows of d, an atom of 32 keys each, the 8-key
    step 32 bytes in), gives [slot][d] = V's terms of the slot's key; and P's
    accumulator fragment taken in the order c0, c2, c1, c3 as the A operand
    puts the same key at each slot, so A B = P V exactly."""
    rng = np.random.default_rng(4)
    k_t, v_t = (torch.from_numpy(rng.standard_normal((BK, D)).astype(np.float32))
                for _ in range(2))
    img, (kb, ks, vb, vs) = split_image(k_t, v_t)
    assert sorted(img) == list(range(0, IMAGE, 4))
    for plane, want in ((0, kb), (4096, ks)):
        for kk in range(D // 8):
            for key in range(BK):
                for e in range(8):
                    at = wgmma_reads(plane + 32 * kk, key, 4 * e, row_bytes=64)
                    assert img[at] == want[key, 8 * kk + e].item()
    p = torch.from_numpy(rng.integers(0, 8, size=(BQ, BK)).astype(np.float32))
    for plane, want in ((8192, vb), (12288, vs)):
        b = torch.empty(BK, D)  # [slot][d], as wgmma reads it
        for kk in range(BK // 8):
            start = plane + (kk >> 2) * 2048 + 32 * (kk & 3)
            for sl in range(8):
                for d in range(D):
                    b[8 * kk + sl, d] = img[wgmma_reads(start, d, 4 * sl)]
        for key in range(BK):
            assert torch.equal(b[(key & 32) + _slot(key & 31)], want[key])
        a = torch.empty(BQ, BK)  # [row][slot]: the A fragments, lane (g, t)
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
        assert torch.equal(a.double() @ b.double(), p.double() @ want.double())


def test_fragment_reads_hit_32_banks():
    """A core matrix of the 64-byte swizzle (8 rows of 64 bytes at one
    16-byte chunk, what the tensor core reads of K a k-step) covers all 32
    banks, where the dense layout puts rows r, r + 2, r + 4, r + 6 on the
    same 4; the 128-byte swizzle's (V^T) likewise. The merge's scratch
    (thread i's (m, l, O) in 12 floats at 48 i, float4 stores and loads)
    puts each phase of 8 threads on 32 banks."""
    for c in range(4):
        for r0 in range(0, BK, 8):
            words = [swizzled(r * 64 + 16 * c, 64) // 4 + w
                     for r in range(r0, r0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))
            dense = [(r * 64 + 16 * c) // 4 + w for r in range(r0, r0 + 8)
                     for w in range(4)]
            assert max(np.bincount(banks(dense))) == 4
    for c in range(8):
        words = [swizzle128(r, 16 * c) // 4 + w for r in range(8) for w in range(4)]
        assert sorted(banks(words)) == list(range(32))
    for i0 in range(0, 128, 8):
        for f in range(3):
            words = [12 * i + 4 * f + w for i in range(i0, i0 + 8) for w in range(4)]
            assert sorted(banks(words)) == list(range(32))


# -- grid, shared memory, registers, scratch and waves --------------------------
def test_grid_and_shared_memory():
    """One block a 64-row q tile: 132,096 bytes of shared memory (eight
    16 KB stages), one block an SM, 640 threads (four consumers and the
    producer warpgroup); ptxas launches it at 96 registers a thread and
    setmaxnreg moves the producer's to the consumers (24 against 112),
    within the block's 61,440; the merge's scratch fits the stages. The
    split kernel runs a block of 256 threads an image, a thread a key's 4
    values of d."""
    assert SMEM == 132096 <= 232448 < 2 * SMEM
    launch, producer, consumer = (65536 // NT) & ~7, 24, 112
    assert launch == 96
    assert 128 * producer + 128 * NC * consumer <= NT * launch
    assert (NT * launch - 128 * producer) // (128 * NC) & ~7 == consumer
    assert (NC - 1) * 128 * 12 * 4 <= STAGES * IMAGE
    assert 256 == BK * D // 4


@pytest.mark.parametrize("b,seq,h", PATH_SHAPES)
def test_scratch_and_waves_at_the_path_shapes(b, seq, h):
    """The scratch is every (b, h, 64-key tile)'s 16 KB image (6 MB at
    [1, 6144, 4, 16]); the blocks a q tile and the rounds on 132 SMs."""
    blocks = math.ceil(seq / BQ) * b * h
    images = math.ceil(seq / BK) * b * h
    if (b, seq, h) == (1, 6144, 4):
        assert blocks == 384 and 2 < blocks / SMS < 3
        assert images * IMAGE == 6291456
    assert blocks <= 65535 * 65535 and b * h <= 65535


@pytest.mark.parametrize("namespace", ["d16", "d16_bf16"])
def test_probe_variants_apply_to_the_d16_kernels(namespace):
    """`tools/flash_fwd_probe.py --d 16` changes the d = 16 kernels by text
    substitutions inside their namespaces: each VARIANTS entry matches this
    source and changes it only there; a text that is gone raises."""
    from rdeic_torch import build

    src = build.FLASH_SRC.read_text()
    head = src[:src.index(f"namespace {namespace} {{")]
    for name, edits in VARIANTS[namespace].items():
        got = variant_source(src, edits, namespace)
        assert got != src and got.startswith(head), name
    with pytest.raises(ValueError):
        variant_source(src, [("no such text", "")], namespace)
