// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces: rdeic_tpu/ops/flash_attention.py `_dq_kernel` and `_dkv_kernel`
// (through `_flash_backward`). Both recompute the score tile from the
// forward's saved logsumexp (flash_attn_fwd.cu writes it), so the [L, L]
// matrix never reaches device memory:
//
//   S = scale * Q K^T,  P = exp(S - lse),  dP = dO V^T,
//   dS = P * (dP - di) * scale,  di = rowsum(dO * O),
//   dq = dS K (dq kernel),  dv = P^T dO,  dk = dS^T Q (dkv kernel).
//
// Padded q rows and k columns are masked out of P, as the TPU kernels do, so
// any L works. The dq kernel also computes di for its rows (from dO and O)
// and writes it out for the dkv kernel, which runs after it.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous [B, L, H, D], fp32 or
// bf16 (outputs in the input type); lse and di are [B*H, L] fp32. Head dims
// 16 and 64 (the denoiser's) and 512 (the VAE decoder's mid-block, which
// only the refine phase differentiates). In every design one block owns a
// (b*h, tile) pair and loops over the other sequence axis itself (the TPU
// kernels' sequential grid axis): dq owns q rows, dkv keys, and neither
// needs atomics, so results are the same from run to run.
//
// d = 16 (the control branch: [2, 4096, 4, 16] and [2, 1024, 8, 16] per
// independent micro-step, twice that per refine micro-step) runs, in fp32,
// flash_dq_d16 and flash_dkv_d16 on the tensor cores, with TF32 mma.sync
// and the 3xTF32 split of flash_mma.cuh, shaped for what d = 16 makes
// cheap (bf16 at d = 16 has kernels of its own, below):
// - 64-row kept tiles, 8 warps: warp w owns rows 16 (w & 3).. of the tile
//   and half w >> 2 of every 128-row streamed tile, in 32-row chunks; the
//   two halves add their accumulators at the end through shared memory, in
//   a fixed order. 64-row tiles give 256 blocks at [2, 1024, 8, 16] and
//   512 at [2, 4096, 4, 16] for 2 x 132 slots (80 / 83 KB, <= 128
//   registers a thread).
// - The kept pair (Q and dO in dq, K and V in dkv) is 2 k-steps x 4 values
//   a lane: read straight from device memory into A fragments and split
//   once into big and small TF32 registers for the whole loop.
// - The streamed pair (K and V, or Q and dO) comes in 128-row raw tiles by
//   cp.async (16 bytes a lane, zero-filled past L), double-buffered; the
//   block then splits each value once into big and small TF32 planes
//   (stride 20 floats), which every warp reads ready-split: as B^T by
//   ldmatrix for the scores, and as B at rows 2t, 2t + 1 for the products
//   with P or dS. Both reads, the split pass's reads and writes and the
//   copies hit 32 distinct banks (tests/test_torch_port_flash_bwd_d16.py
//   counts them). No warp splits a streamed value.
// - Scores as C fragments in registers, as at d = 64: S and dP (S^T and
//   dP^T in dkv); P and dS formed in place and taken as A through the
//   permuted k order; no shared-memory round trip.
// - The softmax weighs as much as the products at d = 16 (18 mma a 16 x 8
//   block in dq, 24 in dkv, against ~7-10 fp32-pipe operations and an
//   exponential a score): log2(e) is folded into the scale, so P is one
//   fmaf and one exp2f, and dS = P fmaf(dP, scale, -di scale). dq masks
//   keys past L in its last chunk only; dkv stages lse2 = +inf past L, so
//   P^T = 0 there with no test.
// - mma.sync rounds its sum toward zero: each chunk's products sum from
//   zero into a partial that is added to the accumulator in fp32, so the
//   fp32 error stays flat in L.
// - di: dq computes it from the kept dO and O (quad shuffles) and writes
//   it; dkv reads lse and di by column from shared memory, copied one q
//   tile ahead with the tile.
// - ptxas -v: dq and dkv 128 registers; no spills. 128 is the limit for
//   two 8-warp blocks per SM; each thread's
//   copy and split addresses are one base plus constants (unit_rc at rows
//   r and r + 64), which keeps them from spilling.
// What it does about the FMA template it replaces: tensor cores in place of
// fp32 FMA; scores, P and dS in registers in place of shared memory; 16-byte
// asynchronous copies in place of element loads through registers; the
// kept pair in registers, split once, and each streamed value split once a
// block rather than once in every warp.
//
// d = 64 (the UNet: [2, 4096, 5, 64] and [2, 1024, 10, 64] per independent
// micro-step, twice that per refine micro-step) runs, in fp32, flash_dq_d64
// and flash_dkv_d64 on Hopper's warpgroup products in TF32, each fp32
// product as three passes (3xTF32), from the pieces of flash_hopper.cuh as
// the fp32 d = 64 forward is (bf16 at d = 64 has kernels of its own,
// below):
// - Blocks: 384 threads, one block an SM (shared memory): a producer
//   warpgroup and two consumer warpgroups, each owning 64 rows of the
//   block's 128 kept rows (q rows in dq, keys in dkv), which take turns
//   issuing a tile's scores (named barriers), so that one's softmax tends
//   to run under the other's products. The streamed pair (K and V in dq; Q
//   and dO in dkv) comes in tiles of 32 rows.
// - Passes: every product is three TF32 wgmma an 8-deep step, small * big,
//   big * small, big * big, the small one first: wgmma rounds each
//   instruction's sum toward zero and cuts each term two bits below the
//   largest one's ulp (tools/wgmma_probe.py on the card), so a small term
//   beside a big one in one instruction would be cut away; one TF32 pass
//   misses the fp32 limit (tests/test_torch_port_flash_bwd_d64_fp32.py).
// - Operands: TF32 wgmma takes K-major operands only. The scores are K-major
//   as the tensors lie (S = Q K^T and dP = dO V^T in dq, S^T = K Q^T and
//   dP^T = V dO^T in dkv, over d); the products with P and dS run over the
//   streamed rows, along which K, Q and dO lie MN-major, so they need K^T
//   (dq += dS K), dO^T (dv += P^T dO) and Q^T (dk += dS^T Q). TMA loads the
//   raw fp32 tiles (two 128-byte-swizzled boxes a 64-wide row, zeros past
//   L) into a ring two tiles ahead; the producer warpgroup splits each
//   loaded tile once (big = TF32 of x to nearest, small = x - big) into its
//   big and small planes in the same layout, and writes the transposed
//   ones, big and small, with d as the rows and the streamed rows along
//   them in the permuted order of an accumulator fragment (within 8 rows,
//   k slot t is row 2t and slot t + 4 row 2t + 1), into a second ring of
//   two stages: P and dS, formed in place in the scores' accumulator
//   registers, are then the register A operand as they stand (a0..a3 = c0,
//   c2, c1, c3), split in registers, as P is in the forward. Every read and
//   write of the split hits 32 banks.
// - The kept pair (Q and dO in dq; K and V in dkv) is split once: each
//   consumer loads its rows' fragments from device memory, keeps the big
//   terms in registers (the A of the second and third pass) and writes the
//   small terms to shared memory in the swizzle (the A of the first pass).
//   dq computes di = rowsum(dO O) from the same loads (a quad a row) and
//   writes it; dkv's streamed lse and di rows ([B*H, L] fp32, whose rows
//   are not 16-byte aligned at every L) come by 4-byte cp.async from the
//   producer's warp 0, joined to the stage's barrier
//   (cp.async.mbarrier.arrive.noinc), and the producer stages lse log2(e)
//   and di beside the operands.
// - Softmax in log2 units: P = 2^(S scale log2(e) - lse log2(e)), and
//   dS / scale = P (dP - di), the scale (1/8: a power of two, so the bits
//   are those of P (dP scale - di scale)) applied to dq and dk at the end;
//   dq masks keys past L in its last tile; in dkv a q row past L lands as
//   zeros, so P^T = 1 and dS^T = 0 there, times dO^T = Q^T = 0: no test.
// - Accuracy: each tile's dq, dv and dk products sum from zero into a
//   partial (wgmma's first step of the tile does not add its C) that joins
//   the running sum by one fp32 add, so wgmma's rounding toward zero stays
//   that of one tile and the fp32 error stays flat in L, as the forward's P
//   V. dkv takes dv's partial and then dk's, one at a time: one partial
//   and one set of terms live (in its half blocks each in two 32-column
//   halves of d, a partial of 16 registers: with 32 they spilled).
// - Grid: one block per (128-row kept tile, b*h), one block an SM: 320 at
//   [2, 4096, 5, 64] and 160 at [2, 1024, 10, 64], 2.42 and 1.21 waves on
//   132 SMs, whose last wave would leave 76 and 104 SMs idle. So where the
//   last wave fills half the SMs or less, its tiles run as two half blocks
//   each (64 kept rows, both consumer warpgroups on them, taking the
//   streamed tiles in turn; warpgroup 1 hands its sums to warpgroup 0
//   through shared memory, which adds them in a fixed order), a second
//   launch of the kernel's half-block instantiation after the full blocks'
//   whole waves: 264 + 2 x 56 and 132 + 2 x 28 blocks. No atomics: two
//   launches give the same bits.
// - Shared memory: dq 193 KB (two raw K / V stages 32 KB; two operand
//   stages of K big and small, V big and small, K^T big and small, 96 KB;
//   the kept small planes 64 KB), dkv 226 KB (raw 32 KB; operands with Q^T
//   and dO^T 128 KB; kept 64 KB; the rows' lse and di 1 KB). Registers:
//   168 a thread at launch (65536 over 384), moved by setmaxnreg to the
//   consumers: dq 56 / 224, dkv 40 / 232 (its consumer holds K's and V's
//   big terms, dk and dv, a partial and one product's terms); another
//   launch count is refused, since setmaxnreg.inc would wait for registers
//   the producer never gave back.
// - Host: each call encodes its two tensor maps (after cudaSetDevice, which
//   binds the context the driver call needs on a thread such as autograd's
//   worker) and launches one or two grids. A call through the Python wrapper
//   takes ~58 us of host (dq and dkv each at [1, 130, 2, 64] back to back,
//   where the card's part is ~15 us; chip_smoke run A), under the kernels'
//   113 and 140 us at [2, 1024, 10, 64], whose back-to-back time there
//   (0.2556 ms) is the device's (0.2530).
// What it does about the mma.sync design it replaces (TF32 m16n8k8, 4
// warps a 64-row block, every warp splitting the same streamed fragments
// again, passes taken into one running accumulator, whose error grew with
// L): wgmma at the full TF32 rate with B read by the tensor cores from
// shared memory, each streamed value split once a block, TMA copies, and
// per-tile partials.
// Probes on the card (rdeic_torch/tools/flash_bwd_probe.py --d 64 --dtype
// fp32, PERF.md §6), the pair at [2, 4096, 5, 64]: 1.42-1.44 ms (the
// mma.sync pair 2.72-2.80 in the same process); every tile in full blocks
// 1.60-1.62 (the tail wave); no turns 1.43-1.46; one TF32 pass a product
// (wrong values) 0.90-0.96, so the two further passes add about their
// time at the TF32 rate, and what stays is the softmax, the waits and the
// splits that no product overlaps; without the producer's split (wrong
// values) 1.32, without the first pass's A from shared memory 1.36,
// ex2.approx for exp2f 1.39-1.42.
//
// bf16 at d = 64 (the bf16 training recipes: the same shapes) runs
// flash_dq_d64_bf16 and flash_dkv_d64_bf16 on Hopper's warpgroup products,
// from the pieces of flash_hopper.cuh, as the d = 64 forward is:
// - Blocks: a consumer warpgroup that keeps 64 rows (q rows in dq, keys in
//   dkv) and a producer warpgroup, one of whose threads issues every TMA
//   load; two blocks an SM: 128 registers a thread at launch, 232 for the
//   consumer and 24 for the producer by setmaxnreg; 89 KB (dq) and 83 KB
//   (dkv) of shared memory. The kept tiles (Q, dO and O in dq; K and V in
//   dkv) and a ring of four stages of the streamed pair (K and V; Q and
//   dO), 64 rows each, come by TMA in the 128-byte swizzle on mbarriers,
//   tokens past L as zeros. dkv's streamed lse and di rows ([B*H, L] fp32,
//   whose rows TMA cannot take at every L: not 16-byte aligned) come by
//   4-byte cp.async from the producer warp's lanes, and the stage's
//   barrier tracks them (cp.async.mbarrier.arrive.noinc). dq computes di
//   in its prologue from the kept dO and O (a quad a row) and writes it.
// - Products: S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T, dP^T = V dO^T)
//   are 64 x 64 wgmma with both operands in shared memory, K-major. P and
//   dS are formed in place in their accumulator registers, in log2 units:
//   P = ex2(fmaf(S, scale log2(e), -lse2)), dS = P fmaf(dP, scale, -di
//   scale); dq masks keys past L in its last tile; in dkv a q row past L
//   lands as zeros, so P^T = 1 and dS^T = 0 there, times dO = Q = 0: no
//   test. Their fragments, packed pairwise to bf16, are the A operand
//   (from registers) of dq += dS K, dv += P^T dO and dk += dS^T Q, whose B
//   (K; dO and Q) is read MN-major from the same tiles.
// - Overlap: each consumer issues the scores of tile j and the products of
//   tile j - 1 together and forms P and dS of tile j while the products
//   run (wgmma groups complete in order). A V stage (dq) is freed after
//   the scores, a K stage (dq) or Q / dO stage (dkv) after the products.
// - P and dS as two bf16 terms (big = bf16(x), small = bf16(x - big),
//   flash_bf16.cuh pack_split), each term's 16-deep step a wgmma of its
//   own, the small one first: within one instruction wgmma cuts each term
//   two bits below the largest one's ulp, which would cut the small
//   term's products away. The rule, read on the CPU emulation under
//   wgmma's rounding (tests/test_torch_port_flash_bwd_d64_bf16.py) before
//   any card run: one term only if it reads at most half the card's limit
//   (2^-8 + 1e-4 of max|plain|) at every training shape and at L = 1000
//   and 8192. One term of P read up to 2.33e-3 of max on dv, one of dS
//   3.19e-3 on dq and 2.40e-3 on dk, past half (2.0e-3); two read
//   <= 2.1e-5 before the bf16 store.
// - wgmma's rounding over L = 8192 into one accumulator moves the result
//   by 2.1e-5 of max (emulation), under a fortieth of half the limit: no
//   per-tile partials. No atomics: two launches give the same bits.
// - Grid: one block per (64-row tile, b*h): 640 at [2, 4096, 5, 64] and
//   320 at [2, 1024, 10, 64], 2.42 and 1.21 waves of 264 slots. ptxas -v:
//   128 registers at launch, no spills.
// Probes on the card (rdeic_torch/tools/flash_bwd_probe.py --d 64,
// PERF.md §6): one block an SM of two consumer warpgroups (128 kept rows,
// NWG = 2) ran 12% slower at [2, 4096, 5, 64] and 26% at [2, 1024, 10,
// 64], where its tail wave runs 28 blocks on 132 SMs; at NWG = 2 a ring
// of two stages ran 1.1-1.3x slower, of eight no faster; Q and dO as
// register A operands of dq's scores were no faster at two blocks an SM
// (dkv's K and V so spill). What holds the pair back is not traced yet;
// its time follows the count of 64 x 64 x 16 products (d = 64 and 64 kept
// rows allow no larger dq, dk or dv product): without the small term's
// products it ran 19% faster at [2, 4096, 5, 64], without the
// exponentials 3%.
//
// bf16 at d = 16 (the bf16 training recipes: the same shapes) runs
// flash_dq_d16_bf16 and flash_dkv_d16_bf16 on mma.sync, at one 16-deep
// step over d:
// - Tiles stay bf16 in shared memory in the d = 16 swizzle of
//   flash_bf16.cuh (chunk c of row r at c ^ ((r >> 2) & 1), Lane16's
//   offsets), copied by cp.async.cg 16 bytes a lane, zero-filled past L, and
//   read by ldmatrix (.trans for the products with P and dS): every copy
//   and fragment read hits 32 banks. No widening pass, no fp32 planes.
//   64-row kept tiles of 4 warps, warp w owning rows 16 w..: the kept pair
//   (Q and dO in dq, K and V in dkv) is one A fragment each, held in
//   registers for the whole loop. The streamed pair (K and V; Q and dO with
//   their rows' lse and di, by 4-byte cp.async.ca) comes in 128-row tiles
//   through a ring of three buffers, one barrier a tile, in four 32-row
//   chunks. dkv's thread i turns its own landed copies of row i's lse and
//   di into lse2 (+inf past L, so P^T = 0 there) and di scale before that
//   barrier.
// - Products: S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T, dP^T = V dO^T)
//   are one m16n8k16 a 16 x 8 block (the template took six TF32 m16n8k8);
//   P and dS are formed in place in the C fragments and packed to bf16x2 as
//   the A fragment of the next 16-deep step over keys (or q rows). The
//   softmax runs in log2 units with ex2.approx.ftz: P = ex2(fmaf(S, scale
//   log2(e), -lse2)), dS = P fmaf(dP, scale, -di scale); dq masks keys
//   past L in its last chunk.
// - P and dS as two bf16 terms. The rule, read on the CPU emulation
//   (tests/test_torch_port_flash_bwd_d16_bf16.py) before any card run: one
//   term only if it reads at most half the card's limit (2^-8 + 1e-4 of
//   max|plain|) at both training shapes and at L = 1000 and 8192. One term
//   of dS read 2.08e-3 of max on dq and 2.13e-3 on dk, one of P 2.24e-3 on
//   dv, each past half (2.003e-3). The split is pack_split_trunc: big = x
//   cut to bf16 by one byte permute, small = bf16(x - big), one conversion
//   a pair (pack_split's two were slower on the card).
// - mma.sync rounds its sums toward zero; over L = 8192 one accumulator
//   moves the result by 2.8e-5 of max (emulation), under a fortieth of half
//   the limit (5.0e-5), so there are no per-chunk partials. No atomics: two
//   launches give the same bits.
// - Grid: one block per (64-row tile, b*h), 512 at [2, 4096, 4, 16] and
//   256 at [2, 1024, 8, 16]. 30 KB (dq) and 31 KB (dkv) of static shared
//   memory and <= 128 registers (ptxas -v: dq 86, dkv 105; no spills):
//   four blocks per SM, 0.97 and 0.48 waves on 132 SMs.
// What holds them back (PERF.md §6 has their times beside SDPA's and the
// probes' readings): the mma.sync stream. Per 16 rows x 16 streamed rows a
// warp issues 8 mma in dq and 12 in dkv (the second terms are 4 of each)
// against 256 exponentials. In probes on the card
// (rdeic_torch/tools/flash_bwd_probe.py) the time followed the mma count:
// one term of P and dS (outside the rule) cut it by about a quarter, while
// leaving out the exponentials, half the blocks per SM, 16- or 64-row
// chunks or separate accumulators for the two terms moved it by about a
// tenth or less. So the MUFU floor (B H L^2 exponentials a kernel) is ~3x
// below them; wgmma, at the full bf16 rate with B from shared memory, is
// the route past it.
//
// bf16 at d = 512 (the VAE decoder's mid-block, [2, 4096, 1, 512] once per
// bf16 refine micro-step) runs flash_dq_d512_bf16 and flash_dkv_d512_bf16,
// built from the pieces of flash_bf16.cuh:
// - Tiles stay bf16 in shared memory, 1 KB rows in flash_bf16.cuh's swizzle
//   (chunk c of row r at c ^ (r & 7)), copied by cp.async.cg 16 bytes a
//   lane, zero-filled past L, and read by ldmatrix (.trans for the products
//   with P and dS): every copy and fragment read hits 32 banks. One block
//   of 8 warps per SM. dq keeps 64 q rows (Q and dO, 128 KB) and streams
//   K and V in 16-key tiles, double-buffered (196.3 KB with the exchange
//   slots); dkv keeps 32 keys (K and V) and streams Q and dO in 32-row
//   tiles with their rows' lse2 and di scale, double-buffered (200.5 KB).
//   The kept heights are set by the L2 -> SM traffic of the streamed pair
//   (2 KB a row): each kept tile reads it once, L / kept rows x L x 2 KB x
//   B H, 1.07 GB for dq and 2.15 GB for dkv at [2, 4096, 1, 512] (the
//   template's 32 rows on both sides: 4.3 GB), and by the register file:
//   dq's 64 x 512 and dkv's 2 x 32 x 512 fp32 accumulators are 128 a
//   thread over 8 warps (64 kept keys would need 256).
// - Scores: each of the four 16 x 16 patches of S = Q K^T in a streamed
//   tile (dkv: S^T = K Q^T) is one warp's (warps 0-3) over the whole of d,
//   32 16-deep m16n8k16 steps from zero, and each of dP = dO V^T (dP^T =
//   V dO^T) one of warps 4-7: no split over d, no partial sums. The dP
//   warp hands fmaf(dP, scale, -di scale) to the S warp of its patch
//   through a 1 KB slot (bar.arrive / bar.sync on a named barrier of the
//   pair, one round trip a tile), which forms P = ex2(fmaf(S, scale
//   log2(e), -lse2)) and dS = P dP' and writes them back as A-fragment
//   terms for every warp. Two block barriers and the pair's a streamed
//   tile (the template: four in dq, five in dkv, a 16-row tile).
// - Products: warp w accumulates columns 64 w.. of d: dq += dS K over all
//   64 q rows, dv += P^T dO and dk += dS^T Q over the 32 keys, the
//   streamed tile read by ldmatrix.trans, the A fragments from the slots
//   (16 bytes a lane). P and dS as two bf16 terms (pack_split_trunc). The
//   rule, read on the CPU emulation (tests/test_torch_port_flash_bwd_
//   d512_bf16.py) before any card run: one term of dS read 2.26e-3 of max
//   on dq ([1, 1024, 1, 512]) and 2.30e-3 (L = 1000), one of P 3.05e-3 on
//   dv, past half the limit (2.003e-3). mma.sync's rounding toward zero
//   over L = 8192 reads 3.1e-5 (under a fortieth of half the limit,
//   5.0e-5): one accumulator, no per-chunk partials. No atomics: two
//   launches give the same bits.
// - Work: 10 B H L^2 D flops for the pair (dq 6, dkv 8, 1.72e11 at
//   [2, 4096, 1, 512], 0.174 ms at the bf16 peak); with two terms of P and
//   dS the kernels issue 8 and 12 B H L^2 D. ptxas -v: dq 207 registers,
//   dkv 233; no spills. Grid at [2, 4096, 1, 512]: dq 128 blocks (0.97
//   waves), dkv 256 (1.94).
// What holds them back (PERF.md §6; rdeic_torch/tools/flash_bwd_probe.py
// --d 512 on the card): the warps' own instruction stream, as at d = 16.
// The score patches issue one ldmatrix.x4 (512 bytes) a mma, 256 KB a
// streamed 16 (dq) or 32 (dkv) rows a block; the products 16 mma a
// ldmatrix. In probes at [2, 4096, 1, 512], leaving out the products took
// 30% off the pair, leaving out the scores as well 64% (what stays, 0.46
// ms, is the copies, the exchanges and the barriers: were it the copies
// alone, 5.3 TB/s from L2 in dq and 8.2 in dkv), leaving out the copies
// past the first tile 11% (they mostly hide), one term of P and dS 11%; 32
// kept q rows in dq (twice the K and V bytes) added 12% to dq. A trial dq
// that issued the previous tile's products in one stream with a tile's
// scores (a third K buffer) was no faster than one that took them in
// turn, so the phases' costs add up whatever the order: wgmma (B read
// from shared memory by the tensor cores, no ldmatrix) and fewer
// instructions a product are the route past them.
//
// d = 512 in fp32 (the VAE decoder's mid-block: [2, 4096, 1, 512] once per
// fp32 refine micro-step, [1, 1024, 1, 512] in the 256x256 refine
// reference) runs flash_dq_d512 and flash_dkv_d512 on TF32 wgmma fed by
// TMA, each fp32 product as three passes, built from the d = 64 fp32
// backward's pieces (d64::) and the d = 512 forward's cluster exchange.
// (bf16 at d = 512 has kernels of its own, above.) The arithmetic that
// sets the design:
// - Accumulators: wgmma takes 64 rows, and dq of a 64-row kept tile is
//   64 x 512 fp32, 256 registers a thread of one warpgroup; dk + dv twice
//   that. Kept operands: Q and dO (dq), K and V (dkv) are 128 KB a tensor
//   at 64 x 512 fp32, and 3xTF32 needs two terms of each: 512 KB against
//   the 227 KB a block may use. So d is split over a cluster of CL = 8
//   blocks, block `rank` owning d 64 rank..: its slice is the d = 64
//   kernels' tile (Q's and dO's big terms 64 registers, dq 32, small
//   terms 32 KB). A cluster of four (128 of d a block) leaves no room for
//   two stages of streamed tiles and the exchange in shared memory.
// - Exchange: each block sums its partial S and dP over its 64 of d, and
//   the eight partials are added in rank order, ((p0 + p1) + p2) ... + p7,
//   by the block that reduces each entry. Every lane's piece u (the S and
//   dP of two entries) goes to block u by st.async (a reduce-scatter in
//   which each block's every warp reduces an eighth of every warp's
//   values), which forms P and dS of its entries once and sends them back
//   (an all-gather: dS alone in dq, P and dS in dkv), so every block holds
//   the same P and dS. Bytes a kernel: B H L^2 x 16 x (CL - 1) in dkv,
//   3.8 GB at [2, 4096, 1, 512] (dq three quarters of it), against 2.1 GB
//   of streamed tiles from L2.
// - Operands: TF32 wgmma reads K-major operands only. The scores take the
//   streamed tiles as TMA lands them (K and V in dq, Q and dO in dkv, d
//   contiguous): wgmma reads an fp32 operand truncated to TF32
//   (tools/wgmma_probe.py), so the raw tile is its own big term and the
//   splitters write only its small term, x - trunc(x) (within half the
//   limit at every path shape in the CPU emulation,
//   tests/test_torch_port_flash_bwd_d512_fp32.py). dq = dS K, dv = P^T dO
//   and dk = dS^T Q reduce over the streamed rows, so their B is K^T, dO^T
//   and Q^T: the splitters write them big and small, d as the rows and the
//   streamed rows along them in P's fragment order (d64::slot_of), and P
//   and dS, in the accumulator registers, are their A as they stand.
// - Rings: tile j's raw tiles and small planes sit in score slot j % 3 (32
//   KB a slot), its transposed planes in product slot j % 2; the
//   producer's four warps split in two groups at their own pace (two on
//   the small planes, two on the transposed ones), and the consumer of
//   tile j refills its score slot with tile j + 3 once it and the
//   transposed split are done with it. The two consumers take alternate
//   tiles and turns at one exchange area (named barriers).
// - Accuracy: every product three wgmma an 8-deep step, small * big, big *
//   small, big * big (one TF32 pass misses the 1e-4 limit); each tile's
//   dq, dv and dk products sum from zero into a partial that joins the
//   consumer's sum by one fp32 add (its error flat in L against float64:
//   2.4e-6 of max at L = 8192 in the emulation, 7.2e-5 with one
//   accumulator); the two consumers' sums add at the end, the even tiles'
//   first. No atomics: two launches give the same bits.
// - Waves: one block an SM (185 KB dq, 226 KB dkv; setmaxnreg gives the
//   consumers 224 registers, the producer 56); 15 clusters of eight run at
//   once (a cluster's blocks share a GPC): [2, 4096, 1, 512] 128 clusters
//   in 9 rounds, [1, 1024, 1, 512] 16 in 2.
// Probes on the card (rdeic_torch/tools/flash_bwd_probe.py --d 512 --dtype
// fp32, PERF.md §6, device ms of the pair at [2, 4096, 1, 512], the H100 at
// 700 W; the mma.sync parent 4.72-4.77 in the same processes), design by
// design: each warp's 8-row unit reduced by one warp of one block, S and
// dP gathered, 6.50 (the exchange ~2.0 of it); every warp reducing pieces
// of every warp, P and dS formed once, 5.16 (the exchange ~0.2); the small
// and transposed planes by separate splitter groups, 4.71; two rings and
// turns at one exchange area, 4.69 (with no split at all, wrong values,
// 3.39: the split held it back); four splitting warps and the consumers
// refilling the score slots, 4.40; two of them on dkv's small planes,
// 3.87-3.89 (one, 4.34; three score slots, not two, 0.8 less; a fourth in
// dq, none). With no exchange it reads 3.60, no products 3.25, no split
// 3.56-3.59: what is left is the chain a tile runs (scores, exchange,
// products) on two consumers.
//
// Bound on the H100: the pair must do 10 * L^2 * D * B * H flops (S, dP, dV,
// dQ, dK; dq alone 6, dkv alone 8, since each recomputes S and dP) against
// ~8 * B * L * H * D elements of traffic. fp32 runs 3xTF32 on the tensor
// cores at every head dim, 494.7 / 3 = 165 TFLOP/s; bf16 takes the bf16
// peak, 989 TFLOP/s. At the training path's L = 1024..4096 the flops
// bound every shape.

#include <atomic>
#include <type_traits>

#include "flash_bf16.cuh"
#include "flash_common.cuh"
#include "flash_hopper.cuh"
#include "flash_mma.cuh"

namespace {

// d = 16 on the tensor cores (header). 8 warps a block: warp w owns rows
// 16 (w & 3).. of the block's 64-row kept tile (q rows in dq, keys in dkv)
// and rows 64 (w >> 2).. of every 128-row streamed tile (its half).
namespace d16 {

constexpr int D = 16, BT = 64, BS = 128, HS = BS / 2, CH = 32, NT = 256;
constexpr int NC = CH / 8;     // n-tiles (8 streamed rows each) a chunk
constexpr int S = D + 4;       // plane row stride: 20 mod 32 banks (header)
constexpr int kPlane = BS * S;  // floats in one plane
constexpr float kLog2e = 1.4426950408889634f;
// A raw streamed tile's row stride as cp.async lands it: the planes' 80
// bytes, so the split pass reads and writes 32 banks. One raw buffer holds
// the streamed pair, [2][BS][S] floats.
constexpr int kRaw = 2 * BS * S;
// Planes of the streamed pair: [2 tensors][big, small][BS][S].
constexpr int kPlanes = 4 * kPlane;
// dq: two raw buffers and the planes. dkv adds lse and di of the streamed
// q rows: two raw buffers [lse, di][BS] and the staged [lse2, di scale][BS].
constexpr int kDqSmemFloats = 2 * kRaw + kPlanes;
constexpr int kDkvSmemFloats = kDqSmemFloats + 6 * BS;
static_assert(2 * kDkvSmemFloats * 4 <= 232448, "two blocks per SM");
static_assert(4 * 32 * 16 <= kPlanes, "the halves' merge fits in the planes");

// The 4-element unit j of a BS x 16 tile as (row, column): 8 consecutive
// units take 4 of row r and 4 of row r + 4, 16 floats each, which stride 20
// puts on the two halves of the 32 banks.
__device__ __forceinline__ void unit_rc(int j, int& r, int& c) {
  const int q = j >> 3, e = j & 7;
  r = (q >> 2) * 8 + (q & 3) + (e >> 2) * 4;
  c = (e & 3) * 4;
}

// Rows [r0, r0 + BS) of the streamed pair (a, b at (b, h)) into a raw
// buffer by cp.async, 16 bytes a lane, zero-filled past L. A thread copies
// one 16-byte chunk of each tensor every kRows rows (the unit of unit_rc,
// at rows r and r + 64).
__device__ __forceinline__ void copy_pair(float* raw, const float* a,
                                          const float* b, int r0, int L,
                                          int row) {
  constexpr int kRows = NT * 4 / D;  // rows the threads cover at once
  int r, c;
  unit_rc(threadIdx.x, r, c);
  const uint32_t dst = static_cast<uint32_t>(
      __cvta_generic_to_shared(raw + r * S + c));
#pragma unroll
  for (int which = 0; which < 2; ++which)
#pragma unroll
    for (int n = 0; n < BS / kRows; ++n) {
      const bool in = r0 + r + n * kRows < L;
      // a row past L reads nothing (src-size 0 fills zeros); its address
      // stays inside the tensor all the same
      const float* src =
          (which ? b : a) + ((in ? r0 + r + n * kRows : 0) * row + c);
      const uint32_t at = dst + static_cast<uint32_t>(
          (which * BS + n * kRows) * S * 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
                   "l"(src), "r"(in ? 16 : 0));
    }
}

// The raw pair into its planes, split once for every warp: big = TF32 of x
// (rounded to nearest), small = x - big, in fp32. A thread takes the
// 4-element unit unit_rc of rows r and r + 64 of each tensor.
__device__ __forceinline__ void split_pair(const float* raw, float* planes) {
  using namespace rdeic_flash;
  int r, c;
  unit_rc(threadIdx.x, r, c);
  const float* src0 = raw + r * S + c;
  float* dst0 = planes + r * S + c;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int which = n >> 1, half = n & 1;
    const float4 f = *reinterpret_cast<const float4*>(
        src0 + (which * BS + half * HS) * S);
    const float x[4] = {f.x, f.y, f.z, f.w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<true>(x[e], big[e], small[e]);
    float* dst = dst0 + which * 2 * kPlane + half * HS * S;
    *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + kPlane) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// The warp's 16 kept rows r0.. of a [B, L, H, D] tensor (p at (b, h)) as
// the values of TF32 A fragments: lane (g, t) reads rows g and g + 8 at
// columns t, t + 4 (k-step 0) and 8 + t, 12 + t (k-step 1) straight from
// device memory, 0 past L.
template <typename T>
__device__ __forceinline__ void load_kept(const T* p, int r0, int L,
                                          int64_t row, float (&x)[2][4]) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i & 1) * 8, c = 8 * kk + t + (i >> 1) * 4;
      x[kk][i] = r < L ? load_f32(p + r * row + c) : 0.f;
    }
}

// Kept fragments split once, for the whole loop.
__device__ __forceinline__ void split_kept(const float (&x)[2][4],
                                           uint32_t (&big)[2][4],
                                           uint32_t (&small)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rdeic_flash::split<true>(x[kk][i], big[kk][i], small[kk][i]);
}

// s (16 x CH: n-tile n holds streamed rows 8 n..) = A B^T over d: A the
// warp's kept fragments, B the streamed rows of `plane` from row 0, read
// ready-split by ldmatrix (big at plane, small at plane + kPlane).
__device__ __forceinline__ void scores(float (&s)[NC][4],
                                       const uint32_t (&ab)[2][4],
                                       const uint32_t (&as)[2][4],
                                       const float* plane) {
  using namespace rdeic_flash;
  zero(s);
  const RowB<S> rb(plane, 0, 0);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    float bb[NC][2], bs[NC][2];
    rb.load(bb, kk * 8);
    rb.load(bs, kPlane + kk * 8);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const uint32_t b[2] = {__float_as_uint(bb[n][0]),
                             __float_as_uint(bb[n][1])};
      const uint32_t sm[2] = {__float_as_uint(bs[n][0]),
                              __float_as_uint(bs[n][1])};
      mma_tf32(s[n], as[kk], b);
      mma_tf32(s[n], ab[kk], sm);
      mma_tf32(s[n], ab[kk], b);
    }
  }
}

// part (16 x 16) += (the 8 streamed rows of C, P or dS, as A) B, B(k, n) =
// plane rows 2t and 2t + 1 at column 8 n + g (b is at the lane's row 2t and
// column g). The permuted k order (slot t is row 2t, slot t + 4 row 2t + 1)
// makes the C fragment an A fragment: a0..a3 = c0, c2, c1, c3.
__device__ __forceinline__ void accumulate(float (&part)[2][4],
                                           const float (&c)[4],
                                           const float* b) {
  using namespace rdeic_flash;
  uint32_t pb[4], ps[4];
  split<true>(c[0], pb[0], ps[0]);
  split<true>(c[2], pb[1], ps[1]);
  split<true>(c[1], pb[2], ps[2]);
  split<true>(c[3], pb[3], ps[3]);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const uint32_t bb[2] = {__float_as_uint(b[8 * n]),
                            __float_as_uint(b[S + 8 * n])};
    mma_tf32(part[n], ps, bb);
    const uint32_t bs[2] = {__float_as_uint(b[kPlane + 8 * n]),
                            __float_as_uint(b[kPlane + S + 8 * n])};
    mma_tf32(part[n], pb, bs);
    mma_tf32(part[n], pb, bb);
  }
}

// acc += part, in fp32 (to nearest): each chunk's products sum from zero,
// so mma.sync's rounding toward zero stays relative to one chunk's part.
__device__ __forceinline__ void add(float (&acc)[2][4],
                                    const float (&part)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

// The warp's 16 x 16 C fragments, rows r0 + g and r0 + g + 8 (those below
// L), to out (at (b, h)).
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[2][4],
                                           int r0, int L, int64_t row) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= L) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store2<T>(out + r * row + 8 * n + 2 * t, acc[n][2 * hr],
                acc[n][2 * hr + 1]);
  }
}

// Half 1 hands its NA accumulators (4 floats each, a lane) to half 0
// through `buf`; half 0 adds them to its own, in that order. Returns false
// on half 1, which is then done.
template <int NA>
__device__ __forceinline__ bool merge_halves(float (&acc)[NA][4], float* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(buf) + ((warp & 3) * 32 + lane) * NA;
  __syncthreads();  // every warp is done with the planes
  if (warp >= 4) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      mine[a] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  __syncthreads();
  if (warp >= 4) return false;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const float4 x = mine[a];
    acc[a][0] += x.x, acc[a][1] += x.y, acc[a][2] += x.z, acc[a][3] += x.w;
  }
  return true;
}

// One block: (64-row q tile blockIdx.x, b*h blockIdx.y). Warp w keeps Q and
// dO of q rows 16 (w & 3).. as split A fragments, with their lse (log2
// units) and di, and takes half w >> 2 of every 128-key K / V tile in
// 32-key chunks: S = Q K^T and dP = dO V^T as C fragments, P = 2^(S c -
// lse2) (0 on a key past L) and dS = P (dP scale - di scale) in place, dq
// += dS K by chunk partials. Also di = rowsum(dO * O) for the tile's rows,
// written to `di`. The next raw K / V pair is copied while this one is
// split and used.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    flash_dq_d16(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ di, int L, int H,
                 float scale) {
  using namespace rdeic_flash;
  extern __shared__ __align__(16) float smem_d16[];
  float* raw = smem_d16;                  // [2 buffers] K, V
  float* planes = smem_d16 + 2 * kRaw;   // K, V
  const float* kp = planes;
  const float* vp = planes + kPlanes / 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, half = warp >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const T* kb = k + base;
  const T* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for exp2f

  copy_pair(raw, kb, vb, 0, L, static_cast<int>(row));
  cp_async_commit();

  // rows g (hr = 0) and g + 8 (hr = 1) of the warp's 16: lse2 = lse log2(e),
  // and di scale, di from the lane's 4 products of each row and its quad's
  const int r0 = blockIdx.x * BT + (warp & 3) * 16;
  uint32_t qb[2][4], qsm[2][4], db[2][4], dsm[2][4];
  float lse2[2], dis[2];
  {
    float x[2][4], y[2][4];
    load_kept<T>(dout + base, r0, L, row, x);
    load_kept<T>(o + base, r0, L, row, y);
    split_kept(x, db, dsm);
    float di_r[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        di_r[i & 1] = fmaf(x[kk][i], y[kk][i], di_r[i & 1]);
    load_kept<T>(q + base, r0, L, row, x);
    split_kept(x, qb, qsm);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      di_r[hr] += __shfl_xor_sync(0xffffffffu, di_r[hr], 1);
      di_r[hr] += __shfl_xor_sync(0xffffffffu, di_r[hr], 2);
      const int r = r0 + g + 8 * hr;
      const bool in = r < L;
      lse2[hr] = in ? lse[rbase + r] * kLog2e : 0.f;
      dis[hr] = di_r[hr] * scale;
      if (in && t == 0 && half == 0) di[rbase + r] = di_r[hr];
    }
  }

  float acc[2][4];  // dq[16 rows][16]: n-tile n holds columns 8 n..
  zero(acc);
  const int nk = (L + BS - 1) / BS;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // raw tile j has landed; no warp reads the planes
    if (j + 1 < nk)
      copy_pair(raw + ((j + 1) & 1) * kRaw, kb, vb, (j + 1) * BS, L,
                static_cast<int>(row));
    cp_async_commit();
    split_pair(raw + (j & 1) * kRaw, planes);
    __syncthreads();
    const int k0 = j * BS + half * HS;  // this warp's first key
    if (k0 >= L) continue;  // a half wholly past L has nothing to add
#pragma unroll 1
    for (int c0 = 0; c0 < HS; c0 += CH) {
      const float* kt = kp + (half * HS + c0) * S;
      float s[NC][4], dp[NC][4];
      scores(s, qb, qsm, kt);
      scores(dp, db, dsm, vp + (half * HS + c0) * S);
      const bool tail = k0 + c0 + CH > L;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hr = i >> 1;
          float p = exp2f(fmaf(s[n][i], c, -lse2[hr]));
          if (tail && k0 + c0 + 8 * n + 2 * t + (i & 1) >= L) p = 0.f;
          s[n][i] = p * fmaf(dp[n][i], scale, -dis[hr]);
        }
      float part[2][4];
      zero(part);
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        accumulate(part, s[kk], kt + (8 * kk + 2 * t) * S + g);
      add(acc, part);
    }
  }
  cp_async_wait<0>();
  if (merge_halves(acc, planes)) store_rows<T>(dq + base, acc, r0, L, row);
}

// Row terms of the streamed q rows [r0, r0 + BS) into a raw buffer
// [lse, di][BS] by cp.async, 4 bytes a thread, zero-filled past L.
__device__ __forceinline__ void copy_rows(float* raw, const float* lse,
                                          const float* di, int r0, int L) {
  const int i = threadIdx.x & (BS - 1), which = threadIdx.x / BS;
  const bool in = r0 + i < L;
  const float* src = (which ? di : lse) + (in ? r0 + i : 0);
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(raw + which * BS + i));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}
static_assert(NT == 2 * BS, "a thread copies one row term");

// One block: (64-row k tile blockIdx.x, b*h blockIdx.y). Warp w keeps K and
// V of keys 16 (w & 3).. as split A fragments and takes half w >> 2 of
// every 128-row Q / dO tile in 32-row chunks: S^T = K Q^T and dP^T = V dO^T
// as C fragments (rows keys, columns q), P^T = 2^(S^T c - lse2) and dS^T =
// P^T (dP^T scale - di scale) in place, with lse2 and di scale read by
// column from shared memory (lse2 = +inf past L, so P^T = 0 there);
// dv += P^T dO and dk += dS^T Q by chunk partials.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    flash_dkv_d16(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dk,
                  T* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  extern __shared__ __align__(16) float smem_d16[];
  float* raw = smem_d16;                  // [2 buffers] Q, dO
  float* planes = smem_d16 + 2 * kRaw;   // Q, dO
  float* rows_raw = planes + kPlanes;     // [2 buffers][lse, di][BS]
  float* rows = rows_raw + 4 * BS;        // [lse2, di scale][BS]
  const float* qp = planes;
  const float* dp_plane = planes + kPlanes / 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, half = warp >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const T* qb = q + base;
  const T* db = dout + base;
  const float c = scale * kLog2e;

  copy_pair(raw, qb, db, 0, L, static_cast<int>(row));
  copy_rows(rows_raw, lse + rbase, di + rbase, 0, L);
  cp_async_commit();

  const int r0 = blockIdx.x * BT + (warp & 3) * 16;
  uint32_t kbig[2][4], ksm[2][4], vbig[2][4], vsm[2][4];
  {
    float x[2][4];
    load_kept<T>(k + base, r0, L, row, x);
    split_kept(x, kbig, ksm);
    load_kept<T>(v + base, r0, L, row, x);
    split_kept(x, vbig, vsm);
  }

  float acc_k[2][4], acc_v[2][4];  // dk, dv [16 keys][16]
  zero(acc_k);
  zero(acc_v);
  const int nq = (L + BS - 1) / BS;
  for (int j = 0; j < nq; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; no warp reads the planes or rows
    if (j + 1 < nq) {
      copy_pair(raw + ((j + 1) & 1) * kRaw, qb, db, (j + 1) * BS, L,
                static_cast<int>(row));
      copy_rows(rows_raw + ((j + 1) & 1) * 2 * BS, lse + rbase, di + rbase,
                (j + 1) * BS, L);
    }
    cp_async_commit();
    split_pair(raw + (j & 1) * kRaw, planes);
    {
      const float* rr = rows_raw + (j & 1) * 2 * BS;
      const int i = threadIdx.x & (BS - 1), which = threadIdx.x / BS;
      const bool in = j * BS + i < L;
      rows[which * BS + i] =
          which ? rr[BS + i] * scale : (in ? rr[i] * kLog2e : INFINITY);
    }
    __syncthreads();
    const int q0 = j * BS + half * HS;  // this warp's first q row
    if (q0 >= L) continue;
#pragma unroll 1
    for (int c0 = 0; c0 < HS; c0 += CH) {
      const int col0 = half * HS + c0;
      const float* qt = qp + col0 * S;
      const float* dt = dp_plane + col0 * S;
      float s[NC][4], dp[NC][4];
      scores(s, kbig, ksm, qt);
      scores(dp, vbig, vsm, dt);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = col0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
        const float2 d2 = *reinterpret_cast<const float2*>(rows + BS + col);
        const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const float p = exp2f(fmaf(s[n][i], c, -lc[e]));
          s[n][i] = p;
          dp[n][i] = p * fmaf(dp[n][i], scale, -dc[e]);
        }
      }
      float part[2][4];
      zero(part);
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        accumulate(part, s[kk], dt + (8 * kk + 2 * t) * S + g);
      add(acc_v, part);
      zero(part);
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        accumulate(part, dp[kk], qt + (8 * kk + 2 * t) * S + g);
      add(acc_k, part);
    }
  }
  cp_async_wait<0>();
  float acc[4][4];  // dk and dv, merged as one
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = acc_k[n][i], acc[2 + n][i] = acc_v[n][i];
  if (!merge_halves(acc, planes)) return;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc[n][i], acc_v[n][i] = acc[2 + n][i];
  store_rows<T>(dk + base, acc_k, r0, L, row);
  store_rows<T>(dv + base, acc_v, r0, L, row);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  if (static_cast<int64_t>(L) * H * D > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = kDqSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_dq_d16<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dq_d16<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), di, L, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  if (static_cast<int64_t>(L) * H * D > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = kDkvSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_dkv_d16<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dkv_d16<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d16

// `smem` bytes of dynamic shared memory for `kernel`, and as much shared
// memory on the SM as it has, so that the blocks a kernel's launch bounds
// ask for fit (four d16_bf16 blocks; one d64_bf16 or d512_bf16 block of
// 99-201 KB)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// prepare() once on each device that launches the kernel: a function's
// attributes are set on the current device only, so a flag a device (not
// one a process) records where they hold. Past kMaxDevices it prepares on
// every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t prepare_on_device(Kernel kernel, int smem,
                              std::atomic<bool>* prepared) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool flagged = dev < kMaxDevices;
  if (flagged && prepared[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = prepare(kernel, smem);
  if (err == cudaSuccess && flagged)
    prepared[dev].store(true, std::memory_order_release);
  return err;
}

// cudaSuccess if `kernel` launches with `regs` registers a thread: a kernel
// whose consumers raise their registers by setmaxnreg.inc needs the count
// its exchange assumes (with fewer, the raise would wait for registers the
// producer never gave back)
template <typename Kernel>
cudaError_t launch_regs(Kernel kernel, int regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs == regs ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// bf16 at d = 64 on wgmma (header). One block: a kept tile of 64 NWG rows
// (blockIdx.x: q rows in dq, keys in dkv) of (b*h blockIdx.y), NWG consumer
// warpgroups, each owning 64 kept rows and keeping their scores and
// accumulators in registers, and a producer warp that issues every TMA load
// (and, in dkv, copies the streamed q rows' lse and di). NWG = 1, two
// blocks an SM: two consumer warpgroups an SM, as at NWG = 2, but half the
// tile a block, so the last wave's blocks spread over more SMs.
namespace d64_bf16 {

namespace bf16 = rdeic_flash::bf16;
using bf16::bf16_t;
using namespace rdeic_flash::hopper;
// NWG consumer warpgroups of 64 kept rows a block, BLOCKS blocks an SM
constexpr int NWG = 1, BLOCKS = 2 / NWG;
constexpr int D = 64, BM = 64 * NWG, BN = 64, STAGES = 4;
constexpr int NT = 128 * (NWG + 1);
// the consumer warpgroups (warps 0.. 4 NWG - 1), then the producer
// warpgroup, whose registers setmaxnreg gives to the consumers;
// setmaxnreg.inc waits for registers its own block freed, so the launch
// must have kLaunchRegs a thread (launch_dq / launch_dkv refuse a build
// that launches with another count)
constexpr int kLaunchRegs = (65536 / (NT * BLOCKS)) & ~7;
constexpr int kProducerRegs = 24, kConsumerRegs = NWG == 1 ? 232 : 240;
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  128 * NWG * (kConsumerRegs - kLaunchRegs),
              "registers per block");
constexpr uint32_t kTile = 64 * D * 2;  // bytes: 64 rows of one tensor
constexpr uint32_t kRowTerms = 2 * BN * 4;  // bytes: lse and di of 64 rows
// dq: Q, dO and O of the BM q rows, then the K ring and the V ring; dkv:
// K and V of the BM keys, the Q ring, the dO ring and the rows' lse and
// di; each from a 1024-byte-aligned base
constexpr int kDqSmemBytes = 1024 + 3 * NWG * kTile + 2 * STAGES * kTile;
constexpr int kDkvSmemBytes =
    1024 + 2 * NWG * kTile + 2 * STAGES * kTile + STAGES * kRowTerms;
static_assert(BLOCKS * (kDqSmemBytes + 1024) <= 233472 &&
                  BLOCKS * (kDkvSmemBytes + 1024) <= 233472,
              "shared memory per SM");

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr));
  return x;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr));
  return x;
}

// The accumulator fragments of X (64 x 64: x[4 n + i]) as two bf16 terms
// (pack_split), the A fragments of the four 16-deep steps over X's columns:
// n-tiles 2 kk and 2 kk + 1, packed pairwise, are step kk
__device__ __forceinline__ void pack_terms(const float (&x)[BN / 2],
                                           uint32_t (&big)[BN / 16][4],
                                           uint32_t (&small)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bf16::pack_split(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], big[kk][e],
                       small[kk][e]);
  fence_regs(big);
  fence_regs(small);
}

// acc += X B over 64 streamed rows: X as two terms (pack_terms), B a tile
// in shared memory read MN-major (`db`: its descriptor; 16 rows, 2048
// bytes, a step); at each step the small term's product, then the big's
__device__ __forceinline__ void take_terms(float (&acc)[D / 2],
                                           const uint32_t (&big)[BN / 16][4],
                                           const uint32_t (&small)[BN / 16][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    mma_m64n64k16_rs_mn(acc, small[kk], db + 128 * kk, 1);
    mma_m64n64k16_rs_mn(acc, big[kk], db + 128 * kk, 1);
  }
}

// The warpgroup's 64 x 64 accumulator (rows r0 + 16 w + g and + 8, those
// below L) to out (at (b, h)) as bf16
__device__ __forceinline__ void store_rows(bf16_t* out,
                                           const float (&acc)[D / 2], int r0,
                                           int L, int64_t row) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * w + g + 8 * half;
    if (r >= L) continue;
    bf16_t* p = out + r * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      rdeic_flash::store2<bf16_t>(p + 8 * n, acc[4 * n + 2 * half],
                                  acc[4 * n + 2 * half + 1]);
  }
}

// One block: (BM q rows blockIdx.x, b*h blockIdx.y). Consumer wg keeps Q
// and dO of q rows 64 wg.. in shared memory and streams K and V tiles of
// 64 keys: S = Q K^T and dP = dO V^T (SS wgmma), P and dS in the
// accumulator registers, dq += dS K (RS wgmma, dS from registers as two
// terms, K MN-major). Also di = rowsum(dO O) of its rows, written to `di`
// for the dkv kernel.
__global__ void __launch_bounds__(NT, BLOCKS)
    flash_dq_d64_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, bf16_t* __restrict__ dq,
                      float* __restrict__ di, int L, int H, float scale) {
  using bf16::exp2_ftz, bf16::kLog2e;
  extern __shared__ unsigned char smem_dq64h[];
  // q_full, then per stage k_full, k_empty, v_full, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  const uint32_t sq = (smem_u32(smem_dq64h) + 1023) & ~1023u;
  const uint32_t sdo = sq + NWG * kTile, so = sdo + NWG * kTile;
  const uint32_t sk = so + NWG * kTile, sv = sk + STAGES * kTile;
  const uint32_t q_full = smem_u32(bars);
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nk = (L + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 4 * NWG);  // lane 0 of each consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // the producer: one thread keeps the ring full, a tile's K ahead of its
    // V (K is freed a tile later: dS K runs under the next tile's scores)
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(q_full, 3 * NWG * kTile);
#pragma unroll
      for (int i = 0; i < NWG; ++i) {
        tma_load_4d(sq + i * kTile, &tq, q_full, 0, h, q0 + 64 * i, b);
        tma_load_4d(sdo + i * kTile, &tdo, q_full, 0, h, q0 + 64 * i, b);
        tma_load_4d(so + i * kTile, &to, q_full, 0, h, q0 + 64 * i, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t free = ((j / STAGES) & 1) ^ 1;  // round 0 passes
        mbar_wait(k_empty(s), free);
        mbar_expect_tx(k_full(s), kTile);
        tma_load_4d(sk + s * kTile, &tk, k_full(s), 0, h, j * BN, b);
        mbar_wait(v_empty(s), free);
        mbar_expect_tx(v_full(s), kTile);
        tma_load_4d(sv + s * kTile, &tv, v_full(s), 0, h, j * BN, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;  // the consumer: q rows 64 wg.. of the block
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  mbar_wait(q_full, 0);

  // rows g (half 0) and g + 8 (half 1) of warp w's 16: lse2 = lse log2(e)
  // and di scale; di from the quad, lane t taking values 16 t.. of each
  // row of dO and O from the swizzled tiles
  float lse2[2], dis[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t rr = 16 * w + g + 8 * half;  // row of the wg's tile
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const uint32_t at = wg * kTile + swizzle128(rr, 16 * (2 * t + cc));
      const uint4 x = ld_shared_v4(sdo + at), y = ld_shared_v4(so + at);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = bf16::unpack(xs[e]), o = bf16::unpack(ys[e]);
        sum = fmaf(a.y, o.y, fmaf(a.x, o.x, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = q0 + 64 * wg + rr;
    const bool in = r < L;
    lse2[half] = in ? lse[rbase + r] * kLog2e : 0.f;
    dis[half] = in ? sum * scale : 0.f;
    if (in && t == 0) di[rbase + r] = sum;
  }

  const uint64_t dq_a = desc(sq + wg * kTile), ddo_a = desc(sdo + wg * kTile);
  float acc[D / 2];  // dq[64 rows][64]: acc[4 n + i], columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];  // S and dP of a tile (keys 8 n.. at 4 n)
  uint32_t big[BN / 16][4], small[BN / 16][4];  // dS as two bf16 terms

  // S = Q K^T and dP = dO V^T of tile j, 64 x 64 each, issued
  auto issue_scores = [&](int j) {
    const int st = j % STAGES;
    const uint32_t phase = (j / STAGES) & 1;
    mbar_wait(k_full(st), phase);
    mbar_wait(v_full(st), phase);
    wgmma_fence();
    const uint64_t dk = desc(sk + st * kTile), dv = desc(sv + st * kTile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_m64n64k16_ss(s, dq_a + 2 * kk, dk + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_m64n64k16_ss(dp, ddo_a + 2 * kk, dv + 2 * kk, kk);
    wgmma_commit();
  };
  // dq += dS K of tile j (big, small), issued: K is the MN-major B operand
  auto issue_dq = [&](int j) {
    wgmma_fence();
    take_terms(acc, big, small, desc(sk + (j % STAGES) * kTile, kTile));
    wgmma_commit();
  };
  // P = 2^(S c - lse2), 0 on a key past L (its K row is zero, but P need
  // not be finite there); dS = P (dP scale - di scale), in place of dP
  auto grad = [&](int j) {
    const int k0 = j * BN;
    const bool tail = k0 + BN > L;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int half = i >> 1;
        float p = exp2_ftz(fmaf(s[4 * n + i], c, -lse2[half]));
        if (tail && k0 + 8 * n + 2 * t + (i & 1) >= L) p = 0.f;
        dp[4 * n + i] = p * fmaf(dp[4 * n + i], scale, -dis[half]);
      }
  };

  // Each warpgroup overlaps its exponentials with its products: the scores
  // of tile j and dS K of tile j - 1 are issued together, and P and dS of
  // tile j are formed while dS K runs (wgmma groups complete in order).
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  __syncwarp();
  if (lane == 0) mbar_arrive(v_empty(0));
  grad(0);
  pack_terms(dp, big, small);
  for (int j = 1; j < nk; ++j) {
    issue_scores(j);
    issue_dq(j - 1);
    wgmma_wait<1>();  // the scores of tile j (dS K may still run)
    fence_regs(s);
    fence_regs(dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(j % STAGES));
    grad(j);
    wgmma_wait<0>();  // dS K of tile j - 1: its K and the terms are free
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty((j - 1) % STAGES));
    pack_terms(dp, big, small);
  }
  issue_dq(nk - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  const int64_t row = static_cast<int64_t>(H) * D;
  store_rows(dq + static_cast<int64_t>(b) * L * row + h * D, acc,
             q0 + 64 * wg, L, row);
}

// One block: (BM keys blockIdx.x, b*h blockIdx.y). Consumer wg keeps K
// and V of keys 64 wg.. in shared memory and streams Q and dO tiles of 64
// q rows with their rows' lse and di: S^T = K Q^T and dP^T = V dO^T (SS
// wgmma, keys as rows), P^T and dS^T in the accumulator registers, dv +=
// P^T dO and dk += dS^T Q (RS wgmma, two terms each, dO and Q MN-major). A
// q row past L lands as zeros (Q, dO, lse, di), so S^T = 0, P^T = 1,
// dP^T = 0 and dS^T = 0 there, and its products with dO = 0 and Q = 0 add
// exact zeros: no test.
__global__ void __launch_bounds__(NT, BLOCKS)
    flash_dkv_d64_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16_t* __restrict__ dk,
                       bf16_t* __restrict__ dv, int L, int H, float scale) {
  using bf16::exp2_ftz, bf16::kLog2e;
  extern __shared__ unsigned char smem_dkv64h[];
  // kv_full, then per stage q_full, q_empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t sk = (smem_u32(smem_dkv64h) + 1023) & ~1023u;
  const uint32_t sv = sk + NWG * kTile, sq = sv + NWG * kTile;
  const uint32_t sdo = sq + STAGES * kTile, srow = sdo + STAGES * kTile;
  const uint32_t kv_full = smem_u32(bars);
  auto q_full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto q_empty = [&](int s) { return kv_full + 8 * (1 + STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (L + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrival and the 32 lanes' lse / di copies
      mbar_init(q_full(s), 1 + 32);
      mbar_init(q_empty(s), 4 * NWG);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // the producer warp: lane 0 issues the TMA loads; every lane copies 2
    // lse and 2 di values of a stage's q rows by cp.async (4 bytes each,
    // zero past L: a [B*H, L] row is not 16-byte aligned for TMA), whose
    // completion the stage's barrier tracks
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * NWG) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * NWG * kTile);
#pragma unroll
        for (int i = 0; i < NWG; ++i) {
          tma_load_4d(sk + i * kTile, &tk, kv_full, 0, h, k0 + 64 * i, b);
          tma_load_4d(sv + i * kTile, &tv, kv_full, 0, h, k0 + 64 * i, b);
        }
      }
      const float* lb = lse + static_cast<int64_t>(bh) * L;
      const float* ib = di + static_cast<int64_t>(bh) * L;
      for (int j = 0; j < nq; ++j) {
        const int s = j % STAGES;
        mbar_wait(q_empty(s), ((j / STAGES) & 1) ^ 1);  // round 0 passes
        if (lane == 0) {
          mbar_expect_tx(q_full(s), 2 * kTile);
          tma_load_4d(sq + s * kTile, &tq, q_full(s), 0, h, j * BN, b);
          tma_load_4d(sdo + s * kTile, &tdo, q_full(s), 0, h, j * BN, b);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = j * BN + 2 * lane + e;
          const bool in = r < L;
          const uint32_t at = srow + s * kRowTerms + 4 * (2 * lane + e);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                           at),
                       "l"(lb + (in ? r : 0)), "r"(in ? 4 : 0)
                       : "memory");
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                           at + 4 * BN),
                       "l"(ib + (in ? r : 0)), "r"(in ? 4 : 0)
                       : "memory");
        }
        cp_async_mbar_arrive(q_full(s));
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;  // the consumer: keys 64 wg.. of the block
  const int t = lane & 3;
  const float c = scale * kLog2e;
  const uint64_t dk_a = desc(sk + wg * kTile), dv_a = desc(sv + wg * kTile);
  float acc_k[D / 2], acc_v[D / 2];  // dk, dv [64 keys][64]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float s[BN / 2], dp[BN / 2];  // S^T and dP^T of a tile (q rows 8 n.. at 4 n)
  uint32_t p_big[BN / 16][4], p_small[BN / 16][4];  // P^T as two terms
  uint32_t d_big[BN / 16][4], d_small[BN / 16][4];  // dS^T as two terms

  // S^T = K Q^T and dP^T = V dO^T of tile j, 64 x 64 each, issued
  auto issue_scores = [&](int j) {
    const int st = j % STAGES;
    mbar_wait(q_full(st), (j / STAGES) & 1);
    wgmma_fence();
    const uint64_t dq_b = desc(sq + st * kTile), ddo_b = desc(sdo + st * kTile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_m64n64k16_ss(s, dk_a + 2 * kk, dq_b + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_m64n64k16_ss(dp, dv_a + 2 * kk, ddo_b + 2 * kk, kk);
    wgmma_commit();
  };
  // dv += P^T dO and dk += dS^T Q of tile j, issued: dO and Q are the
  // MN-major B operands
  auto issue_products = [&](int j) {
    const int st = j % STAGES;
    wgmma_fence();
    take_terms(acc_v, p_big, p_small, desc(sdo + st * kTile, kTile));
    take_terms(acc_k, d_big, d_small, desc(sq + st * kTile, kTile));
    wgmma_commit();
  };
  // column 8 n + 2 t + e is q row j BN + 8 n + 2 t + e: P^T = 2^(S^T c -
  // lse2), dS^T = P^T (dP^T scale - di scale), in place
  auto grad = [&](int j) {
    const uint32_t rows = srow + (j % STAGES) * kRowTerms;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const uint32_t col = 4 * (8 * n + 2 * t);
      const float2 l2 = ld_shared_f2(rows + col);
      const float2 d2 = ld_shared_f2(rows + 4 * BN + col);
      const float lc[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dc[2] = {d2.x * scale, d2.y * scale};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i & 1;
        const float p = exp2_ftz(fmaf(s[4 * n + i], c, -lc[e]));
        s[4 * n + i] = p;
        dp[4 * n + i] = p * fmaf(dp[4 * n + i], scale, -dc[e]);
      }
    }
  };

  // as in dq: the scores of tile j and the products of tile j - 1 are
  // issued together, and P^T and dS^T of tile j are formed under the
  // products
  mbar_wait(kv_full, 0);
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad(0);
  pack_terms(s, p_big, p_small);
  pack_terms(dp, d_big, d_small);
  for (int j = 1; j < nq; ++j) {
    issue_scores(j);
    issue_products(j - 1);
    wgmma_wait<1>();  // the scores of tile j
    fence_regs(s);
    fence_regs(dp);
    grad(j);
    wgmma_wait<0>();  // the products of tile j - 1: its Q, dO and terms
    fence_regs(acc_k);
    fence_regs(acc_v);
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty((j - 1) % STAGES));
    pack_terms(s, p_big, p_small);
    pack_terms(dp, d_big, d_small);
  }
  issue_products(nq - 1);
  wgmma_wait<0>();
  fence_regs(acc_k);
  fence_regs(acc_v);

  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row + h * D;
  store_rows(dk + base, acc_k, k0 + 64 * wg, L, row);
  store_rows(dv + base, acc_v, k0 + 64 * wg, L, row);
}

std::atomic<bool> dq_prepared[kMaxDevices];
std::atomic<bool> dkv_prepared[kMaxDevices];

// The kernel's shared memory, once a device; and a refusal of a build that
// launches it with other than kLaunchRegs registers a thread, where the
// consumers' setmaxnreg.inc would wait for registers the producer never
// gave back
template <typename Kernel>
cudaError_t prepare_exchange(Kernel kernel, int smem,
                             std::atomic<bool>* prepared) {
  static const cudaError_t regs = launch_regs(kernel, kLaunchRegs);
  if (regs != cudaSuccess) return regs;
  return prepare_on_device(kernel, smem, prepared);
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  err = prepare_exchange(flash_dq_d64_bf16, kDqSmemBytes, dq_prepared);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to, tdo;
  if (!tensor_map(&tq, q, true, B, L, H, D, D, 64) ||
      !tensor_map(&tk, k, true, B, L, H, D, D, BN) ||
      !tensor_map(&tv, v, true, B, L, H, D, D, BN) ||
      !tensor_map(&to, o, true, B, L, H, D, D, 64) ||
      !tensor_map(&tdo, dout, true, B, L, H, D, D, 64))
    return cudaErrorInvalidValue;
  const dim3 grid((L + BM - 1) / BM, B * H);
  flash_dq_d64_bf16<<<grid, NT, kDqSmemBytes, stream>>>(
      tq, tk, tv, to, tdo, lse, static_cast<bf16_t*>(dq), di, L, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  err = prepare_exchange(flash_dkv_d64_bf16, kDkvSmemBytes, dkv_prepared);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, true, B, L, H, D, D, BN) ||
      !tensor_map(&tk, k, true, B, L, H, D, D, 64) ||
      !tensor_map(&tv, v, true, B, L, H, D, D, 64) ||
      !tensor_map(&tdo, dout, true, B, L, H, D, D, BN))
    return cudaErrorInvalidValue;
  const dim3 grid((L + BM - 1) / BM, B * H);
  flash_dkv_d64_bf16<<<grid, NT, kDkvSmemBytes, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<bf16_t*>(dk),
      static_cast<bf16_t*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d64_bf16

// fp32 at d = 64 on TF32 wgmma, each product as three passes (header). One
// block: kept rows of one b*h (q rows in dq, keys in dkv: 128, or 64 in a
// half block, `Block`) and three warpgroups: warpgroup 0 the producer
// (thread 0 issues every TMA load, all 128 threads split the loaded tiles
// into the operands wgmma reads), warpgroups 1 and 2 the consumers, each
// with its 64 kept rows' big terms, scores and sums in registers.
namespace d64 {

using namespace rdeic_flash::hopper;
constexpr int D = 64, NWG = 2, BM = 64 * NWG, BN = 32, STAGES = 2;
constexpr int NT = 128 * (NWG + 1);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(BN * 4 == 128, "a transposed plane's row is one 128-byte row");
constexpr uint32_t kAtom = 64 * 128;    // bytes: 64 rows of 32 fp32
constexpr uint32_t kSAtom = BN * 128;   // bytes: BN rows of 32 fp32
constexpr uint32_t kKept = 2 * kAtom;   // a kept 64 x 64 plane: two atoms
constexpr uint32_t kPlane = 2 * kSAtom;  // a streamed BN x 64 plane, K-major
constexpr uint32_t kTPlane = kAtom;      // a transposed 64 x BN plane
// a ring of streamed tiles as TMA loads them (two tensors), and a ring of
// operands the producer makes of them: each tensor's big and small planes
// (K-major, the scores' B) and, of the tensors that are the products' B,
// big and small transposed planes (d as rows, the streamed rows in P's
// permuted fragment order along them)
constexpr uint32_t kRaw = 2 * kPlane;
constexpr uint32_t kDqOp = 4 * kPlane + 2 * kTPlane;   // K, V; K^T
constexpr uint32_t kDkvOp = 4 * kPlane + 4 * kTPlane;  // Q, dO; Q^T, dO^T
// then the two kept tensors' small planes (the scores' A of the first
// pass), NWG 64-row tiles each; dkv adds the streamed rows' lse and di,
// as loaded and as lse log2(e) and di, [STAGES][2][BN] floats each
constexpr uint32_t kRows = STAGES * 2 * BN * 4;
constexpr int kDqSmemBytes =
    1024 + STAGES * (kRaw + kDqOp) + 2 * NWG * kKept;
constexpr int kDkvSmemBytes =
    1024 + STAGES * (kRaw + kDkvOp) + 2 * NWG * kKept + 2 * kRows;
static_assert(kDqSmemBytes <= 232448 - 64 && kDkvSmemBytes <= 232448 - 64,
              "shared memory per block (and the barriers)");
// registers: the launch's (65536 over 384 threads, to 8), then moved by
// setmaxnreg from the producer, which splits, to the consumers, which hold
// the kept big terms, the scores, P's or dS's terms and the accumulators;
// setmaxnreg.inc waits for registers its own block freed, so the launch
// must have kLaunchRegs a thread (launch_dq / launch_dkv refuse another)
constexpr int kLaunchRegs = (65536 / NT) & ~7;
constexpr int kDqProducerRegs = 56, kDqConsumerRegs = 224;
constexpr int kDkvProducerRegs = 40, kDkvConsumerRegs = 232;
static_assert(128 * kDqProducerRegs + 128 * NWG * kDqConsumerRegs <=
                      NT * kLaunchRegs &&
                  128 * kDkvProducerRegs + 128 * NWG * kDkvConsumerRegs <=
                      NT * kLaunchRegs,
              "registers per block");

// The k slot of streamed row x of a tile in a transposed plane: within
// each 8 rows, slot t is row 2t and slot t + 4 row 2t + 1, so that the
// scores' accumulator fragment is the products' A fragment as it stands
// (a0..a3 = c0, c2, c1, c3)
__device__ __forceinline__ uint32_t slot_of(int x) {
  const int e = x & 7;
  return (x & ~7) + ((e & 1) ? 4 + (e >> 1) : e >> 1);
}

// The producer thread tid's share of one loaded BN x 64 tile (`raw`: two
// atoms as TMA writes them) into its big and small planes (the same
// swizzled layout) and, with TRANS, its transposed big and small planes:
// lane = streamed row, chunk c = d 4c..4c + 3, 4 chunks a thread. Every
// read and write hits 32 banks
// (tests/test_torch_port_flash_bwd_d64_fp32.py).
template <bool TRANS>
__device__ __forceinline__ void split_tile(const unsigned char* raw,
                                           unsigned char* big,
                                           unsigned char* small,
                                           unsigned char* tbig,
                                           unsigned char* tsmall, int tid) {
  const int lane = tid & 31, wq = tid >> 5;
  const uint32_t slot = slot_of(lane);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = wq + 4 * it;
    const uint32_t at = (c >> 3) * kSAtom + swizzle128(lane, 16 * (c & 7));
    float4 b, s;
    rdeic_flash::split4(*reinterpret_cast<const float4*>(raw + at), b, s);
    *reinterpret_cast<float4*>(big + at) = b;
    *reinterpret_cast<float4*>(small + at) = s;
    if constexpr (TRANS) {
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t t_at = swizzle128(4 * c + e, 4 * slot);
        *reinterpret_cast<float*>(tbig + t_at) = bv[e];
        *reinterpret_cast<float*>(tsmall + t_at) = sv[e];
      }
    }
  }
}

// The consumer thread's 16 rows r0 (+ 8) of a kept [B, L, H, D] tensor
// (p at (b, h)) as TF32 A fragments, split once: k-step kk holds (row,
// 8 kk + t) and (row, 8 kk + t + 4) of rows r0 and r0 + 8. The big term
// stays in registers (the A of the second and third pass); the small term
// goes to `small`, the warpgroup's plane in the 128-byte swizzle (the A of
// the first pass, from shared memory). Returns the values in x (0 past L).
__device__ __forceinline__ void load_kept(const float* p, int r0, int rw,
                                          int L, int64_t row,
                                          uint32_t (&big)[D / 8][4],
                                          unsigned char* small,
                                          float (&x)[D / 8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      x[kk][i] = rr < L ? p[rr * row + col] : 0.f;
      uint32_t s;
      rdeic_flash::split<true>(x[kk][i], big[kk][i], s);
      *reinterpret_cast<uint32_t*>(
          small + (col >> 5) * kAtom +
          swizzle128(rw + 8 * (i & 1), 4 * (col & 31))) = s;
    }
}

// The 64 x BN score tile of one kept tensor against one streamed one, three
// passes an 8-deep step over d from zero (small * big, big * small,
// big * big): A's small term from shared memory (`as`: the warpgroup's
// plane), its big one from registers; B the streamed tile's big and small
// planes (bb, bs)
__device__ __forceinline__ void scores(float (&s)[BN / 2], uint32_t as,
                                       const uint32_t (&ab)[D / 8][4],
                                       uint32_t bb, uint32_t bs) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t ka = (kk >> 2) * kAtom + 32 * (kk & 3);
    const uint32_t kb = (kk >> 2) * kSAtom + 32 * (kk & 3);
    mma_m64n32k8_ss_tf32(s, desc(as + ka), desc(bb + kb), kk);
    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bs + kb), 1);
    mma_m64n32k8_rs_tf32(s, ab[kk], desc(bb + kb), 1);
  }
}

// x (a 64 x BN accumulator fragment: P, dS or their transposes) as the
// TF32 A fragments of the BN / 8 steps over its columns, split: step kk's
// a0..a3 are c0, c2, c1, c3 of n-tile kk (the permuted k order)
__device__ __forceinline__ void terms(const float (&x)[BN / 2],
                                      uint32_t (&big)[BN / 8][4],
                                      uint32_t (&small)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rdeic_flash::split<true>(x[4 * kk + ((e & 1) << 1) + (e >> 1)],
                               big[kk][e], small[kk][e]);
  fence_regs(big);
  fence_regs(small);
}

// part = X B over the tile's BN streamed rows, from zero, three passes a
// step (small * big, big * small, big * big): X's terms from registers, B
// the transposed planes (tb, ts: N = d, K-major along the slots)
__device__ __forceinline__ void product(float (&part)[D / 2],
                                        const uint32_t (&big)[BN / 8][4],
                                        const uint32_t (&small)[BN / 8][4],
                                        uint32_t tb, uint32_t ts) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    mma_m64n64k8_rs_tf32(part, small[kk], desc(tb + 32 * kk), kk);
    mma_m64n64k8_rs_tf32(part, big[kk], desc(ts + 32 * kk), 1);
    mma_m64n64k8_rs_tf32(part, big[kk], desc(tb + 32 * kk), 1);
  }
}

// acc += X B over the tile's BN streamed rows (`product`), through a
// partial from zero that joins acc by one fp32 add (wgmma rounds its sums
// toward zero: the rounding stays that of one tile). With NARROW, as two
// products of 32 columns of d (m64n32k8, B from rows 32 h.. of the planes),
// one after the other, so that a partial of 16 registers is live, not 32:
// dkv's half blocks, whose consumers would otherwise spill
template <bool NARROW>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&big)[BN / 8][4],
                                           const uint32_t (&small)[BN / 8][4],
                                           uint32_t tb, uint32_t ts) {
  constexpr int kParts = NARROW ? 2 : 1, kN = D / 2 / kParts;
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
    float part[kN];
    wgmma_fence();
    if constexpr (NARROW) {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t at = 32 * 128 * h + 32 * kk;
        mma_m64n32k8_rs_tf32(part, small[kk], desc(tb + at), kk);
        mma_m64n32k8_rs_tf32(part, big[kk], desc(ts + at), 1);
        mma_m64n32k8_rs_tf32(part, big[kk], desc(tb + at), 1);
      }
    } else {
      product(part, big, small, tb, ts);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[kN * h + i] += part[i];
  }
}

// The warpgroup's 64 x 64 accumulator, this thread's rows r0 and r0 + 8
// (those below L), to out (at (b, h))
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 2], int r0,
                                           int L, int64_t row) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= L) continue;
    float* p = out + r * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

// A block's kept rows. A full block (HALF false: block t of its launch is
// tile t) keeps 128 rows, a consumer warpgroup on each 64, and gives every
// streamed tile to both; a half block (HALF: blocks 2 i and 2 i + 1 of
// theirs are the halves of tile full + i) keeps 64, both warpgroups on
// them, warpgroup wg taking the streamed tiles j = wg mod 2. Tile t is
// (b*h t / tiles, rows BM (t % tiles)..). launch_dq / launch_dkv launch
// the full blocks, whole waves of one block an SM, then the tiles of a last
// wave that would fill half the SMs or less as half blocks, in half the
// time.
template <bool HALF>
struct Block {
  static constexpr int kStep = HALF ? 2 : 1;
  // lane 0 of each warp of the warpgroups that consume a tile
  static constexpr uint32_t kConsumers = HALF ? 4 : 4 * NWG;
  int bh, r0;
  __device__ Block(int tiles, int full) {
    const int t = HALF ? full + (blockIdx.x >> 1) : blockIdx.x;
    bh = t / tiles;
    r0 = (t % tiles) * BM + (HALF ? 64 * (blockIdx.x & 1) : 0);
  }
  // consumer warpgroup wg's first kept row and first streamed tile
  __device__ int rows(int wg) const { return r0 + (HALF ? 0 : 64 * wg); }
  static __device__ int first(int wg) { return HALF ? wg : 0; }
};

// Turns in a full block (named barriers 4 and 5): warpgroup wg waits for
// its turn before it issues a tile's scores and gives the other its turn
// after, so that one's softmax tends to run under the other's products;
// warpgroup 1 gives warpgroup 0 its first turn, and none after its last
// tile, which no one would take
__device__ __forceinline__ void first_turn(int wg) {
  if (wg == 1) named_arrive(4, 256);
}
__device__ __forceinline__ void take_turn(int wg) { named_sync(4 + wg, 256); }
__device__ __forceinline__ void give_turn(int wg, bool last) {
  if (wg == 0 || !last) named_arrive(5 - wg, 256);
}

// In a half block warpgroup 1 hands its sums over to warpgroup 0 through
// shared memory at x (one of warpgroup 1's own small planes, free once its
// products are done: float i of a thread at x + 4 (128 i + thread)), across
// named barrier 4 of the two, and warpgroup 0 adds them to its own: the
// even tiles' sum plus the odd tiles', in that order, so two launches give
// the same bits. Which warpgroup a thread is in is read from threadIdx
// again, so that nothing is kept live through the loop for it (dkv's
// consumers have no register to spare).
__device__ __forceinline__ bool second_warpgroup() {
  return threadIdx.x >= 256;
}
template <int N>
__device__ __forceinline__ void hand_over(const float (&acc)[N], uint32_t x) {
  x += 4 * (threadIdx.x & 127);
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(x + 512 * i), "f"(acc[i])
                 : "memory");
}
template <int N>
__device__ __forceinline__ void take_over(float (&acc)[N], uint32_t x) {
  x += 4 * (threadIdx.x & 127);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float y;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(y) : "r"(x + 512 * i)
                 : "memory");
    acc[i] += y;
  }
}

// One block (Block): its q rows of b*h. The producer keeps the raw ring
// STAGES tiles of BN keys ahead (K and V by TMA) and makes of each loaded
// tile K big and small, V big and small, and K^T big and small in the
// operand ring. Consumer wg keeps Q and dO of its 64 q rows (big terms in
// registers, small terms in shared memory), computes di =
// rowsum(dO O) of its rows from the same loads and writes it for the dkv
// kernel, and per tile: S = Q K^T and dP = dO V^T (three passes each), P
// and dS in place in the accumulator registers (log2 units), then dq's
// partial dS K from zero (dS as A from registers, K^T the B), which joins
// the running dq by one fp32 add.
template <bool HALF>
__global__ void __launch_bounds__(NT, 1)
    flash_dq_d64(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ q, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dq,
                 float* __restrict__ di, int L, int H, float scale, int tiles,
                 int full) {
  extern __shared__ unsigned char smem_dq64[];
  // per stage: loaded (TMA), ready (operands made), empty (consumed)
  __shared__ __align__(8) uint64_t bars[3 * STAGES];
  const uint32_t s0 = (smem_u32(smem_dq64) + 1023) & ~1023u;
  unsigned char* const p0 = smem_dq64 + (s0 - smem_u32(smem_dq64));
  const uint32_t op0 = s0 + STAGES * kRaw;
  const uint32_t kept0 = op0 + STAGES * kDqOp;
  // an operand stage: K big, K small, V big, V small, K^T big, K^T small
  constexpr uint32_t kKb = 0, kKs = kPlane, kVb = 2 * kPlane,
                     kVs = 3 * kPlane, kKTb = 4 * kPlane,
                     kKTs = 4 * kPlane + kTPlane;
  const uint32_t b0 = smem_u32(bars);
  auto loaded = [&](int s) { return b0 + 8 * s; };
  auto ready = [&](int s) { return b0 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return b0 + 8 * (2 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Block<HALF> blk(tiles, full);
  const int bh = blk.bh, b = bh / H, h = bh % H;
  const int nk = (L + BN - 1) / BN;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(ready(s), 4);  // lane 0 of each producer warp
      mbar_init(empty(s), Block<HALF>::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: thread 0 keeps the loads STAGES tiles ahead; the
    // warpgroup makes the operands in the 128-byte swizzle
    setmaxnreg_dec<kDqProducerRegs>();
    const int tid = threadIdx.x;
    auto load = [&](int j) {
      const int s = j % STAGES;
      const uint32_t raw = s0 + s * kRaw;
      mbar_expect_tx(loaded(s), kRaw);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        tma_load_4d(raw + half * kSAtom, &tk, loaded(s), 32 * half, h,
                    j * BN, b);
        tma_load_4d(raw + kPlane + half * kSAtom, &tv, loaded(s), 32 * half,
                    h, j * BN, b);
      }
    };
    if (tid == 0)
      for (int j = 0; j < STAGES && j < nk; ++j) load(j);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      const uint32_t round = (j / STAGES) & 1;
      const unsigned char* raw = p0 + s * kRaw;
      unsigned char* const op = p0 + STAGES * kRaw + s * kDqOp;
      mbar_wait(loaded(s), round);
      mbar_wait(empty(s), round ^ 1);  // round 0 passes
      split_tile<true>(raw, op + kKb, op + kKs, op + kKTb, op + kKTs, tid);
      split_tile<false>(raw + kPlane, op + kVb, op + kVs, nullptr, nullptr,
                        tid);
      // the writes seen by wgmma; the reads of the loaded tiles done before
      // TMA refills them
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ready(s));
      named_sync(1, 128);  // the producer warpgroup (ids 2, 3: consumers)
      if (tid == 0 && j + STAGES < nk) load(j + STAGES);
    }
    return;
  }

  setmaxnreg_inc<kDqConsumerRegs>();
  const int wg = (warp >> 2) - 1;  // consumer 0 or 1
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;  // scores in log2 units, for exp2
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const int r0 = blk.rows(wg) + 16 * w + g;  // rows r0 (half 0), r0 + 8 (1)
  const int rw = 16 * w + g;                 // r0's row in the warpgroup

  // Q and dO split once (big terms in registers, small terms in shared
  // memory); di of rows r0 and r0 + 8 from the lane's 16 values of dO and
  // O of each and its quad's
  uint32_t qb[D / 8][4], dob[D / 8][4];
  unsigned char* const qs = p0 + (kept0 - s0) + wg * kKept;
  unsigned char* const dos = qs + NWG * kKept;
  float lse2[2], dir[2];
  {
    float x[D / 8][4];
    load_kept(q + base, r0, rw, L, row, qb, qs, x);
    load_kept(dout + base, r0, rw, L, row, dob, dos, x);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
        const float ov = rr < L ? o[base + rr * row + col] : 0.f;
        sum[i & 1] = fmaf(x[kk][i], ov, sum[i & 1]);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      const int r = r0 + 8 * half;
      const bool in = r < L;
      lse2[half] = in ? lse[rbase + r] * kLog2e : 0.f;
      dir[half] = in ? sum[half] : 0.f;
      if (in && t == 0 && (!HALF || wg == 0)) di[rbase + r] = sum[half];
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);  // the warpgroup's small terms are written
  const uint32_t qsa = smem_u32(qs), dosa = smem_u32(dos);

  float acc[D / 2];  // dq[64 rows][64]: acc[4 n + i], n-tile n = columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if constexpr (!HALF) first_turn(wg);
  // (the loop's bound is L, a parameter, not nk: dkv's consumers have no
  // register to spare, and the two kernels keep one form)
  for (int j = blk.first(wg); j * BN < L; j += Block<HALF>::kStep) {
    const int s = j % STAGES, k0 = j * BN;
    const uint32_t st = op0 + s * kDqOp;
    mbar_wait(ready(s), (j / STAGES) & 1);

    // S = Q K^T and dP = dO V^T, 64 x BN each: sc[4 n + i] holds keys
    // k0 + 8 n..
    float sc[BN / 2], dp[BN / 2];
    if constexpr (!HALF) take_turn(wg);
    wgmma_fence();
    scores(sc, qsa, qb, st + kKb, st + kKs);
    scores(dp, dosa, dob, st + kVb, st + kVs);
    wgmma_commit();
    if constexpr (!HALF) give_turn(wg, (j + 1) * BN >= L);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = 2^(S c - lse2), 0 on a key past L (its K row is zero, but P need
    // not be 0 there); dS / scale = P (dP - di), in place of dP: scale (1/8,
    // a power of two) multiplies dq once at the end, which gives the bits of
    // P (dP scale - di scale) with a register fewer in the loop
    const bool tail = k0 + BN > L;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int half = i >> 1;
        float p = exp2f(fmaf(sc[4 * n + i], c, -lse2[half]));
        if (tail && k0 + 8 * n + 2 * t + (i & 1) >= L) p = 0.f;
        dp[4 * n + i] = p * (dp[4 * n + i] - dir[half]);
      }

    // dq += dS K over the tile's keys, through a partial
    uint32_t big[BN / 8][4], small[BN / 8][4];
    terms(dp, big, small);
    accumulate<false>(acc, big, small, st + kKTb, st + kKTs);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  if constexpr (HALF) {  // through warpgroup 1's Q small plane
    const uint32_t x = kept0 + kKept;
    if (second_warpgroup()) hand_over(acc, x);
    named_sync(4, 256);  // the two consumer warpgroups
    if (second_warpgroup()) return;
    take_over(acc, x);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= scale;
  store_rows(dq + base, acc, r0, L, row);
}

// One block (Block): its keys of b*h. The producer keeps the raw ring
// STAGES tiles of BN q rows ahead (Q and dO by TMA; their rows'
// lse and di by 4-byte cp.async from warp 0's lanes, which a [B*H, L] row
// needs: it is not 16-byte aligned at every L, and the stage's barrier
// tracks them) and makes of each loaded tile Q and dO big and small, their
// transposes big and small, and lse log2(e) and di. Consumer wg
// keeps K and V of its 64 keys (big terms in registers, small terms in
// shared memory) and per tile: S^T = K Q^T and dP^T = V dO^T (keys as
// rows), P^T and dS^T in place, then dv's partial P^T dO and dk's partial
// dS^T Q from zero, each joining its running sum by one fp32 add. A q row
// past L lands as zeros (Q, dO, lse, di), so P^T = 1 and dS^T = 0 there,
// and its products with dO^T = 0 and Q^T = 0 add exact zeros: no test.
template <bool HALF>
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_d64(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dk,
                  float* __restrict__ dv, int L, int H, float scale,
                  int tiles, int full) {
  extern __shared__ unsigned char smem_dkv64[];
  __shared__ __align__(8) uint64_t bars[3 * STAGES];
  const uint32_t s0 = (smem_u32(smem_dkv64) + 1023) & ~1023u;
  unsigned char* const p0 = smem_dkv64 + (s0 - smem_u32(smem_dkv64));
  const uint32_t op0 = s0 + STAGES * kRaw;
  const uint32_t kept0 = op0 + STAGES * kDkvOp;
  // the rows' lse and di as loaded, then as the operands' stages take them:
  // [STAGES][lse, di][BN] each
  const uint32_t raw_rows = kept0 + 2 * NWG * kKept;
  const uint32_t op_rows = raw_rows + kRows;
  // an operand stage: Q big, Q small, dO big, dO small, Q^T big, Q^T
  // small, dO^T big, dO^T small
  constexpr uint32_t kQb = 0, kQs = kPlane, kDb = 2 * kPlane,
                     kDs = 3 * kPlane, kQTb = 4 * kPlane,
                     kQTs = 4 * kPlane + kTPlane,
                     kDTb = 4 * kPlane + 2 * kTPlane,
                     kDTs = 4 * kPlane + 3 * kTPlane;
  const uint32_t b0 = smem_u32(bars);
  auto loaded = [&](int s) { return b0 + 8 * s; };
  auto ready = [&](int s) { return b0 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return b0 + 8 * (2 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Block<HALF> blk(tiles, full);
  const int bh = blk.bh, b = bh / H, h = bh % H;
  const int nq = (L + BN - 1) / BN;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrival and warp 0's 32 lse / di copies
      mbar_init(loaded(s), 1 + 32);
      mbar_init(ready(s), 4);
      mbar_init(empty(s), Block<HALF>::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    setmaxnreg_dec<kDkvProducerRegs>();
    const int tid = threadIdx.x;
    // by warp 0: lane 0 the TMA loads, every lane the lse and di of
    // stage row `lane` (4 bytes each, zero past L)
    auto load = [&](int j) {
      const int s = j % STAGES;
      const uint32_t raw = s0 + s * kRaw;
      if (lane == 0) {
        mbar_expect_tx(loaded(s), kRaw);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(raw + half * kSAtom, &tq, loaded(s), 32 * half, h,
                      j * BN, b);
          tma_load_4d(raw + kPlane + half * kSAtom, &tdo, loaded(s),
                      32 * half, h, j * BN, b);
        }
      }
      const int r = j * BN + lane;
      const bool in = r < L;
      const uint32_t at = raw_rows + s * 2 * BN * 4 + 4 * lane;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(at),
                   "l"(lse + rbase + (in ? r : 0)), "r"(in ? 4 : 0)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       at + 4 * BN),
                   "l"(di + rbase + (in ? r : 0)), "r"(in ? 4 : 0)
                   : "memory");
      cp_async_mbar_arrive(loaded(s));
    };
    if (warp == 0)
      for (int j = 0; j < STAGES && j < nq; ++j) load(j);
    for (int j = 0; j < nq; ++j) {
      const int s = j % STAGES;
      const uint32_t round = (j / STAGES) & 1;
      const unsigned char* raw = p0 + s * kRaw;
      unsigned char* const op = p0 + STAGES * kRaw + s * kDkvOp;
      mbar_wait(loaded(s), round);
      mbar_wait(empty(s), round ^ 1);  // round 0 passes
      split_tile<true>(raw, op + kQb, op + kQs, op + kQTb, op + kQTs, tid);
      split_tile<true>(raw + kPlane, op + kDb, op + kDs, op + kDTb,
                       op + kDTs, tid);
      if (warp == 0) {  // lse log2(e) and di of stage row `lane`
        const float* from =
            reinterpret_cast<const float*>(p0 + (raw_rows - s0)) +
            s * 2 * BN;
        float* to = reinterpret_cast<float*>(p0 + (op_rows - s0)) + s * 2 * BN;
        to[lane] = from[lane] * kLog2e;
        to[BN + lane] = from[BN + lane];
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ready(s));
      named_sync(1, 128);
      if (warp == 0 && j + STAGES < nq) load(j + STAGES);
    }
    return;
  }

  setmaxnreg_inc<kDkvConsumerRegs>();
  const int wg = (warp >> 2) - 1;  // consumer 0 or 1
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int r0 = blk.rows(wg) + 16 * w + g;
  const int rw = 16 * w + g;

  uint32_t kb[D / 8][4], vb[D / 8][4];
  unsigned char* const ks = p0 + (kept0 - s0) + wg * kKept;
  unsigned char* const vs = ks + NWG * kKept;
  {
    float x[D / 8][4];
    load_kept(k + base, r0, rw, L, row, kb, ks, x);
    load_kept(v + base, r0, rw, L, row, vb, vs, x);
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  const uint32_t ksa = smem_u32(ks), vsa = smem_u32(vs);

  float acc_k[D / 2], acc_v[D / 2];  // dk, dv [64 keys][64]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  if constexpr (!HALF) first_turn(wg);
  for (int j = blk.first(wg); j * BN < L; j += Block<HALF>::kStep) {
    const int s = j % STAGES;
    const uint32_t st = op0 + s * kDkvOp;
    mbar_wait(ready(s), (j / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x BN q rows
    float sc[BN / 2], dp[BN / 2];
    if constexpr (!HALF) take_turn(wg);
    wgmma_fence();
    scores(sc, ksa, kb, st + kQb, st + kQs);
    scores(dp, vsa, vb, st + kDb, st + kDs);
    wgmma_commit();
    if constexpr (!HALF) give_turn(wg, (j + 1) * BN >= L);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // column 8 n + 2 t + e is the stage's q row 8 n + 2 t + e: P^T =
    // 2^(S^T c - lse2), dS^T / scale = P^T (dP^T - di), in place (as in dq,
    // scale multiplies dk at the end)
    const uint32_t rows = op_rows + s * 2 * BN * 4;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const uint32_t col = 4 * (8 * n + 2 * t);
      float2 l2, d2;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(l2.x), "=f"(l2.y)
                   : "r"(rows + col));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(d2.x), "=f"(d2.y)
                   : "r"(rows + 4 * BN + col));
      const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i & 1;
        const float p = exp2f(fmaf(sc[4 * n + i], c, -lc[e]));
        sc[4 * n + i] = p;
        dp[4 * n + i] = p * (dp[4 * n + i] - dc[e]);
      }
    }

    // dv += P^T dO, then dk += dS^T Q, each through a partial; one at a
    // time, so that one partial and one set of terms are live (with two,
    // the consumers would spill), in half blocks each in two halves of d
    uint32_t big[BN / 8][4], small[BN / 8][4];
    terms(sc, big, small);
    accumulate<HALF>(acc_v, big, small, st + kDTb, st + kDTs);
    terms(dp, big, small);
    accumulate<HALF>(acc_k, big, small, st + kQTb, st + kQTs);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  if constexpr (HALF) {  // through warpgroup 1's K and V small planes
    const uint32_t x = kept0 + kKept, y = kept0 + (NWG + 1) * kKept;
    if (second_warpgroup()) {
      hand_over(acc_k, x);
      hand_over(acc_v, y);
    }
    named_sync(4, 256);  // the two consumer warpgroups
    if (second_warpgroup()) return;
    take_over(acc_k, x);
    take_over(acc_v, y);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] *= scale;
  store_rows(dk + base, acc_k, r0, L, row);
  store_rows(dv + base, acc_v, r0, L, row);
}

std::atomic<bool> dq_prepared[2][kMaxDevices];
std::atomic<bool> dkv_prepared[2][kMaxDevices];

// The tiles of a launch (Block): `tiles` 128-row tiles a b*h, the first
// `full` of them in full blocks (whole waves), the last `halves` (a last
// wave that would fill half the SMs or less) in two half blocks each
struct Grid {
  int tiles, full, halves;
};
cudaError_t grid_of(int B, int L, int H, Grid* g) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  g->tiles = (L + BM - 1) / BM;
  const int n = g->tiles * B * H, rem = n % sms;
  g->halves = rem > 0 && 2 * rem <= sms ? rem : 0;
  g->full = n - g->halves;
  return cudaSuccess;
}

// The kernel pair (full blocks, half blocks) checked (launch_regs, once) and
// given its shared memory (once a device), then `launch(kernel, blocks)`
// for each of the grid's two launches that has blocks
template <typename Kernel, typename Launch>
cudaError_t launch_grid(const Kernel (&kernels)[2], int smem,
                        std::atomic<bool> (&prepared)[2][kMaxDevices],
                        const cudaError_t (&regs)[2], const Grid& g,
                        Launch launch) {
  for (int half = 0; half < 2; ++half) {
    if (regs[half] != cudaSuccess) return regs[half];
    const cudaError_t err =
        prepare_on_device(kernels[half], smem, prepared[half]);
    if (err != cudaSuccess) return err;
  }
  if (g.full > 0) {
    launch(kernels[0], g.full);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (g.halves > 0) launch(kernels[1], 2 * g.halves);
  return cudaGetLastError();
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  using Kernel = decltype(&flash_dq_d64<false>);
  static const Kernel kernels[2] = {flash_dq_d64<false>, flash_dq_d64<true>};
  static const cudaError_t regs[2] = {launch_regs(kernels[0], kLaunchRegs),
                                      launch_regs(kernels[1], kLaunchRegs)};
  Grid g;
  err = grid_of(B, L, H, &g);
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, false, B, L, H, D, 32, BN) ||
      !tensor_map(&tv, v, false, B, L, H, D, 32, BN))
    return cudaErrorInvalidValue;
  return launch_grid(kernels, kDqSmemBytes, dq_prepared, regs, g,
                     [&](Kernel kernel, int blocks) {
    kernel<<<blocks, NT, kDqSmemBytes, stream>>>(
        tk, tv, static_cast<const float*>(q), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, static_cast<float*>(dq), di,
        L, H, scale, g.tiles, g.full);
  });
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  using Kernel = decltype(&flash_dkv_d64<false>);
  static const Kernel kernels[2] = {flash_dkv_d64<false>,
                                    flash_dkv_d64<true>};
  static const cudaError_t regs[2] = {launch_regs(kernels[0], kLaunchRegs),
                                      launch_regs(kernels[1], kLaunchRegs)};
  Grid g;
  err = grid_of(B, L, H, &g);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tdo;
  if (!tensor_map(&tq, q, false, B, L, H, D, 32, BN) ||
      !tensor_map(&tdo, dout, false, B, L, H, D, 32, BN))
    return cudaErrorInvalidValue;
  return launch_grid(kernels, kDkvSmemBytes, dkv_prepared, regs, g,
                     [&](Kernel kernel, int blocks) {
    kernel<<<blocks, NT, kDkvSmemBytes, stream>>>(
        tq, tdo, static_cast<const float*>(k), static_cast<const float*>(v),
        lse, di, static_cast<float*>(dk), static_cast<float*>(dv), L, H,
        scale, g.tiles, g.full);
  });
}

}  // namespace d64

// fp32 at d = 512 on TF32 wgmma, each product as three passes (header). One
// cluster of CL blocks along d takes one 64-row kept tile of one b*h (q rows
// in dq, keys in dkv): cluster blockIdx.x / CL, b*h blockIdx.y; block `rank`
// owns d 64 rank.. of every tensor, the d = 64 kernels' tile, which d64::'s
// pieces take. Three warpgroups a block: warpgroup 0 the producer (its
// four warps split the loaded tiles) and two consumers on the same 64 kept
// rows, consumer kh taking the streamed tiles j with j % 2 = kh, each with
// its own sums, which add at the end, the even tiles' first. Tile j's raw
// tiles and small planes (the scores' B) sit in slot j % SS of the score
// ring, its transposed planes (the products' B) in slot j % 2 of the
// product ring; the consumers take turns at one exchange area, in tile
// order.
namespace d512 {

using namespace rdeic_flash::hopper;
constexpr int D = 512, CL = 8, DC = D / CL, BM = 64, BN = d64::BN, NT = 384;
static_assert(DC == d64::D, "a block's slice is the d = 64 kernels' tile");
constexpr float kLog2e = 1.4426950408889634f;
// registers: the launch's (65536 over 384 threads, to 8), then moved by
// setmaxnreg from the producer to the consumers (launch_dq / launch_dkv
// refuse another launch count: setmaxnreg.inc waits for registers its own
// block freed)
constexpr int kLaunchRegs = 168;
constexpr int kDqProducerRegs = 56, kDqConsumerRegs = 224;
constexpr int kDkvProducerRegs = 56, kDkvConsumerRegs = 224;
static_assert(kLaunchRegs == ((65536 / NT) & ~7), "one block an SM");
static_assert(128 * kDqProducerRegs + 256 * kDqConsumerRegs <=
                      NT * kLaunchRegs &&
                  128 * kDkvProducerRegs + 256 * kDkvConsumerRegs <=
                      NT * kLaunchRegs,
              "registers per block");
constexpr uint32_t kSAtom = d64::kSAtom, kPlane = d64::kPlane,
                   kTPlane = d64::kTPlane, kKept = d64::kKept;
// A score slot: the two streamed tensors' BN x 64 tiles as TMA lands them
// (raw: wgmma reads an fp32 operand truncated to TF32, so a raw tile is its
// own big term) and their small terms (x - trunc(x)); a product slot: the
// transposed planes, big (the values) and small, of the tensors that are a
// product's B: K^T in dq; Q^T and dO^T in dkv
constexpr uint32_t kRawA = 0, kRawB = kPlane, kSmallA = 2 * kPlane,
                   kSmallB = 3 * kPlane, kScore = 4 * kPlane;  // 32 KB
constexpr uint32_t kDqTrans = 2 * kTPlane, kDkvTrans = 4 * kTPlane;
constexpr int kDqScoreSlots = 3, kDkvScoreSlots = 3, kTransSlots = 2;
// the producer's four warps split: the first SMALL make the small planes,
// the rest the transposed ones, each group at its own pace
constexpr int kDqSmallWarps = 2, kDkvSmallWarps = 2;
// The exchange of a tile's partial S and dP (exchange), one area that the
// consumers take in turns: a lane's piece u is 16 bytes, a warp's 512, a
// block's (the consumer's four warps) a 2 KB slot; `parts` [CL][kSlot]
// (the pieces this block reduces, from each block) and `sums` [CL] of the
// pieces reduced by each block, as P and dS (16 bytes a lane: dkv) or dS
// (8: dq)
constexpr uint32_t kSlot = 4 * 32 * 16, kArea = CL * kSlot;
constexpr uint32_t kDqSumArea = CL * 4 * 32 * 8, kDkvSumArea = kArea;
// dkv: the streamed rows' lse and di as cp.async lands them, [lse, di][BN]
// a score slot; dq's blocks' partial di of the 64 rows ([CL][BM]) take the
// sums area before the first exchange
constexpr uint32_t kRowBytes = 2 * BN * 4, kDiBytes = CL * BM * 4;
static_assert(kDiBytes <= kDqSumArea, "di in the sums area");
// from a 1024-byte-aligned base: the score ring, the product ring, the
// kept small planes (Q and dO; K and V), the parts and sums areas (dkv:
// then the rows)
constexpr uint32_t kTrans0Dq = kDqScoreSlots * kScore,
                   kTrans0Dkv = kDkvScoreSlots * kScore;
constexpr uint32_t kKept0Dq = kTrans0Dq + kTransSlots * kDqTrans,
                   kKept0Dkv = kTrans0Dkv + kTransSlots * kDkvTrans;
constexpr int kDqSmemBytes = 1024 + kKept0Dq + 2 * kKept + kArea + kDqSumArea;
constexpr int kDkvSmemBytes = 1024 + kKept0Dkv + 2 * kKept + kArea +
                              kDkvSumArea + kDkvScoreSlots * kRowBytes;
static_assert(kDqSmemBytes <= 232448 - 256 && kDkvSmemBytes <= 232448 - 256,
              "shared memory per block (and the barriers)");
// the merge's hand-over (d64::hand_over: 128 threads x N floats, two in
// dkv) in score slot 0
static_assert(2 * 128 * (DC / 2) * 4 <= kScore, "the merge's scratch");

// The barriers: per score slot s, loaded (TMA, and in dkv a warp's 32
// rows copies), sready (the small planes made), sfree (done with by the
// consumer's four warps: in dq after their scores, in dkv after their
// exchange, which reads the rows) and rawfree (the raw tiles read by the
// transposed split); per
// product slot p, tready (made) and tfree (done with by the products); per
// consumer warp w, got_parts (the other blocks' pieces that this block
// reduces) and got_sum (the pieces the other blocks reduced); dq's got_di
// (every block's partial di)
struct Bars {
  uint32_t b0;
  __device__ uint32_t loaded(int s) const { return b0 + 8 * s; }
  __device__ uint32_t sready(int s) const { return b0 + 8 * (4 + s); }
  __device__ uint32_t sfree(int s) const { return b0 + 8 * (8 + s); }
  __device__ uint32_t rawfree(int s) const { return b0 + 8 * (12 + s); }
  __device__ uint32_t tready(int p) const { return b0 + 8 * (16 + p); }
  __device__ uint32_t tfree(int p) const { return b0 + 8 * (18 + p); }
  __device__ uint32_t got_parts(int w) const { return b0 + 8 * (20 + w); }
  __device__ uint32_t got_sum(int w) const { return b0 + 8 * (24 + w); }
  __device__ uint32_t got_di() const { return b0 + 8 * 28; }
};
constexpr int kBars = 29;

// The barriers of SS score slots set (thread 0), `loaded` expecting
// `loaded_count` arrivals, and seen by the whole cluster before any block
// arrives on another's
template <int SS, int SMALL>
__device__ __forceinline__ void init_bars(const Bars& bar, int loaded_count) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SS; ++s) {
      mbar_init(bar.loaded(s), loaded_count);
      // lane 0 of each splitting warp of the group, of each consumer warp
      mbar_init(bar.sready(s), SMALL);
      mbar_init(bar.sfree(s), 4);
      mbar_init(bar.rawfree(s), 4 - SMALL);
    }
#pragma unroll
    for (int p = 0; p < kTransSlots; ++p) {
      mbar_init(bar.tready(p), 4 - SMALL);
      mbar_init(bar.tfree(p), 4);
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // one arrival (the warp's own expect_tx) and the other blocks' bytes
      mbar_init(bar.got_parts(w), 1);
      mbar_init(bar.got_sum(w), 1);
    }
    mbar_init(bar.got_di(), 1);
    fence_barrier_init();
  }
  cluster_arrive();
  cluster_wait();
}

// x - trunc(x) of each value: the small term of the split whose big term is
// x as the tensor core reads it (its TF32 bits, truncated); exact in fp32
__device__ __forceinline__ float4 small4(float4 x) {
  auto small = [](float v) {
    return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  };
  return make_float4(small(x.x), small(x.y), small(x.z), small(x.w));
}

// Thread tid's share (of WARPS splitting warps) of a loaded BN x 64 tile
// `raw` (two atoms as TMA writes them; lane = streamed row, chunk c = d
// 4c..4c + 3): its small plane, in the same layout
template <int WARPS>
__device__ __forceinline__ void small_plane(const unsigned char* raw,
                                            unsigned char* small, int tid) {
  const int lane = tid & 31;
#pragma unroll 2
  for (int c = tid >> 5; c < DC / 4; c += WARPS) {
    const uint32_t at = (c >> 3) * kSAtom + swizzle128(lane, 16 * (c & 7));
    *reinterpret_cast<float4*>(small + at) =
        small4(*reinterpret_cast<const float4*>(raw + at));
  }
}

// ... and its transposed planes, big (the values) and small: d as the rows,
// the streamed rows along them in d64::slot_of's order. Every read and
// write of both hits 32 banks (tests/test_torch_port_flash_bwd_d512_fp32.py)
template <int WARPS>
__device__ __forceinline__ void trans_planes(const unsigned char* raw,
                                             unsigned char* tbig,
                                             unsigned char* tsmall, int tid) {
  const int lane = tid & 31;
  const uint32_t slot = d64::slot_of(lane);
#pragma unroll 2
  for (int c = tid >> 5; c < DC / 4; c += WARPS) {
    const float4 x = *reinterpret_cast<const float4*>(
        raw + (c >> 3) * kSAtom + swizzle128(lane, 16 * (c & 7)));
    const float4 s = small4(x);
    const float bv[4] = {x.x, x.y, x.z, x.w}, sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t t_at = swizzle128(4 * c + e, 4 * slot);
      *reinterpret_cast<float*>(tbig + t_at) = bv[e];
      *reinterpret_cast<float*>(tsmall + t_at) = sv[e];
    }
  }
}

// The splitters (the producer's warps), two groups at their own pace: the
// first SMALL warps make both tensors' small planes of each loaded tile in
// its score slot (sready), the others, once the product slot's last
// products are done, the transposed planes of its first NTRANS tensors
// (tready; rawfree for its score slot). `trans` bytes a product slot;
// product slots from p0 + trans0
template <int NTRANS, int SS, int SMALL>
__device__ __forceinline__ void split_tiles(unsigned char* p0,
                                            uint32_t trans0, uint32_t trans,
                                            const Bars& bar, int nk) {
  const int ws = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool small = ws < SMALL;
  const int tid = threadIdx.x - (small ? 0 : 32 * SMALL);
  for (int j = 0; j < nk; ++j) {
    const int s = j % SS, p = j % kTransSlots;
    unsigned char* const st = p0 + s * kScore;
    mbar_wait(bar.loaded(s), (j / SS) & 1);
    if (small) {
      small_plane<SMALL>(st + kRawA, st + kSmallA, tid);
      small_plane<SMALL>(st + kRawB, st + kSmallB, tid);
    } else {
      // round 0 passes
      mbar_wait(bar.tfree(p), ((j / kTransSlots) & 1) ^ 1);
      unsigned char* const tp = p0 + trans0 + p * trans;
#pragma unroll
      for (int x = 0; x < NTRANS; ++x)
        trans_planes<4 - SMALL>(st + x * kPlane, tp + 2 * x * kTPlane,
                                tp + (2 * x + 1) * kTPlane, tid);
    }
    // the writes seen by wgmma, the raw tiles read before TMA refills them
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      if (small) {
        mbar_arrive(bar.sready(s));
      } else {
        mbar_arrive(bar.tready(p));
        mbar_arrive(bar.rawfree(s));
      }
    }
  }
}

// The load (one thread) of tile j of the two streamed tensors into score
// slot j % SS: by the producer for the first SS tiles; then by the consumer
// of tile j - SS, once its four warps are done with the slot and the
// transposed split with its raw tiles (refill)
template <int SS>
__device__ __forceinline__ void load_tile(uint32_t st, const Bars& bar,
                                          const CUtensorMap* ta,
                                          const CUtensorMap* tb, int j,
                                          int rank, int h, int b) {
  const int s = j % SS;
  mbar_expect_tx(bar.loaded(s), 2 * kPlane);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    tma_load_4d(st + kRawA + half * kSAtom, ta, bar.loaded(s),
                DC * rank + 32 * half, h, j * BN, b);
    tma_load_4d(st + kRawB + half * kSAtom, tb, bar.loaded(s),
                DC * rank + 32 * half, h, j * BN, b);
  }
}

// Whether the consumer of tile j refills its score slot with tile j + SS:
// its warp 0 does, once the consumer's four warps are done with the slot
// (sfree) and the transposed split with its raw tiles (rawfree)
template <int SS>
__device__ __forceinline__ bool refill(const Bars& bar, int j, int nk, int w) {
  if (w != 0 || j + SS >= nk) return false;
  const int s = j % SS;
  const uint32_t round = (j / SS) & 1;
  mbar_wait(bar.sfree(s), round);
  mbar_wait(bar.rawfree(s), round);
  return true;
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// A consumer warp's exchange areas and barriers
struct Exchange {
  uint32_t parts, sums, got_parts, got_sum;
};

// Turns (named barriers 2 and 3): consumer kh takes the exchange area for
// tile j once the other consumer is done with tile j - 1, and hands it back
// unless no tile follows
__device__ __forceinline__ void take_turn(int kh, int j) {
  if (j > 0) named_sync(2 + kh, 256);
}
__device__ __forceinline__ void give_turn(int kh, int j, int nk) {
  if (j + 1 < nk) named_arrive(3 - kh, 256);
}

// The cluster's CL partials of the consumer's 64 x BN S and dP (sc, dp:
// each block's over its 64 of d; sc[4 n + i] at row g + 8 (i >> 1), column
// 8 n + 2 t + (i & 1)) become, in every block, the same P and dS. Piece
// u = 4 hf + n of a lane is the two entries 4 n + 2 hf + e of S and of dP
// (n-tile n, row half hf): every lane pushes piece u to block u's parts
// slot [its rank] by st.async (a reduce-scatter: each block's every warp
// reduces one piece of each lane, so the work is even), the block adds the
// CL partials in rank order ((p0 + p1) + p2) ... + p7, `finish(sum, u)`
// forms P and dS of the two entries once (GATHER4: (P, P, dS, dS), pushed
// as 16 bytes; else (dS, dS), 8), and the block pushes them to every other
// block's sums slot [its rank] (an all-gather). Afterwards sc holds P and dp
// holds dS (dq: dp alone). The exchanges run in tile order (the turns), so
// `parity` is tile j's (j & 1), and a slot is written again only by a block
// that has received what its reader sent after reading it: one area of each
// suffices. A warp's 32 lanes write and read a slot's 512 (256) bytes
// whole: 32 banks.
template <bool GATHER4, typename Finish>
__device__ __forceinline__ void exchange(float (&sc)[BN / 2],
                                         float (&dp)[BN / 2],
                                         const Exchange& x, uint32_t parity,
                                         int rank, int w, int lane,
                                         Finish finish) {
  constexpr uint32_t kSum = GATHER4 ? 16 : 8;  // a lane's bytes of a sum
  const uint32_t mine = w * 512 + 16 * lane;
  const uint32_t sum_mine = w * 32 * kSum + kSum * lane;
  if (lane == 0) {
    mbar_expect_tx(x.got_parts, (CL - 1) * 512);
    mbar_expect_tx(x.got_sum, (CL - 1) * 32 * kSum);
  }
  float4 own = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < CL; ++u) {
    const int i = 4 * (u & 3) + 2 * (u >> 2);
    const float4 v = make_float4(sc[i], sc[i + 1], dp[i], dp[i + 1]);
    if (u == rank) {
      own = v;
    } else {
      const uint32_t to = static_cast<uint32_t>(u);
      st_async_v4(mapa(x.parts + rank * kSlot + mine, to), v,
                  mapa(x.got_parts, to));
    }
  }
  mbar_wait_cluster(x.got_parts, parity);
  float4 sum = own;
#pragma unroll
  for (int r = 0; r < CL; ++r) {
    const float4 v =
        r == rank ? own : ld_shared4(x.parts + r * kSlot + mine);
    if (r == 0) {
      sum = v;
    } else {
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
  }
  const float4 out = finish(sum, rank);
#pragma unroll
  for (int r = 0; r < CL; ++r) {
    if (r == rank) continue;
    const uint32_t to = static_cast<uint32_t>(r);
    const uint32_t at = mapa(x.sums + rank * 4 * 32 * kSum + sum_mine, to);
    if constexpr (GATHER4)
      st_async_v4(at, out, mapa(x.got_sum, to));
    else
      st_async_v2(at, make_float2(out.x, out.y), mapa(x.got_sum, to));
  }
  mbar_wait_cluster(x.got_sum, parity);
#pragma unroll
  for (int u = 0; u < CL; ++u) {
    const int i = 4 * (u & 3) + 2 * (u >> 2);
    const uint32_t at = x.sums + u * 4 * 32 * kSum + sum_mine;
    if constexpr (GATHER4) {
      const float4 v = u == rank ? out : ld_shared4(at);
      sc[i] = v.x, sc[i + 1] = v.y, dp[i] = v.z, dp[i + 1] = v.w;
    } else {
      const float2 v = u == rank ? make_float2(out.x, out.y) : ld_shared2(at);
      dp[i] = v.x, dp[i + 1] = v.y;
    }
  }
}

// One cluster: the 64 q rows q0.. of b*h (blockIdx.y), block `rank` on d
// 64 rank... Tile j of BN keys lands in score slot j % kDqScoreSlots (K and
// V by TMA, raw; the splitters make K and V small there and K^T big and
// small in product slot j % 2). Both consumers keep Q and dO of the
// block's d (big terms in registers, small terms in shared memory), and
// consumer j % 2 refills the slot of tile j with tile j + 3; consumer 0
// sums di over the block's d and pushes it to every block, and both add
// the CL partials in rank order (rank 0 writes di for the dkv kernel).
// Per tile j (consumer
// j % 2): this block's partial S = Q K^T and dP = dO V^T (three passes
// each), the exchange, which leaves dS / scale = P (dP - di) in dp (P =
// 2^(S c - lse2), log2 units, 0 on a key past L), then the partial dS K of
// its 64 columns of dq from zero (dS as A from registers, K^T the B), which
// joins the consumer's running dq by one fp32 add.
__global__ void __launch_bounds__(NT, 1)
    flash_dq_d512(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ q, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dq,
                  float* __restrict__ di, int L, int H, float scale) {
  constexpr int SS = kDqScoreSlots;
  extern __shared__ unsigned char smem_dq512[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const uint32_t s0 = (smem_u32(smem_dq512) + 1023) & ~1023u;
  unsigned char* const p0 = smem_dq512 + (s0 - smem_u32(smem_dq512));
  const uint32_t kept0 = s0 + kKept0Dq, x0 = kept0 + 2 * kKept;
  const uint32_t sums0 = x0 + kArea;
  const uint32_t dis = sums0;  // [CL][BM] partial di
  const Bars bar{smem_u32(bars)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int q0 = (blockIdx.x / CL) * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nk = (L + BN - 1) / BN;
  init_bars<SS, kDqSmallWarps>(bar, 1);

  if (warp < 4) {
    setmaxnreg_dec<kDqProducerRegs>();
    if (threadIdx.x == 0)
      for (int j = 0; j < SS && j < nk; ++j)
        load_tile<SS>(s0 + j * kScore, bar, &tk, &tv, j, rank, h, b);
    __syncwarp();
    split_tiles<1, SS, kDqSmallWarps>(p0, kTrans0Dq, kDqTrans, bar, nk);
    cluster_arrive();
  } else {
    setmaxnreg_inc<kDqConsumerRegs>();
    const int kh = (warp >> 2) - 1;  // consumer 0 or 1: tiles kh, kh + 2..
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const float c = scale * kLog2e;  // scores in log2 units, for exp2
    const int64_t row = static_cast<int64_t>(H) * D;
    const int64_t base = static_cast<int64_t>(b) * L * row +
                         static_cast<int64_t>(h) * D + DC * rank;
    const int64_t rbase = static_cast<int64_t>(bh) * L;
    const int rw = 16 * w + g;  // rows rw (half 0), rw + 8 (1) of the tile
    const int r0 = q0 + rw;

    // Q and dO split once (big terms in registers, small terms in shared
    // memory, which both consumers write alike); consumer 0's partial di
    // of rows r0 and r0 + 8 over the block's d, from the lane's values of
    // dO and O and its quad's, to every block's slot [rank]
    uint32_t qb[DC / 8][4], dob[DC / 8][4];
    unsigned char* const qs = p0 + (kept0 - s0);
    unsigned char* const dos = qs + kKept;
    {
      float x[DC / 8][4];
      d64::load_kept(q + base, r0, rw, L, row, qb, qs, x);
      d64::load_kept(dout + base, r0, rw, L, row, dob, dos, x);
      if (kh == 0) {
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < DC / 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
            const float ov = rr < L ? o[base + rr * row + col] : 0.f;
            sum[i & 1] = fmaf(x[kk][i], ov, sum[i & 1]);
          }
        if (w == 0 && lane == 0) mbar_expect_tx(bar.got_di(), kDiBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
          if (t == 0)
            for (int r = 0; r < CL; ++r)
              st_async_f32(
                  mapa(dis + 4 * (BM * rank + rw + 8 * half), r), sum[half],
                  mapa(bar.got_di(), static_cast<uint32_t>(r)));
        }
      }
    }
    fence_proxy_async();
    float lse2[2], dir[2];
    mbar_wait_cluster(bar.got_di(), 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r0 + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        float y;
        asm volatile("ld.shared.f32 %0, [%1];"
                     : "=f"(y)
                     : "r"(dis + 4 * (BM * r + rw + 8 * half))
                     : "memory");
        sum = r == 0 ? y : sum + y;
      }
      const bool in = rr < L;
      lse2[half] = in ? lse[rbase + rr] * kLog2e : 0.f;
      dir[half] = in ? sum : 0.f;
      if (in && rank == 0 && kh == 0 && t == 0) di[rbase + rr] = sum;
    }
    // the kept small planes are written, and di is read before the
    // exchanges take its area (both consumers)
    named_sync(1, 256);
    const uint32_t qsa = kept0, dosa = kept0 + kKept;

    const Exchange xc{x0, sums0, bar.got_parts(w), bar.got_sum(w)};
    float acc[DC / 2];  // dq[64 rows][64]: acc[4 n + i], columns 8 n..
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
    for (int j = kh; j < nk; j += 2) {
      const int s = j % SS, p = j % kTransSlots;
      const uint32_t round = (j / SS) & 1;
      const uint32_t st = s0 + s * kScore;
      const uint32_t tp = s0 + kTrans0Dq + p * kDqTrans;
      const int k0 = j * BN;
      // this block's S = Q K^T and dP = dO V^T over its d, 64 x BN each:
      // sc[4 m + i] holds keys k0 + 8 m..
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(bar.sready(s), round);
      wgmma_fence();
      d64::scores(sc, qsa, qb, st + kRawA, st + kSmallA);
      d64::scores(dp, dosa, dob, st + kRawB, st + kSmallB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.sfree(s));
      // dS / scale = P (dP - di) of a piece's two entries (scale
      // multiplies dq once at the end)
      take_turn(kh, j);
      exchange<false>(sc, dp, xc, j & 1, rank, w, lane,
                      [&](float4 v, int u) {
        const int half = u >> 2, col = k0 + 8 * (u & 3) + 2 * t;
        const float l2 = half ? lse2[1] : lse2[0];
        const float d_i = half ? dir[1] : dir[0];
        const float p0 = col < L ? exp2f(fmaf(v.x, c, -l2)) : 0.f;
        const float p1 = col + 1 < L ? exp2f(fmaf(v.y, c, -l2)) : 0.f;
        return make_float4(p0 * (v.z - d_i), p1 * (v.w - d_i), 0.f, 0.f);
      });
      give_turn(kh, j, nk);

      // dq += dS K over the tile's keys, through a partial
      uint32_t big[BN / 8][4], small[BN / 8][4];
      mbar_wait(bar.tready(p), (j / kTransSlots) & 1);
      if (refill<SS>(bar, j, nk, w) && lane == 0)
        load_tile<SS>(st, bar, &tk, &tv, j + SS, rank, h, b);
      __syncwarp();
      d64::terms(dp, big, small);
      d64::accumulate<false>(acc, big, small, tp, tp + kTPlane);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.tfree(p));
    }
    cluster_arrive();  // this block's exchanges are done

    // consumer 1 hands its sums to consumer 0 through score slot 0 (free
    // once both are done), which adds them to its own: the even tiles'
    // sum, then the odd tiles'
    const uint32_t hand = s0;
    named_sync(1, 256);
    if (kh == 1) d64::hand_over(acc, hand);
    named_sync(1, 256);
    if (kh == 0) {
      d64::take_over(acc, hand);
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) acc[i] *= scale;
      d64::store_rows(dq + base, acc, r0, L, row);
    }
  }
  // no block leaves while another may still write to its shared memory
  cluster_wait();
}

// One cluster: the 64 keys kv0.. of b*h (blockIdx.y), block `rank` on d
// 64 rank... Tile j of BN q rows lands in score slot j % kDkvScoreSlots
// (Q and dO by TMA, raw; their rows' lse and di by 4-byte cp.async from a
// warp's lanes, which a [B*H, L] row needs: it is not 16-byte aligned at
// every L; the splitters make Q and dO small there and Q^T and dO^T big
// and small in product slot j % 2). Both consumers keep K and V of the
// block's d (big terms in registers, small terms in shared memory) and per
// tile (consumer j % 2, which then refills its slot with tile j + 3):
// this block's partial S^T = K Q^T and dP^T = V dO^T (keys as rows), the
// exchange, which leaves P^T in sc and dS^T / scale in dp, then the
// partials dv = P^T dO and dk = dS^T Q of the block's 64 columns from
// zero, each joining its running sum by one fp32 add. A q row past L lands
// as zeros (Q, dO, lse, di), so P^T = 1 and dS^T = 0 there, and its
// products with dO^T = 0 and Q^T = 0 add exact zeros: no test.
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_d512(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int H, float scale) {
  constexpr int SS = kDkvScoreSlots;
  extern __shared__ unsigned char smem_dkv512[];
  __shared__ __align__(8) uint64_t bars[kBars];
  const uint32_t s0 = (smem_u32(smem_dkv512) + 1023) & ~1023u;
  unsigned char* const p0 = smem_dkv512 + (s0 - smem_u32(smem_dkv512));
  const uint32_t kept0 = s0 + kKept0Dkv, x0 = kept0 + 2 * kKept;
  const uint32_t sums0 = x0 + kArea;
  const uint32_t rows0 = sums0 + kDkvSumArea;  // [SS][lse, di][BN]
  const Bars bar{smem_u32(bars)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int kv0 = (blockIdx.x / CL) * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (L + BN - 1) / BN;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  // the TMA arrival and warp 0's 32 rows copies
  init_bars<SS, kDkvSmallWarps>(bar, 1 + 32);

  // tile j into score slot j % SS (load_tile) and lse and di of its row
  // `lane` (zero past L) into the slot's rows, by one warp
  auto load = [&](int j) {
    if (lane == 0)
      load_tile<SS>(s0 + (j % SS) * kScore, bar, &tq, &tdo, j, rank, h, b);
    const int r = j * BN + lane;
    const bool in = r < L;
    const uint32_t at = rows0 + (j % SS) * kRowBytes + 4 * lane;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(at),
                 "l"(lse + rbase + (in ? r : 0)), "r"(in ? 4 : 0)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     at + 4 * BN),
                 "l"(di + rbase + (in ? r : 0)), "r"(in ? 4 : 0)
                 : "memory");
    cp_async_mbar_arrive(bar.loaded(j % SS));
  };
  if (warp < 4) {
    setmaxnreg_dec<kDkvProducerRegs>();
    if (warp == 0)
      for (int j = 0; j < SS && j < nq; ++j) load(j);
    split_tiles<2, SS, kDkvSmallWarps>(p0, kTrans0Dkv, kDkvTrans, bar, nq);
    cluster_arrive();
  } else {
    setmaxnreg_inc<kDkvConsumerRegs>();
    const int kh = (warp >> 2) - 1;
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const float c = scale * kLog2e;
    const int64_t row = static_cast<int64_t>(H) * D;
    const int64_t base = static_cast<int64_t>(b) * L * row +
                         static_cast<int64_t>(h) * D + DC * rank;
    const int rw = 16 * w + g;
    const int r0 = kv0 + rw;

    uint32_t kb[DC / 8][4], vb[DC / 8][4];
    unsigned char* const ks = p0 + (kept0 - s0);
    unsigned char* const vs = ks + kKept;
    {
      float x[DC / 8][4];
      d64::load_kept(k + base, r0, rw, L, row, kb, ks, x);
      d64::load_kept(v + base, r0, rw, L, row, vb, vs, x);
    }
    fence_proxy_async();
    named_sync(1, 256);
    const uint32_t ksa = kept0, vsa = kept0 + kKept;

    const Exchange xc{x0, sums0, bar.got_parts(w), bar.got_sum(w)};
    float acc_k[DC / 2], acc_v[DC / 2];  // dk, dv [64 keys][64]
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    for (int j = kh; j < nq; j += 2) {
      const int s = j % SS, p = j % kTransSlots;
      const uint32_t round = (j / SS) & 1;
      const uint32_t st = s0 + s * kScore;
      const uint32_t tp = s0 + kTrans0Dkv + p * kDkvTrans;
      // S^T = K Q^T and dP^T = V dO^T over this block's d, 64 keys x BN q
      // rows
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(bar.loaded(s), round);  // the rows' lse and di too
      mbar_wait(bar.sready(s), round);
      wgmma_fence();
      d64::scores(sc, ksa, kb, st + kRawA, st + kSmallA);
      d64::scores(dp, vsa, vb, st + kRawB, st + kSmallB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // column 8 n + 2 t + e is the tile's q row 8 n + 2 t + e: P^T =
      // 2^(S^T c - lse log2(e)), dS^T / scale = P^T (dP^T - di) of a
      // piece's two entries (scale multiplies dk at the end)
      const uint32_t rows = rows0 + s * kRowBytes;
      take_turn(kh, j);
      exchange<true>(sc, dp, xc, j & 1, rank, w, lane,
                     [&](float4 x, int u) {
        const uint32_t col = 4 * (8 * (u & 3) + 2 * t);
        const float2 l2 = ld_shared2(rows + col);
        const float2 d2 = ld_shared2(rows + 4 * BN + col);
        const float p0 = exp2f(fmaf(x.x, c, -(l2.x * kLog2e)));
        const float p1 = exp2f(fmaf(x.y, c, -(l2.y * kLog2e)));
        return make_float4(p0, p1, p0 * (x.z - d2.x), p1 * (x.w - d2.y));
      });
      give_turn(kh, j, nq);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.sfree(s));  // the rows read too

      // dv += P^T dO, then dk += dS^T Q, each through a partial
      uint32_t big[BN / 8][4], small[BN / 8][4];
      mbar_wait(bar.tready(p), (j / kTransSlots) & 1);
      if (refill<SS>(bar, j, nq, w)) load(j + SS);
      d64::terms(sc, big, small);
      d64::accumulate<false>(acc_v, big, small, tp + 2 * kTPlane,
                             tp + 3 * kTPlane);
      d64::terms(dp, big, small);
      d64::accumulate<false>(acc_k, big, small, tp, tp + kTPlane);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.tfree(p));
    }
    cluster_arrive();

    // consumer 1 hands dk and dv to consumer 0 through score slot 0
    const uint32_t hand = s0;
    named_sync(1, 256);
    if (kh == 1) {
      d64::hand_over(acc_k, hand);
      d64::hand_over(acc_v, hand + 128 * (DC / 2) * 4);
    }
    named_sync(1, 256);
    if (kh == 0) {
      d64::take_over(acc_k, hand);
      d64::take_over(acc_v, hand + 128 * (DC / 2) * 4);
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) acc_k[i] *= scale;
      d64::store_rows(dk + base, acc_k, r0, L, row);
      d64::store_rows(dv + base, acc_v, r0, L, row);
    }
  }
  cluster_wait();
}

std::atomic<bool> dq_prepared[kMaxDevices];
std::atomic<bool> dkv_prepared[kMaxDevices];

// A launch of `blocks` blocks in clusters of CL along x, `smem` bytes of
// dynamic shared memory a block (attr: the cluster's, kept by the caller)
cudaLaunchConfig_t cluster_config(dim3 blocks, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = blocks;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// `kernel` checked (launch_regs, once), given its shared memory (once a
// device) and launched as clusters of CL blocks along d, one cluster a
// 64-row kept tile of each b*h
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, cudaError_t regs, int smem,
                            std::atomic<bool>* prepared, int B, int L, int H,
                            cudaStream_t stream, Args... args) {
  if (regs != cudaSuccess) return regs;
  cudaError_t err = prepare_on_device(kernel, smem, prepared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(CL * ((L + BM - 1) / BM), B * H), smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// how many of `kernel`'s clusters the current device runs at once
template <typename Kernel>
cudaError_t max_clusters(Kernel kernel, int smem, std::atomic<bool>* prepared,
                         int* n) {
  const cudaError_t err = prepare_on_device(kernel, smem, prepared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(CL * 1024), smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  static const cudaError_t regs = launch_regs(flash_dq_d512, kLaunchRegs);
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, false, B, L, H, D, 32, BN) ||
      !tensor_map(&tv, v, false, B, L, H, D, 32, BN))
    return cudaErrorInvalidValue;
  return launch_clusters(flash_dq_d512, regs, kDqSmemBytes, dq_prepared, B,
                         L, H, stream, tk, tv, static_cast<const float*>(q),
                         static_cast<const float*>(o),
                         static_cast<const float*>(dout), lse,
                         static_cast<float*>(dq), di, L, H, scale);
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  static const cudaError_t regs = launch_regs(flash_dkv_d512, kLaunchRegs);
  CUtensorMap tq, tdo;
  if (!tensor_map(&tq, q, false, B, L, H, D, 32, BN) ||
      !tensor_map(&tdo, dout, false, B, L, H, D, 32, BN))
    return cudaErrorInvalidValue;
  return launch_clusters(flash_dkv_d512, regs, kDkvSmemBytes, dkv_prepared,
                         B, L, H, stream, tq, tdo,
                         static_cast<const float*>(k),
                         static_cast<const float*>(v), lse, di,
                         static_cast<float*>(dk), static_cast<float*>(dv), L,
                         H, scale);
}

}  // namespace d512

// bf16 at d = 16 on the bf16 tensor cores (header). 128 threads a block;
// warp w owns rows 16 w.. of the block's 64-row kept tile (q rows in dq,
// keys in dkv) and holds their two kept A fragments (all of d each) in
// registers; the streamed pair comes in 128-row tiles through a ring of
// three buffers and is used in four KC-row chunks.
namespace d16_bf16 {

namespace bf16 = rdeic_flash::bf16;
using bf16::bf16_t;
constexpr int D = 16, BT = 64, BS = 128, NT = 128, KC = 32;
constexpr int kRow = D * 2;            // bytes of a tile row
constexpr int kKept = BT * D;          // values of a kept tile
constexpr int kTile = BS * D;          // values of a streamed tile
constexpr int kTileBytes = kTile * 2;  // 4 KB
// static shared memory: dq Q, dO, O and three K / V pairs (30 KB); dkv K,
// V, three Q / dO pairs and their rows' lse2 and di scale (31 KB)
constexpr int kDqSmemBytes = 3 * kKept * 2 + 6 * kTileBytes;
constexpr int kDkvSmemBytes = 2 * kKept * 2 + 6 * kTileBytes + 3 * 2 * BS * 4;
static_assert(kDkvSmemBytes <= 48 * 1024, "static shared memory");
static_assert(4 * (kDkvSmemBytes + 1024) <= 233472, "four blocks per SM");
static_assert(NT == BS, "one thread a q row's lse and di in load_row_terms");

// c (16 x KC: n-tile n holds streamed rows 8 n.. as columns) = A B^T, one
// 16-deep step over d from zero: A the warp's kept fragment, B the chunk's
// rows read without .trans (`b`: the chunk's first row plus Lane16::b, in
// bytes; one ldmatrix.x4 gives b0, b1 of two n-tiles)
__device__ __forceinline__ void scores(float (&c)[KC / 8][4],
                                       const uint32_t (&a)[4], uint32_t b) {
  using namespace rdeic_flash;
  zero(c);
#pragma unroll
  for (int np = 0; np < KC / 16; ++np) {
    uint32_t f[4];
    bf16::ldsm_x4(f, b + 16 * np * kRow);
    bf16::mma(c[2 * np], a, f[0], f[1]);
    bf16::mma(c[2 * np + 1], a, f[2], f[3]);
  }
}

// acc (16 x 16: n-tile n holds columns 8 n..) += X B over the chunk's KC
// rows: X (16 x KC, P or dS) from its C fragments as two bf16 terms
// (pack_split_trunc; the C fragments of n-tiles 2 kk and 2 kk + 1, packed
// pairwise, are the A fragment of the 16-deep step kk), B the chunk's rows
// read with .trans (`b`: the chunk's first row plus Lane16::a, in bytes;
// one ldmatrix.x4 gives b0, b1 of both n-tiles of d). At each step the
// small term's products go first, then the big term's.
__device__ __forceinline__ void accumulate(float (&acc)[2][4],
                                           const float (&x)[KC / 8][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t big[4], small[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows g, g + 8 of n-tile 2 kk, 2 kk + 1
      const float(&c)[4] = x[2 * kk + (i >> 1)];
      bf16::pack_split_trunc(c[2 * (i & 1)], c[2 * (i & 1) + 1], big[i],
                             small[i]);
    }
    bf16::ldsm_x4_trans(f, b + 16 * kk * kRow);
    bf16::mma(acc[0], small, f[0], f[1]);
    bf16::mma(acc[1], small, f[2], f[3]);
    bf16::mma(acc[0], big, f[0], f[1]);
    bf16::mma(acc[1], big, f[2], f[3]);
  }
}

// The warp's 16 x 16 accumulator, rows r0 + g and r0 + g + 8 (those below
// L), to out (at (b, h)) as bf16.
__device__ __forceinline__ void store_rows(bf16_t* out,
                                           const float (&acc)[2][4], int r0,
                                           int L, int64_t row) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= L) continue;
    bf16_t* p = out + r * row + 2 * t;
    store2<bf16_t>(p, acc[0][2 * half], acc[0][2 * half + 1]);
    store2<bf16_t>(p + 8, acc[1][2 * half], acc[1][2 * half + 1]);
  }
}

// lse and di of q rows [r0, r0 + BS) (lse and di at (b, h)) into dst: lse
// at dst[0..BS), di at dst[BS..2 BS); thread i copies row i's two by 4-byte
// cp.async.ca (a row past L reads nothing and lands as 0). The same thread
// turns them into lse2 and di scale once they have landed (row_terms).
__device__ __forceinline__ void load_row_terms(float* dst, const float* lse,
                                               const float* di, int r0,
                                               int L) {
  const int i = threadIdx.x;
  const bool in = r0 + i < L;
  const int at = in ? r0 + i : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf16::smem_addr(dst + i)),
               "l"(lse + at), "r"(in ? 4 : 0));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf16::smem_addr(dst + BS + i)),
               "l"(di + at), "r"(in ? 4 : 0));
}

// The calling thread's row of `rs` (its own copies, landed) in place: lse2 =
// lse log2(e), +inf past L (so P^T = 0 there), and di scale.
__device__ __forceinline__ void row_terms(float* rs, int r0, int L,
                                          float scale) {
  const int i = threadIdx.x;
  rs[i] = r0 + i < L ? rs[i] * bf16::kLog2e : INFINITY;
  rs[BS + i] *= scale;
}

// One block: (64-row q tile blockIdx.x, b*h blockIdx.y). Warp w keeps the
// A fragments of Q and dO rows 16 w.. and their lse2 and di scale, and
// streams K and V: S = Q K^T and dP = dO V^T as C fragments, P and dS in
// place, dq += dS K. Also di = rowsum(dO O) of the tile's rows, written to
// `di` for the dkv kernel.
__global__ void __launch_bounds__(NT, 4)
    flash_dq_d16_bf16(const bf16_t* __restrict__ q,
                      const bf16_t* __restrict__ k,
                      const bf16_t* __restrict__ v,
                      const bf16_t* __restrict__ o,
                      const bf16_t* __restrict__ dout,
                      const float* __restrict__ lse, bf16_t* __restrict__ dq,
                      float* __restrict__ di, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  __shared__ __align__(128) bf16_t qs[kKept];      // [BT][D]
  __shared__ __align__(128) bf16_t dos[kKept];     // [BT][D]
  __shared__ __align__(128) bf16_t os[kKept];      // [BT][D]
  __shared__ __align__(128) bf16_t ks[3 * kTile];  // [3 buffers][BS][D]
  __shared__ __align__(128) bf16_t vs[3 * kTile];  // [3 buffers][BS][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16::Lane16 ln(lane);
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const bf16_t* kb = k + base;
  const bf16_t* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const int nk = (L + BS - 1) / BS;

  load_tile<BT, D, NT>(qs, q + base, q0, L, row);
  load_tile<BT, D, NT>(dos, dout + base, q0, L, row);
  load_tile<BT, D, NT>(os, o + base, q0, L, row);
  load_tile<BS, D, NT>(ks, kb, 0, L, row);
  load_tile<BS, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();
  if (nk > 1) {
    load_tile<BS, D, NT>(ks + kTile, kb, BS, L, row);
    load_tile<BS, D, NT>(vs + kTile, vb, BS, L, row);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q, dO, O and the first K / V pair
  __syncthreads();

  // rows g (half 0) and g + 8 (half 1) of the warp's 16: lse2 = lse
  // log2(e), and di from the lane's 4 products of each row and its quad's
  const uint32_t arow = warp * 16 * kRow + ln.a;
  uint32_t qf[4], df[4];
  bf16::ldsm_x4(qf, bf16::smem_addr(qs) + arow);
  bf16::ldsm_x4(df, bf16::smem_addr(dos) + arow);
  float di_r[2] = {0.f, 0.f};
  {
    uint32_t of[4];
    bf16::ldsm_x4(of, bf16::smem_addr(os) + arow);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a0, a2: row g; a1, a3: row g + 8
      const float2 x = bf16::unpack(df[i]), y = bf16::unpack(of[i]);
      di_r[i & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, di_r[i & 1]));
    }
  }
  float lse2[2], dis[2];
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    di_r[half] += __shfl_xor_sync(0xffffffffu, di_r[half], 1);
    di_r[half] += __shfl_xor_sync(0xffffffffu, di_r[half], 2);
    const int r = r0 + 8 * half;
    const bool in = r < L;
    lse2[half] = in ? lse[rbase + r] * kLog2e : 0.f;
    dis[half] = in ? di_r[half] * scale : 0.f;
    if (in && t == 0) di[rbase + r] = di_r[half];
  }

  float acc[2][4];  // dq[16 rows][16]: n-tile n holds columns 8 n..
  zero(acc);
  const uint32_t sk = bf16::smem_addr(ks), sv = bf16::smem_addr(vs);
  // the ring: tile j in buffer j % 3, two in flight
  for (int j = 0, cur = 0; j < nk; ++j, cur = cur == 2 ? 0 : cur + 1) {
    const int k0 = j * BS;
    cp_async_wait<1>();  // this pair (the next may be in flight)
    // every warp sees this pair, and is done with the buffer of tile j - 1,
    // which takes tile j + 2
    __syncthreads();
    if (j + 2 < nk) {
      const int nxt = cur == 0 ? 2 : cur - 1;
      load_tile<BS, D, NT>(ks + nxt * kTile, kb, k0 + 2 * BS, L, row);
      load_tile<BS, D, NT>(vs + nxt * kTile, vb, k0 + 2 * BS, L, row);
    }
    cp_async_commit();
    const uint32_t kt = sk + cur * kTileBytes, vt = sv + cur * kTileBytes;
#pragma unroll
    for (int c0 = 0; c0 < BS; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      scores(s, qf, kt + c0 * kRow + ln.b);
      scores(dp, df, vt + c0 * kRow + ln.b);
      // P = 2^(S c - lse2), 0 on a key past L (its K row is zero, but P
      // need not be finite there); dS = P (dP scale - di scale), in place
      // of S
      const bool tail = k0 + c0 + KC > L;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int half = i >> 1;
          float p = exp2_ftz(fmaf(s[n][i], c, -lse2[half]));
          if (tail && k0 + c0 + 8 * n + 2 * t + (i & 1) >= L) p = 0.f;
          s[n][i] = p * fmaf(dp[n][i], scale, -dis[half]);
        }
      accumulate(acc, s, kt + c0 * kRow + ln.a);
    }
  }
  cp_async_wait<0>();
  store_rows(dq + base, acc, q0 + warp * 16, L, row);
}

// One block: (64-row k tile blockIdx.x, b*h blockIdx.y). Warp w keeps the
// A fragments of K and V rows 16 w.. and streams Q and dO with their rows'
// lse2 and di scale: S^T = K Q^T and dP^T = V dO^T as C fragments (rows
// keys, columns q), P^T and dS^T in place, dv += P^T dO, dk += dS^T Q. A q
// row past L lands as zeros (Q, dO, di) with lse2 = +inf, so P^T = dS^T = 0
// there.
__global__ void __launch_bounds__(NT, 4)
    flash_dkv_d16_bf16(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v,
                       const bf16_t* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16_t* __restrict__ dk,
                       bf16_t* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  __shared__ __align__(128) bf16_t ks[kKept];       // [BT][D]
  __shared__ __align__(128) bf16_t vs[kKept];       // [BT][D]
  __shared__ __align__(128) bf16_t qs[3 * kTile];   // [3 buffers][BS][D]
  __shared__ __align__(128) bf16_t dos[3 * kTile];  // [3 buffers][BS][D]
  __shared__ __align__(16) float rs[3 * 2 * BS];    // [3][lse2, di scale][BS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bf16::Lane16 ln(lane);
  const int k0 = blockIdx.x * BT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const bf16_t* qb = q + base;
  const bf16_t* db = dout + base;
  const float* lb = lse + rbase;
  const float* ib = di + rbase;
  const float c = scale * kLog2e;
  const int nq = (L + BS - 1) / BS;

  load_tile<BT, D, NT>(ks, k + base, k0, L, row);
  load_tile<BT, D, NT>(vs, v + base, k0, L, row);
  load_tile<BS, D, NT>(qs, qb, 0, L, row);
  load_tile<BS, D, NT>(dos, db, 0, L, row);
  load_row_terms(rs, lb, ib, 0, L);
  cp_async_commit();
  if (nq > 1) {
    load_tile<BS, D, NT>(qs + kTile, qb, BS, L, row);
    load_tile<BS, D, NT>(dos + kTile, db, BS, L, row);
    load_row_terms(rs + 2 * BS, lb, ib, BS, L);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K, V and the first Q / dO pair
  __syncthreads();
  const uint32_t arow = warp * 16 * kRow + ln.a;
  uint32_t kf[4], vf[4];
  bf16::ldsm_x4(kf, bf16::smem_addr(ks) + arow);
  bf16::ldsm_x4(vf, bf16::smem_addr(vs) + arow);

  float acc_k[2][4], acc_v[2][4];  // dk, dv [16 keys][16]
  zero(acc_k);
  zero(acc_v);
  const uint32_t sq = bf16::smem_addr(qs), sd = bf16::smem_addr(dos);
  for (int j = 0, cur = 0; j < nq; ++j, cur = cur == 2 ? 0 : cur + 1) {
    const int q0 = j * BS;
    float* r = rs + cur * 2 * BS;
    cp_async_wait<1>();
    row_terms(r, q0, L, scale);  // the thread's own copies, landed
    __syncthreads();  // this pair and its rows are visible; tile j - 1's
                      // buffer is free
    if (j + 2 < nq) {
      const int nxt = cur == 0 ? 2 : cur - 1;
      load_tile<BS, D, NT>(qs + nxt * kTile, qb, q0 + 2 * BS, L, row);
      load_tile<BS, D, NT>(dos + nxt * kTile, db, q0 + 2 * BS, L, row);
      load_row_terms(rs + nxt * 2 * BS, lb, ib, q0 + 2 * BS, L);
    }
    cp_async_commit();
    const uint32_t qt = sq + cur * kTileBytes, dt = sd + cur * kTileBytes;
#pragma unroll
    for (int c0 = 0; c0 < BS; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      scores(s, kf, qt + c0 * kRow + ln.b);
      scores(dp, vf, dt + c0 * kRow + ln.b);
      // column c0 + 8 n + 2 t + e is q row q0 + c0 + 8 n + 2 t + e:
      // P^T = 2^(S^T c - lse2), dS^T = P^T (dP^T scale - di scale)
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(r + col);
        const float2 d2 = *reinterpret_cast<const float2*>(r + BS + col);
        const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const float p = exp2_ftz(fmaf(s[n][i], c, -lc[e]));
          s[n][i] = p;
          dp[n][i] = p * fmaf(dp[n][i], scale, -dc[e]);
        }
      }
      accumulate(acc_v, s, dt + c0 * kRow + ln.a);
      accumulate(acc_k, dp, qt + c0 * kRow + ln.a);
    }
  }
  cp_async_wait<0>();
  store_rows(dk + base, acc_k, k0 + warp * 16, L, row);
  store_rows(dv + base, acc_v, k0 + warp * 16, L, row);
}

// the devices where each kernel's prepare() ran
std::atomic<bool> dq_prepared[kMaxDevices];
std::atomic<bool> dkv_prepared[kMaxDevices];

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  // static shared memory only; prepared once a device, so that a launch is
  // one call (the short calls are host-bound)
  err = prepare_on_device(flash_dq_d16_bf16, 0, dq_prepared);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dq_d16_bf16<<<grid, NT, 0, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(o),
      static_cast<const bf16_t*>(dout), lse, static_cast<bf16_t*>(dq), di, L,
      H, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  err = prepare_on_device(flash_dkv_d16_bf16, 0, dkv_prepared);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dkv_d16_bf16<<<grid, NT, 0, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(dout), lse,
      di, static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d16_bf16

// bf16 at d = 512 on the bf16 tensor cores (header). 256 threads a block.
// Warps 0-3 take the four 16 x 16 patches of S = Q K^T in a streamed tile
// (dkv: S^T = K Q^T), warps 4-7 those of dP = dO V^T (dP^T = V dO^T), each
// over the whole of d; the dP warp of a patch hands it to the S warp of the
// same patch, which forms P and dS; then warp w accumulates columns
// 64 w.. of d over the tile. dq keeps 64 q rows and streams 16-key tiles,
// dkv keeps 32 keys and streams 32-row q tiles, both double-buffered.
namespace d512_bf16 {

namespace bf16 = rdeic_flash::bf16;
using bf16::bf16_t;
using bf16::Lane;
constexpr int D = 512, NW = 8, NT = 32 * NW;
constexpr int kRow = D * 2;     // bytes of a tile row
constexpr int kSlice = D / NW;  // columns of d a warp accumulates
constexpr int DQ_KEPT = 64, DQ_STREAM = 16, KV_KEPT = 32, KV_STREAM = 32;
static_assert(DQ_KEPT / 16 * (DQ_STREAM / 16) == NW / 2 &&
                  KV_KEPT / 16 * (KV_STREAM / 16) == NW / 2,
              "a streamed tile has a 16 x 16 patch for each warp of a role");
static_assert(DQ_KEPT <= 4 * DQ_STREAM, "O passes through the K / V buffers");
// A patch's exchange slot, [2][32 lanes][4] words (1 KB): dP scale - di
// scale as the C fragments of the patch's n-tiles 0 and 1, then in their
// place X (dS or P) as the big and the small bf16 term of the A fragment of
// the 16-deep step over the patch's columns; each lane reads and writes its
// own 16 bytes of each half, so a warp's access hits 32 banks
constexpr int kSlot = 2 * 32 * 4;
constexpr int kDqTile = DQ_STREAM * D;  // values of a streamed K or V tile
constexpr int kKvTile = KV_STREAM * D;  // values of a streamed Q or dO tile
// dq: Q, dO, two K / V buffers, the four dS slots and the kept rows' di;
// dkv: K, V, two Q / dO buffers with their rows' lse2 and di scale, and the
// slots of P^T and dS^T
constexpr int kDqSmemBytes =
    2 * DQ_KEPT * kRow + 4 * kDqTile * 2 + 4 * kSlot * 4 + DQ_KEPT * 4;
constexpr int kDkvSmemBytes = 2 * KV_KEPT * kRow + 4 * kKvTile * 2 +
                              2 * 2 * KV_STREAM * 4 + 8 * kSlot * 4;
static_assert(kDqSmemBytes <= 232448 && kDkvSmemBytes <= 232448,
              "shared memory per block");

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// c (16 x 16: n-tiles 0 and 1) = A B^T over the whole of d, 32 16-deep
// steps from zero: `a` the A tile's 16 rows (their first plus Lane::ar, in
// bytes), `b` the B tile's 16 rows read without .trans (plus Lane::br)
__device__ __forceinline__ void patch(float (&c)[2][4], uint32_t a,
                                      uint32_t b, const Lane& ln) {
  using namespace rdeic_flash;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk >> 2) * 128;  // bytes of 64 columns
    uint32_t x[4], y[4];
    bf16::ldsm_x4(x, a + col + ln.ca[kk & 3]);
    bf16::ldsm_x4(y, b + col + ln.cb[kk & 3]);
    bf16::mma(c[0], x, y[0], y[1]);
    bf16::mma(c[1], x, y[2], y[3]);
  }
}

// A patch's C fragments to its slot, and back
__device__ __forceinline__ void put_c(uint32_t* slot, const float (&c)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n)
    *reinterpret_cast<float4*>(slot + (n * 32 + lane) * 4) =
        make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
}

__device__ __forceinline__ void get_c(float (&c)[2][4], const uint32_t* slot) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float4 x =
        *reinterpret_cast<const float4*>(slot + (n * 32 + lane) * 4);
    c[n][0] = x.x, c[n][1] = x.y, c[n][2] = x.z, c[n][3] = x.w;
  }
}

// X (a patch's C fragments) to its slot as two bf16 terms of the A
// fragment (pack_split_trunc): big, then small
__device__ __forceinline__ void put_a(uint32_t* slot, const float (&x)[2][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows g, g + 8 of n-tile 0, then of 1
    const float(&c)[4] = x[i >> 1];
    bf16::pack_split_trunc(c[2 * (i & 1)], c[2 * (i & 1) + 1], big[i],
                           small[i]);
  }
  *reinterpret_cast<uint4*>(slot + lane * 4) =
      make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(slot + (32 + lane) * 4) =
      make_uint4(small[0], small[1], small[2], small[3]);
}

__device__ __forceinline__ void get_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                      const uint32_t* slot) {
  const int lane = threadIdx.x & 31;
  const uint4 x = *reinterpret_cast<const uint4*>(slot + lane * 4);
  const uint4 y = *reinterpret_cast<const uint4*>(slot + (32 + lane) * 4);
  big[0] = x.x, big[1] = x.y, big[2] = x.z, big[3] = x.w;
  small[0] = y.x, small[1] = y.y, small[2] = y.z, small[3] = y.w;
}

// acc (MT m-tiles of 16 kept rows x the warp's 64 columns of d: n-tile n
// holds columns 8 n..) += X B over one 16-deep step: X the slots of the MT
// m-tiles' patches (slot m at slots + m * stride), B 16 streamed rows read
// with .trans (`b`: their first plus Lane::ar, plus the warp's columns, in
// bytes). At each step the small term's products go first, then the big's.
template <int MT>
__device__ __forceinline__ void take(float (&acc)[MT][kSlice / 8][4],
                                     const uint32_t* slots, int stride,
                                     uint32_t b, const Lane& ln) {
  uint32_t big[MT][4], small[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) get_a(big[m], small[m], slots + m * stride);
#pragma unroll
  for (int np = 0; np < kSlice / 16; ++np) {
    uint32_t f[4];
    bf16::ldsm_x4_trans(f, b + ln.ca[np]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      bf16::mma(acc[m][2 * np], small[m], f[0], f[1]);
      bf16::mma(acc[m][2 * np + 1], small[m], f[2], f[3]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      bf16::mma(acc[m][2 * np], big[m], f[0], f[1]);
      bf16::mma(acc[m][2 * np + 1], big[m], f[2], f[3]);
    }
  }
}

// The warp's accumulator (MT m-tiles from kept row r0, its 64 columns), the
// rows below L, to out (at (b, h) and the warp's columns) as bf16
template <int MT>
__device__ __forceinline__ void store_rows(
    bf16_t* out, const float (&acc)[MT][kSlice / 8][4], int r0, int L,
    int64_t row) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * m + g + 8 * half;
      if (r >= L) continue;
      bf16_t* p = out + r * row + 2 * t;
#pragma unroll
      for (int n = 0; n < kSlice / 8; ++n)
        store2<bf16_t>(p + 8 * n, acc[m][n][2 * half], acc[m][n][2 * half + 1]);
    }
}

// acc + the dot product of 8 bf16 pairs (16 bytes of each), in fp32
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y,
                                      float acc) {
  const uint32_t a[4] = {x.x, x.y, x.z, x.w}, b[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = bf16::unpack(a[i]), w = bf16::unpack(b[i]);
    acc = fmaf(u.y, w.y, fmaf(u.x, w.x, acc));
  }
  return acc;
}

// One block: (64-row q tile blockIdx.x, b*h blockIdx.y). Keeps Q and dO,
// streams K and V in 16-key tiles: warp w < 4 takes S of q rows 16 w.. and
// warp w + 4 dP of the same rows; dS = P dP' from them; then dq += dS K,
// warp w on columns 64 w... Also di = rowsum(dO O) of the tile's rows,
// written to `di` for the dkv kernel. (Written for any DQ_KEPT and
// DQ_STREAM with four patches a tile: patch p has rows 16 (p % MT) and
// keys 16 (p / MT).)
__global__ void __launch_bounds__(NT, 1)
    flash_dq_d512_bf16(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v,
                       const bf16_t* __restrict__ o,
                       const bf16_t* __restrict__ dout,
                       const float* __restrict__ lse, bf16_t* __restrict__ dq,
                       float* __restrict__ di, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  extern __shared__ __align__(128) unsigned char smem_dq512b[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_dq512b);  // [64][D]
  bf16_t* dos = qs + DQ_KEPT * D;                        // [64][D]
  bf16_t* ks = dos + DQ_KEPT * D;  // [2 buffers][16][D]
  bf16_t* vs = ks + 2 * kDqTile;   // [2 buffers][16][D]
  uint32_t* xs = reinterpret_cast<uint32_t*>(vs + 2 * kDqTile);  // [4][kSlot]
  float* di_s = reinterpret_cast<float*>(xs + 4 * kSlot);       // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lane ln(lane);
  constexpr int MT = DQ_KEPT / 16;
  // S (0) or dP (1) of patch p: q rows 16 (p % MT).., keys kc..
  const int role = warp >> 2, p = warp & 3, kc = 16 * (p / MT);
  const int q0 = blockIdx.x * DQ_KEPT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const bf16_t* kb = k + base;
  const bf16_t* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const int nk = (L + DQ_STREAM - 1) / DQ_STREAM;

  load_tile<DQ_KEPT, D, NT>(qs, q + base, q0, L, row);
  load_tile<DQ_KEPT, D, NT>(dos, dout + base, q0, L, row);
  load_tile<DQ_KEPT, D, NT>(ks, o + base, q0, L, row);  // O over ks and vs
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    // di = rowsum(dO O): kParts threads a row, each on chunks kParts i +
    // part of it, shifted by 4 on odd rows so that the 8 lanes of a 16-byte
    // phase hit 32 banks
    constexpr int kParts = NT / DQ_KEPT;
    const int r = threadIdx.x / kParts, part = threadIdx.x % kParts;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8 / kParts; ++i) {
      const int at =
          bf16::swz<D>(r, (kParts * i + part + 4 * (r & 1)) % (D / 8));
      sum = dot8(*reinterpret_cast<const uint4*>(dos + at),
                 *reinterpret_cast<const uint4*>(ks + at), sum);
    }
#pragma unroll
    for (int off = 1; off < kParts; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      di_s[r] = sum;
      if (q0 + r < L) di[rbase + q0 + r] = sum;
    }
  }
  __syncthreads();  // di_s is visible; done with O

  // rows 16 (p % MT) + g (half 0) and + 8 (half 1): lse2 = lse log2(e),
  // di scale
  float lse2[2], dis[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * (p % MT) + g + 8 * half;
    const bool in = q0 + r < L;
    lse2[half] = in ? lse[rbase + q0 + r] * kLog2e : 0.f;
    dis[half] = in ? di_s[r] * scale : 0.f;
  }
  load_tile<DQ_STREAM, D, NT>(ks, kb, 0, L, row);
  load_tile<DQ_STREAM, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();

  float acc[MT][kSlice / 8][4];  // dq: rows 16 m.., the warp's 64 columns
  zero(acc);
  const uint32_t sa =
      bf16::smem_addr(role ? dos : qs) + (16 * (p % MT) + ln.ar) * kRow;
  const uint32_t sk = bf16::smem_addr(ks), sv = bf16::smem_addr(vs);
  constexpr uint32_t kTileBytes = kDqTile * 2;
  uint32_t* slot = xs + p * kSlot;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * DQ_STREAM, cur = j & 1;
    cp_async_wait<0>();
    // tile j is visible; every warp is done with tile j - 1, whose buffers
    // take tile j + 1, and with the slots
    __syncthreads();
    if (j + 1 < nk) {
      load_tile<DQ_STREAM, D, NT>(ks + (cur ^ 1) * kDqTile, kb, k0 + DQ_STREAM,
                                  L, row);
      load_tile<DQ_STREAM, D, NT>(vs + (cur ^ 1) * kDqTile, vb, k0 + DQ_STREAM,
                                  L, row);
    }
    cp_async_commit();
    const uint32_t kt = sk + cur * kTileBytes;
    float s[2][4];  // S, or dP (role 1), of the patch
    patch(s, sa, (role ? sv + cur * kTileBytes : kt) + (kc + ln.br) * kRow,
          ln);
    if (role) {
      // dP' = dP scale - di scale, to the S warp of the patch
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = fmaf(s[n][i], scale, -dis[i >> 1]);
      put_c(slot, s);
      bar_arrive(1 + p, 64);
    } else {
      float dp[2][4];
      bar_sync(1 + p, 64);
      get_c(dp, slot);
      // P = 2^(S c - lse2), 0 on a key past L (its K row is zero, but P need
      // not be finite there); dS = P dP', in place of S
      const bool tail = k0 + DQ_STREAM > L;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pr = exp2_ftz(fmaf(s[n][i], c, -lse2[i >> 1]));
          if (tail && k0 + kc + 8 * n + 2 * t + (i & 1) >= L) pr = 0.f;
          s[n][i] = pr * dp[n][i];
        }
      put_a(slot, s);
    }
    __syncthreads();  // the four patches' dS terms are visible
#pragma unroll
    for (int kk = 0; kk < DQ_STREAM / 16; ++kk)  // m-tile m: patch m + MT kk
      take(acc, xs + MT * kk * kSlot, kSlot,
           kt + (16 * kk + ln.ar) * kRow + warp * 128, ln);
  }
  cp_async_wait<0>();
  store_rows(dq + base + warp * kSlice, acc, q0, L, row);
}

// lse and di of q rows [r0, r0 + KV_STREAM) into dst (lse at dst[0..32),
// di at dst[32..64)): thread i < 32 copies row i's lse, thread 32 + i its
// di, by 4-byte cp.async.ca; a row past L reads nothing and lands as 0. The
// same thread turns it into lse2 or di scale once it has landed (row_terms).
__device__ __forceinline__ void load_row_terms(float* dst, const float* lse,
                                               const float* di, int r0,
                                               int L) {
  const int tid = threadIdx.x, i = tid & (KV_STREAM - 1);
  if (tid >= 2 * KV_STREAM) return;
  const bool in = r0 + i < L;
  const float* src = (tid < KV_STREAM ? lse : di) + (in ? r0 + i : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf16::smem_addr(dst + tid)),
               "l"(src), "r"(in ? 4 : 0));
}

// The calling thread's word of `rs` (its own copy, landed) in place: lse2 =
// lse log2(e), +inf past L (so P^T = 0 there), or di scale
__device__ __forceinline__ void row_terms(float* rs, int r0, int L,
                                          float scale) {
  const int tid = threadIdx.x;
  if (tid < KV_STREAM)
    rs[tid] = r0 + tid < L ? rs[tid] * bf16::kLog2e : INFINITY;
  else if (tid < 2 * KV_STREAM)
    rs[tid] *= scale;
}

// One block: (32-key tile blockIdx.x, b*h blockIdx.y). Keeps K and V,
// streams Q and dO in 32-row tiles with their rows' lse2 and di scale: warp
// w < 4 takes S^T of keys 16 (w & 1).. and q rows 16 (w >> 1).. of the
// tile, warp w + 4 dP^T of the same patch; P^T and dS^T = P^T dP'^T from
// them; then dv += P^T dO and dk += dS^T Q, warp w on columns 64 w... A q
// row past L lands as zeros with lse2 = +inf, so P^T = dS^T = 0 there.
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_d512_bf16(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v,
                        const bf16_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16_t* __restrict__ dk,
                        bf16_t* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  extern __shared__ __align__(128) unsigned char smem_dkv512b[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(smem_dkv512b);  // [32][D]
  bf16_t* vs = ks + KV_KEPT * D;                          // [32][D]
  bf16_t* qs = vs + KV_KEPT * D;   // [2 buffers][32][D]
  bf16_t* dos = qs + 2 * kKvTile;  // [2 buffers][32][D]
  // [2 buffers][lse2, di scale][32], then the slots [P^T, dS^T][4][kSlot]
  float* rs = reinterpret_cast<float*>(dos + 2 * kKvTile);
  uint32_t* xs = reinterpret_cast<uint32_t*>(rs + 2 * 2 * KV_STREAM);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Lane ln(lane);
  // S^T (0) or dP^T (1) of patch p: keys 16 (p & 1).., q rows 16 (p >> 1)..
  const int role = warp >> 2, p = warp & 3, qc = 16 * (p >> 1);
  const int k0 = blockIdx.x * KV_KEPT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const bf16_t* qb = q + base;
  const bf16_t* db = dout + base;
  const float* lb = lse + rbase;
  const float* ib = di + rbase;
  const float c = scale * kLog2e;
  const int nq = (L + KV_STREAM - 1) / KV_STREAM;

  load_tile<KV_KEPT, D, NT>(ks, k + base, k0, L, row);
  load_tile<KV_KEPT, D, NT>(vs, v + base, k0, L, row);
  load_tile<KV_STREAM, D, NT>(qs, qb, 0, L, row);
  load_tile<KV_STREAM, D, NT>(dos, db, 0, L, row);
  load_row_terms(rs, lb, ib, 0, L);
  cp_async_commit();

  float acc_k[KV_KEPT / 16][kSlice / 8][4];  // dk: keys 16 m.., 64 columns
  float acc_v[KV_KEPT / 16][kSlice / 8][4];  // dv
  zero(acc_k);
  zero(acc_v);
  const uint32_t sa =
      bf16::smem_addr(role ? vs : ks) + (16 * (p & 1) + ln.ar) * kRow;
  const uint32_t sq = bf16::smem_addr(qs), sd = bf16::smem_addr(dos);
  constexpr uint32_t kTileBytes = kKvTile * 2;
  uint32_t* pslot = xs + p * kSlot;        // P^T
  uint32_t* dslot = xs + (4 + p) * kSlot;  // dP'^T, then dS^T
  for (int j = 0; j < nq; ++j) {
    const int q0 = j * KV_STREAM, cur = j & 1;
    const float* r = rs + cur * 2 * KV_STREAM;
    cp_async_wait<0>();
    row_terms(rs + cur * 2 * KV_STREAM, q0, L, scale);
    // tile j and its rows are visible; every warp is done with tile j - 1,
    // whose buffers take tile j + 1, and with the slots
    __syncthreads();
    if (j + 1 < nq) {
      const int nxt = cur ^ 1;
      load_tile<KV_STREAM, D, NT>(qs + nxt * kKvTile, qb, q0 + KV_STREAM, L,
                                  row);
      load_tile<KV_STREAM, D, NT>(dos + nxt * kKvTile, db, q0 + KV_STREAM, L,
                                  row);
      load_row_terms(rs + nxt * 2 * KV_STREAM, lb, ib, q0 + KV_STREAM, L);
    }
    cp_async_commit();
    const uint32_t qt = sq + cur * kTileBytes, dt = sd + cur * kTileBytes;
    float s[2][4];  // S^T, or dP^T (role 1): column qc + 8 n + 2 t + e of
                    // the tile is q row q0 + qc + 8 n + 2 t + e
    patch(s, sa, (role ? dt : qt) + (qc + ln.br) * kRow, ln);
    if (role) {
      // dP'^T = dP^T scale - di scale, to the S^T warp of the patch
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(
            r + KV_STREAM + qc + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = fmaf(s[n][i], scale, -((i & 1) ? d2.y : d2.x));
      }
      put_c(dslot, s);
      bar_arrive(1 + p, 64);
    } else {
      float dp[2][4];
      bar_sync(1 + p, 64);
      get_c(dp, dslot);
      // P^T = 2^(S^T c - lse2), dS^T = P^T dP'^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(r + qc + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr =
              exp2_ftz(fmaf(s[n][i], c, -((i & 1) ? l2.y : l2.x)));
          s[n][i] = pr;
          dp[n][i] *= pr;
        }
      }
      put_a(pslot, s);
      put_a(dslot, dp);
    }
    __syncthreads();  // the patches' P^T and dS^T terms are visible
#pragma unroll
    for (int kk = 0; kk < KV_STREAM / 16; ++kk) {
      // m-tile m of the 16-deep step over q rows 16 kk.. is patch m + 2 kk
      const uint32_t at = (16 * kk + ln.ar) * kRow + warp * 128;
      take(acc_v, xs + 2 * kk * kSlot, kSlot, dt + at, ln);
      take(acc_k, xs + (4 + 2 * kk) * kSlot, kSlot, qt + at, ln);
    }
  }
  cp_async_wait<0>();
  store_rows(dk + base + warp * kSlice, acc_k, k0, L, row);
  store_rows(dv + base + warp * kSlice, acc_v, k0, L, row);
}

// dynamic shared memory set once a device (prepare_on_device)
std::atomic<bool> dq_prepared[kMaxDevices];
std::atomic<bool> dkv_prepared[kMaxDevices];

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  err = prepare_on_device(flash_dq_d512_bf16, kDqSmemBytes, dq_prepared);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + DQ_KEPT - 1) / DQ_KEPT, B * H);
  flash_dq_d512_bf16<<<grid, NT, kDqSmemBytes, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(o),
      static_cast<const bf16_t*>(dout), lse, static_cast<bf16_t*>(dq), di, L,
      H, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, dout, dk, dv});
  if (err != cudaSuccess) return err;
  err = prepare_on_device(flash_dkv_d512_bf16, kDkvSmemBytes, dkv_prepared);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + KV_KEPT - 1) / KV_KEPT, B * H);
  flash_dkv_d512_bf16<<<grid, NT, kDkvSmemBytes, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(dout), lse,
      di, static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d512_bf16

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, float* di,
                int B, int L, int H, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      if constexpr (std::is_same_v<T, float>)
        return d16::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H,
                                 scale, st);
      else
        return d16_bf16::launch_dq(q, k, v, o, dout, lse, dq, di, B, L, H,
                                   scale, st);
    case 64:  // both launchers take the storage type's pointers
      return (std::is_same_v<T, float> ? d64::launch_dq : d64_bf16::launch_dq)(
          q, k, v, o, dout, lse, dq, di, B, L, H, scale, st);
    case 512:
      return (std::is_same_v<T, float> ? d512::launch_dq
                                       : d512_bf16::launch_dq)(
          q, k, v, o, dout, lse, dq, di, B, L, H, scale, st);
    default:
      return -1;
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* di,
                 void* dk, void* dv, int B, int L, int H, int D, float scale,
                 cudaStream_t st) {
  switch (D) {
    case 16:
      if constexpr (std::is_same_v<T, float>)
        return d16::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                  scale, st);
      else
        return d16_bf16::launch_dkv(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                    scale, st);
    case 64:
      return (std::is_same_v<T, float> ? d64::launch_dkv
                                       : d64_bf16::launch_dkv)(
          q, k, v, dout, lse, di, dk, dv, B, L, H, scale, st);
    case 512:
      return (std::is_same_v<T, float> ? d512::launch_dkv
                                       : d512_bf16::launch_dkv)(
          q, k, v, dout, lse, di, dk, dv, B, L, H, scale, st);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns 0, a cudaError_t, or -1 for
// a head dim or dtype this file was not built for.
int rdeic_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dq, void* di, int B, int L, int H, int D,
                            int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(di);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, o, dout, l, dq, r, B, L, H, D, scale,
                              st);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, o, dout, l, dq, r, B, L, H, D,
                                      scale, st);
  return -1;
}

int rdeic_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* di, void* dk, void* dv, int B, int L,
                             int H, int D, int dtype, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(di);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dout, l, r, dk, dv, B, L, H, D,
                               scale, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, r, dk, dv, B, L, H,
                                       D, scale, st);
  return -1;
}

const char* rdeic_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How many clusters of the fp32 d = 512 dq and dkv kernels the current
// device runs at once. Returns 0 or a cudaError_t.
int rdeic_flash_bwd_d512_clusters(int* dq, int* dkv) {
  const cudaError_t err = d512::max_clusters(
      d512::flash_dq_d512, d512::kDqSmemBytes, d512::dq_prepared, dq);
  if (err != cudaSuccess) return err;
  return d512::max_clusters(d512::flash_dkv_d512, d512::kDkvSmemBytes,
                            d512::dkv_prepared, dkv);
}

// The shared-memory carveout that the d = 16 bf16 dq and dkv kernels prefer
// on `device`: cudaSharedmemCarveoutMaxShared (100) once prepare() ran
// there, -1 (the default) before. Returns 0 or a cudaError_t.
int rdeic_flash_bwd_d16_bf16_carveout(int device, int* dq, int* dkv) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, d16_bf16::flash_dq_d16_bf16);
  if (err == cudaSuccess) {
    *dq = attr.preferredShmemCarveout;
    err = cudaFuncGetAttributes(&attr, d16_bf16::flash_dkv_d16_bf16);
    *dkv = attr.preferredShmemCarveout;
  }
  const cudaError_t back = cudaSetDevice(current);
  return err != cudaSuccess ? err : back;
}

}  // extern "C"
