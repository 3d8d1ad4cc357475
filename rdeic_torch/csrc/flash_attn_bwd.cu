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
// flash_dq_d16 and flash_dkv_d16 on the tensor cores, with the TF32
// mma.sync and 3xTF32 split of the d = 64 pair (below), reshaped for what
// d = 16 makes cheap (bf16 at d = 16 has kernels of its own, below):
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
// asynchronous copies in place of element loads through registers. Against
// the d = 64 pair: the kept pair in registers, split once, and each
// streamed value split once a block rather than once in every warp.
//
// d = 64 (the UNet: [2, 4096, 5, 64] and [2, 1024, 10, 64] per independent
// micro-step, twice that per refine micro-step) runs, in fp32, flash_dq_d64
// and flash_dkv_d64 on the tensor cores: TF32 mma.sync (m16n8k8), fp32
// accumulators, 3xTF32 for fp32 products (flash_mma.cuh). (bf16 at d = 64
// has kernels of its own, below.) Both kernels:
// - 64-row tiles, 4 warps; warp w owns rows 16 w.. of the block's tile (q
//   rows in dq, keys in dkv). The kept pair (Q and dO in dq, K and V in dkv)
//   stays in shared memory for the whole loop and is read as A fragments
//   by ldmatrix; the streamed pair (K and V, or Q and dO) comes in 64-row
//   tiles by cp.async (16 bytes a lane, zero-filled past L) and is used in
//   32-row chunks.
// - Scores as C fragments in registers: S = Q K^T and dP = dO V^T in dq;
//   S^T = K Q^T and dP^T = V dO^T in dkv, so that P^T and dS^T are C
//   fragments with keys as rows. The two products of a chunk interleave
//   (8 independent accumulators). P = exp(S scale - lse), 0 on a padded q
//   row (and, in dq, a padded key), and dS = P (dP - di) scale are formed in
//   place; they never reach shared memory. dq holds lse and di of its rows
//   g and g + 8 in registers (di = rowsum(dO O) from the kept dO and O, by
//   quad shuffles); dkv reads them by column from shared memory, staged a
//   q tile ahead.
// - dq += dS K, dv += P^T dO and dk += dS^T Q take the score fragments as A
//   in a permuted k order (k-slot t is streamed row 2t, slot t + 4 row
//   2t + 1), which makes a C fragment an A fragment with no shuffle; B is
//   then the streamed tile read at rows 2t and 2t + 1. dkv interleaves its
//   two products (16 accumulators).
// - One layout serves every read: row stride 68 floats (4 mod 32 banks),
//   not swizzled. An 8-row ldmatrix phase covers 8 x 4 banks and the
//   row-pair read puts lane (g, t) on bank 8 t + g (+ 4): both hit 32
//   distinct banks (tests/test_torch_port_tf32_split.py counts them; the
//   forward's swizzled stride 72 would give the row-pair read two-way
//   conflicts).
// - Occupancy: dq keeps 2 tiles and one streamed pair (70 KB), 3 blocks of
//   4 warps per SM; its next pair is copied after the current one is used,
//   while the SM's other blocks compute. dkv keeps 2 tiles and double-
//   buffers its streamed pair (105 KB), 2 blocks per SM, each copying the
//   next pair while it uses the current one.
// - ptxas -v: dq 166 registers, dkv 196; no spills.
// - Accuracy: mma.sync rounds the sum it returns toward zero, and dq, dk
//   and dv take every pass into their running accumulators, so their fp32
//   error grows with L: on the card ~1e-5 of max at L = 1024, 5e-5 at 4096,
//   7e-5 at 8192 (limit 1e-4; tests/test_torch_port_tf32_split.py models
//   it). Summing each step's passes from zero and adding that in fp32
//   keeps it flat, but the temporaries spill both kernels.
// What it does about the FMA template it replaces at d = 64: tensor
// cores in place of fp32 FMA; scores, P and dS in registers in place of
// shared memory; 16-byte asynchronous copies in place of element loads
// through registers. Keeping the kept pair in shared memory, not split in
// registers, keeps both kernels under 200 registers without spills, which
// leaves the compiler room to overlap loads with mma and buys dq a third
// block per SM. What holds it back now: 3 TF32 mma and a split (3 integer and
// fp32 operations) per fp32 product, with every warp splitting the same
// streamed fragments again; 8-12 warps per SM to hide mma.sync's latency;
// mma.sync's rate on Hopper (wgmma is the full-rate instruction).
//
// bf16 at d = 64 (the bf16 training recipes: the same shapes) runs
// flash_dq_d64_bf16 and flash_dkv_d64_bf16, built from the pieces of
// flash_bf16.cuh, as the bf16 forward is:
// - Tiles stay bf16 in shared memory, in flash_bf16.cuh's swizzled layout
//   (chunk c of row r at c ^ (r & 7)), copied by cp.async.cg 16 bytes a
//   lane, zero-filled past L: every copy and every ldmatrix phase, with and
//   without .trans, hits 32 banks. 64-row kept tiles of 4 warps, warp w
//   owning rows 16 w..; the kept pair (Q and dO in dq, K and V in dkv) is
//   read once into A fragments held in registers for the whole loop. The
//   streamed pair (K and V, or Q and dO with their rows' lse and di, these
//   by 4-byte cp.async.ca) comes in 64-row tiles through a ring of three
//   buffers, one barrier a tile, so the next two tiles are in flight while
//   one is used, in two 32-row chunks. dq's O passes through the third K
//   buffer before the ring reaches it.
// - Products: mma.sync m16n8k16, bf16 operands, fp32 accumulators. S = Q K^T
//   and dP = dO V^T (dkv: S^T = K Q^T, dP^T = V dO^T) take the streamed
//   tile's B fragments by ldmatrix without .trans; dq += dS K, dv += P^T dO
//   and dk += dS^T Q take them from the same tile by ldmatrix.trans.
// - Scores stay in registers: P and dS are formed in place in the C
//   fragments, whose pairs packed to bf16x2 are the A fragment of the next
//   16-deep step. The softmax runs in log2 units: P = ex2(fmaf(S, scale
//   log2(e), -lse log2(e))), dS = P fmaf(dP, scale, -di scale). dq masks
//   keys past L in its last tile; in dkv a q row past L lands as zeros (Q,
//   dO, lse, di), so P^T = 1 and dS^T = 0 there, times dO = Q = 0: no test.
// - P and dS as two bf16 terms (big = bf16(x), small = bf16(x - big),
//   flash_bf16.cuh pack_split), so every product with them is two mma. The
//   rule, read on the CPU emulation (tests/test_torch_port_flash_bwd_d64_
//   bf16.py) before any card run: one term only if it reads at most half
//   the card's limit (2^-8 + 1e-4 of max|plain|) at every training shape
//   and at L = 1000 and 8192. One term of P read up to 2.8e-3 of max on dv,
//   one of dS 2.1e-3 on dq and dk, past half (2.0e-3): dS K cancels (each
//   row of dS sums to about zero), and P's rounding does not average out
//   in P^T dO either. Two terms read <= 3.1e-5 before the bf16 store.
// - mma.sync rounds its sums toward zero; over L = 8192 one accumulator
//   moves the result by < 1e-4 of max (emulation), a fortieth of half the
//   limit, so there are no per-chunk partials. No atomics: two launches
//   give the same bits.
// - Grid: one block per (64-row tile, b*h), 640 at [2, 4096, 5, 64] and
//   320 at [2, 1024, 10, 64]. dq: Q, dO and the K / V ring, 64 KB, 167
//   registers (ptxas -v), three blocks per SM: 1.6 and 0.8 waves. dkv
//   holds dk and dv (64 accumulators a thread): at three blocks (168
//   registers) it spilled 16 bytes, so two, 252 registers and 65.5 KB,
//   2.4 and 1.2 waves. No spills.
// What holds them back now (PERF.md §6 has their times beside SDPA's):
// the warps' own instruction stream. In probes neither more warps per SM
// (four dq blocks on 32-row streamed tiles, three dkv blocks with 16-row
// chunks or the kept fragments re-read from shared memory), nor 128-row
// kept tiles of 8 warps (half the streamed bytes through L2), nor 32 q
// rows a warp in dq (each B fragment serving two m-tiles, half the
// ldmatrix a product, at 255 registers) ran faster.
// The products with P and dS take two mma for one (4 / 3 and 3 / 2 of the
// one-term count in dq and dkv), ldmatrix comes at one per 2-4 mma, and
// the exponentials and the split's conversions sit between the products
// in the same warps. wgmma with B from shared memory and TMA copies would
// take the ldmatrix and the copies off the warps that multiply.
//
// bf16 at d = 16 (the bf16 training recipes: the same shapes) runs
// flash_dq_d16_bf16 and flash_dkv_d16_bf16, d64_bf16's design at one
// 16-deep step over d:
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
// --d 512 on the card): the warps' own instruction stream, as at d = 64.
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
// d = 512 in fp32 (the VAE decoder's mid-block) runs its own pair,
// flash_dq_d512 and flash_dkv_d512, on the tensor cores: TF32 mma.sync
// (m16n8k8), fp32 accumulators, each fp32 product taken as three TF32
// products (3xTF32, flash_mma.cuh; one TF32 pass misses the 1e-4 limit).
// (bf16 at d = 512 has kernels of its own, above.)
// - Tiles: each kernel keeps a 32-row tile pair and streams 16-row tile
//   pairs: dq keeps Q and dO and streams K and V; dkv keeps K and V and
//   streams Q and dO. Four D-wide fp32 tiles of 96 rows in all, 195 KB in
//   the swizzled layout of flash_mma.cuh (stride D + 8, column XOR
//   (row & 4)), where a tile read as A, as B^T or as B hits 32 banks; with
//   the partial score tiles and dS (and P): 222 KB (dq) and 220 KB (dkv) of
//   the 227 KB, one block of 8 warps per SM. Keeping 32 rows halves the
//   streamed bytes against 16-row tiles on both sides: each kernel reads
//   the streamed pair L / 32 times per (b, h).
// - Scores: S = Q K^T and dP = dO V^T (32 x 16 in dq, 16 x 32 in dkv) are
//   split over the 8 warps by product and quarter of d: each warp sums its
//   tile over 128 of d (12 mma per 3 ldmatrix.x4), and the four partials
//   of each product meet in shared memory, where the 256 threads take 2
//   entries each: P = exp(S scale - lse) with padded rows and columns
//   masked, dS = P (dP - di) scale.
// - Accumulators: warp w owns the 32 x 64 slice at d = 64 w.. of dq (64
//   fp32 a thread), or of dk and of dv (128 a thread).
// - Copies: fp32 tiles by cp.async.cg, 16 bytes a lane, zero-filled past L.
//   dq: the next V tile is copied while the softmax and dS K run. dkv: dv =
//   P^T dO runs first, then the next dO tile is copied while dk = dS^T Q
//   runs; lse and di of the next q tile are read a tile ahead.
// - Grid at [2, 4096, 1, 512]: 256 blocks each (1.94 waves on 132 SMs).
// - ptxas -v: dq 171 registers, dkv 238; no spills.
// What it does about the FMA design it replaces: tensor cores in place of
// fp32 FMA; 32-row kept tiles (the FMA design had 16 on both sides), so
// each streamed tile feeds twice the work; asynchronous 16-byte copies in
// place of element loads through registers; at most 0.5 shared-memory
// loads per mma against 16 per 32 FMAs. What holds it back now: the copy
// of the next streamed tile that no compute overlaps (K in dq, Q in dkv),
// 3 TF32 mma and the split per fp32 product, and mma.sync's rate.
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
  const RowB<S, false> rb(plane, 0, 0);
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

// d = 512 on the tensor cores (header). 256 threads a block.
namespace d512 {

constexpr int D = 512, NT = 256;
constexpr int TS = D + 8;  // D-wide tile stride (swizzled, flash_mma.cuh)
// dq kernel: a kept 32-row q tile, streamed 16-row k tiles. Partial score
// tiles [S, dP][quarter of d][32][24]: float2 writes hit 32 banks; dS is
// read as a row-major A operand: stride 4 mod 32.
constexpr int DQ_Q = 32, DQ_K = 16, DQ_XS = 24, DQ_DS = 20;
// dkv kernel: a kept 32-row k tile, streamed 16-row q tiles. Partial score
// tiles [S, dP][quarter][16][40]; P and dS are read transposed (as A =
// P^T): stride 8 mod 32.
constexpr int KV_K = 32, KV_Q = 16, KV_XS = 40, KV_PS = 40;
constexpr int kDqSmemFloats = 2 * (DQ_Q + DQ_K) * TS + 8 * DQ_Q * DQ_XS +
                              DQ_Q * DQ_DS + 2 * DQ_Q;
constexpr int kDkvSmemFloats = 2 * (KV_K + KV_Q) * TS + 8 * KV_Q * KV_XS +
                               2 * KV_Q * KV_PS + 2 * KV_Q;
static_assert(kDqSmemFloats * 4 <= 232448, "shared memory per block");
static_assert(kDkvSmemFloats * 4 <= 232448, "shared memory per block");

// Warps 0-3 sum S = Q K^T, warps 4-7 dP = dO V^T, over their quarter of d,
// for the whole (16 MT) x (8 NT) score tile (rows q, columns k); into
// xs[product][quarter] of row stride XS.
template <int MT, int NT, int XS>
__device__ __forceinline__ void score_partials(const float* qs,
                                               const float* dos,
                                               const float* ks,
                                               const float* vs, float* xs) {
  using namespace rdeic_flash;
  const int warp = threadIdx.x >> 5, prod = warp >> 2, quarter = warp & 3;
  float acc[MT][NT][4];
  zero(acc);
  warp_mma<MT, NT, D / 32, true, true>(
      acc, RowA<TS, true>(prod ? dos : qs, 0, quarter * (D / 4)),
      RowB<TS>(prod ? vs : ks, 0, quarter * (D / 4)));
  float* x = xs + (prod * 4 + quarter) * MT * 16 * XS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      store_frag<XS>(x, acc[mt][nt], mt * 16, nt * 8);
}

// P and dS at q row r, k columns c and c + 1 of a ROWS-row score tile,
// from the partial sums: P = exp(S scale - lse), 0 on a padded row (q_in
// false) or column (c + j >= k_left); dS = P (dP - di) scale.
template <int ROWS, int XS>
__device__ __forceinline__ void probs(const float* xs, int r, int c,
                                      bool q_in, int k_left, float lse,
                                      float di, float scale, float (&p)[2],
                                      float (&ds)[2]) {
  float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const float2 x =
        *reinterpret_cast<const float2*>(xs + (qq * ROWS + r) * XS + c);
    const float2 y = *reinterpret_cast<const float2*>(
        xs + ((4 + qq) * ROWS + r) * XS + c);
    s[0] += x.x, s[1] += x.y, dp[0] += y.x, dp[1] += y.y;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p[j] = (q_in && c + j < k_left) ? expf(s[j] * scale - lse) : 0.f;
    ds[j] = p[j] * (dp[j] - di) * scale;
  }
}

// One block: (q tile blockIdx.x, b*h blockIdx.y). dq = sum over k tiles of
// dS K; also di = rowsum(dO * O) for the tile's rows, written to `di`.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
    flash_dq_d512(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ di, int L, int H,
                  float scale) {
  using namespace rdeic_flash;
  constexpr int BQ = DQ_Q, BK = DQ_K;
  extern __shared__ __align__(16) float smem_tc[];
  float* qs = smem_tc;             // [BQ][TS]
  float* dos = qs + BQ * TS;       // [BQ][TS]
  float* ks = dos + BQ * TS;       // [BK][TS]
  float* vs = ks + BK * TS;        // [BK][TS]
  float* xs = vs + BK * TS;        // partial S and dP
  float* dss = xs + 8 * BQ * DQ_XS;  // [BQ][DQ_DS]
  float* lse_s = dss + BQ * DQ_DS;
  float* di_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const int r = tid >> 3, c = (tid & 7) * 2;  // this thread's P / dS entries

  load_rows<T, BQ, D, NT>(qs, q + base, q0, L, row);
  load_rows<T, BQ, D, NT>(dos, dout + base, q0, L, row);
  load_rows<T, BQ, D, NT>(ks, o + base, q0, L, row);  // O over ks and vs
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    const int part = tid & 7;  // 8 lanes a row, 64 of d each
    float sum = 0.f;
    for (int d = part * (D / 8); d < (part + 1) * (D / 8); ++d)
      sum = fmaf(dos[swz<TS>(r, d)], ks[swz<TS>(r, d)], sum);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      const bool in = q0 + r < L;
      di_s[r] = sum;
      lse_s[r] = in ? lse[rbase + q0 + r] : 0.f;
      if (in) di[rbase + q0 + r] = sum;
    }
  }
  __syncthreads();  // done with O: ks and vs take K and V
  load_rows<T, BK, D, NT>(ks, k + base, 0, L, row);
  load_rows<T, BK, D, NT>(vs, v + base, 0, L, row);
  cp_async_commit();

  float acc[2][8][4];  // dq[0..32, 64 warp..]
  zero(acc);
  for (int k0 = 0; k0 < L; k0 += BK) {
    cp_async_wait<0>();
    __syncthreads();
    score_partials<2, 2, DQ_XS>(qs, dos, ks, vs, xs);
    __syncthreads();  // done with vs: the next V tile comes meanwhile
    if (k0 + BK < L) load_rows<T, BK, D, NT>(vs, v + base, k0 + BK, L, row);
    cp_async_commit();
    float p[2], ds[2];
    probs<BQ, DQ_XS>(xs, r, c, q0 + r < L, L - k0, lse_s[r], di_s[r], scale,
                     p, ds);
    *reinterpret_cast<float2*>(dss + r * DQ_DS + c) = make_float2(ds[0], ds[1]);
    __syncthreads();
    warp_mma<2, 8, BK / 8, true, true>(acc, RowA<DQ_DS, false>(dss, 0, 0),
                                         ColB<TS>(ks, warp * (D / 8), 0));
    __syncthreads();  // done with ks
    if (k0 + BK < L) load_rows<T, BK, D, NT>(ks, k + base, k0 + BK, L, row);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = mt * 16 + g + half * 8;
      if (q0 + rr >= L) continue;
      T* out = dq + base + (q0 + rr) * row + warp * (D / 8) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store2<T>(out + nt * 8, acc[mt][nt][2 * half],
                  acc[mt][nt][2 * half + 1]);
    }
}

// One block: (k tile blockIdx.x, b*h blockIdx.y). dv = sum over q tiles of
// P^T dO, dk = sum of dS^T Q.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_d512(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dk,
                   T* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  constexpr int BK = KV_K, BQ = KV_Q;
  extern __shared__ __align__(16) float smem_tc[];
  float* ks = smem_tc;             // [BK][TS]
  float* vs = ks + BK * TS;        // [BK][TS]
  float* qs = vs + BK * TS;        // [BQ][TS]
  float* dos = qs + BQ * TS;       // [BQ][TS]
  float* xs = dos + BQ * TS;       // partial S and dP, rows q, columns k
  float* ps = xs + 8 * BQ * KV_XS;  // [BQ][KV_PS], rows q, columns k
  float* dss = ps + BQ * KV_PS;    // [BQ][KV_PS]
  float* lse_s = dss + BQ * KV_PS;
  float* di_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const int r = tid >> 4, c = (tid & 15) * 2;  // this thread's P / dS entries

  load_rows<T, BK, D, NT>(ks, k + base, k0, L, row);
  load_rows<T, BK, D, NT>(vs, v + base, k0, L, row);
  load_rows<T, BQ, D, NT>(qs, q + base, 0, L, row);
  load_rows<T, BQ, D, NT>(dos, dout + base, 0, L, row);
  cp_async_commit();

  float acc_v[2][8][4], acc_k[2][8][4];  // dv, dk [0..32, 64 warp..]
  zero(acc_v);
  zero(acc_k);
  // lse and di of a q tile, read one tile ahead so that their latency
  // hides behind a whole tile's work
  float lse_next = 0.f, di_next = 0.f;
  if (tid < BQ && tid < L) {
    lse_next = lse[rbase + tid];
    di_next = di[rbase + tid];
  }
  for (int q0 = 0; q0 < L; q0 += BQ) {
    if (tid < BQ) {
      lse_s[tid] = lse_next;
      di_s[tid] = di_next;
      const bool in = q0 + BQ + tid < L;
      lse_next = in ? lse[rbase + q0 + BQ + tid] : 0.f;
      di_next = in ? di[rbase + q0 + BQ + tid] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    score_partials<1, 4, KV_XS>(qs, dos, ks, vs, xs);
    __syncthreads();
    float p[2], ds[2];
    probs<BQ, KV_XS>(xs, r, c, q0 + r < L, L - k0, lse_s[r], di_s[r], scale,
                     p, ds);
    *reinterpret_cast<float2*>(ps + r * KV_PS + c) = make_float2(p[0], p[1]);
    *reinterpret_cast<float2*>(dss + r * KV_PS + c) = make_float2(ds[0], ds[1]);
    __syncthreads();
    warp_mma<2, 8, BQ / 8, true, true>(acc_v, ColA<KV_PS>(ps, 0, 0),
                                         ColB<TS>(dos, warp * (D / 8), 0));
    __syncthreads();  // done with dos: the next dO tile comes meanwhile
    if (q0 + BQ < L) load_rows<T, BQ, D, NT>(dos, dout + base, q0 + BQ, L, row);
    cp_async_commit();
    warp_mma<2, 8, BQ / 8, true, true>(acc_k, ColA<KV_PS>(dss, 0, 0),
                                         ColB<TS>(qs, warp * (D / 8), 0));
    __syncthreads();  // done with qs
    if (q0 + BQ < L) load_rows<T, BQ, D, NT>(qs, q + base, q0 + BQ, L, row);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = mt * 16 + g + half * 8;
      if (k0 + rr >= L) continue;
      const int64_t at = base + (k0 + rr) * row + warp * (D / 8) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        store2<T>(dk + at + nt * 8, acc_k[mt][nt][2 * half],
                  acc_k[mt][nt][2 * half + 1]);
        store2<T>(dv + at + nt * 8, acc_v[mt][nt][2 * half],
                  acc_v[mt][nt][2 * half + 1]);
      }
    }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  const int smem = kDqSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_dq_d512<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + DQ_Q - 1) / DQ_Q, B * H);
  flash_dq_d512<T><<<grid, NT, smem, stream>>>(
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
  const int smem = kDkvSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_dkv_d512<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + KV_K - 1) / KV_K, B * H);
  flash_dkv_d512<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d512

// d = 64 on the tensor cores (header). 128 threads a block; warp w owns
// rows 16 w.. of the block's 64-row tile (q rows in dq, keys in dkv).
namespace d64 {

constexpr int D = 64, BT = 64, NT = 128;
constexpr int TS = D + 4;  // tile stride: 4 mod 32 banks, not swizzled
constexpr int KC = 32;     // streamed rows a chunk
constexpr int kTile = BT * TS;
// dq: the kept Q and dO, one streamed K / V pair (3 blocks per SM). dkv: the
// kept K and V, two streamed Q / dO pairs, lse and di (2 blocks per SM).
constexpr int kDqSmemFloats = 4 * kTile;
constexpr int kDkvSmemFloats = 6 * kTile + 2 * BT;
static_assert(3 * kDqSmemFloats * 4 <= 232448, "three dq blocks per SM");
static_assert(2 * kDkvSmemFloats * 4 <= 232448, "two dkv blocks per SM");

// One 8-deep step of s += A B: A (16 x 8) raw fp32 a0..a3, B(d, n) =
// tile[n][d] from bf (RowB), for NC n-tiles.
template <int NC>
__device__ __forceinline__ void score_step(float (&s)[NC][4],
                                           const float (&a)[4],
                                           const float (&bf)[NC][2]) {
  using namespace rdeic_flash;
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split<true>(a[i], ab[i], as[i]);
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    uint32_t bb[2], bs[2];
    split<true>(bf[n][0], bb[0], bs[0]);
    split<true>(bf[n][1], bb[1], bs[1]);
    mma_tf32(s[n], as, bb);
    mma_tf32(s[n], ab, bs);
    mma_tf32(s[n], ab, bb);
  }
}

// s1 = A1 B1^T and s2 = A2 B2^T over d, 16 x 8 NC each: A the warp's 16
// rows of the kept tiles a1, a2 (ldmatrix, RowA), B the NC 8-row groups of
// the streamed tiles b1, b2 from their row 0 (ldmatrix, RowB). n-tile n
// holds streamed rows 8 n.. as columns. The two products interleave, 2 NC
// independent accumulators.
template <int NC>
__device__ __forceinline__ void scores(float (&s1)[NC][4], float (&s2)[NC][4],
                                       const float* a1, const float* a2,
                                       const float* b1, const float* b2) {
  using namespace rdeic_flash;
  zero(s1);
  zero(s2);
  const int m0 = (threadIdx.x >> 5) * 16;
  const RowA<TS, false> ra1(a1, m0, 0), ra2(a2, m0, 0);
  const RowB<TS, false> rb1(b1, 0, 0), rb2(b2, 0, 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float x1[1][4], x2[1][4], y1[NC][2], y2[NC][2];
    ra1.load(x1, kk * 8);
    rb1.load(y1, kk * 8);
    ra2.load(x2, kk * 8);
    rb2.load(y2, kk * 8);
    score_step<NC>(s1, x1[0], y1);
    score_step<NC>(s2, x2[0], y2);
  }
}

// The 8 streamed rows kk of C (16 x 8 NC score fragments: P or dS) as an A fragment in the permuted k order: k-slot t is
// streamed row 2t, slot t + 4 row 2t + 1, so a0..a3 = c0, c2, c1, c3.
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&pb)[4],
                                       uint32_t (&ps)[4]) {
  using namespace rdeic_flash;
  split<true>(c[0], pb[0], ps[0]);
  split<true>(c[2], pb[1], ps[1]);
  split<true>(c[1], pb[2], ps[2]);
  split<true>(c[3], pb[3], ps[3]);
}

// acc (16 x 64) += (8 rows of C as A) B, B(k, n) = tile[k][n] read at rows
// 2t and 2t + 1 (b, already at the lane's row 2t and column g; stride TS:
// 32 banks). mma.sync rounds its result toward zero, so each pass drops up
// to an ulp of acc, always toward zero: over the L-long sum the error grows
// with L (header).
__device__ __forceinline__ void accumulate_step(float (&acc)[D / 8][4],
                                                const uint32_t (&pb)[4],
                                                const uint32_t (&ps)[4],
                                                const float* b) {
  using namespace rdeic_flash;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    uint32_t bb[2], bs[2];
    split<true>(b[8 * n], bb[0], bs[0]);
    split<true>(b[TS + 8 * n], bb[1], bs[1]);
    mma_tf32(acc[n], ps, bb);
    mma_tf32(acc[n], pb, bs);
    mma_tf32(acc[n], pb, bb);
  }
}

// The warp's 16 x 64 accumulator, rows r0 + g and r0 + g + 8 (those below
// L), to out (at (b, h)) in the storage type.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int r0, int L, int64_t row) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= L) continue;
    T* p = out + r * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(p + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// One block: (64-row q tile blockIdx.x, b*h blockIdx.y). Q and dO stay in
// shared memory; warp w owns q rows 16 w.. and their lse and di, and streams
// 64-row K and V tiles in KC-key chunks: S = Q K^T and dP = dO V^T as C
// fragments, P and dS in place in registers, dq += dS K. Also di =
// rowsum(dO * O) for the tile's rows, written to `di`. One buffer for the
// streamed pair: the next pair is copied after this one is used, while the
// SM's other two blocks compute.
template <typename T>
__global__ void __launch_bounds__(NT, 3)
    flash_dq_d64(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ di, int L, int H,
                 float scale) {
  using namespace rdeic_flash;
  extern __shared__ __align__(16) float smem_d64[];
  float* qs = smem_d64;     // [BT][TS]
  float* dos = qs + kTile;  // [BT][TS]
  float* ks = dos + kTile;  // [BT][TS]
  float* vs = ks + kTile;   // [BT][TS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const T* kb = k + base;
  const T* vb = v + base;

  // O passes through the K buffer; the first V tile lands meanwhile
  const float* os = ks;
  load_rows<T, BT, D, NT, TS, false>(qs, q + base, q0, L, row);
  load_rows<T, BT, D, NT, TS, false>(dos, dout + base, q0, L, row);
  load_rows<T, BT, D, NT, TS, false>(ks, o + base, q0, L, row);
  load_rows<T, BT, D, NT, TS, false>(vs, vb, 0, L, row);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // rows g (half 0) and g + 8 (half 1) of the warp's 16: lse, and di from
  // the lane's 16 products of each row and its quad's
  const int r0 = q0 + warp * 16 + g;
  const bool in[2] = {r0 < L, r0 + 8 < L};
  float lse_r[2], di_r[2] = {0.f, 0.f};
  {
    const RowA<TS, false> rd(dos, warp * 16, 0), ro(os, warp * 16, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float x[1][4], y[1][4];
      rd.load(x, kk * 8);
      ro.load(y, kk * 8);
      di_r[0] = fmaf(x[0][0], y[0][0], di_r[0]);
      di_r[0] = fmaf(x[0][2], y[0][2], di_r[0]);
      di_r[1] = fmaf(x[0][1], y[0][1], di_r[1]);
      di_r[1] = fmaf(x[0][3], y[0][3], di_r[1]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    di_r[half] += __shfl_xor_sync(0xffffffffu, di_r[half], 1);
    di_r[half] += __shfl_xor_sync(0xffffffffu, di_r[half], 2);
    const int r = r0 + 8 * half;
    lse_r[half] = in[half] ? lse[rbase + r] : 0.f;
    if (in[half] && t == 0) di[rbase + r] = di_r[half];
  }
  __syncthreads();  // done with O
  load_rows<T, BT, D, NT, TS, false>(ks, kb, 0, L, row);
  cp_async_commit();

  float acc[D / 8][4];  // dq[16 rows][64]: n-tile n holds columns 8 n..
  zero(acc);
  const int nk = (L + BT - 1) / BT;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BT;
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < BT; c0 += KC) {
      const float* kt = ks + c0 * TS;
      const float* vt = vs + c0 * TS;
      float s[KC / 8][4], dp[KC / 8][4];
      scores<KC / 8>(s, dp, qs, dos, kt, vt);
      // P = exp(S scale - lse), 0 on a padded row or key; dS = P (dP - di)
      // scale, in place of S
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int half = i >> 1, key = k0 + c0 + 8 * n + 2 * t + (i & 1);
          const float p = (in[half] && key < L)
                              ? expf(s[n][i] * scale - lse_r[half]) : 0.f;
          s[n][i] = p * (dp[n][i] - di_r[half]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t pb[4], ps[4];
        c_as_a(s[kk], pb, ps);
        accumulate_step(acc, pb, ps, kt + (8 * kk + 2 * t) * TS + g);
      }
    }
    __syncthreads();  // every warp is done with this pair before its refill
    if (j + 1 < nk) {
      load_rows<T, BT, D, NT, TS, false>(ks, kb, k0 + BT, L, row);
      load_rows<T, BT, D, NT, TS, false>(vs, vb, k0 + BT, L, row);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  store_rows<T>(dq + base, acc, q0 + warp * 16, L, row);
}

// One block: (64-row k tile blockIdx.x, b*h blockIdx.y). K and V stay in
// shared memory; warp w owns keys 16 w.. and streams 64-row Q and dO tiles
// in KC-row chunks: S^T = K Q^T and dP^T = V dO^T as C fragments (rows
// keys, columns q), P^T and dS^T in place in registers (lse and di by
// column, from shared memory), dv += P^T dO, dk += dS^T Q. The next Q / dO
// pair is copied while this one is used.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    flash_dkv_d64(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dk,
                  T* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  extern __shared__ __align__(16) float smem_d64[];
  float* ks = smem_d64;         // [BT][TS]
  float* vs = ks + kTile;       // [BT][TS]
  float* qs = vs + kTile;       // [2 buffers][BT][TS]
  float* dos = qs + 2 * kTile;  // [2 buffers][BT][TS]
  float* lse_s = dos + 2 * kTile;  // [BT] of the current q tile
  float* di_s = lse_s + BT;         // [BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const T* qb = q + base;
  const T* db = dout + base;

  load_rows<T, BT, D, NT, TS, false>(ks, k + base, k0, L, row);
  load_rows<T, BT, D, NT, TS, false>(vs, v + base, k0, L, row);
  load_rows<T, BT, D, NT, TS, false>(qs, qb, 0, L, row);
  load_rows<T, BT, D, NT, TS, false>(dos, db, 0, L, row);
  cp_async_commit();

  // lse and di of a q tile, read one tile ahead so that their latency
  // hides behind a whole tile's work
  float lse_next = 0.f, di_next = 0.f;
  if (tid < BT && tid < L) {
    lse_next = lse[rbase + tid];
    di_next = di[rbase + tid];
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];  // dk, dv [16 keys][64]
  zero(acc_k);
  zero(acc_v);
  const int nq = (L + BT - 1) / BT;
  for (int j = 0; j < nq; ++j) {
    const int cur = j & 1, q0 = j * BT;
    if (tid < BT) {  // the previous tile's last sync has passed: no reader
      lse_s[tid] = lse_next;
      di_s[tid] = di_next;
      const bool in = q0 + BT + tid < L;
      lse_next = in ? lse[rbase + q0 + BT + tid] : 0.f;
      di_next = in ? di[rbase + q0 + BT + tid] : 0.f;
    }
    if (j + 1 < nq) {  // the next pair lands while this one is used
      load_rows<T, BT, D, NT, TS, false>(qs + (cur ^ 1) * kTile, qb, q0 + BT,
                                         L, row);
      load_rows<T, BT, D, NT, TS, false>(dos + (cur ^ 1) * kTile, db,
                                         q0 + BT, L, row);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this pair (the next may be in flight)
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < BT; c0 += KC) {
      const float* qt = qs + cur * kTile + c0 * TS;
      const float* dt = dos + cur * kTile + c0 * TS;
      float s[KC / 8][4], dp[KC / 8][4];
      scores<KC / 8>(s, dp, ks, vs, qt, dt);
      // column c = c0 + 8 n + 2 t + e is q row q0 + c: P^T = exp(S^T scale
      // - lse[c]), 0 on a padded q row; dS^T = P^T (dP^T - di[c]) scale
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int c = c0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(di_s + c);
        const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const float p = q0 + c + e < L ? expf(s[n][i] * scale - lc[e]) : 0.f;
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - dc[e]) * scale;
        }
      }
      // dv += P^T dO and dk += dS^T Q, interleaved: 16 accumulators
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t pb[4], ps[4];
        c_as_a(s[kk], pb, ps);
        accumulate_step(acc_v, pb, ps, dt + (8 * kk + 2 * t) * TS + g);
        c_as_a(dp[kk], pb, ps);
        accumulate_step(acc_k, pb, ps, qt + (8 * kk + 2 * t) * TS + g);
      }
    }
    __syncthreads();  // every warp is done with this pair before its refill
  }
  cp_async_wait<0>();
  store_rows<T>(dk + base, acc_k, k0 + warp * 16, L, row);
  store_rows<T>(dv + base, acc_v, k0 + warp * 16, L, row);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  auto kernel = flash_dq_d64<T>;
  const int smem = kDqSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
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
  auto kernel = flash_dkv_d64<T>;
  const int smem = kDkvSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d64

// `smem` bytes of dynamic shared memory for `kernel`, and as much shared
// memory on the SM as it has, so that the blocks a kernel's launch bounds
// ask for fit (three d64_bf16 dq blocks, four d16_bf16 blocks)
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

// bf16 at d = 64 on the bf16 tensor cores (header). 128 threads a block;
// warp w owns rows 16 w.. of the block's 64-row kept tile (q rows in dq,
// keys in dkv) and holds their two kept A-fragment sets in registers; the
// streamed pair comes in 64-row tiles through a ring of three buffers and
// is used in two KC-row chunks. dq runs three blocks per SM, dkv (twice
// the accumulators) two.
namespace d64_bf16 {

namespace bf16 = rdeic_flash::bf16;
using bf16::bf16_t;
using bf16::Lane;
constexpr int D = 64, BT = 64, NT = 128, KC = 32;
constexpr int kRow = D * 2;                  // bytes of a tile row
constexpr int kTile = BT * D;                // values of a tile
constexpr int kTileBytes = kTile * 2;        // 8 KB
constexpr int kDqSmemBytes = 8 * kTileBytes;  // Q, dO, three K / V pairs
// K, V, three Q / dO pairs, and the lse and di of each pair's q rows
constexpr int kDkvSmemBytes = 8 * kTileBytes + 3 * 2 * BT * 4;
static_assert(3 * (kDqSmemBytes + 1024) <= 233472, "three dq blocks per SM");
static_assert(2 * (kDkvSmemBytes + 1024) <= 233472, "two dkv blocks per SM");
static_assert(NT == 2 * BT, "one thread a row term in load_row_terms");

// c (16 x KC: n-tile n holds streamed rows 8 n.. as columns) = A B^T over
// d: A the warp's kept fragments, B the chunk's rows read without .trans
// (`b`: the chunk's first row plus the lane's row Lane::br, in bytes)
__device__ __forceinline__ void scores(float (&c)[KC / 8][4],
                                       const uint32_t (&a)[D / 16][4],
                                       uint32_t b, const Lane& ln) {
  using namespace rdeic_flash;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < KC / 16; ++np) {
      uint32_t f[4];
      bf16::ldsm_x4(f, b + 16 * np * kRow + ln.cb[kk]);
      bf16::mma(c[2 * np], a[kk], f[0], f[1]);
      bf16::mma(c[2 * np + 1], a[kk], f[2], f[3]);
    }
}

// acc (16 x 64: n-tile n holds columns 8 n..) += X B over the chunk's KC
// rows: X (16 x KC, P or dS) from its C fragments as two bf16 terms (the
// C fragments of n-tiles 2 kk and 2 kk + 1, packed pairwise, are the A
// fragment of the 16-deep step kk), B the chunk's rows read with .trans
// (`b`: the chunk's first row plus the lane's row Lane::ar, in bytes). At
// each step the small term's products go first, then the big term's.
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[KC / 8][4],
                                           uint32_t b, const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t big[4], small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows g, g + 8 of n-tile 2 kk, 2 kk + 1
      const float(&c)[4] = x[2 * kk + (i >> 1)];
      bf16::pack_split(c[2 * (i & 1)], c[2 * (i & 1) + 1], big[i], small[i]);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t f[4];
      bf16::ldsm_x4_trans(f, b + 16 * kk * kRow + ln.ca[np]);
      bf16::mma(acc[2 * np], small, f[0], f[1]);
      bf16::mma(acc[2 * np + 1], small, f[2], f[3]);
      bf16::mma(acc[2 * np], big, f[0], f[1]);
      bf16::mma(acc[2 * np + 1], big, f[2], f[3]);
    }
  }
}

// The warp's 16 rows of a tile (byte address `a`: the tile plus the rows
// 16 w + Lane::ar) as the A fragments of the four 16-deep steps over d
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], uint32_t a,
                                       const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) bf16::ldsm_x4(f[kk], a + ln.ca[kk]);
}

// The warp's 16 x 64 accumulator, rows r0 + g and r0 + g + 8 (those below
// L), to out (at (b, h)) as bf16.
__device__ __forceinline__ void store_rows(bf16_t* out,
                                           const float (&acc)[D / 8][4],
                                           int r0, int L, int64_t row) {
  using namespace rdeic_flash;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= L) continue;
    bf16_t* p = out + r * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<bf16_t>(p + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// lse and di of q rows [r0, r0 + BT) (lse and di at (b, h)) into dst: lse
// at dst[0..BT), di at dst[BT..2 BT), 4 bytes a thread by cp.async.ca; a
// row past L reads nothing and lands as 0.
__device__ __forceinline__ void load_row_terms(float* dst, const float* lse,
                                               const float* di, int r0,
                                               int L) {
  const int i = threadIdx.x & (BT - 1);
  const bool in = r0 + i < L;
  const float* src = (threadIdx.x < BT ? lse : di) + (in ? r0 + i : 0);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf16::smem_addr(dst + threadIdx.x)),
               "l"(src), "r"(in ? 4 : 0));
}

// One block: (64-row q tile blockIdx.x, b*h blockIdx.y). Warp w keeps the
// A fragments of Q and dO rows 16 w.. and their lse2 and di scale, and
// streams K and V: S = Q K^T and dP = dO V^T as C fragments, P and dS in
// place, dq += dS K. Also di = rowsum(dO O) of the tile's rows, written to
// `di` for the dkv kernel.
__global__ void __launch_bounds__(NT, 3)
    flash_dq_d64_bf16(const bf16_t* __restrict__ q,
                      const bf16_t* __restrict__ k,
                      const bf16_t* __restrict__ v,
                      const bf16_t* __restrict__ o,
                      const bf16_t* __restrict__ dout,
                      const float* __restrict__ lse, bf16_t* __restrict__ dq,
                      float* __restrict__ di, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  extern __shared__ __align__(128) unsigned char smem_dq64b[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_dq64b);  // [BT][D]
  bf16_t* dos = qs + kTile;                             // [BT][D]
  bf16_t* ks = dos + kTile;                             // [3 buffers][BT][D]
  bf16_t* vs = ks + 3 * kTile;                          // [3 buffers][BT][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lane ln(lane);
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;
  const bf16_t* kb = k + base;
  const bf16_t* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const int nk = (L + BT - 1) / BT;
  bf16_t* os = ks + 2 * kTile;  // the third K buffer

  // O passes through the third K buffer, which the ring first fills with
  // tile 2, after the loop's first barrier
  load_tile<BT, D, NT>(qs, q + base, q0, L, row);
  load_tile<BT, D, NT>(dos, dout + base, q0, L, row);
  load_tile<BT, D, NT>(os, o + base, q0, L, row);
  cp_async_commit();
  load_tile<BT, D, NT>(ks, kb, 0, L, row);
  load_tile<BT, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();
  if (nk > 1) {
    load_tile<BT, D, NT>(ks + kTile, kb, BT, L, row);
    load_tile<BT, D, NT>(vs + kTile, vb, BT, L, row);
  }
  cp_async_commit();
  cp_async_wait<2>();  // Q, dO and O (the K / V tiles may be in flight)
  __syncthreads();

  // rows g (half 0) and g + 8 (half 1) of the warp's 16: lse2 = lse
  // log2(e), and di from the lane's 16 products of each row and its quad's
  const uint32_t arow = (warp * 16 + ln.ar) * kRow;
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a(qf, bf16::smem_addr(qs) + arow, ln);
  load_a(df, bf16::smem_addr(dos) + arow, ln);
  float di_r[2] = {0.f, 0.f};
  {
    uint32_t of[D / 16][4];
    load_a(of, bf16::smem_addr(os) + arow, ln);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0, a2: row g; a1, a3: row g + 8
        const float2 x = bf16::unpack(df[kk][i]), y = bf16::unpack(of[kk][i]);
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

  float acc[D / 8][4];  // dq[16 rows][64]: n-tile n holds columns 8 n..
  zero(acc);
  const uint32_t sk = bf16::smem_addr(ks), sv = bf16::smem_addr(vs);
  // the ring: tile j in buffer j % 3, two in flight
  for (int j = 0, cur = 0; j < nk; ++j, cur = cur == 2 ? 0 : cur + 1) {
    const int k0 = j * BT;
    cp_async_wait<1>();  // this pair (the next may be in flight)
    // every warp sees this pair, and is done with the buffer of tile
    // j - 1 (at j = 0: with O), which takes tile j + 2
    __syncthreads();
    if (j + 2 < nk) {
      const int nxt = cur == 0 ? 2 : cur - 1;
      load_tile<BT, D, NT>(ks + nxt * kTile, kb, k0 + 2 * BT, L, row);
      load_tile<BT, D, NT>(vs + nxt * kTile, vb, k0 + 2 * BT, L, row);
    }
    cp_async_commit();
    const uint32_t kt = sk + cur * kTileBytes, vt = sv + cur * kTileBytes;
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      scores(s, qf, kt + (c0 + ln.br) * kRow, ln);
      scores(dp, df, vt + (c0 + ln.br) * kRow, ln);
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
      accumulate(acc, s, kt + (c0 + ln.ar) * kRow, ln);
    }
  }
  cp_async_wait<0>();
  store_rows(dq + base, acc, q0 + warp * 16, L, row);
}

// One block: (64-row k tile blockIdx.x, b*h blockIdx.y). Warp w keeps the
// A fragments of K and V rows 16 w.. and streams Q and dO with their rows'
// lse and di: S^T = K Q^T and dP^T = V dO^T as C fragments (rows keys,
// columns q), P^T and dS^T in place, dv += P^T dO, dk += dS^T Q. A q row
// past L lands as zeros (Q, dO, lse, di), so S^T = 0, P^T = 1, dP^T = 0
// and dS^T = 0 there, and its products with dO = 0 and Q = 0 add exact
// zeros: no test. Two blocks per SM: at three (168 registers) it spills.
__global__ void __launch_bounds__(NT, 2)
    flash_dkv_d64_bf16(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v,
                       const bf16_t* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16_t* __restrict__ dk,
                       bf16_t* __restrict__ dv, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLog2e, bf16::load_tile;
  extern __shared__ __align__(128) unsigned char smem_dkv64b[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(smem_dkv64b);  // [BT][D]
  bf16_t* vs = ks + kTile;                               // [BT][D]
  bf16_t* qs = vs + kTile;                               // [3 buffers][BT][D]
  bf16_t* dos = qs + 3 * kTile;                          // [3 buffers][BT][D]
  float* rs = reinterpret_cast<float*>(dos + 3 * kTile);  // [3][lse, di][BT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Lane ln(lane);
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
  const int nq = (L + BT - 1) / BT;

  load_tile<BT, D, NT>(ks, k + base, k0, L, row);
  load_tile<BT, D, NT>(vs, v + base, k0, L, row);
  cp_async_commit();
  load_tile<BT, D, NT>(qs, qb, 0, L, row);
  load_tile<BT, D, NT>(dos, db, 0, L, row);
  load_row_terms(rs, lb, ib, 0, L);
  cp_async_commit();
  if (nq > 1) {
    load_tile<BT, D, NT>(qs + kTile, qb, BT, L, row);
    load_tile<BT, D, NT>(dos + kTile, db, BT, L, row);
    load_row_terms(rs + 2 * BT, lb, ib, BT, L);
  }
  cp_async_commit();
  cp_async_wait<2>();  // K and V (the Q / dO tiles may be in flight)
  __syncthreads();
  const uint32_t arow = (warp * 16 + ln.ar) * kRow;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a(kf, bf16::smem_addr(ks) + arow, ln);
  load_a(vf, bf16::smem_addr(vs) + arow, ln);

  float acc_k[D / 8][4], acc_v[D / 8][4];  // dk, dv [16 keys][64]
  zero(acc_k);
  zero(acc_v);
  const uint32_t sq = bf16::smem_addr(qs), sd = bf16::smem_addr(dos);
  for (int j = 0, cur = 0; j < nq; ++j, cur = cur == 2 ? 0 : cur + 1) {
    const int q0 = j * BT;
    cp_async_wait<1>();
    __syncthreads();  // this pair is visible; tile j - 1's buffer is free
    if (j + 2 < nq) {
      const int nxt = cur == 0 ? 2 : cur - 1;
      load_tile<BT, D, NT>(qs + nxt * kTile, qb, q0 + 2 * BT, L, row);
      load_tile<BT, D, NT>(dos + nxt * kTile, db, q0 + 2 * BT, L, row);
      load_row_terms(rs + nxt * 2 * BT, lb, ib, q0 + 2 * BT, L);
    }
    cp_async_commit();
    const uint32_t qt = sq + cur * kTileBytes, dt = sd + cur * kTileBytes;
    const float* r = rs + cur * 2 * BT;
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      scores(s, kf, qt + (c0 + ln.br) * kRow, ln);
      scores(dp, vf, dt + (c0 + ln.br) * kRow, ln);
      // column c0 + 8 n + 2 t + e is q row q0 + c0 + 8 n + 2 t + e:
      // P^T = 2^(S^T c - lse2), dS^T = P^T (dP^T scale - di scale)
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(r + col);
        const float2 d2 = *reinterpret_cast<const float2*>(r + BT + col);
        const float lc[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dc[2] = {d2.x * scale, d2.y * scale};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const float p = exp2_ftz(fmaf(s[n][i], c, -lc[e]));
          s[n][i] = p;
          dp[n][i] = p * fmaf(dp[n][i], scale, -dc[e]);
        }
      }
      accumulate(acc_v, s, dt + (c0 + ln.ar) * kRow, ln);
      accumulate(acc_k, dp, qt + (c0 + ln.ar) * kRow, ln);
    }
  }
  cp_async_wait<0>();
  store_rows(dk + base, acc_k, k0 + warp * 16, L, row);
  store_rows(dv + base, acc_v, k0 + warp * 16, L, row);
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  err = prepare(flash_dq_d64_bf16, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dq_d64_bf16<<<grid, NT, kDqSmemBytes, stream>>>(
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
  err = prepare(flash_dkv_d64_bf16, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  flash_dkv_d64_bf16<<<grid, NT, kDkvSmemBytes, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(dout), lse,
      di, static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), L, H, scale);
  return cudaGetLastError();
}

}  // namespace d64_bf16

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

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, dout, dq});
  if (err != cudaSuccess) return err;
  err = prepare(flash_dq_d512_bf16, kDqSmemBytes);
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
  err = prepare(flash_dkv_d512_bf16, kDkvSmemBytes);
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
    case 64:
      if constexpr (std::is_same_v<T, float>)
        return d64::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H,
                                 scale, st);
      else
        return d64_bf16::launch_dq(q, k, v, o, dout, lse, dq, di, B, L, H,
                                   scale, st);
    case 512:
      if constexpr (std::is_same_v<T, float>)
        return d512::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H,
                                  scale, st);
      else
        return d512_bf16::launch_dq(q, k, v, o, dout, lse, dq, di, B, L, H,
                                    scale, st);
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
      if constexpr (std::is_same_v<T, float>)
        return d64::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                  scale, st);
      else
        return d64_bf16::launch_dkv(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                    scale, st);
    case 512:
      if constexpr (std::is_same_v<T, float>)
        return d512::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                   scale, st);
      else
        return d512_bf16::launch_dkv(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                     scale, st);
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
