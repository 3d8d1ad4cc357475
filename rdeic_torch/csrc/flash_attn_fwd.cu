// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: rdeic_tpu/ops/flash_attention.py `_flash_kernel` as launched by
// `_flash_forward`, with and without `save_residuals`: non-causal, unmasked
// softmax(Q K^T * d^-1/2) V with a streaming row max and denominator and an
// fp32 accumulator; the padded K tail is masked to -1e30 and the output is
// divided by max(l, 1e-30).
//
// Layout: q, k, v, o are contiguous [B, L, H, D] (the layout the attention
// modules produce, so no transpose is needed around the call); fp32 or bf16
// in, the same type out, every sum and the softmax in fp32.
//
// lse: optional [B*H, L] fp32 output, the row logsumexp m + log(l) of the
// scaled scores, for the backward kernels (flash_attn_bwd.cu). A null
// pointer skips it, so the serving path runs without the extra store.
//
// Design: one block owns one (b*h, q-tile) pair and loops over the K/V tiles
// itself (the TPU kernel's sequential k grid axis becomes this loop).
//
// fp32 runs the kernels below at every head dim. bf16 runs kernels of its
// own at every head dim (flash_fwd_d16_bf16, flash_fwd_d64_bf16,
// flash_fwd_d512_bf16; "bf16", further below). Every one is a Hopper kernel
// built from flash_hopper.cuh: TMA tiles on mbarriers, warpgroup products.
//
// d = 16 (the control branch's attention: [1, 6144, 4, 16] and
// [1, 1536, 8, 16] per denoiser call at 768x512, [2, 4096, 4, 16] and
// [2, 1024, 8, 16] with lse in training) runs flash_fwd_d16 (fp32,
// 3xTF32) and flash_fwd_d16_bf16, with the pieces of the d = 64 design
// below. What bounds them: at d = 16 the products, the exponentials and the
// softmax's fp32 work lie close together ([1, 6144, 4, 16]: 3xTF32
// products 0.059 ms, the B H L^2 exponentials on the MUFU 0.036, the fp32
// pipe's fmaf, max, sum and P's split ~0.03; bf16 products 0.010), so how
// well they overlap decides the time. The mma.sync kernels these replace
// reached 26% of the fp32 bound and 48% of the bf16 exponentials' floor,
// with the softmax in the same warps between the products. What is new at
// d = 16:
// - Rows narrower than 128 bytes: a head's row is 64 bytes in fp32 and 32
//   in bf16. bf16 K and V tiles are TMA boxes of one head's rows in the
//   32-byte swizzle, which wgmma reads as layout type 3; the fp32 tiles are
//   in the 64-byte swizzle, layout type 2 (flash_hopper.cuh `desc_rows`). A
//   box of all heads' rows would load the other heads' bytes for nothing.
// - Q from registers: its fragment is 4 (bf16) or 16 (fp32, both terms)
//   registers a thread, loaded once from device memory: no Q tile, map or
//   descriptor.
// - P V is N = 16 wide: m64n16k8 (fp32) and m64n16k16 (bf16) run at about
//   half the tensor cores' rate (probes: the fp32 kernel without P V reads
//   0.089 ms of its 0.152 at [1, 6144, 4, 16]).
// fp32, flash_fwd_d16, two kernels. TF32 wgmma reads only K-major operands
// (and truncates), so S needs K's big and small terms and P V needs V^T's,
// in P's permuted key order (as flash_fwd_d64). Made by the block itself
// (a splitting producer warpgroup, the d = 64 design) they cost a quarter of
// the time at d = 16 (probes: 0.213 ms against 0.162 at [1, 6144, 4, 16]):
// every q tile's block split every key tile again. So flash_fwd_d16_split
// writes them once a call into scratch (every (b, h, 64-key tile)'s 16 KB
// image: K big (rounded to TF32 to nearest) and small in the 64-byte
// swizzle, V^T big and small in the 128-byte swizzle, keys past L zero;
// B H L x 256 bytes, 6 MB at [1, 6144, 4, 16]), and flash_fwd_d16 copies a
// tile's image into its ring in one bulk copy (cp.async.bulk, no tensor
// map). One block a 64-row q tile: a producer warpgroup (one thread issues
// the copies into eight stages; setmaxnreg gives the consumers its
// registers: 24 against 112) and four consumer warpgroups taking the key
// tiles j % 4, each with its own softmax state and O, merging at the end
// in consumer order. Per tile a consumer takes S = Q K^T (two 8-deep steps
// of three m64n64k8 wgmma, small * big, big * small, big * big, Q's terms
// from registers), the softmax, then P V (eight 8-key steps of three
// m64n16k8, P's terms from registers, in two groups of four steps, so only
// one group's terms are live) from zero into a partial that joins O by one
// fma (wgmma rounds toward zero: the error stays flat in L). The four
// consumers' chains interleave on the SM (probes at [1, 6144, 4, 16]: three
// consumers with all of P's terms live 0.146 ms against 0.141; two 0.175,
// or 0.160 with each softmax overlapped with its own P V, as
// flash_fwd_d64_bf16; five spill at 88 registers; P V in groups of two
// steps 0.142). 129 KB of shared memory, one block an SM: [1, 6144, 4, 16]
// gives 384 blocks (2.9 rounds on 132 SMs).
//
// d = 64 (the UNet's attention: [1, 6144, 5, 64] and [1, 1536, 10, 64] per
// denoiser call at 768x512, [2, 4096, 5, 64] and [2, 1024, 10, 64] with lse
// in training) runs flash_fwd_d64 (fp32) and flash_fwd_d64_bf16 (bf16), two
// Hopper kernels built from flash_hopper.cuh. What bounds them: the
// products. At L = 1536..6144 the 4 B H L^2 d flops take one to two orders
// of magnitude longer than the bytes at either rate, and the exponentials
// (B H L^2 on the MUFU, 16 a clock per SM) about as long as the bf16
// products, a sixth as long as the fp32 ones (3xTF32). The mma.sync
// kernels these replace reached 30% of that bound in fp32 and in bf16:
// mma.sync and ldmatrix issue, cp.async copies by every thread, and the
// softmax in the same warps between the products. The design, common to
// both:
// - Warp specialisation: a producer warpgroup (setmaxnreg gives its
//   registers to the consumers) and two consumer warpgroups, each owning
//   64 q rows of a 128-row q tile with their scores, softmax state and
//   output in registers.
// - TMA: one producer thread loads K and V tiles into a ring in shared
//   memory in the 128-byte swizzle, each tile completing on an mbarrier
//   (expect_tx); the consumers release a stage on a second mbarrier. Each
//   tensor is a 4-d map (d, h, token, b), so a box never crosses into the
//   next batch or head, and TMA reads zeros past L: the K tail is then
//   masked to -1e30 and the output divided by max(l, 1e-30).
// - wgmma: S = Q K^T and P V are warpgroup products, A from shared memory
//   or registers and B read by the tensor cores straight from the swizzled
//   tiles; the softmax runs on S's accumulator fragment in log2 units (one
//   fmaf and one exponential a score), and P's fragment, in registers, is
//   P V's A operand. lse = m ln 2 + ln l, as the dq / dkv kernels read it.
// fp32, flash_fwd_d64 (3xTF32, flash_mma.cuh's split; one TF32 pass misses
// the 2e-5 limit ten times over): every product is three TF32 wgmma an
// 8-deep step, small * big, big * small, big * big. TF32 wgmma takes only
// K-major operands (no transpose) and reads an fp32 value as TF32 by
// dropping its 13 low bits (the card's probe, tools/wgmma_probe.py), so
// what TMA loads is not yet an operand: the producer warpgroup (all 128
// threads) turns each loaded 64-key tile into K big (rounded to TF32 to
// nearest, so the tensor core reads it exactly) and K small, and V^T big
// and small, keys along the 128-byte rows in the permuted order of P's
// fragment (within 8 keys, k-slot t is key 2t and slot t + 4 key 2t + 1),
// so S's accumulator fragment is P V's A fragment as it stands (a0..a3 =
// c0, c2, c1, c3). Two rings: the tiles as loaded (TMA two tiles ahead,
// so the producer never waits on a load it just issued) and the operands
// (two stages). Q is split once: its big term stays in registers (the A
// of the second and third pass), its small term goes to shared memory in
// the swizzle (the A of the first pass): with both in registers the
// consumers spilled. 225 KB, one block per SM; registers: producer 56,
// consumers 224. wgmma rounds its sums toward zero (probe), so P V sums
// each tile into a partial from zero that joins the output by one fma,
// which keeps the error flat in L. [1, 6144, 5, 64] gives 240 blocks on
// 132 SMs (1.82 waves), [1, 1536, 10, 64] 120.
// d = 512 (the VAE mid-block: [1, 6144, 1, 512] twice a served image,
// [2 | 4, 6144, 1, 512] in batched serving, [4 | 7 | 8 | 15, 4096, 1, 512]
// in tiled serving, [2, 4096, 1, 512] with lse in refine training,
// [1, 4096, 1, 512] in validation) runs flash_fwd_d512 (fp32, 3xTF32) and
// flash_fwd_d512_bf16, two Hopper kernels built from flash_hopper.cuh with
// the pieces of the d = 64 design above: TMA tiles on mbarriers, a
// producer and consumer warpgroups, wgmma with P from registers, scores in
// log2 units, lse = m ln 2 + ln l. What bounds them: the products, 4 B H L^2
// d flops, 0.469 ms in fp32 (3xTF32) and 0.078 ms in bf16 at
// [1, 6144, 1, 512]; the B H L^2 exponentials take 0.009 ms. The mma.sync
// kernels they replace reached 23% (fp32) and 16% (bf16) of that. What
// shapes the design is the width, a 64-row tile (wgmma's least M):
// - O: 64 x 512 fp32 accumulators are 128 KB, 256 registers a thread of one
//   warpgroup, more than a thread has, and the per-tile P V partial that
//   keeps the fp32 error flat in L needs as many again. So O's d is split:
//   over two consumer warpgroups (bf16: 128 registers each) or over the
//   four blocks of a cluster (fp32: 64 each).
// - Q: 64 x 512 is 64 KB in bf16, but 128 KB a plane in fp32, and 3xTF32
//   needs a big and a small plane: 256 KB, more than the 227 KB a block
//   may use, before any K or V. Q's small term in registers would be 128
//   registers a thread of two warpgroups, beside O's 128. So the fp32
//   kernel splits Q's d too, over the cluster.
// - K and V: an fp32 key is 2 KB a plane (4 KB as two), and so is V^T:
//   TF32 wgmma reads only K-major B, so V^T is made by the producer, big and
//   small, in P's permuted key order (as flash_fwd_d64). With d split four
//   ways, a key is 2.5 KB in a block (K big, rounded where it lands, and
//   small, V as loaded, V^T big and small), so 32-key tiles fit twice.
//   bf16 takes K K-major and V MN-major straight from TMA: a 32-key tile is
//   32 KB, a ring of two.
// - A split d makes S a sum of partials: each slice of d sums its own
//   partial scores from zero, and the partials join in fp32 in a fixed
//   order, so every holder runs the same softmax on the same bits (cheap
//   at d = 512) and its own columns of P V.
// - Not built: a split over keys for the waves (at [1, 6144, 1, 512] two
//   key halves give the same rounds of work as none; four halve a round's
//   work but need a join of (m, l, O) partials of 64 x 512 each).
// fp32, flash_fwd_d512: a cluster of four blocks along d takes one 64-row
// q tile; block r holds d 128 r.. of Q (its big term in registers, 64 a
// thread; its small term, 32 KB, in shared memory as the A of the first
// pass, as flash_fwd_d64), of each K and V tile, and of O. Per block, three
// warpgroups: the producer (lane 0 of warp 0 issues the TMA loads, four
// boxes of 32 fp32 of K and of V a tile; warps 1-3 round K in place into
// its big term and write its small term, and write V^T's two terms, in two
// operand stages) and two consumers, consumer kh taking the key tiles of
// parity kh with its own softmax state and O; they merge at the end. Per
// tile a consumer: S's partial over its 128 of d (16 8-deep steps of three
// m64n32k8 wgmma: small * big, big * small, big * big); the exchange; the
// softmax; P V over its 128 columns in two halves of 64 (m64n64k8, three
// passes), each half's tile from zero into a partial that joins O by one
// fma, so wgmma's rounding toward zero stays that of one tile and the error
// is flat in L. The exchange is a reduce-scatter and an all-gather, warp by
// warp: warp w of every other block pushes its 16 rows' partial (2 KB) into
// block w by st.async, completing on block w's barrier; warp w of block w
// adds the four in rank order, ((p0 + p1) + p2) + p3, and pushes the sum
// back, so every block holds the same S and P. A stage's K and V^T halves
// are released apart (kready / vready), so K of the next tile is split
// while P V of this one runs. Shared memory 230,400 bytes (two stages of
// 64 KB, two V tiles as loaded, Q small 32 KB, the exchange slots 32 KB),
// one block an SM; setmaxnreg gives the consumers 224 registers (Q big 64,
// O 64, a half's partial 32, P's two terms 32) and the splitters 56. The
// grid: four blocks a q tile, [1, 6144, 1, 512] 384 blocks, 32 clusters at
// a time (a cluster's four blocks share a GPC), three rounds.
// Probes that chose it (tools/flash_fwd_probe.py --d 512, PERF.md §6, the
// H100 at 700 W; device ms at [1, 6144, 1, 512], the parent's mma.sync
// kernel 1.99): one consumer a block reading the other blocks' partials by
// ld.shared::cluster after a fence.acq_rel.cluster and one arrival on each,
// 3.21 (the exchange 1.79 of it); without the fence and with four threads
// arriving, 2.20 (the remote reads 0.72 of it); pushing by st.async
// through a reduce-scatter, 1.70; S of the next tile issued before this
// tile's exchange, 3.13-3.75 (two S accumulators spilled; with Q in shared
// memory, no spill, still 3.13); two consumers splitting each tile's 32
// keys (m64n16k8 S), 2.27; two
// consumers taking alternate tiles (this design), 1.58-1.61; its
// splitters' loads batched before their stores, 1.78-3.39 (slower); the
// TMA loads issued by the consumers and four splitting warps, 1.83;
// registers moved to the splitters (72 / 88), no gain or consumer spills;
// P V as one m64n128k8 group (a 64-register partial), spills, 1.71.
// What holds it back now: the splitters (with nothing to split it reads
// 1.20) and one warpgroup's serial S -> exchange -> softmax -> P V chain a
// tile (the products alone take about a third of it).
// bf16, flash_fwd_d512_bf16: one block a 64-row q tile, two consumer
// warpgroups each owning half of d and a producer warp. Q (64 KB, eight
// boxes of 64) and a ring of two 32-key K and V tiles (32 KB each) by TMA;
// per tile each consumer issues S's partial over its 256 of d (16 m64n32k16
// wgmma, Q and K K-major) and, with it, P V of the previous tile (two
// m64n256k16 wgmma, P from registers, V MN-major over four boxes: the
// descriptor's leading byte offset steps a box); while P V runs, the two
// partials meet in shared memory (one named barrier a tile, two buffers by
// parity), p0 + p1 in both, and the softmax runs. P is one bf16 term and O
// one accumulator, as flash_fwd_d64_bf16 (the rule below;
// tests/test_torch_port_flash_fwd_d512.py reads it under this order).
// 230,400 bytes of shared memory, one block an SM; setmaxnreg gives the
// consumers 240 registers (O 128). [1, 6144, 1, 512] gives 96 blocks on
// 132 SMs. Probe (tools/flash_fwd_probe.py --d 512 --dtype bf16, the H100
// at 700 W): 0.256 device ms at [1, 6144, 1, 512], 0.302 with P V waited
// for before the next S (variant `serial`); the parent's mma.sync kernel
// 0.478.
//
// bf16 (the `--bf16` serving path: [1, 6144, 5, 64] and [1, 1536, 10, 64]
// ten times an image each, [1, 6144, 4, 16] and [1, 1536, 8, 16] four times
// each, [1, 6144, 1, 512] twice; with lse where training calls them) runs
// flash_fwd_d16_bf16, flash_fwd_d64_bf16 and flash_fwd_d512_bf16 (the
// Hopper designs above and below); what they share:
// - Tiles stay bf16 in shared memory as TMA loads them; bf16 products are
//   exact in fp32, so S = Q K^T takes one pass.
// - P as A: the accumulator fragments of two adjacent 8-key n-tiles,
//   rounded to bf16 and packed pairwise, are P V's A fragment as they stand.
// - P's precision: one bf16 term. The rule: one term only if it reads at
//   most half the card's limit (two bf16 ulps of max|plain|, so one ulp)
//   at every path shape and at L = 1000 and 8192; otherwise two (hi =
//   bf16(P), lo = bf16(P - hi)). The CPU emulations of these kernels
//   (tests/test_torch_port_flash_bf16.py, test_torch_port_flash_d16_bf16.py,
//   test_torch_port_flash_fwd_d512.py, each in its kernel's order under
//   wgmma's rounding) read one term at 0.5-1.0 ulp after the bf16 store and
//   two terms at 0.25-0.5; the card reads one term at 0.5-1.0 ulp at every
//   path and check shape (chip_smoke.py phase 9, NVIDIA H100 80GB HBM3 at
//   700 W).
// - The softmax runs in log2 units, one fmaf and one ex2.approx.ftz a score
//   (subnormal p flush to 0), and lse = m ln 2 + ln l.
// - wgmma rounds its sums toward zero and cuts each term two bits below the
//   largest one's ulp (tools/wgmma_probe.py). With P in one bf16 term, P's
//   own rounding outweighs that ~100 times (emulation), so P V sums into
//   one accumulator over the whole L, without the per-tile partials of the
//   fp32 kernels.
// d = 16 (flash_fwd_d16_bf16): one block a 64-row q tile, a consumer
// warpgroup and a producer warp (one thread issues the TMA loads of 64-key
// K and V tiles into a ring of eight stages), 32 KB of static shared
// memory (a launch is the two tensor maps and the launch), three blocks an
// SM: [1, 6144, 4, 16] gives 384 blocks for 396 slots. Per tile the
// consumer issues S = Q K^T (one m64n64k16 wgmma, Q from registers, K
// K-major in the 32-byte swizzle) and P V of the previous tile (four
// m64n16k16, P from registers, V MN-major in the 32-byte swizzle, one atom
// wide) together, and runs the softmax while P V is on the tensor cores,
// as flash_fwd_d64_bf16 below. The MUFU (16 ex2 a clock per SM) sets the
// floor: B H L^2 / (16 x 132 SMs x 1.98 GHz), 0.036 ms at [1, 6144, 4, 16],
// ~4x the tensor-core bound; the kernel holds the SM at ~55% of it
// whichever way it is cut (probes, PERF.md §6: three or four blocks an SM,
// a larger carveout; two S buffers, which ptxas serializes, C7513), and
// without the exponentials reads 0.82 of its time. 128-key tiles at two
// blocks an SM are 6-12% faster at most path shapes, but not at
// [1, 6144, 4, 16] (two rounds of 264 slots for 384 blocks).
// d = 64 (flash_fwd_d64_bf16, the Hopper design above): Q and each K / V
// tile come by TMA into a ring of four 128-key stages (K and V of a stage
// on mbarriers of their own, so S starts before V lands); S = Q K^T is a
// 64 x 128 wgmma with A (Q) and B (K) from shared memory, K-major; P V
// eight 64 x 64 x 16 wgmma with A = P from registers (S's fragments
// rounded to bf16 and packed pairwise) and B = V, MN-major (bf16 takes the
// transpose). Each consumer overlaps its own exponentials with its
// products: S of tile j and P V of tile j - 1 are issued together, and the
// softmax of tile j runs while P V is on the tensor cores. A consumer holds
// 128 registers of fragments (S, P, O) and gets 240 by setmaxnreg (the
// producer keeps 24); 148 KB of shared memory, one block an SM:
// [1, 6144, 5, 64] runs 240 blocks on 132 SMs (1.82 waves). Tried and
// dropped in probes (tools/flash_fwd_probe.py, PERF.md §6): the two
// consumers taking turns on the tensor cores (ping-pong, named barriers),
// 1.3x slower; a second S buffer so that S of tile j + 1 also runs under
// the softmax of tile j, 1.3x slower; 64-key tiles at two blocks an SM,
// which spill at the registers two blocks leave a thread, 1.7x slower; a
// setmaxnreg split at two blocks an SM hung, as ptxas launched it with
// fewer registers than the producer had to give back.
// d = 512 (flash_fwd_d512_bf16, the Hopper design above).
//
// Bound on the H100: 4*L^2*D*H*B flops (S and P V) and 4*B*L*H*D elements
// of traffic. fp32 runs 3xTF32 on the tensor cores at every head dim, three
// TF32 products for each fp32 one, so the rate is 494.7 / 3 = 165 TFLOP/s;
// bf16 takes the bf16 peak, 989 TFLOP/s. At the main path's L = 1536..6144
// the flops bound every shape, by one to three orders of magnitude.

#include "flash_bf16.cuh"
#include "flash_common.cuh"
#include "flash_hopper.cuh"
#include "flash_mma.cuh"

namespace {

using rdeic_flash::kNegInf;

// fp32 at d = 512 on TF32 wgmma, each product as three passes (header). One
// cluster of CL blocks along d takes one 64-row q tile: cluster blockIdx.x
// / CL, b*h blockIdx.y; block `rank` owns d 128 rank.. of Q, K, V and O.
// Three warpgroups a block: warpgroup 0 the producer (lane 0 of warp 0
// issues the TMA loads, warps 1-3 split K and transpose and split V), and
// two consumers: consumer kh takes the key tiles j with j % 2 = kh, each
// with its own softmax state and its own 128 columns of O in registers;
// the two merge at the end.
namespace d512 {

using namespace rdeic_flash::hopper;
constexpr int D = 512, CL = 4, DC = D / CL, BQ = 64, BK = 32, STAGES = 2,
              NT = 384, NS = 96;  // NS: the splitting threads (warps 1-3)
// setmaxnreg moves the producer's registers to the consumers; the release
// covers the raise at the launch's 168 (one block of 384 threads an SM)
constexpr int kLaunchRegs = 168, kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kLaunchRegs == ((65536 / NT) & ~7), "one block an SM");
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  256 * (kConsumerRegs - kLaunchRegs),
              "registers per block");
constexpr uint32_t kBox = BK * 128;          // 32 keys x 32 fp32 of d: 4 KB
constexpr uint32_t kTile = (DC / 32) * kBox;  // a block's K or V tile: 16 KB
// two operand stages, stage s for the tiles of consumer s: K big (TMA lands
// K there and the splitters round it in place), K small, V^T big, V^T small
// (V^T is DC rows of 32 keys, kTile bytes too)
constexpr uint32_t kKb = 0, kKs = kTile, kVTb = 2 * kTile, kVTs = 3 * kTile,
                   kOp = 4 * kTile;
constexpr uint32_t kQAtom = BQ * 128;  // 64 q rows x 32 fp32 of d: 8 KB
// the exchange of a tile's partial scores, warp by warp: a warp's 16 rows
// are 2 KB (16 floats a lane, float4 i of a lane at 512 i + 16 lane). Per
// consumer two areas of four 2 KB slots: `parts`, slot s = block s's
// partial of the rows this block reduces; `sums`, slot w = the rows of
// warp w, reduced by block w
constexpr uint32_t kSlot = 2048, kArea = 4 * kSlot;
// from a 1024-byte-aligned base: the two stages, two V tiles as loaded,
// Q's small term (the A operand of S's first pass), the exchange areas
constexpr uint32_t kV0 = STAGES * kOp, kQs = kV0 + 2 * kTile,
                   kX0 = kQs + (DC / 32) * kQAtom;
constexpr int kSmemBytes = 1024 + kX0 + 4 * kArea;
static_assert(kSmemBytes <= 232448, "shared memory per block");
// consumer 1's (m, l, O) for the merge, in stage 0 once both are done
static_assert(128 * (4 + DC / 2) * 4 <= kOp, "the merge's scratch");

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d512(const float* __restrict__ q,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   float* __restrict__ o, float* __restrict__ lse, int L,
                   int H, float scale) {
  using namespace rdeic_flash;
  extern __shared__ unsigned char smem_d512[];
  // per stage: kfull (K landed), kready / vready (K's / V^T's operands
  // made), kempty / vempty (consumed by S / by P V); per V buffer: vfull
  // (V landed), vfree (transposed); per consumer: got_parts (the other
  // blocks' partials of this block's rows) and, per warp, got_sum (its rows
  // reduced by their block)
  __shared__ __align__(8) uint64_t bars[24];
  const uint32_t s0 = (smem_u32(smem_d512) + 1023) & ~1023u;
  unsigned char* const p0 = smem_d512 + (s0 - smem_u32(smem_d512));
  const uint32_t b0 = smem_u32(bars);
  auto kfull = [&](int s) { return b0 + 8 * s; };
  auto kready = [&](int s) { return b0 + 8 * (2 + s); };
  auto vready = [&](int s) { return b0 + 8 * (4 + s); };
  auto kempty = [&](int s) { return b0 + 8 * (6 + s); };
  auto vempty = [&](int s) { return b0 + 8 * (8 + s); };
  auto vfull = [&](int x) { return b0 + 8 * (10 + x); };
  auto vfree = [&](int x) { return b0 + 8 * (12 + x); };
  auto got_parts = [&](int kh) { return b0 + 8 * (14 + kh); };
  auto got_sum = [&](int kh, int w) { return b0 + 8 * (16 + 4 * kh + w); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int q0 = (blockIdx.x / CL) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kready(s), NS / 32);  // lane 0 of each splitting warp
      mbar_init(vready(s), NS / 32);
      mbar_init(kempty(s), 4);  // lane 0 of each warp of consumer s
      mbar_init(vempty(s), 4);
      mbar_init(vfull(s), 1);
      mbar_init(vfree(s), NS / 32);
      // one arrival (its own warp's expect_tx) and the bytes from the
      // other blocks
      mbar_init(got_parts(s), 1);
#pragma unroll
      for (int w = 0; w < 4; ++w) mbar_init(got_sum(s, w), 1);
    }
    fence_barrier_init();
  }
  // every block's barriers are set before another block arrives on them
  cluster_arrive();
  cluster_wait();

  if (warp < 4) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
      // the loads: K of tile j into its stage once S is done with the
      // stage's last tile, V into its buffer (the stage's) once the
      // splitters have transposed that buffer's last tile
      if (lane == 0) {
        for (int j = 0; j < nk; ++j) {
          const int s = j % STAGES;
          const uint32_t free = ((j / STAGES) & 1) ^ 1;  // round 0 passes
          mbar_wait(kempty(s), free);
          mbar_expect_tx(kfull(s), kTile);
#pragma unroll
          for (int a = 0; a < DC / 32; ++a)
            tma_load_4d(s0 + s * kOp + kKb + a * kBox, &tk, kfull(s),
                        DC * rank + 32 * a, h, j * BK, b);
          mbar_wait(vfree(s), free);
          mbar_expect_tx(vfull(s), kTile);
#pragma unroll
          for (int a = 0; a < DC / 32; ++a)
            tma_load_4d(s0 + kV0 + s * kTile + a * kBox, &tv, vfull(s),
                        DC * rank + 32 * a, h, j * BK, b);
        }
      }
      __syncwarp();
    } else {
      // the splitters make the operands TMA cannot give: K's two terms (K
      // big rounded in place) and V^T's (keys in the permuted order of P's
      // fragment), in the 128-byte swizzle
      const int tid = threadIdx.x - 32, ws = warp - 1;
      // V^T: lane = key; chunk c = d 4c..4c + 3 of the block's. Key x sits
      // at slot 8 (x >> 3) + (x & 7 even ? (x & 7) / 2 : 4 + (x & 7) / 2),
      // so k-slot t of an 8-key step is key 2t and slot t + 4 key 2t + 1
      const int x = lane & 7;
      const uint32_t slot = (lane & ~7) + ((x & 1) ? 4 + (x >> 1) : x >> 1);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t round = (j / STAGES) & 1;
        unsigned char* const op = p0 + s * kOp;
        // K: 1024 chunks of 16 bytes; the split keeps the layout
        mbar_wait(kfull(s), round);
#pragma unroll 2
        for (int i = tid; i < kTile / 16; i += NS) {
          const uint32_t off = 16 * i;
          float4 big, small;
          split4(*reinterpret_cast<const float4*>(op + kKb + off), big,
                 small);
          *reinterpret_cast<float4*>(op + kKb + off) = big;
          *reinterpret_cast<float4*>(op + kKs + off) = small;
        }
        // the writes seen by wgmma
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(kready(s));
        // V^T, once P V is done with the stage's last tile
        mbar_wait(vfull(s), round);
        mbar_wait(vempty(s), round ^ 1);  // round 0 passes
#pragma unroll 2
        for (int c = ws; c < DC / 4; c += NS / 32) {
          float4 big, small;
          split4(*reinterpret_cast<const float4*>(
                     p0 + kV0 + s * kTile + (c >> 3) * kBox +
                     swizzle128(lane, 16 * (c & 7))),
                 big, small);
          const float bv[4] = {big.x, big.y, big.z, big.w};
          const float sv[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t at = swizzle128(4 * c + e, 4 * slot);
            *reinterpret_cast<float*>(op + kVTb + at) = bv[e];
            *reinterpret_cast<float*>(op + kVTs + at) = sv[e];
          }
        }
        // the writes seen by wgmma, the V tile read (TMA may refill it)
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(vfree(s));
          mbar_arrive(vready(s));
        }
      }
    }
    cluster_arrive();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int kh = (warp >> 2) - 1;  // consumer 0 or 1: tiles kh, kh + 2..
    const int w = warp & 3, g = lane >> 2, t = lane & 3;
    const float c = scale * 1.4426950408889634f;  // scores in log2 units
    const int64_t row = static_cast<int64_t>(H) * D;
    const int64_t base = static_cast<int64_t>(b) * L * row +
                         static_cast<int64_t>(h) * D + DC * rank;
    const int r0 = q0 + 16 * w + g;  // rows r0 (r = 0), r0 + 8 (1)

    // this thread's Q fragments of the block's d, split once: k-step kk
    // holds (row, 8 kk + t) and (row, 8 kk + t + 4) of rows r0 and r0 + 8.
    // The big term stays in registers (A of S's second and third pass, in
    // both consumers), the small term goes to shared memory in the
    // 128-byte swizzle (A of the first pass; consumer 0 writes it), as in
    // flash_fwd_d64.
    uint32_t qb[DC / 8][4];
    {
      unsigned char* const qs = p0 + kQs;
      const int rw = 16 * w + g;
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
          const float xq = rr < L ? q[base + rr * row + col] : 0.f;
          uint32_t small;
          split<true>(xq, qb[kk][i], small);
          if (kh == 0)
            *reinterpret_cast<uint32_t*>(
                qs + (col >> 5) * kQAtom +
                swizzle128(rw + 8 * (i & 1), 4 * (col & 31))) = small;
        }
    }
    fence_proxy_async();
    named_sync(1, 256);  // Q's small term is written (the two consumers)

    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float acc[2][32];  // O[64 rows][128]: acc[hf][4 n + i], column 64 hf + 8 n
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;

    // The cluster's four partials of S join in rank order, ((p0 + p1) +
    // p2) + p3, the rows of warp w in block w (a reduce-scatter, then an
    // all-gather): warp w of every other block pushes its partial rows to
    // block w (st.async, completing on its barrier), warp w of block w adds
    // them to its own and pushes the sum back. Every block then holds the
    // same S, softmax and P. Each warp's exchange is its own, one a tile in
    // order; a slot is written again only by a block that has received
    // what its reader sent after reading it, so one area of each suffices.
    const uint32_t parts = s0 + kX0 + 2 * kh * kArea, sums = parts + kArea;
    const uint32_t mine = 16 * lane;  // this lane's bytes in a slot
    auto exchange = [&](int n, float(&sc)[BK / 2]) {
      const uint32_t parity = n & 1;  // this consumer's n-th tile
      if (w != rank) {
        const uint32_t to = static_cast<uint32_t>(w);
        const uint32_t at = mapa(parts + rank * kSlot + mine, to);
        const uint32_t bar = mapa(got_parts(kh), to);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_async_v4(at + 512 * i,
                      make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                  sc[4 * i + 3]),
                      bar);
        if (lane == 0) mbar_expect_tx(got_sum(kh, w), kSlot);
        mbar_wait_cluster(got_sum(kh, w), parity);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              p0 + (sums - s0) + w * kSlot + mine + 512 * i);
          sc[4 * i] = v.x, sc[4 * i + 1] = v.y;
          sc[4 * i + 2] = v.z, sc[4 * i + 3] = v.w;
        }
      } else {
        // this warp's own partial joins the others in its slot, and the
        // four are added in rank order
        unsigned char* const slots = p0 + (parts - s0) + mine;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(slots + rank * kSlot + 512 * i) =
              make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                          sc[4 * i + 3]);
        if (lane == 0) mbar_expect_tx(got_parts(kh), (CL - 1) * kSlot);
        mbar_wait_cluster(got_parts(kh), parity);
#pragma unroll
        for (int r = 0; r < CL; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                slots + r * kSlot + 512 * i);
            if (r == 0) {
              sc[4 * i] = v.x, sc[4 * i + 1] = v.y;
              sc[4 * i + 2] = v.z, sc[4 * i + 3] = v.w;
            } else {
              sc[4 * i] += v.x, sc[4 * i + 1] += v.y;
              sc[4 * i + 2] += v.z, sc[4 * i + 3] += v.w;
            }
          }
#pragma unroll
        for (int r = 0; r < CL; ++r) {
          if (r == rank) continue;
          const uint32_t to = static_cast<uint32_t>(r);
          const uint32_t at = mapa(sums + w * kSlot + mine, to);
          const uint32_t bar = mapa(got_sum(kh, w), to);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            st_async_v4(at + 512 * i,
                        make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                    sc[4 * i + 3]),
                        bar);
        }
      }
    };

    // Each of this consumer's tiles: this block's partial S over its 128 of
    // d, 64 x 32, three passes an 8-deep step (small * big, big * small,
    // big * big), from zero (sc[4 n + i] holds keys 32 j + 8 n..); the
    // exchange; the online softmax; P V in two halves of 64 columns
    // (registers: a half's partial is 32), each from zero into a partial
    // that joins the rescaled output by one fma (the tensor core's rounding
    // of its sums stays that of one tile). The other consumer runs its own
    // tiles in the meantime, on the same tensor cores.
    const uint32_t st = s0 + kh * kOp;
    for (int n = 0, j = kh; j < nk; ++n, j += 2) {
      const int k0 = j * BK;
      const uint32_t round = n & 1;
      float sc[BK / 2];
      // the descriptors of K's and Q's planes, kept from being hoisted out
      // of the loop (every step's as a register pair would not fit)
      uint64_t dk = desc(st + kKb), dq = desc(s0 + kQs);
      asm volatile("" : "+l"(dk), "+l"(dq));
      mbar_wait(kready(kh), round);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DC / 8; ++kk) {
        // in 16-byte units: K's 4 KB boxes, Q's 8 KB atoms
        const uint32_t at = ((kk >> 2) * kBox + 32 * (kk & 3)) >> 4;
        const uint32_t qat = ((kk >> 2) * kQAtom + 32 * (kk & 3)) >> 4;
        const uint64_t kb = dk + at, ks = dk + (kKs >> 4) + at;
        mma_m64n32k8_ss_tf32(sc, dq + qat, kb, kk);
        mma_m64n32k8_rs_tf32(sc, qb[kk], ks, 1);
        mma_m64n32k8_rs_tf32(sc, qb[kk], kb, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty(kh));
      exchange(n, sc);
      if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
        for (int m = 0; m < BK / 8; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + 8 * m + 2 * t + (i & 1) >= L) sc[4 * m + i] = kNegInf;
      }

      // online softmax of rows r0 and r0 + 8 in log2 units:
      // p = 2^(s c - m); a row's 32 values sit in the lane's quad, 8 a lane
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int m = 0; m < BK / 8; ++m)
          mx = fmaxf(mx, fmaxf(sc[4 * m + 2 * r], sc[4 * m + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * c);
        float sum = 0.f;
#pragma unroll
        for (int m = 0; m < BK / 8; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& xv = sc[4 * m + 2 * r + e];
            xv = exp2f(fmaf(xv, c, -m_new));
            sum += xv;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[r] = exp2f(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }

      // P's accumulator fragment of n-tile kk is its A fragment (a0..a3 =
      // c0, c2, c1, c3; V^T is stored in that key order)
      uint32_t pb[BK / 2], psm[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) split<true>(sc[i], pb[i], psm[i]);
      mbar_wait(vready(kh), round);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float pv[32];
        uint64_t dv = desc(st + kVTb + hf * 64 * 128);  // as dk above
        asm volatile("" : "+l"(dv));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t vb = dv + 2 * kk, vs = dv + (kTile >> 4) + 2 * kk;
          const uint32_t ab[4] = {pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1],
                                  pb[4 * kk + 3]};
          const uint32_t as[4] = {psm[4 * kk], psm[4 * kk + 2],
                                  psm[4 * kk + 1], psm[4 * kk + 3]};
          mma_m64n64k8_rs_tf32(pv, as, vb, kk);
          mma_m64n64k8_rs_tf32(pv, ab, vs, 1);
          mma_m64n64k8_rs_tf32(pv, ab, vb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[hf][i] = fmaf(acc[hf][i], alpha[(i >> 1) & 1], pv[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(vempty(kh));
    }
    cluster_arrive();  // this block's exchanges are done

    // the two consumers merge: consumer 1 hands its (m, l, O) to consumer
    // 0 through stage 0 (free once both are done), thread by thread;
    // consumer 0 merges and writes the rows
    float* const other = reinterpret_cast<float*>(p0) + (threadIdx.x & 127) *
                                                            (4 + DC / 2);
    named_sync(1, 256);  // both consumers are done with the stages
    if (kh == 1) {
      *reinterpret_cast<float4*>(other) =
          make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 32; i += 4)
          *reinterpret_cast<float4*>(other + 4 + 32 * hf + i) = make_float4(
              acc[hf][i], acc[hf][i + 1], acc[hf][i + 2], acc[hf][i + 3]);
    }
    named_sync(1, 256);
    if (kh == 0) {
      const float4 ml = *reinterpret_cast<const float4*>(other);
      const float m_1[2] = {ml.x, ml.y}, l_1[2] = {ml.z, ml.w};
      float a_0[2], a_1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(m_run[r], m_1[r]);
        a_0[r] = exp2f(m_run[r] - m);
        a_1[r] = exp2f(m_1[r] - m);
        l_run[r] = l_run[r] * a_0[r] + l_1[r] * a_1[r];
        m_run[r] = m;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(other + 4 + 32 * hf + i);
          const float o1[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = ((i + e) >> 1) & 1;
            acc[hf][i + e] = acc[hf][i + e] * a_0[r] + o1[e] * a_1[r];
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = r0 + 8 * r;
        if (rr >= L) continue;
        const float l = fmaxf(l_run[r], 1e-30f);
        if (lse != nullptr && rank == 0 && t == 0)
          lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
              m_run[r] * 0.6931471805599453f + logf(l);
        const float inv = 1.f / l;
        float* out = o + base + rr * row + 2 * t;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int m = 0; m < 8; ++m)
            *reinterpret_cast<float2*>(out + 64 * hf + 8 * m) =
                make_float2(acc[hf][4 * m + 2 * r] * inv,
                            acc[hf][4 * m + 2 * r + 1] * inv);
      }
    }
  }
  // no block leaves while another may still write to its shared memory
  cluster_wait();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, false, B, L, H, D, 32, BK) ||
      !tensor_map(&tv, v, false, B, L, H, D, 32, BK))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_d512,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((L + BQ - 1) / BQ), B * H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_d512, static_cast<const float*>(q),
                           tk, tv, static_cast<float*>(o), lse, L, H, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace d512

// fp32 at d = 64 on TF32 wgmma, each product as three passes (header). One
// block: (128-row q tile blockIdx.x, b*h blockIdx.y), three warpgroups:
// warpgroup 0 is the producer (one thread issues the TMA loads, all 128
// split K and transpose and split V), warpgroups 1 and 2 the consumers,
// each owning 64 q rows of the tile in registers.
namespace d64 {

using namespace rdeic_flash::hopper;
constexpr int D = 64, BQ = 128, BK = 64, STAGES = 2, NT = 384;
constexpr uint32_t kAtom = 64 * 128;  // bytes: 64 rows of 32 fp32
constexpr uint32_t kTile = 2 * kAtom;  // a 64 x 64 fp32 tile: two atoms
// a ring of tiles as loaded (K, V) and a ring of operands (K big, K small,
// V^T big, V^T small)
constexpr uint32_t kRaw = 2 * kTile;
constexpr uint32_t kKb = 0, kKs = kTile, kVTb = 2 * kTile, kVTs = 3 * kTile,
                   kOp = 4 * kTile;
// then Q's small term, the A operand of S's first pass (128 rows)
constexpr uint32_t kQs = STAGES * (kRaw + kOp);
constexpr int kSmemBytes = 1024 + kQs + 2 * kTile;
static_assert(kSmemBytes <= 232448, "shared memory per block");
// registers after setmaxnreg, moved inside the block: the producer splits
// and transposes, the consumers hold Q's big term and P's two terms
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                  NT * ((65536 / NT) & ~7),
              "registers per block");

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d64(const float* __restrict__ q,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ o, float* __restrict__ lse, int L,
                  int H, float scale) {
  using namespace rdeic_flash;
  extern __shared__ unsigned char smem_d64[];
  // per stage: loaded (TMA), ready (operands made), empty (consumed)
  __shared__ __align__(8) uint64_t bars[3 * STAGES];
  const uint32_t s0 = (smem_u32(smem_d64) + 1023) & ~1023u;
  unsigned char* const p0 = smem_d64 + (s0 - smem_u32(smem_d64));
  const uint32_t raw0 = s0, op0 = s0 + STAGES * kRaw;
  const uint32_t b0 = smem_u32(bars);
  auto loaded = [&](int s) { return b0 + 8 * s; };
  auto ready = [&](int s) { return b0 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return b0 + 8 * (2 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(ready(s), 4);  // lane 0 of each producer warp
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: thread 0 keeps the loads STAGES tiles ahead; the
    // warpgroup makes what TMA cannot give, K's small part and V^T (big
    // and small, keys in the permuted order of P's fragment), in the
    // 128-byte swizzle
    setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x;
    auto load = [&](int j) {
      const int s = j % STAGES;
      const uint32_t raw = raw0 + s * kRaw;
      mbar_expect_tx(loaded(s), kRaw);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        tma_load_4d(raw + half * kAtom, &tk, loaded(s), 32 * half, h,
                    j * BK, b);
        tma_load_4d(raw + kTile + half * kAtom, &tv, loaded(s), 32 * half,
                    h, j * BK, b);
      }
    };
    if (tid == 0)
      for (int j = 0; j < STAGES && j < nk; ++j) load(j);
    // V^T: lane = key within a 32-key half kh; chunk c = d 4c..4c + 3.
    // Key x sits at slot 8 (x >> 3) + (x & 7 even ? (x & 7) / 2 :
    // 4 + (x & 7) / 2) of the 64, so k-slot t of an 8-key step is key 2t
    // and slot t + 4 key 2t + 1 (header)
    const int wq = tid >> 5, x = lane & 7;
    const uint32_t slot = (lane & ~7) + ((x & 1) ? 4 + (x >> 1) : x >> 1);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      const uint32_t round = (j / STAGES) & 1;
      const unsigned char* raw = p0 + s * kRaw;
      unsigned char* const op = p0 + STAGES * kRaw + s * kOp;
      mbar_wait(loaded(s), round);
      mbar_wait(empty(s), round ^ 1);  // round 0 passes
      // K: 1024 chunks of 16 bytes, 8 a thread; the split keeps the layout
#pragma unroll 2
      for (int i = 0; i < kTile / 16 / 128; ++i) {
        const uint32_t off = 16 * (tid + 128 * i);
        float4 big, small;
        split4(*reinterpret_cast<const float4*>(raw + off), big, small);
        *reinterpret_cast<float4*>(op + kKb + off) = big;
        *reinterpret_cast<float4*>(op + kKs + off) = small;
      }
#pragma unroll 2
      for (int it = 0; it < 8; ++it) {
        const int combo = wq + 4 * it, kh = combo >> 4, c = combo & 15;
        const int key = 32 * kh + lane;
        float4 big, small;
        split4(*reinterpret_cast<const float4*>(
                   raw + kTile + (c >> 3) * kAtom +
                   swizzle128(key, 16 * (c & 7))),
               big, small);
        const float bv[4] = {big.x, big.y, big.z, big.w};
        const float sv[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t at = kh * kAtom + swizzle128(4 * c + e, 4 * slot);
          *reinterpret_cast<float*>(op + kVTb + at) = bv[e];
          *reinterpret_cast<float*>(op + kVTs + at) = sv[e];
        }
      }
      // the writes seen by wgmma, the reads of the loaded tiles done
      // before TMA refills them
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ready(s));
      named_sync(1, 128);  // the producer warpgroup (ids 2, 3: consumers)
      if (tid == 0 && j + STAGES < nk) load(j + STAGES);
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = (warp >> 2) - 1;  // consumer 0 or 1: q rows 64 wg..
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * 1.4426950408889634f;  // scores in log2 units
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int r0 = q0 + 64 * wg + 16 * w + g;  // rows r0 (r = 0), r0 + 8 (1)

  // this thread's Q fragments, split once: k-step kk holds (row, 8 kk + t)
  // and (row, 8 kk + t + 4) of rows r0 and r0 + 8. The big term stays in
  // registers (A of S's second and third pass); the small term goes to
  // shared memory in the 128-byte swizzle (A of the first pass), which
  // keeps the consumers' registers under their budget.
  uint32_t qb[D / 8][4];
  unsigned char* const qs = p0 + kQs + wg * kTile;
  const int rw = 16 * w + g;  // the warpgroup's row of r0
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      const float x = rr < L ? q[base + rr * row + col] : 0.f;
      uint32_t small;
      split<true>(x, qb[kk][i], small);
      *reinterpret_cast<uint32_t*>(
          qs + (col >> 5) * kAtom +
          swizzle128(rw + 8 * (i & 1), 4 * (col & 31))) = small;
    }
  fence_proxy_async();
  named_sync(2 + wg, 128);  // the warpgroup's Q small term is written
  const uint32_t qsa = smem_u32(qs);

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];  // O[64 rows][64]: acc[4 n + i], n-tile n = columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    const uint32_t st = op0 + s * kOp;
    mbar_wait(ready(s), (j / STAGES) & 1);

    // S = Q K^T, 64 x 64, three passes an 8-deep step (small * big,
    // big * small, big * big), from zero: sc[4 n + i] holds keys k0 + 8 n..
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t at = (kk >> 2) * kAtom + 32 * (kk & 3);
      const uint64_t kb = desc(st + kKb + at), ks = desc(st + kKs + at);
      mma_m64n64k8_ss_tf32(sc, desc(qsa + at), kb, kk);
      mma_m64n64k8_rs_tf32(sc, qb[kk], ks, 1);
      mma_m64n64k8_rs_tf32(sc, qb[kk], kb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = kNegInf;
    }

    // online softmax of rows r0 and r0 + 8 in log2 units: p = 2^(s c - m);
    // a row's 64 values sit in the lane's quad, 16 a lane
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * n + 2 * r + e];
          x = exp2f(fmaf(x, c, -m_new));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[r] = exp2f(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }

    // P V of this tile into a partial from zero, which joins the rescaled
    // output in fp32 (the tensor core's rounding of its sums stays that of
    // one tile). The k order inside each 8 keys is permuted (slot t is key
    // 2t, slot t + 4 key 2t + 1; V^T is stored so), so P's accumulator
    // fragment of n-tile kk is its A fragment: a0..a3 = c0, c2, c1, c3.
    uint32_t pb[BK / 2], psm[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) split<true>(sc[i], pb[i], psm[i]);
    float pv[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t at = (kk >> 2) * kAtom + 32 * (kk & 3);
      const uint64_t vb = desc(st + kVTb + at), vs = desc(st + kVTs + at);
      const uint32_t ab[4] = {pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1],
                              pb[4 * kk + 3]};
      const uint32_t as[4] = {psm[4 * kk], psm[4 * kk + 2], psm[4 * kk + 1],
                              psm[4 * kk + 3]};
      mma_m64n64k8_rs_tf32(pv, as, vb, kk);
      mma_m64n64k8_rs_tf32(pv, ab, vs, 1);
      mma_m64n64k8_rs_tf32(pv, ab, vb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + 8 * r;
    if (rr >= L) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * 0.6931471805599453f + logf(l);
    const float inv = 1.f / l;
    float* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, false, B, L, H, D, 32, BK) ||
      !tensor_map(&tv, v, false, B, L, H, D, 32, BK))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_d64,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d64<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const float*>(q), tk, tv, static_cast<float*>(o), lse, L,
      H, scale);
  return cudaGetLastError();
}

}  // namespace d64

// fp32 at d = 16 on TF32 wgmma, each product as three passes (header). Two
// kernels: flash_fwd_d16_split writes, once per call, each 64-key tile's
// operands as the image the main kernel's shared memory holds (K big and
// small, V^T big and small); flash_fwd_d16, one block a (64-row q tile
// blockIdx.x, b*h blockIdx.y), copies a tile's image in one bulk copy (one
// thread of a producer warpgroup) and runs NC consumer warpgroups on it:
// consumer kh takes the key tiles j with j % NC = kh, each with its own
// softmax state and O; they merge at the end.
namespace d16 {

using namespace rdeic_flash::hopper;
// NC consumers, each one tile at a time; P V in groups of PV_STEPS 8-key
// steps (P's terms of one group live at a time)
constexpr int D = 16, BQ = 64, BK = 64, NC = 4, STAGES = 8, PV_STEPS = 4;
constexpr int NT = 128 * (NC + 1);
// setmaxnreg moves the producer's registers to the consumers, within the
// block's registers at the launch (one block an SM: 65536 / NT a thread,
// in steps of 8)
constexpr int kLaunchRegs = (65536 / NT) & ~7, kProducerRegs = 24,
              kConsumerRegs = ((NT * kLaunchRegs - 128 * kProducerRegs) /
                               (128 * NC)) & ~7;
static_assert(kConsumerRegs <= 240, "setmaxnreg takes at most 255");
constexpr uint32_t kRow = D * 4;       // a key's 64 bytes
constexpr uint32_t kPlane = BK * kRow;  // 4 KB: K big or small, V^T big or small
constexpr uint32_t kAtomVT = D * 128;   // V^T: 16 rows of 32 keys, 2 KB
// a tile's image: K big and small (64-byte rows in the 64-byte swizzle),
// V^T big and small (16 rows of the tile's keys, in the permuted order of
// P's fragment, two atoms of 32 keys in the 128-byte swizzle)
constexpr uint32_t kKb = 0, kKs = kPlane, kVTb = 2 * kPlane,
                   kVTs = 3 * kPlane, kImage = 4 * kPlane;
constexpr int kSmemBytes = 1024 + STAGES * kImage;
static_assert(kSmemBytes <= 232448, "shared memory per block");
// consumers 1..NC-1 hand their (m, l, O) to consumer 0 through the stages
// once all are done
static_assert((NC - 1) * 128 * (4 + D / 2) * 4 <= STAGES * kImage,
              "the merge's scratch");

// The images: tile j of head (b, h) at image (b H + h) nk + j. Thread t of
// a block takes key t / 4 of the tile, d 4 (t % 4).. of it, for K and V;
// keys past L are zeros. V^T's key x of a 32-key atom sits at slot
// 8 (x >> 3) + (x & 7 even ? (x & 7) / 2 : 4 + (x & 7) / 2), so k-slot t
// of an 8-key step is key 2t and slot t + 4 key 2t + 1.
__global__ void __launch_bounds__(256)
    flash_fwd_d16_split(const float* __restrict__ k,
                        const float* __restrict__ v,
                        unsigned char* __restrict__ images, int L, int H) {
  using namespace rdeic_flash;
  const int key = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int j = blockIdx.x, b = blockIdx.y / H, h = blockIdx.y % H;
  const int tok = j * BK + key;
  const int64_t at = (static_cast<int64_t>(b) * L + tok) * H * D + h * D + 4 * c;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 kx = tok < L ? *reinterpret_cast<const float4*>(k + at) : zero;
  const float4 vx = tok < L ? *reinterpret_cast<const float4*>(v + at) : zero;
  unsigned char* const img =
      images + (static_cast<int64_t>(blockIdx.y) * gridDim.x + j) * kImage;
  float4 big, small;
  split4(kx, big, small);
  const uint32_t kat = swizzled(key * kRow + 16 * c, kRow);
  *reinterpret_cast<float4*>(img + kKb + kat) = big;
  *reinterpret_cast<float4*>(img + kKs + kat) = small;
  split4(vx, big, small);
  const float bv[4] = {big.x, big.y, big.z, big.w};
  const float sv[4] = {small.x, small.y, small.z, small.w};
  const int x = key & 7;
  const uint32_t slot = (key & 24) + ((x & 1) ? 4 + (x >> 1) : x >> 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t vat =
        (key >> 5) * kAtomVT + swizzle128(4 * c + e, 4 * slot);
    *reinterpret_cast<float*>(img + kVTb + vat) = bv[e];
    *reinterpret_cast<float*>(img + kVTs + vat) = sv[e];
  }
}

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d16(const float* __restrict__ q,
                  const unsigned char* __restrict__ images,
                  float* __restrict__ o, float* __restrict__ lse, int L,
                  int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e;
  extern __shared__ unsigned char smem_d16[];
  // per stage: full (the image landed), empty (P V is done with it)
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t s0 = (smem_u32(smem_d16) + 1023) & ~1023u;
  unsigned char* const p0 = smem_d16 + (s0 - smem_u32(smem_d16));
  const uint32_t b0 = smem_u32(bars);
  auto full = [&](int s) { return b0 + 8 * s; };
  auto empty = [&](int s) { return b0 + 8 * (STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each warp of the consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // the producer: one thread keeps the ring full, tile j's image into
    // stage j % STAGES once P V is done with the stage's last tile
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * NC && lane == 0) {
      const unsigned char* src =
          images + static_cast<int64_t>(blockIdx.y) * nk * kImage;
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full(s), kImage);
        bulk_load(s0 + s * kImage, src + static_cast<int64_t>(j) * kImage,
                  kImage, full(s));
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int kh = warp >> 2;  // consumer kh: tiles kh, kh + NC..
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;  // scores in log2 units
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int r0 = q0 + 16 * w + g;  // rows r0 (r = 0), r0 + 8 (1)

  // this thread's Q fragments, split once, both terms in registers (the A
  // of S's passes): k-step kk holds (row, 8 kk + t) and (row, 8 kk + t + 4)
  // of rows r0 and r0 + 8
  uint32_t qb[D / 8][4], qs[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      split<true>(rr < L ? q[base + rr * row + col] : 0.f, qb[kk][i],
                  qs[kk][i]);
    }

  // rows r0 and r0 + 8: the running max, and the lane's part of the
  // running sum (its quad adds the parts at the end)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];  // O[64 rows][16]: acc[4 n + i], n-tile n = columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // S, then P, of a tile: sc[4 n + i] holds keys 8 n..
  uint32_t pb[PV_STEPS][4], ps[PV_STEPS][4];  // a group's P terms, A fragments
  float pv[D / 2];   // a tile's P V, from zero
  float alpha[2];

  // S = Q K^T of tile j, 64 x 64, three passes an 8-deep step (small * big,
  // big * small, big * big) from zero, issued (committed, not waited for)
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
    const uint32_t st = s0 + s * kImage;
    const uint64_t kb = desc_rows(st + kKb, kRow), ks = desc_rows(st + kKs, kRow);
    mbar_wait(full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {  // k-step kk: 32 bytes into the row
      mma_m64n64k8_rs_tf32(sc, qs[kk], kb + 2 * kk, kk);
      mma_m64n64k8_rs_tf32(sc, qb[kk], ks + 2 * kk, 1);
      mma_m64n64k8_rs_tf32(sc, qb[kk], kb + 2 * kk, 1);
    }
    wgmma_commit();
  };
  // P's two terms as A fragments of its 8-key steps k0..k0 + PV_STEPS - 1
  auto split_p = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PV_STEPS; ++i) {
      const int order[4] = {0, 2, 1, 3};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split<true>(sc[4 * (k0 + i) + order[e]], pb[i][e], ps[i][e]);
    }
    fence_regs(pb);  // written before the next wgmma.fence
    fence_regs(ps);
  };
  // P V of tile j into pv from zero, three passes an 8-key step, in
  // groups of PV_STEPS steps, each group's P terms split (split_p) and
  // waited for. The k order inside each 8 keys is permuted (slot t is key
  // 2t, slot t + 4 key 2t + 1; V^T is stored so), so P's accumulator
  // fragment of n-tile kk is its A fragment: a0..a3 = c0, c2, c1, c3
  auto run_pv = [&](int j) {
    const uint32_t st = s0 + (j % STAGES) * kImage;
    const uint64_t vb = desc(st + kVTb), vs = desc(st + kVTs);
#pragma unroll
    for (int k0 = 0; k0 < BK / 8; k0 += PV_STEPS) {
      split_p(k0);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < PV_STEPS; ++i) {
        const int kk = k0 + i;
        const uint32_t at = ((kk >> 2) * kAtomVT + 32 * (kk & 3)) >> 4;
        mma_m64n16k8_rs_tf32(pv, ps[i], vb + at, kk);
        mma_m64n16k8_rs_tf32(pv, pb[i], vs + at, 1);
        mma_m64n16k8_rs_tf32(pv, pb[i], vb + at, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  };
  // the online softmax of tile j's S (rows g and g + 8, log2 units):
  // p = 2^(s c - m) in place, the rows' max and the lane's sums, and the
  // factors alpha of this tile; a row's 64 values sit in the lane's quad
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > L) {  // the K tail (zeros in the image): masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& xv = sc[4 * n + 2 * r + e];
          xv = exp2_ftz(fmaf(xv, c, -m_new));
          sum += xv;
        }
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
  };
  // the finished P V of tile j joins O by one fma: O = O alpha + P V (the
  // tensor core's rounding of its sums stays that of one tile), and its
  // stage goes back to the producer
  auto join_pv = [&](int j) {
    fence_regs(pv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % STAGES));
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  };

  // The consumers' chains (S, softmax, P V, a tile at a time) interleave
  // on the SM's tensor cores and pipes.
  for (int j = kh; j < nk; j += NC) {
    issue_s(j);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(j);
    run_pv(j);
    join_pv(j);
  }

  // the consumers merge: consumers 1..NC-1 hand their (m, l, O) to
  // consumer 0 through the stages (free once all are done), thread by
  // thread; consumer 0 merges them in order and writes the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float* const slots = reinterpret_cast<float*>(p0) + (threadIdx.x & 127) *
                                                          (4 + D / 2);
  named_sync(1, 128 * NC);  // every consumer is done with the stages
  if (kh > 0) {
    float* const mine = slots + (kh - 1) * 128 * (4 + D / 2);
    *reinterpret_cast<float4*>(mine) =
        make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4)
      *reinterpret_cast<float4*>(mine + 4 + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
  named_sync(1, 128 * NC);
  if (kh > 0) return;
#pragma unroll
  for (int x = 1; x < NC; ++x) {
    const float* const other = slots + (x - 1) * 128 * (4 + D / 2);
    const float4 ml = *reinterpret_cast<const float4*>(other);
    const float m_1[2] = {ml.x, ml.y}, l_1[2] = {ml.z, ml.w};
    float a_0[2], a_1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(m_run[r], m_1[r]);
      a_0[r] = exp2_ftz(m_run[r] - m);
      a_1[r] = exp2_ftz(m_1[r] - m);
      l_run[r] = l_run[r] * a_0[r] + l_1[r] * a_1[r];
      m_run[r] = m;
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(other + 4 + i);
      const float o1[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ((i + e) >> 1) & 1;
        acc[i + e] = acc[i + e] * a_0[r] + o1[e] * a_1[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + 8 * r;
    if (rr >= L) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    float* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
}

// the scratch bytes of a call: every (b, h, key tile)'s image
int64_t scratch_bytes(int B, int L, int H) {
  return static_cast<int64_t>(B) * H * ((L + BK - 1) / BK) * kImage;
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* scratch, int B, int L, int H,
                   float scale, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o, scratch});
  if (err != cudaSuccess) return err;
  const int nk = (L + BK - 1) / BK;
  flash_fwd_d16_split<<<dim3(nk, B * H), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<unsigned char*>(scratch), L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_d16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d16<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const float*>(q),
      static_cast<const unsigned char*>(scratch), static_cast<float*>(o),
      lse, L, H, scale);
  return cudaGetLastError();
}

}  // namespace d16

// bf16 at d = 16 on wgmma (header). One block: (64-row q tile blockIdx.x,
// b*h blockIdx.y), a consumer warpgroup that owns the tile's rows (their
// scores, softmax state and output in registers) and a producer warp (one
// thread issues every TMA load); three blocks an SM.
namespace d16_bf16 {

using rdeic_flash::bf16::bf16_t;
using namespace rdeic_flash::hopper;
constexpr int D = 16, BQ = 64, BK = 64, STAGES = 8, NT = 160,
              kBlocksPerSm = 3;
constexpr uint32_t kRow = D * 2;       // a key's 32 bytes
constexpr uint32_t kTile = BK * kRow;  // a K or V tile
// the K ring, then the V ring: static shared memory (under 48 KB, so a
// launch needs no cudaFuncSetAttribute)
constexpr int kSmemBytes = 2 * STAGES * kTile;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory");
static_assert(kBlocksPerSm * (kSmemBytes + 1024) <= 233472,
              "blocks an SM by shared memory");

// S = Q K^T of a tile of n keys: one m64n64k16 or m64n128k16 wgmma, Q from
// registers, K K-major
template <int N>
__device__ __forceinline__ void mma_s(float (&sc)[N / 2],
                                      const uint32_t (&qf)[4], uint64_t dk) {
  static_assert(N == 64 || N == 128, "a 64- or 128-key tile");
  if constexpr (N == 64)
    mma_m64n64k16_rs(sc, qf, dk, 0);
  else
    mma_m64n128k16_rs(sc, qf, dk, 0);
}

__global__ void __launch_bounds__(NT, kBlocksPerSm)
    flash_fwd_d16_bf16(const bf16_t* __restrict__ q,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16_t* __restrict__ o, float* __restrict__ lse, int L,
                       int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::pack;
  __shared__ __align__(1024) unsigned char ring[kSmemBytes];
  // per stage k_full, k_empty, v_full, v_empty
  __shared__ __align__(8) uint64_t bars[4 * STAGES];
  const uint32_t sk = smem_u32(ring), sv = sk + STAGES * kTile;
  const uint32_t b0 = smem_u32(bars);
  auto k_full = [&](int s) { return b0 + 8 * s; };
  auto k_empty = [&](int s) { return b0 + 8 * (STAGES + s); };
  auto v_full = [&](int s) { return b0 + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return b0 + 8 * (3 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 4);  // lane 0 of each consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: one thread keeps the ring full, a tile's K ahead of
    // its V so S can start first
    if (lane == 0) {
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t free = ((j / STAGES) & 1) ^ 1;  // round 0 passes
        mbar_wait(k_empty(s), free);
        mbar_expect_tx(k_full(s), kTile);
        tma_load_4d(sk + s * kTile, &tk, k_full(s), 0, h, j * BK, b);
        mbar_wait(v_empty(s), free);
        mbar_expect_tx(v_full(s), kTile);
        tma_load_4d(sv + s * kTile, &tv, v_full(s), 0, h, j * BK, b);
      }
    }
    return;
  }

  const int w = warp, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int r0 = q0 + 16 * w + g;  // rows r0 (r = 0), r0 + 8 (1)
  // Q as the A operand of S from registers, all of d in one 16-deep step:
  // (r0, 2t..2t+1), (r0 + 8, 2t..), (r0, 2t + 8..), (r0 + 8, 2t + 8..)
  uint32_t qf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + 8 * (i & 1), col = 2 * t + 8 * (i >> 1);
    qf[i] = rr < L ? *reinterpret_cast<const uint32_t*>(q + base + rr * row +
                                                        col)
                   : 0u;
  }
  // rows r0 and r0 + 8: the running max, and the lane's part of the
  // running sum (its quad adds the parts at the end)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];  // O[64 rows][16]: acc[4 n + i], n-tile n = columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // S, then P, of a tile: sc[4 n + i] holds keys 8 n..
  uint32_t pa[BK / 16][4];  // P as bf16 A fragments: keys 16 kk..
  float alpha[2];

  // S = Q K^T of tile j, one wgmma (K K-major, 32-byte rows), issued
  // (committed, not waited for)
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
    const uint64_t dk = desc_rows(sk + s * kTile, kRow);
    mbar_wait(k_full(s), (j / STAGES) & 1);
    wgmma_fence();
    mma_s<BK>(sc, qf, dk);
    wgmma_commit();
  };
  // O += P V of tile j (pa), issued: V is the MN-major B operand (keys =
  // rows, d contiguous: one 16-column atom), 16 keys (512 bytes) a step
  auto issue_pv = [&](int j) {
    const int s = j % STAGES;
    const uint64_t dv = desc_rows(sv + s * kTile, kRow);
    mbar_wait(v_full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_m64n16k16_rs_mn(acc, pa[kk], dv + 32 * kk, 1);
    wgmma_commit();
  };
  // the online softmax of tile j's S (rows g and g + 8, log2 units):
  // p = 2^(s c - m) in place, the rows' max and sums, and the factors
  // alpha that rescale O; a row's BK values sit in the lane's quad
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > L) {  // the K tail (zeros from TMA): masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * n + 2 * r + e];
          x = exp2_ftz(fmaf(x, c, -m_new));
          sum += x;
        }
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
  };
  // O *= alpha, then P's accumulator fragments of n-tiles 2 kk and
  // 2 kk + 1, rounded to bf16 and packed, are the A fragment of keys 16 kk..
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    fence_regs(acc);  // written before the next wgmma.fence
    fence_regs(pa);
  };
  // As flash_fwd_d64_bf16, the warpgroup overlaps its own exponentials
  // with its products: S of tile j and P V of tile j - 1 are issued
  // together, and the softmax of tile j runs while P V is on the tensor
  // cores (wgmma groups complete in the order issued); the other blocks of
  // the SM run theirs meanwhile.
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(k_empty(0));
  softmax(0);
  rescale_and_pack();
  for (int j = 1; j < nk; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S of tile j (P V may still run)
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(j % STAGES));
    softmax(j);
    wgmma_wait<0>();  // P V of tile j - 1: acc and pa are free
    fence_regs(acc);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty((j - 1) % STAGES));
    rescale_and_pack();
  }
  issue_pv(nk - 1);
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int rr = r0 + 8 * r;
    if (rr >= L) continue;
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    bf16_t* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<bf16_t>(out + 8 * n, acc[4 * n + 2 * r] * inv,
                     acc[4 * n + 2 * r + 1] * inv);
  }
}

// static shared memory: no cudaFuncSetAttribute, so a launch is two tensor
// maps and the launch
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, true, B, L, H, D, D, BK) ||
      !tensor_map(&tv, v, true, B, L, H, D, D, BK))
    return cudaErrorInvalidValue;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d16_bf16<<<grid, NT, 0, stream>>>(
      static_cast<const bf16_t*>(q), tk, tv, static_cast<bf16_t*>(o), lse, L,
      H, scale);
  return cudaGetLastError();
}

}  // namespace d16_bf16

// bf16 at d = 64 on wgmma (header). One block: (128-row q tile blockIdx.x,
// b*h blockIdx.y), two consumer warpgroups, each owning 64 q rows of the
// tile and keeping their scores, softmax state and output in registers,
// and a producer warp (one thread issues every TMA load).
namespace d64_bf16 {

using rdeic_flash::bf16::bf16_t;
using namespace rdeic_flash::hopper;
constexpr int D = 64, BQ = 128, BK = 128, STAGES = 4, NT = 384;
// two consumer warpgroups (warps 0-7), then the producer warpgroup, whose
// registers setmaxnreg gives to the consumers. setmaxnreg.inc waits until
// the block itself has freed the registers it asks for, so the producer's
// release must cover the consumers' raise at the launch's 168 registers
// (ptxas may launch a kernel with fewer registers than its bound allows:
// check its log)
constexpr int kLaunchRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kLaunchRegs == ((65536 / NT) & ~7), "one block an SM");
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  256 * (kConsumerRegs - kLaunchRegs),
              "registers per block");
constexpr uint32_t kTileQ = 64 * D * 2;   // bytes: one consumer's 64 q rows
constexpr uint32_t kTileKV = BK * D * 2;  // bytes: one K or V tile
// Q, then the K ring, then the V ring, from a 1024-byte-aligned base
constexpr int kSmemBytes = 1024 + 2 * kTileQ + 2 * STAGES * kTileKV;
static_assert(kSmemBytes <= 232448, "shared memory per block");

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d64_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16_t* __restrict__ o, float* __restrict__ lse, int L,
                       int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::pack;
  extern __shared__ unsigned char smem_d64b[];
  // q_full, then per stage k_full, k_empty, v_full, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  const uint32_t sq = (smem_u32(smem_d64b) + 1023) & ~1023u;
  const uint32_t sk = sq + 2 * kTileQ, sv = sk + STAGES * kTileKV;
  const uint32_t q_full = smem_u32(bars);
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer: one thread keeps the ring full, a tile's K ahead of
    // its V so S can start first
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, 2 * kTileQ);
      tma_load_4d(sq, &tq, q_full, 0, h, q0, b);
      tma_load_4d(sq + kTileQ, &tq, q_full, 0, h, q0 + 64, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t free = ((j / STAGES) & 1) ^ 1;  // round 0 passes
        mbar_wait(k_empty(s), free);
        mbar_expect_tx(k_full(s), kTileKV);
        tma_load_4d(sk + s * kTileKV, &tk, k_full(s), 0, h, j * BK, b);
        mbar_wait(v_empty(s), free);
        mbar_expect_tx(v_full(s), kTileKV);
        tma_load_4d(sv + s * kTileKV, &tv, v_full(s), 0, h, j * BK, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;  // consumer 0 or 1: q rows 64 wg..
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2
  const uint64_t dq = desc(sq + wg * kTileQ);
  // rows g (r = 0) and g + 8 (r = 1) of warp w's 16: the running max, and
  // the lane's part of the running sum (its quad adds the parts at the end)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];  // O[64 rows][64]: acc[4 n + i], n-tile n = columns 8 n..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // S, then P, of a tile: sc[4 n + i] holds keys 8 n..
  uint32_t pa[BK / 16][4];  // P as bf16 A fragments: keys 16 kk..
  float alpha[2];

  // S = Q K^T of tile j, 64 x 128, issued (committed, not waited for)
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
    const uint64_t dk = desc(sk + s * kTileKV);
    mbar_wait(k_full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
  };
  // O += P V of tile j (pa), issued: V is the MN-major B operand (keys =
  // rows, d contiguous), 16 rows a step
  auto issue_pv = [&](int j) {
    const int s = j % STAGES;
    const uint64_t dv = desc(sv + s * kTileKV, kTileKV);
    mbar_wait(v_full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_m64n64k16_rs_mn(acc, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
  };
  // the online softmax of tile j's S (rows g and g + 8, log2 units):
  // p = 2^(s c - m) in place, the rows' max and sums, and the factors
  // alpha that rescale O; a row's 128 values sit in the lane's quad
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * n + 2 * r + e];
          x = exp2_ftz(fmaf(x, c, -m_new));
          sum += x;
        }
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
  };
  // O *= alpha, then P's accumulator fragments of n-tiles 2 kk and
  // 2 kk + 1, rounded to bf16 and packed, are the A fragment of keys 16 kk..
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    fence_regs(acc);  // written before the next wgmma.fence
    fence_regs(pa);
  };

  // Each warpgroup overlaps its own exponentials with its products: S of
  // tile j and P V of tile j - 1 are issued together, and the softmax of
  // tile j runs while P V is on the tensor cores (wgmma groups complete in
  // the order issued).
  mbar_wait(q_full, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(k_empty(0));
  softmax(0);
  rescale_and_pack();
  for (int j = 1; j < nk; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S of tile j (P V may still run)
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(j % STAGES));
    softmax(j);
    wgmma_wait<0>();  // P V of tile j - 1: acc and pa are free
    fence_regs(acc);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty((j - 1) % STAGES));
    rescale_and_pack();
  }
  issue_pv(nk - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int rr = q0 + 64 * wg + 16 * w + g + 8 * r;
    if (rr >= L) continue;
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    bf16_t* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<bf16_t>(out + 8 * n, acc[4 * n + 2 * r] * inv,
                     acc[4 * n + 2 * r + 1] * inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, true, B, L, H, D, D, 64) ||
      !tensor_map(&tk, k, true, B, L, H, D, D, BK) ||
      !tensor_map(&tv, v, true, B, L, H, D, D, BK))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_d64_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d64_bf16<<<grid, NT, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16_t*>(o), lse, L, H, scale);
  return cudaGetLastError();
}

}  // namespace d64_bf16

// bf16 at d = 512 on wgmma (header). One block: (64-row q tile blockIdx.x,
// b*h blockIdx.y), two consumer warpgroups, each owning one half of d (its
// 64 rows' partial scores over that half, and that half of O in
// registers), and a producer warp (one thread issues every TMA load).
namespace d512_bf16 {

using rdeic_flash::bf16::bf16_t;
using namespace rdeic_flash::hopper;
constexpr int D = 512, DH = D / 2, BQ = 64, BK = 32, STAGES = 2, NT = 384;
// two consumer warpgroups (warps 0-7), then the producer warpgroup, whose
// registers setmaxnreg gives to the consumers (as in d64_bf16: the
// producer's release covers the consumers' raise from the launch's 168)
constexpr int kLaunchRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kLaunchRegs == ((65536 / NT) & ~7), "one block an SM");
static_assert(128 * (kLaunchRegs - kProducerRegs) >=
                  256 * (kConsumerRegs - kLaunchRegs),
              "registers per block");
constexpr uint32_t kBoxQ = BQ * 128;           // 64 rows x 64 bf16 of d
constexpr uint32_t kBoxKV = BK * 128;          // 32 keys x 64 bf16 of d
constexpr uint32_t kTileQ = (D / 64) * kBoxQ;  // 64 KB
constexpr uint32_t kTileKV = (D / 64) * kBoxKV;  // 32 KB
// a tile's partial scores of both consumers (16 floats a thread; float4 i
// of thread tc of consumer c at 8192 c + 2048 i + 16 tc); two buffers, a
// tile's by its parity
constexpr uint32_t kX = 2 * 128 * 16 * 4;
// Q, the K ring, the V ring, the exchange buffers, from a 1024-byte-aligned
// base
constexpr int kSmemBytes = 1024 + kTileQ + 2 * STAGES * kTileKV + 2 * kX;
static_assert(kSmemBytes <= 232448, "shared memory per block");

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d512_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16_t* __restrict__ o, float* __restrict__ lse, int L,
                        int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::pack;
  extern __shared__ unsigned char smem_d512b[];
  // q_full, then per stage k_full, k_empty, v_full, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  const uint32_t sq = (smem_u32(smem_d512b) + 1023) & ~1023u;
  unsigned char* const p0 = smem_d512b + (sq - smem_u32(smem_d512b));
  const uint32_t sk = sq + kTileQ, sv = sk + STAGES * kTileKV;
  const uint32_t sx = sv + STAGES * kTileKV;
  const uint32_t q_full = smem_u32(bars);
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nk = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer: one thread keeps the ring full, a tile's K ahead of
    // its V so S can start first; a 512-wide row is 8 boxes of 64
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, kTileQ);
#pragma unroll
      for (int a = 0; a < D / 64; ++a)
        tma_load_4d(sq + a * kBoxQ, &tq, q_full, 64 * a, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t free = ((j / STAGES) & 1) ^ 1;  // round 0 passes
        mbar_wait(k_empty(s), free);
        mbar_expect_tx(k_full(s), kTileKV);
#pragma unroll
        for (int a = 0; a < D / 64; ++a)
          tma_load_4d(sk + s * kTileKV + a * kBoxKV, &tk, k_full(s), 64 * a,
                      h, j * BK, b);
        mbar_wait(v_empty(s), free);
        mbar_expect_tx(v_full(s), kTileKV);
#pragma unroll
        for (int a = 0; a < D / 64; ++a)
          tma_load_4d(sv + s * kTileKV + a * kBoxKV, &tv, v_full(s), 64 * a,
                      h, j * BK, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;  // consumer 0 or 1: d 256 wg..
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const int tc = threadIdx.x & 127;  // the thread within its warpgroup
  const float c = scale * kLog2e;     // scores in log2 units, for ex2
  // Q's and each K tile's half of d: boxes 4 wg.. (K-major); V's half: the
  // four boxes from 4 wg, the MN-major B of a 256-wide product (the
  // descriptor's leading byte offset steps a box)
  const uint32_t qh = sq + 4 * wg * kBoxQ;
  // rows g (r = 0) and g + 8 (r = 1) of warp w's 16: the running max, and
  // the lane's part of the running sum (its quad adds the parts at the end)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[DH / 2];  // O[64 rows][256]: acc[4 n + i], columns 256 wg + 8 n..
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];  // S, then P, of a tile: sc[4 n + i] holds keys 8 n..
  uint32_t pa[BK / 16][4];  // P as bf16 A fragments: keys 16 kk..
  float alpha[2];

  // this warpgroup's partial S = Q K^T of tile j over its half of d,
  // 64 x 32 from zero in 16 steps of 16, issued (committed, not waited for)
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
    const uint32_t kh = sk + s * kTileKV + 4 * wg * kBoxKV;
    mbar_wait(k_full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t step = 32 * (kk & 3);
      mma_m64n32k16_ss(sc, desc(qh + (kk >> 2) * kBoxQ + step),
                       desc(kh + (kk >> 2) * kBoxKV + step), kk);
    }
    wgmma_commit();
  };
  // O += P V of tile j (pa) over this warpgroup's half of d, issued: V is
  // the MN-major B operand (keys = rows, d contiguous), 16 rows a step
  auto issue_pv = [&](int j) {
    const int s = j % STAGES;
    const uint64_t dv = desc(sv + s * kTileKV + 4 * wg * kBoxKV, kBoxKV);
    mbar_wait(v_full(s), (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_m64n256k16_rs_mn(acc, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
  };
  // the halves' partial S join in fp32, p0 + p1 in both warpgroups, so
  // both hold the same S and the same P; a buffer is written again two
  // tiles on, after both have passed the next tile's barrier, which each
  // does after its reads of this one
  auto exchange = [&](int j) {
    unsigned char* const xb = p0 + (sx - sq) + (j & 1) * kX + 16 * tc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(xb + (kX / 2) * wg + 2048 * i) =
          make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
    named_sync(1, 256);  // the two consumers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x0 = *reinterpret_cast<const float4*>(xb + 2048 * i);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xb + kX / 2 + 2048 * i);
      sc[4 * i] = x0.x + x1.x, sc[4 * i + 1] = x0.y + x1.y;
      sc[4 * i + 2] = x0.z + x1.z, sc[4 * i + 3] = x0.w + x1.w;
    }
  };
  // the online softmax of tile j's S (rows g and g + 8, log2 units):
  // p = 2^(s c - m) in place, the rows' max and sums, and the factors
  // alpha that rescale O; a row's 32 values sit in the lane's quad
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * n + 2 * r + e];
          x = exp2_ftz(fmaf(x, c, -m_new));
          sum += x;
        }
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
  };
  // O *= alpha, then P's accumulator fragments of n-tiles 2 kk and
  // 2 kk + 1, rounded to bf16 and packed, are the A fragment of keys 16 kk..
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    fence_regs(acc);  // written before the next wgmma.fence
    fence_regs(pa);
  };

  // As in d64_bf16, each warpgroup overlaps its exchange and exponentials
  // with its products: S of tile j and P V of tile j - 1 are issued
  // together, and the exchange and softmax of tile j run while P V is on
  // the tensor cores (wgmma groups complete in the order issued).
  mbar_wait(q_full, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(k_empty(0));
  exchange(0);
  softmax(0);
  rescale_and_pack();
  for (int j = 1; j < nk; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S of tile j (P V may still run)
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(j % STAGES));
    exchange(j);
    softmax(j);
    wgmma_wait<0>();  // P V of tile j - 1: acc and pa are free
    fence_regs(acc);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty((j - 1) % STAGES));
    rescale_and_pack();
  }
  issue_pv(nk - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D + DH * wg;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int rr = q0 + 16 * w + g + 8 * r;
    if (rr >= L) continue;
    if (lse != nullptr && wg == 0 && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    bf16_t* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      store2<bf16_t>(out + 8 * n, acc[4 * n + 2 * r] * inv,
                     acc[4 * n + 2 * r + 1] * inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, true, B, L, H, D, 64, BQ) ||
      !tensor_map(&tk, k, true, B, L, H, D, 64, BK) ||
      !tensor_map(&tv, v, true, B, L, H, D, 64, BK))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_d512_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d512_bf16<<<grid, NT, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16_t*>(o), lse, L, H, scale);
  return cudaGetLastError();
}

}  // namespace d512_bf16

// dtype: 0 = float32, 1 = bfloat16
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             void* scratch, int B, int L, int H, int D, int dtype,
             float scale, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const bool fp32 = dtype == 0;
  switch (D) {
    case 16:
      return fp32 ? d16::launch(q, k, v, o, lse, scratch, B, L, H, scale,
                                stream)
                  : d16_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 64:
      return fp32 ? d64::launch(q, k, v, o, lse, B, L, H, scale, stream)
                  : d64_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 512:
      return fp32 ? d512::launch(q, k, v, o, lse, B, L, H, scale, stream)
                  : d512_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// The scratch bytes a call needs (device memory the caller allocates and
// passes as `scratch`): the fp32 d = 16 forward's operand images, else 0.
int64_t rdeic_flash_attn_fwd_scratch_bytes(int B, int L, int H, int D,
                                           int dtype) {
  return D == 16 && dtype == 0 ? d16::scratch_bytes(B, L, H) : 0;
}

// dtype: 0 = float32, 1 = bfloat16; lse may be null; scratch holds
// rdeic_flash_attn_fwd_scratch_bytes (null if 0). Returns 0, a cudaError_t,
// or -1 for a head dim or dtype this file was not built for.
int rdeic_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int L, int H, int D, int dtype,
                         float scale, void* stream, void* scratch) {
  return dispatch(q, k, v, o, static_cast<float*>(lse), scratch, B, L, H, D,
                  dtype, scale, static_cast<cudaStream_t>(stream));
}

const char* rdeic_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
