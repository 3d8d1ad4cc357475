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
// own on the bf16 tensor cores at every head dim (flash_fwd_d16_bf16,
// flash_fwd_d64_bf16, flash_fwd_d512_bf16; "bf16", further below).
//
// d = 16 (the control branch's attention: [1, 6144, 4, 16] and
// [1, 1536, 8, 16] per denoiser call at 768x512, [2, 4096, 4, 16] and
// [2, 1024, 8, 16] with lse in training) runs flash_fwd_d16 on the tensor
// cores, with mma.sync and the 3xTF32 split of flash_mma.cuh:
// - 64-row q tiles of 4 warps, 16 q rows a warp, scores, running max and
//   sum and the 16 x 16 output in registers, row reductions as quad
//   shuffles, Q split once into big and small A fragments (2 k-steps x 4
//   registers x 2). A second set of 4 warps takes the other half of every
//   128-key tile for the same rows (8 warps a block), and the two halves
//   merge their (max, sum, output) through shared memory at the end: the
//   short serving shape [1, 1536, 8, 16] has only 192 tiles of 64 rows for
//   132 SMs, and the halves double the warps in flight at every shape.
// - K and V: 128-key tiles (64 bytes a row in fp32) double-buffered by
//   cp.async, zero-filled past L, row stride 20 floats: the ldmatrix
//   phases of Q and K and V's row-pair reads (rows 2t, 2t + 1) all hit 32
//   banks without a swizzle.
// - P as A: a permuted k order (k-slot t is key 2t, slot t + 4 key
//   2t + 1), so S's C fragment is P V's A fragment without a shuffle.
// - At d = 16 the softmax is no longer small beside the products: per 16
//   rows x 8 keys a warp issues 12 mma (6 for S, 6 for P V)
//   against 128 exponentials and ~14 fp32-pipe operations a score (max,
//   exponential, sum, the splits of K, V and P). So log2(e) is folded into
//   the scale and the exponential is one exp2f of one fmaf (max(s) * c is
//   the row max of the scaled scores, c > 0), and lse is m ln 2 + ln l.
// - mma.sync rounds the sum it returns toward zero: each tile's P V sums
//   from zero into a partial that joins the rescaled accumulator in fp32,
//   so the error does not grow with L.
// - Grid (q tiles, b*h), two blocks of 45 KB and 256 threads per SM:
//   [1, 1536, 8, 16] gives 192 blocks for 264 slots (one wave),
//   [1, 6144, 4, 16] 384.
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
// d = 512 (the VAE mid-block, [1, 6144, 1, 512] per served image and
// [2, 4096, 1, 512] with lse in refine training) runs its own kernel,
// flash_fwd_d512, on the tensor cores: TF32 mma.sync (m16n8k8) with fp32
// accumulators, each fp32 product taken as three TF32 products (3xTF32,
// flash_mma.cuh), because one TF32 pass misses the fp32 limit of 2e-5 by
// ten times while the split lands beside plain fp32.
// - Tiles: 32 q rows and 32 k rows. Q, K and V live in shared memory as fp32
//   in the swizzled layout of flash_mma.cuh (stride D + 8, column XOR
//   (row & 4)), so the fragment loads of every role hit 32 banks: 3 x 65 KB,
//   plus the four partial score tiles (20 KB) and P, 220 KB of the 227 KB
//   a block may use; one block of 8 warps per SM.
// - Score phase: warp w sums S = Q K^T over quarter w >> 1 of d for the
//   16 x 32 patch at rows 16 (w & 1).. (one ldmatrix.x4 for A and two for
//   the four n-tiles of B per 8 of d; the split of A serves 4 n-tiles). The
//   four partial tiles meet in shared memory, where all 256 threads take 4
//   entries each, add the partials and run the softmax (8 lanes a row,
//   shuffles).
// - P V phase: warp w owns the 32 x 64 slice of O at d = 64 w..: 64 fp32
//   accumulators a thread in registers; each 8 of k loads and splits 4
//   values of P and 16 of V for 48 mma.
// - Copies: fp32 tiles come by cp.async.cg, 16 bytes a lane, zero-filled past
//   L. K and V have one buffer each and take turns: the next K tile is
//   copied while the softmax and P V run, the next V tile while the next
//   score phase runs.
// - Grid: one block per (32-row q tile, b*h): [1, 6144, 1, 512] gives 192
//   blocks on 132 SMs, 1.45 waves, so the second wave runs 60 blocks on 132
//   SMs and the tail costs up to 27% of the kernel's time; [2, 4096, 1, 512]
//   gives 256 blocks, 1.94 waves.
// - ptxas -v: 198 registers, no spills.
// What it does about the FMA design it replaces: tensor cores in place of
// fp32 FMA; 16-byte asynchronous copies that overlap compute in place of
// element loads through registers; 0.25 shared-memory loads per mma in the
// score phase and 0.4 in P V, against 2 loads per FMA. What holds it back
// now: 3 TF32 mma and the split (3 integer and fp32 operations a value)
// per fp32 product, mma.sync's rate on Hopper (wgmma is the full-rate
// instruction), and one block of 8 warps per SM to hide their latency.
//
// bf16 (the `--bf16` serving path: [1, 6144, 5, 64] and [1, 1536, 10, 64]
// ten times an image each, [1, 6144, 4, 16] and [1, 1536, 8, 16] four times
// each, [1, 6144, 1, 512] twice; with lse where training calls them) runs
// flash_fwd_d16_bf16 and flash_fwd_d512_bf16, built from the pieces of
// flash_bf16.cuh, and flash_fwd_d64_bf16 (the Hopper design above; the
// points on P and the softmax below hold for it too):
// - Tiles stay bf16 in shared memory, half the bytes of the fp32 tiles the
//   template widened them to, in a swizzled layout (chunk c of a row at
//   c ^ (row & 7); at d = 16, whose rows hold 2 chunks, c ^ ((row >> 2) & 1))
//   that puts every copy and every ldmatrix phase, with and without .trans,
//   on 32 banks. cp.async.cg copies 16 bytes (8 values) a
//   lane, zero-filled past L, so the next tiles are in flight while the
//   current ones are used.
// - Products: mma.sync m16n8k16 with bf16 operands and fp32 accumulators,
//   twice the depth and rate of TF32 m16n8k8. A and K's B fragments come by
//   ldmatrix.x4, V's by ldmatrix.x4.trans. bf16 products are exact in fp32,
//   so S = Q K^T takes one pass.
// - P as A: the C fragments of two adjacent 8-key tiles, rounded to bf16
//   and packed pairwise, are P V's A fragment as they stand.
// - P's precision: one bf16 term. The rule: one term only if it reads at
//   most half the card's limit (two bf16 ulps of max|plain|, so one ulp)
//   at every path shape and at L = 1000 and 8192; otherwise two (hi =
//   bf16(P), lo = bf16(P - hi)). The CPU emulation of these kernels
//   (tests/test_torch_port_flash_bf16.py) reads one term at 0.5-1.0 ulp
//   after the bf16 store (0.2-0.3 ulp before it) and two terms at 0.25-0.5;
//   the card reads one term at 0.5-1.0 ulp at every path and check shape
//   (chip_smoke.py phase 9, NVIDIA H100 80GB HBM3 at 700 W).
// - The softmax runs in log2 units, one fmaf and one ex2.approx.ftz a score
//   (subnormal p flush to 0), and lse = m ln 2 + ln l.
// - mma.sync and wgmma round their sums toward zero (wgmma also cuts each
//   term two bits below the largest one's ulp: tools/wgmma_probe.py). With
//   P in one bf16 term, P's own rounding outweighs that ~100 times
//   (emulation), so P V sums into one accumulator over the whole L,
//   without the per-tile partials of the fp32 kernels at d = 16 and 64
//   (the emulation reads the same at d = 16).
// d = 16: 64-row q tiles of 4 warps, 16 q rows a warp (one A fragment holds
// all of d, loaded once), 128-key tiles in a ring of three K / V buffers
// (one barrier a tile), 26 KB of static shared memory, four blocks per SM:
// [1, 6144, 4, 16] gives 384 blocks and [1, 1536, 8, 16] 192, one wave
// each, so the fp32 kernel's key halves are not needed (with them, twice
// the warps in flight, a probe ran no faster). Per 16 rows x 16 keys a
// warp issues 4 mma (2 for S, 2 for P V) and 2 ldmatrix against 256
// exponentials, so the MUFU (16 ex2 a clock per SM) sets the floor:
// B H L^2 / (16 x 132 SMs x 1.98 GHz), 0.036 ms at [1, 6144, 4, 16], ~4x
// the tensor-core bound. The kernel reaches about half of that floor
// (PERF.md §6); moving part of the exponentials to the FMA pipe as a
// polynomial was slower in probes, so the MUFU is not the limit alone.
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
// d = 512: 64-row q tiles of 16 warps (512 threads, 128 registers each, one
// block per SM) share each 32-key K and V tile (154 KB with Q, the partial
// scores and P): [1, 6144, 1, 512] gives 96 blocks and [2, 4096, 1, 512]
// 128, one wave on 132 SMs. Score phase: warp (rows 16 rq.., keys 16 kh..,
// d half dh) sums its 16 x 16 patch over 256 of d (one ldmatrix of Q and
// one of K a step for two mma); the two d halves meet in shared memory as
// fp32, where 8 threads a row run the softmax and store P as bf16. P V
// phase: warp owns O[32 rows, 64 of d] (64 accumulators a thread), P's A
// fragments by ldmatrix, V's by ldmatrix.trans, each V fragment serving two
// m-tiles. K and V take turns in one buffer each, as in the fp32 kernel.
// Reach (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), against the bf16
// bound and SDPA's bf16 call: see PERF.md §6. What holds the mma.sync
// kernels (d = 16, 512) back now: mma.sync and ldmatrix issue, the
// softmax's fp32 and MUFU work in the same warps between them, and at
// d = 512 one block of 16 warps per SM with three barriers a tile; the
// d = 64 design above is the route for them.
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

// d = 512 on the tensor cores (header). One block: (q tile blockIdx.x,
// b*h blockIdx.y), 256 threads.
namespace d512 {

constexpr int D = 512, BQ = 32, BK = 32, NT = 256;
constexpr int TS = D + 8;  // D-wide tile stride (swizzled, flash_mma.cuh)
constexpr int PS = 36;     // P: 4 mod 32, A-operand reads hit 32 banks
constexpr int XS = 40;     // partial scores: 8 mod 32, float2 writes ditto
constexpr int kSmemFloats =
    3 * BQ * TS + 4 * BQ * XS + BQ * PS + 2 * BQ;
static_assert(kSmemFloats * 4 <= 232448, "shared memory per block");

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d512(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 operands are exact in TF32
  extern __shared__ __align__(16) float smem_tc[];
  float* qs = smem_tc;             // [BQ][TS]
  float* ks = qs + BQ * TS;        // [BK][TS]
  float* vs = ks + BK * TS;        // [BK][TS]
  float* xs = vs + BK * TS;        // [4 quarters of d][BQ][XS]
  float* ps = xs + 4 * BQ * XS;    // [BQ][PS]
  float* alpha_s = ps + BQ * PS;   // [BQ]
  float* l_s = alpha_s + BQ;       // [BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rh = warp & 1, quarter = warp >> 1;  // rows 16 rh.., d quarter
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const T* kb = k + base;
  const T* vb = v + base;

  load_rows<T, BQ, D, NT>(qs, q + base, q0, L, row);
  load_rows<T, BK, D, NT>(ks, kb, 0, L, row);
  cp_async_commit();
  load_rows<T, BK, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();

  // softmax: thread (r, 4 columns from c); a row's 8 threads share a warp
  const int r = tid >> 3, c = (tid & 7) * 4;
  float m_run = kNegInf, l_run = 0.f;
  float acc[2][8][4];  // O[0..32, 64 warp..]
  zero(acc);

  for (int k0 = 0; k0 < L; k0 += BK) {
    cp_async_wait<1>();  // Q and this K tile (this V tile may be in flight)
    __syncthreads();
    {
      float sx[1][4][4];
      zero(sx);
      warp_mma<1, 4, D / 32, kSplit, kSplit>(
          sx, RowA<TS, true>(qs, rh * 16, quarter * (D / 4)),
          RowB<TS>(ks, 0, quarter * (D / 4)));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store_frag<XS>(xs + quarter * BQ * XS, sx[0][nt], rh * 16, nt * 8);
    }
    __syncthreads();
    if (k0 + BK < L) load_rows<T, BK, D, NT>(ks, kb, k0 + BK, L, row);
    cp_async_commit();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float4 x =
          *reinterpret_cast<const float4*>(xs + (qq * BQ + r) * XS + c);
      s[0] += x.x, s[1] += x.y, s[2] += x.z, s[3] += x.w;
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = k0 + c + j < L ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    *reinterpret_cast<float4*>(ps + r * PS + c) =
        make_float4(s[0], s[1], s[2], s[3]);
    if (c == 0) {
      alpha_s[r] = alpha;
      l_s[r] = l_run;
    }
    cp_async_wait<1>();  // this V tile (the next K tile may be in flight)
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a_lo = alpha_s[mt * 16 + g], a_hi = alpha_s[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][0] *= a_lo, acc[mt][nt][1] *= a_lo;
        acc[mt][nt][2] *= a_hi, acc[mt][nt][3] *= a_hi;
      }
    }
    warp_mma<2, 8, BK / 8, true, kSplit>(acc, RowA<PS, false>(ps, 0, 0),
                                         ColB<TS>(vs, warp * (D / 8), 0));
    __syncthreads();  // done with vs and ps
    if (k0 + BK < L) load_rows<T, BK, D, NT>(vs, vb, k0 + BK, L, row);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (lse != nullptr && c == 0 && q0 + r < L)
    lse[static_cast<int64_t>(blockIdx.y) * L + q0 + r] =
        m_run + logf(fmaxf(l_run, 1e-30f));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = mt * 16 + g + half * 8;
      if (q0 + rr >= L) continue;
      const float inv = 1.f / fmaxf(l_s[rr], 1e-30f);
      T* out = o + base + (q0 + rr) * row + warp * (D / 8) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store2<T>(out + nt * 8, acc[mt][nt][2 * half] * inv,
                  acc[mt][nt][2 * half + 1] * inv);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_fwd_d512<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d512<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, scale);
  return cudaGetLastError();
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

// d = 16 on the tensor cores (header). One block: (64-row q tile
// blockIdx.x, b*h blockIdx.y), 8 warps: warp w takes q rows 16 (w & 3).. of
// the tile and keys 64 (w >> 2).. of every 128-key tile.
namespace d16 {

constexpr int D = 16, BQ = 64, BK = 128, HK = BK / 2, NT = 256;
constexpr int S = D + 4;  // Q, K and V tiles: 20 mod 32 banks (header)
constexpr int kSmemFloats = BQ * S + 2 * 2 * BK * S;
constexpr int kMergeFloats = 4 * 32 * 12;  // a lane's state of key half 1
static_assert(kMergeFloats <= 2 * BK * S, "the merge reuses the K tiles");
static_assert(2 * kSmemFloats * 4 <= 232448, "two blocks per SM");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    flash_fwd_d16(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 operands are exact in TF32
  extern __shared__ __align__(16) float smem_d16[];
  float* qs = smem_d16;          // [BQ][S]
  float* ks = qs + BQ * S;       // [2 buffers][BK][S]
  float* vs = ks + 2 * BK * S;   // [2 buffers][BK][S]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, half = warp >> 2;  // q rows 16 rw.., key half
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for exp2f

  load_rows<T, BQ, D, NT, S, false>(qs, q + base, q0, L, row);
  load_rows<T, BK, D, NT, S, false>(ks, kb, 0, L, row);
  load_rows<T, BK, D, NT, S, false>(vs, vb, 0, L, row);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as A fragments for the whole K loop, split once
  uint32_t qb[D / 8][4], qsm[D / 8][4];
  {
    const RowA<S, false> ra(qs, rw * 16, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float a[1][4];
      ra.load(a, kk * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split<kSplit>(a[0][i], qb[kk][i], qsm[kk][i]);
    }
  }

  // rows g (r = 0) and g + 8 (r = 1) of the warp's 16, over its key half
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];  // O[16 rows][16]: n-tile n holds columns 8 n..
  zero(acc);
  const int nk = (L + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int cur = j & 1, k0 = j * BK + half * HK;  // this warp's first key
    if (j + 1 < nk) {  // the next pair lands while this one is used
      load_rows<T, BK, D, NT, S, false>(ks + (cur ^ 1) * BK * S, kb,
                                        (j + 1) * BK, L, row);
      load_rows<T, BK, D, NT, S, false>(vs + (cur ^ 1) * BK * S, vb,
                                        (j + 1) * BK, L, row);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this pair (the next may be in flight)
    __syncthreads();
    if (k0 < L) {  // a key half wholly past L has nothing to add
      const float* kt = ks + (cur * BK + half * HK) * S;
      const float* vt = vs + (cur * BK + half * HK) * S;

      // S = Q K^T, 16 x 64: n-tile n holds keys k0 + 8 n..
      float s[HK / 8][4];
      zero(s);
      {
        const RowB<S, false> rb(kt, 0, 0);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          float bf[HK / 8][2];
          rb.load(bf, kk * 8);
#pragma unroll
          for (int n = 0; n < HK / 8; ++n) {
            uint32_t bb[2], bs[2];
            split<kSplit>(bf[n][0], bb[0], bs[0]);
            split<kSplit>(bf[n][1], bb[1], bs[1]);
            if (kSplit) mma_tf32(s[n], qsm[kk], bb);
            if (kSplit) mma_tf32(s[n], qb[kk], bs);
            mma_tf32(s[n], qb[kk], bb);
          }
        }
      }
      if (k0 + HK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
        for (int n = 0; n < HK / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + 8 * n + 2 * t + (i & 1) >= L) s[n][i] = kNegInf;
      }

      // online softmax of rows g and g + 8 in log2 units: x = s * c - m,
      // p = 2^x; a row's 16 values a lane sit in the lane's quad, so the row
      // max and sum are two shuffles. c > 0, so max(s) * c is the max of
      // the scaled scores.
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < HK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * c);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < HK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * r + e];
            x = exp2f(fmaf(x, c, -m_new));
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[r] = exp2f(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }

      // P V of this tile, from zero: mma.sync rounds its sum toward zero,
      // so the tile's 8 steps land in a partial that is added to the
      // rescaled accumulator in fp32, which keeps the error flat in L. The
      // k order inside each 8 keys is permuted (slot t is key 2t, slot
      // t + 4 key 2t + 1), so P's C fragment is its A fragment as it
      // stands (a0..a3 = c0, c2, c1, c3), and V's B fragment reads rows 2t
      // and 2t + 1 (stride S: the 32 lanes hit 32 banks).
      float pv[D / 8][4];
      zero(pv);
#pragma unroll
      for (int kk = 0; kk < HK / 8; ++kk) {
        uint32_t pb[4], ps[4];
        split<true>(s[kk][0], pb[0], ps[0]);
        split<true>(s[kk][2], pb[1], ps[1]);
        split<true>(s[kk][1], pb[2], ps[2]);
        split<true>(s[kk][3], pb[3], ps[3]);
        const float* v0 = vt + (8 * kk + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bb[2], bs[2];
          split<kSplit>(v0[8 * n], bb[0], bs[0]);
          split<kSplit>(v0[S + 8 * n], bb[1], bs[1]);
          mma_tf32(pv[n], ps, bb);
          if (kSplit) mma_tf32(pv[n], pb, bs);
          mma_tf32(pv[n], pb, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = fmaf(acc[n][i], alpha[i >> 1], pv[n][i]);
    }
    __syncthreads();  // every warp is done with this pair before its refill
  }
  cp_async_wait<0>();

  // key half 1 hands its (m, l, O) to half 0 through the K tiles, lane by
  // lane; half 0 merges the two and writes the rows
  float* mine = ks + (rw * 32 + lane) * 12;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float4*>(mine + 4 * n) =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    *reinterpret_cast<float4*>(mine + 8) =
        make_float4(m_run[0], m_run[1], l_run[0], l_run[1]);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 ml = *reinterpret_cast<const float4*>(mine + 8);
  const float m_other[2] = {ml.x, ml.y}, l_other[2] = {ml.z, ml.w};
  float a_self[2], a_other[2], l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = fmaxf(m_run[r], m_other[r]);
    a_self[r] = exp2f(m_run[r] - m);
    a_other[r] = exp2f(m_other[r] - m);
    l_tot[r] = l_run[r] * a_self[r] + l_other[r] * a_other[r];
    m_run[r] = m;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(mine + 4 * n);
    const float other[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[n][i] = acc[n][i] * a_self[i >> 1] + other[i] * a_other[i >> 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = q0 + rw * 16 + g + 8 * r;
    if (rr >= L) continue;
    const float l = fmaxf(l_tot[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    T* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(out + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_fwd_d16<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d16<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, scale);
  return cudaGetLastError();
}

}  // namespace d16

// bf16 at d = 16 on the bf16 tensor cores (header). One block: (64-row q
// tile blockIdx.x, b*h blockIdx.y), 4 warps; warp w owns q rows 16 w.. of
// the tile and keeps their scores, softmax state and output in registers.
namespace d16_bf16 {

using rdeic_flash::bf16::bf16_t;
constexpr int D = 16, BQ = 64, BK = 128, NT = 128;
constexpr int kRow = D * 2;  // bytes of a tile row
// Q, 3 K, 3 V: 26 KB of static shared memory, under the 48 KB a launch
// takes without cudaFuncSetAttribute
constexpr int kSmemBytes = (BQ + 6 * BK) * kRow;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory");
static_assert(4 * (kSmemBytes + 1024) <= 233472, "four blocks per SM");

__global__ void __launch_bounds__(NT, 4)
    flash_fwd_d16_bf16(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                       float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::ldsm_x4,
      bf16::ldsm_x4_trans, bf16::load_tile, bf16::mma, bf16::pack;
  __shared__ __align__(128) bf16_t qs[BQ * D];      // [BQ][D]
  __shared__ __align__(128) bf16_t ks[3 * BK * D];  // [3 buffers][BK][D]
  __shared__ __align__(128) bf16_t vs[3 * BK * D];  // [3 buffers][BK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16::Lane16 ln(lane);
  const uint32_t sq = bf16::smem_addr(qs) + warp * 16 * kRow + ln.a;
  const uint32_t sk = bf16::smem_addr(ks) + ln.b;
  const uint32_t sv = bf16::smem_addr(vs) + ln.a;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const bf16_t* kb = k + base;
  const bf16_t* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2

  load_tile<BQ, D, NT>(qs, q + base, q0, L, row);
  load_tile<BK, D, NT>(ks, kb, 0, L, row);
  load_tile<BK, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();
  const int nk = (L + BK - 1) / BK;
  if (nk > 1) {
    load_tile<BK, D, NT>(ks + BK * D, kb, BK, L, row);
    load_tile<BK, D, NT>(vs + BK * D, vb, BK, L, row);
  }
  cp_async_commit();

  // the warp's 16 q rows as one A fragment (all of d); rows g (r = 0) and
  // g + 8 (r = 1): the running max, and the lane's part of the running sum
  // (its quad adds the four parts at the end)
  uint32_t qf[4];
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];  // O[16 rows][16]: n-tile n holds columns 8 n..
  zero(acc);
  // a ring of three K / V buffers: tile j in buffer j % 3, two in flight
  for (int j = 0, cur = 0; j < nk; ++j, cur = cur == 2 ? 0 : cur + 1) {
    const int k0 = j * BK;
    cp_async_wait<1>();  // this pair (the next may be in flight)
    // every warp sees this pair, and is done with the buffer of tile j - 1,
    // which takes tile j + 2
    __syncthreads();
    if (j + 2 < nk) {
      const int nxt = cur == 0 ? 2 : cur - 1;
      load_tile<BK, D, NT>(ks + nxt * BK * D, kb, k0 + 2 * BK, L, row);
      load_tile<BK, D, NT>(vs + nxt * BK * D, vb, k0 + 2 * BK, L, row);
    }
    cp_async_commit();
    if (j == 0) ldsm_x4(qf, sq);
    const uint32_t kt = sk + cur * BK * kRow, vt = sv + cur * BK * kRow;

    // S = Q K^T, 16 x 128, one m16n8k16 per 8 keys: n-tile n holds keys
    // k0 + 8 n..; one ldmatrix.x4 of K gives both n-tiles of 16 keys
    float s[BK / 8][4];
    zero(s);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t kf[4];
      ldsm_x4(kf, kt + 16 * np * kRow);
      mma(s[2 * np], qf, kf[0], kf[1]);
      mma(s[2 * np + 1], qf, kf[2], kf[3]);
    }
    if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L) s[n][i] = kNegInf;
    }

    // online softmax of rows g and g + 8 in log2 units: p = 2^(s c - m);
    // a row's 128 values sit in the lane's quad, 32 a lane, so the row max
    // is two shuffles
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * r + e];
          x = exp2_ftz(fmaf(x, c, -m_new));
          sum += x;
        }
      const float alpha = exp2_ftz(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P's C fragments of n-tiles 2 kk and 2 kk + 1, rounded to
    // bf16 and packed, are the A fragment of keys 16 kk..; one
    // ldmatrix.x4.trans of V gives b0, b1 of both n-tiles of d
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4], vf[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      ldsm_x4_trans(vf, vt + 16 * kk * kRow);
      mma(acc[0], pa, vf[0], vf[1]);
      mma(acc[1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int rr = q0 + warp * 16 + g + 8 * r;
    if (rr >= L) continue;
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
          m_run[r] * kLn2 + logf(l);
    const float inv = 1.f / l;
    bf16_t* out = o + base + rr * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<bf16_t>(out + 8 * n, acc[n][2 * r] * inv,
                     acc[n][2 * r + 1] * inv);
  }
}

// 26 KB of static shared memory: no cudaFuncSetAttribute, so a launch is
// one call
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d16_bf16<<<grid, NT, 0, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), lse, L, H,
      scale);
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

// bf16 at d = 512 on the bf16 tensor cores (header). One block: (64-row q
// tile blockIdx.x, b*h blockIdx.y), 16 warps.
namespace d512_bf16 {

using rdeic_flash::bf16::bf16_t;
constexpr int D = 512, BQ = 64, BK = 32, NT = 512;
constexpr int kRow = D * 2;  // bytes of a tile row
constexpr int XS = 40;  // partial scores (fp32): 8 mod 32, float2 writes
constexpr int PS = 40;  // P (bf16): 80-byte rows, ldmatrix hits 32 banks
constexpr int kSmemBytes =
    (BQ + 2 * BK) * kRow + 2 * BQ * XS * 4 + BQ * PS * 2 + 2 * BQ * 4;
static_assert(kSmemBytes <= 232448, "shared memory per block");

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_d512_bf16(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                        float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::ldsm_x4,
      bf16::ldsm_x4_trans, bf16::load_tile, bf16::mma, bf16::pack;
  extern __shared__ __align__(128) unsigned char smem_d512b[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_d512b);  // [BQ][D]
  bf16_t* ks = qs + BQ * D;                             // [BK][D]
  bf16_t* vs = ks + BK * D;                             // [BK][D]
  float* xs = reinterpret_cast<float*>(vs + BK * D);    // [2 d halves][BQ][XS]
  bf16_t* ps = reinterpret_cast<bf16_t*>(xs + 2 * BQ * XS);  // [BQ][PS]
  float* alpha_s = reinterpret_cast<float*>(ps + BQ * PS);    // [BQ]
  float* l_s = alpha_s + BQ;                                  // [BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16::Lane ln(lane);
  // score phase: rows 16 rq.., keys 16 kh.., d 256 dh..
  const int rq = warp & 3, kh = (warp >> 2) & 1, dh = warp >> 3;
  const uint32_t sq =
      bf16::smem_addr(qs) + (16 * rq + ln.ar) * kRow + dh * kRow / 2;
  const uint32_t sk =
      bf16::smem_addr(ks) + (16 * kh + ln.br) * kRow + dh * kRow / 2;
  // P V phase: rows 32 rp.., d 64 dp..
  const int rp = warp & 1, dp = warp >> 1;
  const uint32_t sv = bf16::smem_addr(vs) + ln.ar * kRow + dp * 128;
  const uint32_t sp =
      bf16::smem_addr(ps) + (32 * rp + ln.ar) * PS * 2 + (lane >> 4) * 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const bf16_t* kb = k + base;
  const bf16_t* vb = v + base;
  const float c = scale * kLog2e;  // scores in log2 units, for ex2

  load_tile<BQ, D, NT>(qs, q + base, q0, L, row);
  load_tile<BK, D, NT>(ks, kb, 0, L, row);
  cp_async_commit();
  load_tile<BK, D, NT>(vs, vb, 0, L, row);
  cp_async_commit();

  // softmax: thread (r, 4 columns from cc); a row's 8 threads share a warp
  // and the running max; each keeps its part of the running sum, and the 8
  // parts meet at the end
  const int r = tid >> 3, cc = (tid & 7) * 4;
  float m_run = kNegInf, l_run = 0.f;
  float acc[2][8][4];  // O[32 rp.. + 32, 64 dp.. + 64]
  zero(acc);

  for (int k0 = 0; k0 < L; k0 += BK) {
    cp_async_wait<1>();  // Q and this K tile (this V tile may be in flight)
    __syncthreads();
    {
      // this warp's 16 x 16 patch of S over its half of d, from zero
      float sx[2][4];
      zero(sx);
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        const int col = (kk >> 2) * 128;  // bytes of 64 columns
        uint32_t a[4], kf[4];
        ldsm_x4(a, sq + col + ln.ca[kk & 3]);
        ldsm_x4(kf, sk + col + ln.cb[kk & 3]);
        mma(sx[0], a, kf[0], kf[1]);
        mma(sx[1], a, kf[2], kf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        store_frag<XS>(xs + dh * BQ * XS, sx[nt], 16 * rq, 16 * kh + 8 * nt);
    }
    __syncthreads();
    if (k0 + BK < L) load_tile<BK, D, NT>(ks, kb, k0 + BK, L, row);
    cp_async_commit();

    // the halves of d join in fp32; online softmax in log2 units
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 x =
          *reinterpret_cast<const float4*>(xs + (half * BQ + r) * XS + cc);
      s[0] += x.x, s[1] += x.y, s[2] += x.z, s[3] += x.w;
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + cc + j >= L) s[j] = kNegInf;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx * c);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = exp2_ftz(fmaf(s[j], c, -m_new));
      sum += s[j];
    }
    const float alpha = exp2_ftz(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    *reinterpret_cast<uint2*>(ps + r * PS + cc) =
        make_uint2(pack(s[0], s[1]), pack(s[2], s[3]));
    if (cc == 0) alpha_s[r] = alpha;
    cp_async_wait<1>();  // this V tile (the next K tile may be in flight)
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = 32 * rp + 16 * mt + g;
      const float a_lo = alpha_s[r0], a_hi = alpha_s[r0 + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][0] *= a_lo, acc[mt][nt][1] *= a_lo;
        acc[mt][nt][2] *= a_hi, acc[mt][nt][3] *= a_hi;
      }
    }
    // O += P V: P's A fragments by ldmatrix from ps, V's B fragments by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(pa[mt], sp + 16 * mt * PS * 2 + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, sv + 16 * kk * kRow + ln.ca[np]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][2 * np], pa[mt], vf[0], vf[1]);
          mma(acc[mt][2 * np + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // done with vs and ps
    if (k0 + BK < L) load_tile<BK, D, NT>(vs, vb, k0 + BK, L, row);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    l_run += __shfl_xor_sync(0xffffffffu, l_run, off);
  if (cc == 0) l_s[r] = l_run;
  if (lse != nullptr && cc == 0 && q0 + r < L)
    lse[static_cast<int64_t>(blockIdx.y) * L + q0 + r] =
        m_run * kLn2 + logf(fmaxf(l_run, 1e-30f));
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = 32 * rp + 16 * mt + g + 8 * half;
      if (q0 + rr >= L) continue;
      const float inv = 1.f / fmaxf(l_s[rr], 1e-30f);
      bf16_t* out = o + base + (q0 + rr) * row + dp * 64 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store2<bf16_t>(out + nt * 8, acc[mt][nt][2 * half] * inv,
                       acc[mt][nt][2 * half + 1] * inv);
    }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_d512_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d512_bf16<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), lse, L, H,
      scale);
  return cudaGetLastError();
}

}  // namespace d512_bf16

// dtype: 0 = float32, 1 = bfloat16
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int L, int H, int D, int dtype, float scale,
             cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const bool fp32 = dtype == 0;
  switch (D) {
    case 16:
      return fp32 ? d16::launch<float>(q, k, v, o, lse, B, L, H, scale, stream)
                  : d16_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 64:
      return fp32 ? d64::launch(q, k, v, o, lse, B, L, H, scale, stream)
                  : d64_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 512:
      return fp32 ? d512::launch<float>(q, k, v, o, lse, B, L, H, scale, stream)
                  : d512_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; lse may be null. Returns 0, a
// cudaError_t, or -1 for a head dim or dtype this file was not built for.
int rdeic_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int L, int H, int D, int dtype,
                         float scale, void* stream) {
  return dispatch(q, k, v, o, static_cast<float*>(lse), B, L, H, D, dtype,
                  scale, static_cast<cudaStream_t>(stream));
}

const char* rdeic_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
