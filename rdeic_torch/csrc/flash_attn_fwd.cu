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
// cores, shaped as flash_fwd_d64 with the 3xTF32 split of flash_mma.cuh:
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
// - P as A: the permuted k order of flash_fwd_d64, so S's C fragment is
//   P V's A fragment without a shuffle.
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
// in training) runs flash_fwd_d64 on the tensor cores, with the TF32
// mma.sync and the 3xTF32 split of flash_mma.cuh (below), shaped as
// FlashAttention-2:
// - 64-row q tiles, 4 warps; each warp owns 16 q rows and keeps their score
//   fragments (16 x 64 a K tile), running max and sum (rows g and g + 8 of
//   each lane), and the 16 x 64 output accumulator in registers. Row
//   reductions are two shuffles inside a lane's quad; scores never meet in
//   shared memory.
// - Q is split once into big and small TF32 A fragments and held in
//   registers for the whole K loop (64 registers).
// - K and V tiles of 64 rows are double-buffered: cp.async copies the next
//   pair while the current one is used. K is swizzled (stride 72) for
//   ldmatrix; V has stride 68 (4 mod 32 banks).
// - P V needs P in the A layout, which the C layout of S is not. Inside each
//   8 keys the contraction order is permuted (k-slot t is key 2t, slot t + 4
//   key 2t + 1), so the C fragment is the A fragment as it stands, and V's B
//   fragment reads rows 2t and 2t + 1, which stride 68 puts on 32 banks.
// - Every product takes three TF32 passes.
// - The K tail is masked to -1e30 and the output divided by max(l, 1e-30).
// - Grid (q tiles, b*h), two blocks of 88 KB per SM: [1, 1536, 10, 64] gives
//   240 blocks for 264 slots, [1, 6144, 5, 64] 480 (1.8 waves).
//
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
// flash_fwd_d16_bf16, flash_fwd_d64_bf16 and flash_fwd_d512_bf16, built
// from the pieces of flash_bf16.cuh:
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
// - mma.sync rounds its sums toward zero. With P in one bf16 term, P's own
//   rounding outweighs that ~100 times (emulation), so P V sums into one
//   accumulator over the whole L, without the per-tile partials of the
//   fp32 kernel at d = 16 (the emulation reads the same at d = 16).
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
// d = 64: 128-row q tiles of 4 warps, 32 q rows a warp (two m-tiles: each K
// and V fragment serves both, half the ldmatrix a product of 16-row warps),
// 64-key tiles in a ring of three K / V buffers (one barrier a tile), 64 KB
// and 247 registers, two blocks per SM: [1, 6144, 5, 64] gives 240 blocks
// for 264 slots and [1, 1536, 10, 64] 120, one wave each. 128-row q tiles
// halve the K and V tiles each block reads through L2 against 64-row ones.
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
// bound and SDPA's bf16 call: see PERF.md §6. What holds them back now:
// mma.sync and ldmatrix issue (at d = 64 the two products take most of the
// time: a kernel without either ran much faster), the softmax's fp32 and
// MUFU work in the same warps between them, and at d = 512 one block of 16
// warps per SM with three barriers a tile. wgmma
// would take B straight from shared memory at the full 989 TFLOP/s rate,
// with A (Q, or P from registers) for 64 rows a warpgroup, and TMA would
// free the copies' threads; warp-specialised producers and two softmax
// warpgroups in ping-pong would overlap the exponentials with the products.
//
// Bound on the H100: 4*L^2*D*H*B flops (S and P V) and 4*B*L*H*D elements
// of traffic. fp32 runs 3xTF32 on the tensor cores at every head dim, three
// TF32 products for each fp32 one, so the rate is 494.7 / 3 = 165 TFLOP/s;
// bf16 takes the bf16 peak, 989 TFLOP/s. At the main path's L = 1536..6144
// the flops bound every shape, by one to three orders of magnitude.

#include <type_traits>

#include "flash_bf16.cuh"
#include "flash_common.cuh"
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

// d = 64 on the tensor cores (header). One block: (64-row q tile
// blockIdx.x, b*h blockIdx.y), 4 warps; warp w owns q rows 16 w.. of the
// tile and keeps their scores, softmax state and output in registers.
namespace d64 {

constexpr int D = 64, BQ = 64, BK = 64, NT = 128;
constexpr int KS = D + 8;  // Q and K tiles: swizzled (flash_mma.cuh swz)
constexpr int VS = D + 4;  // V tiles: 4 mod 32 banks, read at rows 2t, 2t + 1
constexpr int kSmemFloats = BQ * KS + 2 * BK * KS + 2 * BK * VS;
static_assert(2 * kSmemFloats * 4 <= 232448, "two blocks per SM");

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    flash_fwd_d64(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 operands are exact in TF32
  extern __shared__ __align__(16) float smem_d64[];
  float* qs = smem_d64;           // [BQ][KS]
  float* ks = qs + BQ * KS;       // [2 buffers][BK][KS]
  float* vs = ks + 2 * BK * KS;   // [2 buffers][BK][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const T* kb = k + base;
  const T* vb = v + base;

  load_rows<T, BQ, D, NT>(qs, q + base, q0, L, row);
  load_rows<T, BK, D, NT>(ks, kb, 0, L, row);
  load_rows<T, BK, D, NT, VS, false>(vs, vb, 0, L, row);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as A fragments for the whole K loop, split once
  uint32_t qb[D / 8][4], qsm[D / 8][4];
  {
    const RowA<KS, true> ra(qs, warp * 16, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float a[1][4];
      ra.load(a, kk * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split<kSplit>(a[0][i], qb[kk][i], qsm[kk][i]);
    }
  }

  // rows g (half 0) and g + 8 (half 1) of the warp's 16
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[1][D / 8][4];  // O[16 rows][64]: n-tile n holds columns 8 n..
  zero(acc);
  const int nk = (L + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int cur = j & 1, k0 = j * BK;
    if (j + 1 < nk) {  // the next pair lands while this one is used
      load_rows<T, BK, D, NT>(ks + (cur ^ 1) * BK * KS, kb, k0 + BK, L, row);
      load_rows<T, BK, D, NT, VS, false>(vs + (cur ^ 1) * BK * VS, vb,
                                         k0 + BK, L, row);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this pair (the next may be in flight)
    __syncthreads();
    const float* kt = ks + cur * BK * KS;
    const float* vt = vs + cur * BK * VS;

    // S = Q K^T, 16 x 64: n-tile n holds keys k0 + 8 n..
    float s[1][BK / 8][4];
    zero(s);
    {
      const RowB<KS> rb(kt, 0, 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        float bf[BK / 8][2];
        rb.load(bf, kk * 8);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          uint32_t bb[2], bs[2];
          split<kSplit>(bf[n][0], bb[0], bs[0]);
          split<kSplit>(bf[n][1], bb[1], bs[1]);
          if (kSplit) mma_tf32(s[0][n], qsm[kk], bb);
          if (kSplit) mma_tf32(s[0][n], qb[kk], bs);
          mma_tf32(s[0][n], qb[kk], bb);
        }
      }
    }

    // online softmax of rows g and g + 8: a row's 16 values a lane sit in
    // the lane's quad, so the row max and sum are two shuffles
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[0][n][2 * half + e];
          x = k0 + 8 * n + 2 * t + e < L ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[0][n][2 * half + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run[half] - m_new);
      l_run[half] = l_run[half] * alpha + sum;
      m_run[half] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[0][n][2 * half] *= alpha;
        acc[0][n][2 * half + 1] *= alpha;
      }
    }

    // O += P V. The k order inside each 8 keys is permuted so that P's C
    // fragment is already its A fragment: k-slot t is key 2t and slot t + 4
    // key 2t + 1, so a0..a3 = c0, c2, c1, c3, and V's B fragment reads rows
    // 2t and 2t + 1 (stride VS: the 32 lanes hit 32 banks).
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t pb[4], ps[4];
      split<true>(s[0][kk][0], pb[0], ps[0]);
      split<true>(s[0][kk][2], pb[1], ps[1]);
      split<true>(s[0][kk][1], pb[2], ps[2]);
      split<true>(s[0][kk][3], pb[3], ps[3]);
      const float* v0 = vt + (8 * kk + 2 * t) * VS + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2], bs[2];
        split<kSplit>(v0[8 * n], bb[0], bs[0]);
        split<kSplit>(v0[VS + 8 * n], bb[1], bs[1]);
        mma_tf32(acc[0][n], ps, bb);
        if (kSplit) mma_tf32(acc[0][n], pb, bs);
        mma_tf32(acc[0][n], pb, bb);
      }
    }
    __syncthreads();  // every warp is done with this pair before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + warp * 16 + g + 8 * half;
    if (r >= L) continue;
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(blockIdx.y) * L + r] =
          m_run[half] + logf(fmaxf(l_run[half], 1e-30f));
    const float inv = 1.f / fmaxf(l_run[half], 1e-30f);
    T* out = o + base + r * row + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2<T>(out + 8 * n, acc[0][n][2 * half] * inv,
                acc[0][n][2 * half + 1] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_fwd_d64<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d64<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, scale);
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

// bf16 at d = 64 on the bf16 tensor cores (header). One block: (128-row q
// tile blockIdx.x, b*h blockIdx.y), 4 warps; warp w owns q rows 32 w.. of
// the tile and keeps their scores, softmax state and output in registers.
namespace d64_bf16 {

using rdeic_flash::bf16::bf16_t;
constexpr int D = 64, BQ = 128, BK = 64, NT = 128;
constexpr int kRow = D * 2;  // bytes of a tile row
constexpr int kSmemBytes = (BQ + 6 * BK) * kRow;  // Q, 3 K, 3 V: 64 KB
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two blocks per SM");

__global__ void __launch_bounds__(NT, 2)
    flash_fwd_d64_bf16(const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ k,
                       const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                       float* __restrict__ lse, int L, int H, float scale) {
  using namespace rdeic_flash;
  using bf16::exp2_ftz, bf16::kLn2, bf16::kLog2e, bf16::ldsm_x4,
      bf16::ldsm_x4_trans, bf16::load_tile, bf16::mma, bf16::pack;
  extern __shared__ __align__(128) unsigned char smem_d64b[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_d64b);  // [BQ][D]
  bf16_t* ks = qs + BQ * D;                            // [3 buffers][BK][D]
  bf16_t* vs = ks + 3 * BK * D;                        // [3 buffers][BK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16::Lane ln(lane);
  const uint32_t sq = bf16::smem_addr(qs) + (warp * 32 + ln.ar) * kRow;
  const uint32_t sk = bf16::smem_addr(ks) + ln.br * kRow;
  const uint32_t sv = bf16::smem_addr(vs) + ln.ar * kRow;
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

  // the warp's 32 q rows as the A fragments of two m-tiles; m-tile mt's
  // rows g (r = 0) and g + 8 (r = 1): the running max, and the lane's part
  // of the running sum (its quad adds the four parts at the end)
  uint32_t qf[2][D / 16][4];
  float m_run[2][2], l_run[2][2];
  float acc[2][D / 8][4];  // O[32 rows][64]: n-tile n holds columns 8 n..
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) m_run[mt][r] = kNegInf, l_run[mt][r] = 0.f;
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
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[mt][kk], sq + mt * 16 * kRow + ln.ca[kk]);
    }
    const uint32_t kt = sk + cur * BK * kRow, vt = sv + cur * BK * kRow;

    // S = Q K^T, 32 x 64, one pass: n-tile n holds keys k0 + 8 n..; each
    // K fragment serves both m-tiles
    float s[2][BK / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + 16 * np * kRow + ln.cb[kk]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(s[mt][2 * np], qf[mt][kk], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    if (k0 + BK > L) {  // the K tail: its scores are masked to -1e30
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= L)
            s[0][n][i] = s[1][n][i] = kNegInf;
    }

    // online softmax of rows g and g + 8 of each m-tile in log2 units:
    // p = 2^(s c - m); a row's 64 values sit in the lane's quad, 16 a lane,
    // so the row max is two shuffles
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][r], mx * c);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][n][2 * r + e];
            x = exp2_ftz(fmaf(x, c, -m_new));
            sum += x;
          }
        const float alpha = exp2_ftz(m_run[mt][r] - m_new);
        l_run[mt][r] = l_run[mt][r] * alpha + sum;
        m_run[mt][r] = m_new;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }

    // O += P V: P's C fragments of n-tiles 2 kk and 2 kk + 1, rounded to
    // bf16 and packed, are the A fragment of keys 16 kk..; V's B fragments
    // come by ldmatrix.trans, each serving both m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pa[mt][0] = pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + 16 * kk * kRow + ln.ca[np]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][2 * np], pa[mt], vf[0], vf[1]);
          mma(acc[mt][2 * np + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int rr = q0 + warp * 32 + mt * 16 + g + 8 * r;
      if (rr >= L) continue;
      if (lse != nullptr && t == 0)
        lse[static_cast<int64_t>(blockIdx.y) * L + rr] =
            m_run[mt][r] * kLn2 + logf(l);
      const float inv = 1.f / l;
      bf16_t* out = o + base + rr * row + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2<bf16_t>(out + 8 * n, acc[mt][n][2 * r] * inv,
                       acc[mt][n][2 * r + 1] * inv);
    }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = rdeic_flash::check_aligned({q, k, v, o});
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_d64_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_d64_bf16<<<grid, NT, kSmemBytes, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), lse, L, H,
      scale);
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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int L, int H, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      if constexpr (std::is_same_v<T, float>)
        return d16::launch<T>(q, k, v, o, lse, B, L, H, scale, stream);
      else
        return d16_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 64:
      if constexpr (std::is_same_v<T, float>)
        return d64::launch<T>(q, k, v, o, lse, B, L, H, scale, stream);
      else
        return d64_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
    case 512:
      if constexpr (std::is_same_v<T, float>)
        return d512::launch<T>(q, k, v, o, lse, B, L, H, scale, stream);
      else
        return d512_bf16::launch(q, k, v, o, lse, B, L, H, scale, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return dispatch<float>(q, k, v, o, l, B, L, H, D, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, B, L, H, D, scale, st);
  return -1;
}

const char* rdeic_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
