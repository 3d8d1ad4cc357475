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
// only the refine phase differentiates).
//
// Design at d = 16 and 64, as the forward: one block owns a (b*h, tile)
// pair and loops over the other sequence axis itself (the TPU kernels'
// sequential grid axis). Tiles live in shared memory as fp32, rows padded
// by one float. Each thread holds an SM x SN patch of the score tiles (S and
// dP together) and a TM x TN patch of its accumulators (dq; or dk and dv)
// in registers; dS (and P) go through shared memory between the two. Plain
// fp32 FMA, no tensor cores: right first, fast later.
//
// d = 512 (the VAE decoder's mid-block, [2, 4096, 1, 512] per refine
// micro-step) runs its own pair, flash_dq_d512 and flash_dkv_d512, on the
// tensor cores: TF32 mma.sync (m16n8k8), fp32 accumulators, each fp32
// product taken as three TF32 products (3xTF32, flash_mma.cuh; one TF32
// pass misses the 1e-4 limit). bf16 inputs are exact in TF32: Q K^T and
// dO V^T take one pass; products with P or dS, which are fp32, two.
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
//   runs; lse and di of the next q tile are read a tile ahead. bf16 tiles
//   widen to fp32 through registers.
// - Grid at [2, 4096, 1, 512]: 256 blocks each (1.94 waves on 132 SMs).
// - ptxas -v: dq 171 registers (fp32) and 216 (bf16), dkv 238 and 232; no
//   spills.
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
// ~8 * B * L * H * D elements of traffic. d = 16 and 64 run fp32 FMA at
// 67 TFLOP/s; d = 512 runs 3xTF32 at 494.7 / 3 = 165 TFLOP/s. At the
// training path's L = 1024..4096 the flops bound every shape.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using rdeic_flash::from_f32;
using rdeic_flash::load_f32;

// D: head dim. BT: rows of both tiles (q and k). NT: threads.
// SM x SN: score patch per thread group; KS: threads (adjacent lanes) that
// split the d-sum of one patch (1 at d = 16 and 64: each thread sums its
// whole patch); TM x TN: accumulator patch per thread;
// LB: loads a thread keeps in flight when it fills a tile (load_tile).
template <int D, int BT, int NT, int SM, int SN, int TM, int TN, int KS,
          int LB>
struct BwdTile {
  static constexpr int SX = BT / SN;  // patches across a score row
  static constexpr int SY = BT / SM;
  static constexpr int OX = D / TN;   // threads across an accumulator row
  static constexpr int OY = BT / TM;
  static constexpr int QS = D + KS;   // padded row stride of the D-wide tiles
  static constexpr int PS = BT + 1;   // padded row stride of P and dS
  // four D-wide tiles, two score tiles, two row vectors
  static constexpr int kSmemFloats = 4 * BT * QS + 2 * BT * PS + 2 * BT;
  static_assert(SX * SY * KS == NT, "score tiling must cover the threads");
  static_assert(OX * OY == NT, "accumulator tiling must cover the threads");
  static_assert(32 % KS == 0 && D % KS == 0, "a d-split lives in one warp");
  static_assert((BT * D) % (NT * LB) == 0, "the threads split a tile evenly");
  static_assert(kSmemFloats * 4 <= 232448, "shared memory per block");
};

// Load rows [r0, r0 + BT) of a [B, L, H, D] tensor (base already at (b, h))
// into an fp32 tile with row stride QS; rows past L are zero. A thread
// issues its loads in batches of LB before storing them, so the block waits
// for one round trip to memory per batch rather than per element. (At
// d = 64 a batch of 16 spills in the dq kernel.)
template <typename T, int D, int BT, int NT, int QS, int LB>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int L, int64_t row) {
#pragma unroll 1
  for (int n0 = 0; n0 < BT * D / NT; n0 += LB) {
    float x[LB];
#pragma unroll
    for (int n = 0; n < LB; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT, r = i / D, d = i % D;
      x[n] = (r0 + r < L) ? load_f32(src + (r0 + r) * row + d) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < LB; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT;
      dst[(i / D) * QS + i % D] = x[n];
    }
  }
}

// S = q_tile . k_tile^T and dP = do_tile . v_tile^T on this thread's patch;
// rows of the score patch index `qs`/`dos`, columns `ks`/`vs`. The KS lanes
// of a patch (split = lane % KS) each sum every KS-th d from `split`, then
// add the partial sums, so every one of them ends with the whole patch.
template <int D, int SM, int SN, int SX, int SY, int QS, int KS>
__device__ __forceinline__ void score_patch(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int sx, int sy, int split,
                                            float (&s)[SM][SN],
                                            float (&dp)[SM][SN]) {
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = split; d < D; d += KS) {
    float qv[SM], dov[SM], kv[SN], vv[SN];
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      qv[i] = qs[(sy + i * SY) * QS + d];
      dov[i] = dos[(sy + i * SY) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      kv[j] = ks[(sx + j * SX) * QS + d];
      vv[j] = vs[(sx + j * SX) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < SM; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int off = KS / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < SM; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
        dp[i][j] += __shfl_xor_sync(0xffffffffu, dp[i][j], off);
      }
}

// Whether this lane finishes entry (i, j) of its score patch: each of the
// KS lanes that share a patch takes every KS-th entry.
template <int SN, int KS>
__device__ __forceinline__ bool owns_entry(int i, int j, int split) {
  return (i * SN + j) % KS == split;
}

// One block: (q tile blockIdx.x, b*h blockIdx.y). dq = sum over k tiles of
// dS K; also di = rowsum(dO * O) for the tile's rows, written to `di`.
template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN,
          int KS, int LB>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ di, int L, int H,
                    float scale) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN, KS, LB>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BT][QS]
  float* dos = qs + BT * C::QS;     // [BT][QS]
  float* ks = dos + BT * C::QS;     // [BT][QS]
  float* vs = ks + BT * C::QS;      // [BT][QS]
  float* dss = vs + BT * C::QS;     // [BT][PS]
  float* lse_s = dss + 2 * BT * C::PS;
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;

  load_tile<T, D, BT, NT, C::QS, LB>(qs, q + base, q0, L, row);
  load_tile<T, D, BT, NT, C::QS, LB>(dos, dout + base, q0, L, row);
  load_tile<T, D, BT, NT, C::QS, LB>(ks, o + base, q0, L, row);  // O, for di
  __syncthreads();
  for (int r = tid; r < BT; r += NT) {
    float sum = 0.f;
    for (int d = 0; d < D; ++d)
      sum = fmaf(dos[r * C::QS + d], ks[r * C::QS + d], sum);
    di_s[r] = sum;
    lse_s[r] = (q0 + r < L) ? lse[rbase + q0 + r] : 0.f;
    if (q0 + r < L) di[rbase + q0 + r] = sum;
  }

  const int split = tid % KS, sx = tid / KS % C::SX, sy = tid / KS / C::SX;
  const int ox = tid % C::OX, oy = tid / C::OX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's dS K is done with ks and dss
    load_tile<T, D, BT, NT, C::QS, LB>(ks, k + base, k0, L, row);
    load_tile<T, D, BT, NT, C::QS, LB>(vs, v + base, k0, L, row);
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch<D, SM, SN, C::SX, C::SY, C::QS, KS>(qs, dos, ks, vs, sx, sy,
                                                    split, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * C::SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        if (!owns_entry<SN, KS>(i, j, split)) continue;
        const int c = sx + j * C::SX;
        const float p = (q0 + r < L && k0 + c < L)
                            ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * C::PS + c] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dsv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = dss[(oy + i * C::OY) * C::PS + j];
#pragma unroll
      for (int n = 0; n < TN; ++n) kv[n] = ks[j * C::QS + ox + n * C::OX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(dsv[i], kv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = oy + i * C::OY;
    if (q0 + r >= L) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n)
      dq[base + (q0 + r) * row + ox + n * C::OX] = from_f32<T>(acc[i][n]);
  }
}

// One block: (k tile blockIdx.x, b*h blockIdx.y). dv = sum over q tiles of
// P^T dO, dk = sum of dS^T Q.
template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN,
          int KS, int LB>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int H, float scale) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN, KS, LB>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BT][QS]
  float* dos = qs + BT * C::QS;     // [BT][QS]
  float* ks = dos + BT * C::QS;     // [BT][QS]
  float* vs = ks + BT * C::QS;      // [BT][QS]
  float* ps = vs + BT * C::QS;      // [BT][PS], rows q, columns k
  float* dss = ps + BT * C::PS;     // [BT][PS]
  float* lse_s = dss + BT * C::PS;
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;

  load_tile<T, D, BT, NT, C::QS, LB>(ks, k + base, k0, L, row);
  load_tile<T, D, BT, NT, C::QS, LB>(vs, v + base, k0, L, row);

  const int split = tid % KS, sx = tid / KS % C::SX, sy = tid / KS / C::SX;
  const int ox = tid % C::OX, oy = tid / C::OX;
  float acc_k[TM][TN], acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc_k[i][n] = acc_v[i][n] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous tile's products are done with qs..dss
    load_tile<T, D, BT, NT, C::QS, LB>(qs, q + base, q0, L, row);
    load_tile<T, D, BT, NT, C::QS, LB>(dos, dout + base, q0, L, row);
    for (int r = tid; r < BT; r += NT) {
      const bool in = q0 + r < L;
      lse_s[r] = in ? lse[rbase + q0 + r] : 0.f;
      di_s[r] = in ? di[rbase + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch<D, SM, SN, C::SX, C::SY, C::QS, KS>(qs, dos, ks, vs, sx, sy,
                                                    split, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * C::SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        if (!owns_entry<SN, KS>(i, j, split)) continue;
        const int c = sx + j * C::SX;
        const float p = (q0 + r < L && k0 + c < L)
                            ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ps[r * C::PS + c] = p;
        dss[r * C::PS + c] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float pv[TM], dsv[TM], dov[TN], qv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = ps[r * C::PS + oy + i * C::OY];
        dsv[i] = dss[r * C::PS + oy + i * C::OY];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        dov[n] = dos[r * C::QS + ox + n * C::OX];
        qv[n] = qs[r * C::QS + ox + n * C::OX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          acc_v[i][n] = fmaf(pv[i], dov[n], acc_v[i][n]);
          acc_k[i][n] = fmaf(dsv[i], qv[n], acc_k[i][n]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = oy + i * C::OY;
    if (k0 + r >= L) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int64_t at = base + (k0 + r) * row + ox + n * C::OX;
      dk[at] = from_f32<T>(acc_k[i][n]);
      dv[at] = from_f32<T>(acc_v[i][n]);
    }
  }
}

template <typename C, typename K>
cudaError_t prepare(K kernel, int* smem) {
  *smem = C::kSmemFloats * static_cast<int>(sizeof(float));
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN,
          int KS, int LB>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN, KS, LB>;
  auto kernel = flash_dq_kernel<T, D, BT, NT, SM, SN, TM, TN, KS, LB>;
  int smem;
  cudaError_t err = prepare<C>(kernel, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), di, L, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN,
          int KS, int LB>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN, KS, LB>;
  auto kernel = flash_dkv_kernel<T, D, BT, NT, SM, SN, TM, TN, KS, LB>;
  int smem;
  cudaError_t err = prepare<C>(kernel, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

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
template <int MT, int NT, int XS, bool kSplit>
__device__ __forceinline__ void score_partials(const float* qs,
                                               const float* dos,
                                               const float* ks,
                                               const float* vs, float* xs) {
  using namespace rdeic_flash;
  const int warp = threadIdx.x >> 5, prod = warp >> 2, quarter = warp & 3;
  float acc[MT][NT][4];
  zero(acc);
  warp_mma<MT, NT, D / 32, kSplit, kSplit>(
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
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 operands are exact in TF32
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
    score_partials<2, 2, DQ_XS, kSplit>(qs, dos, ks, vs, xs);
    __syncthreads();  // done with vs: the next V tile comes meanwhile
    if (k0 + BK < L) load_rows<T, BK, D, NT>(vs, v + base, k0 + BK, L, row);
    cp_async_commit();
    float p[2], ds[2];
    probs<BQ, DQ_XS>(xs, r, c, q0 + r < L, L - k0, lse_s[r], di_s[r], scale,
                     p, ds);
    *reinterpret_cast<float2*>(dss + r * DQ_DS + c) = make_float2(ds[0], ds[1]);
    __syncthreads();
    warp_mma<2, 8, BK / 8, true, kSplit>(acc, RowA<DQ_DS, false>(dss, 0, 0),
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
  constexpr bool kSplit = sizeof(T) == 4;
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
    score_partials<1, 4, KV_XS, kSplit>(qs, dos, ks, vs, xs);
    __syncthreads();
    float p[2], ds[2];
    probs<BQ, KV_XS>(xs, r, c, q0 + r < L, L - k0, lse_s[r], di_s[r], scale,
                     p, ds);
    *reinterpret_cast<float2*>(ps + r * KV_PS + c) = make_float2(p[0], p[1]);
    *reinterpret_cast<float2*>(dss + r * KV_PS + c) = make_float2(ds[0], ds[1]);
    __syncthreads();
    warp_mma<2, 8, BQ / 8, true, kSplit>(acc_v, ColA<KV_PS>(ps, 0, 0),
                                         ColB<TS>(dos, warp * (D / 8), 0));
    __syncthreads();  // done with dos: the next dO tile comes meanwhile
    if (q0 + BQ < L) load_rows<T, BQ, D, NT>(dos, dout + base, q0 + BQ, L, row);
    cp_async_commit();
    warp_mma<2, 8, BQ / 8, true, kSplit>(acc_k, ColA<KV_PS>(dss, 0, 0),
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

// FMA tile shapes of d = 16 and 64: <D, BT, NT, SM, SN, TM, TN, KS, LB>.
#define RDEIC_BWD_D16 16, 64, 128, 8, 4, 8, 1, 1, 8
#define RDEIC_BWD_D64 64, 64, 256, 4, 4, 4, 4, 1, 8

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, float* di,
                int B, int L, int H, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_dq<T, RDEIC_BWD_D16>(q, k, v, o, dout, lse, dq, di, B, L,
                                         H, scale, st);
    case 64:
      return launch_dq<T, RDEIC_BWD_D64>(q, k, v, o, dout, lse, dq, di, B, L,
                                         H, scale, st);
    case 512:
      return d512::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H, scale,
                                st);
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
      return launch_dkv<T, RDEIC_BWD_D16>(q, k, v, dout, lse, di, dk, dv, B,
                                          L, H, scale, st);
    case 64:
      return launch_dkv<T, RDEIC_BWD_D64>(q, k, v, dout, lse, di, dk, dv, B,
                                          L, H, scale, st);
    case 512:
      return d512::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
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

}  // extern "C"
