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
// d = 16 (the control branch) runs flash_dq_d16 and flash_dkv_d16 on fp32
// FMA: tiles live in shared memory as fp32, rows padded by one float. Each
// thread holds an SM x SN patch of the score tiles (S and dP together) and
// a TM x TN patch of its accumulators (dq; or dk and dv) in registers; dS
// (and P) go through shared memory between the two. At d = 16 it is ahead
// of SDPA's backward.
//
// d = 64 (the UNet: [2, 4096, 5, 64] and [2, 1024, 10, 64] per independent
// micro-step, twice that per refine micro-step) runs flash_dq_d64 and
// flash_dkv_d64 on the tensor cores: TF32 mma.sync (m16n8k8), fp32
// accumulators, 3xTF32 for fp32 products (flash_mma.cuh); bf16 operands are
// exact in TF32, so S and dP take one pass and the products with P or dS
// two. Both kernels:
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
// - ptxas -v: dq 166 registers (fp32) and 152 (bf16), dkv 196 and 189; no
//   spills.
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
// ~8 * B * L * H * D elements of traffic. d = 16 runs fp32 FMA at
// 67 TFLOP/s; d = 64 and 512 run 3xTF32 at 494.7 / 3 = 165 TFLOP/s. At the
// training path's L = 1024..4096 the flops bound every shape.

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using rdeic_flash::from_f32;
using rdeic_flash::load_f32;

// d = 16 on fp32 FMA (header): 64-row q and k tiles, 128 threads a block.
namespace d16 {

constexpr int D = 16, BT = 64, NT = 128;
// SM x SN: score patch per thread; TM x TN: accumulator patch per thread;
// LB: loads a thread keeps in flight when it fills a tile (load_tile).
constexpr int SM = 8, SN = 4, TM = 8, TN = 1, LB = 8;
constexpr int SX = BT / SN;  // patches across a score row
constexpr int SY = BT / SM;
constexpr int OX = D / TN;   // threads across an accumulator row
constexpr int OY = BT / TM;
constexpr int QS = D + 1;    // padded row stride of the D-wide tiles
constexpr int PS = BT + 1;   // padded row stride of P and dS
// four D-wide tiles, two score tiles, two row vectors
constexpr int kSmemFloats = 4 * BT * QS + 2 * BT * PS + 2 * BT;
static_assert(SX * SY == NT, "score tiling must cover the threads");
static_assert(OX * OY == NT, "accumulator tiling must cover the threads");
static_assert((BT * D) % (NT * LB) == 0, "the threads split a tile evenly");
static_assert(kSmemFloats * 4 <= 232448, "shared memory per block");

// Load rows [r0, r0 + BT) of a [B, L, H, D] tensor (base already at (b, h))
// into an fp32 tile with row stride QS; rows past L are zero. A thread
// issues its loads in batches of LB before storing them, so the block waits
// for one round trip to memory per batch rather than per element.
template <typename T>
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
// rows of the score patch index `qs`/`dos`, columns `ks`/`vs`.
__device__ __forceinline__ void score_patch(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int sx, int sy, float (&s)[SM][SN],
                                            float (&dp)[SM][SN]) {
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
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
}

// One block: (q tile blockIdx.x, b*h blockIdx.y). dq = sum over k tiles of
// dS K; also di = rowsum(dO * O) for the tile's rows, written to `di`.
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dq_d16(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ di, int L, int H,
                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // [BT][QS]
  float* dos = qs + BT * QS;   // [BT][QS]
  float* ks = dos + BT * QS;   // [BT][QS]
  float* vs = ks + BT * QS;    // [BT][QS]
  float* dss = vs + BT * QS;   // [BT][PS]
  float* lse_s = dss + 2 * BT * PS;
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;

  load_tile<T>(qs, q + base, q0, L, row);
  load_tile<T>(dos, dout + base, q0, L, row);
  load_tile<T>(ks, o + base, q0, L, row);  // O, for di
  __syncthreads();
  for (int r = tid; r < BT; r += NT) {
    float sum = 0.f;
    for (int d = 0; d < D; ++d)
      sum = fmaf(dos[r * QS + d], ks[r * QS + d], sum);
    di_s[r] = sum;
    lse_s[r] = (q0 + r < L) ? lse[rbase + q0 + r] : 0.f;
    if (q0 + r < L) di[rbase + q0 + r] = sum;
  }

  const int sx = tid % SX, sy = tid / SX;
  const int ox = tid % OX, oy = tid / OX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's dS K is done with ks and dss
    load_tile<T>(ks, k + base, k0, L, row);
    load_tile<T>(vs, v + base, k0, L, row);
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch(qs, dos, ks, vs, sx, sy, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int c = sx + j * SX;
        const float p = (q0 + r < L && k0 + c < L)
                            ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * PS + c] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dsv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = dss[(oy + i * OY) * PS + j];
#pragma unroll
      for (int n = 0; n < TN; ++n) kv[n] = ks[j * QS + ox + n * OX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(dsv[i], kv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = oy + i * OY;
    if (q0 + r >= L) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n)
      dq[base + (q0 + r) * row + ox + n * OX] = from_f32<T>(acc[i][n]);
  }
}

// One block: (k tile blockIdx.x, b*h blockIdx.y). dv = sum over q tiles of
// P^T dO, dk = sum of dS^T Q.
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dkv_d16(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H,
                  float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // [BT][QS]
  float* dos = qs + BT * QS;   // [BT][QS]
  float* ks = dos + BT * QS;   // [BT][QS]
  float* vs = ks + BT * QS;    // [BT][QS]
  float* ps = vs + BT * QS;    // [BT][PS], rows q, columns k
  float* dss = ps + BT * PS;   // [BT][PS]
  float* lse_s = dss + BT * PS;
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int64_t row = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const int64_t rbase = static_cast<int64_t>(bh) * L;

  load_tile<T>(ks, k + base, k0, L, row);
  load_tile<T>(vs, v + base, k0, L, row);

  const int sx = tid % SX, sy = tid / SX;
  const int ox = tid % OX, oy = tid / OX;
  float acc_k[TM][TN], acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc_k[i][n] = acc_v[i][n] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous tile's products are done with qs..dss
    load_tile<T>(qs, q + base, q0, L, row);
    load_tile<T>(dos, dout + base, q0, L, row);
    for (int r = tid; r < BT; r += NT) {
      const bool in = q0 + r < L;
      lse_s[r] = in ? lse[rbase + q0 + r] : 0.f;
      di_s[r] = in ? di[rbase + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch(qs, dos, ks, vs, sx, sy, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int c = sx + j * SX;
        const float p = (q0 + r < L && k0 + c < L)
                            ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ps[r * PS + c] = p;
        dss[r * PS + c] = p * (dp[i][j] - di_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float pv[TM], dsv[TM], dov[TN], qv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = ps[r * PS + oy + i * OY];
        dsv[i] = dss[r * PS + oy + i * OY];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        dov[n] = dos[r * QS + ox + n * OX];
        qv[n] = qs[r * QS + ox + n * OX];
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
    const int r = oy + i * OY;
    if (k0 + r >= L) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int64_t at = base + (k0 + r) * row + ox + n * OX;
      dk[at] = from_f32<T>(acc_k[i][n]);
      dv[at] = from_f32<T>(acc_v[i][n]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_dq_d16<T>;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  auto kernel = flash_dkv_d16<T>;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
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
template <int NC, bool kSplit>
__device__ __forceinline__ void score_step(float (&s)[NC][4],
                                           const float (&a)[4],
                                           const float (&bf)[NC][2]) {
  using namespace rdeic_flash;
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kSplit>(a[i], ab[i], as[i]);
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    uint32_t bb[2], bs[2];
    split<kSplit>(bf[n][0], bb[0], bs[0]);
    split<kSplit>(bf[n][1], bb[1], bs[1]);
    if (kSplit) mma_tf32(s[n], as, bb);
    if (kSplit) mma_tf32(s[n], ab, bs);
    mma_tf32(s[n], ab, bb);
  }
}

// s1 = A1 B1^T and s2 = A2 B2^T over d, 16 x 8 NC each: A the warp's 16
// rows of the kept tiles a1, a2 (ldmatrix, RowA), B the NC 8-row groups of
// the streamed tiles b1, b2 from their row 0 (ldmatrix, RowB). n-tile n
// holds streamed rows 8 n.. as columns. The two products interleave, 2 NC
// independent accumulators.
template <int NC, bool kSplit>
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
    score_step<NC, kSplit>(s1, x1[0], y1);
    score_step<NC, kSplit>(s2, x2[0], y2);
  }
}

// The 8 streamed rows kk of C (16 x 8 NC score fragments: P or dS, fp32,
// always split) as an A fragment in the permuted k order: k-slot t is
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
template <bool kSplit>
__device__ __forceinline__ void accumulate_step(float (&acc)[D / 8][4],
                                                const uint32_t (&pb)[4],
                                                const uint32_t (&ps)[4],
                                                const float* b) {
  using namespace rdeic_flash;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    uint32_t bb[2], bs[2];
    split<kSplit>(b[8 * n], bb[0], bs[0]);
    split<kSplit>(b[TS + 8 * n], bb[1], bs[1]);
    mma_tf32(acc[n], ps, bb);
    if (kSplit) mma_tf32(acc[n], pb, bs);
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
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 operands are exact in TF32
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
      scores<KC / 8, kSplit>(s, dp, qs, dos, kt, vt);
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
        accumulate_step<kSplit>(acc, pb, ps, kt + (8 * kk + 2 * t) * TS + g);
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
  constexpr bool kSplit = sizeof(T) == 4;
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
      scores<KC / 8, kSplit>(s, dp, ks, vs, qt, dt);
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
        accumulate_step<kSplit>(acc_v, pb, ps, dt + (8 * kk + 2 * t) * TS + g);
        c_as_a(dp[kk], pb, ps);
        accumulate_step<kSplit>(acc_k, pb, ps, qt + (8 * kk + 2 * t) * TS + g);
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

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, float* di,
                int B, int L, int H, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return d16::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H, scale,
                               st);
    case 64:
      return d64::launch_dq<T>(q, k, v, o, dout, lse, dq, di, B, L, H, scale,
                               st);
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
      return d16::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                scale, st);
    case 64:
      return d64::launch_dkv<T>(q, k, v, dout, lse, di, dk, dv, B, L, H,
                                scale, st);
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
