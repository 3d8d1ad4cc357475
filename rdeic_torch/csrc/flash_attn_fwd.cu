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
// in, the same type out, all arithmetic in fp32.
//
// lse: optional [B*H, L] fp32 output, the row logsumexp m + log(l) of the
// scaled scores, for the backward kernels (flash_attn_bwd.cu). A null
// pointer skips it, so the serving path runs without the extra store.
//
// Design: one block owns one (b*h, q-tile) pair and loops over the K/V tiles
// itself (the TPU kernel's sequential k grid axis becomes this loop). The
// Q tile and one K/V tile live in shared memory as fp32, with rows padded
// by one float so that the column walks are free of bank conflicts. Each
// thread holds an SM x SN patch of the score tile and a TM x TN patch of the
// output accumulator in registers; the threads that share a score row sit in
// one warp, so the row max and row sum are warp shuffles. P goes through
// shared memory to the output threads. Arithmetic is plain fp32 FMA (no
// tensor cores): the port's first kernel is exact first, fast later.
//
// d = 512 (the VAE mid-block) is the case a register accumulator cannot
// usually hold at a 64-row tile (128 KB). This kernel keeps the accumulator
// in registers by shrinking the tile instead: a 32-row q-tile over 256
// threads is 64 fp32 accumulators a thread, and the fp32 Q tile, one K and
// one V tile (32 rows each) take 197 KB of the 227 KB of shared memory.
//
// Bound on the H100: 4*L^2*D*H flops against 67 TFLOP/s of fp32 FMA (fp32
// inputs) versus 4*B*L*H*D elements of traffic; at the main path's
// L = 1536..6144 the flops bound it by two to three orders of magnitude.

#include "flash_common.cuh"

namespace {

using rdeic_flash::from_f32;
using rdeic_flash::kNegInf;
using rdeic_flash::load_f32;

// D: head dim. BQ/BK: q and k tile rows. NT: threads.
// SM x SN: score patch per thread; TM x TN: output patch per thread.
template <int D, int BQ, int BK, int NT, int SM, int SN, int TM, int TN>
struct Tile {
  static constexpr int SX = BK / SN;  // threads across a score row
  static constexpr int SY = BQ / SM;
  static constexpr int OX = D / TN;   // threads across an output row
  static constexpr int OY = BQ / TM;
  static constexpr int QS = D + 1;    // padded row stride of Q and K
  static constexpr int PS = BK + 1;   // padded row stride of P
  static constexpr int kSmemFloats =
      BQ * QS + BK * QS + BK * D + BQ * PS + 2 * BQ;
  static_assert(SX * SY == NT, "score tiling must cover the threads");
  static_assert(OX * OY == NT, "output tiling must cover the threads");
  static_assert(SX <= 32 && (32 % SX) == 0, "a score row lives in one warp");
  static_assert(kSmemFloats * 4 <= 232448, "shared memory per block");
};

template <typename T, int D, int BQ, int BK, int NT, int SM, int SN, int TM,
          int TN>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int L, int H, float scale) {
  using C = Tile<D, BQ, BK, NT, SM, SN, TM, TN>;
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][QS], pre-scaled
  float* ks = qs + BQ * C::QS;        // [BK][QS]
  float* vs = ks + BK * C::QS;        // [BK][D]
  float* ps = vs + BK * D;            // [BQ][PS]
  float* alpha_s = ps + BQ * C::PS;   // [BQ] rescale of this tile
  float* l_s = alpha_s + BQ;          // [BQ] running denominator

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int64_t row = static_cast<int64_t>(H) * D;  // stride between tokens
  const int64_t base = static_cast<int64_t>(b) * L * row +
                       static_cast<int64_t>(h) * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* ob = o + base;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < L) x = load_f32(qb + (q0 + r) * row + d) * scale;
    qs[r * C::QS + d] = x;
  }

  const int sx = tid % C::SX, sy = tid / C::SX;
  const int ox = tid % C::OX, oy = tid / C::OX;

  float m_run[SM], l_run[SM];
#pragma unroll
  for (int i = 0; i < SM; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's P V is done with ks/vs/ps
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < L) {
        kx = load_f32(kb + (k0 + r) * row + d);
        vx = load_f32(vb + (k0 + r) * row + d);
      }
      ks[r * C::QS + d] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[SM][SN];
#pragma unroll
    for (int i = 0; i < SM; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[SM], kv[SN];
#pragma unroll
      for (int i = 0; i < SM; ++i) qv[i] = qs[(sy + i * C::SY) * C::QS + d];
#pragma unroll
      for (int j = 0; j < SN; ++j) kv[j] = ks[(sx + j * C::SX) * C::QS + d];
#pragma unroll
      for (int i = 0; i < SM; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < SM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        if (k0 + sx + j * C::SX >= L) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = C::SX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = C::SX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      const int r = sy + i * C::SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) ps[r * C::PS + sx + j * C::SX] = s[i][j];
      if (sx == 0) {
        alpha_s[r] = alpha;
        l_s[r] = l_run[i];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = alpha_s[oy + i * C::OY];
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TM], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = ps[(oy + i * C::OY) * C::PS + j];
#pragma unroll
      for (int n = 0; n < TN; ++n) vv[n] = vs[j * D + ox + n * C::OX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }
  __syncthreads();

  if (lse != nullptr && sx == 0) {
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * C::SY;
      if (q0 + r < L)
        lse[static_cast<int64_t>(blockIdx.y) * L + q0 + r] =
            m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = oy + i * C::OY;
    if (q0 + r >= L) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < TN; ++n)
      ob[(q0 + r) * row + ox + n * C::OX] = from_f32<T>(acc[i][n] / l);
  }
}

template <typename T, int D, int BQ, int BK, int NT, int SM, int SN, int TM,
          int TN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int L, int H, float scale,
                   cudaStream_t stream) {
  using C = Tile<D, BQ, BK, NT, SM, SN, TM, TN>;
  auto kernel = flash_fwd_kernel<T, D, BQ, BK, NT, SM, SN, TM, TN>;
  const int smem = C::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int L, int H, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16, 64, 64, 128, 8, 4, 8, 1>(q, k, v, o, lse, B, L, H,
                                                     scale, stream);
    case 64:
      return launch<T, 64, 64, 64, 256, 4, 4, 4, 4>(q, k, v, o, lse, B, L, H,
                                                     scale, stream);
    case 512:
      return launch<T, 512, 32, 32, 256, 2, 2, 4, 16>(q, k, v, o, lse, B, L, H,
                                                       scale, stream);
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
