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
// 16 and 64 (the denoiser's); the wrapper refuses 512, which only the
// VAE decoder's backward would need.
//
// Design, as the forward: one block owns a (b*h, tile) pair and loops over
// the other sequence axis itself (the TPU kernels' sequential grid axis).
// Tiles live in shared memory as fp32 with rows padded by one float. Each
// thread holds an SM x SN patch of the score tiles (S and dP together) and a
// TM x TN patch of its accumulators (dq; or dk and dv) in registers; dS (and
// P) go through shared memory between the two. Plain fp32 FMA, no tensor
// cores: right first, fast later.
//
// Bound on the H100: the pair must do 10 * L^2 * D * B * H flops (S, dP, dV,
// dQ, dK; dq alone 6, dkv alone 8, since each recomputes S and dP) at
// 67 TFLOP/s fp32, against ~8 * B * L * H * D elements of traffic: at the
// training path's L = 1024..4096 the flops bound it.

#include "flash_common.cuh"

namespace {

using rdeic_flash::from_f32;
using rdeic_flash::load_f32;

// D: head dim. BT: rows of both tiles (q and k). NT: threads.
// SM x SN: score patch per thread; TM x TN: accumulator patch per thread.
template <int D, int BT, int NT, int SM, int SN, int TM, int TN>
struct BwdTile {
  static constexpr int SX = BT / SN;  // threads across a score row
  static constexpr int SY = BT / SM;
  static constexpr int OX = D / TN;   // threads across an accumulator row
  static constexpr int OY = BT / TM;
  static constexpr int QS = D + 1;    // padded row stride of the D-wide tiles
  static constexpr int PS = BT + 1;   // padded row stride of P and dS
  // four D-wide tiles, two score tiles, two row vectors
  static constexpr int kSmemFloats = 4 * BT * QS + 2 * BT * PS + 2 * BT;
  static_assert(SX * SY == NT, "score tiling must cover the threads");
  static_assert(OX * OY == NT, "accumulator tiling must cover the threads");
  static_assert(kSmemFloats * 4 <= 232448, "shared memory per block");
};

// Load rows [r0, r0 + BT) of a [B, L, H, D] tensor (base already at (b, h))
// into an fp32 tile with row stride QS; rows past L are zero.
template <typename T, int D, int BT, int NT, int QS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int L, int64_t row) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * QS + d] = (r0 + r < L) ? load_f32(src + (r0 + r) * row + d) : 0.f;
  }
}

// S = q_tile . k_tile^T and dP = do_tile . v_tile^T on this thread's patch;
// rows of the score patch index `qs`/`dos`, columns `ks`/`vs`.
template <int D, int SM, int SN, int SX, int SY, int QS>
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
template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ di, int L, int H,
                    float scale) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN>;
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

  load_tile<T, D, BT, NT, C::QS>(qs, q + base, q0, L, row);
  load_tile<T, D, BT, NT, C::QS>(dos, dout + base, q0, L, row);
  load_tile<T, D, BT, NT, C::QS>(ks, o + base, q0, L, row);  // O, for di
  __syncthreads();
  for (int r = tid; r < BT; r += NT) {
    float sum = 0.f;
    for (int d = 0; d < D; ++d)
      sum = fmaf(dos[r * C::QS + d], ks[r * C::QS + d], sum);
    di_s[r] = sum;
    lse_s[r] = (q0 + r < L) ? lse[rbase + q0 + r] : 0.f;
    if (q0 + r < L) di[rbase + q0 + r] = sum;
  }

  const int sx = tid % C::SX, sy = tid / C::SX;
  const int ox = tid % C::OX, oy = tid / C::OX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's dS K is done with ks and dss
    load_tile<T, D, BT, NT, C::QS>(ks, k + base, k0, L, row);
    load_tile<T, D, BT, NT, C::QS>(vs, v + base, k0, L, row);
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch<D, SM, SN, C::SX, C::SY, C::QS>(qs, dos, ks, vs, sx, sy, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * C::SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
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
template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int H, float scale) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN>;
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

  load_tile<T, D, BT, NT, C::QS>(ks, k + base, k0, L, row);
  load_tile<T, D, BT, NT, C::QS>(vs, v + base, k0, L, row);

  const int sx = tid % C::SX, sy = tid / C::SX;
  const int ox = tid % C::OX, oy = tid / C::OX;
  float acc_k[TM][TN], acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc_k[i][n] = acc_v[i][n] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous tile's products are done with qs..dss
    load_tile<T, D, BT, NT, C::QS>(qs, q + base, q0, L, row);
    load_tile<T, D, BT, NT, C::QS>(dos, dout + base, q0, L, row);
    for (int r = tid; r < BT; r += NT) {
      const bool in = q0 + r < L;
      lse_s[r] = in ? lse[rbase + q0 + r] : 0.f;
      di_s[r] = in ? di[rbase + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[SM][SN], dp[SM][SN];
    score_patch<D, SM, SN, C::SX, C::SY, C::QS>(qs, dos, ks, vs, sx, sy, s, dp);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = sy + i * C::SY;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
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

template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* di, int B, int L, int H, float scale,
                      cudaStream_t stream) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN>;
  auto kernel = flash_dq_kernel<T, D, BT, NT, SM, SN, TM, TN>;
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

template <typename T, int D, int BT, int NT, int SM, int SN, int TM, int TN>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  using C = BwdTile<D, BT, NT, SM, SN, TM, TN>;
  auto kernel = flash_dkv_kernel<T, D, BT, NT, SM, SN, TM, TN>;
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

// Tile shapes per head dim: <D, BT, NT, SM, SN, TM, TN>.
#define RDEIC_BWD_D16 16, 64, 128, 8, 4, 8, 1
#define RDEIC_BWD_D64 64, 64, 256, 4, 4, 4, 4

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
