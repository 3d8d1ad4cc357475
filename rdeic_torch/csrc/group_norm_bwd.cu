// GroupNorm(+SiLU) backward for Hopper (sm_90a), written by hand.
//
// Replaces: rdeic_tpu/ops/fused_groupnorm.py `_gn_bwd_kernel` (the whole
// slab, `_group_norm_bwd`) and the row-chunked pair `_gn_bstat_kernel` +
// `_gn_bdx_kernel` (`_run_bwd_chunked`). With p = x_hat * scale + bias and
// x_hat = (x - mean) * inv:
//   dp = dy * sigmoid(p) * (1 + p * (1 - sigmoid(p))) when SiLU is fused,
//        else dy;
//   dscale = sum of dp * x_hat and dbias = sum of dp, over batch and space;
//   dx = inv * (dp * scale - m1 - x_hat * m2), m1 and m2 the group means of
//        dp * scale and dp * scale * x_hat.
// The TPU split between a whole-slab and a chunked pair exists only to fit
// VMEM; here one launch serves every shape.
//
// Layout: x, dy and dx are contiguous NCHW, fp32 or bf16 (dx in the input
// dtype); one (b, g) span is the C/G * H * W contiguous elements of one
// group of one image. mean and inv are the forward's (B, G) fp32
// statistics, as saved under autograd. scale and bias are [C], fp32 or bf16;
// dscale and dbias come out in their dtype. sums ([B, C, 2] fp32) and
// arrivals ([G] int32, zero before the first launch and after every one)
// are the wrapper's scratch.
//
// Design: one thread-block cluster of up to 8 CTAs per span, as the forward
// (group_norm_fwd.cu); ops/fused_groupnorm.py `group_norm_bwd_plan` picks
// the cluster size, each CTA's slice, the threads and the shared memory,
// and the tests hold that plan to its rules on the CPU.
// 1. Each CTA reads its slice of x and dy from HBM once, 16 bytes a lane
//    (or element by element where H * W is no multiple of a vector), forms
//    x_hat and dp, and, where the slice is resident (fits its shared memory
//    beside the scratch), keeps both there in fp32. Work is cut into tasks
//    of up to 128 vectors inside one channel, one warp a task: a slice may
//    start or end inside a channel, and a task never crosses one. Each
//    task's (sum dp, sum dp x_hat) is a fixed warp sum; a channel's partial
//    is its tasks' sums added in task order.
// 2. After a cluster barrier every CTA reads, for each channel of the
//    group, the partials of the ranks whose slices touch it, in rank order,
//    through distributed shared memory: no float atomics, so every CTA and
//    every run forms the same channel sums and the same m1 and m2. Rank 0
//    writes the span's per-(b, c) sums to `sums`.
// 3. Each CTA writes dx from its resident x_hat and dp (streamed spans read
//    x and dy again, from L2 where they fit).
// 4. dscale and dbias sum `sums` over the batch in b order, inside the same
//    launch: rank 0 of each span counts its arrival on the group's counter
//    (an integer atomic; the values are never added atomically), and the
//    cluster that arrives last sums the group's channels and resets the
//    counter for the next launch.
//
// Bound on the H100: memory. The function must read x and dy and write dx,
// 3 * numel * itemsize bytes at 3.35 TB/s (the [C] parameters and the
// [B, C, 2] sums are noise). Where a slice is resident (every span of the
// training paths: the largest, 30 x 4096 fp32 at (2, 960, 64, 64), keeps
// 2 x 60 KB in each of 8 CTAs) x and dy cross HBM once, so the kernel can
// reach that bound. What the design does about the Triton pair it replaces:
// one launch instead of two and no torch reductions between them, so the
// host path is one ctypes call; x and dy are read once instead of twice.

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "group_norm_common.cuh"

namespace {

using namespace rdeic_gn;

constexpr int kMaxThreads = 512;
constexpr int kTaskUnits = 128;  // vectors (or elements) of one task
// floats ahead of the channel partials: [2][32] warp partials, then m1, m2
// and the last-arrival flag (ops/fused_groupnorm.py BWD_HEAD_FLOATS)
constexpr int kHeadFloats = 72;

// The launch's integers, in this order (ops/fused_groupnorm.py `_bwd_args`
// builds them once per shape): rows (B * G), span, H * W, C / G, G, C, B,
// then the plan of `group_norm_bwd_plan` (cluster, chunk, threads, shared
// bytes, resident, vec, channel partials a CTA), then silu, dtype and
// param_dtype (0 = float32, 1 = bfloat16). Passing them as one array keeps
// the host's call short.
enum Arg {
  kRows, kSpan, kHw, kCg, kGroups, kChannels, kBatch, kCluster, kChunk,
  kThreads, kSmem, kResident, kVec, kNch, kSilu, kDtype, kParamDtype,
  kNumArgs
};

// N elements as fp32: a 16-byte vector (VEC) or one element.
template <typename T, bool VEC>
struct Units {
  static constexpr int N = VEC ? Vec16<T>::N : 1;
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  __device__ static Raw load(const T* p, int u) {
    if constexpr (VEC)
      return __ldg(reinterpret_cast<const uint4*>(p) + u);
    else
      return p[u];
  }
  __device__ static void unpack(const Raw& r, float (&f)[N]) {
    if constexpr (VEC)
      Vec16<T>::unpack(r, f);
    else
      f[0] = to_f32(r);
  }
  __device__ static void store(T* p, int u, const float (&f)[N]) {
    if constexpr (VEC)
      reinterpret_cast<uint4*>(p)[u] = Vec16<T>::pack(f);
    else
      p[u] = from_f32<T>(f[0]);
  }
};

// x_hat and dp of one element (the plain version's formulas and order)
__device__ __forceinline__ void xhat_dp(float x, float dy, float mean,
                                        float inv, float g, float b, int silu,
                                        float& xh, float& dp) {
  xh = (x - mean) * inv;
  if (silu) {
    const float p = fmaf(xh, g, b);
    const float sig = 1.f / (1.f + expf(-p));
    dp = dy * sig * (1.f + p * (1.f - sig));
  } else {
    dp = dy;
  }
}

template <int N>
__device__ __forceinline__ void store_smem(float* dst, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = f[e];
  }
}

template <int N>
__device__ __forceinline__ void load_smem(const float* src, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + e);
      f[e] = v.x, f[e + 1] = v.y, f[e + 2] = v.z, f[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = src[e];
  }
}

// One cluster per (b, g) span (grid.x = spans * cluster size); CTA `rank`
// takes span elements [rank * chunk, min(span, (rank + 1) * chunk)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd(const T* __restrict__ x, const T* __restrict__ dy,
           const void* __restrict__ gamma, const void* __restrict__ beta,
           const float* __restrict__ mean, const float* __restrict__ inv,
           T* __restrict__ dx, void* __restrict__ dscale,
           void* __restrict__ dbias, float* __restrict__ sums,
           int* __restrict__ arrivals, int span, int hw, int cg, int groups,
           int channels, int batch, int chunk, int nch, int resident,
           int silu, int param_bf16) {
  using U = Units<T, VEC>;
  constexpr int N = U::N;
  const int rank = cluster_rank();
  const int ncta = cluster_size();
  const int64_t row = blockIdx.x / ncta;  // b * groups + g
  const int grp = static_cast<int>(row % groups);
  const int bat = static_cast<int>(row / groups);
  const int lo = rank * chunk;
  const int n = max(0, min(span - lo, chunk));
  const T* xs = x + row * span;  // the span (units are span-relative)
  const T* dys = dy + row * span;
  T* dxs = dx + row * span;
  const int hv = hw / N;  // units a channel
  const int a = lo / N, nu = n / N;  // this slice: span units [a, a + nu)
  const int tpc = (hv + kTaskUnits - 1) / kTaskUnits;  // tasks a channel
  const int c0 = lo / hw;  // first channel of the group this slice touches
  const int ncl = n > 0 ? (lo + n - 1) / hw - c0 + 1 : 0;
  const int cbase = grp * cg;

  extern __shared__ __align__(16) float smem[];
  float* red = smem;        // [2][32]: each warp's (m1, m2) terms
  float* misc = smem + 64;  // m1, m2, last arrival
  float* chan = smem + kHeadFloats;  // [nch][2]: read by the whole cluster
  float* task = chan + 2 * nch;      // [nch * tpc][2]
  float* xh_s = smem + ((kHeadFloats + 2 * nch + 2 * nch * tpc + 3) & ~3);
  float* dp_s = xh_s + chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float mu = mean[row], iv = inv[row];

  // 1. x_hat, dp and each task's (sum dp, sum dp x_hat); a warp a task
  constexpr int J = kTaskUnits / 32;  // units a lane, per task
  for (int t = warp; t < ncl * tpc; t += nwarps) {
    const int c = c0 + t / tpc, k = t % tpc;
    const int u0 = max(a, c * hv + k * kTaskUnits);
    const int u1 = min(a + nu, min((c + 1) * hv, c * hv + (k + 1) * kTaskUnits));
    const float g = load_param(gamma, cbase + c, param_bf16);
    const float bb = silu ? load_param(beta, cbase + c, param_bf16) : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < J; j0 += 2) {  // two units' loads in flight a lane
      typename U::Raw rx[2], rd[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = u0 + lane + 32 * (j0 + j);
        if (u < u1) rx[j] = U::load(xs, u), rd[j] = U::load(dys, u);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = u0 + lane + 32 * (j0 + j);
        if (u >= u1) continue;
        float xf[N], df[N];
        U::unpack(rx[j], xf);
        U::unpack(rd[j], df);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          xhat_dp(xf[e], df[e], mu, iv, g, bb, silu, xf[e], df[e]);
          s1 += df[e];
          s2 += df[e] * xf[e];
        }
        if (resident) {
          store_smem<N>(xh_s + (u - a) * N, xf);
          store_smem<N>(dp_s + (u - a) * N, df);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) task[2 * t] = s1, task[2 * t + 1] = s2;
  }
  __syncthreads();
  for (int cl = tid; cl < ncl; cl += blockDim.x) {  // tasks in order
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < tpc; ++k) {
      s1 += task[2 * (cl * tpc + k)];
      s2 += task[2 * (cl * tpc + k) + 1];
    }
    chan[2 * cl] = s1, chan[2 * cl + 1] = s2;
  }
  cluster_sync();  // every CTA's channel partials are in its shared memory

  // 2. channel sums in rank order, then m1 and m2 (the same in every CTA)
  float m1 = 0.f, m2 = 0.f;
  for (int c = tid; c < cg; c += blockDim.x) {
    const int rlo = c * hw / chunk;
    const int rhi = min(ncta - 1, ((c + 1) * hw - 1) / chunk);
    float t1 = 0.f, t2 = 0.f;
    for (int r = rlo; r <= rhi; ++r) {
      const float2 p = load_remote2(chan + 2 * (c - r * chunk / hw), r);
      t1 += p.x;
      t2 += p.y;
    }
    const float g = load_param(gamma, cbase + c, param_bf16);
    m1 += g * t1;
    m2 += g * t2;
    if (rank == 0) {
      *reinterpret_cast<float2*>(
          sums + 2 * (static_cast<int64_t>(bat) * channels + cbase + c)) =
          make_float2(t1, t2);
      __threadfence();  // before this span's arrival is counted
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, off);
    m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  }
  if (lane == 0) red[warp] = m1, red[32 + warp] = m2;
  __syncthreads();
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < nwarps; ++w) s1 += red[w], s2 += red[32 + w];
    const float cnt = static_cast<float>(cg) * static_cast<float>(hw);
    misc[0] = s1 / cnt;
    misc[1] = s2 / cnt;
    misc[2] = 0.f;
    if (rank == 0) {
      __threadfence();
      const int ticket = atomicAdd(arrivals + grp, 1);
      misc[2] = ticket == batch - 1 ? 1.f : 0.f;
    }
  }
  __syncthreads();
  m1 = misc[0];
  m2 = misc[1];

  // 3. dx from the resident x_hat and dp (streamed: from x and dy again)
  for (int u = tid; u < nu; u += blockDim.x) {
    const int c = (a + u) / hv;  // one channel per unit
    const float g = load_param(gamma, cbase + c, param_bf16);
    float xh[N], dp[N];
    if (resident) {
      load_smem<N>(xh_s + u * N, xh);
      load_smem<N>(dp_s + u * N, dp);
    } else {
      const float bb = silu ? load_param(beta, cbase + c, param_bf16) : 0.f;
      U::unpack(U::load(xs, a + u), xh);
      U::unpack(U::load(dys, a + u), dp);
#pragma unroll
      for (int e = 0; e < N; ++e)
        xhat_dp(xh[e], dp[e], mu, iv, g, bb, silu, xh[e], dp[e]);
    }
    float o[N];
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = iv * (dp[e] * g - m1 - xh[e] * m2);
    U::store(dxs, a + u, o);
  }

  // 4. the last span of the group to arrive sums dscale and dbias over the
  // batch, in b order
  if (rank == 0 && misc[2] != 0.f) {
    __threadfence();
    for (int c = tid; c < cg; c += blockDim.x) {
      float sdb = 0.f, sdx = 0.f;
      for (int bb = 0; bb < batch; ++bb) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            sums + 2 * (static_cast<int64_t>(bb) * channels + cbase + c)));
        sdb += v.x;
        sdx += v.y;
      }
      if (param_bf16) {
        static_cast<__nv_bfloat16*>(dscale)[cbase + c] = __float2bfloat16_rn(sdx);
        static_cast<__nv_bfloat16*>(dbias)[cbase + c] = __float2bfloat16_rn(sdb);
      } else {
        static_cast<float*>(dscale)[cbase + c] = sdx;
        static_cast<float*>(dbias)[cbase + c] = sdb;
      }
    }
    if (tid == 0) arrivals[grp] = 0;  // ready for the next launch
  }
  cluster_sync();  // no CTA leaves while another may still read its partials
}


template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* dy, const void* gamma,
                   const void* beta, const float* mean, const float* inv,
                   void* dx, void* dscale, void* dbias, float* sums,
                   int* arrivals, const int* a, cudaStream_t stream) {
  auto kernel = gn_bwd<T, VEC>;
  if (a[kSmem] > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a[kSmem]);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a[kRows]) * a[kCluster]);
  cfg.blockDim = dim3(a[kThreads]);
  cfg.dynamicSmemBytes = static_cast<size_t>(a[kSmem]);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a[kCluster];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy),
      gamma, beta, mean, inv, static_cast<T*>(dx), dscale, dbias, sums,
      arrivals, a[kSpan], a[kHw], a[kCg], a[kGroups], a[kChannels],
      a[kBatch], a[kChunk], a[kNch], a[kResident], a[kSilu], a[kParamDtype]);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dy, const void* gamma,
             const void* beta, const float* mean, const float* inv, void* dx,
             void* dscale, void* dbias, float* sums, int* arrivals,
             const int* a, cudaStream_t stream) {
  if (a[kVec]) {
    for (const void* p : {x, dy, static_cast<const void*>(dx)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorMisalignedAddress;
    return launch<T, true>(x, dy, gamma, beta, mean, inv, dx, dscale, dbias,
                           sums, arrivals, a, stream);
  }
  return launch<T, false>(x, dy, gamma, beta, mean, inv, dx, dscale, dbias,
                          sums, arrivals, a, stream);
}

// The shared memory the kernel lays out for this plan, in bytes.
int64_t smem_needed(const int* a, int units_per_channel) {
  const int64_t tpc = (units_per_channel + kTaskUnits - 1) / kTaskUnits;
  const int64_t head = (kHeadFloats + 2 * a[kNch] + 2 * a[kNch] * tpc + 3) & ~3;
  return 4 * (head + (a[kResident] ? 2 * static_cast<int64_t>(a[kChunk]) : 0));
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t, or -1 for a plan or dtype this file does not
// take.
int rdeic_group_norm_bwd(const void* x, const void* dy, const void* gamma,
                         const void* beta, const void* mean, const void* inv,
                         void* dx, void* dscale, void* dbias, void* sums,
                         void* arrivals, const int* a, void* stream) {
  const int per_unit = !a[kVec] ? 1 : (a[kDtype] == 0 ? 4 : 8);
  if (a[kCluster] < 1 || a[kCluster] > kMaxCluster || a[kThreads] < 32 ||
      a[kThreads] > kMaxThreads || a[kThreads] % 32 != 0 ||
      a[kNch] < std::min(a[kCg], (a[kChunk] - 1) / a[kHw] + 2) ||
      a[kHw] % per_unit != 0 || a[kChunk] % per_unit != 0 ||
      static_cast<int64_t>(a[kCluster]) * a[kChunk] < a[kSpan] ||
      a[kSmem] < smem_needed(a, a[kHw] / per_unit) ||
      (a[kParamDtype] != 0 && a[kParamDtype] != 1))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  float* s = static_cast<float*>(sums);
  int* arr = static_cast<int*>(arrivals);
  if (a[kDtype] == 0)
    return dispatch<float>(x, dy, gamma, beta, m, iv, dx, dscale, dbias, s,
                           arr, a, st);
  if (a[kDtype] == 1)
    return dispatch<__nv_bfloat16>(x, dy, gamma, beta, m, iv, dx, dscale,
                                   dbias, s, arr, a, st);
  return -1;
}

const char* rdeic_group_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
