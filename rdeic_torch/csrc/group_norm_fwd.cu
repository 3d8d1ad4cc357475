// GroupNorm(+SiLU) forward for Hopper (sm_90a), written by hand.
//
// Replaces: rdeic_tpu/ops/fused_groupnorm.py `_gn_fwd_kernel` (the whole
// slab, `_run_fwd`) and the row-chunked pair `_gn_csum_kernel` +
// `_gn_affine_kernel` (`_run_fwd_chunked`): GroupNorm with fp32 statistics
// (var = E[x^2] - mean^2, clamped at 0, as flax computes it), y = x * w + off
// with w = inv * scale[c] and off = bias[c] - mean * w, then SiLU when asked,
// in the input dtype. The TPU split between a whole-slab and a chunked kernel
// exists only to fit VMEM; here one launch serves every shape.
//
// Layout: x and y are contiguous NCHW, fp32 or bf16; one (b, g) span is the
// C/G * H * W contiguous elements of one group of one image. scale and bias
// are [C], fp32 or bf16. mean and inv, when given, are (B, G) fp32: the
// backward (group_norm_bwd.cu) rebuilds x_hat from
// them. The serving call passes null and skips the store.
//
// Design: one thread-block cluster per span, launched with
// cudaLaunchKernelEx and a cluster dimension of at most 8 CTAs (the portable
// limit); ops/fused_groupnorm.py `group_norm_plan` picks the cluster size,
// each CTA's slice, the threads and the shared memory from the span, and
// the tests hold that plan to its rules on the CPU.
// - Resident (the slice fits the CTA's shared memory): each CTA copies its
//   slice into shared memory once, by cp.async, 16 bytes a lane, and both
//   passes read it there, so x crosses HBM once: the kernel can reach its
//   whole bytes bound. The path's largest span, 30 x 6144 fp32 (720 KB at
//   (1, 960, 64, 96)), takes ~90 KB in each of 8 CTAs.
// - Streaming (a slice larger than a CTA's shared memory): the same launch
//   reads the slice from global memory for the sums, then again (from L2
//   where it fits) for the output.
// - Each CTA sums (sum x, sum x^2) in fp32 (fixed thread mapping, shuffles in
//   a fixed order, warps summed in order), leaves the pair in its shared
//   memory, and after a cluster barrier every CTA reads the pairs of ranks
//   0, 1, ... through distributed shared memory (mapa + ld.shared::cluster)
//   and adds them in that order: no atomics, so every CTA and every run
//   forms the same mean and 1/sqrt(var + eps). A second cluster barrier
//   before exit keeps each CTA's pair alive while the others read it.
// - Vector (VEC): 16-byte loads and stores, when H * W is a multiple of the
//   elements in 16 bytes (so a vector never crosses a channel) and the
//   pointers are aligned; otherwise element by element.
//
// Bound on the H100: memory. The function must read x and write y, 2 * numel
// * itemsize bytes at 3.35 TB/s (the [C] parameters are noise). What the
// design does about the Triton stats + apply pair it replaces: one launch
// instead of two, with no partials buffer and no per-call allocation but y
// (and mean / inv under autograd), and one HBM read of x instead of two.
// At the path's shapes (0.0001-0.019 ms of bytes) a call is bound by its
// launch; the host path in ops/fused_groupnorm.py is one ctypes call.

#include <initializer_list>

#include "group_norm_common.cuh"

namespace {

using namespace rdeic_gn;

constexpr int kMaxThreads = 512;
// floats ahead of the slice in dynamic shared memory: [2][32] warp partials
// and this CTA's (sum, sum of squares); ops/fused_groupnorm.py SCRATCH_BYTES
constexpr int kScratchFloats = 80;

__device__ __forceinline__ float silu_f(float y) {
  return y / (1.f + expf(-y));  // y * sigmoid(y); -0 where expf overflows
}

// (sum, sum of squares) of this thread's share of src[0, n), n elements.
template <typename T, bool VEC>
__device__ __forceinline__ void sum_pass(const T* src, int n, float& s,
                                         float& ss) {
  if constexpr (VEC) {
    using V = Vec16<T>;
    for (int i = threadIdx.x; i < n / V::N; i += blockDim.x) {
      float f[V::N];
      V::unpack(*reinterpret_cast<const uint4*>(src + i * V::N), f);
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        s += f[e];
        ss = fmaf(f[e], f[e], ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float f = to_f32(src[i]);
      s += f;
      ss = fmaf(f, f, ss);
    }
  }
}

// dst[i] = silu?(src[i] * w[c] + off[c]) over this thread's share of
// [0, n); element i of the slice sits at span offset lo + i.
template <typename T, bool VEC>
__device__ __forceinline__ void apply_pass(const T* src, T* dst, int n, int lo,
                                           int hw, int c0, const void* gamma,
                                           const void* beta, int param_bf16,
                                           float mean, float inv, int silu) {
  if constexpr (VEC) {
    using V = Vec16<T>;
    for (int i = threadIdx.x; i < n / V::N; i += blockDim.x) {
      const int c = c0 + (lo + i * V::N) / hw;  // one channel per vector
      const float w = load_param(gamma, c, param_bf16) * inv;
      const float off = load_param(beta, c, param_bf16) - mean * w;
      float f[V::N];
      V::unpack(*reinterpret_cast<const uint4*>(src + i * V::N), f);
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        f[e] = fmaf(f[e], w, off);
        if (silu) f[e] = silu_f(f[e]);
      }
      *reinterpret_cast<uint4*>(dst + i * V::N) = V::pack(f);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = c0 + (lo + i) / hw;
      const float w = load_param(gamma, c, param_bf16) * inv;
      const float off = load_param(beta, c, param_bf16) - mean * w;
      float f = fmaf(to_f32(src[i]), w, off);
      if (silu) f = silu_f(f);
      dst[i] = from_f32<T>(f);
    }
  }
}

// One cluster per (b, g) span (grid.x = spans * cluster size); CTA `rank`
// takes span elements [rank * chunk, min(span, (rank + 1) * chunk)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd(const T* __restrict__ x, T* __restrict__ y,
           const void* __restrict__ gamma, const void* __restrict__ beta,
           float* __restrict__ mean_out, float* __restrict__ inv_out, int span,
           int hw, int cg, int groups, int chunk, int resident, int silu,
           int param_bf16, float eps) {
  const int rank = cluster_rank();
  const int ncta = cluster_size();
  const int64_t row = blockIdx.x / ncta;  // b * groups + g
  const int grp = static_cast<int>(row % groups);
  const int lo = rank * chunk;
  const int n = max(0, min(span - lo, chunk));
  const T* xs = x + row * span + lo;
  T* ys = y + row * span + lo;

  extern __shared__ __align__(16) float smem[];
  float* red = smem;        // [2][32]: each warp's (sum, sum of squares)
  float* part = smem + 64;  // [2]: this CTA's, read by the whole cluster
  T* buf = reinterpret_cast<T*>(smem + kScratchFloats);  // the slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (resident) {
    if constexpr (VEC) {
      constexpr int N = Vec16<T>::N;
      for (int i = tid; i < n / N; i += blockDim.x) {
        const uint32_t d =
            static_cast<uint32_t>(__cvta_generic_to_shared(buf + i * N));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(xs + i * N));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      for (int i = tid; i < n; i += blockDim.x) buf[i] = xs[i];
    }
    __syncthreads();
  }

  float s = 0.f, ss = 0.f;
  if (resident)
    sum_pass<T, VEC>(buf, n, s, ss);
  else
    sum_pass<T, VEC>(xs, n, s, ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) red[warp] = s, red[32 + warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < blockDim.x / 32; ++w) a += red[w], b += red[32 + w];
    part[0] = a, part[1] = b;
  }
  cluster_sync();  // every CTA's pair is in its shared memory

  float tot = 0.f, tot2 = 0.f;
  for (int r = 0; r < ncta; ++r) {  // rank order: the same sum in every CTA
    const float2 p = load_remote2(part, r);
    tot += p.x;
    tot2 += p.y;
  }
  const float cnt = static_cast<float>(span);
  const float mean = tot / cnt;
  const float var = fmaxf(tot2 / cnt - mean * mean, 0.f);
  const float inv = 1.f / sqrtf(var + eps);
  if (mean_out != nullptr && rank == 0 && tid == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }

  const int c0 = grp * cg;
  if (resident)
    apply_pass<T, VEC>(buf, ys, n, lo, hw, c0, gamma, beta, param_bf16, mean,
                       inv, silu);
  else
    apply_pass<T, VEC>(xs, ys, n, lo, hw, c0, gamma, beta, param_bf16, mean,
                       inv, silu);
  cluster_sync();  // no CTA leaves while another may still read its pair
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, void* y, const void* gamma, const void* beta,
                   float* mean, float* inv, int rows, int span, int hw, int cg,
                   int groups, int cluster, int chunk, int threads, int smem,
                   int resident, int silu, int param_bf16, float eps,
                   cudaStream_t stream) {
  auto kernel = gn_fwd<T, VEC>;
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y), gamma, beta,
      mean, inv, span, hw, cg, groups, chunk, resident, silu, param_bf16, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* y, const void* gamma, const void* beta,
             float* mean, float* inv, int rows, int span, int hw, int cg,
             int groups, int cluster, int chunk, int threads, int smem,
             int resident, int vec, int silu, int param_bf16, float eps,
             cudaStream_t stream) {
  if (vec) {
    for (const void* p : {x, static_cast<const void*>(y)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorMisalignedAddress;
    return launch<T, true>(x, y, gamma, beta, mean, inv, rows, span, hw, cg,
                           groups, cluster, chunk, threads, smem, resident,
                           silu, param_bf16, eps, stream);
  }
  return launch<T, false>(x, y, gamma, beta, mean, inv, rows, span, hw, cg,
                          groups, cluster, chunk, threads, smem, resident,
                          silu, param_bf16, eps, stream);
}

}  // namespace

extern "C" {

// The launch's integers, in this order (ops/fused_groupnorm.py `_fwd_args`
// builds them once per shape): rows (B * G), span, H * W, C / G, G, then the
// plan of `group_norm_plan` (cluster, chunk, threads, shared bytes,
// resident, vec), then silu, dtype and param_dtype (0 = float32,
// 1 = bfloat16). Passing them as one array keeps the host's call short.
enum Arg {
  kRows, kSpan, kHw, kCg, kGroups, kCluster, kChunk, kThreads, kSmem,
  kResident, kVec, kSilu, kDtype, kParamDtype, kNumArgs
};

// mean and inv may be null (both or neither). Returns 0, a cudaError_t, or
// -1 for a plan or dtype this file does not take.
int rdeic_group_norm_fwd(const void* x, void* y, const void* gamma,
                         const void* beta, void* mean, void* inv,
                         const int* a, float eps, void* stream) {
  if (a[kCluster] < 1 || a[kCluster] > rdeic_gn::kMaxCluster ||
      a[kThreads] < 32 || a[kThreads] > kMaxThreads || a[kThreads] % 32 != 0 ||
      a[kSmem] < kScratchFloats * 4 || (mean == nullptr) != (inv == nullptr) ||
      static_cast<int64_t>(a[kCluster]) * a[kChunk] < a[kSpan] ||
      (a[kParamDtype] != 0 && a[kParamDtype] != 1))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(inv);
  if (a[kDtype] == 0)
    return dispatch<float>(x, y, gamma, beta, m, iv, a[kRows], a[kSpan],
                           a[kHw], a[kCg], a[kGroups], a[kCluster], a[kChunk],
                           a[kThreads], a[kSmem], a[kResident], a[kVec],
                           a[kSilu], a[kParamDtype], eps, st);
  if (a[kDtype] == 1)
    return dispatch<__nv_bfloat16>(
        x, y, gamma, beta, m, iv, a[kRows], a[kSpan], a[kHw], a[kCg],
        a[kGroups], a[kCluster], a[kChunk], a[kThreads], a[kSmem],
        a[kResident], a[kVec], a[kSilu], a[kParamDtype], eps, st);
  return -1;
}

const char* rdeic_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
