// The rounding of one warpgroup product on the card, read from its result.
//
// Replaces no TPU kernel: it measures the tensor core that flash_fwd_d64_bf16
// and flash_fwd_d64 (flash_attn_fwd.cu) run on, so that the CPU emulation of
// those kernels (tests/torch_port_tf32.py) can model how wgmma rounds the
// fp32 sums it returns and how it reads an fp32 operand as TF32. One block
// of one warpgroup computes D = C + A B with the kernels' own instruction
// forms: bf16 m64n64k16 with A from registers and B an MN-major operand in
// shared memory (P V of flash_fwd_d64_bf16), and tf32 m64n64k8 with A from
// registers and B K-major in shared memory (both products of flash_fwd_d64).
// A, B, C and D are dense fp32 arrays; the bf16 product rounds A and B to
// bf16 first, the tf32 one hands their fp32 bits to the tensor core as they
// are. Bound: none worth the name (a few hundred bytes, one launch).
#include <cuda_bf16.h>

#include "flash_bf16.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace rdeic_flash::hopper;

// kind 0: bf16, A [64][16], B [16][64]; kind 1: tf32, A [64][8], B [8][64];
// C and D [64][64]
__global__ void __launch_bounds__(128, 1)
    wgmma_probe(int kind, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                float* __restrict__ d) {
  __shared__ __align__(1024) unsigned char bs[64 * 128];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * w + g;
  if (kind == 0) {  // B[k][n]: row k, bytes 2 n.. (MN-major)
    for (int i = tid; i < 16 * 64; i += 128)
      *reinterpret_cast<__nv_bfloat16*>(bs + swizzle128(i / 64, 2 * (i % 64))) =
          __float2bfloat16(b[i]);
  } else {  // B[k][n]: row n, bytes 4 k.. (K-major)
    for (int i = tid; i < 8 * 64; i += 128)
      *reinterpret_cast<float*>(bs + swizzle128(i % 64, 4 * (i / 64))) = b[i];
  }
  fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[4 * n + i] = c[(r0 + 8 * (i >> 1)) * 64 + 8 * n + 2 * t + (i & 1)];
  uint32_t af[4];
  const uint64_t db = desc(smem_u32(bs), 16 * 128);
  if (kind == 0) {
    using rdeic_flash::bf16::pack;
    const float* a0 = a + r0 * 16;
    const float* a1 = a0 + 8 * 16;
    af[0] = pack(a0[2 * t], a0[2 * t + 1]);
    af[1] = pack(a1[2 * t], a1[2 * t + 1]);
    af[2] = pack(a0[2 * t + 8], a0[2 * t + 9]);
    af[3] = pack(a1[2 * t + 8], a1[2 * t + 9]);
    wgmma_fence();
    mma_m64n64k16_rs_mn(acc, af, db, 1);
  } else {
    const float* a0 = a + r0 * 8;
    const float* a1 = a0 + 8 * 8;
    af[0] = __float_as_uint(a0[t]);
    af[1] = __float_as_uint(a1[t]);
    af[2] = __float_as_uint(a0[t + 4]);
    af[3] = __float_as_uint(a1[t + 4]);
    wgmma_fence();
    mma_m64n64k8_rs_tf32(acc, af, db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[(r0 + 8 * (i >> 1)) * 64 + 8 * n + 2 * t + (i & 1)] = acc[4 * n + i];
}

}  // namespace

extern "C" {

// D = C + A B on the card (kind 0: bf16 m64n64k16, 1: tf32 m64n64k8);
// returns 0 or a cudaError_t
int rdeic_wgmma_probe(int kind, const void* a, const void* b, const void* c,
                      void* d, void* stream) {
  wgmma_probe<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
