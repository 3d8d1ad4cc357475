// Tensor-core pieces shared by the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): the 3xTF32 split that keeps fp32
// products fp32-accurate (every fp32 kernel), and TF32 `mma.sync` with fp32
// accumulators, its fragment reads and copies (the d = 16 backward).
//
// 3xTF32: a float x is split into big = tf32(x), rounded to nearest, and
// small = x - big, which the tensor core reads as TF32 (split, below). A
// product a * b is then taken as small_a * big_b + big_a * small_b +
// big_a * big_b; the dropped small_a * small_b is ~2^-22 of the product and
// the truncated bits of small ~2^-21, near fp32's own rounding. A bf16
// value has 8 significant bits, which TF32's 11 hold exactly: its small
// part is 0, so an operand that came from bf16 is not split (SPLIT =
// false), and a bf16 x bf16 product takes one pass.
//
// Fragments of mma.sync.aligned.m16n8k8 (tf32), for lane = 4 g + t:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8, fp32): c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
#pragma once

#include <initializer_list>

#include "flash_common.cuh"

namespace rdeic_flash {

// big and, where SPLIT, small of the 3xTF32 split, as TF32 operands. big
// is x rounded to TF32 by integer ops: adding half a TF32 ulp (bit 12) and
// clearing the 13 bits TF32 drops rounds to nearest, ties away from zero,
// as cvt.rna.tf32.f32 does for finite x (which compiles on sm_90 to a
// longer compare-and-select sequence). small = x - big is exact in fp32 and
// goes to the tensor core as it is: the tensor core reads its TF32 bits and
// drops the low 13 (truncation, ~2^-21 of x), as CUTLASS's 3xTF32 does. A
// NaN x keeps a NaN small, so NaN propagates; an operand that is not split
// is exact in TF32 (bf16) and comes through unchanged.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = SPLIT ? __float_as_uint(x - __uint_as_float(big)) : 0u;
}

// split of four values (a 16-byte chunk, as the d = 64 kernels' producers
// split their tiles), as fp32 values: big + small = x, small exact
__device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  uint32_t b[4];
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t s;
    split<true>(v[i], b[i], s);
  }
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
  small = make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 4 fp32 matrices (8 rows of 16 bytes, one row address from each
// lane, lanes 8j.. for matrix j) into x[j]: lane 4 g + t gets (row g, t).
__device__ __forceinline__ void ldmatrix_x4(float (&x)[4], uint32_t addr) {
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
}

// B(k, n) = tile[n][k] (a tile of row stride S): one ldmatrix.x4 per two
// n-tiles (b0, b1 of n-tile 2p, then of 2p + 1). The reader fixes its
// lane's shared-memory address when it is made, at the warp's (n0, k0)
// corner, so a k loop adds only constants.
template <int S>
struct RowB {
  uint32_t addr;
  __device__ RowB(const float* tile, int n0, int k0) {
    const int l = threadIdx.x & 31, r = (l & 7) + (l >> 4) * 8,
              c = (l & 8) >> 1;
    addr = smem_addr(tile + (n0 + r) * S + k0 + c);
  }
  template <int NT>
  __device__ __forceinline__ void load(float (&x)[NT][2], int k) const {
    static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      float y[4];
      ldmatrix_x4(y, addr + (p * 16 * S + k) * 4);
      x[2 * p][0] = y[0], x[2 * p][1] = y[1];
      x[2 * p + 1][0] = y[2], x[2 * p + 1][1] = y[3];
    }
  }
};

// Two adjacent outputs in the storage type.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cudaErrorMisalignedAddress unless every pointer is 16-byte aligned (the
// tiles are copied 16 bytes, or 4 bf16 values, a lane).
inline cudaError_t check_aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace rdeic_flash
