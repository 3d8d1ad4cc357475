// Tensor-core pieces shared by the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): TF32 `mma.sync` with fp32
// accumulators, the 3xTF32 split that keeps fp32 products fp32-accurate,
// the swizzled shared-memory layout of the D-wide tiles, and their copies.
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

// A D-wide tile row has stride D + 8 floats (8 mod 32 banks) and its column
// index is XOR-ed with (row & 4). A tile is read two ways: as a row-major A
// operand, or as B = tile^T (lane reads (row g, column t)); and as B = tile
// (lane reads (row t, column g)). With the plain stride 8 mod 32 the first
// puts rows g and g + 4 on one bank; the XOR moves row g + 4 by four
// columns, so both reads hit 32 distinct banks. It keeps 16-byte chunks
// whole, so cp.async still copies 16 bytes a lane.
template <int S>
__device__ __forceinline__ int swz(int r, int c) {
  return r * S + (c ^ (r & 4));
}

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

// Fragment readers. Each fixes its lane's shared-memory addresses when it is
// made, at the warp's (m0 or n0, k0) corner, so a k loop adds
// only constants. m0, n0 and k0 are multiples of 8, which keeps the swizzle
// of a row (row & 4) a constant of the lane.

// A(m, k) = tile[m][k] (row stride S, swizzled if SWZ): one ldmatrix.x4 per
// m-tile (rows 0-7 / 8-15 x columns 0-3 / 4-7 are a0..a3).
template <int S, bool SWZ>
struct RowA {
  uint32_t addr;
  __device__ RowA(const float* tile, int m0, int k0) {
    const int l = threadIdx.x & 31, r = (l & 7) + (l & 8), c = (l >> 4) * 4;
    addr = smem_addr(tile + (m0 + r) * S + k0 + (SWZ ? c ^ (r & 4) : c));
  }
  template <int MT>
  __device__ __forceinline__ void load(float (&x)[MT][4], int k) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(x[mt], addr + (mt * 16 * S + k) * 4);
  }
};

// B(k, n) = tile[n][k] (a D-wide tile of row stride S, swizzled if SWZ):
// one ldmatrix.x4 per two n-tiles (b0, b1 of n-tile 2p, then of 2p + 1).
template <int S, bool SWZ = true>
struct RowB {
  uint32_t addr;
  __device__ RowB(const float* tile, int n0, int k0) {
    const int l = threadIdx.x & 31, r = (l & 7) + (l >> 4) * 8,
              c = (l & 8) >> 1;
    addr = smem_addr(tile + (n0 + r) * S + k0 + (SWZ ? c ^ (r & 4) : c));
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

// Rows [r0, r0 + ROWS) of a [B, L, H, D] fp32 tensor (src at (b, h), tokens
// `row` elements apart) into a tile of stride S, swizzled (swz) when SWZ,
// by default the stride D + 8 of the D-wide tiles above; rows past L are
// zero. By cp.async.cg, 16 bytes a lane; the copies land later
// (cp_async_commit, then cp_async_wait before the block reads them). bf16
// tiles have kernels of their own (flash_bf16.cuh load_tile).
template <typename T, int ROWS, int D, int NT, int S = D + 8, bool SWZ = true>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int L, int64_t row) {
  static_assert(sizeof(T) == 4, "fp32 tiles");
  static_assert(S % 4 == 0, "16-byte chunks stay whole");
  constexpr int kChunks = ROWS * D / 4 / NT;  // 4-element chunks a thread
  static_assert((ROWS * D / 4) % NT == 0, "the threads split a tile evenly");
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    const int i = threadIdx.x + n * NT, r = i / (D / 4), c = i % (D / 4) * 4;
    const bool in = r0 + r < L;
    // a row past L reads nothing (src-size 0 fills zeros); its address
    // stays inside the tensor all the same
    const float* s = src + (in ? r0 + r : 0) * row + c;
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + (SWZ ? swz<S>(r, c) : r * S + c)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(s), "r"(in ? 16 : 0));
  }
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
