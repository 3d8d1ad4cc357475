// bf16 tensor-core pieces of the bf16 flash-attention kernels on mma.sync
// (flash_attn_bwd.cu: flash_dq_d16_bf16, flash_dkv_d16_bf16,
// flash_dq_d512_bf16, flash_dkv_d512_bf16): bf16
// `mma.sync` m16n8k16 with fp32 accumulators, fragment loads by ldmatrix,
// and bf16 tiles copied by cp.async into a swizzled shared-memory layout.
// The wgmma kernels (every forward, flash_dq_d64_bf16,
// flash_dkv_d64_bf16) take its scalar helpers: exp2_ftz, pack,
// pack_split, unpack.
//
// Fragments of mma.sync.aligned.m16n8k16 (bf16, two values a register, the
// lower column in the low half), for lane = 4 g + t:
//   A (16 x 16, row): a0 (g, 2t..2t+1)   a1 (g + 8, 2t..)
//                     a2 (g, 2t + 8..)   a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t + 8.., n = g)
//   C (16 x 8, fp32): c0 (g, 2t)  c1 (g, 2t + 1)
//                     c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// So the C fragments of two adjacent 8-column tiles, packed pairwise to
// bf16x2, are the A fragment of the 16-deep step over those 16 columns.
//
// ldmatrix.x4 reads four 8 x 8 matrices of 16-bit values, lanes 8j..8j + 7
// giving the row addresses (16 bytes each) of matrix j; lane 4 g + t gets
// (row g, columns 2t, 2t + 1) of each, or with .trans (rows 2t, 2t + 1,
// column g). Lane offsets into a tile, for a 16 x 16 corner:
//   A (and B with .trans, rows = k): row (l & 7) + 8 ((l >> 3) & 1),
//     chunk (l >> 4): matrices a0..a3, or b0, b1 of n-tiles 0 and 1;
//   B without .trans (rows = n): row (l & 7) + 8 (l >> 4), chunk
//     (l >> 3) & 1: b0, b1 of n-tile 0, then of n-tile 1.
//
// Swizzle: a D-wide tile row holds D / 8 chunks of 16 bytes, and chunk c of
// row r is stored at chunk c ^ (r & 7). Rows of 128 (d = 64) or 1024 bytes
// (d = 512) all start on bank 0, so without it the 8 rows of an ldmatrix
// matrix would hit the same 4 banks; with it the 8 rows land on 8 distinct
// chunks mod 8, all 32 banks, for ldmatrix with and without .trans, and a
// copy phase (8 lanes, one row's 8 chunks) too. A d = 16 row (32 bytes)
// holds only 2 chunks, and rows r and r + 4 start on the same bank; there
// chunk c of row r is stored at chunk c ^ ((r >> 2) & 1), so 8 rows of one
// chunk fill all 32 banks (ldmatrix, with and without .trans), and so do
// the 4 rows of a copy phase (Lane16).
#pragma once

#include "flash_common.cuh"

namespace rdeic_flash {
namespace bf16 {

using bf16_t = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix.x4 (with .trans: ldsm_x4_trans) from a shared-memory address
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A lane's ldmatrix rows at a 16 x 16 corner (the header's offsets), and
// the byte offsets of its swizzled 16-column steps: step j of every 128
// columns, for a row whose (row & 7) is lane & 7, as at every corner of
// multiples of 8 rows.
struct Lane {
  int ar, br;             // rows: A and B with .trans; B without .trans
  uint32_t ca[4], cb[4];  // byte offsets of the steps, for ar and br rows
  __device__ explicit Lane(int lane) {
    ar = (lane & 7) + ((lane >> 3) & 1) * 8;
    br = (lane & 7) + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ca[j] = ((2 * j + (lane >> 4)) ^ (lane & 7)) << 4;
      cb[j] = ((2 * j + ((lane >> 3) & 1)) ^ (lane & 7)) << 4;
    }
  }
};

// d = 16: a lane's ldmatrix row at a 16 x 16 corner (a multiple of 8 rows)
// as a byte offset, its chunk swizzled: `a` for A and for B with .trans,
// `b` for B without .trans (the header's rows and chunks)
struct Lane16 {
  uint32_t a, b;
  __device__ explicit Lane16(int lane) {
    const int sw = (lane >> 2) & 1;  // (row >> 2) & 1 of the lane's row
    a = (((lane & 7) + ((lane >> 3) & 1) * 8) << 5) +
        (((lane >> 4) ^ sw) << 4);
    b = (((lane & 7) + (lane >> 4) * 8) << 5) +
        ((((lane >> 3) & 1) ^ sw) << 4);
  }
};

// 2^x, one MUFU instruction: ex2.approx with subnormal results flushed to
// zero (exp2f adds a rescaling around it to keep them)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to nearest bf16, as one A-fragment register
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) as two bf16 terms, each an A-fragment register: big = the pair
// rounded to nearest bf16, small = bf16(x - big) (x - big is exact in fp32),
// so big + small is within 2^-17 |x| of x (flash_attn_bwd.cu's bf16
// backward takes P and dS so)
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& big,
                                           uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(b);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = pack(x0 - f.x, x1 - f.y);
}

// (x0, x1) as two bf16 terms, one conversion a pair: big = the pair cut to
// bf16 (each value's top 16 bits, toward zero: one byte permute), small =
// bf16(x - big) rounded to nearest (x - big is exact in fp32, and below
// one bf16 ulp of x), so big + small is within 2^-16 |x| of x
// (flash_attn_bwd.cu's bf16 backward at d = 16 and 512 takes P and dS so)
__device__ __forceinline__ void pack_split_trunc(float x0, float x1,
                                                 uint32_t& big,
                                                 uint32_t& small) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  big = __byte_perm(u0, u1, 0x7632);
  small = pack(x0 - __uint_as_float(u0 & 0xffff0000u),
               x1 - __uint_as_float(u1 & 0xffff0000u));
}

// A bf16x2 register (low half first) as two floats
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Element offset of chunk c (8 values) of row r in a swizzled D-wide tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D == 16) return r * D + ((c ^ ((r >> 2) & 1)) << 3);
  return r * D + ((c ^ (r & 7)) << 3);
}

// Rows [r0, r0 + ROWS) of a [B, L, H, D] bf16 tensor (src at (b, h), tokens
// `row` elements apart) into a swizzled tile, by cp.async.cg, 16 bytes a
// lane; a row past L reads nothing (src-size 0 fills zeros), its address
// staying inside the tensor. The copies land later: cp_async_commit, then
// cp_async_wait before the block reads them.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16_t* dst, const bf16_t* src,
                                          int r0, int L, int64_t row) {
  constexpr int kChunks = ROWS * D / 8 / NT;  // 16-byte chunks a thread
  static_assert((ROWS * D / 8) % NT == 0, "the threads split a tile evenly");
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    const int i = threadIdx.x + n * NT, r = i / (D / 8), c = i % (D / 8);
    const bool in = r0 + r < L;
    const bf16_t* s = src + (in ? r0 + r : 0) * row + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + swz<D>(r, c))),
                 "l"(s), "r"(in ? 16 : 0));
  }
}

}  // namespace bf16
}  // namespace rdeic_flash
