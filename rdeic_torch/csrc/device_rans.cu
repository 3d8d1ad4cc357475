// Interleaved-lane rANS decode and encode for Hopper (sm_90a), written by
// hand.
//
// Replaces: rdeic_tpu/entropy/device_rans.py `decode_pass` (v1 per-lane
// words), `decode_pass_shared` (v2 one word stream per image) and
// `encode_lanes`. The JAX package writes these in jnp (a lax.scan over the
// steps of a pass, vectorized over [batch, lanes]), not Pallas: they are the
// codec's device-side entropy coder, so the decode chain keeps every pass's
// symbols on the card and the encoder sends only the lanes' words to the
// host. rdeic_torch/entropy/device_rans.py holds the plain PyTorch version of
// each kernel beside its wrapper, and the tests hold the three to each other
// bit for bit.
//
// The code is the host coder's (entropy/csrc/rans.cpp): 32-bit state, 16-bit
// probabilities and renorm words, an escape slot followed by 4-bit bypass
// chunks (1 continuation bit + 3 payload bits). Symbol j of a pass rides lane
// j % K; step t of a pass resolves symbols t*K .. t*K + K-1. Every table and
// word gather clamps its index into range, as the JAX `take(mode="clip")`,
// and index arithmetic wraps in 32 bits as JAX's int32 does, so a corrupt
// stream decodes to the plain version's (and the JAX package's) symbols and
// never reads out of bounds; escape payloads keep JAX's int32 arithmetic.
//
// Kernels:
// - rans_decode_lanes (v1): a thread per (image, lane), 128 lanes a block.
//   Each thread walks the pass's T steps: a LUT gather (cum -> symbol), two
//   CDF gathers, the state update, one conditional pull from its own word
//   row; an escape runs a per-thread bypass loop (each lane owns its words,
//   so nothing is shared). Symbols [B, T*K] are written zero past n_valid;
//   the state and cursor go back to device memory for the next pass.
// - rans_decode_shared (v2): a block per image, a thread per lane (K <= 1024).
//   Every pull phase is lane-major across the whole block: a lane's word sits
//   at the image's cursor plus the count of lower lanes pulling in that
//   phase. The count is two-level: a warp __ballot_sync + __popc of the lower
//   lanes' bits, then the lower warps' totals from shared memory; the cursor
//   (held alike by every thread) moves by the block's total. Each bypass-chunk
//   iteration of an escape is a phase of its own across all lanes, repeated
//   while any lane is in its chain (__syncthreads_or), as the JAX while_loop
//   runs while any lane is active: a per-thread escape loop would be wrong.
// - rans_encode_lanes: a thread per (image, lane) over all passes' steps in
//   reverse (rANS encodes backwards so the decoder reads forward). Each step
//   does its table lookups, then the escape's bypass chunks in six stages
//   (int16-guarded symbols give payloads under 2^18: six 3-bit chunks, at
//   most two of whose pushes renormalize), then the slot code, and emits at
//   most three words into [B, K, wcap] in emit order. An overflow flag is
//   raised when a lane needs more than wcap words or a payload reaches 2^18;
//   the caller then encodes on the host.
//
// Bound on the H100: neither bytes nor operations. Each pass moves a few
// hundred KB (a 768x512 image: 0.39 M symbols over 20 passes, 4 bytes of
// index and symbol each, the words 2 bytes a symbol at most), a few us at
// 3.35 TB/s; the real limit is the serial chain of a lane: T steps, each a
// LUT gather on the state and the two CDF gathers on its symbol (mostly L2
// hits: the 8 MiB LUT and 0.8 MB of CDFs stay in the 50 MB L2) before the
// next state is known. v1's word address is known as the step begins, so
// its gather leaves the chain; v2's waits for the block's count of pulling
// lanes, a third dependent load. The encoder's lookups do not depend on the
// state: its chain is the slot code's division. rans_chain_probe measures
// both latencies on the card. The design does nothing more about the chain
// than keep one lane a thread, so the K lanes of every image run at once; a
// step's latency is the lever for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kLanesPerBlock = 128;
constexpr int kMaxSharedLanes = 1024;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// int32 arithmetic that wraps, as JAX's does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

struct Tables {
  const uint16_t* lut;  // [ncdfs << 16]
  const int* cdf;       // [ncdfs * max_len]
  const int* lengths;   // [ncdfs]
  const int* offsets;   // [ncdfs]
  int max_len;
  int ncdfs;
};

// One symbol resolution: s, the state advanced past it (before its renorm),
// its escape slot (max_value) and offset.
struct Resolved {
  int s;
  uint32_t adv;
  int max_value;
  int offset;
};

__device__ __forceinline__ Resolved resolve(const Tables& tb, uint32_t x,
                                            int ci) {
  const int64_t ncdfs = tb.ncdfs;
  const uint32_t cum = x & 0xffffu;
  const int li = static_cast<int>((static_cast<uint32_t>(ci) << kProbBits) | cum);
  Resolved r;
  r.s = tb.lut[clamp_index(li, ncdfs << kProbBits)];
  const int base = wrap_mul(ci, tb.max_len);
  const int64_t ncdf = ncdfs * tb.max_len;
  const uint32_t lo = static_cast<uint32_t>(
      tb.cdf[clamp_index(wrap_add(base, r.s), ncdf)]);
  const uint32_t hi = static_cast<uint32_t>(
      tb.cdf[clamp_index(wrap_add(base, r.s + 1), ncdf)]);
  r.adv = (hi - lo) * (x >> kProbBits) + cum - lo;
  const int64_t c = clamp_index(ci, ncdfs);
  r.max_value = tb.lengths[c] - 2;
  r.offset = tb.offsets[c];
  return r;
}

// The escape's value from its bypass payload z, read as int32 (JAX's z).
__device__ __forceinline__ int unzigzag(uint32_t z, int max_value) {
  const int zs = static_cast<int>(z);
  return (zs & 1) ? -(zs >> 1) - 1 : wrap_add(zs >> 1, max_value);
}

__global__ void rans_decode_lanes(
    const int* __restrict__ words, const int* __restrict__ nwords,
    const int64_t* __restrict__ state_in, const int* __restrict__ ptr_in,
    const int* __restrict__ idx, Tables tb, int* __restrict__ syms,
    int64_t* __restrict__ state_out, int* __restrict__ ptr_out, int B, int K,
    int W, int T, int n_valid) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (k >= K) return;
  const int64_t lane = static_cast<int64_t>(b) * K + k;
  const int64_t nw_all = static_cast<int64_t>(B) * K * W;
  const int64_t row = lane * W;
  const int nw = nwords[lane];
  uint32_t x = static_cast<uint32_t>(state_in[lane]);
  int p = ptr_in[lane];
  const int* idx_row = idx + static_cast<int64_t>(b) * T * K;
  int* sym_row = syms + static_cast<int64_t>(b) * T * K;
  for (int t = 0; t < T; ++t) {
    const int pos = t * K + k;
    const bool valid = pos < n_valid;
    const int ci = idx_row[pos];
    const Resolved r = resolve(tb, x, ci);
    uint32_t nx = r.adv;
    int np = p;
    if (nx < kRansL && np < nw) {  // one conditional 16-bit pull
      nx = (nx << 16) | static_cast<uint32_t>(words[clamp_index(row + np, nw_all)]);
      ++np;
    }
    const bool esc = valid && r.s == r.max_value;
    uint32_t z = 0;
    int shift = 0;
    bool active = esc;
    while (active) {  // this lane's bypass chunks; it owns its words
      const uint32_t bits = nx & 0xfu;
      nx >>= 4;
      if (nx < kRansL && np < nw) {
        nx = (nx << 16) |
             static_cast<uint32_t>(words[clamp_index(row + np, nw_all)]);
        ++np;
      }
      z |= (bits & 7u) << shift;
      shift += 3;
      active = (bits & 8u) != 0 && shift <= 30;
    }
    const int v = esc ? unzigzag(z, r.max_value) : r.s;
    sym_row[pos] = valid ? wrap_add(v, r.offset) : 0;
    if (valid) {
      x = nx;
      p = np;
    }
  }
  state_out[lane] = x;
  ptr_out[lane] = p;
}

// The block-wide pull of rans_decode_shared: every thread calls it; a
// pulling lane takes the word at the cursor plus the count of lower lanes
// pulling, and the cursor moves by the block's count. `counts` holds one
// total per warp.
__device__ __forceinline__ void pull_shared(
    bool pull, uint32_t& x, int& p, const int* __restrict__ words,
    int64_t img_base, int64_t nw_all, int nw, int* counts, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, pull);
  const int before = __popc(mask & ((1u << lane) - 1u));
  if (lane == 0) counts[warp] = __popc(mask);
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = counts[w];
    off += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();  // counts is rewritten by the next phase
  if (pull) {
    const int pos = wrap_add(p, off + before);
    const uint32_t wd =
        pos < nw ? static_cast<uint32_t>(
                       words[clamp_index(img_base + pos, nw_all)])
                 : 0u;  // past the stream's end reads zero
    x = (x << 16) | wd;
  }
  p = wrap_add(p, total);
}

__global__ void rans_decode_shared(
    const int* __restrict__ words, const int* __restrict__ nwords,
    const int64_t* __restrict__ state_in, const int* __restrict__ ptr_in,
    const int* __restrict__ idx, Tables tb, int* __restrict__ syms,
    int64_t* __restrict__ state_out, int* __restrict__ ptr_out, int B, int K,
    int W, int T, int n_valid) {
  __shared__ int counts[kMaxSharedLanes / 32];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool lane_ok = k < K;
  const int nwarps = blockDim.x >> 5;
  const int64_t nw_all = static_cast<int64_t>(B) * W;
  const int64_t img_base = static_cast<int64_t>(b) * W;
  const int nw = nwords[b];
  uint32_t x =
      lane_ok ? static_cast<uint32_t>(state_in[static_cast<int64_t>(b) * K + k])
              : 0u;
  int p = ptr_in[b];
  const int* idx_row = idx + static_cast<int64_t>(b) * T * K;
  int* sym_row = syms + static_cast<int64_t>(b) * T * K;
  for (int t = 0; t < T; ++t) {
    const int pos = t * K + k;
    const bool valid = lane_ok && pos < n_valid;
    const int ci = lane_ok ? idx_row[pos] : 0;
    const Resolved r = resolve(tb, x, ci);
    if (valid) x = r.adv;
    pull_shared(valid && x < kRansL, x, p, words, img_base, nw_all, nw,
                counts, nwarps);
    const bool esc = valid && r.s == r.max_value;
    uint32_t z = 0;
    int shift = 0;
    bool active = esc;
    // each bypass-chunk iteration is a phase across all lanes
    while (__syncthreads_or(active)) {
      const uint32_t bits = x & 0xfu;
      if (active) x >>= 4;
      pull_shared(active && x < kRansL, x, p, words, img_base, nw_all, nw,
                  counts, nwarps);
      if (active) {
        z |= (bits & 7u) << shift;
        shift += 3;
        active = (bits & 8u) != 0 && shift <= 30;
      }
    }
    if (lane_ok) {
      const int v = esc ? unzigzag(z, r.max_value) : r.s;
      sym_row[pos] = valid ? wrap_add(v, r.offset) : 0;
    }
  }
  if (lane_ok) state_out[static_cast<int64_t>(b) * K + k] = x;
  if (k == 0) ptr_out[b] = p;
}

__global__ void rans_encode_lanes(
    const int* __restrict__ sym_steps, const int* __restrict__ idx_steps,
    const bool* __restrict__ valid_steps, const int* __restrict__ cdf,
    const int* __restrict__ lengths, const int* __restrict__ offsets,
    int* __restrict__ words, int* __restrict__ nwords, int* __restrict__ ovf,
    int T, int B, int K, int wcap, int max_len, int ncdfs) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * K) return;
  const int64_t ncdf = static_cast<int64_t>(ncdfs) * max_len;
  int* out = words + lane * wcap;
  uint32_t x = kRansL;
  int wptr = 0;
  bool wide = false;
  for (int t = T - 1; t >= 0; --t) {
    const int64_t at = static_cast<int64_t>(t) * B * K + lane;
    const int ci = idx_steps[at];
    const bool valid = valid_steps[at];
    const int64_t c = clamp_index(ci, ncdfs);
    const int max_value = lengths[c] - 2;
    const int v = static_cast<int>(static_cast<uint32_t>(sym_steps[at]) -
                                   static_cast<uint32_t>(offsets[c]));
    const bool esc = valid && (v < 0 || v >= max_value);
    const int slot = esc ? max_value : min(max(v, 0), max_value - 1);
    const int base = wrap_mul(ci, max_len);
    const uint32_t lo =
        static_cast<uint32_t>(cdf[clamp_index(wrap_add(base, slot), ncdf)]);
    const uint32_t hi =
        static_cast<uint32_t>(cdf[clamp_index(wrap_add(base, slot + 1), ncdf)]);
    const uint32_t start = lo & 0xffffu;
    const uint32_t freq = ((hi - lo - 1u) & 0xffffu) + 1u;
    uint32_t z = 0;
    if (esc) {
      z = v >= max_value
              ? (static_cast<uint32_t>(v) - static_cast<uint32_t>(max_value)) << 1
              : ((0u - static_cast<uint32_t>(v) - 1u) << 1) | 1u;
    }
    wide |= (z >> 18) != 0;
    int shift0 = 0;
    for (int s = 3; s < 18; s += 3)
      if ((z >> s) != 0) shift0 = s;
    // bypass chunks, most significant first, in six stages
    int ce = 0;
    uint32_t w_c0 = 0, w_c1 = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const bool active = esc && shift0 >= 3 * j;
      const uint32_t sh = active ? static_cast<uint32_t>(shift0 - 3 * j) : 0u;
      const uint32_t bits = ((z >> sh) & 7u) | (j ? 8u : 0u);
      const bool em = active && x >= (1u << 28);
      if (em) {
        if (ce == 0) w_c0 = x & 0xffffu;
        if (ce == 1) w_c1 = x & 0xffffu;
        ++ce;
      }
      const uint32_t x1 = em ? x >> 16 : x;
      if (active) x = (x1 << 4) | bits;
    }
    // the slot code: the symbol itself, or the escape slot
    const bool em_s = valid && (x >> 16) >= freq;
    const uint32_t w_s = x & 0xffffu;
    const uint32_t x1 = em_s ? x >> 16 : x;
    const uint32_t q = x1 / freq;
    if (valid) x = (q << kProbBits) + (x1 - q * freq) + start;
    if (ce >= 1 && wptr < wcap) out[wptr] = static_cast<int>(w_c0);
    if (ce >= 2 && wptr + 1 < wcap) out[wptr + 1] = static_cast<int>(w_c1);
    if (em_s && wptr + ce < wcap) out[wptr + ce] = static_cast<int>(w_s);
    wptr += ce + (em_s ? 1 : 0);
  }
  // flush: low word, then high word (the decoder reads high first)
  if (wptr < wcap) out[wptr] = static_cast<int>(x & 0xffffu);
  if (wptr + 1 < wcap) out[wptr + 1] = static_cast<int>(x >> 16);
  nwords[lane] = wptr + 2;
  if (wide || wptr + 2 > wcap) atomicOr(ovf, 1);
}

// The latency probe behind the lane kernels' serial-chain bound: one thread
// walks a chain of `n` dependent steps. mode 0: each load at the index the
// last one read (a pointer chase over `next`, laid out by the caller); mode
// 1: the encoder's slot-code update (a 32-bit division by `f`, its
// remainder, `s` added, the renorm shift), each on the last one's state.
// The end value goes to `sink`, so nothing is elided.
__global__ void rans_chain_probe(const int* next, int n, int mode, uint32_t f,
                                 uint32_t s, uint32_t* sink) {
  if (mode == 0) {
    int i = 0;
    for (int j = 0; j < n; ++j) i = next[i];
    *sink = static_cast<uint32_t>(i);
    return;
  }
  uint32_t x = kRansL + s;
  for (int j = 0; j < n; ++j) {
    const uint32_t x1 = (x >> 16) >= f ? x >> 16 : x;
    const uint32_t q = x1 / f;
    x = (q << kProbBits) + (x1 - q * f) + s;
  }
  *sink = x;
}

int check_launch() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// v1: words [B, K, W] int32 (16-bit values), nwords [B, K] int32, state
// [B, K] int64 (uint32 values), ptr [B, K] int32, idx [B, T*K] int32; the
// tables as in entropy/device_rans.py DeviceRansTables (lut uint16). Writes
// syms [B, T*K] int32, state_out, ptr_out. Returns 0, a cudaError_t, or -1
// for arguments this file does not take.
int rdeic_rans_decode_lanes(const void* words, const void* nwords,
                            const void* state, const void* ptr,
                            const void* idx, const void* lut, const void* cdf,
                            const void* lengths, const void* offsets,
                            void* syms, void* state_out, void* ptr_out, int B,
                            int K, int W, int T, int n_valid, int max_len,
                            int ncdfs, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || W < 1 || T < 0 || ncdfs < 1 ||
      max_len < 1)
    return -1;
  const Tables tb{static_cast<const uint16_t*>(lut), static_cast<const int*>(cdf),
                  static_cast<const int*>(lengths),
                  static_cast<const int*>(offsets), max_len, ncdfs};
  const dim3 grid((K + kLanesPerBlock - 1) / kLanesPerBlock, B);
  rans_decode_lanes<<<grid, kLanesPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<const int*>(nwords),
      static_cast<const int64_t*>(state), static_cast<const int*>(ptr),
      static_cast<const int*>(idx), tb, static_cast<int*>(syms),
      static_cast<int64_t*>(state_out), static_cast<int*>(ptr_out), B, K, W, T,
      n_valid);
  return check_launch();
}

// v2: words [B, W] int32, nwords [B] int32, state [B, K] int64, ptr [B]
// int32 (one cursor per image), idx [B, T*K] int32; K <= 1024.
int rdeic_rans_decode_shared(const void* words, const void* nwords,
                             const void* state, const void* ptr,
                             const void* idx, const void* lut, const void* cdf,
                             const void* lengths, const void* offsets,
                             void* syms, void* state_out, void* ptr_out, int B,
                             int K, int W, int T, int n_valid, int max_len,
                             int ncdfs, void* stream) {
  if (B < 1 || K < 1 || K > kMaxSharedLanes || W < 1 || T < 0 || ncdfs < 1 ||
      max_len < 1)
    return -1;
  const Tables tb{static_cast<const uint16_t*>(lut), static_cast<const int*>(cdf),
                  static_cast<const int*>(lengths),
                  static_cast<const int*>(offsets), max_len, ncdfs};
  const int threads = (K + 31) / 32 * 32;
  rans_decode_shared<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<const int*>(nwords),
      static_cast<const int64_t*>(state), static_cast<const int*>(ptr),
      static_cast<const int*>(idx), tb, static_cast<int*>(syms),
      static_cast<int64_t*>(state_out), static_cast<int*>(ptr_out), B, K, W, T,
      n_valid);
  return check_launch();
}

// sym_steps, idx_steps [T, B, K] int32, valid_steps [T, B, K] bool; words
// [B, K, wcap] int32 (zeroed by the caller), nwords [B, K] int32, ovf one
// int32 (zeroed by the caller, set to 1 on overflow).
int rdeic_rans_encode_lanes(const void* sym_steps, const void* idx_steps,
                            const void* valid_steps, const void* cdf,
                            const void* lengths, const void* offsets,
                            void* words, void* nwords, void* ovf, int T, int B,
                            int K, int wcap, int max_len, int ncdfs,
                            void* stream) {
  if (T < 0 || B < 1 || K < 1 || wcap < 2 || ncdfs < 1 || max_len < 1)
    return -1;
  const int64_t lanes = static_cast<int64_t>(B) * K;
  const int blocks = static_cast<int>((lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  rans_encode_lanes<<<blocks, kLanesPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sym_steps), static_cast<const int*>(idx_steps),
      static_cast<const bool*>(valid_steps), static_cast<const int*>(cdf),
      static_cast<const int*>(lengths), static_cast<const int*>(offsets),
      static_cast<int*>(words), static_cast<int*>(nwords),
      static_cast<int*>(ovf), T, B, K, wcap, max_len, ncdfs);
  return check_launch();
}

// next [len] int32 (a chain of indexes in range), sink one uint32; f >= 1.
int rdeic_rans_chain_probe(const void* next, int n, int mode, unsigned f,
                           unsigned s, void* sink, void* stream) {
  if (n < 0 || f < 1 || mode < 0 || mode > 1) return -1;
  rans_chain_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), n, mode, f, s,
      static_cast<uint32_t*>(sink));
  return check_launch();
}

const char* rdeic_rans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
