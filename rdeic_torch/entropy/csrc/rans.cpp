// rANS entropy coder (host-side, C++) for rdeic_torch: a copy of
// rdeic_tpu/entropy/csrc/rans.cpp whose code is unchanged (only comments
// differ), so both packages write and read the same bitstreams without
// sharing files.
//
// Role parity: the compressai BufferedRansEncoder/RansDecoder used by the
// upstream RDEIC model (model/compression.py:163-262). This is an
// original implementation of the standard rANS construction (Duda 2013;
// popularized by F. Giesen's ryg_rans): 32-bit state, 16-bit probability
// precision, 16-bit renormalization words. Out-of-range symbols use an
// escape slot (the CDF tail bin) followed by variable-length bypass chunks
// (4-bit groups: 1 continuation bit + 3 payload bits).
//
// The stream format is self-defined (this framework's bitstreams only need
// to round-trip bit-exactly within the framework).
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 16;  // normalized interval lower bound

struct WordBuf {
  std::vector<uint16_t> words;
  void put(uint16_t w) { words.push_back(w); }
};

// --- encoder primitives (operate on state x, emit renorm words) ---------
inline void enc_symbol(uint32_t& x, WordBuf& buf, uint32_t start,
                       uint32_t freq) {
  // renorm: keep x < freq << 16 so the decoder invariant holds
  // (uint64 guards against freq == 2^16 overflowing the shift)
  const uint64_t x_max = static_cast<uint64_t>(freq) << 16;
  while (x >= x_max) {
    buf.put(static_cast<uint16_t>(x & 0xffff));
    x >>= 16;
  }
  x = ((x / freq) << kProbBits) + (x % freq) + start;
}

inline void enc_raw(uint32_t& x, WordBuf& buf, uint32_t bits, uint32_t nbits) {
  const uint32_t x_max = 1u << (32 - nbits);
  while (x >= x_max) {
    buf.put(static_cast<uint16_t>(x & 0xffff));
    x >>= 16;
  }
  x = (x << nbits) | (bits & ((1u << nbits) - 1));
}

// --- decoder ---------------------------------------------------------------
struct Decoder {
  std::vector<uint8_t> stream;
  size_t pos = 0;  // byte position
  uint32_t x = 0;

  uint16_t read16() {
    if (pos + 2 > stream.size()) return 0;  // past-end reads zero-fill
    uint16_t w = static_cast<uint16_t>(stream[pos]) |
                 (static_cast<uint16_t>(stream[pos + 1]) << 8);
    pos += 2;
    return w;
  }

  void init(const uint8_t* data, int n) {
    stream.assign(data, data + n);
    pos = 0;
    x = (static_cast<uint32_t>(read16()) << 16) | read16();
  }

  void renorm() {
    while (x < kRansL && pos < stream.size()) {
      x = (x << 16) | read16();
    }
  }

  uint32_t dec_get_cum() const { return x & ((1u << kProbBits) - 1); }

  void dec_advance(uint32_t start, uint32_t freq) {
    x = freq * (x >> kProbBits) + (x & ((1u << kProbBits) - 1)) - start;
    renorm();
  }

  uint32_t dec_raw(uint32_t nbits) {
    uint32_t bits = x & ((1u << nbits) - 1);
    x >>= nbits;
    renorm();
    return bits;
  }
};

// Find symbol s such that cdf[s] <= cum < cdf[s+1]; cdf has `len` entries.
inline int cdf_find(const int32_t* cdf, int len, uint32_t cum) {
  int lo = 0, hi = len - 1;  // invariant: cdf[lo] <= cum < cdf[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(cdf[mid]) <= cum)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Map an out-of-range residual to a non-negative bypass value. In-range
// values are 0 <= v < max_value; escapes carry (v - max_value) for overflow
// or (-v - 1) for underflow, distinguished by the low bit.
inline uint32_t zigzag_escape(int64_t v, int64_t max_value) {
  return v >= max_value ? static_cast<uint32_t>((v - max_value) << 1)
                        : static_cast<uint32_t>(((-v - 1) << 1) | 1);
}

inline int64_t unzigzag_escape(uint32_t z, int64_t max_value) {
  return (z & 1) ? -static_cast<int64_t>(z >> 1) - 1
                 : static_cast<int64_t>(z >> 1) + max_value;
}

// Encode one (symbol, cdf index) pair onto state x / word buffer buf —
// shared by the single-stream and interleaved encoders so both emit
// bit-identical per-symbol codes.
inline int encode_one(uint32_t& x, WordBuf& buf, int32_t symbol, int32_t idx,
                      const int32_t* cdfs, const int32_t* cdf_lengths,
                      const int32_t* offsets, int ncdfs, int max_len) {
  if (idx < 0 || idx >= ncdfs) return -2;
  const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
  const int len = cdf_lengths[idx];
  const int64_t max_value = len - 2;
  const int64_t v = static_cast<int64_t>(symbol) - offsets[idx];

  if (v >= 0 && v < max_value) {
    enc_symbol(x, buf, cdf[v], cdf[v + 1] - cdf[v]);
  } else {
    uint32_t z = zigzag_escape(v, max_value);
    uint32_t chunks[16];
    int nc = 0;
    do {
      uint32_t c = z & 7;
      z >>= 3;
      if (z != 0) c |= 8;
      chunks[nc++] = c;
    } while (z != 0 && nc < 16);
    for (int c = nc - 1; c >= 0; --c) enc_raw(x, buf, chunks[c], 4);
    enc_symbol(x, buf, cdf[max_value], cdf[max_value + 1] - cdf[max_value]);
  }
  return 0;
}

}  // namespace

extern "C" {

// Encode n symbols. cdfs: flattened [ncdfs, max_len] int32. Returns bytes
// written, or -1 if `capacity` is insufficient, -2 on bad args.
int rans_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                             int n, const int32_t* cdfs,
                             const int32_t* cdf_lengths,
                             const int32_t* offsets, int ncdfs, int max_len,
                             uint8_t* out, int capacity) {
  WordBuf buf;
  buf.words.reserve(static_cast<size_t>(n) + 16);
  uint32_t x = kRansL;

  // rANS encodes in reverse so the decoder reads forward.
  for (int i = n - 1; i >= 0; --i) {
    if (encode_one(x, buf, symbols[i], indexes[i], cdfs, cdf_lengths, offsets,
                   ncdfs, max_len) != 0)
      return -2;
  }
  // flush state (two words; decoder reads high then low first)
  buf.put(static_cast<uint16_t>(x & 0xffff));
  buf.put(static_cast<uint16_t>(x >> 16));

  const int nbytes = static_cast<int>(buf.words.size() * 2);
  if (nbytes > capacity) return -1;
  // words were emitted in reverse stream order
  uint8_t* p = out;
  for (size_t i = buf.words.size(); i-- > 0;) {
    *p++ = static_cast<uint8_t>(buf.words[i] & 0xff);
    *p++ = static_cast<uint8_t>(buf.words[i] >> 8);
  }
  return nbytes;
}

void* rans_decoder_new(const uint8_t* stream, int nbytes) {
  auto* d = new Decoder();
  d->init(stream, nbytes);
  return d;
}

void rans_decoder_free(void* dec) { delete static_cast<Decoder*>(dec); }

// Decode n symbols from the persistent stream into out (int32 values with
// offsets already applied back). Returns 0 on success, -2 on bad args.
int rans_decode_stream(void* dec, const int32_t* indexes, int n,
                       const int32_t* cdfs, const int32_t* cdf_lengths,
                       const int32_t* offsets, int ncdfs, int max_len,
                       int32_t* out) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -2;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
    const int len = cdf_lengths[idx];
    const int64_t max_value = len - 2;

    const uint32_t cum = d->dec_get_cum();
    const int s = cdf_find(cdf, len, cum);
    d->dec_advance(cdf[s], cdf[s + 1] - cdf[s]);

    int64_t v;
    if (s == max_value) {
      uint32_t z = 0;
      int shift = 0;
      for (;;) {
        const uint32_t c = d->dec_raw(4);
        z |= (c & 7) << shift;
        shift += 3;
        if (!(c & 8) || shift > 30) break;
      }
      v = unzigzag_escape(z, max_value);
    } else {
      v = s;
    }
    out[i] = static_cast<int32_t>(v + offsets[idx]);
  }
  return 0;
}

// Coarse bucket index: buckets[idx][b] = the symbol s whose cdf range
// contains cum = b << kBucketShift. Narrows the per-symbol search to the
// few symbols inside one 2^shift-wide cum bucket. At 64 cdfs x 256
// buckets x 2 B = 32 KB the whole table is L1/L2-resident — unlike the
// full 8 MB cum->symbol LUT (rans_build_lut below), which measured 2.2x
// SLOWER than binary search because every random cum missed cache.
constexpr int kBucketShift = 8;
constexpr int kNumBuckets = 1 << (kProbBits - kBucketShift);  // 256

// Exported so the Python wrapper sizes its bucket buffer from the library
// instead of a duplicated literal (changing kBucketShift would otherwise
// make rans_build_buckets write past the caller's buffer).
int rans_num_buckets() { return kNumBuckets; }

void rans_build_buckets(const int32_t* cdfs, const int32_t* cdf_lengths,
                        int ncdfs, int max_len, uint16_t* buckets) {
  for (int idx = 0; idx < ncdfs; ++idx) {
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
    const int len = cdf_lengths[idx];
    uint16_t* row = buckets + static_cast<size_t>(idx) * kNumBuckets;
    int s = 0;
    for (int b = 0; b < kNumBuckets; ++b) {
      const uint32_t cum = static_cast<uint32_t>(b) << kBucketShift;
      while (s + 1 < len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
      row[b] = static_cast<uint16_t>(s);
    }
  }
}

// Decode with the bucket index: identical output to rans_decode_stream.
int rans_decode_stream_bucketed(void* dec, const int32_t* indexes, int n,
                                const int32_t* cdfs,
                                const int32_t* cdf_lengths,
                                const int32_t* offsets, int ncdfs,
                                int max_len, const uint16_t* buckets,
                                int32_t* out) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -2;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
    const int len = cdf_lengths[idx];
    const int64_t max_value = len - 2;
    const uint16_t* row = buckets + static_cast<size_t>(idx) * kNumBuckets;

    const uint32_t cum = d->dec_get_cum();
    const int b = static_cast<int>(cum >> kBucketShift);
    int s = row[b];
    // walk forward inside the bucket (rarely more than a step or two:
    // a bucket holds 2^8 of the 2^16 cum mass)
    while (s + 1 < len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
    d->dec_advance(cdf[s], cdf[s + 1] - cdf[s]);

    int64_t v;
    if (s == max_value) {
      uint32_t z = 0;
      int shift = 0;
      for (;;) {
        const uint32_t c = d->dec_raw(4);
        z |= (c & 7) << shift;
        shift += 3;
        if (!(c & 8) || shift > 30) break;
      }
      v = unzigzag_escape(z, max_value);
    } else {
      v = s;
    }
    out[i] = static_cast<int32_t>(v + offsets[idx]);
  }
  return 0;
}

// Build a cum -> symbol lookup table for O(1) symbol resolution:
// lut[idx * 2^16 + cum] = s with cdf[s] <= cum < cdf[s+1]. The quantized
// CDFs span the full 16-bit range; any tail gap maps to the escape slot.
// Replaces the per-symbol binary search (the decode hot loop) — the table
// is ncdfs * 65536 * 2 bytes (~8 MB for the 64-scale Gaussian set), built
// once per CdfTable.
void rans_build_lut(const int32_t* cdfs, const int32_t* cdf_lengths,
                    int ncdfs, int max_len, uint16_t* lut) {
  for (int idx = 0; idx < ncdfs; ++idx) {
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
    const int len = cdf_lengths[idx];
    uint16_t* row = lut + (static_cast<size_t>(idx) << kProbBits);
    uint32_t cum = 0;
    for (int s = 0; s < len - 1; ++s) {
      const uint32_t hi = static_cast<uint32_t>(cdf[s + 1]);
      for (; cum < hi && cum < (1u << kProbBits); ++cum)
        row[cum] = static_cast<uint16_t>(s);
    }
    for (; cum < (1u << kProbBits); ++cum)
      row[cum] = static_cast<uint16_t>(len - 2);  // escape slot
  }
}

// LUT-accelerated variant of rans_decode_stream (bit-identical output).
int rans_decode_stream_lut(void* dec, const int32_t* indexes, int n,
                           const int32_t* cdfs, const int32_t* cdf_lengths,
                           const int32_t* offsets, int ncdfs, int max_len,
                           const uint16_t* lut, int32_t* out) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -2;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
    const int64_t max_value = cdf_lengths[idx] - 2;

    const uint32_t cum = d->dec_get_cum();
    const int s = lut[(static_cast<size_t>(idx) << kProbBits) | cum];
    d->dec_advance(cdf[s], cdf[s + 1] - cdf[s]);

    int64_t v;
    if (s == max_value) {
      uint32_t z = 0;
      int shift = 0;
      for (;;) {
        const uint32_t c = d->dec_raw(4);
        z |= (c & 7) << shift;
        shift += 3;
        if (!(c & 8) || shift > 30) break;
      }
      v = unzigzag_escape(z, max_value);
    } else {
      v = s;
    }
    out[i] = static_cast<int32_t>(v + offsets[idx]);
  }
  return 0;
}

// Interleaved-lane encode for device-side (SPMD) decoding: within each
// pass p (sizes in pass_sizes[npass], summing to n), symbol j goes to lane
// (j % K); each lane's subsequence is encoded as an INDEPENDENT rANS
// stream (same per-symbol code as rans_encode_with_indexes, so escapes /
// renorm behave identically). A vector decoder can then decode all K
// lanes in lock-step: at step t of pass p it resolves symbols
// t*K .. t*K+K-1 in parallel.
//
// Output layout: lane 0 bytes, lane 1 bytes, ... back to back in `out`;
// lane_nbytes[k] receives each lane's byte count (always even — the
// streams are u16 words). Returns total bytes, -1 if capacity is too
// small, -2 on bad args.
int rans_encode_interleaved(const int32_t* symbols, const int32_t* indexes,
                            int n, const int32_t* pass_sizes, int npass,
                            int K, const int32_t* cdfs,
                            const int32_t* cdf_lengths, const int32_t* offsets,
                            int ncdfs, int max_len, uint8_t* out, int capacity,
                            int32_t* lane_nbytes) {
  if (K <= 0 || npass < 0) return -2;
  {
    int64_t total = 0;
    for (int p = 0; p < npass; ++p) total += pass_sizes[p];
    if (total != n) return -2;
  }
  // partition: per-lane list of global symbol positions, forward order
  std::vector<std::vector<int32_t>> lane_pos(K);
  for (int k = 0; k < K; ++k)
    lane_pos[k].reserve(static_cast<size_t>(n) / K + npass);
  {
    int g = 0;
    for (int p = 0; p < npass; ++p) {
      const int np = pass_sizes[p];
      for (int j = 0; j < np; ++j, ++g) lane_pos[j % K].push_back(g);
    }
  }

  uint8_t* p_out = out;
  int written = 0;
  for (int k = 0; k < K; ++k) {
    WordBuf buf;
    buf.words.reserve(lane_pos[k].size() + 4);
    uint32_t x = kRansL;
    for (size_t i = lane_pos[k].size(); i-- > 0;) {
      const int32_t g = lane_pos[k][i];
      if (encode_one(x, buf, symbols[g], indexes[g], cdfs, cdf_lengths,
                     offsets, ncdfs, max_len) != 0)
        return -2;
    }
    buf.put(static_cast<uint16_t>(x & 0xffff));
    buf.put(static_cast<uint16_t>(x >> 16));
    const int nbytes = static_cast<int>(buf.words.size() * 2);
    if (written + nbytes > capacity) return -1;
    for (size_t i = buf.words.size(); i-- > 0;) {
      *p_out++ = static_cast<uint8_t>(buf.words[i] & 0xff);
      *p_out++ = static_cast<uint8_t>(buf.words[i] >> 8);
    }
    lane_nbytes[k] = nbytes;
    written += nbytes;
  }
  return written;
}

// One-shot decode convenience (stream created and freed internally).
int rans_decode_with_indexes(const uint8_t* stream, int nbytes,
                             const int32_t* indexes, int n,
                             const int32_t* cdfs, const int32_t* cdf_lengths,
                             const int32_t* offsets, int ncdfs, int max_len,
                             int32_t* out) {
  Decoder d;
  d.init(stream, nbytes);
  return rans_decode_stream(&d, indexes, n, cdfs, cdf_lengths, offsets, ncdfs,
                            max_len, out);
}

// ===========================================================================
// v2 "shared-stream" interleaved format.
//
// v1 (rans_encode_interleaved) stores K per-lane streams back to back and
// needs a 4-byte size PER LANE in the container header — ~0.5 KB of pure
// overhead at K=128, which is what makes device decode rate-expensive at
// extreme-compression payloads. v2 merges all lanes' renorm words into ONE
// stream, ordered exactly as the lock-step vector decoder pulls them, so
// the container needs only K itself (the per-symbol code is unchanged and
// still bit-identical to the scalar coder).
//
// The merge is exact because every encoder primitive (enc_symbol,
// enc_raw(4)) emits AT MOST ONE word (a single 16-bit shift always drops
// the state below the next threshold), so the decoder conjugate needs at
// most one pull per primitive, at a position derivable without ambiguity.
// The global pull order is the vector decoder's phase order per step t:
//   phase A: lanes 0..K-1 symbol-advance renorm pulls;
//   phase B: bypass-chunk iterations j = 0,1,...: lanes still in their
//            escape chain pull after each 4-bit shift.
// (The init pulls — two words per lane, lane-major — sit at the head.)
// Mirrored by rdeic_tpu/entropy/device_rans.decode_pass_shared.
// ===========================================================================

}  // extern "C"  (the v2 helpers below use templates)

namespace {

struct LaneCursor {
  const uint8_t* p = nullptr;
  int nbytes = 0;
  int pos = 0;
  uint16_t read16() {
    if (pos + 2 > nbytes) {
      pos += 2;  // advance-and-zero-fill (matches the device's masked pull)
      return 0;
    }
    uint16_t w = static_cast<uint16_t>(p[pos]) |
                 (static_cast<uint16_t>(p[pos + 1]) << 8);
    pos += 2;
    return w;
  }
  bool fully_consumed() const { return pos == nbytes; }
};

// Walk the vector-decode schedule over per-lane word queues; `emit` is
// called for every pulled word in global order. Returns 0, or -2 on bad
// args. Shared by the merge (emit = append) and nothing else — the shared
// DECODER below duplicates the walk against one stream because its reads
// mutate decoder state.
template <typename Emit>
int walk_schedule(LaneCursor* cur, uint32_t* x, int K, const int32_t* indexes,
                  const int32_t* pass_sizes, int npass, const int32_t* cdfs,
                  const int32_t* cdf_lengths, int ncdfs, int max_len,
                  Emit&& emit) {
  std::vector<uint8_t> esc(K);
  std::vector<int> zshift(K);
  int g = 0;
  for (int p = 0; p < npass; ++p) {
    const int np = pass_sizes[p];
    const int T = (np + K - 1) / K;
    for (int t = 0; t < T; ++t) {
      const int kmax = np - t * K < K ? np - t * K : K;
      // phase A: symbol advance + conditional renorm pull, lane order
      for (int k = 0; k < kmax; ++k) {
        const int32_t idx = indexes[g + t * K + k];
        if (idx < 0 || idx >= ncdfs) return -2;
        const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
        const int len = cdf_lengths[idx];
        const uint32_t cum = x[k] & 0xffff;
        const int s = cdf_find(cdf, len, cum);
        const uint32_t freq = cdf[s + 1] - cdf[s];
        x[k] = freq * (x[k] >> kProbBits) + cum - cdf[s];
        if (x[k] < kRansL) {
          const uint16_t w = cur[k].read16();
          x[k] = (x[k] << 16) | w;
          emit(w);
        }
        esc[k] = (s == len - 2);
        zshift[k] = 0;
      }
      // phase B: bypass-chunk iterations across the still-active lanes
      bool any = false;
      for (int k = 0; k < kmax; ++k) any |= (esc[k] != 0);
      while (any) {
        any = false;
        for (int k = 0; k < kmax; ++k) {
          if (!esc[k]) continue;
          const uint32_t bits = x[k] & 0xf;
          x[k] >>= 4;
          if (x[k] < kRansL) {
            const uint16_t w = cur[k].read16();
            x[k] = (x[k] << 16) | w;
            emit(w);
          }
          zshift[k] += 3;
          esc[k] = ((bits & 8) != 0) && zshift[k] <= 30;
          any |= (esc[k] != 0);
        }
      }
    }
    g += np;
  }
  return 0;
}

}  // namespace

extern "C" {

// Merge v1 per-lane streams into one v2 shared stream (same total bytes;
// the container drops its per-lane size table). Returns bytes written,
// -1 if capacity is too small, -2 on bad args, -3 if the schedule failed
// to consume every lane exactly (internal invariant; cannot happen for
// well-formed v1 output with matching indexes/pass_sizes).
int rans_lanes_to_shared(const uint8_t* lanes, const int32_t* lane_nbytes,
                         int K, const int32_t* indexes, int n,
                         const int32_t* pass_sizes, int npass,
                         const int32_t* cdfs, const int32_t* cdf_lengths,
                         int ncdfs, int max_len, uint8_t* out, int capacity) {
  if (K <= 0 || npass < 0) return -2;
  {
    int64_t total = 0;
    for (int p = 0; p < npass; ++p) total += pass_sizes[p];
    if (total != n) return -2;
  }
  std::vector<LaneCursor> cur(K);
  {
    int off = 0;
    for (int k = 0; k < K; ++k) {
      cur[k].p = lanes + off;
      cur[k].nbytes = lane_nbytes[k];
      off += lane_nbytes[k];
    }
  }
  std::vector<uint16_t> merged;
  merged.reserve(static_cast<size_t>(n) / 2 + 2 * K);
  std::vector<uint32_t> x(K);
  // init: two flush words per lane, lane-major, at the stream head
  for (int k = 0; k < K; ++k) {
    const uint16_t hi = cur[k].read16();
    const uint16_t lo = cur[k].read16();
    x[k] = (static_cast<uint32_t>(hi) << 16) | lo;
    merged.push_back(hi);
    merged.push_back(lo);
  }
  const int rc = walk_schedule(
      cur.data(), x.data(), K, indexes, pass_sizes, npass, cdfs, cdf_lengths,
      ncdfs, max_len, [&](uint16_t w) { merged.push_back(w); });
  if (rc != 0) return rc;
  for (int k = 0; k < K; ++k)
    if (!cur[k].fully_consumed()) return -3;
  const int nbytes = static_cast<int>(merged.size() * 2);
  if (nbytes > capacity) return -1;
  uint8_t* o = out;
  for (const uint16_t w : merged) {
    *o++ = static_cast<uint8_t>(w & 0xff);
    *o++ = static_cast<uint8_t>(w >> 8);
  }
  return nbytes;
}

// Encode straight into the v2 shared format (v1 encode + merge).
int rans_encode_interleaved_shared(
    const int32_t* symbols, const int32_t* indexes, int n,
    const int32_t* pass_sizes, int npass, int K, const int32_t* cdfs,
    const int32_t* cdf_lengths, const int32_t* offsets, int ncdfs,
    int max_len, uint8_t* out, int capacity) {
  std::vector<uint8_t> scratch(static_cast<size_t>(capacity) + 8 * K + 64);
  std::vector<int32_t> lane_nbytes(K);
  const int w = rans_encode_interleaved(
      symbols, indexes, n, pass_sizes, npass, K, cdfs, cdf_lengths, offsets,
      ncdfs, max_len, scratch.data(), static_cast<int>(scratch.size()),
      lane_nbytes.data());
  if (w < 0) return w;
  return rans_lanes_to_shared(scratch.data(), lane_nbytes.data(), K, indexes,
                              n, pass_sizes, npass, cdfs, cdf_lengths, ncdfs,
                              max_len, out, capacity);
}

// --- host decoder for v2 streams (persistent across passes, so the codec
// can interleave entropy-parameter programs between decode calls) ---------
namespace {

struct SharedDecoder {
  std::vector<uint8_t> stream;
  size_t pos = 0;
  int K = 0;
  std::vector<uint32_t> x;

  uint16_t read16() {
    if (pos + 2 > stream.size()) {
      pos += 2;  // advance-and-zero-fill (identical to the device pull)
      return 0;
    }
    uint16_t w = static_cast<uint16_t>(stream[pos]) |
                 (static_cast<uint16_t>(stream[pos + 1]) << 8);
    pos += 2;
    return w;
  }
};

}  // namespace

void* rans_shared_decoder_new(const uint8_t* stream, int nbytes, int K) {
  auto* d = new SharedDecoder();
  d->stream.assign(stream, stream + nbytes);
  d->K = K;
  d->x.resize(K);
  for (int k = 0; k < K; ++k)
    d->x[k] = (static_cast<uint32_t>(d->read16()) << 16) | d->read16();
  return d;
}

void rans_shared_decoder_free(void* dec) {
  delete static_cast<SharedDecoder*>(dec);
}

// Decode one pass of n symbols (striped lane = j % K) from the shared
// stream. Pull order mirrors walk_schedule / decode_pass_shared exactly.
int rans_shared_decode_pass(void* dec, const int32_t* indexes, int n,
                            const int32_t* cdfs, const int32_t* cdf_lengths,
                            const int32_t* offsets, int ncdfs, int max_len,
                            int32_t* out) {
  SharedDecoder* d = static_cast<SharedDecoder*>(dec);
  const int K = d->K;
  std::vector<uint8_t> esc(K);
  std::vector<int> zshift(K);
  std::vector<uint32_t> z(K);
  std::vector<int64_t> maxv(K);
  const int T = (n + K - 1) / K;
  for (int t = 0; t < T; ++t) {
    const int kmax = n - t * K < K ? n - t * K : K;
    for (int k = 0; k < kmax; ++k) {
      const int32_t idx = indexes[t * K + k];
      if (idx < 0 || idx >= ncdfs) return -2;
      const int32_t* cdf = cdfs + static_cast<size_t>(idx) * max_len;
      const int len = cdf_lengths[idx];
      const int64_t max_value = len - 2;
      const uint32_t cum = d->x[k] & 0xffff;
      const int s = cdf_find(cdf, len, cum);
      const uint32_t freq = cdf[s + 1] - cdf[s];
      d->x[k] = freq * (d->x[k] >> kProbBits) + cum - cdf[s];
      if (d->x[k] < kRansL) d->x[k] = (d->x[k] << 16) | d->read16();
      esc[k] = (s == max_value);
      zshift[k] = 0;
      z[k] = 0;
      maxv[k] = max_value;
      out[t * K + k] = static_cast<int32_t>(s + offsets[idx]);
    }
    bool any = false;
    for (int k = 0; k < kmax; ++k) any |= (esc[k] != 0);
    std::vector<uint8_t> in_chain(esc.begin(), esc.end());
    while (any) {
      any = false;
      for (int k = 0; k < kmax; ++k) {
        if (!in_chain[k]) continue;
        const uint32_t bits = d->x[k] & 0xf;
        d->x[k] >>= 4;
        if (d->x[k] < kRansL) d->x[k] = (d->x[k] << 16) | d->read16();
        z[k] |= (bits & 7) << zshift[k];
        zshift[k] += 3;
        in_chain[k] = ((bits & 8) != 0) && zshift[k] <= 30;
        any |= (in_chain[k] != 0);
      }
    }
    for (int k = 0; k < kmax; ++k) {
      if (!esc[k]) continue;
      const int32_t idx = indexes[t * K + k];
      out[t * K + k] = static_cast<int32_t>(
          unzigzag_escape(z[k], maxv[k]) + offsets[idx]);
    }
  }
  return 0;
}

}  // extern "C"
