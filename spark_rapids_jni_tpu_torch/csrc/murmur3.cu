// Spark Murmur3 table hash for Hopper: kernel K5.
//
// Replaces the Pallas kernel of spark_rapids_jni_tpu/kernels/hashing.py:
// murmur3_table_fused (_hash_words_pallas / _hash_kernel). Spark's
// Murmur3_x86_32 with seed 42 chained left to right over the key columns,
// as HashPartitioning computes it: h = hash(col_i, seed = h), a null row
// leaving h unchanged. The word rules are those of _column_words:
//   int family  (INT8/16/32, UINT8/16/32, TIMESTAMP_DAYS, DURATION_DAYS,
//                DICTIONARY32, BOOL8): one u32 word, the value widened to
//                int32 (signed types sign-extend, unsigned zero-extend),
//                hashInt;
//   FLOAT32:     its bit pattern with -0.0 made +0.0 (NaN kept), hashInt;
//   long family  (every other fixed-width type, DECIMAL32/64 included): the
//                value widened to int64, low word then high word, hashLong;
//   FLOAT64:     its bit pattern (stored in int64) with -0.0 made +0.0.
//
// Design: one thread per row runs the whole chain across every key column
// in registers. The wrapper hands over a small descriptor per column (data
// pointer, width, signedness, kind, validity pointer or null), so the
// kernel reads each column's native storage once — no widened word copies
// are made in device memory, as the TPU kernel's wrapper did.
//
// Bound on the H100: bytes. A row costs its key bytes, one validity byte
// per nullable key and 4 bytes of output; the integer work (about 11
// operations a word plus a 10-operation finalizer a column) is well under
// the memory time. Neighbouring threads read neighbouring rows, so every
// load and the store are coalesced.

#include "common.cuh"

constexpr int kMaxHashCols = 32;

enum HashKind : int { kInt = 0, kFloat32 = 1, kLong = 2, kFloat64 = 3 };

struct HashCol {
  const void* data;
  const uint8_t* valid;  // null: the column has no nulls
  int width;             // bytes per value: 1, 2, 4 or 8
  int is_signed;         // sign-extend narrow values
  int kind;              // HashKind
};

struct HashCols {
  HashCol col[kMaxHashCols];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  return rotl32(k1 * 0xCC9E2D51u, 15) * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

// the value of row i widened to 64 bits (sign- or zero-extended)
__device__ __forceinline__ uint64_t load_widened(const HashCol& c, int64_t i) {
  switch (c.width) {
    case 1: {
      uint8_t v = static_cast<const uint8_t*>(c.data)[i];
      return c.is_signed ? static_cast<uint64_t>(static_cast<int64_t>(
                               static_cast<int8_t>(v)))
                         : v;
    }
    case 2: {
      uint16_t v = static_cast<const uint16_t*>(c.data)[i];
      return c.is_signed ? static_cast<uint64_t>(static_cast<int64_t>(
                               static_cast<int16_t>(v)))
                         : v;
    }
    case 4: {
      uint32_t v = static_cast<const uint32_t*>(c.data)[i];
      return c.is_signed ? static_cast<uint64_t>(static_cast<int64_t>(
                               static_cast<int32_t>(v)))
                         : v;
    }
    default:
      return static_cast<const uint64_t*>(c.data)[i];
  }
}

__global__ void murmur3_kernel(HashCols cols, int ncols, uint32_t seed,
                               int32_t* __restrict__ out, int64_t n) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  uint32_t h = seed;
  for (int c = 0; c < ncols; ++c) {
    const HashCol& col = cols.col[c];
    uint64_t v = load_widened(col, i);
    uint32_t next;
    if (col.kind == kInt || col.kind == kFloat32) {
      uint32_t w = static_cast<uint32_t>(v);
      if (col.kind == kFloat32 && w == 0x80000000u) w = 0;  // -0.0
      next = fmix(mix_h1(h, mix_k1(w)), 4);
    } else {
      if (col.kind == kFloat64 && v == 0x8000000000000000ull) v = 0;
      next = mix_h1(h, mix_k1(static_cast<uint32_t>(v)));
      next = mix_h1(next, mix_k1(static_cast<uint32_t>(v >> 32)));
      next = fmix(next, 8);
    }
    if (col.valid == nullptr || col.valid[i] != 0) h = next;
  }
  out[i] = static_cast<int32_t>(h);
}

// Per-column host arrays of length ncols (1..kMaxHashCols): data pointers,
// validity pointers (0 = no nulls), widths, signedness, kinds. `out` holds
// n int32 in device memory.
SRT_EXPORT int srt_murmur3_table(const uint64_t* data, const uint64_t* valid,
                                 const int* widths, const int* is_signed,
                                 const int* kinds, int ncols, uint32_t seed,
                                 int32_t* out, int64_t n, void* stream) {
  if (ncols < 1 || ncols > kMaxHashCols) return cudaErrorInvalidValue;
  HashCols cols{};
  for (int c = 0; c < ncols; ++c) {
    cols.col[c].data = reinterpret_cast<const void*>(data[c]);
    cols.col[c].valid = reinterpret_cast<const uint8_t*>(valid[c]);
    cols.col[c].width = widths[c];
    cols.col[c].is_signed = is_signed[c];
    cols.col[c].kind = kinds[c];
  }
  if (n > 0) {
    murmur3_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(cols, ncols, seed,
                                                          out, n);
  }
  return cudaGetLastError();
}
