// Batched sorts for Hopper: kernels K3 and K4a (u64 keys) and K4b (u32 keys).
//
// Replaces three Pallas kernels of
// spark_rapids_jni_tpu/kernels/bitonic_sort.py.
// batched_sort_u64_looped (_kernel_u64_looped, :401), K3, and
// batched_sort_u64 (_kernel, :116), K4a, share one contract (that module
// says so at :418-419): each of C rows of T keys (T a power of two) is
// sorted ascending as unsigned 64-bit integers, stably; the result is the
// sorted key, the int32 within-row permutation (each output's source index)
// and the payloads gathered through it. batched_sort_u32 (_kernel_u32,
// :265), K4b, sorts each row of u32 keys that are distinct within the row
// (the packed groupby's word with its embedded iota) ascending and returns
// the sorted keys and the payloads, with no perm.
//
// Design: a least-significant-digit radix sort over the key's 8-bit digits,
// templated on the key word (8 digits of a u64, 4 of a u32). The digits of
// the raw key bits give the unsigned order by themselves, and each pass is
// a stable scatter, so the passes compose into the stable sort and an index
// that rides them is the permutation.
//   plan     one read of the keys, grid (tiles, C): for every row the bits
//            in which it varies (the OR over the row of key ^ key[row, 0])
//            and, for every digit, each tile's 256 bucket counts (a digit
//            that a sub-tile of 4096 keys does not vary in counts at once);
//   then for each digit d:
//   count    the tile bucket counts of digit d over the current order (the
//            plan's counts serve a row's first pass, which reads key_in);
//   scan     per row and bucket, the exclusive scan of its counts over the
//            tiles, and the bucket's total;
//   scatter  one block a tile of 8192 keys, in two sub-tiles of 4096 staged
//            in shared memory: each warp ranks its 512 keys by digit in
//            index order (ballots group equal digits; one per-warp counter
//            a bucket, no atomics, so the order never depends on timing),
//            ranks are offset by the warps before, the keys are reordered
//            by digit in shared memory and written to row base + bucket
//            base + tile offset + rank, coalesced within a bucket's run.
//            Where an index rides, the first pass makes it from the
//            position.
// A digit in which no key of a row varies is the identity for a stable
// pass, so the row skips it: every launch reads its row's plan and returns
// at once for a digit the row does not need. The plan is per row and stays
// on the device; the launch sequence does not depend on the data. A row of
// equal keys takes one pass (digit 0), which is the identity. Rows take
// different numbers of passes, so each row's passes alternate between the
// scratch pair and the output pair, starting on the one that makes its last
// pass land in the output.
// What rides: K3 and K4a carry a u32 index and write it as the perm. K4b
// keys-only carries nothing: its keys are distinct, stable LSD ranking
// needs only each key's position, and the sorted keys are the whole
// result, so one key buffer and its alternate are all that move. K4b with
// payloads carries the u32 index into the caller's idx buffer.
// Payloads move once, through the final index (gather.cuh).
// Rows of T <= 4096 take one launch instead: one block sorts a row in
// shared memory with a bitonic network, over (key, index) where an index
// rides (its tiebreak makes the network stable), over the keys alone for
// K4b keys-only (equal keys are indistinguishable in the result).
//
// Bound on the H100: bytes. The least traffic of K3 and K4a is one read of
// the key and one write of the key and the perm (20 B a key) plus the
// payloads; the design moves 8 B a key for the plan, 20 B for a row's
// first pass and 32 B for each later one (a count read of the key, then
// the scatter's read and write of key and index). K4b keys-only needs 8 B
// a key and moves 4 B for the plan, 8 B for the first pass and 12 B for
// each later one. An SF100 item key varies in 3 digits (18 bits), the
// packed groupby's u64 words in 4 (8 in its padded last chunk) and their
// low u32 words in all 4. The scatter holds 16 keys a thread in about 120
// registers (u64 keys with an index), two blocks an SM. Tiles of 16384 or
// 32768 keys, three blocks an SM (80 registers, with spills) and loading
// the next sub-tile while one writes were tried on an H100 for the u64
// sort and were no faster.

// Scratch (srt_radix_sort_u64_scratch / _u32_scratch bytes, allocated by
// the caller): a second key buffer, a second index buffer where an index
// rides, the bucket counts (a digit x 256 buckets x T / 8192 tiles x 4 B a
// row: 1 B a key for a u64, 0.5 B for a u32), the bucket totals and the
// row plans. At one row of 2^23 u64 keys it is about 104 MB.

#include "common.cuh"
#include "gather.cuh"

constexpr int kMaxDigits = 8;       // 8-bit digits of the widest key, a u64
constexpr int kBuckets = 256;
constexpr int kSortThreads = 256;   // one thread a bucket in the scans
constexpr int kWarps = kSortThreads / 32;
constexpr int kItems = 16;          // keys a thread holds per sub-tile
constexpr int kSub = kSortThreads * kItems;   // 4096 keys staged at a time
constexpr int kSubsPerTile = 2;
constexpr int kTileKeys = kSub * kSubsPerTile;  // 8192 keys a block
constexpr int kSmallT = 4096;       // rows up to this length: one block
constexpr int kSmallThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kSortThreads == kBuckets, "scans take one bucket a thread");

// Dynamic shared memory of radix_scatter<K, kIdx>: the staged keys (and
// indices), the per-warp bucket counters and three bucket arrays.
template <typename K, bool kIdx>
constexpr size_t scatter_smem() {
  return kSub * (sizeof(K) + (kIdx ? sizeof(uint32_t) : 0)) +
         (kWarps + 3) * kBuckets * sizeof(uint32_t);
}

// ---------------------------------------------------------------------------
// small rows: the whole row in one block
// ---------------------------------------------------------------------------

// true when (ka, ia) sorts after (kb, ib); the keys alone when no index
// rides
template <typename K, bool kIdx>
__device__ __forceinline__ bool after(K ka, uint32_t ia, K kb, uint32_t ib) {
  return ka > kb || (kIdx && ka == kb && ia > ib);
}

// Steps j = j_top .. 1 of stage k of the bitonic network over one row of
// n keys (and their indices) in shared memory.
template <typename K, bool kIdx>
__device__ void tile_steps(K* sk, uint32_t* si, int n, int k, int j_top) {
  for (int j = j_top; j >= 1; j >>= 1) {
    int lj = __ffs(j) - 1;
    __syncthreads();
    for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
      int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
      int q = i + j;
      bool asc = (i & k) == 0;
      K ka = sk[i], kb = sk[q];
      uint32_t ia = kIdx ? si[i] : 0u, ib = kIdx ? si[q] : 0u;
      if (after<K, kIdx>(ka, ia, kb, ib) == asc) {
        sk[i] = kb;
        sk[q] = ka;
        if (kIdx) {
          si[i] = ib;
          si[q] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// One block a row of n <= kSmallT keys: every stage of the network.
template <typename K, bool kIdx>
__global__ void sort_row_small(const K* __restrict__ key_in,
                               K* __restrict__ key_out,
                               uint32_t* __restrict__ idx_out, int n) {
  extern __shared__ uint64_t smem[];
  K* sk = reinterpret_cast<K*>(smem);
  uint32_t* si = reinterpret_cast<uint32_t*>(sk + n);
  int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    sk[e] = key_in[row + e];
    if (kIdx) si[e] = static_cast<uint32_t>(e);
  }
  for (int k = 2; k <= n; k <<= 1) tile_steps<K, kIdx>(sk, si, n, k, k >> 1);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    key_out[row + e] = sk[e];
    if (kIdx) idx_out[row + e] = si[e];
  }
}

// ---------------------------------------------------------------------------
// the digit plan
// ---------------------------------------------------------------------------

template <typename K>
__device__ __forceinline__ unsigned digit_of(K k, int d) {
  return static_cast<unsigned>(k >> (8 * d)) & 0xFFu;
}

// Where digit d's pass stands in a row whose keys vary in the bits of
// `varying`: the row's active digits are those with a varying bit (digit 0
// when none varies); `first` is the row's first pass (it reads key_in),
// `to_out` says whether the pass writes the output pair or the scratch
// pair. A pass other than the first reads the pair it does not write.
struct Pass {
  bool active;
  bool first;
  bool to_out;
};

__device__ __forceinline__ Pass pass_of(uint64_t varying, int d) {
  unsigned m = 0;
  for (int i = 0; i < kMaxDigits; ++i) {
    if (digit_of(varying, i) != 0) m |= 1u << i;
  }
  if (m == 0) m = 1;
  int n = __popc(m);
  int p = __popc(m & ((1u << d) - 1u));
  return {((m >> d) & 1u) != 0, p == 0, ((n - 1 - p) & 1) == 0};
}

// Adds a warp's 32 digits to the shared counters `hist`: one add of 32
// when the warp's digits are equal, else one add a lane.
__device__ __forceinline__ void warp_count(unsigned* hist, unsigned digit,
                                           int lane) {
  unsigned lead = __shfl_sync(kFull, digit, 0);
  if (__all_sync(kFull, digit == lead)) {
    if (lane == 0) atomicAdd(&hist[digit], 32u);
  } else {
    atomicAdd(&hist[digit], 1u);
  }
}

// The lanes of the warp whose digit equals this lane's: eight ballots, one
// a digit bit, in place of __match_any_sync, which ranked slower on an
// H100.
__device__ __forceinline__ unsigned warp_peers(unsigned digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    bool set = (digit >> bit) & 1u;
    unsigned votes = __ballot_sync(kFull, set);
    peers &= set ? votes : ~votes;
  }
  return peers;
}

// Index of the count of (digit d, row, bucket b, tile) in the counts array.
__device__ __forceinline__ int64_t count_at(int d, int64_t c, int64_t row,
                                            int b, int tiles, int tile) {
  return ((d * c + row) * kBuckets + b) * tiles + tile;
}

// grid (tiles, C): one read of the keys. varying[row] (zeroed by the
// caller) gathers the OR of key ^ key[row, 0]; counts gets every digit's
// bucket counts of this tile.
template <typename K>
__global__ void __launch_bounds__(kSortThreads)
radix_plan(const K* __restrict__ key, int64_t c, int64_t t, int tiles,
           unsigned long long* __restrict__ varying,
           unsigned* __restrict__ counts) {
  constexpr int kDigits = static_cast<int>(sizeof(K));  // 8-bit digits
  __shared__ unsigned hist[kDigits][kBuckets];
  __shared__ K warp_or[kWarps];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t row = blockIdx.y;
  int tile = blockIdx.x;
  for (int i = threadIdx.x; i < kDigits * kBuckets; i += kSortThreads) {
    (&hist[0][0])[i] = 0;
  }
  const K* rk = key + row * t;
  K ref = rk[0];
  K var = 0;
  for (int s = 0; s < kSubsPerTile; ++s) {
    int64_t sub = static_cast<int64_t>(tile) * kTileKeys + s * kSub;
    K k[kItems];
    K x = 0;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      k[r] = rk[sub + r * kSortThreads + threadIdx.x];
      x |= k[r] ^ ref;
    }
    // the sub-tile's varying bits: a digit none of its keys varies in
    // counts kSub at the reference key's digit, without a per-key add
    for (int o = 16; o >= 1; o >>= 1) x |= __shfl_xor_sync(kFull, x, o);
    __syncthreads();  // hist zeroed; warp_or free
    if (lane == 0) warp_or[warp] = x;
    __syncthreads();
    x = 0;
    for (int w = 0; w < kWarps; ++w) x |= warp_or[w];
    var |= x;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      if (digit_of(x, d) == 0) {
        if (threadIdx.x == 0) hist[d][digit_of(ref, d)] += kSub;
        continue;
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        warp_count(hist[d], digit_of(k[r], d), lane);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && var != 0) {
    atomicOr(&varying[row], static_cast<unsigned long long>(var));
  }
  int b = threadIdx.x;
  for (int d = 0; d < kDigits; ++d) {
    counts[count_at(d, c, row, b, tiles, tile)] = hist[d][b];
  }
}

// grid (tiles, C): digit d's bucket counts of each tile in the order the
// row's previous pass left, for rows whose pass d is not their first.
template <typename K>
__global__ void __launch_bounds__(kSortThreads)
radix_count(const K* key_out, const K* key_alt, int64_t c, int64_t t,
            int tiles, const unsigned long long* varying, unsigned* counts,
            int d) {
  __shared__ unsigned hist[kBuckets];
  int64_t row = blockIdx.y;
  Pass ps = pass_of(varying[row], d);
  if (!ps.active || ps.first) return;
  int lane = threadIdx.x & 31;
  int tile = blockIdx.x;
  hist[threadIdx.x] = 0;
  __syncthreads();
  const K* rk = (ps.to_out ? key_alt : key_out) + row * t;
  for (int s = 0; s < kSubsPerTile; ++s) {
    int64_t sub = static_cast<int64_t>(tile) * kTileKeys + s * kSub;
    K k[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      k[r] = rk[sub + r * kSortThreads + threadIdx.x];
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) warp_count(hist, digit_of(k[r], d), lane);
  }
  __syncthreads();
  counts[count_at(d, c, row, threadIdx.x, tiles, tile)] = hist[threadIdx.x];
}

// grid (kBuckets / kWarps, C): one warp a (row, bucket) scans the bucket's
// tile counts in place (exclusive) and writes its total.
__global__ void __launch_bounds__(kSortThreads)
radix_scan(int64_t c, int tiles, const unsigned long long* varying,
           unsigned* counts, unsigned* totals, int d) {
  int64_t row = blockIdx.y;
  if (!pass_of(varying[row], d).active) return;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int b = blockIdx.x * kWarps + warp;
  unsigned* col = counts + count_at(d, c, row, b, tiles, 0);
  unsigned carry = 0;
  for (int base = 0; base < tiles; base += 128) {
    unsigned v[4];
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int i = base + lane * 4 + j;
      v[j] = i < tiles ? col[i] : 0u;
      sum += v[j];
    }
    unsigned incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    unsigned run = carry + incl - sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int i = base + lane * 4 + j;
      if (i < tiles) col[i] = run;
      run += v[j];
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[(d * c + row) * kBuckets + b] = carry;
}

// Exclusive scan of one value a thread over the block (blockDim ==
// kSortThreads); every thread must call it. `scratch` holds kWarps values.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + x - v;
}

// grid (tiles, C): the stable scatter of digit d for the rows that need it.
// The output pair is (key_out, perm), the scratch pair (key_alt, idx_alt);
// perm and idx_alt are unused when no index rides.
template <typename K, bool kIdx>
__global__ void __launch_bounds__(kSortThreads, 2)
radix_scatter(const K* __restrict__ key_in, K* key_out, uint32_t* perm,
              K* key_alt, uint32_t* idx_alt, int64_t c, int64_t t, int tiles,
              const unsigned long long* varying, const unsigned* counts,
              const unsigned* totals, int d) {
  extern __shared__ uint64_t smem[];
  K* sk = reinterpret_cast<K*>(smem);                   // kSub keys, by digit
  uint32_t* si = reinterpret_cast<uint32_t*>(sk + kSub);  // their indices
  uint32_t* wcnt = si + (kIdx ? kSub : 0);  // [kWarps][kBuckets] counters
  uint32_t* s_off = wcnt + kWarps * kBuckets;  // bucket's next row position
  uint32_t* s_loc = s_off + kBuckets;    // bucket's first slot in sk
  uint32_t* scan = s_loc + kBuckets;     // kWarps scan partials
  int64_t row = blockIdx.y;
  Pass ps = pass_of(varying[row], d);
  if (!ps.active) return;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tile = blockIdx.x;
  int64_t rbase = row * t;
  const K* src_k =
      (ps.first ? key_in : (ps.to_out ? key_alt : key_out)) + rbase;
  K* dst_k = (ps.to_out ? key_out : key_alt) + rbase;
  const uint32_t* src_i =
      kIdx && !ps.first ? (ps.to_out ? idx_alt : perm) + rbase : nullptr;
  uint32_t* dst_i = kIdx ? (ps.to_out ? perm : idx_alt) + rbase : nullptr;

  int b = threadIdx.x;  // this thread's bucket in the per-bucket steps
  int64_t tot = (d * c + row) * kBuckets;
  unsigned bucket_base = block_exclusive_scan(totals[tot + b], scan);
  s_off[b] = bucket_base + counts[count_at(d, c, row, b, tiles, tile)];
  unsigned lt = (1u << lane) - 1u;

  for (int s = 0; s < kSubsPerTile; ++s) {
    // warp w ranks the sub-tile's keys [w * 512, w * 512 + 512), 32 a round
    int64_t first = static_cast<int64_t>(tile) * kTileKeys + s * kSub +
                    warp * (kItems * 32) + lane;
    K k[kItems];
    unsigned rank[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) k[r] = src_k[first + r * 32];
    for (int i = lane; i < kBuckets; i += 32) wcnt[warp * kBuckets + i] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      unsigned dig = digit_of(k[r], d);
      unsigned peers = warp_peers(dig);
      unsigned lower = __popc(peers & lt);
      unsigned before = wcnt[warp * kBuckets + dig];
      __syncwarp();
      if (lower == 0) wcnt[warp * kBuckets + dig] = before + __popc(peers);
      __syncwarp();
      rank[r] = before + lower;
    }
    __syncthreads();
    // per bucket: the warps' counts become exclusive offsets over warps
    unsigned run = 0;
    for (int w = 0; w < kWarps; ++w) {
      unsigned x = wcnt[w * kBuckets + b];
      wcnt[w * kBuckets + b] = run;
      run += x;
    }
    s_loc[b] = block_exclusive_scan(run, scan);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      unsigned dig = digit_of(k[r], d);
      unsigned pos = s_loc[dig] + wcnt[warp * kBuckets + dig] + rank[r];
      int64_t e = first + r * 32;
      sk[pos] = k[r];
      if (kIdx) {
        si[pos] = src_i != nullptr ? src_i[e] : static_cast<uint32_t>(e);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSub; i += kSortThreads) {
      K key = sk[i];
      unsigned dig = digit_of(key, d);
      unsigned g = s_off[dig] + (static_cast<unsigned>(i) - s_loc[dig]);
      dst_k[g] = key;
      if (kIdx) dst_i[g] = si[i];
    }
    __syncthreads();
    s_off[b] += run;
  }
}

// ---------------------------------------------------------------------------
// the launch sequence and the entry points
// ---------------------------------------------------------------------------

static int64_t align_up(int64_t n) { return (n + 255) / 256 * 256; }

// Byte offsets of the scratch pieces of a (c, t) batch of K keys with
// t > kSmallT, and their total.
template <typename K>
struct Layout {
  int64_t idx_alt, counts, totals, varying, bytes;
  Layout(int64_t c, int64_t t, bool idx) {
    int64_t n = c * t;
    int64_t per_digit = static_cast<int64_t>(sizeof(K)) * c * kBuckets;
    idx_alt = align_up(n * static_cast<int64_t>(sizeof(K)));  // after key_alt
    counts = idx_alt + (idx ? align_up(n * 4) : 0);
    totals = counts + align_up(per_digit * (t / kTileKeys) * 4);
    varying = totals + align_up(per_digit * 4);
    bytes = varying + align_up(c * 8);
  }
};

// 2 <= t <= t_max, t a power of two, 1 <= c <= 65535
static bool bad_shape(int64_t c, int64_t t, int64_t t_max) {
  return t < 2 || (t & (t - 1)) || t > t_max || c < 1 || c > 65535;
}

// Sorts the (c, t) batch key_in into key_out and, when kIdx, writes the
// permutation to perm; `scratch` holds Layout<K>(c, t, kIdx).bytes (unused
// for t <= kSmallT). Returns the first launch error.
template <typename K, bool kIdx>
static int radix_sort(const K* key_in, K* key_out, uint32_t* perm, int64_t c,
                      int64_t t, char* scratch, cudaStream_t st) {
  int rc;
  if (t <= kSmallT) {
    int n = static_cast<int>(t);
    int threads = n / 2 < kSmallThreads ? n / 2 : kSmallThreads;
    size_t smem = static_cast<size_t>(n) *
                  (sizeof(K) + (kIdx ? sizeof(uint32_t) : 0));
    rc = cudaFuncSetAttribute(sort_row_small<K, kIdx>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != 0) return rc;
    sort_row_small<K, kIdx>
        <<<dim3(1, static_cast<unsigned int>(c)), threads, smem, st>>>(
            key_in, key_out, perm, n);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kDigits = static_cast<int>(sizeof(K));  // 8-bit digits
  constexpr size_t kSmem = scatter_smem<K, kIdx>();
  Layout<K> lay(c, t, kIdx);
  int tiles = static_cast<int>(t / kTileKeys);
  K* key_alt = reinterpret_cast<K*>(scratch);
  uint32_t* idx_alt =
      kIdx ? reinterpret_cast<uint32_t*>(scratch + lay.idx_alt) : nullptr;
  unsigned* counts = reinterpret_cast<unsigned*>(scratch + lay.counts);
  unsigned* totals = reinterpret_cast<unsigned*>(scratch + lay.totals);
  unsigned long long* varying =
      reinterpret_cast<unsigned long long*>(scratch + lay.varying);

  rc = cudaFuncSetAttribute(radix_scatter<K, kIdx>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(kSmem));
  if (rc != 0) return rc;
  rc = cudaMemsetAsync(varying, 0, static_cast<size_t>(c) * 8, st);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(c));
  dim3 scan_grid(kBuckets / kWarps, static_cast<unsigned int>(c));
  radix_plan<K><<<grid, kSortThreads, 0, st>>>(key_in, c, t, tiles, varying,
                                               counts);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  for (int d = 0; d < kDigits; ++d) {
    radix_count<K><<<grid, kSortThreads, 0, st>>>(key_out, key_alt, c, t,
                                                  tiles, varying, counts, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    radix_scan<<<scan_grid, kSortThreads, 0, st>>>(c, tiles, varying, counts,
                                                   totals, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    radix_scatter<K, kIdx><<<grid, kSortThreads, kSmem, st>>>(
        key_in, key_out, perm, key_alt, idx_alt, c, t, tiles, varying, counts,
        totals, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  return 0;
}

// Bytes of scratch srt_radix_sort_u64 needs for a (c, t) batch (0 when a
// row fits one block); -1 for a shape it does not take.
SRT_EXPORT int64_t srt_radix_sort_u64_scratch(int64_t c, int64_t t) {
  if (bad_shape(c, t, int64_t{1} << 30)) return -1;
  return t <= kSmallT ? 0 : Layout<uint64_t>(c, t, true).bytes;
}

// key_in/key_out: C*T u64, perm: C*T u32 (the int32 perm), all device
// memory; scratch: scratch_bytes of device memory, at least
// srt_radix_sort_u64_scratch(c, t); psrc/pdst/pwidth: host arrays of npay
// payload pointers (C*T values of pwidth bytes each). T is a power of two,
// 2 <= T <= 2^30, and 1 <= C <= 65535. Launches on `stream`, never
// synchronises, allocates nothing.
SRT_EXPORT int srt_radix_sort_u64(const uint64_t* key_in, uint64_t* key_out,
                                  uint32_t* perm, int64_t c, int64_t t,
                                  void* scratch, int64_t scratch_bytes,
                                  const uint64_t* psrc, const uint64_t* pdst,
                                  const int* pwidth, int npay, void* stream) {
  int64_t need = srt_radix_sort_u64_scratch(c, t);
  if (need < 0 || npay < 0 || scratch_bytes < need ||
      (need > 0 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = radix_sort<uint64_t, true>(key_in, key_out, perm, c, t,
                                      static_cast<char*>(scratch), st);
  if (rc != 0) return rc;
  return launch_gather(perm, c, t, psrc, pdst, pwidth, npay, st);
}

// Bytes of scratch srt_radix_sort_u32 needs for a (c, t) batch with npay
// payloads (0 when a row fits one block); -1 for a shape it does not take.
SRT_EXPORT int64_t srt_radix_sort_u32_scratch(int64_t c, int64_t t,
                                              int npay) {
  if (bad_shape(c, t, int64_t{1} << 31) || npay < 0) return -1;
  return t <= kSmallT ? 0 : Layout<uint32_t>(c, t, npay > 0).bytes;
}

// key_in/key_out: C*T u32 keys, distinct within each row; idx: C*T u32 for
// the riding index, needed (not null) only when npay > 0; scratch:
// scratch_bytes of device memory, at least srt_radix_sort_u32_scratch(c, t,
// npay); psrc/pdst/pwidth: host arrays of npay payload pointers (C*T values
// of pwidth bytes each). T is a power of two, 2 <= T <= 2^31, and
// 1 <= C <= 65535. Launches on `stream`, never synchronises, allocates
// nothing.
SRT_EXPORT int srt_radix_sort_u32(const uint32_t* key_in, uint32_t* key_out,
                                  uint32_t* idx, int64_t c, int64_t t,
                                  void* scratch, int64_t scratch_bytes,
                                  const uint64_t* psrc, const uint64_t* pdst,
                                  const int* pwidth, int npay, void* stream) {
  int64_t need = srt_radix_sort_u32_scratch(c, t, npay);
  if (need < 0 || scratch_bytes < need || (need > 0 && scratch == nullptr) ||
      (npay > 0 && idx == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(scratch);
  if (npay == 0) {
    return radix_sort<uint32_t, false>(key_in, key_out, nullptr, c, t, s, st);
  }
  int rc = radix_sort<uint32_t, true>(key_in, key_out, idx, c, t, s, st);
  if (rc != 0) return rc;
  return launch_gather(idx, c, t, psrc, pdst, pwidth, npay, st);
}
