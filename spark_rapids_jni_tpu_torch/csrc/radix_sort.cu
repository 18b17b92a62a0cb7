// Batched stable sort of u64 keys for Hopper: kernels K3 and K4a.
//
// Replaces two Pallas kernels of spark_rapids_jni_tpu/kernels/bitonic_sort.py
// that share one contract (that module says so at :418-419):
// batched_sort_u64_looped (_kernel_u64_looped, :401), K3, and
// batched_sort_u64 (_kernel, :116), K4a. Each of C rows of T keys (T a power
// of two) is sorted ascending as unsigned 64-bit integers, stably; the
// result is the sorted key, the int32 within-row permutation (each output's
// source index) and the payloads gathered through it.
//
// Design: a least-significant-digit radix sort over eight 8-bit digits. The
// digits of the raw key bits give the unsigned order by themselves, and each
// pass is a stable scatter, so the passes compose into the stable sort and
// the index that rides them is the permutation.
//   plan     one read of the keys, grid (tiles, C): for every row the bits
//            in which it varies (the OR over the row of key ^ key[row, 0])
//            and, for every digit, each tile's 256 bucket counts (a digit
//            that a sub-tile of 4096 keys does not vary in counts at once);
//   then for each digit d = 0..7:
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
//            The first pass makes the index from the position.
// A digit in which no key of a row varies is the identity for a stable
// pass, so the row skips it: every launch reads its row's plan and returns
// at once for a digit the row does not need. The plan is per row and stays
// on the device; the launch sequence does not depend on the data. A row of
// equal keys takes one pass (digit 0), which is the identity. Rows take
// different numbers of passes, so each row's passes alternate between the
// scratch pair and (key_out, perm), starting on the one that makes its last
// pass land in (key_out, perm).
// Payloads move once, through the final permutation (gather.cuh).
// Rows of T <= 4096 take one launch instead: one block sorts a row in
// shared memory with a bitonic network over (key, index), whose index
// tiebreak makes the network stable.
//
// Bound on the H100: bytes. The least traffic is one read of the key and
// one write of the key and the perm (20 B a key) plus the payloads. The
// design moves 8 B a key for the plan, 20 B for a row's first pass and
// 32 B for each later one (a count read of the key, then the scatter's
// read and write of key and index). An SF100 item key varies in 3 digits
// (18 bits), the packed groupby's words in 4 (8 in its padded last
// chunk), where the bitonic network it replaces made 78 and 21 passes of
// 12 B each way. The scatter holds 16 keys a thread in about 120
// registers, two blocks an SM. Tiles of 16384 or 32768 keys, three blocks
// an SM (80 registers, with spills) and loading the next sub-tile while one
// writes were tried on an H100 and were no faster.

// Scratch (srt_radix_sort_u64_scratch bytes, allocated by the caller):
// a second (key, index) buffer of 12 B a key, the bucket counts (8 digits x
// 256 buckets x T / 8192 tiles x 4 B a row, 1 B a key), the bucket totals
// and the row plans. At one row of 2^23 keys it is about 104 MB.

#include "common.cuh"
#include "gather.cuh"

constexpr int kDigits = 8;          // 8-bit digits of a 64-bit key
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

// Dynamic shared memory of radix_scatter: the staged keys and indices, the
// per-warp bucket counters and three bucket arrays.
constexpr size_t kScatterSmem =
    kSub * (sizeof(uint64_t) + sizeof(uint32_t)) +
    (kWarps + 3) * kBuckets * sizeof(uint32_t);

// ---------------------------------------------------------------------------
// small rows: the whole row in one block
// ---------------------------------------------------------------------------

// true when (ka, ia) sorts after (kb, ib)
__device__ __forceinline__ bool after(uint64_t ka, uint32_t ia, uint64_t kb,
                                      uint32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// Steps j = j_top .. 1 of stage k of the bitonic network over one row of
// n keys in shared memory.
__device__ void tile_steps(uint64_t* sk, uint32_t* si, int n, int k,
                           int j_top) {
  for (int j = j_top; j >= 1; j >>= 1) {
    int lj = __ffs(j) - 1;
    __syncthreads();
    for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
      int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
      int q = i + j;
      bool asc = (i & k) == 0;
      uint64_t ka = sk[i], kb = sk[q];
      uint32_t ia = si[i], ib = si[q];
      if (after(ka, ia, kb, ib) == asc) {
        sk[i] = kb;
        sk[q] = ka;
        si[i] = ib;
        si[q] = ia;
      }
    }
  }
  __syncthreads();
}

// One block a row of n <= kSmallT keys: every stage of the network.
__global__ void sort_row_small(const uint64_t* __restrict__ key_in,
                               uint64_t* __restrict__ key_out,
                               uint32_t* __restrict__ idx_out, int n) {
  extern __shared__ uint64_t smem[];
  uint64_t* sk = smem;
  uint32_t* si = reinterpret_cast<uint32_t*>(smem + n);
  int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    sk[e] = key_in[row + e];
    si[e] = static_cast<uint32_t>(e);
  }
  for (int k = 2; k <= n; k <<= 1) tile_steps(sk, si, n, k, k >> 1);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    key_out[row + e] = sk[e];
    idx_out[row + e] = si[e];
  }
}

// ---------------------------------------------------------------------------
// the digit plan
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned digit_of(uint64_t k, int d) {
  return static_cast<unsigned>(k >> (8 * d)) & 0xFFu;
}

// Where digit d's pass stands in a row whose keys vary in the bits of
// `varying`: the row's active digits are those with a varying bit (digit 0
// when none varies); `first` is the row's first pass (it reads key_in),
// `to_out` says whether the pass writes (key_out, perm) or the scratch pair.
// A pass other than the first reads the pair it does not write.
struct Pass {
  bool active;
  bool first;
  bool to_out;
};

__device__ __forceinline__ Pass pass_of(uint64_t varying, int d) {
  unsigned m = 0;
  for (int i = 0; i < kDigits; ++i) {
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
__global__ void __launch_bounds__(kSortThreads)
radix_plan(const uint64_t* __restrict__ key, int64_t c, int64_t t, int tiles,
           unsigned long long* __restrict__ varying,
           unsigned* __restrict__ counts) {
  __shared__ unsigned hist[kDigits][kBuckets];
  __shared__ unsigned long long warp_or[kWarps];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t row = blockIdx.y;
  int tile = blockIdx.x;
  for (int i = threadIdx.x; i < kDigits * kBuckets; i += kSortThreads) {
    (&hist[0][0])[i] = 0;
  }
  const uint64_t* rk = key + row * t;
  uint64_t ref = rk[0];
  uint64_t var = 0;
  for (int s = 0; s < kSubsPerTile; ++s) {
    int64_t sub = static_cast<int64_t>(tile) * kTileKeys + s * kSub;
    uint64_t k[kItems];
    uint64_t x = 0;
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
  if (threadIdx.x == 0 && var != 0) atomicOr(&varying[row], var);
  int b = threadIdx.x;
  for (int d = 0; d < kDigits; ++d) {
    counts[count_at(d, c, row, b, tiles, tile)] = hist[d][b];
  }
}

// grid (tiles, C): digit d's bucket counts of each tile in the order the
// row's previous pass left, for rows whose pass d is not their first.
__global__ void __launch_bounds__(kSortThreads)
radix_count(const uint64_t* key_out, const uint64_t* key_alt, int64_t c,
            int64_t t, int tiles, const unsigned long long* varying,
            unsigned* counts, int d) {
  __shared__ unsigned hist[kBuckets];
  int64_t row = blockIdx.y;
  Pass ps = pass_of(varying[row], d);
  if (!ps.active || ps.first) return;
  int lane = threadIdx.x & 31;
  int tile = blockIdx.x;
  hist[threadIdx.x] = 0;
  __syncthreads();
  const uint64_t* rk = (ps.to_out ? key_alt : key_out) + row * t;
  for (int s = 0; s < kSubsPerTile; ++s) {
    int64_t sub = static_cast<int64_t>(tile) * kTileKeys + s * kSub;
    uint64_t k[kItems];
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
__global__ void __launch_bounds__(kSortThreads, 2)
radix_scatter(const uint64_t* __restrict__ key_in, uint64_t* key_out,
              uint32_t* perm, uint64_t* key_alt, uint32_t* idx_alt, int64_t c,
              int64_t t, int tiles, const unsigned long long* varying,
              const unsigned* counts, const unsigned* totals, int d) {
  extern __shared__ uint64_t smem[];
  uint64_t* sk = smem;                                   // kSub keys, by digit
  uint32_t* si = reinterpret_cast<uint32_t*>(sk + kSub);  // their indices
  uint32_t* wcnt = si + kSub;            // [kWarps][kBuckets] warp counters
  uint32_t* s_off = wcnt + kWarps * kBuckets;  // bucket's next row position
  uint32_t* s_loc = s_off + kBuckets;    // bucket's first slot in sk
  uint32_t* scan = s_loc + kBuckets;     // kWarps scan partials
  int64_t row = blockIdx.y;
  Pass ps = pass_of(varying[row], d);
  if (!ps.active) return;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tile = blockIdx.x;
  int64_t rbase = row * t;
  const uint64_t* src_k =
      (ps.first ? key_in : (ps.to_out ? key_alt : key_out)) + rbase;
  const uint32_t* src_i =
      ps.first ? nullptr : (ps.to_out ? idx_alt : perm) + rbase;
  uint64_t* dst_k = (ps.to_out ? key_out : key_alt) + rbase;
  uint32_t* dst_i = (ps.to_out ? perm : idx_alt) + rbase;

  int b = threadIdx.x;  // this thread's bucket in the per-bucket steps
  int64_t tot = (d * c + row) * kBuckets;
  unsigned bucket_base = block_exclusive_scan(totals[tot + b], scan);
  s_off[b] = bucket_base + counts[count_at(d, c, row, b, tiles, tile)];
  unsigned lt = (1u << lane) - 1u;

  for (int s = 0; s < kSubsPerTile; ++s) {
    // warp w ranks the sub-tile's keys [w * 512, w * 512 + 512), 32 a round
    int64_t first = static_cast<int64_t>(tile) * kTileKeys + s * kSub +
                    warp * (kItems * 32) + lane;
    uint64_t k[kItems];
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
      si[pos] = src_i != nullptr ? src_i[e] : static_cast<uint32_t>(e);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSub; i += kSortThreads) {
      uint64_t key = sk[i];
      unsigned dig = digit_of(key, d);
      unsigned g = s_off[dig] + (static_cast<unsigned>(i) - s_loc[dig]);
      dst_k[g] = key;
      dst_i[g] = si[i];
    }
    __syncthreads();
    s_off[b] += run;
  }
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static int64_t align_up(int64_t n) { return (n + 255) / 256 * 256; }

static bool bad_shape(int64_t c, int64_t t) {
  return t < 2 || (t & (t - 1)) || t > (int64_t{1} << 30) || c < 1 ||
         c > 65535;
}

// Bytes of scratch srt_radix_sort_u64 needs for a (c, t) batch (0 when a
// row fits one block); -1 for a shape it does not take.
SRT_EXPORT int64_t srt_radix_sort_u64_scratch(int64_t c, int64_t t) {
  if (bad_shape(c, t)) return -1;
  if (t <= kSmallT) return 0;
  int64_t n = c * t;
  int64_t tiles = t / kTileKeys;
  return align_up(n * 8) + align_up(n * 4) +
         align_up(kDigits * c * kBuckets * tiles * 4) +
         align_up(kDigits * c * kBuckets * 4) + align_up(c * 8);
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
  int rc;
  if (t <= kSmallT) {
    int n = static_cast<int>(t);
    int threads = n / 2 < kSmallThreads ? n / 2 : kSmallThreads;
    size_t smem = static_cast<size_t>(n) * (sizeof(uint64_t) + sizeof(uint32_t));
    rc = cudaFuncSetAttribute(sort_row_small,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != 0) return rc;
    sort_row_small<<<dim3(1, static_cast<unsigned int>(c)), threads, smem, st>>>(
        key_in, key_out, perm, n);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    return launch_gather(perm, c, t, psrc, pdst, pwidth, npay, st);
  }
  int tiles = static_cast<int>(t / kTileKeys);
  int64_t n = c * t;
  char* p = static_cast<char*>(scratch);
  uint64_t* key_alt = reinterpret_cast<uint64_t*>(p);
  p += align_up(n * 8);
  uint32_t* idx_alt = reinterpret_cast<uint32_t*>(p);
  p += align_up(n * 4);
  unsigned* counts = reinterpret_cast<unsigned*>(p);
  p += align_up(kDigits * c * kBuckets * tiles * 4);
  unsigned* totals = reinterpret_cast<unsigned*>(p);
  p += align_up(kDigits * c * kBuckets * 4);
  unsigned long long* varying = reinterpret_cast<unsigned long long*>(p);

  rc = cudaFuncSetAttribute(radix_scatter,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(kScatterSmem));
  if (rc != 0) return rc;
  rc = cudaMemsetAsync(varying, 0, static_cast<size_t>(c) * 8, st);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(c));
  dim3 scan_grid(kBuckets / kWarps, static_cast<unsigned int>(c));
  radix_plan<<<grid, kSortThreads, 0, st>>>(key_in, c, t, tiles, varying,
                                            counts);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  for (int d = 0; d < kDigits; ++d) {
    radix_count<<<grid, kSortThreads, 0, st>>>(key_out, key_alt, c, t, tiles,
                                               varying, counts, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    radix_scan<<<scan_grid, kSortThreads, 0, st>>>(c, tiles, varying, counts,
                                                   totals, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
    radix_scatter<<<grid, kSortThreads, kScatterSmem, st>>>(
        key_in, key_out, perm, key_alt, idx_alt, c, t, tiles, varying, counts,
        totals, d);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  return launch_gather(perm, c, t, psrc, pdst, pwidth, npay, st);
}
