// Open-addressing hash table for Hopper: kernels K2a (build) and K2b (probe).
//
// Replaces the Pallas kernels of spark_rapids_jni_tpu/kernels/hash_table.py:
// build_table (_build_kernel) and probe_table (_probe_kernel). Keys are u64
// order words split into (lo, hi) u32 halves; rows come as C chunks of T,
// and chunk c owns slots [c*S, (c+1)*S) of a table of S (a power of two)
// slots per chunk. The first slot of a key is hash_word(lo, hi) & (S-1)
// (fmix32 of lo ^ hi*0x9E3779B9, hash_table.py:51-64), then linear probing.
//
// The build must place every key exactly where the JAX rounds do
// (hash_table.py:85-110), because the slot, the stored row id, `overflow`
// and `dup` are compared byte for byte. In each round every live row
// proposes its current slot; the slot counts as empty if it was empty at
// the START of the round; the lowest row id among the proposers wins and
// writes its key; then every live row re-reads its slot and stops on a
// key match (counting `dup` when the slot belongs to another row), else
// moves one slot on. Rows still live after max_probes rounds are the
// `overflow`. A first-come atomicCAS insert would let a later row id win a
// slot and change both the placement and the stored row id.
//
// So each round is three phases, each seeing all of the one before:
//   claim  - every live row whose slot is empty does atomicMin of
//            kClaim | row id on the slot's row word; an empty slot holds
//            kEmpty (all ones, the table's -1) and a claimed one keeps the
//            kClaim bit, so the slot still reads as empty to every row of
//            the round and the lowest row id wins. Lanes of a warp that
//            claim the same slot send one atomic, their lowest row's (the
//            same slot means the same claim): a skewed chunk's thousands of
//            rows of one key would otherwise serialise on one address;
//   commit - the row whose claim survived writes lo, hi and its row id,
//            which clears the kClaim bit (every claimed slot has a winner
//            in its round, so no claim outlives the round and no claim
//            buffer is needed);
//   check  - every live row compares its slot with its key.
// A round's check and the next round's claim share one phase: a claim
// leaves its slot reading as empty, so a check that meets it moves on as
// it would from the empty slot, and both read the table the commit left.
// So a round costs two barriers, and the loop leaves as soon as no row is
// live.
//
// Two regimes, both one launch a build:
//   build_chunk (a chunk's table fits in shared memory: T <= 4096 and
//            12 B x S within the block's shared memory, so S <= 16384 on
//            an H100's 227 KB): one block a chunk holds the table in shared
//            memory and 8 rows a thread (key, slot, live bit) in registers,
//            runs every round with block barriers (the second is
//            __syncthreads_or of the live bits, which ends the loop), sums
//            dup and overflow in the block, adds each with one atomic and
//            writes slot and its chunk's table out once. The groupby's
//            chunks (T = 4096, S = 8192: 96 KB) run two blocks an SM.
//   build_grid (any other shape, e.g. the join build's 2^19-slot table):
//            one cooperative launch (cudaLaunchCooperativeKernel, at most
//            one block an SM, so every block is resident) whose blocks
//            stride over the slots and the rows; cooperative groups' grid
//            barrier (it builds without -rdc) separates the phases, each
//            row's probe slot and live flag stay in its slot output word,
//            the table's shared words are read past L1 (__ldcg), and a
//            device-side count of live rows ends the loop.
//
// Bound on the H100: the work is random 4-byte and 8-byte accesses into
// tables that, at the slices' sizes (2^19 slots for a 204k-row join build,
// 8192 slots per groupby chunk), fit in the 50 MB L2 or in shared memory;
// the byte floor counts each input read once and each output written once.
// What the design pays above it is two barriers a round for as many
// rounds as the longest probe: block barriers in build_chunk, grid
// barriers (an atomic a block, then a spin) in build_grid.
//
// The probe is read-only: each query walks at most max_probes slots and
// stops on a key match or on an empty slot, which proves the key absent.
// Its bound on the H100 is the HBM stream of query keys, valid flags and
// results (20 B a query) plus one read of the table; the table (12 B a
// slot, 6 MB at the join's 2^19 slots) fits the 50 MB L2, so what keeps
// a probe above the bound is the latency of its steps into L2. probe_slots
// loads a step's three words (row, lo, hi) together, one round trip a
// step; reads the query stream and writes the results evict-first (ld/st
// .cs), so the stream does not push the table out of L2; and takes its
// chunk from blockIdx.y, with no division.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // row word of an empty slot (-1)
constexpr uint32_t kClaim = 0x80000000u;  // row word of a claim: kClaim | row
constexpr uint32_t kLive = 0x80000000u;   // build_grid's live row: kLive | slot
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunkThreads = 512;   // build_chunk: rows in registers,
constexpr int kChunkRows = 8;        // 8 a thread
constexpr int kChunkMaxT = kChunkThreads * kChunkRows;
constexpr int kGridThreads = 1024;   // build_grid: one block an SM

__device__ __forceinline__ uint32_t hash_word(uint32_t lo, uint32_t hi) {
  uint32_t h = lo ^ (hi * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Sums a and b over the block and adds each sum to its counter with one
// atomic a block (none for a zero sum); every thread must call it. acc is
// two shared ints, zero on entry and zero again on return.
__device__ void block_add(int a, int b, int* acc, int* ga, int* gb) {
  a = __reduce_add_sync(kFull, a);
  b = __reduce_add_sync(kFull, b);
  if ((threadIdx.x & 31) == 0) {
    if (a != 0) atomicAdd(&acc[0], a);
    if (b != 0) atomicAdd(&acc[1], b);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (acc[0] != 0) atomicAdd(ga, acc[0]);
    if (acc[1] != 0) atomicAdd(gb, acc[1]);
    acc[0] = 0;
    acc[1] = 0;
  }
  __syncthreads();
}

// One claim of a warp's lanes: `want` is the slot a lane claims (`none`
// for a lane that claims nothing), `tag` its kClaim | row id. Lanes that
// claim the same slot send one atomicMin, the lowest lane's (the lowest
// row of the group, as rows rise with the lane).
template <typename F>
__device__ __forceinline__ void warp_claim(uint32_t* words, F want, F none,
                                           uint32_t tag) {
  if (!__any_sync(kFull, want != none)) return;
  unsigned peers = __match_any_sync(kFull, want);
  if (want != none && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicMin(&words[want], tag);
  }
}

// build_chunk's claim phase over a thread's rows (row r is
// r * blockDim.x + threadIdx.x): each live row whose slot is empty.
__device__ __forceinline__ void claim_chunk_rows(
    uint32_t* srow, const uint32_t (&ps)[kChunkRows], unsigned live) {
#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    uint32_t row = r * blockDim.x + threadIdx.x;
    bool claims = ((live >> r) & 1u) && (srow[ps[r]] & kClaim);
    warp_claim(srow, claims ? ps[r] : kEmpty, kEmpty, kClaim | row);
  }
}

// grid (C): one block a chunk, every round in shared memory.
// counters[0] gets the overflow, counters[1] the dup.
__global__ void __launch_bounds__(kChunkThreads, 2)
build_chunk(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
            const int32_t* __restrict__ valid, int32_t* __restrict__ out_slot,
            uint32_t* __restrict__ tlo, uint32_t* __restrict__ thi,
            uint32_t* __restrict__ trow, int t, int s, int max_probes,
            int* counters) {
  extern __shared__ uint32_t table[];
  uint32_t* slo = table;
  uint32_t* shi = table + s;
  uint32_t* srow = table + 2 * s;
  __shared__ int acc[2];
  int64_t rbase = static_cast<int64_t>(blockIdx.x) * t;
  int64_t fbase = static_cast<int64_t>(blockIdx.x) * s;
  uint32_t smask = static_cast<uint32_t>(s - 1);
  for (int f = threadIdx.x; f < s; f += blockDim.x) {
    slo[f] = 0;
    shi[f] = 0;
    srow[f] = kEmpty;
  }
  if (threadIdx.x == 0) {
    acc[0] = 0;
    acc[1] = 0;
  }
  uint32_t klo[kChunkRows], khi[kChunkRows], ps[kChunkRows];
  unsigned live = 0, placed = 0;  // a bit a row
#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    int row = r * blockDim.x + threadIdx.x;
    klo[r] = khi[r] = ps[r] = 0;
    if (row < t && valid[rbase + row] != 0) {
      klo[r] = lo[rbase + row];
      khi[r] = hi[rbase + row];
      ps[r] = hash_word(klo[r], khi[r]) & smask;
      live |= 1u << r;
    }
  }
  int dup = 0;
  __syncthreads();  // the table is empty
  if (max_probes > 0) claim_chunk_rows(srow, ps, live);
  bool any = __syncthreads_or(live != 0);
  for (int round = 0; any && round < max_probes; ++round) {
    // commit: the row whose claim survived takes the slot
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      uint32_t row = r * blockDim.x + threadIdx.x;
      if (((live >> r) & 1u) && srow[ps[r]] == (kClaim | row)) {
        slo[ps[r]] = klo[r];
        shi[ps[r]] = khi[r];
        srow[ps[r]] = row;
      }
    }
    __syncthreads();
    // check, then the next round's claim in the same phase: a claim keeps
    // its slot reading as empty, so a check that meets it moves on as it
    // would from the empty slot
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      if (!((live >> r) & 1u)) continue;
      uint32_t row = r * blockDim.x + threadIdx.x;
      uint32_t own = srow[ps[r]];
      if (!(own & kClaim) && slo[ps[r]] == klo[r] && shi[ps[r]] == khi[r]) {
        live &= ~(1u << r);
        placed |= 1u << r;
        dup += own != row;
      } else {
        ps[r] = (ps[r] + 1) & smask;
      }
    }
    if (round + 1 < max_probes) claim_chunk_rows(srow, ps, live);
    any = __syncthreads_or(live != 0);
  }
  block_add(__popc(live), dup, acc, &counters[0], &counters[1]);
#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    int row = r * blockDim.x + threadIdx.x;
    if (row < t) {
      out_slot[rbase + row] =
          (placed >> r) & 1u ? static_cast<int32_t>(ps[r]) : -1;
    }
  }
  for (int f = threadIdx.x; f < s; f += blockDim.x) {
    tlo[fbase + f] = slo[f];
    thi[fbase + f] = shi[f];
    trow[fbase + f] = srow[f];
  }
}

// build_grid keeps each row's state in its out_slot word: kLive | probe
// slot while the row is live (slots are below 2^30, as C * S < 2^31), the
// slot once it is placed, -1 for a null or overflowing row.
__device__ __forceinline__ bool is_live(int32_t w) {
  return (static_cast<uint32_t>(w) & 0xC0000000u) == kLive;
}

// build_grid's claim phase: the loop is uniform over the block, so a
// warp's lanes claim together.
__device__ void claim_grid_rows(const int32_t* state, uint32_t* trow,
                                int64_t n, int t, int s, int64_t block0,
                                int64_t stride) {
  const unsigned long long kNone = ~0ull;
  for (int64_t i0 = block0; i0 < n; i0 += stride) {
    int64_t i = i0 + threadIdx.x;
    unsigned long long want = kNone;
    uint32_t row = 0;
    int32_t w = i < n ? state[i] : -1;
    if (is_live(w)) {
      int64_t chunk = i / t;
      row = static_cast<uint32_t>(i - chunk * t);
      int64_t f = chunk * s + (static_cast<uint32_t>(w) & ~kLive);
      if (__ldcg(&trow[f]) & kClaim) {
        want = static_cast<unsigned long long>(f);
      }
    }
    warp_claim(trow, want, kNone, kClaim | row);
  }
}

// One cooperative launch of at most one block an SM: the blocks stride over
// the table's slots and the rows, and grid barriers separate the phases,
// two a round as in build_chunk. counters[0] counts the live rows (the
// overflow at the end), counters[1] the dup; both start at 0.
__global__ void __launch_bounds__(kGridThreads)
build_grid(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
           const int32_t* __restrict__ valid, int32_t* __restrict__ state,
           uint32_t* tlo, uint32_t* thi, uint32_t* trow, int64_t c, int t,
           int s, int max_probes, int* counters) {
  __shared__ int acc[2];
  int64_t n = c * t, ns = c * s;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t block0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  uint32_t smask = static_cast<uint32_t>(s - 1);
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    acc[0] = 0;
    acc[1] = 0;
  }
  for (int64_t f = block0 + threadIdx.x; f < ns; f += stride) {
    tlo[f] = 0;
    thi[f] = 0;
    trow[f] = kEmpty;
  }
  int nlive = 0;
  for (int64_t i = block0 + threadIdx.x; i < n; i += stride) {
    bool v = valid[i] != 0;
    uint32_t home = hash_word(lo[i], hi[i]) & smask;
    state[i] = v ? static_cast<int32_t>(kLive | home) : -1;
    nlive += v;
  }
  __syncthreads();  // acc zeroed
  block_add(nlive, 0, acc, &counters[0], &counters[1]);
  grid.sync();
  if (max_probes > 0) claim_grid_rows(state, trow, n, t, s, block0, stride);
  grid.sync();
  for (int round = 0; round < max_probes; ++round) {
    // counters[0] changes only in a check phase, between two barriers:
    // every block reads the same count
    if (*reinterpret_cast<volatile int*>(counters) == 0) break;
    for (int64_t i = block0 + threadIdx.x; i < n; i += stride) {
      int32_t w = state[i];
      if (!is_live(w)) continue;
      int64_t chunk = i / t;
      uint32_t row = static_cast<uint32_t>(i - chunk * t);
      int64_t f = chunk * s + (static_cast<uint32_t>(w) & ~kLive);
      if (__ldcg(&trow[f]) == (kClaim | row)) {
        tlo[f] = lo[i];
        thi[f] = hi[i];
        trow[f] = row;
      }
    }
    grid.sync();
    int placed = 0, dup = 0;
    for (int64_t i = block0 + threadIdx.x; i < n; i += stride) {
      int32_t w = state[i];
      if (!is_live(w)) continue;
      int64_t chunk = i / t;
      uint32_t row = static_cast<uint32_t>(i - chunk * t);
      uint32_t p = static_cast<uint32_t>(w) & ~kLive;
      int64_t f = chunk * s + p;
      uint32_t own = __ldcg(&trow[f]);
      if (!(own & kClaim) && __ldcg(&tlo[f]) == lo[i] &&
          __ldcg(&thi[f]) == hi[i]) {
        state[i] = static_cast<int32_t>(p);
        ++placed;
        dup += own != row;
      } else {
        state[i] = static_cast<int32_t>(kLive | ((p + 1) & smask));
      }
    }
    if (round + 1 < max_probes) {
      claim_grid_rows(state, trow, n, t, s, block0, stride);
    }
    block_add(-placed, dup, acc, &counters[0], &counters[1]);
    grid.sync();
  }
  for (int64_t i = block0 + threadIdx.x; i < n; i += stride) {
    if (is_live(state[i])) state[i] = -1;  // overflow
  }
}

constexpr int kProbeThreads = 256;
constexpr int64_t kGridYMax = 65535;  // the launch grid's y limit

// grid (ceil(T / threads), min(C, kGridYMax)): thread x of a block takes
// query row x of chunk blockIdx.y and of every gridDim.y-th chunk after it.
__global__ void __launch_bounds__(kProbeThreads)
probe_slots(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
            const int32_t* __restrict__ valid, const int32_t* __restrict__ tlo,
            const int32_t* __restrict__ thi, const int32_t* __restrict__ trow,
            int32_t* __restrict__ found, int32_t* __restrict__ row,
            int* __restrict__ unresolved, int64_t c, int t, int s,
            int max_probes) {
  int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= t) return;
  uint32_t smask = static_cast<uint32_t>(s - 1);
  int unres = 0;
  for (int64_t chunk = blockIdx.y; chunk < c; chunk += gridDim.y) {
    int64_t i = chunk * t + j;
    int64_t base = chunk * s;
    bool live = __ldcs(&valid[i]) != 0;
    int32_t klo = __ldcs(&lo[i]), khi = __ldcs(&hi[i]);
    uint32_t p = hash_word(static_cast<uint32_t>(klo),
                           static_cast<uint32_t>(khi)) & smask;
    int32_t hit = 0, got = -1;
    for (int step = 0; live && step < max_probes; ++step) {
      int64_t f = base + p;
      int32_t own = __ldg(&trow[f]);  // the three loads in flight together
      int32_t slo = __ldg(&tlo[f]), shi = __ldg(&thi[f]);
      if (own < 0) {  // an empty slot proves the key absent
        live = false;
      } else if (slo == klo && shi == khi) {
        hit = 1;
        got = own;
        live = false;
      } else {
        p = (p + 1) & smask;
      }
    }
    unres += live;
    __stcs(&found[i], hit);
    __stcs(&row[i], got);
  }
  if (unres != 0) atomicAdd(unresolved, unres);
}

// Whether a (t, s) build takes build_chunk on the current device (a
// chunk's table, 12 B a slot beside the kernel's static share, fits the
// shared memory a block may use, and its t rows fit the block's registers)
// or build_grid; sets *smem to build_chunk's dynamic shared memory.
static int chunk_fits(int t, int s, bool* fits, size_t* smem) {
  int dev, smem_max, rc;
  cudaFuncAttributes fa;
  if ((rc = cudaGetDevice(&dev)) != 0 ||
      (rc = cudaDeviceGetAttribute(
           &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != 0 ||
      (rc = cudaFuncGetAttributes(&fa, build_chunk)) != 0) {
    return rc;
  }
  *smem = sizeof(uint32_t) * 3 * static_cast<size_t>(s);
  *fits = t <= kChunkMaxT &&
          *smem + fa.sharedSizeBytes <= static_cast<size_t>(smem_max);
  return 0;
}

// 1 when a (t, s) build runs build_chunk on the current device, 0 when it
// runs build_grid, a negative CUDA error when the device cannot be asked.
SRT_EXPORT int srt_build_table_regime(int t, int s) {
  bool fits;
  size_t smem;
  int rc = chunk_fits(t, s, &fits, &smem);
  return rc != 0 ? -rc : fits ? 1 : 0;
}

// All buffers are device memory the caller allocated: lo/hi/valid/slot
// hold C*T entries, tlo/thi/trow C*S, counters 2 ints (overflow, dup),
// which this zeroes. One memset and one launch on `stream`;
// never synchronises, allocates nothing.
SRT_EXPORT int srt_build_table(const uint32_t* lo, const uint32_t* hi,
                               const int32_t* valid, int32_t* slot,
                               uint32_t* tlo, uint32_t* thi, int32_t* trow,
                               int* counters, int64_t c, int t, int s,
                               int max_probes, void* stream) {
  if (c < 0 || t < 0 || s < 2 || (s & (s - 1))) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (rc != 0 || c == 0) return rc;
  bool fits;
  size_t smem;
  if ((rc = chunk_fits(t, s, &fits, &smem)) != 0) return rc;
  uint32_t* row_words = reinterpret_cast<uint32_t*>(trow);
  if (fits) {
    rc = cudaFuncSetAttribute(build_chunk,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != 0) return rc;
    int threads = ((t + kChunkRows - 1) / kChunkRows + 31) / 32 * 32;
    threads = threads < 32 ? 32 : threads;
    build_chunk<<<static_cast<unsigned int>(c), threads, smem, st>>>(
        lo, hi, valid, slot, tlo, thi, row_words, t, s, max_probes, counters);
    return static_cast<int>(cudaGetLastError());
  }
  // every block resident, as the cooperative launch requires: at most one
  // block an SM, and the block must fit one
  int dev, sms, occ;
  if ((rc = cudaGetDevice(&dev)) != 0 ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != 0 ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, build_grid, kGridThreads, 0)) != 0) {
    return rc;
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int64_t work = c * (t > s ? t : s);
  int64_t blocks = (work + kGridThreads - 1) / kGridThreads;
  blocks = blocks < sms ? blocks : sms;
  void* args[] = {&lo,  &hi, &valid, &slot, &tlo,        &thi,
                  &row_words, &c, &t, &s, &max_probes, &counters};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_grid),
      dim3(static_cast<unsigned int>(blocks)), dim3(kGridThreads), args, 0,
      st));
}

// All buffers are device memory the caller allocated: lo/hi/valid/found/
// row hold C*T entries, tlo/thi/trow C*S, unresolved 1 int, which this
// zeroes. One memset and one launch on `stream`; never synchronises,
// allocates nothing.
SRT_EXPORT int srt_probe_table(const int32_t* lo, const int32_t* hi,
                               const int32_t* valid, const int32_t* tlo,
                               const int32_t* thi, const int32_t* trow,
                               int32_t* found, int32_t* row, int* unresolved,
                               int64_t c, int t, int s, int max_probes,
                               void* stream) {
  if (c < 0 || t < 0 || s < 2 || (s & (s - 1))) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = cudaMemsetAsync(unresolved, 0, sizeof(int), st);
  if (rc != 0 || c == 0 || t == 0) return rc;
  dim3 grid(static_cast<unsigned int>((t + kProbeThreads - 1) / kProbeThreads),
            static_cast<unsigned int>(c < kGridYMax ? c : kGridYMax));
  probe_slots<<<grid, kProbeThreads, 0, st>>>(lo, hi, valid, tlo, thi, trow,
                                              found, row, unresolved, c, t, s,
                                              max_probes);
  return static_cast<int>(cudaGetLastError());
}
