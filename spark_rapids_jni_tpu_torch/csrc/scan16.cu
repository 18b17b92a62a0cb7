// FLOAT64 inclusive scan in the add order of XLA's CPU scan, for Hopper.
//
// Replaces, on the card, the plain torch version ops/groupby.py
// _scan_sum16: the cumsum under every FLOAT64 segment sum, which the JAX
// package computes with jnp.cumsum (spark_rapids_jni_tpu/ops/groupby.py
// _sorted_segment_sum). XLA's CPU reduce-window rewrite makes that a
// recursive two-level scan with base 16:
//   level L+1 holds the totals of level L's blocks of 16 (zero-padded);
//   a block's inclusive prefixes are summed left to right from +0.0;
//   S_L[i] = P_L[i] + B_L(block of i), B = 0.0 for block 0, else the
//   scanned level-(L+1) entry of the block before; a level of one block
//   gets + 0.0.
// IEEE adds are deterministic, so the result must be the plain version's
// bit for bit (chip_smoke.py holds it so). XLA's CPU code runs with
// subnormals flushed to zero, in what an add reads and what it returns,
// and FP64 on the card has no such mode: every load and every add goes
// through flush() (a subnormal becomes the zero of its sign).
//
// Design: one launch a call, which reads the input once. A block of 256
// threads owns a tile of 16^3 = 4096 elements, which holds three whole
// levels: 256 level-0 blocks, 16 level-1 blocks and one level-2 block.
// Everything inside a tile is computed in shared memory. What crosses
// tiles is the scan of the tile totals (level 3, S3) and the two
// "before" values of a tile's first level-0 and level-1 blocks, which
// are the previous tile's right edge:
//   c2(t) = S3[t-1]
//   c1(t) = T3[t-1] + S3[t-2]                 (S_2 at tile t-1's end)
//   c0(t) = T2[t-1][15] + (P2[t-1][14] + S3[t-2])   (S_1 there)
// with S3[-1] = 0.0. A block
//   1. takes its tile id from an atomic ticket, so it only ever waits on
//      tiles whose blocks already run: the waits cannot deadlock;
//   2. loads its tile once into shared memory and computes its three
//      levels there;
//   3. publishes its tile total T3 and the right-edge values T2[15] and
//      P2[14], then a ready flag (release store; readers load the flag
//      with acquire);
//   4. if it is the last tile of a span of 16^k tiles (or the last tile
//      of all), publishes that span's total, the entry of level 3 + k:
//      the 16 entries of the level below summed from +0.0, the missing
//      ones of a ragged last block as +0.0;
//   5. recomputes S3[t-1] and S3[t-2] from published entries in XLA's
//      order: S_L[j] = P_L[j] + S_(L+1)[j/16 - 1], P_L[j] the prefix of
//      j's block of 16 up to j. The chain of indices is known up front,
//      so one thread a (scan, level, entry) waits and loads, all at once
//      (2 scans x 8 levels x 16 entries = the block's 256 threads);
//   6. writes its output from the shared-memory tile, without reading x
//      again.
// The flags and the ticket are cleared by one cudaMemsetAsync before the
// launch (a single tile needs neither).
//
// Bound on the H100: bytes. The input is read once and the output
// written once; the published entries are 1/1000 of that. Loads and
// stores are coalesced through shared memory; each thread then walks its
// own 16 consecutive elements, padded one double every 16 so that a
// half-warp's 8-byte reads fall in distinct banks.

#include "common.cuh"

namespace {

constexpr int kBase = 16;
constexpr int kTile = kBase * kBase * kBase;  // 4096 elements a block
constexpr int kScanThreads = kTile / kBase;   // 256: a level-0 block each
constexpr int kMaxLevels = 8;                 // levels above the tile

// Where the entries of the levels above the tile live: level 3 + l has
// count[l] entries, each the total of span[l] tiles, at off[l].. of the
// entry arrays. Level 3 exists from two tiles on; level 3 + l + 1 when
// level 3 + l has more than one block of 16.
struct Layout {
  int levels;
  int64_t count[kMaxLevels];
  int64_t span[kMaxLevels];
  int64_t off[kMaxLevels + 1];
};

__host__ __device__ inline bool layout_of(int64_t tiles, Layout* L) {
  L->levels = 0;
  L->off[0] = 0;
  if (tiles < 2) return true;
  int64_t count = tiles, span = 1;
  for (;;) {
    const int l = L->levels++;
    L->count[l] = count;
    L->span[l] = span;
    L->off[l + 1] = L->off[l] + count;
    if (count <= kBase) return true;
    if (L->levels == kMaxLevels) return false;
    span *= kBase;
    count = (count + kBase - 1) / kBase;
  }
}

// Scratch: the ticket and one flag an entry (uint32, cleared each call),
// then the entries (double), then two right-edge values a tile.
__host__ __device__ inline int64_t flag_bytes(const Layout& L) {
  return (4 * (1 + L.off[L.levels]) + 7) / 8 * 8;
}

__host__ __device__ inline int64_t scratch_bytes(const Layout& L,
                                                 int64_t tiles) {
  if (L.levels == 0) return 0;
  return flag_bytes(L) + 8 * L.off[L.levels] + 16 * tiles;
}

#ifdef SCAN16_PHASES
// The phase clock of chip_smoke.py's breakdown, compiled out unless
// SCAN16_PHASES is defined: %globaltimer (ns) as thread 0 of a block
// starts each step, and the SM it ran on, for the first kPhaseTiles
// tiles.
constexpr int kPhases = 8;
constexpr int kPhaseTiles = 8192;
__device__ long long g_phase[kPhases + 1][kPhaseTiles];
__device__ __forceinline__ long long phase_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(k) const long long phase##k = phase_clock()
#else
#define PHASE(k)
#endif

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ double flush(double x) {
  return fabs(x) < 2.2250738585072014e-308 ? copysign(0.0, x) : x;
}

__device__ __forceinline__ double add(double a, double b) {
  return flush(a + b);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Wait for an entry's flag, then read the entry past L1. Its publisher
// already runs, so the wait is microseconds; a flag still clear after
// about ten seconds of polling is a fault, and the launch fails with it
// (__trap) instead of holding the card.
__device__ __forceinline__ double read_entry(const unsigned* flags,
                                             const double* vals, int64_t at) {
  for (uint32_t polls = 0; load_acquire(flags + at) == 0; ++polls) {
    if (polls == (1u << 28)) __trap();
    __nanosleep(32);
  }
  return __ldcg(vals + at);
}

// The tile's elements (zero past n) into shared memory.
__device__ __forceinline__ void load_tile(const double* __restrict__ x,
                                          int64_t n, int64_t base,
                                          double* v) {
#pragma unroll
  for (int k = 0; k < kTile / kScanThreads; ++k) {
    const int i = threadIdx.x + k * kScanThreads;
    const int64_t g = base + i;
    v[padded(i)] = g < n ? flush(x[g]) : 0.0;
  }
}

// Inclusive prefixes of 16 values from +0.0, in place; returns the total.
__device__ __forceinline__ double prefix16(double* p, int stride) {
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < kBase; ++j) {
    acc = add(acc, p[j * stride]);
    p[j * stride] = acc;
  }
  return acc;
}

// Step 4, by warp 0: the span totals this tile closes, level by level.
// flags/vals point at entry 0 (flags past the ticket).
__device__ void publish_spans(const Layout& L, int64_t tile, int64_t tiles,
                              unsigned* flags, double* vals) {
  const int lane = threadIdx.x;
  for (int l = 1; l < L.levels; ++l) {
    if ((tile + 1) % L.span[l] != 0 && tile != tiles - 1) break;
    const int64_t i = tile / L.span[l];
    const int64_t first = i * kBase;
    const int64_t k = L.count[l - 1] - first;  // children in the block
    double e = 0.0;
    if (lane < kBase && lane < k) {
      e = read_entry(flags, vals, L.off[l - 1] + first + lane);
    }
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kBase; ++j) acc = add(acc, __shfl_sync(~0u, e, j));
    if (lane == 0) {
      vals[L.off[l] + i] = acc;
      store_release(flags + L.off[l] + i, 1u);
    }
    __syncwarp();
  }
}

// The entry index of scan s's chain at level `level`, or -1 past the
// chain's top: j_0 = tile - 1 - s, j_(d+1) = j_d/16 - 1 while j_d/16 > 0.
__device__ __forceinline__ int64_t chain_at(int64_t tile, int s, int level) {
  int64_t j = tile - 1 - s;
  for (int d = 0; d < level && j >= 0; ++d) {
    const int64_t g = j / kBase;
    j = g > 0 ? g - 1 : -1;
  }
  return j;
}

__global__ void __launch_bounds__(kScanThreads)
scan16_onepass(const double* __restrict__ x, int64_t n, int64_t tiles,
               unsigned* ticket, double* vals, double* edge,
               double* __restrict__ out) {
  __shared__ double v[kTile + kTile / kBase];
  __shared__ double p1[kScanThreads + kScanThreads / kBase];
  __shared__ double p2[kBase];
  __shared__ double part[2][kMaxLevels][kBase];
  __shared__ double c[3];
  __shared__ int64_t s_tile;
  __shared__ Layout L;
  unsigned* flags = ticket + 1;
  PHASE(0);
  if (threadIdx.x == 0) {
    s_tile = tiles > 1 ? static_cast<int64_t>(atomicAdd(ticket, 1u)) : 0;
    layout_of(tiles, &L);
  }
  __syncthreads();
  const int64_t tile = s_tile;
  PHASE(1);
  load_tile(x, n, tile * kTile, v);
  __syncthreads();
  PHASE(2);
  p1[padded(threadIdx.x)] = prefix16(v + padded(threadIdx.x * kBase), 1);
  __syncthreads();
  if (threadIdx.x < kBase) {
    p2[threadIdx.x] = prefix16(p1 + padded(threadIdx.x * kBase), 1);
  }
  __syncthreads();
  PHASE(3);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {  // step 3
      const double t2_last = p2[kBase - 1];
      const double t3 = prefix16(p2, 1);
      if (tiles > 1) {
        vals[tile] = t3;
        edge[2 * tile] = t2_last;
        edge[2 * tile + 1] = p2[kBase - 2];
        store_release(flags + tile, 1u);
      }
    }
    __syncwarp();
    if (tiles > 1) publish_spans(L, tile, tiles, flags, vals);
  }
  PHASE(4);
  // step 5: thread (s, d, e) loads entry e of scan s's block at level 3+d
  if (tile > 0) {
    const int s = threadIdx.x >> 7;
    const int d = (threadIdx.x >> 4) & (kMaxLevels - 1);
    const int e = threadIdx.x & (kBase - 1);
    const int64_t j = chain_at(tile, s, d);
    double val = 0.0;
    if (j >= 0 && e <= j % kBase) {
      val = read_entry(flags, vals, L.off[d] + j / kBase * kBase + e);
    }
    part[s][d][e] = val;
  }
  __syncthreads();
  PHASE(5);
  if (threadIdx.x < 32) {
    double s3 = 0.0;  // lane s: S3[tile - 1 - s]
    if (tile > 0 && threadIdx.x < 2) {
      const int s = threadIdx.x;
      int depth = 0;
      while (depth < kMaxLevels && chain_at(tile, s, depth) >= 0) ++depth;
      for (int d = depth - 1; d >= 0; --d) {
        const int last = static_cast<int>(chain_at(tile, s, d) % kBase);
        double acc = 0.0;
        for (int e = 0; e <= last; ++e) acc = add(acc, part[s][d][e]);
        s3 = add(acc, s3);
      }
    }
    const double s3_prev = __shfl_sync(~0u, s3, 0);    // S3[t-1]
    const double s3_before = __shfl_sync(~0u, s3, 1);  // S3[t-2]
    if (threadIdx.x == 0) {
      double c0 = 0.0, c1 = 0.0, c2 = 0.0;
      if (tile > 0) {  // tile t-1's right edge
        const double t3_prev = read_entry(flags, vals, tile - 1);
        const double t2_last = __ldcg(edge + 2 * (tile - 1));
        const double p2_14 = __ldcg(edge + 2 * (tile - 1) + 1);
        c2 = s3_prev;
        c1 = add(t3_prev, s3_before);
        c0 = add(t2_last, add(p2_14, s3_before));
      }
      c[0] = c0;
      c[1] = c1;
      c[2] = c2;
    }
  }
  __syncthreads();
  PHASE(6);
  // step 6: S_2, S_1, S_0 of the tile from shared memory
  if (threadIdx.x < kBase) p2[threadIdx.x] = add(p2[threadIdx.x], c[2]);
  __syncthreads();
  {
    const int e = threadIdx.x;
    const int b = e / kBase;
    p1[padded(e)] = add(p1[padded(e)], b == 0 ? c[1] : p2[b - 1]);
  }
  __syncthreads();
  const int64_t base = tile * kTile;
#pragma unroll
  for (int k = 0; k < kTile / kScanThreads; ++k) {
    const int i = threadIdx.x + k * kScanThreads;
    const int b = i / kBase;
    const int64_t g = base + i;
    if (g < n) out[g] = add(v[padded(i)], b == 0 ? c[0] : p1[padded(b - 1)]);
  }
#ifdef SCAN16_PHASES
  PHASE(7);
  if (threadIdx.x == 0 && tile < kPhaseTiles) {
    const long long at[kPhases] = {phase0, phase1, phase2, phase3,
                                   phase4, phase5, phase6, phase7};
    for (int k = 0; k < kPhases; ++k) g_phase[k][tile] = at[k];
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_phase[kPhases][tile] = sm;
  }
#endif
}

}  // namespace

// Bytes of scratch a call on n elements needs (0 for one tile), or -1
// when n is past what the levels cover.
SRT_EXPORT int64_t srt_scan16_scratch_bytes(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  Layout L;
  if (!layout_of(tiles, &L)) return -1;
  return scratch_bytes(L, tiles);
}

// The scan of n elements: one memset of the flags (from two tiles on),
// then one launch. scratch holds srt_scan16_scratch_bytes(n) bytes.
SRT_EXPORT int srt_scan16(const double* x, int64_t n, void* scratch,
                          int64_t scratch_size, double* out, void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles <= 0) return 0;
  Layout L;
  if (!layout_of(tiles, &L) || scratch_size < scratch_bytes(L, tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* ticket = nullptr;
  double* vals = nullptr;
  double* edge = nullptr;
  if (L.levels > 0) {
    char* base = static_cast<char*>(scratch);
    ticket = reinterpret_cast<unsigned*>(base);
    vals = reinterpret_cast<double*>(base + flag_bytes(L));
    edge = vals + L.off[L.levels];
    const cudaError_t rc = cudaMemsetAsync(ticket, 0, flag_bytes(L), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  scan16_onepass<<<static_cast<unsigned int>(tiles), kScanThreads, 0, st>>>(
      x, n, tiles, ticket, vals, edge, out);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SCAN16_PHASES
// The phase clock's (kPhases + 1, kPhaseTiles) int64 stamps to the host.
SRT_EXPORT int srt_scan16_phases(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
#endif
