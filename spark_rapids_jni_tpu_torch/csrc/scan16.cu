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
// Design: one block of 256 threads owns a tile of 16^3 = 4096 elements,
// which holds three whole levels: 256 level-0 blocks, 16 level-1 blocks
// and one level-2 block. Everything inside a tile is computed in shared
// memory; what crosses tiles is the scan of the tile totals (level 3),
// which the wrapper computes by the same two kernels, recursively, and
// the two "before" values of a tile's first level-0 and level-1 blocks,
// which are the previous tile's right edge:
//   c2(t) = S3[t-1]
//   c1(t) = T3[t-1] + S3[t-2]                 (S_2 at tile t-1's end)
//   c0(t) = T2[t-1][15] + (P2[t-1][14] + S3[t-2])   (S_1 there)
// with S3[-1] = 0.0. So a scan of n elements is scan16_up over the tiles
// (each tile's 16 level-2 totals and its total), the recursive scan of
// the ceil(n/4096) totals, and scan16_down over the tiles: 3 launches at
// 2^23 elements, where the plain version makes about 90.
//
// Bound on the H100: bytes. The input is read twice (once a kernel) and
// the output written once; the tile totals are 1/256 of that. Loads and
// stores are coalesced through shared memory; each thread then walks its
// own 16 consecutive elements, padded one double every 16 so that a
// half-warp's 8-byte reads fall in distinct banks.

#include "common.cuh"

namespace {

constexpr int kBase = 16;
constexpr int kTile = kBase * kBase * kBase;  // 4096 elements a block
constexpr int kScanThreads = kTile / kBase;   // 256: a level-0 block each

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ double flush(double x) {
  return fabs(x) < 2.2250738585072014e-308 ? copysign(0.0, x) : x;
}

__device__ __forceinline__ double add(double a, double b) {
  return flush(a + b);
}

// The tile's elements (zero past n) into shared memory.
__device__ __forceinline__ void load_tile(const double* __restrict__ x,
                                          int64_t n, int64_t base,
                                          double* v) {
  for (int i = threadIdx.x; i < kTile; i += kScanThreads) {
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

__global__ void __launch_bounds__(kScanThreads)
scan16_up(const double* __restrict__ x, int64_t n, double* __restrict__ t2,
          double* __restrict__ t3) {
  __shared__ double v[kTile + kTile / kBase];
  __shared__ double p1[kScanThreads];
  __shared__ double p2[kBase];
  const int64_t tile = blockIdx.x;
  load_tile(x, n, tile * kTile, v);
  __syncthreads();
  p1[threadIdx.x] = prefix16(v + padded(threadIdx.x * kBase), 1);
  __syncthreads();
  if (threadIdx.x < kBase) {
    const double total = prefix16(p1 + threadIdx.x * kBase, 1);
    p2[threadIdx.x] = total;
    t2[tile * kBase + threadIdx.x] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) t3[tile] = prefix16(p2, 1);
}

__global__ void __launch_bounds__(kScanThreads)
scan16_down(const double* __restrict__ x, int64_t n,
            const double* __restrict__ t2, const double* __restrict__ t3,
            const double* __restrict__ s3, double* __restrict__ out) {
  __shared__ double v[kTile + kTile / kBase];
  __shared__ double p1[kScanThreads];
  __shared__ double p2[kBase];
  __shared__ double c[3];
  const int64_t tile = blockIdx.x;
  load_tile(x, n, tile * kTile, v);
  if (threadIdx.x == 0) {
    double c0 = 0.0, c1 = 0.0, c2 = 0.0;
    if (tile > 0) {
      const double s_before = tile > 1 ? s3[tile - 2] : 0.0;
      const double* prev = t2 + (tile - 1) * kBase;
      double p14 = 0.0;
      for (int k = 0; k < kBase - 1; ++k) p14 = add(p14, prev[k]);
      c2 = s3[tile - 1];
      c1 = add(t3[tile - 1], s_before);
      c0 = add(prev[kBase - 1], add(p14, s_before));
    }
    c[0] = c0;
    c[1] = c1;
    c[2] = c2;
  }
  __syncthreads();
  p1[threadIdx.x] = prefix16(v + padded(threadIdx.x * kBase), 1);
  __syncthreads();
  if (threadIdx.x < kBase) {
    p2[threadIdx.x] = prefix16(p1 + threadIdx.x * kBase, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    prefix16(p2, 1);
    // S_2: the tile's one level-2 block gets c2
    for (int k = 0; k < kBase; ++k) p2[k] = add(p2[k], c[2]);
  }
  __syncthreads();
  {  // S_1: one level-1 entry a thread
    const int e = threadIdx.x;
    const int b = e / kBase;
    p1[e] = add(p1[e], b == 0 ? c[1] : p2[b - 1]);
  }
  __syncthreads();
  const int64_t base = tile * kTile;
  for (int i = threadIdx.x; i < kTile; i += kScanThreads) {
    const int b = i / kBase;
    const int64_t g = base + i;
    if (g < n) out[g] = add(v[padded(i)], b == 0 ? c[0] : p1[b - 1]);
  }
}

}  // namespace

// Tile totals: t2 gets 16 level-2 totals a tile, t3 one total a tile.
SRT_EXPORT int srt_scan16_up(const double* x, int64_t n, double* t2,
                             double* t3, int64_t tiles, void* stream) {
  if (tiles <= 0) return 0;
  scan16_up<<<static_cast<unsigned int>(tiles), kScanThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(x, n, t2, t3);
  return static_cast<int>(cudaGetLastError());
}

// The scan: with one tile, t2, t3 and s3 are unused (pass null).
SRT_EXPORT int srt_scan16_down(const double* x, int64_t n, const double* t2,
                               const double* t3, const double* s3,
                               double* out, int64_t tiles, void* stream) {
  if (tiles <= 0) return 0;
  scan16_down<<<static_cast<unsigned int>(tiles), kScanThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, n, t2, t3, s3, out);
  return static_cast<int>(cudaGetLastError());
}
