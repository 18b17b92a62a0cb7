// Batched sort of distinct u32 keys for Hopper: kernel K4b.
//
// Replaces the Pallas kernel of spark_rapids_jni_tpu/kernels/bitonic_sort.py:
// batched_sort_u32 (_kernel_u32, :265): an ascending sort of each row of u32
// keys that are DISTINCT within a row (the packed word with its embedded
// iota), so no index tiebreak rides. Each of C rows of T keys (T a power of
// two) is sorted by a bitonic network cut in three kinds of launch:
//   (i)   sort_tiles_u32 — one block per tile of a row runs every stage with
//                          k <= tile in shared memory: a tile of up to 2^15
//                          keys in 128 KB (2^14 when a u32 index rides for
//                          payloads);
//   (ii)  for each stage k > tile: one global_step_u32 launch per j >= tile
//         (one thread per compare-exchange pair), then one merge_tile_u32
//         launch for all the steps j < tile in shared memory;
//   (iii) the payload gather of gather.cuh, through the riding index.
// Rows ride blockIdx.y; the direction of a compare-exchange is
// ((i & k) == 0) over the index i within the row, so tiles of one row
// alternate direction exactly as the whole-row network does.
//
// Bound on the H100: bytes. The least traffic is 4 B read and 4 B written a
// key, plus one read and one write of each payload. K3 and K4a, the u64
// sorts of the same module, are radix_sort.cu.

#include "common.cuh"
#include "gather.cuh"

constexpr int kTileThreads = 1024;   // two compare-exchanges a thread a step

static int check_launch() { return static_cast<int>(cudaGetLastError()); }

constexpr int kTileU32 = 1 << 15;     // keys a block sorts, key only: 128 KB
constexpr int kTileU32Idx = 1 << 14;  // with the riding u32 index: 128 KB

// Steps j = j_top .. 1 of stage k over one tile of u32 keys (and, when
// `si` is not null, their riding indices) in shared memory.
__device__ void tile_steps_u32(uint32_t* sk, uint32_t* si, int tile_n,
                               int64_t base, int64_t k, int j_top) {
  for (int j = j_top; j >= 1; j >>= 1) {
    int lj = __ffs(j) - 1;
    __syncthreads();
    for (int p = threadIdx.x; p < tile_n / 2; p += blockDim.x) {
      int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
      int q = i + j;
      bool asc = ((base + i) & k) == 0;
      uint32_t ka = sk[i], kb = sk[q];
      if (asc ? ka > kb : ka < kb) {
        sk[i] = kb;
        sk[q] = ka;
        if (si != nullptr) {
          uint32_t ia = si[i];
          si[i] = si[q];
          si[q] = ia;
        }
      }
    }
  }
  __syncthreads();
}

// One block per (tile, row): every stage k <= tile in shared memory.
__global__ void sort_tiles_u32(const uint32_t* __restrict__ key_in,
                               uint32_t* __restrict__ key_out,
                               uint32_t* __restrict__ idx_out, int64_t t,
                               int tile_n) {
  extern __shared__ uint32_t smem32[];
  uint32_t* sk = smem32;
  uint32_t* si = idx_out != nullptr ? smem32 + tile_n : nullptr;
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile_n;
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    sk[e] = key_in[row + base + e];
    if (si != nullptr) si[e] = static_cast<uint32_t>(base + e);
  }
  for (int64_t k = 2; k <= tile_n; k <<= 1) {
    tile_steps_u32(sk, si, tile_n, base, k, static_cast<int>(k >> 1));
  }
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    key_out[row + base + e] = sk[e];
    if (si != nullptr) idx_out[row + base + e] = si[e];
  }
}

// Steps j < tile of stage k, in place, one block per (tile, row).
__global__ void merge_tile_u32(uint32_t* __restrict__ key,
                               uint32_t* __restrict__ idx, int64_t t,
                               int tile_n, int64_t k) {
  extern __shared__ uint32_t smem32[];
  uint32_t* sk = smem32;
  uint32_t* si = idx != nullptr ? smem32 + tile_n : nullptr;
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile_n;
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    sk[e] = key[row + base + e];
    if (si != nullptr) si[e] = idx[row + base + e];
  }
  tile_steps_u32(sk, si, tile_n, base, k, tile_n >> 1);
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    key[row + base + e] = sk[e];
    if (si != nullptr) idx[row + base + e] = si[e];
  }
}

// One compare-exchange step (k, j) with j >= tile, one thread per pair.
__global__ void global_step_u32(uint32_t* __restrict__ key,
                                uint32_t* __restrict__ idx, int64_t t,
                                int64_t k, int64_t j, int lj) {
  int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (p >= (t >> 1)) return;
  int64_t i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t a = row + i;
  int64_t b = a + j;
  bool asc = (i & k) == 0;
  uint32_t ka = key[a], kb = key[b];
  if (asc ? ka > kb : ka < kb) {
    key[a] = kb;
    key[b] = ka;
    if (idx != nullptr) {
      uint32_t ia = idx[a];
      idx[a] = idx[b];
      idx[b] = ia;
    }
  }
}

// key_in/key_out: C*T u32 keys, distinct within each row; idx: C*T u32
// scratch for the riding index, needed (not null) only when npay > 0;
// psrc/pdst/pwidth: host arrays of npay payload pointers (C*T values of
// pwidth bytes each). T is a power of two, 2 <= T <= 2^31, and
// 1 <= C <= 65535.
SRT_EXPORT int srt_bitonic_sort_u32(const uint32_t* key_in, uint32_t* key_out,
                                    uint32_t* idx, int64_t c, int64_t t,
                                    const uint64_t* psrc, const uint64_t* pdst,
                                    const int* pwidth, int npay, void* stream) {
  if (t < 2 || (t & (t - 1)) || t > (int64_t{1} << 31) || c < 1 ||
      c > 65535 || npay < 0 || (npay > 0 && idx == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (npay == 0) idx = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tile_max = idx != nullptr ? kTileU32Idx : kTileU32;
  int tile_n = static_cast<int>(t < tile_max ? t : tile_max);
  int threads = tile_n / 2 < kTileThreads ? tile_n / 2 : kTileThreads;
  size_t smem = static_cast<size_t>(tile_n) * sizeof(uint32_t) *
                (idx != nullptr ? 2 : 1);
  int rc = cudaFuncSetAttribute(sort_tiles_u32,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  if (rc == 0) {
    rc = cudaFuncSetAttribute(merge_tile_u32,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  if (rc != 0) return rc;
  dim3 tiles(static_cast<unsigned int>(t / tile_n), static_cast<unsigned int>(c));
  sort_tiles_u32<<<tiles, threads, smem, st>>>(key_in, key_out, idx, t, tile_n);
  if ((rc = check_launch()) != 0) return rc;
  dim3 pairs(blocks_for(t >> 1), static_cast<unsigned int>(c));
  for (int64_t k = int64_t{2} * tile_n; k <= t; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile_n; j >>= 1) {
      int lj = 0;
      while ((int64_t{1} << lj) < j) ++lj;
      global_step_u32<<<pairs, kThreads, 0, st>>>(key_out, idx, t, k, j, lj);
      if ((rc = check_launch()) != 0) return rc;
    }
    merge_tile_u32<<<tiles, threads, smem, st>>>(key_out, idx, t, tile_n, k);
    if ((rc = check_launch()) != 0) return rc;
  }
  return launch_gather(idx, c, t, psrc, pdst, pwidth, npay, st);
}
