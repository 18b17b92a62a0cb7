// Batched stable sort of u64 keys for Hopper: kernel K3.
//
// Replaces the Pallas kernel of spark_rapids_jni_tpu/kernels/bitonic_sort.py:
// batched_sort_u64_looped (_kernel_u64_looped). Each of C rows of T keys
// (T a power of two) is sorted ascending by a bitonic network whose compare
// is lexicographic over (key, idx): the u64 key compared unsigned — which
// is the (hi, lo) u32 pair compared lexicographically — then the element's
// index within its row. The index makes every element distinct, so the
// network's output is the stable sort, and the index that rides the network
// is the permutation. Payloads move once, through that permutation.
//
// The TPU kernel ran the whole (C, T) batch as one program in VMEM, which
// bounds T at 2^16. A Hopper block has at most 227 KB of shared memory, so
// the network is cut in three kinds of launch:
//   (i)   sort_tiles  — one block per tile of kTile elements of a row runs
//                       every stage with k <= tile in shared memory, on
//                       (key, idx) only (12 bytes an element: 48 KB);
//   (ii)  for each stage k > tile: one global_step launch per j >= tile
//         (one thread per compare-exchange pair), then one merge_tile launch
//         for all the steps j < tile in shared memory;
//   (iii) gather_payloads — one launch moves every payload through the perm.
// Rows ride blockIdx.y; the direction of a compare-exchange is
// ((i & k) == 0) over the index i within the row, so tiles of one row
// alternate direction exactly as the whole-row network does.
//
// Bound on the H100: bytes. The least traffic is one read of the key and
// the payloads and one write of the sorted key, the perm and the payloads.
// This design moves the 12-byte (key, idx) pairs through device memory once
// per global step and once per merge: at T = 2^23 that is 1 + 66 + 11 = 78
// passes, about 200 MB each — the network's launch chain, not the least
// bytes, sets its time. Merging several global steps per pass (a later
// speed step) is what would close the gap.
//
// K4a (batched_sort_u64 of spark_rapids_jni_tpu/kernels/bitonic_sort.py,
// _kernel) has K3's contract — the JAX package says so at
// bitonic_sort.py:418-419 — and runs this same launch sequence,
// srt_bitonic_sort, on its many-row (C, T) batches (rows on blockIdx.y).
//
// K4b, srt_bitonic_sort_u32 below, replaces batched_sort_u32 (_kernel_u32,
// bitonic_sort.py:265): an ascending sort of each row of u32 keys that are
// DISTINCT within a row (the packed word with its embedded iota), so no
// index tiebreak rides. One key is 4 bytes instead of K3's 12-byte pair,
// so a block sorts a tile of up to 2^15 keys in 128 KB of shared memory
// (2^14 when a u32 index rides for payloads). Stages beyond the tile run
// as in K3: one global compare-exchange launch per step j >= tile, then a
// shared-memory merge. Bytes bound it: the least traffic is 4 B read and
// 4 B written a key, plus one read and one write of each payload; the
// payloads move once, through the riding index, as in K3.

#include "common.cuh"

constexpr int kTile = 4096;          // elements a block sorts in shared memory
constexpr int kTileThreads = 1024;   // two compare-exchanges a thread a step
constexpr int kMaxPayloads = 64;     // payloads one gather launch moves

struct Payloads {
  const void* src[kMaxPayloads];
  void* dst[kMaxPayloads];
  int width[kMaxPayloads];
};

// true when (ka, ia) sorts after (kb, ib)
__device__ __forceinline__ bool after(uint64_t ka, uint32_t ia, uint64_t kb,
                                      uint32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// Steps j = j_top .. 1 of stage k over one tile in shared memory; `base` is
// the tile's first index within its row.
__device__ void tile_steps(uint64_t* sk, uint32_t* si, int tile_n,
                           int64_t base, int64_t k, int j_top) {
  for (int j = j_top; j >= 1; j >>= 1) {
    int lj = __ffs(j) - 1;
    __syncthreads();
    for (int p = threadIdx.x; p < tile_n / 2; p += blockDim.x) {
      int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
      int q = i + j;
      bool asc = ((base + i) & k) == 0;
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

__global__ void sort_tiles(const uint64_t* __restrict__ key_in,
                           uint64_t* __restrict__ key_out,
                           uint32_t* __restrict__ idx_out, int64_t t,
                           int tile_n) {
  extern __shared__ uint64_t smem[];
  uint64_t* sk = smem;
  uint32_t* si = reinterpret_cast<uint32_t*>(smem + tile_n);
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile_n;
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    sk[e] = key_in[row + base + e];
    si[e] = static_cast<uint32_t>(base + e);
  }
  for (int64_t k = 2; k <= tile_n; k <<= 1) {
    tile_steps(sk, si, tile_n, base, k, static_cast<int>(k >> 1));
  }
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    key_out[row + base + e] = sk[e];
    idx_out[row + base + e] = si[e];
  }
}

__global__ void merge_tile(uint64_t* __restrict__ key, uint32_t* __restrict__ idx,
                           int64_t t, int tile_n, int64_t k) {
  extern __shared__ uint64_t smem[];
  uint64_t* sk = smem;
  uint32_t* si = reinterpret_cast<uint32_t*>(smem + tile_n);
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t base = static_cast<int64_t>(blockIdx.x) * tile_n;
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    sk[e] = key[row + base + e];
    si[e] = idx[row + base + e];
  }
  tile_steps(sk, si, tile_n, base, k, tile_n >> 1);
  for (int e = threadIdx.x; e < tile_n; e += blockDim.x) {
    key[row + base + e] = sk[e];
    idx[row + base + e] = si[e];
  }
}

// one compare-exchange step (k, j) with j >= tile, one thread per pair
__global__ void global_step(uint64_t* __restrict__ key,
                            uint32_t* __restrict__ idx, int64_t t, int64_t k,
                            int64_t j, int lj) {
  int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (p >= (t >> 1)) return;
  int64_t i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t a = row + i;
  int64_t b = a + j;
  uint64_t ka = key[a], kb = key[b];
  uint32_t ia = idx[a], ib = idx[b];
  if (after(ka, ia, kb, ib) == ((i & k) == 0)) {
    key[a] = kb;
    key[b] = ka;
    idx[a] = ib;
    idx[b] = ia;
  }
}

__global__ void gather_payloads(const uint32_t* __restrict__ perm,
                                Payloads pay, int npay, int64_t t) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= t) return;
  int64_t row = static_cast<int64_t>(blockIdx.y) * t;
  int64_t dst = row + i;
  int64_t src = row + perm[dst];
  for (int p = 0; p < npay; ++p) {
    switch (pay.width[p]) {
      case 1:
        static_cast<uint8_t*>(pay.dst[p])[dst] =
            static_cast<const uint8_t*>(pay.src[p])[src];
        break;
      case 2:
        static_cast<uint16_t*>(pay.dst[p])[dst] =
            static_cast<const uint16_t*>(pay.src[p])[src];
        break;
      case 4:
        static_cast<uint32_t*>(pay.dst[p])[dst] =
            static_cast<const uint32_t*>(pay.src[p])[src];
        break;
      default:
        static_cast<uint64_t*>(pay.dst[p])[dst] =
            static_cast<const uint64_t*>(pay.src[p])[src];
        break;
    }
  }
}

static int check_launch() { return static_cast<int>(cudaGetLastError()); }

// key_in/key_out: C*T u64, perm: C*T u32 (the int32 perm), all device
// memory; psrc/pdst/pwidth: host arrays of npay payload pointers (C*T
// values of pwidth bytes each). T is a power of two, 2 <= T <= 2^30, and
// 1 <= C <= 65535.
SRT_EXPORT int srt_bitonic_sort(const uint64_t* key_in, uint64_t* key_out,
                                uint32_t* perm, int64_t c, int64_t t,
                                const uint64_t* psrc, const uint64_t* pdst,
                                const int* pwidth, int npay, void* stream) {
  if (t < 2 || (t & (t - 1)) || t > (int64_t{1} << 30) || c < 1 ||
      c > 65535 || npay < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tile_n = static_cast<int>(t < kTile ? t : kTile);
  int threads = tile_n / 2 < kTileThreads ? tile_n / 2 : kTileThreads;
  size_t smem = static_cast<size_t>(tile_n) * (sizeof(uint64_t) + sizeof(uint32_t));
  int rc = cudaFuncSetAttribute(sort_tiles,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  if (rc == 0) {
    rc = cudaFuncSetAttribute(merge_tile,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  if (rc != 0) return rc;
  dim3 tiles(static_cast<unsigned int>(t / tile_n), static_cast<unsigned int>(c));
  sort_tiles<<<tiles, threads, smem, st>>>(key_in, key_out, perm, t, tile_n);
  if ((rc = check_launch()) != 0) return rc;
  dim3 pairs(blocks_for(t >> 1), static_cast<unsigned int>(c));
  for (int64_t k = int64_t{2} * tile_n; k <= t; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile_n; j >>= 1) {
      int lj = 0;
      while ((int64_t{1} << lj) < j) ++lj;
      global_step<<<pairs, kThreads, 0, st>>>(key_out, perm, t, k, j, lj);
      if ((rc = check_launch()) != 0) return rc;
    }
    merge_tile<<<tiles, threads, smem, st>>>(key_out, perm, t, tile_n, k);
    if ((rc = check_launch()) != 0) return rc;
  }
  dim3 rows(blocks_for(t), static_cast<unsigned int>(c));
  for (int first = 0; first < npay; first += kMaxPayloads) {
    int m = npay - first < kMaxPayloads ? npay - first : kMaxPayloads;
    Payloads pay{};
    for (int p = 0; p < m; ++p) {
      pay.src[p] = reinterpret_cast<const void*>(psrc[first + p]);
      pay.dst[p] = reinterpret_cast<void*>(pdst[first + p]);
      pay.width[p] = pwidth[first + p];
    }
    gather_payloads<<<rows, kThreads, 0, st>>>(perm, pay, m, t);
    if ((rc = check_launch()) != 0) return rc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K4b: distinct u32 keys, no tiebreak
// ---------------------------------------------------------------------------

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
  dim3 rows(blocks_for(t), static_cast<unsigned int>(c));
  for (int first = 0; first < npay; first += kMaxPayloads) {
    int m = npay - first < kMaxPayloads ? npay - first : kMaxPayloads;
    Payloads pay{};
    for (int p = 0; p < m; ++p) {
      pay.src[p] = reinterpret_cast<const void*>(psrc[first + p]);
      pay.dst[p] = reinterpret_cast<void*>(pdst[first + p]);
      pay.width[p] = pwidth[first + p];
    }
    gather_payloads<<<rows, kThreads, 0, st>>>(idx, pay, m, t);
    if ((rc = check_launch()) != 0) return rc;
  }
  return 0;
}
