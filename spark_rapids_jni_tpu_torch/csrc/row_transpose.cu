// Row <-> columnar transpose for Hopper: kernels K1a (pack) and K1b (unpack).
//
// Replaces the Pallas kernels of spark_rapids_jni_tpu/kernels/row_transpose.py:
// pack_rows_pallas (_pack_kernel) and unpack_rows_pallas (_unpack_kernel).
// Same row format: columns arrive / leave as (n, w_i) little-endian byte
// matrices plus one (n,) 0/1 byte validity vector a column (the wrapper
// splits and stacks the JAX contract's (n, num_cols) matrix); a row is the
// Spark UnsafeRow-style layout of rows.py (each column at an offset aligned
// to its width, LSB-first validity bytes after the last column, zero gaps,
// the row padded to 8 bytes). Widths are 1, 2, 4, 8 or 16 (DECIMAL128).
//
// Bound on the H100: bytes. Each input byte is read once and each output
// byte written once; there is no arithmetic to speak of, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design against that bound: a tile transpose staged in shared memory.
// A block of 256 threads owns a tile of R consecutive rows (R a multiple
// of 32, up to 512, sized to the row width below and so that a small
// table still spreads over the SMs). The tile's packed rows are
// contiguous (R * row_size bytes) and move between device memory and a
// row image in shared memory with coalesced 16-byte accesses. Each
// column's slice of the tile is contiguous too (R * w bytes, and R bytes
// of its validity): the lanes of a warp take consecutive rows of one
// column, so a warp's access to a column is one contiguous run in device
// memory, and, with the image's rows an odd number of 8-byte words apart,
// its accesses to the image hit distinct banks.
//  * pack: the block clears the image and stages the tile's validity
//    bytes (16-byte loads of each column's slice); then writes every
//    element into its row (four loads in flight a thread) and builds each
//    row's LSB-first validity bytes; then writes the image out with
//    16-byte stores.
//  * unpack: the mirror. The block loads the row tile into the image with
//    16-byte loads, then writes every element, and each validity bit as a
//    0/1 byte, to its column; per-column null counts take one shared
//    atomic a warp (a ballot) on whole tiles.
// Edges: the ragged last tile and a slice that does not start on 16 bytes
// (any view can start anywhere its width allows) take a guarded path; the
// rows' side needs 8-byte alignment, the columns' their width's. The
// column pointers, offsets and widths travel in the kernel parameter
// block, so a launch needs no device-side metadata.

#include "common.cuh"

constexpr int kMaxCols = 128;
constexpr int kTileThreads = 256;
constexpr int kSmemBudget = 48 * 1024;
// Tile sizes, measured on an H100 at 32- and 56-byte rows: the pack takes
// up to 512 rows within the 48 KB budget; the unpack's image up to 20 KB
// (512 rows of 32 bytes, fewer of wider rows).
constexpr int kPackMaxRows = 512;
constexpr int kUnpackTileBytes = 20 * 1024;
constexpr int kUnpackMaxRows = 512;
constexpr int kBatch = 4;  // elements a thread keeps in flight

struct Layout {
  uint8_t* col[kMaxCols];
  int off[kMaxCols];
  int width[kMaxCols];
};

// Each column's (n,) 0/1 validity bytes: a null pointer means all valid
// (pack only). Unpack adds each column's null count to nulls[c].
struct Validity {
  uint8_t* col[kMaxCols];
  int* nulls;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Bytes between rows of the shared-memory image: the row size, padded to
// an odd number of 8-byte words, so the 32 lanes of a warp reading or
// writing one column of 32 consecutive rows hit distinct banks.
__host__ __device__ __forceinline__ int image_stride(int row_size) {
  return (row_size / 8) % 2 ? row_size : row_size + 8;
}

// 8-byte word u of the tile's packed rows, in the padded image.
__device__ __forceinline__ uint8_t* image_word(uint8_t* image, int u,
                                               int words, int stride) {
  int e = u / words;
  return image + e * stride + 8 * (u - e * words);
}

// The next element of the (column, row) walk a thread takes in steps of
// kTileThreads, rows fastest.
__device__ __forceinline__ void advance(int& c, int& e, int nr) {
  e += kTileThreads;
  while (e >= nr) {
    e -= nr;
    ++c;
  }
}

// One element of width w, as two 8-byte halves (hi only for 16 bytes).
// Global element loads need w-byte alignment (8 for 16-byte elements),
// which the wrapper checks.
__device__ __forceinline__ void load_element(const uint8_t* p, int w,
                                             uint2& lo, uint2& hi) {
  switch (w) {
    case 1: lo = make_uint2(*p, 0); break;
    case 2: lo = make_uint2(*reinterpret_cast<const uint16_t*>(p), 0); break;
    case 4: lo = make_uint2(*reinterpret_cast<const uint32_t*>(p), 0); break;
    case 8: lo = *reinterpret_cast<const uint2*>(p); break;
    default:
      lo = *reinterpret_cast<const uint2*>(p);
      hi = *reinterpret_cast<const uint2*>(p + 8);
  }
}

__device__ __forceinline__ void store_element(uint8_t* p, int w, uint2 lo,
                                              uint2 hi) {
  switch (w) {
    case 1: *p = static_cast<uint8_t>(lo.x); break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(lo.x); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = lo.x; break;
    case 8: *reinterpret_cast<uint2*>(p) = lo; break;
    default:
      *reinterpret_cast<uint2*>(p) = lo;
      *reinterpret_cast<uint2*>(p + 8) = hi;
  }
}

__global__ void __launch_bounds__(kTileThreads)
pack_tile_kernel(Layout layout, Validity validity, int num_cols,
                 uint8_t* __restrict__ out, int64_t n, int row_size, int voff,
                 int vbytes, int tile_rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int stride = image_stride(row_size);
  uint8_t* image = smem;                        // tile_rows * stride
  uint8_t* vstage = smem + tile_rows * stride;  // tile_rows * num_cols
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nr = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
  const int t = threadIdx.x;

  // gaps and padding are 0: clear the image
  const int image_bytes = nr * stride;  // a multiple of 8
  for (int i = 16 * t; i < image_bytes; i += 16 * kTileThreads) {
    if (i + 16 <= image_bytes) {
      *reinterpret_cast<uint4*>(image + i) = make_uint4(0, 0, 0, 0);
    } else {
      *reinterpret_cast<uint2*>(image + i) = make_uint2(0, 0);
    }
  }
  // stage the tile's validity bytes column-major, lanes on consecutive
  // rows: each column's tile slice is nr contiguous bytes, 16-byte chunks
  const int chunks = (nr + 15) / 16;
  for (int i = t; i < num_cols * chunks; i += kTileThreads) {
    int c = i / chunks;
    int q = i - c * chunks;
    const uint8_t* v = validity.col[c];
    uint4 bytes = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                             0x01010101u);
    if (v != nullptr) {
      v += r0;
      if (aligned16(v) && 16 * q + 16 <= nr) {
        bytes = __ldg(reinterpret_cast<const uint4*>(v + 16 * q));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (16 * q + j < nr) w[j / 4] |= static_cast<uint32_t>(v[16 * q + j]) << (8 * (j % 4));
        }
        bytes = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(vstage + c * tile_rows + 16 * q) = bytes;
  }
  __syncthreads();

  // every element of every column into its row: lanes take consecutive
  // rows of a column (coalesced loads, conflict-free stores), kBatch
  // loads in flight before the stores
  const int items = num_cols * nr;
  int c = t / nr;
  int e = t - c * nr;
  for (int base = t; base < items; base += kBatch * kTileThreads) {
    uint2 lo[kBatch], hi[kBatch];
    int cs[kBatch], es[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      cs[k] = c;
      es[k] = e;
      if (base + k * kTileThreads < items) {
        int w = layout.width[c];
        load_element(layout.col[c] + (r0 + e) * w, w, lo[k], hi[k]);
        advance(c, e, nr);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (base + k * kTileThreads < items) {
        store_element(image + es[k] * stride + layout.off[cs[k]],
                      layout.width[cs[k]], lo[k], hi[k]);
      }
    }
  }
  // LSB-first validity bytes from the staged 0/1 bytes
  for (int b = 0; b < vbytes; ++b) {
    for (int r = t; r < nr; r += kTileThreads) {
      const uint8_t* vrow = vstage + r + 8 * b * tile_rows;
      int m = min(8, num_cols - 8 * b);
      uint32_t byte = 0;
      for (int j = 0; j < m; ++j) {
        byte |= static_cast<uint32_t>(vrow[j * tile_rows] != 0) << j;
      }
      image[r * stride + voff + b] = static_cast<uint8_t>(byte);
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in the output: 16-byte stores
  const int words = row_size / 8;
  const int out_words = nr * words;
  uint8_t* dst = out + r0 * row_size;
  const bool vec = aligned16(dst);
  for (int u = 2 * t; u < out_words; u += 2 * kTileThreads) {
    uint2 a = *reinterpret_cast<const uint2*>(image_word(image, u, words, stride));
    if (u + 1 < out_words) {
      uint2 b = *reinterpret_cast<const uint2*>(
          image_word(image, u + 1, words, stride));
      if (vec) {
        *reinterpret_cast<uint4*>(dst + 8 * u) = make_uint4(a.x, a.y, b.x, b.y);
        continue;
      }
      *reinterpret_cast<uint2*>(dst + 8 * u + 8) = b;
    }
    *reinterpret_cast<uint2*>(dst + 8 * u) = a;
  }
}

__global__ void __launch_bounds__(kTileThreads)
unpack_tile_kernel(Layout layout, Validity validity, int num_cols,
                   const uint8_t* __restrict__ rows, int64_t n, int row_size,
                   int voff, int tile_rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tile_nulls[kMaxCols];
  const int stride = image_stride(row_size);
  uint8_t* image = smem;  // tile_rows * stride
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int nr = n - r0 < tile_rows ? static_cast<int>(n - r0) : tile_rows;
  const int t = threadIdx.x;

  // the tile's contiguous rows into the padded image, 16-byte loads
  // rows a multiple of 32: every lane of a warp takes the same number of
  // (column, row) steps, each on one column
  const bool whole_warps = nr % 32 == 0;
  if (t < num_cols) tile_nulls[t] = 0;
  const int words = row_size / 8;
  const int in_words = nr * words;
  const uint8_t* src = rows + r0 * row_size;
  const bool vec = aligned16(src);
  for (int base = 2 * t; base < in_words; base += 2 * kBatch * kTileThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int u = base + 2 * k * kTileThreads;
      if (u >= in_words) break;
      if (vec && u + 1 < in_words) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(src + 8 * u));
      } else {  // 8-byte aligned: rows are 8-byte multiples
        uint2 a = __ldg(reinterpret_cast<const uint2*>(src + 8 * u));
        uint2 b = u + 1 < in_words
                      ? __ldg(reinterpret_cast<const uint2*>(src + 8 * u + 8))
                      : make_uint2(0, 0);
        v[k] = make_uint4(a.x, a.y, b.x, b.y);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int u = base + 2 * k * kTileThreads;
      if (u >= in_words) break;
      *reinterpret_cast<uint2*>(image_word(image, u, words, stride)) =
          make_uint2(v[k].x, v[k].y);
      if (u + 1 < in_words) {
        *reinterpret_cast<uint2*>(image_word(image, u + 1, words, stride)) =
            make_uint2(v[k].z, v[k].w);
      }
    }
  }
  __syncthreads();

  // every element of every column out of its row: lanes take consecutive
  // rows of a column (conflict-free loads, coalesced stores), and its
  // validity bit as a 0/1 byte
  const int items = num_cols * nr;
  int c = t / nr;
  int e = t - c * nr;
  for (int i = t; i < items; i += kTileThreads) {
    int w = layout.width[c];
    const uint8_t* row = image + e * stride;
    uint2 lo, hi;
    load_element(row + layout.off[c], w, lo, hi);
    store_element(layout.col[c] + (r0 + e) * w, w, lo, hi);
    uint8_t bit = (row[voff + (c >> 3)] >> (c & 7)) & 1;
    validity.col[c][r0 + e] = bit;
    if (whole_warps) {  // the warp's 32 lanes are on one column
      unsigned nullmask = __ballot_sync(0xffffffffu, !bit);
      if ((t & 31) == 0 && nullmask) {
        atomicAdd(&tile_nulls[c], __popc(nullmask));
      }
    } else if (!bit) {
      atomicAdd(&tile_nulls[c], 1);
    }
    advance(c, e, nr);
  }
  __syncthreads();
  if (t < num_cols && tile_nulls[t]) atomicAdd(&validity.nulls[t], tile_nulls[t]);
}

static bool fill_layout(Layout* layout, const uint64_t* col_ptrs,
                        const int* offsets, const int* widths, int num_cols) {
  if (num_cols < 1 || num_cols > kMaxCols) return false;
  for (int c = 0; c < num_cols; ++c) {
    int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) return false;
    layout->col[c] = reinterpret_cast<uint8_t*>(col_ptrs[c]);
    layout->off[c] = offsets[c];
    layout->width[c] = w;
  }
  return true;
}

// Rows of a tile: a multiple of 32, at most max_rows, with bytes_per_row
// * rows inside budget where 32 rows allow it, and small enough that n
// rows still spread over two blocks an SM of an H100 (132 SMs).
static int tile_rows(int bytes_per_row, int budget, int max_rows, int64_t n) {
  int r = budget / bytes_per_row / 32 * 32;
  int64_t spread = (n + 2 * 132 - 1) / (2 * 132);
  int64_t want = ((spread < max_rows ? spread : max_rows) + 31) / 32 * 32;
  r = r < want ? r : static_cast<int>(want);
  return r < 32 ? 32 : r;
}

static int pack_tile_rows(int row_size, int num_cols, int64_t n) {
  return tile_rows(image_stride(row_size) + num_cols, kSmemBudget,
                   kPackMaxRows, n);
}

static int unpack_tile_rows(int row_size, int64_t n) {
  return tile_rows(image_stride(row_size), kUnpackTileBytes, kUnpackMaxRows,
                   n);
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

static int launch_pack(const Layout& layout, const Validity& validity,
                       int num_cols, uint8_t* out, int64_t n, int row_size,
                       int voff, int vbytes, void* stream) {
  if (row_size % 8 != 0) return cudaErrorInvalidValue;
  int tile = pack_tile_rows(row_size, num_cols, n);
  size_t smem = static_cast<size_t>(tile) * (image_stride(row_size) + num_cols);
  cudaError_t err = allow_smem(pack_tile_kernel, smem);
  if (err != cudaSuccess) return err;
  unsigned int blocks = static_cast<unsigned int>((n + tile - 1) / tile);
  pack_tile_kernel<<<blocks, kTileThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      layout, validity, num_cols, out, n, row_size, voff, vbytes, tile);
  return cudaGetLastError();
}

static int launch_unpack(const Layout& layout, const Validity& validity,
                         int num_cols, const uint8_t* rows, int64_t n,
                         int row_size, int voff, void* stream) {
  if (row_size % 8 != 0) return cudaErrorInvalidValue;
  int tile = unpack_tile_rows(row_size, n);
  size_t smem = static_cast<size_t>(tile) * image_stride(row_size);
  cudaError_t err = allow_smem(unpack_tile_kernel, smem);
  if (err != cudaSuccess) return err;
  unsigned int blocks = static_cast<unsigned int>((n + tile - 1) / tile);
  unpack_tile_kernel<<<blocks, kTileThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      layout, validity, num_cols, rows, n, row_size, voff, tile);
  return cudaGetLastError();
}

// One validity vector a column (host array of device pointers, 0 for
// none) as a Validity.
static Validity column_validity(const uint64_t* valid_ptrs, int num_cols,
                                int* nulls) {
  Validity v;
  for (int c = 0; c < num_cols; ++c) {
    v.col[c] = reinterpret_cast<uint8_t*>(valid_ptrs[c]);
  }
  v.nulls = nulls;
  return v;
}

// col_ptrs/offsets/widths are host arrays of num_cols entries; valid_ptrs
// a host array of device pointers to (n,) 0/1 validity vectors, 0 for a
// column without one (all valid).
SRT_EXPORT int srt_pack_rows(const uint64_t* col_ptrs, const int* offsets,
                             const int* widths, int num_cols,
                             const uint64_t* valid_ptrs, uint8_t* out,
                             int64_t n, int row_size, int voff, int vbytes,
                             void* stream) {
  Layout layout;
  if (!fill_layout(&layout, col_ptrs, offsets, widths, num_cols)) {
    return cudaErrorInvalidValue;
  }
  return launch_pack(layout, column_validity(valid_ptrs, num_cols, nullptr),
                     num_cols, out, n, row_size, voff, vbytes, stream);
}

// Unpack into one (n,) 0/1 validity vector a column (every pointer set),
// and each column's null count into nulls[c] (a device array of num_cols
// int32, zeroed here).
SRT_EXPORT int srt_unpack_rows(const uint64_t* col_ptrs, const int* offsets,
                               const int* widths, int num_cols,
                               const uint8_t* rows, const uint64_t* valid_ptrs,
                               int* nulls, int64_t n, int row_size, int voff,
                               void* stream) {
  Layout layout;
  if (!fill_layout(&layout, col_ptrs, offsets, widths, num_cols)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(nulls, 0, num_cols * sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return launch_unpack(layout, column_validity(valid_ptrs, num_cols, nulls),
                       num_cols, rows, n, row_size, voff, stream);
}
