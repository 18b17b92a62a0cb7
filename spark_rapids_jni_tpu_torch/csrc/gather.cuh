// The payload gather shared by the port's sorts (K3, K4a and K4b): each of
// up to kMaxPayloads payloads of a (C, T) batch moves once through a
// within-row u32 permutation, one thread per output element.
#pragma once

#include "common.cuh"

constexpr int kMaxPayloads = 64;  // payloads one gather launch moves

struct Payloads {
  const void* src[kMaxPayloads];
  void* dst[kMaxPayloads];
  int width[kMaxPayloads];
};

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

// Gathers npay payloads (host arrays of source and destination device
// pointers and widths in bytes) through perm, kMaxPayloads a launch, on
// stream st; returns the first launch error.
static int launch_gather(const uint32_t* perm, int64_t c, int64_t t,
                         const uint64_t* psrc, const uint64_t* pdst,
                         const int* pwidth, int npay, cudaStream_t st) {
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
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}
