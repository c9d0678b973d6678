// Block-wide segmented inclusive scan of int64 vectors, shared by the
// resolve_prefix (K4) and queue_budget (K5) kernels.
//
// A single block walks the sorted row axis in chunks of blockDim.x rows,
// one row per thread. Within a chunk: a warp shuffle scan, then a scan of
// the warp aggregates by warp 0, then each warp adds its prefix. Across
// chunks the caller carries the running sums of the last row: a row whose
// segment started before the chunk (flag still 0 after the block scan)
// adds the carry. All sums are exact int64 (the JAX reference keeps two
// 15-bit int32 limbs for the same exactness).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segscan {

constexpr unsigned kFull = 0xffffffffu;

// (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va + vb), a before b
template <int W>
__device__ __forceinline__ void warp_scan(int& f, long long (&v)[W]) {
  int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int fu = __shfl_up_sync(kFull, f, d);
    long long vu[W];
#pragma unroll
    for (int w = 0; w < W; ++w) vu[w] = __shfl_up_sync(kFull, v[w], d);
    if (lane >= d) {
      if (!f) {
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] += vu[w];
      }
      f |= fu;
    }
  }
}

// On return v is the sum from this row's segment start (or the chunk's
// first row) to this row, and f says whether a segment starts at or before
// this row inside the chunk. sf/sv are 32-entry shared scratch.
template <int W>
__device__ __forceinline__ void block_scan(int& f, long long (&v)[W], int* sf,
                                           long long (*sv)[W]) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  warp_scan<W>(f, v);
  if (lane == 31) {
    sf[warp] = f;
#pragma unroll
    for (int w = 0; w < W; ++w) sv[warp][w] = v[w];
  }
  __syncthreads();
  if (warp == 0) {
    int g = lane < nwarps ? sf[lane] : 1;
    long long gv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) gv[w] = lane < nwarps ? sv[lane][w] : 0;
    warp_scan<W>(g, gv);
    if (lane < nwarps) {
      sf[lane] = g;
#pragma unroll
      for (int w = 0; w < W; ++w) sv[lane][w] = gv[w];
    }
  }
  __syncthreads();
  if (warp > 0 && !f) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] += sv[warp - 1][w];
    f = sf[warp - 1];
  }
  __syncthreads();
}

}  // namespace segscan
