// Block-wide exclusive scans and reductions under an associative,
// commutative operation (sum, max, min), shared by the round's select (K3,
// round_select.cu), its commit (K7c, round_commit.cu) and the capacity walk
// (K2b, cap_walk.cu).
//
// A warp shuffle scan, then a scan of the warp aggregates by warp 0, then
// each warp adds the aggregates before it. Every thread of the block must
// call with the same block size; the call ends on a barrier, so the
// 32-entry shared scratch can be reused at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bscan {

constexpr unsigned kFull = 0xffffffffu;

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// Exclusive scan of v over the block in thread order (``ident`` before
// thread 0); *total gets the block's aggregate. sw: 32 entries of T.
template <typename T, typename Op>
__device__ __forceinline__ T exclusive(T v, T ident, Op op, T* sw, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) sw[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? sw[lane] : ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = op(w, y);
    }
    if (lane < nwarps) sw[lane] = w;
  }
  __syncthreads();
  T before = warp > 0 ? sw[warp - 1] : ident;
  T in_warp = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) in_warp = ident;
  *total = sw[nwarps - 1];
  __syncthreads();
  return op(before, in_warp);
}

// The block's aggregate of v, in every thread.
template <typename T, typename Op>
__device__ __forceinline__ T reduce(T v, T ident, Op op, T* sw) {
  T total;
  exclusive(v, ident, op, sw, &total);
  return total;
}

}  // namespace bscan
