// Segmented scans of int64 vectors and the single-pass look-back between
// CTAs, shared by resolve_prefix (K4) and queue_budget (K5).
//
// A segmented pair (f, v[W]) describes a span of rows: f says a segment
// starts inside it, v sums the span from its last segment start (or from
// its first row) to its end. Two pairs combine, a before b, as
//   (fa | fb, fb ? vb : va + vb),
// which is associative with identity (0, 0), so threads, warps, the block
// and the tiles of a grid scan them like sums. All sums are exact int64
// (the JAX reference keeps two 15-bit int32 limbs for the same exactness).
//
// Between CTAs (K4): each tile publishes its aggregate, then, once it has
// looked back, its inclusive prefix, behind a status word stamped with the
// launch's epoch. A look-back stops at the first tile before it that
// holds a segment start or has published its prefix.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segscan {

constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Seg {
  int f;
  long long v[W];
};

template <int W>
__device__ __forceinline__ Seg<W> ident() {
  Seg<W> s;
  s.f = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) s.v[w] = 0;
  return s;
}

// a then b
template <int W>
__device__ __forceinline__ Seg<W> cat(const Seg<W>& a, const Seg<W>& b) {
  Seg<W> s;
  s.f = a.f | b.f;
#pragma unroll
  for (int w = 0; w < W; ++w) s.v[w] = b.f ? b.v[w] : a.v[w] + b.v[w];
  return s;
}

template <int W>
__device__ __forceinline__ Seg<W> shfl_up(const Seg<W>& a, int d) {
  Seg<W> s;
  s.f = __shfl_up_sync(kFull, a.f, d);
#pragma unroll
  for (int w = 0; w < W; ++w) s.v[w] = __shfl_up_sync(kFull, a.v[w], d);
  return s;
}

// A segmented OR flag, packed: bit 0 the segment start, bit 1 the flag.
__device__ __forceinline__ int cat(int a, int b) {
  return ((a | b) & 1) | ((b & 1) ? (b & 2) : ((a | b) & 2));
}

__device__ __forceinline__ int shfl_up(int a, int d) {
  return __shfl_up_sync(kFull, a, d);
}

// Exclusive scan of x over the block in thread order (identity before
// thread 0); *total gets the block's aggregate. sw: 32 entries. Every
// thread calls; the call ends on a barrier, so sw can be reused at once.
template <typename S>
__device__ __forceinline__ S block_exclusive(S x, S id, S* sw, S* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    S y = shfl_up(x, d);
    if (lane >= d) x = cat(y, x);
  }
  if (lane == 31) sw[warp] = x;
  __syncthreads();
  if (warp == 0) {
    S w = lane < nwarps ? sw[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      S y = shfl_up(w, d);
      if (lane >= d) w = cat(y, w);
    }
    if (lane < nwarps) sw[lane] = w;
  }
  __syncthreads();
  S before = warp > 0 ? sw[warp - 1] : id;
  S in_warp = shfl_up(x, 1);
  if (lane == 0) in_warp = id;
  *total = sw[nwarps - 1];
  __syncthreads();
  return cat(before, in_warp);
}

// -- the look-back between tiles ---------------------------------------------

// status word: epoch << 8 | flags
constexpr unsigned long long kAgg = 1;   // the aggregate is published
constexpr unsigned long long kPre = 2;   // the inclusive prefix is published
constexpr unsigned long long kHead = 4;  // a segment starts in the tile
constexpr unsigned long long kBitA = 8;  // a flag scan's aggregate bit
constexpr unsigned long long kBitP = 16; // a flag scan's prefix bit

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The status of tile p in this epoch, once it has published its aggregate.
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* st, int p, unsigned long long epoch) {
  unsigned long long s;
  do {
    s = ld_acquire(st + p);
  } while ((s >> 8) != epoch);
  return s;
}

// One thread: the combination of tiles [0, tile) of a vector scan, whose
// tiles publish W lanes each at agg/inc (stride kStride) behind st.
template <int W, int kStride>
__device__ Seg<W> look_back(const unsigned long long* st, const long long* agg,
                            const long long* inc, int tile,
                            unsigned long long epoch) {
  Seg<W> acc = ident<W>();
  for (int p = tile - 1; p >= 0; --p) {
    const unsigned long long s = wait_status(st, p, epoch);
    const bool pre = s & kPre;
    const long long* src = (pre ? inc : agg) + (size_t)p * kStride;
    Seg<W> x;
    x.f = (pre || (s & kHead)) ? 1 : 0;
#pragma unroll
    for (int w = 0; w < W; ++w) x.v[w] = __ldcg(src + w);
    acc = cat(x, acc);
    if (x.f) break;
  }
  return acc;
}

// One thread: publish a vector tile's aggregate (kAgg) or inclusive
// prefix (kPre) with its head bit.
template <int W, int kStride>
__device__ __forceinline__ void publish(unsigned long long* st, long long* dst,
                                        int tile, const Seg<W>& x, int head,
                                        unsigned long long epoch,
                                        unsigned long long kind) {
#pragma unroll
  for (int w = 0; w < W; ++w) dst[(size_t)tile * kStride + w] = x.v[w];
  st_release(st + tile, (epoch << 8) | kAgg | kind | (head ? kHead : 0));
}

// One thread: the combination of tiles [0, tile) of a flag scan (cat(int)),
// whose tiles publish their bits in the status word itself.
__device__ __forceinline__ int look_back_flag(const unsigned long long* st,
                                              int tile, unsigned long long epoch) {
  int acc = 0;
  for (int p = tile - 1; p >= 0; --p) {
    const unsigned long long s = wait_status(st, p, epoch);
    const bool pre = s & kPre;
    const int bit = (s & (pre ? kBitP : kBitA)) ? 2 : 0;
    const int x = bit | ((pre || (s & kHead)) ? 1 : 0);
    acc = cat(x, acc);
    if (x & 1) break;
  }
  return acc;
}

}  // namespace segscan
