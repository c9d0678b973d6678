// The cluster radix select of K2 window_topk (window_topk.cu), shared with
// K14 express_place's window (express_place.cu): the first k entries of one
// row's order, key desc under IEEE 754's total order (order_key.cuh: +0.0
// ahead of -0.0, -inf an ordinary key), ties to the lower index — an exact
// prefix of the order lax.top_k gives, which the coverage proofs of both
// callers rely on.
//
// Every entry has a unique key, (score's order-preserving bits desc, index
// asc), so the top k is a set with no tie left to resolve.
//   1. Radix select across the cluster. A row belongs to a cluster of C
//      CTAs (C = 1..8, the caller's choice); CTA r owns the index range
//      [lo, hi). Each pass builds a 256-bin histogram of the next 8 bits of
//      the key in shared memory (warp-aggregated atomics, so equal scores
//      cost one atomic a warp), every CTA sums the C histograms through
//      distributed shared memory after a cluster barrier, and each finds
//      the same digit. The passes stop as soon as the keys above the
//      threshold number exactly k. If the key bits run out first, the
//      entries equal to the threshold are ranked by index: a CTA's offset
//      is the sum of the earlier CTAs' tie counts (their last histogram
//      bins), then a block scan in index order.
//   2. Compaction: each CTA appends its survivors to the row's k slots of a
//      scratch list (positions from one atomic a warp on CTA 0's counter,
//      in any order).
//   3. The sort of the k survivors: each survivor's output position is the
//      number of survivors ahead of it (tiles of the list staged in shared
//      memory), each CTA ranking k/C of them with a few threads a survivor.
//
// The caller gives the keys as a function of the index (K2: the score row
// in global memory; K14: the scores it computed once into the CTA's slice),
// launches kThreads threads a CTA and calls `cluster_select` from every
// thread of every CTA of the row's cluster.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "order_key.cuh"

namespace topk {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kTile = 1024;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kBins, "one histogram bin a thread");

template <typename T>
struct Key;
template <>
struct Key<float> {
  using U = uint32_t;
  static constexpr int kBits = 32;
};
template <>
struct Key<double> {
  using U = uint64_t;
  static constexpr int kBits = 64;
};

// exclusive rank of this thread's flag in thread order; `total` gets the
// block's count (every thread calls)
__device__ __forceinline__ int block_rank(bool f, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned b = __ballot_sync(kFull, f);
  if (lane == 0) warp_tot[w] = __popc(b);
  __syncthreads();
  int off = 0;
  total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    int v = warp_tot[q];
    off += q < w ? v : 0;
    total += v;
  }
  __syncthreads();
  return off + __popc(b & ((1u << lane) - 1u));
}

// The row's first k entries: `key(i)` is entry i's okey::ord key for i in
// this CTA's [lo, hi); top_s/top_i get the k scores (bit for bit) and
// indices in order; rhi/rlo are the row's scratch list of k entries. Its
// shared memory is its own static arrays (the peers read `hist` and
// `count` through distributed shared memory at the same address; arrays of
// their own, not one struct, keep K2 at its parent's time).
template <typename T, typename KeyFn>
__device__ __forceinline__ void cluster_select(cg::cluster_group& cluster, int lo, int hi,
                                               int k, KeyFn key,
                                               T* __restrict__ top_s,
                                               int32_t* __restrict__ top_i,
                                               uint64_t* __restrict__ rhi,
                                               uint32_t* __restrict__ rlo) {
  using U = typename Key<T>::U;
  constexpr int kBits = Key<T>::kBits;
  __shared__ int hist[2][kBins];
  __shared__ int warp_tot[kWarps];
  __shared__ int pick_digit, pick_above, pick_count;
  __shared__ int count;  // CTA 0's: survivors appended so far
  __shared__ uint64_t tile_hi[kTile];
  __shared__ uint32_t tile_lo[kTile];
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) count = 0;

  // -- 1. radix select over the key, 8 bits a pass -----------------------------
  U prefix = 0, mask = 0;
  int remaining = k, buf = 0, digit = 0;
  bool exact = false;
  for (int shift = kBits - 8;; shift -= 8) {
    int* h = hist[buf];
    h[tid] = 0;
    __syncthreads();
    for (int base = lo; base < hi; base += kThreads) {
      int i = base + tid;
      int d = -1;
      if (i < hi) {
        U u = key(i);
        if ((u & mask) == prefix) d = (int)((u >> shift) & U(kBins - 1));
      }
      unsigned same = __match_any_sync(kFull, d);
      if (d >= 0 && lane == __ffs(same) - 1) atomicAdd(&h[d], __popc(same));
    }
    __syncthreads();
    cluster.sync();
    // the row's histogram, bins from the top: thread t holds bin 255 - t
    const int bin = kBins - 1 - tid;
    int part[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) part[c] = c < C ? cluster.map_shared_rank(h, c)[bin] : 0;
    int g = 0;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) g += part[c];
    int incl = g;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    for (int q = 0; q < warp; ++q) incl += warp_tot[q];
    const int above = incl - g;
    if (above < remaining && remaining <= incl) {
      pick_digit = bin;
      pick_above = above;
      pick_count = g;
    }
    __syncthreads();
    digit = pick_digit;
    remaining -= pick_above;
    prefix |= (U)digit << shift;
    mask |= (U)(kBins - 1) << shift;
    exact = pick_count == remaining;
    __syncthreads();
    if (exact || shift == 0) break;
    buf ^= 1;
  }

  // -- 2. compaction: keys above the threshold, and the ties it needs ---------
  // tie offset: the earlier CTAs' entries equal to the full threshold (their
  // last pass's bin; nothing writes a histogram again)
  int tie_base = 0;
  if (!exact)
    for (int c = 0; c < r; ++c) tie_base += cluster.map_shared_rank(hist[buf], c)[digit];
  int* count0 = cluster.map_shared_rank(&count, 0);
  for (int base = lo; base < hi; base += kThreads) {
    int i = base + tid;
    bool in = i < hi;
    U u = in ? key(i) : U(0);
    bool gt = in && (u & mask) > prefix;
    bool eq = in && (u & mask) == prefix;
    bool take = gt || (eq && exact);
    if (!exact) {
      int total;
      int rank = block_rank(eq, warp_tot, total);
      take = take || (eq && tie_base + rank < remaining);
      tie_base += total;
    }
    unsigned b = __ballot_sync(kFull, take);
    int pos = 0;
    if (lane == 0 && b) pos = atomicAdd(count0, __popc(b));
    pos = __shfl_sync(kFull, pos, 0) + __popc(b & ((1u << lane) - 1u));
    if (take) {
      rhi[pos] = (uint64_t)u;
      rlo[pos] = ~(uint32_t)i;
    }
  }
  cluster.sync();

  // -- 3. each survivor's position: the survivors ahead of it ------------------
  // CTA r ranks its share of the list; `tps` threads share one survivor's
  // comparisons, so every thread of the cluster works
  const int per = (k + C - 1) / C;
  const int s_lo = min(r * per, k), s_hi = min(s_lo + per, k);
  int tps = 1;
  while (tps < 32 && 2 * tps * (s_hi - s_lo) <= kThreads) tps <<= 1;
  const int sub = tid & (tps - 1);
  for (int base = s_lo; base < s_hi; base += kThreads / tps) {
    const int s = base + tid / tps;
    const bool own = s < s_hi;
    const uint64_t mh = own ? __ldcg(rhi + s) : 0;
    const uint32_t ml = own ? __ldcg(rlo + s) : 0;
    int ahead = 0;
    for (int t0 = 0; t0 < k; t0 += kTile) {
      const int n = min(kTile, k - t0);
      __syncthreads();
      for (int j = tid; j < n; j += kThreads) {
        tile_hi[j] = __ldcg(rhi + t0 + j);
        tile_lo[j] = __ldcg(rlo + t0 + j);
      }
      __syncthreads();
      if (own) {
#pragma unroll 4
        for (int j = sub; j < n; j += tps) {
          const uint64_t h2 = tile_hi[j];
          ahead += (h2 > mh || (h2 == mh && tile_lo[j] > ml)) ? 1 : 0;
        }
      }
    }
    for (int off = 1; off < tps; off <<= 1) ahead += __shfl_xor_sync(kFull, ahead, off);
    if (own && sub == 0) {
      top_s[ahead] = okey::unord((U)mh);
      top_i[ahead] = (int32_t)~ml;
    }
  }
}

}  // namespace topk
