// K2 window_topk: per class row, the first k entries of the stable
// descending order of the score row under IEEE 754's total order (+0.0
// ahead of -0.0, ties to the lower node index, -inf an ordinary key),
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:754 `lax.top_k(scores, k)` — whose
// window is an exact prefix of that order, ties included, which the
// coverage bit relies on. torch.topk documents no tie order, so it is never
// called.
//
// Bound: bytes (read K x N scores once, write K x k pairs), well under a
// microsecond at cfg5 (K=16, N=10000, k=1024). The previous design sorted
// each whole row on one SM (16 SMs at cfg5, 105 barrier-separated stages);
// this one spreads a row over a thread-block cluster and sorts only k.
//
// Design: every entry has a unique key, (score's order-preserving bits
// desc, index asc), so the top k is a set with no tie left to resolve.
//   1. Radix select across the cluster. A row belongs to a cluster of C
//      CTAs (C = 1..8, chosen by the launcher so that K x C fills the card);
//      CTA r owns the index range [r*ceil(N/C), ...). Each pass builds a
//      256-bin histogram of the next 8 bits of the score key in shared
//      memory (warp-aggregated atomics, so equal scores cost one atomic a
//      warp), every CTA sums the C histograms through distributed shared
//      memory after a cluster barrier, and each finds the same digit. The
//      passes stop as soon as the keys above the threshold number exactly
//      k. If the score bits run out first, the entries equal to the
//      threshold are ranked by index: a CTA's offset is the sum of the
//      earlier CTAs' tie counts (their last histogram bins), then a block
//      scan in index order.
//   2. Compaction: each CTA appends its survivors to the row's k slots of a
//      scratch list (positions from one atomic a warp on CTA 0's counter,
//      in any order).
//   3. The sort of the k survivors: each survivor's output position is the
//      number of survivors ahead of it (tiles of the list staged in shared
//      memory), each CTA ranking k/C of them with a few threads a survivor.
// A row with C = 1 (cfg6: K=512, N=1000) runs the same code on one CTA.
//
// Capturable in a CUDA graph: no allocation (the wrapper passes the
// scratch list from the torch allocator), no host synchronisation, no
// attribute set at launch (static shared memory under 48 KB); the SM count
// is read once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "order_key.cuh"

namespace cg = cooperative_groups;

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_cluster(int N, int k, const T* __restrict__ scores,
                 T* __restrict__ top_s, int32_t* __restrict__ top_i,
                 uint64_t* __restrict__ list_hi, uint32_t* __restrict__ list_lo) {
  using U = typename Key<T>::U;
  constexpr int kBits = Key<T>::kBits;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (N + C - 1) / C;
  const int lo = min(r * chunk, N), hi = min(lo + chunk, N);
  const T* x = scores + (size_t)row * N;
  uint64_t* rhi = list_hi + (size_t)row * k;
  uint32_t* rlo = list_lo + (size_t)row * k;

  __shared__ int hist[2][kBins];
  __shared__ int warp_tot[kWarps];
  __shared__ int pick_digit, pick_above, pick_count;
  __shared__ int count;  // CTA 0's: survivors appended so far
  __shared__ uint64_t tile_hi[kTile];
  __shared__ uint32_t tile_lo[kTile];

  if (tid == 0) count = 0;

  // -- 1. radix select over the score key, 8 bits a pass ----------------------
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
        U u = okey::ord(x[i]);
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
    U u = in ? okey::ord(x[i]) : U(0);
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
      top_s[(size_t)row * k + ahead] = okey::unord((U)mh);
      top_i[(size_t)row * k + ahead] = (int32_t)~ml;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// CTAs a row: doubled while the grid is under one wave and each CTA keeps
// at least 1024 entries
int cluster_size(int K, int N) {
  int c = 1;
  while (c < kMaxCluster && (long)K * c < sm_count() && (N + 2 * c - 1) / (2 * c) >= 1024)
    c <<= 1;
  return c;
}

template <typename T>
int launch(int K, int N, int k, const void* scores, void* top_s, void* top_i,
           void* list_hi, void* list_lo, void* stream) {
  if (K <= 0 || k <= 0 || k > N) return (int)cudaErrorInvalidValue;
  const int c = cluster_size(K, N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, topk_cluster<T>, N, k, (const T*)scores,
                                     (T*)top_s, (int32_t*)top_i, (uint64_t*)list_hi,
                                     (uint32_t*)list_lo);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// the CTAs a row gets at this shape (chip_smoke.py reports it)
extern "C" int window_topk_cluster(int K, int N) { return cluster_size(K, N); }

extern "C" int window_topk_f32(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* list_hi,
                               void* list_lo, void* stream) {
  return launch<float>(K, N, k, scores, top_s, top_i, list_hi, list_lo, stream);
}
extern "C" int window_topk_f64(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* list_hi,
                               void* list_lo, void* stream) {
  return launch<double>(K, N, k, scores, top_s, top_i, list_hi, list_lo, stream);
}
