// K2b cap_walk: the capacity walk of one round of the rounds solve, along
// each class's ordered candidate axis, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:190 `_cap_walk` (and its use by
// `_nominate_full`, :259). Plain version: volcano_tpu_torch/ops/
// rounds_kernels.py `cap_walk_plain`, equal bit for bit.
//
// For row i (a class) and position j of its ordered axis (node order[i, j]
// of score score[i, j]; the top-k window or the full stable argsort):
//   feas = score > -inf
//   cap  = min over the dims r with req[r] > 0 of idle[node, r] /
//          max(req[r], eps[r]) (IEEE division), inf with none; inf becomes
//          t_cap, then min with t_cap; * frac[i] (binpack); min with 1 for
//          an exclusion class; min with node_max_tasks - cnt of the node for
//          a class with pods (the pod check); floor if feas else 0, then at
//          least 1 if feas; int32
//   ccap[j]        the prefix sum of cap along the row, saturated at t_cap
//                  (an exact int64 sum, clamped: equal to the reference's
//                  saturating int32 scan for these non-negative terms)
//   g_start[j]     the start of j's equal-score group: the last k <= j with
//                  k == 0 or score[k] != score[k-1], compared as floats
//                  (-0.0 == +0.0, -inf == -inf: one group)
//   g_size[j]      the next start after j (or W) minus g_start[j]
//   ccap_before[j] ccap[g_start[j] - 1], or 0 at g_start 0
//
// Design: a CTA a row, walking the row in chunks of blockDim x 4 positions
// (blockDim 32-512 by W). The forward sweep computes each position's cap
// (the [rows, W, R] gather of idle is never built: a thread reads its
// node's row), a block scan of the sums carried across chunks, then a
// block max-scan of the group keys (start << 32 | the exclusive prefix at
// the start): the last start at or before a position and its ccap_before.
// The backward sweep, chunks from the last, threads mapped to positions in
// descending order, carries the first start after each position (a block
// min-scan): g_end, and g_size = g_end - g_start.
//
// Bound: bytes (order and score read, the idle and pod-room rows of each
// position's node gathered, four int32 written a position); a row's chunks
// are a chain of block scans, so at the cover's width (W = N) the walk is
// bound by their latency on one SM a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_scan.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct WalkArgs {
  const int32_t* order;      // [rows, W] node of each position
  const void* score;         // [rows, W] F, descending
  const void* req;           // [rows, R] F
  const int32_t* exl;        // [rows] exclusion group (F_EXCL)
  const uint8_t* has_pod;    // [rows] (F_POD)
  const void* frac;          // [rows] F, binpack demand share (F_BINPACK)
  const void* idle;          // [N, R] F
  const int32_t* cnt;        // [N]
  const int32_t* nmax;       // [N]
  const void* eps;           // [R] F
  int32_t* ccap;             // [rows, W]
  int32_t* g_start;          // [rows, W]
  int32_t* g_size;           // [rows, W]
  int32_t* ccap_before;      // [rows, W]
  int rows, W, N, R, t_cap, flags;
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kItems = 4;
constexpr int kMaxR = 8;

enum { F_BINPACK = 1, F_EXCL = 2, F_POD = 4 };

template <typename F>
__device__ __forceinline__ F fmin_(F a, F b) { return b < a ? b : a; }

template <typename F>
__global__ void __launch_bounds__(kMaxThreads) cap_walk_kernel(WalkArgs a) {
  __shared__ long long sw_sum[32];
  __shared__ unsigned long long sw_key[32];
  __shared__ int sw_min[32];
  const int row = blockIdx.x;
  const int W = a.W, R = a.R;
  const int C = blockDim.x * kItems;
  const size_t rbase = (size_t)row * W;
  const F* score = (const F*)a.score + rbase;
  const int32_t* order = a.order + rbase;
  const F* idle = (const F*)a.idle;
  const F* eps = (const F*)a.eps;
  // the row's constants
  F rq[kMaxR], sr[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    rq[r] = r < R ? ((const F*)a.req)[(size_t)row * R + r] : F(0);
    sr[r] = r < R ? (rq[r] > eps[r] ? rq[r] : eps[r]) : F(1);  // max(req, eps)
  }
  const F big = (F)a.t_cap;
  const bool binpack = a.flags & F_BINPACK;
  const F fr = binpack ? ((const F*)a.frac)[row] : F(1);
  const bool excl = (a.flags & F_EXCL) && a.exl[row] >= 0;
  const bool pod = (a.flags & F_POD) && a.has_pod[row];
  const long long tcap = a.t_cap;

  // -- forward: ccap, g_start, ccap_before --------------------------------
  long long run = 0;             // the prefix sum before this chunk
  unsigned long long gkey = 0;   // the last group key before this chunk
  for (int base = 0; base < W; base += C) {
    int capv[kItems];
    bool st[kItems];
    long long loc = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = base + threadIdx.x * kItems + k;
      capv[k] = 0;
      st[k] = false;
      if (pos < W) {
        const F s = score[pos];
        st[k] = pos == 0 || s != score[pos - 1];
        const bool feas = s > F(-INFINITY);
        const int node = order[pos];
        F cap = F(INFINITY);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R && rq[r] > F(0)) cap = fmin_(cap, idle[(size_t)node * R + r] / sr[r]);
        cap = isinf(cap) ? big : cap;
        cap = fmin_(cap, big);
        if (binpack) cap = cap * fr;
        if (excl) cap = fmin_(cap, F(1));
        if (pod) cap = fmin_(cap, (F)(int32_t)((uint32_t)a.nmax[node] - (uint32_t)a.cnt[node]));
        cap = feas ? floor(cap) : F(0);
        cap = feas ? (cap < F(1) ? F(1) : cap) : cap;
        capv[k] = (int)cap;
      }
      loc += capv[k];
    }
    long long tot;
    const long long p = run + bscan::exclusive(loc, 0LL, bscan::Sum(), sw_sum, &tot);
    // the group key of this thread's last start
    unsigned long long lk = 0;
    long long q = p;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = base + threadIdx.x * kItems + k;
      if (st[k]) lk = ((unsigned long long)pos << 32) | (unsigned long long)(q < tcap ? q : tcap);
      q += capv[k];
    }
    unsigned long long ktot;
    const unsigned long long kex = bscan::exclusive(lk, 0ull, bscan::Max(), sw_key, &ktot);
    unsigned long long g = kex > gkey ? kex : gkey;
    q = p;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = base + threadIdx.x * kItems + k;
      if (pos < W) {
        if (st[k]) g = ((unsigned long long)pos << 32) | (unsigned long long)(q < tcap ? q : tcap);
        q += capv[k];
        a.ccap[rbase + pos] = (int32_t)(q < tcap ? q : tcap);
        a.g_start[rbase + pos] = (int32_t)(g >> 32);
        a.ccap_before[rbase + pos] = (int32_t)(g & 0xffffffffull);
      }
    }
    run += tot;
    gkey = ktot > gkey ? ktot : gkey;
  }
  __syncthreads();  // this row's g_start, written above, visible to the block

  // -- backward: g_end, g_size --------------------------------------------
  int nxt = W;  // the first start at or after the chunk's end
  const int n_chunks = (W + C - 1) / C;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int top = c * C + C - 1;
    bool st[kItems];
    int lmin = W;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = top - (threadIdx.x * kItems + k);
      st[k] = pos < W && (pos == 0 || score[pos] != score[pos - 1]);
      if (st[k]) lmin = pos;
    }
    int tot;
    const int ex = bscan::exclusive(lmin, W, bscan::Min(), sw_min, &tot);
    int after = ex < nxt ? ex : nxt;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = top - (threadIdx.x * kItems + k);
      if (pos < W) a.g_size[rbase + pos] = after - a.g_start[rbase + pos];
      if (st[k]) after = pos;
    }
    nxt = tot < nxt ? tot : nxt;
  }
}

int threads_for(int W) {
  int t = ((W + kItems - 1) / kItems + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename F>
int launch(const WalkArgs* a, cudaStream_t s) {
  if (a->rows <= 0 || a->W <= 0 || a->R <= 0 || a->R > kMaxR || a->t_cap < 0)
    return (int)cudaErrorInvalidValue;
  cap_walk_kernel<F><<<a->rows, threads_for(a->W), 0, s>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cap_walk_f32(const WalkArgs* a, cudaStream_t s) { return launch<float>(a, s); }
extern "C" int cap_walk_f64(const WalkArgs* a, cudaStream_t s) { return launch<double>(a, s); }
