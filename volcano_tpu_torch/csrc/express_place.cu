// K14 express_place: one express batch — initial scores, the per-task
// candidate window, the sequential walk with fresh in-window rescoring and
// the coverage proof, the full-width fallback and the all-or-nothing gang
// strip — hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/express/place.py:94 `solve_express` (one jitted
// XLA program: fused_scores over [tb, N], lax.top_k, a fori_loop over the
// tasks with lax.cond's full-width fallback, the strip, one packed int32
// result). Plain version: volcano_tpu_torch/express/place.py
// solve_express_plain.
//
// Two launches on one stream:
//   1. window_kernel (only when window_k > 0): a cluster of C CTAs a task
//      row (C = 1..8, as K2 chooses it). A pad row's cluster returns before
//      its first barrier. Each CTA scores its slice of the node axis once —
//      the row's masked initial scores (fused_score, -inf off the ok
//      column) as order keys into shared memory, or into a global scratch
//      slice when the slice does not fit — and the cluster runs K2's radix
//      select on them (topk_select.cuh): the first W entries of the order
//      score desc under IEEE 754's total order (+0.0 ahead of -0.0), index
//      asc — an exact prefix of the order lax.top_k gives.
//   2. walk_kernel: a cluster of up to 16 CTAs, CTA r owning a slice of the
//      node axis. The lane's standing tensors are the next batch's input and
//      are never written; the walked changes live in an overlay that every
//      CTA keeps the same: the touched nodes' idle and count in shared
//      memory, found through a small hash table (at most tb entries), each
//      updated by the same float additions in step order as a copy of the
//      axis would be. The valid tasks are staged in shared memory at the
//      start. A task step:
//      - window (W > 0): each CTA rescores the task's W columns, a column a
//        thread (fit against the walked state, fresh score; a thread's
//        column and its node's columns were loaded during the step before),
//        and takes the best in window order (shuffles in each warp, one
//        block barrier for the warps' bests); covered when that fresh best
//        is strictly above the window's last initial score. Every CTA
//        reaches the same answer, so a covered step crosses no cluster
//        barrier;
//      - otherwise (uncovered, or window_k 0) the full-width sweep: each CTA
//        its slice, a block reduction, its best (and that node's fit)
//        stored into every CTA's shared memory through distributed shared
//        memory (double-buffered, so one cluster barrier a sweep), then in
//        every warp a lane a CTA and shuffles give the cluster's: the
//        lowest node index
//        among the maxima (all -inf: node 0, feasible iff node 0 fits, as
//        jnp.argmax and fit[node] read); it counts a full sweep;
//      - the placement: thread 0 of every CTA adds it to the overlay once
//        the step's reads are done, then a block barrier.
//      After the walk CTA 0 strips every job placed short of its need and
//      writes the packed [tb + 2] result.
//
// Rounding: scores are scorefn::fused_score (score_common.cuh) with
// nodeorder only, a zero affinity row and weight 0 — the same function for
// the initial and every fresh score, so the coverage proof's monotonicity
// holds bit for bit; built with --fmad=false, fma() where XLA contracts.
//
// Bound: operations of the initial scores (valid tasks x N x ~45) and
// bytes of the node columns, both under a microsecond at cfg5; the walk is
// tb dependent steps, so step latency bounds it: a covered step is one
// column's score a thread and a block barrier, an uncovered one also a
// slice sweep and a cluster barrier.
//
// Built with -DK14_PROFILE, PROF(k) marks add the walk's CTA 0 thread 0's
// clock between marks to phase k's counter, PROF_UNIT() counts its valid
// steps (in shared memory, copied out at the walk's end), and globaltimer
// marks bound the window launch (its first CTA's
// start, its last CTA's end) and the walk
// (volcano_tpu_torch/bench/kernel_profile.py reads them); otherwise they
// compile to nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "order_key.cuh"
#include "score_common.cuh"
#include "topk_select.cuh"

#ifdef K14_PROFILE
constexpr int kProfPhases = 5;
// the walk's phases' cycles at its thread 0, then the valid steps: kept in
// shared memory while the kernel runs (a mark costs no global round trip),
// copied out at its end
__device__ long long k14_prof_t[kProfPhases + 1];
__shared__ long long k14_prof_s[kProfPhases + 1];
__shared__ long long k14_prof_last;
// globaltimer ns: first window block's start, last window block's end, the
// walk's start and end
__device__ unsigned long long k14_prof_span[4];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(k)                                                  \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      const long long now_ = clock64();                          \
      k14_prof_s[k] += now_ - k14_prof_last;                     \
      k14_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNIT()                                              \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) k14_prof_s[kProfPhases] += 1; \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k14_prof_s[k_] = 0; \
      k14_prof_last = clock64();                                 \
    }                                                            \
  } while (0)
#define PROF_END()                                               \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0)                     \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k14_prof_t[k_] = k14_prof_s[k_]; \
  } while (0)
#define PROF_SPAN_MIN(i) \
  do { if (threadIdx.x == 0) atomicMin(&k14_prof_span[i], gtime()); } while (0)
#define PROF_SPAN_MAX(i)                                         \
  do {                                                           \
    __syncthreads();                                             \
    if (threadIdx.x == 0) atomicMax(&k14_prof_span[i], gtime()); \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNIT() do {} while (0)
#define PROF_START() do {} while (0)
#define PROF_END() do {} while (0)
#define PROF_SPAN_MIN(i) do {} while (0)
#define PROF_SPAN_MAX(i) do {} while (0)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kMaxWalkCluster = 16;
constexpr int kWalkSlice = 640;                       // nodes a walk CTA aims at
constexpr int kMaxTb = 1024;
constexpr int kHash = 2 * kMaxTb;                     // overlay slots, load <= 1/2
constexpr unsigned kFull = 0xffffffffu;
constexpr double kMinMilliCpu = 10.0;                 // resource.MIN_MILLI_CPU
constexpr double kMinMemory = 10.0 * 1024 * 1024;     // resource.MIN_MEMORY

// the walk's argmax order (value desc, index asc): +0.0 and -0.0 tie, as
// the reference's argmax compares them
template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// a node's static columns and its idle/count as the lane's tensors hold
// them (the walk's overlay replaces the latter where it touched the node)
template <typename T>
struct Node {
  T i0, i1, a0, a1;
  int cn, mt;
  bool ok;
};

template <typename T>
__device__ __forceinline__ Node<T> load_node(int c, const T* __restrict__ idle,
                                             const T* __restrict__ alloc,
                                             const int32_t* __restrict__ cnt,
                                             const uint8_t* __restrict__ ok,
                                             const int32_t* __restrict__ maxt) {
  Node<T> nd;
  nd.i0 = idle[2 * c];
  nd.i1 = idle[2 * c + 1];
  nd.a0 = alloc[2 * c];
  nd.a1 = alloc[2 * c + 1];
  nd.cn = cnt[c];
  nd.mt = maxt[c];
  nd.ok = ok[c] != 0;
  return nd;
}

// the task's fresh score on a node at idle (i0, i1)
template <typename T>
__device__ __forceinline__ T score_at(const T* rq, T nzc, T nzm, T i0, T i1,
                                      T a0, T a1, const T* w4) {
  const T a[2] = {a0, a1};
  const T used_c[2] = {a0 - i0, a1 - i1};
  return scorefn::fused_score<T>(2, rq, nzc, nzm, used_c, a, T(0), w4, w4,
                                 true, false);
}

// fit of the task's init request on a node: epsilon-less-than per dim, the
// static ok column, and the pod cap
template <typename T>
__device__ __forceinline__ bool fit_at(const T* irq, const Node<T>& nd,
                                       bool has_pod, int check_pod) {
  bool f = (irq[0] < nd.i0 + T(kMinMilliCpu)) && (irq[1] < nd.i1 + T(kMinMemory)) && nd.ok;
  if (check_pod) f = f && ((nd.cn < nd.mt) || !has_pod);
  return f;
}

// ---------------------------------------------------------------------------
// 1. the window
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(topk::kThreads)
window_kernel(int N, int W, const T* __restrict__ idle,
              const T* __restrict__ alloc,
              const uint8_t* __restrict__ ok,
              const T* __restrict__ req,
              const T* __restrict__ nzc,
              const T* __restrict__ nzm,
              const uint8_t* __restrict__ valid,
              const T* __restrict__ weights,
              typename topk::Key<T>::U* __restrict__ gkeys,
              T* __restrict__ top_s,
              int32_t* __restrict__ top_i,
              uint64_t* __restrict__ list_hi,
              uint32_t* __restrict__ list_lo) {
  using U = typename topk::Key<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int t = blockIdx.x / C;
  if (!valid[t]) return;  // the whole cluster: a pad row's window is never read
  PROF_SPAN_MIN(0);
  const int chunk = (N + C - 1) / C;
  const int lo = min(r * chunk, N), hi = min(lo + chunk, N);
  U* slice = gkeys != nullptr ? gkeys + (size_t)blockIdx.x * chunk
                              : reinterpret_cast<U*>(smem);
  const T w4[4] = {weights[0], weights[1], T(0), T(0)};
  const T rq[2] = {req[2 * t], req[2 * t + 1]};
  const T zc = nzc[t], zm = nzm[t];
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    T s = T(-INFINITY);
    if (ok[i])
      s = score_at<T>(rq, zc, zm, idle[2 * i], idle[2 * i + 1], alloc[2 * i],
                      alloc[2 * i + 1], w4);
    slice[i - lo] = okey::ord(s);
  }
  __syncthreads();
  topk::cluster_select<T>(cluster, lo, hi, W, [=](int i) { return slice[i - lo]; },
                          top_s + (size_t)t * W, top_i + (size_t)t * W,
                          list_hi + (size_t)t * W, list_lo + (size_t)t * W);
  PROF_SPAN_MAX(1);
}

// ---------------------------------------------------------------------------
// 2. the walk
// ---------------------------------------------------------------------------

template <typename T>
struct Overlay {
  int key[kHash];     // node, -1 empty
  int16_t slot[kHash];
  T idle[kMaxTb][2];
  int cnt[kMaxTb];
  int n;
};

__device__ __forceinline__ int hash_of(int c) {
  return (int)(((unsigned)c * 2654435761u) >> 21) & (kHash - 1);
}

// the overlay slot of node c, or -1 when the walk has not touched it
template <typename T>
__device__ __forceinline__ int find(const Overlay<T>& ov, int c) {
  for (int h = hash_of(c);; h = (h + 1) & (kHash - 1)) {
    const int k = ov.key[h];
    if (k == c) return ov.slot[h];
    if (k < 0) return -1;
  }
}

// node c's walked idle and count over the lane's
template <typename T>
__device__ __forceinline__ void walked(const Overlay<T>& ov, int c, Node<T>& nd) {
  const int s = find(ov, c);
  if (s >= 0) {
    nd.i0 = ov.idle[s][0];
    nd.i1 = ov.idle[s][1];
    nd.cn = ov.cnt[s];
  }
}

// a valid task of the batch, staged in shared memory at the walk's start
template <typename T>
struct Task {
  T rq[2], irq[2], zc, zm;
  int t, hp;
};

// the warp's best (key desc, index asc) at lane 0, with a payload
template <typename T>
__device__ __forceinline__ void warp_best(T& k, int& i, int& p) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ok = __shfl_down_sync(kFull, k, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    const int op = __shfl_down_sync(kFull, p, off);
    if (before(ok, oi, k, i)) { k = ok; i = oi; p = op; }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(int N, int tb, int jb, int W, int check_pod,
            const T* __restrict__ idle,
            const T* __restrict__ alloc,
            const int32_t* __restrict__ cnt,
            const uint8_t* __restrict__ ok,
            const int32_t* __restrict__ maxt,
            const T* __restrict__ initreq,
            const T* __restrict__ req,
            const T* __restrict__ nzc,
            const T* __restrict__ nzm,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ task_job,
            const uint8_t* __restrict__ has_pod,
            const int32_t* __restrict__ job_need,
            const T* __restrict__ weights,
            const T* __restrict__ top_s,
            const int32_t* __restrict__ top_i,
            int32_t* __restrict__ job_placed,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Task<T>* tasks = reinterpret_cast<Task<T>*>(smem);   // [the valid tasks]
  __shared__ Overlay<T> ov;
  __shared__ int assign[kMaxTb];
  __shared__ int warp_tot[kWalkWarps];
  __shared__ T wk[kWalkWarps];      // a sweep's warp bests
  __shared__ int wi[kWalkWarps];
  __shared__ int wf[kWalkWarps];
  __shared__ T win_k[kWalkWarps];   // a window step's warp bests
  __shared__ int win_i[kWalkWarps];
  __shared__ int win_c[kWalkWarps];
  __shared__ int win_any[kWalkWarps];
  // every CTA's sweep best (and its fit), written by that CTA,
  // double-buffered
  __shared__ T all_k[2][kMaxWalkCluster];
  __shared__ int all_i[2][kMaxWalkCluster];
  __shared__ int all_f[2][kMaxWalkCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (N + C - 1) / C;
  const int lo = min(r * chunk, N), hi = min(lo + chunk, N);
  if (r == 0) PROF_SPAN_MIN(2);
  PROF_START();
  for (int h = tid; h < kHash; h += kWalkThreads) ov.key[h] = -1;
  for (int t = tid; t < tb; t += kWalkThreads) assign[t] = -1;
  if (r == 0)
    for (int j = tid; j < jb; j += kWalkThreads) job_placed[j] = 0;
  if (tid == 0) ov.n = 0;
  // the valid tasks in order, staged once
  int steps = 0;
  for (int base = 0; base < tb; base += kWalkThreads) {
    const int t = base + tid;
    const bool v = t < tb && valid[t];
    const unsigned b = __ballot_sync(kFull, v);
    if (lane == 0) warp_tot[warp] = __popc(b);
    __syncthreads();
    int at = steps, total = 0;
    for (int q = 0; q < kWalkWarps; ++q) {
      at += q < warp ? warp_tot[q] : 0;
      total += warp_tot[q];
    }
    if (v) {
      Task<T>& tk = tasks[at + __popc(b & ((1u << lane) - 1u))];
      tk.rq[0] = req[2 * t];
      tk.rq[1] = req[2 * t + 1];
      tk.irq[0] = initreq[2 * t];
      tk.irq[1] = initreq[2 * t + 1];
      tk.zc = nzc[t];
      tk.zm = nzm[t];
      tk.t = t;
      tk.hp = has_pod[t] != 0;
    }
    steps += total;
    __syncthreads();
  }
  PROF(0);
  const T w4[4] = {weights[0], weights[1], T(0), T(0)};
  // a window column a thread, its node's columns loaded a step ahead
  const bool has_col = W > 0 && tid < W;
  int col_c = 0;
  Node<T> col{};
  T col_last = T(0);   // the window's last initial score (every thread)
  if (W > 0 && steps > 0) {
    const int t0 = tasks[0].t;
    col_last = top_s[(size_t)t0 * W + W - 1];
    if (has_col) {
      col_c = top_i[(size_t)t0 * W + tid];
      col = load_node<T>(col_c, idle, alloc, cnt, ok, maxt);
    }
  }
  int fulls = 0, buf = 0;
  for (int k = 0; k < steps; ++k) {
    PROF_UNIT();
    const Task<T> tk = tasks[k];
    const int t = tk.t;
    const bool hp = tk.hp != 0;
    int node = 0;
    bool feas = false, covered = false;
    if (W > 0) {
      // the window's columns over the CTA's threads, each warp's best by
      // shuffles, the CTA's through shared memory: every CTA of the cluster
      // reaches the same answer
      Node<T> cur = col;
      const int cur_c = col_c;
      const T last = col_last;
      if (k + 1 < steps) {   // the next step's columns, in flight meanwhile
        const int tn = tasks[k + 1].t;
        col_last = top_s[(size_t)tn * W + W - 1];
        if (has_col) {
          col_c = top_i[(size_t)tn * W + tid];
          col = load_node<T>(col_c, idle, alloc, cnt, ok, maxt);
        }
      }
      T bk = T(-INFINITY);
      int bi = INT32_MAX, bc = 0;
      bool any = false;
      for (int j = tid; j < W; j += kWalkThreads) {
        int c = cur_c;
        Node<T> nd = cur;
        if (j != tid) {
          c = top_i[(size_t)t * W + j];
          nd = load_node<T>(c, idle, alloc, cnt, ok, maxt);
        }
        walked(ov, c, nd);
        const bool f = fit_at<T>(tk.irq, nd, hp, check_pod);
        const T s = f ? score_at<T>(tk.rq, tk.zc, tk.zm, nd.i0, nd.i1, nd.a0, nd.a1, w4)
                      : T(-INFINITY);
        any = any || f;
        if (before(s, j, bk, bi)) { bk = s; bi = j; bc = c; }
      }
      warp_best(bk, bi, bc);
      any = __any_sync(kFull, any);
      if (lane == 0) { win_k[warp] = bk; win_i[warp] = bi; win_c[warp] = bc; win_any[warp] = any; }
      __syncthreads();
      bk = T(-INFINITY);
      bi = INT32_MAX;
      any = false;
      for (int q = 0; q < kWalkWarps; ++q) {
        if (before(win_k[q], win_i[q], bk, bi)) { bk = win_k[q]; bi = win_i[q]; bc = win_c[q]; }
        any = any || win_any[q];
      }
      // strict: an equal fresh best may lose to a lower out-of-window index
      covered = any && (bk > last);
      if (covered) {
        node = bc;
        feas = true;
      }
      PROF(1);
    }
    if (!covered) {
      // the full-width sweep: the CTA's slice, its best (with its fit), the
      // cluster's from the CTAs' bests, a lane a CTA
      T bk = T(-INFINITY);
      int bi = INT32_MAX, bf = 0;
      for (int c = lo + tid; c < hi; c += kWalkThreads) {
        Node<T> nd = load_node<T>(c, idle, alloc, cnt, ok, maxt);
        walked(ov, c, nd);
        const bool f = fit_at<T>(tk.irq, nd, hp, check_pod);
        const T s = f ? score_at<T>(tk.rq, tk.zc, tk.zm, nd.i0, nd.i1, nd.a0, nd.a1, w4)
                      : T(-INFINITY);
        if (before(s, c, bk, bi)) { bk = s; bi = c; bf = f; }
      }
      warp_best(bk, bi, bf);
      if (lane == 0) { wk[warp] = bk; wi[warp] = bi; wf[warp] = bf; }
      __syncthreads();
      if (warp == 0) {
        bk = lane < kWalkWarps ? wk[lane] : T(-INFINITY);
        bi = lane < kWalkWarps ? wi[lane] : INT32_MAX;
        bf = lane < kWalkWarps ? wf[lane] : 0;
        warp_best(bk, bi, bf);
        bk = __shfl_sync(kFull, bk, 0);
        bi = __shfl_sync(kFull, bi, 0);
        bf = __shfl_sync(kFull, bf, 0);
        if (lane < C) {   // the CTA's best into every CTA, lane q to CTA q
          *cluster.map_shared_rank(&all_k[buf][r], lane) = bk;
          *cluster.map_shared_rank(&all_i[buf][r], lane) = bi;
          *cluster.map_shared_rank(&all_f[buf][r], lane) = bf;
        }
      }
      cluster.sync();
      bk = lane < C ? all_k[buf][lane] : T(-INFINITY);
      bi = lane < C ? all_i[buf][lane] : INT32_MAX;
      bf = lane < C ? all_f[buf][lane] : 0;
      warp_best(bk, bi, bf);
      bi = __shfl_sync(kFull, bi, 0);
      bf = __shfl_sync(kFull, bf, 0);
      buf ^= 1;
      if (bi < N) {
        node = bi;
        feas = bf != 0;
      } else {   // no node at all: jnp.argmax's 0
        Node<T> nd = load_node<T>(0, idle, alloc, cnt, ok, maxt);
        walked(ov, 0, nd);
        feas = fit_at<T>(tk.irq, nd, hp, check_pod);
      }
      fulls += 1;
      PROF(2);
    }
    if (feas) {  // cluster-uniform
      // every read of this step's state is done (a covered step's reads end
      // at the window's barrier)
      if (!covered) __syncthreads();
      if (tid == 0) {
        int s = find(ov, node);
        if (s < 0) {
          s = ov.n++;
          int h = hash_of(node);
          while (ov.key[h] >= 0) h = (h + 1) & (kHash - 1);
          ov.key[h] = node;
          ov.slot[h] = (int16_t)s;
          ov.idle[s][0] = idle[2 * node];
          ov.idle[s][1] = idle[2 * node + 1];
          ov.cnt[s] = cnt[node];
        }
        ov.idle[s][0] = ov.idle[s][0] + (-tk.rq[0]);
        ov.idle[s][1] = ov.idle[s][1] + (-tk.rq[1]);
        ov.cnt[s] += 1;
        assign[t] = node;
      }
      __syncthreads();
      PROF(3);
    }
  }
  // no CTA leaves while a peer may still read its bests
  cluster.sync();
  if (r == 0) {
    // all-or-nothing per job: a job's placements as the walk left them
    for (int t = tid; t < tb; t += kWalkThreads)
      if (assign[t] >= 0) atomicAdd(&job_placed[task_job[t]], 1);
    __syncthreads();
    int placed = 0;
    for (int t0 = 0; t0 < tb; t0 += kWalkThreads) {
      const int t = t0 + tid;
      int a = -1;
      if (t < tb) {
        a = assign[t];
        const int j = task_job[t];
        if (a >= 0 && __ldcg(job_placed + j) < job_need[j]) a = -1;
        out[t] = a;
      }
      placed += __syncthreads_count(a >= 0);
    }
    if (tid == 0) {
      out[tb] = fulls;
      out[tb + 1] = placed;
    }
    PROF(4);
    PROF_END();
    PROF_SPAN_MAX(3);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the window's CTAs a row: K2's rule (window_topk.cu cluster_size)
int window_cluster(int tb, int N) {
  int c = 1;
  while (c < topk::kMaxCluster && (long)tb * c < sm_count() &&
         (N + 2 * c - 1) / (2 * c) >= 1024)
    c <<= 1;
  return c;
}

// the walk's CTAs: doubled while a slice holds more than kWalkSlice nodes
int walk_cluster(int N) {
  int c = 1;
  while (c < kMaxWalkCluster && (N + c - 1) / c > kWalkSlice) c <<= 1;
  return c;
}

// the largest dynamic shared memory a window CTA may take; both kernels'
// attributes are set at the first call (once a type)
template <typename T>
int window_max_dyn() {
  static std::mutex mu;
  static int max_dyn = -1;
  std::lock_guard<std::mutex> lock(mu);
  if (max_dyn < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa, fw;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, window_kernel<T>) != cudaSuccess ||
        cudaFuncGetAttributes(&fw, walk_kernel<T>) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    const int m = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, m) != cudaSuccess ||
        cudaFuncSetAttribute(walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fw.sharedSizeBytes) != cudaSuccess ||
        cudaFuncSetAttribute(walk_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    max_dyn = m;
  }
  return max_dyn;
}

// bytes of one window CTA's key slice
template <typename T>
size_t slice_bytes(int tb, int N) {
  const int c = window_cluster(tb, N);
  return (size_t)((N + c - 1) / c) * sizeof(typename topk::Key<T>::U);
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, int cluster, size_t smem,
                                  cudaLaunchAttribute* at, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(int N, int tb, int jb, int W, int check_pod, const void* idle,
           const void* alloc, const void* cnt, const void* ok, const void* maxt,
           const void* initreq, const void* req, const void* nzc,
           const void* nzm, const void* valid, const void* task_job,
           const void* has_pod, const void* job_need, const void* weights,
           void* gkeys, void* top_s, void* top_i, void* list_hi, void* list_lo,
           void* job_placed, void* out, void* stream) {
  using U = typename topk::Key<T>::U;
  if (N <= 0 || tb <= 0 || tb > kMaxTb || jb <= 0 || W < 0 || W > N)
    return (int)cudaErrorInvalidValue;
  const int max_dyn = window_max_dyn<T>();
  if (max_dyn < 0) return (int)cudaErrorInvalidConfiguration;
#ifdef K14_PROFILE
  const unsigned long long span0[4] = {~0ull, 0ull, ~0ull, 0ull};
  cudaMemcpyToSymbolAsync(k14_prof_span, span0, sizeof(span0), 0,
                          cudaMemcpyHostToDevice, (cudaStream_t)stream);
#endif
  cudaLaunchAttribute at[1];
  if (W > 0) {
    const int c = window_cluster(tb, N);
    const size_t bytes = slice_bytes<T>(tb, N);
    size_t dyn = 0;
    if (bytes <= (size_t)max_dyn) {
      dyn = bytes;
      gkeys = nullptr;
    } else if (gkeys == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t cfg = cluster_config(tb * c, topk::kThreads, c, dyn, at, stream);
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, window_kernel<T>, N, W, (const T*)idle, (const T*)alloc,
        (const uint8_t*)ok, (const T*)req, (const T*)nzc, (const T*)nzm,
        (const uint8_t*)valid, (const T*)weights, (U*)gkeys, (T*)top_s,
        (int32_t*)top_i, (uint64_t*)list_hi, (uint32_t*)list_lo);
    if (e != cudaSuccess) return (int)e;
  }
  const int cw = walk_cluster(N);
  cudaLaunchConfig_t cfg = cluster_config(cw, kWalkThreads, cw, (size_t)tb * sizeof(Task<T>),
                                          at, stream);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, walk_kernel<T>, N, tb, jb, W, check_pod, (const T*)idle,
      (const T*)alloc, (const int32_t*)cnt, (const uint8_t*)ok,
      (const int32_t*)maxt, (const T*)initreq, (const T*)req, (const T*)nzc,
      (const T*)nzm, (const uint8_t*)valid, (const int32_t*)task_job,
      (const uint8_t*)has_pod, (const int32_t*)job_need, (const T*)weights,
      (const T*)top_s, (const int32_t*)top_i, (int32_t*)job_placed,
      (int32_t*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan of a shape, in `out`: [bytes of global key scratch the
// window needs (0 when a CTA's slice fits shared memory, or with no
// window), the window's CTAs a row, the walk's CTAs]. Returns 0, or the
// CUDA error of setting the kernels' attributes.
extern "C" int express_place_plan(int N, int tb, int W, int is_f64, long long* out) {
  const int max_dyn = is_f64 ? window_max_dyn<double>() : window_max_dyn<float>();
  if (max_dyn < 0) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = is_f64 ? slice_bytes<double>(tb, N) : slice_bytes<float>(tb, N);
  const int c = window_cluster(tb, N);
  out[0] = (W > 0 && bytes > (size_t)max_dyn) ? (long long)bytes * tb * c : 0;
  out[1] = W > 0 ? c : 0;
  out[2] = walk_cluster(N);
  return 0;
}

#define EXPRESS_ARGS                                                         \
  int N, int tb, int jb, int W, int check_pod, const void *idle,             \
      const void *alloc, const void *cnt, const void *ok, const void *maxt,  \
      const void *initreq, const void *req, const void *nzc,                 \
      const void *nzm, const void *valid, const void *task_job,              \
      const void *has_pod, const void *job_need, const void *weights,        \
      void *gkeys, void *top_s, void *top_i, void *list_hi, void *list_lo,   \
      void *job_placed, void *out, void *stream
#define EXPRESS_CALL                                                         \
  N, tb, jb, W, check_pod, idle, alloc, cnt, ok, maxt, initreq, req, nzc,    \
      nzm, valid, task_job, has_pod, job_need, weights, gkeys, top_s, top_i, \
      list_hi, list_lo, job_placed, out, stream

extern "C" int express_place_f32(EXPRESS_ARGS) { return launch<float>(EXPRESS_CALL); }
extern "C" int express_place_f64(EXPRESS_ARGS) { return launch<double>(EXPRESS_CALL); }

#ifdef K14_PROFILE
// the walk's phases' cycles and valid steps, then the four globaltimer
// marks (ns) of the last launch
extern "C" int k14_profile_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k14_prof_t, sizeof(k14_prof_t));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + kProfPhases + 1, k14_prof_span,
                                   sizeof(k14_prof_span));
}
#endif
