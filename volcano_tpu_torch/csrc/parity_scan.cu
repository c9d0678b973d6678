// K15 parity_scan: the whole allocate session as the sequential parity
// scan — visit by visit, namespace -> queue -> job by lexicographic argmin,
// then the job's tasks one at a time through the feasibility mask, the
// round-robin sampling window, the fused score and the arg-max, and the
// gang commit or an exact roll back — hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/kernels.py:389 `solve_allocate` (one jitted
// XLA program: a lax.while_loop over visits (`_make_visit` :310) around a
// lax.while_loop over a job's tasks (`_inner_task_loop` :250), with
// `_lex_argmin` :52 and `_sample_window` :92). Plain version:
// volcano_tpu_torch/ops/parity_kernels.py solve_allocate_plain.
//
// One launch a session, one block of 1024 threads. Thread 0 takes the
// control decisions and the scalar state updates; every N-wide and J-wide
// sweep is shared by the block. The carry (idle, used, cnt, the job, queue
// and namespace state, assign, rr) lives in device scratch the wrapper
// allocates; the inputs are never written. Output: int32 [T + 1], assign
// then the final round-robin index, read back in one fetch.
//
// Per visit: three lexicographic argmins (namespaces, queues, jobs). Each
// is one pass in which a thread keeps its best candidate under the
// comparator (key levels in order, then the lowest index) and one block
// reduction under the same comparator. For keys without NaN this is the
// reference's level-by-level "min, then keep the equal ones" with the
// lowest index left winning. Keys compare as doubles: a float key widens
// exactly, and so does an int32 key. The overused-queue purge is written
// back to q_in_ns on every branch (it is permanent).
//
// Per task step: the rotated node order starting at rr is walked in chunks
// of 1024 positions; a position is feasible when the node is real, its
// signature mask is set, every resource dim fits (req < idle + eps, scalar
// dims at or below MIN_MILLI_SCALAR skipped) and the pod cap allows it
// (unless the task has no pod). A block-wide inclusive count (ballot +
// popc, then the warp totals) gives c, the feasible count, and e, the real
// count; selected are the feasible positions with c <= num_to_find, scored
// with score_common.cuh's fused_score and reduced to the arg-max in
// ORIGINAL node order (score desc, node index asc). The walk stops at the
// chunk where c reaches num_to_find: later positions are never selected,
// and `processed` is e at that position (the reference's examined[kth]);
// without enough feasible nodes it is real_n. rr advances by processed
// modulo real_n on both the place and the infeasible branch.
//
// Roll back is exact: each placement logs the node's idle/used rows and
// cnt as they were before it, and a discarded visit restores them in
// reverse order (never by subtracting the request back: float sums are
// not reversible); assign is cleared over the visit's tasks and rr keeps
// its advance.
//
// Rounding: built with --fmad=false; the score is scorefn::fused_score,
// with fma() where XLA contracts; shares, idle/used updates and the
// placed-request sums are the reference's single adds and divides.
//
// Bound: the work is a chain of dependent steps (one a task, three
// argmins a visit), each a few block-wide syncs, so the kernel is bound by
// step latency on one SM, far above the bytes or operations the session
// needs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"

// The argument block, field for field the ctypes structure
// parity_kernels._Params: the enc inputs, the weights, the scratch, the
// output, then the sizes and the static spec.
struct ParityParams {
  const void *task_req, *task_initreq, *task_nz_cpu, *task_nz_mem, *task_sig,
      *task_has_pod, *node_idle, *node_used, *node_cnt, *node_alloc,
      *node_max_tasks, *node_real, *real_n, *sig_mask, *affinity_score, *eps,
      *is_scalar, *binpack_w, *job_task_start, *job_task_count, *job_queue,
      *job_ns, *job_priority, *job_min_available, *job_ready_base,
      *job_ready_threshold, *job_tie_rank, *job_alloc0, *job_active0,
      *queue_deserved, *queue_present, *queue_alloc0, *queue_tie_rank,
      *ns_alloc0, *ns_active0, *ns_rank, *ns_weight, *q_in_ns0, *drf_total,
      *drf_present;
  const void* weights;
  void *idle, *used, *cnt, *job_ptr, *job_placed, *job_alloc, *queue_alloc,
      *ns_alloc, *job_active, *ns_active, *q_in_ns, *undo_node, *undo_cnt,
      *undo_idle, *undo_used;
  void* out;
  int T, N, R, J, Q, S, G, rr0, num_to_find, n_job_keys, key0, key1, key2,
      use_drf_ns_order, use_prop_queue_order, use_prop_overused,
      check_pod_count, use_nodeorder, use_binpack;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR
constexpr unsigned kFull = 0xffffffffu;

// a lexicographic candidate: up to four key levels, then the index
// (idx < 0: no candidate)
struct Lex {
  double k[4];
  int idx;
};

__device__ __forceinline__ Lex lex_none() {
  Lex v;
#pragma unroll
  for (int i = 0; i < 4; ++i) v.k[i] = 0.0;
  v.idx = -1;
  return v;
}

__device__ __forceinline__ bool lex_less(const Lex& a, const Lex& b, int nk) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < nk) {
      if (a.k[i] < b.k[i]) return true;
      if (a.k[i] > b.k[i]) return false;
    }
  }
  return a.idx < b.idx;
}

__device__ __forceinline__ void lex_take_down(Lex& v, int off, int nk) {
  Lex o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.k[i] = __shfl_down_sync(kFull, v.k[i], off);
  o.idx = __shfl_down_sync(kFull, v.idx, off);
  if (lex_less(o, v, nk)) v = o;
}

// block-wide lexicographic minimum; every thread gets the winner
__device__ Lex block_lex_min(Lex v, int nk, Lex* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) lex_take_down(v, off, nk);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = sm[lane];  // kThreads / 32 == 32 warps, one a lane
    for (int off = 16; off > 0; off >>= 1) lex_take_down(v, off, nk);
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  Lex w = sm[0];
  __syncthreads();
  return w;
}

template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// block-wide best (score desc, index asc); every thread gets the winner
template <typename T>
__device__ void block_best(T& k, int& i, T* wk, int* wi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    T ok = __shfl_down_sync(kFull, k, off);
    int oi = __shfl_down_sync(kFull, i, off);
    if (before(ok, oi, k, i)) { k = ok; i = oi; }
  }
  if (lane == 0) { wk[warp] = k; wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    k = wk[lane];
    i = wi[lane];
    for (int off = 16; off > 0; off >>= 1) {
      T ok = __shfl_down_sync(kFull, k, off);
      int oi = __shfl_down_sync(kFull, i, off);
      if (before(ok, oi, k, i)) { k = ok; i = oi; }
    }
    if (lane == 0) { wk[0] = k; wi[0] = i; }
  }
  __syncthreads();
  k = wk[0];
  i = wi[0];
  __syncthreads();
}

// inclusive block counts of two flags in thread order; totals out
__device__ void block_count2(bool a, bool b, int& ca, int& cb, int& ta,
                             int& tb, int* wa, int* wb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned le = lane == 31 ? kFull : ((1u << (lane + 1)) - 1u);
  const unsigned ba = __ballot_sync(kFull, a), bb = __ballot_sync(kFull, b);
  ca = __popc(ba & le);
  cb = __popc(bb & le);
  if (lane == 0) { wa[warp] = __popc(ba); wb[warp] = __popc(bb); }
  __syncthreads();
  if (warp == 0) {
    int va = wa[lane], vb = wb[lane];
    for (int d = 1; d < 32; d <<= 1) {
      int ua = __shfl_up_sync(kFull, va, d), ub = __shfl_up_sync(kFull, vb, d);
      if (lane >= d) { va += ua; vb += ub; }
    }
    wa[lane] = va;
    wb[lane] = vb;
  }
  __syncthreads();
  if (warp > 0) { ca += wa[warp - 1]; cb += wb[warp - 1]; }
  ta = wa[kWarps - 1];
  tb = wb[kWarps - 1];
  __syncthreads();
}

// max_r alloc_r / total_r over present dims, share(l, 0) = 1 when l != 0,
// with initial 0 (volcano_tpu/ops/kernels.py _share)
template <typename T>
__device__ __forceinline__ T share(const T* alloc, const T* total,
                                   const uint8_t* present, int R) {
  T m = T(0);
  for (int r = 0; r < R; ++r) {
    if (!present[r]) continue;
    T s = total[r] > T(0) ? alloc[r] / total[r]
                          : (alloc[r] == T(0) ? T(0) : T(1));
    if (s > m) m = s;
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) parity_kernel(ParityParams p) {
  const T* task_req = (const T*)p.task_req;
  const T* task_initreq = (const T*)p.task_initreq;
  const T* task_nz_cpu = (const T*)p.task_nz_cpu;
  const T* task_nz_mem = (const T*)p.task_nz_mem;
  const int32_t* task_sig = (const int32_t*)p.task_sig;
  const uint8_t* task_has_pod = (const uint8_t*)p.task_has_pod;
  const T* node_alloc = (const T*)p.node_alloc;
  const int32_t* node_max_tasks = (const int32_t*)p.node_max_tasks;
  const uint8_t* node_real = (const uint8_t*)p.node_real;
  const uint8_t* sig_mask = (const uint8_t*)p.sig_mask;
  const T* aff = (const T*)p.affinity_score;
  const T* eps = (const T*)p.eps;
  const uint8_t* is_scalar = (const uint8_t*)p.is_scalar;
  const T* binpack_w = (const T*)p.binpack_w;
  const int32_t* job_task_start = (const int32_t*)p.job_task_start;
  const int32_t* job_task_count = (const int32_t*)p.job_task_count;
  const int32_t* job_queue = (const int32_t*)p.job_queue;
  const int32_t* job_ns = (const int32_t*)p.job_ns;
  const int32_t* job_priority = (const int32_t*)p.job_priority;
  const int32_t* job_min_available = (const int32_t*)p.job_min_available;
  const int32_t* job_ready_base = (const int32_t*)p.job_ready_base;
  const int32_t* job_ready_threshold = (const int32_t*)p.job_ready_threshold;
  const int32_t* job_tie_rank = (const int32_t*)p.job_tie_rank;
  const T* queue_deserved = (const T*)p.queue_deserved;
  const uint8_t* queue_present = (const uint8_t*)p.queue_present;
  const int32_t* queue_tie_rank = (const int32_t*)p.queue_tie_rank;
  const int32_t* ns_rank = (const int32_t*)p.ns_rank;
  const T* ns_weight = (const T*)p.ns_weight;
  const T* drf_total = (const T*)p.drf_total;
  const uint8_t* drf_present = (const uint8_t*)p.drf_present;
  const T* weights = (const T*)p.weights;

  T* idle = (T*)p.idle;
  T* used = (T*)p.used;
  int32_t* cnt = (int32_t*)p.cnt;
  int32_t* job_ptr = (int32_t*)p.job_ptr;
  int32_t* job_placed = (int32_t*)p.job_placed;
  T* job_alloc = (T*)p.job_alloc;
  T* queue_alloc = (T*)p.queue_alloc;
  T* ns_alloc = (T*)p.ns_alloc;
  uint8_t* job_active = (uint8_t*)p.job_active;
  uint8_t* ns_active = (uint8_t*)p.ns_active;
  uint8_t* q_in_ns = (uint8_t*)p.q_in_ns;
  int32_t* undo_node = (int32_t*)p.undo_node;
  int32_t* undo_cnt = (int32_t*)p.undo_cnt;
  T* undo_idle = (T*)p.undo_idle;
  T* undo_used = (T*)p.undo_used;
  int32_t* assign = (int32_t*)p.out;

  const int T_ = p.T, N = p.N, R = p.R, J = p.J, Q = p.Q, S = p.S;
  const int tid = threadIdx.x;
  const int real_n = *(const int32_t*)p.real_n;
  const int ntf = p.num_to_find;

  __shared__ Lex lex_sm[kWarps];
  __shared__ T best_k[kWarps];
  __shared__ int best_i[kWarps];
  __shared__ int cnt_a[kWarps], cnt_b[kWarps];
  __shared__ T s_preq[kMaxR];
  __shared__ int s_ptr, s_placed, s_broke, s_infeasible, s_rr, s_kth_e;

  // the carry starts as the encoded state
  for (int i = tid; i < N * R; i += kThreads) {
    idle[i] = ((const T*)p.node_idle)[i];
    used[i] = ((const T*)p.node_used)[i];
  }
  for (int i = tid; i < N; i += kThreads) cnt[i] = ((const int32_t*)p.node_cnt)[i];
  for (int j = tid; j < J; j += kThreads) {
    job_ptr[j] = job_task_start[j];
    job_placed[j] = 0;
    job_active[j] = ((const uint8_t*)p.job_active0)[j];
  }
  for (int i = tid; i < J * R; i += kThreads) job_alloc[i] = ((const T*)p.job_alloc0)[i];
  for (int i = tid; i < Q * R; i += kThreads) queue_alloc[i] = ((const T*)p.queue_alloc0)[i];
  for (int i = tid; i < S * R; i += kThreads) ns_alloc[i] = ((const T*)p.ns_alloc0)[i];
  for (int i = tid; i < S; i += kThreads) ns_active[i] = ((const uint8_t*)p.ns_active0)[i];
  for (int i = tid; i < S * Q; i += kThreads) q_in_ns[i] = ((const uint8_t*)p.q_in_ns0)[i];
  for (int t = tid; t < T_; t += kThreads) assign[t] = -1;
  if (tid == 0) s_rr = p.rr0;
  __syncthreads();

  // runaway backstop from the padded shapes; the real exit is the drain
  const long long max_visits = (long long)S + J + T_ + 8;
  long long visits = 0;  // block-uniform
  while (true) {
    bool any_ns = false;
    for (int s = tid; s < S; s += kThreads) any_ns = any_ns || ns_active[s];
    any_ns = __syncthreads_or(any_ns);
    if (!any_ns || visits >= max_visits) break;
    visits += 1;

    // 1. namespace: the weighted DRF share when enabled, then the rank
    const int nk_ns = p.use_drf_ns_order ? 2 : 1;
    Lex v = lex_none();
    for (int s = tid; s < S; s += kThreads) {
      if (!ns_active[s]) continue;
      Lex c;
      int k = 0;
      if (p.use_drf_ns_order) {
        T sh = share<T>(ns_alloc + (size_t)s * R, drf_total, drf_present, R);
        c.k[k++] = (double)(sh / ns_weight[s]);
      }
      c.k[k++] = (double)ns_rank[s];
      for (; k < 4; ++k) c.k[k] = 0.0;
      c.idx = s;
      if (lex_less(c, v, nk_ns)) v = c;
    }
    const int ns = block_lex_min(v, nk_ns, lex_sm).idx;

    // 2. queue: overused queues leave q_in_ns for good, then the
    // proportion share and the queue rank
    const int nk_q = p.use_prop_queue_order ? 2 : 1;
    v = lex_none();
    for (int q = tid; q < Q; q += kThreads) {
      bool in = q_in_ns[(size_t)ns * Q + q] != 0;
      if (in && p.use_prop_overused) {
        bool le_all = true;
        for (int r = 0; r < R; ++r) {
          T a = queue_alloc[(size_t)q * R + r];
          bool le = a < queue_deserved[(size_t)q * R + r] + eps[r];
          bool skip = is_scalar[r] && a <= T(kMinMilliScalar);
          le_all = le_all && (le || skip);
        }
        in = le_all;
      }
      q_in_ns[(size_t)ns * Q + q] = in ? 1 : 0;
      if (!in) continue;
      Lex c;
      int k = 0;
      if (p.use_prop_queue_order)
        c.k[k++] = (double)share<T>(queue_alloc + (size_t)q * R,
                                    queue_deserved + (size_t)q * R,
                                    queue_present + (size_t)q * R, R);
      c.k[k++] = (double)queue_tie_rank[q];
      for (; k < 4; ++k) c.k[k] = 0.0;
      c.idx = q;
      if (lex_less(c, v, nk_q)) v = c;
    }
    const int q = block_lex_min(v, nk_q, lex_sm).idx;

    // 3. job: the job-order keys in tier order, then the tie rank
    int j = -1;
    if (q >= 0) {
      const int nk_j = p.n_job_keys + 1;
      const int codes[3] = {p.key0, p.key1, p.key2};
      v = lex_none();
      for (int jj = tid; jj < J; jj += kThreads) {
        if (!job_active[jj] || job_queue[jj] != q || job_ns[jj] != ns) continue;
        Lex c;
        int k = 0;
        for (int l = 0; l < p.n_job_keys; ++l) {
          if (codes[l] == 0) {
            c.k[k++] = -(double)job_priority[jj];
          } else if (codes[l] == 1) {
            c.k[k++] = (job_ready_base[jj] + job_placed[jj]) >= job_min_available[jj]
                           ? 1.0 : 0.0;
          } else {
            c.k[k++] = (double)share<T>(job_alloc + (size_t)jj * R, drf_total,
                                        drf_present, R);
          }
        }
        c.k[k++] = (double)job_tie_rank[jj];
        for (; k < 4; ++k) c.k[k] = 0.0;
        c.idx = jj;
        if (lex_less(c, v, nk_j)) v = c;
      }
      j = block_lex_min(v, nk_j, lex_sm).idx;
    }
    if (j < 0) {
      // all queues overused or the queue has no job: the namespace is
      // popped and never re-pushed (allocate.go:125-157)
      if (tid == 0) ns_active[ns] = 0;
      __syncthreads();
      continue;
    }

    // 4. the job's tasks until gang-ready, exhausted or infeasible
    const int start = job_task_start[j];
    const int count = job_task_count[j];
    const int threshold = job_ready_threshold[j];
    const int base = job_ready_base[j] + job_placed[j];
    if (tid == 0) {
      s_ptr = job_ptr[j] - start;
      s_placed = 0;
      s_broke = 0;
      s_infeasible = 0;
      for (int r = 0; r < R; ++r) s_preq[r] = T(0);
    }
    __syncthreads();
    while (s_ptr < count && !s_broke && !s_infeasible) {
      const int t = start + s_ptr;
      const int rr = s_rr;
      const int sig = task_sig[t];
      const bool has_pod = task_has_pod[t] != 0;
      const T* irq = task_initreq + (size_t)t * R;
      const T* rq = task_req + (size_t)t * R;
      const T nzc = task_nz_cpu[t], nzm = task_nz_mem[t];
      if (tid == 0) s_kth_e = 0;
      __syncthreads();
      int carry_c = 0, carry_e = 0;
      T bk = T(-INFINITY);
      int bi = INT32_MAX;
      for (int base_p = 0; base_p < N; base_p += kThreads) {
        const int pos = base_p + tid;
        const bool in = pos < N;
        const int n = in ? (int)(((long long)pos + rr) % N) : 0;
        const bool real = in && node_real[n] != 0;
        bool f = real && sig_mask[(size_t)sig * N + n] != 0;
        for (int r = 0; f && r < R; ++r) {
          T a = irq[r];
          bool le = a < idle[(size_t)n * R + r] + eps[r];
          bool skip = is_scalar[r] && a <= T(kMinMilliScalar);
          f = le || skip;
        }
        if (f && p.check_pod_count)
          f = (cnt[n] < node_max_tasks[n]) || !has_pod;
        int cf, ce, tf, te;
        block_count2(f, real, cf, ce, tf, te, cnt_a, cnt_b);
        const int c = carry_c + cf, e = carry_e + ce;
        if (f && c <= ntf) {
          T s = scorefn::fused_score<T>(
              R, rq, nzc, nzm, used + (size_t)n * R, node_alloc + (size_t)n * R,
              aff[(size_t)sig * N + n], binpack_w, weights,
              p.use_nodeorder != 0, p.use_binpack != 0);
          if (before(s, n, bk, bi)) { bk = s; bi = n; }
        }
        // examined[kth]: the real count at the first position whose
        // feasible count reaches num_to_find (position 0 when it is <= 0)
        if (ntf >= 1 ? (f && c == ntf) : pos == 0) s_kth_e = e;
        carry_c += tf;
        carry_e += te;
        if (ntf >= 1 && carry_c >= ntf) break;  // block-uniform
      }
      block_best<T>(bk, bi, best_k, best_i);  // ends in a barrier
      if (tid == 0) {
        const int processed = carry_c >= ntf ? s_kth_e : real_n;
        s_rr = (int)(((long long)rr + processed) % real_n);
        if (carry_c > 0) {
          const int node = bi < N ? bi : 0;
          const int k = s_placed;
          undo_node[k] = node;
          undo_cnt[k] = cnt[node];
          for (int r = 0; r < R; ++r) {
            undo_idle[(size_t)k * R + r] = idle[(size_t)node * R + r];
            undo_used[(size_t)k * R + r] = used[(size_t)node * R + r];
            idle[(size_t)node * R + r] = idle[(size_t)node * R + r] + (-rq[r]);
            used[(size_t)node * R + r] = used[(size_t)node * R + r] + rq[r];
            s_preq[r] = s_preq[r] + rq[r];
          }
          cnt[node] += 1;
          assign[t] = node;
          s_placed = k + 1;
          s_ptr += 1;
          s_broke = (base + s_placed) >= threshold;
        } else {
          s_infeasible = 1;
        }
      }
      __syncthreads();
    }

    // 5. commit when the gang is ready, else roll the visit back
    if (tid == 0) {
      const int placed = s_placed, ptr = s_ptr;
      if (base + placed >= threshold) {
        for (int r = 0; r < R; ++r) {
          job_alloc[(size_t)j * R + r] = job_alloc[(size_t)j * R + r] + s_preq[r];
          queue_alloc[(size_t)q * R + r] = queue_alloc[(size_t)q * R + r] + s_preq[r];
          ns_alloc[(size_t)ns * R + r] = ns_alloc[(size_t)ns * R + r] + s_preq[r];
        }
        job_placed[j] += placed;
        job_ptr[j] = start + ptr;
        // re-pushed only on the gang-ready break (allocate.go:238-240)
        job_active[j] = s_broke ? 1 : 0;
      } else {
        for (int k = placed - 1; k >= 0; --k) {
          const int node = undo_node[k];
          cnt[node] = undo_cnt[k];
          for (int r = 0; r < R; ++r) {
            idle[(size_t)node * R + r] = undo_idle[(size_t)k * R + r];
            used[(size_t)node * R + r] = undo_used[(size_t)k * R + r];
          }
        }
        for (int t = start + ptr - placed; t < start + ptr; ++t) assign[t] = -1;
        job_active[j] = 0;
      }
    }
    __syncthreads();
  }
  if (tid == 0) assign[T_] = s_rr;
}

template <typename T>
int launch(const ParityParams* p, void* stream) {
  if (p->T <= 0 || p->N <= 0 || p->R <= 0 || p->R > kMaxR || p->J <= 0 ||
      p->Q <= 0 || p->S <= 0 || p->G <= 0 || p->n_job_keys < 0 ||
      p->n_job_keys > 3)
    return (int)cudaErrorInvalidValue;
  parity_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int parity_scan_f32(const ParityParams* p, void* stream) {
  return launch<float>(p, stream);
}
extern "C" int parity_scan_f64(const ParityParams* p, void* stream) {
  return launch<double>(p, stream);
}
