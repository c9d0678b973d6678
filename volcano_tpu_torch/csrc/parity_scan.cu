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
// Bound: the work is a chain of dependent steps (one a task, three argmins
// a visit), so the kernel is bound by each step's latency on one SM, far
// above the bytes or operations the session needs. The previous design (one
// block of 1024 threads) spent, at cfg5 on an H100, 20.5 us a task step:
// 15.5 of it in the visits' three block argmins (the job argmin read all J
// jobs' keys every visit, three barriers each), 4.1 in the step (the
// rotated node order in chunks of 1024, a three-barrier count each, a
// three-barrier arg-max, a barrier after thread 0's update).
//
// Design: one launch a session, one block of NT = 512 threads (tried: at
// 1024 a thread has 64 registers and spills, and cfg2 and cfg5 ran 20-30%
// slower on an H100; at 256 a thread's share of the jobs grows, and they
// ran 12-18% slower); two barriers a visit and two a task step while the
// window lies in the first NT positions (both BASELINE cells).
// - A task step walks the rotated node order from rr in chunks of NT
//   positions, one a thread, and stops at the chunk where the feasible
//   count reaches num_to_find (later positions are never selected). A
//   position's feasibility (real, signature mask, every dim fits, pod cap)
//   issues all its loads before the first test. Counts in rotated order
//   take one barrier a chunk: warp ballots, one slot a warp (two buffers),
//   and each thread sums the warps' slots. A selected position is scored
//   (score_common.cuh fused_score) into its thread's best (score desc,
//   node asc); a warp shuffle, one barrier and a pass over the warps'
//   bests give the arg-max to every thread, and every thread follows the
//   step's outcome (node, rr, placed). `processed` is the real count at
//   the position whose count reaches num_to_find (position 0 when it is
//   <= 0), real_n when too few nodes are feasible.
// - The node state (idle/used/cnt) lives in the global scratch, where it
//   stays in L2 (tried: in shared memory it ran within 1% at cfg2 and
//   10-15% slower at cfg5 on an H100). A placement's row is written by the
//   thread that reads it first in the next step (the node's position from
//   the new cursor), so no barrier stands between the update and that read.
// - The visit: warp 0 alone takes the namespace and queue argmins with
//   shuffles (S, Q <= 32; else block argmins over the same comparator),
//   writing the overused-queue purge back to q_in_ns on every branch; one
//   barrier. The job argmin keeps each thread's best over its jobs (j =
//   tid mod NT) from visit to visit: a visit changes only its own job's
//   keys, so only that job's owner folds its jobs again, or every thread
//   when (namespace, queue) changes. The owner commits its job's state
//   itself, and its warp folds the owner's jobs (one a lane) at the
//   visit's end; every warp writes the minimum of its threads' bests
//   before the next visit's barrier, so the job argmin needs no barrier of
//   its own while (namespace, queue) stays.
//   Comparators: key levels in order (as doubles: a float or an int32 key
//   widens exactly), then the lowest index.
// - Roll back is exact: each placement logs the node's rows and cnt as
//   they were before it, and a discarded visit restores them in reverse
//   order after one barrier (never by subtracting: float sums are not
//   reversible); assign is cleared over the visit's tasks and rr keeps
//   its advance.
// - Tried and dropped: one pass over the whole node axis a step (each
//   thread a contiguous run of nodes, one block scan, the rotated counts as
//   differences of the prefix, as K9's window). Its barriers were fewer,
//   but each thread's run of 10 nodes at cfg5 was a chain of dependent
//   loads and up to 10 scores: 13.9 us a step in the sweep and 5.5 in the
//   arg-max against the chunked walk's 2.9 and 0.5 (H100).
// - Built with -DK15_PROFILE, PROF(k) marks add thread 0's clock between
//   marks to phase k's counter and PROF_UNIT() counts the task steps
//   (volcano_tpu_torch/bench/kernel_profile.py reads them); otherwise they
//   compile to nothing.
//
// Output: int32 [T + 1], assign then the final round-robin index, read
// back in one fetch. The inputs are never written.
//
// Rounding: built with --fmad=false; the score is scorefn::fused_score,
// with fma() where XLA contracts; shares, idle/used updates and the
// placed-request sums are the reference's single adds and divides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"

#ifdef K15_PROFILE
constexpr int kProfPhases = 8;
// the phases' cycles at thread 0, then the task steps
__device__ long long k15_prof_t[kProfPhases + 1];
__device__ long long k15_prof_last;
#define PROF(k)                                                  \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      const long long now_ = clock64();                          \
      k15_prof_t[k] += now_ - k15_prof_last;                     \
      k15_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNIT()                                              \
  do {                                                           \
    if (threadIdx.x == 0) k15_prof_t[kProfPhases] += 1;          \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k15_prof_t[k_] = 0; \
      k15_prof_last = clock64();                                 \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNIT() do {} while (0)
#define PROF_START() do {} while (0)
#endif

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

constexpr int kMaxR = 16;
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
constexpr int NT = 512;  // threads a block
constexpr int NW = NT / 32;

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

// the warp's lexicographic minimum, in every lane (a butterfly: the order
// is total, so every lane ends with the same winner); only the nk levels
// in use cross lanes
__device__ __forceinline__ Lex warp_lex_min(Lex v, int nk) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lex o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.k[i] = i < nk ? __shfl_xor_sync(kFull, v.k[i], off) : 0.0;
    o.idx = __shfl_xor_sync(kFull, v.idx, off);
    if (lex_less(o, v, nk)) v = o;
  }
  return v;
}

// the block's lexicographic minimum, in every thread: one barrier, then
// every warp reads the warps' minima one a lane and reduces them with
// shuffles. `sm` (one slot a warp) is read after the barrier, so its next
// writer must be past another barrier.
__device__ __forceinline__ Lex block_lex_min(Lex v, int nk, Lex* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_lex_min(v, nk);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  return warp_lex_min(lane < NW ? sm[lane] : lex_none(), nk);
}

template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
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

// a visit's namespace and queue, from warp 0 to the block (two buffers:
// warp 0 writes visit v + 1's while slower warps may still read visit v's)
struct Vis {
  int any, ns, q;
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) parity_kernel(const ParityParams p) {
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int real_n = *(const int32_t*)p.real_n;
  const int ntf = p.num_to_find;

  __shared__ Lex lex_ns[NW], lex_q[NW], lex_j[NW];
  __shared__ Lex lex_w[2][NW];  // the warps' cached best jobs, by visit parity
  __shared__ int2 cnt_w[2][NW];
  __shared__ T best_k[NW];
  __shared__ int best_i[NW];
  __shared__ T s_preq[kMaxR];
  __shared__ Vis s_vis[2];
  __shared__ int s_kth_e;
  T* idle = (T*)p.idle;
  T* used = (T*)p.used;
  int* cnt = (int*)p.cnt;

  // the carry starts as the encoded state
  for (int i = tid; i < N * R; i += NT) {
    idle[i] = ((const T*)p.node_idle)[i];
    used[i] = ((const T*)p.node_used)[i];
  }
  for (int n = tid; n < N; n += NT) cnt[n] = ((const int32_t*)p.node_cnt)[n];
  for (int j = tid; j < J; j += NT) {
    job_ptr[j] = job_task_start[j];
    job_placed[j] = 0;
    job_active[j] = ((const uint8_t*)p.job_active0)[j];
  }
  for (int i = tid; i < J * R; i += NT) job_alloc[i] = ((const T*)p.job_alloc0)[i];
  for (int i = tid; i < Q * R; i += NT) queue_alloc[i] = ((const T*)p.queue_alloc0)[i];
  for (int i = tid; i < S * R; i += NT) ns_alloc[i] = ((const T*)p.ns_alloc0)[i];
  for (int i = tid; i < S; i += NT) ns_active[i] = ((const uint8_t*)p.ns_active0)[i];
  for (int i = tid; i < S * Q; i += NT) q_in_ns[i] = ((const uint8_t*)p.q_in_ns0)[i];
  for (int t = tid; t < T_; t += NT) assign[t] = -1;
  __syncthreads();
  PROF_START();

  const int nk_ns = p.use_drf_ns_order ? 2 : 1;
  const int nk_q = p.use_prop_queue_order ? 2 : 1;
  const int nk_j = p.n_job_keys + 1;
  const bool small = S <= 32 && Q <= 32;

  // a namespace's and a queue's candidate (the queue's after the purge)
  auto ns_cand = [&](int s) {
    Lex c = lex_none();
    const double rank = (double)ns_rank[s];
    if (p.use_drf_ns_order) {
      T sh = share<T>(ns_alloc + (size_t)s * R, drf_total, drf_present, R);
      c.k[0] = (double)(sh / ns_weight[s]);
      c.k[1] = rank;
    } else {
      c.k[0] = rank;
    }
    c.idx = s;
    return c;
  };
  auto q_cand = [&](int ns, int q) {
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
    Lex c = lex_none();
    if (!in) return c;
    const double tie = (double)queue_tie_rank[q];
    if (p.use_prop_queue_order) {
      c.k[0] = (double)share<T>(queue_alloc + (size_t)q * R, queue_deserved + (size_t)q * R,
                                queue_present + (size_t)q * R, R);
      c.k[1] = tie;
    } else {
      c.k[0] = tie;
    }
    c.idx = q;
    return c;
  };
  // the job-order key codes in tier order, and whether drf is one of them
  const int codes[3] = {p.key0, p.key1, p.key2};
  const bool drf_key = (p.n_job_keys > 0 && codes[0] == 2) || (p.n_job_keys > 1 && codes[1] == 2) ||
                       (p.n_job_keys > 2 && codes[2] == 2);
  // one job's candidate of (ns, q) (none when it is not one)
  auto job_cand = [&](int jj, int ns, int q) {
    Lex c = lex_none();
    if (!job_active[jj] || job_queue[jj] != q || job_ns[jj] != ns) return c;
    const double prio = -(double)job_priority[jj];
    const double rdy = (job_ready_base[jj] + job_placed[jj]) >= job_min_available[jj] ? 1.0 : 0.0;
    const double sh = drf_key ? (double)share<T>(job_alloc + (size_t)jj * R, drf_total, drf_present, R)
                              : 0.0;
    const double tie = (double)job_tie_rank[jj];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int code = l < 3 ? codes[l] : -1;
      const double key = code == 0 ? prio : code == 1 ? rdy : sh;
      c.k[l] = l < p.n_job_keys ? key : (l == p.n_job_keys ? tie : 0.0);
    }
    c.idx = jj;
    return c;
  };
  // this thread's best job of (ns, q): its jobs tid, tid + NT, ...
  auto job_fold = [&](int ns, int q) {
    Lex v = lex_none();
    for (int jj = tid; jj < J; jj += NT) {
      const Lex c = job_cand(jj, ns, q);
      if (lex_less(c, v, nk_j)) v = c;
    }
    return v;
  };

  // runaway backstop from the padded shapes; the real exit is the drain
  const long long max_visits = (long long)S + J + T_ + 8;
  long long visits = 0;  // block-uniform
  int rr = p.rr0;        // block-uniform: every thread follows each step
  int vb = 0;            // the visit's Vis buffer
  Lex jbest = lex_none();
  int jtag_ns = -1, jtag_q = -1;
  while (true) {
    // 1. namespace (the weighted DRF share when enabled, then the rank),
    // 2. queue: overused queues leave q_in_ns for good, then the
    // proportion share and the queue rank
    vb ^= 1;
    {
      // each warp's best of the cached bests, before the visit's barrier
      const Lex w = warp_lex_min(jbest, nk_j);
      if (lane == 0) lex_w[vb][warp] = w;
    }
    if (small) {
      if (warp == 0) {
        __syncwarp();  // thread 0's commit of the last visit
        const bool act = lane < S && ns_active[lane];
        const unsigned am = __ballot_sync(kFull, act);
        int ns = 0, q = -1;
        if (am) {
          ns = warp_lex_min(act ? ns_cand(lane) : lex_none(), nk_ns).idx;
          PROF(1);
          q = warp_lex_min(lane < Q ? q_cand(ns, lane) : lex_none(), nk_q).idx;
        }
        if (lane == 0) s_vis[vb] = Vis{am != 0, ns, q};
      }
      __syncthreads();
    } else {
      bool any = false;
      for (int s = tid; s < S; s += NT) any = any || ns_active[s];
      any = __syncthreads_or(any);
      int ns = 0, q = -1;
      if (any) {
        Lex v = lex_none();
        for (int s = tid; s < S; s += NT)
          if (ns_active[s]) {
            const Lex c = ns_cand(s);
            if (lex_less(c, v, nk_ns)) v = c;
          }
        ns = block_lex_min(v, nk_ns, lex_ns).idx;
        PROF(1);
        v = lex_none();
        for (int qq = tid; qq < Q; qq += NT) {
          const Lex c = q_cand(ns, qq);
          if (lex_less(c, v, nk_q)) v = c;
        }
        q = block_lex_min(v, nk_q, lex_q).idx;
      }
      if (tid == 0) s_vis[vb] = Vis{any, ns, q};
      __syncthreads();
    }
    PROF(2);
    const Vis vis = s_vis[vb];
    const int ns = vis.ns, q = vis.q;
    if (!vis.any || visits >= max_visits) break;
    visits += 1;
    PROF(0);

    // 3. job: the job-order keys in tier order, then the tie rank; each
    // thread's cached best holds unless (namespace, queue) changed (the
    // last visit's job's owner folded its jobs at that visit's end), and
    // then the warps' minima written before the barrier give the block's
    int j = -1;
    if (q >= 0 && ns == jtag_ns && q == jtag_q) {
      j = warp_lex_min(lane < NW ? lex_w[vb][lane] : lex_none(), nk_j).idx;
    } else if (q >= 0) {
      jbest = job_fold(ns, q);
      jtag_ns = ns;
      jtag_q = q;
      j = block_lex_min(jbest, nk_j, lex_j).idx;
    }
    PROF(3);
    if (j < 0) {
      // all queues overused or the queue has no job: the namespace is
      // popped and never re-pushed (allocate.go:125-157)
      if (tid == 0) ns_active[ns] = 0;
      PROF(7);
      continue;
    }

    // 4. the job's tasks until gang-ready, exhausted or infeasible
    const int start = job_task_start[j];
    const int count = job_task_count[j];
    const int threshold = job_ready_threshold[j];
    const int base = job_ready_base[j] + job_placed[j];
    int ptr = job_ptr[j] - start, placed = 0;
    bool broke = false;
    // the placed requests' sums: thread 0's for the queue and namespace,
    // the job's owner's (the thread whose jobs are j mod NT) for the job
    const int jo = j % NT;
    T opreq[kMaxR];
    if (tid == 0)
      for (int r = 0; r < R; ++r) s_preq[r] = T(0);
    if (tid == jo)
      for (int r = 0; r < R; ++r) opreq[r] = T(0);
    while (ptr < count && !broke) {
      const int t = start + ptr;
      const int sig = task_sig[t];
      const bool has_pod = task_has_pod[t] != 0;
      const T* irq = task_initreq + (size_t)t * R;
      const T* rq = task_req + (size_t)t * R;
      const uint8_t* smask = sig_mask + (size_t)sig * N;
      const int rrn = rr % N;
      // the rotated node order from rr in chunks of NT positions, one a
      // thread: feasible (f) and real (e) counts in rotated order, the
      // selected positions scored into the thread's best
      int carry_c = 0, carry_e = 0, kb = 0;
      T bk = T(-INFINITY);
      int bi = kNone;
      for (int base_p = 0; base_p < N; base_p += NT, kb ^= 1) {
        const int pos = base_p + tid;
        int n = pos + rrn;
        n = pos < N ? (n >= N ? n - N : n) : 0;
        // every operand's load goes out before the first test
        const bool e = (pos < N) & (node_real[n] != 0);
        bool f = e & (smask[n] != 0);
        for (int r = 0; r < R; ++r) {
          const T a = irq[r];
          f = f & ((a < idle[(size_t)n * R + r] + eps[r]) | (is_scalar[r] & (a <= T(kMinMilliScalar))));
        }
        if (p.check_pod_count) f = f & ((cnt[n] < node_max_tasks[n]) | !has_pod);
        const unsigned le = lane == 31 ? kFull : ((1u << (lane + 1)) - 1u);
        const unsigned bf = __ballot_sync(kFull, f), be = __ballot_sync(kFull, e);
        if (lane == 0) cnt_w[kb][warp] = make_int2(__popc(bf), __popc(be));
        __syncthreads();
        // the warps' counts, one a lane: their scan gives this warp's
        // offset and the chunk's totals
        int2 x = lane < NW ? cnt_w[kb][lane] : make_int2(0, 0);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int yf = __shfl_up_sync(kFull, x.x, off), ye = __shfl_up_sync(kFull, x.y, off);
          if (lane >= off) {
            x.x += yf;
            x.y += ye;
          }
        }
        const int tf = __shfl_sync(kFull, x.x, 31), te = __shfl_sync(kFull, x.y, 31);
        const int of = __shfl_sync(kFull, x.x, (warp + 31) & 31), oe = __shfl_sync(kFull, x.y, (warp + 31) & 31);
        const int c = carry_c + __popc(bf & le) + (warp > 0 ? of : 0);
        const int ce = carry_e + __popc(be & le) + (warp > 0 ? oe : 0);
        if (f && c <= ntf) {
          const T s = scorefn::fused_score<T>(
              R, rq, task_nz_cpu[t], task_nz_mem[t], used + (size_t)n * R,
              node_alloc + (size_t)n * R, aff[(size_t)sig * N + n], binpack_w, weights,
              p.use_nodeorder != 0, p.use_binpack != 0);
          if (before(s, n, bk, bi)) {
            bk = s;
            bi = n;
          }
        }
        // examined[kth]: the real count at the first position whose
        // feasible count reaches num_to_find (position 0 when it is <= 0)
        if (ntf >= 1 ? (f && c == ntf) : pos == 0) s_kth_e = ce;
        carry_c += tf;
        carry_e += te;
        if (ntf >= 1 && carry_c >= ntf) break;  // block-uniform
      }
      PROF(4);
      // the arg-max (score desc, node asc) over the block
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ok = __shfl_down_sync(kFull, bk, off);
        const int oi = __shfl_down_sync(kFull, bi, off);
        if (before(ok, oi, bk, bi)) {
          bk = ok;
          bi = oi;
        }
      }
      if (lane == 0) {
        best_k[warp] = bk;
        best_i[warp] = bi;
      }
      __syncthreads();
      // the warps' bests, one a lane, reduced in every warp
      bk = lane < NW ? best_k[lane] : T(-INFINITY);
      bi = lane < NW ? best_i[lane] : kNone;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ok = __shfl_xor_sync(kFull, bk, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (before(ok, oi, bk, bi)) {
          bk = ok;
          bi = oi;
        }
      }
      // without enough feasible nodes the window examined every real one
      const int processed = carry_c >= ntf ? s_kth_e : real_n;
      rr = (int)(((long long)rr + processed) % real_n);
      PROF(5);
      PROF_UNIT();
      if (carry_c == 0) break;  // infeasible: the visit ends
      // the placement: the node's row is updated by the thread that reads
      // it first in the next step (its position from the new cursor), so
      // no barrier is needed before that read; thread 0 keeps the
      // assignment and the request sum
      const int node = bi < N ? bi : 0;
      int np = node - rr % N;
      np = np < 0 ? np + N : np;
      if (tid == np % NT) {
        undo_node[placed] = node;
        undo_cnt[placed] = cnt[node];
        for (int r = 0; r < R; ++r) {
          undo_idle[(size_t)placed * R + r] = idle[(size_t)node * R + r];
          undo_used[(size_t)placed * R + r] = used[(size_t)node * R + r];
          idle[(size_t)node * R + r] = idle[(size_t)node * R + r] + (-rq[r]);
          used[(size_t)node * R + r] = used[(size_t)node * R + r] + rq[r];
        }
        cnt[node] += 1;
      }
      if (tid == 0) {
        for (int r = 0; r < R; ++r) s_preq[r] = s_preq[r] + rq[r];
        assign[t] = node;
      }
      if (tid == jo)
        for (int r = 0; r < R; ++r) opreq[r] = opreq[r] + rq[r];
      placed += 1;
      ptr += 1;
      broke = (base + placed) >= threshold;
      PROF(6);
    }

    // 5. commit when the gang is ready, else roll the visit back. Thread 0
    // writes the queue's and namespace's state (warp 0 reads them next);
    // the job's owner writes the job's, which only it reads outside a
    // barrier, and its warp folds the owner's jobs again at once (one a
    // lane), beside warp 0's next argmins
    const bool ready = base + placed >= threshold;
    if (ready) {
      if (tid == 0)
        for (int r = 0; r < R; ++r) {
          queue_alloc[(size_t)q * R + r] = queue_alloc[(size_t)q * R + r] + s_preq[r];
          ns_alloc[(size_t)ns * R + r] = ns_alloc[(size_t)ns * R + r] + s_preq[r];
        }
      if (tid == jo) {
        for (int r = 0; r < R; ++r)
          job_alloc[(size_t)j * R + r] = job_alloc[(size_t)j * R + r] + opreq[r];
        job_placed[j] += placed;
        job_ptr[j] = start + ptr;
        // re-pushed only on the gang-ready break (allocate.go:238-240)
        job_active[j] = broke ? 1 : 0;
      }
    } else {
      __syncthreads();  // every placement's log entry and row, from their writers
      if (tid == 0) {
        for (int k = placed - 1; k >= 0; --k) {
          const int node = undo_node[k];
          cnt[node] = undo_cnt[k];
          for (int r = 0; r < R; ++r) {
            idle[(size_t)node * R + r] = undo_idle[(size_t)k * R + r];
            used[(size_t)node * R + r] = undo_used[(size_t)k * R + r];
          }
        }
        for (int t = start + ptr - placed; t < start + ptr; ++t) assign[t] = -1;
      }
      if (tid == jo) job_active[j] = 0;
    }
    if (warp == jo / 32) {
      __syncwarp();
      Lex v = lex_none();
      for (int jj = jo + lane * NT; jj < J; jj += 32 * NT) {
        const Lex c = job_cand(jj, ns, q);
        if (lex_less(c, v, nk_j)) v = c;
      }
      v = warp_lex_min(v, nk_j);
      if (tid == jo) jbest = v;
    }
    PROF(7);
  }
  if (tid == 0) assign[T_] = rr;
}

bool valid(const ParityParams* p) {
  return p->T > 0 && p->N > 0 && p->R > 0 && p->R <= kMaxR && p->J > 0 && p->Q > 0 &&
         p->S > 0 && p->G > 0 && p->n_job_keys >= 0 && p->n_job_keys <= 3;
}

template <typename T>
int launch(const ParityParams* p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  parity_kernel<T><<<1, NT, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int parity_scan_f32(const ParityParams* p, void* stream) {
  return launch<float>(p, stream);
}
extern "C" int parity_scan_f64(const ParityParams* p, void* stream) {
  return launch<double>(p, stream);
}

#ifdef K15_PROFILE
// the phases' cycles and the task steps of the last launch
extern "C" int k15_profile_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k15_prof_t, sizeof(k15_prof_t));
}
#endif
