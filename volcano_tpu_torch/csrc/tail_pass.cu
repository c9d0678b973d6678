// K7b tail_pass: the sequential tail pass of the rounds solve, hand-written
// for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:980 `tail_pass` (a lax.while_loop run
// under lax.cond(capped) at :1101). Plain version:
// volcano_tpu_torch/ops/rounds_kernels.py `tail_pass_plain`.
//
// After a capped exit (and the straggler rounds) the remainder is placed
// one task at a time, in the serial visit order, for at most
// 8 * max(round_min_progress, 1) + 16 steps. One launch runs the whole tail
// in one block of 1024 threads; each step:
//   1. marks the queues over their deserved share (the overused gate),
//   2. finds the live task of a queue under its share that is first by the
//      job-order keys in tier order (priority, gang readiness, drf share;
//      csrc/job_keys.cuh, shared with K6 job_rank),
//      then the job's tie rank and the task's index in its job, then the
//      lowest task index: each thread keeps its best candidate under that
//      comparator and the block reduces (keys compare as doubles: an int32
//      and a float key widen exactly), and stops when no task is live;
//   3. scores ONE class row (the task's) over every node: the epsilon fit
//      of the init request against idle (scalar dims at or under
//      MIN_MILLI_SCALAR skipped), the signature mask, the pod cap and the
//      exclusion group's occupancy, then score_common.cuh's fused score;
//   4. takes the first maximum (score desc, node index asc; -inf where the
//      mask fails, node 0 when every node fails);
//   5. commits on thread 0: idle/used/cnt of the node, assign, the task
//      retired from the live set, tail_failed when no node fits, the job,
//      queue and namespace allocations and the exclusion occupancy; a step
//      with nothing eligible commits zeros and ends the pass.
// The tasks placed land in ctl[C_TAIL_PLACED].
//
// Rounding: built with --fmad=false; the score is scorefn::fused_score
// (fma() where XLA contracts); every state update is the reference's single
// add (idle + (-req), used + req), zeros included, so even signed zeros
// match.
//
// Bound: a chain of dependent steps, each two block-wide sweeps (T tasks,
// N nodes) and a few block barriers, so the pass is bound by step latency
// on one SM, far above the bytes it moves.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "job_keys.cuh"
#include "rounds_ctl.cuh"
#include "score_common.cuh"

// The argument block, field for field the ctypes structure
// rounds_kernels._TailParams: TAIL_INPUTS, TAIL_STATE, ctl, the sizes and
// the static spec.
struct TailParams {
  const void *task_cls, *task_job, *task_queue, *task_ns, *task_in_job,
      *task_excl, *job_priority, *job_ready_base, *job_min_available,
      *job_tie_rank, *drf_total, *drf_present, *queue_deserved, *eps,
      *is_scalar, *cls_req, *cls_initreq, *cls_sig, *cls_nz_cpu, *cls_nz_mem,
      *cls_has_pod, *sig_mask, *node_max_tasks, *node_alloc, *affinity_score,
      *binpack_w, *score_weights;
  void *idle, *used, *cnt, *assign, *active, *job_placed, *job_alloc,
      *queue_alloc, *ns_alloc, *excl_occ, *tail_failed;
  void* ctl;
  int T, N, R, J, Q, S, G, budget, n_job_keys, key0, key1, key2,
      use_prop_overused, check_pod_count, use_exclusion, use_nodeorder,
      use_binpack;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxR = 16;
constexpr int kLevels = 5;  // three job-order keys, tie rank, task_in_job
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR
constexpr unsigned kFull = 0xffffffffu;

struct Lex {
  double k[kLevels];
  int idx;  // < 0: no candidate
};

__device__ __forceinline__ bool lex_less(const Lex& a, const Lex& b, int nk) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
#pragma unroll
  for (int i = 0; i < kLevels; ++i) {
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
  for (int i = 0; i < kLevels; ++i) o.k[i] = __shfl_down_sync(kFull, v.k[i], off);
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
    v = sm[lane];
    for (int off = 16; off > 0; off >>= 1) lex_take_down(v, off, nk);
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  Lex out = sm[0];
  __syncthreads();
  return out;
}

// a node candidate of the arg-max: its masked score, index and mask bit
struct Best {
  double val;
  int idx;
  int mask;
};

__device__ __forceinline__ bool best_better(const Best& a, const Best& b) {
  return a.val > b.val || (a.val == b.val && a.idx < b.idx);
}

__device__ __forceinline__ void best_take_down(Best& v, int off) {
  Best o;
  o.val = __shfl_down_sync(kFull, v.val, off);
  o.idx = __shfl_down_sync(kFull, v.idx, off);
  o.mask = __shfl_down_sync(kFull, v.mask, off);
  if (best_better(o, v)) v = o;
}

__device__ Best block_best(Best v, Best* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) best_take_down(v, off);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = sm[lane];
    for (int off = 16; off > 0; off >>= 1) best_take_down(v, off);
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  Best out = sm[0];
  __syncthreads();
  return out;
}

template <typename F>
__global__ void __launch_bounds__(kThreads) tail_kernel(TailParams p) {
  extern __shared__ uint8_t qover[];  // [Q]: queue over its share
  __shared__ Lex lex_sm[kThreads / 32];
  __shared__ Best best_sm[kThreads / 32];

  const int tid = threadIdx.x;
  const int R = p.R, N = p.N;
  const int32_t* task_cls = (const int32_t*)p.task_cls;
  const int32_t* task_job = (const int32_t*)p.task_job;
  const int32_t* task_queue = (const int32_t*)p.task_queue;
  const int32_t* task_ns = (const int32_t*)p.task_ns;
  const int32_t* task_in_job = (const int32_t*)p.task_in_job;
  const int32_t* task_excl = (const int32_t*)p.task_excl;
  const int32_t* job_priority = (const int32_t*)p.job_priority;
  const int32_t* job_ready_base = (const int32_t*)p.job_ready_base;
  const int32_t* job_min_available = (const int32_t*)p.job_min_available;
  const int32_t* job_tie_rank = (const int32_t*)p.job_tie_rank;
  const F* drf_total = (const F*)p.drf_total;
  const uint8_t* drf_present = (const uint8_t*)p.drf_present;
  const F* queue_deserved = (const F*)p.queue_deserved;
  const F* eps = (const F*)p.eps;
  const uint8_t* is_scalar = (const uint8_t*)p.is_scalar;
  const F* cls_req = (const F*)p.cls_req;
  const F* cls_initreq = (const F*)p.cls_initreq;
  const int32_t* cls_sig = (const int32_t*)p.cls_sig;
  const F* cls_nz_cpu = (const F*)p.cls_nz_cpu;
  const F* cls_nz_mem = (const F*)p.cls_nz_mem;
  const uint8_t* cls_has_pod = (const uint8_t*)p.cls_has_pod;
  const uint8_t* sig_mask = (const uint8_t*)p.sig_mask;
  const int32_t* nmax = (const int32_t*)p.node_max_tasks;
  const F* node_alloc = (const F*)p.node_alloc;
  const F* aff = (const F*)p.affinity_score;
  const F* binpack_w = (const F*)p.binpack_w;
  const F* weights = (const F*)p.score_weights;
  F* idle = (F*)p.idle;
  F* used = (F*)p.used;
  int32_t* cnt = (int32_t*)p.cnt;
  int32_t* assign = (int32_t*)p.assign;
  uint8_t* active = (uint8_t*)p.active;
  int32_t* job_placed = (int32_t*)p.job_placed;
  F* job_alloc = (F*)p.job_alloc;
  F* queue_alloc = (F*)p.queue_alloc;
  F* ns_alloc = (F*)p.ns_alloc;
  uint8_t* occ = (uint8_t*)p.excl_occ;
  uint8_t* tail_failed = (uint8_t*)p.tail_failed;

  const jobkeys::JobCols<F> jcols{job_priority, job_ready_base, job_min_available,
                                  job_tie_rank, job_placed, job_alloc, drf_total,
                                  drf_present, R};
  const int keys[3] = {p.key0, p.key1, p.key2};
  const int nk = p.n_job_keys + 2;
  int placed = 0;

  for (int step = 0; step < p.budget; ++step) {
    // 1. the overused gate: a queue over its deserved share sits out
    if (p.use_prop_overused) {
      for (int q = tid; q < p.Q; q += kThreads) {
        bool le = true;
        for (int r = 0; r < R; ++r) {
          F l = queue_alloc[(size_t)q * R + r];
          bool ok = l < queue_deserved[(size_t)q * R + r] + eps[r];
          bool skip = is_scalar[r] && l <= F(kMinMilliScalar);
          le = le && (ok || skip);
        }
        qover[q] = !le;
      }
    }
    __syncthreads();
    // 2. the first live task in the serial visit order
    Lex best;
    best.idx = -1;
#pragma unroll
    for (int i = 0; i < kLevels; ++i) best.k[i] = 0.0;
    int any_active = 0;
    for (int t = tid; t < p.T; t += kThreads) {
      if (!active[t]) continue;
      any_active = 1;
      if (p.use_prop_overused && qover[task_queue[t]]) continue;
      const int j = task_job[t];
      Lex v;
      v.idx = t;
#pragma unroll
      for (int i = 0; i < kLevels; ++i) v.k[i] = 0.0;
      int l = 0;
      for (int kk = 0; kk < p.n_job_keys; ++kk) v.k[l++] = jobkeys::key<F>(jcols, keys[kk], j);
      v.k[l++] = (double)job_tie_rank[j];
      v.k[l] = (double)task_in_job[t];
      if (lex_less(v, best, nk)) best = v;
    }
    if (!__syncthreads_or(any_active)) break;
    best = block_lex_min(best, nk, lex_sm);
    const bool has = best.idx >= 0;
    const int t = has ? best.idx : 0;
    const int c = task_cls[t];
    const int sig = cls_sig[c];
    const int g = task_excl[t];
    const F* req = cls_req + (size_t)c * R;
    const F* ireq = cls_initreq + (size_t)c * R;
    // 3-4. the class row's mask and score, the first maximum
    Best nb;
    nb.val = -INFINITY;
    nb.idx = 0x7fffffff;
    nb.mask = 0;
    for (int n = tid; n < N; n += kThreads) {
      bool mask = sig_mask[(size_t)sig * N + n] != 0;
      for (int r = 0; r < R; ++r) {
        F ir = ireq[r];
        bool le = ir < idle[(size_t)n * R + r] + eps[r];
        bool skip = is_scalar[r] && ir <= F(kMinMilliScalar);
        mask = mask && (le || skip);
      }
      if (p.check_pod_count) mask = mask && ((cnt[n] < nmax[n]) || !cls_has_pod[c]);
      if (p.use_exclusion) mask = mask && !(occ[(size_t)(g > 0 ? g : 0) * N + n] && g >= 0);
      F score = scorefn::fused_score<F>(
          R, req, cls_nz_cpu[c], cls_nz_mem[c], used + (size_t)n * R,
          node_alloc + (size_t)n * R, aff[(size_t)sig * N + n], binpack_w, weights,
          p.use_nodeorder != 0, p.use_binpack != 0);
      Best v;
      v.val = mask ? (double)score : -INFINITY;
      v.idx = n;
      v.mask = mask;
      if (best_better(v, nb)) nb = v;
    }
    nb = block_best(nb, best_sm);
    // 5. the commit
    if (tid == 0) {
      const bool ok = has && nb.mask;
      const int node = nb.idx;
      const int j = task_job[t], q = task_queue[t], ns = task_ns[t];
      for (int r = 0; r < R; ++r) {
        F d = ok ? req[r] : F(0);
        idle[(size_t)node * R + r] = idle[(size_t)node * R + r] + (-d);
        used[(size_t)node * R + r] = used[(size_t)node * R + r] + d;
        job_alloc[(size_t)j * R + r] = job_alloc[(size_t)j * R + r] + d;
        queue_alloc[(size_t)q * R + r] = queue_alloc[(size_t)q * R + r] + d;
        ns_alloc[(size_t)ns * R + r] = ns_alloc[(size_t)ns * R + r] + d;
      }
      cnt[node] += ok ? 1 : 0;
      job_placed[j] += ok ? 1 : 0;
      if (ok) assign[t] = node;
      if (has) active[t] = 0;
      if (has && !ok) tail_failed[t] = 1;
      if (p.use_exclusion && ok && g >= 0) occ[(size_t)g * N + node] = 1;
      placed += ok ? 1 : 0;
    }
    __syncthreads();
    if (!has) break;
  }
  if (tid == 0) ((int32_t*)p.ctl)[rctl::C_TAIL_PLACED] = placed;
}

template <typename F>
int launch(const TailParams* p, void* stream) {
  if (p->R > kMaxR || p->R < 2 || p->T <= 0 || p->N <= 0 || p->n_job_keys > 3)
    return (int)cudaErrorInvalidValue;
  tail_kernel<F><<<1, kThreads, p->Q, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tail_pass_f32(const TailParams* p, void* stream) {
  return launch<float>(p, stream);
}
extern "C" int tail_pass_f64(const TailParams* p, void* stream) {
  return launch<double>(p, stream);
}
