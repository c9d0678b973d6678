// K7c round_commit: the commit of one round of the rounds solve, and the
// rollback's undo of one gang, hand-written for Hopper (sm_90a).
//
// Replaces: the commit of volcano_tpu/ops/rounds.py:838-870 (`round_body`):
// the scatter-adds of the accepted tasks' requests into idle, used and the
// pod counts of their nodes and into job_alloc, queue_alloc and ns_alloc,
// the job placed counts, assign, active, the exclusion occupancy, the
// next round's dirty columns and the round's counters for the loop
// control; and the same scatters of `rollback` (:886-922), which gives the
// retired gang's placed tasks back (mode 1). Plain versions:
// volcano_tpu_torch/ops/rounds_kernels.py `round_commit_plain` and
// `round_rollback_plain` (the torch ops the bodies ran before), whose
// serial CPU semantics it keeps bit for bit.
//
// Order. XLA's scatter-add adds a row's updates one after another in the
// order of the flat task index, to the row's value. Every float row here
// does the same: one thread a row and resource dimension adds its masked
// tasks' requests in task order. torch's CUDA index_put_(accumulate=True)
// sums a row's duplicates first and adds the sum, another rounding.
//
// Signed zeros. Tasks outside the mask add a zero of one sign: -0.0 (idle
// in the commit; used and the allocations in the rollback), an identity
// on every value, or +0.0 (the others), an identity on every value but
// -0.0, which it turns into +0.0. The kernel skips them, so its sum of the
// masked requests differs from the plain one only where it ends at -0.0
// (the row held -0.0 and every masked request added was -0.0) and a task
// outside the mask adds +0.0 to the row: the plain row is +0.0 there. Only
// a row that ends at -0.0 looks for such a task (`unmasked_hits`, a walk
// of the task axis); the solve's rows never hold -0.0 (they start as sums
// of non-negative requests, and an exact subtraction rounds to +0.0), so
// the walk runs only on crafted state.
//
// Design. One launch, four kinds of CTA by block index. Node CTAs: a
// thread a node, its masked tasks found in a stable torch sort of the tasks
// by node (the masked ones by node, the rest behind), in task order; it
// updates the node's idle, used and count, writes its dirty bit and adds
// the placed and dirty counts. Job CTAs: a thread a job, over the job's
// contiguous task range (the encoder lays a job's tasks out together, and
// only valid tasks, which lie in it, are ever placed). Row CTAs: a CTA a
// queue or namespace row; a tile of the task axis at a time, the matching
// tasks' requests are compacted in task order into shared memory (a block
// scan), and thread d < R adds them to the row's dimension d one after
// another. Task CTAs: assign, active, the exclusion occupancy and the
// still-active count. The launcher zeroes the counters it adds to first.
//
// Bound: bytes (each task's node, mask, request and rows once, the touched
// rows read and written once); in practice the longest row's chain of
// dependent adds (a queue with every task) bounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "rounds_ctl.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct CommitArgs {
  const int32_t* node;        // [T] each task's node (the choice; the rollback's assign)
  const uint8_t* mask;        // [T] the tasks placed (accepted) or given back (rolled)
  const void* task_req;       // [T, R] F
  const int32_t* task_job;    // [T]
  const int32_t* task_queue;  // [T]
  const int32_t* task_ns;     // [T]
  const int32_t* task_excl;   // [T] (use_excl)
  const int32_t* job_start;   // [J]
  const int32_t* job_count;   // [J]
  const uint8_t* roll_job;    // [J] the retired gang (mode 1)
  const int32_t* key_s;       // [T] node of each masked task, N for the rest, sorted
  const int64_t* perm_s;      // [T] the tasks in that (stable) order
  const int64_t* flag;        // [] did_full (mode 0); any rollback candidate (mode 1)
  void* idle;                 // [N, R] F
  void* used;                 // [N, R] F
  int32_t* cnt;               // [N]
  int32_t* assign;            // [T]
  uint8_t* active;            // [T]
  int32_t* job_placed;        // [J]
  void* job_alloc;            // [J, R] F
  void* queue_alloc;          // [Q, R] F
  void* ns_alloc;             // [S, R] F
  uint8_t* excl_occ;          // [G, N] (use_excl)
  uint8_t* dirty;             // [N]
  int32_t* ctl;               // the control vector
  int T, N, R, J, Q, S, use_excl, mode;
  int nb_node, nb_job;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 16;
using rctl::C_ANY_CAND;
using rctl::C_DID_FULL;
using rctl::C_NDIRTY_NEXT;
using rctl::C_PLACED;
using rctl::C_STILL;

// x is -0.0
template <typename F>
__device__ __forceinline__ bool neg_zero(F x) {
  return x == (F)0 && signbit(x);
}

// whether a task outside the mask adds its zero to row `row` of `key`
// (the node axis clamps its index as the plain version does)
__device__ bool unmasked_hits(const CommitArgs& a, const int32_t* key, int row, bool clamp) {
  for (int t = 0; t < a.T; ++t) {
    if (a.mask[t]) continue;
    const int k = clamp ? min(max(key[t], 0), a.N - 1) : key[t];
    if (k == row) return true;
  }
  return false;
}

__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// a request as the mode adds it to used and the allocations (idle takes
// the opposite): the commit adds, the rollback gives back
template <typename F>
__device__ __forceinline__ F signed_req(const CommitArgs& a, F r) {
  return a.mode ? -r : r;
}

template <typename F>
__device__ void node_part(const CommitArgs& a, int b) {
  __shared__ int32_t s_w[32];
  const int n = b * kThreads + threadIdx.x;
  int placed = 0, dirty = 0;
  if (n < a.N) {
    const int lo = lower_bound(a.key_s, a.T, n);
    const int hi = lower_bound(a.key_s, a.T, n + 1);
    const F* req = (const F*)a.task_req;
    F* idle = (F*)a.idle;
    F* used = (F*)a.used;
    int hit = -1;  // a task outside the mask on this node: not looked for yet
    for (int d = 0; d < a.R; ++d) {
      F vi = idle[(size_t)n * a.R + d], vu = used[(size_t)n * a.R + d];
      for (int i = lo; i < hi; ++i) {
        const F r = signed_req(a, req[(size_t)a.perm_s[i] * a.R + d]);
        vi = vi + (-r);
        vu = vu + r;
      }
      // the row the unmasked tasks add +0.0 to: used (commit), idle (rollback)
      F& vz = a.mode ? vi : vu;
      if (neg_zero(vz)) {
        if (hit < 0) hit = unmasked_hits(a, a.node, n, true);
        if (hit) vz = (F)0;  // -0.0 + +0.0
      }
      idle[(size_t)n * a.R + d] = vi;
      used[(size_t)n * a.R + d] = vu;
    }
    placed = hi - lo;
    a.cnt[n] += a.mode ? -placed : placed;
    dirty = (a.mode && a.dirty[n]) || hi > lo;
    a.dirty[n] = (uint8_t)dirty;
  }
  placed = bscan::reduce(placed, 0, bscan::Sum(), s_w);
  dirty = bscan::reduce(dirty, 0, bscan::Sum(), s_w);
  if (threadIdx.x == 0) {
    if (placed && !a.mode) atomicAdd(&a.ctl[C_PLACED], placed);
    if (dirty) atomicAdd(&a.ctl[C_NDIRTY_NEXT], dirty);
  }
}

template <typename F>
__device__ void job_part(const CommitArgs& a, int b) {
  const int j = b * kThreads + threadIdx.x;
  if (j >= a.J) return;
  if (a.mode && a.roll_job[j]) a.job_placed[j] = 0;
  const int s = a.job_start[j], e = s + a.job_count[j];
  int placed = 0;
  for (int t = s; t < e; ++t) placed += a.mask[t] && a.task_job[t] == j;
  // the commit's unmasked tasks add +0.0 (the rollback's -0.0), so in the
  // commit a job with nothing placed still reads its row for a -0.0
  if (!placed && a.mode) return;
  const F* req = (const F*)a.task_req;
  F* ja = (F*)a.job_alloc;
  int hit = -1;
  for (int d = 0; d < a.R; ++d) {
    F v = ja[(size_t)j * a.R + d];
    for (int t = s; placed && t < e; ++t) {
      if (a.mask[t] && a.task_job[t] == j) v = v + signed_req(a, req[(size_t)t * a.R + d]);
    }
    if (!a.mode && neg_zero(v)) {
      if (hit < 0) hit = unmasked_hits(a, a.task_job, j, false);
      if (hit) v = (F)0;
    }
    if (placed || hit > 0) ja[(size_t)j * a.R + d] = v;
  }
  if (!a.mode) a.job_placed[j] += placed;
}

template <typename F>
__device__ void row_part(const CommitArgs& a, int r) {
  __shared__ F s_req[kThreads * kMaxR];
  __shared__ int32_t s_w[32];
  const bool is_q = r < a.Q;
  const int row = is_q ? r : r - a.Q;
  const int32_t* key = is_q ? a.task_queue : a.task_ns;
  F* out = (F*)(is_q ? a.queue_alloc : a.ns_alloc) + (size_t)row * a.R;
  const F* req = (const F*)a.task_req;
  const int d = threadIdx.x;
  F v = d < a.R ? out[d] : (F)0;
  for (int base = 0; base < a.T; base += kThreads) {
    // the tile's matching tasks, compacted in task order
    const int t = base + threadIdx.x;
    const int m = t < a.T && a.mask[t] && key[t] == row;
    int count;
    const int pos = bscan::exclusive(m, 0, bscan::Sum(), s_w, &count);
    if (m) {
      for (int k = 0; k < a.R; ++k) s_req[pos * a.R + k] = req[(size_t)t * a.R + k];
    }
    __syncthreads();
    if (d < a.R) {
      for (int i = 0; i < count; ++i) v = v + signed_req(a, s_req[i * a.R + d]);
    }
    __syncthreads();
  }
  // the commit's unmasked tasks add +0.0 (the rollback's -0.0)
  if (__syncthreads_or(!a.mode && d < a.R && neg_zero(v))) {
    int hit = 0;
    for (int t = threadIdx.x; t < a.T && !hit; t += kThreads) hit = !a.mask[t] && key[t] == row;
    if (__syncthreads_or(hit) && d < a.R && neg_zero(v)) v = (F)0;
  }
  if (d < a.R) out[d] = v;
}

__device__ void task_part(const CommitArgs& a, int b) {
  __shared__ int32_t s_w[32];
  const int t = b * kThreads + threadIdx.x;
  int still = 0;
  if (t < a.T) {
    const bool m = a.mask[t];
    if (m) {
      const int c = a.node[t];
      if (a.use_excl && a.task_excl[t] >= 0)
        a.excl_occ[(size_t)a.task_excl[t] * a.N + c] = a.mode ? 0 : 1;
      a.assign[t] = a.mode ? -1 : c;
    }
    const bool gone = a.mode ? a.roll_job[a.task_job[t]] != 0 : m;
    still = a.active[t] && !gone;
    a.active[t] = (uint8_t)still;
  }
  still = bscan::reduce(still, 0, bscan::Sum(), s_w);
  if (threadIdx.x == 0) {
    if (still) atomicAdd(&a.ctl[C_STILL], still);
    if (b == 0) {
      a.ctl[C_DID_FULL] = a.mode ? 0 : (int32_t)*a.flag;
      if (a.mode) a.ctl[C_ANY_CAND] = (int32_t)*a.flag;
    }
  }
}

template <typename F>
__global__ void __launch_bounds__(kThreads) round_commit_kernel(CommitArgs a) {
  int b = blockIdx.x;
  if (b < a.nb_node) { node_part<F>(a, b); return; }
  b -= a.nb_node;
  if (b < a.nb_job) { job_part<F>(a, b); return; }
  b -= a.nb_job;
  if (b < a.Q + a.S) { row_part<F>(a, b); return; }
  task_part(a, b - a.Q - a.S);
}

template <typename F>
int launch(const CommitArgs* a, cudaStream_t s) {
  if (a->R > kMaxR) return (int)cudaErrorInvalidValue;
  // the counters the CTAs add to: placed (a round only), still, dirty
  int32_t* first = a->ctl + (a->mode ? C_STILL : C_PLACED);
  const size_t n = a->mode ? 2 : 3;
  cudaError_t e = cudaMemsetAsync(first, 0, n * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  const int nb_task = (a->T + kThreads - 1) / kThreads;
  const int grid = a->nb_node + a->nb_job + a->Q + a->S + (nb_task > 0 ? nb_task : 1);
  round_commit_kernel<F><<<grid, kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int round_commit_f32(const CommitArgs* a, cudaStream_t s) { return launch<float>(a, s); }
extern "C" int round_commit_f64(const CommitArgs* a, cudaStream_t s) { return launch<double>(a, s); }
