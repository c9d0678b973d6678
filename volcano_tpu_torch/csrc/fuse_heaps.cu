// K13 fuse_heaps: the heap rebuilds of the fused session chain, under the
// keys carried from the stage before, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/session_fuse.py, the push loops of
// _fuse_preempt (:196-215) and _fuse_reclaim (:268-312). The per-action
// encode builds a preempt or reclaim action's initial job heaps with the
// real PriorityQueue on the host; the fused chain encodes before allocate
// runs, so the heaps that depend on post-allocate state are rebuilt here:
//
// - preempt: each job of the static push order f_push_jobs that still has
//   a live candidate task is pushed, in order, into its queue's row with
//   heapq's _siftdown under job_order (priority, gang readiness, drf share
//   at the carried ready/job_alloc, then rank); the pushed jobs, in push
//   order, are the under-request list (-1 elsewhere);
// - reclaim: the jobs evicted from during preempt are counted from the
//   carried alive mask (an exact int scatter-add), eligibility is f_elig0
//   and, under gang, f_vtn0 - evicted >= min_available; walking f_ev_jobs,
//   a queue enters the queue heap (queue_order at the carried
//   queue_alloc) at its first eligible job, live or not, and each live
//   eligible job enters its queue's row.
//
// Design: one block. Its threads zero the outputs and, for reclaim, fold
// the [N, V] alive mask into per-job eviction counts with int atomics;
// then thread 0 walks the push order, which is sequential by nature: each
// push's sift depends on every push before it. The comparisons are
// evict_common.cuh's job_less and queue_less and the push is its
// heap_push, so a key compares exactly as K9's and K10's pops compare it.
//
// Bound: the bytes it must move (the push orders and keys read once, the
// heaps written once) over the memory rate, well under a microsecond at
// cfg4; the walk is one thread's dependent loads, so it is latency-bound,
// a few microseconds per thousand pushes.

#include "evict_common.cuh"

namespace {

using namespace ev;

constexpr int kFhThreads = 256;

#define FH_PTRS(X)                                                           \
  X(job_prio) X(job_min_av) X(job_tie) X(drf_total) X(queue_deserved)       \
  X(queue_tie) X(ready) X(job_alloc) X(queue_alloc) X(live_job)             \
  X(push_jobs) X(push_row) X(ev_jobs) X(ev_qrow) X(elig0) X(vtn0)           \
  X(vic_job) X(vic_valid) X(alive) X(heap) X(hsize) X(under) X(qheap)       \
  X(qhsize) X(evicted) X(qpushed)
#define FH_DIMS(X)                                                           \
  X(J) X(ROWS) X(JCAP) X(PB) X(EB) X(NV) X(QH) X(use_gang_valid) X(n_keys)  \
  X(key0) X(key1) X(key2) X(use_prop_queue_order)

#define FH_PENUM(name) F_##name,
#define FH_DENUM(name) G_##name,
enum { FH_PTRS(FH_PENUM) F_COUNT };
enum { FH_DIMS(FH_DENUM) G_COUNT };

struct FhArgs {
  const void* p[F_COUNT];
  int d[G_COUNT];
};

template <typename U>
__device__ __forceinline__ U* fp(const FhArgs& f, int k) { return (U*)f.p[k]; }

template <typename T>
__global__ void __launch_bounds__(kFhThreads)
    fuse_heaps_kernel(const __grid_constant__ FhArgs f,
                      const __grid_constant__ Args<T> keys, int reclaim) {
  __shared__ Ctl<T> ctl;
  const int tid = threadIdx.x;
  Machine<T> m{keys, ctl, tid};
  const int J = f.d[G_J], ROWS = f.d[G_ROWS], JCAP = f.d[G_JCAP];
  int* heap = fp<int>(f, F_heap);
  int* hsize = fp<int>(f, F_hsize);
  const uint8_t* live = fp<const uint8_t>(f, F_live_job);
  for (int i = tid; i < ROWS * JCAP; i += kFhThreads) heap[i] = 0;
  for (int i = tid; i < ROWS; i += kFhThreads) hsize[i] = 0;
  if (reclaim) {
    int* evicted = fp<int>(f, F_evicted);
    for (int i = tid; i < J; i += kFhThreads) evicted[i] = 0;
    for (int i = tid; i < ROWS; i += kFhThreads) fp<uint8_t>(f, F_qpushed)[i] = 0;
    for (int i = tid; i < f.d[G_QH]; i += kFhThreads) fp<int>(f, F_qheap)[i] = 0;
    __syncthreads();
    // jobs' evictions during preempt (exact int sums, in any order)
    const uint8_t* valid = fp<const uint8_t>(f, F_vic_valid);
    const uint8_t* alive = fp<const uint8_t>(f, F_alive);
    const int* vjob = fp<const int>(f, F_vic_job);
    for (int k = tid; k < f.d[G_NV]; k += kFhThreads)
      if (valid[k] && !alive[k]) atomicAdd(&evicted[vjob[k]], 1);
  }
  __syncthreads();
  if (tid != 0) return;
  if (!reclaim) {
    const int* push_jobs = fp<const int>(f, F_push_jobs);
    const int* push_row = fp<const int>(f, F_push_row);
    int* under = fp<int>(f, F_under);
    for (int i = 0; i < f.d[G_PB]; ++i) {
      const int j = push_jobs[i];
      const bool pushable = j >= 0 && live[min(max(j, 0), J - 1)];
      under[i] = pushable ? j : -1;
      if (pushable) {
        const int row = min(max(push_row[i], 0), ROWS - 1);
        m.heap_push(heap + (size_t)row * JCAP, &hsize[row], j, false);
      }
    }
    return;
  }
  const int* ev_jobs = fp<const int>(f, F_ev_jobs);
  const int* ev_qrow = fp<const int>(f, F_ev_qrow);
  const uint8_t* elig0 = fp<const uint8_t>(f, F_elig0);
  const int* vtn0 = fp<const int>(f, F_vtn0);
  const int* min_av = fp<const int>(f, F_job_min_av);
  const int* evicted = fp<const int>(f, F_evicted);
  uint8_t* qpushed = fp<uint8_t>(f, F_qpushed);
  int* qheap = fp<int>(f, F_qheap);
  int qhs = 0;
  for (int i = 0; i < f.d[G_EB]; ++i) {
    const int j = ev_jobs[i];
    const int jc = min(max(j, 0), J - 1);
    const int q = min(max(ev_qrow[i], 0), ROWS - 1);
    bool elig = j >= 0 && elig0[jc];
    if (f.d[G_use_gang_valid]) elig = elig && vtn0[jc] - evicted[jc] >= min_av[jc];
    if (elig && !qpushed[q]) {
      m.heap_push(qheap, &qhs, q, true);
      qpushed[q] = 1;
    }
    if (elig && live[jc]) m.heap_push(heap + (size_t)q * JCAP, &hsize[q], j, false);
  }
  *fp<int>(f, F_qhsize) = qhs;
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, int reclaim, void* stream) {
  FhArgs f;
  for (int k = 0; k < F_COUNT; ++k) f.p[k] = ptrs[k];
  for (int k = 0; k < G_COUNT; ++k) f.d[k] = dims[k];
  if (f.d[G_J] <= 0 || f.d[G_ROWS] <= 0 || f.d[G_JCAP] <= 0 ||
      (reclaim ? f.d[G_EB] <= 0 || f.d[G_QH] <= 0 : f.d[G_PB] <= 0))
    return (int)cudaErrorInvalidValue;
  // the comparators read their keys through the machines' argument table
  Args<T> keys;
  for (int k = 0; k < P_COUNT; ++k) keys.p[k] = nullptr;
  for (int k = 0; k < D_COUNT; ++k) keys.d[k] = 0;
  keys.p[P_job_prio] = f.p[F_job_prio];
  keys.p[P_job_min_av] = f.p[F_job_min_av];
  keys.p[P_job_tie] = f.p[F_job_tie];
  keys.p[P_drf_total] = f.p[F_drf_total];
  keys.p[P_queue_deserved] = f.p[F_queue_deserved];
  keys.p[P_queue_tie] = f.p[F_queue_tie];
  keys.p[P_ready] = f.p[F_ready];
  keys.p[P_job_alloc] = f.p[F_job_alloc];
  keys.p[P_queue_alloc] = f.p[F_queue_alloc];
  keys.d[D_n_keys] = f.d[G_n_keys];
  keys.d[D_key0] = f.d[G_key0];
  keys.d[D_key1] = f.d[G_key1];
  keys.d[D_key2] = f.d[G_key2];
  keys.d[D_use_prop_queue_order] = f.d[G_use_prop_queue_order];
  fuse_heaps_kernel<T><<<1, kFhThreads, 0, (cudaStream_t)stream>>>(f, keys, reclaim);
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_STR(name) #name ","
extern "C" const char* fh_ptr_names() { return FH_PTRS(FH_STR); }
extern "C" const char* fh_dim_names() { return FH_DIMS(FH_STR); }

extern "C" int fuse_heaps_f32(const void* const* ptrs, const int* dims, int reclaim,
                              void* stream) {
  return launch<float>(ptrs, dims, reclaim, stream);
}
extern "C" int fuse_heaps_f64(const void* const* ptrs, const int* dims, int reclaim,
                              void* stream) {
  return launch<double>(ptrs, dims, reclaim, stream);
}
