// K10 evict_reclaim: the whole reclaim action as one state machine,
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/evict.py solve_reclaim (:1009) with
// reclaim_machine (:942), _reclaim_walk (:861) and _cut_reclaim (:839):
// the queue heap rotation (an overused queue drops out without a re-push),
// one job pop and one task per queue visit; each reclaimer walks its
// feasible nodes in name order, the first node whose cross-queue victims
// validate takes the cut in claimee order (an uncovered cut persists and
// the walk continues strictly forward), and a covered cut pipelines the
// task and re-pushes its queue. Evictions and pipelines are direct (no
// statement), so the log never rewinds.
//
// One block of kThreads threads (evict_common.cuh): thread 0 runs the
// heaps, the cut and the op log; the block shares the victim folds, in
// chunks of kThreads nodes in name order that stop at the first chunk
// holding a qualifying node, and the first-qualifying-node reduction. Output: the packed int32
// result, the flattened [L, 3] op log then the 6-wide tail.
//
// Bound: as K9, a sequential machine whose least time is its bytes over
// the memory rate; one block is latency-bound by design.

#include "evict_common.cuh"

namespace {

using namespace ev;

// one reclaimer task's walk; sets c.w_assigned when the task pipelined
template <typename T>
__device__ void reclaim_walk(Machine<T>& m, int t, int j) {
  const int N = m.d(D_N), V = m.d(D_V);
  const int tid = m.tid;
  Ctl<T>& c = m.c;
  uint8_t* flags = m.template sc<uint8_t>(P_flags);
  uint8_t* under_s = m.template sc<uint8_t>(P_under);
  // feasibility is fixed for the walk: the pod counts change only by the
  // pipeline that ends it
  for (int i = tid; i < N; i += kThreads) flags[i] = m.elig(t, i);
  if (tid == 0) { c.cursor = -1; c.iters = 0; c.w_assigned = 0; c.wdone = 0; }
  __syncthreads();
  const int qj = m.template in<int>(P_job_queue)[j];
  for (;;) {
    const int cursor = c.cursor;
    const T ls = m.claimer_share(j, t);
    // the lowest qualifying node past the cursor: fold in chunks of
    // kThreads nodes in index order and stop at the first chunk that holds
    // one (the nodes past it are neither chosen nor visited)
    T bs = T(0);
    int bc = 0, bi = -1;
    for (int base = (cursor + 1) / kThreads * kThreads; base < N; base += kThreads) {
      const int i = base + tid;
      if (i < N && flags[i] && i > cursor) {
        int vc;
        bool und;
        bool validate = m.fold_node(i, 2, j, qj, t, ls, vc, und);
        under_s[i] = und;
        if (validate) { bc = i; bi = i; }
      }
      m.reduce_best(bs, bc, bi);
      if (bi >= 0) break;
    }
    const bool any_p = bi >= 0;
    int zero = 0, uor = 0;
    for (int i = tid; i < N; i += kThreads) {
      bool visited = flags[i] && i > cursor && (!any_p || i <= bi);
      if (visited) uor |= under_s[i];
    }
    m.reduce_sum_or(zero, uor);
    if (tid == 0) {
      c.underflow |= uor;
      c.iters += 1;
      if (c.iters > N * V + 2) c.fail = 1;
      bool covered = false;
      if (any_p) {
        covered = m.cut(t, bi, nullptr);
        if (covered) m.pipeline(t, bi);
        c.cursor = bi;
      }
      if (covered) c.w_assigned = 1;
      c.wdone = !any_p || covered;
    }
    __syncthreads();
    if (c.wdone || c.fail) break;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reclaim_kernel(const __grid_constant__ Args<T> args) {
  __shared__ Ctl<T> ctl;
  __shared__ Red<T> red;
  Machine<T> m{args, ctl, red, (int)threadIdx.x};
  Ctl<T>& c = ctl;
  m.load_state(true);
  const int TT = m.d(D_T), JCAP = m.d(D_JCAP);
  const int budget = 4 * (TT + m.d(D_J) + m.d(D_Q)) + 64;
  for (;;) {
    if (c.qhsize <= 0 || c.fail) break;
    __syncthreads();
    if (m.tid == 0) {
      c.steps += 1;
      if (c.steps > budget) c.fail = 1;
      c.walk = 0;
      int q = m.heap_pop(m.template sc<int>(P_qheap), &c.qhsize, true);
      bool over = false;
      if (m.d(D_use_prop_overused)) {
        const T* qa = m.template sc<T>(P_queue_alloc);
        const T* des = m.template in<T>(P_queue_deserved);
        const T* eps = m.template in<T>(P_eps);
        over = m.template in<uint8_t>(P_queue_has_attr)[q] &&
               !le2(qa[2 * q], qa[2 * q + 1], des[2 * q], des[2 * q + 1], eps[0], eps[1]);
      }
      int* hsize = m.template sc<int>(P_hsize);
      if (!over && hsize[q] != 0) {
        int j = m.heap_pop(m.template sc<int>(P_heap) + (size_t)q * JCAP, &hsize[q], false);
        if (m.has_live(j)) {
          int* ptr = m.template sc<int>(P_ptr);
          int t = m.template in<int>(P_p_next)[min(max(ptr[j], 0), TT - 1)];
          ptr[j] = t + 1;
          c.walk = 1; c.t = t; c.j = j; c.q = q;
        }
      }
    }
    __syncthreads();
    if (c.walk) {
      const int t = c.t, j = c.j;
      __syncthreads();
      reclaim_walk(m, t, j);
      if (m.tid == 0 && c.w_assigned)
        m.heap_push(m.template sc<int>(P_qheap), &c.qhsize, c.q, true);
    }
    __syncthreads();
  }
  m.write_tail();
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, void* stream) {
  Args<T> a;
  for (int k = 0; k < P_COUNT; ++k) a.p[k] = ptrs[k];
  for (int k = 0; k < D_COUNT; ++k) a.d[k] = dims[k];
  if (a.d[D_N] <= 0 || a.d[D_V] <= 0 || a.d[D_L] <= 0 || a.d[D_QH] <= 0)
    return (int)cudaErrorInvalidValue;
  reclaim_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

EV_EXPORT_NAMES

extern "C" int evict_reclaim_f32(const void* const* ptrs, const int* dims, void* stream) {
  return launch<float>(ptrs, dims, stream);
}
extern "C" int evict_reclaim_f64(const void* const* ptrs, const int* dims, void* stream) {
  return launch<double>(ptrs, dims, stream);
}
