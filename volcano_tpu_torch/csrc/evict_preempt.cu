// K9 evict_preempt: the whole preempt action as one state machine,
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/evict.py solve_preempt (:828) with
// preempt_machine (:678), _preempt_walk (:552) and _cut_preempt (:527):
// per-queue phase 1 (job heap pops, one statement per job, gang-pipelined
// commit or discard), then phase 2 (intra-job task-vs-task, one statement
// per task), interleaved per queue as the host loop runs them. Each
// preemptor task takes the round-robin window from rr, the fused scores of
// its candidates, and walks them in (score desc, circular position asc)
// order: every visited node adds its victim count to the metric, the first
// node whose victims validate takes the cut.
//
// One block of kThreads threads (evict_common.cuh): thread 0 runs the mode
// machine, the heaps, the cut and the op log; the block shares the window's
// circular scan, the score row and the victim folds, which it runs only
// over the window's nodes (no other node can be chosen or counted). Output:
// the packed int32 result, the flattened [L, 3] op log then the 6-wide
// tail.
//
// Bound: a sequential machine far from both of the card's bounds; the least
// time for the same work is its bytes (each input read once, the result
// written once) over the memory rate, a few microseconds at cfg4. One block
// on one SM is expected to be latency-bound by its barriers and thread 0's
// serial sections; a multi-block design is later work.

#include "evict_common.cuh"

namespace {

using namespace ev;

enum { M_QUEUE = 0, M_POP_JOB = 1, M_TASK = 2, M_STMT_END = 3, M_UNDER = 4, M_DONE = 5 };

template <typename T>
__device__ void preempt_walk(Machine<T>& m, int t, int j, int intra) {
  const int N = m.d(D_N), V = m.d(D_V);
  const int tid = m.tid;
  Ctl<T>& c = m.c;
  int* cpos = m.template sc<int>(P_cpos);
  int* circ = m.template sc<int>(P_circ);
  uint8_t* flags = m.template sc<uint8_t>(P_flags);
  T* score = m.template sc<T>(P_score);
  int* vcnt_s = m.template sc<int>(P_vcnt);
  uint8_t* under_s = m.template sc<uint8_t>(P_under);
  const uint8_t* real = m.template in<uint8_t>(P_node_real);
  const int rn = max(*m.template in<int>(P_real_n), 1);
  const int ntf = *m.template in<int>(P_num_to_find);
  const int rr0 = c.rr;

  // the round-robin window (_window): eligible real nodes ranked by an
  // exact scan in circular order from rr
  for (int i = tid; i < N; i += kThreads) cpos[i] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    bool rl = real[i];
    bool er = m.elig(t, i) && rl;
    int ci = rl ? (((i - rr0) % rn) + rn) % rn : N;
    circ[i] = ci;
    flags[i] = er;
    if (er) atomicAdd(&cpos[min(ci, N - 1)], 1);
  }
  __syncthreads();
  m.scan_inplace(cpos, N);
  const T* req = m.template in<T>(P_p_req) + 2 * t;
  const T nz_cpu = m.template in<T>(P_p_nz_cpu)[t];
  const T nz_mem = m.template in<T>(P_p_nz_mem)[t];
  const int sig = m.template in<int>(P_p_sig)[t];
  const T* used = m.template sc<T>(P_used);
  const T* alloc = m.template in<T>(P_node_alloc);
  const T* aff = m.template in<T>(P_affinity_score) + (size_t)sig * N;
  const T* bw = m.template in<T>(P_binpack_w);
  const T* wts = m.template in<T>(P_weights);
  int kth = N;
  for (int i = tid; i < N; i += kThreads) {
    if (cpos[i] >= ntf) kth = min(kth, i);
    int ci = circ[i];
    flags[i] = flags[i] && cpos[min(ci, N - 1)] <= ntf;
    score[i] = scorefn::fused_score<T>(2, req, nz_cpu, nz_mem, used + 2 * i,
                                       alloc + 2 * i, aff[i], bw, wts,
                                       m.d(D_use_nodeorder) != 0,
                                       m.d(D_use_binpack) != 0);
  }
  kth = m.reduce_min(kth);
  if (tid == 0) {
    int found_total = cpos[N - 1];
    int processed = found_total >= ntf ? kth + 1 : rn;
    c.rr = (rr0 + processed) % rn;
    c.first = 1; c.cs = T(0); c.cc = -1; c.iters = 0; c.host = -1; c.wdone = 0;
  }
  __syncthreads();

  const int qj = m.template in<int>(P_job_queue)[j];
  const int filt = intra ? 1 : 0;
  for (;;) {
    const int first = c.first;
    const T cs = c.cs;
    const int cc = c.cc;
    const T ls = m.claimer_share(j, t);
    T bs = T(0);
    int bc = 0, bi = -1;
    for (int i = tid; i < N; i += kThreads) {
      // a node outside the window is never chosen nor counted: its fold
      // would change nothing, so only the window's nodes are folded
      if (!(flags[i] & 1)) continue;
      int vc;
      bool und;
      bool validate = m.fold_node(i, filt, j, qj, t, ls, vc, und);
      T sc_i = score[i];
      int ci = circ[i];
      bool after = first || sc_i < cs || (sc_i == cs && ci > cc);
      flags[i] = (uint8_t)(1 | (after << 1));
      vcnt_s[i] = vc;
      under_s[i] = und;
      if (validate && after && better(sc_i, ci, i, bs, bc, bi)) {
        bs = sc_i; bc = ci; bi = i;
      }
    }
    m.reduce_best(bs, bc, bi);
    const bool any_p = bi >= 0;
    int vsum = 0, uor = 0;
    for (int i = tid; i < N; i += kThreads) {
      uint8_t fl = flags[i];
      bool visited = (fl & 1) && (fl & 2);
      if (any_p) {
        T sc_i = score[i];
        int ci = circ[i];
        visited = visited && (sc_i > bs || (sc_i == bs && ci <= bc));
      }
      if (visited) {
        vsum += vcnt_s[i];
        uor |= under_s[i];
      }
    }
    m.reduce_sum_or(vsum, uor);
    if (tid == 0) {
      c.victims += vsum;
      c.underflow |= uor;
      c.iters += 1;
      if (c.iters > N * V + 2) c.fail = 1;
      bool covered = false;
      if (any_p) {
        c.attempts += 1;
        covered = m.cut(t, bi, m.template in<int>(P_vic_cut_perm) + (size_t)bi * V);
        if (covered) m.pipeline(t, bi);
      }
      bool done = !any_p || covered;
      if (done) c.host = covered ? bi : -1;
      c.first = 0;
      if (any_p) { c.cs = bs; c.cc = bc; }
      c.wdone = done;
    }
    __syncthreads();
    if (c.wdone || c.fail) break;
    __syncthreads();
  }
}

// one control step of the mode machine (thread 0)
template <typename T>
__device__ void control_step(Machine<T>& m) {
  Ctl<T>& c = m.c;
  const int QP = m.d(D_QP), JU = m.d(D_JU), JCAP = m.d(D_JCAP);
  int* hsize = m.template sc<int>(P_hsize);
  int* heap = m.template sc<int>(P_heap);
  if (c.mode == M_QUEUE) {
    bool past = c.qi >= QP;
    bool real = m.template in<uint8_t>(P_queue_real)[min(c.qi, QP - 1)];
    if (past) c.mode = M_DONE;
    else if (real) c.mode = M_POP_JOB;
    else c.qi += 1;
  } else if (c.mode == M_POP_JOB) {
    if (hsize[c.qi] == 0) {
      c.u2 = 0;
      c.mode = M_UNDER;
    } else {
      c.cur_job = m.heap_pop(heap + (size_t)c.qi * JCAP, &hsize[c.qi], false);
      c.stmt_start = c.log_len;
      c.assigned = 0;
      c.phase2 = 0;
      c.mode = M_TASK;
    }
  } else if (c.mode == M_STMT_END) {
    int j = c.cur_job;
    bool pl = !m.d(D_use_gang_pipelined) ||
              m.template sc<int>(P_wait)[j] + m.template sc<int>(P_ready)[j] >=
                  m.template in<int>(P_job_min_av)[j];
    if (pl) {
      m.log_append(OP_COMMIT, 0, 0, c.log_len > c.stmt_start);
      if (c.assigned) m.heap_push(heap + (size_t)c.qi * JCAP, &hsize[c.qi], j, false);
    } else {
      m.discard(c.stmt_start);
    }
    c.mode = M_POP_JOB;
  } else if (c.mode == M_UNDER) {
    bool past = c.u2 >= JU;
    int j = m.template in<int>(P_under_jobs)[min(c.u2, JU - 1)];
    bool has = !past && j >= 0 && m.has_live(max(j, 0));
    if (has) c.cur_job = j;
    c.phase2 = 1;
    if (past) {
      c.mode = M_QUEUE;
      c.qi += 1;
    } else if (has) {
      c.mode = M_TASK;
    } else {
      c.u2 += 1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    preempt_kernel(const __grid_constant__ Args<T> args) {
  __shared__ Ctl<T> ctl;
  __shared__ Red<T> red;
  Machine<T> m{args, ctl, red, (int)threadIdx.x};
  Ctl<T>& c = ctl;
  m.load_state(false);
  const int TT = m.d(D_T);
  const int budget = 8 * (TT + m.d(D_J) + m.d(D_QP) + m.d(D_JU)) + 64;
  for (;;) {
    if (c.mode == M_DONE || c.fail) break;
    __syncthreads();
    if (m.tid == 0) {
      c.steps += 1;
      if (c.steps > budget) c.fail = 1;
      c.walk = 0;
      if (c.mode == M_TASK) {
        int j = c.cur_job;
        if (!m.has_live(j)) {
          c.mode = c.phase2 ? M_UNDER : M_STMT_END;
          if (c.phase2) c.u2 += 1;
        } else {
          int* ptr = m.template sc<int>(P_ptr);
          int t = m.template in<int>(P_p_next)[min(max(ptr[j], 0), TT - 1)];
          ptr[j] = t + 1;
          if (c.phase2) c.stmt_start = c.log_len;
          c.walk = 1; c.t = t; c.j = j;
        }
      } else {
        control_step(m);
      }
    }
    __syncthreads();
    if (c.walk) {
      const int t = c.t, j = c.j, intra = c.phase2;
      __syncthreads();
      preempt_walk(m, t, j, intra);
      if (m.tid == 0) {
        int host = c.host;
        bool phase2 = c.phase2;
        if (!phase2 && host >= 0) c.assigned = 1;
        bool pl = !m.d(D_use_gang_pipelined) ||
                  m.template sc<int>(P_wait)[j] + m.template sc<int>(P_ready)[j] >=
                      m.template in<int>(P_job_min_av)[j];
        m.log_append(OP_COMMIT, 0, 0, phase2 && c.log_len > c.stmt_start);
        bool miss2 = phase2 && host < 0;
        if (miss2) {
          c.u2 += 1;
          c.mode = M_UNDER;
        } else if (!phase2 && pl) {
          c.mode = M_STMT_END;
        } else {
          c.mode = M_TASK;
        }
      }
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
  if (a.d[D_N] <= 0 || a.d[D_V] <= 0 || a.d[D_L] <= 0 || a.d[D_QP] <= 0)
    return (int)cudaErrorInvalidValue;
  preempt_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

EV_EXPORT_NAMES

extern "C" int evict_preempt_f32(const void* const* ptrs, const int* dims, void* stream) {
  return launch<float>(ptrs, dims, stream);
}
extern "C" int evict_preempt_f64(const void* const* ptrs, const int* dims, void* stream) {
  return launch<double>(ptrs, dims, stream);
}
