// Device functions shared by the eviction state machines K9 preempt
// (evict_preempt.cu) and K10 reclaim (evict_reclaim.cu), hand-written for
// Hopper (sm_90a). Port of the device helpers of volcano_tpu/ops/evict.py:
// _le2/_lt2/_share2 (:118-136), _window (:138), heapq's sift mechanics
// _heap_pop (:166) and _heap_push (:213), _job_less (:254), _queue_less
// (:290), the victim verdicts _gang_verdict/_prop_verdict/_drf_verdict and
// _victim_masks (:310-425), and the state mutators _log_append,
// _apply_evict_slot, _apply_pipeline and _discard (:426-525), which keep
// the consumed-candidate mask p_done (set on pipeline, cleared on discard)
// that the fused session chain carries from one stage to the next. K13
// fuse_heaps (fuse_heaps.cu) reuses job_less, queue_less and heap_push, so
// a heap rebuilt for the fused chain compares keys exactly as K9's and
// K10's pops compare them.
//
// Design: Machine holds an action's argument tables, its control scalars
// (Ctl, in shared memory) and the mutators and key compares the control
// thread runs: the heaps, the eviction cut, the op log and the pipeline
// over global scratch, and fold_node, the victim fold over global scratch
// rows that K9 and K10 take for rows wider than their register fold
// (evict_cluster.cuh, where the cluster machinery they share lives). A node
// fold walks its V victim slots in slot order, so every float fold keeps
// the reference's order. Mutable state lives in device scratch the wrapper
// allocates (the kernel copies the initial state in at its start). A
// kernel allocates nothing and does not synchronise the host.
//
// Arguments arrive as one table of pointers and one of sizes and flags
// (Args), whose order the X-macros below fix; the Python wrapper checks its
// own order against ev_ptr_names()/ev_dim_names() before every launch.
//
// Rounding: built with --fmad=false; every float expression keeps the
// order of the plain PyTorch version (ops/evict_kernels.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"

namespace ev {

constexpr unsigned kFull = 0xffffffffu;

constexpr int OP_EVICT = 0;
constexpr int OP_PIPELINE = 1;
constexpr int OP_COMMIT = 2;
constexpr int TAIL = 6;
constexpr double kShareDelta = 0.000001;  // drf.SHARE_DELTA

// job-order keys and victim fns (codes shared with ops/evict_kernels.py)
enum { KEY_PRIORITY = 0, KEY_GANG = 1, KEY_DRF = 2 };
enum { VF_GANG = 0, VF_CONFORMANCE = 1, VF_DRF = 2, VF_PROPORTION = 3 };

#define EV_INPUTS(X)                                                          \
  X(eps) X(node_used) X(node_alloc) X(node_cnt) X(node_max)                  \
  X(affinity_score) X(sig_mask) X(weights) X(binpack_w) X(drf_total)         \
  X(p_req) X(p_init) X(p_nz_cpu) X(p_nz_mem) X(p_sig) X(p_has_pod) X(p_job)  \
  X(job_task_start) X(job_task_end) X(job_prio) X(job_min_av) X(job_ready0)  \
  X(job_wait0) X(job_queue) X(job_alloc0) X(job_tie) X(queue_alloc0)         \
  X(queue_deserved) X(queue_has_attr) X(queue_tie) X(vic_req) X(vic_job)     \
  X(vic_queue) X(vic_valid) X(vic_alive0) X(vic_conf) X(vic_cut_perm)        \
  X(vic_samejob) X(vic_samequeue) X(node_real) X(real_n) X(rr0)              \
  X(num_to_find) X(p_next) X(heap0) X(hsize0) X(queue_real) X(under_jobs)    \
  X(qheap0) X(qhsize0) X(p_done0)
#define EV_SCRATCH(X)                                                         \
  X(used) X(cnt) X(alive) X(ready) X(wait) X(job_alloc) X(queue_alloc) X(ptr) \
  X(heap) X(hsize) X(qheap) X(score) X(circ) X(flags) X(vcnt) X(under) X(vm)  \
  X(iwork) X(fwork) X(cpos) X(out) X(p_done)
#define EV_DIMS(X)                                                            \
  X(N) X(V) X(T) X(J) X(Q) X(QP) X(JCAP) X(L) X(JU) X(QH) X(check_pod)       \
  X(use_nodeorder) X(use_binpack) X(use_gang_pipelined) X(use_prop_overused) \
  X(use_prop_queue_order) X(n_keys) X(key0) X(key1) X(key2) X(n_fns) X(fn0)  \
  X(fn1) X(fn2) X(fn3)

#define EV_PENUM(name) P_##name,
#define EV_DENUM(name) D_##name,
#define EV_STR(name) #name ","
enum { EV_INPUTS(EV_PENUM) EV_SCRATCH(EV_PENUM) P_COUNT };
enum { EV_DIMS(EV_DENUM) D_COUNT };

template <typename T>
struct Args {
  const void* p[P_COUNT];
  int d[D_COUNT];
};

// the per-run scalars, in shared memory
template <typename T>
struct Ctl {
  int log_len, rr, victims, attempts, fail, underflow, steps;
  int mode, qi, cur_job, phase2, assigned, stmt_start, u2, qhsize, q;
  int walk, t, j, first, cc, iters, wdone, host, cursor, any_p, chosen;
  int w_assigned;
  T cs;
};

template <typename T>
__device__ __forceinline__ bool le2(T l0, T l1, T r0, T r1, T e0, T e1) {
  return ((l0 < r0) || (fabs(l0 - r0) < e0)) && ((l1 < r1) || (fabs(l1 - r1) < e1));
}

template <typename T>
__device__ __forceinline__ bool lt2(T l0, T l1, T r0, T r1) {
  return (l0 < r0) && (l1 < r1);
}

template <typename T>
__device__ __forceinline__ T share1(T a, T t) {
  return t > T(0) ? a / t : (a == T(0) ? T(0) : T(1));
}

template <typename T>
__device__ __forceinline__ T share2(T a0, T a1, T t0, T t1) {
  T s0 = share1(a0, t0), s1 = share1(a1, t1);
  T m = s0 >= s1 ? s0 : s1;
  return m < T(0) ? T(0) : m;
}

template <typename T>
struct Machine {
  const Args<T>& a;
  Ctl<T>& c;
  int tid;

  // -- argument access -------------------------------------------------------
  template <typename U>
  __device__ __forceinline__ const U* in(int k) const { return (const U*)a.p[k]; }
  template <typename U>
  __device__ __forceinline__ U* sc(int k) const { return (U*)a.p[k]; }
  __device__ __forceinline__ int d(int k) const { return a.d[k]; }

  __device__ void write_tail() {
    if (tid == 0) {
      int* out = sc<int>(P_out) + 3 * d(D_L);
      out[0] = c.log_len; out[1] = c.rr; out[2] = c.victims;
      out[3] = c.attempts; out[4] = c.fail; out[5] = c.underflow;
    }
  }

  // -- keys (thread 0) ----------------------------------------------------------
  __device__ bool job_less(int x, int y) const {
    const int* ready = sc<int>(P_ready);
    const T* ja = sc<T>(P_job_alloc);
    const T* tot = in<T>(P_drf_total);
    for (int k = 0; k < d(D_n_keys); ++k) {
      int key = d(D_key0 + k);
      if (key == KEY_PRIORITY) {
        int px = in<int>(P_job_prio)[x], py = in<int>(P_job_prio)[y];
        if (px != py) return px > py;
      } else if (key == KEY_GANG) {
        bool rx = ready[x] >= in<int>(P_job_min_av)[x];
        bool ry = ready[y] >= in<int>(P_job_min_av)[y];
        if (rx != ry) return !rx && ry;
      } else if (key == KEY_DRF) {
        T sx = share2(ja[2 * x], ja[2 * x + 1], tot[0], tot[1]);
        T sy = share2(ja[2 * y], ja[2 * y + 1], tot[0], tot[1]);
        if (sx != sy) return sx < sy;
      }
    }
    return in<int>(P_job_tie)[x] < in<int>(P_job_tie)[y];
  }

  __device__ bool queue_less(int x, int y) const {
    if (d(D_use_prop_queue_order)) {
      const T* qa = sc<T>(P_queue_alloc);
      const T* des = in<T>(P_queue_deserved);
      T sx = share2(qa[2 * x], qa[2 * x + 1], des[2 * x], des[2 * x + 1]);
      T sy = share2(qa[2 * y], qa[2 * y + 1], des[2 * y], des[2 * y + 1]);
      if (sx != sy) return sx < sy;
    }
    return in<int>(P_queue_tie)[x] < in<int>(P_queue_tie)[y];
  }

  __device__ bool less(bool queues, int x, int y) const {
    return queues ? queue_less(x, y) : job_less(x, y);
  }

  // -- heapq mechanics (thread 0): exact heappop / heappush sift order ------
  __device__ int heap_pop(int* row, int* size, bool queues) const {
    int root = row[0];
    int last = row[*size - 1];
    int nsize = *size - 1;
    if (nsize > 0) {
      int pos = 0;
      while (2 * pos + 1 < nsize) {
        int child = 2 * pos + 1;
        int right = child + 1;
        if (right < nsize && !less(queues, row[child], row[right])) child = right;
        row[pos] = row[child];
        pos = child;
      }
      row[pos] = last;
      while (pos > 0 && less(queues, last, row[(pos - 1) / 2])) {
        int parent = (pos - 1) / 2;
        row[pos] = row[parent];
        pos = parent;
      }
      row[pos] = last;
    }
    *size = nsize;
    return root;
  }

  __device__ void heap_push(int* row, int* size, int item, bool queues) const {
    int pos = *size;
    row[pos] = item;
    while (pos > 0 && less(queues, item, row[(pos - 1) / 2])) {
      int parent = (pos - 1) / 2;
      row[pos] = row[parent];
      pos = parent;
    }
    row[pos] = item;
    *size = *size + 1;
  }

  __device__ bool has_live(int j) const {
    int p = sc<int>(P_ptr)[j], end = in<int>(P_job_task_end)[j];
    int tt = d(D_T);
    int nxt = in<int>(P_p_next)[min(max(p, 0), tt - 1)];
    return p < end && nxt < end;
  }

  // -- state mutators (thread 0; session-event twins) -------------------------
  __device__ void log_append(int kind, int x, int y, bool active) {
    const int L = d(D_L);
    if (active) {
      int i = min(c.log_len, L - 1);
      int* log = sc<int>(P_out);
      log[3 * i] = kind; log[3 * i + 1] = x; log[3 * i + 2] = y;
      c.log_len += 1;
    }
    if (c.log_len >= L) c.fail = 1;
  }

  __device__ void evict_slot(int node, int slot, bool active) {
    if (active) {
      size_t k = (size_t)node * d(D_V) + slot;
      int jv = in<int>(P_vic_job)[k], qv = in<int>(P_vic_queue)[k];
      T r0 = in<T>(P_vic_req)[2 * k], r1 = in<T>(P_vic_req)[2 * k + 1];
      sc<uint8_t>(P_alive)[k] = 0;
      sc<int>(P_ready)[jv] -= 1;
      T* ja = sc<T>(P_job_alloc);
      T* qa = sc<T>(P_queue_alloc);
      ja[2 * jv] = ja[2 * jv] - r0; ja[2 * jv + 1] = ja[2 * jv + 1] - r1;
      qa[2 * qv] = qa[2 * qv] - r0; qa[2 * qv + 1] = qa[2 * qv + 1] - r1;
    }
    log_append(OP_EVICT, node, slot, active);
  }

  __device__ void pipeline(int t, int node) {
    T r0 = in<T>(P_p_req)[2 * t], r1 = in<T>(P_p_req)[2 * t + 1];
    int j = in<int>(P_p_job)[t];
    int q = in<int>(P_job_queue)[j];
    T* used = sc<T>(P_used);
    T* ja = sc<T>(P_job_alloc);
    T* qa = sc<T>(P_queue_alloc);
    used[2 * node] = used[2 * node] + r0; used[2 * node + 1] = used[2 * node + 1] + r1;
    sc<int>(P_cnt)[node] += 1;
    sc<int>(P_wait)[j] += 1;
    ja[2 * j] = ja[2 * j] + r0; ja[2 * j + 1] = ja[2 * j + 1] + r1;
    qa[2 * q] = qa[2 * q] + r0; qa[2 * q + 1] = qa[2 * q + 1] + r1;
    // consumed-candidate mark: the fused chain hands it to the next stage
    // as its skip mask (a pipelined task is no longer PENDING)
    sc<uint8_t>(P_p_done)[t] = 1;
    log_append(OP_PIPELINE, t, node, true);
  }

  // the eviction cut at `node` (thread 0): victims in `perm` order
  // (preempt's reverse task order) or claimee order (perm == nullptr),
  // evicted one by one until the init request is covered; `got` takes one
  // add per evicted victim, in cut order
  __device__ bool cut(int t, int node, const int* perm) {
    const int V = d(D_V);
    const uint8_t* vm = sc<uint8_t>(P_vm) + (size_t)node * V;
    const T* req = in<T>(P_vic_req) + (size_t)node * V * 2;
    const T* eps = in<T>(P_eps);
    T n0 = in<T>(P_p_init)[2 * t], n1 = in<T>(P_p_init)[2 * t + 1];
    T g0 = T(0), g1 = T(0);
    bool covered = false;
    for (int p = 0; p < V; ++p) {
      int pv = perm != nullptr ? perm[p] : p;
      int slot = pv > 0 ? pv : 0;
      bool selp = pv >= 0 && vm[slot] && !covered;
      evict_slot(node, slot, selp);
      if (selp) {
        g0 = g0 + req[2 * slot];
        g1 = g1 + req[2 * slot + 1];
        covered = le2(n0, n1, g0, g1, eps[0], eps[1]);
      }
    }
    return covered;
  }

  // -- per-node folds ----------------------------------------------------------
  // claimee filter: 0 preempt across jobs of the queue, 1 preempt within
  // the job (phase 2), 2 reclaim across queues
  __device__ __forceinline__ bool claim(size_t k, int filt, int j, int qj) const {
    if (!sc<uint8_t>(P_alive)[k] || !in<uint8_t>(P_vic_valid)[k]) return false;
    int jv = in<int>(P_vic_job)[k], qv = in<int>(P_vic_queue)[k];
    if (filt == 0) return qv == qj && jv != j;
    if (filt == 1) return jv == j;
    return qv != qj;
  }

  // node i's victim row (the deciding-tier intersection, each fn over the
  // full claimee row, walked in slot order) into vm; returns validate and
  // sets vcnt/under
  __device__ bool fold_node(int i, int filt, int j, int qj, int t, T ls,
                            int& vcnt, bool& under) {
    const int V = d(D_V);
    const size_t base = (size_t)i * V;
    uint8_t* vmr = sc<uint8_t>(P_vm) + base;
    const T* req = in<T>(P_vic_req) + base * 2;
    const int* vjob = in<int>(P_vic_job) + base;
    const int* vq = in<int>(P_vic_queue) + base;
    const T* eps = in<T>(P_eps);
    for (int v = 0; v < V; ++v) vmr[v] = claim(base + v, filt, j, qj);
    under = false;
    for (int f = 0; f < d(D_n_fns); ++f) {
      int fn = d(D_fn0 + f);
      if (fn == VF_GANG) {
        int* used = sc<int>(P_iwork) + base;
        const uint8_t* same = in<uint8_t>(P_vic_samejob) + base * V;
        const int* ready = sc<int>(P_ready);
        const int* mav = in<int>(P_job_min_av);
        for (int w = 0; w < V; ++w) used[w] = 0;
        for (int v = 0; v < V; ++v) {
          bool av = claim(base + v, filt, j, qj);
          int jv = vjob[v];
          int b = ready[jv] - mav[jv];
          b = b > 0 ? b : 0;
          bool nom = av && (mav[jv] == 1 || used[v] < b);
          if (!nom) { vmr[v] = 0; continue; }
          for (int w = 0; w < V; ++w)
            if (same[(size_t)v * V + w]) used[w] += 1;
        }
      } else if (fn == VF_CONFORMANCE) {
        const uint8_t* conf = in<uint8_t>(P_vic_conf) + base;
        for (int v = 0; v < V; ++v)
          if (!conf[v]) vmr[v] = 0;
      } else if (fn == VF_DRF) {
        T* cur = sc<T>(P_fwork) + base * 2;
        const uint8_t* same = in<uint8_t>(P_vic_samejob) + base * V;
        const T* ja = sc<T>(P_job_alloc);
        const T* tot = in<T>(P_drf_total);
        for (int w = 0; w < V; ++w) {
          cur[2 * w] = ja[2 * vjob[w]];
          cur[2 * w + 1] = ja[2 * vjob[w] + 1];
        }
        for (int v = 0; v < V; ++v) {
          bool av = claim(base + v, filt, j, qj);
          T r0 = req[2 * v], r1 = req[2 * v + 1];
          T c0 = cur[2 * v], c1 = cur[2 * v + 1];
          if (av && !le2(r0, r1, c0, c1, eps[0], eps[1])) under = true;
          T rs = share2(c0 - r0, c1 - r1, tot[0], tot[1]);
          bool verdict = (ls < rs) || (fabs(ls - rs) <= T(kShareDelta));
          if (!(av && verdict)) vmr[v] = 0;
          if (av)
            for (int w = 0; w < V; ++w)
              if (same[(size_t)v * V + w]) {
                cur[2 * w] = cur[2 * w] - r0;
                cur[2 * w + 1] = cur[2 * w + 1] - r1;
              }
        }
      } else if (fn == VF_PROPORTION) {
        T* cur = sc<T>(P_fwork) + base * 2;
        const uint8_t* same = in<uint8_t>(P_vic_samequeue) + base * V;
        const T* qa = sc<T>(P_queue_alloc);
        const T* des = in<T>(P_queue_deserved);
        for (int w = 0; w < V; ++w) {
          cur[2 * w] = qa[2 * vq[w]];
          cur[2 * w + 1] = qa[2 * vq[w] + 1];
        }
        for (int v = 0; v < V; ++v) {
          bool av = claim(base + v, filt, j, qj);
          T r0 = req[2 * v], r1 = req[2 * v + 1];
          T c0 = cur[2 * v], c1 = cur[2 * v + 1];
          bool doit = av && !lt2(c0, c1, r0, r1);
          if (doit && !le2(r0, r1, c0, c1, eps[0], eps[1])) under = true;
          bool out = doit && le2(des[2 * vq[v]], des[2 * vq[v] + 1], c0 - r0, c1 - r1,
                                 eps[0], eps[1]);
          if (!out) vmr[v] = 0;
          if (doit)
            for (int w = 0; w < V; ++w)
              if (same[(size_t)v * V + w]) {
                cur[2 * w] = cur[2 * w] - r0;
                cur[2 * w + 1] = cur[2 * w + 1] - r1;
              }
        }
      }
    }
    // victim count and slot-order request sum, then validate
    vcnt = 0;
    T s0 = T(0), s1 = T(0);
    for (int v = 0; v < V; ++v)
      if (vmr[v]) {
        vcnt += 1;
        s0 = s0 + req[2 * v];
        s1 = s1 + req[2 * v + 1];
      }
    const T* init = in<T>(P_p_init) + 2 * t;
    return vcnt > 0 && !lt2(s0, s1, init[0], init[1]);
  }

};

}  // namespace ev

// the argument orders, for the wrapper's check
#define EV_EXPORT_NAMES                                                      \
  extern "C" const char* ev_ptr_names() {                                   \
    return EV_INPUTS(EV_STR) EV_SCRATCH(EV_STR);                            \
  }                                                                          \
  extern "C" const char* ev_dim_names() { return EV_DIMS(EV_STR); }
