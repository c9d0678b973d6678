// K9 evict_preempt: the whole preempt action as one state machine on a
// thread-block cluster, hand-written for Hopper (sm_90a).
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
// Bound: a sequential machine far from both of the card's bounds (the
// least time for the same work, its operations at the card's peak, is
// about 0.01 ms at cfg4). It is latency-bound: what counts is the depth of
// each walk's critical path. The previous design ran the action on one CTA
// of 512 threads: about 70 block barriers a walk over the whole node axis
// in global memory, and a victim fold whose per-slot counters lived in
// global memory (V^2 read-modify-writes a node); 65 us a walk at cfg4 on
// an H100.
//
// Design (the cluster machinery, the register fold, the job heap, the cut
// and the launch live in evict_cluster.cuh, shared with K10):
// - One cluster of 16 CTAs (a non-portable cluster size, which every
//   Hopper card runs) of 256 threads. CTA r owns the node slice [r*S,
//   r*S + S), S = ceil(N/16), and keeps that slice's `used` and `cnt` (and
//   its share of the window list) in its own shared memory; a shape whose
//   slices do not fit there keeps them in a global buffer of 16 slices
//   instead, with the same code. CTA 0's thread 0 runs the control machine
//   (the heaps, the cut, the pipeline, the op log and the discard replay,
//   all as evict_common.cuh's Machine has them) and writes a chosen node's
//   `used`/`cnt` into the owning CTA's slice (distributed shared memory).
//   Cluster barriers (hardware) replace block barriers; victim rows, job
//   and queue state stay in global memory (L2-resident at cfg4; the folds
//   read the mutable state with ld.cg).
// - The window in one scan. The reference's count at circular position
//   c(i) (volcano_tpu/ops/evict.py:138-163) is, where the real slots are the
//   prefix [0, real_n) (the reference appends its pad), a rotation of one
//   prefix sum P of the eligible real nodes in node order: P[i] - P[rr-1]
//   for i >= rr, P[rn-1] - P[rr-1] + P[i] for i < rr. Each thread scans a
//   contiguous run of its CTA's slice (a bit mask where the run is at most
//   32 nodes), one block scan gives the runs' offsets, the CTAs' totals
//   cross through distributed shared memory after one cluster barrier: no
//   atomics, no clear. The same counts give kth (the node whose count is
//   num_to_find) and `processed`. Any other layout takes the reference's
//   own arithmetic (window_any): a histogram of the circular positions,
//   its scan, and a slot a selected node takes from its position's count.
// - The window compacted once a walk: a selected node's count is its rank
//   in circular order, so its entry (node, circular position, fused score)
//   goes straight to slot rank of a list spread round-robin over the CTAs'
//   slices. Each candidate iteration folds the list (at most num_to_find
//   nodes, one a thread), not the node axis, and only the entries still
//   after the previous candidate.
// - The fold keeps its state in registers: claim, nominate and do-it bits
//   as 64-bit masks; gang's per-slot occupancy counters packed one byte a
//   slot (the same-job row, V bytes of 0/1, adds to them as words); the drf
//   and proportion walks read slot v's current share as its start value
//   minus the earlier same-job (same-queue) slots' requests, subtracted in
//   slot order. The fns read nothing of one another, so one pass over the
//   slots runs them all; a chunk of slots loads its rows and job state
//   together before the pass walks it. One thread still folds a node's V
//   slots in slot order, so every float keeps the reference's operation
//   order. V is a template parameter of the kernel for the encoder's
//   buckets 16..256; a wider row (a node of more than 256 victims) folds
//   with Machine::fold_node over global scratch rows (V = 0 below).
// - Reductions keep (score desc, circular position asc, node asc); counts
//   are exact int32. One launch an action, per-action and fused, no host sync. The
//   machine's fail bit trips only on the reference's budgets (the op log's
//   length, the step budget, iters > N*V+2).
// - Built with -DK9_PROFILE, PROF(k) marks add CTA 0 thread 0's clock
//   between marks to phase k's counter (volcano_tpu_torch/bench/
//   kernel_profile.py reads them); otherwise they compile to nothing.

// Output: the packed int32 result (the flattened [L, 3] op log then the
// 6-wide tail) and the final state in the wrapper's scratch (the fused
// chain's carry).
//
// Rounding: built with --fmad=false; every float expression keeps the
// order of the plain PyTorch version (ops/evict_kernels.py).

#include "evict_cluster.cuh"

#ifdef K9_PROFILE
constexpr int kProfPhases = 18;
__device__ long long k9_prof_t[kProfPhases];
__device__ long long k9_prof_last;
#define PROF(k)                                                  \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      const long long now_ = clock64();                          \
      k9_prof_t[k] += now_ - k9_prof_last;                       \
      k9_prof_last = now_;                                       \
    }                                                            \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      for (int k_ = 0; k_ < kProfPhases; ++k_) k9_prof_t[k_] = 0; \
      k9_prof_last = clock64();                                  \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_START() do {} while (0)
#endif

namespace {

using namespace ev;
using namespace evc;

constexpr int kMaxRun = 32;   // window nodes a thread keeps as a bit mask

enum { M_QUEUE = 0, M_POP_JOB = 1, M_TASK = 2, M_STMT_END = 3, M_UNDER = 4, M_DONE = 5 };
enum { RUN_STOP = 0, RUN_WALK = 1, RUN_NEXT = 2 };
// a list entry's fold result: victim count, then flags
constexpr int OUT_VALID = 1 << 16, OUT_AFTER = 1 << 17, OUT_UNDER = 1 << 18;

// the cluster's node state in contiguous slices: `used`/`cnt` are this
// CTA's slice arrays, a node's row lives in the slice of CTA node / S
template <typename T>
struct Nodes {
  Slices sl;
  T* used_s;
  int* cnt_s;
  int S;
  __device__ T* used(int node) const {
    int o = node / S;
    return sl.rem(used_s, o) + 2 * (node - o * S);
  }
  __device__ int* cnt(int node) const {
    int o = node / S;
    return sl.rem(cnt_s, o) + (node - o * S);
  }
};

// CTA 0 thread 0's order to every CTA, written into each CTA before a
// cluster barrier
template <typename T>
struct Cmd {
  int run, t, j, intra, rr, first, cc;
  T cs;
};

template <typename T>
struct Best {
  T s;
  int c, i, pos, rank;
};

// what other CTAs read of a CTA, after a cluster barrier; CTA 0's last
// fields are written by the others: kth (the window's), the visited sums
// (atomics) and the chosen entry's victim mask
template <typename T>
struct Pub {
  int tot, pre_rr, bad, kth, vsum, uor, sel;
  Best<T> best;
  uint64_t gvm[kMaxMW];
};

// CTA-local values of the current walk
template <typename T>
struct Loc {
  int found, off, prr, list_len;
  Best<T> gbest;
};

// a CTA's dynamic shared memory: its node slice's state, then its share of
// the window list
template <typename T>
struct View {
  uint64_t* vm;   // [S * MW] an entry's victim mask
  T* used;        // [2 * S] the slice's used
  T* score;       // [S] an entry's fused score
  int* cnt;       // [S] the slice's pod count
  int* idx;       // [S] an entry's node
  int* circ;      // [S] an entry's circular position
  int* out;       // [S] an entry's fold result
};

__host__ __device__ inline size_t smem_bytes(int S, int MW, int tsize) {
  return (size_t)S * (8 * MW + 3 * tsize + 16);
}

// a slice's bytes, rounded up so that slices in a global buffer stay aligned
__host__ __device__ inline size_t slice_bytes(int S, int MW, int tsize) {
  return (smem_bytes(S, MW, tsize) + 15) / 16 * 16;
}

template <typename T>
__device__ View<T> carve(unsigned char* base, int S, int MW) {
  View<T> v;
  v.vm = reinterpret_cast<uint64_t*>(base);
  v.used = reinterpret_cast<T*>(v.vm + (size_t)S * MW);
  v.score = v.used + 2 * S;
  v.cnt = reinterpret_cast<int*>(v.score + S);
  v.idx = v.cnt + S;
  v.circ = v.idx + S;
  v.out = v.circ + S;
  return v;
}

// -- block reductions (every thread calls) -------------------------------------

// the candidate order (score desc, circular position asc, node asc):
// circular positions are distinct where the real slots are the prefix
// [0, real_n); elsewhere nodes can share one, and the lowest node wins, as
// the reference's argmin over the candidates' positions
template <typename T>
__device__ __forceinline__ bool ahead(T s1, int c1, int i1, T s2, int c2, int i2) {
  if (i1 < 0) return false;
  if (i2 < 0) return true;
  if (s1 != s2) return s1 > s2;
  if (c1 != c2) return c1 < c2;
  return i1 < i2;
}

template <typename T>
__device__ void block_best(Best<T>& b, Best<T>* scr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best<T> o;
    o.s = __shfl_down_sync(kFull, b.s, off);
    o.c = __shfl_down_sync(kFull, b.c, off);
    o.i = __shfl_down_sync(kFull, b.i, off);
    o.pos = __shfl_down_sync(kFull, b.pos, off);
    if (ahead(o.s, o.c, o.i, b.s, b.c, b.i)) b = o;
  }
  if (lane == 0) scr[warp] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCtaWarps; ++w)
      if (ahead(scr[w].s, scr[w].c, scr[w].i, b.s, b.c, b.i)) b = scr[w];
    scr[0] = b;
  }
  __syncthreads();
  b = scr[0];
  __syncthreads();
}

__device__ void block_sum_or(int& v, int& f, int* sv, int* sf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
    f |= __shfl_down_sync(kFull, f, off);
  }
  if (lane == 0) {
    sv[warp] = v;
    sf[warp] = f;
  }
  __syncthreads();
  v = 0;
  f = 0;
#pragma unroll
  for (int w = 0; w < kCtaWarps; ++w) {
    v += sv[w];
    f |= sf[w];
  }
  __syncthreads();
}

// exclusive prefix of x over the block's threads; `total` gets the sum
__device__ int block_excl(int x, int* scr, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) scr[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kCtaWarps; ++w) {
    before += w < warp ? scr[w] : 0;
    total += scr[w];
  }
  __syncthreads();
  return before + incl - x;
}

// Statement.discard: the open segment's ops undone in REVERSE order by
// inverse float ops
template <typename T>
__device__ void discard(Machine<T>& m, const Nodes<T>& nd, int stmt_start) {
  const int V = m.d(D_V);
  const int* log = m.template sc<int>(P_out);
  T* ja = m.template sc<T>(P_job_alloc);
  T* qa = m.template sc<T>(P_queue_alloc);
  Ctl<T>& c = m.c;
  while (c.log_len > stmt_start) {
    int i = c.log_len - 1;
    int kind = log[3 * i], x = log[3 * i + 1], y = log[3 * i + 2];
    if (kind == OP_EVICT) {
      size_t k = (size_t)x * V + y;
      int jv = m.template in<int>(P_vic_job)[k], qv = m.template in<int>(P_vic_queue)[k];
      T r0 = m.template in<T>(P_vic_req)[2 * k], r1 = m.template in<T>(P_vic_req)[2 * k + 1];
      m.template sc<uint8_t>(P_alive)[k] = 1;
      m.template sc<int>(P_ready)[jv] += 1;
      ja[2 * jv] = ja[2 * jv] + r0; ja[2 * jv + 1] = ja[2 * jv + 1] + r1;
      qa[2 * qv] = qa[2 * qv] + r0; qa[2 * qv + 1] = qa[2 * qv + 1] + r1;
    } else if (kind == OP_PIPELINE) {
      T r0 = m.template in<T>(P_p_req)[2 * x], r1 = m.template in<T>(P_p_req)[2 * x + 1];
      int pj = m.template in<int>(P_p_job)[x];
      int pq = m.template in<int>(P_job_queue)[pj];
      T* u = nd.used(y);
      u[0] = u[0] - r0;
      u[1] = u[1] - r1;
      *nd.cnt(y) -= 1;
      m.template sc<int>(P_wait)[pj] -= 1;
      ja[2 * pj] = ja[2 * pj] - r0; ja[2 * pj + 1] = ja[2 * pj + 1] - r1;
      qa[2 * pq] = qa[2 * pq] - r0; qa[2 * pq + 1] = qa[2 * pq + 1] - r1;
      m.template sc<uint8_t>(P_p_done)[x] = 0;
    }
    c.log_len = i;
  }
}

// one control step of the mode machine (not M_TASK)
template <typename T>
__device__ void control_step(Machine<T>& m, const Nodes<T>& nd) {
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
      PROF(14);
      c.cur_job = heap_pop(m, heap + (size_t)c.qi * JCAP, &hsize[c.qi]);
      PROF(15);
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
      if (c.assigned) {
        PROF(14);
        heap_push(m, heap + (size_t)c.qi * JCAP, &hsize[c.qi], j);
        PROF(16);
      }
    } else {
      discard(m, nd, c.stmt_start);
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

// CTA 0 thread 0, between cluster barriers: ends the walk iteration that just
// ran (its best and visited sums are in the CTAs' Pub), then runs control
// steps until a walk starts or the machine stops, and orders every CTA
template <typename T, int V0>
__device__ void decide(Machine<T>& m, const Nodes<T>& nd, Pub<T>* pub, const Loc<T>& loc,
                       Cmd<T>* cmd, int budget) {
  Ctl<T>& c = m.c;
  const cg::cluster_group& cl = nd.sl.cl;
  const int N = m.d(D_N), V = m.d(D_V), TT = m.d(D_T);
  if (c.walk) {
    if (c.first) {
      // the walk's window: rr moves past the processed nodes
      const int rn = max(*m.template in<int>(P_real_n), 1);
      const int ntf = *m.template in<int>(P_num_to_find);
      const int kth = ntf <= 0 ? 0 : pub->kth;
      const int processed = loc.found >= ntf ? kth + 1 : rn;
      c.rr = (c.rr + processed) % rn;
    }
    const int vsum = pub->vsum, uor = pub->uor;
    pub->vsum = 0;
    pub->uor = 0;
    const Best<T> gb = loc.gbest;
    const bool any_p = gb.i >= 0;
    c.victims += vsum;
    c.underflow |= uor;
    c.iters += 1;
    if (c.iters > N * V + 2) c.fail = 1;
    bool covered = false;
    if (any_p) {
      c.attempts += 1;
      // V0 = 0: the fold left the victim mask in the node's global row
      if constexpr (V0 == 0)
        covered = m.cut(c.t, gb.i, m.template in<int>(P_vic_cut_perm) + (size_t)gb.i * V);
      else
        covered = cut<true>(m, c.t, gb.i, pub->gvm);
      PROF(17);
      if (covered) pipeline(m, nd, c.t, gb.i);
    }
    PROF(12);
    const bool done = !any_p || covered;
    if (done) c.host = covered ? gb.i : -1;
    c.first = 0;
    if (any_p) {
      c.cs = gb.s;
      c.cc = gb.c;
    }
    if (!done && !c.fail) {
      push(cl, cmd, Cmd<T>{RUN_NEXT, c.t, c.j, c.phase2, c.rr, 0, c.cc, c.cs});
      return;
    }
    // the walk is over
    c.walk = 0;
    const int j = c.j, host = c.host;
    const bool phase2 = c.phase2;
    if (!phase2 && host >= 0) c.assigned = 1;
    bool pl = !m.d(D_use_gang_pipelined) ||
              m.template sc<int>(P_wait)[j] + m.template sc<int>(P_ready)[j] >=
                  m.template in<int>(P_job_min_av)[j];
    m.log_append(OP_COMMIT, 0, 0, phase2 && c.log_len > c.stmt_start);
    if (phase2 && host < 0) {
      c.u2 += 1;
      c.mode = M_UNDER;
    } else if (!phase2 && pl) {
      c.mode = M_STMT_END;
    } else {
      c.mode = M_TASK;
    }
  }
  PROF(13);
  for (;;) {
    if (c.mode == M_DONE || c.fail) {
      push(cl, cmd, Cmd<T>{RUN_STOP, 0, 0, 0, 0, 0, 0, T(0)});
      return;
    }
    c.steps += 1;
    if (c.steps > budget) c.fail = 1;
    if (c.mode != M_TASK) {
      control_step(m, nd);
      continue;
    }
    const int j = c.cur_job;
    if (!m.has_live(j)) {
      c.mode = c.phase2 ? M_UNDER : M_STMT_END;
      if (c.phase2) c.u2 += 1;
      continue;
    }
    int* ptr = m.template sc<int>(P_ptr);
    const int t = m.template in<int>(P_p_next)[min(max(ptr[j], 0), TT - 1)];
    ptr[j] = t + 1;
    if (c.phase2) c.stmt_start = c.log_len;
    c.t = t;
    c.j = j;
    c.walk = 1;
    c.first = 1;
    c.cs = T(0);
    c.cc = -1;
    c.iters = 0;
    c.host = -1;
    push(cl, cmd, Cmd<T>{RUN_WALK, t, j, c.phase2, c.rr, 1, -1, T(0)});
    return;
  }
}

// -- the walk's candidate iteration (every CTA) ---------------------------------

template <typename T, int V>
__device__ void iterate(Machine<T>& m, const cg::cluster_group& cl, const View<T>& sm,
                        const Cmd<T>& cm, Pub<T>* pub, Loc<T>* loc, Best<T>* bscr,
                        int* sv, int* sf) {
  constexpr int MW = (V + 63) / 64;
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = loc->list_len;
  const int mine = len > r ? (len - 1 - r) / C + 1 : 0;
  const int j = cm.j, t = cm.t;
  const int qj = m.template in<int>(P_job_queue)[j];
  const int filt = cm.intra ? 1 : 0;
  const Fns fns = fns_of(m);
  // the claimer's drf share with its request added
  T ls = T(0);
  if (fns.drf) {
    const T* ja = m.template sc<T>(P_job_alloc);
    const T* tot = m.template in<T>(P_drf_total);
    const T* preq = m.template in<T>(P_p_req) + 2 * t;
    ls = share2(__ldcg(ja + 2 * j) + preq[0], __ldcg(ja + 2 * j + 1) + preq[1], tot[0], tot[1]);
  }
  // entry p to lane p / kCtaWarps of warp p % kCtaWarps: a short list
  // spreads over every warp, and a warp's loads over few nodes
  Best<T> b{T(0), 0, -1, 0, r};
  for (int p = lane * kCtaWarps + warp; p < mine; p += kCta) {
    const T s = sm.score[p];
    const int ci = sm.circ[p];
    const bool after = cm.first || s < cm.cs || (s == cm.cs && ci > cm.cc);
    int out = 0;
    if (after) {
      int vc;
      bool und;
      const int i = sm.idx[p];
      bool val;
      if constexpr (V == 0)
        val = m.fold_node(i, filt, j, qj, t, ls, vc, und);
      else
        val = fold_node<T, V>(m, fns, i, filt, j, qj, t, ls, vc, und, sm.vm + (size_t)p * MW);
      out = vc | OUT_AFTER | (val ? OUT_VALID : 0) | (und ? OUT_UNDER : 0);
      if (val && ahead(s, ci, i, b.s, b.c, b.i)) {
        b.s = s; b.c = ci; b.i = i; b.pos = p;
      }
    }
    sm.out[p] = out;
  }
  PROF(5);
  block_best(b, bscr);
  PROF(6);
  if (tid == 0) {
    b.rank = r;
    pub->best = b;
  }
  cl.sync();
  PROF(7);
  // the cluster's best (score desc, circular position asc)
  if (warp == 0) {
    Best<T> g{T(0), 0, -1, 0, 0};
    if (lane < C) g = cl.map_shared_rank(pub, lane)->best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best<T> o;
      o.s = __shfl_down_sync(kFull, g.s, off);
      o.c = __shfl_down_sync(kFull, g.c, off);
      o.i = __shfl_down_sync(kFull, g.i, off);
      o.pos = __shfl_down_sync(kFull, g.pos, off);
      o.rank = __shfl_down_sync(kFull, g.rank, off);
      if (ahead(o.s, o.c, o.i, g.s, g.c, g.i)) g = o;
    }
    if (lane == 0) loc->gbest = g;
  }
  __syncthreads();
  const Best<T> g = loc->gbest;
  const bool any_p = g.i >= 0;
  // the chosen entry's victim mask, for CTA 0's cut
  if (any_p && r == g.rank && tid == 0)
    for (int w = 0; w < MW; ++w) cl.map_shared_rank(pub, 0)->gvm[w] = sm.vm[(size_t)g.pos * MW + w];
  // the visited nodes: after the previous candidate, up to the chosen one
  int vs = 0, uo = 0;
  for (int p = tid; p < mine; p += kCta) {
    const int out = sm.out[p];
    if (!(out & OUT_AFTER)) continue;
    const T s = sm.score[p];
    const int ci = sm.circ[p];
    if (!any_p || s > g.s || (s == g.s && ci <= g.c)) {
      vs += out & 0xffff;
      uo |= (out & OUT_UNDER) ? 1 : 0;
    }
  }
  block_sum_or(vs, uo, sv, sf);
  if (tid == 0 && (vs || uo)) {
    Pub<T>* p0 = cl.map_shared_rank(pub, 0);
    atomicAdd(&p0->vsum, vs);
    atomicOr(&p0->uor, uo);
  }
  PROF(8);
  cl.sync();
  PROF(9);
}

// -- the round-robin window (every CTA) ------------------------------------------

// the walk's inputs of the window: a node's eligibility (real, the
// signature's mask, pod headroom) and its fused score's operands
template <typename T>
struct Win {
  int N, rn, ntf, rr, lo, hi, S;
  const uint8_t* mask;
  const uint8_t* real;
  const int* nmax;
  bool pod;
  const T* req;
  T nz_cpu, nz_mem;
  const T* aff;
  __device__ Win(const Machine<T>& m, const Cmd<T>& cm, int lo_, int hi_, int S_)
      : lo(lo_), hi(hi_), S(S_) {
    const int t = cm.t;
    N = m.d(D_N);
    rn = max(*m.template in<int>(P_real_n), 1);
    ntf = *m.template in<int>(P_num_to_find);
    rr = ((cm.rr % rn) + rn) % rn;
    const int sig = m.template in<int>(P_p_sig)[t];
    mask = m.template in<uint8_t>(P_sig_mask) + (size_t)sig * N;
    real = m.template in<uint8_t>(P_node_real);
    nmax = m.template in<int>(P_node_max);
    pod = m.d(D_check_pod) && m.template in<uint8_t>(P_p_has_pod)[t];
    req = m.template in<T>(P_p_req) + 2 * t;
    nz_cpu = m.template in<T>(P_p_nz_cpu)[t];
    nz_mem = m.template in<T>(P_p_nz_mem)[t];
    aff = m.template in<T>(P_affinity_score) + (size_t)sig * N;
  }
  __device__ bool er(const View<T>& sm, int i) const {
    return real[i] && mask[i] && (!pod || sm.cnt[i - lo] < nmax[i]);
  }
};

// a selected node's list entry: slot s of the list, spread round-robin
// over the CTAs' slices
template <typename T>
__device__ void put_entry(const Machine<T>& m, const Slices& sl, const View<T>& sm,
                          const Win<T>& w, int i, int circ, int s) {
  const int C = (int)sl.cl.num_blocks();
  const T score = scorefn::fused_score<T>(
      2, w.req, w.nz_cpu, w.nz_mem, sm.used + 2 * (i - w.lo),
      m.template in<T>(P_node_alloc) + 2 * i, w.aff[i], m.template in<T>(P_binpack_w),
      m.template in<T>(P_weights), m.d(D_use_nodeorder) != 0, m.d(D_use_binpack) != 0);
  const int dst = s % C, pos = s / C;
  sl.rem(sm.idx, dst)[pos] = i;
  sl.rem(sm.circ, dst)[pos] = circ;
  sl.rem(sm.score, dst)[pos] = score;
}

// real slots the prefix [0, real_n): the rotation of one prefix sum
template <typename T>
__device__ void window(const Machine<T>& m, const Slices& sl, const View<T>& sm,
                       const Cmd<T>& cm, Pub<T>* pub, Loc<T>* loc, int* scr, int lo, int hi,
                       int S) {
  const cg::cluster_group& cl = sl.cl;
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Win<T> w(m, cm, lo, hi, S);
  const int rr = w.rr, ntf = w.ntf, rn = w.rn;
  // eligible real nodes of this thread's run: counted, and kept as bits
  // where the run is at most kMaxRun nodes (else read again below)
  const int per = (S + kCta - 1) / kCta;
  const bool packed = per <= kMaxRun;
  const int a0 = min(lo + tid * per, hi), a1 = min(a0 + per, hi);
  uint32_t bits = 0;
  int mine = 0, pre = 0;
  for (int i = a0; i < a1; ++i) {
    const bool e = w.er(sm, i);
    if (packed) bits |= (uint32_t)e << (i - a0);
    mine += e;
    pre += e && i < rr;
  }
  int total;
  const int before = block_excl(mine, scr, total);
  if (rr >= 1 && rr - 1 >= a0 && rr - 1 < a1) pub->pre_rr = before + pre;
  if (tid == 0) pub->tot = total;
  PROF(1);
  cl.sync();
  PROF(2);
  // the CTAs' offsets, the window's total and P[rr - 1]
  if (warp == 0) {
    const int own = lane < C ? cl.map_shared_rank(pub, lane)->tot : 0;
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int found = __shfl_sync(kFull, incl, 31);
    const int my_off = __shfl_sync(kFull, incl - own, r);
    const int o = rr >= 1 ? (rr - 1) / S : 0;
    const int o_off = __shfl_sync(kFull, incl - own, o);
    if (lane == 0) {
      loc->found = found;
      loc->off = my_off;
      loc->prr = rr >= 1 ? o_off + cl.map_shared_rank(pub, o)->pre_rr : 0;
      loc->list_len = ntf >= 0 ? min(found, ntf) : 0;
    }
  }
  __syncthreads();
  const int found = loc->found, prr = loc->prr;
  // each selected node: its count is its rank in circular order from rr
  int run = loc->off + before;
  for (int i = a0; i < a1; ++i) {
    if (!(packed ? (bits >> (i - a0)) & 1 : w.er(sm, i))) continue;
    run += 1;
    const int count = i >= rr ? run - prr : found - prr + run;
    const int circ = i >= rr ? i - rr : i - rr + rn;
    if (ntf >= 1 && count == ntf) cl.map_shared_rank(pub, 0)->kth = circ;
    if (count > ntf) continue;
    put_entry(m, sl, sm, w, i, circ, count - 1);
  }
  PROF(3);
  cl.sync();
  PROF(4);
}

// any other layout, with the reference's own arithmetic: the eligible real
// nodes' histogram over circular positions (i - rr) mod rn (clamped to
// N - 1), its inclusive scan c, selected = c[pos] <= num_to_find, kth the
// first position where c reaches num_to_find. A selected node takes a
// distinct slot below c[pos] (the list's order is free: the folds read
// nothing of one another and the reductions are order-free). Position p
// lives in CTA p / S, in its slice's `out` (free until the walk iterates).
template <typename T>
__device__ void window_any(const Machine<T>& m, const Slices& sl, const View<T>& sm,
                           const Cmd<T>& cm, Pub<T>* pub, Loc<T>* loc, int* sv, int* sf,
                           int lo, int hi, int S) {
  const cg::cluster_group& cl = sl.cl;
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Win<T> w(m, cm, lo, hi, S);
  const int N = w.N, rr = w.rr, ntf = w.ntf, rn = w.rn;
  int* h = sm.out;
  for (int p = tid; p < hi - lo; p += kCta) h[p] = 0;
  if (tid == 0) pub->sel = 0;
  cl.sync();
  for (int i = lo + tid; i < hi; i += kCta)
    if (w.er(sm, i)) {
      const int p = min(((i - rr) % rn + rn) % rn, N - 1);
      atomicAdd(sl.rem(h, p / S) + p % S, 1);
    }
  cl.sync();
  // the scan over this CTA's positions, each thread a contiguous run
  const int per = (S + kCta - 1) / kCta;
  const int a0 = min(lo + tid * per, hi), a1 = min(a0 + per, hi);
  int mine = 0;
  for (int p = a0; p < a1; ++p) mine += h[p - lo];
  int total;
  const int before = block_excl(mine, sv, total);
  if (tid == 0) pub->tot = total;
  PROF(1);
  cl.sync();
  PROF(2);
  if (warp == 0) {
    const int own = lane < C ? cl.map_shared_rank(pub, lane)->tot : 0;
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int found = __shfl_sync(kFull, incl, 31);
    const int my_off = __shfl_sync(kFull, incl - own, r);
    if (lane == 0) {
      loc->found = found;
      loc->off = my_off;
    }
  }
  __syncthreads();
  // each position's count c, kept where it selects (a slot counter), else 0
  int run = loc->off + before;
  for (int p = a0; p < a1; ++p) {
    const int prev = run;
    run += h[p - lo];
    if (ntf >= 1 && prev < ntf && run >= ntf) cl.map_shared_rank(pub, 0)->kth = p;
    h[p - lo] = run <= ntf ? run : 0;
  }
  cl.sync();
  int taken = 0;
  for (int i = lo + tid; i < hi; i += kCta)
    if (w.er(sm, i)) {
      const int circ = ((i - rr) % rn + rn) % rn;
      const int p = min(circ, N - 1);
      const int k = atomicSub(sl.rem(h, p / S) + p % S, 1);
      if (k > 0) {
        put_entry(m, sl, sm, w, i, circ, k - 1);
        taken += 1;
      }
    }
  int none = 0;
  block_sum_or(taken, none, sv, sf);
  if (tid == 0 && taken)
    for (int q = 0; q < C; ++q) atomicAdd(&cl.map_shared_rank(pub, q)->sel, taken);
  PROF(3);
  cl.sync();
  PROF(4);
  if (tid == 0) loc->list_len = pub->sel;
  __syncthreads();
}

// one kernel a victim width V (V = 0: a row wider than kMaxV, folded from
// global scratch), so a launch carries the fold of its own V only (the
// serial sections run from a smaller instruction footprint). The node
// slices live in shared memory, or in the global buffer P_cpos where the
// launcher passes one (K9 keeps no circular-position scratch of its own).
template <typename T, int V>
__global__ void __launch_bounds__(kCta, 1)
    preempt_cluster(const __grid_constant__ Args<T> args) {
  constexpr int MW = (V + 63) / 64;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int N = args.d[D_N];
  const int S = (N + C - 1) / C;
  const int lo = min(r * S, N), hi = min(lo + S, N);
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned char* spill = (unsigned char*)args.p[P_cpos];
  const long long stride = spill ? (long long)slice_bytes(S, MW, (int)sizeof(T)) : 0;
  const View<T> sm = carve<T>(spill ? spill + r * stride : dyn, S, MW);
  const Slices sl{cl, stride, r};
  __shared__ Ctl<T> ctl;
  __shared__ Cmd<T> cmd;
  __shared__ Pub<T> pub;
  __shared__ Loc<T> loc;
  __shared__ Best<T> bscr[kCtaWarps];
  __shared__ int sv[kCtaWarps], sf[kCtaWarps];
  Machine<T> m{args, ctl, tid};

  // initial state: the global scratch over the cluster's threads, the
  // slice's used/cnt into its slice; whether the real slots are the prefix
  // [0, real_n)
  {
    const int J = m.d(D_J), Q = m.d(D_Q), L = m.d(D_L), TT = m.d(D_T);
    const int G = C * kCta, g = r * kCta + tid;
    for (int i = g; i < N * m.d(D_V); i += G) m.template sc<uint8_t>(P_alive)[i] = m.template in<uint8_t>(P_vic_alive0)[i];
    for (int i = g; i < J; i += G) {
      m.template sc<int>(P_ready)[i] = m.template in<int>(P_job_ready0)[i];
      m.template sc<int>(P_wait)[i] = m.template in<int>(P_job_wait0)[i];
      m.template sc<int>(P_ptr)[i] = m.template in<int>(P_job_task_start)[i];
      m.template sc<T>(P_job_alloc)[2 * i] = m.template in<T>(P_job_alloc0)[2 * i];
      m.template sc<T>(P_job_alloc)[2 * i + 1] = m.template in<T>(P_job_alloc0)[2 * i + 1];
    }
    for (int i = g; i < 2 * Q; i += G) m.template sc<T>(P_queue_alloc)[i] = m.template in<T>(P_queue_alloc0)[i];
    for (int i = g; i < m.d(D_QP) * m.d(D_JCAP); i += G) m.template sc<int>(P_heap)[i] = m.template in<int>(P_heap0)[i];
    for (int i = g; i < m.d(D_QP); i += G) m.template sc<int>(P_hsize)[i] = m.template in<int>(P_hsize0)[i];
    for (int i = g; i < 3 * L; i += G) m.template sc<int>(P_out)[i] = 0;
    const uint8_t* pd0 = m.template in<uint8_t>(P_p_done0);
    for (int i = g; i < TT; i += G) m.template sc<uint8_t>(P_p_done)[i] = pd0 ? pd0[i] : 0;
    const int real_n = *m.template in<int>(P_real_n);
    bool bad = false;
    for (int i = lo + tid; i < hi; i += kCta) {
      sm.used[2 * (i - lo)] = m.template in<T>(P_node_used)[2 * i];
      sm.used[2 * (i - lo) + 1] = m.template in<T>(P_node_used)[2 * i + 1];
      sm.cnt[i - lo] = m.template in<int>(P_node_cnt)[i];
      bad |= (m.template in<uint8_t>(P_node_real)[i] != 0) != (i < real_n);
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) {
      pub.bad = bad;
      pub.vsum = 0;
      pub.uor = 0;
    }
    if (r == 0 && tid == 0) {
      ctl.log_len = 0;
      ctl.rr = *m.template in<int>(P_rr0);
      ctl.victims = ctl.attempts = ctl.fail = ctl.underflow = ctl.steps = 0;
      ctl.mode = M_QUEUE; ctl.qi = 0; ctl.cur_job = 0; ctl.phase2 = 0; ctl.assigned = 0;
      ctl.stmt_start = 0; ctl.u2 = 0; ctl.qhsize = 0;
      ctl.walk = 0;
    }
  }
  cl.sync();
  PROF_START();
  bool prefix = true;
  for (int q = 0; q < C; ++q) prefix &= !cl.map_shared_rank(&pub, q)->bad;

  const Nodes<T> nd{sl, sm.used, sm.cnt, S};
  const int budget = 8 * (m.d(D_T) + m.d(D_J) + m.d(D_QP) + m.d(D_JU)) + 64;
  for (;;) {
    PROF(0);
    if (r == 0 && tid == 0) decide<T, V>(m, nd, &pub, loc, &cmd, budget);
    PROF(10);
    cl.sync();
    PROF(11);
    const Cmd<T> cm = cmd;
    if (cm.run == RUN_STOP) break;
    if (cm.run == RUN_WALK) {
      if (prefix) window(m, sl, sm, cm, &pub, &loc, sv, lo, hi, S);
      else window_any(m, sl, sm, cm, &pub, &loc, sv, sf, lo, hi, S);
    }
    iterate<T, V>(m, cl, sm, cm, &pub, &loc, bscr, sv, sf);
  }
  // the final node state out (the fused chain's carry)
  for (int i = lo + tid; i < hi; i += kCta) {
    m.template sc<T>(P_used)[2 * i] = sm.used[2 * (i - lo)];
    m.template sc<T>(P_used)[2 * i + 1] = sm.used[2 * (i - lo) + 1];
    m.template sc<int>(P_cnt)[i] = sm.cnt[i - lo];
  }
  if (r == 0) m.write_tail();
}

// K9's kernel at (T, V): its plan at N nodes and its launch
template <typename T, int V>
Plan plan_v(int N) {
  return plan<Args<T>, preempt_cluster<T, V>>(
      slice_bytes((N + kCluster - 1) / kCluster, (V + 63) / 64, (int)sizeof(T)));
}

template <typename T, int V>
int launch_v(Args<T>& a, void* stream) {
  return launch_cluster<Args<T>, preempt_cluster<T, V>>(
      a, slice_bytes((a.d[D_N] + kCluster - 1) / kCluster, (V + 63) / 64, (int)sizeof(T)),
      P_cpos, stream);
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, void* stream) {
  Args<T> a;
  for (int k = 0; k < P_COUNT; ++k) a.p[k] = ptrs[k];
  for (int k = 0; k < D_COUNT; ++k) a.d[k] = dims[k];
  if (a.d[D_N] <= 0 || a.d[D_V] <= 0 || a.d[D_L] <= 0 || a.d[D_QP] <= 0)
    return (int)cudaErrorInvalidValue;
  return by_v(a.d[D_V], [&](auto v) { return launch_v<T, decltype(v)::value>(a, stream); });
}

}  // namespace

EV_EXPORT_NAMES

// the layout a launch at (N, V) takes: out[0] the cluster's CTAs (0: the
// card does not run it), out[1] each CTA's dynamic shared-memory bytes,
// out[2] the bytes of the global buffer the slices need where they do not
// fit shared memory (the caller passes it as `cpos`), else 0
extern "C" int evict_preempt_plan(int N, int V, int f64, long long* out) {
  const Plan p = f64 ? by_v(V, [&](auto v) { return plan_v<double, decltype(v)::value>(N); })
                     : by_v(V, [&](auto v) { return plan_v<float, decltype(v)::value>(N); });
  out[0] = p.ok ? kCluster : 0;
  out[1] = (long long)p.smem;
  out[2] = (long long)p.spill;
  return 0;
}

extern "C" int evict_preempt_f32(const void* const* ptrs, const int* dims, void* stream) {
  return launch<float>(ptrs, dims, stream);
}
extern "C" int evict_preempt_f64(const void* const* ptrs, const int* dims, void* stream) {
  return launch<double>(ptrs, dims, stream);
}

#ifdef K9_PROFILE
// the phases' clock counters of the last launch (CTA 0 thread 0's cycles)
extern "C" int k9_profile_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k9_prof_t, sizeof(k9_prof_t));
}
#endif
