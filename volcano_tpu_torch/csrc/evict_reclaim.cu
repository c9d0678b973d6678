// K10 evict_reclaim: the whole reclaim action as one state machine on a
// thread-block cluster, hand-written for Hopper (sm_90a).
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
// Bound: a sequential machine far from both of the card's bounds (its
// operations at the card's peak take about 0.013 ms on the reclaim path);
// it is latency-bound: what counts is the depth of each walk iteration's
// critical path. The previous design ran on one CTA of 512 threads: per
// iteration a fold in chunks of 512 nodes with a block reduction after
// each, a second pass over all N for the visited underflow, all node and
// fold state in global memory; 150 us an iteration on an H100.
//
// Design (K9's cluster machinery, evict_cluster.cuh):
// - One cluster of 16 CTAs of 256 threads. Nodes come in groups of 32
//   consecutive ones, dealt round-robin to the CTAs (a super-block of 512
//   nodes holds one group of each); a CTA keeps its nodes' `used`, `cnt`
//   and the walk's eligibility in shared memory (or, where they do not
//   fit, a global buffer of 16 slices). CTA 0's thread 0 runs the control
//   machine and writes a pipelined node's `used`/`cnt` into the owning
//   CTA's slice.
// - Eligibility once a walk: a node belongs to one thread for the whole
//   run, which computes its eligibility into the slice at the walk's start
//   (`cnt` changes only by the pipeline that ends the walk) and folds it
//   in every iteration: no block barrier between the two.
// - The first qualifying node by rounds. The fold is bound by the memory
//   pipes, not by barriers: each lane reads its own node's rows, which do
//   not coalesce, so folding every node past the cursor (8,000 at the
//   reclaim path) took 42 us an iteration. A search runs rounds of
//   super-blocks from the cursor's, two in the first round and twice the
//   last one after, until a round holds a validating node; every CTA owns
//   a group of each super-block, so a round spreads over all 16 SMs. In a
//   round a thread folds its nodes past the cursor in name order up to its
//   first validating node a_t; f_t is its first folded node whose victims
//   underflow. The reference's visited set (eligible, past the cursor, up
//   to the chosen node, volcano_tpu/ops/evict.py:891-892) lies inside the
//   folded nodes (the chosen node bi = min a_t <= every a_t, and earlier
//   rounds folded all of theirs), so the visited underflow is (min f_t <=
//   bi): a block min of (a_t, f_t), each CTA's pair into every CTA's shared
//   memory (distributed shared memory), one cluster barrier a round, and
//   every CTA takes the minimum of the 16 pairs itself. No pass over N.
// - The fold keeps its state in registers (evict_cluster.cuh fold_node, V
//   a template parameter for the encoder's buckets 16..256); a validating
//   node's victim mask goes to its row of a global word buffer, from which
//   CTA 0's cut reads the chosen node's. A wider row (a node of more than 256
//   victims) folds with Machine::fold_node over global scratch rows (V = 0
//   below). One thread folds a node's V slots in slot order, so every float
//   keeps the reference's order.
// - A cluster barrier a round and one for CTA 0's order; counts are exact
//   int32. One launch an action, per-action and fused, no
//   host sync. The machine's fail bit trips only on the reference's
//   budgets (the op log's length, the step budget, iters > N*V+2).
// - Built with -DK10_PROFILE, PROF(k) marks add CTA 0 thread 0's clock
//   between marks to phase k's counter and PROF_UNIT() counts the folds
//   (volcano_tpu_torch/bench/kernel_profile.py reads them); otherwise
//   they compile to nothing.
//
// Output: the packed int32 result (the flattened [L, 3] op log then the
// 6-wide tail) and the final state in the wrapper's scratch.

#include "evict_cluster.cuh"

#ifdef K10_PROFILE
constexpr int kProfPhases = 8;
// the phases' cycles at CTA 0 thread 0, then the folds (walk iterations)
__device__ long long k10_prof_t[kProfPhases + 1];
__device__ long long k10_prof_last;
#define PROF(k)                                                  \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      const long long now_ = clock64();                          \
      k10_prof_t[k] += now_ - k10_prof_last;                     \
      k10_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNIT()                                              \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) k10_prof_t[kProfPhases] += 1; \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                   \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k10_prof_t[k_] = 0; \
      k10_prof_last = clock64();                                 \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNIT() do {} while (0)
#define PROF_START() do {} while (0)
#endif

namespace {

using namespace ev;
using namespace evc;

enum { RUN_STOP = 0, RUN_WALK = 1, RUN_NEXT = 2 };
constexpr int kNone = 0x7fffffff;
// node layout: groups of 32 consecutive nodes dealt round-robin to the
// CTAs; a super-block of 512 nodes holds one group of each CTA
constexpr int kGroup = 32;
constexpr int kSuper = kGroup * kCluster;
constexpr int kRound0 = 2;  // super-blocks in a search's first round

// CTA 0 thread 0's order to every CTA
struct Cmd {
  int run, t, j, cursor;
};

// each CTA's search result of a round, written into every CTA (two
// buffers, alternating by round): its lowest validating node and its
// lowest folded node whose victims underflow (kNone: none)
struct Pub {
  int a[2][kCluster];
  int f[2][kCluster];
};

// a CTA's dynamic shared memory: its nodes' used, cnt and the walk's
// eligibility, by local index (a node's group's rank among the CTA's
// groups, then its lane)
template <typename T>
struct View {
  T* used;      // [2 * S]
  int* cnt;     // [S]
  uint8_t* el;  // [S]
};

__host__ __device__ inline int local_nodes(int N) {
  return ((N + kSuper - 1) / kSuper) * kGroup;
}

// a slice's bytes, rounded up so that slices in a global buffer stay aligned
__host__ __device__ inline size_t slice_bytes(int S, int tsize) {
  return ((size_t)S * (2 * tsize + 5) + 15) / 16 * 16;
}

__device__ __forceinline__ int owner_of(int node) { return (node / kGroup) % kCluster; }
__device__ __forceinline__ int local_of(int node) {
  return node / kSuper * kGroup + node % kGroup;
}
// CTA r's node at local index li
__device__ __forceinline__ int node_of(int r, int li) {
  return (li / kGroup * kCluster + r) * kGroup + li % kGroup;
}

template <typename T>
__device__ View<T> carve(unsigned char* base, int S) {
  View<T> v;
  v.used = reinterpret_cast<T*>(base);
  v.cnt = reinterpret_cast<int*>(v.used + 2 * S);
  v.el = reinterpret_cast<uint8_t*>(v.cnt + S);
  return v;
}

// a node's used/cnt in the owning CTA's slice (for the pipeline)
template <typename T>
struct RNodes {
  Slices sl;
  T* used_s;
  int* cnt_s;
  __device__ T* used(int node) const { return sl.rem(used_s, owner_of(node)) + 2 * local_of(node); }
  __device__ int* cnt(int node) const { return sl.rem(cnt_s, owner_of(node)) + local_of(node); }
};

// CTA 0 thread 0, between cluster barriers: ends the walk iteration whose
// search just ran (bi: the chosen node, fm: the lowest folded node whose
// victims underflow), then runs the queue rotation until a walk starts or
// the machine stops, and orders every CTA
template <typename T, int V>
__device__ void decide(Machine<T>& m, const RNodes<T>& nd, int bi, int fm, Cmd* cmd, int budget) {
  Ctl<T>& c = m.c;
  const cg::cluster_group& cl = nd.sl.cl;
  const int N = m.d(D_N), JCAP = m.d(D_JCAP), TT = m.d(D_T);
  if (c.walk) {
    PROF_UNIT();
    const bool any_p = bi != kNone;
    // visited: eligible, past the cursor, up to the chosen node (all of
    // them when none qualifies), every one of them folded
    c.underflow |= fm != kNone && fm <= bi;
    c.iters += 1;
    if (c.iters > N * m.d(D_V) + 2) c.fail = 1;
    PROF(5);
    bool covered = false;
    if (any_p) {
      if constexpr (V == 0) {
        // the fold left the victim mask in the node's global row
        covered = m.cut(c.t, bi, nullptr);
      } else {
        constexpr int MW = (V + 63) / 64;
        const uint64_t* row = m.template in<uint64_t>(P_vm) + (size_t)bi * MW;
        uint64_t vm[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) vm[w] = __ldcg(row + w);
        covered = cut<false>(m, c.t, bi, vm);
      }
      if (covered) pipeline(m, nd, c.t, bi);
      c.cursor = bi;
    }
    PROF(6);
    if (any_p && !covered && !c.fail) {
      push(cl, cmd, Cmd{RUN_NEXT, c.t, c.j, c.cursor});
      return;
    }
    // the walk is over; an assigned reclaimer's queue goes back in
    c.walk = 0;
    if (covered) m.heap_push(m.template sc<int>(P_qheap), &c.qhsize, c.q, true);
  }
  for (;;) {
    if (c.qhsize <= 0 || c.fail) {
      PROF(1);
      push(cl, cmd, Cmd{RUN_STOP, 0, 0, 0});
      return;
    }
    c.steps += 1;
    if (c.steps > budget) c.fail = 1;
    const int q = m.heap_pop(m.template sc<int>(P_qheap), &c.qhsize, true);
    bool over = false;
    if (m.d(D_use_prop_overused)) {
      const T* qa = m.template sc<T>(P_queue_alloc);
      const T* des = m.template in<T>(P_queue_deserved);
      const T* eps = m.template in<T>(P_eps);
      over = m.template in<uint8_t>(P_queue_has_attr)[q] &&
             !le2(qa[2 * q], qa[2 * q + 1], des[2 * q], des[2 * q + 1], eps[0], eps[1]);
    }
    int* hsize = m.template sc<int>(P_hsize);
    if (over || hsize[q] == 0) continue;
    const int j = heap_pop(m, m.template sc<int>(P_heap) + (size_t)q * JCAP, &hsize[q]);
    if (!m.has_live(j)) continue;
    int* ptr = m.template sc<int>(P_ptr);
    const int t = m.template in<int>(P_p_next)[min(max(ptr[j], 0), TT - 1)];
    ptr[j] = t + 1;
    c.walk = 1;
    c.t = t;
    c.j = j;
    c.q = q;
    c.cursor = -1;
    c.iters = 0;
    PROF(1);
    push(cl, cmd, Cmd{RUN_WALK, t, j, -1});
    return;
  }
}

// one kernel a victim width V (V = 0: a row wider than kMaxV, folded from
// global scratch). The node slices live in shared memory, or in the global
// buffer P_cpos where the launcher passes one.
template <typename T, int V>
__global__ void __launch_bounds__(kCta, 1)
    reclaim_cluster(const __grid_constant__ Args<T> args) {
  constexpr int MW = V == 0 ? 1 : (V + 63) / 64;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = args.d[D_N];
  const int S = local_nodes(N), nsb = (N + kSuper - 1) / kSuper;
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned char* spill = (unsigned char*)args.p[P_cpos];
  const long long stride = spill ? (long long)slice_bytes(S, (int)sizeof(T)) : 0;
  const View<T> sm = carve<T>(spill ? spill + r * stride : dyn, S);
  const Slices sl{cl, stride, r};
  __shared__ Ctl<T> ctl;
  __shared__ Cmd cmd;
  __shared__ Pub pub;
  __shared__ int wa[kCtaWarps], wf[kCtaWarps];
  Machine<T> m{args, ctl, tid};

  // initial state: the global scratch over the cluster's threads, the
  // CTA's nodes' used/cnt into its slice
  {
    const int J = m.d(D_J), Q = m.d(D_Q), L = m.d(D_L), TT = m.d(D_T);
    const int G = C * kCta, g = r * kCta + tid;
    for (int i = g; i < N * m.d(D_V); i += G)
      m.template sc<uint8_t>(P_alive)[i] = m.template in<uint8_t>(P_vic_alive0)[i];
    for (int i = g; i < J; i += G) {
      m.template sc<int>(P_ready)[i] = m.template in<int>(P_job_ready0)[i];
      m.template sc<int>(P_wait)[i] = m.template in<int>(P_job_wait0)[i];
      m.template sc<int>(P_ptr)[i] = m.template in<int>(P_job_task_start)[i];
      m.template sc<T>(P_job_alloc)[2 * i] = m.template in<T>(P_job_alloc0)[2 * i];
      m.template sc<T>(P_job_alloc)[2 * i + 1] = m.template in<T>(P_job_alloc0)[2 * i + 1];
    }
    for (int i = g; i < 2 * Q; i += G)
      m.template sc<T>(P_queue_alloc)[i] = m.template in<T>(P_queue_alloc0)[i];
    for (int i = g; i < m.d(D_QP) * m.d(D_JCAP); i += G)
      m.template sc<int>(P_heap)[i] = m.template in<int>(P_heap0)[i];
    for (int i = g; i < m.d(D_QP); i += G) m.template sc<int>(P_hsize)[i] = m.template in<int>(P_hsize0)[i];
    for (int i = g; i < m.d(D_QH); i += G) m.template sc<int>(P_qheap)[i] = m.template in<int>(P_qheap0)[i];
    for (int i = g; i < 3 * L; i += G) m.template sc<int>(P_out)[i] = 0;
    const uint8_t* pd0 = m.template in<uint8_t>(P_p_done0);
    for (int i = g; i < TT; i += G) m.template sc<uint8_t>(P_p_done)[i] = pd0 ? pd0[i] : 0;
    for (int li = tid; li < S; li += kCta) {
      const int i = node_of(r, li);
      if (i >= N) continue;
      sm.used[2 * li] = m.template in<T>(P_node_used)[2 * i];
      sm.used[2 * li + 1] = m.template in<T>(P_node_used)[2 * i + 1];
      sm.cnt[li] = m.template in<int>(P_node_cnt)[i];
    }
    if (r == 0 && tid == 0) {
      ctl.log_len = 0;
      ctl.rr = *m.template in<int>(P_rr0);
      ctl.victims = ctl.attempts = ctl.fail = ctl.underflow = ctl.steps = 0;
      ctl.qhsize = *m.template in<int>(P_qhsize0);
      ctl.walk = 0;
    }
  }
  cl.sync();
  PROF_START();

  const RNodes<T> nd{sl, sm.used, sm.cnt};
  const Fns fns = fns_of(m);
  const int budget = 4 * (m.d(D_T) + m.d(D_J) + m.d(D_Q)) + 64;
  int bi = kNone, fm = kNone;  // the last search: chosen node, first underflow
  int rounds = 0;              // cluster-uniform: the Pub buffer
  for (;;) {
    if (r == 0 && tid == 0) decide<T, V>(m, nd, bi, fm, &cmd, budget);
    cl.sync();
    PROF(7);
    const Cmd cm = cmd;
    if (cm.run == RUN_STOP) break;
    const int t = cm.t, j = cm.j, cursor = cm.cursor;
    PROF(0);
    if (cm.run == RUN_WALK) {
      // feasibility is fixed for the walk: the pod counts change only by
      // the pipeline that ends it (Machine::elig on the slice's counts)
      const uint8_t* mask = m.template in<uint8_t>(P_sig_mask) +
                            (size_t)m.template in<int>(P_p_sig)[t] * N;
      const int* nmax = m.template in<int>(P_node_max);
      const bool pod = m.d(D_check_pod) && m.template in<uint8_t>(P_p_has_pod)[t];
      for (int li = tid; li < S; li += kCta) {
        const int i = node_of(r, li);
        sm.el[li] = i < N && mask[i] && (!pod || sm.cnt[li] < nmax[i]);
      }
    }
    PROF(2);
    const int qj = m.template in<int>(P_job_queue)[j];
    T ls = T(0);
    if (fns.drf) {
      // the claimer's drf share with its request added
      const T* ja = m.template sc<T>(P_job_alloc);
      const T* tot = m.template in<T>(P_drf_total);
      const T* preq = m.template in<T>(P_p_req) + 2 * t;
      ls = share2(__ldcg(ja + 2 * j) + preq[0], __ldcg(ja + 2 * j + 1) + preq[1], tot[0], tot[1]);
    }
    // the search: rounds of super-blocks from the cursor's, kRound0 the
    // first round and twice the last one after, until a round holds a
    // validating node. A thread folds its nodes of the round (one a
    // super-block it owns a group of) in name order up to its first
    // validating one.
    bi = kNone;
    fm = kNone;
    for (int b0 = (cursor + 1) / kSuper, w = kRound0; b0 < nsb; b0 += w, w *= 2) {
      const int b1 = min(b0 + w, nsb);
      int a = kNone, f = kNone;
      for (int b = b0; b < b1; ++b) {
        if (b % kCtaWarps != warp) continue;
        const int li = b * kGroup + lane, i = node_of(r, li);
        if (i >= N || i <= cursor || !sm.el[li]) continue;
        int vc;
        bool und, val;
        if constexpr (V == 0) {
          val = m.fold_node(i, 2, j, qj, t, ls, vc, und);
        } else {
          uint64_t vm[MW];
          val = fold_node<T, V>(m, fns, i, 2, j, qj, t, ls, vc, und, vm);
          if (val) {
            uint64_t* row = m.template sc<uint64_t>(P_vm) + (size_t)i * MW;
#pragma unroll
            for (int x = 0; x < MW; ++x) row[x] = vm[x];
          }
        }
        if (und && f == kNone) f = i;
        if (val) {
          a = i;
          break;
        }
      }
      PROF(3);
      // the CTA's pair, to every CTA; then each CTA takes the cluster's
      a = __reduce_min_sync(kFull, a);
      f = __reduce_min_sync(kFull, f);
      if (lane == 0) {
        wa[warp] = a;
        wf[warp] = f;
      }
      __syncthreads();
      const int buf = rounds & 1;
      if (warp == 0) {
        a = __reduce_min_sync(kFull, lane < kCtaWarps ? wa[lane] : kNone);
        f = __reduce_min_sync(kFull, lane < kCtaWarps ? wf[lane] : kNone);
        if (lane < C) {
          Pub* pq = cl.map_shared_rank(&pub, lane);
          pq->a[buf][r] = a;
          pq->f[buf][r] = f;
        }
      }
      cl.sync();
      rounds += 1;
      const int ra = __reduce_min_sync(kFull, lane < C ? pub.a[buf][lane] : kNone);
      const int rf = __reduce_min_sync(kFull, lane < C ? pub.f[buf][lane] : kNone);
      fm = min(fm, rf);
      PROF(4);
      if (ra != kNone) {
        bi = ra;
        break;
      }
    }
  }
  // the final node state out
  for (int li = tid; li < S; li += kCta) {
    const int i = node_of(r, li);
    if (i >= N) continue;
    m.template sc<T>(P_used)[2 * i] = sm.used[2 * li];
    m.template sc<T>(P_used)[2 * i + 1] = sm.used[2 * li + 1];
    m.template sc<int>(P_cnt)[i] = sm.cnt[li];
  }
  if (r == 0) m.write_tail();
}

template <typename T>
size_t bytes_at(int N) {
  return slice_bytes(local_nodes(N), (int)sizeof(T));
}

template <typename T, int V>
Plan plan_v(int N) {
  return plan<Args<T>, reclaim_cluster<T, V>>(bytes_at<T>(N));
}

template <typename T, int V>
int launch_v(Args<T>& a, void* stream) {
  return launch_cluster<Args<T>, reclaim_cluster<T, V>>(a, bytes_at<T>(a.d[D_N]), P_cpos,
                                                        stream);
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, void* stream) {
  Args<T> a;
  for (int k = 0; k < P_COUNT; ++k) a.p[k] = ptrs[k];
  for (int k = 0; k < D_COUNT; ++k) a.d[k] = dims[k];
  if (a.d[D_N] <= 0 || a.d[D_V] <= 0 || a.d[D_L] <= 0 || a.d[D_QH] <= 0)
    return (int)cudaErrorInvalidValue;
  return by_v(a.d[D_V], [&](auto v) { return launch_v<T, decltype(v)::value>(a, stream); });
}

}  // namespace

EV_EXPORT_NAMES

// the layout a launch at (N, V) takes: out[0] the cluster's CTAs (0: the
// card does not run it), out[1] each CTA's dynamic shared-memory bytes,
// out[2] the bytes of the global buffer the slices need where they do not
// fit shared memory (the caller passes it as `cpos`), else 0
extern "C" int evict_reclaim_plan(int N, int V, int f64, long long* out) {
  const Plan p = f64 ? by_v(V, [&](auto v) { return plan_v<double, decltype(v)::value>(N); })
                     : by_v(V, [&](auto v) { return plan_v<float, decltype(v)::value>(N); });
  out[0] = p.ok ? kCluster : 0;
  out[1] = (long long)p.smem;
  out[2] = (long long)p.spill;
  return 0;
}

extern "C" int evict_reclaim_f32(const void* const* ptrs, const int* dims, void* stream) {
  return launch<float>(ptrs, dims, stream);
}
extern "C" int evict_reclaim_f64(const void* const* ptrs, const int* dims, void* stream) {
  return launch<double>(ptrs, dims, stream);
}

#ifdef K10_PROFILE
// the phases' cycles and the folds of the last launch
extern "C" int k10_profile_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k10_prof_t, sizeof(k10_prof_t));
}
#endif
