// K7b tail_pass: the sequential tail pass of the rounds solve, hand-written
// for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:980 `tail_pass` (a lax.while_loop run
// under lax.cond(capped) at :1101). Plain version:
// volcano_tpu_torch/ops/rounds_kernels.py `tail_pass_plain`.
//
// After a capped exit (and the straggler rounds) the remainder is placed
// one task at a time, in the serial visit order, for at most
// 8 * max(round_min_progress, 1) + 16 steps. Each step takes the live task
// of a queue under its deserved share that is first by the job-order keys
// in tier order (priority, gang readiness, drf share; csrc/job_keys.cuh,
// shared with K6 job_rank), then the job's tie rank, the task's index in
// its job and the lowest task index; scores that task's class row over
// every node (the epsilon fit of the init request, the signature mask, the
// pod cap, the exclusion group's occupancy, score_common.cuh's fused
// score); takes the first maximum (node 0 when every node fails); and
// commits: idle/used/cnt of the node, assign, the task retired, tail_failed
// when no node fits, the job, queue and namespace allocations and the
// exclusion occupancy. A step with nothing eligible commits zeros and ends
// the pass. The tasks placed land in ctl[C_TAIL_PLACED].
//
// Bound: a chain of dependent steps (each step's choice reads the last
// step's commit), far above the bytes the pass moves, so the design cuts
// the latency of a step. One launch, one block of 1,024 threads (faster at
// cfg6 than blocks of 256 or 512, PERF.md):
// - Segments. At the pass's start the task axis is cut into segments: runs
//   of consecutive tasks of one job and one queue whose task_in_job does
//   not decrease. Inside a segment the first live task is the least by
//   (task_in_job, index), so a segment's candidate is a cursor, and the
//   least candidate over the segments is the reference's choice. The
//   encoder lays a job's tasks out contiguously in task_in_job order with
//   one queue a job, so a segment is a job there; any other layout is cut
//   into more segments and chosen the same way. Only segments with a live
//   task at the start are kept (113 at cfg6's tail against T = 8,192).
// - Packed keys. A segment's candidate is one unsigned integer of 3 (float)
//   or 4 (double) 64-bit words: the job's keys packed as K6 packs them
//   (priority, gang flag, the drf share by its ordered bits with -0.0
//   folded into +0.0, tie rank), then task_in_job and the task index in the
//   last word. A step rewrites the words of the job it placed (its keys)
//   and the cursor of the segment it took; nothing else moves.
// - The segments are found in parallel at the pass's start (each thread a
//   run of tasks: its segment starts, a block scan numbers them, an atomic
//   minimum gives each its first live task), into a global scratch block
//   planned once a size (tail_pass_scratch_bytes), rebuilt by every launch,
//   never memset. A live segment's entry holds its key words, queue, end,
//   job, its cursor task's class, exclusion group and namespace, and its
//   job's static columns, so a step reads no task or job column to learn
//   its task or to rebuild the job's keys.
// - The select: while at most 256 segments live, their table is copied to
//   shared memory and warp 0 alone takes the least candidate (a lane a few
//   segments, compared without branches, then one redux.sync a 32-bit
//   piece of the key over the lanes still tied), right after the commit it
//   made itself, so a step has two block barriers: one after the select,
//   one after the node sweep. With more segments every warp takes part, on
//   the table in global memory, and a third barrier closes the step. The
//   node sweep's first maximum is taken the same way (the score's ordered
//   bits, then the node index).
// - The overused gate: a queue's allocation only grows in the pass, so a
//   queue over its share stays over. Its segments' task words are marked
//   dead at the start, and when a commit takes a queue across its share
//   (recomputed for that one queue); the select reads the key words alone.
// - The commit spreads over warp 0: a lane a resource dimension (the node,
//   job, queue and namespace rows, each read before any is written), a
//   lane each for the counts and the task's flags.
// - Two placements. The state the steps read and write (idle, used, cnt,
//   the node rows and caps, the job, queue and namespace allocations,
//   job_placed, the live flags), the queues' deserved shares and the class
//   columns are staged in shared memory for the whole pass where they all
//   fit (cfg6: about 85 KB in float32), and written back or dropped at the
//   end. Where they do not, all of them stay in global memory, under the
//   same code. The sizes alone choose.
// - The node sweep scores only the nodes the mask passes (the others take
//   -inf either way): at a tail most nodes are full.
// - Built with -DK7B_PROFILE, PROF(k) marks add thread 0's clock between
//   marks to phase k's counter, PROF_UNIT() counts the steps and two
//   globaltimer marks take the launch's span
//   (volcano_tpu_torch/bench/kernel_profile.py --kernel k7b reads them).
//
// Rounding: built with --fmad=false; the score is scorefn::fused_score
// (fma() where XLA contracts); every state update is the reference's single
// add (idle + (-req), used + req), zeros included, so even signed zeros
// match.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "job_keys.cuh"
#include "order_key.cuh"
#include "rounds_ctl.cuh"
#include "score_common.cuh"

#ifdef K7B_PROFILE
constexpr int kProfPhases = 5;
// the phases' cycles at thread 0, then the steps (kept in shared memory
// while the kernel runs, so a mark costs no global round trip)
__device__ long long k7b_prof_t[kProfPhases + 1];
__shared__ long long k7b_prof_s[kProfPhases + 1];
__shared__ long long k7b_prof_last;
// globaltimer ns at the kernel's start and end (thread 0)
__device__ unsigned long long k7b_prof_span[2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(k)                                                  \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      const long long now_ = clock64();                          \
      k7b_prof_s[k] += now_ - k7b_prof_last;                     \
      k7b_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNIT()                                              \
  do {                                                           \
    if (threadIdx.x == 0) k7b_prof_s[kProfPhases] += 1;          \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k7b_prof_s[k_] = 0; \
      k7b_prof_span[0] = gtime();                                \
      k7b_prof_last = clock64();                                 \
    }                                                            \
  } while (0)
#define PROF_END()                                               \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k7b_prof_t[k_] = k7b_prof_s[k_]; \
      k7b_prof_span[1] = gtime();                                \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNIT() do {} while (0)
#define PROF_START() do {} while (0)
#define PROF_END() do {} while (0)
#endif

// The argument block, field for field the ctypes structure
// rounds_kernels._TailParams: TAIL_INPUTS, TAIL_STATE, ctl, the scratch,
// the sizes and the static spec.
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
  void* scratch;
  int T, N, R, J, Q, S, G, K, budget, n_job_keys, key0, key1, key2,
      use_prop_overused, check_pod_count, use_exclusion, use_nodeorder,
      use_binpack;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr int kSegWords = 4;      // key words a segment holds room for
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kDead = ~0ull;  // a segment's task word, no task left

template <typename F>
struct Words;
template <>
struct Words<float> {
  static constexpr int NW = 3;  // priority 32 + gang 1 + share 32 + tie 32, task 64
};
template <>
struct Words<double> {
  static constexpr int NW = 4;  // priority 32 + gang 1 + share 64 + tie 32, task 64
};

template <int NW>
struct Key {
  unsigned long long w[NW];
};

// a < b, word by word, without branches
template <int NW>
__device__ __forceinline__ bool less(const Key<NW>& a, const Key<NW>& b) {
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    lt = lt | (eq & (a.w[i] < b.w[i]));
    eq = eq & (a.w[i] == b.w[i]);
  }
  return lt;
}

// The least key over the warp (and its segment), in every lane: one
// reduction (redux.sync) a 32-bit piece, most significant first, over the
// lanes still tied.
template <int NW>
__device__ __forceinline__ void warp_lex_min(Key<NW>& k, int& bl) {
  bool in = true;
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) {
    const unsigned piece = (unsigned)(k.w[i >> 1] >> ((i & 1) ? 0 : 32));
    const unsigned m = __reduce_min_sync(kFull, in ? piece : 0xffffffffu);
    in = in & (piece == m);
  }
  const int src = __ffs(__ballot_sync(kFull, in)) - 1;
#pragma unroll
  for (int i = 0; i < NW; ++i) k.w[i] = __shfl_sync(kFull, k.w[i], src);
  bl = __shfl_sync(kFull, bl, src);
}

// k = (k << width) | v (1 <= width <= 64), as job_rank.cu packs
template <int NW>
__device__ __forceinline__ void push(Key<NW>& k, unsigned long long v, int width) {
  if (width == 64) {
#pragma unroll
    for (int i = 0; i + 1 < NW; ++i) k.w[i] = k.w[i + 1];
    k.w[NW - 1] = v;
    return;
  }
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) k.w[i] = (k.w[i] << width) | (k.w[i + 1] >> (64 - width));
  k.w[NW - 1] = (k.w[NW - 1] << width) | v;
}

__device__ __forceinline__ unsigned long long ord_i32(int32_t x) {
  return (unsigned long long)((uint32_t)x ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long task_word(int32_t in_job, int t) {
  return (ord_i32(in_job) << 32) | (unsigned long long)(uint32_t)t;
}

// A live segment: its key words (kSegWords of room, the task word last),
// its queue, end and job, its cursor task's class, exclusion group and
// namespace, and its job's static columns (priority, ready base, min
// available, tie rank). The table lives in shared memory while at most
// kSegSmem segments live, else in the global scratch.
constexpr int kSegInts = 11;

struct Segs {
  unsigned long long* w;
  int* queue;
  int* end;
  int* job;
  int* cls;
  int* excl;
  int* ns;
  int* prio;
  int* rb;
  int* ma;
  int* tie;
  int stride;  // entries an int column holds

  __device__ Segs(unsigned long long* w_, int* i, int n)
      : w(w_), queue(i), end(i + n), job(i + 2 * n), cls(i + 3 * n), excl(i + 4 * n),
        ns(i + 5 * n), prio(i + 6 * n), rb(i + 7 * n), ma(i + 8 * n), tie(i + 9 * n),
        stride(n) {}

  // word i of segment l's key (the words of one rank side by side)
  __device__ __forceinline__ unsigned long long& word(int l, int i) const {
    return w[(size_t)i * stride + l];
  }
};

// The global scratch: the segment table (T entries of room), each
// segment's first task and its first live task, by segment id.
__host__ __device__ inline size_t scratch_bytes(int T, int J) {
  (void)J;
  return (size_t)T * kSegWords * 8 + (size_t)T * (kSegInts + 2) * 4;
}

__device__ inline Segs global_segs(void* base, int T, int** start, int** first) {
  unsigned long long* w = (unsigned long long*)base;
  int* i = (int*)(w + (size_t)T * kSegWords);
  *start = i + (size_t)kSegInts * T;
  *first = i + (size_t)(kSegInts + 1) * T;
  return Segs(w, i, T);
}

constexpr int kSegSmem = 256;  // segments the shared table holds

// The dynamic shared memory: the overused gate, the shared segment table,
// then (staged) the class columns and the state.
__host__ __device__ inline size_t al16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Layout {
  size_t qover, segw, segi, idle, used, nalloc, jalloc, qalloc, qdes, nsalloc, cnt, nmax,
      jplaced, active, creq, cireq, cnzc, cnzm, csig, cpod, total;
};

__host__ __device__ inline Layout layout(int T, int N, int R, int J, int Q, int S, int K, int fb,
                                         bool staged) {
  Layout l{};
  size_t o = 0;
  l.qover = o;
  o += al16((size_t)Q);
  l.segw = o;
  o += (size_t)kSegSmem * kSegWords * 8;
  l.segi = o;
  o += (size_t)kSegSmem * kSegInts * 4;
  if (staged) {
    l.creq = o;
    o += al16((size_t)K * R * fb);
    l.cireq = o;
    o += al16((size_t)K * R * fb);
    l.cnzc = o;
    o += al16((size_t)K * fb);
    l.cnzm = o;
    o += al16((size_t)K * fb);
    l.csig = o;
    o += al16((size_t)K * 4);
    l.cpod = o;
    o += al16((size_t)K);
    const size_t nr = (size_t)N * R * fb;
    l.idle = o;
    o += al16(nr);
    l.used = o;
    o += al16(nr);
    l.nalloc = o;
    o += al16(nr);
    l.jalloc = o;
    o += al16((size_t)J * R * fb);
    l.qalloc = o;
    o += al16((size_t)Q * R * fb);
    l.qdes = o;
    o += al16((size_t)Q * R * fb);
    l.nsalloc = o;
    o += al16((size_t)S * R * fb);
    l.cnt = o;
    o += al16((size_t)N * 4);
    l.nmax = o;
    o += al16((size_t)N * 4);
    l.jplaced = o;
    o += al16((size_t)J * 4);
    l.active = o;
    o += al16((size_t)T);
  }
  l.total = o;
  return l;
}

// the step's task as warp 0 chose it, and its class's columns
template <typename F>
struct Sel {
  int t, live, has, stop, c, sig, g, job, q, ns, has_pod;
  F nz_cpu, nz_mem;
  F req[kMaxR], ireq[kMaxR];
};

// a node candidate of the arg-max: its masked score, then index << 1 | mask
template <typename F>
__device__ __forceinline__ bool node_better(F va, int ia, F vb, int ib) {
  return va > vb || (va == vb && (ia >> 1) < (ib >> 1));
}

// The first maximum over the warp, in every lane: the masked scores by
// their ordered bits (-0.0 folded into +0.0: they tie, as the reference's
// compare ties them), then the least node among the lanes that hold it.
__device__ __forceinline__ unsigned long long score_bits(float v) {
  return okey::ord(v == 0.0f ? 0.0f : v);
}
__device__ __forceinline__ unsigned long long score_bits(double v) {
  return okey::ord(v == 0.0 ? 0.0 : v);
}

template <typename F>
__device__ __forceinline__ void warp_node_max(F& v, int& im) {
  const unsigned long long b = score_bits(v);
  bool in = true;
  if (sizeof(F) == 8) {
    const unsigned hi = (unsigned)(b >> 32);
    in = hi == __reduce_max_sync(kFull, hi);
  }
  const unsigned lo = (unsigned)b;
  in = in & (lo == __reduce_max_sync(kFull, in ? lo : 0u));
  const int m = (int)__reduce_min_sync(kFull, in ? (unsigned)im : 0xffffffffu);
  const int src = __ffs(__ballot_sync(kFull, in && im == m)) - 1;
  v = __shfl_sync(kFull, v, src);
  im = m;
}

// a queue over its deserved share (the reference's ~_le_eps_rows)
template <typename F>
__device__ __forceinline__ bool overused(const F* alloc, const F* deserved, const F* eps,
                                         const uint8_t* is_scalar, int R) {
  bool le = true;
  for (int r = 0; r < R; ++r) {
    const F l = alloc[r];
    const bool ok = l < deserved[r] + eps[r];
    const bool skip = is_scalar[r] && l <= F(kMinMilliScalar);
    le = le && (ok || skip);
  }
  return !le;
}

template <typename F>
struct Ctx {
  const TailParams& p;
  const int32_t* job_placed;  // the (staged) state
  const F* job_alloc;
  const F* drf_total;         // shared copies
  const uint8_t* drf_present;
};

// the key words (NW - 1 of them, right-aligned: the task word follows) of
// job j, whose static columns segment l of ``sg`` holds
template <int NW, typename F>
__device__ Key<NW - 1> job_words(const Ctx<F>& x, const Segs& sg, int l, int j) {
  const TailParams& p = x.p;
  Key<NW - 1> k;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) k.w[i] = 0ull;
  for (int i = 0; i < p.n_job_keys; ++i) {
    const int code = i == 0 ? p.key0 : (i == 1 ? p.key1 : p.key2);
    if (code == jobkeys::kPriority) {
      push(k, ord_i32(jobkeys::wrap_neg(sg.prio[l])), 32);
    } else if (code == jobkeys::kGang) {
      push(k, jobkeys::wrap_add(sg.rb[l], x.job_placed[j]) >= sg.ma[l] ? 1ull : 0ull, 1);
    } else {
      F s = jobkeys::drf_share<F>(x.job_alloc + (size_t)j * p.R, x.drf_total, x.drf_present,
                                  p.R);
      s = s == F(0) ? F(0) : s;  // -0.0 ties +0.0
      push(k, (unsigned long long)okey::ord(s), (int)(8 * sizeof(F)));
    }
  }
  push(k, ord_i32(sg.tie[l]), 32);
  return k;
}

// task t opens a segment
__device__ __forceinline__ bool seg_start(const int32_t* job, const int32_t* queue,
                                          const int32_t* in_job, int t) {
  return t == 0 || job[t] != job[t - 1] || queue[t] != queue[t - 1] || in_job[t] < in_job[t - 1];
}

// exclusive prefix sum of v over the block; *total gets the sum
__device__ int block_excl_scan(int v, int* total, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? sm[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) sm[lane] = w;
  }
  __syncthreads();
  *total = sm[kWarps - 1];
  return (warp ? sm[warp - 1] : 0) + x - v;
}

template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const void* src, size_t n) {
  const T* s = (const T*)src;
  for (size_t i = threadIdx.x; i < n; i += kThreads) dst[i] = s[i];
}

template <typename T>
__device__ __forceinline__ void stage_out(void* dst, const T* src, size_t n) {
  T* d = (T*)dst;
  for (size_t i = threadIdx.x; i < n; i += kThreads) d[i] = src[i];
}

template <typename F>
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(TailParams p, int staged) {
  constexpr int NW = Words<F>::NW;
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Sel<F> sel;
  __shared__ unsigned long long wkey[kWarps][NW];
  __shared__ int wlive[kWarps];
  __shared__ F wval[kWarps];
  __shared__ int wim[kWarps];
  __shared__ F s_eps[kMaxR], s_total[kMaxR], s_bpw[kMaxR], s_wts[4];
  __shared__ uint8_t s_scalar[kMaxR], s_present[kMaxR];
  __shared__ int s_nlive, s_nactive, s_scan[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, N = p.N, T = p.T, J = p.J, Q = p.Q, S = p.S;
  const int32_t* task_cls = (const int32_t*)p.task_cls;
  const int32_t* task_job = (const int32_t*)p.task_job;
  const int32_t* task_queue = (const int32_t*)p.task_queue;
  const int32_t* task_ns = (const int32_t*)p.task_ns;
  const int32_t* task_in_job = (const int32_t*)p.task_in_job;
  const int32_t* task_excl = (const int32_t*)p.task_excl;

  const uint8_t* sig_mask = (const uint8_t*)p.sig_mask;
  const F* aff = (const F*)p.affinity_score;
  int32_t* assign = (int32_t*)p.assign;
  const uint8_t* active_g = (const uint8_t*)p.active;
  uint8_t* occ = (uint8_t*)p.excl_occ;
  uint8_t* tail_failed = (uint8_t*)p.tail_failed;
  int *gstart, *gfirst;
  const Segs gseg = global_segs(p.scratch, T, &gstart, &gfirst);

  const int K = p.K;
  const Layout lay = layout(T, N, R, J, Q, S, K, (int)sizeof(F), staged != 0);
  uint8_t* qover = dyn + lay.qover;
  F* idle = staged ? (F*)(dyn + lay.idle) : (F*)p.idle;
  F* used = staged ? (F*)(dyn + lay.used) : (F*)p.used;
  const F* nalloc = staged ? (const F*)(dyn + lay.nalloc) : (const F*)p.node_alloc;
  F* job_alloc = staged ? (F*)(dyn + lay.jalloc) : (F*)p.job_alloc;
  F* queue_alloc = staged ? (F*)(dyn + lay.qalloc) : (F*)p.queue_alloc;
  const F* queue_deserved = staged ? (const F*)(dyn + lay.qdes) : (const F*)p.queue_deserved;
  F* ns_alloc = staged ? (F*)(dyn + lay.nsalloc) : (F*)p.ns_alloc;
  int32_t* cnt = staged ? (int32_t*)(dyn + lay.cnt) : (int32_t*)p.cnt;
  const int32_t* nmax = staged ? (const int32_t*)(dyn + lay.nmax) : (const int32_t*)p.node_max_tasks;
  int32_t* job_placed = staged ? (int32_t*)(dyn + lay.jplaced) : (int32_t*)p.job_placed;
  uint8_t* active = staged ? (uint8_t*)(dyn + lay.active) : (uint8_t*)p.active;
  const F* cls_req = staged ? (const F*)(dyn + lay.creq) : (const F*)p.cls_req;
  const F* cls_initreq = staged ? (const F*)(dyn + lay.cireq) : (const F*)p.cls_initreq;
  const F* cls_nz_cpu = staged ? (const F*)(dyn + lay.cnzc) : (const F*)p.cls_nz_cpu;
  const F* cls_nz_mem = staged ? (const F*)(dyn + lay.cnzm) : (const F*)p.cls_nz_mem;
  const int32_t* cls_sig = staged ? (const int32_t*)(dyn + lay.csig) : (const int32_t*)p.cls_sig;
  const uint8_t* cls_has_pod =
      staged ? (const uint8_t*)(dyn + lay.cpod) : (const uint8_t*)p.cls_has_pod;

  PROF_START();
  // 1. the constants, the staged state, the gate, the count of live tasks,
  // the segments' first live tasks cleared
  if (tid < R) {
    s_eps[tid] = ((const F*)p.eps)[tid];
    s_total[tid] = ((const F*)p.drf_total)[tid];
    s_bpw[tid] = ((const F*)p.binpack_w)[tid];
    s_scalar[tid] = ((const uint8_t*)p.is_scalar)[tid];
    s_present[tid] = ((const uint8_t*)p.drf_present)[tid];
  }
  if (tid < 4) s_wts[tid] = ((const F*)p.score_weights)[tid];
  if (tid == 0) {
    s_nlive = 0;
    s_nactive = 0;
  }
  if (staged) {
    const size_t nr = (size_t)N * R;
    stage_in(idle, p.idle, nr);
    stage_in(used, p.used, nr);
    stage_in((F*)nalloc, p.node_alloc, nr);
    stage_in(job_alloc, p.job_alloc, (size_t)J * R);
    stage_in(queue_alloc, p.queue_alloc, (size_t)Q * R);
    stage_in((F*)queue_deserved, p.queue_deserved, (size_t)Q * R);
    stage_in(ns_alloc, p.ns_alloc, (size_t)S * R);
    stage_in(cnt, p.cnt, (size_t)N);
    stage_in((int32_t*)nmax, p.node_max_tasks, (size_t)N);
    stage_in(job_placed, p.job_placed, (size_t)J);
    stage_in(active, p.active, (size_t)T);
    stage_in((F*)cls_req, p.cls_req, (size_t)K * R);
    stage_in((F*)cls_initreq, p.cls_initreq, (size_t)K * R);
    stage_in((F*)cls_nz_cpu, p.cls_nz_cpu, (size_t)K);
    stage_in((F*)cls_nz_mem, p.cls_nz_mem, (size_t)K);
    stage_in((int32_t*)cls_sig, p.cls_sig, (size_t)K);
    stage_in((uint8_t*)cls_has_pod, p.cls_has_pod, (size_t)K);
  }
  for (int q = tid; q < Q; q += kThreads)
    qover[q] = p.use_prop_overused
                   ? overused<F>((const F*)p.queue_alloc + (size_t)q * R,
                                 (const F*)p.queue_deserved + (size_t)q * R, (const F*)p.eps,
                                 (const uint8_t*)p.is_scalar, R)
                   : 0;
  for (int t = tid; t < T; t += kThreads) gfirst[t] = 0x7fffffff;
  // each thread a run of tasks: its segment starts and live tasks
  const int per = (T + kThreads - 1) / kThreads;
  const int lo = min(T, tid * per), hi = min(T, lo + per);
  int n_start = 0, n_act = 0;
  for (int t = lo; t < hi; ++t) {
    n_start += seg_start(task_job, task_queue, task_in_job, t);
    n_act += active_g[t] != 0;
  }
  for (int off = 16; off > 0; off >>= 1) n_act += __shfl_down_sync(kFull, n_act, off);
  int n_seg = 0;
  int sid = block_excl_scan(n_start, &n_seg, s_scan) - 1;  // barriers inside
  // after the scan's barriers, which order thread 0's zeroing before it
  if (lane == 0 && n_act) atomicAdd(&s_nactive, n_act);

  // 2. the segments: their starts, and each one's first live task
  for (int t = lo; t < hi; ++t) {
    if (seg_start(task_job, task_queue, task_in_job, t)) gstart[++sid] = t;
    if (active_g[t]) atomicMin(&gfirst[sid], t);
  }
  __syncthreads();
  const Ctx<F> cx{p, job_placed, job_alloc, s_total, s_present};
  for (int g = tid; g < n_seg; g += kThreads) {
    const int cur = gfirst[g];
    if (cur == 0x7fffffff) continue;
    const int l = atomicAdd(&s_nlive, 1);
    const int s0 = gstart[g], j = task_job[s0];
    gseg.prio[l] = ((const int32_t*)p.job_priority)[j];
    gseg.rb[l] = ((const int32_t*)p.job_ready_base)[j];
    gseg.ma[l] = ((const int32_t*)p.job_min_available)[j];
    gseg.tie[l] = ((const int32_t*)p.job_tie_rank)[j];
    const Key<NW - 1> k = job_words<NW, F>(cx, gseg, l, j);
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) gseg.word(l, i) = k.w[i];
    // a segment of a queue already over its share sits out for the pass
    // (a queue's allocation only grows in it): its task word is dead
    gseg.word(l, NW - 1) =
        p.use_prop_overused && qover[task_queue[s0]] ? kDead : task_word(task_in_job[cur], cur);
    gseg.queue[l] = task_queue[s0];
    gseg.end[l] = g + 1 < n_seg ? gstart[g + 1] : T;
    gseg.job[l] = j;
    gseg.cls[l] = task_cls[cur];
    gseg.excl[l] = task_excl[cur];
    gseg.ns[l] = task_ns[cur];
  }
  __syncthreads();
  const int L = s_nlive;
  // few segments: their table in shared memory, and warp 0 selects alone
  const bool block_sel = L > kSegSmem;
  Segs seg = gseg;
  if (!block_sel) {
    seg = Segs((unsigned long long*)(dyn + lay.segw), (int*)(dyn + lay.segi), kSegSmem);
    for (int l = tid; l < L; l += kThreads) {
#pragma unroll
      for (int i = 0; i < NW; ++i) seg.word(l, i) = gseg.word(l, i);
      for (int c = 0; c < kSegInts; ++c) seg.queue[c * kSegSmem + l] = gseg.queue[(size_t)c * T + l];
    }
    __syncthreads();
  }
  int placed = 0;
  PROF(0);

  for (int step = 0; step < p.budget; ++step) {
    // 3. the select: the least candidate over the live segments of queues
    // under their share (all warps first where many segments live)
    Key<NW> best;
    int bl = -1;
#pragma unroll
    for (int i = 0; i < NW; ++i) best.w[i] = kDead;
    if (block_sel || warp == 0) {
      const int first = block_sel ? tid : lane, stride = block_sel ? kThreads : 32;
#pragma unroll 4
      for (int l = first; l < L; l += stride) {
        Key<NW> k;
#pragma unroll
        for (int i = 0; i < NW; ++i) k.w[i] = seg.word(l, i);
        // a dead task word: no live task left, or its queue over its share
        const bool take = (k.w[NW - 1] != kDead) & less(k, best);
#pragma unroll
        for (int i = 0; i < NW; ++i) best.w[i] = take ? k.w[i] : best.w[i];
        bl = take ? l : bl;
      }
      warp_lex_min(best, bl);
    }
    if (block_sel) {
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NW; ++i) wkey[warp][i] = best.w[i];
        wlive[warp] = bl;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < NW; ++i) best.w[i] = lane < kWarps ? wkey[lane][i] : kDead;
        bl = lane < kWarps ? wlive[lane] : -1;
        warp_lex_min(best, bl);
      }
    }
    if (warp == 0) {
      // live keys are unique (the index is in them): every lane holds the
      // winner; with nothing eligible the step runs task 0's class
      const bool has = best.w[NW - 1] != kDead;
      const int t = has ? (int)(uint32_t)best.w[NW - 1] : 0;
      const int c = has ? seg.cls[bl] : task_cls[0];
      if (lane < R) {
        sel.req[lane] = cls_req[(size_t)c * R + lane];
        sel.ireq[lane] = cls_initreq[(size_t)c * R + lane];
      }
      if (lane == 0) {
        sel.stop = s_nactive == 0;
        sel.t = t;
        sel.live = bl;
        sel.has = has;
        sel.c = c;
        sel.sig = cls_sig[c];
        sel.g = has ? seg.excl[bl] : task_excl[0];
        sel.job = has ? seg.job[bl] : task_job[0];
        sel.q = has ? seg.queue[bl] : task_queue[0];
        sel.ns = has ? seg.ns[bl] : task_ns[0];
        sel.has_pod = cls_has_pod[c];
        sel.nz_cpu = cls_nz_cpu[c];
        sel.nz_mem = cls_nz_mem[c];
      }
    }
    __syncthreads();
    PROF(2);
    if (sel.stop) break;
    const bool has = sel.has != 0;

    // 4. the class row's mask and score over the nodes, the first maximum
    {
      const int sig = sel.sig, g = sel.g;
      F nv = F(-INFINITY);
      int nim = 0x7fffffff;
      for (int n = tid; n < N; n += kThreads) {
        bool mask = sig_mask[(size_t)sig * N + n] != 0;
        for (int r = 0; r < R; ++r) {
          const F ir = sel.ireq[r];
          const bool le = ir < idle[(size_t)n * R + r] + s_eps[r];
          const bool skip = s_scalar[r] && ir <= F(kMinMilliScalar);
          mask = mask && (le || skip);
        }
        if (p.check_pod_count) mask = mask && ((cnt[n] < nmax[n]) || !sel.has_pod);
        if (p.use_exclusion) mask = mask && !(occ[(size_t)(g > 0 ? g : 0) * N + n] && g >= 0);
        // a node the mask fails takes -inf, scored or not
        const F v = mask ? scorefn::fused_score<F>(
                               R, sel.req, sel.nz_cpu, sel.nz_mem, used + (size_t)n * R,
                               nalloc + (size_t)n * R, aff[(size_t)sig * N + n], s_bpw, s_wts,
                               p.use_nodeorder != 0, p.use_binpack != 0)
                         : F(-INFINITY);
        const int im = (n << 1) | (mask ? 1 : 0);
        if (node_better(v, im, nv, nim)) {
          nv = v;
          nim = im;
        }
      }
      warp_node_max(nv, nim);
      if (lane == 0) {
        wval[warp] = nv;
        wim[warp] = nim;
      }
    }
    __syncthreads();
    PROF(3);

    // 5. the commit, by warp 0
    if (warp == 0) {
      F nv = lane < kWarps ? wval[lane] : F(-INFINITY);
      int nim = lane < kWarps ? wim[lane] : 0x7fffffff;
      warp_node_max(nv, nim);
      const int t = sel.t, j = sel.job;
      const bool ok = has && (nim & 1);
      const int node = nim >> 1;
      const int q = sel.q, ns = sel.ns, g = sel.g;
      // a lane a dimension, then a lane each for the scalar updates
      if (lane < R) {
        const F d = ok ? sel.req[lane] : F(0);
        const size_t nr = (size_t)node * R + lane, jr = (size_t)j * R + lane,
                     qr = (size_t)q * R + lane, sr = (size_t)ns * R + lane;
        // every row read before any is written: one latency
        const F a = idle[nr], b = used[nr], cj = job_alloc[jr], cq = queue_alloc[qr],
                cn = ns_alloc[sr];
        idle[nr] = a + (-d);
        used[nr] = b + d;
        job_alloc[jr] = cj + d;
        queue_alloc[qr] = cq + d;
        ns_alloc[sr] = cn + d;
      } else if (lane == R) {
        cnt[node] += ok ? 1 : 0;
      } else if (lane == R + 1) {
        job_placed[j] += ok ? 1 : 0;
      }
      if (lane == 0) {
        if (has) {
          active[t] = 0;
          s_nactive -= 1;
        }
        placed += ok ? 1 : 0;
      }
      __syncwarp();
      PROF(4);
      // the gate of the one queue this step charged
      const bool crossed = p.use_prop_overused && !qover[q] &&
                           overused<F>(queue_alloc + (size_t)q * R,
                                       queue_deserved + (size_t)q * R, s_eps, s_scalar, R);
      PROF(1);
      __syncwarp();
      if (has) {
        // the segment's cursor to its next live task (32 flags a ballot)
        // and that task's columns; then the job's keys in each of its
        // live segments
        const int l = sel.live, e = seg.end[l];
        int cur = -1;
        for (int base = t + 1; base < e; base += 32) {
          const int x = base + lane;
          const unsigned b = __ballot_sync(kFull, x < e && active[x] != 0);
          if (b) {
            cur = base + __ffs(b) - 1;
            break;
          }
        }
        if (lane == 0) {
          if (cur >= 0) {
            seg.word(l, NW - 1) = task_word(task_in_job[cur], cur);
            seg.cls[l] = task_cls[cur];
            seg.excl[l] = task_excl[cur];
            seg.ns[l] = task_ns[cur];
          } else {
            seg.word(l, NW - 1) = kDead;
          }
        }
        const Key<NW - 1> k = job_words<NW, F>(cx, seg, l, j);
        for (int l2 = lane; l2 < L; l2 += 32) {
          if (seg.job[l2] != j) continue;
#pragma unroll
          for (int i = 0; i < NW - 1; ++i) seg.word(l2, i) = k.w[i];
        }
      }
      __syncwarp();
      if (crossed) {
        // the queue crossed its share: its segments sit out from now on
        if (lane == 0) qover[q] = 1;
        for (int l2 = lane; l2 < L; l2 += 32)
          if (seg.queue[l2] == q) seg.word(l2, NW - 1) = kDead;
        __syncwarp();
      }
      // the stores to global memory last: the next barrier, a select
      // later, orders them before the next sweep reads the occupancy
      if (lane == R + 2) {
        if (ok) assign[t] = node;
        if (has && !ok) tail_failed[t] = 1;
        if (p.use_exclusion && ok && g >= 0) occ[(size_t)g * N + node] = 1;
      }
      PROF(4);
    }
    if (block_sel) __syncthreads();
    PROF_UNIT();
    if (!has) break;
  }
  __syncthreads();
  if (staged) {
    const size_t nr = (size_t)N * R;
    stage_out(p.idle, idle, nr);
    stage_out(p.used, used, nr);
    stage_out(p.job_alloc, job_alloc, (size_t)J * R);
    stage_out(p.queue_alloc, queue_alloc, (size_t)Q * R);
    stage_out(p.ns_alloc, ns_alloc, (size_t)S * R);
    stage_out(p.cnt, cnt, (size_t)N);
    stage_out(p.job_placed, job_placed, (size_t)J);
    stage_out(p.active, active, (size_t)T);
  }
  if (tid == 0) ((int32_t*)p.ctl)[rctl::C_TAIL_PLACED] = placed;
  PROF_END();
}

// the dynamic shared memory a block may take (set once a process)
template <typename F>
int max_dyn() {
  static std::mutex mu;
  static int m = -1;
  std::lock_guard<std::mutex> lock(mu);
  if (m < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, tail_kernel<F>) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    const int want = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(tail_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             want) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    m = want;
  }
  return m;
}

// 1 when the state and the class columns fit in shared memory, 0 when they
// stay in global memory, -1 when not even the gate fits
template <typename F>
int placement(int T, int N, int R, int J, int Q, int S, int K) {
  const int m = max_dyn<F>();
  if (m < 0) return -1;
  for (int staged = 1; staged >= 0; --staged)
    if (layout(T, N, R, J, Q, S, K, (int)sizeof(F), staged != 0).total <= (size_t)m)
      return staged;
  return -1;
}

template <typename F>
int launch(const TailParams* p, void* stream) {
  if (p->R > kMaxR || p->R < 2 || p->T <= 0 || p->N <= 0 || p->J <= 0 || p->Q <= 0 ||
      p->S <= 0 || p->K <= 0 || p->n_job_keys > 3 || p->scratch == nullptr ||
      p->N >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int staged = placement<F>(p->T, p->N, p->R, p->J, p->Q, p->S, p->K);
  if (staged < 0) return (int)cudaErrorInvalidConfiguration;
  const Layout lay = layout(p->T, p->N, p->R, p->J, p->Q, p->S, p->K, (int)sizeof(F), staged != 0);
  tail_kernel<F><<<1, kThreads, lay.total, (cudaStream_t)stream>>>(*p, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long tail_pass_scratch_bytes(int T, int J) {
  return (long long)scratch_bytes(T, J);
}

// the placement a launch of these sizes takes (1 the state and the class
// columns in shared memory, 0 in global memory, -1 none fits)
extern "C" int tail_pass_placement(int T, int N, int R, int J, int Q, int S, int K, int f64) {
  return f64 ? placement<double>(T, N, R, J, Q, S, K) : placement<float>(T, N, R, J, Q, S, K);
}

extern "C" int tail_pass_f32(const TailParams* p, void* stream) {
  return launch<float>(p, stream);
}
extern "C" int tail_pass_f64(const TailParams* p, void* stream) {
  return launch<double>(p, stream);
}

#ifdef K7B_PROFILE
// the phases' cycles and the steps of the last launch, then its two
// globaltimer marks (ns)
extern "C" int k7b_profile_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k7b_prof_t, sizeof(k7b_prof_t));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + kProfPhases + 1, k7b_prof_span,
                                   sizeof(k7b_prof_span));
}
#endif
