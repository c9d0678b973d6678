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
// Design: one block of 1024 threads (reclaim: a cluster's first CTA). A
// push sifts only within its own row, and a slot's decision reads only the
// fixed carried state, so:
//   0. the outputs are zeroed with 16-byte stores and, for reclaim, a
//      cluster of 8 CTAs folds the eviction mask (eight victims a thread a
//      batch, the loads ahead of the atomics), then CTA 0 goes on alone;
//   1. every slot decides at once — a thread a run of consecutive slots,
//      all their loads in flight (preempt: pushable and the under entry;
//      reclaim: eligible and live, and each queue row's first eligible slot
//      by an int atomicMin — where the reference's qpushed flips) — and one
//      block scan a pass places the job pushes in slot order;
//   2. each pushed job's key — (priority, gang readiness, drf share by
//      share2, rank), the fields job_order compares in the D_key0..2 order
//      — is computed once, in parallel, into shared memory (global scratch
//      when the push list outgrows it), packed into one 128-bit number whose
//      unsigned order is job_order's (JKey below), and each queue row's
//      (share, rank); a precomputed share is the float the reference's
//      comparison computes, so every comparison decides as it does;
//   3. a warp a row replays the row's pushes in slot order (ballots pick
//      them from the list) into the row's segment of a heap whose entries
//      hold a push's key beside its index, one push at a time with its
//      ancestors compared at once (below), one more lane the queue pushes
//      in the order of their first slots;
//   4. each row's pushed jobs go out over the zeros.
//
// Bound: the bytes it must move (the push orders and keys read once, the
// heaps written once) over the memory rate, well under a microsecond at
// cfg4; a row's pushes are dependent (each sifts into the heap the ones
// before it left), so the longest row bounds the time: a few shared-memory
// round trips a push.
//
// Built with -DK13_PROFILE, PROF(k) marks add thread 0's clock between
// marks to phase k's counter and PROF_UNIT() counts the pushes (at the
// lanes that make them), in shared memory, copied out at the kernel's end
// with globaltimer marks of its start and end
// (volcano_tpu_torch/bench/kernel_profile.py reads them); otherwise they
// compile to nothing.

#include <cooperative_groups.h>
#include <stdint.h>

#include "evict_common.cuh"

#ifdef K13_PROFILE
constexpr int kProfPhases = 4;
// the phases' cycles at thread 0, then the pushes: kept in shared memory
// while the kernel runs (a mark costs no global round trip), copied out at
// its end
__device__ long long k13_prof_t[kProfPhases + 1];
__shared__ long long k13_prof_s[kProfPhases + 1];
__shared__ long long k13_prof_last;
// globaltimer ns at the kernel's start and end (CTA 0 thread 0)
__device__ unsigned long long k13_prof_span[2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(k)                                                  \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      const long long now_ = clock64();                          \
      k13_prof_s[k] += now_ - k13_prof_last;                     \
      k13_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNIT()                                              \
  atomicAdd((unsigned long long*)&k13_prof_s[kProfPhases], 1ull)
#define PROF_START()                                             \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k13_prof_s[k_] = 0; \
      k13_prof_last = clock64();                                 \
      if (blockIdx.x == 0) k13_prof_span[0] = gtime();           \
    }                                                            \
    __syncthreads();                                             \
  } while (0)
#define PROF_END()                                               \
  do {                                                           \
    __syncthreads();                                             \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k13_prof_t[k_] = k13_prof_s[k_]; \
      k13_prof_span[1] = gtime();                                \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNIT() do {} while (0)
#define PROF_START() do {} while (0)
#define PROF_END() do {} while (0)
#endif

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

using namespace ev;

constexpr int kFhThreads = 1024;
constexpr int kFhWarps = kFhThreads / 32;
constexpr int kNone = 0x7fffffff;
constexpr int kCountCtas = 8;   // reclaim: the CTAs that fold the eviction mask

#define FH_PTRS(X)                                                           \
  X(job_prio) X(job_min_av) X(job_tie) X(drf_total) X(queue_deserved)       \
  X(queue_tie) X(ready) X(job_alloc) X(queue_alloc) X(live_job)             \
  X(push_jobs) X(push_row) X(ev_jobs) X(ev_qrow) X(elig0) X(vtn0)           \
  X(vic_job) X(vic_valid) X(alive) X(heap) X(hsize) X(under) X(qheap)       \
  X(qhsize) X(evicted) X(qpushed) X(work) X(spill)
#define FH_DIMS(X)                                                           \
  X(J) X(ROWS) X(JCAP) X(PB) X(EB) X(NV) X(QH) X(use_gang_valid) X(n_keys)  \
  X(key0) X(key1) X(key2) X(use_prop_queue_order) X(cap)

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

// a pushed job's job_order key, packed into one 128-bit unsigned number
// whose order is job_order's: the enabled keys' fields in tier order, most
// significant first, then the rank. Priority (desc) as its biased bits
// inverted, gang readiness (non-ready first) as one bit, the drf share
// (asc; share2 is never below zero) as its bits with -0.0 taken as +0.0,
// so the fields compare as the reference's != and < do; 32 + 1 + 63 + 32
// bits at most (float64 shares).
struct JKey {
  unsigned long long hi, lo;
};

// a queue row's queue_order key
template <typename T>
struct QKey {
  T share;
  int tie;
};

// job_order's enabled keys, read once into registers
struct KeyOrder {
  int n, k0, k1, k2;
};

__device__ __forceinline__ void put(JKey& k, unsigned long long v, int w) {
  k.hi = (k.hi << w) | (k.lo >> (64 - w));
  k.lo = (k.lo << w) | v;
}

__device__ __forceinline__ void put_share(JKey& k, float s) {
  put(k, s == 0.0f ? 0ull : (unsigned long long)__float_as_uint(s), 31);
}

__device__ __forceinline__ void put_share(JKey& k, double s) {
  put(k, s == 0.0 ? 0ull : (unsigned long long)__double_as_longlong(s), 63);
}

template <typename T>
__device__ __forceinline__ JKey job_key(const KeyOrder& o, int prio, bool ready, T share,
                                        int tie) {
  JKey k{0ull, 0ull};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= o.n) break;
    const int key = i == 0 ? o.k0 : (i == 1 ? o.k1 : o.k2);
    if (key == KEY_PRIORITY) put(k, ~((unsigned)prio ^ 0x80000000u), 32);
    else if (key == KEY_GANG) put(k, ready ? 1ull : 0ull, 1);
    else if (key == KEY_DRF) put_share(k, share);
  }
  put(k, (unsigned)tie ^ 0x80000000u, 32);
  return k;
}

// Machine::job_less on packed keys
__device__ __forceinline__ bool job_less(const JKey& x, const JKey& y) {
  return x.hi < y.hi || (x.hi == y.hi && x.lo < y.lo);
}

// Machine::queue_less on precomputed keys
template <typename T>
__device__ __forceinline__ bool queue_less(bool prop, const QKey<T>& x, const QKey<T>& y) {
  if (prop && x.share != y.share) return x.share < y.share;
  return x.tie < y.tie;
}

// a heap entry: a push's key beside its index, so a comparison with an
// ancestor is one load
struct __align__(16) HEnt {
  JKey key;
  int item;
};

// the scratch layouts, from the slot count S and the rows: `work` (global)
// holds the rows' queue keys, then the push list's jobs and rows and the
// rows' counts, offsets, first eligible slots and queue order; the push
// list's heap entries, keys and rows live in shared memory up to `cap`
// pushes, else in `spill` (global)
template <typename T>
struct Layout {
  size_t ints, work, per_push;   // the ints' offset in `work`, its bytes
  __host__ __device__ Layout(int S, int ROWS) {
    ints = ((size_t)ROWS * sizeof(QKey<T>) + 15) / 16 * 16;
    work = ints + sizeof(int) * (2 * (size_t)S + 4 * (size_t)ROWS);
    per_push = sizeof(HEnt) + sizeof(JKey) + sizeof(int);  // heap entry, key, row
  }
};

// out[i] = in[0] + ... + in[i - 1] for i < n (every thread calls)
__device__ __forceinline__ void block_scan(const int* in, int* out, int n, int* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kFhThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n ? in[i] : 0;
    int incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[w] = incl;
    __syncthreads();
    int before = carry, total = carry;
#pragma unroll
    for (int q = 0; q < kFhWarps; ++q) {
      const int t = warp_tot[q];
      before += q < w ? t : 0;
      total += t;
    }
    if (i < n) out[i] = before + incl - x;
    carry = total;
    __syncthreads();
  }
}

// the jobs' evictions during preempt: +1 a valid victim no longer alive
// (exact int sums in any order), over this CTA's share [lo, hi) of the
// mask; eight entries a thread a batch, every load of a batch before its
// atomics (coalesced across the warp; the tables need no alignment)
__device__ __forceinline__ void count_evictions(const uint8_t* valid, const uint8_t* alive,
                                                const int* vjob, int lo, int hi, int* evicted) {
  constexpr int kB = 8;
  for (int base = lo; base < hi; base += kFhThreads * kB) {
    bool dead[kB];
    int j[kB];
#pragma unroll
    for (int m = 0; m < kB; ++m) {
      const int k = base + m * kFhThreads + (int)threadIdx.x;
      dead[m] = k < hi && valid[k] && !alive[k];
      j[m] = k < hi ? vjob[k] : 0;
    }
#pragma unroll
    for (int m = 0; m < kB; ++m)
      if (dead[m]) atomicAdd(&evicted[j[m]], 1);
  }
}

// one slot's decision: (the job, its row, pushed as a job, eligible)
struct Slot {
  int j, row;
  bool push, elig;
};

template <int kReclaim>
__device__ __forceinline__ Slot decide(const FhArgs& f, int i, const int* evicted) {
  const int J = f.d[G_J], ROWS = f.d[G_ROWS];
  const uint8_t* live = fp<const uint8_t>(f, F_live_job);
  Slot s;
  if (!kReclaim) {
    s.j = fp<const int>(f, F_push_jobs)[i];
    s.push = s.j >= 0 && live[min(max(s.j, 0), J - 1)];
    s.elig = false;
    s.row = min(max(fp<const int>(f, F_push_row)[i], 0), ROWS - 1);
  } else {
    s.j = fp<const int>(f, F_ev_jobs)[i];
    const int jc = min(max(s.j, 0), J - 1);
    s.row = min(max(fp<const int>(f, F_ev_qrow)[i], 0), ROWS - 1);
    bool elig = s.j >= 0 && fp<const uint8_t>(f, F_elig0)[jc];
    if (f.d[G_use_gang_valid])
      elig = elig && fp<const int>(f, F_vtn0)[jc] - __ldcg(evicted + jc) >=
                         fp<const int>(f, F_job_min_av)[jc];
    s.elig = elig;
    s.push = elig && live[jc];
  }
  return s;
}

// exclusive prefix of v over the block in thread order; `total` gets the
// sum (every thread calls)
__device__ __forceinline__ int block_excl(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[w] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int q = 0; q < kFhWarps; ++q) {
    const int t = warp_tot[q];
    before += q < w ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + incl - v;
}

// the push list's scratch and the rows' counters in the work arena
struct Rows {
  const int* ev_job;
  const int* ev_row;
  int *r_cnt, *r_off, *first, *qorder;
  int E, S, ROWS, JCAP;
};

// phases 1 (keys) to 3 (the heaps out) over the push list's scratch at
// `mem`, room for `kcap` pushes: heap entries, keys, rows
template <typename T, int kReclaim>
__device__ __forceinline__ void rebuild(const FhArgs& f, const Rows& rw, QKey<T>* qkeys,
                                        const KeyOrder& order, unsigned char* mem,
                                        int kcap, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = rw.E, ROWS = rw.ROWS, JCAP = rw.JCAP;
  const int* ev_job = rw.ev_job;
  const int* ev_row = rw.ev_row;
  int* r_cnt = rw.r_cnt;
  int* r_off = rw.r_off;
  int* first = rw.first;
  int* qorder = rw.qorder;
  int* heap = fp<int>(f, F_heap);
  HEnt* hent = reinterpret_cast<HEnt*>(mem);
  JKey* keys = reinterpret_cast<JKey*>(mem + (size_t)kcap * sizeof(HEnt));
  int* rows = reinterpret_cast<int*>(mem + (size_t)kcap * (sizeof(HEnt) + sizeof(JKey)));
  {
    const int* ready = fp<const int>(f, F_ready);
    const int* min_av = fp<const int>(f, F_job_min_av);
    const int* prio = fp<const int>(f, F_job_prio);
    const int* tie = fp<const int>(f, F_job_tie);
    const T* ja = fp<const T>(f, F_job_alloc);
    const T* tot = fp<const T>(f, F_drf_total);
    const T t0 = tot[0], t1 = tot[1];
    for (int base = 0; base < E; base += kFhThreads) {
      const int e = base + tid;
      int r = -1;
      if (e < E) {
        const int j = ev_job[e];
        r = ev_row[e];
        keys[e] = job_key<T>(order, prio[j], ready[j] >= min_av[j],
                             share2(ja[2 * j], ja[2 * j + 1], t0, t1), tie[j]);
        rows[e] = r;
      }
      // the rows' push counts: one atomic a row a warp
      const unsigned grp = __match_any_sync(kFull, r);
      if (r >= 0 && lane == __ffs(grp) - 1) atomicAdd(&r_cnt[r], __popc(grp));
    }
  }
  int nq = 0;
  if (kReclaim) {
    const T* qa = fp<const T>(f, F_queue_alloc);
    const T* des = fp<const T>(f, F_queue_deserved);
    const int* qtie = fp<const int>(f, F_queue_tie);
    const bool prop = f.d[G_use_prop_queue_order] != 0;
    for (int q = tid; q < ROWS; q += kFhThreads) {
      QKey<T> k;
      k.share = prop ? share2(qa[2 * q], qa[2 * q + 1], des[2 * q], des[2 * q + 1]) : T(0);
      k.tie = qtie[q];
      qkeys[q] = k;
    }
  }
  __syncthreads();
  block_scan(r_cnt, r_off, ROWS, warp_tot);
  if (kReclaim) {
    // the queue pushes' order: rows by their first eligible slot (distinct)
    for (int q = tid; q < ROWS; q += kFhThreads) {
      const int fq = first[q];
      fp<uint8_t>(f, F_qpushed)[q] = fq != kNone;
      if (fq != kNone) {
        int rank = 0;
        for (int p = 0; p < ROWS; ++p) rank += first[p] < fq;
        qorder[rank] = q;
      }
    }
    for (int base = 0; base < ROWS; base += kFhThreads)
      nq += __syncthreads_count(base + tid < ROWS && first[base + tid] != kNone);
  }
  __syncthreads();
  PROF(1);

  // -- 2. the pushes: a warp a row, in slot order; the queue heap ------------
  // heapq's _siftdown compares the new item with its ancestors from the
  // parent up and stops at the first that is not greater: the warp makes
  // those comparisons at once (lane m the m-th ancestor), the ballot's first
  // "not greater" gives the stop, and the ancestors below it move down one
  // level each
  for (int r = warp; r < ROWS; r += kFhWarps) {
    const int n = r_cnt[r];
    HEnt* h = hent + r_off[r];
    int size = 0;
    for (int b0 = 0; b0 < E && size < n; b0 += 32) {
      const int e = b0 + lane;
      unsigned m = __ballot_sync(kFull, e < E && rows[e] == r);
      while (m) {
        HEnt it;
        it.item = b0 + __ffs(m) - 1;
        it.key = keys[it.item];
        m &= m - 1;
        const unsigned q = (unsigned)size + 1;       // the new leaf, 1-based
        const int depth = 31 - __clz(q);             // its ancestors
        const bool anc = lane >= 1 && lane <= depth;
        HEnt a;
        if (anc) a = h[(q >> lane) - 1];
        const bool lt = anc && job_less(it.key, a.key);
        const unsigned stop = ~__ballot_sync(kFull, lt) & (((2u << depth) - 1u) & ~1u);
        const int up = stop ? __ffs(stop) - 2 : depth;   // levels it rises
        __syncwarp();
        if (lane >= 1 && lane <= up) h[(q >> (lane - 1)) - 1] = a;
        if (lane == 0) h[(q >> up) - 1] = it;
        __syncwarp();
        size += 1;
        if (lane == 0) PROF_UNIT();
      }
    }
  }
  if (kReclaim && tid == kFhThreads - 32) {
    int* qheap = fp<int>(f, F_qheap);
    for (int k = 0; k < nq; ++k) {
      const int q = qorder[k];
      const QKey<T> kq = qkeys[q];
      int pos = k;
      while (pos > 0) {
        const int parent = (pos - 1) / 2;
        const int pq = qheap[parent];
        if (!queue_less(f.d[G_use_prop_queue_order] != 0, kq, qkeys[pq])) break;
        qheap[pos] = pq;
        pos = parent;
      }
      qheap[pos] = q;
      PROF_UNIT();
    }
    *fp<int>(f, F_qhsize) = nq;
  }
  __syncthreads();
  PROF(2);

  // -- 3. each row's heap out: the pushes' jobs over the zeros ---------------
  for (int r = warp; r < ROWS; r += kFhWarps) {
    const int n = r_cnt[r], off = r_off[r];
    for (int p = lane; p < n && p < JCAP; p += 32)
      heap[(size_t)r * JCAP + p] = ev_job[hent[off + p].item];
    if (lane == 0) fp<int>(f, F_hsize)[r] = n;
  }
}

template <typename T, int kReclaim>
__device__ __forceinline__ void fuse_heaps_body(const FhArgs& f, unsigned char* smem,
                                                int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int J = f.d[G_J], ROWS = f.d[G_ROWS], JCAP = f.d[G_JCAP];
  const int S = kReclaim ? f.d[G_EB] : f.d[G_PB];
  const Layout<T> lay(S, ROWS);
  unsigned char* work = fp<unsigned char>(f, F_work);
  QKey<T>* qkeys = reinterpret_cast<QKey<T>*>(work);
  int* ev_job = reinterpret_cast<int*>(work + lay.ints);
  int* ev_row = ev_job + S;
  int* r_cnt = ev_row + S;
  int* r_off = r_cnt + ROWS;
  int* first = r_off + ROWS;
  int* qorder = first + ROWS;
  int* evicted = fp<int>(f, F_evicted);
  int* heap = fp<int>(f, F_heap);
  const KeyOrder order{f.d[G_n_keys], f.d[G_key0], f.d[G_key1], f.d[G_key2]};

  // -- 0. counters and outputs zeroed; reclaim: the jobs' evictions ---------
  for (int i = tid; i < ROWS; i += kFhThreads) {
    r_cnt[i] = 0;
    first[i] = kNone;
  }
  {
    const size_t n = (size_t)ROWS * JCAP;
    size_t done = 0;
    if (((uintptr_t)heap & 15) == 0) {
      done = n / 4 * 4;
      for (size_t q = tid; q < n / 4; q += kFhThreads)
        reinterpret_cast<int4*>(heap)[q] = make_int4(0, 0, 0, 0);
    }
    for (size_t q = done + tid; q < n; q += kFhThreads) heap[q] = 0;
  }
  if (kReclaim) {
    int* qheap = fp<int>(f, F_qheap);
    for (int i = tid; i < f.d[G_QH]; i += kFhThreads) qheap[i] = 0;
  }
  __syncthreads();
  PROF(0);

  // -- 1. every slot's decision; the job pushes compacted in slot order ------
  // a thread decides `per` consecutive slots (their loads all in flight),
  // then one block scan places its pushes
  const int per = min(32, max(1, (S + kFhThreads - 1) / kFhThreads));
  int E = 0;
  for (int base = 0; base < S; base += kFhThreads * per) {
    const int lo = base + tid * per;
    unsigned push = 0, elig = 0;
#pragma unroll 4
    for (int m = 0; m < per; ++m) {
      if (lo + m < S) {
        const Slot sl = decide<kReclaim>(f, lo + m, evicted);
        push |= (unsigned)sl.push << m;
        elig |= (unsigned)sl.elig << m;
      }
    }
    int total;
    int at = E + block_excl(__popc(push), warp_tot, total);
    // the stores after every load above (the tables may alias, so a store
    // would hold the next slot's loads back); the slots read again hit L1
    if (kReclaim) {
      // each row's first eligible slot: one atomicMin a row a warp a step
      for (int m = 0; m < per; ++m) {
        const bool e = (elig >> m) & 1;
        const int row = e ? min(max(fp<const int>(f, F_ev_qrow)[lo + m], 0), ROWS - 1) : -1;
        const unsigned grp = __match_any_sync(kFull, row);
        if (e && lane == __ffs(grp) - 1) atomicMin(&first[row], lo + m);
      }
    }
    for (unsigned m = kReclaim ? push : (per < 32 ? (1u << per) - 1u : ~0u); m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      if (lo + b >= S) break;
      const Slot sl = decide<kReclaim>(f, lo + b, evicted);
      const bool pushed = (push >> b) & 1;
      if (!kReclaim) fp<int>(f, F_under)[lo + b] = pushed ? sl.j : -1;
      if (pushed) {
        ev_job[at] = sl.j;
        ev_row[at] = sl.row;
        ++at;
      }
    }
    E += total;
  }
  __syncthreads();
  // the pushes' keys, rows and heaps: shared memory when the list fits (a
  // call a memory space, so each one's loads are of that space)
  const Rows rw{ev_job, ev_row, r_cnt, r_off, first, qorder, E, S, ROWS, JCAP};
  if (E <= f.d[G_cap])
    rebuild<T, kReclaim>(f, rw, qkeys, order, smem, f.d[G_cap], warp_tot);
  else
    rebuild<T, kReclaim>(f, rw, qkeys, order, fp<unsigned char>(f, F_spill), S, warp_tot);
  PROF(3);
  PROF_END();
}

// reclaim: a cluster of kCountCtas CTAs folds the eviction mask (CTA 0
// zeroes the counts first), then CTA 0 alone goes on; preempt: one CTA
template <typename T>
__global__ void __launch_bounds__(kFhThreads)
    fuse_heaps_kernel(const __grid_constant__ FhArgs f, int reclaim) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kFhWarps];
  PROF_START();
  if (!reclaim) {
    fuse_heaps_body<T, 0>(f, smem, warp_tot);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  int* evicted = fp<int>(f, F_evicted);
  if (r == 0)
    for (int i = threadIdx.x; i < f.d[G_J]; i += kFhThreads) evicted[i] = 0;
  cluster.sync();
  const int NV = f.d[G_NV], per = (NV + C - 1) / C;
  count_evictions(fp<const uint8_t>(f, F_vic_valid), fp<const uint8_t>(f, F_alive),
                  fp<const int>(f, F_vic_job), min(r * per, NV), min(r * per + per, NV),
                  evicted);
  cluster.sync();
  if (r == 0) fuse_heaps_body<T, 1>(f, smem, warp_tot);
}

template <typename T>
int max_dyn() {
  static std::mutex mu;
  static int m = -1;
  std::lock_guard<std::mutex> lock(mu);
  if (m < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, fuse_heaps_kernel<T>) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    const int want = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(fuse_heaps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             want) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    m = want;
  }
  return m;
}

// [work bytes, pushes kept in shared memory, their bytes, spill bytes]
template <typename T>
int plan(int S, int ROWS, long long* out) {
  const int m = max_dyn<T>();
  if (m < 0) return (int)cudaErrorInvalidConfiguration;
  const Layout<T> lay(S, ROWS);
  const long long cap = std::min<long long>(S, (long long)m / (long long)lay.per_push);
  out[0] = (long long)lay.work;
  out[1] = cap;
  out[2] = cap * (long long)lay.per_push;
  out[3] = S > cap ? (long long)S * (long long)lay.per_push : 0;
  return 0;
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, int reclaim, void* stream) {
  FhArgs f;
  for (int k = 0; k < F_COUNT; ++k) f.p[k] = ptrs[k];
  for (int k = 0; k < G_COUNT; ++k) f.d[k] = dims[k];
  if (f.d[G_J] <= 0 || f.d[G_ROWS] <= 0 || f.d[G_JCAP] <= 0 || f.d[G_cap] < 0 ||
      (reclaim ? f.d[G_EB] <= 0 || f.d[G_QH] <= 0 : f.d[G_PB] <= 0))
    return (int)cudaErrorInvalidValue;
  const int S = reclaim ? f.d[G_EB] : f.d[G_PB];
  if (f.p[F_work] == nullptr || (S > f.d[G_cap] && f.p[F_spill] == nullptr))
    return (int)cudaErrorInvalidValue;
  if (max_dyn<T>() < 0) return (int)cudaErrorInvalidConfiguration;
  const int ctas = reclaim ? kCountCtas : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(kFhThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)f.d[G_cap] * Layout<T>(S, f.d[G_ROWS]).per_push;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)ctas;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, fuse_heaps_kernel<T>, f, reclaim);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#define FH_STR(name) #name ","
extern "C" const char* fh_ptr_names() { return FH_PTRS(FH_STR); }
extern "C" const char* fh_dim_names() { return FH_DIMS(FH_STR); }

// the scratch plan of S push slots and `rows` rows (see plan above)
extern "C" int fuse_heaps_plan(int S, int rows, int is_f64, long long* out) {
  return is_f64 ? plan<double>(S, rows, out) : plan<float>(S, rows, out);
}

extern "C" int fuse_heaps_f32(const void* const* ptrs, const int* dims, int reclaim,
                              void* stream) {
  return launch<float>(ptrs, dims, reclaim, stream);
}
extern "C" int fuse_heaps_f64(const void* const* ptrs, const int* dims, int reclaim,
                              void* stream) {
  return launch<double>(ptrs, dims, reclaim, stream);
}

#ifdef K13_PROFILE
// the phases' cycles and the pushes of the last launch, then its two
// globaltimer marks (ns)
extern "C" int k13_profile_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k13_prof_t, sizeof(k13_prof_t));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + kProfPhases + 1, k13_prof_span,
                                   sizeof(k13_prof_span));
}
#endif
