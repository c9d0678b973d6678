// The cluster machinery shared by the eviction machines K9 preempt
// (evict_preempt.cu) and K10 reclaim (evict_reclaim.cu), hand-written for
// Hopper (sm_90a).
//
// Both run a whole action on one cluster of kCluster CTAs (a non-portable
// cluster size, which every Hopper card runs) of kCta threads. Each CTA
// owns a slice of the nodes and keeps its `used` and `cnt` in its own
// shared memory; each kernel defines its own node layout (K9 contiguous
// slices, K10 32-node groups dealt round-robin: see their files). A shape
// whose slices do not fit there keeps them in a global buffer of kCluster
// slices instead, with the same code (Slices). CTA 0's thread 0 runs the
// control machine (evict_common.cuh's Machine: the heaps, the cut, the
// pipeline, the op log) and writes a chosen node's `used`/`cnt` into the
// owning CTA's slice through distributed shared memory (pipeline, over
// the kernel's map of a node to its row). Cluster barriers
// replace block barriers; victim rows, job and queue state stay in global
// memory (the folds read the mutable state with ld.cg).
//
// Here:
// - the register fold of a node's victim row (fold_node), with V a
//   template parameter for the encoder's buckets 16..256 (wider rows fold
//   with Machine::fold_node over global scratch rows);
// - the fast job heap (every key of both jobs loaded before a compare) and
//   the eviction cut (preempt's permutation or reclaim's claimee order);
// - the cluster's launch: one plan a kernel and slice size (the kernel's
//   attributes, a cluster-occupancy query), and cudaLaunchKernelEx with
//   the cluster dimension.
//
// Rounding: built with --fmad=false; every float expression keeps the
// order of the plain PyTorch version (ops/evict_kernels.py).

#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "evict_common.cuh"

namespace evc {

namespace cg = cooperative_groups;
using namespace ev;

constexpr int kCta = 256;
constexpr int kCtaWarps = kCta / 32;
constexpr int kCluster = 16;  // CTAs a cluster (non-portable; Hopper runs it)
constexpr int kMaxV = 256;    // V folded in registers: the buckets 16..256
constexpr int kMaxMW = kMaxV / 64;
constexpr int kChunk = 8;     // slots a fold chunk or a cut step reads ahead

// where the CTAs' node slices live: each CTA's shared memory (stride 0),
// or a global buffer of kCluster slices `stride` bytes apart; rem(p, o) is
// CTA o's counterpart of this CTA's slice pointer p
struct Slices {
  cg::cluster_group cl;
  long long stride;
  int r;
  template <typename P>
  __device__ P* rem(P* p, int o) const {
    if (stride == 0) return cl.map_shared_rank(p, o);
    return reinterpret_cast<P*>(reinterpret_cast<char*>(p) + (long long)(o - r) * stride);
  }
};

template <int W>
__device__ __forceinline__ uint64_t word(const uint64_t (&m)[W], int v) {
  uint64_t x = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (v >> 6)) x = m[w];
  return x;
}

template <int W>
__device__ __forceinline__ void put(uint64_t (&m)[W], int v, bool b) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (v >> 6)) m[w] = (m[w] & ~(1ull << (v & 63))) | ((uint64_t)b << (v & 63));
}

// slot v's current value of a share walk: start minus the requests of the
// flagged slots before v that `same` joins to v, in slot order
template <typename T, int W>
__device__ __forceinline__ void walk_cur(const uint64_t (&flag)[W], int v, int V,
                                         const uint8_t* same, const T* req, T& c0,
                                         T& c1) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w * 64 >= v) break;
    uint64_t m = flag[w];
    int top = v - w * 64;
    if (top < 64) m &= (1ull << top) - 1;
    while (m) {
      int v2 = w * 64 + __ffsll((long long)m) - 1;
      m &= m - 1;
      if (same[(size_t)v2 * V + v]) {
        c0 = c0 - req[2 * v2];
        c1 = c1 - req[2 * v2 + 1];
      }
    }
  }
}

// the deciding tier's victim fns, read once a walk iteration (they
// intersect, so their order does not matter)
struct Fns {
  bool gang, conf, drf, prop;
};

template <typename T>
__device__ Fns fns_of(const Machine<T>& m) {
  Fns f{false, false, false, false};
  for (int k = 0; k < m.d(D_n_fns); ++k) {
    const int fn = m.d(D_fn0 + k);
    f.gang |= fn == VF_GANG;
    f.conf |= fn == VF_CONFORMANCE;
    f.drf |= fn == VF_DRF;
    f.prop |= fn == VF_PROPORTION;
  }
  return f;
}

// node i's victim row (the deciding-tier intersection, each fn over the
// full claimee row, walked in slot order) into vm_out; returns validate and
// sets vcnt/under (evict_common.cuh Machine::fold_node, with its state in
// registers). The fns read nothing of one another, so one pass over the
// slots runs them all, each in slot order; a chunk of slots (all 16 at
// V = 16, else kChunk) loads its rows and job state together before the
// pass walks it. (Tried: loading the share walks' starts with the chunk
// too left K10 unchanged and made K9 5-10% slower on an H100.)
template <typename T, int V>
__device__ bool fold_node(const Machine<T>& m, const Fns& fns, int i, int filt, int j,
                          int qj, int t, T ls, int& vcnt, bool& under, uint64_t* vm_out) {
  constexpr int W = (V + 63) / 64;
  constexpr int VQ = V / 8;
  constexpr int CH = V == 16 ? 16 : kChunk;
  constexpr bool kRows = VQ <= 4;  // gang's same-job rows preloaded (V <= 32)
  const size_t base = (size_t)i * V;
  const uint8_t* alive = m.template sc<uint8_t>(P_alive) + base;
  const uint8_t* valid = m.template in<uint8_t>(P_vic_valid) + base;
  const uint8_t* conf = m.template in<uint8_t>(P_vic_conf) + base;
  const int* vjob = m.template in<int>(P_vic_job) + base;
  const int* vq = m.template in<int>(P_vic_queue) + base;
  const T* req = m.template in<T>(P_vic_req) + base * 2;
  const T* eps = m.template in<T>(P_eps);
  const int* ready = m.template sc<int>(P_ready);
  const int* mav = m.template in<int>(P_job_min_av);
  const T* ja = m.template sc<T>(P_job_alloc);
  const T* qa = m.template sc<T>(P_queue_alloc);
  const T* des = m.template in<T>(P_queue_deserved);
  const T* tot = m.template in<T>(P_drf_total);
  const uint8_t* samej = fns.gang || fns.drf ? m.template in<uint8_t>(P_vic_samejob) + base * V
                                             : nullptr;
  const uint8_t* sameq = fns.prop ? m.template in<uint8_t>(P_vic_samequeue) + base * V : nullptr;
  const uint64_t* rows = reinterpret_cast<const uint64_t*>(samej);
  uint64_t claim[W], vmm[W], doit[W], used[VQ];
#pragma unroll
  for (int w = 0; w < W; ++w) claim[w] = vmm[w] = doit[w] = 0;
#pragma unroll
  for (int q = 0; q < VQ; ++q) used[q] = 0;
  under = false;
  vcnt = 0;
  T s0 = T(0), s1 = T(0);
  for (int c0 = 0; c0 < V; c0 += CH) {
    int jv[CH], qv[CH], ma[CH], rd[CH];
    bool cl[CH], cf[CH];
    T r0[CH], r1[CH];
    uint64_t sw[CH][kRows ? VQ : 1];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int v = c0 + u;
      jv[u] = vjob[v];
      qv[u] = vq[v];
      r0[u] = req[2 * v];
      r1[u] = req[2 * v + 1];
      cl[u] = __ldcg(alive + v) && valid[v] &&
              (filt == 0 ? (qv[u] == qj && jv[u] != j) : filt == 1 ? jv[u] == j : qv[u] != qj);
      cf[u] = !fns.conf || conf[v];
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      if (fns.gang) {
        ma[u] = mav[jv[u]];
        rd[u] = __ldcg(ready + jv[u]);
        if (kRows)
#pragma unroll
          for (int q = 0; q < (kRows ? VQ : 1); ++q) sw[u][q] = rows[(size_t)(c0 + u) * VQ + q];
      }
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int v = c0 + u;
      put(claim, v, cl[u]);
      bool keep = cl[u] && cf[u];
      if (fns.gang) {
        // used[w] of the reference, one byte a slot: a nominated slot adds
        // its same-job row (V bytes of 0/1) as words; slot v reads only the
        // adds of the slots before it, at most v <= 255, so no byte carries
        // into the next before it is read
        int b = rd[u] - ma[u];
        b = b > 0 ? b : 0;
        uint64_t uw = 0;
#pragma unroll
        for (int q = 0; q < VQ; ++q)
          if (q == (v >> 3)) uw = used[q];
        const int used_v = (int)((uw >> ((v & 7) * 8)) & 0xff);
        const bool nom = cl[u] && (ma[u] == 1 || used_v < b);
        keep = keep && nom;
        if (nom) {
#pragma unroll
          for (int q = 0; q < VQ; ++q)
            used[q] += kRows ? sw[u][kRows ? q : 0] : rows[(size_t)v * VQ + q];
        }
      }
      if (fns.drf) {
        T c_0 = __ldcg(ja + 2 * jv[u]), c_1 = __ldcg(ja + 2 * jv[u] + 1);
        walk_cur<T, W>(claim, v, V, samej, req, c_0, c_1);
        if (cl[u] && !le2(r0[u], r1[u], c_0, c_1, eps[0], eps[1])) under = true;
        const T rs = share2(c_0 - r0[u], c_1 - r1[u], tot[0], tot[1]);
        const bool verdict = (ls < rs) || (fabs(ls - rs) <= T(kShareDelta));
        keep = keep && verdict;
      }
      if (fns.prop) {
        T c_0 = __ldcg(qa + 2 * qv[u]), c_1 = __ldcg(qa + 2 * qv[u] + 1);
        walk_cur<T, W>(doit, v, V, sameq, req, c_0, c_1);
        const bool d = cl[u] && !lt2(c_0, c_1, r0[u], r1[u]);
        if (d && !le2(r0[u], r1[u], c_0, c_1, eps[0], eps[1])) under = true;
        keep = keep && d && le2(des[2 * qv[u]], des[2 * qv[u] + 1], c_0 - r0[u], c_1 - r1[u], eps[0], eps[1]);
        put(doit, v, d);
      }
      // victim count and slot-order request sum
      put(vmm, v, keep);
      if (keep) {
        vcnt += 1;
        s0 = s0 + r0[u];
        s1 = s1 + r1[u];
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) vm_out[w] = vmm[w];
  const T* init = m.template in<T>(P_p_init) + 2 * t;
  return vcnt > 0 && !lt2(s0, s1, init[0], init[1]);
}

// -- the control machine (CTA 0, thread 0) ------------------------------------

// -- the control machine's node-state mutators (CTA 0, thread 0) ----------------
// Machine's pipeline, with used/cnt in the owning CTA's slice

// (ND: the kernel's map of a node to its row in the owning CTA's slice)
template <typename T, typename ND>
__device__ void pipeline(Machine<T>& m, const ND& nd, int t, int node) {
  T r0 = m.template in<T>(P_p_req)[2 * t], r1 = m.template in<T>(P_p_req)[2 * t + 1];
  int j = m.template in<int>(P_p_job)[t];
  int q = m.template in<int>(P_job_queue)[j];
  T* u = nd.used(node);
  T* ja = m.template sc<T>(P_job_alloc);
  T* qa = m.template sc<T>(P_queue_alloc);
  u[0] = u[0] + r0;
  u[1] = u[1] + r1;
  *nd.cnt(node) += 1;
  m.template sc<int>(P_wait)[j] += 1;
  ja[2 * j] = ja[2 * j] + r0; ja[2 * j + 1] = ja[2 * j + 1] + r1;
  qa[2 * q] = qa[2 * q] + r0; qa[2 * q + 1] = qa[2 * q + 1] + r1;
  m.template sc<uint8_t>(P_p_done)[t] = 1;
  m.log_append(OP_PIPELINE, t, node, true);
}

// job_order_cmp as less(x, y) (Machine::job_less), with every key of both
// jobs loaded before the first compare: one memory round trip a compare
template <typename T>
__device__ bool job_less(const Machine<T>& m, int x, int y) {
  const int* prio = m.template in<int>(P_job_prio);
  const int* ready = m.template sc<int>(P_ready);
  const int* mav = m.template in<int>(P_job_min_av);
  const int* tie = m.template in<int>(P_job_tie);
  const T* ja = m.template sc<T>(P_job_alloc);
  const T* tot = m.template in<T>(P_drf_total);
  const int px = prio[x], py = prio[y], rx = ready[x], ry = ready[y];
  const int mx = mav[x], my = mav[y], tx = tie[x], ty = tie[y];
  const T ax0 = ja[2 * x], ax1 = ja[2 * x + 1], ay0 = ja[2 * y], ay1 = ja[2 * y + 1];
  const T t0 = tot[0], t1 = tot[1];
  for (int k = 0; k < m.d(D_n_keys); ++k) {
    const int key = m.d(D_key0 + k);
    if (key == KEY_PRIORITY) {
      if (px != py) return px > py;
    } else if (key == KEY_GANG) {
      const bool gx = rx >= mx, gy = ry >= my;
      if (gx != gy) return !gx && gy;
    } else if (key == KEY_DRF) {
      const T sx = share2(ax0, ax1, t0, t1), sy = share2(ay0, ay1, t0, t1);
      if (sx != sy) return sx < sy;
    }
  }
  return tx < ty;
}

// heapq's exact heappop / heappush sift order over a job heap row
// (Machine::heap_pop / heap_push with the job keys)
template <typename T>
__device__ int heap_pop(const Machine<T>& m, int* row, int* size) {
  const int root = row[0];
  const int last = row[*size - 1];
  const int nsize = *size - 1;
  if (nsize > 0) {
    int pos = 0;
    // each level reads both candidates' children with the compare's keys
    int lc = 1 < nsize ? row[1] : 0, rc = 2 < nsize ? row[2] : 0;
    while (2 * pos + 1 < nsize) {
      const int left = 2 * pos + 1, right = left + 1;
      const int a1 = 2 * left + 1, b1 = 2 * right + 1;
      const int la = a1 < nsize ? row[a1] : 0, lb = a1 + 1 < nsize ? row[a1 + 1] : 0;
      const int ra = b1 < nsize ? row[b1] : 0, rb = b1 + 1 < nsize ? row[b1 + 1] : 0;
      int child = left, cv = lc;
      if (right < nsize && !job_less(m, lc, rc)) {
        child = right;
        cv = rc;
        lc = ra;
        rc = rb;
      } else {
        lc = la;
        rc = lb;
      }
      row[pos] = cv;
      pos = child;
    }
    row[pos] = last;
    while (pos > 0 && job_less(m, last, row[(pos - 1) / 2])) {
      const int parent = (pos - 1) / 2;
      row[pos] = row[parent];
      pos = parent;
    }
    row[pos] = last;
  }
  *size = nsize;
  return root;
}

template <typename T>
__device__ void heap_push(const Machine<T>& m, int* row, int* size, int item) {
  int pos = *size;
  row[pos] = item;
  while (pos > 0 && job_less(m, item, row[(pos - 1) / 2])) {
    const int parent = (pos - 1) / 2;
    row[pos] = row[parent];
    pos = parent;
  }
  row[pos] = item;
  *size = *size + 1;
}

// Machine::evict_slot, the victim's row and its job's and queue's state
// loaded before the first store; returns the victim's request
template <typename T>
__device__ void evict_slot(Machine<T>& m, int node, int slot, bool active, T& r0, T& r1) {
  if (active) {
    const size_t k = (size_t)node * m.d(D_V) + slot;
    const int jv = m.template in<int>(P_vic_job)[k], qv = m.template in<int>(P_vic_queue)[k];
    r0 = m.template in<T>(P_vic_req)[2 * k];
    r1 = m.template in<T>(P_vic_req)[2 * k + 1];
    int* ready = m.template sc<int>(P_ready);
    T* ja = m.template sc<T>(P_job_alloc);
    T* qa = m.template sc<T>(P_queue_alloc);
    const int rd = ready[jv];
    const T a0 = ja[2 * jv], a1 = ja[2 * jv + 1], b0 = qa[2 * qv], b1 = qa[2 * qv + 1];
    m.template sc<uint8_t>(P_alive)[k] = 0;
    ready[jv] = rd - 1;
    ja[2 * jv] = a0 - r0;
    ja[2 * jv + 1] = a1 - r1;
    qa[2 * qv] = b0 - r0;
    qa[2 * qv + 1] = b1 - r1;
  }
  m.log_append(OP_EVICT, node, slot, active);
}

// the eviction cut at `node`: victims in reversed task order (kPerm:
// preempt's vic_cut_perm) or claimee order (reclaim), those of the mask
// `vm` evicted one by one until the init request is covered (Machine::cut
// with the mask from the fold; the permutation read a chunk at a time
// ahead of the stores). V is a multiple of kChunk.
template <bool kPerm, typename T>
__device__ bool cut(Machine<T>& m, int t, int node, const uint64_t* vm) {
  const int V = m.d(D_V);
  const int* perm = kPerm ? m.template in<int>(P_vic_cut_perm) + (size_t)node * V : nullptr;
  const T* eps = m.template in<T>(P_eps);
  const T n0 = m.template in<T>(P_p_init)[2 * t], n1 = m.template in<T>(P_p_init)[2 * t + 1];
  T g0 = T(0), g1 = T(0);
  bool covered = false;
  for (int p0 = 0; p0 < V; p0 += kChunk) {
    int pv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) pv[u] = kPerm ? perm[p0 + u] : p0 + u;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int slot = pv[u] > 0 ? pv[u] : 0;
      const bool selp = pv[u] >= 0 && ((vm[slot >> 6] >> (slot & 63)) & 1) && !covered;
      T r0, r1;
      evict_slot(m, node, slot, selp, r0, r1);
      if (selp) {
        g0 = g0 + r0;
        g1 = g1 + r1;
        covered = le2(n0, n1, g0, g1, eps[0], eps[1]);
      }
    }
  }
  return covered;
}

// CTA 0 thread 0's order, written into every CTA before a cluster barrier
template <typename C>
__device__ void push(const cg::cluster_group& cl, C* cmd, const C& v) {
  for (int r = 0; r < (int)cl.num_blocks(); ++r) *cl.map_shared_rank(cmd, r) = v;
}


// -- the launch -------------------------------------------------------------------

// a launch's layout: each CTA's dynamic shared memory, or, where the
// slices do not fit there, the bytes of their global buffer; `ok` where
// the card runs the cluster
struct Plan {
  int ok;
  size_t smem, spill;
};

inline cudaLaunchConfig_t cluster_config(size_t smem, cudaLaunchAttribute* at, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kCta, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// planned once a kernel and slice size (`bytes`, one CTA's slice): the
// kernel's attributes are set at the first plan, a cluster-occupancy query
// is made at each new size
template <typename A, void (*K)(A)>
Plan plan(size_t bytes) {
  static std::mutex mu;
  static int max_dyn = -1;
  static size_t last_bytes = 0;
  static Plan last;
  std::lock_guard<std::mutex> lock(mu);
  if (max_dyn >= 0 && bytes == last_bytes) return last;
  if (max_dyn < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, K) != cudaSuccess) {
      cudaGetLastError();
      return Plan{0, 0, 0};
    }
    max_dyn = optin - (int)fa.sharedSizeBytes;
    cudaFuncSetAttribute(K, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
  }
  Plan p{0, 0, 0};
  if (bytes <= (size_t)max_dyn) p.smem = bytes;
  else p.spill = bytes * kCluster;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = cluster_config(p.smem, at, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, K, &cfg) != cudaSuccess) cudaGetLastError();
  p.ok = clusters >= 1;
  last_bytes = bytes;
  last = p;
  return p;
}

// one launch of K on the plan for `bytes`: `spill` is the args' slot of
// the slices' global buffer (nulled where they fit shared memory)
template <typename A, void (*K)(A)>
int launch_cluster(A& a, size_t bytes, int spill, void* stream) {
  const Plan p = plan<A, K>(bytes);
  if (!p.ok) return (int)cudaErrorInvalidConfiguration;
  if (p.spill == 0) a.p[spill] = nullptr;
  else if (a.p[spill] == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = cluster_config(p.smem, at, stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, K, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// V's kernel: the encoder's buckets 16..256 fold in registers, any other
// width from global scratch (V = 0)
template <typename F>
auto by_v(int V, F f) {
  switch (V) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
  }
  return f(std::integral_constant<int, 0>());
}

}  // namespace evc
