// K14 express_place: one express batch — initial scores, the per-task
// candidate window, the sequential walk with fresh in-window rescoring and
// the coverage proof, the full-width fallback and the all-or-nothing gang
// strip — hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/express/place.py:94 `solve_express` (one jitted
// XLA program: fused_scores over [tb, N], lax.top_k, a fori_loop over the
// tasks with lax.cond's full-width fallback, the strip, one packed int32
// result). Plain version: volcano_tpu_torch/express/place.py
// solve_express_plain.
//
// Two launches on one stream:
//   1. window_kernel, one block per valid task row (only when window_k > 0):
//      the row's masked initial scores (fused_score, -inf off the ok
//      column) into shared memory — or into a global scratch row when the
//      padded row does not fit — a bitonic sort under the strict order of
//      window_topk.cu (order_key.cuh: score desc under IEEE 754's total
//      order, +0.0 ahead of -0.0, then index asc), and the first W entries
//      out: an exact prefix of that order, as lax.top_k gives it.
//   2. walk_kernel, one block: copies idle/cnt into scratch (the lane's
//      standing tensors are the next batch's input and are never written),
//      then walks the tasks in order. A step rescores the task's window
//      columns (one thread a column) against the walked state, takes the
//      block-wide best in window order, and is covered when that fresh
//      best is strictly above the window's last initial score; otherwise
//      (or with window_k 0) it sweeps all N nodes and takes the lowest
//      node index among the maxima (all -inf: node 0, feasible iff node
//      0 fits, as jnp.argmax and fit[node] read). Thread 0 applies the
//      placement: idle[node] += -req, cnt[node] += 1, job_placed += 1.
//      After the walk thread 0 strips every job placed short of its need
//      and writes the packed [tb + 2] result.
//
// Rounding: scores are scorefn::fused_score (score_common.cuh) with
// nodeorder only, a zero affinity row and weight 0 — the same function for
// the initial and every fresh score, so the coverage proof's monotonicity
// holds bit for bit; built with --fmad=false, fma() where XLA contracts.
//
// Bound: operations of the initial scores (tb x N x ~45) and bytes of the
// node columns, both under a microsecond at cfg5; the walk is one block of
// tb dependent steps, so launch and step latency bound it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_key.cuh"
#include "score_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTb = 1024;
constexpr double kMinMilliCpu = 10.0;                 // resource.MIN_MILLI_CPU
constexpr double kMinMemory = 10.0 * 1024 * 1024;     // resource.MIN_MEMORY

// the walk's argmax order (value desc, index asc): +0.0 and -0.0 tie, as
// the reference's argmax compares them
template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// the task's fresh score on node c, against the node state (idle, alloc)
template <typename T>
__device__ __forceinline__ T score_on(int c, const T* req, T nzc, T nzm,
                                      const T* idle, const T* alloc,
                                      const T* w4) {
  T used_c[2] = {alloc[2 * c] - idle[2 * c], alloc[2 * c + 1] - idle[2 * c + 1]};
  return scorefn::fused_score<T>(2, req, nzc, nzm, used_c, alloc + 2 * c, T(0),
                                 w4, w4, true, false);
}

// fit of the task's init request on node c: epsilon-less-than per dim, the
// static ok column, and the pod cap
template <typename T>
__device__ __forceinline__ bool fit_on(int c, const T* ireq, const T* idle,
                                       const int32_t* cnt, const uint8_t* ok,
                                       const int32_t* maxt, bool has_pod,
                                       int check_pod) {
  bool f = (ireq[0] < idle[2 * c] + T(kMinMilliCpu)) &&
           (ireq[1] < idle[2 * c + 1] + T(kMinMemory)) && ok[c];
  if (check_pod) f = f && ((cnt[c] < maxt[c]) || !has_pod);
  return f;
}

// block-wide best (key desc, index asc); every thread gets the winner
template <typename T>
__device__ __forceinline__ void block_best(T& k, int& i, T* wk, int* wi) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    T ok = __shfl_down_sync(0xffffffffu, k, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ok, oi, k, i)) { k = ok; i = oi; }
  }
  if (lane == 0) { wk[warp] = k; wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    int nw = blockDim.x >> 5;
    k = lane < nw ? wk[lane] : T(-INFINITY);
    i = lane < nw ? wi[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      T ok = __shfl_down_sync(0xffffffffu, k, off);
      int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (before(ok, oi, k, i)) { k = ok; i = oi; }
    }
    if (lane == 0) { wk[0] = k; wi[0] = i; }
  }
  __syncthreads();
  k = wk[0];
  i = wi[0];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_kernel(int N, int P, int W, const T* __restrict__ idle,
              const T* __restrict__ alloc,
              const uint8_t* __restrict__ ok,
              const T* __restrict__ req,
              const T* __restrict__ nzc,
              const T* __restrict__ nzm,
              const uint8_t* __restrict__ valid,
              const T* __restrict__ weights,
              unsigned char* __restrict__ gkeys,
              T* __restrict__ top_s,
              int32_t* __restrict__ top_i) {
  extern __shared__ unsigned char smem[];
  const int t = blockIdx.x;
  if (!valid[t]) return;  // a pad row's window is never read
  unsigned char* base = gkeys != nullptr
      ? gkeys + (size_t)t * P * (sizeof(T) + sizeof(int)) : smem;
  T* key = reinterpret_cast<T*>(base);
  int* idx = reinterpret_cast<int*>(key + P);
  const T w4[4] = {weights[0], weights[1], T(0), T(0)};
  const T* rq = req + 2 * t;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    T k = T(-INFINITY);
    if (i < N && ok[i]) k = score_on<T>(i, rq, nzc[t], nzm[t], idle, alloc, w4);
    key[i] = k;
    idx[i] = i;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        int j = i ^ stride;
        if (j > i) {
          bool up = (i & size) == 0;
          T ki = key[i], kj = key[j];
          int ii = idx[i], ij = idx[j];
          bool swap = up ? okey::sort_before(kj, ij, ki, ii)
                         : okey::sort_before(ki, ii, kj, ij);
          if (swap) {
            key[i] = kj; key[j] = ki;
            idx[i] = ij; idx[j] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    top_s[(size_t)t * W + j] = key[j];
    top_i[(size_t)t * W + j] = idx[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
walk_kernel(int N, int tb, int jb, int W, int check_pod,
            const T* __restrict__ idle,
            const T* __restrict__ alloc,
            const int32_t* __restrict__ cnt,
            const uint8_t* __restrict__ ok,
            const int32_t* __restrict__ maxt,
            const T* __restrict__ initreq,
            const T* __restrict__ req,
            const T* __restrict__ nzc,
            const T* __restrict__ nzm,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ task_job,
            const uint8_t* __restrict__ has_pod,
            const int32_t* __restrict__ job_need,
            const T* __restrict__ weights,
            const T* __restrict__ top_s,
            const int32_t* __restrict__ top_i,
            T* __restrict__ idle_s, int32_t* __restrict__ cnt_s,
            int32_t* __restrict__ job_placed,
            int32_t* __restrict__ out) {
  __shared__ T wk[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ int assign[kMaxTb];
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    idle_s[2 * c] = idle[2 * c];
    idle_s[2 * c + 1] = idle[2 * c + 1];
    cnt_s[c] = cnt[c];
  }
  for (int j = threadIdx.x; j < jb; j += blockDim.x) job_placed[j] = 0;
  for (int t = threadIdx.x; t < tb; t += blockDim.x) assign[t] = -1;
  __syncthreads();
  const T w4[4] = {weights[0], weights[1], T(0), T(0)};
  int fulls = 0, placed_n = 0;  // thread 0's
  for (int t = 0; t < tb; ++t) {
    if (!valid[t]) continue;  // block-uniform
    const T* rq = req + 2 * t;
    const T* irq = initreq + 2 * t;
    const bool hp = has_pod[t] != 0;
    int node = 0;
    bool feas = false;
    bool covered = false;
    if (W > 0) {
      T k = T(-INFINITY);
      int i = INT32_MAX;
      bool any = false;
      for (int j = threadIdx.x; j < W; j += blockDim.x) {
        int c = top_i[(size_t)t * W + j];
        bool f = fit_on<T>(c, irq, idle_s, cnt_s, ok, maxt, hp, check_pod);
        T s = f ? score_on<T>(c, rq, nzc[t], nzm[t], idle_s, alloc, w4)
                : T(-INFINITY);
        any = any || f;
        if (before(s, j, k, i)) { k = s; i = j; }
      }
      any = __syncthreads_or(any);
      block_best<T>(k, i, wk, wi);
      // strict: an equal fresh best may lose to a lower out-of-window index
      covered = any && (k > top_s[(size_t)t * W + W - 1]);
      if (covered) {
        node = top_i[(size_t)t * W + i];
        feas = true;
      }
    }
    if (!covered) {
      T k = T(-INFINITY);
      int i = INT32_MAX;
      for (int c = threadIdx.x; c < N; c += blockDim.x) {
        bool f = fit_on<T>(c, irq, idle_s, cnt_s, ok, maxt, hp, check_pod);
        T s = f ? score_on<T>(c, rq, nzc[t], nzm[t], idle_s, alloc, w4)
                : T(-INFINITY);
        if (before(s, c, k, i)) { k = s; i = c; }
      }
      block_best<T>(k, i, wk, wi);
      node = i < N ? i : 0;
      feas = fit_on<T>(node, irq, idle_s, cnt_s, ok, maxt, hp, check_pod);
      fulls += 1;
    }
    if (threadIdx.x == 0 && feas) {
      idle_s[2 * node] = idle_s[2 * node] + (-rq[0]);
      idle_s[2 * node + 1] = idle_s[2 * node + 1] + (-rq[1]);
      cnt_s[node] += 1;
      assign[t] = node;
      job_placed[task_job[t]] += 1;
      placed_n += 1;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // all-or-nothing per job: job_placed is read as the walk left it
    for (int t = 0; t < tb; ++t) {
      int a = assign[t];
      int j = task_job[t];
      if (a >= 0 && job_placed[j] < job_need[j]) {
        a = -1;
        placed_n -= 1;
      }
      out[t] = a;
    }
    out[tb] = fulls;
    out[tb + 1] = placed_n;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
size_t smem_bytes(int N) {
  return (size_t)pow2_at_least(N) * (sizeof(T) + sizeof(int));
}

bool fits_smem(size_t bytes) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes <= (size_t)max_optin;
}

template <typename T>
int launch(int N, int tb, int jb, int W, int check_pod, const void* idle,
           const void* alloc, const void* cnt, const void* ok, const void* maxt,
           const void* initreq, const void* req, const void* nzc,
           const void* nzm, const void* valid, const void* task_job,
           const void* has_pod, const void* job_need, const void* weights,
           void* gkeys, void* top_s, void* top_i, void* idle_s, void* cnt_s,
           void* job_placed, void* out, void* stream) {
  if (N <= 0 || tb <= 0 || tb > kMaxTb || jb <= 0 || W < 0 || W > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W > 0) {
    int P = pow2_at_least(N);
    size_t bytes = smem_bytes<T>(N);
    size_t dyn = 0;
    if (fits_smem(bytes)) {
      cudaError_t e = cudaFuncSetAttribute(
          window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
      dyn = bytes;
      gkeys = nullptr;
    } else if (gkeys == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    window_kernel<T><<<tb, kThreads, dyn, s>>>(
        N, P, W, (const T*)idle, (const T*)alloc, (const uint8_t*)ok,
        (const T*)req, (const T*)nzc, (const T*)nzm, (const uint8_t*)valid,
        (const T*)weights, (unsigned char*)gkeys, (T*)top_s, (int32_t*)top_i);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  walk_kernel<T><<<1, kThreads, 0, s>>>(
      N, tb, jb, W, check_pod, (const T*)idle, (const T*)alloc,
      (const int32_t*)cnt, (const uint8_t*)ok, (const int32_t*)maxt,
      (const T*)initreq, (const T*)req, (const T*)nzc, (const T*)nzm,
      (const uint8_t*)valid, (const int32_t*)task_job, (const uint8_t*)has_pod,
      (const int32_t*)job_need, (const T*)weights, (const T*)top_s,
      (const int32_t*)top_i, (T*)idle_s, (int32_t*)cnt_s,
      (int32_t*)job_placed, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of global scratch the window launch needs (0 when a padded row of
// (key, index) pairs fits one block's shared memory, or with no window)
extern "C" long long express_place_scratch_bytes(int N, int tb, int W,
                                                 int is_f64) {
  if (W <= 0) return 0;
  size_t bytes = is_f64 ? smem_bytes<double>(N) : smem_bytes<float>(N);
  return fits_smem(bytes) ? 0 : (long long)bytes * tb;
}

#define EXPRESS_ARGS                                                         \
  int N, int tb, int jb, int W, int check_pod, const void *idle,             \
      const void *alloc, const void *cnt, const void *ok, const void *maxt,  \
      const void *initreq, const void *req, const void *nzc,                 \
      const void *nzm, const void *valid, const void *task_job,              \
      const void *has_pod, const void *job_need, const void *weights,        \
      void *gkeys, void *top_s, void *top_i, void *idle_s, void *cnt_s,      \
      void *job_placed, void *out, void *stream
#define EXPRESS_CALL                                                         \
  N, tb, jb, W, check_pod, idle, alloc, cnt, ok, maxt, initreq, req, nzc,    \
      nzm, valid, task_job, has_pod, job_need, weights, gkeys, top_s, top_i, \
      idle_s, cnt_s, job_placed, out, stream

extern "C" int express_place_f32(EXPRESS_ARGS) { return launch<float>(EXPRESS_CALL); }
extern "C" int express_place_f64(EXPRESS_ARGS) { return launch<double>(EXPRESS_CALL); }
