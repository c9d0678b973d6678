// K16b probe_evict_fold: the mesh bench's per-shard eviction-fold probe,
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/shard.py:215 `_probe_evict_fold` (driven by
// :252 `probe_per_device_stage_ms`), a jitted fori_loop of _PROBE_REPS
// proportion deserved-floor victim walks (the ops/evict._prop_verdict
// twin) over one shard's [W, V] victim slice. Plain version:
// volcano_tpu_torch/ops/shard.py `probe_evict_fold_plain`.
//
// Per rep and per node row, the V victims are walked in order against the
// row's queue-current state qcur[V][R] (each slot's queue allocation times
// the rep's factor): with cur = qcur[v] and d = cur - req[v] (computed
// once, used in both terms),
//   do   = !all_r(cur < req)
//   fits = all_r(des < d || |des - d| < eps)
//   count += do && fits
//   where do: qcur[u] -= req[v] for every u with samequeue[v][u]
// (the reference's `where(upd, qcur - req, qcur)`: a subtraction only where
// the slot updates). Built with --fmad=false: nothing is contracted, so
// every rounding is the plain version's.
//
// A walk is a sequential state machine per row, so one thread owns one
// row: qcur and the row's requests live in registers (V and R are template
// parameters, the loops unrolled), the deserved floors and allocations
// (a [Q, R] table) come through the read-only cache. Each thread's count
// is reduced through its warp (shuffles), then its block (shared memory),
// and one atomicAdd a block lands it in the int32 result, which the entry
// zeroes first on the same stream.
//
// Bound: at cfg7 (W = 50,000 at one shard, V = 8, R = 2, float32) the
// inputs are about 8 MB read once and the reps x W x V x (6R + V R)
// operations about 0.18 G: both bounds a few microseconds. The walk is
// V dependent steps a rep, 16 reps, over 50,000 rows: one wave of 196
// blocks of 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float vt_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double vt_abs(double x) { return fabs(x); }

template <typename T, int V, int R>
__global__ void fold_kernel(int W, int reps, const T* __restrict__ vic_req,
                            const int32_t* __restrict__ vic_queue,
                            const bool* __restrict__ samequeue,
                            const T* __restrict__ queue_alloc,
                            const T* __restrict__ queue_deserved,
                            const T* __restrict__ eps,
                            const T* __restrict__ factors,
                            int32_t* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  if (w < W) {
    T req[V][R];
    int q[V];
    uint32_t same[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      q[v] = vic_queue[(long long)w * V + v];
#pragma unroll
      for (int r = 0; r < R; ++r) req[v][r] = vic_req[((long long)w * V + v) * R + r];
      uint32_t bits = 0;
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (samequeue[((long long)w * V + v) * V + u]) bits |= 1u << u;
      same[v] = bits;
    }
    for (int rep = 0; rep < reps; ++rep) {
      const T f = factors[rep];
      T qcur[V][R];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int r = 0; r < R; ++r) qcur[v][r] = __ldg(&queue_alloc[q[v] * R + r]) * f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bool all_lt = true;
        bool fits = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T cur = qcur[v][r];
          const T d = cur - req[v][r];
          const T des = __ldg(&queue_deserved[q[v] * R + r]);
          all_lt = all_lt && (cur < req[v][r]);
          fits = fits && ((des < d) || (vt_abs(des - d) < __ldg(&eps[r])));
        }
        const bool go = !all_lt;
        count += (go && fits) ? 1 : 0;
        if (go) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            if ((same[v] >> u) & 1u) {
#pragma unroll
              for (int r = 0; r < R; ++r) qcur[u][r] = qcur[u][r] - req[v][r];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sum[i];
    if (total) atomicAdd(out, total);
  }
}

template <typename T, int V, int R>
int launch(int W, int reps, const void* vic_req, const void* vic_queue,
           const void* samequeue, const void* queue_alloc,
           const void* queue_deserved, const void* eps, const void* factors,
           void* out, cudaStream_t stream) {
  const int blocks = (W + kThreads - 1) / kThreads;
  fold_kernel<T, V, R><<<blocks, kThreads, 0, stream>>>(
      W, reps, (const T*)vic_req, (const int32_t*)vic_queue,
      (const bool*)samequeue, (const T*)queue_alloc, (const T*)queue_deserved,
      (const T*)eps, (const T*)factors, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int by_r(int R, int W, int reps, const void* a, const void* b, const void* c,
         const void* d, const void* e, const void* f, const void* g, void* out,
         cudaStream_t s) {
  switch (R) {
    case 1: return launch<T, V, 1>(W, reps, a, b, c, d, e, f, g, out, s);
    case 2: return launch<T, V, 2>(W, reps, a, b, c, d, e, f, g, out, s);
    case 3: return launch<T, V, 3>(W, reps, a, b, c, d, e, f, g, out, s);
    case 4: return launch<T, V, 4>(W, reps, a, b, c, d, e, f, g, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(int W, int V, int R, int reps, const void* vic_req,
        const void* vic_queue, const void* samequeue, const void* queue_alloc,
        const void* queue_deserved, const void* eps, const void* factors,
        void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (W <= 0 || reps <= 0) return 0;
  switch (V) {
    case 2: return by_r<T, 2>(R, W, reps, vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps, factors, out, s);
    case 4: return by_r<T, 4>(R, W, reps, vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps, factors, out, s);
    case 8: return by_r<T, 8>(R, W, reps, vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps, factors, out, s);
    case 16: return by_r<T, 16>(R, W, reps, vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps, factors, out, s);
    case 32: return by_r<T, 32>(R, W, reps, vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps, factors, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vic_req [W, V, R], vic_queue int32 [W, V], samequeue bool [W, V, V],
// queue_alloc / queue_deserved [Q, R], eps [R], factors [reps]: device
// pointers of the float type; out: one device int32. Launches on `stream`.
extern "C" int probe_evict_fold_f32(int W, int V, int R, int reps,
                                    const void* vic_req, const void* vic_queue,
                                    const void* samequeue, const void* queue_alloc,
                                    const void* queue_deserved, const void* eps,
                                    const void* factors, void* out, void* stream) {
  return run<float>(W, V, R, reps, vic_req, vic_queue, samequeue, queue_alloc,
                    queue_deserved, eps, factors, out, stream);
}

extern "C" int probe_evict_fold_f64(int W, int V, int R, int reps,
                                    const void* vic_req, const void* vic_queue,
                                    const void* samequeue, const void* queue_alloc,
                                    const void* queue_deserved, const void* eps,
                                    const void* factors, void* out, void* stream) {
  return run<double>(W, V, R, reps, vic_req, vic_queue, samequeue, queue_alloc,
                     queue_deserved, eps, factors, out, stream);
}
