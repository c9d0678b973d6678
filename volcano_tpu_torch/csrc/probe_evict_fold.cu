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
// Design: the reps are independent (each starts from queue_alloc[q] x
// its factor), so a thread owns one (row, rep) walk: W x reps threads,
// 520,000 at W = 32,500 and 16 reps, about two waves of 256-thread
// blocks. A block takes a run of whole rows (16 at 16 reps) and stages
// them through shared memory first: the rows' vic_req with 16-byte loads
// where the addresses allow, each slot's queue allocation and deserved
// floor (gathered once a block from the [Q, R] tables), and each victim's
// samequeue row folded into a bitmask. The rep-threads of a row read
// them there (a broadcast); qcur lives in registers (V and R are template
// parameters, the loops unrolled; a step updates only the slots after
// it, the only ones read again). The count is summed by warp shuffles,
// then by one shared and one global integer add a block (the order of
// integer adds does not change the sum); the entry zeroes the int32
// result first on the same stream (a memset, its own node in a graph).
//
// Bound: at cfg7 x 0.65 (W = 32,500 at one shard, V = 8, R = 2, float32)
// the inputs are about 5.2 MB read once, 0.00155 ms at 3.35 TB/s; the
// reps x W x V x 6R operations, 0.05 G, take under a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 32 * 1024;  // a block's staged rows at most (under
                                        // the 48 KB a launch takes unasked)

__device__ __forceinline__ float vt_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double vt_abs(double x) { return fabs(x); }

// `bytes` from `src` to shared `dst` by the block: 16-byte words where
// both addresses and the size allow, else 4-byte words, else bytes
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  const uintptr_t a = (uintptr_t)src | (uintptr_t)dst;
  if ((a & 15) == 0 && (bytes & 15) == 0) {
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      ((uint4*)dst)[i] = __ldg((const uint4*)src + i);
  } else if ((a & 3) == 0 && (bytes & 3) == 0) {
    for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x)
      ((uint32_t*)dst)[i] = __ldg((const uint32_t*)src + i);
  } else {
    for (int i = threadIdx.x; i < bytes; i += blockDim.x)
      ((uint8_t*)dst)[i] = __ldg((const uint8_t*)src + i);
  }
}

// the bitmask of one victim's samequeue row (V bools): 4-byte words
// where V and the address allow, else bytes
template <int V>
__device__ __forceinline__ uint32_t same_bits(const bool* row) {
  uint32_t bits = 0;
  if constexpr (V % 4 == 0) {
    if ((((uintptr_t)row) & 3) == 0) {
#pragma unroll
      for (int w = 0; w < V / 4; ++w) {
        const uint32_t x = __ldg((const uint32_t*)row + w);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((x >> (8 * b)) & 0xffu) bits |= 1u << (4 * w + b);
      }
      return bits;
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u)
    if (__ldg((const uint8_t*)row + u)) bits |= 1u << u;
  return bits;
}

// four blocks an SM where a thread's walk state is small
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads, V * R * sizeof(T) <= 64 ? 4 : 1)
    fold_kernel(int W, int reps, int rep_threads, int rows_a_block,
                const T* __restrict__ vic_req, const int32_t* __restrict__ vic_queue,
                const bool* __restrict__ samequeue, const T* __restrict__ queue_alloc,
                const T* __restrict__ queue_deserved, const T* __restrict__ eps,
                const T* __restrict__ factors, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * rows_a_block;
  const int rows = W - r0 < rows_a_block ? W - r0 : rows_a_block;
  const size_t plane = (size_t)rows_a_block * V * R;
  T* s_req = (T*)smem;                             // [rows, V, R] requests
  T* s_alloc = s_req + plane;                      // [rows, V, R] the slot's queue allocation
  T* s_des = s_alloc + plane;                      // [rows, V, R] and its deserved floor
  uint32_t* s_same = (uint32_t*)(s_des + plane);   // [rows, V] samequeue bits
  stage(s_req, vic_req + (size_t)r0 * V * R, rows * V * R * (int)sizeof(T));
  for (int i = threadIdx.x; i < rows * V * R; i += blockDim.x) {
    const int q = __ldg(&vic_queue[(size_t)r0 * V + i / R]);
    s_alloc[i] = __ldg(&queue_alloc[q * R + i % R]);
    s_des[i] = __ldg(&queue_deserved[q * R + i % R]);
  }
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x)
    s_same[i] = same_bits<V>(samequeue + ((size_t)r0 * V + i) * V);
  T e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = __ldg(&eps[r]);
  __syncthreads();

  const int row = threadIdx.x / rep_threads;
  int count = 0;
  if (row < rows) {
    const T* req = s_req + (size_t)row * V * R;
    const T* alloc = s_alloc + (size_t)row * V * R;
    const T* des = s_des + (size_t)row * V * R;
    const uint32_t* same = s_same + row * V;
    for (int rep = threadIdx.x - row * rep_threads; rep < reps; rep += rep_threads) {
      const T f = factors[rep];
      T qcur[V][R];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int r = 0; r < R; ++r) qcur[v][r] = alloc[v * R + r] * f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bool all_lt = true;
        bool fits = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T cur = qcur[v][r];
          const T d = cur - req[v * R + r];
          const T fl = des[v * R + r];
          all_lt = all_lt && (cur < req[v * R + r]);
          fits = fits && ((fl < d) || (vt_abs(fl - d) < e[r]));
        }
        const bool go = !all_lt;
        count += (go && fits) ? 1 : 0;
        if (go) {  // only the slots after v are read again
          const uint32_t m = same[v];
#pragma unroll
          for (int u = v + 1; u < V; ++u) {
            if ((m >> u) & 1u) {
#pragma unroll
              for (int r = 0; r < R; ++r) qcur[u][r] = qcur[u][r] - req[v * R + r];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&block_sum, count);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum) atomicAdd(out, block_sum);
}

template <typename T, int V, int R>
int launch(int W, int reps, const void* vic_req, const void* vic_queue,
           const void* samequeue, const void* queue_alloc,
           const void* queue_deserved, const void* eps, const void* factors,
           void* out, cudaStream_t stream) {
  // a row's rep-threads, whole rows a block (at most kThreads threads and
  // kStageBytes staged), the block rounded up to whole warps
  const int rep_threads = reps < kThreads ? reps : kThreads;
  const int row_bytes = 3 * V * R * (int)sizeof(T) + V * 4;
  int rows = kThreads / rep_threads;
  if (rows * row_bytes > kStageBytes) rows = kStageBytes / row_bytes;
  if (rows < 1) rows = 1;
  const int threads = (rows * rep_threads + 31) / 32 * 32;
  const int blocks = (W + rows - 1) / rows;
  fold_kernel<T, V, R><<<blocks, threads, (size_t)rows * row_bytes, stream>>>(
      W, reps, rep_threads, rows, (const T*)vic_req, (const int32_t*)vic_queue,
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
