// K2 window_topk: per class row, the first k entries of the stable
// descending order of the score row (ties to the lower node index, -inf an
// ordinary key), hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:754 `lax.top_k(scores, k)` — whose
// window is an exact prefix of the stable argsort, ties included, which the
// coverage bit relies on. torch.topk documents no tie order, so it is never
// called.
//
// Design: one block per row. When the row, padded to a power of two P, fits
// in shared memory as (key, index) pairs, the block bitonic-sorts it there
// under the strict total order (key descending, index ascending; padding is
// -inf with indices past N, so it sorts after every real entry) and writes
// the first k. Otherwise the block takes k passes of a block-wide arg-max
// over the entries that come after the last one taken.
//
// Bound: bytes (read K x N scores once, write K x k pairs); at cfg5 well
// under a MB, so launch latency and the per-row sort depth bound it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

template <typename T>
__global__ void topk_bitonic(int N, int P, int k, const T* __restrict__ scores,
                             T* __restrict__ top_s, int32_t* __restrict__ top_i) {
  extern __shared__ unsigned char smem[];
  T* key = reinterpret_cast<T*>(smem);
  int* idx = reinterpret_cast<int*>(key + P);
  const T* row = scores + (size_t)blockIdx.x * N;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    key[i] = i < N ? row[i] : T(-INFINITY);
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
          bool swap = up ? before(kj, ij, ki, ii) : before(ki, ii, kj, ij);
          if (swap) {
            key[i] = kj; key[j] = ki;
            idx[i] = ij; idx[j] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    top_s[(size_t)blockIdx.x * k + t] = key[t];
    top_i[(size_t)blockIdx.x * k + t] = idx[t];
  }
}

template <typename T>
__global__ void topk_passes(int N, int k, const T* __restrict__ scores,
                            T* __restrict__ top_s, int32_t* __restrict__ top_i) {
  __shared__ T wkey[kThreads / 32];
  __shared__ int widx[kThreads / 32];
  __shared__ T last_k;
  __shared__ int last_i;
  const T* row = scores + (size_t)blockIdx.x * N;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < k; ++t) {
    // best entry strictly after (last_k, last_i) in the order
    T bk = T(-INFINITY);
    int bi = INT32_MAX;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      T v = row[i];
      bool after = t == 0 || before(last_k, last_i, v, i);
      if (after && before(v, i, bk, bi)) { bk = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      T ok = __shfl_down_sync(0xffffffffu, bk, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (before(ok, oi, bk, bi)) { bk = ok; bi = oi; }
    }
    if (lane == 0) { wkey[warp] = bk; widx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bk = lane < (int)(blockDim.x / 32) ? wkey[lane] : T(-INFINITY);
      bi = lane < (int)(blockDim.x / 32) ? widx[lane] : INT32_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        T ok = __shfl_down_sync(0xffffffffu, bk, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (before(ok, oi, bk, bi)) { bk = ok; bi = oi; }
      }
      if (lane == 0) {
        top_s[(size_t)blockIdx.x * k + t] = bk;
        top_i[(size_t)blockIdx.x * k + t] = bi;
        last_k = bk;
        last_i = bi;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int K, int N, int k, const void* scores, void* top_s, void* top_i,
           void* stream) {
  if (K <= 0 || k <= 0 || k > N) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < N) P <<= 1;
  size_t bytes = (size_t)P * (sizeof(T) + sizeof(int));
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes <= (size_t)max_optin) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_bitonic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    topk_bitonic<T><<<K, kThreads, bytes, s>>>(N, P, k, (const T*)scores,
                                               (T*)top_s, (int32_t*)top_i);
  } else {
    topk_passes<T><<<K, kThreads, 0, s>>>(N, k, (const T*)scores, (T*)top_s,
                                          (int32_t*)top_i);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_topk_f32(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* stream) {
  return launch<float>(K, N, k, scores, top_s, top_i, stream);
}
extern "C" int window_topk_f64(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* stream) {
  return launch<double>(K, N, k, scores, top_s, top_i, stream);
}
