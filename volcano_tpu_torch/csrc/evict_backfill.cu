// K11 evict_backfill: backfill's placement decisions, hand-written for
// Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/evict.py solve_backfill (:1020): each
// zero-request task in walk order takes the first feasible node in name
// order; the only dynamic feasibility term is the pod-count headroom the
// earlier placements consumed. Output: assign [T] int32 (node or -1).
//
// One block: for each task in order, the block finds the lowest feasible
// node index (a min-reduction over the signature row and the live pod
// counts), then thread 0 records it and bumps that node's count. The
// counts live in scratch the wrapper allocates (copied in at the start).
//
// Bound: bytes (each input read once, assign written once), a few
// microseconds at cfg4; the per-task barrier chain is what a single block
// pays instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    backfill_kernel(int N, int T, int check_pod, const uint8_t* __restrict__ sig_mask,
                    const int* __restrict__ node_cnt, const int* __restrict__ node_max,
                    const int* __restrict__ b_sig, const uint8_t* __restrict__ b_has_pod,
                    const uint8_t* __restrict__ b_real, int* cnt, int* assign) {
  __shared__ int warp_min[kWarps];
  __shared__ int best;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < N; i += kThreads) cnt[i] = node_cnt[i];
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const uint8_t* row = sig_mask + (size_t)b_sig[t] * N;
    const bool pod = b_has_pod[t];
    int first = N;
    for (int i = tid; i < N; i += kThreads) {
      bool ok = row[i] && (!check_pod || cnt[i] < node_max[i] || !pod);
      if (ok) { first = i; break; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) first = min(first, __shfl_down_sync(kFull, first, off));
    if (lane == 0) warp_min[warp] = first;
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? warp_min[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(kFull, v, off));
      if (lane == 0) best = v;
    }
    __syncthreads();
    if (tid == 0) {
      // argmax of an all-false mask is node 0, which then fails ok
      bool ok = best < N && b_real[t];
      assign[t] = ok ? best : -1;
      if (ok) cnt[best] += 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int evict_backfill(int N, int T, int check_pod, const void* sig_mask,
                              const void* node_cnt, const void* node_max,
                              const void* b_sig, const void* b_has_pod,
                              const void* b_real, void* cnt, void* assign,
                              void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  backfill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      N, T, check_pod, (const uint8_t*)sig_mask, (const int*)node_cnt,
      (const int*)node_max, (const int*)b_sig, (const uint8_t*)b_has_pod,
      (const uint8_t*)b_real, (int*)cnt, (int*)assign);
  return (int)cudaGetLastError();
}
