// K5 queue_budget: the job-granular queue fair-share cap of one round,
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _queue_budget (:495-549) — its
// segmented scans after the (queue, rank) sort, in exact int64 in place of
// the two 15-bit int32 limbs.
//
// Input rows are sorted by (queue, task rank); job segments nest inside
// queue segments. req holds the quantized requests of the rows the round
// accepted (zero elsewhere). For a row of queue q:
//   before = (within-queue sum up to the row) - (within-job sum up to it)
//          = what the higher-ranked jobs of the same queue took
//   tot    = alloc[q] + before
//   ok     = for every r: tot < max(bound[q, r], 0)
//            or (r is a scalar dim and tot <= MIN_MILLI_SCALAR)
//   out    = accept and ok
// with bound = floor(deserved / unit) + eps / unit.
//
// Design: one block of 512 threads walks the rows in chunks with two
// block-wide segmented scans (queue and job segments, segscan.cuh) and
// carries both across chunks.
//
// Bound: bytes (T x R int64 + three int32 columns in, T flags out, about
// 2.5 MB at cfg5); the single block is the simple design's price.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

namespace {

constexpr int kMaxR = 8;
constexpr int kThreads = 512;
constexpr long long kMinMilliScalar = 10;

__global__ void queue_budget_kernel(
    int T, int R, const int32_t* __restrict__ queue,
    const int32_t* __restrict__ job, const long long* __restrict__ req,
    const uint8_t* __restrict__ accept, const long long* __restrict__ alloc,
    const long long* __restrict__ bound, const uint8_t* __restrict__ is_scalar,
    uint8_t* __restrict__ out) {
  __shared__ int sf[32];
  __shared__ long long sv[32][kMaxR];
  __shared__ long long carry_q[kMaxR];
  __shared__ long long carry_j[kMaxR];
  for (int base = 0; base < T; base += blockDim.x) {
    int i = base + threadIdx.x;
    bool valid = i < T;
    int q = valid ? queue[i] : 0;
    int qhead = (!valid || i == 0 || queue[i - 1] != q) ? 1 : 0;
    int jhead = (qhead || job[i - 1] != job[i]) ? 1 : 0;
    long long vq[kMaxR], vj[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      vq[r] = (valid && r < R) ? req[(size_t)i * R + r] : 0;
      vj[r] = vq[r];
    }
    int fq = qhead, fj = jhead;
    segscan::block_scan<kMaxR>(fq, vq, sf, sv);
    segscan::block_scan<kMaxR>(fj, vj, sf, sv);
    if (!fq) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) vq[r] += carry_q[r];
    }
    if (!fj) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) vj[r] += carry_j[r];
    }
    if (valid) {
      bool ok = true;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          long long tot = alloc[(size_t)q * R + r] + (vq[r] - vj[r]);
          long long b = bound[(size_t)q * R + r];
          bool le = tot < (b > 0 ? b : 0);
          bool skip = is_scalar[r] && tot <= kMinMilliScalar;
          ok = ok && (le || skip);
        }
      }
      out[i] = (accept[i] && ok) ? 1 : 0;
    }
    int last = min(base + (int)blockDim.x, T) - 1 - base;
    __syncthreads();
    if ((int)threadIdx.x == last) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        carry_q[r] = vq[r];
        carry_j[r] = vj[r];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int queue_budget(int T, int R, const void* queue, const void* job,
                            const void* req, const void* accept,
                            const void* alloc, const void* bound,
                            const void* is_scalar, void* out, void* stream) {
  if (T <= 0 || R <= 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  queue_budget_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      T, R, (const int32_t*)queue, (const int32_t*)job, (const long long*)req,
      (const uint8_t*)accept, (const long long*)alloc,
      (const long long*)bound, (const uint8_t*)is_scalar, (uint8_t*)out);
  return (int)cudaGetLastError();
}
