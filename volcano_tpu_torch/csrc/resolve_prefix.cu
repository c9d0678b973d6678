// K4 resolve_prefix: per-node longest rank prefix that fits, hand-written for
// Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _resolve (:442) with _seg_limbs (:399)
// and _limbs_lt (:433) — the segmented scans after the (node, rank) sort.
//
// Input rows are sorted by (node key, task rank); key INT32_MAX is the
// infeasible pseudo-node segment at the end. For a row i of node n whose
// segment starts at s:
//   fits  = for every r: sum(req[s..i, r]) < max(bound[n, r], 0)
//           or (r is a scalar dim and req[i, r] <= MIN_MILLI_SCALAR)
//   pods  = !pod[i] or cnt[n] + count(pod[s..i]) <= nmax[n]   (check_pod)
//   accept[i] = fits and pods for every row s..i (no rejection before it)
// with bound = floor(idle / unit) + eps / unit. The sums are exact int64.
//
// Design: one block of 512 threads walks the rows in chunks with a
// block-wide segmented scan (segscan.cuh) of the request sums and the pod
// count, then a second one of the rejection count, carrying both across
// chunks. The block stops at the first chunk that opens on the infeasible
// segment; the caller zeroes the output, so those rows stay rejected.
//
// Bound: bytes (T x (R + 1) int64 + keys in, T flags out, under 3 MB at
// cfg5); a single block leaves most of the card idle, which is the simple
// design's price and the first thing a later PR would change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

namespace {

constexpr int kMaxR = 8;
constexpr int kW = kMaxR + 1;  // request sums + pod count
constexpr int kThreads = 512;
constexpr long long kMinMilliScalar = 10;

__global__ void resolve_prefix_kernel(
    int T, int R, const int32_t* __restrict__ key,
    const long long* __restrict__ req, const uint8_t* __restrict__ pod,
    const long long* __restrict__ bound, const uint8_t* __restrict__ is_scalar,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ nmax,
    int check_pod, uint8_t* __restrict__ accept) {
  __shared__ int sf[32];
  __shared__ long long sv[32][kW];
  __shared__ long long sv1[32][1];
  __shared__ long long carry[kW];
  __shared__ long long carry_rej;
  for (int base = 0; base < T; base += blockDim.x) {
    if (key[base] == INT32_MAX) break;  // the rest is the infeasible segment
    int i = base + threadIdx.x;
    bool valid = i < T;
    int kk = valid ? key[i] : INT32_MAX;
    int head = (!valid || i == 0 || key[i - 1] != kk) ? 1 : 0;
    long long v[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) v[w] = 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (valid && r < R) v[r] = req[(size_t)i * R + r];
    v[kMaxR] = (valid && pod[i]) ? 1 : 0;
    int f = head;
    segscan::block_scan<kW>(f, v, sf, sv);
    if (!f) {
#pragma unroll
      for (int w = 0; w < kW; ++w) v[w] += carry[w];
    }
    bool cond = false;
    if (valid && kk != INT32_MAX) {
      bool fits = true;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          long long b = bound[(size_t)kk * R + r];
          bool le = v[r] < (b > 0 ? b : 0);
          bool skip = is_scalar[r] && req[(size_t)i * R + r] <= kMinMilliScalar;
          fits = fits && (le || skip);
        }
      }
      cond = fits;
      if (check_pod)
        cond = cond && (!pod[i] || (long long)cnt[kk] + v[kMaxR] <= (long long)nmax[kk]);
    }
    int last = min(base + (int)blockDim.x, T) - 1 - base;
    __syncthreads();
    if ((int)threadIdx.x == last) {
#pragma unroll
      for (int w = 0; w < kW; ++w) carry[w] = v[w];
    }
    long long rej[1] = {(valid && !cond) ? 1 : 0};
    int f2 = head;
    segscan::block_scan<1>(f2, rej, sf, sv1);
    if (!f2) rej[0] += carry_rej;
    if (valid) accept[i] = (cond && rej[0] == 0) ? 1 : 0;
    __syncthreads();
    if ((int)threadIdx.x == last) carry_rej = rej[0];
    __syncthreads();
  }
}

}  // namespace

extern "C" int resolve_prefix(int T, int R, const void* key, const void* req,
                              const void* pod, const void* bound,
                              const void* is_scalar, const void* cnt,
                              const void* nmax, int check_pod, void* accept,
                              void* stream) {
  if (T <= 0 || R <= 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  resolve_prefix_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      T, R, (const int32_t*)key, (const long long*)req, (const uint8_t*)pod,
      (const long long*)bound, (const uint8_t*)is_scalar,
      (const int32_t*)cnt, (const int32_t*)nmax, check_pod,
      (uint8_t*)accept);
  return (int)cudaGetLastError();
}
