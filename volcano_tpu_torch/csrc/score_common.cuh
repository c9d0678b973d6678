// The fused binpack + nodeorder score of one (request, node) pair, shared
// by K1 score_block and the eviction machines K9/K10 (whose candidate
// windows order nodes by the same score), so that every kernel rounds it
// exactly as volcano_tpu_torch/ops/kernels.py fused_scores does.
//
// Rounding: every expression is evaluated in the order kernels.py writes
// it, R-sums left to right; sources are built with --fmad=false. The two
// places where XLA's CPU backend contracts a multiply-add in the JAX
// reference (balanced's 10 - |d| * 10, and the adds of the weighted
// affinity and binpack terms, the latter reassociated as bp * (10 * w))
// use fma() by name, as the plain PyTorch version does with its exact FMA.

#pragma once

#include <math.h>

namespace scorefn {

constexpr double kMaxPriority = 10.0;   // nodeorder.MAX_PRIORITY

template <typename T>
__device__ __forceinline__ T dim_score(T cap, T want) {
  bool ok = (cap > T(0)) && (want <= cap);
  T safe = cap > T(0) ? cap : T(1);
  return ok ? ((cap - want) * T(kMaxPriority)) / safe : T(0);
}

// req: [R] request; used_c/alloc_c: the node's [R] rows; aff: the node's
// affinity score for the request's signature; weights: [least-requested,
// balanced, node-affinity, binpack] plugin weights.
template <typename T>
__device__ __forceinline__ T fused_score(int R, const T* req, T nz_cpu,
                                         T nz_mem, const T* used_c,
                                         const T* alloc_c, T aff,
                                         const T* binpack_w,
                                         const T* weights, bool use_nodeorder,
                                         bool use_binpack) {
  T score = T(0);
  if (use_nodeorder) {
    T cap_cpu = alloc_c[0], cap_mem = alloc_c[1];
    T want_cpu = used_c[0] + nz_cpu;
    T want_mem = used_c[1] + nz_mem;
    T least = floor((dim_score(cap_cpu, want_cpu) + dim_score(cap_mem, want_mem)) / T(2));
    T cpu_frac = want_cpu / (cap_cpu > T(0) ? cap_cpu : T(1));
    T mem_frac = want_mem / (cap_mem > T(0) ? cap_mem : T(1));
    bool bal_ok = (cap_cpu > T(0)) && (cap_mem > T(0)) && (cpu_frac < T(1)) && (mem_frac < T(1));
    T balanced = bal_ok
        ? floor(fma(-fabs(cpu_frac - mem_frac), T(kMaxPriority), T(kMaxPriority)))
        : T(0);
    score = score + least * weights[0] + balanced * weights[1];
    score = fma(aff, weights[2], score);
  }
  if (use_binpack) {
    T w_sum = T(0);
    T raw = T(0);
    for (int r = 0; r < R; ++r) {
      T w_eff = req[r] > T(0) ? binpack_w[r] : T(0);
      w_sum = w_sum + w_eff;
      T want = req[r] + used_c[r];
      T a = alloc_c[r];
      bool ok = (a > T(0)) && (want <= a);
      T part = ok ? (want * w_eff) / (a > T(0) ? a : T(1)) : T(0);
      raw = raw + part;
    }
    T bp = w_sum > T(0) ? raw / (w_sum > T(0) ? w_sum : T(1)) : T(0);
    score = fma(bp, T(kMaxPriority) * weights[3], score);
  }
  return score;
}

}  // namespace scorefn
