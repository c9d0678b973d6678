// K1 score_block: the masked fused feasibility + score matrix of the rounds
// solver, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _score_block (:108) with
// volcano_tpu/ops/kernels.py fused_scores (:163), as run by _refresh_scores
// (:138, every column) and _rescore_dirty (:168, a gathered column set).
//
// One thread per (class row, node column) cell; the resource axis R is a
// loop in registers. With `cols` the thread reads node column cols[j] of the
// full node arrays and writes scores[k, cols[j]] (the dirty-column patch):
// padding slots of cols repeat column 0 and rewrite identical bits.
//
// Bound: bytes. At cfg5 the node state is N x (3R + 4) values and the output
// K x N, a few MB, so the kernel is bound by launch latency on this card.
//
// Rounding: every expression is evaluated in the order kernels.py:185-216
// writes it, R-sums left to right, built with --fmad=false. The two places
// where XLA's CPU backend contracts a multiply-add (balanced's
// 10 - |d| * 10, and the adds of the weighted affinity and binpack terms,
// the latter reassociated as bp * (10 * w)) use fma() by name, as the
// plain PyTorch version does with its exact FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 16;
constexpr double kMaxPriority = 10.0;   // nodeorder.MAX_PRIORITY
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR

template <typename T>
__device__ __forceinline__ T dim_score(T cap, T want) {
  bool ok = (cap > T(0)) && (want <= cap);
  T safe = cap > T(0) ? cap : T(1);
  return ok ? ((cap - want) * T(kMaxPriority)) / safe : T(0);
}

template <typename T>
__global__ void score_block_kernel(
    int K, int M, int N, int R,
    const T* __restrict__ cls_req, const T* __restrict__ cls_initreq,
    const int32_t* __restrict__ cls_sig, const T* __restrict__ cls_nz_cpu,
    const T* __restrict__ cls_nz_mem, const uint8_t* __restrict__ cls_has_pod,
    const int32_t* __restrict__ cls_excl,
    const T* __restrict__ idle, const T* __restrict__ used,
    const T* __restrict__ alloc, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ nmax, const uint8_t* __restrict__ sig_mask,
    const T* __restrict__ aff, const uint8_t* __restrict__ occ,
    const T* __restrict__ eps, const uint8_t* __restrict__ is_scalar,
    const T* __restrict__ binpack_w, const T* __restrict__ weights,
    const int32_t* __restrict__ cols,
    int check_pod, int use_excl, int use_nodeorder, int use_binpack,
    T* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int k = blockIdx.y;
  if (j >= M || k >= K) return;
  int c = cols != nullptr ? cols[j] : j;
  const T* req = cls_req + (size_t)k * R;
  const T* ireq = cls_initreq + (size_t)k * R;
  const T* idle_c = idle + (size_t)c * R;
  const T* used_c = used + (size_t)c * R;
  const T* alloc_c = alloc + (size_t)c * R;
  int sig = cls_sig[k];

  // epsilon fit of the init request against idle (resource_info.go:267)
  bool fit = true;
  for (int r = 0; r < R; ++r) {
    T ir = ireq[r];
    bool le = ir < idle_c[r] + eps[r];
    bool skip = is_scalar[r] && ir <= T(kMinMilliScalar);
    fit = fit && (le || skip);
  }
  bool mask = fit && sig_mask[(size_t)sig * N + c];
  if (check_pod) mask = mask && ((cnt[c] < nmax[c]) || !cls_has_pod[k]);
  if (use_excl) {
    int g = cls_excl[k];
    bool held = occ[(size_t)(g > 0 ? g : 0) * N + c];
    mask = mask && !(held && g >= 0);
  }

  T score = T(0);
  if (use_nodeorder) {
    T cap_cpu = alloc_c[0], cap_mem = alloc_c[1];
    T want_cpu = used_c[0] + cls_nz_cpu[k];
    T want_mem = used_c[1] + cls_nz_mem[k];
    T least = floor((dim_score(cap_cpu, want_cpu) + dim_score(cap_mem, want_mem)) / T(2));
    T cpu_frac = want_cpu / (cap_cpu > T(0) ? cap_cpu : T(1));
    T mem_frac = want_mem / (cap_mem > T(0) ? cap_mem : T(1));
    bool bal_ok = (cap_cpu > T(0)) && (cap_mem > T(0)) && (cpu_frac < T(1)) && (mem_frac < T(1));
    T balanced = bal_ok
        ? floor(fma(-fabs(cpu_frac - mem_frac), T(kMaxPriority), T(kMaxPriority)))
        : T(0);
    score = score + least * weights[0] + balanced * weights[1];
    score = fma(aff[(size_t)sig * N + c], weights[2], score);
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
  out[(size_t)k * N + c] = mask ? score : T(-INFINITY);
}

template <typename T>
int launch(int K, int M, int N, int R, const void* cls_req,
           const void* cls_initreq, const void* cls_sig, const void* cls_nz_cpu,
           const void* cls_nz_mem, const void* cls_has_pod, const void* cls_excl,
           const void* idle, const void* used, const void* alloc,
           const void* cnt, const void* nmax, const void* sig_mask,
           const void* aff, const void* occ, const void* eps,
           const void* is_scalar, const void* binpack_w, const void* weights,
           const void* cols, int check_pod, int use_excl, int use_nodeorder,
           int use_binpack, void* out, void* stream) {
  if (R > kMaxR || R < 2 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  dim3 block(256);
  dim3 grid((M + 255) / 256, K);
  score_block_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      K, M, N, R, (const T*)cls_req, (const T*)cls_initreq,
      (const int32_t*)cls_sig, (const T*)cls_nz_cpu, (const T*)cls_nz_mem,
      (const uint8_t*)cls_has_pod, (const int32_t*)cls_excl, (const T*)idle,
      (const T*)used, (const T*)alloc, (const int32_t*)cnt,
      (const int32_t*)nmax, (const uint8_t*)sig_mask, (const T*)aff,
      (const uint8_t*)occ, (const T*)eps, (const uint8_t*)is_scalar,
      (const T*)binpack_w, (const T*)weights, (const int32_t*)cols,
      check_pod, use_excl, use_nodeorder, use_binpack, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define SCORE_ARGS                                                          \
  int K, int M, int N, int R, const void *cls_req, const void *cls_initreq, \
      const void *cls_sig, const void *cls_nz_cpu, const void *cls_nz_mem,  \
      const void *cls_has_pod, const void *cls_excl, const void *idle,      \
      const void *used, const void *alloc, const void *cnt,                 \
      const void *nmax, const void *sig_mask, const void *aff,              \
      const void *occ, const void *eps, const void *is_scalar,              \
      const void *binpack_w, const void *weights, const void *cols,         \
      int check_pod, int use_excl, int use_nodeorder, int use_binpack,      \
      void *out, void *stream
#define SCORE_CALL                                                          \
  K, M, N, R, cls_req, cls_initreq, cls_sig, cls_nz_cpu, cls_nz_mem,        \
      cls_has_pod, cls_excl, idle, used, alloc, cnt, nmax, sig_mask, aff,   \
      occ, eps, is_scalar, binpack_w, weights, cols, check_pod, use_excl,   \
      use_nodeorder, use_binpack, out, stream

extern "C" int score_block_f32(SCORE_ARGS) { return launch<float>(SCORE_CALL); }
extern "C" int score_block_f64(SCORE_ARGS) { return launch<double>(SCORE_CALL); }
