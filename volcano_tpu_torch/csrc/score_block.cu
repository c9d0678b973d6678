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
// Rounding: the score is scorefn::fused_score (score_common.cuh), shared
// with the eviction machines; see there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"

namespace {

constexpr int kMaxR = 16;
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR

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

  T score = scorefn::fused_score<T>(
      R, req, cls_nz_cpu[k], cls_nz_mem[k], used_c, alloc_c,
      aff[(size_t)sig * N + c], binpack_w, weights, use_nodeorder != 0,
      use_binpack != 0);
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
