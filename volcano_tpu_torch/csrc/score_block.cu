// K1 score_block: the masked fused feasibility + score matrix of the rounds
// solver, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _score_block (:108) with
// volcano_tpu/ops/kernels.py fused_scores (:163), as run by the round
// (:708-723): the lax.cond on n_dirty > dirty_k between _refresh_scores
// (:138, every column) and _rescore_dirty (:168, the dirty columns), then
// n_feas = sum(scores > -inf) over each class row.
//
// Two entries share one kernel:
//
// - `score_round` (the round's, one launch a round): it reads the dirty
//   count from the solve's control vector and decides on the card between
//   the full refresh (dirty_k == 0 or n_dirty > dirty_k) and the dirty
//   columns, rescores column c exactly when the round is full or dirty[c]
//   holds, and counts the columns above -inf of every class row over the
//   whole node axis into n_feas (clean columns from the carried scores).
//   This is the reference's result: on the dirty path n_dirty <= dirty_k,
//   so nonzero(dirty, size=dirty_k) lists every dirty column, its padding
//   slots alias column 0 and rewrite the bits column 0 holds, and a clean
//   column's carried score was computed from the state it still has.
// - `score_block` (the full refresh, K16a's probes): every column, no
//   count.
//
// Layout: a thread a node column, a CTA kThreads columns x up to kRows
// class rows, as few rows as give the grid kCtasPerSm CTAs an SM (a cell's
// work is a chain of dependent loads and divisions, so the card needs
// many threads in flight more than it needs the node state loaded once).
// A thread loads its node's idle/used/alloc rows, cnt and nmax into
// registers once (the R loops unrolled to the bucket RM >= R), the CTA
// stages its class rows in shared memory, and each row's score is written
// coalesced along the columns. A warp whose 32 columns are all clean
// loads no node state and scores nothing: it reads the carried scores and
// counts. The counts go warp by warp (ballot, popc) into shared memory,
// then by one atomic a row into `acc` (int32 [K + 1], zero between
// launches); the last CTA to finish (the ticket acc[K]) copies the counts
// to n_feas and zeroes acc again, so no memset precedes a launch.
//
// Bound: bytes. The node state is N x (3R + 2) values, the output K x N;
// at the solve's shapes a few MB, so the launch's latency decides. On an
// H100 a cfg5 full round takes about 2 us more than the same refresh
// without the count: the last CTA's two round trips to L2
// (bench/score_round_designs.py times both entries).
//
// Rounding: the score is scorefn::fused_score (score_common.cuh), shared
// with the eviction machines; see there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"

// the launch's arguments, one block (ops/kernels.py _ScoreArgs); at file
// scope, so the C entries taking it keep external linkage
struct ScoreArgs {
  int K, N, R, dirty_k;
  int check_pod, use_excl, use_nodeorder, use_binpack;
  const void *cls_req, *cls_initreq, *cls_sig, *cls_nz_cpu, *cls_nz_mem,
      *cls_has_pod, *cls_excl;
  const void *idle, *used, *alloc, *cnt, *nmax, *sig_mask, *aff, *occ;
  const void *eps, *is_scalar, *binpack_w, *weights;
  // the round entry's: the dirty mask [N], the dirty count (int32, in the
  // control vector), n_feas [K] out, the count scratch [K + 1]; null in
  // the full entry
  const void *dirty, *n_dirty;
  void *n_feas, *acc;
  void *out;
};

namespace {

constexpr int kMaxR = 16;
constexpr int kThreads = 128;  // node columns a CTA
constexpr int kRows = 16;      // class rows a CTA, at most
constexpr int kCtasPerSm = 8;  // the grid's target
constexpr double kMinMilliScalar = 10.0;  // resource.MIN_MILLI_SCALAR

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads) score_block_kernel(ScoreArgs a, int rpc) {
  __shared__ T s_req[kRows * kMaxR], s_ireq[kRows * kMaxR];
  __shared__ T s_nzc[kRows], s_nzm[kRows];
  __shared__ int s_sig[kRows], s_excl[kRows], s_count[kRows];
  __shared__ bool s_pod[kRows], s_last;

  const int N = a.N, R = a.R;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int k0 = blockIdx.y * rpc;
  const int rows = min(rpc, a.K - k0);
  const bool count = a.n_feas != nullptr;
  // full or dirty, decided here (the reference's lax.cond); the node's
  // column state loaded at once, in registers, before the rows are staged
  const bool full = a.dirty == nullptr || a.dirty_k <= 0 ||
                    *(const int32_t*)a.n_dirty > a.dirty_k;
  const bool live = c < N;
  const bool rescore = live && (full || ((const uint8_t*)a.dirty)[c] != 0);
  T idle_c[RM], used_c[RM], alloc_c[RM], eps[RM];
  bool scalar[RM];
  int cnt_c = 0, nmax_c = 0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    idle_c[r] = used_c[r] = alloc_c[r] = eps[r] = T(0);
    scalar[r] = false;
    if (r < R) {
      eps[r] = ((const T*)a.eps)[r];
      scalar[r] = ((const uint8_t*)a.is_scalar)[r] != 0;
      if (rescore) {
        idle_c[r] = ((const T*)a.idle)[(size_t)c * R + r];
        used_c[r] = ((const T*)a.used)[(size_t)c * R + r];
        alloc_c[r] = ((const T*)a.alloc)[(size_t)c * R + r];
      }
    }
  }
  if (rescore) {
    cnt_c = ((const int32_t*)a.cnt)[c];
    nmax_c = ((const int32_t*)a.nmax)[c];
  }
  const T* cls_req = (const T*)a.cls_req;
  const T* cls_initreq = (const T*)a.cls_initreq;
  for (int i = threadIdx.x; i < rows * R; i += kThreads) {
    s_req[i] = cls_req[(size_t)k0 * R + i];
    s_ireq[i] = cls_initreq[(size_t)k0 * R + i];
  }
  if (threadIdx.x < rows) {
    const int k = k0 + threadIdx.x;
    s_nzc[threadIdx.x] = ((const T*)a.cls_nz_cpu)[k];
    s_nzm[threadIdx.x] = ((const T*)a.cls_nz_mem)[k];
    s_sig[threadIdx.x] = ((const int32_t*)a.cls_sig)[k];
    s_excl[threadIdx.x] = a.use_excl ? ((const int32_t*)a.cls_excl)[k] : -1;
    s_pod[threadIdx.x] = ((const uint8_t*)a.cls_has_pod)[k] != 0;
    s_count[threadIdx.x] = 0;
  }
  __syncthreads();

  T* __restrict__ out = (T*)a.out;
  const unsigned lanes = __ballot_sync(0xffffffffu, rescore);

  if (lanes != 0) {
    const uint8_t* __restrict__ sig_mask = (const uint8_t*)a.sig_mask;
    const T* __restrict__ aff = (const T*)a.aff;
    const uint8_t* __restrict__ occ = (const uint8_t*)a.occ;
    for (int kk = 0; kk < rows; ++kk) {
      const size_t at = (size_t)(k0 + kk) * N + c;
      T v = T(-INFINITY);
      if (rescore) {
        // epsilon fit of the init request against idle (resource_info.go:267)
        bool fit = true;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < R) {
            const T ir = s_ireq[kk * R + r];
            const bool le = ir < idle_c[r] + eps[r];
            const bool skip = scalar[r] && ir <= T(kMinMilliScalar);
            fit = fit && (le || skip);
          }
        }
        const int sig = s_sig[kk];
        bool mask = fit && sig_mask[(size_t)sig * N + c];
        if (a.check_pod) mask = mask && ((cnt_c < nmax_c) || !s_pod[kk]);
        if (a.use_excl) {
          const int g = s_excl[kk];
          const bool held = occ[(size_t)(g > 0 ? g : 0) * N + c];
          mask = mask && !(held && g >= 0);
        }
        if (mask)
          v = scorefn::fused_score<T, RM>(
              R, s_req + kk * R, s_nzc[kk], s_nzm[kk], used_c, alloc_c,
              aff[(size_t)sig * N + c], (const T*)a.binpack_w, (const T*)a.weights,
              a.use_nodeorder != 0, a.use_binpack != 0);
        out[at] = v;
      } else if (live && count) {
        v = out[at];
      }
      if (count) {
        const unsigned feas = __ballot_sync(0xffffffffu, live && v > T(-INFINITY));
        if ((threadIdx.x & 31) == 0 && feas) atomicAdd(&s_count[kk], __popc(feas));
      }
    }
  } else if (count) {
    // a clean warp: count the carried scores
    for (int kk = 0; kk < rows; ++kk) {
      const bool feas_c = live && out[(size_t)(k0 + kk) * N + c] > T(-INFINITY);
      const unsigned feas = __ballot_sync(0xffffffffu, feas_c);
      if ((threadIdx.x & 31) == 0 && feas) atomicAdd(&s_count[kk], __popc(feas));
    }
  }
  if (!count) return;

  // the CTA's counts into acc, then the last CTA publishes n_feas and
  // leaves acc zero for the next launch
  int32_t* acc = (int32_t*)a.acc;
  __syncthreads();
  if (threadIdx.x < rows && s_count[threadIdx.x])
    atomicAdd(&acc[k0 + threadIdx.x], s_count[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    s_last = atomicAdd((unsigned*)&acc[a.K], 1u) == total - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int32_t* n_feas = (int32_t*)a.n_feas;
  for (int k = threadIdx.x; k < a.K; k += kThreads) n_feas[k] = atomicExch(&acc[k], 0);
  if (threadIdx.x == 0) acc[a.K] = 0;
}

template <typename T, int RM>
void launch_rm(const ScoreArgs& a, int rpc, cudaStream_t s) {
  dim3 grid((a.N + kThreads - 1) / kThreads, (a.K + rpc - 1) / rpc);
  score_block_kernel<T, RM><<<grid, kThreads, 0, s>>>(a, rpc);
}

template <typename T>
int launch(const ScoreArgs* a, void* stream) {
  if (a->R > kMaxR || a->R < 2 || a->K <= 0 || a->N <= 0 ||
      (a->n_feas != nullptr) != (a->acc != nullptr) ||
      (a->dirty != nullptr) != (a->n_dirty != nullptr))
    return (int)cudaErrorInvalidValue;
  // rows a CTA: as few (at most kRows) as leave kCtasPerSm CTAs an SM
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int col_blocks = (a->N + kThreads - 1) / kThreads;
  const int slices = min(a->K, max(1, (kCtasPerSm * sms + col_blocks - 1) / col_blocks));
  const int rpc = min(kRows, (a->K + slices - 1) / slices);
  cudaStream_t s = (cudaStream_t)stream;
  if (a->R <= 2)
    launch_rm<T, 2>(*a, rpc, s);
  else if (a->R <= 4)
    launch_rm<T, 4>(*a, rpc, s);
  else if (a->R <= 8)
    launch_rm<T, 8>(*a, rpc, s);
  else
    launch_rm<T, 16>(*a, rpc, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The full refresh (every column, no count) and the round's entry; the
// same argument block, the round's fields null in the first.
extern "C" int score_block_f32(const ScoreArgs* a, void* stream) {
  return launch<float>(a, stream);
}
extern "C" int score_block_f64(const ScoreArgs* a, void* stream) {
  return launch<double>(a, stream);
}
extern "C" int score_round_f32(const ScoreArgs* a, void* stream) {
  return launch<float>(a, stream);
}
extern "C" int score_round_f64(const ScoreArgs* a, void* stream) {
  return launch<double>(a, stream);
}
extern "C" int score_args_size() { return (int)sizeof(ScoreArgs); }
