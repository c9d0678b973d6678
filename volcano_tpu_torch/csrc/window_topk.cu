// K2 window_topk: per class row, the first k entries of the stable
// descending order of the score row under IEEE 754's total order (+0.0
// ahead of -0.0, ties to the lower node index, -inf an ordinary key),
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:754 `lax.top_k(scores, k)` — whose
// window is an exact prefix of that order, ties included, which the
// coverage bit relies on. torch.topk documents no tie order, so it is never
// called.
//
// Bound: bytes (read K x N scores once, write K x k pairs), well under a
// microsecond at cfg5 (K=16, N=10000, k=1024). The previous design sorted
// each whole row on one SM (16 SMs at cfg5, 105 barrier-separated stages);
// this one spreads a row over a thread-block cluster and sorts only k.
//
// Design: a cluster radix select over the row, the compaction of the
// survivors and a count sort of the k survivors (topk_select.cuh, shared
// with K14 express_place's window). A row gets a cluster of C CTAs (C =
// 1..8, chosen by the launcher so that K x C fills the card); CTA r owns
// the index range [r*ceil(N/C), ...) and reads its keys from the score row
// in every pass. A row with C = 1 (cfg6: K=512, N=1000) runs the same code
// on one CTA.
//
// Capturable in a CUDA graph: no allocation (the wrapper passes the
// scratch list from the torch allocator), no host synchronisation, no
// attribute set at launch (static shared memory under 48 KB); the SM count
// is read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace cg = cooperative_groups;

namespace {

using topk::kMaxCluster;
using topk::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_cluster(int N, int k, const T* __restrict__ scores,
                 T* __restrict__ top_s, int32_t* __restrict__ top_i,
                 uint64_t* __restrict__ list_hi, uint32_t* __restrict__ list_lo) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int chunk = (N + C - 1) / C;
  const int lo = min(r * chunk, N), hi = min(lo + chunk, N);
  const T* x = scores + (size_t)row * N;
  topk::cluster_select<T>(cluster, lo, hi, k, [=](int i) { return okey::ord(x[i]); },
                          top_s + (size_t)row * k, top_i + (size_t)row * k,
                          list_hi + (size_t)row * k, list_lo + (size_t)row * k);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// CTAs a row: doubled while the grid is under one wave and each CTA keeps
// at least 1024 entries
int cluster_size(int K, int N) {
  int c = 1;
  while (c < kMaxCluster && (long)K * c < sm_count() && (N + 2 * c - 1) / (2 * c) >= 1024)
    c <<= 1;
  return c;
}

template <typename T>
int launch(int K, int N, int k, const void* scores, void* top_s, void* top_i,
           void* list_hi, void* list_lo, void* stream) {
  if (K <= 0 || k <= 0 || k > N) return (int)cudaErrorInvalidValue;
  const int c = cluster_size(K, N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, topk_cluster<T>, N, k, (const T*)scores,
                                     (T*)top_s, (int32_t*)top_i, (uint64_t*)list_hi,
                                     (uint32_t*)list_lo);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// the CTAs a row gets at this shape (chip_smoke.py reports it)
extern "C" int window_topk_cluster(int K, int N) { return cluster_size(K, N); }

extern "C" int window_topk_f32(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* list_hi,
                               void* list_lo, void* stream) {
  return launch<float>(K, N, k, scores, top_s, top_i, list_hi, list_lo, stream);
}
extern "C" int window_topk_f64(int K, int N, int k, const void* scores,
                               void* top_s, void* top_i, void* list_hi,
                               void* list_lo, void* stream) {
  return launch<double>(K, N, k, scores, top_s, top_i, list_hi, list_lo, stream);
}
