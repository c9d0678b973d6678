// K3 round_select: the task-axis select of one round of the rounds solve,
// hand-written for Hopper (sm_90a), with K6's in-class and exclusion-group
// ranks and the window's coverage test folded in.
//
// Replaces: volcano_tpu/ops/rounds.py:336 `_select`, with `_rank_in_class`
// (:319) and `_excl_grank` (:293) that feed it, and the coverage test of
// `round_body` (:766-786: all_in, safe_end, exact, the scatter-max of the
// uncovered classes). Plain version: volcano_tpu_torch/ops/rounds_kernels.py
// `round_select_plain` (the head's class order, `rank_in_class`,
// `excl_grank`, `select_plain`, `coverage_plain`), equal bit for bit: all
// of it is integer arithmetic.
//
// Design. A task's class never changes within a solve, so the solve's head
// sorts the tasks by class once (a stable torch sort: `perm`, the class
// offsets `off`, and each class's first chunk `chunk_first`). A CTA takes
// one chunk of up to kChunk tasks of one class, in that order. Its tasks'
// ranks are a block scan of `active` along the chunk, counted apart for
// active and inactive tasks, on top of the class's tasks before the chunk
// (a block count over them). The class's cumulative-capacity row goes into
// shared memory when it fits in 48 KB (the window's W <= 1024, the cover's
// N <= 12,288), else the search reads it through L1/L2. Each task then runs
// the plain version's `bit_length(W)`-step binary search (clamp of mid to
// W-1 included), the rotation inside its equal-score group, the exclusion
// spread by its class's group rank, and writes choice, cons_choice, slot
// and final at its flat index. An exclusion class's group rank counts the
// live classes ahead of it in its group (the head's stable order of
// cls_excl): a warp a class, a ballot over that class's tasks, stopping at
// the first active one. The class's uncovered bit is a block OR, stored by
// every CTA of the class that finds one (the launcher zeroes the row
// first).
//
// Bound: bytes. Each task reads its active flag and perm entry and a few
// entries of its class's walk rows and writes four int32; the search's
// reads stay in shared memory or L1. The cost is one launch a call, in the
// graph, against the ~100 torch-op nodes it replaces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct SelArgs {
  const int32_t* perm;        // [T] tasks in class order (stable)
  const int32_t* off;         // [K+1] class offsets into perm
  const int32_t* chunk_first; // [K+1] each class's first chunk
  const int32_t* excl_perm;   // [K] classes in stable cls_excl order
  const int32_t* excl_start;  // [K] first position of the class's group there
  const int32_t* excl_pos;    // [K] the class's position there
  const int32_t* cls_excl;    // [K]
  const uint8_t* active;      // [T]
  const int32_t* n_feas;      // [K]
  const int32_t* order;       // [K, W]
  const int32_t* ccap;        // [K, W]
  const int32_t* g_start;     // [K, W]
  const int32_t* g_size;      // [K, W]
  const int32_t* ccap_before; // [K, W]
  int32_t* choice;            // [T]
  int32_t* cons_choice;       // [T]
  int32_t* slot;              // [T]
  int32_t* final_;            // [T]
  uint8_t* uncovered;         // [K] (F_COVER)
  int T, K, W, steps, flags;
  int chunk;                  // the tasks of a chunk in chunk_first: kChunk
};

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;  // rounds_kernels.SELECT_CHUNK
constexpr int kSmemRow = 48 * 1024;        // bytes of a ccap row in shared memory
constexpr int kWarps = kThreads / 32;

enum { F_BINPACK = 1, F_EXCL = 2, F_COVER = 4 };

__global__ void __launch_bounds__(kThreads) round_select_kernel(SelArgs a, bool smem_row) {
  extern __shared__ int32_t s_row[];
  __shared__ int32_t s_w[32];
  const int b = blockIdx.x;
  if (b >= a.chunk_first[a.K]) return;  // block-uniform
  // the class of this chunk: the last c with chunk_first[c] <= b
  int lo = 0, hi = a.K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.chunk_first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int c = lo;
  const int W = a.W;
  const int seg0 = a.off[c], seg1 = a.off[c + 1];
  const int lo_pos = seg0 + (b - a.chunk_first[c]) * kChunk;
  const int hi_pos = min(lo_pos + kChunk, seg1);
  const size_t row = (size_t)c * W;
  const int32_t* srch = a.ccap + row;
  if (smem_row) {
    for (int j = threadIdx.x; j < W; j += kThreads) s_row[j] = a.ccap[row + j];
    srch = s_row;
  }
  // active tasks of the class ahead of this chunk
  int ahead = 0;
  for (int i = seg0 + threadIdx.x; i < lo_pos; i += kThreads) ahead += a.active[a.perm[i]] != 0;
  ahead = bscan::reduce(ahead, 0, bscan::Sum(), s_w);
  // the class's rank among its group's live classes (exclusion classes)
  const bool binpack = a.flags & F_BINPACK, excl = a.flags & F_EXCL;
  const int excl_c = excl ? a.cls_excl[c] : -1;
  int live = 0;
  if (excl_c >= 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int p = a.excl_start[c] + warp; p < a.excl_pos[c]; p += kWarps) {
      const int cc = a.excl_perm[p];
      const int s0 = a.off[cc], s1 = a.off[cc + 1];
      int found = 0;
      for (int base = s0; base < s1 && !found; base += 32) {
        const int i = base + lane;
        found = __any_sync(bscan::kFull, i < s1 && a.active[a.perm[i]]);
      }
      if (lane == 0) live += found;
    }
  }
  const int grank = bscan::reduce(live, 0, bscan::Sum(), s_w);
  // this thread's tasks: kItems consecutive positions of the chunk
  const int t0 = lo_pos + threadIdx.x * kItems;
  int act[kItems];
  int n_act = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = t0 + k;
    act[k] = i < hi_pos ? a.active[a.perm[i]] != 0 : 0;
    n_act += act[k];
  }
  int total;
  int pre = ahead + bscan::exclusive(n_act, 0, bscan::Sum(), s_w, &total);
  const int nf = a.n_feas[c];
  int safe_end = W;
  if (a.flags & F_COVER) {
    if (!binpack || (excl && excl_c >= 0)) safe_end = a.g_start[row + W - 1];
    if (nf <= W) safe_end = W;
  }
  int unc = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = t0 + k;
    if (i >= hi_pos) break;
    const int t = a.perm[i];
    const int rank = act[k] ? pre : (i - seg0) - pre;
    pre += act[k];
    int l = 0, h = W;
    for (int s = 0; s < a.steps; ++s) {
      const int mid = (l + h) >> 1;
      if (srch[min(mid, W - 1)] <= rank) l = mid + 1; else h = mid;
    }
    const int slot = l;
    const int slot_c = min(max(slot, 0), W - 1);
    int fin = slot_c;
    if (!binpack || (excl && excl_c >= 0)) {
      const size_t at = row + slot_c;
      const int gz = max(a.g_size[at], 1);
      const int local = rank - a.ccap_before[at];
      fin = a.g_start[at] + (max(local, 0) % gz);
    }
    if (excl_c >= 0) fin = min(max(fin + grank, 0), max(nf - 1, 0));
    const bool on = act[k] != 0;
    a.choice[t] = (nf > 0 && slot < nf && on) ? a.order[row + min(max(fin, 0), W - 1)] : -1;
    a.cons_choice[t] = (nf > 0 && on) ? a.order[row] : -1;
    a.slot[t] = slot;
    a.final_[t] = fin;
    if (on && !(nf <= W || (slot < safe_end && fin < safe_end))) unc = 1;
  }
  if (a.flags & F_COVER) {
    if (__syncthreads_or(unc) && threadIdx.x == 0) a.uncovered[c] = 1;
  }
}

}  // namespace

// The launch: a CTA a chunk, at most K + ceil(T / kChunk) of them (the
// ones past chunk_first[K] return at once); the ccap row in shared memory
// when it fits in kSmemRow.
extern "C" int round_select(const SelArgs* a, cudaStream_t s) {
  if (a->chunk != kChunk) return (int)cudaErrorInvalidValue;
  if (a->flags & F_COVER) {
    cudaError_t e = cudaMemsetAsync(a->uncovered, 0, a->K, s);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t row = (size_t)a->W * sizeof(int32_t);
  const bool smem_row = row <= (size_t)kSmemRow;
  const int grid = a->K + (a->T + kChunk - 1) / kChunk;
  round_select_kernel<<<grid, kThreads, smem_row ? row : 0, s>>>(*a, smem_row);
  return (int)cudaGetLastError();
}
