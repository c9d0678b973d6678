// K4 resolve_prefix: per-node longest rank prefix that fits, hand-written for
// Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _resolve (:442) with _seg_limbs (:399)
// and _limbs_lt (:433): the segmented scans after the (node, rank) sort, the
// gathers through the sort's order and the scatter back. Plain version:
// volcano_tpu_torch/ops/rounds_kernels.py `resolve_prefix_plain`, equal bit
// for bit (integer arithmetic, and the bound's float ops as torch does them).
//
// Row i of the sorted axis is task order[i]; its key is its choice, or
// INT32_MAX when it has none (the infeasible segment, last). For a row of
// node n whose segment starts at s:
//   bound = int32(floor(idle[n] / unit) saturated + eps_i), widened
//   fits  = for every r: sum(req[s..i, r]) < max(bound[r], 0)
//           or (r is a scalar dim and req[i, r] <= MIN_MILLI_SCALAR)
//   pods  = !pod[i] or cnt[n] + count(pod[s..i]) <= nmax[n]   (check_pod)
//   accept[order[i]] = fits and pods for every row s..i
// The sums are exact int64.
//
// Design. One CTA a tile of kTile rows, taken by a ticket in launch order
// (an atomic counter, so a tile's predecessors are running or done), each
// thread kItems consecutive rows. Two single-pass look-back scans chain
// the tiles: the first carries (segment start, R request sums, pod count),
// the second the "a row before me in my segment was rejected" flag, which
// needs the first's result (fits is not monotone in a segment: the scalar
// skip). A look-back stops at the first tile before it with a segment
// start, one tile on the solve's inputs. The tile status words carry the
// launch's epoch (ticket / tiles + 1), so no memset runs between launches,
// inside a CUDA graph or out. The scan shuffles the live request lanes
// only (templated R: 1-4, or 8). A tile that opens on the infeasible
// segment writes rejections and stops.
//
// Bound: bytes (the order, and through it each task's choice, request row
// and pod flag, the nodes' idle rows, cnt and nmax, in; T flags out); the
// look-back's chain of L2 round trips and two block scans a tile are the
// latency it pays.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct ResolveArgs {
  const long long* order;     // [T] rows sorted by (node key, rank)
  const int32_t* choice;      // [T] node or -1, by task
  const long long* req;       // [T, R] quantized requests, by task
  const uint8_t* has_pod;     // [T] by task
  const void* idle;           // [N, R] float or double
  const void* unit;           // [R] float or double
  const int32_t* eps;         // [R] eps / unit, truncated
  const uint8_t* is_scalar;   // [R]
  const int32_t* cnt;         // [N]
  const int32_t* nmax;        // [N]
  uint8_t* accept;            // [T] out, by task
  unsigned long long* ctr;    // tile tickets
  unsigned long long* st1;    // [G] status of the sums scan
  unsigned long long* st2;    // [G] status of the rejection scan
  long long* agg;             // [G, kStride]
  long long* inc;             // [G, kStride]
  int T, R, G, check_pod;
};

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kStride = 9;  // payload lanes a tile: R <= 8 sums + pods
constexpr long long kMinMilliScalar = 10;

// XLA's float -> int32 convert as the plain version's torch ops do it:
// NaN -> 0, then the clamp to [-2^31, 2^31 - 1] in the float type, then
// truncation (which saturates on the card)
template <typename F>
__device__ __forceinline__ int to_i32(F x) {
  if (x != x) return 0;
  const F lo = (F)-2147483648.0, hi = (F)2147483647.0;
  x = x < lo ? lo : (x > hi ? hi : x);
  return (int)x;
}

template <int kR, typename F>
__global__ void __launch_bounds__(kThreads) resolve_prefix_kernel(ResolveArgs a) {
  constexpr int W = kR + 1;  // request sums, then the pod count
  using S = segscan::Seg<W>;
  __shared__ int s_key[kTile];
  __shared__ S sw[32];
  __shared__ int sw2[32];
  __shared__ S s_carry;
  __shared__ int s_carry2;
  __shared__ unsigned long long s_ticket;

  if (threadIdx.x == 0) s_ticket = atomicAdd(a.ctr, 1ULL);
  __syncthreads();
  const unsigned long long epoch = s_ticket / (unsigned)a.G + 1;
  const int tile = (int)(s_ticket % (unsigned)a.G);
  const int R = a.R;
  const int first = tile * kTile + threadIdx.x * kItems;

  long long o[kItems];
  int key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = first + k;
    o[k] = i < a.T ? a.order[i] : -1;
    int c = o[k] >= 0 ? a.choice[o[k]] : -1;
    key[k] = c >= 0 ? c : INT32_MAX;
    s_key[threadIdx.x * kItems + k] = key[k];
  }
  __syncthreads();
  if (s_key[0] == INT32_MAX) {  // the tile lies in the infeasible segment
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (o[k] >= 0) a.accept[o[k]] = 0;
    return;
  }

  // each row's segment start, requests and pod flag
  int head[kItems];
  S x[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k, i = first + k;
    int prev;
    if (j > 0) {
      prev = s_key[j - 1];
    } else {
      int c = i > 0 ? a.choice[a.order[i - 1]] : -1;
      prev = i > 0 ? (c >= 0 ? c : INT32_MAX) : -1;
    }
    head[k] = (i == 0 || prev != key[k]) ? 1 : 0;
    x[k].f = head[k];
    const bool feas = key[k] != INT32_MAX;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      x[k].v[r] = (feas && r < R) ? a.req[(size_t)o[k] * R + r] : 0;
    x[k].v[kR] = (feas && a.has_pod[o[k]]) ? 1 : 0;
  }

  // scan 1: the sums, within the tile, then across tiles
  S agg = segscan::ident<W>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) agg = segscan::cat(agg, x[k]);
  S total;
  S run = segscan::block_exclusive<S>(agg, segscan::ident<W>(), sw, &total);
  if (threadIdx.x == 0) {
    S carry = segscan::ident<W>();
    if (tile > 0) {
      segscan::publish<W, kStride>(a.st1, a.agg, tile, total, total.f, epoch, 0);
      carry = segscan::look_back<W, kStride>(a.st1, a.agg, a.inc, tile, epoch);
    }
    segscan::publish<W, kStride>(a.st1, a.inc, tile, segscan::cat(carry, total),
                                 total.f, epoch, segscan::kPre);
    s_carry = carry;
  }
  __syncthreads();
  run = segscan::cat(s_carry, run);

  // each row's condition: fits and the pod room
  const F* idle = (const F*)a.idle;
  const F* unit = (const F*)a.unit;
  int cond[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = segscan::cat(run, x[k]);
    const int n = key[k];
    bool ok = n != INT32_MAX;
    if (ok) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < R) {
          const F q = floor(idle[(size_t)n * R + r] / unit[r]);
          const long long b = (long long)(int)((unsigned)to_i32(q) + (unsigned)a.eps[r]);
          const bool le = run.v[r] < (b > 0 ? b : 0);
          const bool skip = a.is_scalar[r] && x[k].v[r] <= kMinMilliScalar;
          ok = ok && (le || skip);
        }
      }
      if (a.check_pod && x[k].v[kR])
        ok = ok && (long long)a.cnt[n] + run.v[kR] <= (long long)a.nmax[n];
    }
    cond[k] = ok ? 1 : 0;
  }

  // scan 2: a rejection earlier in the segment, within the tile and across
  int agg2 = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) agg2 = segscan::cat(agg2, head[k] | (cond[k] ? 0 : 2));
  int total2;
  int run2 = segscan::block_exclusive<int>(agg2, 0, sw2, &total2);
  if (threadIdx.x == 0) {
    int carry2 = 0;
    const unsigned long long hb = (total2 & 1) ? segscan::kHead : 0;
    if (tile > 0) {
      segscan::st_release(a.st2 + tile, (epoch << 8) | segscan::kAgg | hb
                                            | ((total2 & 2) ? segscan::kBitA : 0));
      carry2 = segscan::look_back_flag(a.st2, tile, epoch);
    }
    const int inc2 = segscan::cat(carry2, total2);
    segscan::st_release(a.st2 + tile, (epoch << 8) | segscan::kAgg | segscan::kPre
                                          | hb | ((inc2 & 2) ? segscan::kBitP : 0));
    s_carry2 = carry2;
  }
  __syncthreads();
  run2 = segscan::cat(s_carry2, run2);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool before = !head[k] && (run2 & 2);
    if (o[k] >= 0) a.accept[o[k]] = (cond[k] && !before) ? 1 : 0;
    run2 = segscan::cat(run2, head[k] | (cond[k] ? 0 : 2));
  }
}

template <typename F>
int launch(const ResolveArgs& a, cudaStream_t s) {
  const int grid = a.G;
  switch (a.R) {
    case 1: resolve_prefix_kernel<1, F><<<grid, kThreads, 0, s>>>(a); break;
    case 2: resolve_prefix_kernel<2, F><<<grid, kThreads, 0, s>>>(a); break;
    case 3: resolve_prefix_kernel<3, F><<<grid, kThreads, 0, s>>>(a); break;
    case 4: resolve_prefix_kernel<4, F><<<grid, kThreads, 0, s>>>(a); break;
    default: resolve_prefix_kernel<8, F><<<grid, kThreads, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resolve_prefix_tile() { return kTile; }
extern "C" int resolve_prefix_stride() { return kStride; }

extern "C" int resolve_prefix_f32(const ResolveArgs* a, cudaStream_t s) {
  if (a->T <= 0 || a->R <= 0 || a->R > 8 || a->G != (a->T + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  return launch<float>(*a, s);
}

extern "C" int resolve_prefix_f64(const ResolveArgs* a, cudaStream_t s) {
  if (a->T <= 0 || a->R <= 0 || a->R > 8 || a->G != (a->T + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  return launch<double>(*a, s);
}
