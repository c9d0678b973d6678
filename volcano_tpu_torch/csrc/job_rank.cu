// K6 job_rank: the job ranks of one round (and of the rollback) of the
// rounds solve, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py:91 `_job_rank`: jnp.lexsort of the
// job-order keys with the last key primary, i.e. the jobs ordered by the
// spec's job_order_keys in tier order (priority, gang readiness, drf
// share; csrc/job_keys.cuh, shared with K7b), then the tie rank, then the
// job index; rank[j] is job j's place in that order and order[p] the job
// at place p. Plain version: volcano_tpu_torch/ops/rounds_kernels.py
// `job_rank_plain` (chained stable torch sorts), equal bit for bit.
//
// Keys. Each job's keys pack into one unsigned integer of two or three
// 64-bit words (the fewest that hold them), most significant tier first: a
// priority as its int32 with the sign bit flipped (32 bits), the gang flag
// (1 bit), a drf share by the bits of its float or double with -0.0 folded
// into +0.0 (the map of csrc/order_key.cuh, 32 or 64 bits: ordered as the
// floats compare), the tie rank (32 bits), the index (the bits J - 1
// needs). The index makes every key unique, so a job's rank is the number
// of keys below its own.
//
// Design: two launches, each its own entry point (the wrapper counts them
// apart). ``job_rank_f32``/``_f64`` (job_rank_tiles_kernel): a CTA a tile
// of 512 jobs, a thread a job, builds the keys (also into scratch in job
// order) and sorts the tile with a bitonic network, the exchanges across
// warps through shared memory (10 barrier steps) and those within a warp
// by shuffles (35 steps), then writes the sorted tile to scratch and
// zeroes the tile's ranks. ``job_rank_count`` (job_rank_count_kernel): a
// CTA a (chunk of 512 jobs, tile) pair loads the tile into shared memory;
// each job binary-searches its key there (the keys below it) and adds the
// count to its rank with an atomic; the CTA that finishes a chunk last
// writes order[rank[j]] = j for the chunk's jobs and resets the chunk's
// counter for the next launch (no memset between launches, in a CUDA
// graph or out). The scratch (keys, sorted tiles, chunk counters) is one
// zeroed block of ``job_rank_scratch_bytes(J, words)``, laid out here.
//
// A one-CTA design (every key in one CTA's shared memory, one bitonic
// sort, one launch) holds at most 8,192 keys of 24 bytes, and the job axis
// has no such bound; bench/job_rank_designs.py times it against this one.
//
// Bound: bytes (the job columns and the allocation rows read, rank and
// order written); the sort's barrier and shuffle steps and the search's
// dependent shared-memory loads make it latency-bound at these J.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "job_keys.cuh"
#include "order_key.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct RankArgs {
  const int32_t* priority;        // [J]
  const int32_t* ready_base;      // [J]
  const int32_t* min_available;   // [J]
  const int32_t* tie_rank;        // [J]
  const int32_t* placed;          // [J]
  const void* alloc;              // [J, R] F
  const void* drf_total;          // [R] F
  const uint8_t* drf_present;     // [R]
  void* scratch;                  // job_rank_scratch_bytes(J, words), zeroed once
  int32_t* rank;                  // [J]
  long long* order;               // [J]
  int J, R, n_keys, key0, key1, key2, idx_bits, words;
};

namespace {

constexpr int kTile = 512;
constexpr int kCountThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the scratch: the keys in job order, the sorted tiles, the chunk counters
struct Scratch {
  unsigned long long* keys;  // [n_tiles * kTile * words]
  unsigned long long* tiles;  // [n_tiles * kTile * words]
  unsigned* done;             // [n_tiles], zero between launches
};

__host__ __device__ inline int n_tiles(int J) { return (J + kTile - 1) / kTile; }

inline Scratch scratch(const RankArgs* a) {
  const size_t span = (size_t)n_tiles(a->J) * kTile * a->words;
  unsigned long long* keys = (unsigned long long*)a->scratch;
  return Scratch{keys, keys + span, (unsigned*)(keys + 2 * span)};
}

template <int NW>
struct Key {
  unsigned long long w[NW];
};

template <int NW>
__device__ __forceinline__ bool less(const Key<NW>& a, const Key<NW>& b) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  }
  return false;
}

// k = (k << width) | v (1 <= width <= 64)
template <int NW>
__device__ __forceinline__ void push(Key<NW>& k, unsigned long long v, int width) {
  if (width == 64) {
#pragma unroll
    for (int i = 0; i + 1 < NW; ++i) k.w[i] = k.w[i + 1];
    k.w[NW - 1] = v;
    return;
  }
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) k.w[i] = (k.w[i] << width) | (k.w[i + 1] >> (64 - width));
  k.w[NW - 1] = (k.w[NW - 1] << width) | v;
}

__device__ __forceinline__ unsigned long long ord_i32(int32_t x) {
  return (unsigned long long)((uint32_t)x ^ 0x80000000u);
}

template <int NW, typename F>
__device__ Key<NW> job_key(const RankArgs& a, int j) {
  const jobkeys::JobCols<F> c{a.priority, a.ready_base, a.min_available, a.tie_rank,
                              a.placed, (const F*)a.alloc, (const F*)a.drf_total,
                              a.drf_present, a.R};
  Key<NW> k;
#pragma unroll
  for (int i = 0; i < NW; ++i) k.w[i] = 0ull;
  for (int i = 0; i < a.n_keys; ++i) {
    const int code = i == 0 ? a.key0 : (i == 1 ? a.key1 : a.key2);
    const double v = jobkeys::key<F>(c, code, j);
    if (code == jobkeys::kPriority) {
      push(k, ord_i32((int32_t)v), 32);
    } else if (code == jobkeys::kGang) {
      push(k, v != 0.0 ? 1ull : 0ull, 1);
    } else {
      F s = (F)v;
      s = s == F(0) ? F(0) : s;  // -0.0 ties +0.0
      push(k, (unsigned long long)okey::ord(s), (int)(8 * sizeof(F)));
    }
  }
  push(k, ord_i32(a.tie_rank[j]), 32);
  push(k, (unsigned long long)(uint32_t)j, a.idx_bits);
  return k;
}

template <int NW>
__device__ __forceinline__ Key<NW> shfl_xor(const Key<NW>& k, int m) {
  Key<NW> o;
#pragma unroll
  for (int i = 0; i < NW; ++i) o.w[i] = __shfl_xor_sync(kFull, k.w[i], m);
  return o;
}

template <int NW, typename F>
__global__ void __launch_bounds__(kTile) job_rank_tiles_kernel(RankArgs a, Scratch sc) {
  __shared__ unsigned long long s[2][NW][kTile];
  const int e = threadIdx.x;
  const int j = blockIdx.x * kTile + e;
  Key<NW> k;
#pragma unroll
  for (int i = 0; i < NW; ++i) k.w[i] = ~0ull;  // padding sorts last
  if (j < a.J) {
    k = job_key<NW, F>(a, j);
#pragma unroll
    for (int i = 0; i < NW; ++i) sc.keys[(size_t)j * NW + i] = k.w[i];
    a.rank[j] = 0;
  }
  int buf = 0;
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key<NW> o;
      if (stride >= 32) {  // across warps: through shared memory
#pragma unroll
        for (int i = 0; i < NW; ++i) s[buf][i][e] = k.w[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NW; ++i) o.w[i] = s[buf][i][e ^ stride];
        buf ^= 1;  // the next exchange writes the other buffer: one barrier a step
      } else {
        o = shfl_xor(k, stride);
      }
      // the pair's lower element keeps the min where the run ascends
      const bool keep_min = ((e & stride) == 0) == ((e & size) == 0);
      if (less(o, k) == keep_min) k = o;
    }
  }
  unsigned long long* out = sc.tiles + (size_t)blockIdx.x * kTile * NW;
#pragma unroll
  for (int i = 0; i < NW; ++i) out[(size_t)e * NW + i] = k.w[i];
}

template <int NW>
__global__ void __launch_bounds__(kCountThreads) job_rank_count_kernel(RankArgs a, Scratch sc) {
  __shared__ unsigned long long tile[kTile * NW];
  __shared__ int s_last;
  const int chunk = blockIdx.x, t = blockIdx.y;
  const unsigned long long* src = sc.tiles + (size_t)t * kTile * NW;
  for (int i = threadIdx.x; i < kTile * NW; i += kCountThreads) tile[i] = __ldcg(src + i);
  __syncthreads();
  constexpr int kPer = kTile / kCountThreads;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = chunk * kTile + q * kCountThreads + threadIdx.x;
    if (j >= a.J) continue;
    Key<NW> k;
#pragma unroll
    for (int i = 0; i < NW; ++i) k.w[i] = __ldcg(sc.keys + (size_t)j * NW + i);
    int lo = 0, hi = kTile;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      Key<NW> x;
#pragma unroll
      for (int i = 0; i < NW; ++i) x.w[i] = tile[mid * NW + i];
      if (less(x, k)) lo = mid + 1; else hi = mid;
    }
    if (lo) atomicAdd(a.rank + j, lo);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(sc.done + chunk, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = 0; q < kPer; ++q) {
    const int j = chunk * kTile + q * kCountThreads + threadIdx.x;
    if (j < a.J) a.order[__ldcg(a.rank + j)] = j;
  }
  if (threadIdx.x == 0) sc.done[chunk] = 0;
}

bool valid(const RankArgs* a) {
  return a->J > 0 && a->R > 0 && a->n_keys >= 0 && a->n_keys <= 3 && a->idx_bits >= 1 &&
         a->idx_bits <= 32 && (1ll << a->idx_bits) >= (long long)a->J &&
         a->J <= 65535 * kTile && (a->words == 2 || a->words == 3) && a->scratch;
}

template <typename F>
int launch_tiles(const RankArgs* a, cudaStream_t s) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (a->words == 2)
    job_rank_tiles_kernel<2, F><<<n_tiles(a->J), kTile, 0, s>>>(*a, scratch(a));
  else
    job_rank_tiles_kernel<3, F><<<n_tiles(a->J), kTile, 0, s>>>(*a, scratch(a));
  return (int)cudaGetLastError();
}

int launch_count(const RankArgs* a, cudaStream_t s) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles(a->J), n_tiles(a->J));
  if (a->words == 2)
    job_rank_count_kernel<2><<<grid, kCountThreads, 0, s>>>(*a, scratch(a));
  else
    job_rank_count_kernel<3><<<grid, kCountThreads, 0, s>>>(*a, scratch(a));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long job_rank_scratch_bytes(int J, int words) {
  return 16ll * n_tiles(J) * kTile * words + 4ll * n_tiles(J);
}
extern "C" int job_rank_f32(const RankArgs* a, cudaStream_t s) { return launch_tiles<float>(a, s); }
extern "C" int job_rank_f64(const RankArgs* a, cudaStream_t s) { return launch_tiles<double>(a, s); }
extern "C" int job_rank_count(const RankArgs* a, cudaStream_t s) { return launch_count(a, s); }
