// K5 queue_budget: the job-granular queue fair-share cap of one round,
// hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/rounds.py _queue_budget (:495-549): its
// segmented scans after the (queue, rank) sort of the tasks, in exact int64
// in place of the two 15-bit int32 limbs. Plain version:
// volcano_tpu_torch/ops/rounds_kernels.py `queue_budget_plain`, equal bit
// for bit.
//
// The reference's answer for a task is a function of its job: in (queue,
// rank) order a job's tasks are contiguous (a task's rank is its job's
// rank x T + its place in the job), so "the accepted requests of the rows
// of my queue before my job" is the sum over the higher-ranked jobs of the
// queue. For job j of queue q, in the job order ``jq`` (jobs by queue,
// then rank):
//   before = sum of the accepted requests of the jobs of q before j in jq
//   tot    = int32(ceil(queue_alloc[q] / unit) saturated), widened, + before
//   ok[j]  = for every r: tot < max(bound[q, r], 0)
//            or (r is a scalar dim and tot <= MIN_MILLI_SCALAR)
//   out[t] = accept[t] and ok[task_job[t]]
// with bound = floor(deserved / unit) + eps / unit, fixed for a solve.
//
// Design: two launches and no task-axis sort. ``queue_budget``: a CTA a
// tile of tasks sums each warp's runs of equal task_job (a segmented warp
// scan) and adds a run's accepted requests to its job's row with one int64
// atomicAdd a lane (exact, so their order does not matter); the CTA that
// arrives last scans the jobs in jq order (a block scan, ceil(J / 1024)
// jobs a thread), writes ok[j], and zeroes the job rows and its arrival
// counter for the next launch (no memset between launches, in a CUDA graph
// or out). ``queue_budget_mask``: out[t] = accept[t] and ok[task_job[t]].
// Loading a thread's jobs four at a time, their loads issued together,
// measured slower on an NVIDIA H100 (0.0370 against 0.0339 ms at cfg5).
//
// Bound: bytes (the accept flags, task_job and the request rows of the
// tasks, the job order and queues, in; T flags out); the last CTA's scan
// of the jobs is the serial part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

// the launch's arguments (external linkage: the C entry points take it)
struct BudgetArgs {
  const uint8_t* accept;      // [T]
  const int32_t* task_job;    // [T]
  const long long* req;       // [T, R] quantized requests
  const long long* jq;        // [J] jobs by (queue, rank)
  const int32_t* job_queue;   // [J]
  const void* queue_alloc;    // [Q, R] float or double
  const void* unit;           // [R] float or double
  const long long* bound;     // [Q, R]
  const uint8_t* is_scalar;   // [R]
  uint8_t* out;               // [T]
  long long* jsum;            // [J, R] scratch, zero between launches
  unsigned* arrived;          // scratch, zero between launches
  uint8_t* job_ok;            // [J] scratch
  int T, R, J;
};

namespace {

constexpr int kThreads = 1024;
constexpr long long kMinMilliScalar = 10;

template <typename F>
__device__ __forceinline__ int to_i32(F x) {
  if (x != x) return 0;
  const F lo = (F)-2147483648.0, hi = (F)2147483647.0;
  x = x < lo ? lo : (x > hi ? hi : x);
  return (int)x;
}

template <int kR, typename F>
__global__ void __launch_bounds__(kThreads) queue_budget_kernel(BudgetArgs a) {
  using S = segscan::Seg<kR>;
  __shared__ S sw[32];
  __shared__ int s_last;
  const int R = a.R;
  const int lane = threadIdx.x & 31;

  // 1. each warp's runs of equal task_job, one atomic a run and lane
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = t < a.T;
  const int j = valid ? a.task_job[t] : -1;
  const int prev = __shfl_up_sync(segscan::kFull, j, 1);  // every lane shuffles
  S x;
  x.f = (lane == 0 || prev != j) ? 1 : 0;
  const bool acc = valid && a.accept[t];
#pragma unroll
  for (int r = 0; r < kR; ++r) x.v[r] = (acc && r < R) ? a.req[(size_t)t * R + r] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    S y = segscan::shfl_up(x, d);
    if (lane >= d) x = segscan::cat(y, x);
  }
  const int next = __shfl_down_sync(segscan::kFull, j, 1);
  if (valid && (lane == 31 || next != j)) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r < R && x.v[r] != 0)
        atomicAdd((unsigned long long*)&a.jsum[(size_t)j * R + r],
                  (unsigned long long)x.v[r]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 2. the last CTA: the exclusive scan of the job sums in jq order,
  //    segmented by queue, and each job's decision
  const int per = (a.J + kThreads - 1) / kThreads;
  const int lo = min(a.J, (int)threadIdx.x * per), hi = min(a.J, lo + per);
  const int q0 = lo > 0 ? a.job_queue[a.jq[lo - 1]] : -1;  // queues are >= 0
  S agg = segscan::ident<kR>();
  for (int p = lo, qprev = q0; p < hi; ++p) {
    const long long jj = a.jq[p];
    const int q = a.job_queue[jj];
    S y;
    y.f = q != qprev ? 1 : 0;
    qprev = q;
#pragma unroll
    for (int r = 0; r < kR; ++r) y.v[r] = r < R ? __ldcg(a.jsum + jj * R + r) : 0;
    agg = segscan::cat(agg, y);
  }
  S total;
  S run = segscan::block_exclusive<S>(agg, segscan::ident<kR>(), sw, &total);
  const F* qa = (const F*)a.queue_alloc;
  const F* unit = (const F*)a.unit;
  for (int p = lo, qprev = q0; p < hi; ++p) {
    const long long jj = a.jq[p];
    const int q = a.job_queue[jj];
    S y;
    y.f = q != qprev ? 1 : 0;
    qprev = q;
    bool ok = true;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < R) {
        y.v[r] = __ldcg(a.jsum + jj * R + r);
        const long long before = y.f ? 0 : run.v[r];
        const long long alloc = (long long)to_i32(ceil(qa[(size_t)q * R + r] / unit[r]));
        const long long tot = alloc + before;
        const long long b = a.bound[(size_t)q * R + r];
        const bool le = tot < (b > 0 ? b : 0);
        const bool skip = a.is_scalar[r] && tot <= kMinMilliScalar;
        ok = ok && (le || skip);
      } else {
        y.v[r] = 0;
      }
    }
    a.job_ok[jj] = ok ? 1 : 0;
    run = segscan::cat(run, y);
  }
  __syncthreads();
  // the job rows and the arrival counter back to zero for the next launch
  for (size_t i = threadIdx.x; i < (size_t)a.J * R; i += kThreads) a.jsum[i] = 0;
  if (threadIdx.x == 0) *a.arrived = 0;
}

__global__ void __launch_bounds__(256) queue_budget_mask_kernel(BudgetArgs a) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t < a.T) a.out[t] = (a.accept[t] && a.job_ok[a.task_job[t]]) ? 1 : 0;
}

template <typename F>
int launch(const BudgetArgs& a, cudaStream_t s) {
  const int grid = (a.T + kThreads - 1) / kThreads;
  switch (a.R) {
    case 1: queue_budget_kernel<1, F><<<grid, kThreads, 0, s>>>(a); break;
    case 2: queue_budget_kernel<2, F><<<grid, kThreads, 0, s>>>(a); break;
    case 3: queue_budget_kernel<3, F><<<grid, kThreads, 0, s>>>(a); break;
    case 4: queue_budget_kernel<4, F><<<grid, kThreads, 0, s>>>(a); break;
    default: queue_budget_kernel<8, F><<<grid, kThreads, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

int check(const BudgetArgs* a) {
  return (a->T <= 0 || a->J <= 0 || a->R <= 0 || a->R > 8) ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" int queue_budget_f32(const BudgetArgs* a, cudaStream_t s) {
  return check(a) ? check(a) : launch<float>(*a, s);
}

extern "C" int queue_budget_f64(const BudgetArgs* a, cudaStream_t s) {
  return check(a) ? check(a) : launch<double>(*a, s);
}

extern "C" int queue_budget_mask(const BudgetArgs* a, cudaStream_t s) {
  if (check(a)) return check(a);
  queue_budget_mask_kernel<<<(a->T + 255) / 256, 256, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
