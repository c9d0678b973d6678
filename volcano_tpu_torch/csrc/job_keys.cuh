// The job-order keys of the rounds solve, shared by K6 job_rank
// (job_rank.cu: the round's and the rollback's job ranks) and K7b
// tail_pass (tail_pass.cu: the serial visit order of the tail).
//
// A job's keys, in the spec's job_order_keys order (volcano_tpu/ops/
// rounds.py:91 `_job_rank`, :980 `tail_pass`):
//   priority  -job_priority (an int32 negation, wrapping as torch's)
//   gang      ready = job_ready_base + job_placed >= job_min_available
//             (an int32 add, wrapping as torch's)
//   drf       the share of volcano_tpu/ops/kernels.py `_share`: the max
//             over the present dims of alloc / total (share(l, 0) = 1 for
//             l != 0), at least 0
// then the job's tie rank. Every key widens exactly to a double (an int32,
// a 0/1 flag, a float or double share), so both kernels compare them as
// doubles: -0.0 and +0.0 tie, as the reference's stable sorts tie them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace jobkeys {

// the key codes (rounds_kernels.JOB_KEY_CODES)
enum { kPriority = 0, kGang = 1, kDrf = 2 };

// _share: max over present dims of alloc/total (share(l, 0) = 1 for
// l != 0), at least 0
template <typename F>
__device__ __forceinline__ F drf_share(const F* alloc, const F* total,
                                       const uint8_t* present, int R) {
  F m = F(-INFINITY);
  for (int r = 0; r < R; ++r) {
    F tot = total[r];
    F s = tot > F(0) ? alloc[r] / tot : (alloc[r] == F(0) ? F(0) : F(1));
    if (present[r] && s > m) m = s;
  }
  return m < F(0) ? F(0) : m;
}

// What a job's keys read: the encode's job columns and the solve state.
template <typename F>
struct JobCols {
  const int32_t* priority;       // [J]
  const int32_t* ready_base;     // [J]
  const int32_t* min_available;  // [J]
  const int32_t* tie_rank;       // [J]
  const int32_t* placed;         // [J] state
  const F* alloc;                // [J, R] state
  const F* drf_total;            // [R]
  const uint8_t* drf_present;    // [R]
  int R;
};

__device__ __forceinline__ int32_t wrap_neg(int32_t x) {
  return (int32_t)(0u - (uint32_t)x);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// job j's key of kind ``code``, as a double (exact)
template <typename F>
__device__ __forceinline__ double key(const JobCols<F>& c, int code, int j) {
  if (code == kPriority) return (double)wrap_neg(c.priority[j]);
  if (code == kGang)
    return wrap_add(c.ready_base[j], c.placed[j]) >= c.min_available[j] ? 1.0 : 0.0;
  return (double)drf_share<F>(c.alloc + (size_t)j * c.R, c.drf_total, c.drf_present, c.R);
}

}  // namespace jobkeys
