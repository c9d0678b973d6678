// The order of the score windows of K2 window_topk and K14 express_place:
// IEEE 754's total order, which lax.top_k sorts by (-inf lowest, -0.0
// below +0.0), with ties to the lower index. A float's bits map to an
// unsigned integer that orders like the float; the map is a bijection, so
// the value comes back bit for bit. NaN lies outside the domain.

#pragma once

#include <stdint.h>

namespace okey {

__device__ __forceinline__ uint32_t ord(float x) {
  uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t ord(double x) {
  uint64_t b = (uint64_t)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | (1ull << 63));
}

__device__ __forceinline__ float unord(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ double unord(uint64_t u) {
  return __longlong_as_double((long long)((u >> 63) ? (u ^ (1ull << 63)) : ~u));
}

// (key desc under the total order, index asc)
template <typename T>
__device__ __forceinline__ bool sort_before(T ka, int ia, T kb, int ib) {
  auto a = ord(ka), b = ord(kb);
  return a > b || (a == b && ia < ib);
}

}  // namespace okey
