// K8 scatter_rows: the bucketed row scatter of the device replica and the
// express lane, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/replica.py:144 `scatter_rows`, a jitted
// `{k: bufs[k].at[idx].set(rows[k]) for k in bufs}` over one axis family's
// buffer dict (the replica's node/job/queue/ns families and the express
// lane's five node columns, volcano_tpu/express/encode.py:199).
//
// One launch per family: the wrapper passes a pointer table by value (each
// standing buffer, its staged source rows and its row width in bytes) and
// the padded row index; block row y copies buffer y's rows into place,
// threads striding over (row, byte). The standing buffers are written in
// place (the port's replacement for JAX's functional update), so nothing
// else of them moves.
//
// Duplicate indices: `bucket_pad_rows` pads the index to the bucket ladder
// by repeating the first dirty row, and every duplicate carries the same
// source bytes, so concurrent writes of one row store identical values and
// their order does not matter.
//
// Bound: bytes (the rows read once and written once: at cfg5 at most 256
// rows of 36 bytes per node family), a few KB, so launch latency bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBufs = 8;
constexpr int kThreads = 256;

struct Table {
  char* dst[kMaxBufs];
  const char* src[kMaxBufs];
  int row_bytes[kMaxBufs];
};

__global__ void scatter_rows_kernel(Table tab, const int32_t* __restrict__ idx,
                                    int M) {
  const int b = blockIdx.y;
  const int rb = tab.row_bytes[b];
  const long long total = (long long)M * rb;
  char* dst = tab.dst[b];
  const char* src = tab.src[b];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long m = i / rb;
    long long byte = i - m * rb;
    dst[(long long)idx[m] * rb + byte] = src[i];
  }
}

}  // namespace

extern "C" int scatter_rows_max_bufs() { return kMaxBufs; }

// dst/src: host arrays of nbuf device pointers; row_bytes: host array of
// nbuf widths; idx: device int32 [M]; launches on `stream`.
extern "C" int scatter_rows(int nbuf, void* const* dst, const void* const* src,
                            const int* row_bytes, const void* idx, int M,
                            void* stream) {
  if (nbuf <= 0 || nbuf > kMaxBufs || M <= 0) return (int)cudaErrorInvalidValue;
  Table tab;
  long long widest = 0;
  for (int b = 0; b < kMaxBufs; ++b) {
    tab.dst[b] = b < nbuf ? (char*)dst[b] : nullptr;
    tab.src[b] = b < nbuf ? (const char*)src[b] : nullptr;
    tab.row_bytes[b] = b < nbuf ? row_bytes[b] : 0;
    if (b < nbuf) {
      if (row_bytes[b] <= 0) return (int)cudaErrorInvalidValue;
      long long bytes = (long long)M * row_bytes[b];
      if (bytes > widest) widest = bytes;
    }
  }
  long long blocks = (widest + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  dim3 grid((unsigned)blocks, nbuf);
  scatter_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tab, (const int32_t*)idx, M);
  return (int)cudaGetLastError();
}
