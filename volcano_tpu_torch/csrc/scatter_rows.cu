// K8 scatter_rows: the bucketed row scatter of the device replica and the
// express lane, hand-written for Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/replica.py:144 `scatter_rows`, a jitted
// `{k: bufs[k].at[idx].set(rows[k]) for k in bufs}` over one axis family's
// buffer dict (the replica's node/job/queue/ns families and the express
// lane's five node columns, volcano_tpu/express/encode.py:199).
//
// Bound: bytes (the rows read once and written once: at cfg5 at most 256
// rows of 36 bytes per node family), a few KB, so a call is bound by the
// host's work and the launch, not by the card. The design cuts both:
//
// - A plan a (family, padded bucket width), made once (scatter_plan_new):
//   the standing buffers' pointers and row widths, the word each buffer is
//   copied in, the grid, and two staging slots, each a block of pinned
//   host memory mapped into the card's address space (cudaHostAlloc) of
//   the bucket's size (the index, then each buffer's rows, every section
//   16-byte aligned) with an event. The standing buffers are written in
//   place, so their pointers hold until the caller rebuilds them, which
//   drops the plan (ops/replica.py ScatterPlans).
// - A call writes the rows into the slot's block (the wrapper's np.copyto
//   into views planned once) and makes ONE C call (scatter_plan_run): the
//   launch, whose threads read the rows from host memory over the bus (no
//   copy to the card first: a few KB, read once), the slot's event; then it
//   waits on the other slot's event (the launch the call before made, long
//   done in a session), so the next call may write that slot's block.
//   scatter_plan_launch is the launch alone, which a CUDA graph captures.
// - The kernel: block row y copies buffer y; a buffer is copied in 16-, 8-
//   or 4-byte words where its row width and pointers allow (bytes only for
//   1-byte columns: the lane's ok flags, bool buffers), a group of threads a
//   row (the power of two at or above the row's words, at most 32), so the
//   row and word come from a shift and a mask: no division.
//
// Duplicate indices: `bucket_pad_rows` pads the index to the bucket ladder
// by repeating the first dirty row, and every duplicate carries the same
// source bytes, so concurrent writes of one row store identical values and
// their order does not matter.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int kMaxBufs = 8;
constexpr int kSlots = 2;
constexpr int kThreads = 256;
constexpr int kMaxCtas = 1024;

struct Buf {
  char* dst;    // the standing buffer
  int src_off;  // its rows' byte offset in a staging block
  int words;    // words a row
  int wshift;   // log2 of the word's bytes (0, 2, 3 or 4)
  int gshift;   // log2 of the threads a row (0..5)
};

struct Table {
  Buf b[kMaxBufs];
  int M;  // rows (the padded bucket width)
};

struct Plan {
  Table tab;
  int nbuf;
  unsigned grid_x;
  size_t bytes;         // a staging block
  void* host[kSlots];   // pinned, mapped
  void* mapped[kSlots]; // the same blocks in the card's address space
  cudaEvent_t done[kSlots];
};

// the rows of one buffer from the staging block (host memory) into place;
// a row's words load beside its index, so a row costs one trip over the bus
template <typename W>
__device__ __forceinline__ void copy_rows(const Buf& b, const char* stage, const int32_t* idx,
                                          int M) {
  const int lane = threadIdx.x & ((1 << b.gshift) - 1);
  const int g = 1 << b.gshift;
  const W* src = (const W*)(stage + b.src_off);
  W* dst = (W*)b.dst;
  const int first = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> b.gshift);
  const int stride = (int)((gridDim.x * blockDim.x) >> b.gshift);
  for (int r = first; r < M; r += stride) {
    const size_t row = (size_t)idx[r] * b.words;
    const int s = r * b.words;
    for (int w = lane; w < b.words; w += g) dst[row + w] = src[s + w];
  }
}

__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(Table tab, const char* stage) {
  const Buf b = tab.b[blockIdx.y];
  const int32_t* idx = (const int32_t*)stage;
  switch (b.wshift) {
    case 4: copy_rows<uint4>(b, stage, idx, tab.M); break;
    case 3: copy_rows<uint2>(b, stage, idx, tab.M); break;
    case 2: copy_rows<uint32_t>(b, stage, idx, tab.M); break;
    default: copy_rows<uint8_t>(b, stage, idx, tab.M); break;
  }
}

int log2_floor(int x) {
  int s = 0;
  while ((1 << (s + 1)) <= x) ++s;
  return s;
}

}  // namespace

extern "C" int scatter_rows_max_bufs() { return kMaxBufs; }

// A plan: nbuf standing buffers (dst, row_bytes), each one's rows at
// src_off in a staging block of `bytes` (the index at offset 0, M int32),
// two slots of mapped pinned blocks (scatter_plan_host gives their host
// addresses). Returns the plan, or null when an argument is out of range
// or a block or an event cannot be made.
extern "C" void* scatter_plan_new(int nbuf, void* const* dst, const int* row_bytes,
                                  const long long* src_off, int M, long long bytes) {
  if (nbuf <= 0 || nbuf > kMaxBufs || M <= 0 || bytes <= 0) return nullptr;
  Plan* p = (Plan*)calloc(1, sizeof(Plan));
  if (p == nullptr) return nullptr;
  p->nbuf = nbuf;
  p->bytes = (size_t)bytes;
  p->tab.M = M;
  int widest = 1;
  for (int k = 0; k < nbuf; ++k) {
    const int rb = row_bytes[k];
    if (rb <= 0 || src_off[k] < (long long)M * 4 || src_off[k] + (long long)M * rb > bytes) {
      free(p);
      return nullptr;
    }
    // the widest word the row width and both addresses allow
    int ws = 16;
    while (ws > 1 && (rb % ws || (uintptr_t)dst[k] % ws || src_off[k] % ws)) ws >>= 1;
    if (ws == 2) ws = 1;  // a 2-byte word: copied as bytes
    Buf& b = p->tab.b[k];
    b.dst = (char*)dst[k];
    b.src_off = (int)src_off[k];
    b.words = rb / ws;
    b.wshift = log2_floor(ws);
    int g = 1;
    while (g < b.words && g < 32) g <<= 1;
    b.gshift = log2_floor(g);
    if (g > widest) widest = g;
  }
  long long ctas = ((long long)M * widest + kThreads - 1) / kThreads;
  p->grid_x = (unsigned)(ctas > kMaxCtas ? kMaxCtas : ctas);
  for (int s = 0; s < kSlots; ++s) {
    if (cudaHostAlloc(&p->host[s], p->bytes, cudaHostAllocMapped | cudaHostAllocPortable) !=
            cudaSuccess ||
        cudaHostGetDevicePointer(&p->mapped[s], p->host[s], 0) != cudaSuccess ||
        cudaEventCreateWithFlags(&p->done[s], cudaEventDisableTiming) != cudaSuccess) {
      cudaGetLastError();
      for (int u = 0; u <= s; ++u) {
        if (p->host[u]) cudaFreeHost(p->host[u]);
        if (p->done[u]) cudaEventDestroy(p->done[u]);
      }
      free(p);
      return nullptr;
    }
  }
  return p;
}

// slot `slot`'s block, as the host writes it
extern "C" void* scatter_plan_host(void* plan, int slot) {
  Plan* p = (Plan*)plan;
  return p != nullptr && slot >= 0 && slot < kSlots ? p->host[slot] : nullptr;
}

// The plan's end: waits for both slots' last launches, then frees their
// blocks and the plan.
extern "C" int scatter_plan_free(void* plan) {
  Plan* p = (Plan*)plan;
  if (p == nullptr) return 0;
  int rc = 0;
  for (int s = 0; s < kSlots; ++s) {
    cudaError_t e = cudaEventSynchronize(p->done[s]);
    if (e != cudaSuccess && rc == 0) rc = (int)e;
    cudaEventDestroy(p->done[s]);
    e = cudaFreeHost(p->host[s]);
    if (e != cudaSuccess && rc == 0) rc = (int)e;
  }
  free(p);
  return rc;
}

// Slot `slot`'s launch on `stream`, reading its block (capturable).
extern "C" int scatter_plan_launch(void* plan, int slot, void* stream) {
  Plan* p = (Plan*)plan;
  if (p == nullptr || slot < 0 || slot >= kSlots) return (int)cudaErrorInvalidValue;
  dim3 grid(p->grid_x, (unsigned)p->nbuf);
  scatter_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      p->tab, (const char*)p->mapped[slot]);
  return (int)cudaGetLastError();
}

// A call: the launch of slot `slot`, its event, then the wait for the
// other slot's last launch (the block the next call writes).
extern "C" int scatter_plan_run(void* plan, int slot, void* stream) {
  int rc = scatter_plan_launch(plan, slot, stream);
  if (rc != 0) return rc;
  Plan* p = (Plan*)plan;
  cudaError_t e = cudaEventRecord(p->done[slot], (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaEventSynchronize(p->done[slot ^ 1]);
}
