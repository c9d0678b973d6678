// K7a rounds_ctl: the loop control of the rounds solve, hand-written for
// Hopper (sm_90a), and the graph's conditional nodes it drives.
//
// Replaces: the loop structure of volcano_tpu/ops/rounds.py:619
// `solve_rounds` — the inner round loop and the outer rollback fixpoint
// (`outer_body`, :925-952, with the lax.cond on `capped`), the straggler
// rounds (:954-975) and the lax.cond around the tail pass (:1101). Plain
// version: volcano_tpu_torch/ops/rounds_kernels.py `rounds_ctl_plain`
// (`_ctl_fold_decide`), field for field.
//
// The solve is a flat step machine whose state is one int32 vector on the
// card (the C_* layout of rounds_ctl.cuh, mirrored from rounds_kernels.py).
// One thread runs after every step: it folds the step's counters (placed,
// still active, next dirty count, full sweep, rollback candidate) into the
// loop state, then walks the phases (outer test, inner rounds, straggler set-up
// and rounds, tail, done) until it picks the next step, and writes the
// step's predicates. Inside the solve's CUDA graph the steps run under a
// WHILE node whose body gates each step kind with IF nodes; this kernel's
// `_while` entry also sets the WHILE node's condition (a step is pending).
//
// The conditional nodes are created here too (`vt_cond_begin` /
// `vt_cond_end`): PyTorch on the card has no conditional-node capture, so
// the wrapper asks the runtime for the capturing graph of the current
// stream, adds an IF or WHILE node behind a one-thread kernel that copies a
// bool predicate from device memory into the node's handle, and starts
// capturing a second stream (one of `vt_stream_create`'s) into the node's
// body graph.
//
// A solve's dispatch is one call here, so that it holds the host as short
// a time as can be: `vt_launch` copies every input of the solve into the
// graph's input buffers in one kernel (a CTA column an input, the
// (source, destination, bytes) list passed by value; `vt_copy_in` alone
// for the eager pass before the capture), launches the graph, copies the
// packed result and status block into pinned host memory and records an
// event behind that copy (`vt_event_create`, `vt_event_sync`,
// `vt_event_destroy`).
//
// Bound: one thread, a few dozen integer operations a step; the cost is
// the launch inside the graph (a few microseconds), far above its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounds_ctl.cuh"

namespace {

using namespace rctl;

enum { PH_INIT, PH_OUTER, PH_INNER, PH_STRAG_INIT, PH_STRAG, PH_TAIL, PH_DONE };
enum { ST_NONE, ST_ROUND, ST_STRAG, ST_ROLLBACK, ST_TAIL };
enum { P_ACTIVE, P_ROUND, P_CONS, P_FULL, P_DIRTY, P_ROLLBACK, P_TAIL, P_DONE };

struct CtlArgs {
  int budget, rmp, sr, dirty_k, n_nodes, max_steps;
};

__device__ void ctl_step(int32_t* c, uint8_t* p, CtlArgs a) {
  const int last = c[C_LAST];
  if (c[C_PHASE] == PH_INIT) {
    c[C_PROGRESS] = 1;
    c[C_NDIRTY] = a.n_nodes;
    c[C_PHASE] = PH_OUTER;
  } else if (last == ST_ROUND || last == ST_STRAG) {
    const int placed = c[C_PLACED], still = c[C_STILL];
    if (a.rmp > 1 && placed > 0 && placed < a.rmp && still > 0 && still <= 8 * a.rmp)
      c[C_CAPPED] = 1;
    const int slot = c[C_ROUNDS] < kProfSlots - 1 ? c[C_ROUNDS] : kProfSlots - 1;
    c[C_HIST + slot] += placed;
    c[C_ROUNDS] += 1;
    c[C_PROGRESS] = placed > 0;
    c[C_TRIED] = (c[C_CONS] != 0) && placed == 0;
    c[C_FULL_SWEEPS] += c[C_DID_FULL];
    c[C_REMAINING] = still;
    c[C_NDIRTY] = c[C_NDIRTY_NEXT];
    if (last == ST_STRAG) c[C_EXTRA] += 1;
  } else if (last == ST_ROLLBACK) {
    c[C_PROGRESS] = 1;
    c[C_DEAD] = c[C_ANY_CAND] == 0;
    c[C_TRIED] = 0;
    c[C_NDIRTY] = c[C_NDIRTY_NEXT];
    c[C_REMAINING] = c[C_STILL];
  }
  int nxt = ST_NONE, cons = 0;
  for (;;) {
    const int ph = c[C_PHASE];
    if (ph == PH_OUTER) {
      c[C_PHASE] = (!c[C_DEAD] && c[C_ROUNDS] < a.budget) ? PH_INNER : PH_STRAG_INIT;
    } else if (ph == PH_INNER) {
      if ((c[C_PROGRESS] || !c[C_TRIED]) && c[C_REMAINING] > 0 &&
          c[C_ROUNDS] < a.budget && !c[C_CAPPED]) {
        nxt = ST_ROUND;
        cons = !c[C_PROGRESS];
        break;
      }
      c[C_PHASE] = PH_OUTER;
      if (c[C_CAPPED]) {
        c[C_DEAD] = 1;
        c[C_TRIED] = 0;
      } else {
        nxt = ST_ROLLBACK;
        break;
      }
    } else if (ph == PH_STRAG_INIT) {
      if (a.rmp > 1 && a.sr > 0) {
        c[C_EXTRA] = 0;
        c[C_PROGRESS] = 1;
      }
      c[C_PHASE] = PH_STRAG;
    } else if (ph == PH_STRAG) {
      if (a.rmp > 1 && a.sr > 0 && c[C_CAPPED] && c[C_PROGRESS] &&
          c[C_REMAINING] > 0 && c[C_EXTRA] < a.sr && c[C_ROUNDS] < a.budget) {
        nxt = ST_STRAG;
        cons = !c[C_PROGRESS];
        break;
      }
      c[C_PHASE] = PH_TAIL;
    } else if (ph == PH_TAIL) {
      c[C_PHASE] = PH_DONE;
      if (a.rmp > 1 && c[C_CAPPED]) {
        nxt = ST_TAIL;
        break;
      }
    } else {
      break;
    }
  }
  if (nxt != ST_NONE && c[C_STEPS] >= a.max_steps) {
    c[C_ERR] = 1;
    c[C_PHASE] = PH_DONE;
    nxt = ST_NONE;
    cons = 0;
  }
  c[C_LAST] = nxt;
  c[C_CONS] = cons;
  if (nxt != ST_NONE) c[C_STEPS] += 1;
  const bool dirty = a.dirty_k > 0 && c[C_NDIRTY] <= a.dirty_k;
  p[P_ACTIVE] = nxt != ST_NONE;
  p[P_ROUND] = nxt == ST_ROUND || nxt == ST_STRAG;
  p[P_CONS] = cons != 0;
  p[P_FULL] = !dirty;
  p[P_DIRTY] = dirty;
  p[P_ROLLBACK] = nxt == ST_ROLLBACK;
  p[P_TAIL] = nxt == ST_TAIL;
  p[P_DONE] = nxt == ST_NONE;
}

__global__ void rounds_ctl_kernel(int32_t* ctl, uint8_t* pred, CtlArgs a) {
  ctl_step(ctl, pred, a);
}

// the same step inside the WHILE node's body: the node runs again while a
// step is pending
__global__ void rounds_ctl_while_kernel(int32_t* ctl, uint8_t* pred, CtlArgs a,
                                        cudaGraphConditionalHandle h) {
  ctl_step(ctl, pred, a);
  cudaGraphSetConditional(h, pred[P_ACTIVE] ? 1u : 0u);
}

__global__ void set_cond_kernel(cudaGraphConditionalHandle h, const uint8_t* v) {
  cudaGraphSetConditional(h, *v ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* g, const cudaGraphNode_t** deps,
                         size_t* n) {
  cudaStreamCaptureStatus st;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &st, &id, g, deps, nullptr, n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &st, &id, g, deps, n);
#endif
  if (e != cudaSuccess) return e;
  return st == cudaStreamCaptureStatusActive ? cudaSuccess
                                             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int rounds_ctl(void* ctl, void* pred, int budget, int rmp, int sr,
                          int dirty_k, int n_nodes, int max_steps, void* stream) {
  CtlArgs a{budget, rmp, sr, dirty_k, n_nodes, max_steps};
  rounds_ctl_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int32_t*)ctl, (uint8_t*)pred, a);
  return (int)cudaGetLastError();
}

extern "C" int rounds_ctl_while(void* ctl, void* pred, int budget, int rmp, int sr,
                                int dirty_k, int n_nodes, int max_steps,
                                unsigned long long handle, void* stream) {
  CtlArgs a{budget, rmp, sr, dirty_k, n_nodes, max_steps};
  rounds_ctl_while_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int32_t*)ctl, (uint8_t*)pred, a, (cudaGraphConditionalHandle)handle);
  return (int)cudaGetLastError();
}

// Add a conditional node (kind 0: IF, 1: WHILE) to the graph `stream` is
// capturing, behind a kernel that loads its condition from the bool at
// `pred`; start capturing `body` into the node's body graph. The node's
// handle goes to *handle_out (the WHILE body's last kernel sets it).
extern "C" int vt_cond_begin(void* stream, void* body, const void* pred, int kind,
                             unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(s, &g, &deps, &n);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_cond_kernel<<<1, 1, 0, s>>>(h, (const uint8_t*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = capture_info(s, &g, &deps, &n);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, g, deps, nullptr, n, &params);
#else
  e = cudaGraphAddNode(&node, g, deps, n, &params);
#endif
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t child = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph((cudaStream_t)body, child, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = (unsigned long long)h;
  return 0;
}

// A stream of the graph's own (created once, never destroyed): torch's
// streams come from a small pool shared with every other user, so a body's
// stream could be the very stream being captured.
extern "C" int vt_stream_create(unsigned long long* out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  *out = (unsigned long long)s;
  return 0;
}

// End the capture of a conditional node's body (the graph stays the node's).
extern "C" int vt_cond_end(void* body) {
  cudaGraph_t g;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &g);
}

// -- the dispatch of a solve ---------------------------------------------------

// up to kMaxCopies inputs (the list rides the kernel's parameters, 3 KB)
constexpr int kMaxCopies = 128;

struct VtCopyList {
  const void* src[kMaxCopies];
  void* dst[kMaxCopies];
  long long bytes[kMaxCopies];
  int n;
};

namespace {

template <typename T>
__device__ __forceinline__ void copy_as(const char* s, char* d, long long n, long long first,
                                        long long step) {
  const long long m = n / (long long)sizeof(T);
  for (long long k = first; k < m; k += step) ((T*)d)[k] = ((const T*)s)[k];
  for (long long k = m * (long long)sizeof(T) + first; k < n; k += step) d[k] = s[k];
}

__global__ void __launch_bounds__(256) copy_in_kernel(VtCopyList l) {
  const int i = blockIdx.y;
  const char* s = (const char*)l.src[i];
  char* d = (char*)l.dst[i];
  const long long n = l.bytes[i];
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const uintptr_t align = (uintptr_t)s | (uintptr_t)d;
  if ((align & 15) == 0)
    copy_as<uint4>(s, d, n, first, step);
  else if ((align & 3) == 0)
    copy_as<uint32_t>(s, d, n, first, step);
  else
    copy_as<char>(s, d, n, first, step);
}

}  // namespace

extern "C" int vt_copy_in(const VtCopyList* l, void* stream) {
  if (l->n <= 0 || l->n > kMaxCopies) return (int)cudaErrorInvalidValue;
  copy_in_kernel<<<dim3(16, l->n), 256, 0, (cudaStream_t)stream>>>(*l);
  return (int)cudaGetLastError();
}

extern "C" int vt_launch(const VtCopyList* l, unsigned long long exec, void* host,
                         const void* block, long long bytes, unsigned long long event,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = vt_copy_in(l, stream);
  if (rc != 0) return rc;
  cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(host, block, bytes, cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaEventRecord((cudaEvent_t)event, s);
}

extern "C" int vt_event_create(unsigned long long* out) {
  cudaEvent_t ev;
  cudaError_t e = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
  if (e != cudaSuccess) return (int)e;
  *out = (unsigned long long)ev;
  return 0;
}

extern "C" int vt_event_sync(unsigned long long ev) {
  return (int)cudaEventSynchronize((cudaEvent_t)ev);
}

extern "C" int vt_event_destroy(unsigned long long ev) {
  return (int)cudaEventDestroy((cudaEvent_t)ev);
}
