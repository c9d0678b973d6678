// K11 evict_backfill: backfill's placement decisions, hand-written for
// Hopper (sm_90a).
//
// Replaces: volcano_tpu/ops/evict.py solve_backfill (:1020): each
// zero-request task in walk order takes the first feasible node in name
// order; the only dynamic feasibility term is the pod-count headroom the
// earlier placements consumed. Output: assign [T] int32 (node or -1).
// Plain version: volcano_tpu_torch/ops/evict_kernels.py backfill_plain.
//
// The invariant: pod counts only rise, so for every signature the first
// node that still has pod room never moves backward. A cursor a signature
// replaces the per-task scan of the node axis.
//
// Design: one block, one launch.
// 1. Set-up, the whole block: each signature row of sig_mask becomes a
//    bitset (S x NW words, NW = ceil(N / 32); 16-byte loads of the flat
//    mask, a shared atomicOr a word touched), the headroom h = node_max -
//    node_cnt (clamped to [0, T + 1], which no run of T placements can
//    tell apart from the true value) and its room bitset (h > 0, warp
//    ballots), and each signature's static first node (its first set bit)
//    and cursor (the first node's word).
// 2. The tasks in order, on warp 0 alone, with no block barrier, 32 at a
//    time (lane k reads task t0 + k: the columns coalesced). A pad task
//    gives -1. A task with no pod, or any task without the pod check,
//    takes its row's static first node (one at a time; the last node's
//    headroom kept in registers). The pod tasks of one row, up to the next
//    real task of another kind or row (pads between take nothing), are a
//    run, placed at once: first fit gives them the row's nodes with room in
//    node order, each as many tasks as its headroom. So from the row's
//    cursor word (bits & room, kept in registers for the current row; a
//    warp ballot over 32 words at a time moves a spent cursor on), lane b
//    takes node 32 cw + b, its headroom where the bit is set, a warp scan
//    sums them, and each task of the run finds its node by a binary search
//    of those sums (5 shuffles); each node's headroom drops by the tasks it
//    took and a spent node's room bit clears. Lane 0 writes the shared
//    state (the run's lanes their own nodes' headroom) and a __syncwarp
//    precedes every read of it.
//
// Placements: the state (h, room, first, cursors, bitsets: 4 x (32 NW +
// NW + 2S + S NW) bytes, 49 KB at cfg4) lives in dynamic shared memory
// where it fits, else the same layout in global scratch the wrapper
// allocates (evict_backfill_scratch_bytes says which); the sizes choose.
//
// Bound: bytes (each input read once, assign written once), 0.0000634 ms
// at cfg4. One task at a time costs about 0.2 us of dependent warp
// instructions (an earlier build of this kernel: 0.415 ms at cfg4 on an
// H100); a run costs one scan and search a cursor word it spans, whatever
// its length.
//
// Built with -DK11_PROFILE, PROF(k) marks add thread 0's clock between
// marks to phase k's counter, PROF_UNITS(n) counts the tasks and two
// globaltimer reads bound the kernel's span (bench/kernel_profile.py
// --kernel k11 reads them).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#ifdef K11_PROFILE
constexpr int kProfPhases = 4;
__device__ long long k11_prof_t[kProfPhases + 1];
__shared__ long long k11_prof_s[kProfPhases + 1];
__shared__ long long k11_prof_last;
__device__ unsigned long long k11_prof_span[2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(k)                                                  \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      const long long now_ = clock64();                          \
      k11_prof_s[k] += now_ - k11_prof_last;                     \
      k11_prof_last = now_;                                      \
    }                                                            \
  } while (0)
#define PROF_UNITS(n)                                            \
  do {                                                           \
    if (threadIdx.x == 0) k11_prof_s[kProfPhases] += (n);        \
  } while (0)
#define PROF_START()                                             \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k11_prof_s[k_] = 0; \
      k11_prof_span[0] = gtime();                                \
      k11_prof_last = clock64();                                 \
    }                                                            \
  } while (0)
#define PROF_END()                                               \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      for (int k_ = 0; k_ <= kProfPhases; ++k_) k11_prof_t[k_] = k11_prof_s[k_]; \
      k11_prof_span[1] = gtime();                                \
    }                                                            \
  } while (0)
#else
#define PROF(k) do {} while (0)
#define PROF_UNITS(n) do {} while (0)
#define PROF_START() do {} while (0)
#define PROF_END() do {} while (0)
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int nw;          // bitset words a row
  size_t words;    // 32-bit words of the state
};

__host__ __device__ inline Layout layout(int N, int S) {
  Layout l;
  l.nw = (N + 31) / 32;
  l.words = (size_t)l.nw * 32 + l.nw + 2 * (size_t)S + (size_t)S * l.nw;
  return l;
}

struct Args {
  int N, S, T, check_pod;
  const uint8_t* sig_mask;
  const int* node_cnt;
  const int* node_max;
  const int* b_sig;
  const uint8_t* b_has_pod;
  const uint8_t* b_real;
  int* assign;
};

// ORs the set bytes of flat sig_mask positions [f, f + n) (all inside one
// chunk; f at row s, column c) into the bitsets
__device__ __forceinline__ void or_bits(uint32_t* bits, int nw, int N, const uint8_t* b,
                                        int n, long long f) {
  int s = (int)(f / N), c = (int)(f - (long long)s * N);
  int wi = -1;
  uint32_t acc = 0;
  for (int j = 0; j < n; ++j) {
    if (b[j]) {
      const int w = s * nw + (c >> 5);
      if (w != wi) {
        if (acc) atomicOr(&bits[wi], acc);
        wi = w;
        acc = 0;
      }
      acc |= 1u << (c & 31);
    }
    if (++c == N) {
      c = 0;
      ++s;
    }
  }
  if (acc) atomicOr(&bits[wi], acc);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) backfill_kernel(Args a, uint32_t* gstate) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* st = kShared ? smem : gstate;
  const int N = a.N, S = a.S, T = a.T;
  const Layout L = layout(N, S);
  const int NW = L.nw;
  int* h = (int*)st;
  uint32_t* room = st + (size_t)NW * 32;
  int* first = (int*)(room + NW);
  int* cur = first + S;
  uint32_t* bits = (uint32_t*)(cur + S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROF_START();

  // 1. set-up: the bitsets (zeroed, then the mask's set bytes ORed in)
  for (size_t i = tid; i < (size_t)S * NW; i += kThreads) bits[i] = 0;
  __syncthreads();
  {
    const long long total = (long long)S * N;
    const int mis = (int)((uintptr_t)a.sig_mask & 15);
    const long long chunks = (total + mis + 15) / 16;
    const uint4* base = (const uint4*)(a.sig_mask - mis);
    constexpr int U = 4;
    for (long long c0 = tid; c0 < chunks; c0 += (long long)kThreads * U) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long c = c0 + (long long)u * kThreads;
        const long long f = c * 16 - mis;
        v[u] = (c < chunks && f >= 0 && f + 16 <= total) ? __ldg(base + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long c = c0 + (long long)u * kThreads;
        if (c >= chunks) break;
        const long long f = c * 16 - mis;
        if (f >= 0 && f + 16 <= total) {
          or_bits(bits, NW, N, (const uint8_t*)&v[u], 16, f);
        } else {  // the ragged first or last chunk
          uint8_t b[16];
          const long long lo = f < 0 ? 0 : f, hi = f + 16 < total ? f + 16 : total;
          for (long long g = lo; g < hi; ++g) b[g - lo] = a.sig_mask[g];
          if (hi > lo) or_bits(bits, NW, N, b, (int)(hi - lo), lo);
        }
      }
    }
  }
  // the headroom and the room bitset (a warp covers 32 whole nodes)
  {
    constexpr int U = 4;
    const int span = NW * 32;
    for (int n0 = tid; n0 < span; n0 += kThreads * U) {
      int hv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int n = n0 + u * kThreads;
        hv[u] = 0;
        if (n < N) {
          const long long d = (long long)__ldg(&a.node_max[n]) - __ldg(&a.node_cnt[n]);
          hv[u] = d <= 0 ? 0 : (d > T ? T + 1 : (int)d);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int n = n0 + u * kThreads;
        if (n < span) {  // uniform across the warp
          h[n] = hv[u];
          const uint32_t bal = __ballot_sync(kFull, hv[u] > 0);
          if (lane == 0) room[n >> 5] = bal;
        }
      }
    }
  }
  __syncthreads();
  // each signature's first node and its cursor word, a warp a signature
  for (int s = warp; s < S; s += kWarps) {
    int f = -1;
    for (int w0 = 0; w0 < NW; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t v = w < NW ? bits[(size_t)s * NW + w] : 0u;
      const uint32_t bal = __ballot_sync(kFull, v != 0);
      if (bal) {
        const int l = __ffs(bal) - 1;
        const uint32_t vv = __shfl_sync(kFull, v, l);
        f = (w0 + l) * 32 + __ffs(vv) - 1;
        break;
      }
    }
    if (lane == 0) {
      first[s] = f;
      cur[s] = f < 0 ? NW : f >> 5;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  PROF(0);

  // 2. the tasks in order, on warp 0, 32 at a time (lane k holds task t0 + k)
  const bool check_pod = a.check_pod != 0;
  const uint32_t below = (1u << lane) - 1u;  // the lanes under this one
  int cs = -1, cw = NW;   // the cached row and its cursor word
  uint32_t word = 0;      // bits[cs][cw] & room[cw]
  int hn = -1, hval = 0;  // the last node a single task took, its headroom
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    int s = 0;
    bool real = false, pod = false;
    if (t < T) {
      s = __ldg(&a.b_sig[t]);
      pod = __ldg(&a.b_has_pod[t]) != 0;
      real = __ldg(&a.b_real[t]) != 0;
    }
    const bool runner = real && pod && check_pod;   // takes the cursor's node
    const uint32_t runners = __ballot_sync(kFull, runner);
    const uint32_t singles = __ballot_sync(kFull, real && !runner);
    uint32_t todo = runners | singles;             // pads stay -1
    int mine = -1;
    PROF_UNITS(T - t0 < 32 ? T - t0 : 32);
    PROF(1);
    while (todo) {
      const int i = __ffs(todo) - 1;
      const int si = __shfl_sync(kFull, s, i);
      if ((singles >> i) & 1u) {
        // a task with no pod (or no pod check): its row's first node
        const int node = first[si];
        PROF(2);
        if (node >= 0) {
          int hv;
          if (node == hn) {
            hv = hval;
          } else {
            __syncwarp();
            hv = h[node];
          }
          hv -= 1;
          hn = node;
          hval = hv;
          if (lane == 0) h[node] = hv;
          if (hv == 0) {
            const uint32_t bit = 1u << (node & 31);
            if (lane == 0) room[node >> 5] &= ~bit;
            if ((node >> 5) == cw) word &= ~bit;
          }
        }
        if (lane == i) mine = node;
        todo &= todo - 1;
        PROF(3);
        continue;
      }
      // a run: the pod tasks of row si from lane i up to the next real task
      // of another kind or row (pads between take nothing); first fit gives
      // them the row's nodes with room in node order, each node as many
      // tasks as its headroom
      const bool same = runner && s == si;
      const uint32_t from_i = ~((1u << i) - 1u);
      const uint32_t other = __ballot_sync(kFull, real && !same) & from_i;
      const uint32_t members = __ballot_sync(kFull, same) & from_i &
                               (other ? (other & (0u - other)) - 1u : kFull);
      const int cnt = __popc(members);
      const bool member = (members >> lane) & 1u;
      const int rank = __popc(members & below);
      if (si != cs) {
        __syncwarp();
        if (cs >= 0 && lane == 0) cur[cs] = cw;
        cs = si;
        cw = cur[si];
        word = cw < NW ? bits[(size_t)si * NW + cw] & room[cw] : 0u;
      }
      for (int done = 0; done < cnt;) {
        if (word == 0 && cw < NW) {  // the cursor word is spent: move on
          __syncwarp();
          for (int w0 = cw + 1;; w0 += 32) {
            if (w0 >= NW) {
              cw = NW;
              break;
            }
            const int w = w0 + lane;
            const uint32_t v = w < NW ? bits[(size_t)si * NW + w] & room[w] : 0u;
            const uint32_t bal = __ballot_sync(kFull, v != 0);
            if (bal) {
              const int l = __ffs(bal) - 1;
              cw = w0 + l;
              word = __shfl_sync(kFull, v, l);
              break;
            }
          }
        }
        PROF(2);
        if (word == 0) break;  // no node left: the rest stay -1
        // lane b holds node cw * 32 + b: its headroom where its bit is set,
        // the inclusive sum of those over the lanes up to b
        __syncwarp();
        const int nb = cw * 32 + lane;
        const int hb = (word >> lane) & 1u ? h[nb] : 0;
        int pre = hb;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(kFull, pre, off);
          if (lane >= off) pre += v;
        }
        const int total = __shfl_sync(kFull, pre, 31);
        const int take = cnt - done < total ? cnt - done : total;
        // a member's node: the first lane whose sum passes its place
        const int q = rank - done;
        int lo = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, pre, lo + step - 1) <= q) lo += step;
        if (member && q >= 0 && q < take) mine = cw * 32 + lo;
        // the nodes' new headroom; the spent ones leave room and the word
        const int before = pre - hb;
        const int tb = take <= before ? 0 : (take - before < hb ? take - before : hb);
        if (tb > 0) h[nb] = hb - tb;
        const uint32_t spent = __ballot_sync(kFull, tb > 0 && tb == hb);
        if (spent) {
          if (lane == 0) room[cw] &= ~spent;
          word &= ~spent;
        }
        done += take;
        PROF(3);
      }
      hn = -1;  // the run wrote headroom from many lanes
      todo &= ~members;
    }
    if (t < T) a.assign[t] = mine;
  }
  PROF_END();
}

// the dynamic shared memory a block may take (set once a process)
int max_dyn() {
  static std::mutex mu;
  static int m = -1;
  std::lock_guard<std::mutex> lock(mu);
  if (m < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, backfill_kernel<true>) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    const int want = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(backfill_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             want) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    m = want;
  }
  return m;
}

// the state's words (and so S x NW) stay below 2^30: int indices
bool valid(int N, int S, int T) {
  return N > 0 && S > 0 && T > 0 && N < (1 << 30) && S < (1 << 28) &&
         layout(N, S).words < ((size_t)1 << 30);
}

}  // namespace

// 0 when the state of a launch at these sizes fits in shared memory (the
// shared placement, no scratch), else the bytes of global scratch it
// takes (the global placement); -1 when the sizes are invalid or the
// device cannot be asked
extern "C" long long evict_backfill_scratch_bytes(int N, int S, int T) {
  if (!valid(N, S, T)) return -1;
  const int m = max_dyn();
  if (m < 0) return -1;
  const size_t bytes = layout(N, S).words * 4;
  return bytes <= (size_t)m ? 0 : (long long)bytes;
}

// sig_mask bool [S, N], node_cnt / node_max int32 [N], b_sig int32 [T],
// b_has_pod / b_real bool [T]: device pointers; scratch: the bytes
// evict_backfill_scratch_bytes gives (null when it gives 0); assign:
// int32 [T]. Launches on `stream`.
extern "C" int evict_backfill(int N, int S, int T, int check_pod, const void* sig_mask,
                              const void* node_cnt, const void* node_max,
                              const void* b_sig, const void* b_has_pod,
                              const void* b_real, void* scratch, void* assign,
                              void* stream) {
  const long long need = evict_backfill_scratch_bytes(N, S, T);
  if (need < 0) return (int)cudaErrorInvalidValue;
  if (need > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{N, S, T, check_pod, (const uint8_t*)sig_mask, (const int*)node_cnt,
         (const int*)node_max, (const int*)b_sig, (const uint8_t*)b_has_pod,
         (const uint8_t*)b_real, (int*)assign};
  if (need == 0) {
    const size_t bytes = layout(N, S).words * 4;
    backfill_kernel<true><<<1, kThreads, bytes, (cudaStream_t)stream>>>(a, nullptr);
  } else {
    backfill_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(a, (uint32_t*)scratch);
  }
  return (int)cudaGetLastError();
}

#ifdef K11_PROFILE
// the phases' cycles and the tasks of the last launch, then its two
// globaltimer marks (ns)
extern "C" int k11_profile_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k11_prof_t, sizeof(k11_prof_t));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + kProfPhases + 1, k11_prof_span,
                                   sizeof(k11_prof_span));
}
#endif
