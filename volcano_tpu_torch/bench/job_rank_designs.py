"""K6's job ranks, two designs on the card: the tile design the rounds
solve runs (csrc/job_rank.cu: tile sorts, then each key searched in every
sorted tile; two launches) against a one-CTA design (every packed key in
one CTA's shared memory, one bitonic sort, rank and order written from
the sorted keys; one launch, no scratch). The one-CTA design holds at
most 8,192 keys of 24 bytes (14,563 of 16) in the 227 KB a CTA may have,
and the job axis has no such bound, so it is measured here and not used.

The one-CTA source below includes csrc/job_rank.cu for its key build, so
both designs pack the same keys. Each design is held equal (torch.equal)
to ``rounds_kernels.job_rank_plain`` and timed as 20 calls in a CUDA
graph (chip_smoke.graph_ms's method) at the job counts the main path
gives K6 (bench/round_cases.py RANK_SHAPES: cfg5 8,192, cfg2 2,048, cfg6
4,096) under cfg5's tiers and cfg2's, in float32. One JSON line a case.

On a machine with an NVIDIA GPU:

    python -m volcano_tpu_torch.bench.job_rank_designs
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

ONE_CTA_SRC = r"""
#include "job_rank.cu"

namespace {

template <int NW, typename F>
__global__ void __launch_bounds__(1024) job_rank_one_cta_kernel(RankArgs a, int jp) {
  extern __shared__ unsigned long long sk[];  // [jp][NW]
  const int nt = blockDim.x;
  for (int e = threadIdx.x; e < jp; e += nt) {
    Key<NW> k;
#pragma unroll
    for (int i = 0; i < NW; ++i) k.w[i] = ~0ull;  // padding sorts last
    if (e < a.J) k = job_key<NW, F>(a, e);
#pragma unroll
    for (int i = 0; i < NW; ++i) sk[e * NW + i] = k.w[i];
  }
  __syncthreads();
  for (int size = 2; size <= jp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < jp / 2; p += nt) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int m = i + stride;
        Key<NW> x, y;
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          x.w[q] = sk[i * NW + q];
          y.w[q] = sk[m * NW + q];
        }
        if (less(y, x) == ((i & size) == 0)) {
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            sk[i * NW + q] = y.w[q];
            sk[m * NW + q] = x.w[q];
          }
        }
      }
      __syncthreads();
    }
  }
  const unsigned long long idx_mask =
      a.idx_bits == 64 ? ~0ull : ((1ull << a.idx_bits) - 1ull);
  for (int p = threadIdx.x; p < a.J; p += nt) {
    const int j = (int)(sk[p * NW + NW - 1] & idx_mask);
    a.rank[j] = p;
    a.order[p] = j;
  }
}

template <int NW, typename F>
int launch_one_cta(const RankArgs* a, cudaStream_t s) {
  int jp = 1;
  while (jp < a->J) jp <<= 1;
  const size_t smem = (size_t)jp * NW * 8;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(job_rank_one_cta_kernel<NW, F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = jp / 2 < 1024 ? (jp / 2 < 32 ? 32 : jp / 2) : 1024;
  job_rank_one_cta_kernel<NW, F><<<1, threads, smem, s>>>(*a, jp);
  return (int)cudaGetLastError();
}

template <typename F>
int one_cta(const RankArgs* a, cudaStream_t s) {
  if (a->words == 2) return launch_one_cta<2, F>(a, s);
  if (a->words == 3) return launch_one_cta<3, F>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int job_rank_one_cta_f32(const RankArgs* a, cudaStream_t s) {
  return one_cta<float>(a, s);
}
extern "C" int job_rank_one_cta_f64(const RankArgs* a, cudaStream_t s) {
  return one_cta<double>(a, s);
}
"""


def _one_cta_lib() -> ctypes.CDLL:
    """Build the one-CTA design beside the kernels (csrc/build/) and load it."""
    from volcano_tpu_torch import _build

    os.makedirs(_build.BUILD, exist_ok=True)
    src = os.path.join(_build.BUILD, "job_rank_one_cta.cu")
    out = os.path.join(_build.BUILD, "libjob_rank_one_cta.so")
    with open(src, "w") as fh:
        fh.write(ONE_CTA_SRC)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", out, src], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    for name in ("job_rank_one_cta_f32", "job_rank_one_cta_f64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
    return lib


def one_cta_rank(lib, spec, cols, job_placed, job_alloc):
    """(rank, order) of the one-CTA design: the wrapper's arguments."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import rounds_kernels as RK

    j, r = job_alloc.shape
    dt = job_alloc.dtype
    codes = [RK.JOB_KEY_CODES[k] for k in spec.job_order_keys if k in RK.JOB_KEY_CODES]
    n_keys = len(codes)
    codes += [-1] * (3 - n_keys)
    rank = torch.empty(j, dtype=torch.int32, device=job_placed.device)
    order = torch.empty(j, dtype=torch.int64, device=job_placed.device)
    a = RK._RankArgs(
        priority=cols["job_priority"].data_ptr(), ready_base=cols["job_ready_base"].data_ptr(),
        min_available=cols["job_min_available"].data_ptr(),
        tie_rank=cols["job_tie_rank"].data_ptr(), placed=job_placed.data_ptr(),
        alloc=job_alloc.data_ptr(), drf_total=cols["drf_total"].data_ptr(),
        drf_present=cols["drf_present"].data_ptr(), scratch=None,
        rank=rank.data_ptr(), order=order.data_ptr(), J=j, R=r, n_keys=n_keys,
        key0=codes[0], key1=codes[1], key2=codes[2],
        idx_bits=max(1, (j - 1).bit_length()), words=RK.rank_words(spec, j, dt))
    fn = lib.job_rank_one_cta_f64 if dt == torch.float64 else lib.job_rank_one_cta_f32
    rc = fn(ctypes.byref(a), ctypes.c_void_p(devmod.raw_stream(job_placed.device)))
    if rc != 0:
        raise RuntimeError(f"one-CTA job ranks: CUDA error {rc}")
    return rank, order


def graph_ms(fn, reps=20, replays=5) -> float:
    """A call's device time: ``reps`` calls captured into one CUDA graph,
    replayed once to warm and ``replays`` times under CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> int:
    from volcano_tpu_torch.bench import round_cases as RC
    from volcano_tpu_torch.ops import rounds_kernels as RK

    if not torch.cuda.is_available():
        raise SystemExit("job_rank_designs: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    lib = _one_cta_lib()
    dt = torch.float32
    for seed, (cfg, j) in enumerate(RC.RANK_SHAPES):
        for keys in (("priority", "gang", "drf"), ("priority", "gang")):
            args = RC.rank_args(RC.rank_inputs(40 + seed, j), keys, "cuda", dt)
            want = RK.job_rank_plain(*args)
            for design, fn in (("tiles (csrc/job_rank.cu)", lambda: RK.job_rank(*args)),
                               ("one CTA", lambda: one_cta_rank(lib, *args))):
                got = fn()
                equal = all(torch.equal(a, b) for a, b in zip(got, want))
                if not equal:
                    raise AssertionError(f"{design} at {cfg}: differs from plain")
                print(json.dumps({"k6_design": design, "card": card, "shape": cfg,
                                  "J": j, "keys": "/".join(keys),
                                  "words": RK.rank_words(args[0], j, dt),
                                  "ms": graph_ms(fn), "equal_to_plain": equal}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
