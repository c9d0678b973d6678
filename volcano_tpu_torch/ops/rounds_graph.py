"""K7 on the card: one rounds solve as one CUDA graph replay.

Port of the device program volcano_tpu/ops/rounds.py:603-1130
(``solve_rounds_packed``: the round loop, the rollback fixpoint, the
straggler rounds, the tail pass and the pack, all one XLA program). The
solve is the flat step machine of ops/rounds.py (``StepMachine``), captured
once per bucket into one graph:

    head (state from the inputs, K7a decides the first step)
    WHILE a step is pending:
        IF round: the round body (IF full refresh / IF dirty columns,
            IF the coverage fallback)
        IF rollback: the rollback body
        IF tail: K7b, the whole tail pass in one launch
        K7a: fold the step's counters, decide the next step, set the WHILE
            condition
    finish (the gang strip, the residue marking, the pack)

PyTorch on the card offers no conditional-node capture, so the nodes come
from csrc/rounds_ctl.cu (``vt_cond_begin``/``vt_cond_end``): each body is
captured on a stream of its own into the node's body graph. Every buffer a
body touches lives in memory the graph owns: the inputs, the state and the
outputs are allocated from the graph's MemPool before the capture, the
temporaries of the bodies come from that pool during it (the allocator
routes this thread's allocations there), and the head's and finish's from
the graph's private pool. Nothing the graph reads is ever freed while it
exists, so no block is reused under it.

A solve copies its inputs into the graph's input buffers (device to device),
replays the graph and clones the outputs: nothing is read back. The packed
result carries the graph's status (the step cap's error bit, the steps,
how often each body ran) in ``devprof_status``; the one fetch reads it
beside the result (utils/devprof.py) and only then adds the launches:
for each body, the kernels captured in it times the times it ran.

Graphs are cached by the solve spec, every input's name, shape and dtype
(so every padded extent: T, J, K, N, R, the exclusion groups, queues,
namespaces, signatures) and the device: warm sessions of a bucket capture
nothing. A failed build, capture or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Dict, Tuple

import numpy as np
import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import rounds as R
from volcano_tpu_torch.ops import rounds_kernels as RK

# captures made, seconds spent in them (warm-up pass included), solves run
STATS = {"captures": 0, "capture_s": 0.0, "solves": 0}
_GRAPHS: Dict[tuple, "_Graph"] = {}
# nesting of the conditional bodies: WHILE, IF round, IF refresh/cover
_DEPTH = 3
_IF, _WHILE = 0, 1
# the capture stream and one stream a body depth, the graphs' own
_STREAMS: list = []


def _lib():
    from volcano_tpu_torch import _build

    lib = _build.library("rounds_ctl")
    lib.vt_cond_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.vt_cond_begin.restype = ctypes.c_int
    lib.vt_cond_end.argtypes = [ctypes.c_void_p]
    lib.vt_cond_end.restype = ctypes.c_int
    lib.vt_stream_create.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.vt_stream_create.restype = ctypes.c_int
    return lib


def _streams():
    """The capture stream and the body streams, created once: torch's own
    streams come from a shared pool, where a body's stream could turn out
    to be the stream under capture."""
    while len(_STREAMS) < 1 + _DEPTH:
        handle = ctypes.c_ulonglong()
        rc = _lib().vt_stream_create(ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"stream for the solve graph: CUDA error {rc}")
        _STREAMS.append(torch.cuda.ExternalStream(handle.value))
    return _STREAMS


def graph_key(spec, enc) -> tuple:
    """The cache key: spec, device and every input's (name, shape, dtype)."""
    ref = enc["cls_req"]
    return (spec, str(ref.device), tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in enc.items())))


def graphs_cached() -> int:
    return len(_GRAPHS)


class _Cond:
    """Conditional nodes of the graph being captured, by csrc/rounds_ctl.cu.
    ``counts`` keeps, per body, the kernel launches captured in it (nested
    bodies count in their own)."""

    def __init__(self):
        self.lib = _lib()
        self.streams = _streams()[1:]
        self.depth = 0
        self.counts: Dict[str, Dict[str, int]] = {}

    @contextlib.contextmanager
    def node(self, pred: torch.Tensor, body: str, kind: int):
        """Capture the body of an IF (or WHILE) node on ``pred`` (a bool on
        the card); yields the node's handle."""
        if self.depth >= _DEPTH:
            raise RuntimeError(f"conditional bodies nested deeper than {_DEPTH}")
        side = self.streams[self.depth]
        handle = ctypes.c_ulonglong()
        rc = self.lib.vt_cond_begin(
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            ctypes.c_void_p(side.cuda_stream), ctypes.c_void_p(pred.data_ptr()),
            kind, ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"conditional node for {body!r}: CUDA error {rc}")
        self.depth += 1
        try:
            with torch.cuda.stream(side), devmod.capture_sink() as sink:
                yield handle.value
            self.counts[body] = sink
        finally:
            self.depth -= 1
            rc = self.lib.vt_cond_end(ctypes.c_void_p(side.cuda_stream))
        if rc != 0:
            raise RuntimeError(f"end of the {body!r} body: CUDA error {rc}")

    def if_node(self, pred: torch.Tensor, body: str):
        return self.node(pred, body, _IF)


class _Graph:
    """The captured solve of one bucket: its pool, input, state and output
    buffers, and the graph."""

    def __init__(self, spec, enc):
        t0 = time.perf_counter()
        self.pool = torch.cuda.MemPool()
        with torch.cuda.use_mem_pool(self.pool):
            self.inp = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device)
                        for k, v in enc.items()}
        # the inputs by dtype: one multi-tensor copy a group on each solve
        self.groups: Dict[torch.dtype, list] = {}
        for k, v in self.inp.items():
            self.groups.setdefault(v.dtype, []).append(k)
            m = self.machine = R.StepMachine(spec, self.inp, "warm")
            self.status = torch.zeros(2 + len(R.BODIES), dtype=torch.int32,
                                      device=m.ctl.device)
        # one eager pass over every body: it loads every kernel library and
        # raises on any hidden host sync before the capture would
        self.copy_in(enc)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m.head()
            m.step()
            raw, packed = m.finish()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        with torch.cuda.use_mem_pool(self.pool):
            self.out = tuple(torch.empty_like(x) for x in raw)
            self.out_packed = torch.empty_like(packed)
        del raw, packed
        cond = _Cond()
        self.graph = torch.cuda.CUDAGraph()
        m.mode, m.cond = "capture", cond
        with torch.cuda.graph(self.graph, stream=_streams()[0],
                              capture_error_mode="thread_local"):
            with torch.cuda.use_mem_pool(self.pool):
                with devmod.capture_sink() as self.head_counts:
                    m.head()
                with cond.node(m.pred[RK.P_ACTIVE], "step", _WHILE) as handle:
                    m.hits[R.BODIES.index("step")] += 1
                    m.while_handle = handle
                    m.step()
                    m.while_handle = None
                raw, packed = m.finish()
                for o, x in zip(self.out, raw):
                    o.copy_(x)
                self.out_packed.copy_(packed)
                self.status[0] = m.ctl[RK.C_ERR]
                self.status[1] = m.ctl[RK.C_STEPS]
                self.status[2:] = m.hits
        self.body_counts = cond.counts
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0

    def copy_in(self, enc) -> None:
        for names in self.groups.values():
            torch._foreach_copy_([self.inp[k] for k in names],
                                 [enc[k] for k in names])

    def on_status(self, status: np.ndarray) -> None:
        """The fetched status: raise on the step cap, count the launches."""
        if status[0]:
            raise RuntimeError("rounds solve: the step machine hit its step "
                               "cap (a controller fault)")
        devmod.add_launches(self.head_counts)
        for i, body in enumerate(R.BODIES):
            if body in self.body_counts and status[2 + i]:
                devmod.add_launches(self.body_counts[body], int(status[2 + i]))

    def run(self, enc) -> Tuple[tuple, torch.Tensor]:
        self.copy_in(enc)
        self.graph.replay()
        raw = tuple(o.clone() for o in self.out)
        packed = self.out_packed.clone()
        packed.devprof_status = (self.status.clone(), self.on_status)
        STATS["solves"] += 1
        return raw, packed


def solve(spec, enc):
    """(raw, packed) of one solve by the bucket's graph, capturing it on
    the bucket's first solve."""
    key = graph_key(spec, enc)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _Graph(spec, enc)
    return g.run(enc)
