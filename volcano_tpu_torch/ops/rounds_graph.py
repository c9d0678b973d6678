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

A solve is one call into csrc/rounds_ctl.cu (``vt_launch``): it copies
the encode's inputs into the graph's input buffers (one kernel over the
copy list ``sources`` builds), launches the graph, copies the packed
result and the graph's status (the step cap's error bit, the steps, how
often each body ran), which share one device block, into a pinned host
block of the graph's, and records an event behind that copy: nothing is
read back. The scheduler's dispatch (``dispatch``) returns that copy's
handle (``Fetch``); its copy list is built ahead in the prepare
(``bind``) once the bucket's graph exists, so the dispatch holds the
host for that one call. ``solve`` also clones the packed result on the
device, and the raw outputs for a caller that asks for them. The one
fetch waits on the event (utils/devprof.py), and only then are the
launches added: for each body, the kernels captured in it times the
times it ran.

Graphs are cached by the solve spec, every input's name, shape and dtype
(so every padded extent: T, J, K, N, R, the exclusion groups, queues,
namespaces, signatures) and the device: warm sessions of a bucket capture
nothing. A failed build, capture or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

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
    lib.vt_copy_in.argtypes = [ctypes.POINTER(_CopyList), ctypes.c_void_p]
    lib.vt_launch.argtypes = [ctypes.POINTER(_CopyList), ctypes.c_ulonglong, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                              ctypes.c_void_p]
    lib.vt_event_create.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.vt_event_sync.argtypes = lib.vt_event_destroy.argtypes = [ctypes.c_ulonglong]
    for fn in (lib.vt_copy_in, lib.vt_launch, lib.vt_event_create, lib.vt_event_sync,
               lib.vt_event_destroy):
        fn.restype = ctypes.c_int
    return lib


# the most inputs a solve's copy list holds (csrc/rounds_ctl.cu kMaxCopies)
_MAX_COPIES = 128


class _CopyList(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p * _MAX_COPIES),
                ("dst", ctypes.c_void_p * _MAX_COPIES),
                ("bytes", ctypes.c_longlong * _MAX_COPIES), ("n", ctypes.c_int)]


class _Done:
    """An event of the graph's that vt_launch records behind a solve's
    copy to the host (what devprof waits on); destroyed with this object."""

    __slots__ = ("lib", "ev")

    def __init__(self, lib):
        ev = ctypes.c_ulonglong()
        rc = lib.vt_event_create(ctypes.byref(ev))
        if rc != 0:
            raise RuntimeError(f"rounds solve: CUDA error {rc} creating an event")
        self.lib, self.ev = lib, ev.value

    def synchronize(self) -> None:
        rc = self.lib.vt_event_sync(self.ev)
        if rc != 0:
            raise RuntimeError(f"rounds solve: CUDA error {rc} waiting on its result")

    def __del__(self):
        if getattr(self, "ev", None):
            self.lib.vt_event_destroy(self.ev)


class Fetch:
    """One solve's packed result on its way to the host: the graph's pinned
    block its copy goes to and the event behind that copy, in
    ``devprof_fetch`` for utils/devprof.py's fetch (``read`` gives the
    packed result as a numpy array, once). A fetch read or dropped unread
    (a discarded stage) gives its block and event back to the graph; a
    dropped one's event is waited on before the block is written again."""

    def __init__(self, g: "_Graph", host: torch.Tensor, done: _Done):
        self.g, self.host, self.done = g, host, done
        self.fin = weakref.finalize(self, g.free.append, (host, done, True))

    @property
    def devprof_fetch(self):
        return self.done, self.read

    def read(self) -> np.ndarray:
        g, host = self.g, self.host
        out = host[:g.packed_bytes].view(g.out_packed.dtype).numpy().copy()
        status = host[g.status_at:].view(torch.int32).numpy().copy()
        if self.fin.detach() is not None:
            g.free.append((host, self.done, False))
        g.on_status(status)
        return out


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
    return (spec, enc["cls_req"].device,
            tuple((k, enc[k].shape, enc[k].dtype) for k in sorted(enc)))


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
        self.lib = _lib()
        self.device = enc["cls_req"].device
        with torch.cuda.use_mem_pool(self.pool):
            self.inp = {k: torch.empty(v.shape, dtype=v.dtype, device=v.device)
                        for k, v in enc.items()}
        # the inputs' copy list (vt_launch): destinations and sizes here,
        # the sources of each solve's encode in a copy of it (sources())
        self.names = sorted(self.inp)
        if len(self.names) > _MAX_COPIES:
            raise ValueError(f"rounds solve: {len(self.names)} inputs, more than "
                             f"the graph's copy list holds ({_MAX_COPIES})")
        self.copies = _CopyList(n=len(self.names))
        for j, k in enumerate(self.names):
            self.copies.dst[j] = self.inp[k].data_ptr()
            self.copies.bytes[j] = self.inp[k].numel() * self.inp[k].element_size()
        m = self.machine = R.StepMachine(spec, self.inp, "warm")
        # one eager pass over every body: it loads every kernel library and
        # raises on any hidden host sync before the capture would
        lst, keep = self.sources(enc)
        rc = self.lib.vt_copy_in(ctypes.byref(lst), devmod.raw_stream(self.device))
        if rc != 0:
            raise RuntimeError(f"rounds solve: copying its inputs in: CUDA error {rc}")
        del keep
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m.head()
            m.step()
            raw, packed = m.finish()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        # the packed result, then (4-byte aligned) the status: one block,
        # fetched by one copy
        n_packed = packed.numel() * packed.element_size()
        at = -(-n_packed // 4) * 4
        n_status = 2 + len(R.BODIES)
        with torch.cuda.use_mem_pool(self.pool):
            self.out = tuple(torch.empty_like(x) for x in raw)
            self.block = torch.empty(at + 4 * n_status, dtype=torch.uint8,
                                     device=packed.device)
        self.out_packed = self.block[:n_packed].view(packed.dtype)
        self.status = self.block[at:].view(torch.int32)
        self.packed_bytes, self.status_at = n_packed, at
        # pinned host blocks no fetch holds, each with the event of its
        # last copy when its fetch was dropped unread (else None)
        self.free: list = []
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
        self.exec = self.graph.raw_cuda_graph_exec()
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0

    def sources(self, enc) -> Tuple[_CopyList, list]:
        """The copy list of ``enc``'s inputs into the graph's, and the
        contiguous copies of strided inputs it points to (keep them alive
        until the launch)."""
        lst = _CopyList.from_buffer_copy(self.copies)
        keep = []
        for j, k in enumerate(self.names):
            v = enc[k]
            if not v.is_contiguous():
                v = v.contiguous()
                keep.append(v)
            lst.src[j] = v.data_ptr()
        return lst, keep

    def on_status(self, status: np.ndarray) -> None:
        """The fetched status: raise on the step cap, count the launches."""
        if status[0]:
            raise RuntimeError("rounds solve: the step machine hit its step "
                               "cap (a controller fault)")
        devmod.add_launches(self.head_counts)
        for i, body in enumerate(R.BODIES):
            if body in self.body_counts and status[2 + i]:
                devmod.add_launches(self.body_counts[body], int(status[2 + i]))

    def launch(self, lst: _CopyList) -> Fetch:
        """One call (csrc/rounds_ctl.cu vt_launch): copy the sources of
        ``lst`` in, launch the graph, copy the packed result and status
        to a pinned host block and record the fetch's event behind it."""
        if self.free:
            host, done, dropped = self.free.pop()
            if dropped:
                done.synchronize()
        else:
            host = torch.empty(self.block.shape, dtype=torch.uint8, pin_memory=True)
            done = _Done(self.lib)
        fetch = Fetch(self, host, done)
        rc = self.lib.vt_launch(ctypes.byref(lst), self.exec, host.data_ptr(),
                                self.block.data_ptr(), self.block.numel(), done.ev,
                                devmod.raw_stream(self.device))
        if rc != 0:
            raise RuntimeError(f"rounds solve: launching its graph: CUDA error {rc}")
        STATS["solves"] += 1
        return fetch

    def run(self, enc, raw: bool = True) -> Tuple[tuple, torch.Tensor]:
        lst, keep = self.sources(enc)
        fetch = self.launch(lst)
        del keep
        packed = self.out_packed.clone()
        packed.devprof_fetch = fetch.devprof_fetch
        return (tuple(o.clone() for o in self.out) if raw else None), packed


def _graph(spec, enc) -> _Graph:
    """The bucket's graph, captured on the bucket's first solve."""
    key = graph_key(spec, enc)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _Graph(spec, enc)
    return g


def solve(spec, enc, raw: bool = True):
    """(raw, packed) of one solve by the bucket's graph; raw is None
    unless asked for."""
    return _graph(spec, enc).run(enc, raw)


class Bound(NamedTuple):
    """An encode bound to its bucket's graph (``bind``): the graph, the
    copy list of the encode's inputs, the copies it points to."""
    graph: _Graph
    copies: _CopyList
    keep: list


def bind(spec, enc) -> Optional[Bound]:
    """``enc``'s copy list into its bucket's graph, when the graph exists
    (None before the bucket's first solve, which captures it): the host
    work of a solve that can come before its dispatch."""
    g = _GRAPHS.get(graph_key(spec, enc))
    return None if g is None else Bound(g, *g.sources(enc))


def dispatch(spec, enc, bound: Optional[Bound] = None) -> Fetch:
    """One solve with its packed result only on its way to the host (no
    device copy of it kept): the scheduler's dispatch. With ``bound``
    (``bind``'s result for this encode) it is one call to the card's
    runtime."""
    if bound is None:
        g = _graph(spec, enc)
        bound = Bound(g, *g.sources(enc))
    return bound.graph.launch(bound.copies)
