"""Chip smoke test of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py               # full scale: cfg2, cfg3, cfg5, cfg4
    python3 chip_smoke.py --scale 0.05  # cfg2/3/5 smaller; cfg4 stays full

Phases, each failing the run on any error:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel under volcano_tpu_torch/csrc, one nvcc per source, in
   parallel;
2. kernel phase (allocate): one cfg5 allocate session on the card records
   the first input each kernel wrapper sees on that path (K1 score_block
   full and dirty-column, K2 window_topk, K4 resolve_prefix, K5
   queue_budget); each kernel is then held against its plain PyTorch
   version on those inputs with torch.equal (exact), and both are timed
   with CUDA events; the same session times the rounds solver's torch-op
   parts (K2b, K3, K6) with CUDA events around each call;
3. reference check: small sessions in float64 on the card give the same
   binds (and, for the eviction sessions, the same evictions in order) as
   the same sessions on the CPU (plain versions): cfg5, and cfg4 and the
   reclaim path in rounds mode, which run the fused session chain on both
   sides; and a cfg4 session whose preempt op log is cut to 8 rows trips
   K9's log budget on the card, once on the per-action path
   (VOLCANO_TPU_FUSE=0) and once inside the fused chain (the rerun owns
   preempt and reclaim), falls back to preempt's serial walk (recorded in
   the profile and the fallback counter) and still gives the CPU's binds
   and evictions;
4. session phase: cfg2 (5k x 1k), cfg3 (20k x 5k) and cfg5 (50k x 10k)
   through build_config -> open_session -> run_actions(["allocate"]) ->
   close_session, twice each; then cfg4 (30k x 8k) and the reclaim path
   (an overcommitted two-queue cluster of cfg4's width under the
   reclaim-tier conf, where reclaim evicts: cfg4's preempt pipelines every
   pending task, so its reclaim has nothing to do) through
   run_actions(["allocate", "backfill", "preempt", "reclaim"]), twice on
   the fused session chain and once more on the per-action path
   (VOLCANO_TPU_FUSE=0), each on a fresh cache with tpuscore on cuda.
   Launch counters are zeroed just before each run and read just after:
   every kernel of the path must have launched (K1/K2/K4/K5 everywhere;
   on a fused run K13 fuse_heaps twice, the fused K9 and K10 once each and
   K11 once where backfill has work, and no per-action K9/K10; on the
   per-action run K9 and K11 on cfg4, K9 and K10 on the reclaim path, and
   no fused kernel), and no eviction kernel on the allocate-only configs.
   Every bind must be feasible, no node over capacity (evicted victims
   released), every gang whole, every eviction a lower-priority victim or
   one in an over-deserved queue, each eviction plan consumed without
   fallback, every fused run fused all four stages, and all runs of a
   config must give the same binds and the same evictions in order;
5. kernel phase (eviction): K9 evict_preempt and K11 evict_backfill on
   the inputs the per-action cfg4 run handed them, K10 evict_reclaim on
   those of the per-action reclaim-path run; K13's two entries on the
   inputs of the first fused cfg4 run and of the first fused reclaim-path
   run, the fused K9 on the first fused cfg4 run's and the fused K10 on
   the first fused reclaim-path run's; each held against its plain
   version with torch.equal (the packed int32 result, K13's every output,
   the fused K9's every carry tensor; float32 state), and timed.

The last two lines of standard output are a {"kernels": [...]} JSON object
and {"ok": true, "device": {...}}. Without a usable GPU, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

MEM_BPS = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


RECLAIM_TIERS = (["priority"], ["gang", "proportion", "predicates", "nodeorder"])
EVICT_ACTIONS = ("allocate", "backfill", "preempt", "reclaim")


def reclaim_path_cluster(scale):
    """The reclaim path: cfg4's node shape (8k nodes of 4 cpu / 8Gi) packed
    on both dimensions by a running fill of queue-a (weight 1, gangs of 4
    with minMember 2), and 1.2k pending gangs of two 2-cpu/4Gi tasks in
    queue-b (weight 3), whose deserved share is unmet while queue-a runs
    above its own: preempt finds no victims inside queue-b, and reclaim
    evicts from queue-a."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_pod, build_pod_group, build_queue,
        build_resource_list_with_pods)

    nodes = max(int(8000 * scale), 8)
    n_jobs = max(int(1200 * scale), 4)
    c = make_cache()
    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("4", "8Gi", pods=64)))
    c.add_queue(build_queue("queue-a", weight=1))
    c.add_queue(build_queue("queue-b", weight=3))
    for g in range(nodes):
        pg = f"run-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=2,
                                        queue="queue-a"))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", f"node-{(g * 4 + i) % nodes:05d}",
                objects.POD_PHASE_RUNNING, {"cpu": "1000m", "memory": "2Gi"},
                pg, priority=1))
    for g in range(n_jobs):
        pg = f"rb-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=1,
                                        queue="queue-b"))
        for i in range(2):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "2000m", "memory": "4Gi"}, pg, priority=10))
    return c, nodes * 4 + n_jobs * 2


def run_session(cfg, scale, device, dtype, fuse=True):
    """One session of a bench config (or "reclaim", the reclaim path)
    through the port's normal entry, on the fused session chain or (``fuse``
    False: VOLCANO_TPU_FUSE=0) the per-action path; returns (cache,
    profile, launches, n_tasks, wall_s, action_ms, before) where
    ``before`` is what the checks need of the cluster as the session
    opened. The profile's "session_devprof" holds the device counters of
    the whole run_actions call."""
    import os

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    from volcano_tpu_torch.utils import devprof

    if cfg == "reclaim":
        cache, n_tasks = reclaim_path_cluster(scale)
        tier_names, actions = RECLAIM_TIERS, EVICT_ACTIONS
    else:
        cache, _, _, actions, n_tasks = build_config(cfg, scale)
        tier_names = CONFIGS[cfg].tiers
    tiers = make_tiers(["tpuscore"], *tier_names, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    before = snapshot(cache)
    if device == "cuda":
        torch.cuda.synchronize()
    counters = {}
    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "1" if fuse else "0"
    devmod.reset_launches()
    t0 = time.perf_counter()
    try:
        ssn = open_session(cache, tiers)
        before["over_deserved"] = over_deserved(ssn)
        with devprof.session(counters):
            action_ms = run_actions(ssn, list(actions))
        prof = dict(ssn.plugins["tpuscore"].profile, session_devprof=counters)
        close_session(ssn)
    finally:
        if prev is None:
            del os.environ["VOLCANO_TPU_FUSE"]
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return cache, prof, devmod.launches(), n_tasks, wall, action_ms, before


def snapshot(cache):
    """The running tasks (node, request) and the highest pending priority
    of each queue, as the session opens."""
    from volcano_tpu_torch.api.types import TaskStatus

    running, top_pending = {}, {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            key = f"{t.namespace}/{t.name}"
            if t.status == TaskStatus.RUNNING and t.node_name:
                running[key] = (t.node_name, t.resreq.clone())
            elif t.status == TaskStatus.PENDING:
                top_pending[job.queue] = max(top_pending.get(job.queue, t.priority),
                                             t.priority)
    return {"running": running, "top_pending": top_pending}


def over_deserved(ssn):
    """Queues whose allocation exceeds their deserved share at open."""
    prop = ssn.plugins.get("proportion")
    if prop is None:
        return set()
    return {q for q, a in prop.queue_opts.items()
            if not a.allocated.less_equal(a.deserved)}


def check_binds(cache, cfg, before=None):
    """Feasibility, capacity and gang atomicity of the FakeBinder result.
    Capacity counts the tasks running at open that were not evicted (an
    evicted victim's request is released) plus every bind."""
    from volcano_tpu_torch.api.resource import Resource

    binds = cache.binder.binds
    evicted = set(cache.evictor.evicts)
    tasks = {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            tasks[f"{t.namespace}/{t.name}"] = (job, t)
    per_node = {}
    per_job = {}
    for key, (node_name, req) in (before or {}).get("running", {}).items():
        if key not in evicted:
            per_node.setdefault(node_name, []).append(req)
    for key, node_name in binds.items():
        job, t = tasks[key]
        per_node.setdefault(node_name, []).append(t.resreq)
        per_job[job.uid] = per_job.get(job.uid, 0) + 1
    for node_name, reqs in per_node.items():
        node = cache.nodes[node_name]
        total = Resource.empty()
        for r in reqs:
            total.add(r)
        if not total.less_equal(node.allocatable):
            raise AssertionError(f"cfg{cfg}: node {node_name} over capacity")
        if len(reqs) > node.allocatable.max_task_num:
            raise AssertionError(f"cfg{cfg}: node {node_name} over its pod count")
    for uid, n in per_job.items():
        if n < cache.jobs[uid].min_available:
            raise AssertionError(f"cfg{cfg}: gang {uid} bound {n} < min")


def check_evicts(cache, cfg, before):
    """Every eviction took a victim running at open, of lower priority
    than a task pending in its queue (preempt) or in a queue above its
    deserved share (reclaim), and no task was evicted twice."""
    tasks = {}
    for job in cache.jobs.values():
        for t in job.tasks.values():
            tasks[f"{t.namespace}/{t.name}"] = (job, t)
    evicts = cache.evictor.evicts
    if len(set(evicts)) != len(evicts):
        raise AssertionError(f"cfg{cfg}: a task was evicted twice")
    for key in evicts:
        if key not in before["running"]:
            raise AssertionError(f"cfg{cfg}: evicted {key} was not running")
        job, t = tasks[key]
        lower = t.priority < before["top_pending"].get(job.queue, t.priority)
        if not (lower or job.queue in before["over_deserved"]):
            raise AssertionError(
                f"cfg{cfg}: evicted {key} (priority {t.priority}, queue "
                f"{job.queue}) is neither lower-priority nor over-deserved")


def capture_inputs():
    """Wrap the rounds solver's kernel wrappers so the first call of each
    (and the first dirty-column K1 call) keeps a copy of its inputs."""
    from volcano_tpu_torch.ops import rounds

    seen = {}
    real = {n: getattr(rounds, n) for n in
            ("score_block", "window_topk", "resolve_prefix", "queue_budget")}

    def cl(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def wrap(name):
        def fn(*args, **kw):
            key = name
            if name == "score_block":
                key = "score_block_cols" if kw.get("cols") is not None else name
            if key not in seen:
                seen[key] = ([cl(a) for a in args], {k: cl(v) for k, v in kw.items()})
            return real[name](*args, **kw)
        return fn

    for name in real:
        setattr(rounds, name, wrap(name))

    def restore():
        for name, f in real.items():
            setattr(rounds, name, f)
    return seen, restore


# the rounds solver's parts that stay torch ops (ROADMAP Queue 2 K2b, K3,
# K6) and its host-driven loop (K7): counted on the cfg5 session
TORCH_OP_ROWS = {
    "K2b": ("_cap_walk", "_nominate_full"),
    "K3": ("_select",),
    "K6": ("_job_rank", "_rank_in_class", "_excl_grank"),
    "K7": ("solve_rounds",),
}


def tensor_bytes(x, dicts=False):
    if isinstance(x, torch.Tensor):
        return nbytes(x)
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v, dicts) for v in x)
    if dicts and isinstance(x, dict):
        return sum(tensor_bytes(v, dicts) for v in x.values())
    return 0


def count_torch_ops():
    """Wrap the torch-op rows' functions: calls per session, CUDA events
    around each call (the span on the stream from its first launch to its
    last), and the bytes of the first call's tensor arguments and results
    (solve_rounds: with the whole encode it reads; the others: without
    the encoded fields they read, so their bound is a lower one)."""
    from volcano_tpu_torch.ops import rounds

    calls, first, events = {}, {}, {}
    real = {n: getattr(rounds, n) for ns in TORCH_OP_ROWS.values() for n in ns}

    def wrap(name):
        def fn(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            events.setdefault(name, []).append((start, end))
            calls[name] = calls.get(name, 0) + 1
            if name not in first:
                whole = name == "solve_rounds"
                first[name] = tensor_bytes(args, whole) \
                    + tensor_bytes(list(kw.values()), whole) + tensor_bytes(out, whole)
            return out
        return fn

    for name in real:
        setattr(rounds, name, wrap(name))

    def restore():
        for name, f in real.items():
            setattr(rounds, name, f)
    return calls, first, events, restore


def kernel_phase(scale):
    """Hold every kernel against its plain version on cfg5 main-path
    inputs; time both. Returns the kernel records (launches filled later)."""
    from volcano_tpu_torch.ops import kernels as K
    from volcano_tpu_torch.ops import rounds_kernels as RK

    seen, restore = capture_inputs()
    try:
        run_session(5, scale, "cuda", "float32")
        src = {k: "cfg5" for k in seen}
        if "score_block_cols" not in seen:
            # cfg5 placed everything before any dirty-column rescore: take
            # that variant's inputs from cfg2's path, which rescores
            run_session(2, scale, "cuda", "float32")
    finally:
        restore()
    # the torch-op rows on a second, warm cfg5 session (the first one pays
    # the process's lazy CUDA set-up inside its first calls)
    calls, first, events, restore_ops = count_torch_ops()
    try:
        run_session(5, scale, "cuda", "float32")
    finally:
        restore_ops()
    torch.cuda.synchronize()
    rows = {}
    for row, names in TORCH_OP_ROWS.items():
        byts = sum(first.get(n, 0) for n in names)
        spans = [a.elapsed_time(b) for n in names for a, b in events.get(n, ())]
        rows[row] = {"functions": list(names),
                     "launches": sum(calls.get(n, 0) for n in names),
                     "ms_per_session": sum(spans),
                     "ms_per_call": sum(spans) / max(len(spans), 1),
                     "bytes": byts, "bound_ms": byts / MEM_BPS * 1e3,
                     "bound_by": "bytes"}
    print(json.dumps({"torch_op_rows": rows, "session": "cfg5 (warm)"}), flush=True)
    missing = {"score_block", "window_topk", "resolve_prefix",
               "queue_budget"} - set(seen)
    if missing:
        raise AssertionError(f"cfg5 path never called {sorted(missing)}")
    records = []

    # K1, full and (when the path reached it) dirty-column
    for key in ("score_block", "score_block_cols"):
        if key not in seen:
            log(f"kernel phase: {key} not reached on the cfg5 path")
            continue
        (spec, enc, idle, used, cnt, occ, out), kw = seen[key]
        cols = kw.get("cols")
        k_rows, n = enc["cls_req"].shape[0], idle.shape[0]
        base = torch.full((k_rows, n), 7.0, dtype=idle.dtype, device=idle.device)
        got = base.clone()
        K.score_block(spec, enc, idle, used, cnt, occ, got, cols=cols)
        block = K.score_block_plain(spec, enc, idle, used, cnt, occ, cols)
        want = base.clone()
        if cols is None:
            want.copy_(block)
        else:
            want[:, cols.long()] = block
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{key}: kernel != plain at {bad} cells")
        m = n if cols is None else cols.shape[0]
        dt = idle.dtype
        r = idle.shape[1]
        col_bytes = m * (3 * r * idle.element_size() + 8
                         + enc["sig_mask"].shape[0] * (1 + idle.element_size()))
        byts = nbytes(*(enc[x] for x in ("cls_req", "cls_initreq", "cls_sig",
                                         "cls_nz_cpu", "cls_nz_mem",
                                         "cls_has_pod"))) \
            + col_bytes + k_rows * m * idle.element_size() \
            + (0 if cols is None else nbytes(cols))
        ops = k_rows * m * (30 + 12 * r)
        scratch = base.clone()
        ms = time_ms(lambda: K.score_block(spec, enc, idle, used, cnt, occ,
                                           scratch, cols=cols))
        plain_ms = time_ms(lambda: K.score_block_plain(spec, enc, idle, used,
                                                       cnt, occ, cols))
        records.append(dict(
            name=key, kernel="score_block", route="cuda",
            source="volcano_tpu_torch/csrc/score_block.cu",
            replaces="volcano_tpu/ops/rounds.py:108" if cols is None
            else "volcano_tpu/ops/rounds.py:168",
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bytes=byts, ops=ops, dtype=dt, library_ms=None,
            shape=f"K={k_rows} cols={m} N={n} R={r} ({src.get(key, 'cfg2')})"))

    # K2
    (scores, k), _ = seen["window_topk"]
    s1, i1 = RK.window_topk(scores, k)
    s2, i2 = RK.window_topk_plain(scores, k)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(s1, s2)):
        raise AssertionError("window_topk: kernel != plain")
    records.append(dict(
        name="window_topk", kernel="window_topk", route="cuda",
        source="volcano_tpu_torch/csrc/window_topk.cu",
        replaces="volcano_tpu/ops/rounds.py:754", max_abs_err=0.0,
        ms=time_ms(lambda: RK.window_topk(scores, k)),
        plain_ms=time_ms(lambda: RK.window_topk_plain(scores, k)),
        library_ms=time_ms(lambda: torch.topk(scores, k, dim=1)),
        bytes=nbytes(scores) + scores.shape[0] * k * (scores.element_size() + 4),
        ops=scores.numel(), dtype=scores.dtype,
        shape=f"K={scores.shape[0]} N={scores.shape[1]} k={k}"))

    # K4
    args, _ = seen["resolve_prefix"]
    a1 = RK.resolve_prefix(*args)
    a2 = RK.resolve_prefix_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(a1, a2):
        raise AssertionError(f"resolve_prefix: kernel != plain at "
                             f"{(a1 != a2).sum().item()} rows")
    key_s, req_s, pod_s, bound, is_scalar, cnt, nmax, _ = args
    records.append(dict(
        name="resolve_prefix", kernel="resolve_prefix", route="cuda",
        source="volcano_tpu_torch/csrc/resolve_prefix.cu",
        replaces="volcano_tpu/ops/rounds.py:442", max_abs_err=0.0,
        ms=time_ms(lambda: RK.resolve_prefix(*args)),
        plain_ms=time_ms(lambda: RK.resolve_prefix_plain(*args)),
        library_ms=None,
        bytes=nbytes(key_s, req_s, pod_s, bound, is_scalar, cnt, nmax) + key_s.shape[0],
        ops=req_s.numel() * 3, dtype=torch.int64,
        shape=f"T={key_s.shape[0]} R={req_s.shape[1]} N={bound.shape[0]}"))

    # K5
    args, _ = seen["queue_budget"]
    b1 = RK.queue_budget(*args)
    b2 = RK.queue_budget_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(b1, b2):
        raise AssertionError(f"queue_budget: kernel != plain at "
                             f"{(b1 != b2).sum().item()} rows")
    q_s = args[0]
    records.append(dict(
        name="queue_budget", kernel="queue_budget", route="cuda",
        source="volcano_tpu_torch/csrc/queue_budget.cu",
        replaces="volcano_tpu/ops/rounds.py:495", max_abs_err=0.0,
        ms=time_ms(lambda: RK.queue_budget(*args)),
        plain_ms=time_ms(lambda: RK.queue_budget_plain(*args)),
        library_ms=None,
        bytes=nbytes(*args) + q_s.shape[0],
        ops=args[2].numel() * 4, dtype=torch.int64,
        shape=f"T={q_s.shape[0]} R={args[2].shape[1]} Q={args[4].shape[0]}"))
    for rec in records:
        finish_record(rec)
    return records


def finish_record(rec):
    """bound_ms: the larger of the bytes over the memory rate and the
    operations over the peak rate of their type."""
    peak = PEAK_OPS.get(rec["dtype"], PEAK_OPS[torch.float32])
    t_bytes = rec["bytes"] / MEM_BPS * 1e3
    t_ops = rec["ops"] / peak * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel {rec['name']} [{rec['shape']}]: equal to plain; "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    print(json.dumps({"kernel": rec["name"], "shape": rec["shape"],
                      "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                      "library_ms": rec["library_ms"]}), flush=True)


def capture_evict():
    """Wrap the eviction dispatch so the first call of each machine kind
    keeps a copy of its inputs."""
    from volcano_tpu_torch.ops import evict_kernels as EK

    seen = {}
    real = EK.solve_packed

    def fn(spec, enc):
        if spec.kind not in seen:
            seen[spec.kind] = (spec, {k: v.clone() for k, v in enc.items()})
        return real(spec, enc)

    EK.solve_packed = fn

    def restore():
        EK.solve_packed = real
    return seen, restore


def capture_fused():
    """Wrap the fused chain's kernel wrappers so the first call of each (K13
    per kind, the fused K9 and K10) keeps a copy of its inputs."""
    from volcano_tpu_torch.ops import evict_kernels as EK

    seen = {}
    real = {n: getattr(EK, n) for n in ("fuse_heaps", "preempt_fused", "reclaim_fused")}

    def cl(d):
        return {k: v.clone() for k, v in d.items()}

    def heaps(kind, spec, enc, st, *args, **kw):
        seen.setdefault(f"fuse_heaps_{kind}", (kind, spec, cl(enc), cl(st), args, kw))
        return real["fuse_heaps"](kind, spec, enc, st, *args, **kw)

    def machine(name):
        def fn(spec, enc):
            seen.setdefault(name, (spec, cl(enc)))
            return real[name](spec, enc)
        return fn

    EK.fuse_heaps = heaps
    EK.preempt_fused = machine("preempt_fused")
    EK.reclaim_fused = machine("reclaim_fused")

    def restore():
        for name, f in real.items():
            setattr(EK, name, f)
    return seen, restore


# operations per node of an eligibility test (signature mask, pod count,
# and), of the window's circular scan (position, running count, test,
# select) and of the fused score (K1's per-node arithmetic)
ELIG_OPS, SCAN_OPS, SCORE_OPS = 4, 4, 45


def fold_ops(spec, v):
    """Operations of one node's victim fold: per slot the claim, count and
    sum, plus each deciding fn's walk (gang and the share walks scan the
    same-job/queue row, V entries)."""
    per_slot = 6
    for fn in spec.victim_fns:
        per_slot += 1 if fn == "conformance" else (4 + v if fn == "gang" else 14 + 2 * v)
    return v * per_slot


def evict_kernel_phase(captured):
    """Hold K9/K10/K11 against their plain versions on the main path's
    inputs (float32 state), exact on the packed int32 result; time both."""
    from volcano_tpu_torch.ops import evict_kernels as EK

    records = []
    for name, kind, src, replaces in (
            ("evict_preempt", "preempt", "cfg4", "volcano_tpu/ops/evict.py:828"),
            ("evict_reclaim", "reclaim", "reclaim path", "volcano_tpu/ops/evict.py:1009"),
            ("evict_backfill", "backfill", "cfg4", "volcano_tpu/ops/evict.py:1020")):
        if kind not in captured[src]:
            raise AssertionError(f"{src}: the {kind} machine was never called")
        spec, enc = captured[src][kind]
        got = EK.solve_packed(spec, enc)
        want, plain_ms = timed_plain(lambda: EK.solve_plain(spec, enc))
        stats = dict(EK.STATS)
        same(got, want, name)
        ms = time_ms(lambda: EK.solve_packed(spec, enc), reps=5, warmup=1)
        if kind == "backfill":
            used = ("sig_mask", "node_cnt", "node_max", "b_sig", "b_has_pod", "b_real")
            s_rows, n = enc["sig_mask"].shape
            t_total = enc["b_sig"].shape[0]
            # pod counts only rise, so the first feasible node of each
            # (signature, has_pod) never moves back: one cursor each walks
            # the node axis once (mask, count test, and), plus a lookup and
            # a bump per task
            ops = (2 if spec.check_pod_count else 1) * s_rows * n * 3 + t_total * 4
            shape = f"T={t_total} S={s_rows} N={n} ({src})"
        else:
            used = [k for k in EK._INPUTS if k in enc]
            n, v = enc["vic_job"].shape
            ops = machine_ops(spec, enc, stats)
            tail = got[-6:].tolist()
            shape = (f"N={n} V={v} T={enc['p_req'].shape[0]} "
                     f"J={enc['job_prio'].shape[0]} L={enc['log0'].shape[0]} "
                     f"folds={stats['folds']} fold_nodes={stats['fold_nodes']} "
                     f"walks={stats['walks']} windows={stats['windows']} "
                     f"scored={stats['scored']} "
                     f"ops={tail[0]} victims={tail[2]} attempts={tail[3]} ({src})")
        rec = dict(
            name=name, kernel=name, route="cuda",
            source=f"volcano_tpu_torch/csrc/{name}.cu", replaces=replaces,
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=nbytes(*(enc[k] for k in used)) + nbytes(got), ops=ops,
            dtype=enc["node_used"].dtype if "node_used" in enc else torch.int32,
            shape=shape)
        finish_record(rec)
        records.append(rec)
    return records


def machine_ops(spec, enc, stats):
    """A machine's operations, as the plain run on the same inputs counted
    them (the work depends on the data)."""
    n, v = enc["vic_job"].shape
    return (stats["fold_nodes"] * fold_ops(spec, v) + stats["walks"] * n * ELIG_OPS
            + stats["windows"] * n * SCAN_OPS + stats["scored"] * SCORE_OPS)


def timed_plain(fn):
    """One call of a plain version, timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same(got, want, what):
    if not torch.equal(got, want):
        bad = (got != want).nonzero().flatten()
        raise AssertionError(f"{what}: kernel != plain at {bad.numel()} entries "
                             f"(first {bad[:8].tolist()}); last six "
                             f"{got.flatten()[-6:].tolist()} vs {want.flatten()[-6:].tolist()}")


# operations of one heap comparison (keys, shares, tie) and of one push's
# bookkeeping (liveness, row clamp, append, size)
CMP_OPS, PUSH_OPS = 12, 8


def fused_kernel_phase(captured):
    """Hold K13 (both entries, on the first fused cfg4 and reclaim-path
    runs' inputs) and the fused K9 (cfg4) and K10 (reclaim path) against
    their plain versions: torch.equal on every output and carry tensor
    (float32 state); time both."""
    from volcano_tpu_torch.ops import evict_kernels as EK

    records = []
    for src in ("cfg4", "reclaim path"):
        for kind in ("preempt", "reclaim"):
            name = f"fuse_heaps_{kind}"
            if name not in captured[src]:
                raise AssertionError(f"{src}: K13 {kind} was never called")
            _, spec, enc, st, args, kw = captured[src][name]
            got = EK.fuse_heaps(kind, spec, enc, st, *args, **kw)
            want, plain_ms = timed_plain(
                lambda: EK.fuse_heaps_plain(kind, spec, enc, st, *args, **kw))
            stats = dict(EK.STATS)
            if sorted(got) != sorted(want):
                raise AssertionError(f"{name} ({src}): outputs {sorted(got)}")
            for k in want:
                same(got[k], want[k], f"{name} ({src}) {k}")
            ms = time_ms(lambda: EK.fuse_heaps(kind, spec, enc, st, *args, **kw))
            used = [st["ready"], st["job_alloc"], st["live_job"], enc["job_prio"],
                    enc["job_min_av"], enc["job_tie"]]
            if kind == "preempt":
                used += [enc["f_push_jobs"], enc["f_push_row"]]
                n_items = enc["f_push_jobs"].shape[0]
            else:
                used += [st["queue_alloc"], st["alive"], enc["f_ev_jobs"],
                         enc["f_ev_qrow"], enc["f_elig0"], enc["f_vtn0"],
                         enc["vic_job"], enc["vic_valid"], enc["queue_tie"],
                         enc["queue_deserved"]]
                n_items = enc["f_ev_jobs"].shape[0] + enc["vic_job"].numel()
            ops = stats["pushes"] * PUSH_OPS + stats["compares"] * CMP_OPS + n_items
            rec = dict(
                name=name, kernel=name, route="cuda",
                source="volcano_tpu_torch/csrc/fuse_heaps.cu",
                replaces="volcano_tpu/ops/session_fuse.py:" + (
                    "196" if kind == "preempt" else "268"),
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=nbytes(*used) + sum(nbytes(t) for t in got.values()),
                ops=ops, dtype=st["job_alloc"].dtype, path=src,
                shape=(f"rows={got['heap'].shape[0]} JCAP={got['heap'].shape[1]} "
                       f"pushes={stats['pushes']} compares={stats['compares']} ({src})"))
            finish_record(rec)
            if src == "cfg4":
                records.append(rec)

    for name, src, kind in (("evict_preempt_fused", "cfg4", "preempt"),
                            ("evict_reclaim_fused", "reclaim path", "reclaim")):
        key = "preempt_fused" if kind == "preempt" else "reclaim_fused"
        if key not in captured[src]:
            raise AssertionError(f"{src}: the fused {kind} machine was never called")
        spec, enc = captured[src][key]
        if kind == "preempt":
            got, carry = EK.preempt_fused(spec, enc)
            (want, carry_p), plain_ms = timed_plain(lambda: EK.preempt_fused_plain(spec, enc))
            if sorted(carry) != sorted(carry_p):
                raise AssertionError(f"{name}: carry keys {sorted(carry)}")
            for k in carry_p:
                same(carry[k], carry_p[k], f"{name} carry {k}")
            ms = time_ms(lambda: EK.preempt_fused(spec, enc), reps=5, warmup=1)
            out_bytes = nbytes(got, *carry.values())
        else:
            got = EK.reclaim_fused(spec, enc)
            want, plain_ms = timed_plain(lambda: EK.reclaim_plain(spec, enc))
            ms = time_ms(lambda: EK.reclaim_fused(spec, enc), reps=5, warmup=1)
            out_bytes = nbytes(got)
        stats = dict(EK.STATS)
        same(got, want, name)
        n, v = enc["vic_job"].shape
        tail = got[-6:].tolist()
        rec = dict(
            name=name, kernel=name, route="cuda",
            source=f"volcano_tpu_torch/csrc/evict_{kind}.cu",
            replaces="volcano_tpu/ops/session_fuse.py:" + (
                "235" if kind == "preempt" else "327"),
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=nbytes(*(enc[k] for k in EK._INPUTS if k in enc)) + out_bytes,
            ops=machine_ops(spec, enc, stats), dtype=enc["node_used"].dtype, path=src,
            shape=(f"N={n} V={v} T={enc['p_req'].shape[0]} J={enc['job_prio'].shape[0]} "
                   f"L={enc['log0'].shape[0]} folds={stats['folds']} "
                   f"fold_nodes={stats['fold_nodes']} walks={stats['walks']} "
                   f"ops={tail[0]} victims={tail[2]} attempts={tail[3]} ({src}, fused)"))
        finish_record(rec)
        records.append(rec)
    return records


def tripped_budget_session(cfg, scale, fuse):
    """The session on the card with the preempt plan's op log cut to 8
    rows: K9 runs out of its log budget and reports fail, preempt runs its
    serial walk instead, and the fallback is recorded in the profile and
    in the fallback counter. On the fused chain (``fuse``) the fused K9
    trips first: the chain records the fallback and the per-action rerun
    owns preempt and reclaim, whose own K9 trips the same cut. Returns the
    cache."""
    import numpy as np
    from volcano_tpu_torch.ops import evict as EV
    from volcano_tpu_torch.scheduler import metrics

    real = EV._EvictPlan.__init__

    def init(self, ssn, kind, fused=False, view=None):
        real(self, ssn, kind, fused, view)
        if kind == "preempt" and not self.trivial:
            self.log_rows = 8
            self.arrays["log0"] = np.zeros((8, 3), np.int32)

    fallbacks = metrics.registry().device_fallbacks
    before = fallbacks.get(("evict_preempt",))
    EV._EvictPlan.__init__ = init
    try:
        cache, prof, counts = run_session(cfg, scale, "cuda", "float64", fuse=fuse)[:3]
    finally:
        EV._EvictPlan.__init__ = real
    what = f"budget check cfg{cfg} ({'fused' if fuse else 'per-action'})"
    reason = prof.get("evict_preempt_fallback")
    if reason != "kernel step/log budget exhausted":
        raise AssertionError(f"{what}: no budget fallback: {reason}")
    if fallbacks.get(("evict_preempt",)) != before + (2 if fuse else 1):
        raise AssertionError(f"{what}: fallback not counted")
    if counts["evict_preempt"] != 1:
        raise AssertionError(f"{what}: K9 launches {counts}")
    if fuse:
        if prof.get("fuse") != 1 or "fuse_fallback" in prof:
            raise AssertionError(f"{what}: the chain did not fuse: {prof.get('fuse_fallback')}")
        if counts["evict_preempt_fused"] != 1 or "evict_reclaim" not in prof:
            raise AssertionError(f"{what}: preempt/reclaim not rerun per-action: {counts}")
    elif "fuse" in prof:
        raise AssertionError(f"{what}: fused with VOLCANO_TPU_FUSE=0")
    return cache


def check_fused(cfg, prof):
    if prof.get("fuse") != 1 or "fuse_fallback" in prof:
        raise AssertionError(f"cfg{cfg}: the chain did not fuse: "
                             f"{prof.get('fuse_fallback', prof.get('fallback'))}")
    if prof.get("fuse_stages") != list(EVICT_ACTIONS):
        raise AssertionError(f"cfg{cfg}: fused stages {prof.get('fuse_stages')}")


def reference_check():
    """Small sessions in float64: the card gives the CPU's binds and, on
    the eviction paths (fused on both sides), the CPU's evictions in the
    same order. On cfg4 a session whose preempt log budget trips on the
    card, per-action and inside the fused chain, falls back to the serial
    walk and still gives the CPU's binds and evictions."""
    for cfg, scale in ((5, 0.02), (4, 0.02), ("reclaim", 0.02)):
        gpu, prof_g = run_session(cfg, scale, "cuda", "float64")[:2]
        cpu, prof_c = run_session(cfg, scale, "cpu", "float64")[:2]
        if cfg != 5:
            check_fused(cfg, prof_g)
            check_fused(cfg, prof_c)
        if cfg == 4:
            for fuse in (False, True):
                tripped = tripped_budget_session(cfg, scale, fuse)
                if (tripped.binder.binds != cpu.binder.binds
                        or tripped.evictor.evicts != cpu.evictor.evicts):
                    raise AssertionError(f"budget check cfg4 (fuse {fuse}): the serial "
                                         "walk differs from the CPU's batched session")
                print(json.dumps({"budget_check": f"cfg4@{scale} K9 log budget "
                                  f"tripped on cuda ({'fused chain' if fuse else 'per-action'}), "
                                  "serial walk == cpu",
                                  "evicts": len(tripped.evictor.evicts)}), flush=True)
        if prof_g.get("mode") != "rounds" or prof_c.get("mode") != "rounds":
            raise AssertionError(f"reference check cfg{cfg}: rounds mode did not run")
        same_result = (gpu.binder.binds == cpu.binder.binds
                       and gpu.evictor.evicts == cpu.evictor.evicts)
        if not same_result:
            raise AssertionError(f"reference check cfg{cfg}: card and CPU differ")
        if cfg == 5 and not gpu.binder.binds:
            raise AssertionError("reference check cfg5: nothing bound")
        if cfg != 5 and not gpu.evictor.evicts:
            raise AssertionError(f"reference check cfg{cfg}: nothing evicted")
        print(json.dumps({"reference_check": f"cfg{cfg}@{scale} float64 cuda == cpu"
                          + (" (fused chain)" if cfg != 5 else ""),
                          "binds": len(gpu.binder.binds),
                          "evicts": len(gpu.evictor.evicts)}), flush=True)


ALLOC_KERNELS = ("score_block", "window_topk", "resolve_prefix", "queue_budget")
EVICT_KERNELS = ("evict_preempt", "evict_reclaim", "evict_backfill")
FUSED_KERNELS = ("fuse_heaps_preempt", "fuse_heaps_reclaim", "evict_preempt_fused",
                 "evict_reclaim_fused")
# the kernels each per-action path must launch (and, for the allocate-only
# configs, the eviction kernels they must not); cfg4's reclaim finds no
# pending task once preempt has pipelined them all, so K10 is the reclaim
# path's
PATH_KERNELS = {
    2: ALLOC_KERNELS, 3: ALLOC_KERNELS, 5: ALLOC_KERNELS,
    4: ALLOC_KERNELS + ("evict_preempt", "evict_backfill"),
    "reclaim": ("evict_preempt", "evict_reclaim"),
}
# a fused chain launches each of these exactly once: K13's two entries, the
# fused K9 and K10, and K11 where backfill has tasks (cfg4; the reclaim
# path has none), beside the allocate kernels of its rounds solve
FUSED_ONCE = {4: FUSED_KERNELS + ("evict_backfill",), "reclaim": FUSED_KERNELS}


def check_plans(cfg, prof):
    """Each eviction action consumed its plan, with no fallback; on cfg4
    backfill and preempt did work, on the reclaim path reclaim did."""
    for kind in ("backfill", "preempt", "reclaim"):
        key = f"evict_{kind}"
        if key + "_fallback" in prof:
            raise AssertionError(f"cfg{cfg}: {key} fell back: {prof[key + '_fallback']}")
        if key not in prof:
            raise AssertionError(f"cfg{cfg}: {key} missing from the profile")
    busy = ("backfill", "preempt") if cfg == 4 else ("reclaim",)
    for kind in busy:
        plan = prof[f"evict_{kind}"]
        if plan.get("trivial") or not (plan.get("ops") or plan.get("placed")):
            raise AssertionError(f"cfg{cfg}: evict_{kind} did no work: {plan}")


def check_launches(cfg, prof, counts, fused):
    """Every kernel of the path launched (the fused chain's exactly once),
    and none of another path."""
    # K2 is on the path only when the solve used a candidate window
    # (window_k 0 means full-width sweeps, as cfg4 runs)
    alloc = [k for k in ALLOC_KERNELS if k != "window_topk" or prof.get("window_k")]
    if fused:
        need = (alloc if cfg == 4 else []) + list(FUSED_ONCE[cfg])
        wrong = {k: counts[k] for k in FUSED_ONCE[cfg] if counts[k] != 1}
        wrong.update({k: counts[k] for k in EVICT_KERNELS + FUSED_KERNELS
                      if k not in FUSED_ONCE[cfg] and counts[k]})
    else:
        need = [k for k in PATH_KERNELS[cfg] if k in EVICT_KERNELS or k in alloc]
        bad = FUSED_KERNELS + (EVICT_KERNELS if cfg not in FUSED_ONCE else ())
        wrong = {k: counts[k] for k in bad if counts[k]}
    idle = [k for k in need if counts[k] == 0]
    if idle:
        raise AssertionError(f"cfg{cfg}: kernels never launched: {idle}")
    if wrong:
        raise AssertionError(f"cfg{cfg} ({'fused' if fused else 'per-action'}): "
                             f"wrong launch counts {wrong}")


def split(prof, wall, action_ms):
    """A run's wall split: per action, device waits and overlap, sync
    points; for a fused run its per-stage fetch waits; each eviction
    plan's encode/solve/apply."""
    dp = prof["session_devprof"]
    out = {"session_ms": wall * 1e3, "action_ms": action_ms,
           "sync_points": dp["tpu_sync_points"], "d2h_fetches": dp["tpu_d2h_fetches"],
           "overlap_ms": dp["tpu_overlap_ms"], "fetch_wait_ms": dp["tpu_fence_wait_ms"]}
    if prof.get("fuse"):
        out.update(stage_fetch_wait_ms={k: v * 1e3 for k, v in prof["fuse_wait_s"].items()},
                   fuse_stage_ms=prof["fuse_stage_s"] * 1e3,
                   fuse_dispatch_ms=prof["fuse_dispatch_s"] * 1e3)
    for kind in ("backfill", "preempt", "reclaim"):
        plan = prof[f"evict_{kind}"]
        out[f"evict_{kind}"] = plan if plan.get("trivial") else {
            "encode_ms": plan["encode_s"] * 1e3,
            "solve_ms": plan["solve_s"] * 1e3,
            "apply_ms": plan["apply_s"] * 1e3,
            **{k: plan[k] for k in ("ops", "victims", "attempts", "tasks", "placed")
               if k in plan}}
    return out


def session_phase(scale):
    """cfg2/3/5 at ``scale``, twice each; cfg4 and the reclaim path always
    at full width, twice on the fused chain (the first run captures the
    fused kernels' inputs) and once per-action (capturing K9/K10/K11's)."""
    launches, captured = {}, {}
    for cfg in (2, 3, 5, 4, "reclaim"):
        evicting = cfg in (4, "reclaim")
        src = "cfg4" if cfg == 4 else "reclaim path"
        plan = ([(True, capture_fused), (True, None), (False, capture_evict)]
                if evicting else [(True, None), (True, None)])
        runs = []
        for fuse, capture in plan:
            seen, restore = capture() if capture is not None else ({}, None)
            try:
                cache, prof, counts, n_tasks, wall, action_ms, before = run_session(
                    cfg, 1.0 if evicting else scale, "cuda", "float32", fuse=fuse)
            finally:
                if restore is not None:
                    restore()
            captured.setdefault(src, {}).update(seen)
            if prof.get("mode") != "rounds":
                raise AssertionError(f"cfg{cfg}: mode {prof.get('mode')}: {prof}")
            check_launches(cfg, prof, counts, fuse and evicting)
            check_binds(cache, cfg, before)
            if evicting:
                if fuse:
                    check_fused(cfg, prof)
                elif "fuse" in prof:
                    raise AssertionError(f"cfg{cfg}: fused with VOLCANO_TPU_FUSE=0")
                check_evicts(cache, cfg, before)
                check_plans(cfg, prof)
            runs.append((cache.binder.binds, list(cache.evictor.evicts), prof,
                         counts, n_tasks, wall, action_ms))
        for other in runs[1:]:
            if other[0] != runs[0][0] or other[1] != runs[0][1]:
                raise AssertionError(f"cfg{cfg}: runs gave different binds or evictions "
                                     "(fused twice, then per-action)")
        binds, evicts, prof, counts, n_tasks, wall, action_ms = runs[1]
        launches[cfg] = runs[0][3]
        line = {
            "cfg": cfg, "tasks": n_tasks, "nodes": prof.get("nodes"),
            "placed": prof.get("placed"), "binds": len(binds),
            "evicts": len(evicts), "rounds": prof.get("rounds"),
            "sync_points": prof["session_devprof"]["tpu_sync_points"],
            "window_k": prof.get("window_k"), "dirty_k": prof.get("dirty_k"),
            "full_sweep_rounds": prof.get("full_sweep_rounds"),
            "encode_ms": prof["encode_s"] * 1e3,
            "solve_ms": prof["solve_s"] * 1e3,
            "apply_ms": prof["apply_s"] * 1e3,
            "session_ms": wall * 1e3,
            "launches": counts, "deterministic": True}
        if evicting:
            launches[(cfg, "per_action")] = runs[2][3]
            line["fused"] = split(prof, wall, action_ms)
            line["per_action"] = split(runs[2][2], runs[2][5], runs[2][6])
            line["launches_per_action"] = runs[2][3]
            line["fused_equals_per_action"] = True
        print(json.dumps(line), flush=True)
    return launches, captured


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cluster scale of the cfg2/3/5 sessions (1.0 = full)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    import volcano_tpu_torch  # noqa: F401  (fails outside the repository)
    from volcano_tpu_torch import _build
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    records = kernel_phase(args.scale)
    reference_check()
    launches, captured = session_phase(args.scale)
    records += evict_kernel_phase(captured)
    records += fused_kernel_phase(captured)
    # each kernel's launches on the path that runs it: K1-K5 on cfg5; the
    # per-action K9 on cfg4's and K10 on the reclaim path's per-action run;
    # K11, K13 and the fused K9 on cfg4's fused run, the fused K10 on the
    # reclaim path's
    path_of = {"evict_preempt": (4, "per_action"),
               "evict_reclaim": ("reclaim", "per_action"),
               "evict_backfill": 4, "fuse_heaps_preempt": 4,
               "fuse_heaps_reclaim": 4, "evict_preempt_fused": 4,
               "evict_reclaim_fused": "reclaim"}
    out = []
    for rec in records:
        out.append({
            "name": rec["name"], "route": rec["route"], "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": launches[path_of.get(rec["kernel"], 5)][rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(f"power: {smi}", flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
