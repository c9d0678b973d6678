"""Where a warm graph round of the rounds solve (K7) spends the card's time.

``python -m volcano_tpu_torch.bench.kernel_profile --kernel k7`` runs this
on the card, for cfg2 (24 rounds, binpack, a GPU scalar dimension), cfg5
(one round and the full-width cover) and cfg6 (15 rounds, capped: the
straggler rounds and the tail pass, K7b), all at full scale, float32, on
the solver's own encode:

1. A solve by the host-driven step machine (``loop="host"``: the same round
   body, launched eagerly) under ``torch.profiler``, with a range around
   each node group: K1 (``score_round``; the parent's ``score_block``,
   ``_rescore_dirty``), K2
   (``window_topk``), the ranks (K6 ``job_rank``), the capacity walk (K2b
   ``cap_walk``, with the cover's argsort and gather), the select (K3),
   ``_resolve`` (its sort and K4), ``_queue_budget`` (its sort and K5),
   and around the round, the rollback, the tail, the head and the
   finish. A kernel belongs to the range its launch was issued in; the
   round's kernels outside every group range are its commit. Each group's
   kernel count and device time a round come from this run.
2. A warm graph solve under the profiler. Its kernels, in the order the
   card ran them, are aligned with the host run's labelled launches by
   name (same body code, same order; a longest common subsequence, since
   the graph adds K7a, the condition kernels and the body counters); the
   device time of each group inside the graph, the replay's span, its
   busy time and idle share, the input copies before the replay and the
   clones after it, and the kernels a round.
3. Warm graph solves timed with CUDA events, the captured graph's per-body
   launch counts (``utils/devprof``: hand-written kernels only), and K4,
   K5, K2b and K6 timed on the first inputs the run gave them (CUDA
   events, 20 calls after 3, and the wrapper's host time a call), beside
   their bytes bounds (every tensor argument read once, the outputs
   written) and plain versions.

Each group's kernels are also split by kind (``*_split``): the sorts (CUB's
radix passes, torch's sort kernels), the hand-written kernels, and the
other torch ops (gathers, copies, the elementwise ops).

Where the profiler records no device time (its CUPTI tracing is untried on
the machine), the lines say so and carry the CUDA-event numbers only.

``python -m volcano_tpu_torch.bench.round_split --compare A1 B1 B2 A2``
reads the JSON lines of runs of this split and of ``chip_smoke.py`` (its
``k7``, ``k4_k5`` and ``k2b_k6`` lines), each run's output in a file, and prints the
numbers side by side: the two trees of an ABBA call in turns.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

MEM_BPS = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

# node groups of a round: the rounds module's functions whose launches
# each group owns (the parent's torch-op functions and this tree's kernel
# wrappers both named, so one profile reads either tree)
GROUPS = (
    ("K1", ("score_round", "score_block", "_rescore_dirty")),
    ("K2", ("window_topk",)),
    ("ranks (K6)", ("_job_rank", "_rank_in_class", "_excl_grank")),
    ("capacity walk (K2b)", ("_cap_walk", "_nominate_full")),
    ("select (K3)", ("_select", "round_select")),
    ("resolve + K4", ("_resolve",)),
    ("queue budget + K5", ("_queue_budget",)),
)
BODIES = ("_round", "_rollback", "_tail", "head", "finish")
# hand-written kernels by a substring of their name, for graph kernels the
# host run has no launch of (K7a, the condition kernels)
KERNEL_NAMES = (
    ("rounds_ctl", "K7a"), ("set_cond", "K7a"), ("tail_pass", "tail"),
    ("score_block", "K1"), ("window_topk", "K2"), ("resolve_prefix", "resolve + K4"),
    ("queue_budget", "queue budget + K5"), ("round_select", "select (K3)"),
    ("cap_walk", "capacity walk (K2b)"), ("job_rank", "ranks (K6)"),
)
# the one-thread control kernels (K7a, the condition setters), by name
CONTROL = ("rounds_ctl", "set_cond")
CFGS = (2, 5, 6)
# a kernel's kind within its group, by a substring of its name
HANDWRITTEN = ("resolve_prefix", "queue_budget", "round_select", "round_commit",
               "score_block", "window_topk", "rounds_ctl", "tail_pass", "cap_walk",
               "job_rank")
SORTS = ("sort", "Sort", "radix", "Radix")


# the kernel wrappers whose first inputs a split keeps and times
KEPT = ("resolve_prefix", "queue_budget", "cap_walk", "job_rank")


def _bytes(x):
    """The bytes of every tensor in ``x`` (tensors, tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return sum(_bytes(v) for v in x)
    return 0


def kind_of(name: str) -> str:
    if any(k in name for k in HANDWRITTEN):
        return "kernel"
    if any(k in name for k in SORTS):
        return "sort"
    return "torch"


def _split(rows, rounds):
    """{group: {kind: [kernels a round, device ms a round]}} of (name,
    label, dur us) rows."""
    out = {}
    for name, lab, dur in rows:
        k = out.setdefault(lab, {}).setdefault(kind_of(name), [0.0, 0.0])
        k[0] += 1 / rounds
        k[1] += dur / 1e3 / rounds
    return out


def smi_line() -> str:
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def solve_inputs(cfg, scale):
    """(spec, staged encode) of the allocate solve a session of ``cfg``
    prepares on the card (float32)."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(cfg, scale)
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                     "tpuscore.dtype": "float32"}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    if prep is None or prep["mode"] != "rounds":
        raise RuntimeError(f"cfg{cfg}: no rounds solve prepared")
    return prep["spec"], prep["staged"]


@contextlib.contextmanager
def keeping(kept):
    """Wrap the rounds module's KEPT kernel wrappers (those the tree has) so
    that ``kept`` takes each one's first inputs. Used on the split's warm-up
    run, outside the profile: the copies would add kernels to the profiled
    run that its graph lacks."""
    from volcano_tpu_torch.bench.round_cases import _clone
    from volcano_tpu_torch.ops import rounds as R

    real = {name: getattr(R, name) for name in KEPT if hasattr(R, name)}

    def keep(fn, name):
        def inner(*a, **kw):
            if name not in kept:
                kept[name] = [_clone(x) for x in a]
            return fn(*a, **kw)
        return inner

    for name, fn in real.items():
        setattr(R, name, keep(fn, name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(R, name, fn)


@contextlib.contextmanager
def group_ranges():
    """Wrap the rounds module's group functions and the machine's bodies in
    profiler ranges named ``group:<name>`` and ``body:<name>``. A group
    call inside another group's range is not wrapped again."""
    from torch.autograd.profiler import record_function

    from volcano_tpu_torch.ops import rounds as R

    real, depth = {}, [0]

    def wrap(fn, label):
        def inner(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            try:
                with record_function(label):
                    return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return inner

    def body(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    for group, names in GROUPS:
        for name in names:
            if hasattr(R, name):
                real[(R, name)] = getattr(R, name)
                setattr(R, name, wrap(real[(R, name)], f"group:{group}"))
    for name in BODIES:
        real[(R.StepMachine, name)] = getattr(R.StepMachine, name)
        setattr(R.StepMachine, name, body(real[(R.StepMachine, name)], f"body:{name}"))
    try:
        yield
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)


def _trace(prof):
    """The profile's chrome trace as (kernels, launches by correlation, host
    ranges): kernels as dicts with name, ts, dur, correlation."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    kernels, launches, ranges = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args", {})
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"]),
                            "corr": args.get("correlation")})
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            launches[args.get("correlation")] = (e["name"], float(e["ts"]))
        elif cat == "user_annotation" or (cat == "cpu_op" and ":" in e["name"]
                                          and e["name"].split(":")[0] in ("group", "body")):
            ranges.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    kernels.sort(key=lambda k: k["ts"])
    return kernels, launches, ranges


def _label_host(kernels, launches, ranges):
    """Each kernel of the host run labelled by the innermost group or body
    range its launch lies in: (name, label, dur)."""
    groups = [r for r in ranges if r[0].startswith("group:")]
    bodies = [r for r in ranges if r[0].startswith("body:")]
    out = []
    for k in kernels:
        ts = launches.get(k["corr"], (None, None))[1]
        label = "other"
        if ts is not None:
            g = next((r for r in groups if r[1] <= ts <= r[2]), None)
            b = next((r for r in bodies if r[1] <= ts <= r[2]), None)
            if g is not None:
                label = g[0][len("group:"):]
            elif b is not None:
                label = {"body:_round": "commit", "body:_rollback": "rollback",
                         "body:_tail": "tail", "body:head": "head",
                         "body:finish": "finish"}[b[0]]
        out.append((k["name"], label, k["dur"]))
    return out


def _by_name(name):
    return next((lab for key, lab in KERNEL_NAMES if key in name), None)


def _align(a, b):
    """The pairs (i, j) of a longest common subsequence of the name lists
    ``a`` and ``b``: a row of the LCS table at a time, S[i][j] the running
    max over j of max(S[i-1][j], S[i-1][j-1] + 1 where a[i-1] == b[j-1])."""
    ids = {}
    ai = np.array([ids.setdefault(x, len(ids)) for x in a], dtype=np.int64)
    bi = np.array([ids.setdefault(x, len(ids)) for x in b], dtype=np.int64)
    n, m = len(ai), len(bi)
    table = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(1, n + 1):
        prev = table[i - 1]
        t = prev.copy()
        t[1:] = np.maximum(prev[1:], np.where(bi == ai[i - 1], prev[:-1] + 1, 0))
        table[i] = np.maximum.accumulate(t)
    pairs, i, j = [], n, m
    while i > 0 and j > 0:
        if ai[i - 1] == bi[j - 1] and table[i, j] == table[i - 1, j - 1] + 1:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif table[i - 1, j] >= table[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return pairs[::-1]


def _label_graph(graph_kernels, host_seq):
    """Label the graph's kernels by aligning their names, in order, with the
    host run's labelled sequence (a longest common subsequence: the graph
    adds K7a, the conditions and the body counters, the host run its own
    sync copies); a kernel left out takes the label of its own name, or
    none (unattributed)."""
    pairs = dict(_align([k["name"] for k in graph_kernels], [h[0] for h in host_seq]))
    return [(k, host_seq[pairs[i]][1] if i in pairs
             else _by_name(k["name"]) or "unattributed")
            for i, k in enumerate(graph_kernels)]


def control_kernels(kernels) -> dict:
    """The one-thread control kernels among ``kernels`` (dicts with a
    name), counted by the CONTROL substring they carry."""
    out = {}
    for k in kernels:
        key = next((c for c in CONTROL if c in k["name"]), None)
        if key is not None:
            out[key] = out.get(key, 0) + 1
    return out


def _busy(kernels):
    """The union of the kernels' intervals (us)."""
    busy, end = 0.0, None
    for k in sorted(kernels, key=lambda x: x["ts"]):
        a, b = k["ts"], k["ts"] + k["dur"]
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def _events_ms(fn, reps=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def split_config(cfg, scale, card):
    """Print and return the split of ``cfg``'s warm graph round."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import rounds as R
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.ops import rounds_kernels as RK
    from volcano_tpu_torch.utils import devprof

    spec, enc = solve_inputs(cfg, scale)
    # the host run, once to warm (kernel builds, lazy set-up; it keeps the
    # KEPT wrappers' first inputs), once profiled
    kept = {}
    with keeping(kept):
        R.solve(spec, enc, loop="host")
    torch.cuda.synchronize()
    with group_ranges():
        (raw, _), prof = _profile(lambda: R.solve(spec, enc, loop="host"))
    rounds = max(int(raw[1]), 1)
    kernels, launches, ranges = _trace(prof)
    host_seq = _label_host(kernels, launches, ranges)
    host_groups, by_name = {}, {}
    for name, lab, dur in host_seq:
        g = host_groups.setdefault(lab, {"kernels": 0, "device_ms": 0.0})
        g["kernels"] += 1
        g["device_ms"] += dur / 1e3
        k = by_name.setdefault((lab, name[:80]), [0, 0.0])
        k[0] += 1
        k[1] += dur / 1e3
    # each group's heaviest kernels (name, launches, device ms a solve)
    host_top = {}
    for (lab, name), (n, ms) in sorted(by_name.items(), key=lambda x: -x[1][1]):
        if len(host_top.setdefault(lab, [])) < 4:
            host_top[lab].append([name, n, ms])
    # the graph: capture (cold), warm, then a profiled warm solve. The
    # capture comes after the profiler's first run in this process: on an
    # H100 under CUDA 12.8 the trace of a graph captured before it lacks
    # the WHILE body's passes after the first, so a graph this bucket
    # already had is dropped
    rounds_graph._GRAPHS.pop(rounds_graph.graph_key(spec, enc), None)
    packed = R.solve(spec, enc)[1]
    devprof.fetch(packed)
    graph = rounds_graph._GRAPHS[rounds_graph.graph_key(spec, enc)]
    warm_ms = _events_ms(lambda: R.solve(spec, enc)[1])

    (raw_g, _), gprof = _profile(lambda: R.solve(spec, enc))
    gkernels, glaunches, _ = _trace(gprof)
    # the replay's kernels: correlated with the graph launch, or with no
    # host launch at all (the conditional bodies' nodes); the rest are the
    # eager copies into the graph's inputs before it and the clones after
    graph_ts = min((ts for name, ts in glaunches.values()
                    if name.startswith("cudaGraphLaunch")), default=None)
    replay, copies, clones = [], [], []
    for k in gkernels:
        name, ts = glaunches.get(k["corr"], ("", None))
        if ts is None or name.startswith("cudaGraphLaunch"):
            replay.append(k)
        elif graph_ts is not None and ts < graph_ts:
            copies.append(k)
        else:
            clones.append(k)
    first = replay[0]["ts"] if replay else None
    labelled = _label_graph(replay, host_seq)
    graph_groups, graph_by_name = {}, {}
    for k, lab in labelled:
        g = graph_groups.setdefault(lab, {"kernels": 0, "device_ms": 0.0})
        g["kernels"] += 1
        g["device_ms"] += k["dur"] / 1e3
        x = graph_by_name.setdefault((lab, k["name"][:80]), [0, 0.0])
        x[0] += 1
        x[1] += k["dur"] / 1e3
    graph_top = {}
    for (lab, name), (n, ms) in sorted(graph_by_name.items(), key=lambda x: -x[1][1]):
        if len(graph_top.setdefault(lab, [])) < 4:
            graph_top[lab].append([name, n, ms])
    graph_groups["copies in"] = {"kernels": len(copies),
                                 "device_ms": sum(k["dur"] for k in copies) / 1e3}
    graph_groups["clones out"] = {"kernels": len(clones),
                                  "device_ms": sum(k["dur"] for k in clones) / 1e3}
    span = (max(k["ts"] + k["dur"] for k in replay) - first) / 1e3 if replay else None
    busy = _busy(replay) / 1e3 if replay else None
    round_kernels = sum(v["kernels"] for lab, v in graph_groups.items()
                        if lab in dict(GROUPS) or lab == "commit")
    control = control_kernels(replay)
    rec = {
        "kernel_profile": "k7", "config": cfg, "scale": scale, "card": card,
        "T": enc["task_cls"].shape[0], "N": enc["node_idle"].shape[0],
        "K": enc["cls_req"].shape[0], "window_k": spec.window_k,
        "rounds": int(raw[1]), "full_sweeps": int(raw[3]),
        "graph_equals_host": bool(all(torch.equal(a, b) for a, b in zip(raw_g, raw))),
        "warm_solve_ms": warm_ms,
        "profiler_device_time": bool(replay),
        "replay_span_ms": span, "replay_busy_ms": busy,
        "replay_idle_share": (1 - busy / span) if span else None,
        "graph_kernels": len(replay),
        "graph_round_kernels_a_round": round_kernels / rounds,
        # the one-thread control kernels: K7a's (one a pass of the WHILE
        # body, the steps + 1) and the condition setters
        "graph_control_kernels": control,
        "graph_control_kernels_a_pass": sum(control.values()) / max(control.get("rounds_ctl", 0), 1),
        "graph_ms_a_round": {lab: v["device_ms"] / rounds for lab, v in graph_groups.items()},
        "graph": graph_groups,
        "host_run_ms_a_round": {lab: v["device_ms"] / rounds for lab, v in host_groups.items()},
        "host_run": host_groups,
        "host_run_top_kernels": host_top,
        "graph_top_kernels": graph_top,
        "host_run_split": _split(host_seq, rounds),
        "graph_split": _split([(k["name"], lab, k["dur"]) for k, lab in labelled], rounds),
        "body_launches": {"head": graph.head_counts, **graph.body_counts},
    }
    print(json.dumps(rec), flush=True)
    # K4, K5, K2b and K6 on the first inputs this config's path gave them
    for name in KEPT:
        args = kept.get(name)
        if args is None:
            continue
        fn, plain = getattr(RK, name), getattr(RK, name + "_plain")
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        ms = _events_ms(lambda: fn(*args), reps=20, warmup=3)
        t0 = time.perf_counter()
        for _ in range(20):
            fn(*args)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        byts = _bytes(args) + _bytes(got)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        print(json.dumps({"kernel_profile": "k7", "config": cfg, "kernel": name,
                          "card": card,
                          "equal_plain": all(torch.equal(a, b) for a, b in zip(got, want)),
                          "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                          "bound_ms": byts / MEM_BPS * 1e3, "rounds": int(raw[1])}),
              flush=True)
    devmod.reset_launches()
    return rec


def _lines(path):
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def compare(paths) -> int:
    """Print the runs' numbers side by side (one column a run)."""
    rows = {}
    for col, path in enumerate(paths):
        for rec in _lines(path):
            keys = []
            if rec.get("kernel_profile") == "k7" and "graph" in rec:
                c = f"cfg{rec['config']}"
                keys.append((f"{c} warm graph solve ms", rec["warm_solve_ms"]))
                keys.append((f"{c} graph kernels a round", rec["graph_round_kernels_a_round"]))
                if "graph_control_kernels" in rec:
                    keys.append((f"{c} graph control kernels a pass",
                                 rec["graph_control_kernels_a_pass"]))
                keys.append((f"{c} replay idle share", rec["replay_idle_share"]))
                for lab, v in rec["graph_ms_a_round"].items():
                    keys.append((f"{c} graph ms a round: {lab}", v))
                for lab in ("resolve + K4", "queue budget + K5", "ranks (K6)",
                            "capacity walk (K2b)"):
                    for kind, (n, ms) in rec.get("host_run_split", {}).get(lab, {}).items():
                        keys.append((f"{c} host run {lab}: {kind} ms (kernels)",
                                     f"{ms:.4f} ({n:.1f})"))
            elif rec.get("kernel_profile") == "k7" and "kernel" in rec:
                for f in ("ms", "host_ms", "bound_ms"):
                    if f in rec:
                        keys.append((f"cfg{rec['config']} {rec['kernel']} {f}", rec[f]))
            elif "k7" in rec and "graph_solve_ms_warm" in rec:
                keys.append((f"chip_smoke {rec['k7']} warm graph solve ms",
                             rec["graph_solve_ms_warm"]))
            elif "k4_k5" in rec or "k2b_k6" in rec:
                x = rec.get("k4_k5") or rec["k2b_k6"]
                for f in ("ms", "wrapper_ms", "host_ms", "mask_ms", "bound_ms"):
                    if f in x:
                        keys.append((f"chip_smoke {x['kernel']} {x['call']} {f}", x[f]))
            for key, v in keys:
                rows.setdefault(key, [None] * len(paths))[col] = v
    print("| | " + " | ".join(os.path.basename(p) for p in paths) + " |")
    print("|---" * (len(paths) + 1) + "|")
    for key, vals in rows.items():
        cells = [("%.4f" % v) if isinstance(v, float) else ("—" if v is None else str(v))
                 for v in vals]
        print(f"| {key} | " + " | ".join(cells) + " |")
    return 0


def main(scale: float = 1.0) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("round_split: no CUDA device is available")
    card = smi_line()
    print(f"device: {card}", flush=True)
    for cfg in CFGS:
        split_config(cfg, scale, card)
    return 0


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(sys.argv[2:]))
    sys.exit(main(float(sys.argv[1]) if len(sys.argv) > 1 else 1.0))
