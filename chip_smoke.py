"""Chip smoke test of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py               # full scale: cfg2, cfg3, cfg5, cfg4
    python3 chip_smoke.py --scale 0.05  # cfg2/3/5 smaller; cfg4, cfg6 and K7's phase stay full
    python3 chip_smoke.py --only parity,pipeline  # some phase groups only

Phase groups (``--only``; all by default): allocate (phases 2-5, 3b),
express (6-10), parity (11), pipeline (12), loop (13), bench (14),
store (15), cluster (16), daemon (17). Each group's wall time is logged
at the end. A device error (a failed build, launch, solve or fetch) is
never turned into the serial host path by the port: it raises and fails
the run.

Every rounds solve on the card is one replay of its bucket's CUDA graph
(K7, volcano_tpu_torch/ops/rounds_graph.py): the kernel wrappers launch
while the graph is captured, so a launch count is the kernels captured in
each graph body times the times the body ran, added when the solve's
result is fetched.

Phases, each failing the run on any error:

1. the card's name and power limit (nvidia-smi), the torch, CUDA and
   driver versions, then the build of every CUDA kernel under
   volcano_tpu_torch/csrc, one nvcc per source, in parallel, and of the
   native host engines (volcano_tpu_torch/_native, cc), which must load;
2. kernel phase (allocate): one cfg5 allocate session on the card records
   the first input each kernel wrapper sees on that path (K1's round
   entry score_round on a full round, and on a dirty round, which cfg2's
   session gives; K2 window_topk); each kernel is then held against its
   plain PyTorch version on those inputs with torch.equal (exact; K1's
   scores by their bits, its feasible counts, its scratch left zero; K1's
   full-refresh entry score_block too, on the full round's inputs), and
   both are timed with CUDA events (K1 20 calls in a CUDA graph); the same session times the rounds solver's K2b and
   K6 groups (``_cap_walk``/``_nominate_full`` and ``_job_rank``: each
   kernel's wrapper with the sorts and gathers around it) with CUDA
   events around each call. These sessions
   run the step machine from the host (loop="host"), so each call is an
   eager launch. K2 is also held against its plain version (bits equal)
   on crafted rows (signed zeros either way round, all tied, all -inf,
   -inf ties ahead of a feasible tail, last-bit neighbours), N odd,
   k = N/2, k = N and cfg6's shape, in float32 and float64, and timed
   beside torch.topk at the cfg5 capture and at cfg6's shape;
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
3b. K7, the rounds loop: cfg2, cfg3, cfg5 and cfg6 solves at full scale
   (the solver's own encode; the first solves of these buckets in the
   run): the graph solve, cold (it captures) and
   warm (it must not), is torch.equal to the host-driven step machine on
   the card (loop="host": the plain controller and tail) with exactly one
   sync point, the fetch; K7a rounds_ctl is held against its plain
   version on every controller input the host runs recorded, K7b
   tail_pass on the capped cfg6 tail's inputs (every state tensor), both
   timed, and the graph runs K7a once a pass of its loop (the host run's
   controller calls) and K1 once a round; K1's round entry on every
   round of those host runs (cfg6's K = 512 timed, 20 calls in a CUDA
   graph); K3 round_select and K7c round_commit on every select and commit
   call the host runs of cfg2, cfg3, cfg5 (window and cover) and cfg6
   (exclusion) made and on crafted inputs (bench/round_cases.py), K7c's
   plain version on CPU copies, both timed on cfg5's calls; K4
   resolve_prefix and K5 queue_budget (two launches: the job sums and
   queue scan, then queue_budget_mask) on every call of those host runs
   (cfg2's rounds, R = 3; cfg3's ten queues) and on crafted inputs in
   float32 and float64, timed with their host time and recounted bytes
   bound on cfg2's first and a later round, cfg3's and cfg5's; K2b
   cap_walk and K6 (two launches: the tile sorts job_rank, then
   job_rank_count) on every call of those host runs (the window and the full-width
   cover; the round's and the rollback's ranks) and on crafted inputs in
   float32 and float64 (bench/round_cases.py walk_cases, rank_cases), timed
   the same way on each config's first call (``k2b_k6`` lines); solve ms
   of the graph beside the host loop, the capture ms and the graphs cached
   are printed;
4. session phase: cfg2 (5k x 1k), cfg3 (20k x 5k), cfg5 (50k x 10k) and
   cfg6 (cfg2 with anti-affinity groups, always at full scale: it caps
   and runs the tail pass)
   through build_config -> open_session -> run_actions(["allocate"]) ->
   close_session, twice each (the second session of a bucket must capture
   no graph); then cfg4 (30k x 8k) and the reclaim path
   (an overcommitted two-queue cluster of cfg4's width under the
   reclaim-tier conf, where reclaim evicts: cfg4's preempt pipelines every
   pending task, so its reclaim has nothing to do) through
   run_actions(["allocate", "backfill", "preempt", "reclaim"]), twice on
   the fused session chain and once more on the per-action path
   (VOLCANO_TPU_FUSE=0), each on a fresh cache with tpuscore on cuda.
   Launch counters are zeroed just before each run and read just after:
   every kernel of the path must have launched (K1's round entry,
   K2/K2b/K3/K4/K5, K5's
   mask, K6's job_rank and job_rank_count, K7a and K7c everywhere, K7b exactly once on
   cfg6;
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
   the fused K9's every carry tensor; float32 state), and timed (K13 also
   its wrapper's host time a call, ``host_ms``; K11 that and 20 calls in
   a CUDA graph, ``graph_ms``); K11 also on bench/backfill_cases.py's
   crafted inputs, each in the placement its sizes choose and, widened,
   in the global one (one launch a call, torch.equal); K9's and
   K10's shape lines give their cluster's CTAs, a CTA's shared memory
   (static from ptxas -v, dynamic from the launcher) and microseconds a
   walk (K9) or a fold (K10).

6. express parity: a small float64 express lane on the card against the
   same lane on the CPU, on one event sequence (12 and 300 nodes, waves
   of arrivals with a session between): the same reports, end state and
   state stats;
7. the express lane at cfg5 (50k x 10k), bench.py --express's traffic:
   a settling session, a drain, 16 warm and 96 measured batches (the
   Poisson arrivals of one 20 ms period at 50 jobs/s, at least one; one
   pod of 100m/250m and 128Mi/256Mi each, seed 7), one full 64-task
   batch, a reconciling session. Exactly one fetch and one K14 launch
   per measured batch, no kernel built after the warm batches, one state
   rebuild, no error, the breaker closed, no token left, every bind
   feasible; prints p50/p99/max batch ms beside the card;
8. the replica at cfg5 (with 8 one-pod jobs of 64 cores, which no
   32-core node holds, so every session encodes), against a replica-off
   twin: a cold serve, a settling session, an unchanged session
   (whole-encode reuse, h2d_puts 0), and a capacity update of 8 nodes to
   96 cores (a node-family scatter of exactly those rows, on which the
   backlog then places); binds equal, standing tensors equal to the
   mirror each time;
9. preempt-terminal at cfg4: a fused chain ending at preempt, then 8
   nodes grown to 256 cores and an allocate session that places pending
   tasks on them, with and without the replica: binds and evictions
   equal in order, standing tensors equal to the mirror;
10. kernel phase (express and replica): K14 express_place on the lane's
   captured 1-task and 64-task batches, a full-width 100-node case, a
   tie-heavy case (fulls > 0), a gang strip and a zero-weight case (a
   window of +0.0 ties), and K8 scatter_rows on the cfg5 replica's node
   family (1, 16, 100, 256 rows) and the lane's columns, each held
   against its plain version with torch.equal and timed (K14 also its
   wrapper's host time a call, ``host_ms``: CUDA events over back-to-back
   calls read the host's time where it is the longer), K8 beside
   index_copy_ from sources on the card (library_ms) and from one pinned
   staging copy a call (library_staged_ms, the wrapper's own work);
11. parity mode (K15): (a) cfg2 at full scale in float32, one parity
   session through the tpuscore plugin launches K15 exactly once, binds
   feasible and gangs whole; on the captured inputs K15 is torch.equal to
   its plain version (assign and the cursor) and timed (5 calls after 1
   warm-up), and torch.equal on crafted inputs (bench/parity_cases.py; on
   the capture with a tenth of its jobs active:
   the cursor at real_n - 1, num_to_find <= 0, 1 and above the feasible
   count, pad nodes inside the rotation, 1024 and 256 threads, the node
   state in global memory, a gang visit that rolls back, more than 32
   namespaces and queues), and timed at each block size and node-state
   place; (b) float64 parity sessions on the card give the host serial
   loop's binds and cursor at cfg2 1.0 and cfg3 0.4; (c) one cfg5 parity
   session at full width in float32, feasible; on its capture with a
   tenth of its jobs active K15 is torch.equal to its plain version,
   timed (microseconds a task step),
   and timed at each block size and node-state place;
12. the pipeline at cfg5 (plus an oversized backlog, so every cycle
   solves): Scheduler(pipeline=True).run_once_pipelined() against
   Scheduler.run_once() on twins with their own cursors over 8 cycles
   (quiet, a fitting gang, quiet, a bound pod deleted, quiet, a gang,
   quiet, quiet): equal end signatures, the driver's accounting, at least
   one commit and one read-set or watch-delta discard, and on each
   committed stage a device overlap of at least half its device time (the
   dispatch returns before the solve ends); each cycle of each
   twin printed (session ms, sync points, fetch wait, tpu_overlap_ms, the
   stage's dispatch and device times, action ms);
13. the scheduler loop at cfg5: Scheduler(express=True, pipeline=True)
   .run() on its thread until a stage commits, then bench.py --express's
   arrivals for 8 s, until every arrival is bound; stop(); at least 3
   cycles, a commit, automatic GC off while it ran and restored after, no
   "scheduling cycle failed" or "express run failed" record; the lane's
   p50/p99/max (beside phase 7's p99) and the collections the
   interpreter ran are printed;
14. the bench (volcano_tpu_torch/bench): (a) K16 at cfg7 x 0.65 (65k
   tasks x 32.5k nodes, the largest cfg7 the encoder takes: at full scale
   its cluster capacity passes the int32 quantized-bound guard and the
   solver falls back to the serial loop, in the JAX package too; one
   rounds-mode encode through the solver's own prepare, no session run,
   the cluster build outside every timed window): at d = 1 and d = 8
   shards (N/d = 32,500 and 4,063 of the padded axis), K16a probe_refresh (16 launches of
   K1) and K16b probe_evict_fold (one launch) torch.equal to their plain
   versions on one shard's slice, each timed (5 calls after 1 warm-up;
   K16b also 20 calls in a CUDA graph and its wrapper's host time);
   (b) the bench's entry point ``main`` on the card (default --device
   cuda): cfg5 with both arms (the serial arm extrapolated under
   --serial-budget), the mesh curve at cfg7 0.2, the express lane (32
   measured batches) and the pipeline (2 measured cycles, and its churn
   arm), cfg5 at full scale: zero warm compiles (kernel builds and graph captures), both
   native engines loaded, one sync point a warm cfg5 solve, binds > 0,
   one curve entry with per_device_stage_ms > 0; each headline line and
   the phase's wall time are printed. The launch counters are zeroed
   before the mesh-curve run and read after it: K1's launches inside its
   probes (16 a probe) and K16b's;
15. the state store (volcano_tpu_torch/store): (a) cfg5 at ``--scale``
   (50k x 10k) written by its generator into a port Store, mirrored by a
   SchedulerCache(store=...) only through its watches (run()), one
   allocate session on the card binding through DefaultBinder.bind_many
   into the store: every rounds kernel of cfg5's path launched, the
   store's spec.node_name of every pod equal to its bind, the Scheduled
   events exactly the bind keys in bind order, the binds equal pod by pod
   (and in order) to a fed twin's (the same generator into a FakeBinder
   cache, the clock pinned to one counter on both sides, on the card),
   and a second session binding nothing new and capturing no graph; (b)
   cfg2 at ``--scale`` but at most 0.45 (2,248 tasks; phase 17(b) binds
   cfg2's full scale over HTTP) behind an ApiGateway on 127.0.0.1 (its journal sized to hold the
   initial sync and the binds' echoes), a RemoteStore-backed cache in
   this process synced from the watches, one session on the card binding
   over HTTP: cfg2's kernels launched, the server store's binds equal to
   a fed cfg2 twin's, one Scheduled event a bind after flush_events(), no
   watch reset; the watches and the gateway stopped in a ``finally``.
   Prints populate, session and bind-apply times, events, binds a second
   over HTTP;
16. the in-process cluster (volcano_tpu_torch/cluster.py): cfg2 at
   ``--scale`` as a user submits it (``cfg2_cluster``: 1,000 nodes, each
   four-task group a Job of four one-replica tasks, min_available 2, ttl
   0; 5,000 pods, above the rounds threshold), (a) through
   Cluster(scheduler_conf=loop_conf("auto")) driven by ``step()`` until a
   step writes nothing, the clock pinned to a counter: admission on every
   Job, each PodGroup Pending then Inqueue before any of its pods exists
   (the delay-pod-creation gate), one allocating cycle on the card whose
   rounds kernels launched (``check_launches``), every bound pod within
   its node's allocatable and Running, gangs whole, every Job's phase
   following its gang, the Queue counting every PodGroup running, the
   Scheduled events the binds; pods left unbound (cfg2 asks for 1,982 of
   2,000 GPUs) must be unplaceable: one cycle of the host's serial loop
   (tpuscore off) fed the store's objects binds none of them;
   the binds equal pod by pod and in order to a fed twin's (the store's
   Nodes, Queue, PodGroups and Pods right before the allocating cycle fed
   into a FakeBinder cache, one cycle of the same conf); then every pod
   Succeeded, every Job Completed and collected with its pods and
   PodGroup, and an empty cycle that captures no graph and binds nothing;
   (b) the same Jobs into a fresh Cluster run() on its threads
   (schedule_period 0.5 s) until every pod Runs, or until every bound pod
   Runs and 10 cycles have bound nothing (cfg2 asks for 1,982 of 2,000
   GPUs: pods arriving over many cycles can leave no GPU node room for a
   waiting 2-GPU pod), in which case one cycle of the host's serial loop
   fed the store's final objects must bind none of the pods left; gangs whole,
   fit per node, no ERROR record of the scheduler's logger (a failed
   cycle), the rounds kernels launched; stop() in a ``finally``. Prints the
   submission (admission), the controllers' pod creation, the allocating
   cycle's session and bind apply, the kubelet, submit -> Running (a and
   b), Running -> collected, and (b)'s cycles, beside the card;
17. the daemon (volcano_tpu_torch/scheduler/__main__.py, ha.py,
   leaderelection.py, cli/): (c) a takeover in this process: two
   FailoverScheduler members (a 1 s lease) over one Store holding cfg2 at
   ``--scale``; the leader solves it and pauses holding the lease, its
   pods are replaced by the same work under another namespace, the lease
   is released, and the standby's first session solves that same bucket
   with no graph capture (the graphs are cached process-wide) and no
   wholesale snapshot rebuild (its cache followed as a warm standby), pods
   left unbound held to ``serial_witness``; (b) the process split at
   cfg2's ``--scale``: ``python -m volcano_tpu_torch.scheduler
   --api-server-only`` (its ``api gateway on :PORT`` line read), cfg2's
   Nodes and the Queue written over a RemoteStore, two ``--server
   --leader-elect`` schedulers (sched-a, sched-b) under cfg2's conf with
   the batch solve in rounds mode on the card, each run as ``python -m
   volcano_tpu_torch.scheduler`` is (runpy) with a hook that prints each
   session's solver profile and kernel launches; cfg2's 1,250 Jobs
   submitted with ``cli.job.run_job`` (admission server-side) in two
   waves: once every Job of the first has its pods and 1,000 pods are
   bound, the leader is killed (SIGKILL); the standby takes the lease
   (more transitions, a higher epoch), the second wave is submitted (no
   Job waits for admission across the takeover: the job controller drops
   one that waits past its retry budget, a reference fault), and the
   standby binds the rest. Checked: at most one
   live leader and the lock's holder among them at every scrape; every
   Job with its pods; both schedulers' bind sessions solved in rounds mode
   and launched the rounds kernels in their own processes, the standby's
   after the takeover; no pod with two Scheduled events and one for every
   pod the standby bound (the killed leader's last unflushed batch of
   events is lost with it, and counted); fit and gangs; every bound pod
   Running and every Job's phase following its gang; pods left unbound
   held to ``serial_witness``; each scheduler's /metrics (the leader's
   before the kill, the standby's at the end) with no degraded rung, its
   envelope misses (``volcano_device_fallbacks_total``, cfg2's backfill)
   printed; the card's used memory (nvidia-smi) up by at least a CUDA
   context once the leader solves, down by as much at its kill, and up
   again once the standby solves (the card's process list carries
   another pid namespace's numbers, so a pid cannot be matched); ``python
   -m volcano_tpu_torch.cli.vcctl --server ... job list`` listing every
   Job. Prints the writes a second over HTTP, submit -> Running, the
   leader's binds before the kill, kill -> the standby's first bind
   beside the 15 s lease, the standby's binds, the fenced writes the
   gateway rejected and whether each watch journal trimmed, beside the
   card.

The last two lines of standard output are a {"kernels": [...]} JSON object
and {"ok": true, "device": {...}}. Without a usable GPU, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
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


def graph_ms(fn, reps=20, replays=5) -> float:
    """A call's device time: ``reps`` calls captured into one CUDA graph,
    replayed once to warm and ``replays`` times under CUDA events, so the
    wrapper's host work stays off the clock (as inside the solve's graph).
    For kernels whose scratch is planned before a capture (a warm call)."""
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


def host_ms(fn, reps=20) -> float:
    """A wrapper's host time a call: ``reps`` calls with no sync between
    (the card runs behind), one sync outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts if t is not None))


def run_session(cfg, scale, device, dtype, fuse=True):
    """One session of a bench config (or "reclaim", the reclaim path)
    through the port's normal entry, on the fused session chain or (``fuse``
    False: VOLCANO_TPU_FUSE=0) the per-action path; returns (cache,
    profile, launches, n_tasks, wall_s, action_ms, before) where
    ``before`` is what the checks need of the cluster as the session
    opened. The profile's "session_devprof" holds the device counters of
    the whole run_actions call, its "gc2_ms" the host's full (generation 2)
    collections inside the wall: each walks every tracked object of the
    process, so one that lands inside a session adds its length to the
    wall."""
    import gc
    import os

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.bench.reclaim_path import (
        EVICT_ACTIONS, RECLAIM_TIERS, reclaim_path_cluster)
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
    full_gc = {"ms": 0.0, "t": 0.0}

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                full_gc["t"] = time.perf_counter()
            else:
                full_gc["ms"] += (time.perf_counter() - full_gc["t"]) * 1e3

    gc.callbacks.append(on_gc)
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
        gc.callbacks.remove(on_gc)
    prof["gc2_ms"] = full_gc["ms"]
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


def check_binds(cache, cfg, before=None, gone=()):
    """Feasibility, capacity and gang atomicity of the FakeBinder result.
    Capacity counts the tasks running at open that were not evicted (an
    evicted victim's request is released) plus every bind but those of
    the pods in ``gone`` (deleted since they were bound)."""
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
        if key in gone:
            continue
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
    (and K1's first call on a dirty round, "score_round_dirty") keeps a
    copy of its inputs."""
    from volcano_tpu_torch.bench.round_cases import _clone
    from volcano_tpu_torch.ops import kernels as K
    from volcano_tpu_torch.ops import rounds

    seen = {}
    real = {n: getattr(rounds, n) for n in ("score_round", "window_topk")}

    def wrap(name):
        def fn(*args, **kw):
            key = name
            if name == "score_round" and not K.round_is_full(args[0], int(args[8])):
                key = "score_round_dirty"
            if key not in seen:
                seen[key] = (list(_clone(tuple(args))), _clone(kw))
            return real[name](*args, **kw)
        return fn

    for name in real:
        setattr(rounds, name, wrap(name))

    def restore():
        for name, f in real.items():
            setattr(rounds, name, f)
    return seen, restore


# the rounds solver's K2b and K6 groups (their kernels' wrappers, K2b's
# with the cover's torch argsort and gather), timed call by call on a cfg5
# session of the host-driven machine; inside the solve's graph they run
# as captured nodes
GROUP_ROWS = {
    "K2b": ("_cap_walk", "_nominate_full"),
    "K6": ("_job_rank",),
}


def tensor_bytes(x):
    if isinstance(x, torch.Tensor):
        return nbytes(x)
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    return 0


def count_group_calls():
    """Wrap the group rows' functions: calls per session, CUDA events
    around each call (the span on the stream from its first launch to its
    last), and the bytes of the first call's tensor arguments and results
    (without the encoded fields they read, so their bound is a lower
    one)."""
    from volcano_tpu_torch.ops import rounds

    calls, first, events = {}, {}, {}
    real = {n: getattr(rounds, n) for ns in GROUP_ROWS.values() for n in ns}

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
                first[name] = tensor_bytes(args) + tensor_bytes(list(kw.values())) \
                    + tensor_bytes(out)
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
    from volcano_tpu_torch.bench import round_cases
    from volcano_tpu_torch.ops import kernels as K
    from volcano_tpu_torch.ops import rounds
    from volcano_tpu_torch.ops import rounds_kernels as RK

    # these sessions run the step machine from the host (loop="host"), so
    # every wrapper call is an eager launch whose inputs can be copied and
    # whose groups can be timed one call at a time (inside the graph a
    # wrapper is called once, at the capture)
    graph_solve, graph_dispatch = rounds.solve, rounds.dispatch_packed
    rounds.solve = lambda spec, enc, loop=None, raw=True: graph_solve(spec, enc, "host", raw)
    rounds.dispatch_packed = lambda spec, enc, bound=None: graph_solve(spec, enc, "host")[1]
    seen, restore = capture_inputs()
    try:
        run_session(5, scale, "cuda", "float32")
        src = {k: "cfg5" for k in seen}
        if "score_round_dirty" not in seen:
            # cfg5 placed everything before any dirty round: take that
            # round's inputs from cfg2's path, which rescores
            run_session(2, scale, "cuda", "float32")
    finally:
        restore()
    # the group rows on a second, warm cfg5 session (the first one pays
    # the process's lazy CUDA set-up inside its first calls)
    calls, first, events, restore_ops = count_group_calls()
    try:
        run_session(5, scale, "cuda", "float32")
    finally:
        restore_ops()
        rounds.solve, rounds.dispatch_packed = graph_solve, graph_dispatch
    torch.cuda.synchronize()
    rows = {}
    for row, names in GROUP_ROWS.items():
        byts = sum(first.get(n, 0) for n in names)
        spans = [a.elapsed_time(b) for n in names for a, b in events.get(n, ())]
        rows[row] = {"functions": list(names),
                     "launches": sum(calls.get(n, 0) for n in names),
                     "ms_per_session": sum(spans),
                     "ms_per_call": sum(spans) / max(len(spans), 1),
                     "bytes": byts, "bound_ms": byts / MEM_BPS * 1e3,
                     "bound_by": "bytes"}
    print(json.dumps({"group_rows": rows, "session": "cfg5 (warm)"}), flush=True)
    missing = {"score_round", "score_round_dirty", "window_topk"} - set(seen)
    if missing:
        raise AssertionError(f"cfg5 and cfg2 paths never called {sorted(missing)}")
    records = []

    # K1's round entry on a full round (cfg5's first) and a dirty one
    # (cfg2's); its full-refresh entry (K16a's) on the full round's state
    for key in ("score_round", "score_round_dirty"):
        args, _ = seen[key]
        round_cases.hold_score_round(args, f"{key} ({src.get(key, 'cfg2')})")
        records.append(score_round_record(key, args, src.get(key, "cfg2")))
    spec, enc, idle, used, cnt, occ = seen["score_round"][0][:6]
    got = torch.full_like(seen["score_round"][0][6], 7.0)
    K.score_block(spec, enc, idle, used, cnt, occ, got)
    same(_bits(got), _bits(K.score_block_plain(spec, enc, idle, used, cnt, occ)),
         "score_block (full refresh, cfg5)")

    # K2, on the cfg5 capture, then on crafted rows and shapes
    (scores, k), _ = seen["window_topk"]
    same_window(scores, k, "cfg5 capture")
    window_crafted_cases()
    ms, lib_ms, wrapper_ms = window_times(scores, k)
    records.append(dict(
        name="window_topk", kernel="window_topk", route="cuda",
        source="volcano_tpu_torch/csrc/window_topk.cu",
        replaces="volcano_tpu/ops/rounds.py:754", max_abs_err=0.0,
        ms=ms, plain_ms=time_ms(lambda: RK.window_topk_plain(scores, k)),
        library_ms=lib_ms,
        bytes=nbytes(scores) + scores.shape[0] * k * (scores.element_size() + 4),
        ops=scores.numel(), dtype=scores.dtype,
        shape=f"K={scores.shape[0]} N={scores.shape[1]} k={k}, "
              f"{window_cluster(*scores.shape)} CTAs a row; wrapper "
              f"{wrapper_ms:.4f} ms a call"))
    # cfg6's shape (one CTA a row), timed beside torch.topk
    k6 = window_cfg6_k()
    s6 = window_scores(512, 1000, scores.dtype, seed=6)
    same_window(s6, k6, "cfg6 shape")
    ms6, lib6, wrap6 = window_times(s6, k6)
    print(json.dumps({"kernel": "window_topk", "shape": f"K=512 N=1000 k={k6} (cfg6), "
                      f"{window_cluster(512, 1000)} CTA a row",
                      "ms": ms6, "library_ms": lib6, "wrapper_ms": wrap6,
                      "plain_ms": time_ms(lambda: RK.window_topk_plain(s6, k6))}),
          flush=True)

    for rec in records:
        finish_record(rec)
    return records


def score_round_bytes(args):
    """(bytes, operations, columns rescored) of one K1 round launch: the
    class rows, eps, is_scalar, binpack_w and the weights read once; a
    rescored column's idle, used and alloc rows, cnt and nmax, and its
    sig_mask and affinity entries for the signatures (and occupancy for
    the exclusion groups) the class rows use, read once, its K scores
    written; a clean column's dirty flag and K carried scores read; the
    dirty count read and the K counts written."""
    from volcano_tpu_torch.ops import kernels as K

    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = args[:10]
    k, n = scores.shape
    r, esz = idle.shape[1], idle.element_size()
    full = K.round_is_full(spec, int(n_dirty))
    m = n if full else int(dirty.sum())
    sigs = int(torch.unique(enc["cls_sig"]).numel())
    groups = int(torch.unique(enc["cls_excl"][enc["cls_excl"] >= 0]).numel()) \
        if spec.use_exclusion else 0
    col = 3 * r * esz + 8 + sigs * (1 + esz) + groups + k * esz
    rows = nbytes(*(enc[x] for x in ("cls_req", "cls_initreq", "cls_sig", "cls_nz_cpu",
                                     "cls_nz_mem", "cls_has_pod", "eps", "is_scalar",
                                     "binpack_w")))
    rows += 4 * esz + (nbytes(enc["cls_excl"]) if spec.use_exclusion else 0)
    clean = 0 if full else (n - m) * (1 + k * esz) + m
    return rows + m * col + clean + 4 + 4 * k, k * m * K1_OPS(r), m


def score_round_record(name, args, src):
    """The kernels-line record of K1's round entry on ``args``: the launch
    timed 20 calls in a CUDA graph, the plain version once."""
    from volcano_tpu_torch.ops import kernels as K

    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = args[:10]
    s_t, f_t = scores.clone(), n_feas.clone()
    acc = torch.zeros(n_feas.shape[0] + 1, dtype=torch.int32, device=scores.device)
    weights = K.score_weights(enc)
    ms = graph_ms(lambda: K.score_round(spec, enc, idle, used, cnt, occ, s_t, dirty,
                                        n_dirty, f_t, weights, acc))
    wrapper_ms = host_ms(lambda: K.score_round(spec, enc, idle, used, cnt, occ, s_t,
                                               dirty, n_dirty, f_t, weights, acc))
    s_p, f_p = scores.clone(), n_feas.clone()
    _, plain_ms = timed_plain(lambda: K.score_round_plain(spec, enc, idle, used, cnt, occ,
                                                          s_p, dirty, n_dirty, f_p))
    byts, ops, m = score_round_bytes(args)
    k, n = scores.shape
    return dict(
        name=name, kernel="score_round", route="cuda",
        source="volcano_tpu_torch/csrc/score_block.cu",
        replaces="volcano_tpu/ops/rounds.py:708", max_abs_err=0.0,
        ms=ms, host_ms=wrapper_ms, plain_ms=plain_ms, bytes=byts, ops=ops,
        dtype=idle.dtype, library_ms=None, launch_path=5,
        shape=f"{src} {'full' if m == n else 'dirty'} round: K={k} N={n} R={idle.shape[1]}, "
              f"{m} columns rescored (dirty_k {spec.dirty_k}); 20 calls in a graph")


def window_times(scores, k):
    """K2's launch into outputs and scratch allocated once (the kernel as
    the rounds graph replays it), torch.topk into preallocated outputs
    (``out=``, the same work), and K2's wrapper a call (allocation and the
    launch), each over 20 calls after 3 warm-ups."""
    from volcano_tpu_torch.ops import rounds_kernels as RK

    rows = scores.shape[0]
    top_s = torch.empty((rows, k), dtype=scores.dtype, device=scores.device)
    top_i = torch.empty((rows, k), dtype=torch.int32, device=scores.device)
    scratch = torch.empty(3 * rows * k, dtype=torch.int32, device=scores.device)
    vals = torch.empty((rows, k), dtype=scores.dtype, device=scores.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=scores.device)
    ms = time_ms(lambda: RK.window_topk_launch(scores, k, top_s, top_i, scratch))
    lib_ms = time_ms(lambda: torch.topk(scores, k, dim=1, out=(vals, idx)))
    wrapper_ms = time_ms(lambda: RK.window_topk(scores, k))
    return ms, lib_ms, wrapper_ms


def window_cluster(rows, n):
    """The CTAs K2's launcher gives a row at this shape."""
    import ctypes

    from volcano_tpu_torch import _build

    fn = _build.library("window_topk").window_topk_cluster
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(rows, n)


def window_scores(rows, n, dtype, seed, levels=40, p_inf=0.3):
    """Scores as a solve has them: a few dozen distinct values (most nodes
    tie with many others), a share of -inf, and signed zeros."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vals = np.floor(rng.random((rows, n)) * levels) * 2.5
    vals[rng.random((rows, n)) < p_inf] = -np.inf
    zero = rng.random((rows, n)) < 0.05
    vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    f = np.float64 if dtype == torch.float64 else np.float32
    return torch.tensor(vals.astype(f), device="cuda")


def window_cfg6_k():
    """cfg6's window width as its solve sizes it, or 256 where cfg6 sweeps
    the full width (window 0)."""
    return solve_inputs(6, 1.0)[0].window_k or 256


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def same_window(scores, k, what):
    """K2 == its plain version, values compared by their bits."""
    from volcano_tpu_torch.ops import rounds_kernels as RK

    s1, i1 = RK.window_topk(scores, k)
    s2, i2 = RK.window_topk_plain(scores, k)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(_bits(s1), _bits(s2))):
        bad = (i1 != i2).nonzero()[:8].tolist()
        raise AssertionError(f"window_topk ({what}): kernel != plain at {bad}")


def window_crafted_cases():
    """K2 == plain on crafted rows (signed zeros either way round, all
    tied, all -inf, -inf ties ahead of a feasible tail, last-bit
    neighbours), N not a power of two, k = N/2 and k = N, cfg6's shape,
    in float32 and float64."""
    import numpy as np
    from volcano_tpu_torch.ops import rounds_kernels as RK

    inf = np.inf
    for dt, f in ((torch.float32, np.float32), (torch.float64, np.float64)):
        one, zero, tiny = f(1.0), f(0.0), np.finfo(f).tiny
        up, down = np.nextafter(one, f(2.0)), np.nextafter(one, zero)
        rows = [[-0.0, 0.0, -0.0, 0.0, 1.0, -inf] + [-inf] * 10,
                [0.0, -0.0, 0.0, -0.0, -inf, 1.0] + [-0.0, 0.0] * 5,
                [-0.0] * 8 + [0.0] * 8, [-0.0, 0.0] * 8, [3.0] * 16, [-inf] * 16,
                [-inf] * 12 + [1.0, -0.0, 0.0, 1.0],
                [one, up, down, one, tiny, -tiny, -zero, zero, up,
                 np.nextafter(tiny, one), -zero, -inf, zero, down, -tiny, one]]
        crafted = torch.tensor(np.asarray(rows, dtype=f), device="cuda")
        for k in (1, 3, 8, 16):
            same_window(crafted, k, f"crafted rows {dt} k={k}")
        _, idx = RK.window_topk(crafted, 16)
        if idx[0, :6].tolist() != [4, 1, 3, 0, 2, 5]:
            raise AssertionError(f"window_topk: signed-zero order {idx[0, :6].tolist()}")
        for rows_n, n, k in ((16, 10000, 1024), (16, 10007, 1024), (16, 10000, 5000),
                             (4, 3001, 3001), (512, 1000, 256)):
            sc = window_scores(rows_n, n, dt, seed=n + k)
            sc[0] = 2.5                     # every entry tied
            sc[-1, : n // 2] = -inf         # -inf ties ahead of a feasible tail
            same_window(sc, k, f"{rows_n}x{n} k={k} {dt}")
    print(json.dumps({"window_topk_crafted": "signed zeros, ties, -inf, last-bit "
                      "neighbours, N odd, k=N/2, k=N, cfg6 shape: float32 and "
                      "float64 == plain"}), flush=True)


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
    line = {"kernel": rec["name"], "shape": rec["shape"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "library_ms": rec["library_ms"]}
    if "graph_ms" in rec:
        line["graph_ms"] = rec["graph_ms"]  # 20 calls in a CUDA graph
    if "host_ms" in rec:
        line["host_ms"] = rec["host_ms"]    # the wrapper's host time a call
    print(json.dumps(line), flush=True)


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
        extra = {}
        if kind == "backfill":
            used = ("sig_mask", "node_cnt", "node_max", "b_sig", "b_has_pod", "b_real")
            s_rows, n = enc["sig_mask"].shape
            t_total = enc["b_sig"].shape[0]
            extra = dict(graph_ms=graph_ms(lambda: EK.backfill(spec, enc)),
                         host_ms=host_ms(lambda: EK.backfill(spec, enc)))
            # pod counts only rise, so the first feasible node of each
            # (signature, has_pod) never moves back: one cursor each walks
            # the node axis once (mask, count test, and), plus a lookup and
            # a bump per task
            ops = (2 if spec.check_pod_count else 1) * s_rows * n * 3 + t_total * 4
            shape = (f"T={t_total} S={s_rows} N={n} ({src}), "
                     f"{EK.backfill_placement(n, s_rows, t_total)} placement, "
                     f"{int((got >= 0).sum())} placed")
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
            if kind == "preempt":
                shape += cluster_layout(kind, enc, ms, stats["walks"], "walk")
            else:
                shape += cluster_layout(kind, enc, ms, stats["folds"], "fold")
        rec = dict(
            name=name, kernel=name, route="cuda",
            source=f"volcano_tpu_torch/csrc/{name}.cu", replaces=replaces,
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=nbytes(*(enc[k] for k in used)) + nbytes(got), ops=ops,
            dtype=enc["node_used"].dtype if "node_used" in enc else torch.int32,
            shape=shape, **extra)
        finish_record(rec)
        records.append(rec)
    backfill_crafted_phase()
    return records


def backfill_crafted_phase():
    """K11 on bench/backfill_cases.py's crafted inputs: each case in the
    placement its sizes choose and, widened by all-false node columns, in
    the global placement; one launch a call, torch.equal to the plain
    version on the card."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench import backfill_cases
    from volcano_tpu_torch.ops import evict_kernels as EK

    t0 = time.perf_counter()
    held = []
    for name, check_pod, arrays in backfill_cases.cases():
        spec = backfill_cases.spec(check_pod)
        s_rows, n = arrays["sig_mask"].shape
        t_total = arrays["b_sig"].shape[0]
        variants = [arrays]
        if EK.backfill_placement(n, s_rows, t_total) == "shared":
            variants.append(backfill_cases.widen_nodes(arrays, backfill_cases.global_width(s_rows)))
        for a in variants:
            enc = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
            where = EK.backfill_placement(a["sig_mask"].shape[1], s_rows, t_total)
            devmod.reset_launches()
            got = EK.backfill(spec, enc)
            torch.cuda.synchronize()
            if devmod.launches()["evict_backfill"] != 1:
                raise AssertionError(f"evict_backfill {name} ({where}): "
                                     f"{devmod.launches()['evict_backfill']} launches")
            same(got, EK.backfill_plain(spec, enc), f"evict_backfill {name} ({where})")
            held.append(f"{name} ({where})")
    log(f"evict_backfill: crafted cases equal to plain, one launch each: "
        f"{', '.join(held)} ({time.perf_counter() - t0:.1f} s)")


def cluster_layout(kind, enc, ms, units, unit):
    """K9's or K10's launch at these inputs: the CTAs of its cluster, a
    CTA's static shared memory (ptxas -v, from the build's log) and dynamic
    shared memory (the launcher's plan; or the global buffer its node
    slices take where they do not fit), and microseconds a unit of work (a
    preempt walk, a reclaim fold)."""
    import re

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.ops import evict_kernels as EK

    n, v = enc["vic_job"].shape
    dt = enc["node_used"].dtype
    layout = EK.preempt_layout if kind == "preempt" else EK.reclaim_layout
    cluster, dyn, spill = layout(n, v, dt)
    tag = ("IdLi" if dt == torch.float64 else "IfLi") + f"{v if v in EK.K9_V else 0}E"
    static, entry = None, ""
    for line in _build.build_log(f"evict_{kind}").splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "bytes smem" in line and tag in entry:
            static = int(re.search(r"(\d+) bytes smem", line).group(1))
    where = f"{dyn} dynamic bytes" if not spill else f"node slices in {spill} global bytes"
    return (f" cluster={cluster} CTAs, smem a CTA {static} static + {where}, "
            f"{ms * 1000 / max(units, 1):.2f} us a {unit}")


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
            wrapper_ms = host_ms(lambda: EK.fuse_heaps(kind, spec, enc, st, *args, **kw))
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
                max_abs_err=0.0, ms=ms, host_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None,
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
                   f"ops={tail[0]} victims={tail[2]} attempts={tail[3]} ({src}, fused)"
                   + (cluster_layout(kind, enc, ms, stats["walks"], "walk") if kind == "preempt"
                      else cluster_layout(kind, enc, ms, stats["folds"], "fold"))))
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
    from volcano_tpu_torch.bench.reclaim_path import EVICT_ACTIONS

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


ALLOC_KERNELS = ("score_round", "window_topk", "resolve_prefix", "queue_budget",
                 "queue_budget_mask", "rounds_ctl", "round_select", "round_commit",
                 "cap_walk", "job_rank", "job_rank_count")
EVICT_KERNELS = ("evict_preempt", "evict_reclaim", "evict_backfill")
FUSED_KERNELS = ("fuse_heaps_preempt", "fuse_heaps_reclaim", "evict_preempt_fused",
                 "evict_reclaim_fused")
# the kernels each per-action path must launch (and, for the allocate-only
# configs, the eviction kernels they must not); cfg4's reclaim finds no
# pending task once preempt has pipelined them all, so K10 is the reclaim
# path's
PATH_KERNELS = {
    2: ALLOC_KERNELS, 3: ALLOC_KERNELS, 5: ALLOC_KERNELS,
    6: ALLOC_KERNELS + ("tail_pass",),
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


def check_launches(cfg, prof, counts, fused, cold=False):
    """Every kernel of the path launched (the fused chain's exactly once),
    and none of another path. ``cold``: the run captured a solve graph,
    whose build runs every graph body once eagerly first."""
    # K2 is on the path only when the solve used a candidate window
    # (window_k 0 means full-width sweeps, as cfg4 runs)
    alloc = [k for k in ALLOC_KERNELS if k != "window_topk" or prof.get("window_k")]
    alloc += ["tail_pass"] if cfg == 6 else []
    if fused:
        need = (alloc if cfg == 4 else []) + list(FUSED_ONCE[cfg])
        wrong = {k: counts[k] for k in FUSED_ONCE[cfg] if counts[k] != 1}
        wrong.update({k: counts[k] for k in EVICT_KERNELS + FUSED_KERNELS
                      if k not in FUSED_ONCE[cfg] and counts[k]})
    else:
        need = [k for k in PATH_KERNELS[cfg] if k in EVICT_KERNELS or k in alloc]
        bad = FUSED_KERNELS + (EVICT_KERNELS if cfg not in FUSED_ONCE else ())
        wrong = {k: counts[k] for k in bad if counts[k]}
        if cfg == 6 and counts["tail_pass"] != 1 + int(cold):
            # the capped cfg6 solve runs its whole tail in one K7b launch
            wrong["tail_pass"] = counts["tail_pass"]
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
    out = {"session_ms": wall * 1e3, "gc2_ms": prof["gc2_ms"], "action_ms": action_ms,
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
    """cfg2/3/5/6 at ``scale``, twice each; cfg4 and the reclaim path always
    at full width, twice on the fused chain (the first run captures the
    fused kernels' inputs) and once per-action (capturing K9/K10/K11's).
    Every rounds solve is a graph replay: the first session of a bucket
    captures it, the second must capture nothing."""
    from volcano_tpu_torch.ops import rounds_graph

    launches, captured = {}, {}
    for cfg in (2, 3, 5, 6, 4, "reclaim"):
        evicting = cfg in (4, "reclaim")
        src = "cfg4" if cfg == 4 else "reclaim path"
        plan = ([(True, capture_fused), (True, None), (False, capture_evict)]
                if evicting else [(True, None), (True, None)])
        runs = []
        for i, (fuse, capture) in enumerate(plan):
            caps0 = rounds_graph.STATS["captures"]
            seen, restore = capture() if capture is not None else ({}, None)
            try:
                cache, prof, counts, n_tasks, wall, action_ms, before = run_session(
                    cfg, 1.0 if evicting or cfg == 6 else scale, "cuda", "float32",
                    fuse=fuse)
            finally:
                if restore is not None:
                    restore()
            captured.setdefault(src, {}).update(seen)
            cold = rounds_graph.STATS["captures"] != caps0
            if i == 1 and cold:
                raise AssertionError(f"cfg{cfg}: a warm session of the bucket "
                                     "captured a graph")
            if prof.get("mode") != "rounds":
                raise AssertionError(f"cfg{cfg}: mode {prof.get('mode')}: {prof}")
            check_launches(cfg, prof, counts, fuse and evicting, cold)
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
        # the launches of the warm session (the first one of a bucket also
        # counts its graph build's eager pass)
        launches[cfg] = runs[1][3]
        line = {
            "cfg": cfg, "tasks": n_tasks, "nodes": prof.get("nodes"),
            "placed": prof.get("placed"), "binds": len(binds),
            "evicts": len(evicts), "rounds": prof.get("rounds"),
            "sync_points": prof["session_devprof"]["tpu_sync_points"],
            "tail_placed": prof.get("tail_placed"),
            "round_capped": prof.get("round_capped"),
            "window_k": prof.get("window_k"), "dirty_k": prof.get("dirty_k"),
            "full_sweep_rounds": prof.get("full_sweep_rounds"),
            "encode_ms": prof["encode_s"] * 1e3,
            "solve_ms": prof["solve_s"] * 1e3,
            "apply_ms": prof["apply_s"] * 1e3,
            "session_ms": wall * 1e3, "gc2_ms": prof["gc2_ms"],
            "launches": counts, "deterministic": True}
        if evicting:
            launches[(cfg, "per_action")] = runs[2][3]
            line["fused"] = split(prof, wall, action_ms)
            line["per_action"] = split(runs[2][2], runs[2][5], runs[2][6])
            line["launches_per_action"] = runs[2][3]
            line["fused_equals_per_action"] = True
        print(json.dumps(line), flush=True)
    return launches, captured


# ---------------------------------------------------------------------------
# K7: the rounds solve's loop on the card (one graph replay a solve)
# ---------------------------------------------------------------------------

K7_CFGS = (2, 3, 5, 6)


def probe_versions():
    """torch, CUDA and driver versions, and whether torch itself offers
    conditional-node capture (the port makes its own nodes either way)."""
    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    info = {"torch": torch.__version__, "cuda": torch.version.cuda, "driver": drv,
            "torch_if_node_capture": hasattr(torch.cuda.CUDAGraph,
                                             "begin_capture_to_if_node")}
    print(json.dumps({"versions": info}), flush=True)
    return info


def solve_inputs(cfg, scale, device="cuda", dtype="float32"):
    """(spec, staged encode) of the allocate solve a session of ``cfg``
    prepares (the solver's own encode, pad and staging)."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session

    cache, *_ = build_config(cfg, scale)
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    if prep is None or prep["mode"] != "rounds":
        raise AssertionError(f"cfg{cfg}: no rounds solve prepared")
    return prep["spec"], prep["staged"]


def record_host_machine():
    """Wrap the host-driven machine's controller and tail so that a
    ``loop="host"`` solve records each controller input (the host copy of
    ctl before the fold) and the tail's inputs."""
    from volcano_tpu_torch.ops import rounds_kernels as RK

    seen = {"ctl": [], "tail": None}
    real_ctl, real_tail = RK._ctl_fold_decide, RK.tail_pass_plain

    def ctl(c, params):
        seen["ctl"].append((list(c), params))
        return real_ctl(c, params)

    def tail(spec, enc, st, c):
        seen["tail"] = (spec, {k: v.clone() for k, v in enc.items()},
                        {k: v.clone() for k, v in st.items()}, c.clone())
        return real_tail(spec, enc, st, c)

    RK._ctl_fold_decide, RK.tail_pass_plain = ctl, tail

    def restore():
        RK._ctl_fold_decide, RK.tail_pass_plain = real_ctl, real_tail
    return seen, restore


def timed_solve(spec, enc, loop):
    """One solve and its fetch, timed with CUDA events around the solve's
    enqueue and the device work; returns (packed result on the host, raw,
    device ms, the devprof counters of the solve and its fetch, with the
    host ms the solve call held as dispatch_ms)."""
    from volcano_tpu_torch.ops import rounds
    from volcano_tpu_torch.utils import devprof

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    counters = {}
    with devprof.session(counters):
        start.record()
        t0 = time.perf_counter()
        raw, packed = rounds.solve(spec, enc, loop=loop)
        counters["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
        end.record()
        out = devprof.fetch(packed)
    torch.cuda.synchronize()
    return out, raw, start.elapsed_time(end), counters


def rounds_loop_phase():
    """K7: cfg2, cfg3, cfg5 and cfg6 at full scale (cfg6 caps and runs the
    tail pass only there, where its class axis spans several chunks).
    Each solve by the bucket's graph (a cold one that captures, then a
    warm one that must not) is torch.equal to the host-driven step
    machine on the card (loop="host": the plain controller and tail), with
    one sync point (the fetch); K7a is held against its plain version on
    every controller input the host run recorded, K7b on the cfg6 tail's
    inputs. Returns (records of K7a and K7b, the K7 row)."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.ops import rounds_kernels as RK

    from volcano_tpu_torch.bench import round_cases
    from volcano_tpu_torch.bench.kernel_profile import replay_ms

    scale = 1.0
    rows, ctl_inputs, tail_inputs, recorded = [], [], None, {}
    for cfg in K7_CFGS:
        spec, enc = solve_inputs(cfg, scale)
        seen, restore = record_host_machine()
        try:
            host, _, host_ms, host_dp = timed_solve(spec, enc, "host")
        finally:
            restore()
        ctl_inputs += seen["ctl"]
        if cfg in ROUND_KERNEL_CFGS:
            recorded[cfg] = round_cases.record_solve(spec, enc, limit=24)
        caps0 = rounds_graph.STATS["captures"]
        cap_s0 = rounds_graph.STATS["capture_s"]
        devmod.reset_launches()
        cold, _, cold_ms, cold_dp = timed_solve(spec, enc, None)
        cold_launch = devmod.launches()
        captured = rounds_graph.STATS["captures"] - caps0
        capture_ms = (rounds_graph.STATS["capture_s"] - cap_s0) * 1e3
        devmod.reset_launches()
        warm, raw, warm_ms, warm_dp = timed_solve(spec, enc, None)
        launch = devmod.launches()
        if captured != 1 or rounds_graph.STATS["captures"] != caps0 + 1:
            raise AssertionError(f"K7 cfg{cfg}: {captured} captures cold, "
                                 "the warm solve must capture nothing")
        for name, got in (("cold", cold), ("warm", warm)):
            if not (got.shape == host.shape and (got == host).all()):
                bad = int((got != host).sum()) if got.shape == host.shape else -1
                raise AssertionError(f"K7 cfg{cfg}: the {name} graph solve differs from "
                                     f"loop=host at {bad} entries")
        for name, dp in (("cold", cold_dp), ("warm", warm_dp)):
            if dp["tpu_sync_points"] != 1 or dp["tpu_d2h_fetches"] != 1:
                raise AssertionError(f"K7 cfg{cfg}: the {name} solve made "
                                     f"{dp['tpu_sync_points']} sync points")
        capped, tail_placed = bool(raw[4]), int(raw[2])
        if launch["rounds_ctl"] < 2 or launch["tail_pass"] != int(capped):
            raise AssertionError(f"K7 cfg{cfg}: launches {launch}")
        # K7a once a pass of the graph's loop (the steps and the last
        # pass, as many as the host run's controller calls: the IF nodes
        # it set ran the host run's steps), K1 once a round
        if launch["rounds_ctl"] != len(seen["ctl"]) or launch["score_round"] != int(raw[1]):
            raise AssertionError(f"K7 cfg{cfg}: {launch['rounds_ctl']} K7a launches for "
                                 f"{len(seen['ctl'])} controller calls, "
                                 f"{launch['score_round']} K1 for {int(raw[1])} rounds")
        if cfg == 6:
            if not capped or tail_placed <= 0 or seen["tail"] is None:
                raise AssertionError(f"K7 cfg6: must cap and place in the tail "
                                     f"(capped {capped}, tail_placed {tail_placed})")
            tail_inputs = seen["tail"]
        row = {"k7": f"cfg{cfg}@{scale}", "card": CARD, "rounds": int(raw[1]),
               "capped": capped, "tail_placed": tail_placed,
               "full_sweeps": int(raw[3]), "steps": len(seen["ctl"]) - 1,
               "graph_solve_ms_cold": cold_ms, "graph_solve_ms_warm": warm_ms,
               "graph_dispatch_ms_warm": warm_dp["dispatch_ms"],
               "capture_ms": capture_ms,
               "host_loop_ms": host_ms, "host_loop_sync_points": host_dp["tpu_sync_points"],
               "graph_sync_points": warm_dp["tpu_sync_points"], "continuations": 0,
               "captures": captured, "launches": {k: v for k, v in launch.items() if v},
               "launches_cold": {k: v for k, v in cold_launch.items() if v},
               "inputs_bytes": nbytes(*enc.values()) + nbytes(torch.from_numpy(warm))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    # K3 and K7c on the select and commit inputs of the host-driven cfg2,
    # cfg5 (window and cover) and cfg6 (exclusion) solves, and crafted ones
    round_recs = round_kernel_records(recorded)
    print(json.dumps({"k7_graphs": {
        "graphs_cached": rounds_graph.graphs_cached(),
        "captures": rounds_graph.STATS["captures"],
        "capture_ms": rounds_graph.STATS["capture_s"] * 1e3}}), flush=True)

    # K7a on every recorded controller input
    dev = torch.device("cuda")
    for c, params in ctl_inputs:
        ctl = torch.tensor(c, dtype=torch.int32, device=dev)
        pred = torch.zeros(RK.NPRED, dtype=torch.bool, device=dev)
        RK.rounds_ctl(ctl, pred, params)
        want_c = list(c)
        want_p = RK._ctl_fold_decide(want_c, params)
        same(ctl.cpu(), torch.tensor(want_c, dtype=torch.int32), "rounds_ctl ctl")
        same(pred.cpu(), torch.tensor(want_p, dtype=torch.bool), "rounds_ctl pred")
    c0, params0 = ctl_inputs[len(ctl_inputs) // 2]
    ctl = torch.tensor(c0, dtype=torch.int32, device=dev)
    pred = torch.zeros(RK.NPRED, dtype=torch.bool, device=dev)
    # a launch's device time, 20 in a CUDA graph (the fold repeated on the
    # same vector), beside the eager launch the record keeps
    print(json.dumps({"kernel": "rounds_ctl", "card": CARD, "graph_ms": graph_ms(
        lambda: RK.rounds_ctl(ctl, pred, params0))}), flush=True)
    ctl.copy_(torch.tensor(c0, dtype=torch.int32))
    ctl_rec = dict(
        name="rounds_ctl", kernel="rounds_ctl", route="cuda",
        source="volcano_tpu_torch/csrc/rounds_ctl.cu",
        replaces="volcano_tpu/ops/rounds.py:925", max_abs_err=0.0,
        ms=time_ms(lambda: RK.rounds_ctl(ctl, pred, params0)),
        plain_ms=timed_plain(lambda: RK._ctl_fold_decide(list(c0), params0))[1],
        library_ms=None, bytes=2 * (RK.CTL_LEN * 4 + RK.NPRED), ops=64,
        dtype=torch.int32, launch_path=5,
        shape=f"{len(ctl_inputs)} controller inputs of cfg{K7_CFGS} held equal")

    # K7b on the cfg6 tail's inputs
    spec6, tenc, st0, ctl0 = tail_inputs

    def fresh():
        return {k: v.clone() for k, v in st0.items()}, ctl0.clone()

    st_p, c_p = fresh()
    _, tail_plain_ms = timed_plain(lambda: RK.tail_pass_plain(spec6, tenc, st_p, c_p))
    # K7b in the placement cfg6's sizes take (the state and class columns
    # staged in shared memory)
    st_k, c_k = fresh()
    RK.tail_pass(spec6, tenc, st_k, c_k)
    for name in st_k:
        same(st_k[name], st_p[name], f"tail_pass {name}")
    same(c_k, c_p, "tail_pass ctl")
    # and in the global placement: the same tail with its node axis tiled
    # to 12,000 nodes (round_cases.widen_nodes), too large to stage
    wenc, wst0 = round_cases.widen_nodes(tenc, st0, 12_000)
    if RK.tail_placement(wenc["task_cls"].shape[0], 12_000, wst0["idle"].shape[1],
                         wenc["job_tie_rank"].shape[0], wenc["queue_deserved"].shape[0],
                         wst0["ns_alloc"].shape[0], wenc["cls_req"].shape[0],
                         wst0["idle"].dtype) != "global":
        raise AssertionError("tail_pass: 12,000 nodes should take the global placement")
    w_p, wc_p = {k: v.clone() for k, v in wst0.items()}, ctl0.clone()
    RK.tail_pass_plain(spec6, wenc, w_p, wc_p)
    w_k, wc_k = {k: v.clone() for k, v in wst0.items()}, ctl0.clone()
    RK.tail_pass(spec6, wenc, w_k, wc_k)
    for name in w_k:
        same(w_k[name], w_p[name], f"tail_pass {name} (global placement)")
    same(wc_k, wc_p, "tail_pass ctl (global placement)")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    eager = []
    for _ in range(5):
        st_t, c_t = fresh()
        torch.cuda.synchronize()
        a.record()
        RK.tail_pass(spec6, tenc, st_t, c_t)
        b.record()
        torch.cuda.synchronize()
        eager.append(a.elapsed_time(b))
    # the launch's device time (the record's ms): K7b captured once in a
    # CUDA graph, the recorded state put back before each replay, CUDA
    # events around the replay alone (the eager calls above also time the
    # wrapper's host work)
    st_g, c_g = fresh()
    RK.tail_pass(spec6, tenc, st_g, c_g)

    def reset():
        for k, v in st0.items():
            st_g[k].copy_(v)
        c_g.copy_(ctl0)

    reps = replay_ms(lambda: RK.tail_pass(spec6, tenc, st_g, c_g), reset)
    for name in st_g:
        same(st_g[name], st_p[name], f"tail_pass {name} (graph replay)")
    same(c_g, c_p, "tail_pass ctl (graph replay)")
    retired = int((st0["active"] & ~st_p["active"]).sum())
    t_n, (n_n, r_n) = tenc["task_cls"].shape[0], st0["idle"].shape
    placement = RK.tail_placement(t_n, n_n, r_n, tenc["job_tie_rank"].shape[0],
                                  tenc["queue_deserved"].shape[0], st0["ns_alloc"].shape[0],
                                  tenc["cls_req"].shape[0], st0["idle"].dtype)
    steps = retired + int(retired < RK.tail_budget(spec6) and bool(st_p["active"].any()))
    tail_rec = dict(
        name="tail_pass", kernel="tail_pass", route="cuda",
        source="volcano_tpu_torch/csrc/tail_pass.cu",
        replaces="volcano_tpu/ops/rounds.py:980", max_abs_err=0.0,
        ms=sum(reps) / len(reps), plain_ms=tail_plain_ms, library_ms=None,
        bytes=nbytes(*(tenc[k] for k, _ in RK.TAIL_INPUTS))
        + 2 * nbytes(*(v for k, v in st0.items()
                       if k in dict(RK.TAIL_STATE))),
        ops=steps * (t_n * 8 + n_n * (30 + 12 * r_n)), dtype=st0["idle"].dtype,
        launch_path=6,
        shape=f"cfg6 tail: T={t_n} N={n_n} R={r_n}, {steps} steps, "
              f"{int(c_p[RK.C_TAIL_PLACED])} placed; state in {placement} memory; "
              f"one launch in a graph (eager call {sum(eager) / len(eager):.4f} ms)")
    for rec in (ctl_rec, tail_rec):
        finish_record(rec)
    print(json.dumps({"kernel": "tail_pass", "card": CARD, "placement": placement,
                      "graph_ms": reps, "eager_ms": eager}), flush=True)
    warm5 = next(r for r in rows if r["k7"].startswith("cfg5"))
    k7_row = {"solve_ms": warm5["graph_solve_ms_warm"], "host_loop_ms": warm5["host_loop_ms"],
              "sync_points": warm5["graph_sync_points"],
              "bound_ms": warm5["inputs_bytes"] / MEM_BPS * 1e3,
              "capture_ms": warm5["capture_ms"]}
    print(json.dumps({"K7": k7_row, "card": CARD}), flush=True)
    return [ctl_rec, tail_rec] + round_recs, k7_row


# the K7 solves whose select and commit inputs K3 and K7c are held on
ROUND_KERNEL_CFGS = (2, 3, 5, 6)
SELECT_OUT = ("choice", "cons_choice", "slot", "final", "uncovered")
# the state a commit reads and writes
COMMIT_STATE = ("idle", "used", "cnt", "active", "job_placed", "job_alloc",
                "queue_alloc", "ns_alloc")


def commit_bytes(spec, tc, st, choice, accept, ctl):
    """The bytes one commit must move: each task's choice, mask, request,
    job, queue and namespace read once (and its exclusion group where the
    spec has exclusion), the jobs' task ranges, the state it updates read
    and written once, the control vector; written only: the accepted
    tasks' assign (and exclusion occupancy), the dirty row."""
    placed = int(accept.sum())
    cols = ("task_req", "task_job", "task_queue", "task_ns", "job_task_start",
            "job_task_count") + (("task_excl",) if spec.use_exclusion else ())
    written = placed * st["assign"].element_size() + nbytes(st["dirty"])
    if spec.use_exclusion:
        written += int((accept & (tc["task_excl"] >= 0)).sum()) * st["excl_occ"].element_size()
    return (nbytes(choice, accept, *(tc[n] for n in cols))
            + 2 * nbytes(*(st[n] for n in COMMIT_STATE), ctl) + written)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def hold_select(args, kw, what):
    from volcano_tpu_torch.ops import rounds_kernels as RK

    got = RK.round_select(*args, **kw)
    want = RK.round_select_plain(*args, **kw)
    for name, a, b in zip(SELECT_OUT, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"round_select {what}: {name} missing")
        if b is not None:
            same(a, b, f"round_select {what} {name}")


def hold_commit(args, what, rollback=False):
    """K7c on the card (the commit, or with ``rollback`` the rollback's
    undo) against its plain version on CPU copies of the same inputs, on
    one thread: the plain version's serial CPU semantics (a
    row's float updates added one after another in task order, to the
    row's value, as XLA's scatter adds them) are the ones the kernel
    keeps; torch's CUDA index_put_ adds a row's duplicates up first."""
    from volcano_tpu_torch.bench.round_cases import _clone
    from volcano_tpu_torch.ops import rounds_kernels as RK

    spec, tc, st, *rest, ctl = args
    kernel, plain = ((RK.round_rollback, RK.round_rollback_plain) if rollback
                     else (RK.round_commit, RK.round_commit_plain))
    st_k, ctl_k = _clone(st), ctl.clone()
    kernel(spec, tc, st_k, *rest, ctl_k)
    st_p, ctl_p = _to_cpu(_clone(st)), ctl.cpu()
    # one thread: torch's CPU index_put_ adds float32 rows with atomics
    # from several threads past 32k elements, in no fixed order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain(spec, _to_cpu(tc), st_p, *(_to_cpu(x) for x in rest), ctl_p)
    finally:
        torch.set_num_threads(threads)
    for name in st_p:
        got, want = st_k[name].cpu(), st_p[name]
        if got.is_floating_point():  # by their bits: -0.0 is not +0.0
            got, want = _bits(got), _bits(want)
        same(got, want, f"round_commit {what} {name}")
    same(ctl_k.cpu(), ctl_p, f"round_commit {what} ctl")


def round_kernel_records(recorded):
    """K3 round_select and K7c round_commit held against their plain
    versions (torch.equal) on every select, commit and rollback call the
    recorded host-driven solves made, then on the crafted inputs of
    bench/round_cases.py; each timed on cfg5's calls (K3 its window and
    its cover, K7c its commit of 50k tasks and its rollback step), cfg2's
    beside, with the wrapper's host time a call (``host_ms``: CUDA events
    over back-to-back calls read the longer of host and card; inside the
    graph only the card's counts). Returns the two records."""
    from volcano_tpu_torch.bench import round_cases
    from volcano_tpu_torch.ops import rounds_kernels as RK

    held = {"select": 0, "commit": 0, "rollback": 0, "score": 0}
    for cfg, seen in recorded.items():
        if not seen["select"] or not seen["commit"] or not seen["score"]:
            raise AssertionError(f"K7 cfg{cfg}: no score, select or commit call recorded")
        for i, (args, _) in enumerate(seen["score"]):
            round_cases.hold_score_round(args, f"cfg{cfg} round {i}")
            held["score"] += 1
        for i, (args, kw) in enumerate(seen["select"]):
            hold_select(args, kw, f"cfg{cfg} call {i}")
            held["select"] += 1
        for i, (args, _) in enumerate(seen["commit"]):
            hold_commit(args, f"cfg{cfg} call {i}")
            held["commit"] += 1
        for i, (args, _) in enumerate(seen["rollback"]):
            hold_commit(args, f"cfg{cfg} rollback {i}", rollback=True)
            held["rollback"] += 1
    for label, args, kw in round_cases.select_cases("cuda", torch.float32):
        hold_select(args, kw, f"crafted {label}")
    for label, args in round_cases.commit_cases("cuda", torch.float32):
        hold_commit(args, f"crafted {label}")
    for label, args in round_cases.rollback_cases("cuda", torch.float32):
        hold_commit(args, f"crafted rollback {label}", rollback=True)
    widths = {}
    for cfg in (5, 2):
        for args, kw in recorded[cfg]["select"]:
            key = (cfg, "window" if kw.get("coverage") else "cover")
            widths.setdefault(key, (args, kw))
    recs = []
    # K3: timed on cfg5's window call, its cover and cfg2's window beside
    (args, kw) = widths[(5, "window")]
    for key, (a, k) in sorted(widths.items()):
        if key != (5, "window"):
            print(json.dumps({"kernel": "round_select", "shape": f"cfg{key[0]} {key[1]} "
                              f"(K={a[4].shape[0]} W={a[4].shape[1]} T={a[2].shape[0]})",
                              "card": CARD, "ms": time_ms(lambda: RK.round_select(*a, **k)),
                              "plain_ms": timed_plain(lambda: RK.round_select_plain(*a, **k))[1]}),
                  flush=True)
    spec, corder, active, n_feas, order, walk = args
    t_n, (k_n, w_n) = active.shape[0], order.shape
    recs.append(dict(
        name="round_select", kernel="round_select", route="cuda",
        source="volcano_tpu_torch/csrc/round_select.cu",
        replaces="volcano_tpu/ops/rounds.py:336", max_abs_err=0.0,
        ms=time_ms(lambda: RK.round_select(*args, **kw)),
        host_ms=host_ms(lambda: RK.round_select(*args, **kw)),
        plain_ms=timed_plain(lambda: RK.round_select_plain(*args, **kw))[1],
        library_ms=None,
        bytes=nbytes(active, n_feas, order, *walk,
                     *(corder[n] for n in ("cls_excl", "perm", "off", "chunk_first",
                                           "excl_perm", "excl_start", "excl_pos")))
        + 16 * t_n + k_n,
        ops=t_n * (max(1, w_n.bit_length()) + 24), dtype=torch.int32, launch_path=5,
        shape=f"cfg5 window: K={k_n} W={w_n} T={t_n}; {held['select']} recorded calls "
              f"of cfg{ROUND_KERNEL_CFGS} and {len(round_cases.SELECT_CASES)} crafted held equal"))
    # K7c: timed on cfg5's commit (the wrapper: its sort and the launch)
    spec, tc, st, choice, accept, did_full, ctl = recorded[5]["commit"][0][0]
    st_t, ctl_t = round_cases._clone(st), ctl.clone()
    st_p, ctl_p = round_cases._clone(st), ctl.clone()
    placed = int(accept.sum())
    r_n = st["idle"].shape[1]
    for a2 in recorded[2]["commit"][:1]:
        spec2, tc2, st2, ch2, acc2, df2, c2 = a2[0]
        st2k, st2p = round_cases._clone(st2), round_cases._clone(st2)
        print(json.dumps({"kernel": "round_commit", "card": CARD,
                          "shape": f"cfg2 round 1: T={ch2.shape[0]}, {int(acc2.sum())} accepted",
                          "ms": time_ms(lambda: RK.round_commit(spec2, tc2, st2k, ch2, acc2,
                                                                df2, c2.clone())),
                          "plain_ms": timed_plain(lambda: RK.round_commit_plain(
                              spec2, tc2, st2p, ch2, acc2, df2, c2.clone()))[1]}), flush=True)
    # its rollback mode on cfg5's rollback step (no gang to retire)
    for a3 in recorded[5]["rollback"][:1]:
        spec3, tc3, st3, rj3, ac3, c3 = a3[0]
        st3k, st3p = round_cases._clone(st3), round_cases._clone(st3)
        print(json.dumps({"kernel": "round_commit", "card": CARD,
                          "shape": f"cfg5 rollback: T={tc3['task_job'].shape[0]}, "
                                   f"{int(rj3.sum())} job retired",
                          "ms": time_ms(lambda: RK.round_rollback(spec3, tc3, st3k, rj3, ac3,
                                                                  c3.clone())),
                          "plain_ms": timed_plain(lambda: RK.round_rollback_plain(
                              spec3, tc3, st3p, rj3, ac3, c3.clone()))[1]}), flush=True)
    recs.append(dict(
        name="round_commit", kernel="round_commit", route="cuda",
        source="volcano_tpu_torch/csrc/round_commit.cu",
        replaces="volcano_tpu/ops/rounds.py:838", max_abs_err=0.0,
        ms=time_ms(lambda: RK.round_commit(spec, tc, st_t, choice, accept, did_full, ctl_t)),
        host_ms=host_ms(lambda: RK.round_commit(spec, tc, st_t, choice, accept, did_full,
                                                ctl_t)),
        plain_ms=timed_plain(lambda: RK.round_commit_plain(
            spec, tc, st_p, choice, accept, did_full, ctl_p))[1],
        library_ms=None,
        bytes=commit_bytes(spec, tc, st, choice, accept, ctl),
        ops=placed * r_n * 5, dtype=st["idle"].dtype, launch_path=5,
        shape=f"cfg5 round 1: T={choice.shape[0]} N={st['idle'].shape[0]} R={r_n}, "
              f"{placed} accepted; {held['commit']} recorded commits, "
              f"{held['rollback']} recorded rollbacks and "
              f"{2 * len(round_cases.COMMIT_CASES) + 1} crafted held equal (plain on the CPU)"))
    # K1's round entry at cfg6's K = 512 (its first round)
    k512 = score_round_record("score_round_k512", recorded[6]["score"][0][0], "cfg6")
    k512["shape"] += f"; {held['score']} recorded rounds of cfg{ROUND_KERNEL_CFGS} held equal"
    recs.append(k512)
    recs += acceptance_records(recorded)
    recs += walk_rank_records(recorded)
    for rec in recs:
        finish_record(rec)
    return recs


def resolve_bytes(args):
    """The bytes one K4 call must move: the order, each task's choice and
    pod flag, the request rows of the tasks with a choice, the idle row,
    cnt and nmax of each node chosen, read once; the accept flags written."""
    order, choice, req_i, has_pod, idle, unit, eps_i, is_scalar, cnt, nmax, _ = args
    t, r = req_i.shape
    feas = choice >= 0
    nodes = int(torch.unique(choice[feas]).numel())
    return (nbytes(order, choice, has_pod, unit, eps_i, is_scalar) + t
            + int(feas.sum()) * r * 8 + nodes * (r * idle.element_size() + 8))


def budget_bytes(args, mask_only=False):
    """The bytes one K5 call must move: each task's accept flag and job
    (and the request rows of the accepted tasks), the job order, each
    job's queue and the queues' rows read once, the flags written; the
    mask alone reads accept, task_job and a decision a job."""
    accept, task_job, req_i, jq, job_queue, queue_alloc, unit, bound, is_scalar = args
    t, r = req_i.shape
    if mask_only:
        return nbytes(accept, task_job) + jq.shape[0] + t
    return (nbytes(accept, task_job, jq, job_queue, queue_alloc, unit, bound, is_scalar)
            + int(accept.sum()) * r * 8 + t)


def acceptance_records(recorded):
    """K4 resolve_prefix and K5 queue_budget (its two launches) held
    against their plain versions (torch.equal) on every call the recorded
    host-driven solves made (cfg2's rounds, R = 3; cfg3's ten queues;
    cfg5; cfg6) and on the crafted inputs of bench/round_cases.py in
    float32 and float64; each timed on cfg2's first and a later round,
    cfg3's and cfg5's call: its device time (``ms``, 20 calls in a CUDA
    graph), the wrapper a call under CUDA events (``wrapper_ms``: back to
    back, they read the longer of host and card) and its host time
    (``host_ms``). Returns the records of K4, K5 and K5's mask at cfg5."""
    from volcano_tpu_torch.bench import round_cases
    from volcano_tpu_torch.ops import rounds_kernels as RK

    held = {"resolve": 0, "budget": 0}
    kinds = {"resolve": (RK.resolve_prefix, RK.resolve_prefix_plain),
             "budget": (RK.queue_budget, RK.queue_budget_plain)}
    for cfg, seen in recorded.items():
        for kind, (kernel, plain) in kinds.items():
            if not seen[kind]:
                raise AssertionError(f"K7 cfg{cfg}: no {kind} call recorded")
            for i, (args, _) in enumerate(seen[kind]):
                same(kernel(*args), plain(*args), f"{kind} cfg{cfg} call {i}")
                held[kind] += 1
    crafted = 0
    for dt in (torch.float32, torch.float64):
        for label, args in round_cases.resolve_cases("cuda", dt):
            same(RK.resolve_prefix(*args), RK.resolve_prefix_plain(*args),
                 f"resolve crafted {label} {dt}")
            crafted += 1
        for label, args in round_cases.budget_cases("cuda", dt):
            same(RK.queue_budget(*args), RK.queue_budget_plain(*args),
                 f"budget crafted {label} {dt}")
            crafted += 1
    # timed: cfg2's first and a later round, cfg3, cfg5
    lines = {}
    for cfg, which in ((2, 0), (2, -1), (3, 0), (5, 0)):
        for kind, (kernel, plain) in kinds.items():
            args = recorded[cfg][kind][which][0]
            line = {"kernel": kind, "card": CARD,
                    "call": f"cfg{cfg} {'round 1' if which == 0 else 'a later round'}",
                    "ms": graph_ms(lambda: kernel(*args)),
                    "wrapper_ms": time_ms(lambda: kernel(*args)),
                    "host_ms": host_ms(lambda: kernel(*args)),
                    "plain_ms": timed_plain(lambda: plain(*args))[1]}
            if kind == "resolve":
                line["shape"] = (f"T={args[0].shape[0]} R={args[2].shape[1]} "
                                 f"N={args[4].shape[0]}, {int((args[1] >= 0).sum())} chosen")
                line["bound_ms"] = resolve_bytes(args) / MEM_BPS * 1e3
            else:
                line["shape"] = (f"T={args[0].shape[0]} R={args[2].shape[1]} "
                                 f"J={args[3].shape[0]} Q={args[5].shape[0]}, "
                                 f"{int(args[0].sum())} accepted")
                line["bound_ms"] = budget_bytes(args) / MEM_BPS * 1e3
                RK.queue_budget(*args)
                line["mask_ms"] = graph_ms(lambda: RK.queue_budget(*args, parts=("mask",)))
            lines[(cfg, which, kind)] = line
            print(json.dumps({"k4_k5": line}), flush=True)
    note = (f"{held['resolve']} recorded K4 calls and {held['budget']} K5 calls of "
            f"cfg{ROUND_KERNEL_CFGS}, {crafted} crafted held equal")
    r_args = recorded[5]["resolve"][0][0]
    b_args = recorded[5]["budget"][0][0]
    r5, b5 = lines[(5, 0, "resolve")], lines[(5, 0, "budget")]
    recs = [
        dict(name="resolve_prefix", kernel="resolve_prefix", route="cuda",
             source="volcano_tpu_torch/csrc/resolve_prefix.cu",
             replaces="volcano_tpu/ops/rounds.py:442", max_abs_err=0.0,
             ms=r5["ms"], host_ms=r5["host_ms"], plain_ms=r5["plain_ms"],
             library_ms=None, bytes=resolve_bytes(r_args),
             ops=r_args[2].numel() * 4, dtype=torch.int64, launch_path=5,
             shape=f"cfg5: {r5['shape']}; {note}"),
        dict(name="queue_budget", kernel="queue_budget", route="cuda",
             source="volcano_tpu_torch/csrc/queue_budget.cu",
             replaces="volcano_tpu/ops/rounds.py:495", max_abs_err=0.0,
             ms=b5["ms"], host_ms=b5["host_ms"], plain_ms=b5["plain_ms"],
             library_ms=None, bytes=budget_bytes(b_args),
             ops=b_args[2].numel() * 2, dtype=torch.int64, launch_path=5,
             shape=f"cfg5 (both launches): {b5['shape']}"),
        dict(name="queue_budget_mask", kernel="queue_budget_mask", route="cuda",
             source="volcano_tpu_torch/csrc/queue_budget.cu",
             replaces="volcano_tpu/ops/rounds.py:548", max_abs_err=0.0,
             ms=b5["mask_ms"], plain_ms=b5["plain_ms"], library_ms=None,
             bytes=budget_bytes(b_args, mask_only=True), ops=b_args[0].shape[0],
             dtype=torch.int32, launch_path=5,
             shape=f"cfg5, the mask alone (plain: the whole of K5): T={b_args[0].shape[0]}"),
    ]
    return recs


def walk_bytes(args):
    """The bytes one K2b call must move: each position's node and score,
    the rows' requests and flags, the idle rows (and with the pod check the
    pod counts) of the distinct nodes the positions name, read once; four
    int32 a position written."""
    spec, order, score_ord, req, exl, has_pod, frac, idle, cnt, nmax, eps, _ = args
    rows, w = order.shape
    nodes = int(torch.unique(order).numel())
    per_node = idle.shape[1] * idle.element_size() + (8 if spec.check_pod_count else 0)
    return (nbytes(order, score_ord, req, eps, exl if spec.use_exclusion else None,
                   frac if spec.use_binpack else None,
                   has_pod if spec.check_pod_count else None)
            + nodes * per_node + 16 * rows * w)


def rank_bytes(args):
    """The bytes one K6 call must move: the tie ranks and the columns of
    the job-order keys the spec names (priorities; the gang columns and
    placed counts; the allocation rows and drf totals), read once; rank
    (int32) and order (int64) written."""
    spec, cols, placed, alloc = args
    keys = set(spec.job_order_keys)
    read = [cols["job_tie_rank"]]
    if "priority" in keys:
        read.append(cols["job_priority"])
    if "gang" in keys:
        read += [cols["job_ready_base"], cols["job_min_available"], placed]
    if "drf" in keys:
        read += [alloc, cols["drf_total"], cols["drf_present"]]
    return nbytes(*read) + 12 * placed.shape[0]


def walk_rank_records(recorded):
    """K2b cap_walk and K6 job_rank held against their plain versions
    (torch.equal) on every call the recorded host-driven solves made
    (cfg2's window, cfg3, cfg5's window and its full-width cover, cfg6's
    exclusion classes; the round's and the rollback's ranks) and on the
    crafted inputs of bench/round_cases.py in float32 and float64; each
    timed on the first call of cfg2, cfg3, cfg5 and cfg6 (K2b: of the
    window and of the full width): device ms (20 calls in a CUDA graph), the wrapper a
    call under CUDA events, its host time, the plain version, the bytes
    bound. Returns the records of K2b (cfg5's window) and K6 (cfg5)."""
    from volcano_tpu_torch.bench import round_cases
    from volcano_tpu_torch.ops import rounds_kernels as RK

    def hold_walk(args, what):
        for name, a, b in zip(("ccap", "g_start", "g_size", "ccap_before"),
                              RK.cap_walk(*args), RK.cap_walk_plain(*args)):
            same(a, b, f"cap_walk {what} {name}")

    def hold_rank(args, what):
        for name, a, b in zip(("rank", "order"), RK.job_rank(*args), RK.job_rank_plain(*args)):
            same(a, b, f"job_rank {what} {name}")

    held = {"walk": 0, "ranks": 0}
    for cfg, seen in recorded.items():
        for kind, hold in (("walk", hold_walk), ("ranks", hold_rank)):
            if not seen[kind]:
                raise AssertionError(f"K7 cfg{cfg}: no {kind} call recorded")
            for i, (args, _) in enumerate(seen[kind]):
                hold(args, f"cfg{cfg} call {i}")
                held[kind] += 1
    crafted = 0
    for dt in (torch.float32, torch.float64):
        for label, args in round_cases.walk_cases("cuda", dt):
            hold_walk(args, f"crafted {label} {dt}")
            crafted += 1
        for label, args in round_cases.rank_cases("cuda", dt):
            hold_rank(args, f"crafted {label} {dt}")
            crafted += 1
    # each config's first walk of the window and of the full width (the
    # cover, or every round without a window), and its first ranks
    calls = {}
    for cfg, seen in recorded.items():
        for args, _ in seen["walk"]:
            part = "full width" if args[1].shape[1] == args[7].shape[0] else "window"
            calls.setdefault(("walk", cfg, part), args)
        calls[("ranks", cfg, "")] = seen["ranks"][0][0]
    lines = {}
    for key, args in sorted(calls.items(), key=str):
        kind, cfg, part = key
        kernel, plain = ((RK.cap_walk, RK.cap_walk_plain) if kind == "walk"
                         else (RK.job_rank, RK.job_rank_plain))
        line = {"kernel": "cap_walk" if kind == "walk" else "job_rank", "card": CARD,
                "call": f"cfg{cfg} {part}".strip(),
                "ms": graph_ms(lambda: kernel(*args)),
                "wrapper_ms": time_ms(lambda: kernel(*args)),
                "host_ms": host_ms(lambda: kernel(*args)),
                "plain_ms": timed_plain(lambda: plain(*args))[1]}
        if kind == "walk":
            line["shape"] = (f"rows={args[1].shape[0]} W={args[1].shape[1]} "
                             f"N={args[7].shape[0]} R={args[7].shape[1]}")
            line["bound_ms"] = walk_bytes(args) / MEM_BPS * 1e3
        else:
            line["shape"] = f"J={args[2].shape[0]} keys={'/'.join(args[0].job_order_keys)}"
            line["bound_ms"] = rank_bytes(args) / MEM_BPS * 1e3
            # the count alone: the call less its tile sorts (a count needs
            # the sorts just before it)
            line["tiles_ms"] = graph_ms(lambda: RK.job_rank(*args, count=False))
            line["count_ms"] = line["ms"] - line["tiles_ms"]
        lines[key] = line
        print(json.dumps({"k2b_k6": line}), flush=True)
    note = (f"{held['walk']} recorded K2b calls and {held['ranks']} K6 calls of "
            f"cfg{tuple(recorded)}, {crafted} crafted held equal")
    w_args, w5 = calls[("walk", 5, "window")], lines[("walk", 5, "window")]
    cover = lines.get(("walk", 5, "full width"))
    r_args, r5 = calls[("ranks", 5, "")], lines[("ranks", 5, "")]
    rows, w = w_args[1].shape
    j = r_args[2].shape[0]
    words = RK.rank_words(r_args[0], j, r_args[3].dtype)
    tiles = -(-j // 512)
    return [
        dict(name="cap_walk", kernel="cap_walk", route="cuda",
             source="volcano_tpu_torch/csrc/cap_walk.cu",
             replaces="volcano_tpu/ops/rounds.py:190", max_abs_err=0.0,
             ms=w5["ms"], host_ms=w5["host_ms"], plain_ms=w5["plain_ms"], library_ms=None,
             bytes=walk_bytes(w_args), ops=rows * w * (2 * w_args[7].shape[1] + 12),
             dtype=w_args[7].dtype, launch_path=5,
             shape=f"cfg5 window: {w5['shape']}"
                   + (f"; its cover ({cover['shape']}) {cover['ms']:.4f} ms" if cover else "")
                   + f"; {note}"),
        dict(name="job_rank", kernel="job_rank", route="cuda",
             source="volcano_tpu_torch/csrc/job_rank.cu",
             replaces="volcano_tpu/ops/rounds.py:91", max_abs_err=0.0,
             ms=r5["ms"], host_ms=r5["host_ms"], plain_ms=r5["plain_ms"], library_ms=None,
             bytes=rank_bytes(r_args), ops=j * max(1, (j - 1).bit_length()) * 6,
             dtype=torch.int64, launch_path=5, shape=f"cfg5 (both launches): {r5['shape']}"),
        dict(name="job_rank_count", kernel="job_rank_count", route="cuda",
             source="volcano_tpu_torch/csrc/job_rank.cu",
             replaces="volcano_tpu/ops/rounds.py:91", max_abs_err=0.0,
             ms=r5["count_ms"], plain_ms=r5["plain_ms"], library_ms=None,
             bytes=2 * 8 * words * j + 12 * j, ops=j * tiles * 9 * words,
             dtype=torch.int64, launch_path=5,
             shape=f"cfg5, the count alone (both launches less the tile sorts' "
                   f"{r5['tiles_ms']:.4f} ms; plain: the whole of K6): J={j}"),
    ]


# ---------------------------------------------------------------------------
# the express lane, the device replica, K8 and K14
# ---------------------------------------------------------------------------

EXPRESS_WARM, EXPRESS_MEASURED = 16, 96
CARD = ""  # nvidia-smi's name and power limit, set by main


def oversized_backlog(cache, cpu, jobs=8):
    """Pending one-pod jobs of ``cpu`` cores, more than any node of the
    config holds until one grows: every session keeps encoding them, so
    the solver serves the replica every session, as an overcommitted
    backlog does."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group

    for g in range(jobs):
        pg = f"huge-{g:03d}"
        cache.add_pod_group(build_pod_group(pg, namespace="backlog", min_member=1))
        cache.add_pod(build_pod("backlog", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                                {"cpu": cpu, "memory": "1Gi"}, pg))


def plain_session(cache, tiers, actions, replica=True):
    """One session through the port's normal entry; returns its profile.
    The scheduler's round-robin node cursor is process-wide: each cache
    keeps its own (``cache._smoke_rr``), so twins run as if alone."""
    import os

    from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
    from volcano_tpu_torch.scheduler.util import scheduler_helper

    prev = os.environ.get("VOLCANO_TPU_REPLICA")
    os.environ["VOLCANO_TPU_REPLICA"] = "1" if replica else "0"
    scheduler_helper._last_processed_node_index = getattr(cache, "_smoke_rr", 0)
    try:
        ssn = open_session(cache, tiers)
        run_actions(ssn, list(actions))
        prof = dict(ssn.plugins["tpuscore"].profile) if "tpuscore" in ssn.plugins else {}
        close_session(ssn)
    finally:
        cache._smoke_rr = scheduler_helper._last_processed_node_index
        if prev is None:
            del os.environ["VOLCANO_TPU_REPLICA"]
        else:
            os.environ["VOLCANO_TPU_REPLICA"] = prev
    return prof


def tpu_tiers(cfg, device="cuda", dtype="float32"):
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_tiers

    return make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={"tpuscore": {
        "tpuscore.mode": "rounds", "tpuscore.device": device, "tpuscore.dtype": dtype}})


def assert_mirror(rep, what):
    """The replica's standing tensors equal its host mirror bit for bit,
    and no serve healed an error (an ``error:<kind>`` rebuild)."""
    import numpy as np

    errors = {k: v for k, v in rep.stats["rebuilds"].items() if k.startswith("error:")}
    if errors:
        raise AssertionError(f"{what}: replica errors {errors}")
    for name, dev in rep.dev.items():
        want = torch.from_numpy(np.ascontiguousarray(rep.mirror[name]))
        if not torch.equal(dev.cpu(), want):
            raise AssertionError(f"{what}: standing {name} != mirror")


def express_lane_phase(scale=1.0, device="cuda", dtype="float32"):
    """cfg5 (50k tasks x 10k nodes) under bench.py --express's traffic: a
    settling session, one drain, then 16 warm and 96 measured batches of
    the Poisson arrivals of one 20 ms period at 50 jobs/s (at least one),
    each job one pod of 100m or 250m cpu and 128Mi or 256Mi (seed 7), one
    full 64-task batch, and a reconciling session. Returns (summary,
    launches of the measured batches, captured K14 inputs, the lane)."""
    import random
    import statistics

    from volcano_tpu_torch import _build
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.express import ExpressLane
    from volcano_tpu_torch.express import place as place_mod
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group

    import gc

    cache, _, _, actions, n_tasks = build_config(5, scale)
    tiers = tpu_tiers(5, device, dtype)
    lane = ExpressLane(cache, device=device, dtype=dtype)
    # every collector pass from the settling session on: [where (the
    # session, the drain, the batch: warm ones negative), generation, ms]
    gc_log, gc_where, gc_t0 = [], ["settle"], {}

    def gc_trace(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0:
            gc_log.append([gc_where[0], info["generation"],
                           round((time.perf_counter() - gc_t0.pop("t")) * 1e3, 4)])

    gc.callbacks.append(gc_trace)
    t0 = time.perf_counter()
    plain_session(cache, tiers, actions)
    torch.cuda.synchronize()
    settle_ms = (time.perf_counter() - t0) * 1e3
    gc_where[0] = "drain"
    lane.run_once()  # drain the backlog notifications (all bound)

    rng = random.Random(7)
    counter = [0]

    def submit(n):
        for _ in range(n):
            counter[0] += 1
            pg = f"xpr-{counter[0]:05d}"
            cache.add_pod_group(build_pod_group(pg, namespace="express", min_member=1))
            cache.add_pod(build_pod(
                "express", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([100, 250])}m",
                 "memory": rng.choice(["128Mi", "256Mi"])}, pg))

    def burst():
        n, budget = 0, 0.02
        while True:
            gap = rng.expovariate(50.0)
            if gap > budget and n > 0:
                break
            budget -= gap
            n += 1
        submit(max(n, 1))
        return max(n, 1)

    captured = {}
    real = place_mod.solve_express

    def capture(spec, *args):
        key = f"tb{spec.tb}"
        if key not in captured:
            captured[key] = (spec, [a.clone() for a in args])
        return real(spec, *args)

    # host-clock split of each batch: classification, axis refresh, column
    # staging (K8), dispatch (batch arrays, K14, the fetch), commit
    from volcano_tpu_torch.express import commit as commit_mod

    spent = {}

    def timed(fn, part):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[part] = spent.get(part, 0.0) + (time.perf_counter() - t) * 1e3
        return wrapped

    # the collector's pauses inside each batch (gc.callbacks)
    gc_t = {}

    def gc_probe(phase, info):
        if phase == "start":
            gc_t["t"] = time.perf_counter()
        elif "t" in gc_t:
            key = f"gc{info['generation']}"
            spent[key] = spent.get(key, 0.0) + (time.perf_counter() - gc_t.pop("t")) * 1e3

    real_commit = commit_mod.commit_batch
    lane._classify = timed(lane._classify, "classify")
    lane.state.refresh = timed(lane.state.refresh, "refresh")
    lane.state.stage = timed(lane.state.stage, "stage")
    lane._dispatch = timed(lane._dispatch, "dispatch")
    commit_mod.commit_batch = timed(real_commit, "commit")
    parts = []

    builds = []
    real_start = _build._start
    place_mod.solve_express = capture
    lat, sizes, fetches, reps = [], [], [], []
    try:
        for it in range(EXPRESS_WARM + EXPRESS_MEASURED):
            gc_where[0] = it - EXPRESS_WARM
            if it == EXPRESS_WARM:
                gc_sizes = [len(gc.get_objects(g)) for g in range(3)]
                gc_counts = list(gc.get_count())
                torch.cuda.synchronize()
                devmod.reset_launches()
                gc.callbacks.append(gc_probe)
                _build._start = lambda name: builds.append(name) or real_start(name)
            size = burst()
            spent.clear()
            rep = lane.run_once()
            if rep["batches"] != 1:
                raise AssertionError(f"express batch {it}: {rep}")
            if it >= EXPRESS_WARM:
                lat.append(rep["ms"])
                sizes.append(size)
                fetches.append(rep["profile"]["tpu_d2h_fetches"])
                reps.append(rep)
                gcs = {k: v for k, v in spent.items() if k.startswith("gc")}
                main = {k: v for k, v in spent.items() if not k.startswith("gc")}
                parts.append(dict(spent, other=rep["ms"] - sum(main.values()),
                                  gc=sum(gcs.values())))
        counts = devmod.launches()
        gc.callbacks.remove(gc_probe)
        _build._start = real_start
        # one full batch: 64 one-pod jobs at once (tb = 64, window 256)
        submit(place_mod.EXPRESS_MAX_BATCH)
        full = lane.run_once()
    finally:
        place_mod.solve_express = real
        _build._start = real_start
        commit_mod.commit_batch = real_commit
        if gc_probe in gc.callbacks:
            gc.callbacks.remove(gc_probe)
        gc.callbacks.remove(gc_trace)
    if builds:
        raise AssertionError(f"express: kernels built after the warm batches: {builds}")
    if any(f != 1 for f in fetches):
        raise AssertionError(f"express: fetches per batch {fetches}")
    if counts["express_place"] != EXPRESS_MEASURED:
        raise AssertionError(f"express: {counts['express_place']} K14 launches for "
                             f"{EXPRESS_MEASURED} batches")
    if full["batches"] != 1 or full["placed"] != place_mod.EXPRESS_MAX_BATCH:
        raise AssertionError(f"express: the full batch {full}")
    t0 = time.perf_counter()
    plain_session(cache, tiers, actions)
    torch.cuda.synchronize()
    reconcile_ms = (time.perf_counter() - t0) * 1e3
    summ = lane.summary()
    if summ["counters"]["errors"] or summ["breaker"] != "closed":
        raise AssertionError(f"express: errors or breaker open: {summ}")
    if lane.state.stats["rebuilds"] != 1:
        raise AssertionError(f"express: state rebuilt {lane.state.stats}")
    if lane.outstanding:
        raise AssertionError(f"express: {len(lane.outstanding)} tokens outstanding")
    check_binds(cache, 5)
    assert_mirror(cache._device_replica, "express sessions")
    ordered = sorted(lat)

    def pick(q):
        return ordered[min(int(q * len(ordered)), len(ordered) - 1)]

    out = {
        "express": f"cfg5@{scale}", "card": CARD, "snapshot_tasks": n_tasks,
        "settle_session_ms": settle_ms, "reconcile_session_ms": reconcile_ms,
        "batches": len(lat), "arrivals": counter[0],
        "mean_batch": statistics.mean(sizes),
        "p50_ms": pick(0.5), "p99_ms": pick(0.99), "max_ms": ordered[-1],
        "placed": summ["counters"]["placed"], "deferred": summ["counters"]["deferred"],
        "reconciled": summ["counters"]["reconciled"],
        "reverted": summ["counters"]["reverted"],
        "full_sweep_steps": sum(r["full_sweep_steps"] for r in reps),
        "fetches_per_batch": statistics.mean(fetches),
        "sync_points_per_batch": statistics.mean(
            r["profile"]["tpu_sync_points"] for r in reps),
        "fetch_wait_ms_mean": statistics.mean(
            r["profile"]["tpu_fence_wait_ms"] for r in reps),
        "full_batch_ms": full["ms"], "full_batch_sweeps": full["full_sweep_steps"],
        "launches": {k: v for k, v in counts.items() if v},
        "split_ms_mean": {k: statistics.mean(p.get(k, 0.0) for p in parts)
                          for k in ("classify", "refresh", "stage", "dispatch",
                                    "commit", "other", "gc")},
        "max_batch_index": lat.index(ordered[-1]),
        "split_ms_of_max": parts[lat.index(ordered[-1])],
        # the collector's passes, and its generations' sizes and counts
        # when the measured batches began
        "gc_log": gc_log, "gc_sizes_at_start": gc_sizes, "gc_counts_at_start": gc_counts,
        "state": dict(lane.state.stats)}
    print(json.dumps(out), flush=True)
    if "tb16" not in captured or "tb64" not in captured:
        raise AssertionError(f"express: captured only {sorted(captured)}")
    return out, counts, captured, lane


def express_parity_phase():
    """A small float64 lane on the card against the same lane on the CPU,
    on one event sequence (waves of arrivals with a session between; a
    300-node axis takes the windowed path): the same reports, end state
    and state stats."""
    import random

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import DEFAULT_TIERS, make_cache, make_tiers
    from volcano_tpu_torch.express import ExpressLane
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_pod, build_pod_group, build_queue,
        build_resource_list_with_pods)

    def cluster(seed, n_nodes):
        rng = random.Random(seed)
        c = make_cache()
        for n in range(n_nodes):
            c.add_node(build_node(f"node-{n:03d}", build_resource_list_with_pods(
                rng.choice(["4", "8", "16"]), rng.choice(["8Gi", "16Gi", "32Gi"]),
                pods=rng.choice([3, 64]))))
        c.add_queue(build_queue("default"))
        return c

    def end_state(cache):
        tasks = {t.key: (int(t.status), t.node_name)
                 for j in cache.jobs.values() for t in j.tasks.values()}
        nodes = {n: (nd.used.milli_cpu, nd.used.memory) for n, nd in cache.nodes.items()}
        return tasks, nodes

    for seed, n_nodes in ((1, 12), (2, 300)):
        caches = {d: cluster(seed, n_nodes) for d in ("cuda", "cpu")}
        lanes = {d: ExpressLane(c, device=d, dtype=torch.float64) for d, c in caches.items()}
        rng = random.Random(seed)
        seq = 0
        for wave in range(3):
            shapes = []
            for _ in range(rng.randint(1, 9)):
                gang = rng.random() < 0.4
                shapes.append((f"job-{seq:03d}", rng.choice([2, 3]) if gang else 1,
                               2 if gang else 1, rng.choice(["250m", "2000m", "6000m"]),
                               rng.choice(["256Mi", "1Gi", "6Gi"])))
                seq += 1
            for c in caches.values():
                for name, tasks, mm, cpu, mem in shapes:
                    c.add_pod_group(build_pod_group(name, namespace="xp", min_member=mm,
                                                    phase=objects.PodGroupPhase.INQUEUE))
                    for i in range(tasks):
                        c.add_pod(build_pod("xp", f"{name}-t{i}", "", objects.POD_PHASE_PENDING,
                                            {"cpu": cpu, "memory": mem}, name))
            reps = {d: lanes[d].run_once() for d in lanes}
            keys = ("placed", "deferred", "batches", "full_sweep_steps", "reasons")
            if {k: reps["cuda"][k] for k in keys} != {k: reps["cpu"][k] for k in keys}:
                raise AssertionError(f"express parity {seed}/{wave}: {reps}")
            if wave == 1:
                for c in caches.values():
                    plain_session(c, make_tiers(*DEFAULT_TIERS), ("enqueue", "allocate", "backfill"))
        if end_state(caches["cuda"]) != end_state(caches["cpu"]):
            raise AssertionError(f"express parity {seed}: end states differ")
        sc, sp = lanes["cuda"].summary(), lanes["cpu"].summary()
        if sc["state"] != sp["state"] or sc["counters"] != sp["counters"]:
            raise AssertionError(f"express parity {seed}: {sc} vs {sp}")
        print(json.dumps({"express_parity": f"{n_nodes} nodes float64 cuda == cpu",
                          "placed": sc["counters"]["placed"],
                          "state": sc["state"]}), flush=True)


def grow_nodes(caches, names, cpu, memory, pods):
    """Raise the capacity of the named nodes in every cache (a node-row
    update the replica must scatter)."""
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_resource_list_with_pods)

    for cache in caches:
        for name in names:
            cache.add_node(build_node(name, build_resource_list_with_pods(
                cpu, memory, pods=pods)))


def landed_on(cache, before, names):
    """The binds made since ``before`` (a copy of binder.binds), and how
    many of them landed on the named nodes."""
    new = {k: n for k, n in cache.binder.binds.items() if k not in before}
    return new, sum(1 for n in new.values() if n in set(names))


def replica_phase(scale=1.0, device="cuda", dtype="float32"):
    """cfg5 with and without the replica: a cold serve, a settling
    session, an unchanged session (whole-encode reuse, no transfer), and a
    capacity update of 8 nodes to 96 cores (a node-family scatter of
    exactly those rows, on which the 64-core backlog then places: the
    solve must read the scattered rows). Binds equal replica-off after
    each session; the standing tensors equal the mirror. Returns
    (launches of the four replica-fed sessions, the replica)."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.ops import replica as replica_mod

    twins = {}
    for on in (True, False):
        cache, _, _, actions, n_tasks = build_config(5, scale)
        oversized_backlog(cache, "64")
        twins[on] = cache
    tiers = tpu_tiers(5, device, dtype)
    scattered = []
    real = replica_mod.DeviceReplica._scatter_family

    def spy(self, family, rows, arrays):
        scattered.append((family, list(rows)))
        return real(self, family, rows, arrays)

    replica_mod.DeviceReplica._scatter_family = spy
    counts = {k: 0 for k in devmod.LAUNCHES}
    lines = []
    try:
        for step in ("cold", "settle", "unchanged", "update8"):
            if step == "update8":
                names = sorted(twins[True].nodes)[:8]
                grow_nodes(twins.values(), names, "96", "64Gi", 256)
            before = dict(twins[True].binder.binds)
            del scattered[:]
            torch.cuda.synchronize()
            devmod.reset_launches()
            t0 = time.perf_counter()
            prof = plain_session(twins[True], tiers, actions)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            for k, v in devmod.launches().items():
                counts[k] += v
            prof_off = plain_session(twins[False], tiers, actions, replica=False)
            rep = twins[True]._device_replica
            if twins[True].binder.binds != twins[False].binder.binds:
                raise AssertionError(f"replica {step}: binds differ from replica-off")
            if prof.get("mode") != "rounds":
                raise AssertionError(f"replica {step}: {prof.get('fallback')}")
            assert_mirror(rep, f"replica {step}")
            if step == "unchanged" and not (prof.get("encode_reused") is True
                                            and prof.get("h2d_puts") == 0):
                raise AssertionError(f"replica unchanged: no reuse: {prof}")
            if step == "update8":
                node_rows = sorted(r for f, rows in scattered if f == "node" for r in rows)
                want = sorted(rep._node_names.index(n) for n in names)
                if node_rows != want:
                    raise AssertionError(f"replica update8: scattered {node_rows}, "
                                         f"changed {want}")
                new, on_grown = landed_on(twins[True], before, names)
                if not new or on_grown != len(new):
                    raise AssertionError(f"replica update8: {len(new)} binds, "
                                         f"{on_grown} on the grown nodes")
            line = {"replica": step, "card": CARD, "binds": len(twins[True].binder.binds),
                    "new_binds": len(twins[True].binder.binds) - len(before),
                    "session_ms": wall, "encode_reused": bool(prof.get("encode_reused")),
                    "h2d_puts": prof.get("h2d_puts"), "h2d_puts_off": prof_off.get("h2d_puts"),
                    "h2d_bytes": prof.get("h2d_bytes"), "h2d_bytes_off": prof_off.get("h2d_bytes"),
                    "encode_ms": prof["encode_s"] * 1e3, "encode_ms_off": prof_off["encode_s"] * 1e3,
                    "replica_serve_ms": prof.get("replica_serve_ms"),
                    "scattered": scattered[:], "rebuilds": dict(rep.stats["rebuilds"]),
                    "scatter_launches": devmod.launches()["scatter_rows"]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    finally:
        replica_mod.DeviceReplica._scatter_family = real
    return counts, twins[True]._device_replica


def preempt_terminal_phase(scale=1.0, device="cuda", dtype="float32"):
    """cfg4 (30k x 8k) with and without the replica: a preempt-terminal
    fused chain (allocate, backfill, preempt); then 8 nodes grow to 256
    cores, which lifts queue-a's proportional share above what it holds,
    and an allocate session must place its pending tasks on them. Binds and evictions equal replica-off in order;
    the standing tensors equal the mirror after each session (the chain
    hands the replica no carry: ops/replica.py)."""
    import os

    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.ops import replica as replica_mod

    twins = {on: build_config(4, scale)[0] for on in (True, False)}
    tiers = tpu_tiers(4, device, dtype)
    names = sorted(twins[True].nodes)[:8]
    prev = os.environ.get("VOLCANO_TPU_FUSE")
    os.environ["VOLCANO_TPU_FUSE"] = "1"
    try:
        out = {}
        for step, chain in (("chain", ("allocate", "backfill", "preempt")),
                            ("next", ("allocate",))):
            if step == "next":
                grow_nodes(twins.values(), names, "256", "512Gi", 256)
            a, b = twins[True], twins[False]
            before = dict(a.binder.binds)
            profs = {on: plain_session(c, tiers, chain, replica=on) for on, c in twins.items()}
            if step == "chain" and (profs[True].get("fuse") != 1
                                    or profs[True].get("fuse_stages") != list(chain)):
                raise AssertionError(f"preempt-terminal: the chain did not fuse: "
                                     f"{profs[True].get('fuse_fallback')}")
            if a.binder.binds != b.binder.binds or a.evictor.evicts != b.evictor.evicts:
                raise AssertionError(f"preempt-terminal {step}: differs from replica-off")
            rep = a._device_replica
            assert_mirror(rep, f"preempt-terminal {step}")
            out[step] = {"binds": len(a.binder.binds), "evicts": len(a.evictor.evicts)}
            if step == "next":
                new, on_grown = landed_on(a, before, names)
                if not on_grown:
                    raise AssertionError(f"preempt-terminal next: {len(new)} binds, "
                                         f"none on the grown nodes")
                out[step].update(new_binds=len(new), on_grown_nodes=on_grown)
    finally:
        if prev is None:
            del os.environ["VOLCANO_TPU_FUSE"]
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    out.update(rebuilds=rep.stats["rebuilds"], scatter_rows=rep.stats["scatter_rows"])
    print(json.dumps({"preempt_terminal": "cfg4 chain then allocate == replica-off",
                      "card": CARD, **out}), flush=True)
    replica_mod.detach(twins[True])


# ---------------------------------------------------------------------------
# the scheduler's own loop: K15 (parity mode), the pipeline, the loop
# ---------------------------------------------------------------------------

# operations of one examined node in a parity step beyond its R fit tests
# (signature mask, pod cap, and, the window's scan), and of one job row or
# queue/namespace row of a visit's lexicographic argmin (keys, comparator)
PARITY_NODE_OPS, LEX_ROW_OPS = 8, 12


def loop_conf(mode="rounds", device="cuda", dtype="float32"):
    """TPU_SCHEDULER_CONF with the tpuscore arguments of this run."""
    from volcano_tpu_torch.scheduler.scheduler import TPU_SCHEDULER_CONF

    return TPU_SCHEDULER_CONF.replace(
        "  - name: tpuscore\n",
        f"  - name: tpuscore\n    arguments:\n      tpuscore.mode: {mode}\n"
        f"      tpuscore.device: {device}\n      tpuscore.dtype: {dtype}\n")


def parity_session(cfg, scale, dtype, tpu=True, device="cuda"):
    """One allocate session of a bench config in parity mode on the card
    (or, with ``tpu`` False, the serial loop on the host, tpuscore off);
    the cursor starts at 0 (build_config's fresh cache). Returns (cache,
    profile with the host's full collections inside the wall as "gc2_ms",
    launches, wall ms, K15's captured inputs, final cursor)."""
    import gc

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import parity_kernels as PK
    from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
    from volcano_tpu_torch.scheduler.util import scheduler_helper

    cache, _, _, actions, _ = build_config(cfg, scale)
    if tpu:
        tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={"tpuscore": {
            "tpuscore.mode": "parity", "tpuscore.device": device, "tpuscore.dtype": dtype}})
    else:
        tiers = make_tiers(*CONFIGS[cfg].tiers)
    captured = {}
    real = PK.solve_allocate

    def capture(spec, enc, rr0, ntf):
        captured.setdefault("args", (spec, {k: v.clone() for k, v in enc.items()}, rr0, ntf))
        return real(spec, enc, rr0, ntf)

    PK.solve_allocate = capture
    torch.cuda.synchronize()
    devmod.reset_launches()
    full_gc = {"ms": 0.0, "t": 0.0}

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                full_gc["t"] = time.perf_counter()
            else:
                full_gc["ms"] += (time.perf_counter() - full_gc["t"]) * 1e3

    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        ssn = open_session(cache, tiers)
        run_actions(ssn, list(actions))
        prof = dict(ssn.plugins["tpuscore"].profile) if tpu else {}
        close_session(ssn)
        torch.cuda.synchronize()
    finally:
        PK.solve_allocate = real
        gc.callbacks.remove(on_gc)
    wall = (time.perf_counter() - t0) * 1e3
    prof["gc2_ms"] = full_gc["ms"]
    if tpu and (prof.get("mode") != "parity" or "fallback" in prof):
        raise AssertionError(f"cfg{cfg} parity session did not run the scan: {prof}")
    return (cache, prof, devmod.launches(), wall, captured.get("args"),
            scheduler_helper._last_processed_node_index)


def parity_phase(scale=1.0, device="cuda", dtype="float32"):
    """K15 on the card. (a) cfg2 at full scale, float32: one parity session
    through the tpuscore plugin launches K15 exactly once, its binds are
    feasible and whole; on the captured inputs K15 is torch.equal to the
    plain version (assign and the cursor) and timed (5 calls after 1
    warm-up; the plain version once). (b) float64 parity sessions on the
    card give the host serial loop's binds and cursor: cfg2 at 1.0 and
    cfg3 at 0.4 (cfg3: ten weighted queues, the overused purge). (c) cfg5
    at full width, float32: one parity session, feasible binds; on its
    capture with the first tenth of its jobs active (full T and N) K15 is
    torch.equal to the plain version; K15 timed on that and on the whole
    capture (2 calls after 1 warm-up). Returns (K15's record, the launches
    of (a)'s session)."""
    from volcano_tpu_torch.bench import parity_cases as PC
    from volcano_tpu_torch.ops import parity_kernels as PK

    launched = 1 if device == "cuda" else 0  # a CPU rehearsal runs the plain version
    cache, prof, counts_a, wall, args, _ = parity_session(2, scale, dtype, device=device)
    if counts_a["parity_scan"] != launched:
        raise AssertionError(f"cfg2 parity: {counts_a['parity_scan']} K15 launches")
    check_binds(cache, 2)
    n_binds = len(cache.binder.binds)
    del cache
    spec, enc, rr0, ntf = args
    got = PK.solve_allocate(spec, enc, rr0, ntf)
    want, plain_ms = timed_plain(lambda: PK.solve_allocate_plain(spec, enc, rr0, ntf))
    stats = dict(PK.STATS)
    same(got, want, "parity_scan")
    ms = time_ms(lambda: PK.solve_allocate(spec, enc, rr0, ntf), reps=5, warmup=1)
    if device == "cuda":
        parity_crafted(spec, enc, rr0, ntf)
    T, R = enc["task_req"].shape
    Q, S = enc["queue_deserved"].shape[0], enc["ns_active0"].shape[0]
    ops = (stats["examined"] * (3 * R + PARITY_NODE_OPS) + stats["scored"] * SCORE_OPS
           + (stats["job_rows"] + stats["visits"] * (Q + S)) * LEX_ROW_OPS)
    rec = dict(
        name="parity_scan", kernel="parity_scan", route="cuda",
        source="volcano_tpu_torch/csrc/parity_scan.cu",
        replaces="volcano_tpu/ops/kernels.py:389", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=nbytes(*(enc[k] for k, _ in PK._INPUTS)) + nbytes(got), ops=ops,
        dtype=enc["node_idle"].dtype, launch_path="parity",
        shape=(f"cfg2 T={T} N={enc['node_idle'].shape[0]} R={R} "
               f"J={enc['job_task_start'].shape[0]} Q={Q} S={S} ntf={ntf} "
               f"visits={stats['visits']} steps={stats['steps']} "
               f"examined={stats['examined']} scored={stats['scored']} "
               f"placed={int((got[:-1] >= 0).sum())} rr={int(got[-1])}"))
    finish_record(rec)
    print(json.dumps({"parity": f"cfg2@{scale} {dtype}", "card": CARD, "session_ms": wall,
                      "gc2_ms": prof["gc2_ms"], "binds": n_binds, "k15_ms": ms,
                      "plain_ms": plain_ms, "steps": stats["steps"],
                      "us_a_step": ms * 1e3 / max(stats["steps"], 1),
                      "split_ms": {k: round(prof[k] * 1e3, 3) for k in
                                   ("encode_s", "solve_s", "apply_s")}}), flush=True)

    # (b) float64 on the card == the serial loop on the host
    for cfg, sc in ((2, 1.0), (3, 0.4)):
        pc, pprof, _, pwall, _, prr = parity_session(cfg, sc, "float64", device=device)
        sc_cache, _, _, swall, _, srr = parity_session(cfg, sc, "float64", tpu=False)
        if pc.binder.binds != sc_cache.binder.binds or prr != srr:
            raise AssertionError(
                f"cfg{cfg}@{sc}: float64 parity binds differ from the serial loop "
                f"({len(pc.binder.binds)} vs {len(sc_cache.binder.binds)}, "
                f"cursor {prr} vs {srr})")
        print(json.dumps({"parity_vs_serial": f"cfg{cfg}@{sc} float64",
                          "binds": len(pc.binder.binds), "cursor": prr,
                          "parity_session_ms": pwall, "serial_session_ms": swall,
                          "k15_solve_ms": round(pprof["solve_s"] * 1e3, 3)}), flush=True)
        del pc, sc_cache

    # (c) cfg5 at full width
    cache, prof, counts, wall, args, _ = parity_session(5, scale, dtype, device=device)
    if counts["parity_scan"] != launched:
        raise AssertionError(f"cfg5 parity: {counts['parity_scan']} K15 launches")
    check_binds(cache, 5)
    spec, enc, rr0, ntf = args
    # K15 against its plain version on the cfg5 capture with only its
    # first tenth of jobs active (full T and N; the plain version of the
    # whole scan took 180-240 s of a run); K15's whole scan timed apart
    cut = PC.job_prefix(enc, 10)
    got5 = PK.solve_allocate(spec, cut, rr0, ntf)
    want5, plain5 = timed_plain(lambda: PK.solve_allocate_plain(spec, cut, rr0, ntf))
    steps5 = PK.STATS["steps"]
    same(got5, want5, "parity_scan (cfg5, a tenth of the jobs)")
    cut_ms = time_ms(lambda: PK.solve_allocate(spec, cut, rr0, ntf), reps=2, warmup=1)
    ms5 = time_ms(lambda: PK.solve_allocate(spec, enc, rr0, ntf), reps=2, warmup=1)
    full5 = PK.solve_allocate(spec, enc, rr0, ntf)
    print(json.dumps({"parity": f"cfg5@{scale} {dtype}", "card": CARD, "session_ms": wall,
                      "binds": len(cache.binder.binds), "k15_ms": ms5,
                      "placed": int((full5[:-1] >= 0).sum()),
                      "cut": {"jobs": f"1/10 of {enc['job_active0'].shape[0]}",
                              "k15_ms": cut_ms, "plain_ms": plain5, "steps": steps5,
                              "us_a_step": cut_ms * 1e3 / max(steps5, 1)},
                      "gc2_ms": prof["gc2_ms"],
                      "T": enc["task_req"].shape[0], "N": enc["node_idle"].shape[0],
                      "J": enc["job_task_start"].shape[0], "ntf": ntf,
                      "split_ms": {k: round(prof[k] * 1e3, 3) for k in
                                   ("encode_s", "solve_s", "apply_s")}}), flush=True)
    log(f"kernel parity_scan [cfg5]: {ms5:.4f} ms; a tenth of the jobs {cut_ms:.4f} ms, "
        f"{cut_ms * 1e3 / max(steps5, 1):.3f} us a step, equal to plain")
    return rec, counts_a


def parity_crafted(spec, enc, rr0, ntf):
    """K15 torch.equal to its plain version on crafted inputs: on the cfg2
    capture with the first tenth of its jobs active (full T and N; the
    plain scans of the whole capture took most of the parity group) the
    cursor at real_n - 1, num_to_find <= 0, 1 and above the feasible
    count, pad nodes inside the rotation; a gang visit that rolls back
    after several placements; more than 32 namespaces and queues."""
    from volcano_tpu_torch.bench import parity_cases as PC
    from volcano_tpu_torch.ops import parity_kernels as PK

    t0 = time.perf_counter()
    enc = PC.job_prefix(enc, 10)

    def check(sp, e, r0, k, what):
        got = PK._solve_cuda(sp, e, r0, k)
        same(got, PK.solve_allocate_plain(sp, e, r0, k), f"parity_scan ({what})")
        return got

    n = 0
    for e, what in ((enc, "cfg2"), (PC.pads_inside(enc), "cfg2, pads inside")):
        for r0, k in PC.windows(enc, rr0, ntf):
            check(spec, e, r0, k, f"{what}, rr0={r0}, ntf={k}")
            n += 1
    sp, e, r0, k = PC.parity_inputs(PC.gang_rollback_cluster(), PC.TIERS)
    got = check(sp, e, r0, k, "gang roll back")
    placed = int((got[:-1] >= 0).sum())
    if not 0 < placed < 30:
        raise AssertionError(f"parity roll-back case placed {placed} of 30")
    sp, e, r0, k = PC.parity_inputs(PC.wide_visit_cluster(), PC.TIERS)
    if e["ns_active0"].shape[0] <= 32 or e["queue_deserved"].shape[0] <= 32:
        raise AssertionError("the wide-visit case has no more than 32 namespaces or queues")
    check(sp, e, r0, k, "S, Q > 32")
    print(json.dumps({"parity_crafted": n + 2, "equal": True,
                      "wall_s": time.perf_counter() - t0}), flush=True)


def signature(cache):
    """The end state two twins must share: each job's PodGroup phase and
    its tasks' status and node, each node's accounting, the binds and the
    evictions in order (tests/test_continuous_pipeline.py's signature)."""
    jobs = {}
    for uid in sorted(cache.jobs):
        job = cache.jobs[uid]
        jobs[uid] = (str(job.pod_group.status.phase) if job.pod_group is not None else None,
                     {t: (int(job.tasks[t].status), job.tasks[t].node_name)
                      for t in sorted(job.tasks)})
    nodes = {name: (round(n.used.milli_cpu, 6), round(n.idle.milli_cpu, 6),
                    round(n.used.memory, 3)) for name, n in sorted(cache.nodes.items())}
    return {"jobs": jobs, "nodes": nodes, "binds": dict(cache.binder.binds),
            "evicts": list(cache.evictor.evicts)}


def check_accounting(stats):
    """Every dispatched stage was applied or discarded, every discard but
    the abandoned re-ran its cycle, and no stale stage reached apply."""
    if stats["stale_commits"]:
        raise AssertionError(f"pipeline: stale commits {stats}")
    if stats["spec_applied"] + stats["spec_discarded"] != stats["spec_dispatched"]:
        raise AssertionError(f"pipeline: stages unaccounted {stats}")
    reruns = sum(n for r, n in stats["spec_discards"].items() if r != "abandoned")
    if reruns != stats["spec_reruns"]:
        raise AssertionError(f"pipeline: discards without a rerun {stats}")


def probe_profiles():
    """Keep a copy of each committed session's tpuscore profile (the
    plugin's close hook) in the returned list."""
    from volcano_tpu_torch.scheduler.plugins import tpuscore

    seen = []
    real = tpuscore.TpuScorePlugin.on_session_close

    def close(self, ssn):
        seen.append(dict(self.profile))
        return real(self, ssn)

    tpuscore.TpuScorePlugin.on_session_close = close

    def restore():
        tpuscore.TpuScorePlugin.on_session_close = real
    return seen, restore


PIPELINE_TRACE = ("quiet", "gang", "quiet", "delete", "quiet", "gang", "quiet", "quiet")


def find_pod(cache, key):
    for job in cache.jobs.values():
        for t in job.tasks.values():
            if f"{t.namespace}/{t.name}" == key:
                return t.pod
    raise AssertionError(f"no task {key}")


def pipeline_phase(scale=1.0, device="cuda", dtype="float32"):
    """cfg5 plus an oversized backlog (every cycle encodes and solves), two
    twins with their own cursors: Scheduler(pipeline=True).run_once_pipelined
    against Scheduler.run_once, TPU_SCHEDULER_CONF in rounds mode on the
    card, over PIPELINE_TRACE (a fitting gang added, a bound pod deleted,
    quiet cycles between). The end signatures must be equal, the driver's
    accounting hold, at least one stage commit and one be discarded by a
    read-set or watch-delta verdict. Prints each cycle of each twin.
    Returns the launches of the pipelined twin's cycles."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.pipeline import PipelineDriver
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.scheduler.util import scheduler_helper
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
    from volcano_tpu_torch.api import objects

    twins, gone = {}, set()
    for name in ("pipelined", "serial"):
        cache, *_ = build_config(5, scale)
        oversized_backlog(cache, "64")
        s = Scheduler(cache, loop_conf(device=device, dtype=dtype))
        if name == "pipelined":
            s.pipeline_driver = PipelineDriver(cache, s._cycle_policy, degrade=s.degrade)
        twins[name] = dict(cache=cache, sched=s, rr=0)
    profiles, restore = probe_profiles()
    launches = {}
    rows = []
    try:
        for k, kind in enumerate(PIPELINE_TRACE):
            target = None
            if kind == "delete":
                target = sorted(twins["pipelined"]["cache"].binder.binds)[0]
                gone.add(target)
            for name, tw in twins.items():
                cache = tw["cache"]
                if kind == "gang":
                    pg = f"fit-{k}"
                    cache.add_pod_group(build_pod_group(pg, namespace="trace", min_member=4))
                    for i in range(4):
                        cache.add_pod(build_pod("trace", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                                                {"cpu": "500m", "memory": "512Mi"}, pg))
                elif kind == "delete":
                    cache.delete_pod(find_pod(cache, target))
                scheduler_helper._last_processed_node_index = tw["rr"]
                profiles.clear()
                caps0 = rounds_graph.STATS["captures"]
                if name == "pipelined":
                    devmod.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "pipelined":
                    info = tw["sched"].run_once_pipelined()
                    action_ms = info.get("action_ms", {})
                else:
                    info = {}
                    action_ms = tw["sched"].run_once()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                tw["rr"] = scheduler_helper._last_processed_node_index
                if name == "pipelined":
                    for kk, v in devmod.launches().items():
                        launches[kk] = launches.get(kk, 0) + v
                prof = profiles[-1] if profiles else {}
                row = {"cycle": k, "delta": kind, "twin": name, "session_ms": wall,
                       "captures": rounds_graph.STATS["captures"] - caps0,
                       "sync_points": prof.get("tpu_sync_points"),
                       "fetch_wait_ms": prof.get("tpu_fence_wait_ms"),
                       "tpu_overlap_ms": prof.get("tpu_overlap_ms"),
                       "action_ms": action_ms}
                for key in ("mode", "spec", "spec_commit", "dispatch_ms",
                            "fetch_wait_ms", "stage_device_ms", "device_overlap_ms",
                            "overlap_ms", "close_ms"):
                    if key in info:
                        row["cycle_" + key] = info[key]
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        restore()
    drv = twins["pipelined"]["sched"].pipeline_driver
    drv.abandon()
    for tw in twins.values():
        tw["cache"].flush_mirror()
        check_binds(tw["cache"], 5, gone=gone)
    stats = dict(drv.stats)
    check_accounting(stats)
    if signature(twins["pipelined"]["cache"]) != signature(twins["serial"]["cache"]):
        raise AssertionError("pipeline: pipelined and serial end states differ")
    scoped = {r: n for r, n in stats["spec_discards"].items()
              if r.startswith("readset:") or r == "watch_delta"}
    if stats["spec_applied"] < 1 or not scoped:
        raise AssertionError(f"pipeline: no commit or no read-set discard {stats}")
    idle = [k for k in ALLOC_KERNELS if not launches.get(k)]
    if idle and device == "cuda":
        raise AssertionError(f"pipeline: kernels never launched: {idle}")
    piped = [r for r in rows if r["twin"] == "pipelined"]
    for prev, row in zip(piped, piped[1:]):
        dev_ms = row.get("cycle_stage_device_ms")
        # the dispatch must return before the solve ends; a stage whose
        # bucket was new captured its graph inside the dispatch (the
        # capture synchronises), so only stages of a known bucket count
        if dev_ms and not prev["captures"] \
                and row["cycle_device_overlap_ms"] < 0.5 * dev_ms:
            raise AssertionError(f"pipeline cycle {row['cycle']}: device overlap "
                                 f"{row['cycle_device_overlap_ms']} ms of {dev_ms} ms")
    print(json.dumps({"pipeline": f"cfg5@{scale} + backlog", "card": CARD,
                      "stats": {k: stats[k] for k in (
                          "cycles", "spec_dispatched", "spec_applied", "spec_discarded",
                          "spec_discards", "spec_commits", "spec_skips")},
                      "binds": len(twins["serial"]["cache"].binder.binds)}), flush=True)
    return launches


def scheduler_loop_phase(arrival_s=8.0, period=4.0, scale=1.0, device="cuda",
                         dtype="float32", express_p99_ms=None):
    """Scheduler(cfg5, TPU_SCHEDULER_CONF in rounds mode, express=True,
    pipeline=True).run() on its own thread: first until a speculative
    stage has committed, then under bench.py --express's arrivals (the
    Poisson arrivals of each 20 ms at 50 jobs/s, one pod of 100m/250m and
    128Mi/256Mi each, seed 7) for ``arrival_s`` seconds, then until every
    arrival is bound; then stop(). Asserts every arrival bound, at least 3
    cycles, a committed stage, automatic GC off while the loop ran and
    restored after, and no "scheduling cycle failed" or "express run
    failed" record. Prints the lane's p50/p99/max batch ms (beside
    ``express_p99_ms``, the express phase's p99 outside the loop's GC
    policy, when that phase ran) and the collections the interpreter ran
    while the loop ran. Returns the launches over the loop's run."""
    import gc
    import logging
    import random

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.express import ExpressLane
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group

    cache, *_ = build_config(5, scale)
    oversized_backlog(cache, "64")
    s = Scheduler(cache, loop_conf(device=device, dtype=dtype), schedule_period=period,
                  express=True, pipeline=True)
    lane = ExpressLane(cache, device=device, dtype=dtype)
    reps = []
    real_run = lane.run_once

    def run_once():
        rep = real_run()
        reps.append(rep)
        return rep

    lane.run_once = run_once
    s.express_lane = lane

    class Failures(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.seen = []

        def emit(self, record):
            msg = record.getMessage()
            if "scheduling cycle failed" in msg or "express run failed" in msg:
                self.seen.append(msg)

    failures = Failures()
    logging.getLogger().addHandler(failures)
    collections = {}
    gc_t = {}

    def gc_probe(phase, info):
        if phase == "start":
            gc_t["t"] = time.perf_counter()
        elif "t" in gc_t:
            g = f"gen{info['generation']}"
            n, ms = collections.get(g, (0, 0.0))
            collections[g] = (n + 1, ms + (time.perf_counter() - gc_t.pop("t")) * 1e3)

    rng = random.Random(7)
    keys = []

    def burst():
        n, budget = 0, 0.02
        while True:
            gap = rng.expovariate(50.0)
            if gap > budget and n > 0:
                break
            budget -= gap
            n += 1
        for _ in range(max(n, 1)):
            pg = f"xpl-{len(keys):05d}"
            cache.add_pod_group(build_pod_group(pg, namespace="express", min_member=1))
            cache.add_pod(build_pod("express", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                                    {"cpu": f"{rng.choice([100, 250])}m",
                                     "memory": rng.choice(["128Mi", "256Mi"])}, pg))
            keys.append(f"express/{pg}-t0")

    was = gc.isenabled()
    gc.enable()
    enabled = []
    torch.cuda.synchronize()
    devmod.reset_launches()
    gc.callbacks.append(gc_probe)
    t0 = time.perf_counter()
    s.run()
    try:
        # the loop thread installs the policy before its first cycle;
        # sample from the first cycle's end on
        deadline = time.perf_counter() + 120.0
        while s.pipeline_driver.stats["cycles"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        while (s.pipeline_driver.stats["spec_applied"] < 1
               and time.perf_counter() < deadline):
            enabled.append(gc.isenabled())
            time.sleep(0.05)
        t_arrivals = time.perf_counter()
        while time.perf_counter() - t_arrivals < arrival_s:
            burst()
            enabled.append(gc.isenabled())
            time.sleep(0.02)
        deadline = time.perf_counter() + 60.0
        while (any(k not in cache.binder.binds for k in keys)
               and time.perf_counter() < deadline):
            enabled.append(gc.isenabled())
            time.sleep(0.05)
    finally:
        gc.callbacks.remove(gc_probe)
        s.stop()
        logging.getLogger().removeHandler(failures)
    wall = time.perf_counter() - t0
    restored = gc.isenabled()
    (gc.enable if was else gc.disable)()
    counts = devmod.launches()
    stats = dict(s.pipeline_driver.stats)
    unbound = [k for k in keys if k not in cache.binder.binds]
    in_order = [r["ms"] for r in reps if r.get("batches")]
    batches = sorted(in_order)
    out = {"loop": f"cfg5@{scale} + backlog, express + pipeline", "card": CARD,
           "wall_s": wall, "period_s": period, "arrivals": len(keys),
           "unbound": len(unbound), "lane_batches": len(batches),
           "lane_placed": lane.counters["placed"],
           "cycles": stats["cycles"], "spec_applied": stats["spec_applied"],
           "spec_commits": stats["spec_commits"],
           "spec_discards": stats["spec_discards"], "spec_skips": stats["spec_skips"],
           "gc_enabled_while_running": any(enabled), "gc_restored": restored,
           "collections": {g: {"n": n, "ms": ms} for g, (n, ms) in collections.items()},
           "launches": {k: v for k, v in counts.items() if v}}
    if batches:
        def pick(q):
            return batches[min(int(q * len(batches)), len(batches) - 1)]
        out.update(p50_ms=pick(0.5), p99_ms=pick(0.99), max_ms=batches[-1],
                   max_batch_index=in_order.index(batches[-1]),
                   first_batch_ms=in_order[0], express_phase_p99_ms=express_p99_ms)
    print(json.dumps(out), flush=True)
    if failures.seen:
        raise AssertionError(f"loop: failure records {failures.seen[:3]}")
    if unbound:
        raise AssertionError(f"loop: {len(unbound)} arrivals never bound")
    if stats["cycles"] < 3 or stats["spec_applied"] < 1:
        raise AssertionError(f"loop: too few cycles or no commit {stats}")
    if any(enabled) or not restored:
        raise AssertionError(f"loop: GC policy not held ({any(enabled)}, {restored})")
    if not batches:
        raise AssertionError("loop: the lane never placed a batch")
    check_binds(cache, 5)
    idle = [k for k in ALLOC_KERNELS + ("express_place",) if not counts.get(k)]
    if idle and device == "cuda":
        raise AssertionError(f"loop: kernels never launched: {idle}")
    return counts


def scatter_kernel_phase(node_dev, lane_dev):
    """K8 against its plain version (index_copy_) with torch.equal, on
    clones of the cfg5 replica's node family (N = 10000) with 1, 16, 100
    and 256 dirty rows, and of the express lane's columns with 1 row;
    each through a plan of its own (ops/replica.ScatterPlans). Timed: the
    device's part (the launch, which reads the rows from the plan's mapped
    host block, 20 calls in a CUDA graph: the record's ms, as K1's and
    K2b's), the eager launch, and the
    wrapper a call (CUDA events over 20 calls after 3 warm-ups, and its
    host time), beside the index_copy_ calls with sources already on the
    card (library_ms) and the like-for-like yardstick of the wrapper
    (library_staged_ms): per call, the rows packed into one pinned staging
    buffer, one non_blocking copy to the card and index_copy_ a buffer.
    Counted: the objects the collector tracks that a call of each leaves
    alive (gc_net_objects)."""
    import numpy as np
    from volcano_tpu_torch.ops import replica as R

    rng = np.random.default_rng(8)
    records = []
    for what, base, dirty in (("node", node_dev, (1, 16, 100, 256)),
                              ("express", lane_dev, (1,))):
        n = next(iter(base.values())).shape[0]
        for d in dirty:
            rows = sorted(rng.choice(n, min(d, n), replace=False).tolist())
            idx = R.bucket_pad_rows(rows)
            vals = {}
            for k, t in base.items():
                host = t.cpu().numpy()
                v = host[idx].copy()
                if v.dtype == np.bool_:
                    v = ~v
                else:
                    v = v + np.ones_like(v)
                vals[k] = v
            got = {k: t.clone() for k, t in base.items()}
            want = {k: t.clone() for k, t in base.items()}
            plans = R.ScatterPlans()
            R.scatter_rows(got, idx, vals, plans=plans)
            R.scatter_rows_plain(want, idx, vals)
            torch.cuda.synchronize()
            for k in base:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"scatter_rows {what}/{d}: {k} != plain")
            plan = plans.get(got, len(idx))
            # the device's part alone (the launch, as the wrapper issues
            # it) in a graph; the eager launch; the wrapper a call
            ms = graph_ms(lambda: plan.launch(0))
            launch_ms = time_ms(lambda: plan.launch(0))
            wrapper_ms = time_ms(lambda: R.scatter_rows(got, idx, vals, plans=plans))
            wrapper_host_ms = host_ms(lambda: R.scatter_rows(got, idx, vals, plans=plans))
            wrapper_gc = gc_net_objects(lambda: R.scatter_rows(got, idx, vals, plans=plans))
            plain_ms = time_ms(lambda: R.scatter_rows_plain(want, idx, vals))
            dsrc = {k: torch.from_numpy(np.ascontiguousarray(v)).to(base[k].device)
                    for k, v in vals.items()}
            didx = torch.from_numpy(idx.astype(np.int64)).to(got[next(iter(got))].device)
            lib_ms = time_ms(lambda: [want[k].index_copy_(0, didx, dsrc[k]) for k in base])
            staged = staged_index_copy(want, idx, vals)
            staged_ms = time_ms(staged)
            staged_gc = gc_net_objects(staged)
            torch.cuda.synchronize()
            for k in base:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"scatter_rows {what}/{d}: {k} != plain after timing")
            plans.clear()
            row_bytes = sum(t[0].numel() * t.element_size() for t in base.values())
            rec = dict(
                name="scatter_rows" if what == "node" else "scatter_rows_express",
                kernel="scatter_rows", route="cuda",
                launch_path="replica" if what == "node" else "express",
                source="volcano_tpu_torch/csrc/scatter_rows.cu",
                replaces="volcano_tpu/ops/replica.py:144" if what == "node"
                else "volcano_tpu/express/encode.py:199",
                max_abs_err=0.0, ms=ms, host_ms=wrapper_host_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                bytes=d * 4 + 2 * d * row_bytes, ops=0, dtype=torch.float32,
                shape=f"{what} family, {len(base)} buffers, N={n}, {d} rows "
                      f"(padded {len(idx)}); 20 launches in a graph; "
                      f"eager launch {launch_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms a call, "
                      f"library_staged_ms {staged_ms:.4f}")
            finish_record(rec)
            print(json.dumps({"kernel": rec["name"], "card": CARD, "rows": d, "graph_ms": ms,
                              "launch_ms": launch_ms, "wrapper_ms": wrapper_ms,
                              "wrapper_host_ms": wrapper_host_ms,
                              "library_staged_ms": staged_ms, "library_ms": lib_ms,
                              "gc_net_objects_a_call": {"wrapper": wrapper_gc,
                                                        "library_staged": staged_gc}}),
                  flush=True)
            if (what, d) in (("node", 16), ("express", 1)):
                records.append(rec)
    return records


def gc_net_objects(fn, calls: int = 200) -> float:
    """The objects the collector tracks that a call of ``fn`` leaves alive
    (its allocations less its frees, the collector off): what brings the
    next collection nearer."""
    import gc

    was = gc.isenabled()
    gc.disable()
    try:
        fn()
        torch.cuda.synchronize()
        c0 = gc.get_count()[0]
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (gc.get_count()[0] - c0) / calls
    finally:
        if was:
            gc.enable()


def staged_index_copy(dst, idx, vals):
    """One call of the yardstick K8's wrapper is held against: the rows of
    every buffer and the row indices packed into one pinned staging buffer
    on the host, one non_blocking copy to the card, index_copy_ a buffer
    from views of the copy. Returns the call."""
    import numpy as np

    dev = next(iter(dst.values())).device
    parts = [("idx", np.ascontiguousarray(np.asarray(idx, np.int64)))] + [
        (k, np.ascontiguousarray(v)) for k, v in vals.items()]
    offs, total = {}, 0
    for k, a in parts:
        offs[k] = total
        total += -(-a.nbytes // 16) * 16
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host = pinned.numpy()
    card = torch.empty(total, dtype=torch.uint8, device=dev)

    def view(k, a):
        t = card[offs[k]:offs[k] + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
        return t.view(a.shape)

    def call():
        for k, a in parts:
            host[offs[k]:offs[k] + a.nbytes] = a.view(np.uint8).reshape(-1)
        card.copy_(pinned, non_blocking=True)
        didx = view("idx", parts[0][1])
        for k, a in parts[1:]:
            dst[k].index_copy_(0, didx, view(k, a))
    return call


def express_kernel_phase(captured):
    """K14 against its plain version with torch.equal on the packed
    result: the cfg5 lane's first 1-task batch (tb = 16, W = 64) and its
    64-task batch (tb = 64, W = 256); a full-width case (window 0 on the
    first 100 nodes); a tie-heavy case (every node the same shape, so the
    window cannot prove coverage: fulls > 0); a gang-strip case (jobs of 4
    on 20 nodes of 300m idle); a zero-weight case (every feasible score
    +0.0: the window, sorted on the total-order key of order_key.cuh, is a
    block of zero ties; K14 sums its scores from +0.0, so -0.0 cannot enter
    its window, and K2's crafted rows hold the signed-zero order). Each
    timed with CUDA events."""
    import numpy as np
    from volcano_tpu_torch.express import place as P

    spec1, args1 = captured["tb16"]
    spec64, args64 = captured["tb64"]
    cases = [("express_place", "cfg5 lane, 1 task", spec1, args1),
             ("express_place_tb64", "cfg5 lane, 64 tasks", spec64, args64)]
    small = [a[:100].contiguous() for a in args1[:5]] + list(args1[5:])
    cases.append(("express_place_full", "first 100 nodes, window 0",
                  spec1._replace(window_k=0), small))
    tie = list(args64)
    tie[0] = torch.full_like(args64[0], 0.0) + args64[1][0]   # idle = alloc of node 0
    tie[1] = torch.zeros_like(args64[1]) + args64[1][0]
    tie[2] = torch.zeros_like(args64[2])
    tie[3] = torch.ones_like(args64[3])
    cases.append(("express_place_ties", "every node one shape", spec64, tie))
    gang = list(args64)
    idle = torch.zeros_like(args64[0])
    idle[:20, 0] = 300.0        # 300m on 20 nodes: three 100m or one 250m pod
    idle[:20, 1] = args64[0][:20, 1]
    gang[0] = idle
    tj = torch.arange(spec64.tb, device=args64[0].device, dtype=torch.int32) // 4
    gang[10] = tj
    need = torch.full((spec64.jb,), 2**31 - 1, dtype=torch.int32, device=tj.device)
    need[:spec64.tb // 4] = 4
    gang[12] = need
    cases.append(("express_place_strip", "jobs of 4 on 20 nodes of 300m", spec64, gang))
    zero = list(args64)
    zero[13] = torch.zeros_like(args64[13])
    cases.append(("express_place_zero", "zero weights: every score +0.0", spec64, zero))
    records = []
    for name, what, spec, args in cases:
        got = P.solve_express(spec, *args)
        want, plain_ms = timed_plain(lambda: P.solve_express_plain(spec, *args))
        same(got, want, name)
        tail = got[-2:].tolist()
        valid = int(args[9].sum())
        if name in ("express_place_ties", "express_place_zero") and tail[0] == 0:
            raise AssertionError(f"{name}: no full-width fallback: {tail}")
        if name == "express_place_strip":
            loose_args = list(args)
            loose_args[12] = torch.zeros_like(args[12])
            loose = P.solve_express_plain(spec, *loose_args)
            if not int(loose[-1]) > tail[1]:
                raise AssertionError(f"{name}: nothing stripped ({loose[-1]} vs {tail[1]})")
        ms = time_ms(lambda: P.solve_express(spec, *args))
        wrapper_ms = host_ms(lambda: P.solve_express(spec, *args))
        n = args[0].shape[0]
        w = spec.window_k
        fulls = tail[0]
        scored = (valid * n if w else 0) + (valid - fulls) * w + fulls * n
        rec = dict(
            name=name, kernel="express_place", route="cuda", launch_path="express",
            source="volcano_tpu_torch/csrc/express_place.cu",
            replaces="volcano_tpu/express/place.py:94", max_abs_err=0.0,
            ms=ms, host_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
            bytes=nbytes(*args) + nbytes(got), ops=scored * (SCORE_OPS + 6),
            dtype=args[0].dtype,
            shape=f"{what}: N={n} tb={spec.tb} W={w} valid={valid} "
                  f"fulls={fulls} placed={tail[1]}")
        finish_record(rec)
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# the bench: K16 at cfg7 and the bench's entry point on the card
# ---------------------------------------------------------------------------

K16_SHARDS = (1, 8)
# the largest cfg7 the encoder takes (at 1.0 the node capacity exceeds
# its int32 quantized-bound guard, ops/encoder.py, and prepare falls back)
K16_CFG7_SCALE = 0.65
K1_OPS = lambda r: 30 + 12 * r  # noqa: E731  (K1's operations a cell)


def cfg7_prepare(scale=1.0, device="cuda", dtype="float32"):
    """(spec, host arrays) of one rounds-mode cfg7 encode through the
    solver's own prepare; no session runs."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_cache
    from volcano_tpu_torch.bench.run import _tpu_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session

    bc = CONFIGS[7]
    cache = make_cache()
    t0 = time.perf_counter()
    n_tasks = bc.populate(cache, scale)
    t1 = time.perf_counter()
    ssn = open_session(cache, _tpu_tiers(bc.tiers, device, dtype, mode="rounds"))
    prep = ssn.batch_allocator._prepare(ssn)
    close_session(ssn)
    if prep is None:
        raise AssertionError(f"cfg7 x {scale}: no rounds encode: "
                             f"{ssn.batch_allocator.profile.get('fallback')}")
    log(f"cfg7 x {scale}: {n_tasks} tasks, build {t1 - t0:.1f} s, "
        f"open + encode {time.perf_counter() - t1:.1f} s")
    return prep["spec"], prep["arrays"]


def k16_phase(scale=K16_CFG7_SCALE, device="cuda", dtype="float32"):
    """K16a and K16b at cfg7's largest encodable width, d = 1 and d = 8:
    equal to their plain versions, launch counts, times. Returns the d = 1
    records (the kernels line) after printing every record."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.ops import shard
    from volcano_tpu_torch.ops.solver import _NODE_AXIS

    spec, arrays = cfg7_prepare(scale, device, dtype)
    on_card = device == "cuda"  # a host rehearsal launches nothing
    records = []
    for d in K16_SHARDS:
        width, enc, fold = shard.stage_probe(arrays, _NODE_AXIS, d, device=device)
        devmod.reset_launches()
        got = shard.probe_refresh(spec, enc)
        torch.cuda.synchronize()
        k1 = devmod.launches()["score_block"]
        want, plain_ms = timed_plain(lambda: shard.probe_refresh_plain(spec, enc))
        same(got, want, f"probe_refresh d={d}")
        if on_card and k1 != shard._PROBE_REPS:
            raise AssertionError(f"probe_refresh d={d}: {k1} K1 launches, "
                                 f"want {shard._PROBE_REPS}")
        devmod.reset_launches()
        count = shard.probe_evict_fold(*fold)
        torch.cuda.synchronize()
        if on_card and devmod.launches()["probe_evict_fold"] != 1:
            raise AssertionError(f"probe_evict_fold d={d}: "
                                 f"{devmod.launches()['probe_evict_fold']} launches")
        stats = {}
        want_n, fold_plain_ms = timed_plain(
            lambda: shard.probe_evict_fold_plain(*fold, stats=stats))
        same(count, want_n, f"probe_evict_fold d={d}")
        k_rows, n, r = enc["cls_req"].shape[0], width, enc["node_idle"].shape[1]
        dt = enc["node_idle"].dtype
        esz = enc["node_idle"].element_size()
        refresh_bytes = nbytes(*(enc[x] for x in (
            "cls_req", "cls_initreq", "cls_sig", "cls_nz_cpu", "cls_nz_mem",
            "cls_has_pod", "node_idle", "node_used", "node_alloc", "node_cnt",
            "node_max_tasks", "sig_mask", "affinity_score"))) + esz
        reps = shard._PROBE_REPS
        refresh = dict(
            name=f"probe_refresh (K1 x {reps})", kernel="probe_refresh",
            route="cuda",
            source="volcano_tpu_torch/csrc/score_block.cu (ops/shard.py probe_refresh)",
            replaces="volcano_tpu/ops/shard.py:191", max_abs_err=0.0,
            ms=time_ms(lambda: shard.probe_refresh(spec, enc), reps=5, warmup=1),
            plain_ms=plain_ms, library_ms=None, bytes=refresh_bytes,
            ops=reps * (k_rows * n * K1_OPS(r) + n * r), dtype=dt,
            launch_path="bench",
            shape=f"cfg7 d={d}: K={k_rows} N/d={n} R={r}, {reps} reps, "
                  f"sum {got.item()}")
        w_, v_, r_ = fold[0].shape
        fold_rec = dict(
            name="probe_evict_fold", kernel="probe_evict_fold", route="cuda",
            source="volcano_tpu_torch/csrc/probe_evict_fold.cu",
            replaces="volcano_tpu/ops/shard.py:215", max_abs_err=0.0,
            ms=time_ms(lambda: shard.probe_evict_fold(*fold), reps=5, warmup=1),
            graph_ms=graph_ms(lambda: shard.probe_evict_fold(*fold)),
            host_ms=host_ms(lambda: shard.probe_evict_fold(*fold)),
            plain_ms=fold_plain_ms, library_ms=None,
            bytes=nbytes(*fold) + 4,
            ops=reps * w_ * v_ * 6 * r_ + stats["updates"] * r_, dtype=dt,
            launch_path="bench",
            shape=f"cfg7 d={d}: W={w_} V={v_} R={r_}, {reps} reps, "
                  f"count {int(count)}")
        for rec in (refresh, fold_rec):
            finish_record(rec)
        if d == 1:
            records += [refresh, fold_rec]
    return records


def bench_main(argv):
    """The bench's main on the card (its default --device cuda); returns
    the JSON lines it printed, after printing the headline."""
    import contextlib
    import io

    from volcano_tpu_torch.bench import run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    if rc != 0:
        raise AssertionError(f"bench {argv}: exit {rc}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    if not lines or "summary" not in lines[-1]:
        raise AssertionError(f"bench {argv}: no summary tail")
    for line in lines[:-1]:
        print(json.dumps({"bench": " ".join(argv), "headline": line}), flush=True)
    log(f"bench {' '.join(argv)}: {time.perf_counter() - t0:.1f} s")
    return lines


def bench_phase(scale=1.0, device=None, dtype=None):
    """The bench's entry point on the card: cfg5 (both arms), the mesh
    curve, the express lane and the pipeline, through ``main`` with its
    default device (``device``/``dtype`` and a smaller ``scale`` rehearse
    it on the host). Returns the launches of K16 on the mesh-curve run
    (K1's inside its probes, K16b's)."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench import run
    from volcano_tpu_torch.ops import shard

    t_phase = time.perf_counter()
    place = [] if device is None else ["--device", device, "--dtype", dtype]
    bench_main(["--config", "5", "--backend", "both", "--warm-iters", "3",
                "--serial-budget", "5", "--scale", str(scale)] + place)
    with open(run.RECORD) as fh:
        rec = json.load(fh)["results"][0]
    prof = rec["tpu_profile"]
    checks = {
        "warm compiles 0": rec["tpu_warm_compiles"] == [0, 0, 0],
        "native engines": rec["native_engines"] == {"fastapply": True, "fasttrans": True},
        "rounds solve": prof.get("mode") == "rounds",
        "one sync point a warm solve": prof.get("tpu_sync_points") == 1,
        "binds": rec["tpu_binds"] > 0,
        "serial extrapolated": rec.get("serial_extrapolated") is True,
    }
    print(json.dumps({"bench_cfg5": {
        "tpu_e2e_median_ms": rec["tpu_e2e_median_ms"],
        "tpu_e2e_samples_ms": rec["tpu_e2e_samples_ms"],
        "serial_e2e_ms": rec["serial_e2e_ms"],
        "serial_measured_scale": rec.get("serial_measured_scale"),
        "speedup": rec.get("speedup"), "tpu_binds": rec["tpu_binds"],
        "solve_ms": round(prof.get("solve_s", 0.0) * 1e3, 3),
        "tpu_floor_samples_ms": rec["tpu_floor_samples_ms"],
        "tpu_steady_state": rec["tpu_steady_state"],
        "card": rec["device"]}}), flush=True)

    # K1 launches inside the probes, counted by wrapping the probe entry
    in_probes = [0]
    probe = shard.probe_refresh

    def counted(*a, **k):
        before = devmod.LAUNCHES["score_block"]
        out = probe(*a, **k)
        in_probes[0] += devmod.LAUNCHES["score_block"] - before
        return out

    shard.probe_refresh = counted
    devmod.reset_launches()
    try:
        mesh = bench_main(["--mesh", "1", "--scale", str(0.2 * scale)]
                          + place)[-1]["summary"]["tpu_mesh_curve"]
    finally:
        shard.probe_refresh = probe
    counts = devmod.launches()
    (entry,) = mesh["curve"]
    checks.update({
        "mesh: one entry at 1 device": mesh["devices"] == [1],
        "mesh: per_device_stage_ms > 0": entry["per_device_stage_ms"] > 0,
        "mesh: warm compiles 0": entry["warm_compiles"] == 0,
        "mesh: K16b launched": counts["probe_evict_fold"] > 0 or device == "cpu",
        "mesh: 16 K1 a probe": in_probes[0] == 16 * counts["probe_evict_fold"],
    })
    print(json.dumps({"bench_mesh": entry}), flush=True)

    xp = bench_main(["--express", "--express-arrivals", "32", "--scale", str(scale)]
                    + place)[-1]["summary"]["express"]
    checks["express: warm compiles 0"] = xp["express_warm_compiles"] == 0
    checks["express: one sync point a batch"] = xp["express_sync_points_per_batch"] == 1.0
    pl = bench_main(["--pipeline", "--pipeline-cycles", "2", "--scale",
                     str(scale)] + place)
    pl = pl[-1]["summary"]["cfg5_pipeline"]
    # the churn arms' bind match is printed, not checked: it depends on the
    # process's string-hash order in the JAX package too (ROADMAP.md Queue 3)
    checks.update({
        "pipeline: warm compiles 0": pl["pipeline_warm_compiles"] == 0,
        "pipeline churn: warm compiles 0": pl["churn"]["warm_compiles_readset"] == 0,
    })
    checks["native engines after"] = run.native_engines() == {
        "fastapply": True, "fasttrans": True}
    print(json.dumps({"bench_express": {k: xp[k] for k in (
        "tpu_express_p50_ms", "tpu_express_p99_ms", "tpu_express_max_ms",
        "batches", "express_placed", "express_warm_compiles")},
        "bench_pipeline": {k: pl[k] for k in (
            "pipeline_sessions_per_sec", "serial_sessions_per_sec",
            "speedup_sessions_per_sec", "p99_submit_bind_ms",
            "pipeline_spec_commit_rate", "pipeline_warm_compiles")},
        "churn": {k: pl["churn"][k] for k in (
            "commit_rate_whole_fingerprint", "binds_match_serial",
            "whole_fp_binds_match_serial", "spec_commits", "spec_discards")},
        "card": CARD}), flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench phase: {failed}")
    log(f"bench phase: {time.perf_counter() - t_phase:.1f} s")
    return {"probe_refresh": in_probes[0],
            "probe_evict_fold": counts["probe_evict_fold"]}


# ---------------------------------------------------------------------------
# 15: the state store, in-process and over HTTP
# ---------------------------------------------------------------------------

STORE_WATCHED = ("Pod", "Node", "PodGroup", "Queue", "PriorityClass",
                 "ResourceQuota", "PodDisruptionBudget")


class StoreWriter:
    """The bench generators' cache surface, writing into a store: the
    objects reach a store-backed cache only through its watches."""

    def __init__(self, store):
        self.add_node = self.add_queue = store.create
        self.add_pod_group = self.add_pod = store.create


def pinned_populate(cfg, target, scale):
    """CONFIGS[cfg].populate with the clock pinned to a counter, so twins
    built apart get the same creation times (and so the same job order)."""
    import itertools

    from volcano_tpu_torch.bench.clusters import CONFIGS
    from volcano_tpu_torch.utils import clock

    ticks = itertools.count(1)
    clock.set_source(lambda: float(next(ticks)))
    try:
        return CONFIGS[cfg].populate(target, scale)
    finally:
        clock.set_source(None)


def store_session(cache, cfg, device, dtype):
    """One allocate session on ``cache`` with the bind apply timed through
    the binder's ``bind_many``; returns (profile, launches, captured,
    wall_s, bound keys in order, bind_many seconds)."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_tiers
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)

    binder = cache.binder
    bind_many = binder.bind_many
    order, apply_s = [], [0.0]

    def timed(pairs):
        def keyed():
            for pod, host in pairs:
                order.append(f"{pod.metadata.namespace}/{pod.metadata.name}")
                yield pod, host
        t0 = time.perf_counter()
        try:
            bind_many(keyed())
        finally:
            apply_s[0] += time.perf_counter() - t0

    binder.bind_many = timed
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    caps0 = rounds_graph.STATS["captures"]
    if device == "cuda":
        torch.cuda.synchronize()
    devmod.reset_launches()
    t0 = time.perf_counter()
    try:
        ssn = open_session(cache, tiers)
        run_actions(ssn, ["allocate"])
        prof = dict(ssn.plugins["tpuscore"].profile)
        close_session(ssn)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        del binder.bind_many
    wall = time.perf_counter() - t0
    return (prof, devmod.launches(), rounds_graph.STATS["captures"] != caps0,
            wall, order, apply_s[0])


def fed_twin(cfg, scale, device, dtype):
    """The same config and scale fed into a FakeBinder cache (bench/
    clusters.make_cache) with the clock pinned the same way; one session
    on the card. Returns the binds and their order."""
    from volcano_tpu_torch.bench.clusters import make_cache

    cache = make_cache()
    pinned_populate(cfg, cache, scale)
    store_session(cache, cfg, device, dtype)
    check_binds(cache, f"{cfg} fed twin")
    return dict(cache.binder.binds), list(cache.binder.channel)


def store_binds(store):
    return {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
            for p in store.list("Pod") if p.spec.node_name}


def first_difference(got, want, what):
    """Fail on the first pod whose bind differs."""
    for key in sorted(set(got) | set(want)):
        if got.get(key) != want.get(key):
            raise AssertionError(f"{what}: pod {key} bound to {got.get(key)!r}, "
                                 f"the fed twin to {want.get(key)!r}")


def scheduled_keys(store):
    return [e.object_key for e in store.events if e.reason == "Scheduled"]


def stop_remote_watches(remote, store):
    """Stop a RemoteStore's watches without waiting out their long polls:
    with the stop flag set, one write of each watched kind wakes every
    poll, so each thread sees the flag and the joins return."""
    from volcano_tpu_torch.api import codec, objects

    remote._watch_stop.set()
    for kind in STORE_WATCHED:
        store.create(codec.kind_class(kind)(
            metadata=objects.ObjectMeta(name="zz-wake", namespace="wake")))
    remote.stop_watches()


# phase 15(b)'s cfg2 scale since phase 17(b) (cfg2 at full scale over HTTP):
# 2,248 tasks, above the rounds threshold
STORE_REMOTE_SCALE = 0.45


def store_phase(scale=1.0, device="cuda", dtype="float32"):
    """(a) cfg5 written into a port Store, mirrored by a store-backed cache
    through its watches, one session binding through DefaultBinder into the
    store; (b) cfg2 behind an ApiGateway, a RemoteStore-backed cache in
    this process, one session binding over HTTP. Each against a fed twin
    on the card. Returns the launches of each session."""
    from volcano_tpu_torch.scheduler.cache import SchedulerCache
    from volcano_tpu_torch.scheduler.util import scheduler_helper
    from volcano_tpu_torch.store import Store
    from volcano_tpu_torch.store.gateway import ApiGateway
    from volcano_tpu_torch.store.remote import RemoteStore

    t_phase = time.perf_counter()
    launches = {}

    # (a) in-process store, cfg5
    scheduler_helper.reset_round_robin()
    store = Store()
    cache = SchedulerCache(store=store)
    if type(cache.binder).__name__ != "DefaultBinder":
        raise AssertionError(f"store cache binder {type(cache.binder).__name__}")
    cache.run()
    t0 = time.perf_counter()
    n_tasks = pinned_populate(5, StoreWriter(store), scale)
    populate_s = time.perf_counter() - t0
    mirrored = sum(len(j.tasks) for j in cache.jobs.values())
    if mirrored != n_tasks or len(cache.nodes) != len(store.list("Node")):
        raise AssertionError(f"store: the watches mirrored {mirrored} of "
                             f"{n_tasks} tasks")
    prof, counts, cold, wall, order, apply_s = store_session(cache, 5, device, dtype)
    if prof.get("mode") != "rounds":
        raise AssertionError(f"store cfg5: mode {prof.get('mode')}")
    check_launches(5, prof, counts, False, cold)
    launches["cfg5"] = counts
    binds = store_binds(store)
    if not order or len(order) != len(set(order)):
        raise AssertionError(f"store cfg5: DefaultBinder.bind_many bound "
                             f"{len(order)} pods, {len(set(order))} distinct")
    bound = {k: binds.get(k) for k in order}
    if set(binds) != set(order) or None in bound.values():
        raise AssertionError("store cfg5: the store's node_name set differs "
                             "from the binds")
    events = scheduled_keys(store)
    if events != order:
        raise AssertionError(f"store cfg5: {len(events)} Scheduled events, "
                             f"not the {len(order)} binds in bind order")
    scheduler_helper.reset_round_robin()
    fed, fed_order = fed_twin(5, scale, device, dtype)
    first_difference(binds, fed, "store cfg5")
    if order != fed_order:
        raise AssertionError("store cfg5: bind order differs from the fed twin's")
    prof2, counts2, cold2, wall2, order2, _ = store_session(cache, 5, device, dtype)
    if order2 or cold2 or store_binds(store) != binds \
            or scheduled_keys(store) != events:
        raise AssertionError(f"store cfg5: the second session bound {len(order2)} "
                             f"new pods, captured a graph: {cold2}")
    print(json.dumps({"store_cfg5": {
        "tasks": n_tasks, "nodes": len(cache.nodes), "binds": len(binds),
        "scheduled_events": len(events), "populate_s": populate_s,
        "session_ms": wall * 1e3, "bind_apply_ms": apply_s * 1e3,
        "solve_ms": prof["solve_s"] * 1e3, "apply_ms": prof["apply_s"] * 1e3,
        "second_session_ms": wall2 * 1e3, "cold": cold,
        "equals_fed_twin": True, "card": CARD}}), flush=True)
    del cache, store, fed, fed_order

    # (b) over HTTP, cfg2 at STORE_REMOTE_SCALE at most: phase 17(b) binds
    # cfg2's full scale over HTTP
    rscale = min(scale, STORE_REMOTE_SCALE)
    server = Store()
    n2 = pinned_populate(2, StoreWriter(server), rscale)
    # the Pod journal holds the initial sync (ADDED) and the binds' echoes
    # (MODIFIED), 10,000 entries at full scale: at the default 4,096 the
    # client's first poll could fall off the ring and re-list (a reset)
    gw = ApiGateway(server, "127.0.0.1:0", journal_cap=4 * 4096).start()
    remote = None
    try:
        remote = RemoteStore(f"127.0.0.1:{gw.port}")
        scheduler_helper.reset_round_robin()
        rcache = SchedulerCache(store=remote)
        t0 = time.perf_counter()
        rcache.run()
        rcache.wait_for_cache_sync()
        n_nodes = len(server.list("Node"))
        deadline = time.monotonic() + 300.0
        while not (sum(len(j.tasks) for j in rcache.jobs.values()) == n2
                   and len(rcache.nodes) == n_nodes and "default" in rcache.queues
                   and all(j.pod_group is not None for j in rcache.jobs.values())):
            if time.monotonic() > deadline:
                raise AssertionError("remote cfg2: the watches never delivered "
                                     "the cluster")
            time.sleep(0.05)
        sync_s = time.perf_counter() - t0
        prof, counts, cold, wall, order, apply_s = store_session(
            rcache, 2, device, dtype)
        check_launches(2, prof, counts, False, cold)
        launches["cfg2_remote"] = counts
        remote.flush_events(timeout=120.0)
        binds = store_binds(server)
        events = scheduled_keys(server)
        resets = remote.watch_stats()["resets"]
        scheduler_helper.reset_round_robin()
        fed, _ = fed_twin(2, rscale, device, dtype)
        first_difference(binds, fed, "remote cfg2")
        if sorted(events) != sorted(order) or set(order) != set(binds):
            raise AssertionError(f"remote cfg2: {len(events)} Scheduled events "
                                 f"for {len(order)} binds")
        if resets:
            raise AssertionError(f"remote cfg2: {resets} watch resets")
        print(json.dumps({"store_cfg2_remote": {
            "scale": rscale, "tasks": n2, "binds": len(binds), "scheduled_events": len(events),
            "watch_sync_s": sync_s, "session_ms": wall * 1e3,
            "bind_apply_ms": apply_s * 1e3,
            "binds_per_s_over_http": len(order) / apply_s if apply_s else None,
            "watch_resets": resets, "equals_fed_twin": True, "card": CARD}}),
            flush=True)
    finally:
        if remote is not None:
            stop_remote_watches(remote, server)
        gw.stop()
    log(f"store phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 16: the in-process cluster, from Job submission to Completed
# ---------------------------------------------------------------------------

def cfg2_cluster(scale=1.0):
    """cfg2 (bench/clusters.py ``_heterogeneous``) at ``scale`` as what a
    user submits: its nodes, and each four-task group as a Job in namespace
    ``bench`` of four one-replica tasks (min_available 2, ttl 0) carrying
    the group's per-pod requests, drawn from the same random.Random(2)
    stream. Returns (nodes, jobs) as port objects."""
    import random

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_resource_list_with_pods)

    rng = random.Random(2)
    tasks, n_nodes = max(int(5000 * scale), 8), max(int(1000 * scale), 4)
    jobs = []
    for g in range(tasks // 4):
        specs = []
        for i in range(4):
            req = {
                "cpu": f"{rng.choice([100, 250, 500, 1000, 2000])}m",
                "memory": rng.choice(["256Mi", "512Mi", "1Gi", "2Gi"]),
            }
            if rng.random() < 0.25:
                req["nvidia.com/gpu"] = str(rng.choice([1, 2]))
            specs.append(objects.TaskSpec(
                name=f"t{i}", replicas=1, template=objects.PodTemplateSpec(
                    spec=objects.PodSpec(containers=[objects.Container(
                        name="c", image="busybox", requests=req)]))))
        jobs.append(objects.Job(
            metadata=objects.ObjectMeta(name=f"job-{g:05d}", namespace="bench"),
            spec=objects.JobSpec(min_available=2, tasks=specs, queue="default",
                                 scheduler_name="volcano",
                                 ttl_seconds_after_finished=0)))
    nodes = []
    for n in range(n_nodes):
        rl = build_resource_list_with_pods("32", "64Gi", pods=256)
        if n % 4 == 0:
            rl["nvidia.com/gpu"] = "8"
        nodes.append(build_node(f"node-{n:05d}", rl, labels={"zone": f"zone-{n % 8}"}))
    return nodes, jobs


def cluster_fit(store, what):
    """Each node's bound pods within its allocatable (requests and pod
    count) and every gang whole (a Job with a bound pod has at least its
    min_available bound). Returns the binds."""
    from volcano_tpu_torch.api.pod_helpers import get_pod_resource_request
    from volcano_tpu_torch.api.resource import Resource

    pods = store.list("Pod")
    per_node, per_job = {}, {}
    for p in pods:
        if not p.spec.node_name:
            continue
        per_node.setdefault(p.spec.node_name, []).append(get_pod_resource_request(p))
        job = p.metadata.annotations.get("volcano.sh/job-name")
        per_job[job] = per_job.get(job, 0) + 1
    for name, reqs in per_node.items():
        node = store.get("Node", "", name)
        alloc = Resource.from_resource_list(node.status.allocatable)
        total = Resource.empty()
        for r in reqs:
            total.add(r)
        if not total.less_equal(alloc) or len(reqs) > alloc.max_task_num:
            raise AssertionError(f"{what}: node {name} over capacity")
    for job in store.list("Job"):
        n = per_job.get(job.metadata.name, 0)
        if n and n < job.spec.min_available:
            raise AssertionError(f"{what}: gang {job.metadata.name} bound {n}")
    return {f"{p.metadata.namespace}/{p.metadata.name}": p.spec.node_name
            for p in pods if p.spec.node_name}


class Timed:
    """Replaces ``obj.<name>`` by a wrapper that records each call's wall
    seconds, what ``note`` returns after it and the call's result in
    ``calls``; ``before`` runs ahead of the timed call."""

    def __init__(self, obj, name, note=None, before=None):
        self.calls = []
        real = getattr(obj, name)

        def timed(*a, **k):
            if before is not None:
                before()
            t0 = time.perf_counter()
            out = real(*a, **k)
            self.calls.append((time.perf_counter() - t0, note() if note else None, out))
            return out

        setattr(obj, name, timed)


class ErrorRecords(logging.Handler):
    """Keeps the records of one logger at ``level`` and above; with
    ``mute`` they stop there (not propagated to stderr) until close()."""

    def __init__(self, name, level=logging.ERROR, mute=False):
        super().__init__(level)
        self.logger = logging.getLogger(name)
        self.seen = []
        self.levels = {}
        self.logger.addHandler(self)
        self.propagate = self.logger.propagate
        if mute:
            self.logger.propagate = False

    def emit(self, record):
        self.seen.append(record.getMessage())
        self.levels[record.levelname] = self.levels.get(record.levelname, 0) + 1

    def close(self):
        self.logger.removeHandler(self)
        self.logger.propagate = self.propagate
        super().close()


FED_KINDS = ("Node", "Queue", "PodGroup", "Pod")


def store_objects(store):
    """Copies of the store's objects a fed cache takes, in feeding order."""
    import copy

    return [copy.deepcopy(o) for kind in FED_KINDS for o in store.list(kind)]


def fed_cycle(objs, conf, rr=0):
    """One cycle of ``conf`` on a FakeBinder cache (bench/clusters.make_cache)
    fed ``objs`` (``store_objects``), the round-robin cursor at ``rr``;
    returns its binder."""
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.scheduler.util import scheduler_helper

    fed = make_cache()
    add = {"Node": fed.add_node, "Queue": fed.add_queue,
           "PodGroup": fed.add_pod_group, "Pod": fed.add_pod}
    for o in objs:
        add[o.KIND](o)
    scheduler_helper._last_processed_node_index = rr
    Scheduler(fed, conf).run_once()
    return fed.binder


def serial_witness(store):
    """The binds of one cycle of the host's serial loop (tpuscore off) fed
    ``store``'s objects: the pods still pending that it can place."""
    from volcano_tpu_torch.scheduler.scheduler import DEFAULT_SCHEDULER_CONF

    return fed_cycle(store_objects(store), DEFAULT_SCHEDULER_CONF).binds


def settle_cluster(cluster, what, after_step=None, max_steps=12):
    """``cluster.step()`` until a step writes nothing to the store, calling
    ``after_step()`` after each; returns each step's seconds."""
    took = []
    for _ in range(max_steps):
        rv = cluster.store.resource_version
        t0 = time.perf_counter()
        cluster.step()
        took.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step()
        if cluster.store.resource_version == rv:
            return took
    raise AssertionError(f"{what}: not stable after {max_steps} steps")


def cluster_phase(scale=1.0, device="cuda", dtype="float32", period=0.5):
    """(a) cfg2 at ``scale`` as Jobs (``cfg2_cluster``) through
    ``Cluster(scheduler_conf=loop_conf("auto", ...))`` driven by step():
    admission, the gate, the allocating cycle on the card against a fed
    twin, the kubelet, Running, then Succeeded, Completed and collected;
    (b) ``threaded_cluster``. Returns (b)'s launches."""
    import copy
    import itertools

    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.cluster import Cluster
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.ops.solver import BatchAllocator
    from volcano_tpu_torch.scheduler.util import scheduler_helper
    from volcano_tpu_torch.store.store import WatchHandler
    from volcano_tpu_torch.utils import clock

    t_phase = time.perf_counter()
    conf = loop_conf("auto", device, dtype)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    # the gate's refusals are the job controller's ERROR and WARNING
    # records, several a Job: counted, kept off stderr
    gate_log = ErrorRecords("volcano_tpu_torch.controllers", logging.WARNING, mute=True)

    # (a) deterministic drive
    nodes, jobs = cfg2_cluster(scale)
    n_pods = sum(len(j.spec.tasks) for j in jobs)
    scheduler_helper.reset_round_robin()
    ticks = itertools.count(1)
    clock.set_source(lambda: float(next(ticks)))
    seq = itertools.count()
    first_seen = {}  # (what, job) -> order of the first such event

    def mark_seen(what, job):
        first_seen.setdefault((what, job), next(seq))

    completed = set()

    def on_pg(pg):
        mark_seen("pg_" + pg.status.phase, pg.metadata.name)

    def on_pod(pod):
        mark_seen("pod", pod.metadata.annotations.get(objects.JOB_NAME_KEY))

    def on_job(old, new):
        if new.status.state.phase == objects.JobPhase.COMPLETED:
            completed.add(new.metadata.name)

    try:
        c = Cluster(scheduler_conf=conf)
        store = c.store
        store.watch("PodGroup", WatchHandler(added=on_pg, updated=lambda o, n: on_pg(n)))
        store.watch("Pod", WatchHandler(added=on_pod))
        store.watch("Job", WatchHandler(updated=on_job))
        for node in nodes:
            store.create(node)
        t_submit = time.perf_counter()
        for job in jobs:
            store.create(job)
        submit_s = time.perf_counter() - t_submit
        # the pieces of a step, timed; the job controller's drains keep
        # their cap (process_all's 10,000 requests a drain)
        n_pods_now = lambda: len(store.list("Pod"))  # noqa: E731
        jc = Timed(c.job_controller, "process_all", note=n_pods_now)
        kub = Timed(c.kubelet, "step")
        others = [Timed(c.podgroup_controller, "process_all"),
                  Timed(c.queue_controller, "process_all"),
                  Timed(c.gc, "process_expired")]
        snap = {"s": 0.0}

        def before_cycle():
            t0 = time.perf_counter()
            pending = [p for p in store.list("Pod") if not p.spec.node_name]
            if pending and "objects" not in snap:
                snap["objects"] = store_objects(store)
                snap["rr"] = scheduler_helper._last_processed_node_index
                snap["captures"] = rounds_graph.STATS["captures"]
                sync()
                devmod.reset_launches()
            snap["s"] += time.perf_counter() - t0

        # the bind apply: the binder's calls into the store (bind_many on the
        # rounds path, bind a task on the serial one), timed
        binder = c.cache.binder
        apply_s, depth = [], [0]

        def timed_bind(real):
            def bind(*a):
                # bind_many binds through bind: time the outer call only
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return real(*a)
                finally:
                    depth[0] -= 1
                    if not depth[0]:
                        apply_s.append(time.perf_counter() - t0)
            return bind

        binder.bind_many = timed_bind(binder.bind_many)
        binder.bind = timed_bind(binder.bind)
        seen_profiles, restore = probe_profiles()

        def after_cycle():
            sync()
            return {"launches": devmod.launches(), "apply_calls": len(apply_s),
                    "binds": sum(e.reason == "Scheduled" for e in store.events),
                    "profiles": len(seen_profiles)}

        marks = []

        def mark_step():
            pods = store.list("Pod")
            marks.append(dict(
                t=time.perf_counter(), pods=len(pods),
                bound=sum(1 for p in pods if p.spec.node_name),
                running=sum(p.status.phase == objects.POD_PHASE_RUNNING for p in pods),
                jc=len(jc.calls), kub=len(kub.calls), cyc=len(cyc.calls),
                others=[len(o.calls) for o in others], snapshot_s=snap["s"]))

        try:
            cyc = Timed(c.scheduler, "run_once", before=before_cycle, note=after_cycle)
            steps = settle_cluster(c, "cluster", after_step=mark_step)
        finally:
            restore()
        # Running: the end of the first step after which every pod exists
        # and every pod the cycles bound runs
        upto = next((m for m in marks if m["pods"] == n_pods
                     and m["running"] == marks[-1]["bound"]), None)
        if upto is None or not upto["running"]:
            raise AssertionError(f"cluster: the bound pods never all ran {marks[-1]}")
        running_at = upto["t"]
        notes = [{"binds": 0, "apply_calls": 0}] + [n for _, n, _ in cyc.calls]
        alloc = [i for i in range(1, len(notes))
                 if notes[i]["binds"] > notes[i - 1]["binds"]]
        if len(alloc) != 1:
            raise AssertionError(f"cluster: binds in cycles {alloc}, not one")
        note, before = notes[alloc[0]], notes[alloc[0] - 1]
        session_s = cyc.calls[alloc[0] - 1][0]
        counts = note["launches"]
        bind_s = sum(apply_s[before["apply_calls"]:note["apply_calls"]])
        prof = seen_profiles[note["profiles"] - 1]
        cold = rounds_graph.STATS["captures"] != snap["captures"]
        # below the rounds threshold (a small --scale) the session is serial
        if n_pods >= BatchAllocator.AUTO_ROUNDS_THRESHOLD:
            if prof.get("mode") != "rounds":
                raise AssertionError(f"cluster: the allocating cycle ran {prof.get('mode')}")
            if device == "cuda":
                check_launches(2, prof, counts, False, cold)
        # the gate: each PodGroup Pending, then Inqueue, before any pod
        for job in jobs:
            name = job.metadata.name
            order = [first_seen.get((k, name)) for k in
                     ("pg_" + objects.PodGroupPhase.PENDING,
                      "pg_" + objects.PodGroupPhase.INQUEUE, "pod")]
            if None in order or order != sorted(order):
                raise AssertionError(f"cluster: {name} gate order {order}")
        # one session at cfg2's GPU load (1,982 of 2,000) can leave a GPU
        # pod no node with room; pods left unbound must be unplaceable,
        # which the host's serial loop (tpuscore off) witnesses: one cycle
        # of it fed the store's objects binds none of them
        binds = cluster_fit(store, "cluster")
        pods = store.list("Pod")
        stranded = {}
        if len(binds) < n_pods:
            placeable = serial_witness(store)
            stranded = dict(unplaced_report(store), serial_witness_binds=len(placeable))
            if placeable:
                raise AssertionError(
                    f"cluster: {n_pods - len(binds)} pods left unbound, of which the "
                    f"serial loop binds {len(placeable)}")
        if any(p.status.phase != objects.POD_PHASE_RUNNING for p in pods if p.spec.node_name):
            raise AssertionError("cluster: a bound pod is not Running")
        per_job = {}
        for p in pods:
            if p.spec.node_name:
                job = p.metadata.annotations[objects.JOB_NAME_KEY]
                per_job[job] = per_job.get(job, 0) + 1
        want = {j.metadata.name: objects.JobPhase.RUNNING
                if per_job.get(j.metadata.name, 0) >= j.spec.min_available
                else objects.JobPhase.PENDING for j in jobs}
        got = {j.metadata.name: j.status.state.phase for j in store.list("Job")}
        if got != want:
            raise AssertionError("cluster: a Job's phase does not follow its gang")
        queue = store.get("Queue", "", "default").status
        pg_running = sum(pg.status.phase == objects.PodGroupPhase.RUNNING
                         for pg in store.list("PodGroup"))
        if queue.running != pg_running or pg_running != sum(
                v == objects.JobPhase.RUNNING for v in want.values()):
            raise AssertionError(f"cluster: the Queue counts {queue.running} running "
                                 f"of {pg_running} running PodGroups")
        order = [e.object_key for e in store.events if e.reason == "Scheduled"]
        if sorted(order) != sorted(binds):
            raise AssertionError("cluster: Scheduled events differ from the binds")

        # fed twin: the store's objects right before the allocating cycle,
        # fed into a FakeBinder cache, one cycle of the same conf
        fed = fed_cycle(snap["objects"], conf, snap["rr"])
        first_difference(binds, fed.binds, "cluster")
        if order != fed.channel:
            raise AssertionError("cluster: bind order differs from the fed twin's")

        # Running -> Succeeded -> Completed -> collected, in waves: pods left
        # unbound bind once the first wave's Jobs free their nodes
        t_done = time.perf_counter()
        flip_s, done_steps = 0.0, []
        for _ in range(4):
            t0 = time.perf_counter()
            for pod in store.list("Pod"):
                if pod.status.phase == objects.POD_PHASE_RUNNING:
                    updated = copy.deepcopy(pod)
                    updated.status.phase = objects.POD_PHASE_SUCCEEDED
                    store.update_status(updated)
            flip_s += time.perf_counter() - t0
            done_steps.append(settle_cluster(c, "cluster completion"))
            if not store.list("Pod", namespace="bench"):
                break
        done_s = time.perf_counter() - t_done
        left = {k: len(store.list(k, namespace="bench")) for k in ("Job", "Pod", "PodGroup")}
        if completed != {j.metadata.name for j in jobs} or any(left.values()):
            raise AssertionError(f"cluster: {len(completed)} Jobs Completed, left {left}")
        caps = rounds_graph.STATS["captures"]
        n_events = len(store.events)
        c.scheduler.run_once()
        if rounds_graph.STATS["captures"] != caps or any(
                e.reason == "Scheduled" for e in store.events[n_events:]):
            raise AssertionError("cluster: an empty cycle captured or bound")
    finally:
        clock.set_source(None)
        gate_log.close()
    drains = jc.calls[:upto["jc"]]
    created = [s for (s, n, _), prev in zip(drains, [0] + [n for _, n, _ in drains])
               if n > prev]
    # submit -> Running split by layer (ms); "harness" is this phase's own
    # snapshot for the fed twin, taken inside the allocating step
    split = {
        "admission": submit_s,
        "job_controller_pod_creation": sum(created),
        "job_controller_other": sum(s for s, _, _ in drains) - sum(created),
        "alloc_cycle": session_s, "of_it_bind_apply": bind_s,
        "other_cycles": sum(s for s, _, _ in cyc.calls[:upto["cyc"]]) - session_s,
        "kubelet": sum(s for s, _, _ in kub.calls[:upto["kub"]]),
        "podgroup_queue_gc": sum(s for o, n in zip(others, upto["others"])
                                 for s, _, _ in o.calls[:n]),
        "harness_snapshot": upto["snapshot_s"]}
    split["unaccounted"] = (running_at - t_submit) - sum(
        v for k, v in split.items() if k != "of_it_bind_apply")
    split = {k: v * 1e3 for k, v in split.items()}
    out_a = {
        "jobs": len(jobs), "pods": n_pods, "nodes": len(nodes),
        "submit_to_running_s": running_at - t_submit, "split_to_running_ms": split,
        "solve_ms": prof.get("solve_s", 0.0) * 1e3, "steps_s": steps,
        "cycles": len(cyc.calls),
        "flip_succeeded_ms": flip_s * 1e3,
        "running_to_collected_s": done_s, "completion_steps": done_steps,
        "max_drain": max(n for _, _, n in jc.calls),
        "bound": len(binds), "unbound": n_pods - len(binds), **stranded,
        "cold": cold,
        "gate_log_records": gate_log.levels,
        "job_controller_drains": [[s * 1e3, pods_after, processed]
                                  for s, pods_after, processed in drains],
        "equals_fed_twin": True,
        "launches": {k: v for k, v in counts.items() if v}, "card": CARD}
    print(json.dumps({"cluster_cfg2": out_a}), flush=True)
    del c, store, fed, snap

    counts = threaded_cluster(scale, device, dtype, period)
    log(f"cluster phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def unplaced_report(store):
    """Why pods are still unbound: the unbound pods by GPU count, how many
    GPU nodes have each count of GPUs free, and the Jobs with an unbound
    pod (the first 8: bound pods, the unbound ones' GPUs and CPU, the
    PodGroup's phase)."""
    from volcano_tpu_torch.api.pod_helpers import get_pod_resource_request

    gpu = "nvidia.com/gpu"
    used, unbound, jobs = {}, {}, {}
    for p in store.list("Pod"):
        g = int(float(p.spec.containers[0].requests.get(gpu, 0)))
        job = jobs.setdefault(p.metadata.annotations.get("volcano.sh/job-name"),
                              {"bound": 0, "unbound_gpus": []})
        if p.spec.node_name:
            used[p.spec.node_name] = used.get(p.spec.node_name, 0) + g
            job["bound"] += 1
        else:
            unbound[g] = unbound.get(g, 0) + 1
            job["unbound_gpus"].append(g)
            job["unbound_cpu_m"] = job.get("unbound_cpu_m", 0) + \
                get_pod_resource_request(p).milli_cpu
    free = {}
    for n in store.list("Node"):
        cap = int(float(n.status.allocatable.get(gpu, 0)))
        if cap:
            f = cap - used.get(n.metadata.name, 0)
            free[f] = free.get(f, 0) + 1
    stranded = {}
    for name, j in jobs.items():
        if j["unbound_gpus"]:
            pg = store.try_get("PodGroup", "bench", name)
            stranded[name] = dict(j, pg_phase=pg.status.phase if pg else None)
    return {"unbound_by_gpus": unbound, "gpu_nodes_by_free_gpus": free,
            "stranded_jobs": len(stranded),
            "stranded_jobs_first": dict(sorted(stranded.items())[:8])}


def threaded_cluster(scale=1.0, device="cuda", dtype="float32", period=0.5,
                     deadline_s=300.0, still_cycles=10):
    """Phase 16 (b): cfg2's Jobs into a fresh Cluster run() on its threads
    until every pod Runs, or until every pod exists, the kubelet has run
    every bound one and ``still_cycles`` cycles have bound nothing (a
    fixed point: with cfg2 asking for 1,982 of 2,000 GPUs, pods that
    arrive over many cycles can leave each GPU node too few GPUs for a
    waiting gang). Pods left unbound must be unplaceable: ``serial_witness``
    on the store's final objects binds none of them. Returns the launches
    over the run."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.cluster import Cluster
    from volcano_tpu_torch.ops.solver import BatchAllocator
    from volcano_tpu_torch.scheduler.util import scheduler_helper

    conf = loop_conf("auto", device, dtype)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    nodes, jobs = cfg2_cluster(scale)
    n_pods = sum(len(j.spec.tasks) for j in jobs)
    scheduler_helper.reset_round_robin()
    c = Cluster(scheduler_conf=conf, schedule_period=period)
    for node in nodes:
        c.store.create(node)
    errors = ErrorRecords("volcano_tpu_torch.scheduler.scheduler")
    gate_log = ErrorRecords("volcano_tpu_torch.controllers", logging.WARNING, mute=True)
    cycles = Timed(c.scheduler, "run_once")
    sync()
    devmod.reset_launches()
    c.run()
    try:
        t0 = time.perf_counter()
        for job in jobs:
            c.store.create(job)
        submit_s = time.perf_counter() - t0
        deadline = time.perf_counter() + deadline_s
        last = (-1, 0)  # (bound pods, cycles when that count was first seen)
        while True:
            pods = c.store.list("Pod")
            bound = sum(1 for p in pods if p.spec.node_name)
            running = sum(p.status.phase == objects.POD_PHASE_RUNNING for p in pods)
            if len(pods) == n_pods and running == n_pods:
                break
            if len(pods) == n_pods and running == bound:
                if bound != last[0]:
                    last = (bound, len(cycles.calls))
                elif len(cycles.calls) - last[1] >= still_cycles:
                    break
            if time.perf_counter() > deadline:
                print(json.dumps({"cluster_cfg2_threaded_timeout": {
                    "pods": len(pods), "bound": bound, "running": running,
                    "cycles": len(cycles.calls),
                    "cycle_ms": [s * 1e3 for s, _, _ in cycles.calls][-8:],
                    "scheduler_errors": errors.seen[:3],
                    "degrade": c.scheduler.degrade.stats(),
                    **unplaced_report(c.store)}}, default=str), flush=True)
                raise AssertionError(f"threaded cluster: {len(pods)} pods, "
                                     f"{running} Running after {deadline_s} s")
            time.sleep(0.05)
        running_s = time.perf_counter() - t0
    finally:
        c.stop()
        errors.close()
        gate_log.close()
    sync()
    counts = devmod.launches()
    pods = c.store.list("Pod")
    unbound = [p for p in pods if not p.spec.node_name]
    report = unplaced_report(c.store) if unbound else {}
    placeable = serial_witness(c.store) if unbound else {}
    out_b = {"pods": n_pods, "submit_ms": submit_s * 1e3,
             "submit_to_running_s": running_s, "all_running": not unbound,
             "unbound": len(unbound), **report, "serial_witness_binds": len(placeable),
             "period_s": period, "cycles": len(cycles.calls),
             "cycle_ms": [s * 1e3 for s, _, _ in cycles.calls],
             "scheduler_errors": len(errors.seen), "gate_log_records": gate_log.levels,
             "launches": {k: v for k, v in counts.items() if v}, "card": CARD}
    print(json.dumps({"cluster_cfg2_threaded": out_b}), flush=True)
    if errors.seen:
        raise AssertionError(f"threaded cluster: failed cycles {errors.seen[:3]}")
    if placeable:
        raise AssertionError(f"threaded cluster: {len(unbound)} pods left unbound, "
                             f"of which the serial loop binds {len(placeable)}")
    cluster_fit(c.store, "threaded cluster")
    if device == "cuda" and n_pods >= BatchAllocator.AUTO_ROUNDS_THRESHOLD:
        idle = [k for k in ALLOC_KERNELS if k != "window_topk" and not counts[k]]
        if idle:
            raise AssertionError(f"threaded cluster: kernels never launched: {idle}")
    return counts


# -- phase 17: the daemon, a takeover, and the process split -----------------


class NamespacedWriter:
    """The bench generators' cache surface writing a config's PodGroups and
    pods into ``store`` under namespace ``ns``; its nodes and queues are
    already there."""

    def __init__(self, store, ns):
        def put(obj):
            obj.metadata.namespace = ns
            store.create(obj)

        self.add_pod_group = self.add_pod = put
        self.add_node = self.add_queue = lambda obj: None


def daemon_takeover_phase(scale=1.0, device="cuda", dtype="float32"):
    """17(c): a takeover inside one process, on the card. Two
    FailoverScheduler members (a 1 s lease) over one Store holding cfg2 at
    ``scale``, under the daemon's conf; the leader solves it (its session
    captures the bucket's graph), then pauses its loop still holding the
    lease; its pods and PodGroups are deleted and the same ones written
    again under another namespace, which the standby's cache follows; the
    leader releases the lease. The standby's first session solves the same
    bucket: it captures no graph (the cache of graphs is process-wide) and
    its snapshot keeper pays no wholesale rebuild. Pods left unbound (cfg2's
    GPU load can strand a 2-GPU pod) are held to ``serial_witness``."""
    from volcano_tpu_torch.ops import rounds_graph
    from volcano_tpu_torch.scheduler.cache import SchedulerCache
    from volcano_tpu_torch.scheduler.ha import FailoverScheduler
    from volcano_tpu_torch.scheduler.scheduler import Scheduler
    from volcano_tpu_torch.store import Store

    t_phase = time.perf_counter()
    store = Store()
    pinned_populate(2, StoreWriter(store), scale)
    conf = daemon_conf(device, dtype)
    seen, restore = probe_profiles()
    members = {}

    def member(name):
        cache = SchedulerCache(store=store, scheduler_name="volcano")
        members[name] = FailoverScheduler(
            Scheduler(cache, conf, schedule_period=0.2), store, identity=name,
            lease_duration=1.0, renew_deadline=0.6, retry_period=0.2,
            follow_period=0.2).start()
        return members[name]

    def wait(pred, what, timeout=120.0):
        deadline = time.time() + timeout
        while not pred():
            if time.time() > deadline:
                raise AssertionError(f"daemon (c): {what} within {timeout} s")
            time.sleep(0.05)

    def solved(since=0):
        """The rounds sessions that placed, from the ``since``-th on."""
        return [p for p in seen[since:] if p.get("mode") == "rounds" and p.get("placed")]

    def bound(ns):
        return sum(1 for p in store.list("Pod", namespace=ns) if p.spec.node_name)

    try:
        a = member("sched-a")
        wait(a.is_leader, "sched-a never led")
        b = member("sched-b")
        wait(solved, "sched-a never solved cfg2")
        placed = solved()[0]["placed"]
        wait(lambda: bound("bench") >= placed, "sched-a's binds never landed")
        a.scheduler.stop(stop_cache=False)  # the lease stays with sched-a
        caps, since = rounds_graph.STATS["captures"], len(seen)
        for kind in ("Pod", "PodGroup"):
            for obj in store.list(kind, namespace="bench"):
                store.delete(kind, "bench", obj.metadata.name)
        pinned_populate(2, NamespacedWriter(store, "bench2"), scale)
        keeper = b.scheduler.cache.snap_keeper
        follows = b.standby.stats["follows"]
        wait(lambda: b.standby.stats["follows"] >= follows + 2, "sched-b never followed")
        rebuilds = keeper.stats["rebuilds"]
        t_release = time.perf_counter()
        a.stop()
        wait(b.is_leader, "sched-b never took the lease", timeout=30.0)
        t_lead = time.perf_counter()
        wait(lambda: solved(since), "sched-b never solved")
        t_solved = time.perf_counter()
        prof = solved(since)[0]
        captures = rounds_graph.STATS["captures"] - caps
        wait(lambda: bound("bench2") >= prof["placed"], "sched-b's binds never landed")
    finally:
        for m in members.values():
            m.stop()
        restore()
    # as in phase 16, cfg2's GPU load can leave a 2-GPU pod no node with
    # room: pods left unbound must be unplaceable
    n_pods = len(store.list("Pod", namespace="bench2"))
    placeable = serial_witness(store) if bound("bench2") < n_pods else {}
    out = {"pods": n_pods, "leader_placed": placed, "standby_placed": prof["placed"],
           "standby_bound": bound("bench2"), "serial_witness_binds": len(placeable),
           "captures_in_takeover": captures,
           "standby_rebuilds_in_takeover": keeper.stats["rebuilds"] - rebuilds,
           "release_to_lead_s": t_lead - t_release, "lead_to_solved_s": t_solved - t_lead,
           "seconds": time.perf_counter() - t_phase, "card": CARD}
    print(json.dumps({"daemon_takeover": out}), flush=True)
    if captures or out["standby_rebuilds_in_takeover"]:
        raise AssertionError(f"daemon (c): the takeover captured or rebuilt: {out}")
    if placeable:
        raise AssertionError(f"daemon (c): {n_pods - bound('bench2')} pods left unbound, "
                             f"of which the serial loop binds {len(placeable)}")
    return out


def daemon_conf(device="cuda", dtype="float32"):
    """The scheduler conf the daemon phase's schedulers read: cfg2's
    actions and tiers with the batch solve in rounds mode on ``device``,
    so every allocate session with work solves there (auto mode would take
    the host's serial loop below AUTO_ROUNDS_THRESHOLD pending tasks)."""
    return loop_conf("rounds", device, dtype)


# the daemon run as ``python -m volcano_tpu_torch.scheduler`` runs it
# (runpy), with each session that placed or launched printed to standard
# output as one "SESSION {...}" line: the solver profile's mode, fallback,
# placed and window, and the kernel launches the session made
DAEMON_PROBE = """
import json, runpy, sys
from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import solver
from volcano_tpu_torch.scheduler import scheduler
solve, cycle, last = solver.BatchAllocator.__call__, scheduler.Scheduler.run_once, {}
def traced_solve(self, ssn):
    ok = solve(self, ssn)
    last.update({k: self.profile.get(k) for k in ("mode", "fallback", "placed", "window_k")})
    return ok
def traced_cycle(self, *args, **kwargs):
    last.clear()
    devmod.reset_launches()
    out = cycle(self, *args, **kwargs)
    launched = {k: v for k, v in devmod.launches().items() if v}
    if last.get("placed") or launched:
        print("SESSION " + json.dumps(dict(last, launches=launched)), flush=True)
    return out
solver.BatchAllocator.__call__ = traced_solve
scheduler.Scheduler.run_once = traced_cycle
runpy.run_module("volcano_tpu_torch.scheduler", run_name="__main__", alter_sys=True)
"""


def job_manifest(job):
    """A cfg2 Job (``cfg2_cluster``) as the manifest ``vcctl job run -f``
    reads (cli/job.py)."""
    spec = job.spec
    lines = ["apiVersion: batch.volcano.sh/v1alpha1", "kind: Job", "metadata:",
             f"  name: {job.metadata.name}", f"  namespace: {job.metadata.namespace}",
             "spec:", f"  minAvailable: {spec.min_available}",
             f"  schedulerName: {spec.scheduler_name}", f"  queue: {spec.queue}",
             f"  ttlSecondsAfterFinished: {spec.ttl_seconds_after_finished}",
             "  tasks:"]
    for t in spec.tasks:
        lines += [f"    - name: {t.name}", f"      replicas: {t.replicas}",
                  "      template:", "        spec:", "          containers:"]
        for c in t.template.spec.containers:
            lines += [f"            - name: {c.name}", f"              image: {c.image}",
                      "              resources:", "                requests:"]
            lines += [f'                  {k}: "{v}"' for k, v in c.requests.items()]
    return "\n".join(lines) + "\n"


class Daemon:
    """``python -m volcano_tpu_torch.scheduler ARGS`` from the repository
    root (with ``probe``, the same module run under DAEMON_PROBE), its log
    (standard error) in a file; its standard output piped (``pipe``) or in
    another file."""

    def __init__(self, name, args, logdir, pipe=False, probe=False):
        import os

        self.name = name
        self.log_path = os.path.join(logdir, f"{name}.log")
        self.out_path = os.path.join(logdir, f"{name}.out")
        self._log = open(self.log_path, "w")
        self._out = None if pipe else open(self.out_path, "w")
        head = ["-c", DAEMON_PROBE] if probe else ["-m", "volcano_tpu_torch.scheduler"]
        self.proc = subprocess.Popen(
            [sys.executable, *head, *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE if pipe else self._out, stderr=self._log, text=True)

    def log(self):
        with open(self.log_path) as f:
            return f.read()

    def sessions(self):
        """The SESSION lines DAEMON_PROBE printed, in order."""
        with open(self.out_path) as f:
            return [json.loads(line[8:]) for line in f if line.startswith("SESSION ")]

    def find(self, pattern, timeout=60.0):
        """The first match of ``pattern`` in the log, waiting for it."""
        import re

        deadline = time.time() + timeout
        while time.time() < deadline:
            m = re.search(pattern, self.log())
            if m:
                return m
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        raise AssertionError(f"daemon {self.name}: no {pattern!r} in its log "
                             f"(rc {self.proc.poll()}):\n{self.log()[-3000:]}")

    def alive(self):
        return self.proc.poll() is None

    def stop(self):
        if self.alive():
            self.proc.kill()
        try:
            self.proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            pass
        self._log.close()
        if self._out is not None:
            self._out.close()


POLL_S = 1.0  # a list of cfg2's pods costs the API server's process its own work
CONTEXT_MIB = 256  # less than a CUDA context and a solve's tensors take


def card_memory():
    """The card's used memory (MiB) and its compute apps as nvidia-smi
    reads them."""
    def smi(*query):
        return subprocess.run(["nvidia-smi", *query, "--format=csv,noheader,nounits"],
                              check=True, capture_output=True, text=True).stdout.strip()

    apps = [line for line in smi("--query-compute-apps=pid,used_memory").splitlines()
            if line.strip()]
    return {"used_mib": int(smi("--query-gpu=memory.used").splitlines()[0]),
            "apps": len(apps), "app_lines": apps}


def scrape(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def clean_metrics(text, what):
    """A scheduler's /metrics: no degraded rung at 1. Returns its envelope
    misses (``volcano_device_fallbacks_total`` by kind: a session or action
    the batched path does not take, such as cfg2's backfill with its
    scalar GPU dimension; device errors are not among them, they raise)."""
    bad = [line for line in text.splitlines()
           if line.startswith("volcano_degraded_mode") and float(line.rsplit(" ", 1)[1]) != 0]
    if bad:
        raise AssertionError(f"daemon (b): {what}'s /metrics shows {bad}")
    return {line.split('"')[1]: float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("volcano_device_fallbacks_total{")}


def solved_on_the_card(sessions, what, card=True):
    """The sessions of a scheduler process that placed pods: each solved in
    rounds mode with no fallback and, on the ``card``, launched kernels;
    together they launched every rounds kernel (K2 where a solve used a
    candidate window). Returns (sessions, pods placed, launches summed)."""
    placed = [x for x in sessions if x.get("placed")]
    if not placed:
        raise AssertionError(f"daemon (b): {what} placed no pod in a rounds solve: {sessions[-5:]}")
    launches = {}
    for x in placed:
        if x.get("mode") != "rounds" or x.get("fallback") or (card and not x["launches"]):
            raise AssertionError(f"daemon (b): {what}'s session did not solve on the card: {x}")
        for k, v in x["launches"].items():
            launches[k] = launches.get(k, 0) + v
    window = any(x.get("window_k") for x in placed)
    idle = [k for k in ALLOC_KERNELS if card and not launches.get(k)
            and (k != "window_topk" or window)]
    if idle:
        raise AssertionError(f"daemon (b): {what}'s rounds kernels never launched: {idle}")
    return len(placed), sum(x["placed"] for x in placed), launches


def metric(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name) and not line.startswith("#"))


def daemon_split_phase(scale=1.0, device="cuda", dtype="float32", kill_at=1000,
                       deadline_s=420.0, still_s=15.0):
    """17(b): cfg2 at ``scale`` through the port's binaries: an
    ``--api-server-only`` process, two leader-elected ``--server``
    schedulers under cfg2's conf with the batch solve in rounds mode on
    ``device`` (each printing its sessions, DAEMON_PROBE), Jobs submitted
    with ``cli.job.run_job`` over a RemoteStore in two waves; the leader
    killed (SIGKILL) once every Job of the first wave has its pods and
    ``kill_at`` pods are bound, the second wave submitted once the standby
    holds the lease, the standby binding the rest. Every process is killed
    in a ``finally``."""
    import os
    import re
    import select
    import tempfile
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.cli import job as job_cli
    from volcano_tpu_torch.scheduler.leaderelection import (
        DEFAULT_LEASE_DURATION, ResourceLock)
    from volcano_tpu_torch.store.remote import RemoteStore

    t_phase = time.perf_counter()
    nodes, jobs = cfg2_cluster(scale)
    n_pods = sum(len(j.spec.tasks) for j in jobs)
    kill_at = min(kill_at, n_pods // 5)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    conf_path = os.path.join(logdir, "scheduler.conf")
    with open(conf_path, "w") as f:
        f.write(daemon_conf(device, dtype))
    out = {"pods": n_pods, "nodes": len(nodes), "jobs": len(jobs)}
    daemons = {}
    try:
        api = daemons["api"] = Daemon("api", [
            "--api-server-only", "--api-address", "127.0.0.1:0",
            "--listen-address", "127.0.0.1:0", "--healthz-address", "127.0.0.1:0"],
            logdir, pipe=True)
        deadline, port = time.time() + 60, None
        while port is None and time.time() < deadline:
            if not select.select([api.proc.stdout], [], [], 1.0)[0]:
                continue
            line = api.proc.stdout.readline()
            if not line:
                break
            if line.startswith("api gateway on :"):
                port = int(line.rsplit(":", 1)[1])
        if port is None:
            raise AssertionError(f"daemon (b): no api gateway line:\n{api.log()[-3000:]}")
        api_metrics = int(api.find(r"metrics on :(\d+)/metrics").group(1))
        server = f"127.0.0.1:{port}"
        remote = RemoteStore(server)

        t0 = time.perf_counter()
        for node in nodes:
            remote.create(node)
        if remote.try_get("Queue", "", "default") is None:
            remote.create(objects.Queue(metadata=objects.ObjectMeta(name="default")))
        out["node_writes_per_s"] = len(nodes) / (time.perf_counter() - t0)

        for name in ("sched-a", "sched-b"):
            daemons[name] = Daemon(name, [
                "--server", server, "--leader-elect", "--leader-elect-identity", name,
                "--scheduler-conf", conf_path, "--schedule-period", "0.5",
                "--listen-address", "127.0.0.1:0", "--healthz-address", "127.0.0.1:0"],
                logdir, probe=True)
        mports = {n: int(daemons[n].find(r"metrics on :(\d+)/metrics").group(1))
                  for n in ("sched-a", "sched-b")}
        lock = ResourceLock(remote, "volcano-system", "volcano", "chip-smoke")

        def holder():
            got = lock.get()
            return got[0] if got and got[0] else None

        def leading():
            """The live schedulers that logged a takeover."""
            return [n for n in ("sched-a", "sched-b") if daemons[n].alive()
                    and "takeover complete" in daemons[n].log()]

        scrapes = [0]

        def one_holder():
            rec, lead = holder(), leading()
            scrapes[0] += 1
            if len(lead) > 1 or (rec and lead and rec.holder_identity not in lead):
                raise AssertionError(f"daemon (b): lock held by "
                                     f"{rec and rec.holder_identity}, leading {lead}")
            return rec

        deadline = time.time() + 90
        while not (one_holder() and leading()):
            if time.time() > deadline:
                raise AssertionError("daemon (b): no scheduler took the lease")
            time.sleep(0.25)
        first = one_holder()
        leader, standby = first.holder_identity, \
            "sched-b" if first.holder_identity == "sched-a" else "sched-a"
        epoch0 = int(daemons[leader].find(r"leading at epoch (\d+)").group(1))

        # the leader has led an empty cluster: no solve yet, no context
        smi = {"before": card_memory()} if device == "cuda" else {}
        # two waves of Jobs, the second submitted once the standby holds
        # the lease: the job controller drops a Job whose PodGroup stays
        # Pending past its retry budget (about 41 s) and never retries it
        # (a reference fault, ROADMAP Queue 3), so no Job may wait for
        # admission across the takeover; the kill waits for every pod of
        # the first wave (made only once its PodGroup is admitted)
        waves = (jobs[:len(jobs) // 2], jobs[len(jobs) // 2:])
        n_first = sum(len(j.spec.tasks) for j in waves[0])
        kill_at = min(kill_at, n_first // 2)
        out["pods_per_wave"] = [n_first, n_pods - n_first]
        t_submit = time.perf_counter()
        for job in waves[0]:
            job_cli.run_job(remote, job_manifest(job))
        out["job_submits_per_s"] = len(waves[0]) / (time.perf_counter() - t_submit)

        def pods_now():
            return remote.list("Pod", namespace="bench")

        bound, pods = 0, []
        deadline = time.time() + deadline_s
        while bound < kill_at or len(pods) < n_first:
            one_holder()
            if not daemons[leader].alive():
                raise AssertionError(f"daemon (b): the leader died:\n"
                                     f"{daemons[leader].log()[-3000:]}")
            pods = pods_now()
            bound = sum(1 for p in pods if p.spec.node_name)
            if bound and "binding" not in smi and device == "cuda":
                smi["binding"] = card_memory()
            if time.time() > deadline:
                raise AssertionError(f"daemon (b): after {deadline_s} s {bound} pods bound, "
                                     f"{len(pods)} of {n_first} made, "
                                     f"{api.log().count('dropping request after')} "
                                     f"Job requests dropped")
            time.sleep(POLL_S)
        leader_metrics = scrape(mports[leader])
        os.kill(daemons[leader].proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        daemons[leader].proc.wait(timeout=15)
        time.sleep(1.0)  # the killed leader's last requests land or fail
        if device == "cuda":
            smi["after_kill"] = card_memory()
        at_kill = pods_now()
        before_kill = {p.metadata.name: p.spec.node_name for p in at_kill}
        b_kill = sum(1 for v in before_kill.values() if v)
        # the gangs the killed leader left short of min_available: the
        # standby's first session reverts them (takeover recovery) and the
        # job controller recreates their pods under the same names
        short = {}
        for p in at_kill:
            if p.spec.node_name:
                job = p.metadata.annotations[objects.JOB_NAME_KEY]
                short[job] = short.get(job, 0) + 1
        min_of = {j.metadata.name: j.spec.min_available for j in jobs}
        short = {j for j, n in short.items() if n < min_of[j]}
        t_first = t_takeover = t_second = None
        last = (b_kill, len(at_kill), time.perf_counter())
        while True:
            rec = one_holder()
            now = time.perf_counter()
            if t_takeover is None and rec and rec.holder_identity == standby:
                t_takeover = now
                for job in waves[1]:
                    job_cli.run_job(remote, job_manifest(job))
                t_second = time.perf_counter()
                continue
            pods = pods_now()
            bound = sum(1 for p in pods if p.spec.node_name)
            running = sum(p.status.phase == objects.POD_PHASE_RUNNING for p in pods)
            if t_first is None and bound > b_kill:
                t_first = now
                if device == "cuda":
                    smi["standby"] = card_memory()
            if (bound, len(pods)) != last[:2]:
                last = (bound, len(pods), now)
            # done: every pod bound and Running, or, once the standby has
            # bound, nothing moved for still_s with every bound pod Running
            if t_second and running == bound and (
                    bound == n_pods or (t_first and now - last[2] > still_s)):
                break
            if not daemons[standby].alive() or time.time() > deadline:
                raise AssertionError(
                    f"daemon (b): {bound} of {n_pods} bound, {running} Running, standby "
                    f"alive {daemons[standby].alive()}:\n{daemons[standby].log()[-3000:]}")
            time.sleep(POLL_S)
        t_running = time.perf_counter()
        out.update({"submit_to_running_s": t_running - t_submit, "leader": leader,
                    "leader_binds_before_kill": b_kill,
                    "kill_to_lease_s": t_takeover - t_kill if t_takeover else None,
                    "second_wave_submit_s": t_second - t_takeover if t_second else None,
                    "kill_to_first_standby_bind_s": t_first - t_kill if t_first else None,
                    "bound": bound})
        print(json.dumps({"daemon_split_running": out}), flush=True)
        rec = one_holder()
        epoch1 = int(re.findall(r"leading at epoch (\d+)", daemons[standby].log())[-1])
        if rec.holder_identity != standby or rec.leader_transitions <= first.leader_transitions \
                or epoch1 <= epoch0:
            raise AssertionError(f"daemon (b): takeover {rec} epochs {epoch0} -> {epoch1}")
        standby_metrics = scrape(mports[standby])
        api_text = scrape(api_metrics)

        # the end state: fit and gangs, one Scheduled event a bind, Running,
        # each Job's phase following its gang, leftovers unplaceable
        binds = cluster_fit(remote, "daemon (b)")
        pods = pods_now()

        # the gateway answers a pod's events by a scan of every event under
        # the store's lock: a few clients with a long timeout, not a crowd
        slow = RemoteStore(server, timeout=120.0)

        def scheduled(pod):
            return sum(e.reason == "Scheduled" for e in slow.events_for(pod))

        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            events = dict(zip([p.metadata.name for p in pods], ex.map(scheduled, pods)))
        out["event_reads_s"] = time.perf_counter() - t0
        job_of = {p.metadata.name: p.metadata.annotations[objects.JOB_NAME_KEY]
                  for p in pods}
        without_pods = len(jobs) - len(set(job_of.values()))
        if without_pods or len(pods) != n_pods:
            raise AssertionError(f"daemon (b): {without_pods} Jobs without pods, {len(pods)} "
                                 f"of {n_pods} pods made")
        # a name carries two Scheduled events only where the standby
        # reverted a short gang and bound its recreated pod
        twice = [n for n, k in events.items() if k > 2 or (k == 2 and job_of[n] not in short)]
        rebound = [n for n, k in events.items() if k == 2]
        standby_bound = [p.metadata.name for p in pods if p.spec.node_name and (
            before_kill.get(p.metadata.name) != p.spec.node_name or job_of[p.metadata.name]
            in short)]
        unrecorded = [n for n in standby_bound if not events[n]]
        lost = [p.metadata.name for p in pods if p.spec.node_name and not events[p.metadata.name]]
        if twice or unrecorded:
            raise AssertionError(f"daemon (b): Scheduled events: {len(twice)} pods bound "
                                 f"more than once, {len(unrecorded)} standby binds without one")
        if any(p.status.phase != objects.POD_PHASE_RUNNING for p in pods if p.spec.node_name):
            raise AssertionError("daemon (b): a bound pod is not Running")
        per_job = {}
        for p in pods:
            if p.spec.node_name:
                job = p.metadata.annotations[objects.JOB_NAME_KEY]
                per_job[job] = per_job.get(job, 0) + 1
        for j in remote.list("Job", namespace="bench"):
            want = objects.JobPhase.RUNNING if per_job.get(j.metadata.name, 0) \
                >= j.spec.min_available else objects.JobPhase.PENDING
            if j.status.state.phase != want:
                raise AssertionError(f"daemon (b): Job {j.metadata.name} is "
                                     f"{j.status.state.phase}, its gang says {want}")
        placeable = serial_witness(remote) if len(binds) < n_pods else {}
        if placeable:
            raise AssertionError(f"daemon (b): {n_pods - len(binds)} pods left unbound, of "
                                 f"which the serial loop binds {len(placeable)}")
        envelope = {leader: clean_metrics(leader_metrics, leader),
                    standby: clean_metrics(standby_metrics, standby)}
        # each scheduler's bind sessions solved in rounds mode and launched
        # the rounds kernels in its own process (the standby schedules only
        # once it leads)
        solves = {name: solved_on_the_card(daemons[name].sessions(), name, device == "cuda")
                  for name in (leader, standby)}
        # the card's processes carry another pid namespace's numbers here
        # (nvidia-smi listed one app, as pid 1), so each scheduler is tied
        # to the card by the card's memory too: up once the leader solves,
        # down at its kill, up again once the standby solves
        if device == "cuda" and not (
                smi["binding"]["used_mib"] - smi["before"]["used_mib"] >= CONTEXT_MIB
                and smi["binding"]["used_mib"] - smi["after_kill"]["used_mib"] >= CONTEXT_MIB
                and smi["standby"]["used_mib"] - smi["after_kill"]["used_mib"] >= CONTEXT_MIB):
            raise AssertionError(f"daemon (b): the card's memory does not show the "
                                 f"schedulers: {smi}")
        listed = subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.cli.vcctl", "--server", server,
             "job", "list", "-n", "bench"], capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        rows = [line for line in listed.stdout.splitlines() if line.startswith("job-")]
        if listed.returncode or len(rows) != len(jobs):
            raise AssertionError(f"daemon (b): vcctl job list gave {len(rows)} Jobs "
                                 f"(rc {listed.returncode}): {listed.stderr[-2000:]}")
        journal = {}
        for kind in ("Pod", "PodGroup", "Node", "Job"):
            with urllib.request.urlopen(
                    f"http://{server}/watch/{kind}?since=0&timeout=0", timeout=30) as r:
                journal[kind] = {"trimmed": bool(json.loads(r.read()).get("reset"))}
        out.update({
            "lease_duration_s": DEFAULT_LEASE_DURATION,
            "standby_binds": len(binds) - b_kill, "bound": len(binds),
            "unbound": n_pods - len(binds), "serial_witness_binds": len(placeable),
            "epochs": [epoch0, epoch1],
            "lease_transitions": [first.leader_transitions, rec.leader_transitions],
            "lock_scrapes": scrapes[0],
            "fenced_writes_rejected": metric(api_text, "volcano_fenced_writes_rejected_total"),
            "scheduled_events_lost_with_the_leader": len(lost),
            "short_gangs_at_kill": len(short), "rebound_after_revert": len(rebound),
            "jobs_without_pods": without_pods,
            "sessions_pods_launches": solves, "envelope_misses": envelope,
            "job_requests_dropped": api.log().count("dropping request after"),
            "journal_trimmed_since_0": journal,
            "card_memory": smi,
            "vcctl_jobs_listed": len(rows), "card": CARD})
    finally:
        for d in daemons.values():
            d.stop()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"daemon_split": out}), flush=True)
    log(f"daemon phase (b): {out['seconds']:.1f} s")
    return out


PHASE_GROUPS = ("allocate", "express", "parity", "pipeline", "loop", "bench", "store",
                "cluster", "daemon")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cluster scale of the cfg2/3/5 sessions (1.0 = full)")
    ap.add_argument("--only", default="",
                    help="comma-separated phase groups to run (default: all): "
                         + ",".join(PHASE_GROUPS))
    args = ap.parse_args()
    # a SIGTERM unwinds like an error: the phases' ``finally`` blocks stop
    # the processes they started
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    groups = set(args.only.split(",")) if args.only else set(PHASE_GROUPS)
    if groups - set(PHASE_GROUPS):
        log(f"chip_smoke: unknown phase groups {sorted(groups - set(PHASE_GROUPS))}")
        return 2
    import volcano_tpu_torch  # noqa: F401  (fails outside the repository)
    from volcano_tpu_torch import _build
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    smi = CARD = smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # the native host engines (cc, not nvcc) build before any phase, so
    # every session's host loops run in them
    from volcano_tpu_torch.bench.run import native_engines

    engines = native_engines()
    log(f"native host engines: {engines}")
    if not all(engines.values()):
        raise AssertionError(f"native engines did not load: {engines}")
    probe_versions()
    # each group's wall time, for the script's time budget
    walls, t_mark = {}, [t0]

    def mark(group):
        now = time.perf_counter()
        walls[group] = round(now - t_mark[0], 1)
        t_mark[0] = now

    mark("build")
    records, launches, express_p99 = [], {}, None
    if "allocate" in groups:
        records = kernel_phase(args.scale)
        reference_check()
        records += rounds_loop_phase()[0]
        launches, captured = session_phase(args.scale)
        records += evict_kernel_phase(captured)
        records += fused_kernel_phase(captured)
        mark("allocate")
    if "express" in groups:
        from volcano_tpu_torch.ops.replica import FAMILIES

        express_parity_phase()
        xsum, launches["express"], xcaptured, lane = express_lane_phase()
        express_p99 = xsum["p99_ms"]
        launches["replica"], rep = replica_phase()
        preempt_terminal_phase()
        for path, kernels in (("express", ("express_place", "scatter_rows")),
                              ("replica", ("scatter_rows",))):
            idle = [k for k in kernels if not launches[path][k]]
            if idle:
                raise AssertionError(f"{path}: kernels never launched: {idle}")
        records += express_kernel_phase(xcaptured)
        records += scatter_kernel_phase({k: rep.dev[k] for k in FAMILIES["node"]},
                                        lane.state.dev)
        del lane, rep
        mark("express")
    if "parity" in groups:
        rec, launches["parity"] = parity_phase(args.scale)
        records.append(rec)
        mark("parity")
    if "pipeline" in groups:
        launches["pipeline"] = pipeline_phase(args.scale)
        mark("pipeline")
    if "loop" in groups:
        launches["loop"] = scheduler_loop_phase(express_p99_ms=express_p99)
        mark("loop")
    if "bench" in groups:
        records += k16_phase()
        launches["bench"] = bench_phase()
        mark("bench")
    if "store" in groups:
        launches["store"] = store_phase(args.scale)
        mark("store")
    if "cluster" in groups:
        launches["cluster"] = cluster_phase(args.scale)
        mark("cluster")
    if "daemon" in groups:
        daemon_takeover_phase(args.scale)
        daemon_split_phase(args.scale)
        mark("daemon")
    log(f"group walls (s): {walls}")
    # each kernel's launches on the path that runs it: K1-K5 on cfg5; the
    # per-action K9 on cfg4's and K10 on the reclaim path's per-action run;
    # K11, K13 and the fused K9 on cfg4's fused run, the fused K10 on the
    # reclaim path's; K8 and K14 on the express lane (a record names its
    # path), K15 on the cfg2 parity session
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
            "launches": launches[rec.get("launch_path", path_of.get(rec["kernel"], 5))][rec["kernel"]],
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
