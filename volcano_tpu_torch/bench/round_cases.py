"""Inputs of the round's scoring (K1's round entry, ``score_round``, recorded
only), its select (K3, ``round_select``), its capacity walk
(K2b, ``cap_walk``), its job ranks (K6, ``job_rank``), its acceptance
scans (K4 ``resolve_prefix``, K5 ``queue_budget``) and of K7c, the
round's commit (``round_commit``) and the rollback's undo
(``round_rollback``): those a solve hands them, recorded, and crafted
ones.

The GPU tests and ``chip_smoke.py`` hold each kernel against its plain
version on both kinds; tests/test_torch_round_kernels.py holds the plain
versions against the jitted JAX functions on the same arrays (CPU,
float64).

Crafted select cases (``select_cases``): a class with a single task, a
class holding every task, inactive tasks, slots past the class's feasible
count (overflow), classes with no feasible node, ±0.0 score ties (one
equal-score group, as the capacity walk's IEEE compare makes them),
exclusion groups with live and dead classes, binpack with and without
exclusion, the window's coverage test and the cover's width. Crafted
commit cases (``commit_cases``): every task accepted onto one node, one
queue and one namespace taking every task, no task accepted, exclusion
occupancy, rows of -0.0 and padding tasks; each also gives a rollback
case (``rollback_case``) that retires a job with placed tasks, or none.
Crafted K4 cases (``resolve_cases``, with and without the pod check): a
node segment over several of K4's tiles (so a tile with no segment
start), every task on one node, the infeasible tail starting inside a
tile, 64-core requests whose sums pass 2^31, a rejection followed by rows
that fit only through the scalar skip, one and five dimensions. Crafted K5
cases (``budget_cases``): one queue of 8,192 jobs, ten queues with their
jobs' ranks interleaved, padding tasks and jobs, 70,000 64-core jobs past
2^31, a scalar dimension at the skip edge, one and five dimensions. Both
are built at the level of the round's arrays (``resolve_inputs``,
``budget_inputs``: numpy, so tests/test_torch_resolve_budget.py feeds the
same ones to the JAX package) and turned into the kernels' arguments as
the round does (``resolve_args``, ``budget_args``). Crafted K2b cases
(``walk_cases``): rows of ties with +0.0 and -0.0 and a -inf tail, all
-inf, -inf ahead of a feasible tail, one tied group; requests zero in
some dimensions, binpack shares, exclusion classes, pod room zero or
negative, prefixes that saturate at t_cap, W = 1, odd W, W past one of
the kernel's chunks, one and five dimensions, and random rows at the
window's and the cover's widths of cfg5, cfg2 and cfg6. Crafted K6 cases
(``rank_cases``): every order of the priority, gang and drf tiers (and
shorter ones) over ties, shares of both signs of zero, zero totals under
allocations, absent dimensions and all-equal keys, and the job counts of
cfg5, cfg2 and cfg6. Both are numpy first (``walk_inputs``,
``rank_inputs``), so tests/test_torch_walk_ranks.py feeds the same arrays
to the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from volcano_tpu_torch.ops import rounds as R
from volcano_tpu_torch.ops import rounds_kernels as RK
from volcano_tpu_torch.ops.kernels import SolveSpec


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(_clone(v) for v in x)
    return x


def bit_equal(a, b) -> bool:
    """torch.equal, with the sign of a float zero told apart."""
    if not torch.equal(a, b):
        return False
    return not a.is_floating_point() or torch.equal(torch.signbit(a), torch.signbit(b))


def hold_score_round(args, what: str) -> None:
    """K1's round entry (``kernels.score_round``) on a recorded call's
    ``args`` against its plain version, each on its own copy of the
    carried scores and counts: the scores by their bits, the counts
    exactly, and the count scratch left zero. Raises AssertionError."""
    from volcano_tpu_torch.ops import kernels as K

    spec, enc, idle, used, cnt, occ, scores, dirty, n_dirty, n_feas = args[:10]
    s_k, f_k = scores.clone(), torch.full_like(n_feas, -5)
    acc = torch.zeros(n_feas.shape[0] + 1, dtype=torch.int32, device=scores.device)
    K.score_round(spec, enc, idle, used, cnt, occ, s_k, dirty, n_dirty, f_k, scratch=acc)
    s_p, f_p = scores.clone(), torch.full_like(n_feas, -5)
    K.score_round_plain(spec, enc, idle, used, cnt, occ, s_p, dirty, n_dirty, f_p)
    if not bit_equal(s_k, s_p):
        raise AssertionError(f"score_round scores != plain at {int((s_k != s_p).sum())} "
                             f"cells: {what}")
    if not torch.equal(f_k, f_p):
        raise AssertionError(f"score_round n_feas {f_k.tolist()} != {f_p.tolist()}: {what}")
    if acc.any():
        raise AssertionError(f"score_round left its scratch non-zero: {what}")


# the recorded kernels of the rounds module, by kind
RECORDED = {"score": "score_round", "select": "round_select", "commit": "round_commit",
            "rollback": "round_rollback", "resolve": "resolve_prefix",
            "budget": "queue_budget", "walk": "cap_walk", "ranks": "job_rank"}


@contextlib.contextmanager
def recording(limit=None, kinds=tuple(RECORDED)):
    """While open, every call of the rounds module's ``score_round``,
    ``round_select``, ``round_commit``, ``round_rollback``,
    ``resolve_prefix``, ``queue_budget``, ``cap_walk`` and ``job_rank``
    (those of ``kinds``) keeps a copy of its inputs (at most ``limit`` of
    each): yields {"score": [(args, kwargs)], "select": [...], ...,
    "walk": [...], "ranks": [...]}."""
    names = {kind: RECORDED[kind] for kind in kinds}
    seen = {kind: [] for kind in names}
    real = {kind: getattr(R, name) for kind, name in names.items()}

    def wrap(kind):
        def fn(*args, **kw):
            if limit is None or len(seen[kind]) < limit:
                seen[kind].append((_clone(args), _clone(kw)))
            return real[kind](*args, **kw)
        return fn

    for kind, name in names.items():
        setattr(R, name, wrap(kind))
    try:
        yield seen
    finally:
        for kind, name in names.items():
            setattr(R, name, real[kind])


def record_solve(spec, enc, limit=None, kinds=tuple(RECORDED)):
    """The recorded kernels' inputs of one solve of the step machine
    driven from the host (the CPU's plain machine, or ``loop="host"`` on
    the card, where the wrappers launch the kernels)."""
    with recording(limit, kinds) as seen:
        R.solve(spec, enc, loop="host")
    return seen


def _spec(binpack, excl, pod=True):
    return SolveSpec(
        job_order_keys=("priority", "gang"), use_drf_ns_order=False,
        use_prop_queue_order=False, use_prop_overused=False,
        check_pod_count=pod, use_nodeorder=not binpack, use_binpack=binpack,
        use_exclusion=excl, round_min_progress=0, straggler_rounds=0,
        window_k=0, dirty_k=0)


def select_case(seed, t, k, w, *, binpack=False, excl=False, coverage=False,
                layout="random", p_active=0.7, device="cpu",
                dtype=torch.float64):
    """One crafted select call: ((spec, corder, active, n_feas, order,
    walk), {"coverage": coverage}), the walk made by the capacity
    walk (``rounds._cap_walk``) from rows of tied and signed-zero
    scores. ``layout``: "random" classes, "one" (every task in class 0),
    "singletons" (class c holds task c, the rest in the last class)."""
    g = np.random.default_rng(seed)
    n = max(w, 4)
    if layout == "one":
        task_cls = np.zeros(t, np.int32)
    elif layout == "singletons":
        task_cls = np.minimum(np.arange(t), k - 1).astype(np.int32)
        g.shuffle(task_cls)
    else:
        task_cls = g.integers(0, k, t).astype(np.int32)
    cls_excl = (g.integers(-1, max(2, k // 3), k) if excl
                else np.full(k, -1)).astype(np.int32)
    active = g.random(t) < p_active
    # feasible counts: none, some, all of the window and past it
    n_feas = g.choice([0, 1, max(1, w // 3), w, w + 1 + w // 2], k).astype(np.int32)
    levels = np.array([7.5, 3.0, 3.0, 0.0, -0.0, -0.0, 0.0, -1.25])
    score = np.full((k, w), -np.inf)
    order = np.zeros((k, w), np.int64)
    for c in range(k):
        f = min(int(n_feas[c]), w)
        score[c, :f] = np.sort(g.choice(levels, f))[::-1]
        order[c] = g.permutation(n)[:w]
    idle = g.choice([0.0, 300.0, 1000.0, 4000.0, 16000.0], (n, 2))
    req = g.choice([0.0, 100.0, 250.0, 1000.0], (k, 2))
    dev = torch.device(device)
    ft = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    it = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    spec = _spec(binpack, excl)
    enc = {"eps": ft([10.0, 10.0]),
           "node_max_tasks": it(g.integers(1, 6, n))}
    frac = ft(g.random(k)) if binpack else None
    walk = R._cap_walk(spec, enc, it(order), ft(score), ft(req), it(cls_excl),
                       torch.tensor(g.random(k) < 0.5, device=dev), frac,
                       ft(idle), it(g.integers(0, 3, n)), t + 1)
    corder = RK.class_order(it(task_cls), it(cls_excl))
    args = (spec, corder, torch.tensor(active, device=dev), it(n_feas),
            it(order), tuple(walk))
    return args, {"coverage": coverage}


# (label, select_case keyword arguments): the crafted select cases
SELECT_CASES = (
    ("window", dict(seed=1, t=300, k=8, w=16, coverage=True)),
    ("window-binpack", dict(seed=2, t=300, k=8, w=16, binpack=True, coverage=True)),
    ("window-excl", dict(seed=3, t=300, k=24, w=16, excl=True, coverage=True)),
    ("window-binpack-excl", dict(seed=4, t=300, k=24, w=16, binpack=True,
                                 excl=True, coverage=True)),
    ("cover", dict(seed=5, t=500, k=6, w=200)),
    ("one-class", dict(seed=6, t=3000, k=4, w=32, layout="one", coverage=True)),
    ("singletons-excl", dict(seed=7, t=40, k=32, w=8, layout="singletons",
                             excl=True, coverage=True)),
    ("mostly-inactive", dict(seed=8, t=2500, k=3, w=64, p_active=0.05,
                             coverage=True)),
    ("width-1", dict(seed=9, t=64, k=4, w=1, coverage=True)),
    ("wide-row", dict(seed=10, t=700, k=2, w=13000)),
)


def select_cases(device="cpu", dtype=torch.float64):
    """[(label, args, kwargs)] of SELECT_CASES on ``device``."""
    return [(label, *select_case(device=device, dtype=dtype, **kw))
            for label, kw in SELECT_CASES]


def commit_case(seed, t, n, j, q, s, r=2, *, excl=False, p_accept=0.4,
                one_node=False, signed_zeros=False, pad=0, device="cpu",
                dtype=torch.float64):
    """One crafted commit call: (spec, tc, st, choice, accept, did_full,
    ctl). Jobs own contiguous task ranges, as the encoder lays them out,
    and ``pad`` padding tasks follow them (job, queue and namespace 0, no
    request, never accepted), as the solver's buckets pad the task axis.
    ``signed_zeros``: state rows of -0.0 (nodes, jobs, queues and
    namespaces, some of which no task reaches) and -0.0 requests (the
    last dimension's all of them), so that a row's sign of zero depends on
    the unaccepted tasks' +0.0."""
    g = np.random.default_rng(seed)
    dev = torch.device(device)
    ft = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    it = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    # with signed zeros, the even jobs (job 0 among them) hold no task, and
    # the last queue, the last namespace and half the nodes take none
    jobs = np.arange(1, j, 2) if signed_zeros else np.arange(j)
    counts = np.bincount(g.choice(jobs, t), minlength=j).astype(np.int32)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    task_job = np.repeat(np.arange(j), counts).astype(np.int32)
    job_queue = g.integers(0, max(1, q - signed_zeros), j)
    job_ns = g.integers(0, max(1, s - signed_zeros), j)
    groups = 3
    task_excl = g.integers(-1, groups, t).astype(np.int32) if excl \
        else np.full(t, -1, np.int32)
    n_reach = n // 2 if signed_zeros else n
    choice = (np.zeros(t) if one_node else g.integers(-1, n_reach, t)).astype(np.int32)
    accept = (g.random(t) < p_accept) & (choice >= 0)
    if excl:
        # one accepted member of a group per node, as the winner scatter leaves it
        seen = set()
        for i in range(t):
            key = (int(task_excl[i]), int(choice[i]))
            if accept[i] and task_excl[i] >= 0:
                if key in seen:
                    accept[i] = False
                seen.add(key)
    vals = [0.0, 1.0, 0.1, 100.0, 333.3, 2.0 ** 24, 1e-3]
    req_vals = [0.0, -0.0, -0.0, 1.0] if signed_zeros else vals
    st = dict(
        idle=ft(g.choice(vals, (n, r)) * 7.0), used=ft(g.choice(vals, (n, r))),
        cnt=it(g.integers(0, 5, n)), assign=it(g.integers(-1, n, t)),
        active=torch.tensor(accept | (g.random(t) < 0.5), device=dev),
        job_placed=it(g.integers(0, 3, j)), job_alloc=ft(g.choice(vals, (j, r))),
        queue_alloc=ft(g.choice(vals, (q, r))), ns_alloc=ft(g.choice(vals, (s, r))),
        dirty=torch.tensor(g.random(n) < 0.5, device=dev))
    if excl:
        st["excl_occ"] = torch.tensor(g.random((groups, n)) < 0.2, device=dev)
    if signed_zeros:
        for name, rows in (("idle", slice(1, None, 3)), ("used", slice(0, None, 3)),
                           ("job_alloc", slice(0, None, 2)),
                           ("queue_alloc", slice(0, None, 2)),
                           ("ns_alloc", slice(0, None, 2))):
            st[name][rows] = -0.0
        for name in ("queue_alloc", "ns_alloc"):
            st[name][-1] = -0.0
    task_req = g.choice(req_vals, (t, r))
    if signed_zeros:
        task_req[:, -1] = -0.0  # a dimension no task asks for
    task_queue, task_ns = job_queue[task_job], job_ns[task_job]
    if pad:
        z = np.zeros(pad, np.int32)
        task_job, task_queue, task_ns = (np.concatenate([x, z]).astype(np.int32)
                                         for x in (task_job, task_queue, task_ns))
        task_excl = np.concatenate([task_excl, z - 1]).astype(np.int32)
        task_req = np.concatenate([task_req, np.zeros((pad, r))])
        choice = np.concatenate([choice, z - 1]).astype(np.int32)
        accept = np.concatenate([accept, np.zeros(pad, bool)])
        for name in ("assign", "active"):
            x = st[name]
            st[name] = torch.cat([x, torch.full((pad,), -1 if name == "assign" else 0,
                                                dtype=x.dtype, device=dev)])
    tc = dict(task_req=ft(task_req), task_job=it(task_job),
              task_queue=it(task_queue), task_ns=it(task_ns),
              task_excl=it(task_excl), job_task_start=it(start),
              job_task_count=it(counts))
    ctl = torch.zeros(RK.CTL_LEN, dtype=torch.int32, device=dev)
    did_full = torch.tensor(int(g.integers(0, 2)), dtype=torch.int64, device=dev)
    return (_spec(False, excl), tc, st, it(choice), torch.tensor(accept, device=dev),
            did_full, ctl)


COMMIT_CASES = (
    ("random", dict(seed=1, t=900, n=40, j=60, q=3, s=2)),
    ("one-node-one-queue", dict(seed=2, t=2000, n=8, j=30, q=1, s=1, one_node=True,
                                p_accept=0.9)),
    ("none-accepted", dict(seed=3, t=300, n=16, j=20, q=2, s=2, p_accept=0.0)),
    ("excl", dict(seed=4, t=600, n=32, j=40, q=4, s=3, excl=True)),
    ("three-dims", dict(seed=5, t=700, n=24, j=50, q=2, s=5, r=3)),
    ("signed-zeros", dict(seed=6, t=400, n=32, j=24, q=4, s=3, r=3,
                          signed_zeros=True, pad=48)),
)


def commit_cases(device="cpu", dtype=torch.float64):
    """[(label, args)] of COMMIT_CASES on ``device``."""
    return [(label, commit_case(device=device, dtype=dtype, **kw))
            for label, kw in COMMIT_CASES]


def rollback_case(seed, roll=True, **kw):
    """A crafted rollback call (spec, tc, st, roll_job, any_cand, ctl) on
    a commit case's state after its commit: the job with the most placed
    tasks retires (``roll``), or no job does."""
    spec, tc, st, choice, accept, did_full, ctl = commit_case(seed, **kw)
    RK.round_commit_plain(spec, tc, st, choice, accept, did_full, ctl)
    j = st["job_placed"].shape[0]
    roll_job = torch.zeros(j, dtype=torch.bool, device=ctl.device)
    if roll:
        roll_job[int(torch.argmax(st["job_placed"]))] = True
    any_cand = torch.tensor(int(roll), dtype=torch.int64, device=ctl.device)
    return spec, tc, st, roll_job, any_cand, ctl


def rollback_cases(device="cpu", dtype=torch.float64):
    """[(label, args)]: each COMMIT_CASES state with a job retired, and the
    first with none."""
    out = [(label, rollback_case(device=device, dtype=dtype, **kw))
           for label, kw in COMMIT_CASES]
    label, kw = COMMIT_CASES[0]
    out.append((label + "-no-candidate",
                rollback_case(roll=False, device=device, dtype=dtype, **kw)))
    return out


# -- K4 and K5 ----------------------------------------------------------------

MI = 1024.0 * 1024.0


def _dims(g, r):
    """(res_unit, eps, is_scalar) of ``r`` dimensions: milli-cpu, memory
    in MiB, then scalar dimensions."""
    unit = np.array([1.0, MI] + [1.0] * (r - 2))[:r]
    eps = np.array([10.0, 10.0 * MI] + [10.0] * (r - 2))[:r]
    is_scalar = np.array([False, False] + [True] * (r - 2))[:r]
    return unit, eps, is_scalar


def _requests(g, t, r, big=False):
    """[t, r] requests in the dimensions' units, non-integral so the
    quantization's ceil shows; ``big``: 64 cores each."""
    if big:
        req = np.zeros((t, r))
        req[:, 0] = 64_000.0
        return req
    cols = [g.choice([0.0, 100.0, 250.0, 999.5, 2000.0], t),
            g.choice([0.0, 256.0, 511.3, 2048.0], t) * MI]
    cols += [g.choice([0.0, 0.0, 0.0, 5.0, 10.0, 11.0, 50.0, 1000.0], t)
             for _ in range(r - 2)]
    return np.stack(cols[:r], axis=1)


def resolve_inputs(seed, t, n, r=3, *, hot=None, p_none=0.2, big=False,
                   skip=False):
    """One crafted K4 input at the round's level (numpy): (enc, idle, cnt,
    choice, task_rank). ``hot`` (node, count): that many tasks choose one
    node; ``p_none``: the share of tasks with no choice; ``big``: 64-core
    requests on nodes whose bounds saturate at 2^31 - 1 units; ``skip``:
    small scalar idle, so scalar rows are rejected and later rows fit only
    through the scalar skip."""
    g = np.random.default_rng(seed)
    unit, eps, is_scalar = _dims(g, r)
    req = _requests(g, t, r, big)
    choice = g.integers(0, n, t)
    if hot is not None:
        choice[g.permutation(t)[:hot[1]]] = hot[0]
    choice[g.random(t) < p_none] = -1
    idle = np.stack([g.choice([3000.0, 16000.5, 64000.0], n),
                     g.choice([4096.0, 30000.7], n) * MI]
                    + [g.choice([0.0, 40.0, 8000.0], n) for _ in range(r - 2)],
                    axis=1)[:, :r]
    if hot is not None:
        # room for about half the hot node's tasks, in every dimension
        idle[hot[0]] = req[choice == hot[0]].sum(axis=0) * 0.5 + 1.0
    if big:
        idle[:, 0] = 2.0 ** 40
        eps[0] = 0.0
    if skip:
        idle[:, 2:] = 20.0
        idle[:, :2] *= 50.0
    idle[0] = -5.0 if n > 2 and not big else idle[0]  # an over-committed node
    enc = {"is_scalar": is_scalar, "res_unit": unit, "eps": eps, "task_req": req,
           "task_has_pod": g.random(t) < 0.9,
           "node_max_tasks": g.integers(2, max(3, 2 * t // n), n).astype(np.int32)}
    return (enc, idle, g.integers(0, 5, n).astype(np.int32),
            choice.astype(np.int32), g.permutation(t).astype(np.int32))


# (label, resolve_inputs keyword arguments): the crafted K4 cases
RESOLVE_CASES = (
    ("multi-tile segment", dict(seed=1, t=5000, n=20, hot=(3, 3000))),
    ("one node", dict(seed=2, t=4000, n=1, hot=(0, 4000), p_none=0.0)),
    ("infeasible tail mid-tile", dict(seed=3, t=3000, n=50, p_none=0.37)),
    ("64-core past int32", dict(seed=4, t=70_000, n=2, r=2, big=True, p_none=0.0)),
    ("rejection then scalar skip", dict(seed=5, t=900, n=6, skip=True)),
    ("one dimension", dict(seed=6, t=2000, n=30, r=1)),
    ("five dimensions", dict(seed=7, t=2500, n=40, r=5)),
)


def resolve_args(inp, check_pod, device="cpu", dtype=torch.float64):
    """K4's arguments for a ``resolve_inputs`` input, made as the round
    makes them (``rounds._resolve``)."""
    enc, idle, cnt, choice, rank = inp
    dev = torch.device(device)
    te = R.quantize({k: torch.tensor(v, device=dev, dtype=dtype
                                     if v.dtype == np.float64 else None)
                     for k, v in enc.items()})
    ch = torch.tensor(choice, device=dev)
    key = torch.where(ch >= 0, ch, torch.full_like(ch, RK.INT32_MAX))
    order = R._pair_order(key, torch.tensor(rank, device=dev))
    return (order, ch, te["task_req_i"], te["task_has_pod"],
            torch.tensor(idle, dtype=dtype, device=dev), te["res_unit"], te["eps_i"],
            te["is_scalar"], torch.tensor(cnt, device=dev), te["node_max_tasks"],
            check_pod)


def resolve_cases(device="cpu", dtype=torch.float64):
    """[(label, args)] of RESOLVE_CASES on ``device``, with and without the
    pod check."""
    return [(f"{label}{' pods' if pod else ''}",
             resolve_args(resolve_inputs(**kw), pod, device, dtype))
            for label, kw in RESOLVE_CASES for pod in (False, True)]


def budget_inputs(seed, j, q, r=3, *, per=3, pad_tasks=0, pad_jobs=0,
                  big=False, edge=False, p_accept=0.7):
    """One crafted K5 input at the round's level (numpy): (enc, queue_alloc,
    accept, task_rank, task_queue, task_job, job_queue, job_order). Jobs
    own contiguous task ranges (1 .. 2 x per tasks each), as the encoder
    lays them out, in queues drawn at random, so the queues' jobs
    interleave in rank; a task's rank is its job's rank x T + its place in
    the job, as the round makes it. ``pad_jobs`` jobs hold no task;
    ``pad_tasks`` tasks follow the jobs' (job 0, never accepted), as the
    solver's buckets pad. ``big``: one-task jobs of 64 cores whose sums
    pass 2^31; ``edge``: a scalar dimension whose budget ends at the skip
    edge (tot 10 passes, 11 does not)."""
    g = np.random.default_rng(seed)
    unit, eps, is_scalar = _dims(g, r)
    counts = (np.ones(j, np.int64) if big or edge else g.integers(1, 2 * per + 1, j))
    counts[j - pad_jobs:] = 0
    task_job = np.repeat(np.arange(j), counts)
    t_real = task_job.shape[0]
    t = t_real + pad_tasks
    task_job = np.concatenate([task_job, np.zeros(pad_tasks, np.int64)]).astype(np.int32)
    in_job = np.concatenate([np.arange(t_real) - np.repeat(np.cumsum(counts) - counts,
                                                           counts),
                             t_real + np.arange(pad_tasks)])
    job_queue = g.integers(0, q, j).astype(np.int32)
    job_order = g.permutation(j)
    job_rank = np.empty(j, np.int64)
    job_rank[job_order] = np.arange(j)
    task_rank = (job_rank[task_job] * t + in_job).astype(np.int32)
    req = _requests(g, t, r, big)
    accept = g.random(t) < p_accept
    accept[t_real:] = False
    # each queue deserves a share of what its accepted tasks ask for
    asked = np.zeros((q, r))
    np.add.at(asked, job_queue[task_job][accept], req[accept])
    deserved = asked * g.choice([0.2, 0.5, 0.8], (q, 1)) + 1.0
    queue_alloc = g.choice([0.0, 1e4, 3e4], (q, r)) * np.array([1.0, MI] + [0.0] * (r - 2))[:r]
    if big:
        deserved[:, 0] = 2.0 ** 40
        eps[0] = 0.0
        queue_alloc[:] = 0.0
    if edge:
        # one unit of the scalar dimension a task, its budget 0 + eps 10
        req[:, 2] = 1.0
        deserved[:, 2] = 0.0
        deserved[:, :2] *= 100.0
    enc = {"is_scalar": is_scalar, "res_unit": unit, "eps": eps, "task_req": req,
           "queue_deserved": deserved, "job_queue": job_queue}
    return (enc, queue_alloc, accept, task_rank, job_queue[task_job], task_job,
            job_queue, job_order)


# (label, budget_inputs keyword arguments): the crafted K5 cases
BUDGET_CASES = (
    ("one queue, 8192 jobs", dict(seed=1, j=8192, q=1, per=2)),
    ("ten queues", dict(seed=2, j=3000, q=10)),
    ("padded tasks and jobs", dict(seed=3, j=500, q=3, pad_tasks=300, pad_jobs=40)),
    ("64-core past int32", dict(seed=4, j=70_000, q=1, r=2, big=True, p_accept=1.0)),
    ("scalar skip edge", dict(seed=5, j=300, q=2, edge=True, p_accept=1.0)),
    ("one dimension", dict(seed=6, j=700, q=4, r=1)),
    ("five dimensions", dict(seed=7, j=900, q=3, r=5)),
)


def budget_args(inp, device="cpu", dtype=torch.float64):
    """K5's arguments for a ``budget_inputs`` input, made as the round
    makes them (``rounds._queue_budget`` with the round's job order)."""
    enc, queue_alloc, accept, task_rank, task_queue, task_job, _, job_order = inp
    dev = torch.device(device)
    te = R.quantize({k: torch.tensor(v, device=dev, dtype=dtype
                                     if v.dtype == np.float64 else None)
                     for k, v in enc.items()})
    jq, jqueue = R._budget_order(
        te, torch.tensor(task_rank, device=dev), torch.tensor(task_queue, device=dev),
        torch.tensor(task_job, device=dev), torch.tensor(job_order, device=dev))
    return (torch.tensor(accept, device=dev), torch.tensor(task_job, device=dev),
            te["task_req_i"], jq, jqueue, torch.tensor(queue_alloc, dtype=dtype, device=dev),
            te["res_unit"], te["queue_bound_i"], te["is_scalar"])


def budget_cases(device="cpu", dtype=torch.float64):
    """[(label, args)] of BUDGET_CASES on ``device``."""
    return [(label, budget_args(budget_inputs(**kw), device, dtype))
            for label, kw in BUDGET_CASES]


# -- K2b and K6 -------------------------------------------------------------------

# the rows of a crafted walk, by kind: sorted with ties and signed zeros and
# a -inf tail; all -inf; -inf ahead of a feasible tail; one tied group;
# distinct values
WALK_ROWS = ("ties", "all -inf", "-inf first", "one group", "distinct")


def _walk_row(g, kind, w):
    if kind == "all -inf":
        return np.full(w, -np.inf)
    if kind == "one group":
        return np.full(w, g.choice([0.0, -0.0, 2.5]))
    if kind == "distinct":
        return np.sort(g.random(w) * 100.0)[::-1].copy()
    row = np.sort(g.choice([9.0, 4.5, 4.5, 1.0, 0.0, -0.0, -2.0], w))[::-1].copy()
    # +0.0 and -0.0 in place in the sorted row (they tie as floats)
    zeros = row == 0.0
    row[zeros] = g.choice([0.0, -0.0], int(zeros.sum()))
    row[w - w // 5:] = -np.inf
    if kind == "-inf first":
        row = np.concatenate([np.full(w // 3, -np.inf), row[:w - w // 3]])
    return row


def walk_inputs(seed, rows, w, n, r=3, *, binpack=False, excl=False, pod=True,
                t_cap=None):
    """One crafted K2b input (numpy): (flags, arrays, t_cap). The rows
    cycle through WALK_ROWS; requests are zero in some dims (a row asks for
    nothing at all); idle holds negative (over-committed), zero and large
    rows; pod room is zero or negative on some nodes; ``t_cap`` small
    makes the prefixes saturate."""
    g = np.random.default_rng(seed)
    score = np.stack([_walk_row(g, WALK_ROWS[i % len(WALK_ROWS)], w) for i in range(rows)])
    order = np.stack([g.permutation(n)[:w] for _ in range(rows)]).astype(np.int32)
    req = g.choice([0.0, 0.0, 100.0, 250.0, 999.5, 4000.0], (rows, r))
    req[0] = 0.0
    idle = g.choice([-500.0, 0.0, 99.0, 1000.0, 16000.0, 1e9], (n, r))
    nmax = g.integers(0, 8, n).astype(np.int32)
    cnt = np.minimum(g.integers(0, 10, n), nmax + 1).astype(np.int32)
    arrays = {"order": order, "score_ord": score, "req": req,
              "exl": g.integers(-1, 3, rows).astype(np.int32),
              "has_pod": g.random(rows) < 0.7, "frac": g.choice([0.0, 0.125, 0.3, 1.0], rows),
              "idle": idle, "cnt": cnt, "node_max_tasks": nmax,
              "eps": np.array([10.0] * r)}
    if t_cap is None:
        t_cap = 4 * n + 1
    return dict(binpack=binpack, excl=excl, pod=pod), arrays, int(t_cap)


# (label, walk_inputs keyword arguments): the crafted K2b cases
WALK_CASES = (
    ("ties and signed zeros", dict(seed=1, rows=15, w=64, n=200)),
    ("binpack", dict(seed=2, rows=10, w=100, n=150, binpack=True)),
    ("exclusion", dict(seed=3, rows=10, w=64, n=64, excl=True)),
    ("binpack exclusion, no pod check", dict(seed=4, rows=10, w=50, n=80, binpack=True,
                                             excl=True, pod=False)),
    ("saturating at t_cap", dict(seed=5, rows=6, w=300, n=400, t_cap=37)),
    ("width 1", dict(seed=6, rows=5, w=1, n=10)),
    ("odd width", dict(seed=7, rows=7, w=333, n=1001)),
    ("past one chunk", dict(seed=8, rows=5, w=5001, n=6000)),
    ("one dimension", dict(seed=9, rows=5, w=40, n=60, r=1)),
    ("five dimensions", dict(seed=10, rows=5, w=40, n=60, r=5)),
)
# the widths the main path gives K2b: (label, rows, W, N) of the window and
# the full-width cover at cfg5, cfg2 and cfg6
WALK_SHAPES = (
    ("cfg5 window", 16, 1024, 10000), ("cfg5 cover", 16, 10000, 10000),
    ("cfg2 window", 64, 128, 1000), ("cfg2 cover", 64, 1000, 1000),
    ("cfg6 window", 512, 128, 1000), ("cfg6 cover", 512, 1000, 1000),
)


def walk_args(inp, device="cpu", dtype=torch.float64):
    """K2b's arguments for a ``walk_inputs`` input: (spec, order, score_ord,
    req, exl, has_pod, frac, idle, cnt, nmax, eps, t_cap)."""
    flags, a, t_cap = inp
    dev = torch.device(device)
    ft = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    it = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    spec = _spec(flags["binpack"], flags["excl"], flags["pod"])
    return (spec, it(a["order"]), ft(a["score_ord"]), ft(a["req"]),
            it(a["exl"]) if spec.use_exclusion else None,
            torch.tensor(a["has_pod"], device=dev),
            ft(a["frac"]) if spec.use_binpack else None, ft(a["idle"]), it(a["cnt"]),
            it(a["node_max_tasks"]), ft(a["eps"]), t_cap)


def walk_cases(device="cpu", dtype=torch.float64):
    """[(label, args)] of WALK_CASES and of random rows at WALK_SHAPES (with
    binpack, exclusion and the pod check), on ``device``."""
    out = [(label, walk_args(walk_inputs(**kw), device, dtype)) for label, kw in WALK_CASES]
    for i, (label, rows, w, n) in enumerate(WALK_SHAPES):
        inp = walk_inputs(20 + i, rows, w, n, binpack=i % 2 == 0, excl=i >= 4)
        out.append((label, walk_args(inp, device, dtype)))
    return out


# the job-order key orders the crafted ranks run under: every order of the
# three tiers, and shorter ones
RANK_KEY_ORDERS = (
    ("priority", "gang", "drf"), ("priority", "drf", "gang"), ("gang", "priority", "drf"),
    ("gang", "drf", "priority"), ("drf", "priority", "gang"), ("drf", "gang", "priority"),
    ("priority", "gang"), ("drf",), (),
)
# the kinds of crafted job columns
RANK_KINDS = ("random", "signed-zero shares", "zero totals", "absent dims", "all equal")


def rank_inputs(seed, j, kind="random", r=3):
    """One crafted K6 input (numpy): the job columns (rounds_kernels.
    JOB_COLS), job_placed and job_alloc. ``kind``: "random" (few distinct
    values, so every tier ties often), "signed-zero shares" (allocations of
    +0.0 and -0.0, so shares of both signs tie), "zero totals" (a total of 0
    under allocations that are not: share 1), "absent dims" (only one dim
    present, or none), "all equal" (every key and the tie rank equal: the
    index decides)."""
    g = np.random.default_rng(seed)
    cols = {"job_priority": g.integers(-2, 3, j), "job_ready_base": g.integers(0, 3, j),
            "job_min_available": g.integers(0, 6, j), "job_tie_rank": g.permutation(j),
            "drf_total": np.array([1000.0, 4096.0, 8.0][:r] + [0.0] * (r - 3))}
    present = np.ones(r, bool)
    placed = g.integers(0, 4, j)
    alloc = g.choice([0.0, 100.0, 250.0, 1000.0], (j, r))
    if kind == "random":
        cols["job_tie_rank"] = g.integers(0, 5, j)
    elif kind == "signed-zero shares":
        alloc = g.choice([0.0, -0.0], (j, r))
        alloc[::7, 0] = 500.0
    elif kind == "zero totals":
        cols["drf_total"][1:] = 0.0
        alloc[:, 1:] = g.choice([0.0, -0.0, 3.0], (j, r - 1))
    elif kind == "absent dims":
        present[1:] = False
        if seed % 2:
            present[:] = False
    else:  # all equal
        for name in ("job_priority", "job_ready_base", "job_min_available", "job_tie_rank"):
            cols[name] = np.full(j, 1)
        placed = np.zeros(j)
        alloc = np.full((j, r), 100.0)
    cols = {k: (v.astype(np.int32) if v.dtype.kind in "iu" else v) for k, v in cols.items()}
    cols["drf_present"] = present
    return cols, placed.astype(np.int32), alloc


# the job counts the main path gives K6: cfg5, cfg2 and cfg6's padded J
RANK_SHAPES = (("cfg5", 8192), ("cfg2", 2048), ("cfg6", 4096))


def rank_args(inp, keys, device="cpu", dtype=torch.float64):
    """K6's arguments (spec, cols, job_placed, job_alloc) for a
    ``rank_inputs`` input under the job-order ``keys``."""
    cols, placed, alloc = inp
    dev = torch.device(device)
    spec = _spec(False, False)._replace(job_order_keys=tuple(keys))
    tc = {k: torch.tensor(v, device=dev, dtype=dtype if v.dtype == np.float64 else None)
          for k, v in cols.items()}
    return (spec, tc, torch.tensor(placed, device=dev),
            torch.tensor(alloc, dtype=dtype, device=dev))


def rank_cases(device="cpu", dtype=torch.float64):
    """[(label, args)]: every RANK_KIND under every RANK_KEY_ORDER at 700
    jobs (two tiles of K6's sort), then RANK_SHAPES' job counts under the
    three tiers."""
    out = []
    for i, kind in enumerate(RANK_KINDS):
        for keys in RANK_KEY_ORDERS:
            out.append((f"{kind} {'/'.join(keys) or 'tie rank only'}",
                        rank_args(rank_inputs(30 + i, 700, kind), keys, device, dtype)))
    for i, (label, j) in enumerate(RANK_SHAPES):
        out.append((label, rank_args(rank_inputs(40 + i, j), RANK_KEY_ORDERS[0], device,
                                     dtype)))
    return out


# -- K7b: capped solves whose tails take crafted paths -----------------------

TAIL_KINDS = ("base", "ties", "queues", "no fit", "stuck", "drf")


def tail_base_arrays(scale: float = 0.06):
    """(spec, padded numpy arrays) of the port's own cfg6 allocate encode
    at ``scale``, capped as tests/test_torch_rounds_gpu.py caps it (a
    progress floor of 40, two straggler rounds): its tail places the
    remainder with exclusion groups, the pod check and binpack, and meets
    jobs whose first tasks the rounds placed."""
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.ops import solver
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(6, scale)
    ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[6].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cpu",
                     "tpuscore.dtype": "float64"}}))
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    arrays = {k: np.array(v) for k, v in solver.pad_encoded(prep["enc"]).items()
              if k not in solver._ROUNDS_SKIP}
    spec = prep["spec"]._replace(round_min_progress=40, straggler_rounds=2)
    return spec, arrays


def tail_solve_case(kind: str, base=None):
    """(spec, arrays) of a capped solve whose tail takes ``kind``
    (TAIL_KINDS), numpy first (tests/test_torch_tail_cases.py feeds the
    same arrays to the JAX package):

    - "base": the cfg6 encode as it is;
    - "ties": every job's priority and tie rank equal and every gang
      ready (min_available 0), so the jobs tie on every key level and the
      tail's order falls to task_in_job, then the task index;
    - "queues": the jobs dealt over three queues (the gate on), each
      queue's deserved share 0.95 of its jobs' requests over its starting
      allocation: the rounds stop short of it and the tail takes two
      queues across their share while it runs;
    - "stuck": the same at 0.9: the rounds take every queue over its
      share with tasks left, so the tail's first step finds nothing
      eligible and stops;
    - "no fit": the last job's class asks for more than any node holds,
      so its tasks reach the tail and no node fits them (tail_failed);
    - "drf": drf first in the job order over every dimension (cfg6 has
      no drf totals: its shares are all 0), the cluster's capacity the
      totals, half the jobs' starting allocations -0.0 and the rest +0.0
      (the rounds' commits add +0.0 to every job's row, so no -0.0
      reaches a tail this way: ``negative_zero_shares`` puts it there)."""
    spec, a = base if base is not None else tail_base_arrays()
    a = {k: v.copy() for k, v in a.items()}
    if kind == "ties":
        a["job_priority"][:] = 0
        a["job_tie_rank"][:] = 0
        a["job_min_available"][:] = 0
    elif kind in ("queues", "stuck"):
        _three_queues(a, 0.95 if kind == "queues" else 0.9)
        spec = spec._replace(use_prop_overused=True)
    elif kind == "no fit":
        last = int(np.nonzero(a["job_task_count"] > 0)[0][-1])
        c = a["task_cls"][a["job_task_start"][last]]
        big = a["node_alloc"].max(axis=0) * 2 + 1
        a["cls_req"][c] = big
        a["cls_initreq"][c] = big
        a["cls_nz_cpu"][c] = big[0]
        a["cls_nz_mem"][c] = big[1]
    elif kind == "drf":
        a["drf_present"][:] = True
        a["drf_total"] = a["node_alloc"].sum(axis=0).astype(a["drf_total"].dtype)
        a["job_alloc0"][:] = 0.0
        a["job_alloc0"][::2] = -0.0
        spec = spec._replace(job_order_keys=("drf",) + tuple(
            k for k in spec.job_order_keys if k != "drf"))
    elif kind != "base":
        raise KeyError(kind)
    return spec, a


def _three_queues(a, frac: float) -> None:
    """Deal the jobs of ``a`` over three queues, each queue's deserved
    share ``frac`` of its jobs' requests over its starting allocation."""
    q, J = 3, a["job_tie_rank"].shape[0]
    a["job_queue"] = (np.arange(J) % q).astype(a["job_queue"].dtype)
    r = a["queue_deserved"].shape[1]
    task_req = a["cls_req"][a["task_cls"]]
    valid = np.arange(a["task_cls"].shape[0]) < (
        a["job_task_start"] + a["job_task_count"])[a["task_job"]]
    want = np.zeros((q, r))
    np.add.at(want, a["job_queue"][a["task_job"][valid]], task_req[valid])
    alloc0 = np.zeros((q, r), a["queue_alloc0"].dtype)
    alloc0[0] = a["queue_alloc0"][0]
    a["queue_alloc0"] = alloc0
    a["queue_deserved"] = (alloc0 + want * frac).astype(a["queue_deserved"].dtype)
    a["queue_present"] = np.repeat(a["queue_present"][:1], q, axis=0)
    a["queue_tie_rank"] = np.arange(q, dtype=a["queue_tie_rank"].dtype)
    a["q_in_ns0"] = np.repeat(a["q_in_ns0"][:1], q, axis=0)


def negative_zero_shares(st):
    """A tail's state with every job's allocation -0.0 in every dimension
    on the even jobs and +0.0 on the odd ones: drf shares of both signs
    of zero, which tie."""
    st = dict(st)
    alloc = torch.zeros_like(st["job_alloc"])
    alloc[::2] = -0.0
    st["job_alloc"] = alloc
    return st


def widen_nodes(enc, st, n: int):
    """A tail's inputs (``enc``, ``st``: the tail pass's) with the node
    axis tiled to ``n`` nodes: every node column and state row repeated
    (the sig masks, affinities and exclusion occupancy with it), so the
    state is too large for K7b's shared-memory placement."""
    n0 = st["idle"].shape[0]
    reps = -(-n // n0)

    def tile(t, axis):
        out = torch.cat([t] * reps, dim=axis)
        return out.narrow(axis, 0, n).contiguous()

    enc = dict(enc)
    for k in ("node_max_tasks", "node_alloc"):
        enc[k] = tile(enc[k], 0)
    for k in ("sig_mask", "affinity_score"):
        enc[k] = tile(enc[k], 1)
    st = dict(st)
    for k in ("idle", "used", "cnt"):
        st[k] = tile(st[k], 0)
    if st.get("excl_occ") is not None:
        st["excl_occ"] = tile(st["excl_occ"], 1)
    return enc, st


def widen_classes(enc, k: int):
    """A tail's inputs with the class axis tiled to ``k`` classes (the
    tasks keep theirs), so K7b's class columns and state no longer fit in
    shared memory together: the global placement."""
    k0 = enc["cls_req"].shape[0]
    reps = -(-k // k0)
    enc = dict(enc)
    for name in ("cls_req", "cls_initreq", "cls_sig", "cls_nz_cpu", "cls_nz_mem",
                 "cls_has_pod"):
        enc[name] = torch.cat([enc[name]] * reps, dim=0)[:k].contiguous()
    return enc


def split_segments(enc, st):
    """A tail's inputs with every task a segment of its own (task_in_job
    decreasing along the task axis) and every task live, so more segments
    live than K7b's warp-0 select takes: its block-wide select."""
    enc = dict(enc)
    enc["task_in_job"] = (-torch.arange(enc["task_in_job"].shape[0], dtype=torch.int32)
                          ).to(enc["task_in_job"].device)
    st = dict(st)
    st["active"] = torch.ones_like(st["active"])
    return enc, st
