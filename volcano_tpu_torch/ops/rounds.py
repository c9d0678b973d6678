"""Rounds-mode throughput solver: bulk-synchronous batched placement.

Port of volcano_tpu/ops/rounds.py (see its docstring for the algorithm
and its documented divergences from the serial oracle). Each function keeps
its counterpart's name and arithmetic; on the same padded arrays in
float64 on the CPU, ``solve_rounds`` returns the reference's ``assign``,
round count, placed histogram, full-sweep count and touched-node mask bit
for bit (tests/test_torch_rounds.py).

The reference's loop nest (the inner rounds, the rollback fixpoint, the
straggler rounds, the tail pass under lax.cond) is a flat step machine here
(``StepMachine``): the solve state lives in fixed tensors, a step is one
round (plain, conservative or straggler), the rollback or the tail pass,
and after every step K7a ``rounds_ctl`` folds the step's counters into an
int32 control vector and decides the next step, taking the decisions the
reference's lax.while_loop/lax.cond take. On the card a solve is one replay
of a CUDA graph that runs the machine (ops/rounds_graph.py): nothing is
read back before the one fetch of the packed result. On the CPU, and on
the card when asked (``loop="host"``), the same machine is driven from the
host with the plain controller and the plain tail.

The kernel-shaped steps run through hand-written CUDA kernels on the card:
K1 ``score_block`` (ops/kernels.py) for the full and the dirty-column
score refresh, K2 ``window_topk``, K2b ``cap_walk`` (the capacity walk of
the window and of the full-width cover), K6 ``job_rank`` (the round's and
the rollback's job ranks), K3 ``round_select`` (the select with K6's
in-class and exclusion-group ranks and the window's coverage test, on the
class order the head sorts once a solve), K4 ``resolve_prefix``, K5
``queue_budget``, K7a ``rounds_ctl``, K7b ``tail_pass`` (the whole
sequential tail in one launch) and K7c ``round_commit`` (the scatter-adds
of a round's commit and of the rollback, each row's updates in task
order; ops/rounds_kernels.py). Sorts, gathers and scatters around them
are torch ops. On the CPU the
scatter-adds of float state use ``index_put_(accumulate=True)``, which
adds a row's updates one after another in task order, to the row's value,
as the reference's sequential scatter does; on the card K7c does the same
in one launch (torch's CUDA ``index_put_`` sums a row's duplicates first
and adds the sum, another rounding). A solve is run-to-run deterministic.
"""

from __future__ import annotations

import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import rounds_kernels as RK
from volcano_tpu_torch.ops.kernels import (  # noqa: F401 (CHUNK re-exported)
    CHUNK,
    SolveSpec,
    _le_eps,
    score_block,
)
from volcano_tpu_torch.ops.rounds_kernels import (
    INT32_MAX,
    cap_walk,
    job_rank,
    queue_budget,
    resolve_prefix,
    round_commit,
    round_rollback,
    round_select,
    to_i32 as _to_i32,
    window_topk,
)
from volcano_tpu_torch.utils import devprof


# per-round profile exported through the packed single-fetch result:
# node-count header (sizes the touched-node mask that precedes the tail),
# placed-per-round histogram slots plus the scalar tail (round-count limbs,
# tail_placed, full-sweep round count, capped flag)
PROF_SLOTS = RK.PROF_SLOTS
PROF_TAIL = 6 + PROF_SLOTS


def _pair_order(primary: torch.Tensor, secondary: torch.Tensor):
    """jnp.lexsort((secondary, primary)) for int32 keys, as one stable sort
    of the injective int64 key (primary, secondary)."""
    key = primary.to(torch.int64) * (1 << 32) + (secondary.to(torch.int64)
                                                 + (1 << 31))
    return torch.argsort(key, stable=True)


def _job_rank(spec: SolveSpec, enc, job_placed, job_alloc):
    """([J] dense rank from the tiered job-order keys (low = first), [J]
    the jobs in that order): K6 ``job_rank`` on the encode's job columns."""
    return job_rank(spec, {k: enc[k] for k in RK.JOB_COLS}, job_placed, job_alloc)


def _dirty_cols(dirty, n_dirty, dirty_k: int):
    """jnp.nonzero(dirty, size=dirty_k, fill_value=0) without a dynamic
    shape: a stable sort brings the dirty columns first, ascending.
    ``n_dirty`` is the dirty count, a 0-d tensor (or a number)."""
    n_total = dirty.shape[0]
    srt = torch.argsort((~dirty).to(torch.int8), stable=True).to(torch.int32)
    if dirty_k > n_total:
        srt = torch.cat([srt, torch.zeros(dirty_k - n_total, dtype=torch.int32,
                                          device=dirty.device)])
    else:
        srt = srt[:dirty_k]
    pos = torch.arange(dirty_k, device=dirty.device)
    return torch.where(pos < n_dirty, srt, torch.zeros_like(srt))


def _rescore_dirty(spec, enc, idle, used, cnt, excl_occ, scores, dirty,
                   n_dirty):
    """Dirty-column rescoring: K1 over the <= dirty_k columns the previous
    round touched, written into the carried matrix in place. Padding slots
    of the column list alias column 0 and rewrite identical values."""
    cols = _dirty_cols(dirty, n_dirty, spec.dirty_k)
    return score_block(spec, enc, idle, used, cnt, excl_occ, scores, cols=cols)


def _cap_walk(spec: SolveSpec, enc, order, score_ord, req, exl, has_pod,
              frac, idle, cnt, t_cap):
    """Capacity estimates and equal-score group structure along an ORDERED
    candidate axis (the full stable-argsort order or its top-k prefix):
    K2b ``cap_walk``. order/score_ord: [rows, W]. Returns (ccap, g_start,
    g_size, ccap_before), all int32 [rows, W]."""
    return cap_walk(spec, order, score_ord, req, exl, has_pod, frac, idle, cnt,
                    enc.get("node_max_tasks"), enc["eps"], t_cap)


def _nominate_full(spec: SolveSpec, enc, scores, idle, cnt, cls_frac, t_cap):
    """Full-width nomination: the stable argsort over all N columns (one
    torch sort of every class row) plus the capacity walk, one K2b call
    for every row (the reference chunks its rows to bound a [rows, N, R]
    gather that the kernel never builds; the rows are independent, so the
    result is the chunked one)."""
    order = torch.argsort(-scores, dim=-1, stable=True).to(torch.int32)
    score_ord = torch.gather(scores, 1, order.long())
    walk = _cap_walk(
        spec, enc, order, score_ord, enc["cls_req"],
        enc["cls_excl"] if spec.use_exclusion else None, enc["cls_has_pod"],
        cls_frac if spec.use_binpack else None, idle, cnt, t_cap)
    return (order,) + tuple(walk)


def quantize(enc):
    """``enc`` with the integer units of the exact acceptance scans, fixed
    for a solve: task_req_i = ceil(task_req / unit) (int64, saturated at
    the int32 range as the reference's convert), eps_i = eps / unit
    truncated (int32) and, where the encode has queues, queue_bound_i =
    floor(deserved / unit) + eps_i (an int32 add, widened). The solve's
    head computes them once."""
    unit = enc["res_unit"]
    eps_i = _to_i32(enc["eps"] / unit)
    out = dict(enc, eps_i=eps_i, task_req_i=_to_i32(
        torch.ceil(enc["task_req"] / unit[None, :])).to(torch.int64))
    if "queue_deserved" in enc:
        out["queue_bound_i"] = (_to_i32(torch.floor(enc["queue_deserved"]
                                                    / unit[None, :]))
                                + eps_i[None, :]).to(torch.int64)
    return out


def _node_rank_order(enc, choice, task_rank, job_order=None):
    """The tasks sorted by (node, rank), the tasks with no choice last (one
    stable torch sort). With the round's job order, where (N + 1) x T and
    J x T stay under 2^31, the key is int32: node x T + the task's place in
    rank order (its job's offset in the job order + its place in the job;
    the tasks with no choice all N x T), half the radix passes of the
    int64 (node, rank) key. Both give the same order of the tasks with a
    choice, which are valid tasks."""
    t_total = choice.shape[0]
    n_total = enc["node_max_tasks"].shape[0]
    j_total = enc["job_task_count"].shape[0] if "job_task_count" in enc else 0
    if (job_order is None or (n_total + 1) * t_total >= 2**31
            or j_total * t_total >= 2**31):
        node_key = torch.where(choice >= 0, choice,
                               torch.full_like(choice, INT32_MAX))
        return _pair_order(node_key, task_rank)
    count = enc["job_task_count"][job_order]
    off = torch.empty_like(count).scatter_(
        0, job_order, torch.cumsum(count, 0, dtype=torch.int32) - count)
    pos = off[enc["task_job"].long()] + enc["task_in_job"]
    key = torch.where(choice >= 0, choice * t_total + pos,
                      torch.full_like(choice, n_total * t_total))
    return torch.argsort(key, stable=True)


def _resolve(spec: SolveSpec, enc, idle, cnt, choice, task_rank, job_order=None):
    """Per-node prefix acceptance: sort by (node, rank), accept the longest
    priority-prefix whose cumulative request fits (K4, which reads the
    tasks through the sort's order and writes accept by task). Returns
    accept [T] bool. ``job_order``: the round's (``_job_rank``), for the
    narrow sort key (``_node_rank_order``)."""
    if "task_req_i" not in enc:
        enc = quantize(enc)
    order = _node_rank_order(enc, choice, task_rank, job_order)
    return resolve_prefix(order, choice, enc["task_req_i"], enc["task_has_pod"],
                          idle, enc["res_unit"], enc["eps_i"], enc["is_scalar"],
                          cnt, enc["node_max_tasks"], spec.check_pod_count)


def _budget_order(enc, task_rank, task_queue, task_job, job_order=None):
    """(K5's job order: the jobs by queue, then rank; each job's queue).

    ``job_order`` is the round's (the jobs in rank order, ``_job_rank``).
    A task's rank is its job's rank x T + its place in the job, in int32
    as the reference computes it; where J x T passes 2^31 those ranks wrap,
    and the reference's order is the wrapped one. Then, and without
    ``job_order``, the order is read off the task axis: a job's key is its
    lowest task rank (T is a power of two, so no job's block of ranks
    straddles the wrap), and the task ranks must keep each job's tasks
    together within its queue."""
    t_total = task_rank.shape[0]
    if "job_queue" in enc:
        job_queue = enc["job_queue"]
        j_total = job_queue.shape[0]
    else:
        j_total = int(task_job.max()) + 1
        job_queue = None
    if job_order is None or j_total * t_total >= 2**31:
        jl = task_job.long()
        if job_queue is None:
            job_queue = torch.zeros(j_total, dtype=torch.int32,
                                    device=task_job.device).scatter_(0, jl, task_queue)
        first = torch.full((j_total,), 2**62, dtype=torch.int64,
                           device=task_job.device).scatter_reduce(
            0, jl, task_rank.to(torch.int64), "amin")
        job_order = torch.argsort(first, stable=True)
    if enc["queue_deserved"].shape[0] > 1:
        job_order = job_order[torch.argsort(job_queue[job_order], stable=True)]
    return job_order, job_queue


def _queue_budget(enc, queue_alloc, accept, task_rank, task_queue, task_job,
                  job_order=None):
    """Job-granular queue fair-share cap inside a round (K5): a job's tasks
    survive iff queue_alloc + contributions of higher-ranked jobs in the
    same queue fit under deserved with the epsilon comparison.

    The reference orders the tasks by (queue, rank); a task's rank is its
    job's rank x T + its place in the job, so a job's tasks are contiguous
    there and the answer is the job's: K5 sums each job's accepted
    requests and scans the jobs by (queue, rank) (``_budget_order``), with
    no task-axis sort."""
    if "task_req_i" not in enc:
        enc = quantize(enc)
    jq, job_queue = _budget_order(enc, task_rank, task_queue, task_job, job_order)
    return queue_budget(accept, task_job, enc["task_req_i"], jq, job_queue,
                        queue_alloc, enc["res_unit"], enc["queue_bound_i"],
                        enc["is_scalar"])


def unpack_layout(layout, bufs):
    """Split packed flat buffers (solver._pack) into the enc dict: static
    slices viewed in place. Plain keys beside the packed "group.kind"
    buffers are merged as they are."""
    enc = {
        name: bufs[key][off:off + size].reshape(shape)
        for name, key, off, size, shape in layout
    }
    for key in bufs:
        if "." not in key:
            enc[key] = bufs[key]
    return enc


def pack_result(enc, raw):
    """Pack a solve_rounds result tuple into ONE array: assign, the
    touched-node mask, then a PROF_TAIL-long profile tail (node-count
    header, round-counter limbs, tail_placed, full-sweep round count,
    capped flag, the placed-per-round histogram); int16 when the node
    count allows. Built on the device from device scalars, so it can run
    inside a CUDA graph."""
    (assign, n_rounds, tail_placed, full_sweeps, capped, placed_hist,
     touched) = (x.to(torch.int32) for x in raw)
    n_total = enc["node_idle"].shape[0]
    cap = 0x7FFF
    tail = torch.cat([
        torch.stack([torch.full((), n_total, dtype=torch.int32,
                                device=assign.device),
                     n_rounds & cap, n_rounds >> 15,
                     torch.clamp(tail_placed, max=cap),
                     torch.clamp(full_sweeps, max=cap), capped]),
        torch.clamp(placed_hist, max=cap)])
    dt = torch.int16 if n_total <= 32766 else torch.int32
    return torch.cat([assign.to(dt), touched.to(dt), tail.to(dt)])


class _Dims:
    """Shapes and per-task columns every phase of one solve reads."""

    def __init__(self, enc):
        self.t = enc["task_cls"].shape[0]
        self.j = enc["job_tie_rank"].shape[0]
        self.k = enc["cls_req"].shape[0]
        self.n = enc["node_idle"].shape[0]
        self.dev = enc["cls_req"].device
        self.dt = enc["cls_req"].dtype
        self.task_cls = enc["task_cls"]
        self.task_cls_l = enc["task_cls"].long()
        self.task_job = enc["task_job"]
        self.task_job_l = enc["task_job"].long()
        self.task_queue = enc["job_queue"][self.task_job_l]
        self.task_queue_l = self.task_queue.long()
        self.task_ns = enc["job_ns"][self.task_job_l]
        self.task_ns_l = self.task_ns.long()
        self.task_excl = enc["cls_excl"][self.task_cls_l]
        ar = torch.arange(self.t, dtype=torch.int32, device=self.dev)
        self.task_in_job = ar - enc["job_task_start"][self.task_job_l]
        self.task_valid = (ar < (enc["job_task_start"][self.task_job_l]
                                 + enc["job_task_count"][self.task_job_l])) \
            & enc["job_active0"][self.task_job_l]


# the gated bodies of a step, by name (graph hit counters index them)
BODIES = ("step", "round", "full", "dirty", "cover", "rollback", "tail")


class StepMachine:
    """The flat step machine of one rounds solve (the reference's
    lax.while_loop nest, volcano_tpu/ops/rounds.py:925-980,1101): the
    solve state lives in fixed tensors, ``ctl`` (rounds_kernels.C_*) holds
    the loop state and ``pred`` the predicates of the next step, which K7a
    (``rounds_ctl``) decides after every step. One step is a round (plain,
    conservative or straggler), the rollback or the tail pass.

    ``mode`` says how a step's gates and the controller run:

    - ``"cpu"``: tensors on the CPU; Python ifs on the predicates, the
      plain controller and the plain tail (the tier-1 plain version);
    - ``"host"``: the same Python-driven machine on the card (``loop=
      "host"``), reading the controller's state back after every step and
      a coverage bit in every windowed round (counted sync points);
    - ``"warm"``: every gate taken, the controller and the tail as
      kernels: one eager pass over every body before a capture;
    - ``"capture"``: the gates become IF nodes and the step loop a WHILE
      node of the graph being captured (ops/rounds_graph.py).

    ``head()`` initialises the state from ``enc``; ``step()`` runs one
    step; ``finish()`` returns (raw result, packed result) computed from the
    state, without changing it."""

    def __init__(self, spec: SolveSpec, enc: dict, mode: str):
        self.spec, self.enc_in, self.mode = spec, enc, mode
        dev = enc["cls_req"].device
        dt = enc["cls_req"].dtype
        t = enc["task_cls"].shape[0]
        j = enc["job_tie_rank"].shape[0]
        k, r = enc["cls_req"].shape
        n = enc["node_idle"].shape[0]
        self.params = RK.ctl_params(spec, t, j, n)

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.st = dict(
            idle=z(n, r), used=z(n, r), cnt=z(n, dtype=torch.int32),
            assign=z(t, dtype=torch.int32), active=z(t, dtype=torch.bool),
            job_placed=z(j, dtype=torch.int32),
            job_alloc=z(*enc["job_alloc0"].shape),
            queue_alloc=z(*enc["queue_alloc0"].shape),
            ns_alloc=z(*enc["ns_alloc0"].shape),
            # carried masked score matrix + dirty-column set: all columns
            # start dirty, so the first round always takes a full refresh
            # (or an all-column gather when dirty_k covers the whole axis)
            scores=z(k, n), dirty=z(n, dtype=torch.bool),
            touched=z(n, dtype=torch.bool), tail_failed=z(t, dtype=torch.bool))
        if spec.use_exclusion:
            self.st["excl_occ"] = z(*enc["excl_occ0"].shape, dtype=torch.bool)
        self.ctl = z(RK.CTL_LEN, dtype=torch.int32)
        self.pred = z(RK.NPRED, dtype=torch.bool)
        self.hits = z(len(BODIES), dtype=torch.int32)
        self.choice_full = z(t, dtype=torch.int32)
        self.hp = None          # the predicates on the host (cpu, host)
        self.cond = None        # the graph's conditional-node hooks
        self.while_handle = None

    # -- gates and the controller ------------------------------------------

    def _gate(self, pred, body: str, fn) -> None:
        """Run ``fn`` when ``pred`` holds: an index into the controller's
        predicates, or a 0-d bool tensor the step computed."""
        if self.mode == "warm":
            fn()
        elif self.mode == "capture":
            t = self.pred[pred] if isinstance(pred, int) else pred
            with self.cond.if_node(t, body):
                self.hits[BODIES.index(body)] += 1
                fn()
        elif isinstance(pred, int):
            if self.hp[pred]:
                fn()
        elif bool(pred if self.mode == "cpu" else devprof.readback(pred)):
            fn()

    def control(self) -> None:
        """K7a after a step (or the head): fold and decide."""
        if self.mode == "cpu":
            self.hp = RK.rounds_ctl_plain(self.ctl, self.pred, self.params)
        elif self.mode == "host":
            c = devprof.readback(self.ctl)
            self.hp = RK._ctl_fold_decide(c, self.params)
            self.ctl.copy_(torch.tensor(c, dtype=torch.int32))
            self.pred.copy_(torch.tensor(self.hp, dtype=torch.bool))
        elif self.while_handle is not None:
            RK.rounds_ctl_while(self.ctl, self.pred, self.params,
                                self.while_handle)
        else:
            RK.rounds_ctl(self.ctl, self.pred, self.params)

    def done(self) -> bool:
        """The host's view (cpu, host): no step is pending."""
        return not self.hp[RK.P_ACTIVE]

    # -- head, step, finish -------------------------------------------------

    def head(self) -> None:
        spec = self.spec
        # the task columns and the acceptance scans' integer units (K4, K5),
        # once a solve
        enc = quantize(dict(
            self.enc_in,
            task_req=self.enc_in["cls_req"][self.enc_in["task_cls"].long()],
            task_has_pod=self.enc_in["cls_has_pod"][self.enc_in["task_cls"].long()],
        ))
        d = _Dims(enc)
        enc["task_in_job"] = d.task_in_job
        self.enc, self.d = enc, d
        # the class order of the round's select, once a solve (K3), and the
        # task columns of its commit and of the rollback (K7c)
        self.corder = RK.class_order(d.task_cls, enc["cls_excl"])
        self.tcols = dict(task_req=enc["task_req"], task_job=d.task_job,
                          task_queue=d.task_queue, task_ns=d.task_ns,
                          task_excl=d.task_excl,
                          job_task_start=enc["job_task_start"],
                          job_task_count=enc["job_task_count"])
        # what the tail kernel reads beside the encode
        self.tenc = dict(enc, task_queue=d.task_queue, task_ns=d.task_ns,
                         task_in_job=d.task_in_job, task_excl=d.task_excl,
                         score_weights=RK.score_weights(enc))
        st = self.st
        for name, src in (("idle", "node_idle"), ("used", "node_used"),
                          ("cnt", "node_cnt"), ("job_alloc", "job_alloc0"),
                          ("queue_alloc", "queue_alloc0"),
                          ("ns_alloc", "ns_alloc0")):
            st[name].copy_(enc[src])
        if spec.use_exclusion:
            st["excl_occ"].copy_(enc["excl_occ0"])
        st["assign"].fill_(-1)
        st["active"].copy_(d.task_valid)
        for name in ("job_placed", "scores", "touched", "tail_failed"):
            st[name].zero_()
        st["dirty"].fill_(True)
        self.ctl.zero_()
        self.ctl[RK.C_REMAINING] = d.task_valid.sum()
        self.hits.zero_()
        self.control()

    def step(self) -> None:
        self._gate(RK.P_ROUND, "round", self._round)
        self._gate(RK.P_ROLLBACK, "rollback", self._rollback)
        self._gate(RK.P_TAIL, "tail", self._tail)
        self.control()

    def run(self) -> None:
        """The whole solve, driven from the host (cpu, host)."""
        self.head()
        while not self.done():
            self.step()

    def finish(self):
        """(raw, packed) of the state: the gang strip, the capped exit's
        residue marking and the pack (the reference's epilogue)."""
        spec, enc, d, st, ctl = self.spec, self.enc, self.d, self.st, self.ctl
        # structural gang-atomicity net (a no-op on a normal exit)
        short = (enc["job_ready_base"] + st["job_placed"]) \
            < enc["job_ready_threshold"]
        assign = torch.where(short[d.task_job_l],
                             torch.full_like(st["assign"], -1), st["assign"])
        # capped exit: still-wanting tasks go to the serial residue retry
        strip_retry = short & (st["job_placed"] > 0)
        want_retry = st["active"] | (strip_retry[d.task_job_l] & d.task_valid)
        if spec.round_min_progress > 1:
            want_retry = want_retry | (st["tail_failed"] & d.task_valid)
        capped = ctl[RK.C_CAPPED] != 0
        assign = torch.where(capped & want_retry & (assign < 0),
                             torch.full_like(assign, -2), assign)
        touched = st["touched"] | capped
        raw = (assign, ctl[RK.C_ROUNDS].clone(), ctl[RK.C_TAIL_PLACED].clone(),
               ctl[RK.C_FULL_SWEEPS].clone(), capped,
               ctl[RK.C_HIST:].clone(), touched)
        return raw, pack_result(enc, raw)

    # -- the step bodies ----------------------------------------------------

    def _round(self) -> None:
        """One bulk-synchronous round (the reference's round_body): state
        updated in place, counters into ctl[C_PLACED .. C_DID_FULL]."""
        spec, enc, d, st = self.spec, self.enc, self.d, self.st
        t_cap = d.t + 1  # capacity clamp: ranks never reach it
        cons = self.pred[RK.P_CONS]
        job_rank, job_order = _job_rank(spec, enc, st["job_placed"], st["job_alloc"])
        task_rank = job_rank[d.task_job_l] * d.t + d.task_in_job  # int32, as ref
        active = st["active"]
        if spec.use_prop_overused:
            over = ~_le_eps(st["queue_alloc"], enc["queue_deserved"],
                            enc["eps"], enc["is_scalar"])
            active = active & ~over[d.task_queue_l]
        idle, used, cnt = st["idle"], st["used"], st["cnt"]
        occ = st.get("excl_occ")
        scores = st["scores"]

        # carried scores: patch the dirty columns, or rebuild past the
        # budget (every class row, live or not: a class revived by a
        # rollback must find current scores)
        def full():
            score_block(spec, enc, idle, used, cnt, occ, scores)

        if spec.dirty_k > 0:
            self._gate(RK.P_FULL, "full", full)
            self._gate(RK.P_DIRTY, "dirty", lambda: _rescore_dirty(
                spec, enc, idle, used, cnt, occ, scores, st["dirty"],
                self.ctl[RK.C_NDIRTY]))
        else:
            full()
        n_feas = torch.sum(scores > float("-inf"), dim=-1).to(torch.int32)

        cls_frac = None
        if spec.use_binpack:
            cls_demand = torch.zeros(d.k, dtype=torch.int32, device=d.dev) \
                .index_add_(0, d.task_cls_l, active.to(torch.int32))
            cls_frac = cls_demand.to(d.dt) / torch.clamp(
                torch.sum(cls_demand), min=1).to(d.dt)
        excl_cls = enc["cls_excl"] if spec.use_exclusion else None

        if spec.window_k > 0:
            k_eff = spec.window_k
            top_s, top_i = window_topk(scores, k_eff)
            nom_w = _cap_walk(spec, enc, top_i, top_s, enc["cls_req"], excl_cls,
                              enc["cls_has_pod"], cls_frac, idle, cnt, t_cap)
            # the select, and the coverage bit: is the windowed answer
            # provably full-width?
            choice_w, cons_choice, _, _, uncovered = round_select(
                spec, self.corder, active, n_feas, top_i, nom_w, coverage=True)
            # stall rounds take cons_choice (exact by construction), so only
            # a real windowed round falls back to the full width
            run_full = torch.any(uncovered) & ~cons
            self.choice_full.fill_(-1)

            def cover():
                nom_f = _nominate_full(spec, enc, scores, idle, cnt, cls_frac,
                                       t_cap)
                self.choice_full.copy_(round_select(
                    spec, self.corder, active, n_feas, nom_f[0], nom_f[1:])[0])

            self._gate(run_full, "cover", cover)
            choice = torch.where(uncovered[d.task_cls_l], self.choice_full,
                                 choice_w)
            # a windowed round read its nominated columns; a fallback all
            touched = st["touched"].index_put(
                (top_i.reshape(-1).long(),),
                torch.ones((), dtype=torch.bool, device=d.dev)) | run_full
            did_full = run_full.to(torch.int64)
        else:
            nom_f = _nominate_full(spec, enc, scores, idle, cnt, cls_frac, t_cap)
            choice, cons_choice, _, _, _ = round_select(
                spec, self.corder, active, n_feas, nom_f[0], nom_f[1:])
            did_full = torch.ones((), dtype=torch.int64, device=d.dev)
            touched = torch.ones_like(st["touched"])
        choice = torch.where(cons, cons_choice, choice)
        task_excl = d.task_excl
        if spec.use_exclusion:
            # within-round mutual exclusion: one winner per (group, node),
            # the best-ranked task, by a scatter-min of the (unique) rank
            isx = (task_excl >= 0) & (choice >= 0)
            flat = (torch.clamp(task_excl, min=0).long() * d.n
                    + torch.clamp(choice, 0, d.n - 1).long())
            big = torch.full_like(task_rank, 2**30)
            n_groups = enc["excl_occ0"].shape[0]
            winner = torch.full((n_groups * d.n,), 2**30, dtype=torch.int32,
                                device=d.dev).scatter_reduce(
                0, flat, torch.where(isx, task_rank, big), "amin")
            keepm = ~isx | (task_rank == winner[flat])
            choice = torch.where(keepm, choice, torch.full_like(choice, -1))
        accept = _resolve(spec, enc, idle, cnt, choice, task_rank, job_order)
        if spec.use_prop_overused:
            accept = _queue_budget(enc, st["queue_alloc"], accept, task_rank,
                                   d.task_queue, d.task_job, job_order)

        # the commit (K7c): state updated in place, the counters into
        # ctl[C_PLACED .. C_DID_FULL]
        round_commit(spec, self.tcols, st, choice, accept, did_full, self.ctl)
        st["touched"].copy_(touched)

    def _rollback(self) -> None:
        """Retire the WORST-ranked gang still short of min_available
        (Statement.Discard semantics), one job per fixpoint iteration:
        state updated in place, counters into ctl[C_STILL .. C_ANY_CAND]."""
        spec, enc, d, st = self.spec, self.enc, self.d, self.st
        short = (enc["job_ready_base"] + st["job_placed"]) \
            < enc["job_ready_threshold"]
        cand = short & (st["job_placed"] > 0)
        job_rank = _job_rank(spec, enc, st["job_placed"], st["job_alloc"])[0]
        worst = torch.argmax(torch.where(cand, job_rank,
                                         torch.full_like(job_rank, -1)))
        roll_job = cand & (torch.arange(d.j, device=d.dev) == worst)
        # its placed tasks given back (K7c's rollback mode): state updated in
        # place, the counters into ctl[C_STILL .. C_ANY_CAND]
        round_rollback(spec, self.tcols, st, roll_job,
                       cand.any().to(torch.int64), self.ctl)

    def _tail(self) -> None:
        """The sequential tail pass (K7b; the plain version on the host
        paths)."""
        tail = RK.tail_pass_plain if self.mode in ("cpu", "host") else RK.tail_pass
        tail(self.spec, self.tenc, self.st, self.ctl)


def _loop(loop, enc) -> str:
    if not devmod.on_cuda(enc["cls_req"], enc["node_idle"]):
        if loop not in (None, "host"):
            raise ValueError(f"loop={loop!r} needs CUDA tensors")
        return "cpu"
    if loop not in (None, "graph", "host"):
        raise ValueError(f"unknown rounds loop {loop!r} (graph, host)")
    return loop or "graph"


def solve(spec: SolveSpec, enc: dict, loop: str = None, raw: bool = True):
    """One rounds solve: (raw result tuple, packed result).

    On CUDA tensors the solve is one replay of the bucket's CUDA graph
    (ops/rounds_graph.py): nothing is read back; the packed result
    carries the graph's status for the one fetch (utils/devprof.py), and
    the raw tuple is None there unless ``raw``.
    ``loop="host"`` runs the same step machine driven from the host
    instead, the plain side of K7's comparison. On CPU tensors the machine runs from the host with every
    plain version."""
    mode = _loop(loop, enc)
    if mode == "graph":
        from volcano_tpu_torch.ops import rounds_graph

        return rounds_graph.solve(spec, enc, raw)
    m = StepMachine(spec, enc, mode)
    m.run()
    return m.finish()


def solve_rounds(spec: SolveSpec, enc: dict, loop: str = None):
    """Batched allocate session. Returns (assign [T] int32 node or -1/-2,
    rounds used, tail_placed, full-sweep rounds, capped flag,
    placed-per-round histogram [PROF_SLOTS], touched-node mask [N] bool),
    every entry a tensor on the encode's device.

    ``enc`` holds the padded encoded arrays as tensors on one device
    (ops/solver.from_numpy_encoded). Per-task request/has-pod columns are
    derived from the class arrays (task_req = cls_req[task_cls])."""
    return solve(spec, enc, loop)[0]


def solve_rounds_packed(spec: SolveSpec, enc: dict, loop: str = None):
    """The packed single-fetch result of one solve (pack_result)."""
    return solve(spec, enc, loop, raw=False)[1]


def bind_packed(spec: SolveSpec, enc: dict):
    """The host work of a solve that can come before its dispatch: on CUDA
    tensors whose bucket's graph exists, the encode's copy list into it
    (rounds_graph.bind); else None (the dispatch then does it, and
    captures the bucket's graph on its first solve)."""
    if _loop(None, enc) != "graph":
        return None
    from volcano_tpu_torch.ops import rounds_graph

    return rounds_graph.bind(spec, enc)


def dispatch_packed(spec: SolveSpec, enc: dict, bound=None):
    """Launch one solve for the scheduler's single fetch of its packed
    result (utils/devprof.py fetch or start_fetch): on CUDA tensors the
    graph's handle of the result's started copy to the host
    (rounds_graph.Fetch), with no copy of the result kept on the device;
    elsewhere the packed tensor. ``bound`` is ``bind_packed``'s result for
    this encode, when the caller made it ahead."""
    from volcano_tpu_torch.ops import rounds_graph

    if bound is not None:
        return rounds_graph.dispatch(spec, enc, bound)
    if _loop(None, enc) != "graph":
        return solve_rounds_packed(spec, enc)
    return rounds_graph.dispatch(spec, enc)
