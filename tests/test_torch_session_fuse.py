"""The fused session chain (volcano_tpu_torch/ops/session_fuse.py): the
port against the JAX package's fused chain, stage by stage and whole, and
against the port's own per-action path.

Twin clusters are built from one seed with each package's own objects
(the overcommit and reclaim builders of tests/test_torch_evict.py, and
cfg4 from each package's bench/clusters.py). Every session forces
``tpuscore.mode: rounds`` (these clusters sit under the auto threshold,
where allocate runs serially and nothing fuses), and every fused case
asserts ``fuse == 1`` with the expected stages on each side, so no case
passes by running per-action on both. The port runs on the CPU in float64
(each kernel wrapper takes its plain version), the JAX package in float64
under jit (the test conftest). Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from tests.test_torch_evict import (
    PKGS,
    TIER_SETS,
    jclusters,
    overcommit_cluster,
    reclaim_cluster,
)
from tests.test_torch_evict_session import ACTIONS, CPU64, session_signature
from volcano_tpu.ops import evict as jevict
from volcano_tpu.ops import session_fuse as jfuse
from volcano_tpu.scheduler import metrics as jmetrics

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.ops import evict as tevict
from volcano_tpu_torch.ops import evict_kernels as tk
from volcano_tpu_torch.ops import session_fuse as tfuse
from volcano_tpu_torch.ops import victimview as tvictimview
from volcano_tpu_torch.ops.solver import from_numpy_encoded
from volcano_tpu_torch.scheduler import framework as tframework
from volcano_tpu_torch.scheduler import metrics as tmetrics
from volcano_tpu_torch.scheduler.util.test_utils import (
    build_node,
    build_resource_list_with_pods,
)
from volcano_tpu_torch.utils import devprof

ROUNDS = {"tpuscore.mode": "rounds"}
CLUSTERS = {"overcommit": overcommit_cluster, "reclaim": reclaim_cluster}
STAGES = ["allocate", "backfill", "preempt", "reclaim"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _args(pkg):
    return dict(CPU64 if pkg == "torch" else {}, **ROUNDS)


def run(pkg, build, tiers, monkeypatch, fuse=True, sessions=1,
        actions=ACTIONS, setup=None):
    """``sessions`` sessions of ``actions`` through ``run_actions`` on one
    cache built by ``build(clusters)``; returns (last signature with the
    preemption metrics, binds, evictions in effector order, profiles)."""
    clusters, framework = PKGS[pkg]
    metrics = jmetrics if pkg == "jax" else tmetrics
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
    monkeypatch.setenv("VOLCANO_TPU_FUSE", "1" if fuse else "0")
    reg = metrics.registry()
    m0 = (reg.preemption_victims.get(), reg.preemption_attempts.get())
    cache = build(clusters)
    profs = []
    for _ in range(sessions):
        ssn = framework.open_session(cache, clusters.make_tiers(
            ["tpuscore"], *tiers, arguments={"tpuscore": _args(pkg)}))
        try:
            if setup is not None:
                setup(ssn)
            framework.run_actions(ssn, list(actions))
            sig = session_signature(ssn)
            profs.append(dict(ssn.plugins["tpuscore"].profile))
        finally:
            framework.close_session(ssn)
    sig["metrics"] = (reg.preemption_victims.get() - m0[0],
                      reg.preemption_attempts.get() - m0[1])
    return sig, dict(cache.binder.binds), list(cache.evictor.evicts), profs


def assert_same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]          # binds
    assert got[2] == want[2]          # evictions, in effector order


def assert_fused(prof, stages=STAGES):
    assert prof.get("fuse") == 1, prof.get("fuse_fallback", prof)
    assert prof.get("fuse_stages") == stages
    assert "fuse_fallback" not in prof, prof["fuse_fallback"]


def _count_discards(monkeypatch):
    """Count the plain machine's discards that rewind a pipeline (and so
    clear its consumed-candidate mark)."""
    seen = {"pipelines": 0}
    real = tk._Plain.discard

    def discard(self, stmt_start):
        kinds = self.log[stmt_start:self.log_len, 0].tolist()
        seen["pipelines"] += kinds.count(tevict.OP_PIPELINE)
        real(self, stmt_start)

    monkeypatch.setattr(tk._Plain, "discard", discard)
    return seen


# ---------------------------------------------------------------------------
# whole sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 42])
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_fused_session_matches_reference(tiers, cluster, seed, monkeypatch):
    """Port fused == JAX fused: signature, binds, evictions in order,
    preemption metrics; both sides ran the four-stage chain."""
    def build(c):
        return CLUSTERS[cluster](c, seed)

    want = run("jax", build, tiers, monkeypatch)
    got = run("torch", build, tiers, monkeypatch)
    assert_same(got, want)
    assert_fused(want[3][0])
    assert_fused(got[3][0])


@pytest.mark.parametrize("seed", [11, 42, 10, 17])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_fused_session_matches_per_action(tiers, seed, monkeypatch):
    """Port fused == port per-action (VOLCANO_TPU_FUSE=0). With seeds 10
    and 17 the overcommit clusters' gangs make the fused preempt discard
    statements that had pipelined tasks, so the carried skip mask must
    drop those marks for reclaim to see the tasks as pending."""
    monkeypatch.setattr(tvictimview.VictimSelector, "MIN_BATCH", 1)
    discards = _count_discards(monkeypatch)

    def build(c):
        return overcommit_cluster(c, seed)

    got = run("torch", build, tiers, monkeypatch)
    if seed in (10, 17):
        assert discards["pipelines"] > 0
    want = run("torch", build, tiers, monkeypatch, fuse=False)
    assert_same(got, want)
    assert_fused(got[3][0])
    assert "fuse" not in want[3][0]


def test_cfg4_fused_session_matches_reference(monkeypatch):
    """cfg4 at scale 0.02: both packages fuse the whole chain and give the
    same session, which is also the port's per-action session."""
    def build(c):
        cache = c.make_cache()
        c.CONFIGS[4].populate(cache, 0.02)
        return cache

    tiers = jclusters.CONFIGS[4].tiers
    want = run("jax", build, tiers, monkeypatch)
    got = run("torch", build, tiers, monkeypatch)
    per_action = run("torch", build, tiers, monkeypatch, fuse=False)
    assert_same(got, want)
    assert_same(got, per_action)
    assert_fused(want[3][0])
    assert_fused(got[3][0])
    assert got[2] and got[3][0]["evict_preempt"]["ops"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(300, 308)))
def test_fused_session_matches_per_action_wide(seed, monkeypatch):
    """Wider fuzz band: fresh cluster shapes across all tier sets."""
    rng = random.Random(seed * 13)
    kw = dict(nodes=rng.choice([4, 7, 9]),
              running_jobs=rng.choice([8, 14, 18]),
              tasks_per_job=rng.choice([3, 4, 5]),
              queues=rng.choice([2, 3]),
              hi_jobs=rng.choice([3, 5]))
    tiers = TIER_SETS[seed % len(TIER_SETS)]
    monkeypatch.setattr(tvictimview.VictimSelector, "MIN_BATCH", 1)

    def build(c):
        return overcommit_cluster(c, seed, **kw)

    got = run("torch", build, tiers, monkeypatch)
    want = run("torch", build, tiers, monkeypatch, fuse=False)
    assert_same(got, want)
    assert_fused(got[3][0])


# ---------------------------------------------------------------------------
# stage by stage against the jitted JAX stage functions
# ---------------------------------------------------------------------------


def _np(x):
    return np.array(x, copy=True)


def _jax_stages(build, tiers):
    """The reference's four stage functions on one encoded session,
    staged as its _run_fused stages them; returns the encodes and every
    stage's outputs as numpy arrays."""
    cache = build(jclusters)
    framework = PKGS["jax"][1]
    ssn = framework.open_session(cache, jclusters.make_tiers(
        ["tpuscore"], *tiers, arguments={"tpuscore": _args("jax")}))
    try:
        prep = ssn.batch_allocator._prepare(ssn)
        assert prep is not None and prep["mode"] == "rounds"
        plan = jevict._EvictPlan(ssn, "preempt", fused=True)
        bf = jevict._BackfillPlan(ssn, view=plan.view)
        maps, bmaps = jfuse._build_maps(prep, plan, bf)
        prof = {}
        ml, mb = jevict._pack(maps, "fuse_maps")
        ms = jevict._stage(mb, prof)
        el, es = jevict._pack_staged(plan.arrays, "fuse_ev", None, prof)
        fs = plan.fuse_sizes
        packed_a, carry = jfuse._fuse_alloc(
            prep["spec"], prep["layout"], prep["staged"], ml, ms,
            (fs["n"], fs["jb"], fs["qb"], fs["tb"]))
        out = {"packed_a": _np(packed_a),
               "carry_a": {k: _np(v) for k, v in carry.items()},
               "bf_trivial": bf.trivial}
        if not bf.trivial:
            bl, bs = jevict._pack_staged(bf.arrays, "fuse_bf", None, prof)
            bml, bmb = jevict._pack(bmaps, "fuse_bmaps")
            assign, carry = jfuse._fuse_backfill(
                bf.spec, bl, bs, bml, jevict._stage(bmb, prof), carry)
            out["assign_bf"] = _np(assign)
            out["carry_b"] = {k: _np(v) for k, v in carry.items()}
            out.update(bmaps=bmaps, bf_arrays=bf.arrays)
        packed_p, carry = jfuse._fuse_preempt(
            plan.spec, el, es, carry,
            (fs["qp"], fs["jcap"], fs["ju"], plan.log_rows))
        out["packed_p"] = _np(packed_p)
        out["carry_p"] = {k: _np(v) for k, v in carry.items()}
        out["packed_r"] = _np(jfuse._fuse_reclaim(
            plan.reclaim_spec, el, es, carry,
            (fs["qb"], fs["jcap"], fs["qh"], plan.log_rows),
            "gang" in ssn.job_valid_fns))
        out.update(maps=maps, arrays=plan.arrays, sizes=fs,
                   spec=tuple(plan.spec),
                   reclaim_spec=tuple(plan.reclaim_spec))
        return out
    finally:
        framework.close_session(ssn)


def _port_session(build, tiers):
    cache = build(tclusters)
    return tframework.open_session(cache, tclusters.make_tiers(
        ["tpuscore"], *tiers, arguments={"tpuscore": _args("torch")}))


def _port_encode(ssn):
    """The port's fused encodes of an open session, staged on the CPU."""
    prep = ssn.batch_allocator._prepare(ssn)
    assert prep is not None
    plan = tevict._EvictPlan(ssn, "preempt", fused=True)
    bf = tevict._BackfillPlan(ssn, view=plan.view)
    maps, bmaps = tfuse._build_maps(prep, plan, bf)

    def stage(a):
        return None if a is None else from_numpy_encoded(
            a, device="cpu", dtype="float64")

    return prep, plan, bf, maps, bmaps, stage(maps), stage(plan.arrays), \
        stage(None if bf.trivial else bf.arrays), stage(bmaps)


def _equal(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want), what


def _equal_dict(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        _equal(got[k], want[k], f"{what}[{k}]")


def _arrays_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), f"{what}[{k}]"


@pytest.mark.parametrize("cluster,seed", [("overcommit", 11), ("overcommit", 7),
                                          ("reclaim", 42)])
@pytest.mark.parametrize("tiers", TIER_SETS[:2], ids=["cfg4", "prop"])
def test_stages_match_reference(tiers, cluster, seed):
    """Each stage's output and carry equal the jitted JAX stage's on the
    same encoded arrays: _fuse_alloc's packed result and carry,
    _fuse_backfill's assign and carry, _fuse_preempt's packed result and
    carry (skip is the machine's final p_done), _fuse_reclaim's packed
    result."""
    def build(c):
        return CLUSTERS[cluster](c, seed)

    want = _jax_stages(build, tiers)
    ssn = _port_session(build, tiers)
    try:
        prep, plan, bf, maps, bmaps, ms, es, bs, bms = _port_encode(ssn)
        _arrays_equal(maps, want["maps"], "maps")
        _arrays_equal(plan.arrays, want["arrays"], "fused encode")
        assert bf.trivial == want["bf_trivial"]
        assert plan.fuse_sizes == want["sizes"]
        assert tuple(plan.spec) == want["spec"]
        assert tuple(plan.reclaim_spec) == want["reclaim_spec"]
        fs = plan.fuse_sizes
        packed_a, carry = tfuse._fuse_alloc(
            prep["spec"], prep["staged"], ms,
            (fs["n"], fs["jb"], fs["qb"], fs["tb"]))
        _equal(packed_a, want["packed_a"], "allocate packed")
        _equal_dict(carry, want["carry_a"], "allocate carry")
        if not bf.trivial:
            _arrays_equal(bmaps, want["bmaps"], "bmaps")
            _arrays_equal(bf.arrays, want["bf_arrays"], "backfill encode")
            assign, carry = tfuse._fuse_backfill(bf.spec, bs, bms, carry)
            _equal(assign, want["assign_bf"], "backfill assign")
            _equal_dict(carry, want["carry_b"], "backfill carry")
        packed_p, carry = tfuse._fuse_preempt(plan.spec, es, carry,
                                              (fs["qp"], fs["jcap"]))
        _equal(packed_p, want["packed_p"], "preempt packed")
        _equal_dict(carry, want["carry_p"], "preempt carry")
        packed_r = tfuse._fuse_reclaim(
            plan.reclaim_spec, es, carry, (fs["qb"], fs["jcap"], fs["qh"]),
            "gang" in ssn.job_valid_fns)
        _equal(packed_r, want["packed_r"], "reclaim packed")
    finally:
        tframework.close_session(ssn)
    # the stages did work: backfill placed (the overcommit clusters carry
    # best-effort pods), and preempt or reclaim logged ops
    if cluster == "overcommit":
        assert (want["assign_bf"] >= 0).any()
    lr = want["packed_p"].shape[0] - tevict.TAIL
    assert want["packed_p"][lr] > 0 or want["packed_r"][lr] > 0


# ---------------------------------------------------------------------------
# K13 against the heaps the per-action encode builds with PriorityQueue
# ---------------------------------------------------------------------------


def _rows(heap, hsize):
    return [row[:n] for row, n in zip(heap.tolist(), hsize.tolist())]


@pytest.mark.parametrize("cluster,seed", [("overcommit", 11), ("overcommit", 42),
                                          ("reclaim", 7)])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_fuse_heaps_match_per_action_encode(tiers, cluster, seed):
    """fuse_heaps_plain on the carried post-allocate (post-preempt) state
    == the heap0/hsize0 (qheap0/qhsize0) and under_jobs the per-action
    _EvictPlan builds with the real PriorityQueue at that state."""
    def build(c):
        return CLUSTERS[cluster](c, seed)

    ssn = _port_session(build, tiers)
    try:
        prep, plan, bf, maps, bmaps, ms, es, bs, bms = _port_encode(ssn)
        fs = plan.fuse_sizes
        _, carry = tfuse._fuse_alloc(prep["spec"], prep["staged"], ms,
                                     (fs["n"], fs["jb"], fs["qb"], fs["tb"]))
        if not bf.trivial:
            _, carry = tfuse._fuse_backfill(bf.spec, bs, bms, carry)
        # the preempt stage's own inputs to K13
        p_next = tk.live_next(~carry["skip"])
        zero = torch.zeros((), dtype=torch.float64)
        st_p = dict(
            live_job=tk.live_job_mask(es, p_next),
            ready=es["job_ready0"] + carry["ready_add"],
            job_alloc=es["job_alloc0"] + torch.where(
                es["f_job_attr"][:, None], carry["alloc_add"], zero))
        heaps_p = tk.fuse_heaps_plain("preempt", plan.spec, es, st_p,
                                      fs["qp"], fs["jcap"])
        _, carry2 = tfuse._fuse_preempt(plan.spec, es, carry,
                                        (fs["qp"], fs["jcap"]))
        p_next2 = tk.live_next(~carry2["skip"])
        st_r = dict(live_job=tk.live_job_mask(es, p_next2),
                    ready=carry2["ready"], job_alloc=carry2["job_alloc"],
                    queue_alloc=carry2["queue_alloc"], alive=carry2["alive"])
        heaps_r = tk.fuse_heaps_plain(
            "reclaim", plan.reclaim_spec, es, st_r, fs["qb"], fs["jcap"],
            fs["qh"], "gang" in ssn.job_valid_fns)
    finally:
        tframework.close_session(ssn)

    # the per-action encodes at the same states
    ssn = _port_session(build, tiers)
    try:
        for name in ("allocate", "backfill"):
            tframework.get_action(name).execute(ssn)
        pre = tevict._EvictPlan(ssn, "preempt")
        tframework.get_action("preempt").execute(ssn)
        rec = tevict._EvictPlan(ssn, "reclaim")
        prof = dict(ssn.plugins["tpuscore"].profile)
    finally:
        tframework.close_session(ssn)
    assert "evict_preempt_fallback" not in prof
    if not pre.trivial:
        a = pre.arrays
        assert _rows(heaps_p["heap"], heaps_p["hsize"]) == _rows(
            torch.from_numpy(a["heap0"]), torch.from_numpy(a["hsize0"]))
        assert [j for j in heaps_p["under_jobs"].tolist() if j >= 0] == [
            j for j in a["under_jobs"].tolist() if j >= 0]
    else:
        assert int(heaps_p["hsize"].sum()) == 0
    if not rec.trivial:
        a = rec.arrays
        assert _rows(heaps_r["heap"], heaps_r["hsize"]) == _rows(
            torch.from_numpy(a["heap0"]), torch.from_numpy(a["hsize0"]))
        n = int(a["qhsize0"])
        assert int(heaps_r["qhsize"]) == n
        assert heaps_r["qheap"].tolist()[:n] == a["qheap0"].tolist()[:n]
    else:
        assert int(heaps_r["hsize"].sum()) == 0


def test_fused_wrappers_run_plain_versions_on_cpu_tensors():
    """On CPU tensors K13 and the fused K9/K10 wrappers are their plain
    versions and count no launch."""
    def build(c):
        return overcommit_cluster(c, 42)

    ssn = _port_session(build, TIER_SETS[0])
    try:
        prep, plan, bf, maps, bmaps, ms, es, bs, bms = _port_encode(ssn)
        fs = plan.fuse_sizes
        _, carry = tfuse._fuse_alloc(prep["spec"], prep["staged"], ms,
                                     (fs["n"], fs["jb"], fs["qb"], fs["tb"]))
        devmod.reset_launches()
        packed, carry2 = tfuse._fuse_preempt(plan.spec, es, carry,
                                             (fs["qp"], fs["jcap"]))
        tfuse._fuse_reclaim(plan.reclaim_spec, es, carry2,
                            (fs["qb"], fs["jcap"], fs["qh"]), True)
        assert devmod.launches() == {k: 0 for k in devmod.LAUNCHES}
        assert sorted(carry2) == ["alive", "cnt", "job_alloc", "queue_alloc",
                                  "ready", "skip", "used", "wait"]
    finally:
        tframework.close_session(ssn)


def test_live_next_and_live_job_mask():
    live = torch.tensor([False, True, False, False, True, False])
    assert tk.live_next(live).tolist() == [1, 1, 4, 4, 4, 6]
    enc = {"job_task_start": torch.tensor([0, 2, 5, 0], dtype=torch.int32),
           "job_task_end": torch.tensor([2, 5, 6, 0], dtype=torch.int32)}
    assert tk.live_job_mask(enc, tk.live_next(live)).tolist() == [
        True, True, False, False]


# ---------------------------------------------------------------------------
# twins of tests/test_session_fuse.py
# ---------------------------------------------------------------------------


def test_chain_grammar():
    """Only order-respecting chains containing allocate+preempt fuse."""
    split = tfuse._split_chain
    assert split(("allocate", "backfill", "preempt", "reclaim")) \
        == ([], ["allocate", "backfill", "preempt", "reclaim"])
    assert split(("enqueue", "allocate", "preempt")) \
        == (["enqueue"], ["allocate", "preempt"])
    assert split(("allocate",)) is None
    assert split(("allocate", "backfill")) is None
    assert split(("allocate", "preempt", "backfill")) is None
    assert split(("preempt", "reclaim")) is None
    assert split(("allocate", "reclaim", "preempt")) is None
    for names in (("allocate", "backfill", "preempt", "reclaim"),
                  ("allocate", "preempt"), ("allocate", "reclaim", "preempt"),
                  ("allocate",)):
        assert split(names) == jfuse._split_chain(names)


def test_env_flag_restores_per_action_path(monkeypatch):
    """VOLCANO_TPU_FUSE=0 routes through the per-action loop: no fuse
    profile keys at all, batched evict still engaged."""
    got = run("torch", lambda c: overcommit_cluster(c, 11), TIER_SETS[0],
              monkeypatch, fuse=False)
    prof = got[3][0]
    assert "fuse" not in prof and "fuse_fallback" not in prof
    assert "evict_preempt" in prof


def test_scalar_resources_fall_back_per_action(monkeypatch):
    """Scalar dims leave the evict envelope: the chain records a
    fuse_fallback and gives the per-action path's result."""
    def build(c):
        cache = overcommit_cluster(c, 11)
        rl = build_resource_list_with_pods("8", "16Gi", pods=64)
        rl["nvidia.com/gpu"] = "4"
        cache.add_node(build_node("node-gpu", rl))
        return cache

    got = run("torch", build, TIER_SETS[0], monkeypatch)
    want = run("torch", build, TIER_SETS[0], monkeypatch, fuse=False)
    assert_same(got, want)
    prof = got[3][0]
    assert "fuse" not in prof
    assert "scalar" in prof["fuse_fallback"], prof


def test_fallback_applies_nothing_twice(monkeypatch):
    """An out-of-envelope plugin set (a custom preemptable fn: the fused
    encode is unsupported) falls back before anything is applied; the
    per-action rerun gives the oracle's result, nothing applied twice."""
    def setup(ssn):
        ssn.add_preemptable_fn("priority", lambda c, cs: cs)

    build = lambda c: overcommit_cluster(c, 11)  # noqa: E731
    got = run("torch", build, TIER_SETS[0], monkeypatch, setup=setup)
    want = run("torch", build, TIER_SETS[0], monkeypatch, fuse=False,
               setup=setup)
    assert "fuse_fallback" in got[3][0] and "fuse" not in got[3][0]
    assert_same(got, want)


def test_consecutive_sessions_parity_with_honest_fallback(monkeypatch):
    """Two sessions on one cache: the first one's evictions leave
    releasing capacity, outside the fuse envelope, so the second falls
    back per-action with a recorded reason; the end state equals the
    per-action path's and the JAX package's."""
    build = lambda c: overcommit_cluster(c, 21)  # noqa: E731
    got = run("torch", build, TIER_SETS[0], monkeypatch, sessions=2)
    want = run("torch", build, TIER_SETS[0], monkeypatch, fuse=False,
               sessions=2)
    ref = run("jax", build, TIER_SETS[0], monkeypatch, sessions=2)
    assert_same(got, want)
    assert_same(got, ref)
    assert_fused(got[3][0])
    assert "releasing" in got[3][1].get("fuse_fallback", ""), got[3][1]
    assert ref[3][1].get("fuse_fallback") == got[3][1]["fuse_fallback"]


def test_devprof_counters_land_in_profile(monkeypatch):
    """The session counters (sync points, fetches, overlap) collect around
    a fused session: one fetch per fused stage at least."""
    monkeypatch.setenv("VOLCANO_TPU_EVICT", "1")
    monkeypatch.setenv("VOLCANO_TPU_FUSE", "1")
    ssn = _port_session(lambda c: overcommit_cluster(c, 11), TIER_SETS[0])
    prof = {}
    try:
        with devprof.session(prof):
            tframework.run_actions(ssn, ACTIONS)
        assert_fused(ssn.plugins["tpuscore"].profile)
    finally:
        tframework.close_session(ssn)
    assert prof["tpu_d2h_fetches"] >= 4
    assert prof["tpu_sync_points"] >= prof["tpu_d2h_fetches"]
    assert prof["tpu_overlap_ms"] >= 0.0


def test_start_fetch_on_cpu_tensors():
    prof = {}
    with devprof.session(prof):
        wait = devprof.start_fetch(torch.arange(4, dtype=torch.int32))
        out = wait()
    assert out.tolist() == [0, 1, 2, 3] and out.dtype == np.int32
    assert prof["tpu_d2h_fetches"] == 1 and prof["tpu_sync_points"] == 1
    assert prof["tpu_overlap_ms"] >= 0.0 and prof["tpu_fence_wait_ms"] >= 0.0


def test_budget_trip_inside_the_chain(monkeypatch):
    """The fused preempt log cut to 8 rows: K9's stage fails, consume
    records the budget fallback and applies nothing, and the per-action
    rerun owns preempt and reclaim (its own preempt trips the same cut and
    runs the serial walk). Nothing is applied twice: the result is the
    uncut fused session's."""
    real = tevict._EvictPlan.__init__

    def init(self, ssn, kind, fused=False, view=None):
        real(self, ssn, kind, fused, view)
        if kind == "preempt" and not self.trivial:
            self.log_rows = 8
            self.arrays["log0"] = np.zeros((8, 3), np.int32)

    build = lambda c: overcommit_cluster(c, 42)  # noqa: E731
    want = run("torch", build, TIER_SETS[0], monkeypatch)
    fallbacks = tmetrics.registry().device_fallbacks
    before = fallbacks.get(("evict_preempt",))
    monkeypatch.setattr(tevict._EvictPlan, "__init__", init)
    got = run("torch", build, TIER_SETS[0], monkeypatch)
    prof = got[3][0]
    assert prof.get("fuse") == 1 and "fuse_fallback" not in prof
    assert prof["evict_preempt_fallback"] == "kernel step/log budget exhausted"
    assert fallbacks.get(("evict_preempt",)) == before + 2
    assert "evict_reclaim" in prof
    assert_same(got, want)
    assert got[2]
