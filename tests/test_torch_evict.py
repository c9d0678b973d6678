"""The eviction machines K9 preempt, K10 reclaim and K11 backfill: the
port's plain versions against the jitted JAX reference, bit for bit.

A cluster is built twice from one seed, once with each package's own
objects; each package's session runs the actions before the one under
test, and the JAX package's plan (volcano_tpu/ops/evict.py) encodes the
action. The same numpy arrays go through the jitted JAX
solve_preempt/solve_reclaim/solve_backfill (float64 under the test
conftest) and through the port's machines on the CPU (float64, where each
wrapper runs its plain version). Tolerance: exact equality of the packed
int32 result (op log and tail; backfill's assign). The port's own plan on
its own session must encode the same arrays.
"""

from __future__ import annotations

import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.ops import evict as jevict
from volcano_tpu.scheduler import framework as jframework
import volcano_tpu.scheduler.actions  # noqa: F401  (register actions)

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.ops import evict as tevict
from volcano_tpu_torch.ops import evict_kernels as tk
from volcano_tpu_torch.ops.solver import from_numpy_encoded
from volcano_tpu_torch.scheduler import framework as tframework
import volcano_tpu_torch.scheduler.actions  # noqa: F401  (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (register plugins)

# the conf shapes of tests/test_evict_kernel.py: cfg4's two-tier default
# (gang decides both victim kinds), a reclaim tier where gang and
# proportion decide, and one tier where gang, drf and conformance decide
TIER_SETS = [
    (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"]),
    (["priority"], ["gang", "proportion", "predicates", "nodeorder"]),
    (["gang", "drf", "conformance", "proportion", "predicates"],),
]
BEFORE = {"backfill": ("allocate",), "preempt": ("allocate", "backfill"),
          "reclaim": ("allocate", "backfill", "preempt")}
PKGS = {"jax": (jclusters, jframework), "torch": (tclusters, tframework)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mods(clusters):
    pkg = clusters.__name__.split(".")[0]
    return (importlib.import_module(pkg + ".api.objects"),
            importlib.import_module(pkg + ".scheduler.util.test_utils"))


def overcommit_cluster(clusters, seed: int, nodes: int = 6,
                       running_jobs: int = 12, tasks_per_job: int = 4,
                       queues: int = 2, hi_jobs: int = 4):
    """tests/test_evict_kernel.py _overcommit_cluster, built with the
    objects of ``clusters``' package: a dense running fill bound
    round-robin, pending high-priority gangs (preemptors), a starved queue
    (reclaimers), best-effort pods (backfill), PDB minAvailable overrides,
    conformance-protected victims, and mixed jobs whose heap keys mutate
    in-heap."""
    objects, tu = _mods(clusters)
    rng = random.Random(seed)
    c = clusters.make_cache()
    for q in range(queues):
        c.add_queue(tu.build_queue(f"q{q}", weight=1 + q))
    per_node = running_jobs * tasks_per_job // nodes + 1
    cpu = per_node + 2
    for n in range(nodes):
        c.add_node(tu.build_node(
            f"node-{n:03d}",
            tu.build_resource_list_with_pods(str(cpu), f"{cpu * 2}Gi", pods=64)))
    slot = 0
    for g in range(running_jobs):
        pg = f"run-{g:03d}"
        queue = f"q{g % queues}"
        min_member = rng.choice([1, 1, 2, tasks_per_job])
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=min_member, queue=queue))
        if rng.random() < 0.25:
            c.add_pdb(objects.PodDisruptionBudget(
                metadata=objects.ObjectMeta(name=pg, namespace="ev"),
                min_available=rng.choice([1, 2, tasks_per_job])))
        for i in range(tasks_per_job):
            pod = tu.build_pod(
                "ev", f"{pg}-t{i}", f"node-{slot % nodes:03d}",
                objects.POD_PHASE_RUNNING,
                {"cpu": "1000m", "memory": rng.choice(["1Gi", "2Gi"])},
                pg, priority=rng.choice([0, 1, 5]))
            if rng.random() < 0.1:
                pod.spec.priority_class_name = objects.SYSTEM_CLUSTER_CRITICAL
            c.add_pod(pod)
            slot += 1
    for g in range(hi_jobs):
        pg = f"hi-{g:02d}"
        mm = rng.choice([1, 1, 2])
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=mm, queue=f"q{g % queues}"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([3000, 4000])}m",
                 "memory": rng.choice(["4Gi", "8Gi"])},
                pg, priority=100))
    for g in range(3):
        pg = f"mx-{g:02d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=1, queue=f"q{g % queues}"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-r{i}", f"node-{(slot + i) % nodes:03d}",
                objects.POD_PHASE_RUNNING,
                {"cpu": "1000m", "memory": "1Gi"}, pg, priority=1))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-p{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "2000m", "memory": "2Gi"}, pg,
                priority=rng.choice([20, 100])))
    for g in range(2):
        pg = f"rc-{g:02d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=1, queue=f"q{queues - 1}"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "2000m", "memory": "2Gi"}, pg, priority=10))
    for g in range(2):
        pg = f"be-{g:02d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=1, queue="q0"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING, {},
                pg, priority=1))
    return c


def reclaim_cluster(clusters, seed: int, nodes: int = 6,
                    running_jobs: int = 12, tasks_per_job: int = 4,
                    reclaim_jobs: int = 6, pods: int = 64):
    """A cluster where reclaim evicts under every tier set: queue q0
    (weight 1) runs a fill that packs every node on both dimensions, and
    queue q1 (weight 3) asks for about half the cluster, so q0 stays above
    its deserved share while reclaimers evict from it."""
    objects, tu = _mods(clusters)
    rng = random.Random(seed)
    c = clusters.make_cache()
    c.add_queue(tu.build_queue("q0", weight=1))
    c.add_queue(tu.build_queue("q1", weight=3))
    cpu = running_jobs * tasks_per_job // nodes + 1
    for n in range(nodes):
        c.add_node(tu.build_node(
            f"node-{n:03d}",
            tu.build_resource_list_with_pods(str(cpu), f"{cpu * 2}Gi", pods=pods)))
    slot = 0
    for g in range(running_jobs):
        pg = f"run-{g:03d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=rng.choice([1, 1, 2]), queue="q0"))
        for i in range(tasks_per_job):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", f"node-{slot % nodes:03d}",
                objects.POD_PHASE_RUNNING, {"cpu": "1000m", "memory": "2Gi"},
                pg, priority=rng.choice([0, 1, 5])))
            slot += 1
    for g in range(reclaim_jobs):
        pg = f"rc-{g:02d}"
        c.add_pod_group(tu.build_pod_group(
            pg, namespace="ev", min_member=1, queue="q1"))
        for i in range(2):
            c.add_pod(tu.build_pod(
                "ev", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([1000, 2000])}m",
                 "memory": rng.choice(["2Gi", "4Gi"])}, pg, priority=10))
    return c


TPU_ARGS = {"jax": {}, "torch": {"tpuscore.device": "cpu",
                                 "tpuscore.dtype": "float64"}}


def plans(build, tiers, kind):
    """(JAX plan, port plan) of ``kind`` on twin sessions built by
    ``build(clusters)``, after the actions that precede it."""
    out = []
    for name, (clusters, framework) in PKGS.items():
        ev = jevict if name == "jax" else tevict
        cache = build(clusters)
        ssn = framework.open_session(cache, clusters.make_tiers(
            ["tpuscore"], *tiers, arguments={"tpuscore": TPU_ARGS[name]}))
        try:
            for action in BEFORE[kind]:
                framework.get_action(action).execute(ssn)
            out.append(ev.build(ssn, kind))
        finally:
            framework.close_session(ssn)
    return out


JAX_SOLVE = {"preempt": jevict.solve_preempt, "reclaim": jevict.solve_reclaim,
             "backfill": jevict.solve_backfill}


def jax_result(plan) -> np.ndarray:
    enc = {k: jnp.asarray(v) for k, v in plan.arrays.items()}
    return np.asarray(JAX_SOLVE[plan.spec.kind](plan.spec, enc))


def port_result(plan, arrays=None) -> np.ndarray:
    spec = tevict.EvictSpec(**plan.spec._asdict())
    enc = from_numpy_encoded(arrays if arrays is not None else plan.arrays,
                             device="cpu", dtype="float64")
    return tk.solve_packed(spec, enc).numpy()


def check_pair(jplan, tplan):
    """The port's encode equals the reference's; the port's machine gives
    the reference's packed result on those arrays. Returns the result."""
    assert jplan is not None and tplan is not None
    assert not jplan.trivial and not tplan.trivial
    assert tuple(tplan.spec) == tuple(jplan.spec)
    assert sorted(tplan.arrays) == sorted(jplan.arrays)
    for k, v in jplan.arrays.items():
        got = np.asarray(tplan.arrays[k])
        assert got.dtype == np.asarray(v).dtype and np.array_equal(got, v), k
    want = jax_result(jplan)
    got = port_result(jplan)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    return want


def _tail(plan, result):
    return dict(zip(("log_len", "rr", "victims", "attempts", "fail",
                     "underflow"), result[plan.log_rows * 3:].tolist()))


@pytest.mark.parametrize("kind", ["preempt", "reclaim", "backfill"])
@pytest.mark.parametrize("seed", [11, 42, 7])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_machine_matches_reference(tiers, seed, kind):
    jplan, tplan = plans(lambda c: overcommit_cluster(c, seed), tiers, kind)
    result = check_pair(jplan, tplan)
    if kind == "preempt" and tiers is not TIER_SETS[2]:
        # under the two gang-deciding confs every case evicts and pipelines
        assert _tail(jplan, result)["log_len"] > 0
    if kind == "backfill":
        assert (result >= 0).sum() == len(jplan.tasks)


@pytest.mark.parametrize("seed", [11, 42, 7])
@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_reclaim_that_evicts_matches_reference(tiers, seed):
    jplan, tplan = plans(lambda c: reclaim_cluster(c, seed), tiers, "reclaim")
    result = check_pair(jplan, tplan)
    tail = _tail(jplan, result)
    log = result[:tail["log_len"] * 3].reshape(-1, 3)
    assert (log[:, 0] == tevict.OP_EVICT).sum() > 0
    assert (log[:, 0] == tevict.OP_PIPELINE).sum() > 0
    assert not tail["fail"]


@pytest.mark.parametrize("tiers", TIER_SETS, ids=["cfg4", "prop", "drf"])
def test_reclaim_wide_rows_match_reference(tiers):
    """Nodes of more than 256 victims (V = 512: the rows K10 folds from
    global scratch on the card) evict as the reference does."""
    jplan, tplan = plans(lambda c: reclaim_cluster(
        c, 3, nodes=2, running_jobs=130, pods=1024), tiers, "reclaim")
    assert jplan.arrays["vic_job"].shape[1] == 512
    result = check_pair(jplan, tplan)
    tail = _tail(jplan, result)
    log = result[:tail["log_len"] * 3].reshape(-1, 3)
    assert (log[:, 0] == tevict.OP_EVICT).sum() > 0 and not tail["fail"]


def test_three_queue_reclaim_evicts():
    """The copied overcommit cluster with three queues: cfg4's conf makes
    reclaim evict across queues there."""
    jplan, tplan = plans(lambda c: overcommit_cluster(c, 0, nodes=7,
                                                      running_jobs=14,
                                                      tasks_per_job=3,
                                                      queues=3, hi_jobs=5),
                         TIER_SETS[0], "reclaim")
    result = check_pair(jplan, tplan)
    log = result[:_tail(jplan, result)["log_len"] * 3].reshape(-1, 3)
    assert (log[:, 0] == tevict.OP_EVICT).sum() > 0


@pytest.mark.parametrize("kind", ["preempt", "reclaim"])
def test_log_budget_trips_fail(kind):
    """A log shorter than the ops the action needs: the machine sets
    ``fail`` exactly where the reference does (the consumer then runs the
    serial walk); rows, tail and all must still agree."""
    build = (lambda c: overcommit_cluster(c, 7)) if kind == "preempt" \
        else (lambda c: reclaim_cluster(c, 7))
    jplan, _ = plans(build, TIER_SETS[0], kind)
    arrays = dict(jplan.arrays, log0=np.zeros((4, 3), np.int32))
    want = np.asarray(JAX_SOLVE[kind](
        jplan.spec, {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = port_result(jplan, arrays)
    assert np.array_equal(got, want)
    assert got[4 * 3 + 4] == 1      # fail
    assert got[4 * 3] >= 4          # log_len reached the budget


def test_step_budget_trips_fail():
    """A queue heap longer than the step budget (4 * (T + J + Q) + 64
    pops): the reclaim machine stops with ``fail`` at the same step as
    the reference, with the same log and tail."""
    jplan, _ = plans(lambda c: reclaim_cluster(c, 11), TIER_SETS[0],
                     "reclaim")
    a = jplan.arrays
    budget = 4 * (a["p_req"].shape[0] + a["job_prio"].shape[0]
                  + a["queue_alloc0"].shape[0]) + 64
    qh = 2 * budget
    arrays = dict(a, qheap0=np.resize(a["qheap0"][:int(a["qhsize0"])], qh)
                  .astype(np.int32), qhsize0=np.int32(qh))
    want = np.asarray(jevict.solve_reclaim(
        jplan.spec, {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = port_result(jplan, arrays)
    assert np.array_equal(got, want)
    assert got[jplan.log_rows * 3 + 4] == 1


def test_wrappers_run_plain_versions_on_cpu_tensors():
    """On CPU tensors each wrapper is its plain version and counts no
    launch; solve_packed dispatches on the spec's kind."""
    jplan, _ = plans(lambda c: overcommit_cluster(c, 42), TIER_SETS[0],
                     "preempt")
    spec = tevict.EvictSpec(**jplan.spec._asdict())
    enc = from_numpy_encoded(jplan.arrays, device="cpu", dtype="float64")
    devmod.reset_launches()
    a = tk.preempt(spec, enc)
    b = tk.preempt_plain(spec, enc)
    c = tk.solve_packed(spec, enc)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert devmod.launches() == {k: 0 for k in devmod.LAUNCHES}
    with pytest.raises(KeyError):
        tk.solve_packed(spec._replace(kind="express"), enc)


@pytest.mark.parametrize("kernel", ["k7b", "k9", "k10", "k13", "k14", "k15"])
def test_kernel_profile_marks_match_its_phases(kernel):
    """A kernel profile's phases are the kernel's PROF(k) marks: every
    phase has a mark and every mark a phase, and the kernel's counter array
    has one slot a phase (and one for the units where it counts them; the
    profile builds only: the marks are empty else)."""
    import os
    import re

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.bench import kernel_profile

    k = kernel_profile.KERNELS[kernel]
    with open(os.path.join(_build.CSRC, k.source + ".cu")) as fh:
        src = fh.read()
    code = "\n".join(line for line in src.splitlines()
                     if not line.lstrip().startswith(("//", "#define")))
    marks = {int(n) for n in re.findall(r"\bPROF\((\d+)\);", code)}
    assert marks == set(range(len(k.phases)))
    assert f"constexpr int kProfPhases = {len(k.phases)};" in src
    slots = "kProfPhases + 1" if k.counts_units else "kProfPhases"
    assert f"{kernel}_prof_t[{slots}];" in src
    assert ("PROF_UNIT();" in code) == k.counts_units
    guarded = src[src.index(f"#ifdef {k.flag}"):]
    assert "#else\n#define PROF(k) do {} while (0)" in guarded
    assert f'extern "C" int {k.read}' in src[src.rindex(f"#ifdef {k.flag}"):]


@pytest.mark.parametrize("kernel", ["k7b", "k9", "k10", "k13", "k14", "k15"])
def test_kernel_profile_builds_the_kernel_source_with_the_flag(monkeypatch, kernel):
    """The profiling build is nvcc on the kernel's own source with the
    kernels' flags and the kernel's profile flag defined: no copy of the
    source."""
    import os

    from volcano_tpu_torch import _build
    from volcano_tpu_torch.bench import kernel_profile

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    k = kernel_profile.KERNELS[kernel]
    cmd = kernel_profile.build_command(kernel, "out.so")
    src = os.path.join(_build.CSRC, k.source + ".cu")
    assert cmd[0] == "nvcc" and cmd[-1] == src and os.path.exists(src)
    assert f"-D{kernel.upper()}_PROFILE" in cmd and cmd[cmd.index("-o") + 1] == "out.so"
    assert cmd[1:1 + len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
