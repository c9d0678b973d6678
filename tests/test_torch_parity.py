"""K15, the parity scan: the port against the JAX package.

Three levels, all on the CPU in float64:

1. ``solve_allocate_plain`` (volcano_tpu_torch/ops/parity_kernels.py) is
   held bit for bit, ``assign`` and the final round-robin index, to the
   JITTED JAX ``kernels.solve_allocate`` on the same padded numpy arrays
   (the JAX encoder's, from clusters built with a seed), across the cases
   that exercise each part of the scan: gangs, partial and no capacity, a
   scalar dim under binpack, node selectors, fair share with an overused
   queue purged, priorities, the sampling window with ``rr0 != 0`` and
   ``num_to_find`` below the feasible count, namespaces under DRF order,
   tiers reordered, gang discards mid-visit, padded jobs and tasks.
2. Twins of every test in tests/test_tpu_parity.py but the mesh one (the
   port has no mesh): the port's parity binds == the port's serial binds
   == the JAX package's serial binds, through the tpuscore plugin.
3. Two consecutive parity sessions, the port against the JAX package,
   including the round-robin cursor carried between them.

Tolerance: exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from volcano_tpu.api import objects as jobjects
from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import solver as jsolver
from volcano_tpu.ops.encoder import encode_session as jencode
from volcano_tpu.scheduler import framework as jframework
from volcano_tpu.scheduler.util import scheduler_helper as jhelper
from volcano_tpu.scheduler.util import test_utils as jtu
import volcano_tpu.scheduler.actions  # noqa: F401  (register actions)

from volcano_tpu_torch.api import objects as tobjects
from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.ops import parity_kernels as pk
from volcano_tpu_torch.scheduler import framework as tframework
from volcano_tpu_torch.scheduler.util import scheduler_helper as thelper
from volcano_tpu_torch.scheduler.util import test_utils as ttu
import volcano_tpu_torch.scheduler.actions  # noqa: F401  (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (register plugins)

DEFAULT_TIERS = (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"])

JAX = dict(tu=jtu, obj=jobjects, clusters=jclusters, fw=jframework, helper=jhelper)
PORT = dict(tu=ttu, obj=tobjects, clusters=tclusters, fw=tframework, helper=thelper)

PARITY_ARGS = {"tpuscore": {"tpuscore.mode": "parity", "tpuscore.device": "cpu",
                            "tpuscore.dtype": "float64"}}
J_PARITY_ARGS = {"tpuscore": {"tpuscore.mode": "parity"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- clusters (either package's objects and test utilities) ----------------


def gang_cluster(n_groups=12, min_member=4, n_nodes=8, seed=0):
    def populate(c, tu, obj):
        rng = random.Random(seed)
        c.add_queue(tu.build_queue("default"))
        for g in range(n_groups):
            pg = f"pg{g}"
            c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=min_member))
            for i in range(min_member):
                c.add_pod(tu.build_pod(
                    "ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                    {"cpu": f"{rng.choice([500, 1000, 2000])}m", "memory": "1Gi"}, pg))
        for n in range(n_nodes):
            c.add_node(tu.build_node(
                f"node-{n:03d}", tu.build_resource_list_with_pods("8", "16Gi")))
    return populate


def no_capacity(c, tu, obj):
    c.add_queue(tu.build_queue("default"))
    c.add_pod_group(tu.build_pod_group("pg1", namespace="ns1", min_member=5))
    for i in range(5):
        c.add_pod(tu.build_pod("ns1", f"p{i}", "", obj.POD_PHASE_PENDING,
                               {"cpu": "3", "memory": "1Gi"}, "pg1"))
    c.add_node(tu.build_node("n1", tu.build_resource_list_with_pods("4", "8Gi")))


def heterogeneous(c, tu, obj):
    rng = random.Random(7)
    c.add_queue(tu.build_queue("default"))
    for g in range(15):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=1))
        for i in range(rng.randint(1, 4)):
            req = {"cpu": f"{rng.choice([250, 500, 1500])}m",
                   "memory": rng.choice(["512Mi", "1Gi", "2Gi"])}
            if rng.random() < 0.3:
                req["nvidia.com/gpu"] = "1"
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING, req, pg))
    for n in range(10):
        rl = tu.build_resource_list_with_pods("4", "8Gi")
        if n % 2 == 0:
            rl["nvidia.com/gpu"] = "4"
        c.add_node(tu.build_node(f"node-{n:03d}", rl))


def node_selectors(c, tu, obj):
    c.add_queue(tu.build_queue("default"))
    for g, zone in enumerate(["a", "b", "a", "b", "a"]):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=2))
        for i in range(2):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": "1", "memory": "1Gi"}, pg,
                                   node_selector={"zone": zone}))
    for n in range(6):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("4", "8Gi"),
            labels={"zone": "a" if n < 3 else "b"}))


def multi_queue(c, tu, obj):
    rng = random.Random(3)
    c.add_queue(tu.build_queue("q-gold", weight=3))
    c.add_queue(tu.build_queue("q-silver", weight=2))
    c.add_queue(tu.build_queue("q-bronze", weight=1))
    for g in range(18):
        q = ["q-gold", "q-silver", "q-bronze"][g % 3]
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=2, queue=q))
        for i in range(3):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": f"{rng.choice([500, 1000])}m",
                                    "memory": "1Gi"}, pg))
    for n in range(6):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("6", "12Gi")))


def overused_queue(c, tu, obj):
    """One queue asks for far more than its share, the other for little:
    the greedy queue turns overused mid-session and is purged for good,
    so idle capacity stays idle behind it."""
    c.add_queue(tu.build_queue("greedy", weight=1))
    c.add_queue(tu.build_queue("small", weight=1))
    for g in range(12):
        pg = f"greedy-{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=1,
                                           queue="greedy"))
        for i in range(2):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": "2", "memory": "1Gi"}, pg))
    for g in range(2):
        pg = f"small-{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=1,
                                           queue="small"))
        c.add_pod(tu.build_pod("ns1", f"{pg}-p0", "", obj.POD_PHASE_PENDING,
                               {"cpu": "1", "memory": "1Gi"}, pg))
    for n in range(4):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("8", "32Gi")))


def priorities(c, tu, obj):
    c.add_queue(tu.build_queue("default"))
    for g in range(6):
        pc = obj.PriorityClass(metadata=obj.ObjectMeta(name=f"prio-{g}"), value=g)
        pc.metadata.ensure_identity()
        c.add_priority_class(pc)
    for g in range(6):
        pg = f"pg{g}"
        pgobj = tu.build_pod_group(pg, namespace="ns1", min_member=2)
        pgobj.spec.priority_class_name = f"prio-{g}"
        c.add_pod_group(pgobj)
        for i in range(2):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": "2", "memory": "2Gi"}, pg))
    c.add_node(tu.build_node("n1", tu.build_resource_list_with_pods("12", "24Gi")))


def sampling_window(c, tu, obj):
    rng = random.Random(11)
    c.add_queue(tu.build_queue("default"))
    for g in range(25):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=2))
        for i in range(2):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": f"{rng.choice([1000, 2000])}m",
                                    "memory": "1Gi"}, pg))
    for n in range(120):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("2", "4Gi")))


def multi_namespace(c, tu, obj):
    c.add_queue(tu.build_queue("default"))
    for ns in ("ns-a", "ns-b"):
        for g in range(4):
            pg = f"{ns}-pg{g}"
            c.add_pod_group(tu.build_pod_group(pg, namespace=ns, min_member=2))
            for i in range(2):
                c.add_pod(tu.build_pod(ns, f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                       {"cpu": "1", "memory": "1Gi"}, pg))
    for n in range(4):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("4", "8Gi")))


def drf_first(c, tu, obj):
    c.add_queue(tu.build_queue("default"))
    pc = obj.PriorityClass(metadata=obj.ObjectMeta(name="hi"), value=100)
    pc.metadata.ensure_identity()
    c.add_priority_class(pc)
    pg_a = tu.build_pod_group("pg-a", namespace="ns1", min_member=1)
    pg_a.spec.priority_class_name = "hi"
    c.add_pod_group(pg_a)
    c.add_pod(tu.build_pod("ns1", "a-run", "n1", obj.POD_PHASE_RUNNING,
                           {"cpu": "2", "memory": "2Gi"}, "pg-a"))
    c.add_pod(tu.build_pod("ns1", "a-p0", "", obj.POD_PHASE_PENDING,
                           {"cpu": "1", "memory": "1Gi"}, "pg-a"))
    c.add_pod_group(tu.build_pod_group("pg-b", namespace="ns1", min_member=1))
    c.add_pod(tu.build_pod("ns1", "b-p0", "", obj.POD_PHASE_PENDING,
                           {"cpu": "1", "memory": "1Gi"}, "pg-b"))
    c.add_node(tu.build_node("n1", tu.build_resource_list_with_pods("4", "8Gi")))


def gang_discard(c, tu, obj):
    """Gangs whose last members do not fit once earlier gangs land: each
    such visit places some tasks, then rolls them back."""
    c.add_queue(tu.build_queue("default"))
    for g in range(6):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=5))
        for i in range(5):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": f"{1000 + 250 * (g % 3)}m",
                                    "memory": "1Gi"}, pg))
    for n in range(3):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("5", "16Gi")))


def with_pods_capped(c, tu, obj):
    """The pod-count cap decides: 2 pods a node, 3-task gangs."""
    c.add_queue(tu.build_queue("default"))
    for g in range(5):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=3))
        for i in range(3):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": "100m", "memory": "128Mi"}, pg))
    for n in range(5):
        c.add_node(tu.build_node(
            f"node-{n:03d}", tu.build_resource_list_with_pods("8", "16Gi", pods=2)))


# -- level 1: the plain version against the jitted JAX kernel ----------------

KERNEL_CASES = {
    "gang_blocks": (gang_cluster(), DEFAULT_TIERS),
    "partial_capacity": (gang_cluster(n_groups=20, min_member=4, n_nodes=4), DEFAULT_TIERS),
    "no_capacity": (no_capacity, DEFAULT_TIERS),
    "binpack_scalar": (heterogeneous, (["priority", "gang"], ["predicates", "binpack"])),
    "node_selectors": (node_selectors, DEFAULT_TIERS),
    "fair_share": (multi_queue, DEFAULT_TIERS),
    "overused_purge": (overused_queue, DEFAULT_TIERS),
    "priorities": (priorities, DEFAULT_TIERS),
    "sampling_window": (sampling_window, DEFAULT_TIERS),
    "namespaces_drf": (multi_namespace, DEFAULT_TIERS),
    "drf_before_priority": (drf_first, (["drf"], ["priority", "gang"], ["proportion"])),
    "gang_discard": (gang_discard, DEFAULT_TIERS),
    "pod_cap": (with_pods_capped, DEFAULT_TIERS),
    "cfg2": (lambda c, tu, obj: _cfg(c, 2, 0.02), jclusters.CONFIGS[2].tiers),
    "cfg3": (lambda c, tu, obj: _cfg(c, 3, 0.01), jclusters.CONFIGS[3].tiers),
}


def _cfg(cache, cfg, scale):
    jclusters.CONFIGS[cfg].populate(cache, scale)


def _jax_arrays(populate, tiers):
    cache = jclusters.make_cache()
    populate(cache, jtu, jobjects)
    ssn = jframework.open_session(cache, jclusters.make_tiers(*tiers))
    enc = jencode(ssn, allow_residue=False)
    arrays = jsolver.pad_encoded(enc)
    jframework.close_session(ssn)
    return enc, {k: np.asarray(v) for k, v in arrays.items()}


def _to_port(arrays):
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype.is_floating_point:
            t = t.to(torch.float64)
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
        out[k] = t
    return out


def _jax_solve(spec, arrays, rr0, ntf):
    assign, rr = jkernels.solve_allocate(spec, arrays, np.int32(rr0), np.int32(ntf))
    return np.append(np.asarray(assign), np.int32(rr)).astype(np.int32)


def _windows(enc):
    """(rr0, num_to_find) pairs: the encode's own, a rotated start with a
    window below the feasible count, and the degenerate window of 1."""
    n = len(enc.node_names)
    return [(enc.rr0, enc.num_to_find), (n // 3 + 1, max(1, enc.num_to_find // 4)),
            (n - 1, 1)]


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_matches_jitted_jax(case):
    populate, tiers = KERNEL_CASES[case]
    enc, arrays = _jax_arrays(populate, tiers)
    t_enc = _to_port(arrays)
    for rr0, ntf in _windows(enc):
        want = _jax_solve(enc.spec, arrays, rr0, ntf)
        got = pk.solve_allocate(enc.spec, t_enc, rr0, ntf)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{case} {rr0} {ntf}")


@pytest.mark.parametrize("case", ["cfg2", "sampling_window", "gang_discard"])
def test_plain_matches_jitted_jax_on_crafted_windows(case):
    """The windows the card holds K15 to (volcano_tpu_torch/bench/
    parity_cases.py): the cursor at real_n - 1 and near 0, num_to_find at
    0, below 0, 1 and above any feasible count, each also with every fifth
    node a pad inside the rotation; the plain version equals the jitted
    JAX kernel on each."""
    from volcano_tpu_torch.bench.parity_cases import pads_inside, windows

    populate, tiers = KERNEL_CASES[case]
    enc, arrays = _jax_arrays(populate, tiers)
    t_enc = _to_port(arrays)
    padded = pads_inside(t_enc)
    p_arrays = dict(arrays, node_real=padded["node_real"].numpy(),
                    real_n=padded["real_n"].numpy().astype(arrays["real_n"].dtype))
    assert int(padded["real_n"]) < int(t_enc["real_n"])
    for a, e in ((arrays, t_enc), (p_arrays, padded)):
        for rr0, ntf in windows(e, enc.rr0, enc.num_to_find):
            want = _jax_solve(enc.spec, a, rr0, ntf)
            got = pk.solve_allocate(enc.spec, e, rr0, ntf)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{case} {rr0} {ntf}")


def test_cases_reach_the_paths_they_name():
    """The kernel cases are not vacuous: the window case rotates over
    more than num_to_find feasible nodes, the partial-capacity and
    discard cases leave gangs unplaced, the padded shapes exceed the live
    counts, and the overused queue is purged with capacity left idle."""
    enc, arrays = _jax_arrays(sampling_window, DEFAULT_TIERS)
    assert len(enc.node_names) > enc.num_to_find
    assert arrays["task_req"].shape[0] > len(enc.task_infos)
    assert arrays["job_task_start"].shape[0] > len(enc.job_infos)
    for case in ("partial_capacity", "gang_discard"):
        populate, tiers = KERNEL_CASES[case]
        enc, arrays = _jax_arrays(populate, tiers)
        out = pk.solve_allocate(enc.spec, _to_port(arrays), enc.rr0, enc.num_to_find)
        placed = (out[:len(enc.task_infos)] >= 0).sum().item()
        assert 0 < placed < len(enc.task_infos), case
    enc, arrays = _jax_arrays(overused_queue, DEFAULT_TIERS)
    out = pk.solve_allocate(enc.spec, _to_port(arrays), enc.rr0, enc.num_to_find).numpy()
    greedy = [i for i, t in enumerate(enc.task_infos) if t.name.startswith("greedy")]
    placed_greedy = int((out[greedy] >= 0).sum())
    assert 0 < placed_greedy < len(greedy)
    assert placed_greedy * 2 < 32  # the cluster had room for every greedy task


def test_wrapper_on_cpu_counts_no_launch():
    from volcano_tpu_torch import device as devmod

    devmod.reset_launches()
    enc, arrays = _jax_arrays(gang_cluster(), DEFAULT_TIERS)
    pk.solve_allocate(enc.spec, _to_port(arrays), enc.rr0, enc.num_to_find)
    assert devmod.launches()["parity_scan"] == 0


def test_kernel_params_match_the_cuda_struct():
    """The ctypes argument block and csrc/parity_scan.cu's ParityParams
    name the same fields in the same order."""
    import os
    import re

    src = os.path.join(os.path.dirname(pk.__file__), "..", "csrc", "parity_scan.cu")
    with open(src) as fh:
        text = fh.read()
    body = text[text.index("struct ParityParams {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"\*?\s*(\w+)\s*[,;]", body.replace("const void", "")
                        .replace("void", "").replace("int ", ""))
    assert fields == [name for name, _ in pk._Params._fields_]


# -- level 2: twins of tests/test_tpu_parity.py through the plugin -----------


def run_backend(pkg, populate, tiers, tpu: bool):
    cache = pkg["clusters"].make_cache()
    populate(cache, pkg["tu"], pkg["obj"])
    tier_spec = list(tiers)
    if tpu:
        tier_spec = [["tpuscore"], *tier_spec]
    args = PARITY_ARGS if pkg is PORT else J_PARITY_ARGS
    ssn = pkg["fw"].open_session(cache, pkg["clusters"].make_tiers(*tier_spec, arguments=args))
    pkg["fw"].get_action("allocate").execute(ssn)
    prof = dict(ssn.plugins["tpuscore"].profile) if tpu else {}
    pkg["fw"].close_session(ssn)
    return cache.binder.binds, prof, pkg["helper"]._last_processed_node_index


def assert_parity(populate, tiers=DEFAULT_TIERS):
    serial, _, rr_serial = run_backend(PORT, populate, tiers, tpu=False)
    batched, prof, rr_batched = run_backend(PORT, populate, tiers, tpu=True)
    j_serial, _, j_rr = run_backend(JAX, populate, tiers, tpu=False)
    assert prof.get("mode") == "parity" and "fallback" not in prof, prof
    assert batched == serial == j_serial
    # the cursor carries on as the serial helper's does
    assert rr_batched == rr_serial == j_rr
    return serial


class TestTorchParity:
    def test_gang_blocks_default_conf(self):
        assert len(assert_parity(gang_cluster())) > 0

    def test_gang_partial_capacity(self):
        binds = assert_parity(gang_cluster(n_groups=20, min_member=4, n_nodes=4))
        assert len(binds) % 4 == 0

    def test_gang_no_capacity(self):
        assert assert_parity(no_capacity) == {}

    def test_heterogeneous_binpack(self):
        assert_parity(heterogeneous, tiers=(["priority", "gang"], ["predicates", "binpack"]))

    def test_node_selectors(self):
        assert len(assert_parity(node_selectors)) == 10

    def test_multi_queue_fair_share(self):
        assert_parity(multi_queue)

    def test_overused_queue_purged(self):
        assert_parity(overused_queue)

    def test_priorities_order(self):
        binds = assert_parity(priorities)
        bound_groups = {k.split("/")[1].rsplit("-", 1)[0] for k in binds}
        assert bound_groups == {"pg5", "pg4", "pg3"}

    def test_node_sampling_window(self):
        assert_parity(sampling_window)

    def test_multi_namespace(self):
        assert_parity(multi_namespace)

    def test_reordered_tiers_drf_before_priority(self):
        binds = assert_parity(drf_first, tiers=(["drf"], ["priority", "gang"], ["proportion"]))
        assert "ns1/b-p0" in binds

    def test_gang_discard_mid_visit(self):
        assert_parity(gang_discard)

    def test_fallback_on_pod_affinity(self):
        """Parity mode keeps the session-wide fallback to the serial loop
        for constructs the scan does not model."""
        def populate(c, tu, obj):
            c.add_queue(tu.build_queue("default"))
            c.add_pod_group(tu.build_pod_group("pg1", namespace="ns1", min_member=1))
            pod = tu.build_pod("ns1", "p1", "", obj.POD_PHASE_PENDING,
                               {"cpu": "1", "memory": "1Gi"}, "pg1", labels={"app": "x"})
            pod.spec.affinity = obj.Affinity(
                pod_anti_affinity=obj.PodAntiAffinity(required_terms=[
                    obj.PodAffinityTerm(
                        label_selector=obj.LabelSelector(match_labels={"app": "x"}),
                        topology_key="kubernetes.io/hostname")]))
            c.add_pod(pod)
            c.add_node(tu.build_node("n1", tu.build_resource_list_with_pods("4", "8Gi")))

        binds, prof, _ = run_backend(PORT, populate, DEFAULT_TIERS, tpu=True)
        assert "fallback" in prof
        assert binds == {"ns1/p1": "n1"}


# -- level 3: consecutive sessions, the cursor carried ------------------------


def _two_sessions(pkg, args):
    cache = pkg["clusters"].make_cache()
    sampling_window(cache, pkg["tu"], pkg["obj"])
    tiers = pkg["clusters"].make_tiers(["tpuscore"], *DEFAULT_TIERS, arguments=args)
    out = []
    for k in range(2):
        if k:
            for g in range(6):
                pg = f"late{g}"
                cache.add_pod_group(pkg["tu"].build_pod_group(pg, namespace="ns1",
                                                              min_member=2))
                for i in range(2):
                    cache.add_pod(pkg["tu"].build_pod(
                        "ns1", f"{pg}-p{i}", "", pkg["obj"].POD_PHASE_PENDING,
                        {"cpu": "1", "memory": "1Gi"}, pg))
        ssn = pkg["fw"].open_session(cache, tiers)
        pkg["fw"].get_action("allocate").execute(ssn)
        mode = ssn.plugins["tpuscore"].profile.get("mode")
        pkg["fw"].close_session(ssn)
        out.append((dict(cache.binder.binds), pkg["helper"]._last_processed_node_index, mode))
    return out


def test_consecutive_parity_sessions_match_the_jax_package():
    t = _two_sessions(PORT, PARITY_ARGS)
    j = _two_sessions(JAX, J_PARITY_ARGS)
    assert [m for _, _, m in t] == ["parity", "parity"]
    assert t == j
    # the second session starts where the first left the cursor
    assert t[0][1] != 0 and len(t[1][0]) > len(t[0][0])
