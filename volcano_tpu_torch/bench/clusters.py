"""Synthetic-cluster generators for the five BASELINE.json configurations.

Each config is a deterministic (seeded) generator that populates a
SchedulerCache through its normal event-handler surface — the same path the
store feeds in production — so benchmarks exercise the full snapshot
pipeline, not a shortcut.

| cfg | BASELINE.json description                                           |
|-----|---------------------------------------------------------------------|
| 1   | allocate + gang only: 100 PodGroups (minMember=4), 50 nodes, CPU    |
| 2   | allocate + predicates + binpack: 5k heterogeneous tasks, 1k nodes   |
| 3   | allocate + drf + proportion: 10 queues, 20k tasks, 5k nodes         |
| 4   | backfill + preempt, priority/reclaim: 30k tasks, 8k nodes, 30% over |
| 5   | full default conf at 50k tasks x 10k nodes                          |
| 6   | cfg2 + required anti-affinity / hostPort pods (serial residue path) |
| 7   | paper-2x mesh-scaling standing config: 100k tasks x 50k nodes       |
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.plugins import apply_plugin_conf_defaults
from volcano_tpu_torch.scheduler.util import scheduler_helper
from volcano_tpu_torch.scheduler.util.test_utils import (
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list_with_pods,
)


def make_tiers(*tier_plugin_names: Sequence[str], arguments=None) -> List[conf.Tier]:
    arguments = arguments or {}
    tiers = []
    for names in tier_plugin_names:
        options = []
        for name in names:
            option = conf.PluginOption(name=name, arguments=arguments.get(name, {}))
            apply_plugin_conf_defaults(option)
            options.append(option)
        tiers.append(conf.Tier(plugins=options))
    return tiers


def make_cache() -> SchedulerCache:
    scheduler_helper.reset_round_robin()
    return SchedulerCache(
        binder=FakeBinder(),
        evictor=FakeEvictor(),
        status_updater=FakeStatusUpdater(),
        volume_binder=FakeVolumeBinder(),
    )


@dataclass
class BenchConfig:
    name: str
    description: str
    populate: Callable[[SchedulerCache, float], int]  # returns task count
    tiers: Sequence[Sequence[str]]
    actions: Sequence[str] = ("allocate",)


def _gang_cpu(c: SchedulerCache, scale: float) -> int:
    """cfg1: example/job.yaml replicated — 100 gangs of 4, 50 nodes."""
    rng = random.Random(1)
    groups, nodes = max(int(100 * scale), 2), max(int(50 * scale), 2)
    for g in range(groups):
        pg = f"job-{g:04d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=4))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([250, 500, 1000])}m", "memory": "512Mi"},
                pg))
    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("16", "32Gi", pods=256)))
    c.add_queue(build_queue("default"))
    return groups * 4


def _heterogeneous(c: SchedulerCache, scale: float) -> int:
    """cfg2: 5k heterogeneous cpu/mem/gpu tasks over 1k nodes."""
    rng = random.Random(2)
    tasks, nodes = max(int(5000 * scale), 8), max(int(1000 * scale), 4)
    groups = tasks // 4
    for g in range(groups):
        pg = f"job-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=2))
        for i in range(4):
            req = {
                "cpu": f"{rng.choice([100, 250, 500, 1000, 2000])}m",
                "memory": rng.choice(["256Mi", "512Mi", "1Gi", "2Gi"]),
            }
            if rng.random() < 0.25:
                req["nvidia.com/gpu"] = str(rng.choice([1, 2]))
            c.add_pod(build_pod("bench", f"{pg}-t{i}", "",
                                objects.POD_PHASE_PENDING, req, pg))
    for n in range(nodes):
        rl = build_resource_list_with_pods("32", "64Gi", pods=256)
        if n % 4 == 0:
            rl["nvidia.com/gpu"] = "8"
        zone = f"zone-{n % 8}"
        c.add_node(build_node(f"node-{n:05d}", rl, labels={"zone": zone}))
    c.add_queue(build_queue("default"))
    return groups * 4


def _multi_queue(c: SchedulerCache, scale: float) -> int:
    """cfg3: 10 weighted queues, 20k tasks, 5k nodes."""
    rng = random.Random(3)
    tasks, nodes = max(int(20000 * scale), 20), max(int(5000 * scale), 4)
    queues = 10
    for q in range(queues):
        c.add_queue(build_queue(f"queue-{q}", weight=1 + q % 5))
    groups = tasks // 4
    for g in range(groups):
        pg = f"job-{g:05d}"
        c.add_pod_group(build_pod_group(
            pg, namespace="bench", min_member=2, queue=f"queue-{g % queues}"))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([250, 500, 1000])}m",
                 "memory": rng.choice(["512Mi", "1Gi"])}, pg))
    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("16", "32Gi", pods=256)))
    return groups * 4


def _overcommit(c: SchedulerCache, scale: float) -> int:
    """cfg4: 30k tasks, 8k nodes, over-committed demand; exercises the full
    opt-in pipeline: allocate (shortfall), backfill (best-effort pods),
    preempt (high-priority gangs evicting running low-priority tasks within
    queue-a), and reclaim (starved queue-b reclaiming queue-a's overage).

    Composition at scale=1 (8k nodes x 4cpu/8Gi = 32k cpu):
    - 20k RUNNING low-priority 1cpu tasks (queue-a, gangs of 4, min=2):
      idle = 12k cpu;
    - 7k PENDING high-priority 2cpu tasks (queue-a, gangs of 4, min=4):
      14k demand > 12k idle -> allocate places most, preempt evicts
      low-priority victims for the shortfall;
    - 1k PENDING queue-b 1cpu tasks: queue-b's deserved share is unmet
      while queue-a runs over deserved -> reclaim;
    - 2k best-effort (zero-request) pods -> backfill."""
    nodes = max(int(8000 * scale), 8)
    n_running = max(int(20000 * scale) // 4 * 4, 16)
    n_high = max(int(7000 * scale) // 4 * 4, 8)
    n_qb = max(int(1000 * scale) // 4 * 4, 4)
    n_be = max(int(2000 * scale) // 4 * 4, 4)

    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("4", "8Gi", pods=64)))
    c.add_queue(build_queue("queue-a", weight=2))
    c.add_queue(build_queue("queue-b", weight=1))

    # running low-priority fill, bound round-robin (gangs of 4, min=2 so the
    # gang plugin lets preemption take up to 2 victims per gang)
    for g in range(n_running // 4):
        pg = f"run-{g:05d}"
        c.add_pod_group(build_pod_group(
            pg, namespace="bench", min_member=2, queue="queue-a"))
        for i in range(4):
            idx = g * 4 + i
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", f"node-{idx % nodes:05d}",
                objects.POD_PHASE_RUNNING,
                {"cpu": "1000m", "memory": "1Gi"}, pg, priority=1))

    # pending high-priority gangs (the preemptors)
    for g in range(n_high // 4):
        pg = f"hi-{g:05d}"
        c.add_pod_group(build_pod_group(
            pg, namespace="bench", min_member=4, queue="queue-a"))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "2000m", "memory": "2Gi"}, pg, priority=100))

    # starved-queue pending tasks (the reclaimers)
    for g in range(n_qb // 4):
        pg = f"qb-{g:05d}"
        c.add_pod_group(build_pod_group(
            pg, namespace="bench", min_member=1, queue="queue-b"))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "1000m", "memory": "1Gi"}, pg, priority=10))

    # best-effort pods for backfill
    for g in range(n_be // 4):
        pg = f"be-{g:05d}"
        c.add_pod_group(build_pod_group(
            pg, namespace="bench", min_member=1, queue="queue-a"))
        for i in range(4):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {}, pg, priority=1))
    return n_running + n_high + n_qb + n_be


def _heterogeneous_affinity(c: SchedulerCache, scale: float) -> int:
    """cfg6: cfg2's heterogeneous cluster + 5% required anti-affinity pods
    and ~1% hostPort pods — the constructs the rounds solve leaves to the
    serial residue pass (and per-signature symmetry masks). Measures the
    residue cost at scale (reference hot spot:
    predicates.go:281-299 inter-pod affinity O(pods x nodes))."""
    rng = random.Random(6)
    tasks, nodes = max(int(5000 * scale), 8), max(int(1000 * scale), 4)
    groups = tasks // 4
    for g in range(groups):
        pg = f"job-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=2))
        for i in range(4):
            req = {
                "cpu": f"{rng.choice([100, 250, 500, 1000, 2000])}m",
                "memory": rng.choice(["256Mi", "512Mi", "1Gi", "2Gi"]),
            }
            if rng.random() < 0.25:
                req["nvidia.com/gpu"] = str(rng.choice([1, 2]))
            pod = build_pod("bench", f"{pg}-t{i}", "",
                            objects.POD_PHASE_PENDING, req, pg)
            r = rng.random()
            if r < 0.05:
                # required anti-affinity against the pod's own app label:
                # at most one such pod per hostname domain
                app = f"aff-{g % 50}"
                pod.metadata.labels["app"] = app
                pod.spec.affinity = objects.Affinity(
                    pod_anti_affinity=objects.PodAntiAffinity(required_terms=[
                        objects.PodAffinityTerm(
                            label_selector=objects.LabelSelector(
                                match_labels={"app": app}),
                            topology_key="kubernetes.io/hostname",
                        )]))
            elif r < 0.06:
                pod.spec.containers[0].ports = [
                    objects.ContainerPort(
                        host_port=30000 + (g % 64), container_port=8080)]
            c.add_pod(pod)
    for n in range(nodes):
        rl = build_resource_list_with_pods("32", "64Gi", pods=256)
        if n % 4 == 0:
            rl["nvidia.com/gpu"] = "8"
        zone = f"zone-{n % 8}"
        c.add_node(build_node(f"node-{n:05d}", rl, labels={"zone": zone}))
    c.add_queue(build_queue("default"))
    return groups * 4


def _full_default(c: SchedulerCache, scale: float) -> int:
    """cfg5: the headline 50k x 10k under the full default conf."""
    rng = random.Random(5)
    tasks, nodes = max(int(50000 * scale), 20), max(int(10000 * scale), 4)
    groups = tasks // 8
    for g in range(groups):
        pg = f"job-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=4))
        for i in range(8):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([250, 500, 1000, 2000])}m",
                 "memory": rng.choice(["512Mi", "1Gi", "2Gi"])}, pg))
    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("32", "64Gi", pods=256)))
    c.add_queue(build_queue("default"))
    return groups * 8


def _paper_2x(c: SchedulerCache, scale: float) -> int:
    """cfg7: the paper-2x standing config — 100k tasks x 50k nodes under
    the full default conf (ROADMAP item 3). Twice the paper's 50k x 10k
    north star on BOTH axes the mesh shards over, so the per-device-count
    scaling curve (bench.py --mesh 1,2,4,8 -> tpu_mesh_curve) is measured
    against a cluster one chip cannot own: at 8 devices each shard still
    carries a cfg5-sized node slice."""
    rng = random.Random(7)
    tasks, nodes = max(int(100000 * scale), 24), max(int(50000 * scale), 8)
    groups = tasks // 8
    for g in range(groups):
        pg = f"job-{g:05d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=4))
        for i in range(8):
            c.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([250, 500, 1000, 2000])}m",
                 "memory": rng.choice(["512Mi", "1Gi", "2Gi"])}, pg))
    for n in range(nodes):
        c.add_node(build_node(
            f"node-{n:05d}", build_resource_list_with_pods("32", "64Gi", pods=256)))
    c.add_queue(build_queue("default"))
    return groups * 8


DEFAULT_TIERS = (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"])

CONFIGS: Dict[int, BenchConfig] = {
    1: BenchConfig("gang-cpu", "allocate+gang: 100 gangs(min=4), 50 nodes",
                   _gang_cpu, (["priority", "gang"], ["proportion"])),
    2: BenchConfig("heterogeneous", "allocate+predicates+binpack: 5k tasks, 1k nodes",
                   _heterogeneous, (["priority", "gang"], ["predicates", "binpack", "proportion"])),
    3: BenchConfig("multi-queue", "allocate+drf+proportion: 10 queues, 20k tasks, 5k nodes",
                   _multi_queue, (["priority", "gang"], ["drf", "proportion"])),
    4: BenchConfig("overcommit", "allocate+backfill+preempt+reclaim at overcommit: 30k tasks, 8k nodes",
                   _overcommit, (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"]),
                   actions=("allocate", "backfill", "preempt", "reclaim")),
    5: BenchConfig("full-default", "full default conf: 50k tasks x 10k nodes",
                   _full_default, DEFAULT_TIERS),
    6: BenchConfig("heterogeneous-affinity",
                   "cfg2 + 5% required anti-affinity + hostPort pods (residue path)",
                   _heterogeneous_affinity,
                   (["priority", "gang"], ["predicates", "binpack", "proportion"])),
    7: BenchConfig("paper-2x", "mesh-scaling standing config: 100k tasks x 50k nodes",
                   _paper_2x, DEFAULT_TIERS),
}


def build_config(cfg: int, scale: float = 1.0) -> tuple:
    """Returns (cache, tiers(serial), tiers(tpu), actions, task_count)."""
    bc = CONFIGS[cfg]
    cache = make_cache()
    n_tasks = bc.populate(cache, scale)
    serial_tiers = make_tiers(*bc.tiers)
    tpu_tiers = make_tiers(["tpuscore"], *bc.tiers)
    return cache, serial_tiers, tpu_tiers, bc.actions, n_tasks
