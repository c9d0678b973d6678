"""The reclaim path: a cluster of cfg4's width on which the reclaim action
has work (cfg4's own reclaim finds nothing: preempt pipelines every
pending task first), with the tiers and actions its sessions run.
``chip_smoke.py`` drives K10 through it, and ``kernel_profile --kernel
k10`` profiles K10 on its inputs. ``dense_reclaim_cluster`` is its shape
with nodes of more than 256 victims (K10's wide-row fold)."""

from __future__ import annotations

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


def dense_reclaim_cluster(nodes=2, pods_per_node=300, pending=6):
    """The reclaim path's shape with many small victims a node: queue-a
    (weight 1) runs pods_per_node one-pod gangs of 100m/128Mi on each
    node, filling it, and queue-b (weight 3) holds pending one-task gangs
    of 1 cpu / 1Gi, so reclaim evicts from nodes of more than 256 victims
    (V = 512)."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_pod, build_pod_group, build_queue,
        build_resource_list_with_pods)

    c = make_cache()
    cpu_m, mem_mi = pods_per_node * 100, pods_per_node * 128
    for n in range(nodes):
        c.add_node(build_node(f"node-{n:03d}", build_resource_list_with_pods(
            f"{cpu_m}m", f"{mem_mi}Mi", pods=1024)))
    c.add_queue(build_queue("queue-a", weight=1))
    c.add_queue(build_queue("queue-b", weight=3))
    for g in range(nodes * pods_per_node):
        pg = f"run-{g:04d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=1, queue="queue-a"))
        c.add_pod(build_pod("bench", f"{pg}-t0", f"node-{g % nodes:03d}",
                            objects.POD_PHASE_RUNNING, {"cpu": "100m", "memory": "128Mi"},
                            pg, priority=1))
    for g in range(pending):
        pg = f"rb-{g:03d}"
        c.add_pod_group(build_pod_group(pg, namespace="bench", min_member=1, queue="queue-b"))
        c.add_pod(build_pod("bench", f"{pg}-t0", "", objects.POD_PHASE_PENDING,
                            {"cpu": "1", "memory": "1Gi"}, pg, priority=10))
    return c
