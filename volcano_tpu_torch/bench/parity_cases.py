"""Crafted parity-scan (K15) inputs for holding the kernel to its plain
version on the card: a session's captured inputs, clusters that reach the
scan's rarer paths (a gang visit that rolls back after several
placements; more than 32 namespaces and queues, the block argmins), pad
nodes inside the round-robin rotation, the windows that bound it, and a
capture cut to a prefix of its jobs.
``chip_smoke.py`` phase 11 and tests/test_torch_kernels_gpu.py use them."""

from __future__ import annotations

import torch

# the default conf's tiers
TIERS = (["priority", "gang"], ["drf", "predicates", "proportion", "nodeorder"])


def parity_inputs(cache, tiers, dtype="float32", device="cuda"):
    """K15's (spec, enc, rr0, num_to_find) of one parity session on
    ``cache`` (on the card)."""
    from volcano_tpu_torch.bench.clusters import make_tiers
    from volcano_tpu_torch.ops import parity_kernels as PK
    from volcano_tpu_torch.scheduler.framework import close_session, open_session, run_actions
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = PK.solve_allocate

    def keep(spec, enc, rr0, ntf):
        seen.setdefault("args", (spec, {k: v.clone() for k, v in enc.items()}, rr0, ntf))
        return real(spec, enc, rr0, ntf)

    PK.solve_allocate = keep
    try:
        ssn = open_session(cache, make_tiers(["tpuscore"], *tiers, arguments={
            "tpuscore": {"tpuscore.mode": "parity", "tpuscore.device": device,
                         "tpuscore.dtype": dtype}}))
        try:
            run_actions(ssn, ["allocate"])
        finally:
            close_session(ssn)
    finally:
        PK.solve_allocate = real
    return seen["args"]


def gang_rollback_cluster():
    """Gangs of five whose last members stop fitting once earlier gangs
    land: such a visit places several tasks, then rolls them back."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.util import test_utils as tu

    c = make_cache()
    c.add_queue(tu.build_queue("default"))
    for g in range(6):
        pg = f"pg{g}"
        c.add_pod_group(tu.build_pod_group(pg, namespace="ns1", min_member=5))
        for i in range(5):
            c.add_pod(tu.build_pod("ns1", f"{pg}-p{i}", "", objects.POD_PHASE_PENDING,
                                   {"cpu": f"{1000 + 250 * (g % 3)}m", "memory": "1Gi"}, pg))
    for n in range(3):
        c.add_node(tu.build_node(f"node-{n:03d}", tu.build_resource_list_with_pods("5", "16Gi")))
    return c


def wide_visit_cluster(spaces=40, queues=40):
    """More than 32 namespaces and 32 queues (the block argmins), with
    proportion's overused purge."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import make_cache
    from volcano_tpu_torch.scheduler.util import test_utils as tu

    c = make_cache()
    for q in range(queues):
        c.add_queue(tu.build_queue(f"q{q:02d}", weight=1 + q % 3))
    for s in range(spaces):
        for g in range(2):
            pg = f"ns{s:02d}-pg{g}"
            c.add_pod_group(tu.build_pod_group(pg, namespace=f"ns{s:02d}", min_member=2,
                                               queue=f"q{(s * 2 + g) % queues:02d}"))
            for i in range(2):
                c.add_pod(tu.build_pod(f"ns{s:02d}", f"{pg}-p{i}", "", objects.POD_PHASE_PENDING,
                                       {"cpu": f"{500 + 250 * ((g + s) % 4)}m", "memory": "1Gi"},
                                       pg))
    for n in range(30):
        c.add_node(tu.build_node(f"node-{n:03d}", tu.build_resource_list_with_pods("4", "8Gi")))
    return c


def pads_inside(enc):
    """Every fifth node a pad (node_real false) and real_n the real count:
    pad nodes sit inside the rotation."""
    enc = dict(enc)
    n = enc["node_real"].shape[0]
    real = enc["node_real"].clone()
    real[torch.arange(n, device=real.device) % 5 == 2] = False
    enc["node_real"] = real
    enc["real_n"] = torch.tensor(int(real.sum()), dtype=torch.int32, device=real.device)
    return enc


def job_prefix(enc, parts: int):
    """``enc`` with only the first 1/``parts`` of its jobs (by index)
    active: the same task and node axes, a scan of about 1/``parts`` of
    the steps (a step is a task visited; num_to_find only sizes each
    step's node window)."""
    enc = dict(enc)
    active = enc["job_active0"].clone()
    active[-(-active.shape[0] // parts):] = False
    enc["job_active0"] = active
    return enc


def windows(enc, rr0: int, ntf: int):
    """(rr0, num_to_find) pairs around the session's own: the cursor at
    real_n - 1 and near 0, num_to_find at 0, below 0, 1 and above any
    feasible count."""
    rn = int(enc["real_n"])
    return [(rr0, ntf), (rn - 1, ntf), (0, 0), (3, -2), (rn - 1, 1), (7, 10 ** 6)]
