"""K7 on a CUDA card: K7a (``rounds_ctl``) and K7b (``tail_pass``) against
their plain versions, and the graph-replayed solve against the host-driven
step machine (``loop="host"``), on encodes the port's own session prepares.

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_rounds_gpu.py

Without a card its tests skip. Tolerance: exact equality (torch.equal)
of every state tensor, the control vector, the predicates and the packed
result.
"""

from __future__ import annotations

import pytest
import torch

from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as RK


def prepared(cfg, scale, extra_pods=0, device="cpu", dtype="float64"):
    """(spec, staged encode) of the allocate solve a port session of
    ``cfg`` prepares; ``extra_pods`` adds one job of that many small pods
    in an existing namespace and queue."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    from volcano_tpu_torch.scheduler.util.test_utils import build_pod, build_pod_group
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(cfg, scale)
    if extra_pods:
        ns = next(iter(cache.jobs.values())).namespace
        cache.add_pod_group(build_pod_group("churn", namespace=ns, min_member=1))
        for i in range(extra_pods):
            cache.add_pod(build_pod(ns, f"churn-{i}", "",
                                    objects.POD_PHASE_PENDING,
                                    {"cpu": "100m", "memory": "128Mi"}, "churn"))
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": device,
                     "tpuscore.dtype": dtype}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    return prep["spec"], prep["staged"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _capped(dtype):
    """cfg6 with a progress floor above most rounds' yield: it caps, runs
    straggler rounds and the tail pass."""
    spec, enc = prepared(6, 0.3, device="cuda", dtype=dtype)
    return spec._replace(round_min_progress=40, straggler_rounds=2), enc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gpu_controller_and_tail_kernels_equal_plain(dtype):
    _cuda()
    spec, enc = _capped(dtype)
    m = trounds.StepMachine(spec, enc, "host")
    seen = {"ctl": []}
    real_tail, real_ctl = RK.tail_pass_plain, RK._ctl_fold_decide

    def tail(spec, enc, st, ctl):
        seen.update(enc=enc, st={k: v.clone() for k, v in st.items()},
                    c=ctl.clone())
        return real_tail(spec, enc, st, ctl)

    def ctl(c, params):
        seen["ctl"].append(list(c))
        return real_ctl(c, params)

    RK.tail_pass_plain, RK._ctl_fold_decide = tail, ctl
    try:
        m.run()
    finally:
        RK.tail_pass_plain, RK._ctl_fold_decide = real_tail, real_ctl
    assert "st" in seen, "the solve must reach the tail pass"
    st_k = {k: v.clone() for k, v in seen["st"].items()}
    ctl_k = seen["c"].clone()
    RK.tail_pass(spec, seen["enc"], st_k, ctl_k)
    st_p = {k: v.clone() for k, v in seen["st"].items()}
    ctl_p = seen["c"].clone()
    RK.tail_pass_plain(spec, seen["enc"], st_p, ctl_p)
    for k in st_k:
        assert torch.equal(st_k[k], st_p[k]), k
    assert torch.equal(ctl_k, ctl_p) and int(ctl_p[RK.C_TAIL_PLACED]) > 0
    for c in seen["ctl"]:
        got = torch.tensor(c, dtype=torch.int32, device="cuda")
        pred = torch.zeros(RK.NPRED, dtype=torch.bool, device="cuda")
        RK.rounds_ctl(got, pred, m.params)
        want = list(c)
        want_p = RK._ctl_fold_decide(want, m.params)
        assert got.tolist() == want and pred.tolist() == want_p


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,scale,capped", [(2, 0.2, False), (6, 0.3, True)])
def test_gpu_graph_replay_equals_host_loop(cfg, scale, capped):
    _cuda()
    spec, enc = prepared(cfg, scale, device="cuda", dtype="float32")
    if capped:
        spec = spec._replace(round_min_progress=40, straggler_rounds=2)
    host = trounds.solve_rounds_packed(spec, enc, loop="host")
    for _ in range(2):
        got = trounds.solve_rounds_packed(spec, enc)
        assert torch.equal(got, host)
