"""K11 evict_backfill (csrc/evict_backfill.cu) on a CUDA card against its
plain version (``evict_kernels.backfill_plain``) on the same inputs:
every crafted case of bench/backfill_cases.py in the placement its sizes
choose and, widened by all-false node columns, in the global placement;
the backfill inputs of small cfg4 sessions, per-action and fused; one
launch in a CUDA graph replayed 20 times on changing inputs; one launch a
call.

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_backfill_gpu.py

Without a card its tests skip. Tolerance: exact equality (torch.equal)
of the int32 assignment.
"""

from __future__ import annotations

import os

import pytest
import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.bench import backfill_cases
from volcano_tpu_torch.ops import evict_kernels as EK

pytestmark = pytest.mark.gpu

CASES = backfill_cases.cases()
IDS = [c[0] for c in CASES]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _enc(arrays, device="cuda"):
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _hold(spec, enc):
    """One launch, equal to the plain version on CPU copies."""
    devmod.reset_launches()
    got = EK.backfill(spec, enc)
    torch.cuda.synchronize()
    assert devmod.launches()["evict_backfill"] == 1
    want = EK.backfill_plain(spec, {k: v.cpu() for k, v in enc.items()})
    assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())
    return got


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backfill_crafted_both_placements(case):
    _cuda()
    _, check_pod, arrays = case
    s, n = arrays["sig_mask"].shape
    t = arrays["b_sig"].shape[0]
    fits = backfill_cases.state_bytes(n, s) <= 232448
    assert EK.backfill_placement(n, s, t) == ("shared" if fits else "global")
    _hold(backfill_cases.spec(check_pod), _enc(arrays))
    if fits:
        wide = backfill_cases.widen_nodes(arrays, backfill_cases.global_width(s))
        assert EK.backfill_placement(wide["sig_mask"].shape[1], s, t) == "global"
        _hold(backfill_cases.spec(check_pod), _enc(wide))


def test_backfill_cfg4_per_action_and_fused():
    """cfg4 at 0.1 scale, per-action (K12's dispatch) and fused (the chain's
    backfill stage, under the post-allocate counts)."""
    _cuda()
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import (
        close_session, open_session, run_actions)
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    seen = {}
    real = {n: getattr(EK, n) for n in ("solve_packed", "backfill")}

    def keep(name):
        def fn(spec, enc):
            if spec.kind == "backfill":
                seen.setdefault(name, (spec, {k: v.clone() for k, v in enc.items()}))
            return real[name](spec, enc)
        return fn

    prev = os.environ.get("VOLCANO_TPU_FUSE")
    EK.solve_packed, EK.backfill = keep("solve_packed"), keep("backfill")
    try:
        for fuse in ("0", "1"):
            os.environ["VOLCANO_TPU_FUSE"] = fuse
            cache, _, _, actions, _ = build_config(4, 0.1)
            ssn = open_session(cache, make_tiers(["tpuscore"], *CONFIGS[4].tiers, arguments={
                "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                             "tpuscore.dtype": "float32"}}))
            try:
                run_actions(ssn, list(actions))
            finally:
                close_session(ssn)
    finally:
        EK.solve_packed, EK.backfill = real["solve_packed"], real["backfill"]
        if prev is None:
            os.environ.pop("VOLCANO_TPU_FUSE", None)
        else:
            os.environ["VOLCANO_TPU_FUSE"] = prev
    assert sorted(seen) == ["backfill", "solve_packed"]
    for spec, enc in seen.values():
        got = _hold(spec, enc)
        assert (got >= 0).any()


def test_backfill_graph_replays_changing_inputs():
    """One call captured in a CUDA graph, replayed 20 times, each on new
    inputs of the same shapes copied into the captured tensors."""
    _cuda()
    spec = backfill_cases.spec(True)
    shape = dict(n=2000, s=16, t=1024)

    def inputs(seed):
        return backfill_cases.random_case(seed, shape["n"], shape["s"], shape["t"],
                                          density=0.4, max_pods=(1, 5), start=(0, 4),
                                          pod_share=0.9, real=0.95)

    static = _enc(inputs(100))
    EK.backfill(spec, static)                    # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    devmod.reset_launches()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = EK.backfill(spec, static)
    torch.cuda.current_stream().wait_stream(stream)
    assert devmod.launches()["evict_backfill"] == 1
    for seed in range(20):
        arrays = inputs(seed)
        for k, v in arrays.items():
            static[k].copy_(torch.from_numpy(v))
        graph.replay()
        torch.cuda.synchronize()
        want = EK.backfill_plain(spec, {k: torch.from_numpy(v) for k, v in arrays.items()})
        assert torch.equal(out.cpu(), want), seed
