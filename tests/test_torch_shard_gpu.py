"""K16 on a CUDA card: K16a (``probe_refresh``: 16 launches of K1) and K16b
(``probe_evict_fold``, csrc/probe_evict_fold.cu) against their plain
versions, on the rounds encodes the port's own sessions prepare.

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_shard_gpu.py

Without a card its tests skip. Tolerance: exact equality (torch.equal) of
K16a's scalar and of K16b's int32 count.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import shard
from volcano_tpu_torch.ops.solver import _NODE_AXIS


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _prepared(cfg, scale, dtype):
    from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    cache, *_ = build_config(cfg, scale)
    tiers = make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": "rounds", "tpuscore.device": "cuda",
                     "tpuscore.dtype": dtype}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    return prep["spec"], prep["arrays"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("cfg,scale", [(2, 0.2), (5, 0.1), (6, 0.2)])
def test_probes_equal_plain_on_the_card(cfg, scale, shards, dtype):
    _cuda()
    spec, arrays = _prepared(cfg, scale, dtype)
    _, enc, fold = shard.stage_probe(arrays, _NODE_AXIS, shards,
                                     device="cuda", dtype=dtype)
    devmod.reset_launches()
    got = shard.probe_refresh(spec, enc)
    torch.cuda.synchronize()
    assert devmod.launches()["score_block"] == shard._PROBE_REPS
    want = shard.probe_refresh_plain(spec, enc)
    assert torch.equal(got, want), (got.item(), want.item())
    devmod.reset_launches()
    count = shard.probe_evict_fold(*fold)
    torch.cuda.synchronize()
    assert devmod.launches()["probe_evict_fold"] == 1
    assert torch.equal(count, shard.probe_evict_fold_plain(*fold))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cfg,scale", [(2, 0.2), (5, 0.1), (6, 0.2)])
def test_full_refresh_equals_plain_on_the_card(cfg, scale, dtype):
    """K1's full-refresh entry (the one K16a repeats) on one shard's slice:
    every cell equal to the plain version's, by its bits, with the plugin
    weights built by the entry and passed in."""
    from volcano_tpu_torch.bench.round_cases import bit_equal
    from volcano_tpu_torch.ops import kernels

    _cuda()
    spec, arrays = _prepared(cfg, scale, dtype)
    _, enc, _ = shard.stage_probe(arrays, _NODE_AXIS, 3, device="cuda", dtype=dtype)
    occ = enc.get("excl_occ0") if spec.use_exclusion else None
    args = (spec, enc, enc["node_idle"], enc["node_used"], enc["node_cnt"], occ)
    want = kernels.score_block_plain(*args)
    for weights in (None, kernels.score_weights(enc)):
        got = torch.full_like(want, 7.0)
        devmod.reset_launches()
        kernels.score_block(*args, got, weights=weights)
        torch.cuda.synchronize()
        assert devmod.launches()["score_block"] == 1
        assert bit_equal(got, want), int((got != want).sum())


def _fold(w, v, r, seed, dtype):
    rng = np.random.default_rng(seed)
    q = 5
    args = (rng.uniform(100.0, 4000.0, (w, v, r)),
            rng.integers(0, q, (w, v)).astype(np.int32), None,
            rng.uniform(1e4, 1e6, (q, r)), rng.uniform(0.0, 2e5, (q, r)),
            np.full(r, 0.01))
    sq = args[1][:, :, None] == args[1][:, None, :]
    args = args[:2] + (sq,) + args[3:]
    dt = torch.float64 if dtype == "float64" else torch.float32
    return [torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt if a.dtype.kind == "f" else None) for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("v", shard.FOLD_WIDTHS)
@pytest.mark.parametrize("r", shard.FOLD_RESOURCES)
def test_fold_every_instantiation_equals_plain(v, r, dtype):
    """Every (V, R) the kernel is built for, on a ragged row count and
    floors below the allocations (non-zero counts)."""
    _cuda()
    args = _fold(1000 + 37, v, r, seed=v * 10 + r, dtype=dtype)
    got = shard.probe_evict_fold(*args)
    want = shard.probe_evict_fold_plain(*args)
    assert int(want) > 0
    assert torch.equal(got, want), (int(got), int(want))


@pytest.mark.gpu
def test_fold_ties_and_near_ties_on_the_card():
    """The floor exactly at cur - req, inside and outside eps, and
    cur == req (the crafted rows of tests/test_torch_shard.py)."""
    _cuda()
    left = [750.0, 1500.0]
    floors = [left, [750.004, 1500.004], [749.996, 1499.996],
              [750.02, 1500.02], [749.98, 1499.98], [750.0, 1500.02], [0.0, 0.0]]
    req = [[[250.0, 500.0], [250.0, 500.0]]] * 6 + [[[1000.0, 2000.0], [250.0, 500.0]]]
    w = len(floors)
    for dt in (torch.float32, torch.float64):
        args = [torch.tensor(req, dtype=dt),
                torch.arange(w, dtype=torch.int32)[:, None].repeat(1, 2).contiguous(),
                torch.ones((w, 2, 2), dtype=torch.bool),
                torch.tensor([[1000.0, 2000.0]] * w, dtype=dt),
                torch.tensor(floors, dtype=dt),
                torch.tensor([0.01, 0.01], dtype=dt)]
        want = shard.probe_evict_fold_plain(*args, reps=1)
        assert int(want) == 5
        got = shard.probe_evict_fold(*(a.cuda() for a in args), reps=1)
        assert int(got) == 5
        full = shard.probe_evict_fold(*(a.cuda() for a in args))
        assert torch.equal(full.cpu(), shard.probe_evict_fold_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("reps", [1, 16])
@pytest.mark.parametrize("w", [1, 15, 16 * 40 + 7, 4063])
def test_fold_ragged_rows_and_reps(w, reps, dtype):
    """Row counts that are not a multiple of a block's rows (16 at 16
    reps, 256 at one), at one and at 16 reps: equal to the plain version,
    one launch a call."""
    _cuda()
    args = _fold(w, 8, 2, seed=w + reps, dtype=dtype)
    devmod.reset_launches()
    got = shard.probe_evict_fold(*args, reps=reps)
    torch.cuda.synchronize()
    assert devmod.launches()["probe_evict_fold"] == 1
    want = shard.probe_evict_fold_plain(*args, reps=reps)
    assert torch.equal(got, want), (int(got), int(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fold_in_a_cuda_graph(dtype):
    """The factors are built once (outside the capture), so a probe is
    captured whole; 20 replays on changing requests, each equal to the
    plain version."""
    _cuda()
    args = _fold(2000 + 5, 8, 2, seed=3, dtype=dtype)
    shard.probe_evict_fold(*args)                 # factors and library, once
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    devmod.reset_launches()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = shard.probe_evict_fold(*args)
    torch.cuda.current_stream().wait_stream(stream)
    assert devmod.launches()["probe_evict_fold"] == 1
    for seed in range(20):
        fresh = _fold(2000 + 5, 8, 2, seed=100 + seed, dtype=dtype)
        for a, b in zip(args, fresh):
            a.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, shard.probe_evict_fold_plain(*args)), seed
