"""The port's rounds solver against the JAX reference, bit for bit.

The same padded encoded arrays (volcano_tpu's encode_session +
pad_encoded, from small bench/clusters.py sessions) go through
volcano_tpu.ops.rounds.solve_rounds and volcano_tpu_torch's solve_rounds
(float64, on the CPU, where every kernel wrapper runs its plain version).
Tolerance: exact equality of assign, round count, tail_placed, full-sweep
count, capped flag, placed-per-round histogram, touched-node mask and the
packed single-fetch result.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.ops import rounds as jrounds
from volcano_tpu.ops import solver as jsolver
from volcano_tpu.ops.encoder import encode_session
from volcano_tpu.scheduler.framework import close_session, open_session
import volcano_tpu.scheduler.actions  # noqa: F401  (register actions)

from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import solver as tsolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def encoded_arrays(cfg: int, scale: float):
    """(padded float64 arrays, JAX spec) of a small cfg session."""
    cache, _, tpu_tiers, _, _ = jclusters.build_config(cfg, scale)
    ssn = open_session(cache, tpu_tiers)
    try:
        enc = encode_session(ssn, allow_residue=True)
    finally:
        close_session(ssn)
    arrays = jsolver.pad_encoded(enc)
    arrays = {k: v for k, v in arrays.items() if k not in jsolver._ROUNDS_SKIP}
    return arrays, enc.spec


def contended_arrays(seed: int = 11):
    """cfg5's default conf on a tight, non-dyadic cluster: many rounds,
    dirty-column rescoring, rollbacks, and balanced/least-requested
    scores whose products are inexact."""
    import random

    from volcano_tpu.api import objects
    from volcano_tpu.scheduler.util.test_utils import (
        build_node, build_pod, build_pod_group, build_queue,
        build_resource_list_with_pods)

    rng = random.Random(seed)
    cache = jclusters.make_cache()
    cache.add_queue(build_queue("default"))
    for n in range(48):
        cache.add_node(build_node(f"node-{n:03d}", build_resource_list_with_pods(
            rng.choice(["6", "12", "7500m"]), rng.choice(["10Gi", "24Gi"]),
            pods=rng.choice([8, 64]))))
    for g in range(160):
        pg = f"job-{g:04d}"
        cache.add_pod_group(build_pod_group(pg, namespace="bench", min_member=3))
        for i in range(4):
            cache.add_pod(build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": f"{rng.choice([300, 700, 1100, 1900])}m",
                 "memory": rng.choice(["300Mi", "700Mi", "1500Mi"])}, pg))
    tiers = jclusters.make_tiers(["tpuscore"], *jclusters.DEFAULT_TIERS)
    ssn = open_session(cache, tiers)
    try:
        enc = encode_session(ssn, allow_residue=True)
    finally:
        close_session(ssn)
    arrays = jsolver.pad_encoded(enc)
    arrays = {k: v for k, v in arrays.items() if k not in jsolver._ROUNDS_SKIP}
    return arrays, enc.spec


@pytest.mark.parametrize("window", [0, 8], ids=["full", "window"])
def test_contended_default_conf_matches(window):
    arrays, jspec = contended_arrays()
    jspec = jspec._replace(window_k=window, dirty_k=16 if window else 0)
    raw_j, raw_t, packed_j, packed_t = run_both(arrays, jspec)
    assert_same(raw_j, raw_t, packed_j, packed_t)
    assert raw_t[1] >= 3, raw_t[1]


def port_spec(jspec):
    return tkernels.SolveSpec(**jspec._asdict())


def run_both(arrays, jspec):
    raw_j = jrounds.solve_rounds(jspec, {k: jnp.asarray(v) for k, v in arrays.items()})
    packed_j = np.asarray(jrounds.pack_result(
        {"node_idle": arrays["node_idle"]}, raw_j))
    enc_t = tsolver.from_numpy_encoded(arrays, device="cpu", dtype=torch.float64)
    raw_t = trounds.solve_rounds(port_spec(jspec), enc_t)
    packed_t = trounds.pack_result(enc_t, raw_t).numpy()
    return raw_j, raw_t, packed_j, packed_t


def assert_same(raw_j, raw_t, packed_j, packed_t):
    (a_j, r_j, tp_j, fs_j, cap_j, hist_j, touch_j) = raw_j
    (a_t, r_t, tp_t, fs_t, cap_t, hist_t, touch_t) = raw_t
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert r_t == int(r_j)
    assert tp_t == int(tp_j)
    assert fs_t == int(fs_j)
    assert cap_t == bool(cap_j)
    np.testing.assert_array_equal(np.asarray(hist_t), np.asarray(hist_j))
    np.testing.assert_array_equal(touch_t.numpy(), np.asarray(touch_j))
    assert packed_t.dtype == packed_j.dtype
    np.testing.assert_array_equal(packed_t, packed_j)


CASES = [
    # (cfg, scale): cfg2 binpack + GPU scalar, cfg3 ten queues, cfg5 the
    # full default conf, cfg6 exclusion groups + residue
    (2, 0.04), (3, 0.02), (5, 0.01), (6, 0.06),
]


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "full"])
@pytest.mark.parametrize("cfg,scale", CASES, ids=[f"cfg{c}" for c, _ in CASES])
def test_solve_rounds_matches_reference(cfg, scale, windowed):
    arrays, jspec = encoded_arrays(cfg, scale)
    if windowed:
        wf = jsolver._window_fields(arrays)
        assert wf == tsolver._window_fields(arrays)
        jspec = jspec._replace(window_k=wf["window_k"], dirty_k=wf["dirty_k"])
        if wf["window_k"] == 0:
            # force a narrow window so the windowed path runs at this size
            n = arrays["node_idle"].shape[0]
            k = max(1, n // 4)
            jspec = jspec._replace(window_k=k, dirty_k=max(1, n // 2))
    else:
        jspec = jspec._replace(window_k=0, dirty_k=0)
    raw_j, raw_t, packed_j, packed_t = run_both(arrays, jspec)
    assert_same(raw_j, raw_t, packed_j, packed_t)
    assert int((raw_t[0] >= 0).sum()) > 0


def test_straggler_rounds_and_tail_pass_match():
    """A diminishing-returns floor above most rounds' yield: the solve
    caps, runs straggler rounds, then the sequential tail pass."""
    arrays, jspec = encoded_arrays(6, 0.06)
    jspec = jspec._replace(round_min_progress=40, straggler_rounds=2,
                           window_k=0, dirty_k=0)
    raw_j, raw_t, packed_j, packed_t = run_both(arrays, jspec)
    assert raw_t[4], "the solve must reach the capped exit"
    assert raw_t[2] > 0, "the tail pass must place something"
    assert_same(raw_j, raw_t, packed_j, packed_t)


def test_packed_layout_and_pad_match_reference():
    cache, _, tpu_tiers, _, _ = jclusters.build_config(3, 0.02)
    ssn = open_session(cache, tpu_tiers)
    try:
        enc = encode_session(ssn, allow_residue=True)
    finally:
        close_session(ssn)
    a_j = jsolver.pad_encoded(enc)
    a_t = tsolver.pad_encoded(enc)
    assert sorted(a_j) == sorted(a_t)
    for k in a_j:
        np.testing.assert_array_equal(np.asarray(a_t[k]), np.asarray(a_j[k]))
    layout_j, bufs_j = jsolver._pack(a_j)
    layout_t, bufs_t = tsolver._pack(a_t)
    assert layout_t == layout_j
    for k in bufs_j:
        np.testing.assert_array_equal(bufs_t[k], bufs_j[k])
    staged = tsolver.from_numpy_encoded(a_t, device="cpu", dtype=torch.float64)
    unpacked_j = jrounds.unpack_layout(layout_j, {k: jnp.asarray(v) for k, v in bufs_j.items()})
    for k, v in unpacked_j.items():
        np.testing.assert_array_equal(staged[k].numpy(), np.asarray(v))
