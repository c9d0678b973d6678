"""K16, the mesh bench's per-device stage probes (volcano_tpu_torch/ops/shard.py)
against the jitted JAX programs of volcano_tpu/ops/shard.py, and the shard
arithmetic against the JAX helpers.

- K16a ``probe_refresh`` (16 x K1 over one shard's node slice, Σ sc[0, 0])
  against ``_probe_refresh`` on the rounds encodes of small cfg2, cfg5 and
  cfg6 sessions (cfg6 runs the exclusion groups), each package building
  its own cluster, at one shard and at three (a node extent that is not a
  multiple of the shards, so the slice comes from the padded axis), in
  float64 and with the arrays cast to float32: equal bit for bit.
- K16b ``probe_evict_fold`` (its plain version on the CPU) against
  ``_probe_evict_fold`` on the probe's own seeded inputs, on seeded inputs
  whose counts are not 0, and on crafted exact ties and near-ties inside
  eps: the int count equal. In float32 the reference runs as the bench runs
  it, without x64. In float64 (x64 on) the reference's carry does not
  trace: its ``jnp.sum`` of int32 widens to int64 under x64 and the int32
  fori_loop carry refuses it (pinned below as a reference fault); the
  comparison there runs the reference with ``jnp.sum`` keeping int32, the
  one change the count needs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import shard as jshard
from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import shard as tshard
from volcano_tpu_torch.ops.solver import _NODE_AXIS as T_NODE_AXIS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_prep(cfg, scale):
    from volcano_tpu.bench.clusters import CONFIGS, make_cache, make_tiers
    from volcano_tpu.scheduler.framework import close_session, open_session
    import volcano_tpu.scheduler.actions  # noqa: F401
    import volcano_tpu.scheduler.plugins  # noqa: F401

    bc = CONFIGS[cfg]
    cache = make_cache()
    bc.populate(cache, scale)
    tiers = make_tiers(["tpuscore"], *bc.tiers,
                       arguments={"tpuscore": {"tpuscore.mode": "rounds"}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    return prep["spec"], {k: np.asarray(v) for k, v in prep["arrays"].items()}


def _port_prep(cfg, scale):
    from volcano_tpu_torch.bench.clusters import CONFIGS, make_cache, make_tiers
    from volcano_tpu_torch.scheduler.framework import close_session, open_session
    import volcano_tpu_torch.scheduler.actions  # noqa: F401
    import volcano_tpu_torch.scheduler.plugins  # noqa: F401

    bc = CONFIGS[cfg]
    cache = make_cache()
    bc.populate(cache, scale)
    tiers = make_tiers(["tpuscore"], *bc.tiers, arguments={"tpuscore": {
        "tpuscore.mode": "rounds", "tpuscore.device": "cpu",
        "tpuscore.dtype": "float64"}})
    ssn = open_session(cache, tiers)
    try:
        prep = ssn.batch_allocator._prepare(ssn)
    finally:
        close_session(ssn)
    return prep["spec"], prep["arrays"]


def _cast(arrays, dt):
    return {k: (v.astype(dt) if v.dtype.kind == "f" else v)
            for k, v in arrays.items()}


_PREPS = {}


def _preps(cfg, scale):
    if (cfg, scale) not in _PREPS:
        _PREPS[cfg, scale] = (_jax_prep(cfg, scale), _port_prep(cfg, scale))
    return _PREPS[cfg, scale]


@pytest.mark.parametrize("cfg,scale", [(2, 0.05), (5, 0.01), (6, 0.05)])
def test_port_prepare_keeps_the_reference_host_arrays(cfg, scale):
    """The port's rounds prepare hands the probe the same padded host
    arrays the reference's ``prep["arrays"]`` holds."""
    (_, ja), (_, ta) = _preps(cfg, scale)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert np.array_equal(ja[k], ta[k]), k
        assert ja[k].dtype == ta[k].dtype, k


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("cfg,scale", [(2, 0.05), (5, 0.01), (6, 0.05)])
def test_probe_refresh_equals_jax(cfg, scale, shards, dt):
    (jspec, ja), (tspec, _) = _preps(cfg, scale)
    arrays = _cast(ja, dt)
    width, enc_np, _ = tshard.probe_inputs(arrays, T_NODE_AXIS, shards)
    want = jshard._probe_refresh(jspec, enc_np)
    _, enc, _ = tshard.stage_probe(arrays, T_NODE_AXIS, shards, device="cpu")
    assert enc["node_idle"].dtype == (torch.float64 if dt == np.float64
                                      else torch.float32)
    devmod.reset_launches()
    got = tshard.probe_refresh(tspec, enc)
    plain = tshard.probe_refresh_plain(tspec, enc)
    assert devmod.launches()["score_block"] == 0  # CPU tensors: plain path
    assert np.asarray(want).dtype == dt
    assert got.item() == float(want) == plain.item()
    assert width == enc["node_idle"].shape[0]
    if cfg == 6:
        assert tspec.use_exclusion


def _fold_inputs(w, v, seed=7, des_lo=1e4, des_hi=1e6, q=4):
    rng = np.random.default_rng(seed)
    vic_req = rng.uniform(100.0, 4000.0, (w, v, 2))
    vic_queue = rng.integers(0, q, (w, v)).astype(np.int32)
    samequeue = vic_queue[:, :, None] == vic_queue[:, None, :]
    queue_alloc = rng.uniform(1e4, 1e6, (q, 2))
    queue_deserved = rng.uniform(des_lo, des_hi, (q, 2))
    eps = np.asarray([0.01, 0.01])
    return vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps


def _jax_fold(args, dt, monkeypatch):
    """The reference's count, its program freshly jitted: float32 without
    x64 (the bench's setting), float64 under x64 with int32 sums."""
    fn = jax.jit(jshard._probe_evict_fold.__wrapped__)
    args = [a.astype(dt) if a.dtype.kind == "f" else a for a in args]
    if dt == np.float32:
        with jax.enable_x64(False):
            return int(fn(*args)), args
    orig = jnp.sum

    def sum_int32(x, *a, **k):
        if getattr(x, "dtype", None) == jnp.int32 and "dtype" not in k:
            k["dtype"] = jnp.int32
        return orig(x, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(jnp, "sum", sum_int32)
        return int(fn(*args)), args


def _port_fold(args, plain=False):
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    fn = tshard.probe_evict_fold_plain if plain else tshard.probe_evict_fold
    out = fn(*ts)
    assert out.dtype == torch.int32 and out.dim() == 0
    return int(out)


def test_reference_fold_fails_to_trace_under_x64():
    """Reference fault: with x64 on (float64 state), the reference's
    ``jnp.sum(... .astype(int32))`` widens to int64 and the int32 carry
    of its rep loop refuses it. The port counts in int32 at every dtype."""
    args = _fold_inputs(9, 4)
    with pytest.raises(TypeError, match="carry"):
        jax.jit(jshard._probe_evict_fold.__wrapped__)(*args)
    assert _port_fold(args) >= 0


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("w,v", [(125, 8), (997, 8), (1000, 8),
                                 (125, 16), (997, 16), (1000, 16)])
def test_probe_evict_fold_equals_jax_on_probe_inputs(w, v, dt, monkeypatch):
    want, args = _jax_fold(_fold_inputs(w, v), dt, monkeypatch)
    assert _port_fold(args) == want
    assert _port_fold(args, plain=True) == want


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_probe_evict_fold_equals_jax_with_counts(seed, dt, monkeypatch):
    """Deserved floors drawn below the allocations, so victims both go
    and fit, and later victims of a queue see its current drop."""
    args = _fold_inputs(301, 8, seed=seed, des_lo=0.0, des_hi=2e5)
    want, args = _jax_fold(args, dt, monkeypatch)
    assert want > 0
    assert _port_fold(args) == want


def _crafted():
    """One queue per row (allocation 1000/2000), two victims a row. Rows
    0-5: both victims request 250/500, so the first sees cur - req =
    750/1500 exactly and the row's floor sits at that value (exact tie),
    0.004 above and below it (inside eps), 0.02 above (outside), 0.02
    below, and exact on one dimension but 0.02 above on the other. Row 6:
    the first victim requests the whole allocation (cur == req on every
    dimension: not all below, so it goes) against a floor of 0."""
    left = [750.0, 1500.0]
    floors = [left, [750.004, 1500.004], [749.996, 1499.996],
              [750.02, 1500.02], [749.98, 1499.98], [750.0, 1500.02],
              [0.0, 0.0]]
    req = [[[250.0, 500.0], [250.0, 500.0]]] * 6 \
        + [[[1000.0, 2000.0], [250.0, 500.0]]]
    w = len(floors)
    vic_req = np.asarray(req)                                  # [W, 2, 2]
    vic_queue = np.repeat(np.arange(w, dtype=np.int32)[:, None], 2, axis=1)
    samequeue = np.ones((w, 2, 2), bool)
    queue_alloc = np.repeat(np.asarray([[1000.0, 2000.0]]), w, axis=0)
    queue_deserved = np.asarray(floors)
    eps = np.asarray([0.01, 0.01])
    return vic_req, vic_queue, samequeue, queue_alloc, queue_deserved, eps


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_probe_evict_fold_ties_and_near_ties(dt, monkeypatch):
    args = _crafted()
    want, cast = _jax_fold(args, dt, monkeypatch)
    assert _port_fold(cast) == want
    # rep 0 (factor exactly 1), by hand: the first victim fits in rows 0,
    # 1, 2, 4 and 6, not in 3 and 5; every second victim then sees cur
    # lowered by the first and fits nowhere (row 6's does not even go)
    one = tshard.probe_evict_fold_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in cast), reps=1)
    assert int(one) == 5
    if dt == np.float32:  # every rep's factor is exactly 1
        assert want == 16 * 5


def test_probe_factors_round_in_the_dtype():
    f32 = tshard.probe_factors(16, torch.float32)
    f64 = tshard.probe_factors(16, torch.float64)
    assert f32 == [1.0] * 16
    assert f64 == [1.0 + i * 1e-12 for i in range(16)]
    assert len(set(f64)) == 16


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("extent", [1, 5, 8, 100, 997, 1000, 50000])
def test_shard_arithmetic_equals_jax(extent, shards):
    a = np.arange(extent * 3, dtype=np.float64).reshape(3, extent)
    for axis, arr in ((1, a), (0, np.ascontiguousarray(a.T))):
        got = tshard.pad_axis_multiple(arr, axis, shards)
        want = jshard.pad_axis_multiple(arr, axis, shards)
        assert got.shape == want.shape and np.array_equal(got, want)
        assert tshard.per_shard(got.shape[axis], shards) == \
            jshard.per_shard(want.shape[axis], shards)
    assert tshard.device_count(None) == jshard.device_count(None) == 1


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_probe_per_device_stage_ms_reads_the_reference_widths(shards):
    """The probe on the CPU returns a positive float, and its inputs have
    the widths the reference's probe slices: every node-axis array at
    N/d of the padded axis, the victim slice [N/d, 8, 2]."""
    (jspec, ja), (tspec, ta) = _preps(6, 0.05)
    ms = tshard.probe_per_device_stage_ms(tspec, ta, T_NODE_AXIS, shards,
                                          iters=1, device="cpu")
    assert isinstance(ms, float) and ms > 0
    width, enc, fold = tshard.probe_inputs(ta, T_NODE_AXIS, shards)
    n = ja["node_idle"].shape[0]
    want = jshard.per_shard(jshard.pad_axis_multiple(
        np.zeros(n, np.int8), 0, shards).shape[0], shards)
    assert width == want
    for k, axis in T_NODE_AXIS.items():
        if k in ja:
            assert enc[k].shape[axis] == want, k
            padded = jshard.pad_axis_multiple(ja[k], axis, shards)
            assert np.array_equal(enc[k], np.take(padded, range(want), axis=axis)), k
    assert fold[0].shape == (want, 8, 2) and fold[2].shape == (want, 8, 8)
