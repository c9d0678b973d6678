"""K8 scatter_rows (csrc/scatter_rows.cu through ops/replica.py's plans)
against its plain version, ``scatter_rows_plain`` (``index_copy_`` a
buffer), and the plans' life with their owners' standing buffers.

On the card (marked gpu; they skip without one): families of 1 and of 8
buffers, and more than 8 refused; float32, float64, int32, int64 and bool
buffers whose row widths are not multiples of 4 or 16 bytes beside ones
that are (every copy word of the kernel); padded duplicate indices; the
cfg5 replica's node family (N = 10,000) at 1, 16, 100 and 256 rows and the
express lane's five columns; 64 calls back to back at one bucket with
other rows and other values each and no sync between them (a pinned
block written again while its copy is in flight would show); a rebuild of
the buffers between calls, after which the owner's plans are dropped and
a call makes a new one. On the CPU: the replica and the express lane drop
their plans when they rebuild their standing buffers.

This file imports nothing of JAX, so it runs where the card is:

    python -m pytest -m gpu --noconftest tests/test_torch_scatter.py

Tolerance: exact equality (torch.equal on every buffer).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from volcano_tpu_torch import device as devmod
from volcano_tpu_torch.ops import replica as R

N_NODES = 10_000


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")


def _family(rng, n, specs, device="cuda"):
    """{name: buffer [n, *shape]} for specs of (name, dtype, row shape)."""
    out = {}
    for name, dtype, shape in specs:
        if dtype == torch.bool:
            a = rng.random((n,) + shape) < 0.5
        elif dtype.is_floating_point:
            a = rng.standard_normal((n,) + shape) * 100
        else:
            a = rng.integers(-1000, 1000, (n,) + shape)
        out[name] = torch.from_numpy(np.asarray(a)).to(dtype).to(device)
    return out


def _rows(rng, dev, idx):
    """New row values for ``idx`` (numpy, each buffer's own dtype)."""
    vals = {}
    for k, t in dev.items():
        host = t.cpu().numpy()[idx]
        if host.dtype == np.bool_:
            v = ~host
        elif np.issubdtype(host.dtype, np.floating):
            v = host + rng.standard_normal(host.shape)
        else:
            v = host + rng.integers(1, 50, host.shape)
        # duplicates of the padded index carry identical rows
        first = {}
        for i, r in enumerate(idx):
            first.setdefault(int(r), i)
        v[:] = v[[first[int(r)] for r in idx]]
        vals[k] = v.astype(host.dtype)
    return vals


def _hold(dev, idx, vals, plans=None):
    got = {k: t.clone() for k, t in dev.items()}
    want = {k: t.clone() for k, t in dev.items()}
    R.scatter_rows(got, idx, vals, plans=plans if plans is not None else R.ScatterPlans())
    R.scatter_rows_plain(want, idx, vals)
    torch.cuda.synchronize()
    for k in dev:
        assert torch.equal(got[k], want[k]), k


NODE = (("node_idle", torch.float32, (2,)), ("node_used", torch.float32, (2,)),
        ("node_alloc", torch.float32, (2,)), ("node_cnt", torch.int32, ()),
        ("node_max_tasks", torch.int32, ()))
EXPRESS = (("idle", torch.float32, (2,)), ("alloc", torch.float32, (2,)),
           ("cnt", torch.int32, ()), ("ok", torch.bool, ()), ("maxt", torch.int32, ()))
WIDTHS = (("f32x3", torch.float32, (3,)), ("f64x3", torch.float64, (3,)),
          ("i32x5", torch.int32, (5,)), ("b7", torch.bool, (7,)), ("b", torch.bool, ()),
          ("i64x2", torch.int64, (2,)), ("f32x4", torch.float32, (4,)),
          ("f64x5", torch.float64, (5,)))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["one", "eight"])
@pytest.mark.parametrize("dirty", [1, 3, 16, 100])
def test_gpu_scatter_equals_plain_on_every_width(family, dirty):
    """Every copy word (16, 8, 4 bytes and bytes) and group of threads a
    row, padded duplicate indices, families of 1 and 8 buffers."""
    _cuda()
    rng = np.random.default_rng(dirty)
    for spec in ([(s,) for s in WIDTHS] if family == "one" else [WIDTHS]):
        dev = _family(rng, 700, spec)
        rows = sorted(rng.choice(700, dirty, replace=False).tolist())
        idx = R.bucket_pad_rows(rows)
        assert len(idx) >= dirty
        _hold(dev, idx, _rows(rng, dev, idx))


@pytest.mark.gpu
def test_gpu_scatter_refuses_more_than_eight_buffers():
    _cuda()
    rng = np.random.default_rng(0)
    dev = _family(rng, 50, [(f"b{i}", torch.float32, (2,)) for i in range(9)])
    idx = R.bucket_pad_rows([3])
    with pytest.raises(ValueError):
        R.scatter_rows(dev, idx, _rows(rng, dev, idx), plans=R.ScatterPlans())


@pytest.mark.gpu
@pytest.mark.parametrize("what,specs,dirty", [
    ("node", NODE, 1), ("node", NODE, 16), ("node", NODE, 100), ("node", NODE, 256),
    ("express", EXPRESS, 1), ("express", EXPRESS, 16)])
def test_gpu_scatter_equals_plain_on_the_paths_families(what, specs, dirty):
    """The cfg5 replica's node family and the lane's columns at N =
    10,000, launched once each and counted."""
    _cuda()
    rng = np.random.default_rng(dirty)
    dev = _family(rng, N_NODES, specs)
    rows = sorted(rng.choice(N_NODES, dirty, replace=False).tolist())
    idx = R.bucket_pad_rows(rows)
    devmod.reset_launches()
    _hold(dev, idx, _rows(rng, dev, idx))
    assert devmod.launches()["scatter_rows"] == 1


@pytest.mark.gpu
def test_gpu_scatter_back_to_back_at_one_bucket():
    """64 calls at one bucket width through one plan (two pinned blocks
    taking turns), other rows and values each call, no sync between
    them: the end state is the plain version's after the same calls."""
    _cuda()
    rng = np.random.default_rng(5)
    dev = _family(rng, N_NODES, NODE)
    want = {k: t.clone() for k, t in dev.items()}
    plans = R.ScatterPlans()
    for _ in range(64):
        rows = sorted(rng.choice(N_NODES, 13, replace=False).tolist())
        idx = R.bucket_pad_rows(rows)
        vals = _rows(rng, dev, idx)
        R.scatter_rows(dev, idx, vals, plans=plans)
        R.scatter_rows_plain(want, idx, vals)
    assert len(plans) == 1
    torch.cuda.synchronize()
    for k in dev:
        assert torch.equal(dev[k], want[k]), k


@pytest.mark.gpu
def test_gpu_scatter_plans_follow_the_buffers():
    """A rebuild drops the owner's plans (clear); the next call plans
    anew. Buffers replaced under the same names (a dense re-put) or
    rebuilt in another dtype get a new plan even without the drop."""
    _cuda()
    rng = np.random.default_rng(6)
    plans = R.ScatterPlans()
    idx = R.bucket_pad_rows([4, 9])

    def call(dev):
        want = {k: t.clone() for k, t in dev.items()}
        vals = _rows(rng, dev, idx)
        R.scatter_rows(dev, idx, vals, plans=plans)
        R.scatter_rows_plain(want, idx, vals)
        torch.cuda.synchronize()
        for k in dev:
            assert torch.equal(dev[k], want[k]), k
        return plans.get(dev, len(idx))  # the plan the call took

    dev = _family(rng, 300, NODE)
    first = call(dev)
    assert call(dev) is first and len(plans) == 1
    plans.clear()  # the owner's rebuild
    assert len(plans) == 0 and first.handle is None
    dev = _family(rng, 300, NODE)
    second = call(dev)
    assert second is not first and len(plans) == 1
    dev64 = {k: t.double() if t.is_floating_point() else t for k, t in dev.items()}
    third = call(dev64)
    assert third is not second and second.handle is None and len(plans) == 1


class _Sentinel:
    """A stand-in plan that records being closed."""

    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_replica_and_lane_drop_their_plans_on_a_rebuild():
    """The replica's invalidate and wholesale restage, and the express
    lane's wholesale re-put, drop the K8 plans of the buffers they
    replace."""
    from volcano_tpu_torch.bench.clusters import build_config
    from volcano_tpu_torch.express.encode import ExpressState

    cache, *_ = build_config(5, 0.01)
    rep = R.DeviceReplica(cache)
    for rebuild in (rep.invalidate, lambda: rep._rebuild(
            {}, types.SimpleNamespace(node_names=[]), ("cpu", torch.float64), "cold")):
        s = _Sentinel()
        rep._plans._plans["idle"] = {16: s}
        rebuild()
        assert s.closed and len(rep._plans) == 0
    rep.detach()
    lane = ExpressState(cache, device="cpu", dtype=torch.float64)
    s = _Sentinel()
    lane._plans._plans["idle"] = {16: s}
    lane._rebuild()
    lane.stage([])
    assert s.closed and len(lane._plans) == 0
    lane.detach()
