"""The order of equal-valued and signed-zero scores: the port against the
JAX package, bit for bit.

The JAX package orders a score row two ways. ``lax.top_k`` (the rounds
window, volcano_tpu/ops/rounds.py:754, and the express window,
volcano_tpu/express/place.py:128) sorts by IEEE 754's total order, so
``+0.0`` comes ahead of ``-0.0``; ``jnp.argsort(-x, stable=True)`` (the
full-width nomination, rounds.py:276) compares the values, so ``+0.0`` and
``-0.0`` tie and keep their index order. The port's plain versions must
give each order exactly: ``window_topk_plain`` the first, the port's
``_nominate_full`` the second, and the express lane's plain solve the
JAX lane's result on a batch whose window holds a signed-zero pair.

Every row is made with numpy and fed to the jitted JAX function and to the
port on CPU tensors, in float32 and float64. Values are compared by their
bits, so a ``-0.0`` where ``+0.0`` belongs fails. NaN and subnormal
floats lie outside the domain: the scores never hold one.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from volcano_tpu.express import place as jplace
from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds

from volcano_tpu_torch.express import place as tplace
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as tk

from test_torch_express import express_case

DTYPES = [np.float32, np.float64]
INF = np.inf


def _neighbours(dt):
    """Last-bit neighbours of 1.0 and of the smallest normal float, beside
    signed zeros (subnormals lie outside the domain: see
    test_reference_argsort_flushes_subnormals)."""
    one, zero = dt(1.0), dt(0.0)
    tiny = np.finfo(dt).tiny
    up, down = np.nextafter(one, dt(2.0)), np.nextafter(one, zero)
    return [one, up, down, one, tiny, -tiny, -zero, zero, up,
            np.nextafter(tiny, one), -zero, -INF, zero, down, -tiny, one]


def crafted_rows(dt):
    """[16, 16] rows: signed zeros either way round, all tied, all -inf,
    -inf ties ahead of a feasible tail, last-bit neighbours."""
    rows = [
        [-0.0, 0.0, -0.0, 0.0, 1.0, -INF] + [-INF] * 10,
        [0.0, -0.0, 0.0, -0.0, -INF, 1.0] + [-0.0, 0.0] * 5,
        [-0.0] * 8 + [0.0] * 8,
        [0.0] * 8 + [-0.0] * 8,
        [-0.0, 0.0] * 8,
        [3.0] * 16,
        [-INF] * 16,
        [-INF] * 12 + [1.0, -0.0, 0.0, 1.0],
        [-INF] * 4 + [-0.0] * 6 + [0.0] * 6,
        _neighbours(dt),
        [2.5, -0.0, 2.5, 0.0, -1.0, -0.0, 0.0, 2.5, -1.0, 0.0, -0.0, 7.0,
         -INF, 0.0, -0.0, 2.5],
    ]
    rng = np.random.default_rng(7)
    for _ in range(5):
        rows.append(rng.choice([-0.0, 0.0, 1.0, -INF], 16))
    return np.asarray(rows, dtype=dt)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@functools.lru_cache(maxsize=None)
def _jit_top_k(k):
    return jax.jit(lambda v: lax.top_k(v, k))


_jit_argsort = jax.jit(lambda v: jnp.argsort(-v, axis=-1, stable=True))


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_window_topk_plain_orders_signed_zeros_as_lax_top_k(dt, k):
    rows = crafted_rows(dt)
    ref_s, ref_i = _jit_top_k(k)(jnp.asarray(rows))
    got_s, got_i = tk.window_topk_plain(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(ref_s))
    assert got_s.dtype == torch.from_numpy(rows).dtype
    # the first row is the one the order fault was found on
    if k == 16:
        assert got_i[0, :6].tolist() == [4, 1, 3, 0, 2, 5]


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_window_topk_wrapper_takes_the_plain_order_on_cpu(dt):
    rows = crafted_rows(dt)
    got = tk.window_topk(torch.from_numpy(rows), 5)
    want = tk.window_topk_plain(torch.from_numpy(rows), 5)
    assert torch.equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0].numpy()))


def test_order_key_is_the_total_order():
    """order_key ranks every float as IEEE 754's total order does."""
    for dt in DTYPES:
        vals = np.asarray(sorted(set(_neighbours(dt)) | {dt(-INF), dt(INF),
                                                          dt(-3.5), dt(1e30)}),
                          dtype=dt)
        vals = np.concatenate([vals, -np.asarray(vals)]).astype(dt)
        key = tk.order_key(torch.from_numpy(vals)).numpy()
        total = sorted(range(len(vals)),
                       key=lambda i: (float(vals[i]), np.signbit(vals[i]) == 0))
        assert sorted(range(len(vals)), key=lambda i: key[i]) == total


def _spec(mod):
    return mod.SolveSpec(job_order_keys=("priority", "gang"),
                         use_drf_ns_order=False, use_prop_queue_order=False,
                         use_prop_overused=True, check_pod_count=False,
                         use_binpack=False, use_nodeorder=False)


def _nominate_inputs(dt):
    rows = crafted_rows(dt)
    k, n = rows.shape
    rng = np.random.default_rng(3)
    enc = {
        "eps": np.array([10.0, 10.0 * 2 ** 20], dt),
        "cls_req": np.stack([rng.choice([100.0, 500.0], k),
                             rng.choice([1.0, 4.0], k) * 2 ** 30], 1).astype(dt),
        "cls_has_pod": np.ones(k, bool),
    }
    idle = np.stack([rng.choice([1000.0, 4000.0], n),
                     rng.choice([8.0, 16.0], n) * 2 ** 30], 1).astype(dt)
    cnt = np.zeros(n, np.int32)
    return rows, enc, idle, cnt


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_nominate_full_orders_signed_zeros_as_jnp_argsort(dt):
    """The full-width order ties +0.0 with -0.0, as the stable argsort of
    the negated row does, while the window puts +0.0 first: the port keeps
    both orders."""
    rows, enc, idle, cnt = _nominate_inputs(dt)
    t_cap = 64
    ref = jax.jit(functools.partial(jrounds._nominate_full, _spec(jkernels),
                                    t_cap=t_cap))(
        {k: jnp.asarray(v) for k, v in enc.items()}, jnp.asarray(rows),
        jnp.asarray(idle), jnp.asarray(cnt), None)
    got = trounds._nominate_full(
        _spec(tkernels), {k: torch.from_numpy(v) for k, v in enc.items()},
        torch.from_numpy(rows), torch.from_numpy(idle), torch.from_numpy(cnt),
        None, t_cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    order = np.asarray(_jit_argsort(jnp.asarray(rows)))
    np.testing.assert_array_equal(got[0].numpy(), order)
    assert got[0][0, :6].tolist() == [4, 0, 1, 2, 3, 5]
    top = np.asarray(_jit_top_k(16)(jnp.asarray(rows))[1])
    assert (top != order).any()


def _signed(fused, where, arange):
    """fused_scores with every column but each 32nd negated: a zero score
    there becomes -0.0, so a row of equal shapes holds a few +0.0 among
    many -0.0."""
    def fn(*args, **kw):
        s = fused(*args, **kw)
        neg = arange(s.shape[-1]) % 32 != 0
        return where(neg, -s, s)
    return fn


@pytest.mark.parametrize("window_k", [16, 64])
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_express_plain_matches_jax_on_a_signed_zero_window(monkeypatch, dt,
                                                           window_k):
    spec_kw, arrays = express_case(1, 200, 16, 12, window_k)
    weights = arrays[-1]
    arrays = arrays[:-1] + (np.zeros_like(weights),)     # every score 0
    arrays = tuple(a.astype(dt) if a.dtype == np.float64 else a
                   for a in arrays)
    monkeypatch.setattr(jplace, "fused_scores",
                        _signed(jplace.fused_scores, jnp.where, jnp.arange))
    monkeypatch.setattr(tplace, "fused_scores",
                        _signed(tplace.fused_scores, torch.where,
                                torch.arange))
    # the window the JAX lane sorts holds +0.0 and -0.0, and its order is
    # not the index order
    ok = arrays[3]
    scores0 = np.where(np.arange(200) % 32 != 0, -0.0, 0.0).astype(dt)
    scores0 = np.where(ok, scores0, -np.inf).astype(dt)
    top_s, top_i = _jit_top_k(window_k)(jnp.asarray(scores0[None]))
    top_s, top_i = np.asarray(top_s)[0], np.asarray(top_i)[0]
    assert np.signbit(top_s).any() and not np.signbit(top_s).all()
    assert (top_i != np.flatnonzero(ok)[:window_k]).any()
    solve = jax.jit(jplace.solve_express.__wrapped__, static_argnames=("spec",))
    jout = np.asarray(solve(jplace.ExpressSpec(**spec_kw),
                            *[jnp.asarray(a) for a in arrays]))
    tout = tplace.solve_express_plain(
        tplace.ExpressSpec(**spec_kw),
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]).numpy()
    np.testing.assert_array_equal(tout, jout)
    assert (tout[:spec_kw["tb"]] >= 0).sum() > 0


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_reference_argsort_flushes_subnormals(dt):
    """Pins why subnormal scores lie outside the domain: the JAX package's
    stable argsort on its CPU backend ties a subnormal with +-0.0 (flushed
    to zero), while lax.top_k and torch order it above +0.0. The scores are
    sums of floored and weighted terms and are never subnormal."""
    sub = np.nextafter(dt(0.0), dt(1.0))
    row = np.asarray([[0.0, sub, -0.0, -sub]], dtype=dt)
    assert np.asarray(_jit_argsort(jnp.asarray(row))).tolist() == [[0, 1, 2, 3]]
    assert np.asarray(_jit_top_k(4)(jnp.asarray(row))[1]).tolist() == [[1, 0, 2, 3]]
    assert tk.window_topk_plain(torch.from_numpy(row), 4)[1].tolist() == [[1, 0, 2, 3]]
