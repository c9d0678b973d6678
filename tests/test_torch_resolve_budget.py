"""K4 (``resolve_prefix``) and K5 (``queue_budget``) of the port against
the JAX package's ``_resolve`` and ``_queue_budget``, jitted.

The inputs are made at the round's level with numpy from a seed
(volcano_tpu_torch/bench/round_cases.py ``resolve_inputs``,
``budget_inputs``) and fed to the JAX function (float64, CPU) and to the
port on CPU tensors: to ``rounds._resolve`` / ``rounds._queue_budget``, and
to the kernels' plain versions on the arguments the round makes for them
(``resolve_args``, ``budget_args``), the functions the CUDA kernels are
held against on the card (tests/test_torch_rounds_gpu.py, chip_smoke.py).
K5 is held both ways the port reaches it: with the round's job order, and
with the jobs read off the task axis. Tolerance: exact equality.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volcano_tpu.ops import kernels as jkernels
from volcano_tpu.ops import rounds as jrounds

from volcano_tpu_torch.bench import round_cases as RC
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds as trounds
from volcano_tpu_torch.ops import rounds_kernels as tk


def _spec(mod, check_pod):
    return mod.SolveSpec(job_order_keys=("priority", "gang"), use_drf_ns_order=False,
                         use_prop_queue_order=False, use_prop_overused=True,
                         check_pod_count=check_pod, use_binpack=False,
                         use_nodeorder=False, use_exclusion=False)


@functools.lru_cache(maxsize=None)
def _jit_resolve(check_pod):
    return jax.jit(functools.partial(jrounds._resolve, _spec(jkernels, check_pod)))


_jit_budget = jax.jit(jrounds._queue_budget)


def _torch(enc):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in enc.items()}


def _jax(enc):
    return {k: jnp.asarray(v) for k, v in enc.items()}


def _resolve_both(inp, check_pod):
    enc, idle, cnt, choice, rank = inp
    ref = np.asarray(_jit_resolve(check_pod)(
        _jax(enc), jnp.asarray(idle), jnp.asarray(cnt), jnp.asarray(choice),
        jnp.asarray(rank)))
    got = trounds._resolve(_spec(tkernels, check_pod), _torch(enc),
                           torch.from_numpy(idle), torch.from_numpy(cnt),
                           torch.from_numpy(choice), torch.from_numpy(rank)).numpy()
    plain = tk.resolve_prefix_plain(*RC.resolve_args(inp, check_pod)).numpy()
    return ref, got, plain


@pytest.mark.parametrize("check_pod", [False, True])
@pytest.mark.parametrize("label", [c[0] for c in RC.RESOLVE_CASES])
def test_resolve_crafted_matches_reference(label, check_pod):
    kw = dict(RC.RESOLVE_CASES)[label]
    ref, got, plain = _resolve_both(RC.resolve_inputs(**kw), check_pod)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)
    assert ref.any() and not ref.all()


@pytest.mark.parametrize("check_pod", [False, True])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_resolve_random_matches_reference(seed, check_pod):
    g = np.random.default_rng(seed)
    inp = RC.resolve_inputs(seed, t=int(g.integers(200, 3000)), n=int(g.integers(2, 80)),
                            r=int(g.integers(1, 5)), p_none=float(g.random() * 0.5))
    ref, got, plain = _resolve_both(inp, check_pod)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)


def _budget_both(inp):
    enc, queue_alloc, accept, rank, task_queue, task_job, _, job_order = inp
    jenc = {k: v for k, v in enc.items() if k != "job_queue"}
    ref = np.asarray(_jit_budget(_jax(jenc), jnp.asarray(queue_alloc), jnp.asarray(accept),
                                 jnp.asarray(rank), jnp.asarray(task_queue),
                                 jnp.asarray(task_job)))
    args = (_torch(enc), torch.from_numpy(queue_alloc), torch.from_numpy(accept),
            torch.from_numpy(rank), torch.from_numpy(task_queue),
            torch.from_numpy(task_job))
    from_tasks = trounds._queue_budget(*args).numpy()
    with_order = trounds._queue_budget(*args, torch.from_numpy(job_order)).numpy()
    plain = tk.queue_budget_plain(*RC.budget_args(inp)).numpy()
    return ref, from_tasks, with_order, plain


@pytest.mark.parametrize("label", [c[0] for c in RC.BUDGET_CASES])
def test_queue_budget_crafted_matches_reference(label):
    kw = dict(RC.BUDGET_CASES)[label]
    inp = RC.budget_inputs(**kw)
    ref, *ours = _budget_both(inp)
    for got in ours:
        np.testing.assert_array_equal(got, ref)
    accept = inp[2]
    assert ref.any() and (accept & ~ref).any()


@pytest.mark.parametrize("q", [1, 3, 10])
@pytest.mark.parametrize("seed", [21, 22])
def test_queue_budget_queues_match_reference(seed, q):
    g = np.random.default_rng(seed)
    inp = RC.budget_inputs(seed, j=int(g.integers(50, 1500)), q=q,
                           r=int(g.integers(1, 5)), pad_tasks=int(g.integers(0, 64)),
                           pad_jobs=int(g.integers(0, 8)))
    ref, *ours = _budget_both(inp)
    for got in ours:
        np.testing.assert_array_equal(got, ref)


def test_budget_skip_edge_and_int32_cut():
    """The two edges by count. The scalar budget (deserved 0 + eps 10
    units, one unit a task, the other dimensions ample) admits a job while
    what its queue's higher-ranked jobs took is at most 10 units: under
    the bound only below 10, at 10 through the scalar skip. 64-core
    one-task jobs pass while the queue's sum stays under 2^31 - 1 units:
    33,555 of 70,000, the first in the reference's order of the int32 task
    ranks (70,000 x 70,000 passes 2^31, so they wrap)."""
    inp = RC.budget_inputs(**dict(RC.BUDGET_CASES)["scalar skip edge"])
    ref, *ours = _budget_both(inp)
    for got in ours:
        np.testing.assert_array_equal(got, ref)
    task_job, job_queue, job_order = inp[5], inp[6], inp[7]
    tasks = np.bincount(task_job, minlength=job_queue.shape[0])
    took, edge = {}, 0
    for j in job_order:
        before = took.get(job_queue[j], 0)
        assert ref[task_job == j].all() == (before <= 10)
        edge += before == 10
        took[job_queue[j]] = before + tasks[j]
    assert edge > 0
    inp = RC.budget_inputs(**dict(RC.BUDGET_CASES)["64-core past int32"])
    ref, *ours = _budget_both(inp)
    for got in ours:
        np.testing.assert_array_equal(got, ref)
    first = np.argsort(inp[3], kind="stable")[:33_555]
    assert ref.sum() == 33_555 and ref[first].all()
