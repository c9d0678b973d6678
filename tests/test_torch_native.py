"""The port's native host engines (volcano_tpu_torch/_native: fastapply.c and
fasttrans.c, via ops/fasttrans.py): build and load, the env gate, exact
end-state equivalence with the Python oracle (twins of tests/test_native.py
and tests/test_fasttrans.py), and whole sessions where native on == native
off == the JAX package's session: binds, and evictions in order.

The port builds its own copies of the C sources into its own package
directory and imports them as ``volcano_tpu_torch._native._fastapply`` /
``._fasttrans``, so both packages' engines can live in one process.
"""

from __future__ import annotations

import os
import shutil
import sysconfig

import pytest
import torch

import volcano_tpu_torch._native as native
import volcano_tpu_torch.scheduler.actions  # noqa: F401
import volcano_tpu_torch.scheduler.plugins  # noqa: F401
from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers
from volcano_tpu_torch.scheduler.framework import (
    close_session, get_action, open_session, run_actions)

PORT_NATIVE = os.path.dirname(os.path.abspath(native.__file__))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toolchain():
    cc = (sysconfig.get_config_var("CC") or "cc").split()[0]
    return shutil.which(cc) is not None


def _tiers(cfg, mode="rounds"):
    return make_tiers(["tpuscore"], *CONFIGS[cfg].tiers, arguments={
        "tpuscore": {"tpuscore.mode": mode, "tpuscore.device": "cpu",
                     "tpuscore.dtype": "float64"}})


def _gate(no_native: bool):
    if no_native:
        os.environ["VOLCANO_TPU_NO_NATIVE"] = "1"
    else:
        os.environ.pop("VOLCANO_TPU_NO_NATIVE", None)
    native._reset()
    if not no_native:
        # block on the build so the native path is genuinely exercised
        # (the solver's nowait call would otherwise fall back this session)
        if native.get_fastapply() is None or native.get_fasttrans() is None:
            pytest.skip("native module unavailable; fallback covered elsewhere")


def _ungate():
    os.environ.pop("VOLCANO_TPU_NO_NATIVE", None)
    native._reset()


def _res_tuple(r):
    return (r.milli_cpu, r.memory,
            {k: v for k, v in (r.scalar_resources or {}).items() if v})


# --- twins of tests/test_native.py ---------------------------------------


def _run_cfg5(no_native: bool):
    _gate(no_native)
    try:
        cache, *_ = build_config(5, 0.02)
        ssn = open_session(cache, _tiers(5, "auto"))
        ssn.batch_allocator.mode = "rounds"
        for name in CONFIGS[5].actions:
            get_action(name).execute(ssn)
        binds = dict(cache.binder.binds)
        node_state = {
            name: (round(n.idle.milli_cpu, 6), round(n.used.milli_cpu, 6),
                   len(n.tasks))
            for name, n in cache.nodes.items()
        }
        statuses = {
            t.uid: (t.status, t.node_name)
            for job in cache.jobs.values() for t in job.tasks.values()
        }
        ssn_statuses = {
            t.uid: (t.status, t.node_name)
            for job in ssn.jobs.values() for t in job.tasks.values()
        }
        close_session(ssn)
        return binds, node_state, statuses, ssn_statuses
    finally:
        _ungate()


class TestNativeFastApply:
    def test_builds_and_loads(self):
        cc = (sysconfig.get_config_var("CC") or "cc").split()[0]
        if shutil.which(cc) is None:
            pytest.skip(f"no C toolchain ({cc}); Python fallback covers this")
        native._reset()
        mod = native.get_fastapply()
        assert mod is not None, "toolchain present; native module must build"
        assert hasattr(mod, "apply_job_tasks")
        assert mod.__name__ == "volcano_tpu_torch._native._fastapply"
        assert os.path.dirname(mod.__file__) == PORT_NATIVE
        ft = native.get_fasttrans()
        assert ft is not None and hasattr(ft, "pick_first")
        assert os.path.dirname(ft.__file__) == PORT_NATIVE

    def test_native_equals_python_oracle(self):
        """Same bindings, node accounting, and task statuses (session +
        cache trees) from the native loop and the Python loop."""
        py = _run_cfg5(no_native=True)
        nat = _run_cfg5(no_native=False)
        assert py[0] == nat[0], "bindings diverge"
        assert py[1] == nat[1], "node accounting diverges"
        assert py[2] == nat[2], "cache task statuses diverge"
        assert py[3] == nat[3], "session task statuses diverge"
        assert len(py[0]) > 0

    def test_env_gate_disables_native(self, monkeypatch):
        monkeypatch.setenv("VOLCANO_TPU_NO_NATIVE", "1")
        native._reset()
        assert native.get_fastapply() is None
        assert native.get_fasttrans() is None
        assert native.settled("_fastapply")
        native._reset()


# --- twins of tests/test_fasttrans.py ------------------------------------


def _run(cfg: int, scale: float, no_native: bool):
    _gate(no_native)
    try:
        cache, *_ = build_config(cfg, scale)
        ssn = open_session(cache, _tiers(cfg, "auto"))
        for name in CONFIGS[cfg].actions:
            get_action(name).execute(ssn)
        used_ft = ssn.fast_trans() is not None
        assert used_ft is (not no_native), \
            "fast path must be exercised exactly when native is enabled"
        jobs = {
            uid: {
                "alloc": _res_tuple(j.allocated),
                "pend": _res_tuple(j.pending_sum),
                "buckets": {int(k): sorted(v)
                            for k, v in j.task_status_index.items()},
                "ver": j._status_version,
                "tasks": {tuid: (int(t.status), t.node_name)
                          for tuid, t in j.tasks.items()},
            }
            for uid, j in ssn.jobs.items()
        }
        nodes = {
            name: {
                "idle": _res_tuple(nd.idle),
                "used": _res_tuple(nd.used),
                "rel": _res_tuple(nd.releasing),
                "tasks": {k: int(t.status) for k, t in nd.tasks.items()},
                "phase": int(nd.state.phase),
            }
            for name, nd in ssn.nodes.items()
        }
        drf = ssn.plugins.get("drf")
        drf_state = ({uid: (a.share, a.dominant_resource,
                            _res_tuple(a.allocated))
                      for uid, a in drf.job_attrs.items()} if drf else None)
        drf_ns = ({ns: (a.share, _res_tuple(a.allocated))
                   for ns, a in drf.namespace_opts.items()} if drf else None)
        prop = ssn.plugins.get("proportion")
        prop_state = ({q: (a.share, _res_tuple(a.allocated))
                       for q, a in prop.queue_opts.items()} if prop else None)
        close_session(ssn)
        cache_tasks = {
            uid: {tuid: (int(t.status), t.node_name)
                  for tuid, t in j.tasks.items()}
            for uid, j in cache.jobs.items()
        }
        return {
            "binds": dict(cache.binder.binds),
            "evicts": sorted(map(str, cache.evictor.evicts)),
            "jobs": jobs, "nodes": nodes, "drf": drf_state,
            "drf_ns": drf_ns, "prop": prop_state, "cache": cache_tasks,
        }
    finally:
        _ungate()


def test_shared_dense_view_invalidated_by_untracked_placements():
    """The session-cached dense view must rebuild when a placement bypassed
    its hooks; hook-notified placements keep it shared."""
    from volcano_tpu_torch.ops import preemptview

    cache, *_ = build_config(4, 0.05)
    ssn = open_session(cache, _tiers(4, "auto"))
    try:
        v1 = preemptview.build(ssn)
        assert v1 is not None
        assert preemptview.build(ssn) is v1, "hook-synced view must be shared"
        ssn._placement_gen += 1
        v2 = preemptview.build(ssn)
        assert v2 is not None and v2 is not v1, \
            "untracked placement must force a rebuild"
        ssn._placement_gen += 1
        v2.on_pipeline(next(iter(ssn.nodes)), next(
            t for j in ssn.jobs.values() for t in j.tasks.values()))
        assert preemptview.build(ssn) is v2
    finally:
        close_session(ssn)


@pytest.mark.skipif(not _toolchain(), reason="no C toolchain")
@pytest.mark.parametrize("cfg,scale", [(4, 0.12), (2, 0.15), (6, 0.15),
                                       # 3,125 pending tasks at cfg5 0.25:
                                       # above the rounds threshold, so the
                                       # bulk apply (apply_all_jobs and the
                                       # deferred mirror_all_jobs flush) runs
                                       (5, 0.25)])
def test_native_transitions_equal_python_oracle(cfg, scale):
    nat = _run(cfg, scale, no_native=False)
    py = _run(cfg, scale, no_native=True)
    for key in py:
        assert nat[key] == py[key], f"{key} diverges between native and oracle"
    if cfg == 4:
        assert len(nat["evicts"]) > 0, "overcommit config must exercise evict"
    assert len(nat["binds"]) > 0


# --- whole sessions: native on == native off == the JAX session ----------


def _port_session(cfg, scale, no_native):
    _gate(no_native)
    try:
        cache, *_ = build_config(cfg, scale)
        ssn = open_session(cache, _tiers(cfg))
        run_actions(ssn, list(CONFIGS[cfg].actions))
        prof = dict(ssn.plugins["tpuscore"].profile)
        assert (ssn.fast_trans() is not None) is (not no_native)
        close_session(ssn)
        return dict(cache.binder.binds), list(cache.evictor.evicts), prof
    finally:
        _ungate()


def _jax_session(cfg, scale):
    from volcano_tpu.bench.clusters import CONFIGS as JCONFIGS
    from volcano_tpu.bench.clusters import build_config as jbuild
    from volcano_tpu.bench.clusters import make_tiers as jtiers
    from volcano_tpu.scheduler.framework import close_session as jclose
    from volcano_tpu.scheduler.framework import open_session as jopen
    from volcano_tpu.scheduler.framework import run_actions as jrun
    import volcano_tpu.scheduler.actions  # noqa: F401
    import volcano_tpu.scheduler.plugins  # noqa: F401

    cache, *_ = jbuild(cfg, scale)
    tiers = jtiers(["tpuscore"], *JCONFIGS[cfg].tiers,
                   arguments={"tpuscore": {"tpuscore.mode": "rounds"}})
    ssn = jopen(cache, tiers)
    jrun(ssn, list(JCONFIGS[cfg].actions))
    jclose(ssn)
    return dict(cache.binder.binds), list(cache.evictor.evicts)


@pytest.mark.skipif(not _toolchain(), reason="no C toolchain")
@pytest.mark.parametrize("cfg,scale", [(2, 0.5), (4, 0.02)])
def test_sessions_native_on_equal_off_equal_jax(cfg, scale):
    """cfg2 (allocate, the bulk apply at 2,500 tasks) and cfg4-shaped
    allocate/backfill/preempt/reclaim: the same binds and the same
    evictions in order with the engines on, off, and in the JAX package."""
    on = _port_session(cfg, scale, no_native=False)
    off = _port_session(cfg, scale, no_native=True)
    ref = _jax_session(cfg, scale)
    assert on[0] == off[0] == ref[0]
    assert [str(e) for e in on[1]] == [str(e) for e in off[1]] \
        == [str(e) for e in ref[1]]
    assert on[2].get("mode") == "rounds" and len(on[0]) > 0
    if cfg == 4:
        assert len(on[1]) > 0
