"""The port's scheduler loop (volcano_tpu_torch/scheduler/scheduler.py) and
its GC policy (volcano_tpu_torch/utils/gcpolicy.py).

Twins of tests/test_scheduler.py (conf parsing, flags, an unknown action,
run_once under the default and the batch-solve conf, hot reload, a bad
conf path, the periodic loop, the express lane placing between sessions)
and of tests/test_gcpolicy.py, on the CPU. The conf reader is the port's
own (no PyYAML): it is held to ``yaml.safe_load`` on the confs the
scheduler reads, and run_once's binds to the JAX package's Scheduler on
the same cluster. Tolerance: exact equality.
"""

from __future__ import annotations

import gc
import logging
import textwrap
import time

import pytest
import torch
import yaml

from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.scheduler import scheduler as jscheduler
from volcano_tpu.scheduler.util import test_utils as jtu
from volcano_tpu.api import objects as jobjects

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.bench.clusters import make_cache
from volcano_tpu_torch.scheduler import degrade as tdegrade
from volcano_tpu_torch.scheduler.scheduler import (
    DEFAULT_SCHEDULER_CONF,
    TPU_SCHEDULER_CONF,
    Scheduler,
    load_scheduler_conf,
    parse_yaml,
)
from volcano_tpu_torch.scheduler.util import test_utils as ttu
from volcano_tpu_torch.utils.gcpolicy import LowLatencyGC

# TPU_SCHEDULER_CONF with the solve on the CPU in float64 (the conf's
# tpuscore arguments place the solve; the default is the card)
CPU_TPU_CONF = TPU_SCHEDULER_CONF.replace(
    "  - name: tpuscore\n",
    "  - name: tpuscore\n    arguments:\n      tpuscore.device: cpu\n"
    "      tpuscore.dtype: float64\n")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_port_ladder():
    tdegrade.reset()
    yield
    tdegrade.reset()


class TestConfLoader:
    def test_default_conf(self):
        actions, tiers = load_scheduler_conf(DEFAULT_SCHEDULER_CONF)
        assert [a.name() for a in actions] == ["enqueue", "allocate", "backfill"]
        assert [[p.name for p in t.plugins] for t in tiers] == [
            ["priority", "gang"],
            ["drf", "predicates", "proportion", "nodeorder"],
        ]
        assert tiers[0].plugins[0].enabled_job_order is True
        assert tiers[1].plugins[1].enabled_predicate is True

    def test_flag_override_and_arguments(self):
        conf_str = textwrap.dedent("""
            actions: "allocate"
            tiers:
            - plugins:
              - name: gang
                enableJobOrder: false
              - name: binpack
                arguments:
                  binpack.weight: 5
        """)
        actions, tiers = load_scheduler_conf(conf_str)
        assert [a.name() for a in actions] == ["allocate"]
        gang, binpack = tiers[0].plugins
        assert gang.enabled_job_order is False
        assert gang.enabled_job_ready is True
        assert binpack.arguments == {"binpack.weight": "5"}

    def test_unknown_action_raises(self):
        with pytest.raises(KeyError):
            load_scheduler_conf('actions: "teleport"')

    def test_same_tiers_as_the_jax_loader(self):
        for text in (DEFAULT_SCHEDULER_CONF, TPU_SCHEDULER_CONF, CPU_TPU_CONF):
            t_actions, t_tiers = load_scheduler_conf(text)
            j_actions, j_tiers = jscheduler.load_scheduler_conf(text)
            assert [a.name() for a in t_actions] == [a.name() for a in j_actions]
            assert [repr(t) for t in t_tiers] == [repr(t) for t in j_tiers]


_DOCS = [
    DEFAULT_SCHEDULER_CONF,
    TPU_SCHEDULER_CONF,
    CPU_TPU_CONF,
    'actions: "allocate"\ntiers:\n- plugins:\n  - name: gang\n',
    """# a comment line
actions: 'enqueue, allocate'   # trailing comment
tiers:
  - plugins:
      - name: tpuscore
        arguments:
          tpuscore.mode: parity
          tpuscore.dtype: "float64"
          weight: 1.5
          flag: yes
          unset: ~
      - name: drf
        enableNamespaceOrder: 'false'
  -
    plugins:
    - name: gang
""",
    "",
]


@pytest.mark.parametrize("text", _DOCS, ids=range(len(_DOCS)))
def test_conf_reader_matches_pyyaml(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: {b: 1}", "a: [1, 2]", "a: &x 1"])
def test_conf_reader_refuses_flow_style(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def _populate(cache, tu=ttu, obj=objects):
    cache.add_queue(tu.build_queue("default"))
    cache.add_pod_group(tu.build_pod_group(
        "pg1", namespace="ns1", min_member=2,
        phase=obj.PodGroupPhase.PENDING))
    for i in range(2):
        cache.add_pod(tu.build_pod("ns1", f"p{i}", "", obj.POD_PHASE_PENDING,
                                   {"cpu": "1", "memory": "1Gi"}, "pg1"))
    cache.add_node(tu.build_node("n1", tu.build_resource_list_with_pods("4", "8Gi")))


class TestSchedulerDriver:
    def test_run_once_end_to_end(self):
        cache = make_cache()
        _populate(cache)
        Scheduler(cache).run_once()
        assert len(cache.binder.binds) == 2

    def test_run_once_tpu_conf(self):
        cache = make_cache()
        _populate(cache)
        Scheduler(cache, scheduler_conf=CPU_TPU_CONF).run_once()
        assert len(cache.binder.binds) == 2

    def test_tpu_conf_asks_for_the_card(self):
        """TPU_SCHEDULER_CONF as it is places the solve on cuda: on a host
        without a GPU the cycle raises instead of carrying on on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the no-GPU refusal cannot be shown here")
        cache = make_cache()
        _populate(cache)
        with pytest.raises(RuntimeError, match="CUDA"):
            Scheduler(cache, scheduler_conf=TPU_SCHEDULER_CONF).run_once()

    def test_conf_hot_reload_from_file(self, tmp_path):
        conf_file = tmp_path / "scheduler.yaml"
        conf_file.write_text('actions: "allocate"\ntiers:\n- plugins:\n  - name: gang\n')
        cache = make_cache()
        _populate(cache)
        # the PodGroup stays Pending without the enqueue action
        s = Scheduler(cache, conf_path=str(conf_file))
        s.run_once()
        assert cache.binder.binds == {}
        conf_file.write_text(DEFAULT_SCHEDULER_CONF)
        s.run_once()
        assert len(cache.binder.binds) == 2

    def test_bad_conf_path_falls_back_to_default(self):
        cache = make_cache()
        _populate(cache)
        s = Scheduler(cache, conf_path="/nonexistent/scheduler.yaml")
        s.run_once()
        assert len(cache.binder.binds) == 2

    def test_periodic_loop(self):
        cache = make_cache()
        _populate(cache)
        s = Scheduler(cache, schedule_period=0.05)
        s.run()
        try:
            assert cache.binder.wait_for_binds(2, timeout=10.0)
        finally:
            s.stop()

    def test_express_loop_places_between_sessions(self):
        """Scheduler(express=True): an eligible arrival binds through the
        port's express lane (on the CPU) during the inter-cycle wait,
        well before the next periodic session would have run."""
        cache = make_cache()
        cache.add_node(ttu.build_node(
            "n1", ttu.build_resource_list_with_pods("8", "16Gi", pods=64)))
        cache.add_queue(ttu.build_queue("default"))
        s = Scheduler(cache, schedule_period=5.0, express=True,
                      device="cpu", dtype=torch.float64)
        s.run()
        try:
            time.sleep(0.2)  # let the first session drain the empty queue
            cache.add_pod_group(ttu.build_pod_group(
                "svc", namespace="xp", min_member=1))
            cache.add_pod(ttu.build_pod(
                "xp", "svc-t0", "", objects.POD_PHASE_PENDING,
                {"cpu": "250m", "memory": "256Mi"}, "svc"))
            assert cache.binder.wait_for_binds(1, timeout=3.0), \
                "express lane did not place within the schedule period"
            assert s.express_lane.counters["placed"] == 1
        finally:
            s.stop()

    def test_loop_runs_under_the_gc_policy_and_logs_no_failure(self, caplog):
        """While the loop runs, automatic collection is off; stop()
        restores it; no cycle logs a failure."""
        cache = make_cache()
        _populate(cache)
        was = gc.isenabled()
        gc.enable()
        seen = []
        try:
            s = Scheduler(cache, CPU_TPU_CONF, schedule_period=0.02,
                          pipeline=True)
            with caplog.at_level(logging.ERROR):
                s.run()
                try:
                    assert cache.binder.wait_for_binds(2, timeout=10.0)
                    deadline = time.time() + 10.0
                    while s.pipeline_driver.stats["cycles"] < 3 \
                            and time.time() < deadline:
                        seen.append(gc.isenabled())
                        time.sleep(0.01)
                    seen.append(gc.isenabled())
                finally:
                    s.stop()
            assert s.pipeline_driver.stats["cycles"] >= 3
            assert not any(seen)
            assert gc.isenabled()
            assert not [r for r in caplog.records
                        if "cycle failed" in r.getMessage()]
        finally:
            (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("conf_name", ["default", "tpu"])
def test_run_once_binds_match_the_jax_scheduler(conf_name):
    """One run_once over cfg2 at a small scale (and a pending PodGroup the
    enqueue action admits) binds the same tasks to the same nodes as the
    JAX package's Scheduler."""
    t_conf, j_conf = {"default": (DEFAULT_SCHEDULER_CONF, jscheduler.DEFAULT_SCHEDULER_CONF),
                      "tpu": (CPU_TPU_CONF, jscheduler.TPU_SCHEDULER_CONF)}[conf_name]
    from volcano_tpu_torch.bench import clusters as tclusters

    tcache = tclusters.make_cache()
    tclusters.CONFIGS[2].populate(tcache, 0.03)
    _populate(tcache)
    jcache = jclusters.make_cache()
    jclusters.CONFIGS[2].populate(jcache, 0.03)
    _populate(jcache, jtu, jobjects)
    Scheduler(tcache, t_conf).run_once()
    jscheduler.Scheduler(jcache, j_conf).run_once()
    assert tcache.binder.binds == jcache.binder.binds
    assert len(tcache.binder.binds) > 2


class TestLowLatencyGC:
    def test_install_disables_and_uninstall_restores(self):
        was = gc.isenabled()
        gc.enable()
        try:
            p = LowLatencyGC.install()
            assert not gc.isenabled()
            p.maintain()
            assert not gc.isenabled()
            p.uninstall()
            assert gc.isenabled()
        finally:
            (gc.enable if was else gc.disable)()

    def test_refcounted_overlapping_installs(self):
        was = gc.isenabled()
        gc.enable()
        try:
            a = LowLatencyGC.install()
            b = LowLatencyGC.install()
            a.uninstall()
            assert not gc.isenabled(), "survivor still runs under the policy"
            b.uninstall()
            assert gc.isenabled()
        finally:
            (gc.enable if was else gc.disable)()

    def test_double_uninstall_is_idempotent(self):
        was = gc.isenabled()
        gc.enable()
        try:
            a = LowLatencyGC.install()
            b = LowLatencyGC.install()
            a.uninstall()
            a.uninstall()
            assert not gc.isenabled()
            b.uninstall()
            assert gc.isenabled()
        finally:
            (gc.enable if was else gc.disable)()

    def test_full_collection_on_stride(self):
        """Young generations every cycle, the full heap on the stride."""
        was = gc.isenabled()
        gens = []

        def note(phase, info):
            if phase == "start":
                gens.append(info["generation"])

        gc.callbacks.append(note)
        try:
            p = LowLatencyGC.install()
            for _ in range(LowLatencyGC.FULL_EVERY):
                p.maintain()
            p.uninstall()
        finally:
            gc.callbacks.remove(note)
            (gc.enable if was else gc.disable)()
        assert gens.count(2) >= 1
        assert len(gens) >= LowLatencyGC.FULL_EVERY


def _stop_during_a_cycle(s, drv):
    """Hold the loop thread inside a cycle, right before its solve-ahead
    dispatch, until either abandon() has run or the stop flag is set (the
    two orders the packages' stop() take); then stop(). Returns the stage
    left in flight."""
    import threading

    held, abandoned = threading.Event(), threading.Event()
    real_speculate, real_abandon = drv._speculate, drv.abandon

    def speculate(*args, **kw):
        held.set()
        deadline = time.time() + 30.0
        while not (abandoned.is_set() or s._stop.is_set()):
            assert time.time() < deadline, "stop() never reached the loop"
            time.sleep(0.001)
        return real_speculate(*args, **kw)

    def abandon():
        real_abandon()
        abandoned.set()

    drv._speculate, drv.abandon = speculate, abandon
    assert held.wait(timeout=60.0), "the loop never reached a solve-ahead"
    s.stop()
    return drv._inflight


def test_stop_leaves_no_stage_in_flight_unlike_the_reference():
    """The reference's stop() abandons the pipeline BEFORE it joins the
    loop, so a cycle still running dispatches a new speculative stage
    after the abandon and leaves it in flight; the port joins first, then
    abandons, and the abandon fetches the stage's solve (still running on
    a card after its dispatch returned) without applying it."""
    from tests.test_torch_pipeline import _CPU_TPU_CONF, _Jax, _cluster

    jax_conf = _CPU_TPU_CONF.replace(
        "      tpuscore.device: cpu\n      tpuscore.dtype: float64\n", "")
    state = _cluster(31, pkg=_Jax)
    sj = jscheduler.Scheduler(state["cache"], jax_conf, schedule_period=0.05,
                              pipeline=True)
    sj.run()
    drv_j = sj.pipeline_driver
    left = _stop_during_a_cycle(sj, drv_j)
    assert left is not None, "the reference's stop() left nothing in flight"
    drv_j.abandon()

    state = _cluster(31)
    s = Scheduler(state["cache"], _CPU_TPU_CONF, schedule_period=0.05,
                  pipeline=True)
    s.run()
    drv = s.pipeline_driver
    assert _stop_during_a_cycle(s, drv) is None
    assert drv.stats["spec_discards"].get("abandoned", 0) >= 1
