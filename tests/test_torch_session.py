"""Whole allocate sessions: the port against the JAX package.

The same bench/clusters.py config, built by each package's own copy of
the cluster generators, runs one allocate session through open_session ->
run_actions -> close_session. With tpuscore in rounds mode (the port on
the CPU in float64, JAX in float64 under the test conftest) the port's
FakeBinder.binds must equal the JAX package's; with tpuscore off both
serial paths must bind the same. Tolerance: exact equality of the bind
maps.
"""

from __future__ import annotations

import importlib

import pytest
import torch

from volcano_tpu.bench import clusters as jclusters
from volcano_tpu.scheduler import framework as jframework
import volcano_tpu.scheduler.actions  # noqa: F401  (register actions)

from volcano_tpu_torch.bench import clusters as tclusters
from volcano_tpu_torch.scheduler import framework as tframework
import volcano_tpu_torch.scheduler.actions  # noqa: F401  (register actions)
import volcano_tpu_torch.scheduler.plugins  # noqa: F401  (register plugins)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _add_residue_pods(cache, objects, test_utils):
    """Gangs the rounds solve leaves to the serial residue pass: pods with
    two host ports and pods with required pod affinity."""
    for g in range(6):
        pg = f"res-{g:03d}"
        cache.add_pod_group(test_utils.build_pod_group(pg, namespace="bench",
                                                       min_member=2))
        for i in range(3):
            pod = test_utils.build_pod(
                "bench", f"{pg}-t{i}", "", objects.POD_PHASE_PENDING,
                {"cpu": "500m", "memory": "512Mi"}, pg)
            if g % 2 == 0:
                pod.spec.containers[0].ports = [
                    objects.ContainerPort(host_port=31000 + g, container_port=80),
                    objects.ContainerPort(host_port=32000 + g, container_port=81)]
            else:
                pod.metadata.labels["app"] = f"res-{g}"
                pod.spec.affinity = objects.Affinity(
                    pod_affinity=objects.PodAffinity(required_terms=[
                        objects.PodAffinityTerm(
                            label_selector=objects.LabelSelector(
                                match_labels={"app": f"res-{g}"}),
                            topology_key="zone")]))
            cache.add_pod(pod)


def _session(clusters, framework, cfg, scale, tpu_args):
    cache = clusters.make_cache()
    bc = clusters.CONFIGS[cfg]
    bc.populate(cache, scale)
    if cfg == 6:
        pkg = clusters.__name__.split(".")[0]
        _add_residue_pods(cache, importlib.import_module(pkg + ".api.objects"),
                          importlib.import_module(pkg + ".scheduler.util.test_utils"))
    if tpu_args is None:
        tiers = clusters.make_tiers(*bc.tiers)
    else:
        tiers = clusters.make_tiers(["tpuscore"], *bc.tiers,
                                    arguments={"tpuscore": tpu_args})
    ssn = framework.open_session(cache, tiers)
    framework.run_actions(ssn, ["allocate"])
    prof = dict(ssn.plugins["tpuscore"].profile) if tpu_args is not None else {}
    framework.close_session(ssn)
    return cache.binder.binds, prof


CASES = [(2, 0.04), (3, 0.02), (5, 0.01), (6, 0.1)]


@pytest.mark.parametrize("cfg,scale", CASES, ids=[f"cfg{c}" for c, _ in CASES])
def test_rounds_session_binds_match_reference(cfg, scale):
    j_binds, j_prof = _session(jclusters, jframework, cfg, scale,
                               {"tpuscore.mode": "rounds"})
    t_binds, t_prof = _session(
        tclusters, tframework, cfg, scale,
        {"tpuscore.mode": "rounds", "tpuscore.device": "cpu",
         "tpuscore.dtype": "float64"})
    assert j_prof.get("mode") == t_prof.get("mode") == "rounds"
    for key in ("rounds", "placed", "residue", "window_k", "dirty_k",
                "full_sweep_rounds", "round_placed"):
        assert t_prof[key] == j_prof[key], key
    assert t_binds == j_binds
    assert t_binds
    if cfg == 6:
        # the serial residue pass ran (with the dense alloc assist)
        assert t_prof["residue"] > 0 and t_prof["residue_pass_tasks"] > 0


@pytest.mark.parametrize("cfg,scale", CASES, ids=[f"cfg{c}" for c, _ in CASES])
def test_serial_session_binds_match_reference(cfg, scale):
    j_binds, _ = _session(jclusters, jframework, cfg, scale, None)
    t_binds, _ = _session(tclusters, tframework, cfg, scale, None)
    assert t_binds == j_binds
    assert t_binds


def test_parity_mode_is_not_ported_yet():
    cache = tclusters.make_cache()
    tclusters.CONFIGS[1].populate(cache, 0.1)
    tiers = tclusters.make_tiers(["tpuscore"], ["priority", "gang"], arguments={
        "tpuscore": {"tpuscore.mode": "parity", "tpuscore.device": "cpu"}})
    with pytest.raises(NotImplementedError, match="parity"):
        tframework.open_session(cache, tiers)


def test_bf16_is_refused():
    cache = tclusters.make_cache()
    tclusters.CONFIGS[1].populate(cache, 0.1)
    tiers = tclusters.make_tiers(["tpuscore"], ["priority", "gang"], arguments={
        "tpuscore": {"tpuscore.device": "cpu", "tpuscore.dtype": "bfloat16"}})
    with pytest.raises(ValueError, match="bfloat16"):
        tframework.open_session(cache, tiers)
