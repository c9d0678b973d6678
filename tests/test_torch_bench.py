"""The port's bench (``python -m volcano_tpu_torch.bench``,
volcano_tpu_torch/bench/run.py) at tiny scale on the CPU in float64,
against the JAX package's ``bench.py`` on the same calls: the records carry
the same keys (the port adds the card line ``device``), the device arm
binds what the JAX bench binds, and warm sessions build no kernel and
capture no graph. The mesh curve runs the JAX bench without x64, as
``bench.py`` runs it (its fold probe does not trace under x64; see
tests/test_torch_shard.py). The watch fan-out bench counts what
``bench.py``'s counts on the same arguments. The CLI exits 0 with a
``summary`` tail, and each flag of a mode the port leaves out exits
non-zero naming its ROADMAP.md item.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402  (the JAX package's bench, at the repository root)

from volcano_tpu_torch.bench import run  # noqa: E402

CPU = dict(device="cpu", dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_keys(port: dict, ref: dict, extra=()):
    assert set(port) - set(extra) == set(ref), (
        sorted(set(port) - set(ref) - set(extra)), sorted(set(ref) - set(port)))


@pytest.mark.parametrize("cfg,scale", [(2, 0.02), (5, 0.05)])
def test_run_config_record_matches_the_jax_bench(cfg, scale):
    """cfg2 at 0.02 stays under the rounds threshold (both arms run the
    serial loop); cfg5 at 0.05 (2,500 tasks) takes the rounds solve."""
    port = run.run_config(cfg, scale, "both", warm_iters=1, verbose=False, **CPU)
    ref = bench.run_config(cfg, scale, "both", 30.0, warm_iters=1, verbose=False)
    _same_keys(port, ref, extra=("device",))
    assert port["device"] == "cpu"
    assert port["tpu_binds"] == ref["tpu_binds"] > 0
    assert port["serial_binds"] == ref["serial_binds"]
    assert port["tpu_warm_compiles"] == [0]
    assert port["tpu_first_warm_compiles"] == 0
    assert port["native_engines"] == {"fastapply": True, "fasttrans": True}
    assert len(port["tpu_e2e_samples_ms"]) == 1
    assert port["tpu_floor_probe_notes"][0]["sync_points"] == 6
    if cfg == 5:
        assert port["tpu_profile"]["mode"] == "rounds"
        assert port["tpu_round_profile"]["rounds"] == \
            ref["tpu_round_profile"]["rounds"]
        _same_keys(port["tpu_round_profile"], ref["tpu_round_profile"])


def test_run_mesh_curve_record_matches_the_jax_bench():
    port = run.run_mesh_curve(0.005, [1, 2, 4, 8], **CPU)
    with jax.enable_x64(False):
        ref = bench.run_mesh_curve(0.005, [1])
    _same_keys(port, ref)
    assert port["devices"] == [1]  # one device until the mesh is ported
    (entry,), (ref_entry,) = port["curve"], ref["curve"]
    _same_keys(entry, ref_entry)
    assert entry["per_device_stage_ms"] > 0
    assert entry["warm_compiles"] == 0
    assert entry["binds"] == ref_entry["binds"] > 0


def test_run_express_record_matches_the_jax_bench():
    port = run.run_express(0.01, arrivals=4, warm=2, **CPU)
    ref = bench.run_express(0.01, arrivals=4, warm=2)
    _same_keys(port, ref)
    _same_keys(port["express_state"], ref["express_state"])
    for k in ("arrivals", "batches", "express_placed", "express_deferred",
              "express_reconciled", "express_reverted"):
        assert port[k] == ref[k], k
    assert port["express_warm_compiles"] == 0
    assert port["express_sync_points_per_batch"] == 1.0


def test_run_pipeline_record_matches_the_jax_bench():
    port = run.run_pipeline(0.01, cycles=2, warm=1, **CPU)
    ref = bench.run_pipeline(0.01, cycles=2, warm=1)
    _same_keys(port, ref)
    for arm in ("serial", "pipeline"):
        _same_keys(port[arm], ref[arm])
        assert port[arm]["binds"] == ref[arm]["binds"], arm
        assert port[arm]["warm_compiles"] == 0
    _same_keys(port["pipeline"]["driver"], ref["pipeline"]["driver"])
    _same_keys(port["churn"], ref["churn"])
    # one process, one string-hash order: both packages agree (see below)
    for k in ("binds_match_serial", "whole_fp_binds_match_serial", "binds",
              "spec_commits", "spec_discards", "whole_fp_discards"):
        assert port["churn"][k] == ref["churn"][k], k
    assert port["churn"]["warm_compiles_readset"] == 0
    # the VOLCANO_TPU_READSET=0 arm discards every echoed window
    assert port["churn"]["commit_rate_whole_fingerprint"] == \
        ref["churn"]["commit_rate_whole_fingerprint"]


_CHURN = r"""
import sys
sys.path.insert(0, {repo!r})
import tests.conftest  # x64 and the CPU platform, as the tests run JAX
import bench
from volcano_tpu_torch.bench import run
p = run.run_pipeline(0.01, cycles=6, device="cpu", dtype="float64")["churn"]
j = bench.run_pipeline(0.01, cycles=6)["churn"]
print("MATCH", p["binds_match_serial"], j["binds_match_serial"],
      p["whole_fp_binds_match_serial"], j["whole_fp_binds_match_serial"])
"""


@pytest.mark.parametrize("seed,match", [("0", False), ("1", True)])
def test_readset_churn_bind_match_follows_the_hash_order_in_both(seed, match):
    """Reference fault (ROADMAP.md Queue 3): the churn arm's read-set
    commits give the serial arm's binds or not depending on the process's
    string-hash order, in the JAX bench as in the port (cfg5 x 0.01, 6
    measured cycles): with PYTHONHASHSEED=0 both differ from their serial
    arm, with 1 both equal it. The whole-fingerprint arm matches in both."""
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=seed,
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHURN.format(repo=REPO)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("MATCH"))
    assert line.split()[1:] == [str(match), str(match), "True", "True"], line


def test_cli_runs_and_prints_a_summary_tail():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench", "--device", "cpu",
         "--dtype", "float64", "--config", "2", "--scale", "0.02",
         "--backend", "both", "--warm-iters", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail["summary"]["cfg2"]["e2e_ms"] > 0
    head = json.loads(lines[-2])
    assert head["unit"] == "ms" and head["value"] > 0
    with open(run.RECORD) as fh:
        record = json.load(fh)
    assert record["complete"] and record["device"] == "cpu"
    assert record["results"][0]["config"] == 2


@pytest.mark.parametrize("argv,item", [
    (["--no-front-door"], "item 4"),
    (["--scenario", "cfg5_storm"], "item 6"),
    (["--no-storm"], "item 6"),
    (["--storm-scale", "0.1"], "item 6"),
    (["--storm-duration", "5"], "item 6"),
    (["--mesh"], "item 7"),
])
def test_left_out_flags_are_refused(argv, item, capsys):
    assert run.main(argv + ["--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert "not in the port yet" in err and f"ROADMAP.md Queue 1 {item}" in err


FANOUT_COUNTS = ("watchers", "batches", "events_appended", "deliveries",
                 "coalesced", "demotions", "resyncs",
                 "journal_peak_occupancy", "journal_hard_cap",
                 "per_watcher_state_bytes")


@pytest.mark.parametrize("kw", [
    dict(watchers=300, batches=6),
    # a ring small enough that the slow tail is demoted and resyncs
    dict(watchers=200, batches=12, churn=64, cap=128, slow_every=50,
         slow_stride=6, pods=32),
])
def test_fanout_bench_counts_match_the_jax_bench(kw):
    # the fan-out reads the process's degrade ladder, which earlier runs
    # leave tripped: each package's starts fresh
    from volcano_tpu.scheduler import degrade as ref_degrade
    from volcano_tpu_torch.scheduler import degrade

    degrade.reset()
    ref_degrade.reset()
    ours = run.run_fanout_bench(**kw)
    ref = bench.run_fanout_bench(**kw)
    degrade.reset()
    ref_degrade.reset()
    assert {k: ours[k] for k in FANOUT_COUNTS} == \
        {k: ref[k] for k in FANOUT_COUNTS}
    assert ours["deliveries"] > 0
    assert set(ours) == set(ref)
    if kw["watchers"] == 200:
        assert ours["demotions"] > 0 and ours["resyncs"] > 0


def test_fanout_cli_runs_without_a_device():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench", "--fanout", "200"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    head, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert head["unit"] == "ms" and "200 watchers" in head["metric"]
    result = tail["summary"]["watch_fanout"]
    assert result["watchers"] == 200 and result["deliveries"] > 0
