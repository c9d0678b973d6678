"""Scheduler driver — the periodic session loop
(volcano pkg/scheduler/scheduler.go + util.go), on PyTorch and CUDA.

Port of volcano_tpu/scheduler/scheduler.py. Every cycle: reload the policy
YAML (hot-reload semantics, scheduler.go:77), open a session over the
cache snapshot, run the configured actions in order, close the session
(status writeback). The conf schema matches conf/scheduler_conf.go:19-58;
the default conf is the reference's (util.go:31-42) — the tpuscore gate
is added via conf, not hardcoded. With ``pipeline=True`` the cycles run
through the continuous pipeline (volcano_tpu_torch/pipeline), with
``express=True`` the loop services the express lane between sessions.

The solve runs where the conf's tpuscore arguments say (``tpuscore.device``
defaults to cuda); the express lane runs on ``device``/``dtype`` (cuda and
float32 unless the caller asks for the CPU).

Trims from the reference, each deliberate:

- ``mesh=``: the port runs on one device;
- the ``except Exception`` around building the express lane and the
  pipeline driver: in the port a failure there raises;
- PyYAML: the conf is read by ``parse_yaml``, a reader of the block-style
  subset the scheduler conf uses (mappings, sequences, plain and quoted
  scalars, comments); flow collections are refused.

``_loop`` keeps the reference's log-and-continue per cycle ("scheduling
cycle failed", "express run failed"): that is the daemon's behaviour.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from typing import List, Optional, Tuple

from volcano_tpu_torch.scheduler import conf, degrade as degrade_mod, metrics
from volcano_tpu_torch.scheduler import plugins as _plugins  # noqa: F401 (register)
from volcano_tpu_torch.scheduler import actions as _actions  # noqa: F401 (register)
from volcano_tpu_torch.scheduler.framework import (
    close_session,
    get_action,
    open_session,
    run_actions,
)

logger = logging.getLogger(__name__)

DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# The batch-solve variant: identical policy tiers plus the tpuscore gate.
TPU_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: tpuscore
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

_FLAG_KEYS = {
    "enableJobOrder": "enabled_job_order",
    "enableNamespaceOrder": "enabled_namespace_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableNodeOrder": "enabled_node_order",
}


# -- the conf reader ----------------------------------------------------------

_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` #`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str):
    """A YAML scalar as PyYAML's safe loader types it: quoted strings,
    booleans (true/yes/on, false/no/off), null, ints, floats, else str."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if text[:1] in ("{", "[", "&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    low = text.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in ("", "~", "null"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _key_value(text: str):
    """Split ``key: value`` at the first colon outside quotes that ends
    the line or is followed by a space; None when there is none."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return _scalar(text[:i]), text[i + 1:].strip()
    return None


def parse_yaml(text: str):
    """Read the block-style YAML subset of the scheduler conf: nested
    mappings and ``- `` sequences (a sequence may sit at its key's
    indentation), plain and quoted scalars, ``#`` comments. Returns the
    same Python value as ``yaml.safe_load`` for such documents; raises
    ValueError on anything else."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(raw)
        if body.strip() and body.strip() != "---":
            lines.append([len(body) - len(body.lstrip(" ")), body.strip()])

    def block(i, indent):
        if lines[i][1] == "-" or lines[i][1].startswith("- "):
            return seq(i, indent)
        if _key_value(lines[i][1]) is None:
            if i + 1 < len(lines) and lines[i + 1][0] > indent:
                raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
            return _scalar(lines[i][1]), i + 1
        return mapping(i, indent)

    def child(i, indent, parent_is_key):
        # the value block after a "key:" or a bare "-" at line i - 1
        if i < len(lines) and lines[i][0] > indent:
            return block(i, lines[i][0])
        if (parent_is_key and i < len(lines) and lines[i][0] == indent
                and (lines[i][1] == "-" or lines[i][1].startswith("- "))):
            return seq(i, indent)
        return None, i

    def seq(i, indent):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip(" ")
            if not rest:
                value, i = child(i + 1, indent, False)
            elif _key_value(rest) is not None:
                # a compact mapping: its first key sits after the dash
                lines[i] = [indent + len(lines[i][1]) - len(rest), rest]
                value, i = mapping(i, lines[i][0])
            else:
                value, i = _scalar(rest), i + 1
            out.append(value)
        return out, i

    def mapping(i, indent):
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            kv = _key_value(lines[i][1])
            if kv is None:
                raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
            key, rest = kv
            if rest:
                out[key], i = _scalar(rest), i + 1
            else:
                out[key], i = child(i + 1, indent, True)
        return out, i

    if not lines:
        return None
    value, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected YAML indentation at {lines[i][1]!r}")
    return value


# -- the conf -----------------------------------------------------------------


def _parse_bool(v) -> bool:
    """Quoted YAML booleans ('false') must not read as truthy strings."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "t", "true", "yes")


def load_scheduler_conf(conf_str: str) -> Tuple[List, List[conf.Tier]]:
    """YAML -> ([Action], [Tier]) with per-plugin flag defaulting
    (util.go:44-72)."""
    data = parse_yaml(conf_str) or {}
    tiers: List[conf.Tier] = []
    for tier_data in data.get("tiers", []) or []:
        options = []
        for p in tier_data.get("plugins", []) or []:
            option = conf.PluginOption(name=p["name"])
            for yaml_key, attr in _FLAG_KEYS.items():
                if yaml_key in p:
                    setattr(option, attr, _parse_bool(p[yaml_key]))
            args = p.get("arguments") or {}
            option.arguments = {str(k): str(v) for k, v in args.items()}
            conf.apply_plugin_conf_defaults(option)
            options.append(option)
        tiers.append(conf.Tier(plugins=options))

    actions = []
    for name in str(data.get("actions", "")).split(","):
        name = name.strip()
        if not name:
            continue
        actions.append(get_action(name))  # raises KeyError like util.go errors
    return actions, tiers


def read_scheduler_conf(path: str) -> str:
    with open(path) as f:
        return f.read()


class Scheduler:
    """Periodic scheduler (scheduler.go:34-106).

    ``device``/``dtype`` place the express lane (cuda/float32 unless the
    caller asks for the CPU); the solve's come from the conf."""

    def __init__(
        self,
        cache,
        scheduler_conf: str = "",
        schedule_period: float = 1.0,
        conf_path: Optional[str] = None,
        express: bool = False,
        pipeline: bool = False,
        device=None,
        dtype=None,
    ):
        self.cache = cache
        self.scheduler_conf = scheduler_conf or DEFAULT_SCHEDULER_CONF
        self.conf_path = conf_path
        self.schedule_period = schedule_period
        self.device = device
        self.dtype = dtype
        self.actions: List = []
        self.tiers: List[conf.Tier] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # express lane (volcano_tpu_torch/express): event-driven placement
        # of small interactive arrivals BETWEEN periodic sessions; the loop
        # services the lane's wake event during the inter-cycle wait, and
        # every full session reconciles
        self.express_lane = None
        self._express = express
        # continuous pipeline (volcano_tpu_torch/pipeline): double-buffered
        # sessions with speculative solve-ahead. VOLCANO_TPU_PIPELINE=0
        # keeps the serial run_once cycle (the byte-for-byte oracle)
        # regardless of this flag, and the degrade ladder's
        # pipeline_disabled rung falls back to it live.
        self._pipeline = pipeline
        self.pipeline_driver = None
        # conf-parse cache: the pipeline's speculation fingerprint keys on
        # the tiers OBJECT identity, so an unchanged conf text must hand
        # back the same parsed objects cycle over cycle
        self._conf_cache: Optional[Tuple[str, List, List[conf.Tier]]] = None
        # fault-degradation policy (scheduler/degrade.py): the process
        # default, so the solver's kernel hooks and this loop's session
        # gate share one ladder; embedders report remote-store health
        # through it too
        self.degrade = degrade_mod.default_ladder()

    # -- lifecycle ---------------------------------------------------------

    def set_fence_epoch(self, epoch) -> None:
        """Stamp the effector write-path with the leadership epoch the
        elector just acquired. Call BEFORE run() on each acquisition so
        no session of the new term writes unfenced."""
        self.cache.set_fence_epoch(epoch)

    def run(self) -> None:
        """Start cache sync then the periodic loop in a background thread
        (scheduler.go:63-69). Restartable: a leader elector may stop the
        loop on lost leadership and run it again on re-election."""
        self.cache.run()
        self.cache.wait_for_cache_sync()
        if self._express and self.express_lane is None:
            from volcano_tpu_torch.express import ExpressLane

            self.express_lane = ExpressLane(self.cache, device=self.device,
                                            dtype=self.dtype)
        if self.express_lane is not None:
            # re-acquired leadership (or plain restart): the lane resumes
            # from wherever the last term parked it
            self.express_lane.unpark()
        if self._pipeline and self.pipeline_driver is None:
            from volcano_tpu_torch.pipeline import PipelineDriver, pipeline_enabled

            if pipeline_enabled():
                self.pipeline_driver = PipelineDriver(
                    self.cache, self._cycle_policy, degrade=self.degrade)
        # fresh Event per generation: if stop()'s bounded join left a
        # previous loop thread mid-run_once, that zombie still sees ITS
        # (set) event and exits; clearing a shared event would revive it
        # alongside the new thread — two loops binding against one cache
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(self._stop,), daemon=True)
        self._thread.start()

    def stop(self, stop_cache: bool = True) -> None:
        if self.express_lane is not None:
            # failover hygiene: a stopping scheduler must not keep
            # optimistically binding between sessions; the lane's
            # outstanding tokens survive for the successor's first session
            self.express_lane.park("scheduler_stopped")
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.pipeline_driver is not None:
            # a stopping (possibly deposed) scheduler must not leave a
            # speculative solve pending — its result is discarded, never
            # applied. Abandoned after the loop thread is joined (the
            # reference abandons first, while the loop may still be
            # dispatching its next stage on its own thread)
            self.pipeline_driver.abandon()
        if stop_cache and hasattr(self.cache, "stop"):
            self.cache.stop()

    def _loop(self, stop: threading.Event) -> None:
        from volcano_tpu_torch.utils.gcpolicy import LowLatencyGC

        # automatic cyclic GC off while the loop runs: a full-heap scan
        # landing inside a session costs more than the session
        # (gcpolicy.py); young-gen collections run between cycles instead
        policy = LowLatencyGC.install()
        try:
            while not stop.is_set():
                start = time.perf_counter()
                if self.degrade.should_skip_session():
                    logger.warning(
                        "session skipped: store circuit open (%s)",
                        self.degrade.stats()["breakers"]["store"])
                    self._inter_cycle_wait(stop, self.schedule_period)
                    continue
                try:
                    if self.pipeline_driver is not None \
                            and self.degrade.pipeline_allowed():
                        self.run_once_pipelined()
                    else:
                        self.run_once()
                    self.degrade.note_store_ok()
                except Exception as e:
                    from volcano_tpu_torch.store.remote import RemoteStoreError

                    if isinstance(e, RemoteStoreError):
                        self.degrade.note_store_error()
                    logger.exception("scheduling cycle failed")
                policy.maintain()
                elapsed = time.perf_counter() - start
                self._inter_cycle_wait(
                    stop, max(self.schedule_period - elapsed, 0.0))
        finally:
            policy.uninstall()

    def _inter_cycle_wait(self, stop: threading.Event, budget: float) -> None:
        """Sleep until the next periodic session, servicing the express
        lane whenever its wake event fires: an eligible interactive
        arrival places within milliseconds instead of waiting out the
        period. Without a lane this is exactly stop.wait()."""
        lane = self.express_lane
        if lane is None:
            stop.wait(budget)
            return
        deadline = time.perf_counter() + budget
        while not stop.is_set():
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return
            # bounded slices keep stop() responsive while the lane idles
            if lane.wake.wait(timeout=min(remaining, 0.05)):
                if stop.is_set():
                    return
                try:
                    lane.run_once()
                except Exception:
                    logger.exception("express run failed")

    # -- one cycle ---------------------------------------------------------

    def load_conf(self) -> None:
        """Hot-reload the policy conf every cycle (scheduler.go:89-106).
        A transiently unreadable file falls back to the configured conf; a
        conf that fails to PARSE keeps the last good actions/tiers so a
        config typo degrades to a logged warning, not a scheduling outage."""
        conf_str = self.scheduler_conf
        if self.conf_path:
            try:
                conf_str = read_scheduler_conf(self.conf_path)
            except OSError as e:
                logger.error(
                    "failed to read scheduler conf %s, using configured "
                    "default: %s", self.conf_path, e)
        cached = self._conf_cache
        if cached is not None and cached[0] == conf_str:
            # unchanged text: reuse the parsed objects — the parse is
            # deterministic, and the pipeline's speculation fingerprint
            # needs stable tiers identity
            self.actions, self.tiers = cached[1], cached[2]
            return
        try:
            self.actions, self.tiers = load_scheduler_conf(conf_str)
            self._conf_cache = (conf_str, self.actions, self.tiers)
        except Exception as e:
            if self.actions:
                logger.error(
                    "invalid scheduler conf, keeping previous policy: %s", e)
            else:
                logger.error(
                    "invalid scheduler conf and no previous policy; "
                    "using default: %s", e)
                self.actions, self.tiers = load_scheduler_conf(
                    DEFAULT_SCHEDULER_CONF)

    def _cycle_policy(self):
        """PipelineDriver's per-cycle policy source: hot-reloads the conf
        (cached on unchanged text so the tiers object — and therefore the
        speculation fingerprint — is stable across steady-state cycles)."""
        self.load_conf()
        return self.actions, self.tiers

    def run_once_pipelined(self) -> dict:
        """One pipelined cycle: commit (or discard + re-run) the in-flight
        speculative session and leave the next cycle's solve dispatched.
        Returns the driver's cycle info. The serial run_once stays
        available behind VOLCANO_TPU_PIPELINE=0 and the pipeline_disabled
        degrade rung."""
        start = time.perf_counter()
        info = self.pipeline_driver.run_cycle()
        for name, ms in (info.get("action_ms") or {}).items():
            metrics.update_action_duration(name, ms / 1e3)
        metrics.update_e2e_duration(time.perf_counter() - start)
        return info

    def run_once(self) -> dict:
        """One serial cycle; returns {action name: wall ms}."""
        start = time.perf_counter()
        self.load_conf()

        ssn = open_session(self.cache, self.tiers)
        try:
            # fused whole-session dispatch when the session qualifies
            # (ops/session_fuse.py), per-action loop otherwise
            action_ms = run_actions(ssn, self.actions)
            for name, ms in action_ms.items():
                metrics.update_action_duration(name, ms / 1e3)
        finally:
            close_session(ssn)
        metrics.update_e2e_duration(time.perf_counter() - start)
        return action_ms
