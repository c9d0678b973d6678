"""vc-scheduler binary equivalent: ``python -m volcano_tpu_torch.scheduler``.

Maps the reference's flag surface (cmd/scheduler/app/options/options.go:78-108
+ server.go:76-160) onto the in-process substrate:

- ``--scheduler-name/--scheduler-conf/--schedule-period/--default-queue`` as
  in the reference;
- ``--leader-elect`` runs the loop behind a store resource-lock election
  (server.go:131-160); only the leader schedules;
- ``--listen-address`` serves /metrics, ``--healthz-address`` serves
  /healthz (server.go:97-100; apis/helpers.go:164);
- node-sampling knobs land in options.ServerOpts exactly where
  scheduler_helper reads them (scheduler_helper.go:43);
- ``--cluster-state`` seeds the store from a YAML corpus (nodes/queues/jobs)
  so a standalone run has something to schedule; without an external API
  server the full cluster (controllers + kubelet sim) runs in-process.

``--run-for N`` exits after N seconds (the e2e/smoke hook); default runs
until SIGINT.

Port of volcano_tpu/scheduler/__main__.py. The solve runs where the
conf's tpuscore arguments say (``tpuscore.device``, cuda by default).
Without ``--scheduler-conf`` the daemon schedules with the batch-solve
conf (``TPU_SCHEDULER_CONF``), on the card; the reference's default is
its serial conf. A scheduling daemon resolves its conf's solve device
before its loop starts, so on a host without a card it exits with
``DeviceUnavailable`` unless its conf names ``tpuscore.device: cpu`` (the
tests do). No flag is added. One trim: PyYAML. A ``--cluster-state``
corpus is read by the port's own reader (utils/yaml_subset.py), and each
Job goes to the CLI loader as its parsed mapping
(``cli/job.job_from_doc``), not re-dumped to text.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from volcano_tpu_torch import version
from volcano_tpu_torch.scheduler import options


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="vc-scheduler")
    d = options.ServerOpts()
    ap.add_argument("--scheduler-name", default=d.scheduler_name,
                    help="only pods with this schedulerName are scheduled")
    ap.add_argument("--scheduler-conf", default="",
                    help="policy YAML path, hot-reloaded every cycle")
    ap.add_argument("--schedule-period", type=float,
                    default=d.schedule_period_seconds, metavar="SECONDS")
    ap.add_argument("--default-queue", default=d.default_queue)
    ap.add_argument("--express", action="store_true", default=False,
                    help="enable the event-driven express lane: eligible "
                         "interactive arrivals place between periodic "
                         "sessions (volcano_tpu_torch/express)")
    ap.add_argument("--pipeline", action="store_true", default=False,
                    help="enable the continuous scheduling pipeline: "
                         "double-buffered sessions with speculative "
                         "solve-ahead (volcano_tpu_torch/pipeline); "
                         "VOLCANO_TPU_PIPELINE=0 forces the serial loop")
    ap.add_argument("--leader-elect", action="store_true", default=False)
    ap.add_argument("--lock-object-namespace", default="volcano-system")
    ap.add_argument("--leader-elect-identity", default="",
                    help="holder identity (default: host-pid)")
    ap.add_argument("--listen-address", default=d.listen_address,
                    help="metrics address (reference :8080)")
    ap.add_argument("--healthz-address", default=d.healthz_address)
    ap.add_argument("--minimum-feasible-nodes", type=int,
                    default=d.min_nodes_to_find)
    ap.add_argument("--minimum-percentage-of-nodes-to-find", type=int,
                    default=d.min_percentage_of_nodes_to_find)
    ap.add_argument("--percentage-of-nodes-to-find", type=int,
                    default=d.percentage_of_nodes_to_find)
    ap.add_argument("--cluster-state", default="",
                    help="YAML corpus seeding nodes/queues/jobs (example/)")
    ap.add_argument("--api-address", default="",
                    help="serve the store API gateway (vcctl --server "
                         "target) on this address; ':0' picks a free port")
    ap.add_argument("--api-token", default="",
                    help="require 'Authorization: Bearer <token>' on every "
                         "gateway request (mandatory for non-loopback "
                         "--api-address)")
    ap.add_argument("--api-tls-cert", default="",
                    help="serve the gateway over HTTPS with this cert chain")
    ap.add_argument("--api-tls-key", default="",
                    help="private key for --api-tls-cert")
    ap.add_argument("--api-server-only", action="store_true",
                    help="run store + admission + controllers + kubelet + "
                         "gateway WITHOUT the in-process scheduler: an "
                         "out-of-process scheduler consumes this process "
                         "over RemoteStore watches (use with "
                         "--api-address)")
    ap.add_argument("--server", default="",
                    help="remote-scheduler mode: run ONLY the scheduler "
                         "stack against an --api-server-only cluster "
                         "process at host:port — informers over HTTP "
                         "long-poll, binds/statuses written back through "
                         "the gateway (the vc-scheduler-vs-API-server "
                         "process split)")
    ap.add_argument("--token", default="",
                    help="bearer token for a --server gateway started "
                         "with --api-token")
    ap.add_argument("--insecure-skip-tls-verify", action="store_true",
                    help="accept self-signed gateway certificates "
                         "(https --server)")
    ap.add_argument("--run-for", type=float, default=0.0,
                    help="exit after N seconds (0 = until SIGINT)")
    ap.add_argument("--version", action="store_true")
    ap.add_argument("-v", "--verbosity", type=int, default=0)
    return ap.parse_args(argv)


def seed_cluster_state(store, path: str) -> None:
    """Load a multi-document YAML corpus into the store: Node/Queue docs go
    in directly; Job docs go through the CLI loader (admission applies)."""
    from volcano_tpu_torch.api import objects
    from volcano_tpu_torch.cli import job as job_cli
    from volcano_tpu_torch.utils.yaml_subset import parse_yaml_all

    with open(path) as f:
        docs = [d for d in parse_yaml_all(f.read()) if d]
    for doc in docs:
        kind = doc.get("kind", "")
        meta = doc.get("metadata", {}) or {}
        if kind == "Node":
            cap = (doc.get("status", {}) or {}).get("capacity", {}) or {}
            capacity = {
                "cpu": str(cap.get("cpu", "8")),
                "memory": str(cap.get("memory", "16Gi")),
                "pods": str(cap.get("pods", "110")),
            }
            node = objects.Node(
                metadata=objects.ObjectMeta(
                    name=meta.get("name", "node"),
                    labels=dict(meta.get("labels") or {})),
                status=objects.NodeStatus(
                    capacity=dict(capacity), allocatable=dict(capacity),
                    conditions=[objects.NodeCondition(
                        type="Ready", status="True")]))
            if store.try_get("Node", "", node.metadata.name) is None:
                store.create(node)
        elif kind == "Queue":
            spec = doc.get("spec", {}) or {}
            q = objects.Queue(
                metadata=objects.ObjectMeta(name=meta.get("name", "default")),
                spec=objects.QueueSpec(weight=int(spec.get("weight", 1))))
            if store.try_get("Queue", "", q.metadata.name) is None:
                store.create(q)
        elif kind == "Job":
            name = meta.get("name", "")
            ns = meta.get("namespace", "default")
            if name and store.try_get("Job", ns, name) is not None:
                continue  # re-seed (restart / HA standby): already present
            store.create(job_cli.job_from_doc(doc))


def check_solve_device(args) -> None:
    """Resolve the device of the conf's tpuscore solve (``--scheduler-conf``
    as it reads now, else ``TPU_SCHEDULER_CONF``): a cuda solve on a host
    without a card raises ``DeviceUnavailable`` here, before the loop
    starts, instead of failing every cycle behind the loop's
    log-and-continue."""
    from volcano_tpu_torch import device as devmod
    from volcano_tpu_torch.scheduler.framework.arguments import Arguments
    from volcano_tpu_torch.scheduler.plugins import tpuscore
    from volcano_tpu_torch.scheduler.scheduler import (
        TPU_SCHEDULER_CONF, load_scheduler_conf, read_scheduler_conf)

    text = TPU_SCHEDULER_CONF
    if args.scheduler_conf:
        try:
            text = read_scheduler_conf(args.scheduler_conf)
        except OSError:
            pass  # the loop falls back to the configured conf, as here
    for tier in load_scheduler_conf(text)[1]:
        for option in tier.plugins:
            conf_args = Arguments(option.arguments)
            if option.name == tpuscore.PLUGIN_NAME \
                    and conf_args.get_bool(tpuscore.ENABLE, True):
                devmod.resolve_device(
                    str(conf_args.get(tpuscore.DEVICE, "cuda")) or "cuda")


def _make_elector(args, store, run_workload, stop_workload, fence=None):
    """Leader-elect wiring shared by the in-process and remote modes:
    identity derivation, the store-backed ConfigMap lock, and the elector
    whose callbacks start/stop the mode's workload. ``fence`` (called
    with the acquired epoch BEFORE the workload starts) stamps the
    fencing token onto the effector write-path, so no session of the new
    term ever writes unfenced (store/store.py FencedError)."""
    import os
    import socket

    from volcano_tpu_torch.scheduler.leaderelection import (
        LeaderElector, ResourceLock)

    identity = (args.leader_elect_identity
                or f"{socket.gethostname()}-{os.getpid()}")
    lock = ResourceLock(
        store, args.lock_object_namespace, args.scheduler_name, identity)
    holder = {}

    def on_started():
        if fence is not None:
            fence(holder["elector"].epoch())
        run_workload()

    elector = LeaderElector(
        lock,
        on_started_leading=on_started,
        on_stopped_leading=stop_workload)
    holder["elector"] = elector
    elector.start()
    logging.info("leader election enabled (identity=%s)", identity)
    return elector


def _wait_for_signal_or_deadline(args, stop_evt) -> None:
    """Install SIGINT/SIGTERM -> stop_evt, wait (bounded by --run-for),
    restore handlers — the run-loop scaffold shared by the in-process and
    remote-scheduler modes."""

    def on_signal(signum, frame):
        stop_evt.set()

    prev_handlers = {}
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev_handlers[sig] = signal.signal(sig, on_signal)
    except ValueError:
        pass  # not the main thread (tests drive main() directly)

    try:
        stop_evt.wait(timeout=args.run_for or None)
    finally:
        stop_evt.set()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)


def run_remote_scheduler(args) -> int:
    """The scheduler as its own OS process against a remote API-server
    process (one run with --api-server-only --api-address): informer
    streams arrive over RemoteStore long-poll watches, effector writes
    (binds, conditions, statuses) return through the gateway, and leader
    election CASes the same remote ConfigMap lock — the reference's
    vc-scheduler binary shape (cmd/scheduler/app/server.go)."""

    from volcano_tpu_torch.scheduler.cache import SchedulerCache
    from volcano_tpu_torch.scheduler.httpserver import ObservabilityServer
    from volcano_tpu_torch.scheduler.scheduler import (
        TPU_SCHEDULER_CONF, Scheduler)
    from volcano_tpu_torch.store.remote import RemoteStore

    remote = RemoteStore(args.server, token=args.token or None,
                         tls_verify=not args.insecure_skip_tls_verify)
    if not remote.healthy():
        logging.error("gateway at %s is not reachable/healthy", args.server)
        return 1
    if args.cluster_state:
        # the seed corpus goes THROUGH the gateway (admission applies
        # server-side), so a seeded remote run schedules rather than
        # silently seeing an empty cluster
        seed_cluster_state(remote, args.cluster_state)
    cache = SchedulerCache(
        store=remote, scheduler_name=args.scheduler_name,
        default_queue=args.default_queue)
    cache.run()
    scheduler = Scheduler(
        cache, scheduler_conf=TPU_SCHEDULER_CONF,
        schedule_period=args.schedule_period,
        express=args.express, pipeline=args.pipeline)
    if args.scheduler_conf:
        scheduler.conf_path = args.scheduler_conf

    stop_evt = threading.Event()
    ha_member = None
    metrics_srv = ObservabilityServer(args.listen_address).start()
    healthz_srv = ObservabilityServer(
        args.healthz_address,
        healthy=lambda: not stop_evt.is_set()
        and (ha_member is None or ha_member.healthy())
        and remote.healthy(timeout=2.0)).start()
    logging.info(
        "remote scheduler against %s; metrics on :%d/metrics, healthz on "
        ":%d/healthz", args.server, metrics_srv.port, healthz_srv.port)

    if args.leader_elect:
        # the full HA member shape (scheduler/ha.py): the lock ConfigMap
        # lives in the REMOTE store — competing scheduler processes CAS
        # the same record through the gateway, the gateway's store
        # advances its fence from the winning lease, and the loser's
        # in-flight writes are rejected server-side. While standby, the
        # cache keeps following the watch stream and the snapshot keeper
        # stays warm for a bounded takeover.
        from volcano_tpu_torch.scheduler.ha import FailoverScheduler

        ha_member = FailoverScheduler(
            scheduler, remote,
            lock_namespace=args.lock_object_namespace,
            lock_name=args.scheduler_name,
            identity=args.leader_elect_identity).start()
    else:
        scheduler.run()

    _wait_for_signal_or_deadline(args, stop_evt)

    if ha_member is not None:
        ha_member.stop()
    else:
        scheduler.stop()
    remote.flush_events()
    remote.stop_watches()
    metrics_srv.stop()
    healthz_srv.stop()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.version:
        sys.stdout.write(version.version_string())
        return 0
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 3 else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")

    # flags land in the global ServerOpts read by scheduler_helper
    o = options.server_opts
    o.scheduler_name = args.scheduler_name
    o.scheduler_conf = args.scheduler_conf
    o.schedule_period_seconds = args.schedule_period
    o.default_queue = args.default_queue
    o.enable_leader_election = args.leader_elect
    o.min_nodes_to_find = args.minimum_feasible_nodes
    o.min_percentage_of_nodes_to_find = args.minimum_percentage_of_nodes_to_find
    o.percentage_of_nodes_to_find = args.percentage_of_nodes_to_find
    o.listen_address = args.listen_address
    o.healthz_address = args.healthz_address

    if not args.api_server_only:
        check_solve_device(args)
    if args.server:
        return run_remote_scheduler(args)

    from volcano_tpu_torch.cluster import Cluster
    from volcano_tpu_torch.scheduler.httpserver import ObservabilityServer
    from volcano_tpu_torch.scheduler.scheduler import TPU_SCHEDULER_CONF

    cluster = Cluster(
        scheduler_conf=TPU_SCHEDULER_CONF,
        scheduler_name=args.scheduler_name,
        default_queue=args.default_queue,
        schedule_period=args.schedule_period)
    if args.scheduler_conf:
        cluster.scheduler.conf_path = args.scheduler_conf
    if args.cluster_state:
        seed_cluster_state(cluster.store, args.cluster_state)

    stop_evt = threading.Event()
    elector = None
    metrics_srv = ObservabilityServer(args.listen_address).start()
    # healthz tracks elector liveness too: a dead elector thread means no
    # scheduler is running even though the process is up
    healthz_srv = ObservabilityServer(
        args.healthz_address,
        healthy=lambda: not stop_evt.is_set()
        and (elector is None or elector.healthy())).start()
    logging.info("metrics on :%d/metrics, healthz on :%d/healthz",
                 metrics_srv.port, healthz_srv.port)

    api_srv = None
    if args.api_address:
        from volcano_tpu_torch.store.gateway import ApiGateway

        api_srv = ApiGateway(
            cluster.store, args.api_address,
            token=args.api_token or None,
            tls_cert=args.api_tls_cert or None,
            tls_key=args.api_tls_key or None).start()
        # the flush=True print is the port-discovery contract for tools
        # spawning this process with --api-address :0
        print(f"api gateway on :{api_srv.port}", flush=True)
        logging.info("api gateway on :%d (vcctl --server target)",
                     api_srv.port)

    if args.leader_elect:
        elector = _make_elector(
            args, cluster.store,
            lambda: cluster.run(scheduling=not args.api_server_only),
            cluster.stop,
            fence=cluster.cache.set_fence_epoch)
    else:
        cluster.run(scheduling=not args.api_server_only)

    _wait_for_signal_or_deadline(args, stop_evt)

    if elector is not None:
        elector.stop()
    else:
        cluster.stop()
    if api_srv is not None:
        api_srv.stop()
    metrics_srv.stop()
    healthz_srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
