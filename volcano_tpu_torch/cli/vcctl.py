"""vcctl — the CLI entry (volcano cmd/cli/vcctl.go:34).

Two modes, mirroring the reference's remote-client design:

- ``--server host:port`` drives a LIVE cluster process over HTTP through
  the store gateway (``python -m volcano_tpu_torch.scheduler --api-address``),
  exactly as the reference vcctl is a network client of the API server
  (pkg/cli/job/run.go:55-80). All job/queue subcommands work this way:

      vcctl --server localhost:11280 job run -f example/job.yaml
      vcctl --server localhost:11280 job list
      vcctl --server localhost:11280 job suspend -n default -N test-job
      vcctl --server localhost:11280 queue list

- ``demo`` spins a full in-process Cluster and runs a job end-to-end
  (library use against any Store stays available via cli/job.py,
  cli/queue.py).
"""

from __future__ import annotations

import argparse
import sys

from volcano_tpu_torch.cli import job as job_cli
from volcano_tpu_torch.cli import queue as queue_cli

DEMO_JOB_YAML = """
apiVersion: batch.volcano.sh/v1alpha1
kind: Job
metadata:
  name: test-job
  namespace: default
spec:
  minAvailable: 3
  schedulerName: volcano
  queue: default
  plugins:
    ssh: []
    env: []
    svc: []
  policies:
    - event: PodEvicted
      action: RestartJob
  tasks:
    - replicas: 1
      name: mpimaster
      template:
        spec:
          containers:
            - image: mpi-image
              name: mpimaster
              resources:
                requests:
                  cpu: "500m"
    - replicas: 2
      name: mpiworker
      template:
        spec:
          containers:
            - image: mpi-image
              name: mpiworker
              resources:
                requests:
                  cpu: "1000m"
"""


def demo(args) -> int:
    from volcano_tpu_torch.cluster import Cluster
    from volcano_tpu_torch.scheduler.util.test_utils import (
        build_node, build_resource_list_with_pods)

    yaml_text = DEMO_JOB_YAML
    if args.job:
        with open(args.job) as f:
            yaml_text = f.read()

    cluster = Cluster()
    for n in range(args.nodes):
        cluster.store.create(build_node(
            f"node-{n}", build_resource_list_with_pods("8", "16Gi")))

    print(f"# vcctl job run -f {args.job or '<demo>'}")
    job = job_cli.run_job(cluster.store, yaml_text)
    cluster.settle(5)

    print("# vcctl job list")
    print(job_cli.list_jobs(cluster.store, namespace=job.metadata.namespace))
    print(f"# vcctl job view -n {job.metadata.namespace} -N {job.metadata.name}")
    print(job_cli.view_job(cluster.store, job.metadata.namespace, job.metadata.name))
    print("# vcctl queue list")
    print(queue_cli.list_queues(cluster.store))

    print(f"# vcctl job suspend -N {job.metadata.name}")
    job_cli.suspend_job(cluster.store, job.metadata.namespace, job.metadata.name)
    cluster.settle(4)
    print(job_cli.list_jobs(cluster.store, namespace=job.metadata.namespace))

    print(f"# vcctl job resume -N {job.metadata.name}")
    job_cli.resume_job(cluster.store, job.metadata.namespace, job.metadata.name)
    cluster.settle(6)
    print(job_cli.list_jobs(cluster.store, namespace=job.metadata.namespace))
    return 0


def _remote(args):
    from volcano_tpu_torch.store.remote import RemoteStore

    if not args.server:
        print("error: this subcommand needs --server host:port "
              "(a cluster process run with --api-address)", file=sys.stderr)
        return None
    return RemoteStore(args.server, token=args.token or None,
                       tls_verify=not args.insecure_skip_tls_verify)


def run_remote(args) -> int:
    store = _remote(args)
    if store is None:
        return 2
    cmd, sub = args.command, args.subcommand
    try:
        if cmd == "job":
            if sub == "run":
                with open(args.file) as f:
                    job = job_cli.run_job(store, f.read())
                print(f"job {job.metadata.namespace}/{job.metadata.name} created")
            elif sub == "list":
                print(job_cli.list_jobs(
                    store, namespace=args.namespace,
                    all_namespaces=args.all_namespaces,
                    selector=args.selector), end="")
            elif sub == "view":
                print(job_cli.view_job(store, args.namespace, args.name), end="")
            elif sub == "suspend":
                job_cli.suspend_job(store, args.namespace, args.name)
                print(f"suspend command issued for {args.namespace}/{args.name}")
            elif sub == "resume":
                job_cli.resume_job(store, args.namespace, args.name)
                print(f"resume command issued for {args.namespace}/{args.name}")
            elif sub == "delete":
                job_cli.delete_job(store, args.namespace, args.name)
                print(f"job {args.namespace}/{args.name} deleted")
        elif cmd == "queue":
            if sub == "create":
                queue_cli.create_queue(store, args.name, weight=args.weight)
                print(f"queue {args.name} created")
            elif sub == "get":
                print(queue_cli.get_queue(store, args.name), end="")
            elif sub == "list":
                print(queue_cli.list_queues(store), end="")
        return 0
    except Exception as e:  # served-boundary errors print, not traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vcctl")
    ap.add_argument("--server", default="",
                    help="cluster API gateway host:port (remote mode)")
    ap.add_argument("--token", default="",
                    help="bearer token for a gateway started with --api-token")
    ap.add_argument("--insecure-skip-tls-verify", action="store_true",
                    help="accept self-signed gateway certificates (https)")
    sub = ap.add_subparsers(dest="command", required=True)

    demo_p = sub.add_parser("demo", help="run a full in-process cluster demo")
    demo_p.add_argument("--job", help="job YAML file (default: built-in MPI-style job)")
    demo_p.add_argument("--nodes", type=int, default=3)

    job_p = sub.add_parser("job", help="job operations (remote: --server)")
    job_sub = job_p.add_subparsers(dest="subcommand", required=True)
    p = job_sub.add_parser("run")
    p.add_argument("-f", "--file", required=True)
    p = job_sub.add_parser("list")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--all-namespaces", action="store_true")
    p.add_argument("--selector", default="")
    for name in ("view", "suspend", "resume", "delete"):
        p = job_sub.add_parser(name)
        p.add_argument("-n", "--namespace", default="default")
        p.add_argument("-N", "--name", required=True)

    queue_p = sub.add_parser("queue", help="queue operations (remote: --server)")
    queue_sub = queue_p.add_subparsers(dest="subcommand", required=True)
    p = queue_sub.add_parser("create")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-w", "--weight", type=int, default=1)
    p = queue_sub.add_parser("get")
    p.add_argument("-N", "--name", required=True)
    queue_sub.add_parser("list")

    sub.add_parser("version", help="print version/build metadata "
                                   "(vcctl version)")

    args = ap.parse_args(argv)
    if args.command == "version":
        from volcano_tpu_torch import version

        sys.stdout.write(version.version_string())
        return 0
    if args.command == "demo":
        return demo(args)
    return run_remote(args)


if __name__ == "__main__":
    sys.exit(main())
