"""vcctl job commands: run/list/view/suspend/resume/delete
(volcano pkg/cli/job/).

Suspend/resume go through the Command bus exactly like the reference
(suspend.go/resume.go -> util.go CreateCommand -> bus Command CR consumed by
the job controller's exactly-once delete-then-execute path).

Port of volcano_tpu/cli/job.py. One trim: the manifest is read by the
port's own YAML reader (utils/yaml_subset.py; the machine with the card
has no PyYAML), and ``job_from_doc`` takes an already parsed manifest, so
a ``--cluster-state`` corpus hands each Job over as its mapping instead of
re-dumping it to text.
"""

from __future__ import annotations

import io
import time
from typing import Dict, List, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobAction
from volcano_tpu_torch.store.store import Store
from volcano_tpu_torch.utils.yaml_subset import parse_yaml

LIST_COLUMNS = ("Name", "Creation", "Phase", "Replicas", "Min", "Scheduler",
                "Pending", "Running", "Succeeded", "Failed", "Unknown",
                "RetryCount")


def job_from_yaml(text: str) -> objects.Job:
    """Parse a vcctl-style job YAML (example/job.yaml shape)."""
    return job_from_doc(parse_yaml(text))


def job_from_doc(data: dict) -> objects.Job:
    """A Job from a parsed vcctl-style manifest."""
    meta = data.get("metadata", {})
    spec = data.get("spec", {})
    tasks = []
    for t in spec.get("tasks", []) or []:
        template = t.get("template", {})
        tspec = template.get("spec", {})
        containers = []
        for c in tspec.get("containers", []) or []:
            resources = c.get("resources", {}) or {}
            containers.append(objects.Container(
                name=c.get("name", ""),
                image=c.get("image", ""),
                command=list(c.get("command", []) or []),
                requests=dict(resources.get("requests", {}) or {}),
                limits=dict(resources.get("limits", {}) or {}),
            ))
        policies = [
            objects.LifecyclePolicy(
                action=p.get("action", ""), event=p.get("event", ""),
                events=list(p.get("events", []) or []),
                exit_code=p.get("exitCode"))
            for p in t.get("policies", []) or []
        ]
        tasks.append(objects.TaskSpec(
            name=t.get("name", ""),
            replicas=int(t.get("replicas", 0)),
            template=objects.PodTemplateSpec(
                metadata=objects.ObjectMeta(
                    labels=dict((template.get("metadata") or {}).get("labels", {}) or {})),
                spec=objects.PodSpec(
                    containers=containers,
                    restart_policy=tspec.get("restartPolicy", "Always"),
                ),
            ),
            policies=policies,
        ))
    policies = [
        objects.LifecyclePolicy(
            action=p.get("action", ""), event=p.get("event", ""),
            events=list(p.get("events", []) or []),
            exit_code=p.get("exitCode"))
        for p in spec.get("policies", []) or []
    ]
    plugins = {name: list(args or []) for name, args in
               (spec.get("plugins", {}) or {}).items()}
    job = objects.Job(
        metadata=objects.ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
        ),
        spec=objects.JobSpec(
            min_available=int(spec.get("minAvailable", 0)),
            scheduler_name=spec.get("schedulerName", "volcano"),
            queue=spec.get("queue", ""),
            max_retry=int(spec.get("maxRetry", 3)),
            ttl_seconds_after_finished=spec.get("ttlSecondsAfterFinished"),
            tasks=tasks,
            policies=policies,
            plugins=plugins,
        ),
    )
    return job


def run_job(store: Store, yaml_text: str) -> objects.Job:
    """vcctl job run -f job.yaml (run.go:55-80)."""
    job = job_from_yaml(yaml_text)
    return store.create(job)


def create_command(store: Store, namespace: str, name: str, action: str) -> objects.Command:
    """(cli/job/util.go CreateCommand)"""
    cmd = objects.Command(
        metadata=objects.ObjectMeta(
            name=f"{name}-{action.lower()}-{int(time.time() * 1000) % 100000}",
            namespace=namespace),
        action=action,
        target_object=objects.OwnerReference(kind=objects.Job.KIND, name=name),
    )
    return store.create(cmd)


def suspend_job(store: Store, namespace: str, name: str) -> objects.Command:
    """vcctl job suspend == AbortJob command (suspend.go)."""
    return create_command(store, namespace, name, JobAction.ABORT_JOB)


def resume_job(store: Store, namespace: str, name: str) -> objects.Command:
    """vcctl job resume == ResumeJob command (resume.go)."""
    return create_command(store, namespace, name, JobAction.RESUME_JOB)


def delete_job(store: Store, namespace: str, name: str) -> None:
    store.delete("Job", namespace, name)


def _fmt_age(created: float) -> str:
    age = max(time.time() - created, 0)
    if age < 60:
        return f"{int(age)}s"
    if age < 3600:
        return f"{int(age // 60)}m"
    return f"{int(age // 3600)}h"


def list_jobs(store: Store, namespace: Optional[str] = "default",
              all_namespaces: bool = False,
              selector: str = "") -> str:
    """vcctl job list table (list.go:95-150)."""
    jobs: List[objects.Job] = store.list(
        "Job", namespace=None if all_namespaces else namespace)
    if selector:
        jobs = [j for j in jobs if selector in j.metadata.name]
    out = io.StringIO()
    header = LIST_COLUMNS if not all_namespaces else ("Namespace", *LIST_COLUMNS)
    out.write("".join(f"{h:<12}" for h in header).rstrip() + "\n")
    for job in sorted(jobs, key=lambda j: (j.metadata.namespace, j.metadata.name)):
        replicas = sum(t.replicas for t in job.spec.tasks)
        s = job.status
        row = []
        if all_namespaces:
            row.append(job.metadata.namespace)
        row.extend([
            job.metadata.name, _fmt_age(job.metadata.creation_timestamp),
            s.state.phase, replicas, job.spec.min_available,
            job.spec.scheduler_name, s.pending, s.running, s.succeeded,
            s.failed, s.unknown, s.retry_count,
        ])
        out.write("".join(f"{str(v):<12}" for v in row).rstrip() + "\n")
    return out.getvalue()


def view_job(store: Store, namespace: str, name: str) -> str:
    """vcctl job view: object dump + recorded events (view.go)."""
    job = store.get("Job", namespace, name)
    out = io.StringIO()
    out.write(f"Name:       \t{job.metadata.name}\n")
    out.write(f"Namespace:  \t{job.metadata.namespace}\n")
    out.write(f"Phase:      \t{job.status.state.phase}\n")
    out.write(f"MinAvailable:\t{job.spec.min_available}\n")
    out.write(f"Queue:      \t{job.spec.queue}\n")
    out.write(f"RetryCount: \t{job.status.retry_count}\n")
    out.write(f"Version:    \t{job.status.version}\n")
    out.write("Tasks:\n")
    for t in job.spec.tasks:
        out.write(f"  {t.name}\treplicas: {t.replicas}\n")
    status = (f"pending: {job.status.pending}, running: {job.status.running}, "
              f"succeeded: {job.status.succeeded}, failed: {job.status.failed}")
    out.write(f"Status:     \t{status}\n")
    events = store.events_for(job)
    if events:
        out.write("Events:\n")
        for e in events:
            out.write(f"  {e.event_type}\t{e.reason}\t{e.message}\n")
    return out.getvalue()
