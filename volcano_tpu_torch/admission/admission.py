"""Admission middleware on the store — the webhook analog
(volcano pkg/admission/{admission_controller,admit_job,mutate_job,admit_pod}.go).

``install(store)`` registers:
- Job mutator: default queue + default task names (mutate_job.go:77-116);
- Job validator: the full validation matrix (admit_job.go:77-202);
- Pod validator: the delay-pod-creation gate — pods of a Pending PodGroup
  are rejected until the scheduler's enqueue action flips it to Inqueue
  (admit_pod.go:94-143, docs/design/delay-pod-creation.md).
"""

from __future__ import annotations

import re
from typing import List, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobAction, JobEvent
from volcano_tpu_torch.store.store import AdmissionError, Store

DEFAULT_QUEUE = "default"
DEFAULT_TASK_SPEC = "task"

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")

# allow-maps: internal events/actions rejected (admission_controller.go:117-139)
VALID_POLICY_EVENTS = {
    JobEvent.ANY, JobEvent.POD_FAILED, JobEvent.POD_EVICTED, JobEvent.JOB_UNKNOWN,
    JobEvent.TASK_COMPLETED,
}
VALID_POLICY_ACTIONS = {
    JobAction.ABORT_JOB, JobAction.RESTART_JOB, JobAction.RESTART_TASK,
    JobAction.TERMINATE_JOB, JobAction.COMPLETE_JOB, JobAction.RESUME_JOB,
}


def is_dns1123_label(name: str) -> bool:
    return len(name) <= 63 and bool(_DNS1123.match(name))


def validate_policies(policies: List[objects.LifecyclePolicy]) -> str:
    """(admission_controller.go:123-180)"""
    seen_events = set()
    seen_exit_codes = set()
    for policy in policies:
        has_event = bool(policy.event or policy.events)
        if has_event and policy.exit_code is not None:
            return "must not specify event and exitCode simultaneously;"
        if not has_event and policy.exit_code is None:
            return "either event and exitCode should be specified;"
        if has_event:
            events = list(policy.events)
            if policy.event:
                events.append(policy.event)
            for event in events:
                if event not in VALID_POLICY_EVENTS:
                    return f"invalid policy event: {event};"
                if policy.action not in VALID_POLICY_ACTIONS:
                    return f"invalid policy action: {policy.action};"
                if event in seen_events:
                    return f"duplicate event {event} across different policy;"
                seen_events.add(event)
        else:
            if policy.exit_code == 0:
                return "0 is not a valid error code;"
            if policy.exit_code in seen_exit_codes:
                return f"duplicate exitCode {policy.exit_code};"
            seen_exit_codes.add(policy.exit_code)
    return ""


def validate_job(store: Optional[Store], job: objects.Job) -> None:
    """Raises AdmissionError on the first/accumulated violations
    (admit_job.go:77-167)."""
    if job.spec.min_available <= 0:
        raise AdmissionError("'minAvailable' must be greater than zero.")
    if job.spec.max_retry < 0:
        raise AdmissionError("'maxRetry' cannot be less than zero.")
    if (job.spec.ttl_seconds_after_finished is not None
            and job.spec.ttl_seconds_after_finished < 0):
        raise AdmissionError("'ttlSecondsAfterFinished' cannot be less than zero.")
    if not job.spec.tasks:
        raise AdmissionError("No task specified in job spec")

    msg = ""
    task_names = set()
    total_replicas = 0
    for task in job.spec.tasks:
        if task.replicas <= 0:
            msg += f" 'replicas' is not set positive in task: {task.name};"
        total_replicas += task.replicas
        if not is_dns1123_label(task.name):
            msg += (f" task name {task.name!r} must be a lowercase RFC 1123 "
                    f"label;")
        if task.name in task_names:
            msg += f" duplicated task name {task.name};"
            break
        task_names.add(task.name)
        msg += validate_policies(task.policies)
        if not task.template.spec.containers:
            msg += f" task {task.name} has no containers;"

    if total_replicas < job.spec.min_available:
        msg += " 'minAvailable' should not be greater than total replicas in tasks;"

    msg += validate_policies(job.spec.policies)

    from volcano_tpu_torch.controllers.job import plugins as job_plugins

    for name in job.spec.plugins:
        if job_plugins.get_plugin_builder(name) is None:
            msg += f" unable to find job plugin: {name}"

    if store is not None and job.spec.queue:
        if store.try_get("Queue", "", job.spec.queue) is None:
            msg += f" unable to find job queue: {job.spec.queue}"

    if msg:
        raise AdmissionError(msg.strip())


def mutate_job(job: objects.Job) -> None:
    """Default queue + default task names (mutate_job.go:77-116)."""
    if not job.spec.queue:
        job.spec.queue = DEFAULT_QUEUE
    for index, task in enumerate(job.spec.tasks):
        if not task.name:
            task.name = f"{DEFAULT_TASK_SPEC}{index}"


def validate_pod(store: Store, pod: objects.Pod,
                 scheduler_name: str = "volcano") -> None:
    """The delay-pod-creation gate (admit_pod.go:94-143)."""
    if pod.spec.scheduler_name != scheduler_name:
        return
    pg_name = pod.metadata.annotations.get(objects.GROUP_NAME_ANNOTATION_KEY, "")
    if pg_name:
        pg = store.try_get("PodGroup", pod.metadata.namespace, pg_name)
        if pg is None:
            raise AdmissionError(
                f"Failed to get PodGroup for pod "
                f"<{pod.metadata.namespace}/{pod.metadata.name}>: not found")
        if pg.status.phase == objects.PodGroupPhase.PENDING:
            raise AdmissionError(
                f"Failed to create pod <{pod.metadata.namespace}/"
                f"{pod.metadata.name}>, because the podgroup phase is Pending")
        return
    # normal pod: gate only if its auto-created podgroup exists and is Pending
    pg = store.try_get("PodGroup", pod.metadata.namespace,
                       f"podgroup-{pod.metadata.uid}")
    if pg is not None and pg.status.phase == objects.PodGroupPhase.PENDING:
        raise AdmissionError(
            f"Failed to create pod <{pod.metadata.namespace}/"
            f"{pod.metadata.name}>, because the podgroup phase is Pending")


def install(store: Store, scheduler_name: str = "volcano",
            gate_pods: bool = True) -> None:
    """Register the webhook analogs as store admission middleware."""
    store.register_admission(
        "Job",
        mutator=lambda job: mutate_job(job),
        validator=lambda job: validate_job(store, job),
    )
    if gate_pods:
        store.register_admission(
            "Pod",
            validator=lambda pod: validate_pod(store, pod, scheduler_name),
        )
