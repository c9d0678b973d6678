"""Lifecycle policy engine: (event, exitCode) -> action
(volcano pkg/controllers/job/job_controller_util.go:129-186)."""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobAction, JobEvent
from volcano_tpu_torch.controllers.apis import Request


def _event_list(policy: objects.LifecyclePolicy) -> List[str]:
    events = list(policy.events)
    if policy.event:
        events.append(policy.event)
    return events


def _match(policies: List[objects.LifecyclePolicy], req: Request) -> str:
    for policy in policies:
        events = _event_list(policy)
        if events and req.event:
            if req.event in events or JobEvent.ANY in events:
                return policy.action
        # 0 is not an error code (rejected by admission validation)
        if policy.exit_code is not None and policy.exit_code == req.exit_code:
            return policy.action
    return ""


def apply_policies(job: objects.Job, req: Request) -> str:
    """Task-level policies override job-level; stale requests (version <
    Status.Version) degrade to Sync (job_controller_util.go:140-143)."""
    if req.action:
        return req.action

    if req.event == JobEvent.OUT_OF_SYNC:
        return JobAction.SYNC_JOB

    # requests from discarded job incarnations perform sync instead
    if req.job_version < job.status.version:
        return JobAction.SYNC_JOB

    if req.task_name:
        for task in job.spec.tasks:
            if task.name == req.task_name:
                action = _match(task.policies, req)
                if action:
                    return action
                break

    action = _match(job.spec.policies, req)
    if action:
        return action

    return JobAction.SYNC_JOB
