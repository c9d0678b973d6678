"""Job state machine — 8 states x actions
(volcano pkg/controllers/job/state/*.go).

Each state's ``execute(action)`` dispatches to the controller-injected
SyncJob/KillJob action fns (function injection exactly like
job_controller.go:218-219: ``state.SyncJob = cc.syncJob``), passing an
update_status_fn closure that decides the phase transition.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Set

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.objects import JobAction, JobPhase
from volcano_tpu_torch.controllers.apis import JobInfo

DEFAULT_MAX_RETRY = 3

# pods in these phases survive a kill (state/factory.go:27-42)
POD_RETAIN_PHASE_NONE: Set[str] = set()
POD_RETAIN_PHASE_SOFT: Set[str] = {
    objects.POD_PHASE_SUCCEEDED,
    objects.POD_PHASE_FAILED,
}

def total_tasks(job: objects.Job) -> int:
    return sum(ts.replicas for ts in job.spec.tasks)


def _now_transition(status: objects.JobStatus) -> None:
    from volcano_tpu_torch.utils import clock

    status.state.last_transition_time = clock.now()


class _State:
    """The reference injects SyncJob/KillJob as package globals
    (job_controller.go:218-219); here they are instance fields so several
    controllers can coexist in one process.

    sync_job(job_info, update_status_fn)
    kill_job(job_info, pod_retain_phase, update_status_fn)
    """

    def __init__(self, job_info: JobInfo, sync_job: Callable, kill_job: Callable):
        self.job = job_info
        self.SyncJob = sync_job
        self.KillJob = kill_job

    def _kill_to(self, phase: str, retain, bump_retry: bool = False):
        def update(status: objects.JobStatus) -> bool:
            if bump_retry:
                status.retry_count += 1
            status.state.phase = phase
            return True

        return self.KillJob(self.job, retain, update)


class PendingState(_State):
    def execute(self, action: str):
        if action == JobAction.RESTART_JOB:
            return self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_NONE,
                                 bump_retry=True)
        if action == JobAction.ABORT_JOB:
            return self._kill_to(JobPhase.ABORTING, POD_RETAIN_PHASE_SOFT)
        if action == JobAction.COMPLETE_JOB:
            return self._kill_to(JobPhase.COMPLETING, POD_RETAIN_PHASE_SOFT)
        if action == JobAction.TERMINATE_JOB:
            return self._kill_to(JobPhase.TERMINATING, POD_RETAIN_PHASE_SOFT)

        def update(status: objects.JobStatus) -> bool:
            phase = JobPhase.PENDING
            if self.job.job.spec.min_available <= (
                status.running + status.succeeded + status.failed
            ):
                phase = JobPhase.RUNNING
            status.state.phase = phase
            return True

        return self.SyncJob(self.job, update)


class RunningState(_State):
    def execute(self, action: str):
        if action == JobAction.RESTART_JOB:
            return self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_NONE,
                                 bump_retry=True)
        if action == JobAction.ABORT_JOB:
            return self._kill_to(JobPhase.ABORTING, POD_RETAIN_PHASE_SOFT)
        if action == JobAction.TERMINATE_JOB:
            return self._kill_to(JobPhase.TERMINATING, POD_RETAIN_PHASE_SOFT)
        if action == JobAction.COMPLETE_JOB:
            return self._kill_to(JobPhase.COMPLETING, POD_RETAIN_PHASE_SOFT)

        def update(status: objects.JobStatus) -> bool:
            if status.succeeded + status.failed == total_tasks(self.job.job):
                status.state.phase = JobPhase.COMPLETED
                return True
            return False

        return self.SyncJob(self.job, update)


class RestartingState(_State):
    def execute(self, action: str):
        def update(status: objects.JobStatus) -> bool:
            max_retry = self.job.job.spec.max_retry or DEFAULT_MAX_RETRY
            if status.retry_count >= max_retry:
                status.state.phase = JobPhase.FAILED
                return True
            if total_tasks(self.job.job) - status.terminating >= status.min_available:
                status.state.phase = JobPhase.PENDING
                return True
            return False

        return self.KillJob(self.job, POD_RETAIN_PHASE_NONE, update)


class AbortingState(_State):
    def execute(self, action: str):
        if action == JobAction.RESUME_JOB:
            return self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_SOFT,
                                 bump_retry=True)

        def update(status: objects.JobStatus) -> bool:
            if status.terminating or status.pending or status.running:
                return False  # still draining
            status.state.phase = JobPhase.ABORTED
            _now_transition(status)
            return True

        return self.KillJob(self.job, POD_RETAIN_PHASE_SOFT, update)


class AbortedState(_State):
    def execute(self, action: str):
        if action == JobAction.RESUME_JOB:
            return self._kill_to(JobPhase.RESTARTING, POD_RETAIN_PHASE_SOFT,
                                 bump_retry=True)
        return self.KillJob(self.job, POD_RETAIN_PHASE_SOFT, None)


class TerminatingState(_State):
    def execute(self, action: str):
        def update(status: objects.JobStatus) -> bool:
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.TERMINATED
            return True

        return self.KillJob(self.job, POD_RETAIN_PHASE_SOFT, update)


class CompletingState(_State):
    def execute(self, action: str):
        def update(status: objects.JobStatus) -> bool:
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.COMPLETED
            return True

        return self.KillJob(self.job, POD_RETAIN_PHASE_SOFT, update)


class FinishedState(_State):
    def execute(self, action: str):
        # in a finished state always reap non-retained pods (finished.go)
        return self.KillJob(self.job, POD_RETAIN_PHASE_SOFT, None)


_PHASE_STATES: Dict[str, type] = {
    JobPhase.PENDING: PendingState,
    JobPhase.RUNNING: RunningState,
    JobPhase.RESTARTING: RestartingState,
    JobPhase.TERMINATED: FinishedState,
    JobPhase.COMPLETED: FinishedState,
    JobPhase.FAILED: FinishedState,
    JobPhase.TERMINATING: TerminatingState,
    JobPhase.ABORTING: AbortingState,
    JobPhase.ABORTED: AbortedState,
    JobPhase.COMPLETING: CompletingState,
}


def new_state(job_info: JobInfo, sync_job: Callable, kill_job: Callable) -> _State:
    """(state/factory.go:56-85; pending by default)"""
    phase = job_info.job.status.state.phase if job_info.job else JobPhase.PENDING
    return _PHASE_STATES.get(phase, PendingState)(job_info, sync_job, kill_job)
