"""PodGroup status writeback at session close
(volcano pkg/scheduler/framework/job_updater.go).

The reference parallelizes over 16 workers; here updates are serial and
deterministic (writeback is store-local, not an RPC)."""

from __future__ import annotations

import random
import time

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.scheduler.framework import session as session_mod

JOB_CONDITION_UPDATE_TIME = 60.0  # seconds
JOB_CONDITION_UPDATE_JITTER = 30.0


def time_jitter_after(new: float, old: float, duration: float, max_jitter: float) -> bool:
    jitter = random.uniform(0, max_jitter) if max_jitter > 0 else 0.0
    return new > old + duration + jitter


def _conditions_updated(new_conds, old_conds) -> bool:
    """(job_updater.go:57-88): fresh-enough or materially different."""
    if len(new_conds) != len(old_conds):
        return True
    for new_c, old_c in zip(new_conds, old_conds):
        if time_jitter_after(
            new_c.last_transition_time,
            old_c.last_transition_time,
            JOB_CONDITION_UPDATE_TIME,
            JOB_CONDITION_UPDATE_JITTER,
        ):
            return True
        # compare ignoring transition time/ID
        if (
            new_c.type != old_c.type
            or new_c.status != old_c.status
            or new_c.reason != old_c.reason
            or new_c.message != old_c.message
        ):
            return True
    return False


def is_pod_group_status_updated(new: objects.PodGroupStatus, old: objects.PodGroupStatus) -> bool:
    if (
        new.phase != old.phase
        or new.running != old.running
        or new.succeeded != old.succeeded
        or new.failed != old.failed
    ):
        return True
    return _conditions_updated(new.conditions, old.conditions)


class JobUpdater:
    def __init__(self, ssn):
        self.ssn = ssn
        self.job_queue = list(ssn.jobs.values())

    def update_all(self) -> None:
        for job in self.job_queue:
            self._update_job(job)

    def _update_job(self, job) -> None:
        ssn = self.ssn
        if job.pod_group is None:
            ssn.cache.record_job_status_event(job)
            return
        # job_status clones the whole PodGroupStatus to rewrite 4 fields;
        # when the computed values already equal the live status (the
        # common case for jobs a session didn't touch), the clone+assign
        # is value-neutral — keep the current object and skip it.
        # job_status itself never modifies conditions, so field equality
        # IS value equality here.
        cur = job.pod_group.status
        phase, running, failed, succeeded = session_mod.job_status_values(
            ssn, job)
        if (phase == cur.phase and running == cur.running
                and failed == cur.failed and succeeded == cur.succeeded):
            new_status = cur
        else:
            new_status = cur.clone()
            new_status.phase = phase
            new_status.running = running
            new_status.failed = failed
            new_status.succeeded = succeeded
            job.pod_group.status = new_status
        old_status = ssn.pod_group_status.get(job.uid)
        update_pg = old_status is None or is_pod_group_status_updated(
            new_status, old_status
        )
        ssn.cache.update_job_status(job, update_pg)
