"""gang — the gang-scheduling policy (volcano pkg/scheduler/plugins/gang/gang.go).

Extension points: JobValid (enough valid tasks vs MinAvailable), Preemptable/
Reclaimable (victim's job must stay >= MinAvailable), JobOrder (non-ready
first), JobReady/JobPipelined; OnSessionClose writes Unschedulable conditions
and metrics.
"""

from __future__ import annotations

import time
from typing import List

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.utils import clock
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.types import TaskStatus, ValidateResult
from volcano_tpu_torch.api.unschedule_info import FitErrors
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "gang"


class GangPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job: JobInfo):
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    pass_=False,
                    reason=objects.NOT_ENOUGH_PODS_REASON,
                    message=(
                        f"Not enough valid tasks for gang-scheduling, "
                        f"valid: {vtn}, min: {job.min_available}"
                    ),
                )
            return None

        # result depends only on the job's status index (valid_task_num)
        # and its static min_available — the session may memoize it per
        # (job, _status_version); see Session.job_valid
        valid_job_fn._status_version_keyed = True
        ssn.add_job_valid_fn(PLUGIN_NAME, valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
            victims = []
            # per-job occupancy map, DECREMENTED per nominated victim
            # (gang.go:82-86): one call may nominate at most
            # (ready - minAvailable) victims per gang — a static read
            # would let a single reclaim pass shred a gang below its min,
            # the partial-gang bug the sim auditor catches mechanically
            occupied_map = {}
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is None:
                    continue
                occupied = occupied_map.get(job.uid)
                if occupied is None:
                    occupied = job.ready_task_num()
                if job.min_available <= occupied - 1 or job.min_available == 1:
                    victims.append(preemptee)
                    occupied -= 1
                occupied_map[job.uid] = occupied
            return victims

        ssn.add_reclaimable_fn(PLUGIN_NAME, preemptable_fn)
        ssn.add_preemptable_fn(PLUGIN_NAME, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1  # non-ready jobs first
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(PLUGIN_NAME, job_order_fn)
        ssn.add_job_ready_fn(PLUGIN_NAME, lambda job: job.ready())
        ssn.add_job_pipelined_fn(PLUGIN_NAME, lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        """Write fit errors + Unschedulable conditions for non-ready gangs
        (gang.go:137-180)."""
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if job.ready():
                continue
            unready = job.min_available - job.ready_task_num()
            msg = (
                f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                f"{job.fit_error()}"
            )
            job.job_fit_errors = msg
            unschedulable_jobs += 1
            metrics.update_unschedule_task_count(job.name, unready)
            metrics.register_job_retry(job.name)

            jc = objects.PodGroupCondition(
                type=objects.POD_GROUP_UNSCHEDULABLE_TYPE,
                status="True",
                last_transition_time=clock.now(),
                transition_id=ssn.uid,
                reason=objects.NOT_ENOUGH_RESOURCES_REASON,
                message=msg,
            )
            try:
                ssn.update_job_condition(job, jc)
            except (KeyError, AttributeError):
                pass

            for task in job.task_status_index.get(TaskStatus.ALLOCATED, {}).values():
                if task.uid in job.nodes_fit_errors:
                    continue
                fe = FitErrors()
                fe.set_error(msg)
                job.nodes_fit_errors[task.uid] = fe

        metrics.update_unschedule_job_count(unschedulable_jobs)


def new(arguments):
    return GangPlugin(arguments)
