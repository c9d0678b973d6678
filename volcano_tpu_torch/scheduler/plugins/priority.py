"""priority — task/job ordering by pod priority
(volcano pkg/scheduler/plugins/priority/priority.go:43-84)."""

from __future__ import annotations

from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "priority"


class PriorityPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l, r) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        # key twin of the comparator: higher priority sorts first
        ssn.add_task_order_fn(PLUGIN_NAME, task_order_fn,
                              key=lambda t: -t.priority)

        def job_order_fn(l, r) -> int:
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(PLUGIN_NAME, job_order_fn)


def new(arguments):
    return PriorityPlugin(arguments)
