"""Scheduling actions, run in configured order each session
(volcano pkg/scheduler/actions)."""

from volcano_tpu_torch.scheduler.actions import factory  # noqa: F401  (registers all)
