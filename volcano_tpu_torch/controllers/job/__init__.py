"""Job controller (volcano pkg/controllers/job/)."""

from volcano_tpu_torch.controllers.job.controller import JobController

__all__ = ["JobController"]
