"""Admission: job validation/mutation + the delay-pod-creation gate
(volcano pkg/admission/)."""

from volcano_tpu_torch.admission.admission import (
    install,
    mutate_job,
    validate_job,
    validate_pod,
)
from volcano_tpu_torch.admission.intake import (
    IntakeGate,
    classify_job,
    install_intake,
)

__all__ = ["install", "mutate_job", "validate_job", "validate_pod",
           "IntakeGate", "classify_job", "install_intake"]
