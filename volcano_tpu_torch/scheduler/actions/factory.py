"""Action registry (volcano pkg/scheduler/actions/factory.go). This slice
of the port carries only enqueue and allocate."""

from volcano_tpu_torch.scheduler.framework.plugins import register_action
from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction
from volcano_tpu_torch.scheduler.actions.enqueue import EnqueueAction

register_action(AllocateAction())
register_action(EnqueueAction())
