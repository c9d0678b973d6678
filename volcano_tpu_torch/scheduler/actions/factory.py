"""Action registry (volcano pkg/scheduler/actions/factory.go)."""

from volcano_tpu_torch.scheduler.framework.plugins import register_action
from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction
from volcano_tpu_torch.scheduler.actions.backfill import BackfillAction
from volcano_tpu_torch.scheduler.actions.enqueue import EnqueueAction
from volcano_tpu_torch.scheduler.actions.preempt import PreemptAction
from volcano_tpu_torch.scheduler.actions.reclaim import ReclaimAction

register_action(AllocateAction())
register_action(BackfillAction())
register_action(EnqueueAction())
register_action(PreemptAction())
register_action(ReclaimAction())
