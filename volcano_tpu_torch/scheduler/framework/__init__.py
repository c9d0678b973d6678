"""Scheduler framework: session lifecycle, tiered plugin dispatch,
transactional statements, and the plugin/action registries."""

from volcano_tpu_torch.scheduler.framework.interface import Action, Plugin
from volcano_tpu_torch.scheduler.framework.plugins import (
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from volcano_tpu_torch.scheduler.framework.arguments import Arguments
from volcano_tpu_torch.scheduler.framework.event_handlers import Event, EventHandler
from volcano_tpu_torch.scheduler.framework.session import Session
from volcano_tpu_torch.scheduler.framework.statement import Statement
from volcano_tpu_torch.scheduler.framework.framework import (
    open_session,
    close_session,
    run_actions,
    takeover_recovery_sweep,
)
