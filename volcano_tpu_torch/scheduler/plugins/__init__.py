"""Policy plugins (volcano pkg/scheduler/plugins)."""

from volcano_tpu_torch.scheduler.plugins import factory  # noqa: F401  (registers all)
from volcano_tpu_torch.scheduler.plugins.defaults import apply_plugin_conf_defaults
