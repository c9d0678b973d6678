"""Per-plugin enable-flag defaulting
(volcano pkg/scheduler/plugins/defaults.go:24). The implementation lives in
scheduler.conf so the framework can default options without importing the
plugin package."""

from volcano_tpu_torch.scheduler.conf import apply_plugin_conf_defaults  # noqa: F401
