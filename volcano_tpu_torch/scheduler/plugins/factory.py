"""Plugin registry (volcano pkg/scheduler/plugins/factory.go:33-45)."""

from volcano_tpu_torch.scheduler.framework.plugins import register_plugin_builder
from volcano_tpu_torch.scheduler.plugins import (
    binpack,
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
    tpuscore,
)

register_plugin_builder("gang", gang.new)
register_plugin_builder("priority", priority.new)
register_plugin_builder("conformance", conformance.new)
register_plugin_builder("drf", drf.new)
register_plugin_builder("proportion", proportion.new)
register_plugin_builder("predicates", predicates.new)
register_plugin_builder("nodeorder", nodeorder.new)
register_plugin_builder("binpack", binpack.new)
register_plugin_builder("tpuscore", tpuscore.new)
