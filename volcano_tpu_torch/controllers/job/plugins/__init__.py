"""Job plugin registry (volcano pkg/controllers/job/plugins/factory.go:28-57).

Plugin interface (interface/interface.go:30-44):
    name() -> str
    on_pod_create(pod, job) -> None
    on_job_add(job) -> None
    on_job_delete(job) -> None
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_builders: Dict[str, Callable] = {}


def register_plugin_builder(name: str, builder: Callable) -> None:
    _builders[name] = builder


def get_plugin_builder(name: str) -> Optional[Callable]:
    return _builders.get(name)


def plugin_names():
    return list(_builders)


from volcano_tpu_torch.controllers.job.plugins import env, ssh, svc  # noqa: E402

register_plugin_builder("env", env.new)
register_plugin_builder("ssh", ssh.new)
register_plugin_builder("svc", svc.new)
