"""Run a reference test module's tests against the port.

``load(globals(), "test_failover")`` reads ``tests/test_failover.py``,
turns every ``volcano_tpu`` module path in it into ``volcano_tpu_torch``
and executes the result in the calling module's namespace. pytest then
collects, in the calling ``test_torch_*`` file, the same classes, test
functions and fixtures, with the same bodies and the same assertions,
running on the port: a twin that cannot drift from its reference. The
reference file itself is only read.

``only`` keeps the named top-level tests and fixtures (a class by its
name, a function by its name); the module's helpers always come along.
Tracebacks point at the reference file's lines.

``daemon_conf`` gives every daemon process the module starts (``-m
volcano_tpu_torch.scheduler``) that ``--scheduler-conf``: the port's
daemon schedules on the card unless its conf names the CPU.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional

_REF_PKG = re.compile(r"\bvolcano_tpu\b")
_TESTS = os.path.dirname(os.path.abspath(__file__))


_DAEMON = '"-m", "volcano_tpu_torch.scheduler",'


def port_source(name: str, daemon_conf: Optional[str] = None) -> str:
    """``tests/<name>.py`` with the reference package renamed (and, with
    ``daemon_conf``, each daemon process given that conf)."""
    with open(os.path.join(_TESTS, name + ".py")) as f:
        source = _REF_PKG.sub("volcano_tpu_torch", f.read())
    if daemon_conf is not None:
        source = source.replace(
            _DAEMON, f'{_DAEMON} "--scheduler-conf", {daemon_conf!r},')
    return source


def load(namespace: dict, name: str,
         only: Optional[Iterable[str]] = None,
         daemon_conf: Optional[str] = None) -> None:
    path = os.path.join(_TESTS, name + ".py")
    scope = {"__name__": namespace["__name__"], "__file__": path}
    exec(compile(port_source(name, daemon_conf), path, "exec"), scope)
    keep = None if only is None else set(only)
    missing = (keep or set()) - set(scope)
    if missing:
        raise NameError(f"{name} has no {sorted(missing)}")
    for key, value in scope.items():
        if key.startswith("__"):
            continue
        collected = key.startswith(("test_", "Test")) or hasattr(
            value, "_pytestfixturefunction") or hasattr(
            value, "_fixture_function_marker")
        if keep is not None and collected and key not in keep:
            continue
        namespace[key] = value
