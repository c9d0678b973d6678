"""Env-gated assertions (analog of volcano pkg/scheduler/util/assert).

By default violations log; set VOLCANO_TPU_PANIC=1 (the analog of the
reference's PANIC_ON_ERROR) to raise instead — tests enable this.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


class AssertionViolation(AssertionError):
    pass


def panic_enabled() -> bool:
    return os.environ.get("VOLCANO_TPU_PANIC", "").lower() in ("1", "true", "yes")


def assertf(condition: bool, msg: str, *args) -> None:
    if condition:
        return
    text = msg % args if args else msg
    if panic_enabled():
        raise AssertionViolation(text)
    logger.error("assertion violated: %s", text)
