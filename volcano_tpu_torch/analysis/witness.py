"""Runtime witness flag — the part of volcano_tpu/analysis/witness.py the
device replica reads.

``VOLCANO_TPU_WITNESS=1`` arms the replica's explanation check
(ops/replica.py ``_witness_check``): every scattered row must be explained
by a keeper mark or a generation movement, or the serve raises
``WitnessViolation`` and heals by a rebuild. The lock witness, the
guarded containers and ``check_session`` of the reference module are not
ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import os


def enabled() -> bool:
    return os.environ.get("VOLCANO_TPU_WITNESS", "") not in ("", "0")


class WitnessViolation(AssertionError):
    pass
