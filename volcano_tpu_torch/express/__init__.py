"""volcano_tpu_torch/express — event-driven express lane: sub-10 ms incremental
placement for interactive arrivals between full sessions, reconciled by
the next full session (the fairness/preemption authority). Port of
volcano_tpu/express.

Modules:
- trigger.py   — watch-triggered arrival queue + eligibility envelope +
                 the run-once fast path (ExpressLane);
- encode.py    — dirty-row live node axis + device buffer cache (patched
                 by K8, ops/replica.scatter_rows);
- place.py     — the one-dispatch narrow windowed round (K14,
                 csrc/express_place.cu, beside its plain version);
- commit.py    — optimistic validate-then-commit via the real cache
                 effectors;
- reconcile.py — full-session confirm/revert of every optimistic bind.

The lane runs on the card unless it is built with ``device="cpu"``.
"""

from volcano_tpu_torch.express.trigger import (  # noqa: F401
    EXPRESS_MAX_GANG,
    EXPRESS_MAX_TASKS,
    EXPRESS_SAFE_PLUGINS,
    ExpressLane,
    ExpressToken,
)
from volcano_tpu_torch.express.reconcile import reconcile_session  # noqa: F401
