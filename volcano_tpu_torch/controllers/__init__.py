"""Controller manager: job lifecycle (8-state machine + policy engine +
job plugins), podgroup auto-creation, queue status aggregation, TTL garbage
collection (volcano pkg/controllers/)."""

from volcano_tpu_torch.controllers.apis import JobInfo, Request
from volcano_tpu_torch.controllers.cache import JobCache

__all__ = ["JobInfo", "Request", "JobCache"]
