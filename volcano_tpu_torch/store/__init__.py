"""In-process event-sourced state substrate — the analog of the Kubernetes
API server + CRDs (volcano's L0/L1): typed object buckets, resource
versioning, watch streams, admission middleware, and an event recorder."""

from volcano_tpu_torch.store.store import (
    AdmissionError,
    ConflictError,
    FencedError,
    FencedStoreView,
    NotFoundError,
    OverloadedError,
    Store,
    WatchHandler,
)
