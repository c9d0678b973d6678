"""volcano_tpu_torch.pipeline — the continuous scheduling pipeline.

Double-buffered sessions with speculative solve-ahead: while cycle N's
results are host-replayed and its close-side writebacks run, cycle N+1's
snapshot is already delta-opened from the SnapshotKeeper's buffer pair
and its device solve is speculatively in flight. A delta fingerprint
sealed at dispatch and re-checked before apply guarantees an invalidated
speculative stage is never applied (docs/DESIGN.md §16).

``VOLCANO_TPU_PIPELINE=0`` keeps the serial loop (the byte-for-byte
oracle); ``VOLCANO_TPU_PIPELINE_SPEC=0`` keeps the pipelined loop but
never speculates (double-buffer-only mode, the parity fuzz's midpoint).
"""

from volcano_tpu_torch.pipeline.driver import PipelineDriver, pipeline_enabled, \
    speculation_enabled

__all__ = ["PipelineDriver", "pipeline_enabled", "speculation_enabled"]
