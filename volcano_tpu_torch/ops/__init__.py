"""Batched placement solver, on PyTorch and CUDA.

Port of volcano_tpu/ops: the host encoder (numpy, copied), the rounds
solver (ops/rounds.py) with its hand-written CUDA kernels (K1 in
ops/kernels.py; K2, K4, K5 in ops/rounds_kernels.py; sources in csrc/),
the batch allocator that stages, solves and applies a session
(ops/solver.py), and batched eviction: the dense views (ops/preemptview.py,
ops/victimview.py, numpy), the host plan and replay (ops/evict.py) and the
state-machine kernels K9-K11 (ops/evict_kernels.py).
"""

from volcano_tpu_torch.ops.encoder import EncodedSnapshot, EncoderFallback, encode_session
from volcano_tpu_torch.ops.solver import BatchAllocator

__all__ = [
    "EncodedSnapshot",
    "EncoderFallback",
    "encode_session",
    "BatchAllocator",
]
