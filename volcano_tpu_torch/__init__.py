"""volcano_tpu_torch: the PyTorch/CUDA port of volcano_tpu.

The same session-based gang scheduler (api, cache, framework, actions,
plugins), with the per-session placement solve on an NVIDIA GPU: the
rounds solver in PyTorch around hand-written CUDA kernels for Hopper
(volcano_tpu_torch/ops, csrc/). It imports torch and numpy, never jax and
nothing of volcano_tpu. It carries enqueue, allocate (through the rounds
solver) and the eviction actions backfill, preempt and reclaim (each one
state-machine kernel dispatch).
"""
