"""Benchmark rig: reproducible synthetic clusters for the five BASELINE.json
configs and session-latency measurement helpers."""

from volcano_tpu_torch.bench.clusters import CONFIGS, build_config, make_tiers

__all__ = ["CONFIGS", "build_config", "make_tiers"]
