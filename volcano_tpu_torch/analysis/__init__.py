"""Runtime analysis helpers of the port (volcano_tpu/analysis)."""
