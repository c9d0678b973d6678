"""tpuscore — the batch-solve gate, on PyTorch and CUDA.

The same plugin name and seam as volcano_tpu/scheduler/plugins/tpuscore.py
(volcano pkg/scheduler/framework/plugins.go RegisterPluginBuilder), so the
same tiers drive both packages: it attaches a BatchAllocator to the
session, and the allocate action hands the whole placement pass to it,
keeping the serial loop for sessions the solve does not take. With the
plugin absent or ``tpuscore.enable: "false"`` scheduling is the serial path.

Arguments:
    tpuscore.enable: "true"/"false" (default true)
    tpuscore.device: "cuda"/"cpu" (default cuda; raises when no GPU is
                     usable — the solve never carries on on the CPU unless
                     asked to)
    tpuscore.dtype:  "float32"/"float64" (default float32 on the card,
                     float64 on the CPU; bf16 is refused — memory-byte
                     epsilons need more than 8 mantissa bits)
    tpuscore.mode:   "rounds"/"auto" (default auto — rounds for large
                     sessions, the serial loop for small ones). "parity"
                     (the sequential-scan oracle) raises
                     NotImplementedError: it comes with a later slice.
"""

from __future__ import annotations

from volcano_tpu_torch.scheduler.framework.interface import Plugin

PLUGIN_NAME = "tpuscore"

ENABLE = "tpuscore.enable"
DEVICE = "tpuscore.device"
DTYPE = "tpuscore.dtype"
MODE = "tpuscore.mode"


class TpuScorePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.profile: dict = {}

    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        from volcano_tpu_torch.scheduler.framework.arguments import Arguments

        args = self.arguments if isinstance(self.arguments, Arguments) \
            else Arguments(self.arguments)
        if not args.get_bool(ENABLE, True):
            return
        from volcano_tpu_torch.ops.solver import BatchAllocator

        mode = str(args.get(MODE, "auto")) or "auto"
        if mode == "parity":
            raise NotImplementedError(
                "tpuscore.mode: parity (the sequential-scan oracle, "
                "kernels.solve_allocate) is not ported yet; it comes with "
                "the parity-scan slice of the PyTorch port")
        if mode not in ("auto", "rounds"):
            raise ValueError(f"tpuscore.mode {mode!r} not supported (auto/rounds)")
        ssn.batch_allocator = BatchAllocator(
            device=str(args.get(DEVICE, "cuda")) or "cuda",
            dtype=str(args.get(DTYPE, "")) or None,
            profile=self.profile, mode=mode)

    def on_session_close(self, ssn) -> None:
        if getattr(ssn, "batch_allocator", None) is not None:
            ssn.batch_allocator = None


def new(arguments):
    return TpuScorePlugin(arguments)
