// The rounds solve's int32 control vector: the loop state, then the
// counters a step writes (C_PLACED .. C_ANY_CAND), then the placed-per-round
// histogram (C_HIST, kProfSlots entries). Mirrors rounds_kernels.py's C_*
// names; shared by the loop control (rounds_ctl.cu), the round's commit
// (round_commit.cu) and the tail pass (tail_pass.cu).

#pragma once

namespace rctl {

enum Slot {
  C_ROUNDS, C_PROGRESS, C_TRIED, C_CAPPED, C_DEAD, C_EXTRA, C_PHASE,
  C_FULL_SWEEPS, C_REMAINING, C_NDIRTY, C_STEPS, C_LAST, C_CONS,
  C_TAIL_PLACED, C_PLACED, C_STILL, C_NDIRTY_NEXT, C_DID_FULL, C_ANY_CAND,
  C_ERR, C_HIST
};
constexpr int kProfSlots = 64;

}  // namespace rctl
