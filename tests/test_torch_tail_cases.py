"""K7b's crafted tails through whole capped solves, against the JAX
reference, on the CPU.

Each case of volcano_tpu_torch/bench/round_cases.py ``tail_solve_case``
(a capped cfg6 encode of the port's own encoder, patched in numpy so that
its tail pass meets jobs tied on every key level, queues that cross their
deserved share mid-pass, tasks no node fits, nothing eligible, the drf
share first, exclusion groups and jobs whose first tasks the rounds
placed) goes, as the same padded numpy arrays, through the jitted JAX
solve_rounds and the port's solve (float64, on the CPU, where the tail
is ``tail_pass_plain``). Tolerance: exact equality of assign (whose -2
marks carry tail_failed and the tasks left active), round count,
tail_placed, full-sweep count, capped flag, placed-per-round histogram,
touched-node mask and the packed result. Each case also checks, on the
state the port's tail saw and left, that its tail took the crafted path.
tests/test_torch_rounds_gpu.py holds K7b against tail_pass_plain on the
tails of the same solves on the card.
"""

from __future__ import annotations

import pytest
import torch

from volcano_tpu.ops import kernels as jkernels

from tests.test_torch_rounds import assert_same, run_both
from tests.test_torch_score_round import _struct_fields
from volcano_tpu_torch.bench import round_cases as RC
from volcano_tpu_torch.ops import kernels as tkernels
from volcano_tpu_torch.ops import rounds_kernels as RK


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def base():
    return RC.tail_base_arrays()


def _over(st, enc):
    """Each queue over its deserved share (the tail's gate)."""
    return ~tkernels._le_eps(st["queue_alloc"], enc["queue_deserved"], enc["eps"],
                             enc["is_scalar"])


def _hit(kind, spec, enc, st0, st1, placed):
    """The tail took ``kind``'s path: st0 the state it saw, st1 the one
    it left, placed its ctl[C_TAIL_PLACED]."""
    live0 = st0["active"]
    if kind == "base":
        start = enc["job_task_start"].long()
        first_done = ~live0[start] & (enc["job_task_count"] > 1)
        live_jobs = torch.zeros_like(first_done)
        live_jobs[enc["task_job"][live0].long()] = True
        return spec.use_exclusion and placed > 0 and bool((first_done & live_jobs).any())
    if kind == "ties":
        jobs = torch.unique(enc["task_job"][live0].long())
        return placed >= 2 and jobs.numel() >= 2
    if kind == "queues":
        crossed = ~_over(st0, enc) & _over(st1, enc)
        return placed > 0 and bool(crossed.any())
    if kind == "no fit":
        return bool(st1["tail_failed"].any())
    if kind == "stuck":
        return placed == 0 and bool(live0.any()) and bool(st1["active"].equal(live0))
    if kind == "drf":
        jobs = torch.unique(enc["task_job"][live0].long())
        share = tkernels._share(st0["job_alloc"], enc["drf_total"][None, :],
                                enc["drf_present"][None, :])[jobs]
        return spec.job_order_keys[0] == "drf" and placed > 0 and \
            torch.unique(share).numel() >= 2
    raise KeyError(kind)


@pytest.mark.parametrize("kind", RC.TAIL_KINDS)
def test_crafted_tail_solves_equal_the_reference(kind, base, monkeypatch):
    spec, arrays = RC.tail_solve_case(kind, base)
    seen = {}
    real = RK.tail_pass_plain

    def tail(spec, enc, st, ctl):
        st0 = {k: v.clone() for k, v in st.items()}
        real(spec, enc, st, ctl)
        seen.update(enc=enc, st0=st0, st1={k: v.clone() for k, v in st.items()},
                    placed=int(ctl[RK.C_TAIL_PLACED]))

    monkeypatch.setattr(RK, "tail_pass_plain", tail)
    raw_j, raw_t, packed_j, packed_t = run_both(arrays, jkernels.SolveSpec(**spec._asdict()))
    assert_same(raw_j, raw_t, packed_j, packed_t)
    assert bool(raw_t[4]) and "st0" in seen, "the solve must cap and run its tail"
    assert _hit(kind, spec, seen["enc"], seen["st0"], seen["st1"], seen["placed"]), kind


def test_tail_argument_block_matches_the_cuda_struct():
    """K7b's ctypes argument block names csrc/tail_pass.cu's TailParams
    fields in order."""
    assert _struct_fields("tail_pass.cu", "TailParams") == [
        name for name, _ in RK._TailParams._fields_]
