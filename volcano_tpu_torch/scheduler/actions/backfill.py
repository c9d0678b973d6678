"""backfill — place BestEffort (zero-request) tasks on the first
predicate-passing node, without scoring or statements
(volcano pkg/scheduler/actions/backfill/backfill.go:41-91)."""

from __future__ import annotations

import logging

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.api.unschedule_info import FitErrors, FitFailure
from volcano_tpu_torch.scheduler.framework.interface import Action
from volcano_tpu_torch.scheduler.util import scheduler_helper as helper

logger = logging.getLogger(__name__)


class BackfillAction(Action):
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn) -> None:
        from volcano_tpu_torch.ops import evict as evict_mod
        from volcano_tpu_torch.ops import preemptview

        # batched backfill (ops/evict.py): one device dispatch decides
        # every zero-request placement (first feasible node in name order
        # under the evolving pod-count); the host replays via ssn.allocate
        # with the same FitErrors/replay-budget machinery as below.
        # VOLCANO_TPU_EVICT=0 forces this oracle path.
        plan = evict_mod.build(ssn, "backfill")
        if plan is not None and plan.run():
            return

        # dense per-signature feasibility rows (same candidates, same name
        # order as the serial walk) when tpuscore is on; the predicate
        # closure sweep remains the fallback and oracle
        view = preemptview.build(ssn)

        all_nodes = helper.get_node_list(ssn.nodes)
        # budget for full per-node diagnostics replay on view-path failures:
        # each replay costs O(nodes) predicate calls, so only the first few
        # failed tasks per session get serial-fidelity reasons — a taint
        # rollout failing thousands of best-effort pods must not turn the
        # fast dense-view path back into the O(tasks x nodes) sweep
        replay_budget = 8
        for job in list(ssn.jobs.values()):
            if job.pod_group.status.phase == objects.PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.pass_:
                continue

            for task in list(job.task_status_index.get(TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue
                allocated = False
                fe = FitErrors()
                candidates = view.masked_nodes_in_name_order(task) \
                    if view is not None else None
                fell_back = candidates is None
                if fell_back:
                    def _feasible(_task=task, _fe=fe):
                        for nd in all_nodes:
                            try:
                                ssn.predicate_fn(_task, nd)
                            except FitFailure as err:
                                _fe.set_node_error(
                                    nd.name, err.fit_error(_task, nd))
                                continue
                            yield nd
                    candidates = _feasible()
                tried = 0
                for node in candidates:
                    tried += 1
                    try:
                        ssn.allocate(task, node.name)
                    except (KeyError, RuntimeError) as err:
                        logger.error("Failed to bind Task %s on %s: %s", task.uid, node.name, err)
                        continue
                    if view is not None:
                        view.on_pipeline(node.name, task)
                        if fell_back and view.needs_poison(task):
                            # an affinity-carrying pod became resident:
                            # later masks/scores would be stale
                            view.poison()
                    allocated = True
                    break
                if not allocated:
                    if view is not None and not fe.nodes:
                        if tried == 0 and replay_budget > 0:
                            # dense-view failure path: replay the serial
                            # predicate chain to recover the per-node
                            # reasons the serial walk records (bounded by
                            # replay_budget — see above)
                            replay_budget -= 1
                            for nd in all_nodes:
                                try:
                                    ssn.predicate_fn(task, nd)
                                except FitFailure as err:
                                    fe.set_node_error(
                                        nd.name, err.fit_error(task, nd))
                        if not fe.nodes:
                            fe.set_error(
                                "0/%d nodes are feasible for backfill"
                                % len(all_nodes) if tried == 0 else
                                "%d feasible nodes rejected the backfill "
                                "allocation" % tried)
                    job.nodes_fit_errors[task.uid] = fe
