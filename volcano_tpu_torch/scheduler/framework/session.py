"""Session — per-cycle snapshot + plugin extension points + mutation API
(volcano pkg/scheduler/framework/{session.go,session_plugins.go}).

Tiered dispatch semantics (session_plugins.go:106-523), preserved exactly:
- victim fns (preemptable/reclaimable): INTERSECTION within a tier; the first
  tier that produces a non-None result decides;
- order fns (job/queue/task/namespace): first non-zero comparison across
  tiers wins; creation-timestamp+UID tie-break as default;
- job_ready/job_pipelined: AND across all enabled plugins;
- overused: OR;
- job_valid/job_enqueueable: first failure rejects;
- node order: SUM of scores across plugins; batch node order sums per-node.
"""

from __future__ import annotations

import uuid
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.cluster_info import ClusterInfo
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.types import TaskStatus, allocated_status
from volcano_tpu_torch.scheduler import conf
from volcano_tpu_torch.scheduler.framework.event_handlers import Event, EventHandler


class Session:
    def __init__(self, cache):
        self.uid = str(uuid.uuid4())
        self.cache = cache

        self.pod_group_status: Dict[str, objects.PodGroupStatus] = {}

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.node_axis = None  # snapshot columnar node capture (nodeaxis.py)
        self.namespace_info: Dict[str, object] = {}

        self.tiers: List[conf.Tier] = []
        self.plugins: Dict[str, object] = {}

        self.event_handlers: List[EventHandler] = []
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.task_order_keys: Dict[str, Callable] = {}
        self.namespace_order_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, Callable] = {}
        self.batch_node_order_fns: Dict[str, Callable] = {}
        self.node_map_fns: Dict[str, Callable] = {}
        self.node_reduce_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.job_enqueueable_fns: Dict[str, Callable] = {}

        self._tier_fns_cache: Dict[tuple, List[List[Callable]]] = {}
        self._flat_fns_cache: Dict[tuple, List[Callable]] = {}
        self._stock_task_key_memo = None
        self._node_order_pairs_cache = None
        self._fast_trans = False  # False = not built yet (None = unavailable)
        self._job_valid_memo = None  # None = gate undecided; False = off
        # bumped by every placement-shaped node mutation (allocate/pipeline
        # and their unwinds, plus the bulk writeback). The shared dense
        # preempt view validates against it: a view that missed a mutation
        # rebuilds instead of serving stale used/pod-count state
        self._placement_gen = 0

    # ------------------------------------------------------------------
    # registration (session_plugins.go:26-104)
    # ------------------------------------------------------------------

    def add_job_order_fn(self, name: str, fn) -> None:
        """fn(l_job, r_job) -> int (-1/0/1)"""
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name: str, fn) -> None:
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name: str, fn, key=None) -> None:
        """fn(l_task, r_task) -> int comparator; ``key`` optionally
        registers an equivalent sort KEY (key(task) -> tuple ordering
        ascending exactly as the comparator orders) — when every enabled
        task-order plugin provides one, hot loops use one C-level key sort
        instead of a comparator heap (see stock_task_order_key)."""
        self.task_order_fns[name] = fn
        if key is not None:
            self.task_order_keys[name] = key

    def add_namespace_order_fn(self, name: str, fn) -> None:
        self.namespace_order_fns[name] = fn

    def add_preemptable_fn(self, name: str, fn) -> None:
        """fn(preemptor: TaskInfo, preemptees: [TaskInfo]) -> [TaskInfo]"""
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name: str, fn) -> None:
        self.reclaimable_fns[name] = fn

    def add_job_ready_fn(self, name: str, fn) -> None:
        """fn(job) -> bool"""
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name: str, fn) -> None:
        self.job_pipelined_fns[name] = fn

    def add_predicate_fn(self, name: str, fn) -> None:
        """fn(task, node) -> None, raising FitFailure on mismatch"""
        self.predicate_fns[name] = fn

    def add_node_order_fn(self, name: str, fn) -> None:
        """fn(task, node) -> float"""
        self.node_order_fns[name] = fn

    def add_batch_node_order_fn(self, name: str, fn) -> None:
        """fn(task, nodes) -> {node_name: float}"""
        self.batch_node_order_fns[name] = fn

    def add_node_map_fn(self, name: str, fn) -> None:
        self.node_map_fns[name] = fn

    def add_node_reduce_fn(self, name: str, fn) -> None:
        self.node_reduce_fns[name] = fn

    def add_overused_fn(self, name: str, fn) -> None:
        self.overused_fns[name] = fn

    def add_job_valid_fn(self, name: str, fn) -> None:
        """fn(job) -> Optional[ValidateResult]"""
        self.job_valid_fns[name] = fn

    def add_job_enqueueable_fn(self, name: str, fn) -> None:
        self.job_enqueueable_fns[name] = fn

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # ------------------------------------------------------------------
    # tiered dispatch
    # ------------------------------------------------------------------

    def _tier_plugins(self, flag_name: Optional[str], fns: Dict[str, Callable]):
        """Enabled fns per tier, in tier order.

        Memoized per (registry, size): dispatch runs per job/task in the
        hot loops while registration only ever ADDS fns during
        on_session_open, so a registry's materialized tier lists are valid
        until its length changes."""
        key = (flag_name, id(fns), len(fns))
        cached = self._tier_fns_cache.get(key)
        if cached is not None:
            return cached
        tiers = []
        for tier in self.tiers:
            out = []
            for plugin in tier.plugins:
                if flag_name is not None and not conf.enabled(getattr(plugin, flag_name)):
                    continue
                fn = fns.get(plugin.name)
                if fn is not None:
                    out.append(fn)
            tiers.append(out)
        self._tier_fns_cache[key] = tiers
        return tiers

    def _victims(self, flag_name: str, fns, claimer, claimees) -> List[TaskInfo]:
        """Within-tier intersection; first deciding tier wins
        (session_plugins.go:106-187)."""
        for tier_fns in self._tier_plugins(flag_name, fns):
            victims: Optional[List[TaskInfo]] = None
            for fn in tier_fns:
                candidates = fn(claimer, claimees)
                if victims is None:
                    victims = candidates
                else:
                    cand_uids = {c.uid for c in (candidates or [])}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims is not None:
                return victims
        return []

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]) -> List[TaskInfo]:
        return self._victims("enabled_reclaimable", self.reclaimable_fns, reclaimer, reclaimees)

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
        return self._victims("enabled_preemptable", self.preemptable_fns, preemptor, preemptees)

    def overused(self, queue: QueueInfo) -> bool:
        """OR over all plugins, no enable flag (session_plugins.go:191-205)."""
        for tier_fns in self._tier_plugins(None, self.overused_fns):
            for fn in tier_fns:
                if fn(queue):
                    return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        for tier_fns in self._tier_plugins("enabled_job_ready", self.job_ready_fns):
            for fn in tier_fns:
                if not fn(job):
                    return False
        return True

    def job_pipelined(self, job: JobInfo) -> bool:
        for tier_fns in self._tier_plugins("enabled_job_pipelined", self.job_pipelined_fns):
            for fn in tier_fns:
                if not fn(job):
                    return False
        return True

    def job_valid(self, job: JobInfo):
        # preempt/reclaim/backfill each dispatch this once per job; when
        # every registered validator declares itself a pure function of the
        # job's status index (the stock gang one does), the verdict is
        # memoized per (job, _status_version). The gate is keyed to the
        # validator COUNT: open_session_state dispatches job_valid before
        # plugins register, and a memo latched against the empty (or any
        # smaller) fn set must be discarded when registration grows it.
        fns = self.job_valid_fns
        if not fns:
            return None
        gate = self._job_valid_memo
        if gate is None or gate[0] != len(fns):
            memo = ({} if all(getattr(fn, "_status_version_keyed", False)
                              for fn in fns.values()) else False)
            gate = self._job_valid_memo = (len(fns), memo)
        memo = gate[1]
        if memo is not False:
            hit = memo.get(job.uid)
            if hit is not None and hit[0] == job._status_version:
                return hit[1]
        vr_out = None
        for tier_fns in self._tier_plugins(None, fns):
            for fn in tier_fns:
                vr = fn(job)
                if vr is not None and not vr.pass_:
                    vr_out = vr
                    break
            if vr_out is not None:
                break
        if memo is not False:
            memo[job.uid] = (job._status_version, vr_out)
        return vr_out

    def job_enqueueable(self, job: JobInfo) -> bool:
        for tier_fns in self._tier_plugins(None, self.job_enqueueable_fns):
            for fn in tier_fns:
                if not fn(job):
                    return False
        return True

    def _order(self, flag_name: str, fns, l, r) -> int:
        # flattened twin of the _tier_plugins memo: comparators run per
        # PAIR in the priority-queue hot loops, so even the nested-list
        # iteration overhead is worth hoisting (tier order preserved)
        key = (flag_name, id(fns), len(fns))
        flat = self._flat_fns_cache.get(key)
        if flat is None:
            flat = self._flat_fns_cache[key] = [
                fn for tier_fns in self._tier_plugins(flag_name, fns)
                for fn in tier_fns]
        for fn in flat:
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        j = self._order("enabled_job_order", self.job_order_fns, l, r)
        if j != 0:
            return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def job_order_cmp(self, l: JobInfo, r: JobInfo) -> int:
        """3-way twin of job_order_fn (cmp < 0 iff job_order_fn(l, r)):
        comparator heaps dispatch ONCE per comparison instead of probing
        both directions for equality."""
        j = self._order("enabled_job_order", self.job_order_fns, l, r)
        if j != 0:
            return j
        if l.creation_timestamp == r.creation_timestamp:
            return -1 if l.uid < r.uid else (1 if l.uid > r.uid else 0)
        return -1 if l.creation_timestamp < r.creation_timestamp else 1

    def namespace_order_fn(self, l: str, r: str) -> bool:
        j = self._order("enabled_namespace_order", self.namespace_order_fns, l, r)
        if j != 0:
            return j < 0
        return l < r

    def namespace_order_cmp(self, l: str, r: str) -> int:
        j = self._order("enabled_namespace_order", self.namespace_order_fns, l, r)
        if j != 0:
            return j
        return -1 if l < r else (1 if l > r else 0)

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        j = self._order("enabled_queue_order", self.queue_order_fns, l, r)
        if j != 0:
            return j < 0
        lt = l.queue.metadata.creation_timestamp
        rt = r.queue.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def queue_order_cmp(self, l: QueueInfo, r: QueueInfo) -> int:
        j = self._order("enabled_queue_order", self.queue_order_fns, l, r)
        if j != 0:
            return j
        lt = l.queue.metadata.creation_timestamp
        rt = r.queue.metadata.creation_timestamp
        if lt == rt:
            return -1 if l.uid < r.uid else (1 if l.uid > r.uid else 0)
        return -1 if lt < rt else 1

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        return self._order("enabled_task_order", self.task_order_fns, l, r)

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        lt = l.pod.metadata.creation_timestamp if l.pod else 0
        rt = r.pod.metadata.creation_timestamp if r.pod else 0
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def stock_task_order_key(self):
        """A sort KEY totally ordering tasks exactly like task_order_fn, or
        None when some enabled comparator has no registered key twin
        (add_task_order_fn's ``key``). With a key, hot loops replace
        comparator heaps (one Python dispatch per PAIR) with one C-level
        sort (one key per ITEM). The composed tuple is (plugin keys in tier
        order..., ctime, uid) — the comparator chain plus task_order_fn's
        tie-break. Memoized on the registry size (fns only ADD during
        open)."""
        memo = self._stock_task_key_memo
        if memo is not None and memo[0] == len(self.task_order_fns):
            return memo[1]
        enabled = [
            plugin.name
            for tier in self.tiers
            for plugin in tier.plugins
            if conf.enabled(plugin.enabled_task_order)
            and plugin.name in self.task_order_fns
        ]
        if any(name not in self.task_order_keys for name in enabled):
            key = None
        else:
            plugin_keys = [self.task_order_keys[name] for name in enabled]
            if not plugin_keys:
                key = lambda t: (  # noqa: E731
                    t.pod.metadata.creation_timestamp if t.pod else 0, t.uid)
            elif len(plugin_keys) == 1:
                k0 = plugin_keys[0]
                key = lambda t: (  # noqa: E731
                    k0(t),
                    t.pod.metadata.creation_timestamp if t.pod else 0,
                    t.uid)
            else:
                key = lambda t: (  # noqa: E731
                    *(k(t) for k in plugin_keys),
                    t.pod.metadata.creation_timestamp if t.pod else 0,
                    t.uid)
        self._stock_task_key_memo = (len(self.task_order_fns), key)
        return key

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """Chains all enabled predicates; raises FitFailure on first miss."""
        for tier_fns in self._tier_plugins("enabled_predicate", self.predicate_fns):
            for fn in tier_fns:
                fn(task, node)

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for tier_fns in self._tier_plugins("enabled_node_order", self.node_order_fns):
            for fn in tier_fns:
                score += fn(task, node)
        return score

    def batch_node_order_fn(self, task: TaskInfo, nodes: List[NodeInfo]) -> Dict[str, float]:
        scores: Dict[str, float] = {}
        for tier_fns in self._tier_plugins("enabled_node_order", self.batch_node_order_fns):
            for fn in tier_fns:
                for node_name, s in fn(task, nodes).items():
                    scores[node_name] = scores.get(node_name, 0.0) + s
        return scores

    def node_order_map_fn(self, task: TaskInfo, node: NodeInfo):
        """Returns ({plugin: score}, summed order score) (session_plugins.go:474).

        The (plugin, order fn, map fn) triples are resolved once per
        registry size — this dispatch runs per (task, node) in the serial
        prioritize sweep, and re-walking the tier/flag structure per node
        dominates the actual scoring lambdas."""
        key = (len(self.node_order_fns), len(self.node_map_fns))
        cached = self._node_order_pairs_cache
        if cached is None or cached[0] != key:
            pairs = []
            for tier in self.tiers:
                for plugin in tier.plugins:
                    if not conf.enabled(plugin.enabled_node_order):
                        continue
                    fn = self.node_order_fns.get(plugin.name)
                    mfn = self.node_map_fns.get(plugin.name)
                    if fn is not None or mfn is not None:
                        pairs.append((plugin.name, fn, mfn))
            cached = self._node_order_pairs_cache = (key, pairs)
        node_score_map: Dict[str, float] = {}
        priority_score = 0.0
        for name, fn, mfn in cached[1]:
            if fn is not None:
                priority_score += fn(task, node)
            if mfn is not None:
                node_score_map[name] = mfn(task, node)
        return node_score_map, priority_score

    def node_order_reduce_fn(self, task: TaskInfo, plugin_node_scores: Dict[str, Dict[str, float]]) -> Dict[str, float]:
        node_scores: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not conf.enabled(plugin.enabled_node_order):
                    continue
                rfn = self.node_reduce_fns.get(plugin.name)
                if rfn is None:
                    continue
                scores = plugin_node_scores.get(plugin.name, {})
                rfn(task, scores)
                for host, s in scores.items():
                    node_scores[host] = node_scores.get(host, 0.0) + s
        return node_scores

    # ------------------------------------------------------------------
    # mutation API (session.go:198-369)
    # ------------------------------------------------------------------

    def statement(self):
        from volcano_tpu_torch.scheduler.framework.statement import Statement

        return Statement(self)

    def fast_trans(self):
        """The session's native transition engine (ops/fasttrans.py), or
        None when the handler set is not the recognized stock set. Built
        once, after plugins have registered (actions run later)."""
        if self._fast_trans is False:
            from volcano_tpu_torch.ops import fasttrans

            self._fast_trans = fasttrans.build(self)
        return self._fast_trans

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Place onto releasing resources; session-state only (session.go:205-245)."""
        self._placement_gen += 1
        ft = self.fast_trans()
        if ft is not None:
            ft.pipeline(task, hostname, strict=True)
            return
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Allocate onto idle resources; dispatches the whole job when it
        becomes gang-ready (session.go:248-303)."""
        self.cache.allocate_volumes(task, hostname)
        self._placement_gen += 1
        ft = self.fast_trans()
        if ft is not None:
            job = ft.allocate(task, hostname)
        else:
            job = self.jobs.get(task.job)
            if job is None:
                raise KeyError(f"failed to find job {task.job}")
            job.update_task_status(task, TaskStatus.ALLOCATED)
            task.node_name = hostname
            node = self.nodes.get(hostname)
            if node is None:
                raise KeyError(f"failed to find node {hostname}")
            node.add_task(task)
            self._fire_allocate(task)

        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        """(session.go:305-329)"""
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.BINDING)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """(session.go:332-369)"""
        self.cache.evict(reclaimee, reason)
        ft = self.fast_trans()
        if ft is not None:
            ft.evict(reclaimee, strict=True)
            return
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)

    def update_job_condition(self, job_info: JobInfo, cond: objects.PodGroupCondition) -> None:
        """(session.go:372-394)"""
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job {job_info.namespace}/{job_info.name}")
        for i, c in enumerate(job.pod_group.status.conditions):
            if c.type == cond.type:
                job.pod_group.status.conditions[i] = cond
                return
        job.pod_group.status.conditions.append(cond)


def job_status_values(ssn: Session, job_info: JobInfo):
    """The (phase, running, failed, succeeded) a session-close writeback
    would set (session.go:157-195) — the value half of job_status, without
    materializing the status clone (JobUpdater skips the clone when these
    equal the live status)."""
    idx = job_info.task_status_index
    cur = job_info.pod_group.status
    unschedulable = any(
        c.type == objects.POD_GROUP_UNSCHEDULABLE_TYPE
        and c.status == "True"
        and c.transition_id == ssn.uid
        for c in cur.conditions
    )

    phase = cur.phase
    if idx.get(TaskStatus.RUNNING) and unschedulable:
        phase = objects.PodGroupPhase.UNKNOWN
    else:
        allocated = 0
        for st, tasks in idx.items():
            if allocated_status(st) or st == TaskStatus.SUCCEEDED:
                allocated += len(tasks)
        if allocated >= job_info.pod_group.spec.min_member:
            phase = objects.PodGroupPhase.RUNNING
        elif cur.phase != objects.PodGroupPhase.INQUEUE:
            phase = objects.PodGroupPhase.PENDING

    return (phase,
            len(idx.get(TaskStatus.RUNNING, {})),
            len(idx.get(TaskStatus.FAILED, {})),
            len(idx.get(TaskStatus.SUCCEEDED, {})))


def job_status(ssn: Session, job_info: JobInfo) -> objects.PodGroupStatus:
    """Compute the PodGroup status to write back at session close
    (session.go:157-195)."""
    status = job_info.pod_group.status.clone()
    (status.phase, status.running, status.failed,
     status.succeeded) = job_status_values(ssn, job_info)
    return status


def open_session_state(ssn: Session) -> None:
    """Fill the session from the cache snapshot and drop invalid jobs
    (session.go:72-139)."""
    snapshot: ClusterInfo = ssn.cache.snapshot()
    ssn.jobs = snapshot.jobs
    for job in list(ssn.jobs.values()):
        if job.pod_group is not None and job.pod_group.status.conditions:
            ssn.pod_group_status[job.uid] = job.pod_group.status.clone()
        vjr = ssn.job_valid(job)
        if vjr is not None:
            if not vjr.pass_:
                jc = objects.PodGroupCondition(
                    type=objects.POD_GROUP_UNSCHEDULABLE_TYPE,
                    status="True",
                    transition_id=ssn.uid,
                    reason=vjr.reason,
                    message=vjr.message,
                )
                try:
                    ssn.update_job_condition(job, jc)
                except (KeyError, AttributeError):
                    pass
            del ssn.jobs[job.uid]
    ssn.nodes = snapshot.nodes
    ssn.queues = snapshot.queues
    ssn.namespace_info = snapshot.namespace_info
    ssn.node_axis = snapshot.node_axis
