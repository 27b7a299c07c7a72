"""Event-driven workflow execution simulator (the WorkflowSim /
WorkSim-PredError role, Section 8): schedules are computed from *predicted*
runtimes, execution advances with *true* runtimes.

The core loop is a heap-ordered event queue — O(T log T + T N) — and every
completion flows through an `on_complete` hook: the attachment point for
the online prediction service and, via `execute_adaptive`, for in-flight
HEFT rescheduling of the not-yet-started frontier
(`online.rescheduler.OnlineReschedulingPlanner`).

Fault tolerance: node failures (fail-stop with re-execution) and
uncertainty-driven speculative straggler duplication.  The event loop
supports backup launches — a running task is duplicated on an idle node,
the first finisher wins, the loser is cancelled and its slot freed — and
`execute_adaptive(speculation=...)` consults the planner's
`decide_speculation` (posterior-quantile thresholds from the decision
plane, `sched.straggler`) on periodic progress-check events.  All of it
runs on the host: the planner's predictions and replans are what reach the
card.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.microbench import NodeSpec
from repro_torch.sched.heft import Schedule, comm_seconds
from repro_torch.workflow.dag import WorkflowDAG

_FINISH, _CHECK = 0, 1     # heap event kinds ((time, seq) keeps order total)


@dataclass
class ExecRecord:
    uid: str
    node: str
    start: float
    finish: float
    attempt: int = 0


@dataclass
class SimResult:
    makespan: float
    records: List[ExecRecord]
    node_busy: Dict[str, List[Tuple[float, float]]]
    n_reschedules: int = 0
    n_backups: int = 0            # speculative copies launched
    backup_waste_s: float = 0.0   # seconds burned on cancelled losers

    def busy_seconds(self) -> Dict[str, float]:
        return {n: sum(b - a for a, b in iv) for n, iv in self.node_busy.items()}


# SpeculationPolicy lives with the rest of the straggler decision plane;
# re-exported here for the executor's callers.
from repro_torch.sched.straggler import SpeculationPolicy  # noqa: E402,F401


@dataclass
class SimState:
    """Snapshot handed to completion hooks / adaptive planners.

    Deliberately withholds the simulator's knowledge of in-flight tasks'
    true finish times (and, for the same reason, exposes no node-free
    times, which are those finishes by another name): a real resource
    manager only knows when a running task *started* — its finish must
    come from the predictor, otherwise adaptive scheduling would be
    benchmarked with oracle knowledge."""
    now: float
    finished: Dict[str, Tuple[str, float]]       # uid -> (node, finish time)
    running: Dict[str, Tuple[str, float]]        # uid -> (node, START time)
    started: Set[str]                            # booked (uncancellable) uids


class _EventLoop:
    """Shared heap-ordered execution core for the static and adaptive
    executors.  A task is *booked* (started) the moment its node commits to
    it; booking pushes its completion event.  A booked task may gain ONE
    speculative backup launch: whichever copy finishes first produces the
    task's single ExecRecord, the other copy's event is cancelled and its
    node freed at the winner's finish time."""

    def __init__(self, dag: WorkflowDAG, nodes: List[NodeSpec],
                 true_runtime: Callable[[str, NodeSpec], float],
                 failures: Optional[Dict[str, float]],
                 straggler_factor: Optional[Callable[[str], float]]):
        self.dag = dag
        self.node_by_name = {n.name: n for n in nodes}
        self.true_runtime = true_runtime
        self.failures = failures or {}
        self.straggler_factor = straggler_factor
        self.finish: Dict[str, float] = {}
        self.assigned_node: Dict[str, str] = {}
        self.records: List[ExecRecord] = []
        self.busy: Dict[str, List[Tuple[float, float]]] = {
            n.name: [] for n in nodes}
        self.node_free: Dict[str, float] = {n.name: 0.0 for n in nodes}
        self.queues: Dict[str, List[str]] = {n.name: [] for n in nodes}
        self.done: Set[str] = set()
        self.started: Set[str] = set()
        self.running: Dict[str, Tuple[str, float]] = {}   # uid -> (node, start)
        self.now = 0.0
        self.n_backups = 0
        self.backup_waste_s = 0.0
        # uid -> [(seq, node, start, end), ...] live launches (primary +
        # backup); end is the booked finish, needed to free slots safely
        self._launches: Dict[str, List[Tuple[int, str, float, float]]] = {}
        self._cancelled: Set[int] = set()
        self._heap: List[Tuple[float, int, int, str, str, float, int]] = []
        self._seq = 0

    def set_queues(self, order: Dict[str, List[str]]):
        for name in self.queues:
            self.queues[name] = list(order.get(name, []))

    def _push_finish(self, uid: str, name: str, start: float, end: float,
                     failed: bool):
        self._seq += 1
        self._launches.setdefault(uid, []).append((self._seq, name, start,
                                                   end))
        heapq.heappush(self._heap, (end, self._seq, _FINISH, uid, name,
                                    start, int(failed)))

    def push_check(self, t: float):
        """Schedule a progress-check event (speculation heartbeat)."""
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, _CHECK, "", "", 0.0, 0))

    def try_start(self, name: str):
        q = self.queues[name]
        if not q:
            return
        u = q[0]
        t = self.dag.tasks[u]
        if any(d not in self.done for d in t.deps):
            return
        node = self.node_by_name[name]
        ready = 0.0
        for d in t.deps:
            dn = self.node_by_name[self.assigned_node[d]]
            ready = max(ready, self.finish[d] +
                        comm_seconds(self.dag.tasks[d].output_gb, dn, node))
        # clamp to the current event time: a replan at `now` may surface a
        # long-runnable task on an idle node — it starts now, not in the past
        start = max(self.node_free[name], ready, self.now)
        dur = self.true_runtime(u, node)
        if self.straggler_factor is not None:
            dur *= self.straggler_factor(u)
        end = start + dur
        failed = name in self.failures and start < self.failures[name] <= end
        if failed:
            # fail-stop mid-task: recover and re-run (adds downtime)
            end = self.failures[name] + 60.0 + dur
        q.pop(0)
        self.node_free[name] = end
        self.started.add(u)
        self.running[u] = (name, start)
        self._push_finish(u, name, start, end, failed)

    def launch_backup(self, uid: str, name: str) -> bool:
        """Duplicate a running task on an idle node (first-finisher-wins).
        The backup runs the task's base true runtime — the injected
        straggler inflation models an incident local to the original
        placement (I/O contention, a sick disk), which is exactly what
        speculation exists to escape.  Returns False when the node is not
        actually idle or the task already has a backup."""
        if (uid not in self.running or uid in self.done
                or len(self._launches.get(uid, ())) > 1
                or self.node_free[name] > self.now
                or self._head_runnable(name)):
            return False
        node = self.node_by_name[name]
        start = self.now
        dur = self.true_runtime(uid, node)
        end = start + dur
        failed = name in self.failures and start < self.failures[name] <= end
        if failed:
            end = self.failures[name] + 60.0 + dur
        self.node_free[name] = end
        self._push_finish(uid, name, start, end, failed)
        self.n_backups += 1
        return True

    def start_all_runnable(self):
        for name in self.queues:
            self.try_start(name)

    def pop_event(self) -> Optional[Tuple[str, object]]:
        """Next live event: ("finish", ExecRecord) or ("check", time)."""
        while self._heap:
            end, seq, kind, u, name, start, failed = heapq.heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self.now = end
            if kind == _CHECK:
                return ("check", end)
            # first finisher wins: cancel every other live launch of u and
            # free its slot from the moment the winner finished — but only
            # rewind node_free when the loser was the node's LAST booking
            # (try_start stacks future bookings behind running tasks;
            # rewinding past one would double-book the slot)
            for lseq, lname, lstart, lend in self._launches.pop(u, ()):
                if lseq == seq:
                    continue
                self._cancelled.add(lseq)
                if self.node_free[lname] == lend:
                    self.node_free[lname] = end
                if lstart < end:
                    self.busy[lname].append((lstart, end))
                    self.backup_waste_s += end - lstart
            self.done.add(u)
            self.finish[u] = end
            self.assigned_node[u] = name
            self.running.pop(u, None)
            self.busy[name].append((start, end))
            # attempt > 0 marks a failure re-run: finish - start includes
            # recovery downtime, NOT the task's runtime — observers must
            # filter
            rec = ExecRecord(u, name, start, end, attempt=failed)
            self.records.append(rec)
            return ("finish", rec)
        return None

    def pop(self) -> Optional[ExecRecord]:
        """Next completion (skipping check events)."""
        while True:
            ev = self.pop_event()
            if ev is None:
                return None
            if ev[0] == "finish":
                return ev[1]

    def _head_runnable(self, name: str) -> bool:
        q = self.queues[name]
        return bool(q) and all(d in self.done
                               for d in self.dag.tasks[q[0]].deps)

    def idle_nodes(self) -> List[NodeSpec]:
        """Backup candidates: nodes free right now whose queue is empty or
        dependency-stalled.  A free node with a *runnable* head cannot
        occur between events (try_start would have booked it), so this is
        every node currently wasting a slot — exactly the slack
        speculation exists to use (a backup may delay the stalled queue,
        but first-finisher-wins frees the slot at the winner's finish)."""
        return [self.node_by_name[name] for name, free in
                self.node_free.items()
                if free <= self.now and not self._head_runnable(name)]

    def state(self, now: float) -> SimState:
        return SimState(
            now=now,
            finished={u: (self.assigned_node[u], self.finish[u])
                      for u in self.done},
            running=dict(self.running),
            started=set(self.started))

    def result(self, n_reschedules: int = 0) -> SimResult:
        pending = set(self.dag.tasks) - self.done
        assert not pending, f"deadlock: {sorted(pending)[:5]}"
        return SimResult(makespan=max(self.finish.values(), default=0.0),
                         records=self.records, node_busy=self.busy,
                         n_reschedules=n_reschedules,
                         n_backups=self.n_backups,
                         backup_waste_s=self.backup_waste_s)


def execute_schedule(dag: WorkflowDAG, sched: Schedule,
                     nodes: List[NodeSpec],
                     true_runtime: Callable[[str, NodeSpec], float],
                     failures: Optional[Dict[str, float]] = None,
                     straggler_factor: Optional[Callable[[str], float]] = None,
                     on_complete: Optional[Callable[[ExecRecord, SimState],
                                                    None]] = None
                     ) -> SimResult:
    """Execute a static (HEFT) schedule with true runtimes.

    Per-node task order follows the schedule; a task starts when its node is
    free, all deps finished, and their outputs transferred.  `failures` maps
    node name -> failure time (fail-stop; its queued tasks re-run after a
    fixed recovery on the same node).  `straggler_factor(uid)` optionally
    inflates a task's true runtime (used by the straggler-mitigation tests).
    `on_complete(record, state)` observes every completion in event order —
    the feed for the online prediction service.
    """
    loop = _EventLoop(dag, nodes, true_runtime, failures, straggler_factor)
    # pre-assign for comm lookups (static schedule fixes the placement)
    loop.assigned_node.update(sched.assignment)
    loop.set_queues(sched.order)
    loop.start_all_runnable()
    while True:
        rec = loop.pop()
        if rec is None:
            break
        if on_complete is not None:
            on_complete(rec, loop.state(rec.finish))
        loop.start_all_runnable()
    return loop.result()


def _progress_check(loop: _EventLoop, planner,
                    spec: SpeculationPolicy) -> None:
    """Consult the planner's speculation policy for every running primary
    without a backup; launch backups on idle nodes (greedily, fastest
    predicted idle node per straggler), within the policy's budget caps
    (`max_total_backups` lifetime, `max_concurrent_backups` in flight —
    a straggler denied a slot stays a candidate on later heartbeats)."""
    idle = loop.idle_nodes()
    live = sum(1 for ls in loop._launches.values() if len(ls) > 1)
    for uid, (name, start) in sorted(loop.running.items(),
                                     key=lambda kv: kv[1][1]):
        if not idle:
            return
        if (spec.max_total_backups is not None
                and loop.n_backups >= spec.max_total_backups):
            return                           # lifetime budget spent
        if (spec.max_concurrent_backups is not None
                and live >= spec.max_concurrent_backups):
            return                           # every backup slot in use
        if len(loop._launches.get(uid, ())) > 1:
            continue                         # already speculated
        dec = planner.decide_speculation(uid, name, loop.now - start, idle,
                                         q=spec.q)
        if dec.speculate and dec.backup_node:
            if loop.launch_backup(uid, dec.backup_node):
                live += 1
                idle = [n for n in idle if n.name != dec.backup_node]


def execute_adaptive(dag: WorkflowDAG, nodes: List[NodeSpec],
                     planner,
                     true_runtime: Callable[[str, NodeSpec], float],
                     failures: Optional[Dict[str, float]] = None,
                     straggler_factor: Optional[Callable[[str], float]] = None,
                     speculation: Optional[SpeculationPolicy] = None
                     ) -> SimResult:
    """Event-driven execution with in-flight rescheduling.

    `planner` must provide:
      initial_schedule() -> Schedule                (covers the full DAG)
      on_completion(record, state) -> Optional[Schedule]
    The planner observes every completion (feeding its online predictor);
    when it returns a new Schedule, the not-yet-started frontier is
    re-queued accordingly (booked/running tasks are never recalled).

    With a `SpeculationPolicy`, the loop fires a progress-check event every
    `check_interval_s`; the planner must additionally provide
      decide_speculation(uid, node, elapsed_s, idle_nodes, q)
        -> sched.straggler.SpeculationDecision
    (TypeError otherwise) and flagged stragglers are duplicated on idle
    nodes via backup launches (first finisher wins; the loser is
    cancelled, never recorded).
    """
    loop = _EventLoop(dag, nodes, true_runtime, failures, straggler_factor)
    if speculation is not None and \
            getattr(planner, "decide_speculation", None) is None:
        raise TypeError("speculation needs a planner with "
                        "decide_speculation(uid, node, elapsed_s, "
                        "idle_nodes, q)")
    sched = planner.initial_schedule()
    loop.assigned_node.update(sched.assignment)
    loop.set_queues(sched.order)
    loop.start_all_runnable()
    if speculation is not None:
        loop.push_check(speculation.check_interval_s)
    n_resched = 0
    while True:
        ev = loop.pop_event()
        if ev is None:
            break
        if ev[0] == "check":
            if loop._launches:       # tasks in flight -> keep the heartbeat
                _progress_check(loop, planner, speculation)
                loop.push_check(loop.now + speculation.check_interval_s)
                loop.start_all_runnable()
            continue
        rec = ev[1]
        new_sched = planner.on_completion(rec, loop.state(rec.finish))
        if new_sched is not None:
            n_resched += 1
            # re-queue only the unbooked frontier; keep booked placements
            for u, name in new_sched.assignment.items():
                if u not in loop.started:
                    loop.assigned_node[u] = name
            loop.set_queues({
                name: [u for u in uids if u not in loop.started]
                for name, uids in new_sched.order.items()})
        loop.start_all_runnable()
    return loop.result(n_resched)


def random_cluster(rng: np.random.Generator, pool: List[NodeSpec],
                   n_nodes: int = 20) -> List[NodeSpec]:
    """Section 8.1: clusters of 20 nodes drawn from the machine pool."""
    out = []
    counts: Dict[str, int] = {}
    for _ in range(n_nodes):
        spec = pool[int(rng.integers(0, len(pool)))]
        i = counts.get(spec.name, 0)
        counts[spec.name] = i + 1
        out.append(NodeSpec(f"{spec.name}-{i}", spec.cpu, spec.mem,
                            spec.io_read, spec.io_write, spec.cores,
                            spec.power_watts, spec.price_per_hour,
                            spec.net_gbps))
    return out
