"""HEFT (Heterogeneous Earliest-Finish-Time) [Topcuoglu et al. 2002] with
insertion-based slot search — the scheduling consumer of Lotaru's
predictions (Section 8.1).

Two entry points share one vectorized core:

  * `heft_schedule_matrix(dag, nodes, matrix)` — the decision-plane path:
    ranks and places straight off a `sched.plane.PredictionMatrix`
    (NumPy upward-rank + a per-task candidate-EFT sweep across all nodes),
    optionally at a pessimistic quantile (mean + z*std);
  * `heft_schedule(dag, nodes, predict)` — the legacy scalar-callback
    signature, now a thin adapter that materializes the matrix once and
    delegates.  Bit-identical to the retired scalar implementation (kept
    as `heft_schedule_reference` for the parity suite and the replan
    latency benchmark baseline).

The vectorized core is arithmetic-compatible with the reference on
purpose: sums are sequential (`cumsum`), communication terms use the exact
`comm_seconds` expression elementwise, and ties resolve to the first node
in list order — so the parity tests can assert bitwise-equal schedules.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.microbench import NodeSpec
from repro_torch.sched.plane import PredictionMatrix
from repro_torch.workflow.dag import WorkflowDAG


@dataclass
class ScheduledTask:
    uid: str
    node: str
    est: float     # estimated (predicted) start
    eft: float     # estimated finish


@dataclass
class Schedule:
    assignment: Dict[str, str] = field(default_factory=dict)   # uid -> node
    order: Dict[str, List[str]] = field(default_factory=dict)  # node -> uids
    est: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    @property
    def predicted_makespan(self) -> float:
        return max((f for _, f in self.est.values()), default=0.0)


def comm_seconds(gb: float, a: NodeSpec, b: NodeSpec) -> float:
    if a.name == b.name:
        return 0.0
    gbps = min(getattr(a, "net_gbps", 1.0), getattr(b, "net_gbps", 1.0))
    return gb * 8.0 / gbps


def heft_schedule(dag: WorkflowDAG, nodes: List[NodeSpec],
                  predict: Union[Callable[[str, NodeSpec], float],
                                 PredictionMatrix],
                  ready_at=None,
                  node_available: Optional[Dict[str, float]] = None,
                  quantile: Optional[float] = None) -> Schedule:
    """predict is either a scalar callable (uid, node) -> seconds or a
    `PredictionMatrix` covering every task in `dag`.

    `ready_at` constrains task start times from outside the DAG (e.g.
    in-flight rescheduling: data from already-finished tasks): either a
    {uid: time} dict or a callable (uid, node) -> time so comm from the
    producing node can be charged per candidate.  `node_available` maps
    node name -> earliest free time (a node still running a task).
    `quantile` schedules on mean + z*std instead of the mean; it needs the
    matrix's uncertainty, so the scalar-callable form rejects it."""
    if not isinstance(predict, PredictionMatrix):
        if quantile is not None:
            raise ValueError("quantile scheduling needs a PredictionMatrix "
                             "(a scalar callable carries no uncertainty)")
        predict = PredictionMatrix.from_callable(list(dag.tasks), nodes,
                                                 predict)
    return heft_schedule_matrix(dag, nodes, predict, ready_at=ready_at,
                                node_available=node_available,
                                quantile=quantile)


def comm_structure(nodes: List[NodeSpec]) -> Tuple[np.ndarray, np.ndarray]:
    """(same, gbps_min) pairwise arrays: comm_seconds(gb, a, b) == 0 where
    `same`, (gb * 8.0) / gbps_min elsewhere — the elementwise form every
    vectorized path (rank, placement, the fused engine) charges."""
    net = np.asarray([float(getattr(n, "net_gbps", 1.0)) for n in nodes])
    gbps_min = np.minimum.outer(net, net)
    same = np.asarray([[a.name == b.name for b in nodes] for a in nodes])
    return same, gbps_min


def upward_ranks(dag: WorkflowDAG, nodes: List[NodeSpec], W: np.ndarray,
                 order: Optional[List[str]] = None,
                 same: Optional[np.ndarray] = None,
                 gbps_min: Optional[np.ndarray] = None) -> Dict[str, float]:
    """HEFT upward ranks off a (T, N) cost array whose rows follow
    `order` (default `dag.topo_order()`): w_avg as a sequential row sum
    (cumsum matches the scalar reference's left-to-right float
    accumulation), avg pairwise comm per task from its output size, then
    the usual reverse-topo recurrence.  Shared by `heft_schedule_matrix`
    and the fused engine's parity tests."""
    if order is None:
        order = dag.topo_order()
    if same is None or gbps_min is None:
        same, gbps_min = comm_structure(nodes)
    n_nodes = len(nodes)
    row_of = {u: i for i, u in enumerate(order)}
    w_avg_arr = W.cumsum(axis=1)[:, -1] / n_nodes if n_nodes else W.sum(1)
    avg_comm: Dict[str, float] = {}
    for u in order:
        gb = dag.tasks[u].output_gb
        terms = np.where(same, 0.0, (gb * 8.0) / gbps_min)
        avg_comm[u] = float(terms.ravel().cumsum()[-1]) / (n_nodes ** 2)
    succ = dag.successors()
    rank: Dict[str, float] = {}
    for u in reversed(order):
        best = 0.0
        for v in succ[u]:
            best = max(best, avg_comm[u] + rank[v])
        rank[u] = float(w_avg_arr[row_of[u]]) + best
    return rank


def heft_schedule_matrix(dag: WorkflowDAG, nodes: List[NodeSpec],
                         matrix: PredictionMatrix,
                         ready_at=None,
                         node_available: Optional[Dict[str, float]] = None,
                         quantile: Optional[float] = None) -> Schedule:
    """Vectorized HEFT over a decision-plane matrix (see heft_schedule)."""
    order = dag.topo_order()
    names = [n.name for n in nodes]
    n_nodes = len(nodes)
    W = matrix.costs(order, names, quantile=quantile)        # (T, N)
    row_of = {u: i for i, u in enumerate(order)}
    same, gbps_min = comm_structure(nodes)
    rank = upward_ranks(dag, nodes, W, order, same, gbps_min)

    sched = Schedule(order={name: [] for name in names})
    idx_of_name = {name: j for j, name in enumerate(names)}
    slots: Dict[str, List[Tuple[float, float]]] = {
        n.name: ([(0.0, node_available[n.name])]
                 if node_available and node_available.get(n.name, 0.0) > 0.0
                 else []) for n in nodes}
    finish: Dict[str, float] = {}

    for u in sorted(order, key=lambda u: -rank[u]):
        t = dag.tasks[u]
        # candidate-EFT sweep: ready/duration vectors over every node, a
        # slot search per candidate, first-minimum EFT wins (ties resolve
        # to the earlier node in list order, like the scalar reference)
        if ready_at is None:
            ready = np.zeros(n_nodes)
        elif callable(ready_at):
            ready = np.asarray([ready_at(u, n) for n in nodes], np.float64)
        else:
            ready = np.full(n_nodes, ready_at.get(u, 0.0), np.float64)
        for d in t.deps:
            dn = idx_of_name[sched.assignment[d]]
            comm = np.where(same[dn], 0.0,
                            (dag.tasks[d].output_gb * 8.0) / gbps_min[dn])
            ready = np.maximum(ready, finish[d] + comm)
        dur = W[row_of[u]]
        est = np.asarray([_earliest_slot(slots[names[j]], ready[j], dur[j])
                          for j in range(n_nodes)], np.float64)
        eft = est + dur
        j = int(np.argmin(eft))
        name = names[j]
        slots[name].append((float(est[j]), float(eft[j])))
        slots[name].sort()
        sched.assignment[u] = name
        sched.order[name].append(u)
        sched.est[u] = (float(est[j]), float(eft[j]))
        finish[u] = float(eft[j])
    for name in sched.order:
        sched.order[name].sort(key=lambda u: sched.est[u][0])
    return sched


def heft_schedule_reference(dag: WorkflowDAG, nodes: List[NodeSpec],
                            predict: Callable[[str, NodeSpec], float],
                            ready_at=None,
                            node_available: Optional[Dict[str, float]] = None
                            ) -> Schedule:
    """The retired scalar implementation: one predict() call per
    (task, node) in the rank pass and another per placement candidate.
    Kept as the bit-parity oracle for the vectorized core and as the
    baseline of `benchmarks/replan_latency.py` — not a serving path."""
    succ = dag.successors()
    order = dag.topo_order()
    w_avg = {u: sum(predict(u, n) for n in nodes) / len(nodes) for u in order}

    # upward rank
    rank: Dict[str, float] = {}
    for u in reversed(order):
        best = 0.0
        t = dag.tasks[u]
        for v in succ[u]:
            avg_comm = sum(comm_seconds(t.output_gb, a, b)
                           for a in nodes for b in nodes) / (len(nodes) ** 2)
            best = max(best, avg_comm + rank[v])
        rank[u] = w_avg[u] + best

    sched = Schedule(order={n.name: [] for n in nodes})
    node_by_name = {n.name: n for n in nodes}
    slots: Dict[str, List[Tuple[float, float]]] = {
        n.name: ([(0.0, node_available[n.name])]
                 if node_available and node_available.get(n.name, 0.0) > 0.0
                 else []) for n in nodes}
    finish: Dict[str, float] = {}

    for u in sorted(order, key=lambda u: -rank[u]):
        t = dag.tasks[u]
        best = None
        for n in nodes:
            if ready_at is None:
                ready = 0.0
            elif callable(ready_at):
                ready = ready_at(u, n)
            else:
                ready = ready_at.get(u, 0.0)
            for d in t.deps:
                dn = node_by_name[sched.assignment[d]]
                ready = max(ready, finish[d] +
                            comm_seconds(dag.tasks[d].output_gb, dn, n))
            dur = predict(u, n)
            est = _earliest_slot(slots[n.name], ready, dur)
            if best is None or est + dur < best[1]:
                best = (est, est + dur, n.name)
        est, eft, name = best
        slots[name].append((est, eft))
        slots[name].sort()
        sched.assignment[u] = name
        sched.order[name].append(u)
        sched.est[u] = (est, eft)
        finish[u] = eft
    for name in sched.order:
        sched.order[name].sort(key=lambda u: sched.est[u][0])
    return sched


def _earliest_slot(busy: List[Tuple[float, float]], ready: float,
                   dur: float) -> float:
    """insertion policy: earliest gap >= dur after `ready`."""
    start = ready
    for (b0, b1) in busy:
        if start + dur <= b0:
            return start
        start = max(start, b1)
    return start
