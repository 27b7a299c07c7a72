"""The vectorized decision plane: one batched prediction matrix per
planning round, shared by every scheduling/cost/carbon/speculation policy.

The paper's headline use of Lotaru is feeding predicted runtimes *and
their uncertainty* into resource-management decisions (Sections 8-9).
Before this layer every consumer pulled scalars through its own callback —
a HEFT replan made O(tasks x nodes) individual `predict(uid, node)` calls
even though the posterior store serves the whole matrix in one batched
dispatch.  `PredictionMatrix` materializes that matrix once
(tasks x nodes mean/std arrays plus uid/node index maps) and the policy
modules consume rows of it:

  * `heft_schedule_matrix` ranks and places straight off the arrays
    (optionally at a pessimistic quantile, mean + z*std);
  * `sched.straggler.decide_speculation` reads a `TaskDistribution` row;
  * `sched.cost.predicted_cost_quantile` bills quantile durations;
  * `sched.carbon.shift_workload` books quantile hours from a
    `RuntimeDist`.

Constructors: `from_service` costs ONE store gather + ONE batched predictive
dispatch (`PredictionService.predict_matrix`); `from_callable` adapts any
scalar `predict(uid, node)` so legacy callers keep working bit-identically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.microbench import NodeSpec
from repro_torch.sched.straggler import cached_z, normal_quantile


def quantile_z(q: float) -> float:
    """z-score of quantile q (shared ndtri; q=0.5 -> 0.0 exactly).
    Memoized — planning rounds hit the same handful of quantiles."""
    return cached_z(float(q))


@dataclass(frozen=True)
class RuntimeDist:
    """One scalar predictive runtime distribution N(mean, std) — the
    currency policies accept instead of a bare float."""
    mean: float
    std: float

    def quantile(self, q: float) -> float:
        return float(normal_quantile(self.mean, self.std, q))


@dataclass(frozen=True)
class TaskDistribution:
    """One matrix row: a task's predictive N(mean, std) on every node.

    `node_index` is the name -> column map; rows sliced off one matrix
    share the matrix's dict (built once per round, not once per row).  A
    row constructed without it builds its own lazily on first lookup —
    either way `on()` is a dict hit, not an O(N) `tuple.index` scan (the
    speculation heartbeat calls it per running task per check)."""
    uid: str
    node_names: Tuple[str, ...]
    means: np.ndarray              # (N,) float64
    stds: np.ndarray               # (N,) float64
    node_index: Optional[Dict[str, int]] = None

    def on(self, node: str) -> Tuple[float, float]:
        ix = self.node_index
        if ix is None:
            ix = {n: j for j, n in enumerate(self.node_names)}
            object.__setattr__(self, "node_index", ix)   # frozen: memoize
        i = ix[node]
        return float(self.means[i]), float(self.stds[i])

    def dist(self, node: str) -> RuntimeDist:
        return RuntimeDist(*self.on(node))

    def quantile(self, node: str, q: float) -> float:
        mean, std = self.on(node)
        return float(normal_quantile(mean, std, q))


class PredictionMatrix:
    """tasks x nodes predictive means/stds with uid/node index maps.

    Materialized once per planning round; every consumer indexes into the
    same arrays instead of issuing its own scalar predictions."""

    __slots__ = ("uids", "node_names", "means", "stds",
                 "uid_index", "node_index")

    def __init__(self, uids: Sequence[str], node_names: Sequence[str],
                 means: np.ndarray, stds: Optional[np.ndarray] = None):
        self.uids: Tuple[str, ...] = tuple(uids)
        self.node_names: Tuple[str, ...] = tuple(node_names)
        self.means = np.asarray(means, np.float64)
        self.stds = (np.zeros_like(self.means) if stds is None
                     else np.asarray(stds, np.float64))
        shape = (len(self.uids), len(self.node_names))
        if self.means.shape != shape or self.stds.shape != shape:
            raise ValueError(f"matrix arrays must be {shape}, got "
                             f"{self.means.shape} / {self.stds.shape}")
        self.uid_index: Dict[str, int] = {u: i for i, u in
                                          enumerate(self.uids)}
        self.node_index: Dict[str, int] = {n: j for j, n in
                                           enumerate(self.node_names)}

    # ---- element / row access ----------------------------------------------
    def mean(self, uid: str, node: str) -> float:
        return float(self.means[self.uid_index[uid], self.node_index[node]])

    def std(self, uid: str, node: str) -> float:
        return float(self.stds[self.uid_index[uid], self.node_index[node]])

    def on(self, uid: str, node: str) -> Tuple[float, float]:
        i, j = self.uid_index[uid], self.node_index[node]
        return float(self.means[i, j]), float(self.stds[i, j])

    def row(self, uid: str) -> TaskDistribution:
        i = self.uid_index[uid]
        return TaskDistribution(uid=uid, node_names=self.node_names,
                                means=self.means[i], stds=self.stds[i],
                                node_index=self.node_index)

    def costs(self, uids: Sequence[str], node_names: Sequence[str],
              quantile: Optional[float] = None) -> np.ndarray:
        """(len(uids), len(node_names)) cost array reindexed to the given
        orders — the scheduling currency.  `quantile` schedules on the
        pessimistic mean + z*std instead of the mean."""
        rows = np.asarray([self.uid_index[u] for u in uids], np.int64)
        cols = np.asarray([self.node_index[n] for n in node_names], np.int64)
        w = self.means[np.ix_(rows, cols)]
        if quantile is not None:
            w = w + quantile_z(quantile) * self.stds[np.ix_(rows, cols)]
        return w

    # ---- constructors -------------------------------------------------------
    @classmethod
    def from_service(cls, service, entries: Sequence[Tuple[str, str, float]],
                     nodes: Sequence) -> "PredictionMatrix":
        """Materialize the matrix in ONE batched dispatch.

        `entries` are (uid, task_name, input_gb) triples; `nodes` are
        NodeSpec instances or plain node names.  `service` is any object
        with `predict_matrix(tasks, node_names) -> (mean, std)` —
        `repro_torch.online.service.PredictionService` gathers the task rows
        once from the posterior store and scales by the per-node factor
        matrix, so the cost is T gathered rows + one predictive kernel
        call, not T x N scalar predictions."""
        names = [getattr(n, "name", n) for n in nodes]
        mean, std = service.predict_matrix(
            [(task, gb) for _, task, gb in entries], names)
        return cls([u for u, _, _ in entries], names, mean, std)

    @classmethod
    def from_callable(cls, uids: Sequence[str], nodes: Sequence[NodeSpec],
                      predict: Callable[[str, NodeSpec], float]
                      ) -> "PredictionMatrix":
        """Adapt a scalar predict(uid, node) callback (stds are zero: a
        bare callable carries no uncertainty).  This is the compatibility
        shim `heft_schedule` uses, so legacy callers pay the same O(T x N)
        calls they always did — once — and then run the vectorized core."""
        means = np.asarray([[float(predict(u, n)) for n in nodes]
                            for u in uids], np.float64)
        return cls(list(uids), [n.name for n in nodes], means)
