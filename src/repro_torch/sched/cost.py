"""Cloud cost prediction (Section 8.3): HEFT schedules a workflow onto cloud
VMs from predicted runtimes; the *predicted* cost bills each VM's predicted
busy window, the *actual* cost bills the realized one.  Over-prediction
inflates expected cost, under-prediction deflates it; minute billing is more
sensitive than hourly (Tables 7-8).

With a decision-plane `PredictionMatrix`, `predicted_cost_quantile` turns
the point estimate into a confidence bound: each task is billed at its
posterior q-quantile duration on its assigned node, so a budget check can
ask "what does this run cost at 95% confidence" instead of trusting the
mean."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.core.microbench import NodeSpec
from repro_torch.sched.heft import Schedule
from repro_torch.sched.plane import PredictionMatrix
from repro_torch.workflow.simulator import SimResult


def _billed_hours(busy_s: float, billing: str) -> float:
    if busy_s <= 0:
        return 0.0
    if billing == "hourly":
        return math.ceil(busy_s / 3600.0)
    if billing == "minute":
        return math.ceil(busy_s / 60.0) / 60.0
    raise ValueError(billing)


def _vm_windows(intervals: Dict[str, List[Tuple[float, float]]]) -> Dict[str, float]:
    """VM rental duration = first start .. last finish per node."""
    out = {}
    for node, iv in intervals.items():
        if iv:
            out[node] = max(b for _, b in iv) - min(a for a, _ in iv)
    return out


def predicted_cost(sched: Schedule, nodes: List[NodeSpec],
                   billing: str) -> float:
    node_by_name = {n.name: n for n in nodes}
    iv: Dict[str, List[Tuple[float, float]]] = {}
    for uid, (s, f) in sched.est.items():
        iv.setdefault(sched.assignment[uid], []).append((s, f))
    total = 0.0
    for node, dur in _vm_windows(iv).items():
        total += _billed_hours(dur, billing) * node_by_name[node].price_per_hour
    return total


def predicted_cost_quantile(sched: Schedule, matrix: PredictionMatrix,
                            nodes: List[NodeSpec], billing: str,
                            q: float = 0.95) -> float:
    """Cost bound at confidence q: every task's billing window runs from
    its scheduled start for the q-quantile of its predictive runtime
    distribution on its assigned node (matrix row), instead of the mean
    the schedule was built from.  q=0.5 reproduces mean durations; a high
    q gives the budget-safe upper bound uncertainty-aware planning wants."""
    node_by_name = {n.name: n for n in nodes}
    iv: Dict[str, List[Tuple[float, float]]] = {}
    for uid, (s, _) in sched.est.items():
        name = sched.assignment[uid]
        dur = max(matrix.row(uid).quantile(name, q), 0.0)
        iv.setdefault(name, []).append((s, s + dur))
    total = 0.0
    for node, dur in _vm_windows(iv).items():
        total += _billed_hours(dur, billing) * node_by_name[node].price_per_hour
    return total


def actual_cost(result: SimResult, nodes: List[NodeSpec],
                billing: str) -> float:
    node_by_name = {n.name: n for n in nodes}
    total = 0.0
    for node, dur in _vm_windows(result.node_busy).items():
        total += _billed_hours(dur, billing) * node_by_name[node].price_per_hour
    return total


def cost_deviation_pct(pred: float, actual: float) -> float:
    """positive = over-prediction (cheaper in reality), Tables 7-8."""
    return 100.0 * (pred - actual) / max(actual, 1e-9)
