"""Elastic scaling + fault-tolerance policies driven by runtime predictions.

  * Young-Daly optimal checkpoint interval from the predicted step time,
    in seconds and in training steps.
  * Elastic worker-count choice: smallest pool meeting a deadline under the
    predicted (mean + z*std) step time — uncertainty-aware, so the decision
    is robust rather than optimistic (the paper's Bayesian bounds at work).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


def young_daly_interval_s(ckpt_cost_s: float, mtbf_s: float) -> float:
    """sqrt(2 * C * MTBF) — first-order optimal checkpoint period."""
    return math.sqrt(2.0 * max(ckpt_cost_s, 1e-9) * max(mtbf_s, 1e-9))


def checkpoint_every_n_steps(step_time_s: float, ckpt_cost_s: float,
                             node_mtbf_s: float, n_nodes: int) -> int:
    """cluster MTBF = node MTBF / n; interval expressed in steps."""
    mtbf = node_mtbf_s / max(n_nodes, 1)
    interval = young_daly_interval_s(ckpt_cost_s, mtbf)
    return max(1, int(round(interval / max(step_time_s, 1e-9))))


def expected_waste_fraction(step_time_s: float, interval_steps: int,
                            ckpt_cost_s: float, node_mtbf_s: float,
                            n_nodes: int) -> float:
    """checkpoint overhead + expected rework per failure (first-order)."""
    mtbf = node_mtbf_s / max(n_nodes, 1)
    period = interval_steps * step_time_s
    ckpt_frac = ckpt_cost_s / period
    rework_frac = 0.5 * period / mtbf
    return ckpt_frac + rework_frac


@dataclass
class ScaleDecision:
    n_workers: int
    predicted_hours: float
    meets_deadline: bool


def choose_workers(total_steps: int, step_time_mean_s: float,
                   step_time_std_s: float, deadline_h: float,
                   max_workers: int, scaling_efficiency: float = 0.92,
                   z: float = 1.645) -> ScaleDecision:
    """smallest worker count whose pessimistic (mean + z*std) completion
    beats the deadline; sub-linear scaling via `scaling_efficiency`."""
    pessimistic = step_time_mean_s + z * step_time_std_s
    best: Optional[ScaleDecision] = None
    for n in range(1, max_workers + 1):
        speedup = n ** (math.log(2 * scaling_efficiency) / math.log(2)) \
            if n > 1 else 1.0
        hours = total_steps * pessimistic / speedup / 3600.0
        best = ScaleDecision(n, hours, hours <= deadline_h)
        if best.meets_deadline:
            return best
    return best
