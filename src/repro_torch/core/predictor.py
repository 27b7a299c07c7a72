"""Lotaru predictor (Section 4): local profiling traces -> per-(task, node)
runtime posteriors on a heterogeneous cluster.

Variants:
  Lotaru-G — general microbenchmarks, Eq. 4 factors
  Lotaru-A — application-specific benchmark factors (Eq. 5), median factor
             (Eq. 6) for unbenchmarked tasks
  Lotaru-W — beyond-paper: per-task CPU/IO weighting from local monitoring

The per-task model is the Pearson-gated Bayesian linear regression of
Section 4.5 (median fallback below |r| = 0.75); uncertainty bounds come
from the Bayesian predictive distribution and are scaled by the same factor
as the mean (the factor is a deterministic rescaling of time).

`device` places the per-task fits and the prediction service's kernel
launches: "cuda" (the default) or "cpu".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bayes
from repro_torch.core.baselines import NaivePredictor, OnlineM, OnlineP
from repro_torch.core.correlation import STRONG_CORRELATION
from repro_torch.core.extrapolation import (MachineBench, factor_app_runtime,
                                      factor_general, factor_median,
                                      factor_weighted)
from repro_torch.core.seeding import stable_seed
from repro_torch.core.traces import PredictionRow, TraceRow
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class TaskRuntimeModel:
    task: str
    correlated: bool
    posterior: Optional[dict]      # BLR posterior (if correlated)
    median_s: float
    spread_s: float                # robust std for the median fallback
    cpu_fraction: float
    # raw fit-time observations (3-10 local profiling points): the posterior
    # alone cannot be re-fit, so the maintenance plane's periodic evidence
    # refresh needs these to re-run the MacKay fixed point over fit-time
    # plus streamed data (see online.maintenance)
    fit_x: Optional[np.ndarray] = None
    fit_y: Optional[np.ndarray] = None

    def predict_local(self, input_gb: float) -> Tuple[float, float]:
        if self.correlated and self.posterior is not None:
            mean, std = bayes.predict_blr_np(self.posterior, input_gb)
            return float(mean), float(std)
        return self.median_s, self.spread_s


class LotaruPredictor:
    """fit() on local traces; predict() for any target node."""

    def __init__(self, variant: str = "G",
                 local_bench: Optional[MachineBench] = None,
                 app_bench: Optional[Mapping[str, Mapping[str, float]]] = None,
                 threshold: float = STRONG_CORRELATION,
                 device=DEFAULT_DEVICE):
        """app_bench: task -> {node_name: benchmark runtime} including the
        local machine under key 'local' (Lotaru-A)."""
        assert variant in ("G", "A", "W")
        self.device = resolve_device(device)
        self.variant = variant
        self.local_bench = local_bench
        self.app_bench = dict(app_bench or {})
        self.threshold = threshold
        self.models: Dict[str, TaskRuntimeModel] = {}
        self.version = 0              # bumped per fit: store bindings re-sync
                                      # rows and drop factor caches on refit

    # ---- training -----------------------------------------------------------
    def fit(self, traces: Sequence[TraceRow]) -> "LotaruPredictor":
        self.version += 1             # store bindings full-resync on the
                                      # bump, so the lazy service survives
                                      # refits (no restack-from-scratch)
        by_task: Dict[str, List[TraceRow]] = {}
        for t in traces:
            by_task.setdefault(t.task, []).append(t)
        for task, rows in by_task.items():
            x = np.asarray([r.input_gb for r in rows], np.float32)
            y = np.asarray([r.runtime_s for r in rows], np.float32)
            r = 0.0
            if len(x) >= 2 and np.std(x) > 1e-12 and np.std(y) > 1e-12:
                r = float(np.corrcoef(x, y)[0, 1])
            correlated = abs(r) >= self.threshold
            post = None
            if correlated:
                post = {k: v.cpu().numpy() for k, v in bayes.fit_blr(
                    torch.from_numpy(x).to(self.device),
                    torch.from_numpy(y).to(self.device)).items()}
            self.models[task] = TaskRuntimeModel(
                task=task, correlated=correlated, posterior=post,
                median_s=float(np.median(y)),
                spread_s=float(1.4826 * np.median(np.abs(y - np.median(y)))
                               + 1e-6),
                cpu_fraction=float(np.mean([r_.cpu_fraction for r_ in rows])),
                fit_x=np.asarray(x, np.float64),
                fit_y=np.asarray(y, np.float64),
            )
        return self

    # ---- extrapolation factors ------------------------------------------------
    def factor(self, task: str, target: MachineBench) -> float:
        if self.variant == "A" and self.app_bench:
            if task in self.app_bench and target.name in self.app_bench[task]:
                b = self.app_bench[task]
                return factor_app_runtime(b["local"], b[target.name])
            factors = [factor_app_runtime(b["local"], b[target.name])
                       for b in self.app_bench.values()
                       if target.name in b and "local" in b]
            if factors:
                return factor_median(factors)           # Eq. 6
        if self.local_bench is None or target.name == self.local_bench.name:
            return 1.0
        if self.variant == "W":
            m = self.models.get(task)
            w = m.cpu_fraction if m else 0.5
            return factor_weighted(self.local_bench, target, w)
        return factor_general(self.local_bench, target)   # Eq. 4

    # ---- prediction -------------------------------------------------------------
    @property
    def method_name(self) -> str:
        return f"lotaru-{self.variant.lower()}"

    def task_names(self) -> List[str]:
        return list(self.models)

    def export_posterior(self, task: str) -> dict:
        """predict_blr-compatible posterior for every task: regression tasks
        return the fitted posterior; median-fallback tasks a degenerate one
        whose predictive is exactly (median, spread).  One uniform format is
        what lets the prediction service stack thousands of task models and
        evaluate them in a single batched kernel call."""
        m = self.models[task]
        if m.correlated and m.posterior is not None:
            return m.posterior
        return bayes.constant_posterior(m.median_s, m.spread_s)

    def predict(self, task: str, input_gb: float,
                target: Optional[MachineBench] = None,
                z: float = 1.96) -> Tuple[float, float, float]:
        """-> (mean, lower, upper) seconds on the target node."""
        m = self.models[task]
        mean, std = m.predict_local(input_gb)
        f = self.factor(task, target) if target is not None else 1.0
        mean, std = max(mean, 1e-3) * f, std * f
        return mean, max(mean - z * std, 0.0), mean + z * std

    def predict_rows(self, dag_tasks, targets: Sequence[MachineBench],
                     workflow: str) -> List[PredictionRow]:
        """All (task, node) predictions in one batched service call (the old
        scalar predict loop dispatched one predict_blr per pair).  The
        service (posterior stack + factor cache) is built once per fit and
        reused across calls."""
        from repro_torch.online.service import PredictionService
        if getattr(self, "_service", None) is None:
            self._service = PredictionService(self, device=self.device)
        return self._service.predict_rows(dag_tasks, targets, workflow)


# ---------------------------------------------------------------------------
# baseline wrappers with the same interface (no microbenchmark knowledge)
# ---------------------------------------------------------------------------
class BaselinePredictor:
    def __init__(self, kind: str):
        assert kind in ("naive", "online-m", "online-p")
        self.kind = kind
        self.models: Dict[str, object] = {}

    def fit(self, traces: Sequence[TraceRow]) -> "BaselinePredictor":
        by_task: Dict[str, List[TraceRow]] = {}
        for t in traces:
            by_task.setdefault(t.task, []).append(t)
        for task, rows in by_task.items():
            sizes = [r.input_gb for r in rows]
            runs = [r.runtime_s for r in rows]
            mdl = {"naive": NaivePredictor, "online-m": OnlineM,
                   "online-p": OnlineP}[self.kind]()
            self.models[task] = mdl.fit(sizes, runs)
        return self

    def predict(self, task: str, input_gb: float,
                target: Optional[MachineBench] = None,
                z: float = 1.96) -> Tuple[float, float, float]:
        m = self.models[task]
        if self.kind == "naive":
            mean = m.predict(input_gb)
        else:
            mean = m.predict(input_gb, seed=stable_seed(task, round(input_gb, 6)) % 997)
        mean = max(float(mean), 1e-3)
        return mean, mean, mean      # point predictors: no uncertainty


def make_predictor(method: str, local_bench=None, app_bench=None):
    if method.startswith("lotaru"):
        variant = method.split("-")[-1].upper()
        return LotaruPredictor(variant=variant, local_bench=local_bench,
                               app_bench=app_bench)
    return BaselinePredictor(method)
