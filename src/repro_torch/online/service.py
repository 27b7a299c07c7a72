"""PredictionService: one (tenant, workflow) serving view over the shared
PosteriorStore.

A scheduler planning T tasks on N nodes issues T x N runtime queries.  The
store owns the stacked float64 leaves: the service binds its predictor to a
namespace, pushes only *dirty* rows on sync (copy-on-write, one block
touched per online update), gathers per-query rows from an immutable
snapshot, and evaluates the whole batch in ONE call to the shared
predictive path (one `bayes_predict` kernel launch on the card, its plain
float64 version on the CPU).  Extrapolation factors are deterministic
scalar rescalings applied outside the kernel, cached per predictor fit
version in the binding (a refit can never serve stale factors).

Many services — one per workflow/tenant — can share one store.

Works with any predictor exposing `task_names() / export_posterior(task) /
factor(task, bench)` — LotaruPredictor does.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.traces import PredictionRow
from repro_torch.online.events import PredictionQuery
from repro_torch.store import (DEFAULT_TENANT, DEFAULT_WORKFLOW, PosteriorStore,
                         TenantBinding)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.store.compute import finalize, predict_stacked, scale


class PredictionService:
    def __init__(self, predictor,
                 benches: Optional[Mapping[str, MachineBench]] = None,
                 z: float = 1.96, device=DEFAULT_DEVICE,
                 store: Optional[PosteriorStore] = None,
                 tenant: str = DEFAULT_TENANT,
                 workflow: str = DEFAULT_WORKFLOW):
        self.predictor = predictor
        self.z = z
        self.device = resolve_device(device)
        self.store = store if store is not None else PosteriorStore()
        self._binding: TenantBinding = self.store.bind(tenant, workflow,
                                                       predictor, benches)
        # shared with the binding so predict_rows' setdefault and the
        # front-end's factor path see one registry
        self.benches = self._binding.benches

    # ---- posterior sync -----------------------------------------------------
    @property
    def tenant(self) -> str:
        return self._binding.tenant

    @property
    def workflow(self) -> str:
        return self._binding.workflow

    def refresh(self, force: bool = False) -> int:
        """Resync this namespace.  Returns the number of rows restacked.
        Generation-aware: when the binding is already current (change
        cursor at the head of the predictor's feed, synced and
        factor-cache versions live) this is a no-op — no rows are
        rewritten and the store generation does not move.  Only a binding
        that is actually behind pays the full restack + factor-cache drop.
        (Incremental dirty-row sync still happens automatically on every
        predict.)

        `force=True` skips the currency check — required for model edits
        no version counter or change feed can see (mutating a fitted
        model's fields in place, swapping `base.app_bench` entries):
        those look 'current' to the binding, so only a forced full sync
        picks them up."""
        if not force and self._binding.is_current():
            return 0
        return self._binding.sync(full=True)

    # ---- batched prediction -------------------------------------------------
    def predict_batch(self, queries: Sequence[PredictionQuery]
                      ) -> np.ndarray:
        """-> (Q, 3) array of [mean, lower, upper] seconds."""
        if not queries:
            return np.zeros((0, 3), np.float32)
        self._binding.sync()
        snap = self.store.snapshot()
        keys = [self._binding.key_str(q.task) for q in queries]
        x = np.asarray([q.input_gb for q in queries])
        mean, std = predict_stacked(x, lambda out: snap.gather(keys, out),
                                    device=self.device)
        return finalize(mean, std, self._binding.factors(queries), self.z)

    def predict_matrix(self, tasks: Sequence[Tuple[str, float]],
                       nodes: Sequence[Optional[str]]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) (T, N) float64 arrays for every (task, node) pair —
        the decision plane's one-dispatch-per-planning-round primitive.

        Node never enters the predictive kernel (extrapolation factors are
        deterministic per-(task, node) rescalings), so the matrix costs a
        single T-row store gather + ONE batched predictive call + a (T, N)
        factor scaling — not the T x N rows a flattened predict_batch
        would gather.  Values are elementwise-identical to predict_batch
        over the flattened queries (same gathered rows, same finalize
        arithmetic)."""
        if not tasks or not nodes:
            return (np.zeros((len(tasks), len(nodes))),
                    np.zeros((len(tasks), len(nodes))))
        self._binding.sync()
        snap = self.store.snapshot()
        keys = [self._binding.key_str(t) for t, _ in tasks]
        x = np.asarray([gb for _, gb in tasks])
        mean, std = predict_stacked(x, lambda out: snap.gather(keys, out),
                                    device=self.device)
        f = self._binding.factor_matrix([t for t, _ in tasks], list(nodes))
        return scale(mean[:, None], std[:, None], f)

    def predict_rows(self, dag_tasks, targets: Sequence[MachineBench],
                     workflow: str) -> List[PredictionRow]:
        """Vectorized replacement for the per-(task, node) scalar loop."""
        for b in targets:
            self.benches.setdefault(b.name, b)
        queries = [PredictionQuery(t.task_name, tgt.name, t.input_gb)
                   for t in dag_tasks for tgt in targets]
        out = self.predict_batch(queries)
        method = getattr(self.predictor, "method_name", "service")
        return [PredictionRow(workflow=workflow, task=q.task, node=q.node,
                              input_gb=q.input_gb, predicted_s=float(m),
                              lower_s=float(lo), upper_s=float(hi),
                              method=method)
                for q, (m, lo, hi) in zip(queries, out)]
