"""OnlinePredictor: a fitted Lotaru predictor that keeps learning.

Lotaru (Section 4.5) fits once on downsampled local profiling traces and
never touches the model again — exactly the cold-start regime the paper
targets.  This wrapper folds in measurements *as tasks finish* with two
exact mechanisms:

  * per-task regression: the fitted BLR posterior is lifted into a
    conjugate NIG state (core.bayes.nig_from_blr); every completion is a
    rank-1 precision update — no refit, O(1) per event, exactly equal to
    the batch posterior on the same data;
  * per-node factor recalibration: observed/predicted log-ratios per node
    form a shrunk multiplicative correction on the Section 4.6 factors
    (the dominant heterogeneous error source: benchmark readings are noisy
    and workload-dependent).

Median-fallback (weakly correlated) tasks keep a streaming observation
buffer: the median/MAD update on full-scale observations fixes the
paper's known weakness of predicting merge-task runtimes from downsampled
profiles, and a task is promoted to a regression model if correlation
emerges once real input sizes spread out.

`device` places the batched write path: on "cuda" (the default) every
fold group of `observe_many` runs through the float64 `nig_fold` kernel,
on "cpu" through the float64 numpy fold; both are bitwise the scalar
`observe` chain, so `export_state` does not depend on the device.  The
promotion fit and the lazy prediction service run there too.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bayes
from repro_torch.core.correlation import STRONG_CORRELATION
from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.predictor import LotaruPredictor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.online.events import TaskCompletion, resolve_bench
from repro_torch.store import compute

MAX_BUFFER = 256          # per-task observation cap (bounded memory)
FACTOR_SHRINK_K = 2.0     # pseudo-count pulling the node correction to 1
FACTOR_CLIP = 4.0         # correction bounded to [1/4, 4]
FACTOR_DEADBAND = 0.12    # |median log ratio| below this -> no correction:
                          # deviations inside the static predictor's own
                          # error floor (Eq. 4's fixed CPU/IO weighting is
                          # ~10% off per task class) are task-mix bias, not
                          # a benchmark miss, and would not transfer to the
                          # other tasks scheduled on the node
NODE_MATURE_N = 5         # remote obs feed the task posterior only once the
                          # node's correction rests on this many ratios
MAX_NODE_LOGS = 64


@dataclass
class _NodeStats:
    """Observed/predicted log-ratios on one node, grouped by task.

    A node-level correction must capture what is common to ALL tasks on the
    node (a mis-benchmarked machine) and reject what is task-specific
    (Eq. 4's fixed CPU/IO weighting vs each task's real compute share).
    Each task contributes ONE median ratio, and the correction is the
    median across tasks, applied only when it is significant against the
    cross-task spread."""
    logs_by_task: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return sum(len(v) for v in self.logs_by_task.values())

    def update(self, task: str, ratio: float):
        logs = self.logs_by_task.setdefault(task, [])
        if len(logs) >= MAX_NODE_LOGS:
            logs.pop(0)
        logs.append(math.log(max(ratio, 1e-6)))

    @property
    def correction(self) -> float:
        meds = [float(np.median(v)) for v in self.logs_by_task.values() if v]
        if len(meds) < 2:
            return 1.0
        med = float(np.median(meds))
        a = np.asarray(meds)
        sd = 1.4826 * float(np.median(np.abs(a - med)))
        se_med = 1.2533 * sd / math.sqrt(len(meds))
        if abs(med) < max(FACTOR_DEADBAND, 2.0 * se_med):
            return 1.0
        w = self.n / (self.n + FACTOR_SHRINK_K)
        return float(np.clip(math.exp(w * med), 1.0 / FACTOR_CLIP,
                             FACTOR_CLIP))


@dataclass
class IngestStats:
    """Write-path telemetry: how observations entered the posteriors, and
    at what batching leverage.  `flushes` and `generations_published` are
    counted by the serving tier above the predictor (`repro_torch.serve.
    shard`); the dict form is the reference's."""
    batches: int = 0               # observe_many calls
    records: int = 0               # completions ingested (incl. dropped)
    folded: int = 0                # records absorbed by the batched fold
    fold_dispatches: int = 0       # fold_stacked calls issued
    scalar: int = 0                # records that took the per-record path
    lock_acquisitions: int = 0     # state-lock acquisitions for ingest
    flushes: int = 0               # oplog commits (group commit: 1/batch)
    generations_published: int = 0  # store COW generations from ingest

    def as_dict(self) -> dict:
        return {"batches": self.batches, "records": self.records,
                "folded": self.folded,
                "fold_dispatches": self.fold_dispatches,
                "scalar": self.scalar,
                "lock_acquisitions": self.lock_acquisitions,
                "flushes": self.flushes,
                "generations_published": self.generations_published}

    def merge(self, other: "IngestStats") -> "IngestStats":
        for f in self.as_dict():
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self


def _ring() -> Deque[float]:
    return deque(maxlen=MAX_BUFFER)


@dataclass
class _TaskState:
    nig: Optional[dict]                     # streaming posterior (correlated)
    median_s: float
    spread_s: float
    xs: Deque[float] = field(default_factory=_ring)   # local-equivalent obs
    ys: Deque[float] = field(default_factory=_ring)   # (ring: newest 256)
    fit_xs: List[float] = field(default_factory=list)   # fit-time profiling
    fit_ys: List[float] = field(default_factory=list)   # points (refresh)
    since_refresh: int = 0    # posterior-moving completions since the last
                              # evidence refresh


class OnlinePredictor:
    """Same predict() interface as LotaruPredictor, plus observe()."""

    def __init__(self, base: LotaruPredictor,
                 benches: Optional[Mapping[str, MachineBench]] = None,
                 threshold: float = STRONG_CORRELATION,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.base = base
        self.benches = dict(benches or {})
        self.threshold = threshold
        self.version = 0                      # bumped on observe (store
        self.node_stats: Dict[str, _NodeStats] = {}     # sync trigger)
        self.tasks: Dict[str, _TaskState] = {}
        self._service = None                  # lazy predict_rows service
        for task, m in base.models.items():
            nig = bayes.nig_from_blr(m.posterior) if (
                m.correlated and m.posterior is not None) else None
            st = _TaskState(nig=nig, median_s=m.median_s,
                            spread_s=m.spread_s)
            if nig is not None and getattr(m, "fit_x", None) is not None:
                # fit-time points feed periodic evidence refreshes; a
                # median-fallback task keeps none (its downsampled profile
                # points are exactly what a later promotion must NOT trust)
                st.fit_xs = [float(v) for v in m.fit_x]
                st.fit_ys = [float(v) for v in m.fit_y]
            self.tasks[task] = st
        # non-destructive change feed: per-task last-change sequence numbers
        # (store bindings each diff against their own cursor, so ONE
        # predictor can feed any number of bindings/stores)
        self._change_seq = 1
        self._task_changes: Dict[str, int] = {t: 1 for t in self.tasks}
        # serializes state mutation (observe / apply_refresh / load_state)
        # against a refresh's snapshot-fit-apply cycle; the seq guard in
        # apply_refresh is only airtight if the check and the swap cannot
        # interleave with a concurrent observe()
        self._state_lock = threading.Lock()
        self.ingest = IngestStats()           # write-path telemetry

    # ---- prediction ---------------------------------------------------------
    @property
    def method_name(self) -> str:
        return f"online-{self.base.method_name}"

    def task_names(self):
        return list(self.tasks)

    def changed_since(self, cursor: float):
        """-> (tasks whose posterior changed after `cursor`, new cursor).
        Non-destructive: each PosteriorStore binding keeps its own cursor
        and re-syncs only these rows instead of restacking every task on
        each version bump.  Covers load_state() rollbacks too (loading
        bumps every task's change sequence)."""
        seq = self._change_seq
        if cursor >= seq:
            return [], seq
        return (sorted(t for t, s in self._task_changes.items()
                       if s > cursor), seq)

    def _mark_changed(self, task: str) -> None:
        self._change_seq += 1
        self._task_changes[task] = self._change_seq

    def export_posterior(self, task: str) -> dict:
        """predict_blr-compatible posterior (feeds the batched service)."""
        st = self.tasks[task]
        if st.nig is not None:
            return bayes.nig_to_blr(st.nig)
        return bayes.constant_posterior(st.median_s, st.spread_s)

    def factor(self, task: str, target: Optional[MachineBench]) -> float:
        """static Section 4.6 factor x streaming per-node correction."""
        if target is None:
            return 1.0
        return self.base.factor(task, target) \
            * self.node_correction(target.name)

    def node_correction(self, node: Optional[str]) -> float:
        """streaming multiplicative correction for one node (1.0 while the
        observed/predicted ratios stay inside the significance gate)."""
        bench = self._bench(node)
        if bench is None:
            return 1.0
        stats = self.node_stats.get(bench.name)
        return stats.correction if stats else 1.0

    def predict(self, task: str, input_gb: float,
                target: Optional[MachineBench] = None,
                z: float = 1.96) -> Tuple[float, float, float]:
        """-> (mean, lower, upper) seconds on the target node."""
        mean, std = bayes.predict_blr_np(self.export_posterior(task),
                                         input_gb)
        f = self.factor(task, target)
        mean = max(float(mean), 1e-3) * f
        std = float(std) * f
        return mean, max(mean - z * std, 0.0), mean + z * std

    def predict_rows(self, dag_tasks, targets, workflow: str):
        from repro_torch.online.service import PredictionService
        if self._service is None:
            self._service = PredictionService(self, device=self.device)
        return self._service.predict_rows(dag_tasks, targets, workflow)

    # ---- learning -----------------------------------------------------------
    def _bench(self, node: Optional[str]) -> Optional[MachineBench]:
        return resolve_bench(self.benches, node)

    def observe(self, comp: TaskCompletion) -> None:
        """Fold one completed task into the posteriors (exact updates, the
        scalar `nig_update` chain on the host).

        When `observe_log` is set (the serving shard's oplog hook) it is
        called with `comp` under the state lock BEFORE the update is
        applied: write-ahead order, so a completion is durable in the log
        before it can mutate state, and a hook that raises leaves the
        state untouched."""
        with self._state_lock:
            self.ingest.lock_acquisitions += 1
            self.ingest.records += 1
            self.ingest.scalar += 1
            hook = getattr(self, "observe_log", None)
            if hook is not None:
                hook(comp)
            self._observe(comp)

    def observe_many(self, comps: Sequence[TaskCompletion]) -> int:
        """Fold a batch of completions under ONE state-lock acquisition.

        Exactness contract: the resulting state is bit-identical to calling
        `observe(comp)` for each completion in order — the scalar chain is
        the oracle.  The batch is regrouped per task; a task whose records
        are all local regression updates rides ONE `fold_stacked` call on
        this predictor's device (the `nig_fold` kernel on a card), with
        grouped ring-buffer appends and a single shared change-feed
        publication for the whole fold group, while records that touch
        order-sensitive side state — remote completions feeding node-factor
        recalibration, median-fallback/promotion tasks, unknown tasks —
        replay through the exact per-record path in original arrival
        order.  The fold is safe to reorder against them because a
        fold-eligible task's NIG state is, by construction, neither read
        nor written by any other record in the batch.

        Write-ahead order is preserved: `observe_log_many` (or the scalar
        `observe_log` per record) runs under the lock BEFORE any state
        moves, so the group commit is durable before it can mutate state.
        Returns the number of records that advanced the predictor version
        (exactly the version delta the scalar chain would produce).
        """
        comps = list(comps)
        if not comps:
            return 0
        with self._state_lock:
            self.ingest.lock_acquisitions += 1
            self.ingest.batches += 1
            self.ingest.records += len(comps)
            hook_many = getattr(self, "observe_log_many", None)
            if hook_many is not None:
                hook_many(comps)
            else:
                hook = getattr(self, "observe_log", None)
                if hook is not None:
                    for c in comps:
                        hook(c)
            return self._observe_many(comps)

    def _observe_many(self, comps: List[TaskCompletion]) -> int:
        local_name = getattr(self.base.local_bench, "name", "local")
        local_names = (None, "", "local", local_name)
        per_task: Dict[str, List[TaskCompletion]] = {}
        for c in comps:
            if c.task in self.tasks:
                per_task.setdefault(c.task, []).append(c)
        fold_tasks: List[str] = []
        scalar_tasks = set()
        for task, recs in per_task.items():
            if self.tasks[task].nig is not None \
                    and all(c.node in local_names for c in recs):
                fold_tasks.append(task)
            else:
                scalar_tasks.add(task)

        applied = 0
        if fold_tasks:
            new_nigs = compute.fold_stacked(
                [self.tasks[t].nig for t in fold_tasks],
                [[c.input_gb for c in per_task[t]] for t in fold_tasks],
                [[c.runtime_s for c in per_task[t]] for t in fold_tasks],
                device=self.device)
            self._change_seq += 1           # ONE publication for the fold
            seq = self._change_seq
            for task, nig in zip(fold_tasks, new_nigs):
                st = self.tasks[task]
                st.nig = nig
                for c in per_task[task]:    # grouped ring-buffer appends
                    self._buffer(st, c.input_gb, c.runtime_s)
                st.since_refresh += len(per_task[task])
                self._task_changes[task] = seq
                applied += len(per_task[task])
            self.version += applied         # same per-record bump as the
            self.ingest.folded += applied   # scalar chain
            self.ingest.fold_dispatches += 1

        if scalar_tasks:
            v0 = self.version
            for c in comps:                 # original arrival order: node
                if c.task in scalar_tasks:  # stats are order-sensitive
                    self._observe(c)
                    self.ingest.scalar += 1
            applied += self.version - v0
        return applied

    def _observe(self, comp: TaskCompletion) -> None:
        if comp.task not in self.tasks:
            return
        st = self.tasks[comp.task]
        local_name = getattr(self.base.local_bench, "name", "local")
        if comp.node in (None, "", "local", local_name):
            bench, is_remote = None, False
        else:
            bench = self._bench(comp.node)
            if bench is None:
                # unknown node: the runtime cannot be attributed to either
                # the task model or a node factor — drop, never treat a
                # remote runtime as a local observation
                return
            is_remote = bench.name != local_name

        # 1) per-node factor recalibration from the observed/predicted ratio
        #    against the *static* factor (so the correction converges to the
        #    true capability ratio rather than chasing its own tail)
        stats = None
        if is_remote:
            local_mean, _ = bayes.predict_blr_np(
                self.export_posterior(comp.task), comp.input_gb)
            static = max(float(local_mean), 1e-3) * self.base.factor(
                comp.task, bench)
            stats = self.node_stats.setdefault(bench.name, _NodeStats())
            stats.update(comp.task, comp.runtime_s / max(static, 1e-6))

        # 2) per-task posterior update in local-equivalent units.  Regression
        #    posteriors only ingest local observations (unbiased for the
        #    task model); median-fallback tasks also ingest mature-node
        #    remote observations, where the 10x scale error of predicting a
        #    merge task from downsampled profiles dwarfs any factor bias.
        if st.nig is not None:
            if is_remote:
                self.version += 1    # node correction moved, posterior not:
                return               # no dirty row, no store COW write
            st.nig = bayes.nig_update(st.nig, comp.input_gb, comp.runtime_s)
            self._buffer(st, comp.input_gb, comp.runtime_s)
            st.since_refresh += 1
        else:
            if is_remote and (stats is None or stats.n < NODE_MATURE_N):
                self.version += 1
                return
            f = self.factor(comp.task, bench)
            self._buffer(st, comp.input_gb, comp.runtime_s / max(f, 1e-6))
            self._update_median(st)
            self._maybe_promote(st)
        self._mark_changed(comp.task)   # posterior moved -> row resync due
        self.version += 1

    @staticmethod
    def _buffer(st: _TaskState, x: float, y: float) -> None:
        # ring (deque maxlen): keep the NEWEST window, which feeds median
        # updates, promotion checks and evidence refreshes
        st.xs.append(float(x))
        st.ys.append(float(y))

    def _update_median(self, st: _TaskState) -> None:
        if st.ys:
            y = np.asarray(st.ys, np.float64)
            st.median_s = float(np.median(y))
            # floor the spread at 5% of the median: a single (or perfectly
            # consistent) observation has MAD 0, and a ~0 spread would make
            # every interval degenerate
            mad = 1.4826 * float(np.median(np.abs(y - np.median(y))))
            st.spread_s = max(mad, 0.05 * abs(st.median_s), 1e-3)

    def _maybe_promote(self, st: _TaskState) -> None:
        """weak-correlation verdicts from tiny downsampled profiles can be
        wrong at production input scales: refit (on this predictor's
        device) + lift once the streamed observations show strong
        correlation."""
        if len(st.xs) < 4:
            return
        x = np.asarray(st.xs, np.float64)
        y = np.asarray(st.ys, np.float64)
        if np.std(x) < 1e-12 or np.std(y) < 1e-12:
            return
        r = float(np.corrcoef(x, y)[0, 1])
        if abs(r) >= self.threshold:
            st.nig = bayes.nig_from_blr(
                bayes.refresh_fit([], [], x, y, device=self.device))
            st.since_refresh = 0       # the promotion fit IS a fresh fit

    def prediction_std(self, task: str, input_gb: float) -> float:
        """local predictive std (the uncertainty band rescheduling uses)."""
        _, std = bayes.predict_blr_np(self.export_posterior(task), input_gb)
        return float(std)

    # ---- periodic evidence refresh ------------------------------------------
    def refresh_due(self, policy) -> List[str]:
        """Tasks whose streaming posterior is due for an evidence refresh
        under `policy` (any object with `min_points`, `every_n` and
        `drift_ratio`, as the reference's RefreshPolicy has): enough
        completions since the last refresh, or the streaming noise estimate
        b/a drifted beyond `drift_ratio` x the lift-time level.  Only
        regression tasks with at least one streamed observation qualify."""
        due = []
        for task, st in self.tasks.items():
            if st.nig is None or st.nig["n_obs"] <= 0:
                continue
            if len(st.fit_xs) + len(st.xs) < policy.min_points:
                continue
            if st.since_refresh >= policy.every_n:
                due.append(task)
                continue
            if policy.drift_ratio is not None and st.since_refresh > 0:
                s2_lift = float(st.nig.get("s2_lift", 0.0))
                if s2_lift > 0.0:
                    ratio = (st.nig["b"] / st.nig["a"]) / s2_lift
                    if not (1.0 / policy.drift_ratio < ratio
                            < policy.drift_ratio):
                        due.append(task)
        return due

    def refresh_snapshot(self, tasks) -> Dict[str, Tuple[int, np.ndarray,
                                                         np.ndarray]]:
        """-> task -> (change seq, x, y): the full evidence for a refresh
        fit — fit-time profiling points plus the streamed ring buffer.  The
        change seq lets `apply_refresh` reject a fit that raced with a
        concurrent observe() instead of silently clobbering it."""
        out = {}
        with self._state_lock:
            for t in tasks:
                st = self.tasks[t]
                out[t] = (self._task_changes.get(t, 0),
                          np.asarray(st.fit_xs + list(st.xs), np.float64),
                          np.asarray(st.fit_ys + list(st.ys), np.float64))
        return out

    def change_seq(self, task: str) -> int:
        """Current change-feed sequence of one task."""
        return self._task_changes.get(task, 0)

    def apply_refresh(self, task: str, post: Mapping, seq=None) -> bool:
        """Moment-match a refreshed BLR posterior back into the streaming
        NIG state.  Returns False — leaving the task due — when `seq` shows
        an observation landed after the snapshot was taken (checked and
        swapped under the state lock)."""
        with self._state_lock:
            st = self.tasks[task]
            if seq is not None and self._task_changes.get(task) != seq:
                return False
            st.nig = bayes.nig_from_blr(post)
            st.since_refresh = 0
            self._mark_changed(task)
            self.version += 1
            return True

    # ---- checkpoint ---------------------------------------------------------
    def export_state(self) -> dict:
        """JSON-serializable streaming state: NIG posteriors, median/MAD
        states with their observation buffers, per-node correction logs —
        the reference package's format.  Pure-python floats/lists only, so
        save -> load_state is bit-identical.  Taken under the state lock:
        a checkpoint must capture a consistent instant."""
        with self._state_lock:
            return self._export_state()

    def _export_state(self) -> dict:
        def _leaf(v):
            return v.tolist() if isinstance(v, np.ndarray) else float(v)
        tasks = {}
        for name, st in self.tasks.items():
            tasks[name] = {
                "nig": ({k: _leaf(v) for k, v in st.nig.items()}
                        if st.nig is not None else None),
                "median_s": float(st.median_s),
                "spread_s": float(st.spread_s),
                "xs": [float(v) for v in st.xs],
                "ys": [float(v) for v in st.ys],
                "fit_xs": [float(v) for v in st.fit_xs],
                "fit_ys": [float(v) for v in st.fit_ys],
                "since_refresh": int(st.since_refresh)}
        nodes = {name: {t: [float(v) for v in logs]
                        for t, logs in s.logs_by_task.items()}
                 for name, s in self.node_stats.items()}
        return {"version": int(self.version), "threshold": float(self.threshold),
                "tasks": tasks, "nodes": nodes}

    def load_state(self, state: dict) -> None:
        """Inverse of export_state: overwrite ALL streaming state so a
        restarted predictor resumes exactly where the checkpoint left off
        (the fitted base model is reconstructed by the caller, e.g. through
        `repro_torch.convert`; everything learned since fit time comes from
        here)."""
        with self._state_lock:
            self._load_state(state)

    def _load_state(self, state: dict) -> None:
        self.version = int(state["version"])
        self.threshold = float(state["threshold"])
        self.tasks = {}
        for name, ts in state["tasks"].items():
            nig = ts["nig"]
            if nig is not None:
                nig = {k: (np.asarray(v, np.float64) if isinstance(v, list)
                           else float(v)) for k, v in nig.items()}
            self.tasks[name] = _TaskState(
                nig=nig, median_s=float(ts["median_s"]),
                spread_s=float(ts["spread_s"]),
                xs=deque((float(v) for v in ts["xs"]), maxlen=MAX_BUFFER),
                ys=deque((float(v) for v in ts["ys"]), maxlen=MAX_BUFFER),
                fit_xs=[float(v) for v in ts.get("fit_xs", [])],
                fit_ys=[float(v) for v in ts.get("fit_ys", [])],
                since_refresh=int(ts.get("since_refresh", 0)))
        self.node_stats = {}
        for node, by_task in state["nodes"].items():
            s = _NodeStats()
            s.logs_by_task = {t: [float(v) for v in logs]
                              for t, logs in by_task.items()}
            self.node_stats[node] = s
        self._change_seq += 1        # every row is due for resync, on every
        self._task_changes = {t: self._change_seq for t in self.tasks}
        # binding's cursor (version may equal what a binding already synced)
