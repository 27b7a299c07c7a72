"""Posterior maintenance plane: fleet-wide periodic evidence refresh.

Streaming NIG updates (online.predictor) are exact conjugate updates given
the (alpha, beta) hyperparameters the MacKay evidence fixed point chose at
fit time.  After many online completions that lift no longer reflects the
data: the standardization is frozen at profile scale and the prior
precision was tuned for a few downsampled points, which degrades the
uncertainty the scheduler consumes.  The remedy (Hilman et al. 2018) is a
periodic re-fit from the accumulated observations.

  * `RefreshPolicy` decides when a task is due: every N posterior-moving
    completions, and/or when the streaming noise estimate b/a drifts
    beyond `drift_ratio` x the lift-time level, within per-tenant and
    per-task budgets;
  * `FleetRefresher` gathers the ragged observation buffers of every due
    task across every tenant bound to one `PosteriorStore`, re-runs the
    evidence fixed point for all of them in ONE `bayes_fit` launch
    (`store.compute.fit_stacked` on the refresher's device: the kernel on
    "cuda", its plain version on "cpu"), moment-matches the refreshed
    posteriors back into the streaming NIG states
    (`OnlinePredictor.apply_refresh`), and publishes every rewritten row
    in ONE `put_many`, hence one copy-on-write generation.  The resident
    plane (`sched.fused.FusedPlane`) picks the rewritten rows up through
    the store's dirty-block feed.

The refresh is out of band: the fit runs with no lock held (a fit that
races a concurrent observe() is rejected per task by its change seq, and
the task stays due), and readers keep serving from immutable snapshots
until the one-generation publish lands.  `start()` runs the loop on a
daemon thread.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.bayes_fit import pad_ragged
from repro_torch.store import compute
from repro_torch.store.posterior import PosteriorStore, TenantBinding


@dataclass
class RefreshPolicy:
    """When is a task's streaming posterior due for an evidence refresh?

    every_n: posterior-moving completions since the last refresh.
    drift_ratio: optional drift trigger — due as soon as the streaming
        noise estimate b/a leaves (s2_lift / drift_ratio,
        s2_lift * drift_ratio).
    min_points: never refit on fewer total (fit + streamed) points.

    Multi-tenant fairness budgets, enforced by `FleetRefresher.due()` so
    every entry point sees the same throttled view:

    max_tasks_per_tenant_per_cycle: at most this many of one tenant's due
        tasks enter one refresh pass; the rest stay due for a later pass
        (deferred, never dropped).
    min_interval_s: a task refreshed less than this many seconds ago is
        not due yet, however many completions landed.
    """
    every_n: int = 32
    drift_ratio: Optional[float] = None
    min_points: int = 4
    max_tasks_per_tenant_per_cycle: Optional[int] = None
    min_interval_s: Optional[float] = None


@dataclass
class RefreshReport:
    """What one `FleetRefresher.refresh()` pass did."""
    n_tasks: int = 0          # posteriors refreshed and published
    n_tenants: int = 0        # distinct tenants those rows belong to
    n_dispatches: int = 0     # batched fit launches issued (0 or 1)
    n_stale: int = 0          # fits rejected by a racing observe()
    generation: int = -1      # store generation after the publish
    duration_s: float = 0.0
    # host seconds of each step of the pass, in order: due, snapshot, pad,
    # fit (the launch and the copies back), apply, put_many, cursor
    split_s: Dict[str, float] = field(default_factory=dict)


class FleetRefresher:
    """Batched evidence refresh for every namespace bound to one store.

    One instance owns the refresh schedule of a whole (multi-tenant)
    `PosteriorStore`; `refresh()` is safe to call from any thread, and
    `start(interval_s)` runs `maybe_refresh()` on a daemon thread.  The fit
    runs on `device` ("cuda" by default; "cpu" runs its plain version).
    """

    def __init__(self, store: PosteriorStore,
                 policy: Optional[RefreshPolicy] = None,
                 device=DEFAULT_DEVICE):
        self.store = store
        self.policy = policy or RefreshPolicy()
        self.device = resolve_device(device)
        self.dispatch_count = 0          # lifetime batched-fit launches
        self.reports: List[RefreshReport] = []
        self.failure_count = 0           # background passes that raised
        self.last_error: Optional[BaseException] = None   # most recent one
        self._last_refresh: Dict[Tuple[int, str], float] = {}   # applied-at
        self._stop = threading.Event()                          # monotonic
        self._thread: Optional[threading.Thread] = None

    # ---- due detection ------------------------------------------------------
    def due(self) -> List[Tuple[TenantBinding, str]]:
        """(binding, task) pairs due under the policy, across all tenants.
        Predictors without the refresh protocol (plain LotaruPredictor) are
        skipped: their posteriors are not streaming.  Tasks refreshed
        within `min_interval_s` are not yet due, and each tenant
        contributes at most `max_tasks_per_tenant_per_cycle` tasks."""
        out = []
        pol = self.policy
        now = time.monotonic()
        per_tenant: Dict[str, int] = {}
        for b in self.store.bindings():
            fn = getattr(b.predictor, "refresh_due", None)
            if fn is None:
                continue
            for t in fn(pol):
                if pol.min_interval_s is not None:
                    last = self._last_refresh.get((id(b.predictor), t))
                    if last is not None and now - last < pol.min_interval_s:
                        continue
                if pol.max_tasks_per_tenant_per_cycle is not None:
                    n = per_tenant.get(b.tenant, 0)
                    if n >= pol.max_tasks_per_tenant_per_cycle:
                        continue
                    per_tenant[b.tenant] = n + 1
                out.append((b, t))
        return out

    # ---- the batched refresh pass -------------------------------------------
    def refresh(self, due: Optional[List[Tuple[TenantBinding, str]]] = None
                ) -> RefreshReport:
        """Refresh every due task in ONE batched fit launch and publish
        all rewritten rows in ONE store generation (see module
        docstring)."""
        marks = [("start", time.perf_counter())]

        def mark(step: str) -> None:
            marks.append((step, time.perf_counter()))

        if due is None:
            due = self.due()
        mark("due")
        # one fit row per distinct (predictor, task): two bindings may feed
        # the same predictor into two namespaces — fit once, publish to
        # both.  Buffers are snapshotted in ONE refresh_snapshot call per
        # predictor (one state-lock acquisition, one consistent instant).
        rows: Dict[Tuple[int, str], dict] = {}
        by_predictor: Dict[int, Tuple[object, List[str]]] = {}
        for b, task in due:
            p = b.predictor
            key = (id(p), task)
            if key not in rows:
                rows[key] = {"p": p, "task": task, "bindings": []}
                by_predictor.setdefault(id(p), (p, []))[1].append(task)
            if b not in rows[key]["bindings"]:
                rows[key]["bindings"].append(b)
        for p, tasks in by_predictor.values():
            for task, (seq, x, y) in p.refresh_snapshot(tasks).items():
                rows[(id(p), task)].update(seq=seq, x=x, y=y)
        mark("snapshot")
        if not rows:
            return self._record(RefreshReport(generation=self.store.generation),
                                marks)

        # ONE padded/masked evidence fixed-point launch for the fleet
        keys = list(rows)
        x, y, m = pad_ragged([rows[k]["x"] for k in keys],
                             [rows[k]["y"] for k in keys])
        mark("pad")
        post = compute.fit_stacked(x, y, m, device=self.device)
        self.dispatch_count += 1
        mark("fit")

        # moment-match back into the streaming states; a task whose change
        # seq moved while the fit ran keeps its (newer) state and stays due
        applied: List[dict] = []
        n_stale = 0
        for i, k in enumerate(keys):
            r = rows[k]
            row_post = {leaf: v[i] for leaf, v in post.items()}
            if r["p"].apply_refresh(r["task"], row_post, seq=r["seq"]):
                applied.append(r)
                self._last_refresh[k] = time.monotonic()   # min_interval_s
            else:                                          # rate-limit stamp
                n_stale += 1
        mark("apply")

        # publish: one put_many -> one COW generation across all tenants,
        # then advance each binding's cursor past the rows just written.
        # Binding locks are taken in namespace order (always before the
        # store lock inside put_many — the order sync() uses), so a
        # concurrent sync serializes instead of deadlocking.
        bindings = sorted({id(b): b for r in applied for b in r["bindings"]
                           }.values(), key=lambda b: b.namespace)
        tenants = set()
        n_rows = 0
        with contextlib.ExitStack() as stack:
            for b in bindings:
                stack.enter_context(b._sync_lock)
            items = []
            per_binding: Dict[int, Dict[str, int]] = {}
            for r in applied:
                # seq captured BEFORE the export: if an observe lands in
                # between, the exported row is fresher than the seq and the
                # cursor advance below refuses — the row just stays due
                seq = r["p"].change_seq(r["task"])
                for b in r["bindings"]:
                    if b._detached:      # evicted/displaced mid-refresh:
                        continue         # never write its rows back
                    items.append((b.key(r["task"]),
                                  r["p"].export_posterior(r["task"])))
                    per_binding.setdefault(id(b), {})[r["task"]] = seq
                    tenants.add(b.tenant)
            if items:
                self.store.put_many(items)
                n_rows = len({str(k) for k, _ in items})
            mark("put_many")
            for b in bindings:
                if not b._detached:
                    b._advance_cursor(per_binding.get(id(b), {}))
        mark("cursor")
        return self._record(RefreshReport(
            n_tasks=n_rows, n_tenants=len(tenants), n_dispatches=1,
            n_stale=n_stale, generation=self.store.generation), marks)

    def _record(self, report: RefreshReport, marks) -> RefreshReport:
        report.duration_s = marks[-1][1] - marks[0][1]
        report.split_s = {step: t - marks[i][1]
                          for i, (step, t) in enumerate(marks[1:])}
        if len(self.reports) >= 4096:    # telemetry, not a log: a daemon
            del self.reports[:2048]      # loop must not grow without bound
        self.reports.append(report)
        return report

    def maybe_refresh(self) -> Optional[RefreshReport]:
        """refresh() only if anything is due (the polling entry point: a
        no-op pass costs one due() sweep and no launch)."""
        due = self.due()
        return self.refresh(due) if due else None

    # ---- background loop ----------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "FleetRefresher":
        """Run maybe_refresh() every `interval_s` on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("refresher already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(interval_s,),
                                        daemon=True,
                                        name="posterior-refresher")
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.maybe_refresh()
            except Exception as e:       # noqa: BLE001  (a refresh bug must
                # not kill the maintenance loop, nor die silently: a plane
                # whose reports stop moving while these climb is failing,
                # not idle)
                self.failure_count += 1
                self.last_error = e

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "FleetRefresher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
