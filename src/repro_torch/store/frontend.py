"""Async batch-window front-end over the shared PosteriorStore.

Concurrent schedulers each issue small bursts of (task, node, input)
queries; dispatching each burst separately wastes the batched predictive
kernel (a launch costs about the same for 8 rows as for 2048).  The
front-end parks callers' queries for one batch window and answers
everything queued — across tenants and workflows — with ONE gather and
ONE `bayes_predict` launch, then resolves per-caller futures with exactly
the array `PredictionService.predict_batch` would have returned (same
compute path, so coalescing is invisible to callers).

A flush syncs each queued namespace once, resolves every caller's keys on
one snapshot (an unknown task fails only its own caller), and then makes
one pass through `store.compute.predict_stacked`: the store's gather
writes the rows straight into the predictive's packed slab (pinned on a
card), the slab goes up in one copy, one `bayes_predict` launch runs, the
means and stds come back in one copy, and each caller's slice is finalized
with its binding's factors.  `dispatch_count` counts those launches.

Two modes:
  * auto-flush (default): a daemon worker wakes on the first enqueue,
    sleeps `window_s` to let concurrent callers pile in, and flushes.
  * manual (`auto_flush=False`): nothing runs until `flush()` — the
    deterministic mode tests and benchmarks use to assert dispatch counts.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.store.compute import finalize, predict_stacked
from repro_torch.store.keys import (DEFAULT_TENANT, DEFAULT_WORKFLOW,
                                    namespace_str)
from repro_torch.store.posterior import PosteriorStore, TenantBinding


def _safe_set(fut: Future, result=None, exc: Optional[BaseException] = None
              ) -> None:
    """Resolve a caller future, tolerating callers that cancelled it while
    it was parked in the window (a cancelled future must not poison the
    dispatch for everyone else)."""
    if not fut.set_running_or_notify_cancel():
        return                       # caller cancelled; nothing to deliver
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


class QueueFullError(RuntimeError):
    """Raised by predict_async when `max_pending_batches` caller batches
    are already parked: the window is not draining fast enough, and
    failing fast beats queueing unboundedly (the caller sheds load or
    retries after a flush)."""


class AsyncPredictionFrontend:
    def __init__(self, store: PosteriorStore, z: float = 1.96,
                 device=DEFAULT_DEVICE, window_s: float = 0.002,
                 auto_flush: bool = True,
                 max_pending_batches: Optional[int] = None,
                 refresher=None, refresh_interval_s: float = 1.0):
        """`device` runs the predictive: "cuda" (the default) launches the
        `bayes_predict` kernel, "cpu" its plain version; a card asked for
        where there is none raises.  `refresher` (an
        `online.maintenance.FleetRefresher`) attaches the posterior
        maintenance plane: the front-end owns its lifecycle —
        `refresher.start(refresh_interval_s)` here, `refresher.stop()` in
        close().  The refresh loop runs on the refresher's own thread, out
        of band of the batch window, so an evidence refresh never delays
        an in-flight predict batch."""
        if max_pending_batches is not None and max_pending_batches < 1:
            raise ValueError("max_pending_batches must be >= 1")
        self.store = store
        self.z = z
        self.device = resolve_device(device)
        self.window_s = window_s
        self.max_pending_batches = max_pending_batches
        self.dispatch_count = 0          # predictive launches issued
        self.coalesced: List[int] = []   # callers coalesced per dispatch
                                         # (bounded: recent dispatches only)
        self._pending: List[Tuple[TenantBinding, list, Future]] = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self._refresher = refresher
        if refresher is not None:        # before the worker spawns: a
            refresher.start(refresh_interval_s)   # failing start() must not
        if auto_flush:                   # leak an unstoppable worker thread
            self._worker = threading.Thread(target=self._loop, daemon=True,
                                            name="posterior-frontend")
            self._worker.start()

    # ---- caller API ---------------------------------------------------------
    def predict_async(self, queries: Sequence,
                      tenant: str = DEFAULT_TENANT,
                      workflow: str = DEFAULT_WORKFLOW) -> Future:
        """Queue queries for the next coalesced dispatch -> Future resolving
        to the (Q, 3) [mean, lower, upper] array."""
        binding = self.store.binding(tenant, workflow)
        if binding is None:
            raise KeyError(f"namespace {namespace_str(tenant, workflow)!r} "
                           f"is not bound; known: {self.store.namespaces()}")
        fut: Future = Future()
        queries = list(queries)
        if not queries:
            fut.set_result(np.zeros((0, 3), np.float32))
            return fut
        with self._cv:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if (self.max_pending_batches is not None
                    and len(self._pending) >= self.max_pending_batches):
                raise QueueFullError(
                    f"{len(self._pending)} caller batches already queued "
                    f"(max_pending_batches={self.max_pending_batches}); "
                    f"retry after the next flush")
            self._pending.append((binding, queries, fut))
            self._cv.notify()
        return fut

    def predict(self, queries: Sequence, tenant: str = DEFAULT_TENANT,
                workflow: str = DEFAULT_WORKFLOW,
                timeout: Optional[float] = 30.0) -> np.ndarray:
        """Blocking convenience wrapper (self-flushing in manual mode)."""
        fut = self.predict_async(queries, tenant, workflow)
        if self._worker is None:
            self.flush()
        return fut.result(timeout=timeout)

    # ---- dispatch -----------------------------------------------------------
    def flush(self) -> int:
        """Serve everything queued in one dispatch.  Returns the number of
        caller batches answered.  Failures are isolated per caller: a bad
        task name (or a namespace whose sync fails) rejects only the
        offending callers' futures — the shared dispatch still answers
        everyone else."""
        with self._cv:
            batch, self._pending = self._pending, []
        if not batch:
            return 0
        # sync each distinct namespace once; a failing sync fails only the
        # callers of that namespace
        sync_err: dict = {}
        for binding in {id(b): b for b, _, _ in batch}.values():
            try:
                binding.sync()
                sync_err[id(binding)] = None
            except Exception as e:                # noqa: BLE001
                sync_err[id(binding)] = e
        snap = self.store.snapshot()
        valid = []
        for binding, qs, fut in batch:
            err = sync_err[id(binding)]
            if err is None:
                try:                 # resolve this caller's keys before
                    keys = [binding.key_str(q.task) for q in qs]
                    for k in keys:   # anything is packed: an unknown task
                        snap.row_of(k)   # rejects only this caller
                except Exception as e:            # noqa: BLE001
                    err = e
            if err is not None:
                _safe_set(fut, exc=err)
                continue
            valid.append((binding, qs, keys, fut))
        if not valid:
            return len(batch)
        try:
            x = np.asarray([q.input_gb for _, qs, _, _ in valid for q in qs])
            keys = [k for _, _, ks, _ in valid for k in ks]
            mean, std = predict_stacked(x, lambda out: snap.gather(keys, out),
                                        device=self.device)
            self.dispatch_count += 1
            if len(self.coalesced) >= 4096:   # telemetry, not a log: a
                del self.coalesced[:2048]     # long-lived frontend must
            self.coalesced.append(len(valid))  # not grow without bound
        except Exception as e:                    # noqa: BLE001
            for _, _, _, fut in valid:
                _safe_set(fut, exc=e)
            return len(batch)
        i = 0
        for binding, qs, _, fut in valid:
            j = i + len(qs)
            try:
                out = finalize(mean[i:j], std[i:j], binding.factors(qs),
                               self.z)
            except Exception as e:                # noqa: BLE001
                _safe_set(fut, exc=e)
            else:
                _safe_set(fut, result=out)
            i = j
        return len(batch)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            time.sleep(self.window_s)    # the batch window: let concurrent
            try:                         # callers pile into this dispatch
                self.flush()
            except Exception:            # noqa: BLE001  (a flush bug fails
                pass                     # its futures; never the worker)

    # ---- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if self._refresher is not None:
            self._refresher.stop()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.flush()                     # drain anything the worker missed

    def __enter__(self) -> "AsyncPredictionFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
