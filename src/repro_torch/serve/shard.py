"""One serving shard: a store slice behind an RPC socket.

A shard process owns every namespace the shard map places on its id —
the `PosteriorStore` rows, the bound `OnlinePredictor`s, its own
`AsyncPredictionFrontend` (batch-window coalescing) and optionally its
own `FleetRefresher` (maintenance plane) — and serves them over the
length-prefixed wire protocol:

  predict         one namespace's query batch -> (Q, 3) array
  predict_multi   several namespaces' batches in one frame (the client
                  coalesces per shard)
  predict_matrix  the decision plane's (T, N) row-gather primitive
  observe         fold a completion in; the ack carries the oplog seq
  refresh / checkpoint / digest / health / pull_blocks / update_map
  fence / unfence / export_namespaces / install_namespaces /
  release_namespaces — the live-resharding handshake driven by
  `rebalance.RebalanceCoordinator` (fence writes, drain ingest, ship
  rows+states, verify digest parity, publish the new map, release)

Ownership is enforced per request: a namespace the shard's own map does
not place here answers `wrong_shard` carrying that map, so clients with
a stale map self-correct (placement.ShardMap version protocol).

Durability: observes are write-ahead logged (`failover.OpLog`) through
the predictor's `observe_log` hook — logged under the predictor's state
lock BEFORE the update applies, acknowledged after.  Checkpoints embed
the applied-oplog watermark via `ShardMeta`, a sentinel pseudo-predictor
bound at `__shard__/__meta__` whose exported state rides inside the
store manifest — the watermark commits atomically with the posterior
blocks it describes (no sidecar file, no torn-meta crash window).
`boot_shard` is the recovery path: restore checkpoint, replay the oplog
tail past the watermark, install hooks, then open the socket.

Devices: the shard's frontend (`bayes_predict` a flush), its refresher
(`bayes_fit`), `predict_matrix` (one gather straight into the predictive's
packed slab, one `bayes_predict` launch) and the predictors' ingest fold
(`nig_fold`, on the predictors' own device) run on `device`, "cuda" by
default; "cpu" runs their plain versions.  The CLI flag is `--device`.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import hashlib
import importlib
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.online.events import TaskCompletion
from repro_torch.online.maintenance import FleetRefresher, RefreshPolicy
from repro_torch.online.predictor import IngestStats
from repro_torch.serve.failover import OpLog
from repro_torch.serve.placement import ShardMap
from repro_torch.serve.wire import WireError, read_frame, write_frame
from repro_torch.store.compute import predict_stacked, scale
from repro_torch.store.frontend import AsyncPredictionFrontend, QueueFullError
from repro_torch.store.keys import namespace_str
from repro_torch.store.posterior import MANIFEST_NAME, PosteriorStore

META_TENANT, META_WORKFLOW = "__shard__", "__meta__"

# type of a bootstrap function: (shard_id, shard_map) -> namespaces
Bootstrap = Callable[[str, ShardMap], Mapping[Tuple[str, str], tuple]]


class _Q:
    """Lightweight prediction query (what the frontend reads: .task,
    .node, .input_gb) decoded from a wire triple."""
    __slots__ = ("task", "node", "input_gb")

    def __init__(self, task: str, node: Optional[str], input_gb: float):
        self.task, self.node, self.input_gb = task, node, input_gb


class RpcError(Exception):
    """Raised by op handlers; `payload` goes on the wire verbatim."""

    def __init__(self, kind: str, msg: str, **extra):
        super().__init__(msg)
        self.payload = {"k": kind, "m": msg, **extra}


class ShardMeta:
    """Sentinel pseudo-predictor carrying the shard's oplog watermark
    inside store checkpoints: `save()` exports it with every manifest,
    `resume()` loads it back — the recovery code reads exactly the
    watermark the restored blocks were written with."""

    def __init__(self) -> None:
        self.applied_seq = 0

    def task_names(self) -> list:
        return []                    # no posterior rows: sync is a no-op

    def export_state(self) -> dict:
        return {"applied_seq": int(self.applied_seq)}

    def load_state(self, state: Mapping) -> None:
        self.applied_seq = int(state.get("applied_seq", 0))


def state_digest(predictor) -> str:
    """sha256 over the canonical JSON of a predictor's exported streaming
    state.  JSON float repr round-trips float64 exactly, so two
    predictors digest equal iff their posteriors are bit-identical —
    the failover acceptance check."""
    state = predictor.export_state()
    blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class ShardServer:
    def __init__(self, shard_id: str, shard_map: ShardMap, *,
                 store: Optional[PosteriorStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 oplog: Optional[OpLog] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval_s: Optional[float] = None,
                 window_s: float = 0.002,
                 max_pending_batches: Optional[int] = 64,
                 ingest_window_s: float = 0.002,
                 max_pending_ingest: Optional[int] = 4096,
                 refresh_policy: Optional[RefreshPolicy] = None,
                 refresh_interval_s: Optional[float] = None,
                 bootstrap: Optional[Bootstrap] = None,
                 device=DEFAULT_DEVICE, z: float = 1.96):
        self.shard_id = shard_id
        self.map = shard_map
        self.bootstrap = bootstrap   # namespace spec factory: lets this
        self.host, self.port = host, port  # shard ADOPT migrated namespaces
        self.store = store if store is not None else PosteriorStore()
        self.oplog = oplog
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = checkpoint_interval_s
        self.device, self.z = resolve_device(device), z
        self.applied_seq = oplog.last_seq if oplog is not None else 0
        self.meta = ShardMeta()
        self.refresher = (FleetRefresher(self.store, refresh_policy,
                                         device=self.device)
                          if refresh_interval_s is not None else None)
        self.frontend = AsyncPredictionFrontend(
            self.store, z=z, device=self.device, window_s=window_s,
            max_pending_batches=max_pending_batches,
            refresher=self.refresher,
            refresh_interval_s=refresh_interval_s or 1.0)
        self.replayed = 0            # oplog records replayed at boot
        self.replay_s = 0.0          # and the seconds their replay took
        # ---- ingest micro-batching (the write-path batch window) ----
        # observe/observe_many records park here for `ingest_window_s`;
        # one drain folds everything pending — per namespace, one
        # observe_many (one state-lock acquisition + one oplog group
        # commit), then ONE sync_bindings publish (one COW generation)
        # for the whole cross-tenant batch.
        if max_pending_ingest is not None and max_pending_ingest < 1:
            raise ValueError("max_pending_ingest must be >= 1")
        self.ingest_window_s = ingest_window_s
        self.max_pending_ingest = max_pending_ingest
        self.ingest = IngestStats()  # shard-level drain/flush telemetry
        self.last_ingest_error: Optional[BaseException] = None
        # namespaces mid-migration: writes answer a retryable
        # nothing-applied `migrating` error until the handoff completes
        self.fenced: set = set()
        self._ingest_pending: List[tuple] = []
        self._ingest_task: Optional[asyncio.Task] = None
        self._batch_seqs: Optional[List[int]] = None  # set by hook_many
        self._server: Optional[asyncio.base_events.Server] = None
        self._checkpoint_task: Optional[asyncio.Task] = None
        self._closing = asyncio.Event()

    # ---- namespace wiring ---------------------------------------------------
    def owns(self, tenant: str, workflow: str) -> bool:
        return self.map.shard_for(namespace_str(tenant, workflow)) \
            == self.shard_id

    def attach(self, tenant: str, workflow: str, predictor,
               benches: Optional[Mapping] = None) -> None:
        """resume + oplog hook: the order matters — recovery replays the
        log tail BEFORE hooks exist, so replayed observes are applied but
        never re-appended."""
        self.store.resume(tenant, workflow, predictor, benches)
        self.install_oplog_hook(tenant, workflow, predictor)

    def install_oplog_hook(self, tenant: str, workflow: str,
                           predictor) -> None:
        if self.oplog is None or not hasattr(predictor, "observe"):
            return

        def hook(comp: TaskCompletion, _t=tenant, _w=workflow) -> None:
            # runs under the predictor's state lock, before _observe:
            # write-ahead order (see OnlinePredictor.observe)
            self.applied_seq = self.oplog.append(
                {"t": _t, "w": _w, "c": dataclasses.asdict(comp)})

        def hook_many(comps, _t=tenant, _w=workflow) -> None:
            # group commit: one frame + one flush for the whole batch,
            # still write-ahead (observe_many calls this under the state
            # lock before any state moves).  Per-record seqs are parked
            # for the ingest drain to hand back as acks.
            seqs = self.oplog.append_many(
                [{"t": _t, "w": _w, "c": dataclasses.asdict(c)}
                 for c in comps])
            self.applied_seq = seqs[-1]
            self._batch_seqs = seqs

        predictor.observe_log = hook
        predictor.observe_log_many = hook_many

    # ---- checkpointing ------------------------------------------------------
    def checkpoint(self) -> dict:
        """Durable snapshot: capture the applied watermark into the meta
        sentinel, then save.  Runs on the event-loop thread, so no observe
        interleaves between capture and save — the watermark is exact."""
        if self.checkpoint_dir is None:
            raise RpcError("no_checkpoint", "shard has no checkpoint dir")
        seq = self.applied_seq
        self.meta.applied_seq = seq
        incremental = os.path.exists(
            os.path.join(self.checkpoint_dir, MANIFEST_NAME))
        try:
            self.store.save(self.checkpoint_dir, incremental=incremental,
                            keep_last=2)
        except ValueError:           # divergent lineage: full save re-owns it
            self.store.save(self.checkpoint_dir, keep_last=2)
        return {"seq": seq, "generation": self.store.generation}

    async def _checkpoint_loop(self) -> None:
        while not self._closing.is_set():
            try:
                await asyncio.wait_for(self._closing.wait(),
                                       self.checkpoint_interval_s)
            except asyncio.TimeoutError:
                try:
                    self.checkpoint()
                except Exception:    # noqa: BLE001 — a failed periodic save
                    pass             # must not kill serving; next tick retries

    # ---- RPC dispatch -------------------------------------------------------
    def _require_owner(self, tenant: str, workflow: str) -> None:
        ns = namespace_str(tenant, workflow)
        owner = self.map.shard_for(ns)
        if owner != self.shard_id:
            raise RpcError("wrong_shard",
                           f"namespace {ns!r} belongs to shard {owner!r}",
                           map=self.map.to_wire())

    def _require_writable(self, tenant: str, workflow: str) -> None:
        """Ownership + fence check for the write path.  Runs BEFORE any
        record parks, so — like `wrong_shard` and `queue_full` — a
        `migrating` reply promises NOTHING of the request was applied:
        the client may retry the whole batch, and after it heals to the
        post-rebalance map the retry lands on the new owner."""
        self._require_owner(tenant, workflow)
        ns = namespace_str(tenant, workflow)
        if ns in self.fenced:
            raise RpcError("migrating",
                           f"namespace {ns!r} is mid-migration off shard "
                           f"{self.shard_id!r}; retry (nothing was applied)")

    def _binding(self, tenant: str, workflow: str):
        b = self.store.binding(tenant, workflow)
        if b is None:
            raise RpcError("unknown_namespace",
                           f"{namespace_str(tenant, workflow)!r} is not "
                           f"bound on shard {self.shard_id!r}")
        return b

    def _queries(self, triples) -> List[_Q]:
        return [_Q(t, n, float(gb)) for t, n, gb in triples]

    async def _op_predict(self, req) -> dict:
        t, w = req["t"], req["w"]
        self._require_owner(t, w)
        try:
            fut = self.frontend.predict_async(self._queries(req["x"]), t, w)
        except QueueFullError as e:
            raise RpcError("queue_full", str(e)) from e
        return {"p": await asyncio.wrap_future(fut)}

    async def _op_predict_multi(self, req) -> dict:
        futs = []
        for b in req["b"]:
            t, w = b["t"], b["w"]
            self._require_owner(t, w)
            try:
                futs.append(self.frontend.predict_async(
                    self._queries(b["x"]), t, w))
            except QueueFullError as e:
                raise RpcError("queue_full", str(e)) from e
        return {"p": list(await asyncio.gather(
            *[asyncio.wrap_future(f) for f in futs]))}

    async def _op_predict_matrix(self, req) -> dict:
        t, w = req["t"], req["w"]
        self._require_owner(t, w)
        tasks = [(name, float(gb)) for name, gb in req["tasks"]]
        nodes = list(req["nodes"])
        if not tasks or not nodes:
            shape = (len(tasks), len(nodes))
            return {"mean": np.zeros(shape), "std": np.zeros(shape)}
        binding = self._binding(t, w)
        binding.sync()
        snap = self.store.snapshot()
        keys = [binding.key_str(name) for name, _ in tasks]
        x = np.asarray([gb for _, gb in tasks])
        # the store's gather writes the rows straight into the packed slab
        # (one copy up, one bayes_predict launch), as
        # PredictionService.predict_matrix does: the same bits
        mean, std = predict_stacked(x, lambda out: snap.gather(keys, out),
                                    device=self.device)
        f = binding.factor_matrix([name for name, _ in tasks], nodes)
        mean, std = scale(mean[:, None], std[:, None], f)
        return {"mean": mean, "std": std}

    # ---- ingest (write path) ------------------------------------------------
    def _enqueue_observes(self, records) -> List[asyncio.Future]:
        """Park validated (tenant, workflow, comp) records in the ingest
        window.  Capacity is checked before anything parks, so a
        `queue_full` reply means NO record of the request was accepted —
        the client can safely retry the whole batch."""
        if self.max_pending_ingest is not None \
                and len(self._ingest_pending) + len(records) \
                > self.max_pending_ingest:
            raise RpcError(
                "queue_full",
                f"{len(self._ingest_pending)} observations already parked "
                f"(max_pending_ingest={self.max_pending_ingest}); retry "
                f"after the next ingest drain")
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in records]
        self._ingest_pending.extend(
            (t, w, c, f) for (t, w, c), f in zip(records, futs))
        if self._ingest_task is None or self._ingest_task.done():
            self._ingest_task = asyncio.ensure_future(self._ingest_drain())
        return futs

    def _take_batch_seqs(self, n: int) -> List[int]:
        """Per-record ack seqs of the group commit the last observe_many
        issued (or the current watermark when the shard runs without an
        oplog — matching the scalar observe ack)."""
        seqs, self._batch_seqs = self._batch_seqs, None
        if seqs is None:
            return [self.applied_seq] * n
        return seqs

    async def _ingest_drain(self) -> None:
        await asyncio.sleep(self.ingest_window_s)
        pending, self._ingest_pending = self._ingest_pending, []
        if not pending:
            return
        self.ingest.batches += 1
        self.ingest.records += len(pending)
        groups: Dict[Tuple[str, str], list] = {}
        for t, w, comp, fut in pending:       # group per namespace, keep
            groups.setdefault((t, w), []).append((comp, fut))   # arrival
        touched = []                                            # order
        for (t, w), recs in groups.items():
            try:
                binding = self._binding(t, w)
                self._batch_seqs = None
                binding.predictor.observe_many([c for c, _ in recs])
                seqs = self._take_batch_seqs(len(recs))
                touched.append(binding)
            except BaseException as e:        # noqa: BLE001 — one bad
                for _, fut in recs:           # namespace fails only its
                    if not fut.done():        # own callers
                        fut.set_exception(e)
                continue
            for (_, fut), seq in zip(recs, seqs):
                if not fut.done():
                    fut.set_result(seq)
        if touched:
            # ONE COW generation for the whole cross-tenant drain; a
            # failed publish leaves the rows due (cursors unmoved) for
            # the next sync — acks stand, durability already committed.
            # The failure is kept on last_ingest_error (surfaced by the
            # health RPC) until a later publish succeeds and clears it.
            try:
                gen0 = self.store.generation
                self.store.sync_bindings(touched)
                self.ingest.generations_published += \
                    self.store.generation - gen0
                self.last_ingest_error = None
            except Exception as e:            # noqa: BLE001
                self.last_ingest_error = e

    async def _op_observe(self, req) -> dict:
        t, w = req["t"], req["w"]
        self._require_writable(t, w)
        self._binding(t, w)                   # fail fast before parking
        comp = TaskCompletion(**req["c"])
        fut = self._enqueue_observes([(t, w, comp)])[0]
        return {"seq": await fut}

    async def _op_observe_many(self, req) -> dict:
        records = []
        for b in req["b"]:                    # validate the WHOLE batch
            t, w = b["t"], b["w"]             # before anything parks: a
            self._require_writable(t, w)      # wrong_shard (or migrating)
            self._binding(t, w)               # promises nothing applied
            records.append((t, w, TaskCompletion(**b["c"])))
        futs = self._enqueue_observes(records)
        return {"seqs": list(await asyncio.gather(*futs))}

    async def _op_refresh(self, req) -> dict:
        refresher = self.refresher or FleetRefresher(self.store,
                                                     device=self.device)
        report = refresher.maybe_refresh()
        return {"refreshed": 0 if report is None else report.n_tasks,
                "generation": self.store.generation}

    async def _op_checkpoint(self, req) -> dict:
        return self.checkpoint()

    async def _op_digest(self, req) -> dict:
        binding = self._binding(req["t"], req["w"])
        return {"sha256": state_digest(binding.predictor)}

    def ingest_stats(self) -> IngestStats:
        """Shard-level ingest telemetry: drain/generation counters merged
        with every bound predictor's fold counters, plus the oplog's
        group-commit flush count."""
        agg = IngestStats()
        agg.merge(self.ingest)
        for b in self.store.bindings():
            ps = getattr(b.predictor, "ingest", None)
            if isinstance(ps, IngestStats):
                agg.folded += ps.folded
                agg.fold_dispatches += ps.fold_dispatches
                agg.scalar += ps.scalar
                agg.lock_acquisitions += ps.lock_acquisitions
        if self.oplog is not None:
            agg.flushes = self.oplog.flush_count
        return agg

    async def _op_health(self, req) -> dict:
        return {"shard_id": self.shard_id, "v": self.map.version,
                "generation": self.store.generation,
                "seq": self.applied_seq, "pid": os.getpid(),
                "ingest": self.ingest_stats().as_dict(),
                # observations parked in the ingest window right now —
                # the supervisor's backlog signal (a shard whose drain
                # task died shows this growing without bound)
                "pending_ingest": len(self._ingest_pending),
                "fenced": sorted(self.fenced),
                # non-None iff the LATEST binding-sync publish failed
                # (rows are due but replicas/readers see a stale store)
                "last_ingest_error": (
                    None if self.last_ingest_error is None
                    else repr(self.last_ingest_error)),
                "namespaces": [ns for ns in self.store.namespaces()
                               if not ns.startswith(META_TENANT)]}

    async def _op_pull_blocks(self, req) -> dict:
        return {"s": self.store.export_blocks(
            since_generation=int(req.get("since", -1)))}

    async def _op_update_map(self, req) -> dict:
        m = ShardMap.from_wire(req["map"])
        if m.version > self.map.version:
            self.map = m
        return {"v": self.map.version}

    # ---- live resharding (rebalance.RebalanceCoordinator drives these) ------
    async def _op_fence(self, req) -> dict:
        """Fence namespaces for migration: new writes for them answer
        `migrating` (nothing-applied, retryable) from this point on, then
        the in-flight ingest window is DRAINED — every observation that
        was parked (and therefore could already have been, or will be,
        acked) is folded and oplogged before this op returns.  Predicts
        keep serving: reads off the source stay correct until the new map
        is published, because no client can reach the target before then.
        Returns the post-drain oplog watermark — the migration fence."""
        self.fenced.update(req["ns"])
        # every record parked so far (fenced namespaces included) belongs
        # to the live drain task: parked-nonempty implies a live drain,
        # and the drain body runs without awaits once its window sleep
        # ends, so ONE await covers it all.  Records parked during this
        # await can only be un-fenced namespaces (the fence check runs
        # before parking) — no loop, no livelock under sustained load.
        task = self._ingest_task
        if task is not None and not task.done():
            try:
                await task
            except Exception:        # noqa: BLE001 — per-record futures
                pass                 # already carry any fold error
        return {"seq": self.applied_seq,
                "generation": self.store.generation}

    async def _op_unfence(self, req) -> dict:
        """Abort path: lift the fence so writes flow to this shard again
        (the coordinator calls this when verification fails before the
        new map was published — no client ever saw the target)."""
        self.fenced.difference_update(req["ns"])
        return {"fenced": sorted(self.fenced)}

    async def _op_export_namespaces(self, req) -> dict:
        """Migration payload for fenced namespaces + their pre-handoff
        digests.  Runs after `fence` drained the ingest window, so the
        digests cover every acked observation; `install_namespaces` on
        the target must reproduce them bit-for-bit."""
        namespaces = list(req["ns"])
        payload = self.store.export_namespaces(namespaces)
        digests = {}
        for ns in namespaces:
            t, _, w = ns.partition("/")
            b = self._binding(t, w)
            digests[ns] = state_digest(b.predictor)
        return {"s": payload, "digests": digests, "seq": self.applied_seq}

    async def _op_install_namespaces(self, req) -> dict:
        """Adopt migrated namespaces: merge the shipped rows/states, build
        fresh predictors from this shard's bootstrap, resume them off the
        staged states (bit-identical re-attach), hook them into the oplog,
        and adopt the post-rebalance map so `_require_owner` accepts the
        rerouted traffic.  Digests are computed HERE, synchronously — no
        await between install and digest, so no write can interleave and
        the parity check proves the handoff, not a later state."""
        if self.bootstrap is None:
            raise RpcError("no_bootstrap",
                           f"shard {self.shard_id!r} has no bootstrap and "
                           f"cannot construct predictors for migrated "
                           f"namespaces")
        payload = req["s"]
        new_map = ShardMap.from_wire(req["map"])
        wanted = set((payload.get("namespaces") or {}))
        specs = {namespace_str(t, w): (t, w, spec) for (t, w), spec
                 in self.bootstrap(self.shard_id, new_map).items()
                 if namespace_str(t, w) in wanted}
        missing = sorted(wanted - set(specs))
        if missing:
            raise RpcError("no_bootstrap",
                           f"bootstrap on shard {self.shard_id!r} has no "
                           f"spec for migrated namespaces {missing}")
        self.store.import_namespaces(payload)
        digests = {}
        for ns, (t, w, spec) in specs.items():
            predictor, benches = (spec if isinstance(spec, tuple)
                                  else (spec, None))
            self.store.resume(t, w, predictor, benches)
            self.install_oplog_hook(t, w, predictor)
            digests[ns] = state_digest(predictor)
        if new_map.version > self.map.version:
            self.map = new_map
        return {"digests": digests, "v": self.map.version}

    async def _op_release_namespaces(self, req) -> dict:
        """Final migration step on the source: drop the namespaces the
        target now owns (rows, bindings, staged states) and lift their
        fence.  The coordinator calls this only AFTER the new map was
        published and digest parity verified."""
        released = 0
        for ns in req["ns"]:
            t, _, w = ns.partition("/")
            try:
                self.store.evict(t, w)
                released += 1
            except KeyError:
                pass                 # already gone (idempotent release)
            self.fenced.discard(ns)
        return {"released": released}

    async def _op_hello(self, req) -> dict:
        return {"shard_id": self.shard_id, "map": self.map.to_wire()}

    async def _op_shutdown(self, req) -> dict:
        asyncio.get_running_loop().call_soon(self._closing.set)
        return {"bye": True}

    async def _dispatch(self, req) -> dict:
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise RpcError("unknown_op", f"shard does not speak {op!r}")
        return await fn(req)

    async def _serve_one(self, req, writer: asyncio.StreamWriter) -> None:
        rid = req.get("i") if isinstance(req, dict) else None
        try:
            resp = {"i": rid, "ok": True, "r": await self._dispatch(req)}
        except RpcError as e:
            resp = {"i": rid, "ok": False, "e": e.payload}
        except Exception as e:       # noqa: BLE001 — a handler bug answers
            resp = {"i": rid, "ok": False,          # the caller, it does
                    "e": {"k": type(e).__name__,    # not kill the shard
                          "m": str(e)}}
        try:
            await write_frame(writer, resp)
        except (ConnectionError, RuntimeError):
            pass                     # peer went away mid-response

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await read_frame(reader)
                if req is None:
                    break
                # a task per request: a slow predict (window wait) must not
                # head-of-line block pipelined requests on this connection;
                # responses carry ids, ordering is the client's job
                asyncio.ensure_future(self._serve_one(req, writer))
        except WireError:
            pass                     # torn client frame: drop the connection
        finally:
            writer.close()

    # ---- lifecycle ----------------------------------------------------------
    async def start(self) -> "ShardServer":
        self._server = await asyncio.start_server(self._on_conn, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.checkpoint_interval_s is not None \
                and self.checkpoint_dir is not None:
            self._checkpoint_task = asyncio.ensure_future(
                self._checkpoint_loop())
        return self

    async def serve_until_closed(self) -> None:
        await self._closing.wait()
        await self.aclose()

    async def aclose(self) -> None:
        self._closing.set()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._ingest_task is not None and not self._ingest_task.done():
            try:                     # drain parked observes before the
                await self._ingest_task      # oplog closes under them
            except Exception:        # noqa: BLE001
                pass
        if self._checkpoint_task is not None:
            self._checkpoint_task.cancel()
        self.frontend.close()
        if self.oplog is not None:
            self.oplog.close()


# ---- recovery boot path ------------------------------------------------------
def boot_shard(shard_id: str, shard_map: ShardMap, bootstrap: Bootstrap,
               *, checkpoint_dir: Optional[str] = None,
               oplog_path: Optional[str] = None,
               **server_opts) -> ShardServer:
    """Build a ShardServer cold or warm.

    Warm (checkpoint exists): restore the store, resume every owned
    namespace (streaming states load bit-identically), read the oplog
    watermark from the embedded ShardMeta, replay the log tail past it
    — BEFORE oplog hooks exist, so replay never re-appends — then
    install hooks and hand back a server ready to open its socket.
    Cold: fresh store, bind the bootstrap namespaces, empty log."""
    if checkpoint_dir is not None and os.path.exists(
            os.path.join(checkpoint_dir, MANIFEST_NAME)):
        store = PosteriorStore.restore(checkpoint_dir)
    else:
        store = PosteriorStore()
    meta = ShardMeta()
    store.resume(META_TENANT, META_WORKFLOW, meta)

    namespaces = {
        (t, w): spec for (t, w), spec in bootstrap(shard_id, shard_map)
        .items()
        if shard_map.shard_for(namespace_str(t, w)) == shard_id}
    preds: Dict[Tuple[str, str], object] = {}
    for (t, w), spec in namespaces.items():
        predictor, benches = (spec if isinstance(spec, tuple)
                              else (spec, None))
        store.resume(t, w, predictor, benches)
        preds[(t, w)] = predictor

    replayed = 0
    t_replay = time.perf_counter()
    if oplog_path is not None:
        # replay rides the batched fold: records group per namespace in
        # log order (each predictor sees its own records in sequence, and
        # predictors share no state), so a long tail recovers in one
        # observe_many per namespace — bit-identical to per-record replay
        by_ns: Dict[Tuple[str, str], list] = {}
        for rec in OpLog.replay(oplog_path, after_seq=meta.applied_seq):
            by_ns.setdefault((rec["t"], rec["w"]), []).append(rec["c"])
            replayed += 1
        for (t, w), comps in by_ns.items():
            p = preds.get((t, w))
            if p is None:
                continue
            batch = [TaskCompletion(**c) for c in comps]
            if hasattr(p, "observe_many"):
                p.observe_many(batch)
            else:
                for comp in batch:
                    p.observe(comp)
    replay_s = time.perf_counter() - t_replay

    oplog = OpLog(oplog_path) if oplog_path is not None else None
    server = ShardServer(shard_id, shard_map, store=store, oplog=oplog,
                         checkpoint_dir=checkpoint_dir, bootstrap=bootstrap,
                         **server_opts)
    server.meta = meta
    server.applied_seq = oplog.last_seq if oplog is not None else 0
    for (t, w), p in preds.items():
        server.install_oplog_hook(t, w, p)
    server.replayed, server.replay_s = replayed, replay_s
    return server


def load_bootstrap(ref: str) -> Bootstrap:
    mod, _, fn = ref.partition(":")
    if not fn:
        raise ValueError(f"bootstrap must be 'module:function', got {ref!r}")
    return getattr(importlib.import_module(mod), fn)


async def _amain(args: argparse.Namespace) -> None:
    shard_map = ShardMap.from_wire(json.loads(args.map))
    t0 = time.perf_counter()
    server = boot_shard(
        args.shard_id, shard_map, load_bootstrap(args.bootstrap),
        checkpoint_dir=args.checkpoint, oplog_path=args.oplog,
        host=args.host, port=args.port,
        checkpoint_interval_s=args.checkpoint_interval,
        refresh_interval_s=args.refresh_interval,
        window_s=args.window_s, device=args.device)
    await server.start()
    boot_ms = round((time.perf_counter() - t0) * 1e3)
    # the reference's READY fields, then the boot's and the replay's
    # milliseconds (a supervisor reads the fields it knows)
    print(f"SHARD-READY port={server.port} pid={os.getpid()} "
          f"replayed={server.replayed} "
          f"replay_ms={round(server.replay_s * 1e3)} boot_ms={boot_ms}",
          flush=True)
    await server.serve_until_closed()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="posterior serving shard")
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--map", required=True, help="ShardMap.to_wire JSON")
    ap.add_argument("--bootstrap", required=True, help="module:function")
    ap.add_argument("--oplog", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-interval", type=float, default=None)
    ap.add_argument("--refresh-interval", type=float, default=None)
    ap.add_argument("--window-s", type=float, default=0.002)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    asyncio.run(_amain(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
