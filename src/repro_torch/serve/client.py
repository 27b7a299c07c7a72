"""Fan-out client for the sharded serving tier.

Routes every namespace (`tenant/workflow`) to its owning shard via the
consistent-hash `ShardMap`, keeps one multiplexed connection per shard
(requests carry ids; responses may arrive out of order), and coalesces
multi-namespace prediction rounds into ONE `predict_multi` frame per
shard (`predict_many`), so a planning round over 50 tenants costs
#shards RPCs, not 50.

Failure handling, per call:

  * transport errors / timeouts -> capped exponential backoff and retry
    within `RetryPolicy.max_attempts`; budget exhaustion raises the LAST
    underlying error, not a wrapper — the caller sees what actually went
    wrong;
  * `wrong_shard` -> adopt the shard's (newer) map and re-route: map
    version skew self-heals without a coordination service;
  * `queue_full` -> the shard's `AsyncPredictionFrontend` is shedding
    load; backoff-retry, then surface `QueueFullError` so the caller's
    own backpressure logic engages (the error type round-trips);
  * non-idempotent `observe`: NEVER resent once the frame hit the
    socket — an ack may have been lost, not the observation; only
    connect/pre-send failures retry.  Idempotent reads retry freely.

The write path mirrors the read path's coalescing: `observe_many`
groups completions by owning shard and sends ONE `observe_many` frame
per shard (all shards in flight concurrently), and an optional
`observe_window_s` turns scalar `observe` calls into parked futures a
background drain batches through `observe_many` — N workflow engines
reporting completions cost #shards RPCs per window, not N.  Retrying a
displaced `observe_many` group after `wrong_shard` is safe despite the
no-resend rule: the shard validates the WHOLE batch before parking
anything, so a `wrong_shard` (or `queue_full`) reply promises nothing
was applied.
"""
from __future__ import annotations

import asyncio
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.placement import ShardMap
from repro_torch.serve.wire import read_frame, write_frame
from repro_torch.store.frontend import QueueFullError
from repro_torch.store.keys import namespace_str


@dataclass
class RetryPolicy:
    max_attempts: int = 4
    base_backoff_s: float = 0.02
    max_backoff_s: float = 0.5
    timeout_s: float = 30.0          # per-RPC (connect and await reply)


class RemoteError(RuntimeError):
    """A shard answered with an application error (not transport)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(f"{kind}: {msg}")
        self.kind = kind


class WrongShardError(RemoteError):
    """Surfaced only when re-routing is the caller's job (fixed-shard
    calls); namespace-routed calls re-route internally."""

    def __init__(self, msg: str):
        super().__init__("wrong_shard", msg)


class MigratingError(RemoteError):
    """The namespace is fenced mid-rebalance on its (old) owner.  Like
    `wrong_shard`/`queue_full`, the shard rejects the request BEFORE
    anything parks, so nothing was applied and a retry is always safe —
    `_call` retries with backoff, and once the bumped map is published
    the retry lands on the new owner."""

    def __init__(self, msg: str):
        super().__init__("migrating", msg)


class ReplicaStaleError(RemoteError):
    """A replica refused a read because its generation lag exceeded its
    `max_generation_lag` bound; redirect the read to the primary."""

    def __init__(self, msg: str, lag: int, bound: int):
        super().__init__("stale_replica", msg)
        self.lag = lag
        self.bound = bound


class TransportError(ConnectionError):
    """Connection/timeout failure; `sent` says whether the request frame
    reached the socket (the idempotency line for observe)."""

    def __init__(self, msg: str, sent: bool):
        super().__init__(msg)
        self.sent = sent


class PartialObserveError(RuntimeError):
    """An `observe_many` round partially succeeded: some shard groups
    returned durable ack seqs while another group failed.  `seqs[i]` is
    record i's ack (None where it failed) and `errors[i]` the failing
    record's exception.  Raised instead of a blanket round failure so a
    caller never re-sends records that already landed — observes are not
    idempotent, and the acked ones are durably applied."""

    def __init__(self, seqs: List[Optional[int]],
                 errors: Dict[int, BaseException]):
        n_ok = sum(s is not None for s in seqs)
        first = next(iter(errors.values()))
        super().__init__(
            f"{len(errors)}/{len(seqs)} observes failed "
            f"({n_ok} durably acked): {first!r}")
        self.seqs = seqs
        self.errors = errors


async def call_direct(address: Tuple[str, int], op: str,
                      payload: Optional[dict] = None,
                      timeout: float = 30.0) -> dict:
    """One-shot RPC to an explicit address OUTSIDE the shard map: read
    replicas (never in the map) and decommissioned shards mid-rebalance
    (already removed from the map but still holding fenced namespaces).
    Opens, sends one frame, awaits the reply, closes — no pooling, no
    retry; callers that need retry semantics go through ServingClient."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(*address), timeout)
    try:
        await write_frame(writer, {"i": 0, "op": op, **(payload or {})})
        resp = await asyncio.wait_for(read_frame(reader), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    if resp is None:
        raise TransportError("peer closed before replying", sent=True)
    if resp.get("ok"):
        return resp["r"]
    err = resp.get("e") or {}
    kind = err.get("k", "error")
    if kind == "stale_replica":
        raise ReplicaStaleError(err.get("m", ""),
                                int(err.get("lag", -1)),
                                int(err.get("bound", -1)))
    raise RemoteError(kind, err.get("m", ""))


def _wire_queries(queries: Sequence) -> List[list]:
    out = []
    for q in queries:
        if hasattr(q, "task"):
            out.append([q.task, getattr(q, "node", None),
                        float(q.input_gb)])
        else:
            t, n, gb = q
            out.append([t, n, float(gb)])
    return out


class _ShardConn:
    """One multiplexed connection: a background reader resolves pending
    futures by response id; losing the connection fails them all."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, address: Tuple[str, int]):
        from repro_torch.serve import wire
        self._wire = wire
        self._reader, self._writer = reader, writer
        self.address = address
        self.alive = True
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._reader_task = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def open(cls, address: Tuple[str, int],
                   timeout: float) -> "_ShardConn":
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(*address), timeout)
        return cls(reader, writer, address)

    async def _read_loop(self) -> None:
        err: BaseException = ConnectionResetError("shard closed connection")
        try:
            while True:
                resp = await self._wire.read_frame(self._reader)
                if resp is None:
                    break
                fut = self._pending.pop(resp.get("i"), None)
                if fut is not None and not fut.done():
                    fut.set_result(resp)
        except BaseException as e:   # noqa: BLE001 — every pending caller
            err = e                  # must learn the connection is gone
        self.alive = False
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    ConnectionResetError(f"connection lost: {err}"))
        self._pending.clear()

    async def request(self, payload: dict, timeout: float) -> dict:
        if not self.alive:
            raise TransportError("connection is closed", sent=False)
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        sent = False
        try:
            await self._wire.write_frame(self._writer, {"i": rid, **payload})
            sent = True
            return await asyncio.wait_for(fut, timeout)
        except (ConnectionError, OSError, RuntimeError,
                asyncio.TimeoutError) as e:
            self._pending.pop(rid, None)
            raise TransportError(str(e), sent=sent) from e

    async def close(self) -> None:
        self.alive = False
        self._reader_task.cancel()
        try:
            await self._reader_task
        except (asyncio.CancelledError, Exception):   # noqa: BLE001
            pass
        try:
            self._writer.close()
        except RuntimeError:
            pass


class ServingClient:
    def __init__(self, shard_map: ShardMap,
                 retry: Optional[RetryPolicy] = None,
                 observe_window_s: Optional[float] = None):
        self.map = shard_map
        self.retry = retry or RetryPolicy()
        self._conns: Dict[str, _ShardConn] = {}
        self._conn_locks: Dict[str, asyncio.Lock] = {}
        self._orphan_closes: List[asyncio.Future] = []
        # observe coalescing: scalar observes park here for a window,
        # then ship as per-shard observe_many frames (None: send-through)
        self.observe_window_s = observe_window_s
        self._obs_buf: List[tuple] = []
        self._obs_task: Optional[asyncio.Future] = None

    # ---- map / connection management ----------------------------------------
    def set_map(self, m: ShardMap) -> None:
        """Adopt a newer map; connections to moved addresses are dropped
        lazily (next use reconnects).  Shards that left the map entirely
        lose their lock entries too — without this, every rebalance
        leaks a dead socket and a lock per removed shard, forever."""
        if m.version <= self.map.version:
            return
        self.map = m
        for sid, conn in list(self._conns.items()):
            if sid not in m.shards or m.address_of(sid) != conn.address:
                self._conns.pop(sid)
                # fire-and-forget, but tracked: close() awaits these so
                # no reader task outlives the client
                self._orphan_closes.append(
                    asyncio.ensure_future(conn.close()))
        for sid in list(self._conn_locks):
            if sid not in m.shards:
                self._conn_locks.pop(sid)

    async def _conn(self, shard_id: str) -> _ShardConn:
        # single-flight per shard: concurrent callers racing to connect
        # would each open a socket and orphan all but the last reader task
        lock = self._conn_locks.setdefault(shard_id, asyncio.Lock())
        async with lock:
            info = self.map.shards.get(shard_id)
            if info is None:
                # the shard left the map (this call raced a rebalance):
                # surface as wrong_shard so fixed-target rounds re-group
                # under the new map instead of KeyError-crashing
                raise WrongShardError(
                    f"shard {shard_id!r} is not in map "
                    f"v{self.map.version}")
            addr = info.address
            conn = self._conns.get(shard_id)
            if conn is not None and conn.alive and conn.address == addr:
                return conn
            if conn is not None:
                await conn.close()
            conn = await _ShardConn.open(addr, self.retry.timeout_s)
            self._conns[shard_id] = conn
            return conn

    # ---- the retry core ------------------------------------------------------
    async def _call(self, op: str, payload: dict, *,
                    tenant: Optional[str] = None,
                    workflow: Optional[str] = None,
                    shard_id: Optional[str] = None,
                    idempotent: bool = True) -> dict:
        pol = self.retry
        delay = pol.base_backoff_s
        last: Optional[BaseException] = None
        for attempt in range(pol.max_attempts):
            if attempt:
                await asyncio.sleep(delay)
                delay = min(delay * 2, pol.max_backoff_s)
            sid = shard_id if shard_id is not None else self.map.shard_for(
                namespace_str(tenant, workflow))
            try:
                conn = await self._conn(sid)
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                last = e
                continue
            try:
                resp = await conn.request(
                    {"op": op, "v": self.map.version, **payload},
                    pol.timeout_s)
            except TransportError as e:
                if not idempotent and e.sent:
                    # the observe frame may have been applied; resending
                    # would double-count it — surface the uncertainty
                    raise (e.__cause__ or e)
                last = e.__cause__ or e
                continue
            if resp.get("ok"):
                return resp["r"]
            err = resp.get("e") or {}
            kind = err.get("k", "error")
            if kind == "wrong_shard":
                m = err.get("map")
                if m is not None:
                    self.set_map(ShardMap.from_wire(m))
                last = WrongShardError(err.get("m", ""))
                if shard_id is not None:
                    raise last       # fixed-target call: caller re-routes
                continue             # namespace call: re-route and retry
            if kind == "queue_full":
                last = QueueFullError(err.get("m", "shard is shedding load"))
                continue             # backpressure: backoff within budget
            if kind == "migrating":
                # fenced mid-rebalance: nothing was applied (the fence
                # rejects before parking), so even observes retry safely;
                # by the time backoff elapses the new map is usually
                # published and the retry re-routes via wrong_shard
                last = MigratingError(err.get("m", ""))
                continue
            if kind == "unknown_namespace" and idempotent \
                    and tenant is not None:
                # release race: the request passed ownership validation
                # on the source just as the namespace was evicted; the
                # next attempt re-routes under the healed map
                last = RemoteError(kind, err.get("m", ""))
                continue
            raise RemoteError(kind, err.get("m", ""))
        assert last is not None
        raise last

    # ---- public API ----------------------------------------------------------
    async def predict(self, queries: Sequence, tenant: str,
                      workflow: str) -> np.ndarray:
        """One namespace's batch -> (Q, 3) [mean, lower, upper]."""
        r = await self._call("predict",
                             {"t": tenant, "w": workflow,
                              "x": _wire_queries(queries)},
                             tenant=tenant, workflow=workflow)
        return np.asarray(r["p"])

    async def predict_many(self, batches: Sequence[Tuple[str, str, Sequence]]
                           ) -> List[np.ndarray]:
        """[(tenant, workflow, queries), ...] -> per-batch (Q, 3) arrays.
        Coalesced: one `predict_multi` RPC per owning shard, all shards
        in flight concurrently.  Re-groups and retries batches displaced
        by a map change mid-round."""
        out: List[Optional[np.ndarray]] = [None] * len(batches)
        remaining = list(range(len(batches)))
        last: Optional[BaseException] = None
        for _ in range(self.retry.max_attempts):
            if not remaining:
                break
            groups: Dict[str, List[int]] = {}
            for i in remaining:
                t, w, _ = batches[i]
                groups.setdefault(
                    self.map.shard_for(namespace_str(t, w)), []).append(i)
            calls = [self._call("predict_multi",
                                {"b": [{"t": batches[i][0],
                                        "w": batches[i][1],
                                        "x": _wire_queries(batches[i][2])}
                                       for i in idxs]},
                                shard_id=sid)
                     for sid, idxs in groups.items()]
            results = await asyncio.gather(*calls, return_exceptions=True)
            next_remaining: List[int] = []
            for (sid, idxs), res in zip(groups.items(), results):
                if isinstance(res, WrongShardError):
                    next_remaining.extend(idxs)   # map moved: re-group
                    last = res
                elif isinstance(res, BaseException):
                    raise res
                else:
                    for i, arr in zip(idxs, res["p"]):
                        out[i] = np.asarray(arr)
            remaining = next_remaining
        if remaining:
            raise last or RuntimeError("predict_many failed to converge")
        return out    # type: ignore[return-value]

    async def predict_matrix(self, tenant: str, workflow: str,
                             tasks: Sequence[Tuple[str, float]],
                             nodes: Sequence[Optional[str]]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        r = await self._call("predict_matrix",
                             {"t": tenant, "w": workflow,
                              "tasks": [[t, float(gb)] for t, gb in tasks],
                              "nodes": list(nodes)},
                             tenant=tenant, workflow=workflow)
        return np.asarray(r["mean"]), np.asarray(r["std"])

    async def observe(self, comp, tenant: str, workflow: str) -> int:
        """Fold a completion into its shard; returns the durable oplog
        ack sequence.  Not resent once on the wire (see module doc).
        With `observe_window_s` set, parks for the window and rides a
        coalesced `observe_many` frame instead of a solo RPC."""
        if self.observe_window_s is not None:
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._obs_buf.append((comp, tenant, workflow, fut))
            if self._obs_task is None or self._obs_task.done():
                self._obs_task = asyncio.ensure_future(self._observe_drain())
            return await fut
        r = await self._call("observe",
                             {"t": tenant, "w": workflow,
                              "c": dataclasses.asdict(comp)},
                             tenant=tenant, workflow=workflow,
                             idempotent=False)
        return int(r["seq"])

    async def _observe_drain(self) -> None:
        """Flush the observe window: everything parked goes out as one
        coalesced `observe_many` round, resolved per record (a partial
        round acks the records that landed and fails only the rest).

        Observes arriving while this drain is on the wire park in the
        fresh buffer but see a still-running task and schedule nothing,
        so the drain re-checks the buffer when it finishes — success or
        failure — and chains a new drain; no parked future can strand."""
        try:
            await asyncio.sleep(self.observe_window_s or 0.0)
            parked, self._obs_buf = self._obs_buf, []
            if parked:
                await self._observe_flush(parked)
        finally:
            if self._obs_buf:
                self._obs_task = asyncio.ensure_future(self._observe_drain())

    async def _observe_flush(self, parked: List[tuple]) -> None:
        try:
            seqs = await self.observe_many(
                [(c, t, w) for c, t, w, _ in parked])
        except PartialObserveError as e:
            for i, (*_, fut) in enumerate(parked):
                if fut.done():
                    continue
                if e.seqs[i] is not None:
                    fut.set_result(e.seqs[i])     # durably acked records
                else:                             # keep their real acks
                    fut.set_exception(e.errors.get(i, e))
            return
        except BaseException as e:     # noqa: BLE001 — parked callers
            for *_, fut in parked:     # must see the round's failure
                if not fut.done():
                    fut.set_exception(e)
            return
        for (*_, fut), seq in zip(parked, seqs):
            if not fut.done():
                fut.set_result(seq)

    async def observe_many(self, batch: Sequence[Tuple[object, str, str]]
                           ) -> List[int]:
        """[(completion, tenant, workflow), ...] -> per-record oplog ack
        seqs.  Coalesced: one `observe_many` RPC per owning shard, all
        shards in flight concurrently.  Re-groups batches displaced by a
        map change mid-round — safe under the no-resend rule because the
        shard rejects a whole frame (`wrong_shard`) before applying any
        record of it.

        A failing shard group fails only its OWN records: acks already
        returned by the round's other groups are durable and must not be
        discarded (a caller retrying them would double-count).  When the
        round is split — some records acked, some failed — the mixed
        outcome surfaces as `PartialObserveError` carrying per-record
        seqs and exceptions; only an all-fail round raises the group
        error directly."""
        out: List[Optional[int]] = [None] * len(batch)
        errors: Dict[int, BaseException] = {}
        remaining = list(range(len(batch)))
        last: Optional[BaseException] = None
        for _ in range(self.retry.max_attempts):
            if not remaining:
                break
            groups: Dict[str, List[int]] = {}
            for i in remaining:
                _, t, w = batch[i]
                groups.setdefault(
                    self.map.shard_for(namespace_str(t, w)), []).append(i)
            calls = [self._call("observe_many",
                                {"b": [{"t": batch[i][1],
                                        "w": batch[i][2],
                                        "c": dataclasses.asdict(batch[i][0])}
                                       for i in idxs]},
                                shard_id=sid, idempotent=False)
                     for sid, idxs in groups.items()]
            results = await asyncio.gather(*calls, return_exceptions=True)
            next_remaining: List[int] = []
            for (sid, idxs), res in zip(groups.items(), results):
                if isinstance(res, WrongShardError):
                    next_remaining.extend(idxs)   # map moved: re-group
                    last = res
                elif isinstance(res, BaseException):
                    for i in idxs:                # group failure stays
                        errors[i] = res           # scoped to the group
                else:
                    for i, seq in zip(idxs, res["seqs"]):
                        out[i] = int(seq)
            remaining = next_remaining
        for i in remaining:                       # wrong_shard budget spent
            errors[i] = last or RuntimeError(
                "observe_many failed to converge")
        if errors:
            if all(s is None for s in out):
                raise next(iter(errors.values()))
            raise PartialObserveError(out, errors)
        return out    # type: ignore[return-value]

    async def digest(self, tenant: str, workflow: str) -> str:
        r = await self._call("digest", {"t": tenant, "w": workflow},
                             tenant=tenant, workflow=workflow)
        return r["sha256"]

    async def predict_base(self, replica: Tuple[str, int],
                           keys: Sequence[str],
                           x: Sequence[float]) -> np.ndarray:
        """First-class replica read: (Q, 3) base predictions off a read
        replica (replicas are never in the shard map — address them
        directly).  The staleness bound is enforced replica-side: one
        whose generation lag exceeds its `max_generation_lag` answers
        `stale_replica`, surfaced here as `ReplicaStaleError` so the
        caller redirects the read to the primary (`predict`)."""
        r = await call_direct(replica, "predict_base",
                              {"keys": list(keys),
                               "x": [float(v) for v in x]},
                              timeout=self.retry.timeout_s)
        return np.asarray(r["p"])

    async def health(self, shard_id: str) -> dict:
        return await self._call("health", {}, shard_id=shard_id)

    async def checkpoint(self, shard_id: str) -> dict:
        return await self._call("checkpoint", {}, shard_id=shard_id)

    async def refresh(self, shard_id: str) -> dict:
        return await self._call("refresh", {}, shard_id=shard_id)

    async def update_maps(self) -> None:
        """Push this client's map to every shard (post-failover: shards
        that never died learn the readmitted address)."""
        wire_map = self.map.to_wire()
        await asyncio.gather(*[
            self._call("update_map", {"map": wire_map}, shard_id=sid)
            for sid in self.map.shard_ids()])

    async def close(self) -> None:
        # let pending observe windows flush before tearing down
        # connections (parked callers get real acks, not resets); a
        # finishing drain may chain a successor for late arrivals, so
        # follow the chain until no new drain replaces the awaited one
        while self._obs_task is not None and not self._obs_task.done():
            task = self._obs_task
            try:
                await task
            except Exception:          # noqa: BLE001 — drain reported to
                pass                   # its own parked futures already
            if self._obs_task is task:
                break
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
        if self._orphan_closes:
            await asyncio.gather(*self._orphan_closes,
                                 return_exceptions=True)
            self._orphan_closes.clear()
