"""Read replicas: periodic COW-snapshot shipping off the primary.

The primary's blocks are copy-on-write and generation-stamped, so a
replica feed is cheap and incremental by construction:
`PosteriorStore.export_blocks(since_generation=g)` returns exactly the
blocks that moved since the last ship (plus the row index and the
predictors' streaming states), and `import_blocks` installs them into a
*passive* store — no bindings, no syncs, so the replica can never
diverge by writing.

`ReplicaShipper` runs on the primary's event loop and pushes deltas to
each replica on an interval, tracking a per-replica generation cursor
(a replica that missed ships just gets a bigger delta next time; a new
replica gets the full set, cursor -1).  Failures are isolated per
replica: a torn frame, codec error, or dead socket on one replica must
never strand the rest of the round (the remaining replicas would
otherwise go stale until the next interval for someone else's fault).

Replica reads are a first-class serving path with an explicit staleness
bound.  Every ship round opens with a `mark` frame carrying the
primary's current generation, so the replica always knows how far ahead
the primary is even when the snapshot transfer itself fails; with
`max_generation_lag=K` configured, `predict_base` serves only while
`primary_generation - replica_generation <= K` and otherwise rejects
with a `stale_replica` error carrying the lag and the bound — the
caller redirects to the primary (`ServingClient.predict_base` surfaces
this as `ReplicaStaleError`).  A replica that has never heard a mark is
conservatively treated as current only up to its own installs.

`ReplicaServer` answers:

  install_snapshot  install a shipped delta
  mark              the shipper's generation heartbeat (staleness bound)
  predict_base      (Q, 3) mean/lower/upper from the replicated rows —
                    base (local-node) predictions: node extrapolation
                    factors are primary-side predictor logic, and the
                    replica deliberately holds state, not models
  digest            sha256 of a shipped namespace's streaming state —
                    comparing against the primary's `digest` proves the
                    replica is bit-identical through the wire
  health / observe  observe answers `read_only`: writes go to the
                    primary, always

`predict_base` runs on the replica's `device` ("cuda" by default): the
snapshot's gather writes the rows straight into the predictive's packed
slab, one copy up, one `bayes_predict` launch.

A warm replica plus the primary's checkpoint+oplog are complementary:
failover restores authoritative state from disk (failover.py); replicas
scale reads and give the fleet a place to point dashboards mid-failover.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.serve.wire import read_frame, write_frame
from repro_torch.store.compute import predict_stacked
from repro_torch.store.posterior import PosteriorStore


class StaleReplicaError(RuntimeError):
    """Replica-side rejection: the shipper cursor fell more than
    `max_generation_lag` generations behind the primary's last mark."""

    def __init__(self, lag: int, bound: int):
        super().__init__(
            f"replica is {lag} generations behind the primary "
            f"(max_generation_lag={bound}); read from the primary or "
            f"retry after the next ship")
        self.lag = lag
        self.bound = bound


class ReplicaServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 device=DEFAULT_DEVICE, z: float = 1.96,
                 max_generation_lag: Optional[int] = None):
        if max_generation_lag is not None and max_generation_lag < 0:
            raise ValueError("max_generation_lag must be >= 0")
        self.host, self.port = host, port
        self.device, self.z = resolve_device(device), z
        self.max_generation_lag = max_generation_lag
        self.store: Optional[PosteriorStore] = None
        self.installs = 0
        self.primary_generation = -1     # last mark/install heard
        self.stale_rejections = 0
        self._server = None

    # ---- staleness ----------------------------------------------------------
    @property
    def generation_lag(self) -> int:
        """Generations the primary is known to be ahead of this replica
        (0 when no mark has outrun the installed snapshot)."""
        mine = self.store.generation if self.store is not None else -1
        return max(0, self.primary_generation - mine)

    def _check_freshness(self) -> None:
        if self.max_generation_lag is None:
            return
        lag = self.generation_lag
        if lag > self.max_generation_lag:
            self.stale_rejections += 1
            raise StaleReplicaError(lag, self.max_generation_lag)

    # ---- ops ----------------------------------------------------------------
    def _install(self, payload) -> dict:
        if self.store is None:
            self.store = PosteriorStore(
                block_size=int(payload["block_size"]))
        n = self.store.import_blocks(payload)
        self.installs += 1
        self.primary_generation = max(self.primary_generation,
                                      int(payload["generation"]))
        return {"installed": n, "generation": self.store.generation}

    def _mark(self, generation: int) -> dict:
        """Shipper heartbeat: how far the primary has advanced.  Arrives
        before each install attempt, so a failed transfer still leaves
        the replica knowing (and enforcing) its true lag."""
        self.primary_generation = max(self.primary_generation,
                                      int(generation))
        return {"lag": self.generation_lag}

    def _predict_base(self, keys: Sequence[str], x: Sequence[float]) -> dict:
        if self.store is None:
            raise RuntimeError("replica has no snapshot yet")
        self._check_freshness()
        snap = self.store.snapshot()
        keys = list(keys)
        mean, std = predict_stacked(np.asarray(x, np.float64),
                                    lambda out: snap.gather(keys, out),
                                    device=self.device)
        out = np.stack([mean, mean - self.z * std, mean + self.z * std],
                       axis=1).astype(np.float32)
        return {"p": out}

    def _digest(self, namespace: str) -> dict:
        states = self.store._saved_states if self.store is not None else {}
        state = states.get(namespace)
        if state is None:
            raise KeyError(f"namespace {namespace!r} not replicated")
        blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
        return {"sha256": hashlib.sha256(blob.encode()).hexdigest()}

    async def _serve_one(self, req, writer) -> None:
        rid = req.get("i")
        try:
            op = req.get("op")
            if op == "install_snapshot":
                r = self._install(req["s"])
            elif op == "mark":
                r = self._mark(req["g"])
            elif op == "predict_base":
                r = self._predict_base(req["keys"], req["x"])
            elif op == "digest":
                r = self._digest(req["ns"])
            elif op == "health":
                r = {"role": "replica", "pid": os.getpid(),
                     "installs": self.installs,
                     "generation": (self.store.generation
                                    if self.store is not None else -1),
                     "primary_generation": self.primary_generation,
                     "generation_lag": self.generation_lag,
                     "max_generation_lag": self.max_generation_lag,
                     "stale_rejections": self.stale_rejections}
            elif op == "observe":
                resp = {"i": rid, "ok": False,
                        "e": {"k": "read_only",
                              "m": "replicas never accept writes; "
                                   "observe on the primary"}}
                await write_frame(writer, resp)
                return
            else:
                raise ValueError(f"replica does not speak {op!r}")
            resp = {"i": rid, "ok": True, "r": r}
        except StaleReplicaError as e:
            resp = {"i": rid, "ok": False,
                    "e": {"k": "stale_replica", "m": str(e),
                          "lag": e.lag, "bound": e.bound}}
        except Exception as e:       # noqa: BLE001
            resp = {"i": rid, "ok": False,
                    "e": {"k": type(e).__name__, "m": str(e)}}
        try:
            await write_frame(writer, resp)
        except (ConnectionError, RuntimeError):
            pass

    async def _on_conn(self, reader, writer) -> None:
        try:
            while True:
                req = await read_frame(reader)
                if req is None:
                    break
                await self._serve_one(req, writer)
        except Exception:            # noqa: BLE001 — torn peer frame
            pass
        finally:
            writer.close()

    # ---- lifecycle ----------------------------------------------------------
    async def start(self) -> "ReplicaServer":
        self._server = await asyncio.start_server(self._on_conn, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


class ReplicaShipper:
    """Primary-side periodic snapshot shipping to N replicas."""

    def __init__(self, store: PosteriorStore,
                 replicas: Sequence[Tuple[str, int]],
                 interval_s: float = 1.0):
        self.store = store
        self.replicas = list(replicas)
        self.interval_s = interval_s
        self.shipped: Dict[Tuple[str, int], int] = {
            addr: -1 for addr in self.replicas}    # generation cursor
        self.ship_count = 0
        self.frame_bytes: Dict[Tuple[str, int], int] = {}  # the newest
        # install frame's bytes a replica (header included)
        self.ship_errors = 0
        self.last_error: Optional[BaseException] = None   # newest failure
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    def lags(self) -> Dict[Tuple[str, int], int]:
        """Per-replica generation lag as the shipper sees it: primary
        generation minus that replica's last installed cursor (a replica
        that keeps failing ships accumulates lag here — the supervisor's
        dashboard view of the staleness bound)."""
        gen = self.store.generation
        return {addr: gen - cursor for addr, cursor in self.shipped.items()}

    async def _ship_to(self, addr: Tuple[str, int], payload: dict) -> int:
        """Ship one delta to one replica.  Every failure mode — refused
        connection, torn frame mid-reply (`asyncio.IncompleteReadError`
        surfaces as `TruncatedFrame`), codec error — is contained to this
        replica: the caller moves on to the next one and this cursor
        stays put for a catch-up delta next round.  The transport is
        closed AND awaited (`wait_closed`) on every path, so failed
        rounds cannot leak half-closed transports."""
        writer = None
        resp = None
        try:
            reader, writer = await asyncio.open_connection(*addr)
            # the mark goes first: even when the snapshot transfer below
            # dies, the replica has learned the primary's generation and
            # can enforce its staleness bound against it
            await write_frame(writer, {"i": 0, "op": "mark",
                                       "g": int(payload["generation"])})
            await read_frame(reader)
            self.frame_bytes[addr] = await write_frame(
                writer, {"i": 1, "op": "install_snapshot", "s": payload})
            resp = await read_frame(reader)
        except Exception as e:       # noqa: BLE001 — per-replica isolation
            self.ship_errors += 1    # (a FrameTooLarge payload lands here:
            self.last_error = e      # callers read ship_errors/last_error)
            return -1
        finally:
            if writer is not None:
                writer.close()
                try:
                    await writer.wait_closed()
                except (ConnectionError, OSError):
                    pass             # peer reset during close handshake
        if resp and resp.get("ok"):
            self.shipped[addr] = int(payload["generation"])
            self.ship_count += 1
            return int(resp["r"]["installed"])
        self.ship_errors += 1
        self.last_error = RuntimeError(f"replica {addr} refused the "
                                       f"install: {resp!r}")
        return -1

    async def ship_once(self) -> List[int]:
        """One delta per replica (coalesced export per distinct cursor).
        Returns installed-block counts; a dead or erroring replica
        answers -1, keeps its cursor, and catches up on the next round —
        it can never abort the remaining replicas' ships."""
        out = []
        exports: Dict[int, dict] = {}
        for addr in self.replicas:
            since = self.shipped[addr]
            if since not in exports:
                exports[since] = self.store.export_blocks(
                    since_generation=since)
            out.append(await self._ship_to(addr, exports[since]))
        return out

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), self.interval_s)
            except asyncio.TimeoutError:
                try:
                    await self.ship_once()
                except Exception:    # noqa: BLE001 — shipping must not
                    pass             # take down the primary's loop

    def start(self) -> "ReplicaShipper":
        self._task = asyncio.ensure_future(self._loop())
        return self

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
