"""Durability and warm failover for serving shards.

Two pieces:

  * `OpLog` — a per-shard append-only observation log using the wire
    framing (the reference's record layout: either package replays a
    log the other wrote).  `OnlinePredictor.observe` calls the shard's
    hook under its state lock BEFORE applying the update (write-ahead
    order), so every *applied* observation is on disk and every
    *acknowledged* one was both logged and applied.  The store
    checkpoint carries the oplog watermark (`shard.ShardMeta` rides
    inside the manifest), so recovery is: restore the checkpoint, replay
    log records past the watermark, and the posterior state is
    bit-identical to the pre-crash primary — with zero lost acknowledged
    observations.

  * `ShardSupervisor` — spawns shard processes (`python -m
    repro_torch.serve.shard`), waits for their READY line, SIGKILLs them
    on demand, and restarts a killed shard from the same checkpoint/oplog
    spec (`failover`).  A child runs on the device its `--device` flag
    names (`ShardSpec.extra_args`; "cuda" when none is given), makes its
    own CUDA context and loads the built kernels.  The restarted shard
    comes back on a fresh port; readmission is `ShardMap.with_address`,
    which moves no namespaces.

  * `HealthMonitor` — the supervisor promoted from kill-drill tooling to
    an actual health-check loop: a thread polls every supervised shard's
    `health` RPC and restarts (via the failover path, readmitting with
    `with_address`) any shard that is dead, unreachable for N
    consecutive polls, stuck with a persistent `last_ingest_error`, or
    drowning in parked ingest backlog.  After a restart it pushes the
    bumped map to the whole fleet so surviving shards and late clients
    converge without a coordination service.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

from repro_torch.serve import wire
from repro_torch.serve.placement import ShardMap
from repro_torch.serve.wire import append_frame, iter_frames


def shard_rpc(address, op: str, payload: Optional[dict] = None,
              timeout_s: float = 5.0) -> dict:
    """Blocking one-shot shard RPC over the wire framing — the health
    monitor runs in a plain thread with no event loop, so it cannot ride
    `ServingClient`.  Raises on transport failure or error replies."""
    with socket.create_connection(address, timeout=timeout_s) as sock:
        sock.settimeout(timeout_s)
        sock.sendall(wire.frame({"i": 0, "op": op, **(payload or {})}))
        buf = b""
        while len(buf) < 4:
            chunk = sock.recv(4 - len(buf))
            if not chunk:
                raise ConnectionError("peer closed before replying")
            buf += chunk
        (n,) = struct.unpack(">I", buf)
        if n > wire.MAX_FRAME:
            raise wire.FrameTooLarge(f"reply announced {n} bytes")
        body = b""
        while len(body) < n:
            chunk = sock.recv(min(65536, n - len(body)))
            if not chunk:
                raise ConnectionError("torn reply frame")
            body += chunk
        resp = wire.decode(body)
    if resp.get("ok"):
        return resp["r"]
    err = resp.get("e") or {}
    raise RuntimeError(f"{err.get('k', 'error')}: {err.get('m', '')}")


class OpLog:
    """Append-only, sequence-numbered record log with group commit.

    Records are dicts; `append` stamps them with a monotonically
    increasing `"q"` (the ack sequence) and flushes before returning —
    a record is durable against *process* death the moment append
    returns (fsync against machine death is deliberately skipped; see
    `wire.append_frame`).  `append_many` is the group commit: a whole
    ingest batch becomes ONE frame (`{"q": <last>, "g": [records]}`) and
    ONE flush, each record inside carrying its own per-record ack seq —
    the batched write path pays one durability round per batch instead
    of one per observation, with an unchanged ack contract (an acked seq
    is on disk, acks are dense).

    Opening an existing log scans it to recover the sequence, tolerating
    a torn tail from a crash mid-append.  A torn GROUP frame drops the
    whole group — safe for the same reason a torn single frame is: no
    record of that group was acked, because append_many had not returned
    when the crash hit (the acked watermark holds).  `flush_count` counts
    commits (frames), the denominator of batching leverage telemetry."""

    def __init__(self, path: str):
        self.path = path
        self.last_seq = 0
        self.flush_count = 0
        if os.path.exists(path):
            with open(path, "rb") as f:
                for _, rec in iter_frames(f):
                    for r in self._expand(rec):
                        self.last_seq = max(self.last_seq,
                                            int(r.get("q", 0)))
        self._f = open(path, "ab")
        self._lock = threading.Lock()

    @staticmethod
    def _expand(frame_rec: dict) -> List[dict]:
        """A frame is either one record or a group commit of many."""
        if "g" in frame_rec:
            return list(frame_rec["g"])
        return [frame_rec]

    def append(self, record: dict) -> int:
        with self._lock:
            self.last_seq += 1
            append_frame(self._f, {"q": self.last_seq, **record})
            self.flush_count += 1
            return self.last_seq

    def append_many(self, records: List[dict]) -> List[int]:
        """Group-commit `records` in ONE frame + ONE flush; returns the
        per-record ack seqs (dense, in order)."""
        if not records:
            return []
        with self._lock:
            group = []
            seqs = []
            for record in records:
                self.last_seq += 1
                group.append({"q": self.last_seq, **record})
                seqs.append(self.last_seq)
            append_frame(self._f, {"q": self.last_seq, "g": group})
            self.flush_count += 1
            return seqs

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def replay(path: str, after_seq: int = 0) -> Iterator[dict]:
        """Records with seq > after_seq, in order (the recovery tail:
        `after_seq` is the checkpoint's embedded watermark).  Group
        frames are expanded to their per-record entries, so replay
        consumers never see the framing difference."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            for _, rec in iter_frames(f):
                for r in OpLog._expand(rec):
                    if int(r.get("q", 0)) > after_seq:
                        yield r


@dataclass
class ShardSpec:
    """Everything needed to (re)start one shard process."""
    shard_id: str
    bootstrap: str                    # "module:function" building namespaces
    checkpoint_dir: str
    oplog_path: str
    host: str = "127.0.0.1"
    port: int = 0                     # 0: kernel-assigned, read from READY
    checkpoint_interval_s: Optional[float] = None
    refresh_interval_s: Optional[float] = None
    extra_args: List[str] = field(default_factory=list)


class ShardSupervisor:
    """Process lifecycle for a fleet of shards (benchmark/CI harness: a
    production deployment would hand this role to systemd/k8s — the
    protocol is the same: start, wait for READY, kill, restart from the
    same durable spec)."""

    def __init__(self, repo_root: Optional[str] = None,
                 ready_timeout_s: float = 60.0,
                 stderr_dir: Optional[str] = None):
        self.repo_root = repo_root or os.getcwd()
        self.ready_timeout_s = ready_timeout_s
        # where each child's stderr goes (`<shard_id>.err`, appended across
        # restarts); None discards it
        self.stderr_dir = stderr_dir
        self.procs: Dict[str, subprocess.Popen] = {}
        self.specs: Dict[str, ShardSpec] = {}
        self.ports: Dict[str, int] = {}
        # the fields of each shard's last READY line (port, pid, and the
        # oplog records its boot replayed)
        self.ready: Dict[str, Dict[str, int]] = {}

    def _env(self) -> dict:
        env = dict(os.environ)
        src = os.path.join(self.repo_root, "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def start(self, spec: ShardSpec, map_json: str) -> int:
        """Spawn the shard, block until its READY line, return its port."""
        cmd = [sys.executable, "-m", "repro_torch.serve.shard",
               "--shard-id", spec.shard_id,
               "--host", spec.host, "--port", str(spec.port),
               "--map", map_json,
               "--bootstrap", spec.bootstrap,
               "--oplog", spec.oplog_path,
               "--checkpoint", spec.checkpoint_dir]
        if spec.checkpoint_interval_s is not None:
            cmd += ["--checkpoint-interval", str(spec.checkpoint_interval_s)]
        if spec.refresh_interval_s is not None:
            cmd += ["--refresh-interval", str(spec.refresh_interval_s)]
        cmd += spec.extra_args
        err = (open(os.path.join(self.stderr_dir, spec.shard_id + ".err"),
                    "ab") if self.stderr_dir is not None
               else subprocess.DEVNULL)
        try:
            proc = subprocess.Popen(cmd, cwd=self.repo_root,
                                    env=self._env(), stdout=subprocess.PIPE,
                                    stderr=err, text=True)
        finally:
            if err is not subprocess.DEVNULL:
                err.close()          # the child holds its own descriptor
        port = self._await_ready(proc, spec.shard_id)
        self.procs[spec.shard_id] = proc
        self.specs[spec.shard_id] = spec
        self.ports[spec.shard_id] = port
        return port

    def _await_ready(self, proc: subprocess.Popen, shard_id: str) -> int:
        deadline = time.monotonic() + self.ready_timeout_s
        assert proc.stdout is not None
        while True:
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError(f"shard {shard_id!r} never became ready")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"shard {shard_id!r} exited before READY "
                    f"(rc={proc.poll()})")
            if line.startswith("SHARD-READY"):
                fields = dict(tok.split("=", 1) for tok in line.split()
                              if "=" in tok)
                if "port" not in fields:
                    raise RuntimeError(f"malformed READY line: {line!r}")
                self.ready[shard_id] = {k: int(v)
                                        for k, v in fields.items()}
                return self.ready[shard_id]["port"]

    def kill(self, shard_id: str, sig: int = signal.SIGKILL) -> None:
        """Hard-kill a shard (the failover drill: no flush, no goodbye)."""
        proc = self.procs[shard_id]
        proc.send_signal(sig)
        proc.wait(timeout=30)

    def failover(self, shard_id: str, map_json: str) -> int:
        """Restart a dead shard from its durable spec: restore checkpoint,
        replay oplog tail, reopen on a fresh port.  Returns the new port;
        the caller readmits it with `ShardMap.with_address`."""
        spec = self.specs[shard_id]
        proc = self.procs.get(shard_id)
        if proc is not None and proc.poll() is None:
            raise RuntimeError(f"shard {shard_id!r} is still alive")
        return self.start(spec, map_json)

    def stop_all(self) -> None:
        for sid, proc in list(self.procs.items()):
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
            try:
                proc.wait(timeout=30)
            finally:
                if proc.stdout is not None:
                    proc.stdout.close()
        self.procs.clear()

    def watch(self, shard_map: ShardMap,
              policy: Optional["HealthPolicy"] = None,
              on_map_change: Optional[Callable[[ShardMap], None]] = None
              ) -> "HealthMonitor":
        """Start the health-check loop over every supervised shard;
        returns the running monitor (call `.stop()` to end it)."""
        monitor = HealthMonitor(self, shard_map, policy=policy,
                                on_map_change=on_map_change)
        monitor.start()
        return monitor

    def __enter__(self) -> "ShardSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()


@dataclass
class HealthPolicy:
    """When is a shard unhealthy enough to restart?

    Transient blips must not trigger restarts (a restart drops the
    shard's in-memory ingest window and costs a recovery replay), so
    every signal except process death needs a consecutive-poll streak:

      * process exited           -> restart immediately
      * health RPC unreachable   -> `max_missed_polls` consecutive times
      * `last_ingest_error` set  -> `max_error_polls` consecutive times
        (the shard keeps acking durable observes but its binding-sync
        publish keeps failing: readers see ever-staler posteriors)
      * `pending_ingest` backlog -> above `max_pending_ingest` for
        `max_backlog_polls` consecutive polls (a dead drain task: parked
        records that will never ack)
    """
    interval_s: float = 0.5
    rpc_timeout_s: float = 2.0
    max_missed_polls: int = 3
    max_error_polls: int = 3
    max_backlog_polls: int = 3
    max_pending_ingest: Optional[int] = None   # None: backlog check off


class _Streaks:
    __slots__ = ("missed", "erroring", "backlog")

    def __init__(self) -> None:
        self.missed = self.erroring = self.backlog = 0


class HealthMonitor(threading.Thread):
    """Poll loop: health-RPC every supervised shard, restart the
    unhealthy via the failover path, readmit with `with_address`, and
    push the bumped map to the fleet.  `current_map` always holds the
    newest published map; `on_map_change` lets the serving application
    adopt it (e.g. schedule `client.set_map` onto its loop)."""

    def __init__(self, supervisor: ShardSupervisor, shard_map: ShardMap,
                 policy: Optional[HealthPolicy] = None,
                 on_map_change: Optional[Callable[[ShardMap], None]]
                 = None):
        super().__init__(daemon=True, name="shard-health-monitor")
        self.supervisor = supervisor
        self.policy = policy or HealthPolicy()
        self.current_map = shard_map
        self.on_map_change = on_map_change
        self.restarts: Dict[str, int] = {}
        self.restart_reasons: List[tuple] = []     # (shard_id, reason)
        self._streaks: Dict[str, _Streaks] = {}
        self._stop_evt = threading.Event()

    # ---- classification (pure-ish: unit-testable without processes) ---------
    def classify(self, shard_id: str, alive: bool,
                 health: Optional[dict]) -> Optional[str]:
        """Fold one poll result into the shard's streaks; returns a
        restart reason, or None while the shard counts as healthy.
        `health` is the health-RPC reply, or None when it failed."""
        pol = self.policy
        s = self._streaks.setdefault(shard_id, _Streaks())
        if not alive:
            return "process exited"
        if health is None:
            s.missed += 1
            if s.missed >= pol.max_missed_polls:
                return (f"unreachable for {s.missed} consecutive polls")
            return None
        s.missed = 0
        if health.get("last_ingest_error"):
            s.erroring += 1
        else:
            s.erroring = 0
        if s.erroring >= pol.max_error_polls:
            return (f"persistent ingest error for {s.erroring} polls: "
                    f"{health['last_ingest_error']}")
        if pol.max_pending_ingest is not None:
            if int(health.get("pending_ingest", 0)) > pol.max_pending_ingest:
                s.backlog += 1
            else:
                s.backlog = 0
            if s.backlog >= pol.max_backlog_polls:
                return (f"ingest backlog above {pol.max_pending_ingest} "
                        f"for {s.backlog} polls")
        return None

    # ---- the loop ------------------------------------------------------------
    def _poll_once(self) -> None:
        for sid in list(self.supervisor.procs):
            proc = self.supervisor.procs.get(sid)
            if proc is None:
                continue
            alive = proc.poll() is None
            health = None
            if alive:
                try:
                    addr = (self.current_map.address_of(sid)
                            if sid in self.current_map.shards
                            else (self.supervisor.specs[sid].host,
                                  self.supervisor.ports[sid]))
                    health = shard_rpc(addr, "health",
                                       timeout_s=self.policy.rpc_timeout_s)
                except Exception:    # noqa: BLE001 — unreachable counts
                    health = None    # via the missed-polls streak
            reason = self.classify(sid, alive, health)
            if reason is not None:
                self._restart(sid, reason)

    def _restart(self, shard_id: str, reason: str) -> None:
        sup = self.supervisor
        proc = sup.procs.get(shard_id)
        if proc is not None and proc.poll() is None:
            try:
                sup.kill(shard_id)
            except Exception:        # noqa: BLE001 — already dying
                pass
        map_json = json.dumps(self.current_map.to_wire())
        try:
            port = sup.failover(shard_id, map_json)
        except Exception:            # noqa: BLE001 — a failed restart
            return                   # retries on the next poll tick
        spec = sup.specs[shard_id]
        self._streaks.pop(shard_id, None)
        self.restarts[shard_id] = self.restarts.get(shard_id, 0) + 1
        self.restart_reasons.append((shard_id, reason))
        if shard_id in self.current_map.shards:
            self.current_map = self.current_map.with_address(
                shard_id, spec.host, port)
        wire_map = self.current_map.to_wire()
        for other in self.current_map.shard_ids():
            try:
                shard_rpc(self.current_map.address_of(other), "update_map",
                          {"map": wire_map},
                          timeout_s=self.policy.rpc_timeout_s)
            except Exception:        # noqa: BLE001 — stale shards heal
                pass                 # via wrong_shard later
        if self.on_map_change is not None:
            self.on_map_change(self.current_map)

    def run(self) -> None:
        while not self._stop_evt.wait(self.policy.interval_s):
            try:
                self._poll_once()
            except Exception:        # noqa: BLE001 — the monitor must
                pass                 # outlive any single bad poll

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop_evt.set()
        self.join(timeout=timeout_s)
