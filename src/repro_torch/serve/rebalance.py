"""Live resharding: move namespaces between shards under traffic.

`RebalanceCoordinator` turns the dormant `ShardMap` algebra
(`with_shard` / `without_shard` / `moved`) into an online protocol that
adds or removes a shard with zero lost acked observations and
bit-identical posteriors, while predicts keep serving:

  1. PLAN      new_map = old_map.with_shard(...) (or without_shard);
               old_map.moved(new_map, live_namespaces) names exactly
               what must migrate, grouped (source shard -> target shard)
  2. FENCE     each source fences its moving namespaces: new writes for
               them answer `migrating` (a nothing-applied, retryable
               reply — the shard's validate-before-park contract), then the
               in-flight ingest window is drained so every observation
               that was or will be ACKED is folded and oplogged.  The
               returned oplog watermark is the fence.  Predicts are NOT
               fenced: reads stay on the source, which remains correct
               because no client can route to the target before step 5.
  3. SHIP      `export_namespaces` off the source (rows gathered from a
               COW snapshot + streaming predictor states + pre-handoff
               digests), `install_namespaces` on the target (merge rows,
               resume fresh bootstrap predictors bit-identically off the
               shipped states, hook the oplog, adopt the new map).
  4. VERIFY    the install reply carries digests computed synchronously
               from the target's freshly resumed predictors; any
               mismatch aborts the rebalance — sources unfence, the old
               map stays published, nothing was lost (the target holds
               orphaned rows but serves nothing: it is not in any map).
  5. PUBLISH   the client adopts the new map and pushes it to every
               member shard; decommissioned sources (no longer in the
               map) get it over a direct connection — from here they
               answer `wrong_shard` with the NEW map, so every stale
               client self-heals on first contact.
  6. RELEASE   after a short grace (lets requests that passed ownership
               validation on the source before publish finish), sources
               evict the moved namespaces and lift fences.

Observation-loss argument: an observe is either acked before the fence
(drained into the source's oplog in step 2, shipped in step 3), or it
arrives fenced and gets `migrating`/`wrong_shard` — both promise
nothing-applied, so the client retry (safe under the no-resend rule
precisely because of that promise) lands on the target after publish.
There is no state in which an acked record misses the export or a
rejected record was half-applied.

The coordinator is storage-free: everything it needs is in the two maps
and the shards' replies, so a crashed coordinator leaves the fleet in
one of two recoverable states (old map everywhere + possibly fenced
sources -> unfence and re-run; new map published -> re-run reaches
release idempotently, `release_namespaces` tolerates already-evicted
namespaces).
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.serve.client import ServingClient, call_direct
from repro_torch.serve.placement import ShardMap


class RebalanceError(RuntimeError):
    """A rebalance step failed after a state change that the coordinator
    rolled back (fences lifted, old map still published)."""


@dataclass
class RebalanceReport:
    old_version: int
    new_version: int
    moved: List[str] = field(default_factory=list)
    rows_shipped: int = 0
    fence_seqs: Dict[str, int] = field(default_factory=dict)
    digests: Dict[str, str] = field(default_factory=dict)
    verified: bool = False


class RebalanceCoordinator:
    """Drives the fence -> ship -> verify -> publish -> release protocol
    against a live fleet through a `ServingClient` (whose map install is
    also the publish step, so the driving process never routes stale)."""

    def __init__(self, client: ServingClient, *,
                 release_grace_s: float = 0.25,
                 timeout_s: float = 30.0):
        self.client = client
        self.release_grace_s = release_grace_s
        self.timeout_s = timeout_s

    # ---- public entry points -------------------------------------------------
    async def add_shard(self, shard_id: str, host: str,
                        port: int) -> RebalanceReport:
        """Grow the ring: ~1/n of namespaces migrate TO the new shard.
        The shard must already be listening (booted with the OLD map —
        it owns nothing under it, so it serves nothing until install
        hands it namespaces and the new map)."""
        new_map = self.client.map.with_shard(shard_id, host, port)
        return await self._rebalance_to(new_map)

    async def remove_shard(self, shard_id: str) -> RebalanceReport:
        """Shrink the ring: the leaving shard's namespaces migrate to
        the survivors, then the shard serves only `wrong_shard` replies
        (it keeps listening so stale clients can still heal off it)."""
        new_map = self.client.map.without_shard(shard_id)
        return await self._rebalance_to(new_map)

    # ---- the protocol --------------------------------------------------------
    async def _namespaces_of(self, old_map: ShardMap) -> Dict[str, str]:
        """Live namespace -> owning shard, from every shard's health
        report (the fleet's own view, not a guess from bootstrap)."""
        owners: Dict[str, str] = {}
        for sid in old_map.shard_ids():
            h = await self.client.health(sid)
            for ns in h["namespaces"]:
                owners[ns] = sid
        return owners

    async def _source_call(self, old_map: ShardMap, new_map: ShardMap,
                           sid: str, op: str, payload: dict) -> dict:
        """RPC a SOURCE shard.  Mid-protocol the client may already hold
        the new map (publish step), where a decommissioned source is
        unreachable through it — so sources are always addressed
        directly via the old map."""
        return await call_direct(old_map.address_of(sid), op, payload,
                                 timeout=self.timeout_s)

    async def _rebalance_to(self, new_map: ShardMap) -> RebalanceReport:
        old_map = self.client.map
        report = RebalanceReport(old_version=old_map.version,
                                 new_version=new_map.version)
        owners = await self._namespaces_of(old_map)
        moved = old_map.moved(new_map, sorted(owners))
        report.moved = moved
        if not moved:
            # membership changed but no namespace moved (e.g. address
            # change): just publish
            await self._publish(old_map, new_map, {})
            report.verified = True
            return report

        # group moves per (source, target): consistent hashing moves a
        # namespace at most once, so the groups are disjoint
        groups: Dict[Tuple[str, str], List[str]] = {}
        for ns in moved:
            src = owners[ns]
            dst = new_map.shard_for(ns)
            groups.setdefault((src, dst), []).append(ns)

        fenced: Dict[str, List[str]] = {}
        for (src, _), nss in groups.items():
            fenced.setdefault(src, []).extend(nss)

        try:
            # FENCE every source (drains its ingest window; the reply's
            # watermark covers every acked observation)
            for src, nss in fenced.items():
                r = await self._source_call(old_map, new_map, src,
                                            "fence", {"ns": nss})
                report.fence_seqs[src] = int(r["seq"])

            # SHIP + VERIFY, per (source, target) group
            for (src, dst), nss in groups.items():
                exp = await self._source_call(old_map, new_map, src,
                                              "export_namespaces",
                                              {"ns": nss})
                report.rows_shipped += len(exp["s"]["keys"])
                inst = await call_direct(
                    new_map.address_of(dst), "install_namespaces",
                    {"s": exp["s"], "map": new_map.to_wire()},
                    timeout=self.timeout_s)
                for ns in nss:
                    want = exp["digests"][ns]
                    got = inst["digests"].get(ns)
                    if got != want:
                        raise RebalanceError(
                            f"digest mismatch migrating {ns!r} "
                            f"{src!r}->{dst!r}: source {want} != "
                            f"target {got}")
                    report.digests[ns] = want
            report.verified = True
        except BaseException:
            # abort: lift fences, old map stays published — the fleet is
            # exactly where it was (the target may hold orphaned rows,
            # but no map routes to them)
            for src, nss in fenced.items():
                try:
                    await self._source_call(old_map, new_map, src,
                                            "unfence", {"ns": nss})
                except Exception:    # noqa: BLE001 — best-effort rollback
                    pass
            raise

        # PUBLISH: client first (the driving process routes new
        # immediately), then every member shard, then decommissioned
        # sources directly (they answer wrong_shard with the NEW map
        # from here on — the self-heal beacon for stale clients)
        await self._publish(old_map, new_map, fenced)

        # RELEASE after a grace period: a request that passed ownership
        # validation on a source just before publish may still be in
        # flight there; evicting under it would turn a clean reroute
        # into an unknown_namespace race
        await asyncio.sleep(self.release_grace_s)
        for src, nss in fenced.items():
            await self._source_call(old_map, new_map, src,
                                    "release_namespaces", {"ns": nss})
        return report

    async def _publish(self, old_map: ShardMap, new_map: ShardMap,
                       fenced: Dict[str, List[str]]) -> None:
        self.client.set_map(new_map)
        await self.client.update_maps()
        wire_map = new_map.to_wire()
        for sid in old_map.shard_ids():
            if sid not in new_map.shards:
                await call_direct(old_map.address_of(sid), "update_map",
                                  {"map": wire_map},
                                  timeout=self.timeout_s)
