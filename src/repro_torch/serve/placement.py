"""Consistent-hash tenant->shard placement with a versioned shard map.

A namespace (`tenant/workflow`) lives wholly on ONE shard — every posterior
row, its oplog records, and its checkpointed streaming state — so a
predict/observe never spans processes.  Placement is a consistent-hash
ring (blake2b, stable across processes and Python runs, unlike `hash()`)
with virtual nodes, so adding or removing a shard moves ~1/n of the
namespaces and leaves everything else in place.

The map is immutable and versioned: rebalance operations (`with_shard`,
`without_shard`) and failover readmission (`with_address` — same shard id,
new port, ring untouched, so NOTHING moves) return a *new* map with a
bumped version.  Clients send their map version with every request; a
shard that does not own the namespace under its own map answers
`wrong_shard` carrying its map, and the client adopts whichever is newer
and re-routes — rebalance-aware lookup without a coordination service.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

VNODES = 64          # virtual nodes per shard: placement spread within ~10%


def stable_hash(s: str) -> int:
    """64-bit stable string hash (process-independent, unlike hash())."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


@dataclass(frozen=True)
class ShardInfo:
    shard_id: str
    host: str
    port: int

    @property
    def address(self) -> Tuple[str, int]:
        return self.host, self.port


class ShardMap:
    """Immutable versioned shard membership + addresses + hash ring."""

    def __init__(self, shards: Iterable[ShardInfo], version: int = 1,
                 vnodes: int = VNODES):
        self.shards: Dict[str, ShardInfo] = {s.shard_id: s for s in shards}
        if not self.shards:
            raise ValueError("a shard map needs at least one shard")
        self.version = int(version)
        self.vnodes = int(vnodes)
        ring: List[Tuple[int, str]] = []
        for sid in self.shards:
            ring.extend((stable_hash(f"{sid}#{i}"), sid)
                        for i in range(self.vnodes))
        ring.sort()
        self._ring = ring
        self._ring_hashes = [h for h, _ in ring]

    # ---- lookup -------------------------------------------------------------
    def shard_for(self, namespace: str) -> str:
        """Owning shard id of `tenant/workflow` (first ring point at or
        after the namespace hash, wrapping)."""
        i = bisect.bisect_left(self._ring_hashes, stable_hash(namespace))
        return self._ring[i % len(self._ring)][1]

    def address_of(self, shard_id: str) -> Tuple[str, int]:
        return self.shards[shard_id].address

    def shard_ids(self) -> List[str]:
        return sorted(self.shards)

    # ---- rebalance / failover (new map, version + 1) ------------------------
    def with_shard(self, shard_id: str, host: str, port: int) -> "ShardMap":
        """Add a shard (or move an existing one's address).  Adding a new
        id rebuilds the ring — ~1/n of namespaces move to it."""
        shards = dict(self.shards)
        shards[shard_id] = ShardInfo(shard_id, host, port)
        return ShardMap(shards.values(), self.version + 1, self.vnodes)

    def without_shard(self, shard_id: str) -> "ShardMap":
        if shard_id not in self.shards:
            raise KeyError(f"cannot remove unknown shard {shard_id!r}; "
                           f"known shards: {sorted(self.shards)}")
        if len(self.shards) == 1:
            raise ValueError(
                f"cannot remove {shard_id!r}: it is the last shard, and an "
                f"empty map cannot route any namespace (decommission by "
                f"adding a replacement shard first)")
        shards = dict(self.shards)
        del shards[shard_id]
        return ShardMap(shards.values(), self.version + 1, self.vnodes)

    def with_address(self, shard_id: str, host: str, port: int) -> "ShardMap":
        """Failover readmission: same shard id at a new address.  The ring
        depends only on shard ids, so placement is untouched — no namespace
        moves, only the route."""
        if shard_id not in self.shards:
            raise KeyError(shard_id)
        return self.with_shard(shard_id, host, port)

    def moved(self, newer: "ShardMap", namespaces: Sequence[str]
              ) -> List[str]:
        """Namespaces whose owner differs between this map and `newer` —
        what a rebalance actually has to migrate."""
        return [ns for ns in namespaces
                if self.shard_for(ns) != newer.shard_for(ns)]

    # ---- wire representation ------------------------------------------------
    def to_wire(self) -> dict:
        return {"version": self.version, "vnodes": self.vnodes,
                "shards": [[s.shard_id, s.host, s.port]
                           for s in self.shards.values()]}

    @classmethod
    def from_wire(cls, d: Mapping) -> "ShardMap":
        return cls([ShardInfo(sid, host, int(port))
                    for sid, host, port in d["shards"]],
                   version=int(d["version"]), vnodes=int(d["vnodes"]))
