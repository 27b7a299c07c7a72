"""Distributed serving plane: sharded PosteriorStore RPC tier (the port).

The same tier as the reference package's `repro.serve`, over the port's
store: frames are byte for byte the reference's (a client of either
package drives a shard of the other), oplogs and checkpoints replay in
either, and the shards' predictive, ingest fold and refresh run on the
shard's `device` ("cuda" by default: `bayes_predict`, `nig_fold` and
`bayes_fit`; "cpu" their plain versions).

  placement — consistent-hash tenant->shard placement, versioned ShardMap
  wire      — length-prefixed msgpack framing (sockets, oplog, snapshots)
  shard     — the shard server process (store slice + frontend + refresher)
  client    — fan-out ServingClient (routing, coalescing, retries,
              backpressure propagation)
  replica   — COW-snapshot shipping to read replicas, staleness-bounded
              replica reads (max_generation_lag)
  failover  — OpLog write-ahead durability + ShardSupervisor warm
              failover + HealthMonitor restart loop
  rebalance — live resharding coordinator (fence -> ship -> verify ->
              publish -> release, zero lost acked observations)
"""
from repro_torch.serve.client import (MigratingError, PartialObserveError,
                                      RemoteError, ReplicaStaleError,
                                      RetryPolicy, ServingClient,
                                      TransportError, WrongShardError,
                                      call_direct)
from repro_torch.serve.failover import (HealthMonitor, HealthPolicy, OpLog,
                                        ShardSpec, ShardSupervisor, shard_rpc)
from repro_torch.serve.placement import ShardInfo, ShardMap, stable_hash
from repro_torch.serve.rebalance import (RebalanceCoordinator, RebalanceError,
                                         RebalanceReport)
from repro_torch.serve.replica import (ReplicaServer, ReplicaShipper,
                                       StaleReplicaError)
from repro_torch.serve.shard import (RpcError, ShardMeta, ShardServer,
                                     boot_shard, state_digest)
from repro_torch.serve.wire import (MAX_FRAME, FrameTooLarge, TruncatedFrame,
                                    WireError)

__all__ = [
    "MAX_FRAME", "FrameTooLarge", "HealthMonitor", "HealthPolicy",
    "MigratingError", "OpLog", "PartialObserveError",
    "RebalanceCoordinator", "RebalanceError", "RebalanceReport",
    "RemoteError", "ReplicaServer", "ReplicaShipper", "ReplicaStaleError",
    "RetryPolicy", "RpcError", "ServingClient", "ShardInfo", "ShardMap",
    "ShardMeta", "ShardServer", "ShardSpec", "ShardSupervisor",
    "StaleReplicaError", "TransportError", "TruncatedFrame", "WireError",
    "WrongShardError", "boot_shard", "call_direct", "shard_rpc",
    "stable_hash", "state_digest",
]
