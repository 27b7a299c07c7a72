"""The port's serving tier in-process (`repro_torch.serve`: shard, client,
replica, rebalance) against the JAX package's `repro.serve`, on the CPU.

Both packages' shards start from the same fitted posteriors: the
reference's predictors are `tests/serve_helpers.py`'s, and the port's
carry the reference's fitted base across (`repro_torch.convert`), so
their streaming states, and the float64 predictive on them, are bitwise
equal.  A reference `ServingClient` drives port shards and a port
`ServingClient` drives reference shards; the predictions (bitwise),
`predict_matrix`, acks, seqs and digest strings of each mixed tier equal
those of a reference tier fed the same operations.  Then `queue_full`,
`wrong_shard` healing, replica ship, delta and staleness, an oplog (and
checkpoint) written by either package booting a shard of the other, an
add-shard rebalance, and the predictor's write-ahead hooks.

Fixed seeds, no hypothesis; 1-3 shards of 4 tenants x 3 tasks."""
import asyncio
import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.online import OnlinePredictor as JOnline
from repro.online.events import TaskCompletion as JComp
from repro.store.frontend import QueueFullError as JQueueFull
from repro_torch import convert
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.online import OnlinePredictor as TOnline
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.store import PosteriorStore as TStore
from repro_torch.store import QueueFullError as TQueueFull
from repro_torch.store.compute import predict_stacked as tpredict
from serve_helpers import TENANTS, make_benches, make_predictor

NODES = [None, "A1", "N2", "C2"]
MATRIX_TASKS = [("bwa", 1.0), ("idx", 2.5), ("sort", 0.3), ("bwa", 7.0)]


@functools.lru_cache(maxsize=None)
def _jbase(salt: int):
    """The reference's fitted base of tenant `salt` (shared: a streaming
    predictor never writes its base)."""
    return make_predictor(salt=salt).base


@functools.lru_cache(maxsize=None)
def _tbase(salt: int):
    return convert.predictor_from_state(
        convert.predictor_state(_jbase(salt)), device="cpu")


def _tbenches():
    return {n.name: tbench(n, 1) for n in TMACHINES}


def jboot(shard_id, shard_map):
    benches = make_benches()
    return {(t, w): (JOnline(_jbase(i)), benches)
            for i, (t, w) in enumerate(TENANTS)}


def tboot(shard_id, shard_map):
    benches = _tbenches()
    return {(t, w): (TOnline(_tbase(i), device="cpu"), benches)
            for i, (t, w) in enumerate(TENANTS)}


@dataclass(frozen=True)
class Pkg:
    name: str
    serve: object
    Comp: type
    QueueFull: type
    boot: Callable
    device: dict            # what runs the predictive on the CPU


PKGS = {"repro": Pkg("repro", jserve, JComp, JQueueFull, jboot,
                     {"impl": "numpy"}),
        "repro_torch": Pkg("repro_torch", tserve, TComp, TQueueFull, tboot,
                           {"device": "cpu"})}


def _run(coro):
    return asyncio.run(coro)


def _client(pkg: Pkg, shard_map, **kw):
    """A client of `pkg` on a map that crossed the wire from the shards'
    package."""
    return pkg.serve.ServingClient(
        pkg.serve.ShardMap.from_wire(shard_map.to_wire()), **kw)


async def _boot_fleet(pkg: Pkg, n: int, tmp: str, **opts):
    sids = [f"s{i}" for i in range(n)]
    m = pkg.serve.ShardMap([pkg.serve.ShardInfo(s, "127.0.0.1", 0)
                            for s in sids])
    servers = []
    opts = {"window_s": 0.001, "ingest_window_s": 0.001, **pkg.device,
            **opts}
    for sid in sids:
        srv = pkg.serve.boot_shard(
            sid, m, pkg.boot,
            checkpoint_dir=os.path.join(tmp, sid + "_ckpt"),
            oplog_path=os.path.join(tmp, sid + ".oplog"), **opts)
        await srv.start()
        m = m.with_address(sid, "127.0.0.1", srv.port)
        servers.append(srv)
    for srv in servers:
        srv.map = m
    return servers, m


async def _close(servers, *clients):
    for c in clients:
        await c.close()
    for srv in servers:
        await srv.aclose()


def _comps(Comp, tenant_idx: int, n: int, tag: str):
    """n completions of one tenant: local and remote, every task."""
    w = TENANTS[tenant_idx][1]
    rng = np.random.default_rng(100 + tenant_idx)
    out = []
    for i in range(n):
        x = float(rng.uniform(0.2, 6.0))
        out.append(Comp(w, f"{tag}{i}", ("bwa", "idx", "sort")[i % 3],
                        ("local", "local", "N1", "C2")[i % 4], x,
                        float(4.0 + 25.0 * x + rng.normal(0, 1))))
    return out


def _batches(k: float):
    return [(t, w, [("bwa", None, 1.0 + i + k), ("idx", "C2", 2.0),
                    ("sort", "N2", 0.4 * (i + 1)), ("bwa", "A1", 3.3)])
            for i, (t, w) in enumerate(TENANTS)]


async def _script(client, Comp) -> dict:
    """The operations a tier is fed: coalesced and single predictions, a
    matrix, scalar and batched observes across every tenant (local and
    remote completions), digests, health, and the predictions again."""
    out = {"many": await client.predict_many(_batches(0.0))}
    t, w = TENANTS[0]
    out["single"] = await client.predict([("bwa", None, 1.5),
                                          ("sort", "A1", 0.25)], t, w)
    out["matrix"] = await client.predict_matrix(t, w, MATRIX_TASKS, NODES)
    acks = [await client.observe(c, t, w) for c in _comps(Comp, 0, 3, "s")]
    batch = [(c, *TENANTS[k]) for k in range(len(TENANTS))
             for c in _comps(Comp, k, 9, "b")]
    acks += await client.observe_many(batch)
    out["acks"] = acks
    out["digests"] = [await client.digest(tt, ww) for tt, ww in TENANTS]
    out["health"] = []
    for sid in client.map.shard_ids():
        h = await client.health(sid)
        out["health"].append((sid, h["seq"], h["generation"],
                              h["namespaces"], h["ingest"]))
    out["after"] = await client.predict_many(_batches(0.5))
    out["matrix_after"] = await client.predict_matrix(
        *TENANTS[2], MATRIX_TASKS, NODES)
    return out


async def _tier(shards: str, client: str, tmp: str) -> dict:
    servers, m = await _boot_fleet(PKGS[shards], 2, tmp)
    c = _client(PKGS[client], m)
    try:
        return await _script(c, PKGS[client].Comp)
    finally:
        await _close(servers, c)


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want


@pytest.fixture(scope="module")
def reference_tier(tmp_path_factory):
    return _run(_tier("repro", "repro", str(tmp_path_factory.mktemp("ref"))))


@pytest.mark.parametrize("shards,client,codec", [
    ("repro_torch", "repro", "msgpack"), ("repro", "repro_torch", "msgpack"),
    ("repro_torch", "repro_torch", "msgpack"),
    ("repro_torch", "repro", "json"), ("repro", "repro_torch", "json")])
def test_mixed_tier_matches_reference_tier(reference_tier, tmp_path,
                                           monkeypatch, shards, client,
                                           codec):
    """Under msgpack and under the JSON + base64 fallback (both packages'
    `wire` patched), against the reference tier's msgpack run."""
    if codec == "json":
        monkeypatch.setattr(jserve.wire, "msgpack", None)
        monkeypatch.setattr(tserve.wire, "msgpack", None)
    got = _run(_tier(shards, client, str(tmp_path)))
    _assert_same(got, reference_tier)


def test_port_shard_answers_bitwise_the_port_service(tmp_path):
    """A port shard's predict and predict_matrix are bitwise the port's
    own `PredictionService.predict_batch` / `predict_matrix` over a store
    holding the same posteriors."""
    async def go():
        servers, m = await _boot_fleet(PKGS["repro_torch"], 1, str(tmp_path))
        c = _client(PKGS["repro_torch"], m)
        try:
            for i, (t, w) in enumerate(TENANTS):
                svc = TService(TOnline(_tbase(i), device="cpu"), _tbenches(),
                               store=TStore(), tenant=t, workflow=w,
                               device="cpu")
                qs = _batches(0.0)[i][2]
                _assert_same(await c.predict(qs, t, w), svc.predict_batch(
                    [TQuery(*q) for q in qs]))
                _assert_same(await c.predict_matrix(t, w, MATRIX_TASKS,
                                                    NODES),
                             svc.predict_matrix(MATRIX_TASKS, NODES))
        finally:
            await _close(servers, c)
    _run(go())


@pytest.mark.parametrize("client", ["repro", "repro_torch"])
def test_queue_full_round_trips_to_either_client(client):
    async def go():
        m = tserve.ShardMap([tserve.ShardInfo("s0", "127.0.0.1", 0)])
        srv = tserve.ShardServer("s0", m, window_s=0.5,
                                 max_pending_batches=1, device="cpu")
        (t, w), spec = next(iter(tboot("s0", m).items()))
        srv.store.bind(t, w, *spec)
        await srv.start()
        srv.map = m = m.with_address("s0", "127.0.0.1", srv.port)
        pkg = PKGS[client]
        c = _client(pkg, m, retry=pkg.serve.RetryPolicy(
            max_attempts=2, base_backoff_s=0.01))
        try:
            qs = [("bwa", None, 1.0)]
            first = asyncio.ensure_future(c.predict(qs, t, w))
            await asyncio.sleep(0.05)
            with pytest.raises(pkg.QueueFull):
                await asyncio.gather(*[c.predict(qs, t, w)
                                       for _ in range(4)])
            assert (await first).shape == (1, 3)
        finally:
            await _close([srv], c)
    _run(go())


@pytest.mark.parametrize("client", ["repro", "repro_torch"])
def test_stale_client_map_heals_from_wrong_shard(tmp_path, client):
    async def go():
        pkg = PKGS[client]
        grown = tserve.ShardMap([tserve.ShardInfo("s0", "127.0.0.1", 0)]) \
            .with_shard("s1", "127.0.0.1", 0)
        servers = []
        for sid in ("s0", "s1"):
            srv = tserve.boot_shard(
                sid, grown, tboot, window_s=0.001, device="cpu",
                oplog_path=os.path.join(str(tmp_path), sid + ".oplog"))
            await srv.start()
            grown = grown.with_address(sid, "127.0.0.1", srv.port)
            servers.append(srv)
        for srv in servers:
            srv.map = grown
        moved = [(t, w) for t, w in TENANTS
                 if grown.shard_for(f"{t}/{w}") == "s1"]
        assert moved
        stale = pkg.serve.ShardMap([pkg.serve.ShardInfo(
            "s0", *grown.address_of("s0"))])
        c = pkg.serve.ServingClient(stale)
        try:
            t, w = moved[0]
            out = await c.predict([("bwa", None, 2.0)], t, w)
            assert out.shape == (1, 3)
            assert c.map.version == grown.version
            assert c.map.shard_for(f"{t}/{w}") == "s1"
            seqs = await c.observe_many(
                [(x, t, w) for x in _comps(pkg.Comp, 0, 2, "h")])
            assert seqs == [1, 2]
        finally:
            await _close(servers, c)
    _run(go())


def test_replica_ship_delta_and_staleness(tmp_path):
    """A port primary ships to a port replica and a reference replica in
    one round: the bootstrap installs every block (the shipper records
    its install frame's bytes), the delta after one ingest only the
    moved block, `predict_base` on each is bitwise the primary's
    predictive, digests equal the primary's, and a read past
    `max_generation_lag` raises each client's `ReplicaStaleError`."""
    async def go():
        store = TStore(block_size=2)
        preds = {}
        for i, ((t, w), (pred, b)) in enumerate(tboot("s0", None).items()):
            if i < 2:
                store.bind(t, w, pred, b)
                preds[(t, w)] = pred
        tr = await tserve.ReplicaServer(device="cpu",
                                        max_generation_lag=1).start()
        jr = await jserve.ReplicaServer(impl="numpy").start()
        addrs = [("127.0.0.1", tr.port), ("127.0.0.1", jr.port)]
        shipper = tserve.ReplicaShipper(store, addrs)
        (t, w), pred = next(iter(preds.items()))
        binding = store.binding(t, w)
        keys = [k for b in store.bindings() for k in
                (b.key_str(n) for n in ("bwa", "idx", "sort"))]
        x = np.linspace(0.1, 5.0, len(keys))

        def primary():
            mean, std = tpredict(x, store.gather(keys), device="cpu")
            return np.stack([mean, mean - 1.96 * std, mean + 1.96 * std],
                            axis=1).astype(np.float32)

        async def check_reads():
            for addr in addrs:
                for pkg in PKGS.values():
                    c = pkg.serve.ServingClient(pkg.serve.ShardMap(
                        [pkg.serve.ShardInfo("s0", "h", 1)]))
                    _assert_same(await c.predict_base(addr, keys, x),
                                 primary())
                    await c.close()
                for ns, p in preds.items():
                    d = await tserve.call_direct(addr, "digest",
                                                 {"ns": "/".join(ns)})
                    assert d["sha256"] == tserve.state_digest(p)

        try:
            n_blocks = store.num_blocks
            assert n_blocks == 3
            assert await shipper.ship_once() == [n_blocks, n_blocks]
            boot = tserve.wire.frame({"i": 1, "op": "install_snapshot",
                                      "s": store.export_blocks(-1)})
            assert shipper.frame_bytes == {a: len(boot) for a in addrs}
            await check_reads()
            pred.observe_many(_comps(TComp, 0, 4, "d")[:2])   # local: bwa,
            binding.sync()                                    # idx: 1 block
            assert await shipper.ship_once() == [1, 1]
            assert shipper.ship_errors == 0 and tr.installs == 2
            await check_reads()
            # two generations past the last ship: a mark tells the replica
            for i in range(2):
                pred.observe(_comps(TComp, 0, 1, f"g{i}")[0])
                binding.sync()
            await tserve.call_direct(addrs[0], "mark",
                                     {"g": store.generation})
            for pkg in PKGS.values():
                c = pkg.serve.ServingClient(pkg.serve.ShardMap(
                    [pkg.serve.ShardInfo("s0", "h", 1)]))
                with pytest.raises(pkg.serve.ReplicaStaleError) as ei:
                    await c.predict_base(addrs[0], keys, x)
                assert ei.value.lag == 2 and ei.value.bound == 1
                await c.close()
            await shipper.ship_once()
            await check_reads()
            assert shipper.lags() == {a: 0 for a in addrs}
            with pytest.raises(tserve.RemoteError, match="read_only"):
                await tserve.call_direct(addrs[0], "observe", {})
        finally:
            await tr.aclose()
            await jr.aclose()
    _run(go())


@pytest.mark.parametrize("checkpoint", [True, False])
@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_oplog_of_either_package_boots_the_other(tmp_path, writer, reader,
                                                 checkpoint):
    """A shard of `writer` acks observations (a checkpoint midway, when
    asked), closes; a shard of `reader` boots on the same checkpoint and
    oplog: it restores, replays exactly the tail past the watermark, and
    its digests and predictions equal the writer's.  Its acks continue
    the writer's sequence."""
    tmp = str(tmp_path)

    async def write():
        servers, m = await _boot_fleet(PKGS[writer], 1, tmp)
        c = _client(PKGS[writer], m)
        try:
            t, w = TENANTS[0]
            pre = [await c.observe(x, t, w)
                   for x in _comps(PKGS[writer].Comp, 0, 4, "p")]
            if checkpoint:
                assert (await c.checkpoint("s0"))["seq"] == pre[-1]
            tail = await c.observe_many(
                [(x, *TENANTS[k]) for k in (0, 1, 3)
                 for x in _comps(PKGS[writer].Comp, k, 5, "q")])
            assert pre + tail == list(range(1, 20))
            return ([await c.digest(tt, ww) for tt, ww in TENANTS],
                    await c.predict_many(_batches(0.25)), m)
        finally:
            await _close(servers, c)

    async def read(m):
        pkg = PKGS[reader]
        srv = pkg.serve.boot_shard(
            "s0", pkg.serve.ShardMap.from_wire(m.to_wire()), pkg.boot,
            checkpoint_dir=os.path.join(tmp, "s0_ckpt"),
            oplog_path=os.path.join(tmp, "s0.oplog"), window_s=0.001,
            ingest_window_s=0.001, **pkg.device)
        await srv.start()
        srv.map = srv.map.with_address("s0", "127.0.0.1", srv.port)
        c = _client(pkg, srv.map)
        try:
            assert srv.replayed == (15 if checkpoint else 19)
            digests = [pkg.serve.state_digest(
                srv.store.binding(t, w).predictor) for t, w in TENANTS]
            out = (srv.replayed, digests,
                   [await c.digest(t, w) for t, w in TENANTS],
                   await c.predict_many(_batches(0.25)))
            t, w = TENANTS[2]
            assert await c.observe(_comps(pkg.Comp, 2, 1, "r")[0], t, w) \
                == 20
            return out
        finally:
            await _close([srv], c)

    digests, preds, m = _run(write())
    _, local, remote, after = _run(read(m))
    assert local == remote == digests
    _assert_same(after, preds)


def _rebalance(pkg_name: str, tmp: str) -> dict:
    os.makedirs(tmp)

    async def go():
        pkg = PKGS[pkg_name]
        servers, m = await _boot_fleet(pkg, 2, tmp)
        c = _client(pkg, m)
        try:
            for k, (t, w) in enumerate(TENANTS):
                await c.observe_many([(x, t, w) for x in
                                      _comps(pkg.Comp, k, 5, "u")])
            before = [await c.digest(t, w) for t, w in TENANTS]
            preds = await c.predict_many(_batches(0.0))
            s2 = pkg.serve.boot_shard(
                "s2", c.map, pkg.boot,
                checkpoint_dir=os.path.join(tmp, "s2_ckpt"),
                oplog_path=os.path.join(tmp, "s2.oplog"), window_s=0.001,
                ingest_window_s=0.001, **pkg.device)
            await s2.start()
            servers.append(s2)
            report = await pkg.serve.RebalanceCoordinator(
                c, release_grace_s=0.02).add_shard("s2", "127.0.0.1",
                                                   s2.port)
            after = [await c.digest(t, w) for t, w in TENANTS]
            preds_after = await c.predict_many(_batches(0.0))
            t, w = next((t, w) for t, w in TENANTS
                        if f"{t}/{w}" in report.moved)
            seq = await c.observe(_comps(pkg.Comp, 0, 1, "z")[0], t, w)
            return {"verified": report.verified, "moved": report.moved,
                    "rows": report.rows_shipped, "fence": report.fence_seqs,
                    "digests": report.digests, "before": before,
                    "after": after, "preds": preds,
                    "preds_after": preds_after,
                    "seq": (seq, s2.applied_seq),
                    "released": [sorted(s.store.namespaces())
                                 for s in servers[:2]]}
        finally:
            await _close(servers, c)
    return _run(go())


def test_add_shard_rebalance_matches_reference(tmp_path):
    got = _rebalance("repro_torch", str(tmp_path / "t"))
    want = _rebalance("repro", str(tmp_path / "j"))
    assert got["verified"] and got["moved"]
    assert got["after"] == got["before"]
    assert got["seq"][0] == got["seq"][1]
    _assert_same(got["preds_after"], got["preds"])
    _assert_same(got, want)


# --- the predictor's write-ahead hooks ------------------------------------------
def _hooked(pkg: str, mode: str) -> dict:
    """Feed a fresh predictor of `pkg` through its hooks: what each hook
    call saw (the state before the update), the final state and the
    counters; with mode "raise" every hook raises."""
    pred = (JOnline(_jbase(0), benches=make_benches()) if pkg == "repro"
            else TOnline(_tbase(0), benches=_tbenches(), device="cpu"))
    Comp = PKGS[pkg].Comp
    seen = []

    def hook(comp):
        seen.append(("one", comp.uid, pred._export_state()))
        if mode == "raise":
            raise OSError("log device full")

    def hook_many(comps):
        seen.append(("many", [c.uid for c in comps], pred._export_state()))
        if mode == "raise":
            raise OSError("log device full")

    pred.observe_log = hook
    if mode != "scalar_only":
        pred.observe_log_many = hook_many
    before = pred._export_state()
    comps = _comps(Comp, 0, 8, "w")
    errors = 0
    for c in comps[:3]:
        try:
            pred.observe(c)
        except OSError:
            errors += 1
    try:
        pred.observe_many(comps[3:])
    except OSError:
        errors += 1
    return {"seen": seen, "before": before, "after": pred._export_state(),
            "ingest": dataclasses.asdict(pred.ingest), "errors": errors,
            "version": pred.version}


@pytest.mark.parametrize("mode", ["both", "scalar_only", "raise"])
def test_write_ahead_hooks_match_reference(mode):
    got, want = _hooked("repro_torch", mode), _hooked("repro", mode)
    assert got == want
    n_calls = 8 if mode == "scalar_only" else 4
    assert len(got["seen"]) == (4 if mode == "raise" else n_calls)
    # each hook saw the state from before its own update: the first saw
    # the untouched state, and no later one saw the final state
    assert got["seen"][0][2] == got["before"]
    if mode == "raise":
        assert got["errors"] == 4
        assert got["after"] == got["before"]
        assert all(s[2] == got["before"] for s in got["seen"])
        assert got["ingest"]["records"] == 8
    else:
        assert got["errors"] == 0 and got["after"] != got["before"]
        assert all(s[2] != got["after"] for s in got["seen"])
