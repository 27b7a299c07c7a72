"""The port's store durability and shipping (`repro_torch.store.posterior`:
save / restore / resume, incremental saves, `keep_last` retention,
`export_blocks` / `import_blocks`, `export_namespaces` /
`import_namespaces`) against the JAX package's, on the CPU.

Each reference behaviour (tests/test_store.py, tests/test_refresh.py,
tests/test_resharding.py) runs on the port at small size, and where the
scenario is the same in both packages the port's answers are held bitwise
against the reference's: the port's predictors carry the reference's
fitted posteriors (`repro_torch.convert`), and the float64 predictive is
bitwise in both (`predict_blr_np` and the port's plain `bayes_predict`).
Then the cross-package cases: a checkpoint or an `export_blocks` payload
written by one package installs in the other, and a resident
`FusedPlane` over a restored, imported or migrated store re-predicts every
row on its first round and none on a warm one.

Fixed seeds; two or three tenants, block sizes 2-8."""
import functools
import json
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import pytest

from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.core.traces import TraceRow as JTrace
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online.events import PredictionQuery as JQuery
from repro.online.events import TaskCompletion as JComp
from repro.sched.cluster import LOCAL as JLOCAL
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.store import PosteriorStore as JStore
from repro_torch import convert
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.online import OnlinePredictor as TOnline
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.sched.fused import FusedPlane
from repro_torch.store import PosteriorStore as TStore
from repro_torch.store import TaskKey
from repro_torch.store import posterior as tposterior

TASKS = ("bwa", "idx", "merge")
NODES = (None, "N1", "N2", "C2")


@functools.lru_cache(maxsize=None)
def _jfit(tasks=TASKS, salt=0.0):
    """The reference's fitted base predictor (shared: a streaming
    predictor never writes its base)."""
    lot = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    rows = []
    for j, t in enumerate(tasks):
        rows += [JTrace("wf", t, "local", s, 2.0 + j + (20.0 + 7 * j + salt)
                        * s) for s in np.linspace(0.05, 0.4, 6)]
    return lot.fit(rows)


@dataclass(frozen=True)
class Pkg:
    """One package's store, streaming predictor and service, built over
    the same fitted posteriors."""
    name: str
    Store: type
    Query: type
    Comp: type
    online: Callable
    service: Callable
    benches: Callable


JPKG = Pkg("repro", JStore, JQuery, JComp,
           lambda tasks=TASKS, salt=0.0: JOnline(_jfit(tasks, salt),
                                                 benches=_jbenches()),
           lambda pred, store, tenant, workflow="w": JService(
               pred, _jbenches(), store=store, tenant=tenant,
               workflow=workflow),
           lambda: _jbenches())
TPKG = Pkg("repro_torch", TStore, TQuery, TComp,
           lambda tasks=TASKS, salt=0.0: TOnline(
               convert.predictor_from_state(
                   convert.predictor_state(_jfit(tasks, salt)),
                   device="cpu"),
               benches=_tbenches(), device="cpu"),
           lambda pred, store, tenant, workflow="w": TService(
               pred, _tbenches(), store=store, tenant=tenant,
               workflow=workflow, device="cpu"),
           lambda: _tbenches())
PKGS = {"repro": JPKG, "repro_torch": TPKG}


def _jbenches():
    return {n.name: jbench(n, 1) for n in JMACHINES}


def _tbenches():
    return {n.name: tbench(n, 1) for n in TMACHINES}


def _stream(seed, tasks=TASKS, n=20, nodes=("local", "N1", "C2", "N2")):
    """(task, node, x, runtime) completions, local and remote."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = float(rng.uniform(0.5, 6.0))
        out.append((tasks[i % len(tasks)], nodes[i % len(nodes)], x,
                    float(5 + 25 * x + rng.normal(0, 1))))
    return out


def _feed(pkg, pred, stream, tag="u"):
    for i, (task, node, x, y) in enumerate(stream):
        pred.observe(pkg.Comp("wf", f"{tag}{i}", task, node, x, y))


def _queries(pkg, tasks=TASKS, nodes=NODES, xs=(0.2, 1.0, 4.0)):
    return [pkg.Query(t, n, x) for t in tasks for n in nodes for x in xs]


def _warm(pkg, store, tenant, tasks=TASKS, seed=3, workflow="w", salt=0.0):
    """A warm OnlinePredictor bound to `store` through a service."""
    pred = pkg.online(tasks, salt)
    svc = pkg.service(pred, store, tenant, workflow)
    _feed(pkg, pred, _stream(seed, tasks))
    svc.predict_batch([pkg.Query(tasks[0], None, 1.0)])
    return pred, svc


def _resumed(pkg, store, tenant, tasks=TASKS, workflow="w", salt=0.0):
    """A fresh predictor resumed on `store`'s checkpointed namespace and
    its service."""
    pred = pkg.online(tasks, salt)
    store.resume(tenant, workflow, pred, pkg.benches())
    return pred, pkg.service(pred, store, tenant, workflow)


def _both(fn):
    """fn(pkg) for the reference, then for the port."""
    return fn(JPKG), fn(TPKG)


def _gathers_equal(a, b, keys):
    ga, gb = a.gather(keys), b.gather(keys)
    assert set(ga) == set(gb)
    for leaf in ga:
        assert ga[leaf].dtype == gb[leaf].dtype == np.float64
        assert np.array_equal(ga[leaf], gb[leaf]), leaf


# --- save / restore / resume ----------------------------------------------------

def test_checkpoint_roundtrip_bitwise(tmp_path):
    """save -> fresh predictor -> restore + resume: predictions bitwise the
    pre-restart ones (and the reference's), and the resumed predictor keeps
    learning identically."""
    def run(pkg):
        path = str(tmp_path / pkg.name)
        store = pkg.Store()
        online, svc = _warm(pkg, store, "acme", workflow="rnaseq")
        qs = _queries(pkg)
        before = svc.predict_batch(qs)
        store.save(path)
        restored = pkg.Store.restore(path)
        online2, svc2 = _resumed(pkg, restored, "acme", workflow="rnaseq")
        after = svc2.predict_batch(qs)
        comp = pkg.Comp("wf", "u99", "bwa", "local", 3.0, 123.0)
        online.observe(comp)
        online2.observe(comp)
        return before, after, svc.predict_batch(qs), svc2.predict_batch(qs), \
            online2.export_state()
    j, t = _both(run)
    np.testing.assert_array_equal(t[1], t[0])
    np.testing.assert_array_equal(t[3], t[2])
    for got, want in zip(t[:4], j[:4]):
        np.testing.assert_array_equal(got, want)
    assert t[4] == j[4]


def test_checkpoint_restores_node_corrections(tmp_path):
    store = TStore()
    online, _ = _warm(TPKG, store, "t")
    store.save(str(tmp_path / "c"))
    online2, _ = _resumed(TPKG, TStore.restore(str(tmp_path / "c")), "t")
    assert set(online2.node_stats) == set(online.node_stats)
    for node, stats in online.node_stats.items():
        assert online2.node_stats[node].correction == stats.correction
        assert online2.node_stats[node].logs_by_task == stats.logs_by_task


def test_resume_restacks_every_row_in_one_generation(tmp_path):
    """bind(sync=False): the first predict after resume rewrites every row
    of the namespace in one put_many, and the rows come out bitwise the
    checkpoint's."""
    store = TStore(block_size=2)
    _warm(TPKG, store, "t")
    keys = store.task_keys()
    path = str(tmp_path / "c")
    store.save(path)
    restored = TStore.restore(path)
    saved = restored.gather(keys)
    gen = restored.generation
    _, svc = _resumed(TPKG, restored, "t")
    assert restored.generation == gen        # bind(sync=False): nothing yet
    svc.predict_batch([TQuery("bwa", None, 1.0)])
    assert restored.generation == gen + 1    # one put_many for every row
    assert set(restored._block_gen.values()) == {gen + 1}
    got = restored.gather(keys)
    for leaf in saved:
        assert np.array_equal(got[leaf], saved[leaf]), leaf


def test_save_preserves_unresumed_namespace_state(tmp_path):
    """restore two tenants, resume one, save again: the unresumed tenant's
    checkpointed streaming state survives the second save."""
    store = TStore()
    _warm(TPKG, store, "a", seed=3)
    online_b, _ = _warm(TPKG, store, "b", seed=4)
    store.save(str(tmp_path / "c1"))
    r1 = TStore.restore(str(tmp_path / "c1"))
    _resumed(TPKG, r1, "a")
    r1.save(str(tmp_path / "c2"))
    online_b2, _ = _resumed(TPKG, TStore.restore(str(tmp_path / "c2")), "b")
    assert online_b2.export_state() == online_b.export_state()


def test_save_with_pending_dirty_rows_checkpoints_consistently(tmp_path):
    """observe() -> save() with no predict between: the checkpoint holds
    the post-observe rows and resume serves them (as the reference's)."""
    def run(pkg):
        store = pkg.Store()
        online = pkg.online(("bwa", "idx"))
        svc = pkg.service(online, store, "t")
        q = _queries(pkg, ("bwa",), (None, "N1"))
        svc.predict_batch(q)
        online.observe(pkg.Comp("wf", "u0", "bwa", "local", 2.0, 500.0))
        path = str(tmp_path / pkg.name)
        store.save(path)                     # the dirty row not yet synced
        expected = svc.predict_batch(q)
        _, svc2 = _resumed(pkg, pkg.Store.restore(path), "t", ("bwa", "idx"))
        return expected, svc2.predict_batch(q)
    j, t = _both(run)
    np.testing.assert_array_equal(t[1], t[0])
    np.testing.assert_array_equal(t[0], j[0])


def test_restore_sparse_external_manifest_no_row_aliasing(tmp_path):
    """a hand-written manifest with row gaps restores without aliasing
    (new keys get rows beyond the largest restored index) and duplicate
    row ids are refused."""
    store = TStore(block_size=4)
    pred = TPKG.online(("bwa",))
    store.bind("t", "w", pred)
    path = str(tmp_path / "c")
    store.save(path)
    man_path = os.path.join(path, "manifest.json")
    with open(man_path) as f:
        manifest = json.load(f)
    manifest["rows"] = {"t/w/bwa": 0, "t/w/far": 6}      # gap + 2nd block
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    restored = TStore.restore(path)
    assert restored.get("t/w/bwa")["mu"].shape == (2,)
    assert restored.num_blocks == 2
    restored.put(TaskKey("t", "w", "new1"), pred.export_posterior("bwa"))
    rows = {k: restored.snapshot().row_of(k) for k in restored.task_keys()}
    assert len(set(rows.values())) == len(rows)
    assert rows["t/w/new1"] > 6
    manifest["rows"] = {"t/w/a": 1, "t/w/b": 1}
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="unique"):
        TStore.restore(path)


def test_format1_checkpoint_and_missing_live_block(tmp_path):
    """The read-only format-1 layout (one blocks.npz) restores as the
    reference restores it; a format-2 checkpoint missing a block file that
    holds live rows restores it as a fresh block, and resume repairs its
    rows bitwise."""
    store = TStore(block_size=2)
    _warm(TPKG, store, "t")
    keys = store.task_keys()
    path = str(tmp_path / "v1")
    os.makedirs(path)
    arrs = {f"b{i}__{leaf}": blk[leaf] for i, blk in enumerate(store._blocks)
            for leaf in blk}
    del arrs["b1__y_sd"]                     # a leaf absent: unit default
    np.savez(os.path.join(path, "blocks.npz"), **arrs)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"format": 1, "block_size": 2, "generation": 7,
                   "n_blocks": store.num_blocks, "rows": store._rows,
                   "namespaces": {}}, f)
    restored = [cls.restore(path) for cls in (JStore, TStore)]
    _gathers_equal(restored[0], restored[1], keys)
    assert restored[1].generation == 7 and restored[1]._block_gen == {}

    path2 = str(tmp_path / "v2")
    store.save(path2)
    want = store.gather(keys)
    os.remove(os.path.join(path2, "block_1.npz"))
    torn = TStore.restore(path2)
    assert not np.array_equal(torn.gather(keys)["mu"], want["mu"])
    _gathers_equal(JStore.restore(path2), torn, keys)
    _, svc = _resumed(TPKG, torn, "t")
    svc.predict_batch([TQuery("bwa", None, 1.0)])
    got = torn.gather(keys)
    for leaf in want:
        assert np.array_equal(got[leaf], want[leaf]), leaf


def test_checkpoint_files_mean_what_the_reference_writes(tmp_path):
    """The same warm state saved by both packages: the same file names,
    the same manifest (save_id aside), and each block's npz the same keys
    and float64 arrays bitwise."""
    def run(pkg):
        store = pkg.Store(block_size=2)
        _warm(pkg, store, "a", seed=3)
        _warm(pkg, store, "b", ("bwa", "idx"), seed=5)
        store.evict("a", "w")
        _warm(pkg, store, "c", ("merge",), seed=6)
        path = str(tmp_path / pkg.name)
        store.save(path)
        return path
    jp, tp = _both(run)
    assert sorted(os.listdir(jp)) == sorted(os.listdir(tp))
    man = []
    for p in (jp, tp):
        with open(os.path.join(p, "manifest.json")) as f:
            m = json.load(f)
        assert isinstance(m.pop("save_id"), str)
        man.append(m)
    assert man[1] == man[0]
    assert sorted(man[1]) == ["block_gen", "block_size", "format",
                              "generation", "n_blocks", "namespaces", "rows"]
    for f in os.listdir(jp):
        if f.endswith(".npz"):
            with np.load(os.path.join(jp, f)) as a, \
                    np.load(os.path.join(tp, f)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert b[k].dtype == np.float64
                    assert np.array_equal(a[k], b[k]), (f, k)


# --- incremental saves -------------------------------------------------------

def test_incremental_save_writes_only_rewritten_blocks(tmp_path):
    tasks = ("a0", "a1", "a2", "a3")
    def run(pkg):
        store = pkg.Store(block_size=2)
        online, svc = _warm(pkg, store, "t", tasks)
        path = str(tmp_path / pkg.name)
        store.save(path)
        full = sorted(store.last_checkpoint_blocks)
        online.observe(pkg.Comp("wf", "u", "a0", "local", 2.0, 77.0))
        svc.predict_batch([pkg.Query("a0", None, 1.0)])
        row = store.snapshot().row_of("t/w/a0")
        store.save(path, incremental=True)
        delta = store.last_checkpoint_blocks
        _, svc2 = _resumed(pkg, pkg.Store.restore(path), "t", tasks)
        qs = [pkg.Query(t, None, 1.5) for t in tasks]
        return full, delta, row, svc.predict_batch(qs), svc2.predict_batch(qs)
    j, t = _both(run)
    assert t[0] == [0, 1] and t[1] == [t[2] // 2]
    assert t[:3] == j[:3]
    np.testing.assert_array_equal(t[4], t[3])
    np.testing.assert_array_equal(t[4], j[4])


def test_incremental_save_requires_existing_checkpoint(tmp_path):
    store = TStore()
    store.bind("t", "w", TPKG.online(("bwa",)))
    with pytest.raises(FileNotFoundError, match="full save first"):
        store.save(str(tmp_path / "nope"), incremental=True)


def test_incremental_save_refuses_foreign_checkpoint(tmp_path):
    """only the store that wrote (or restored) a checkpoint may extend it;
    a restored store may."""
    path = str(tmp_path / "c")
    store_a = TStore()
    _warm(TPKG, store_a, "t", ("bwa",))
    store_a.save(path)
    store_b = TStore()
    _warm(TPKG, store_b, "t", ("bwa",))
    with pytest.raises(ValueError, match="diverged"):
        store_b.save(path, incremental=True)
    restored = TStore.restore(path)
    online, _ = _resumed(TPKG, restored, "t", ("bwa",))
    online.observe(TComp("wf", "u", "bwa", "local", 2.0, 50.0))
    restored.save(path, incremental=True)
    assert TStore.restore(path).generation == restored.generation


def test_evicted_block_file_removed_on_incremental_save(tmp_path):
    store = TStore(block_size=2)
    _warm(TPKG, store, "a", ("a0", "a1"))          # rows 0-1: block 0
    _warm(TPKG, store, "b", ("b0", "b1"))          # rows 2-3: block 1
    path = str(tmp_path / "c")
    store.save(path)
    assert os.path.exists(os.path.join(path, "block_0.npz"))
    store.evict("a", "w")
    store.save(path, incremental=True)
    assert not os.path.exists(os.path.join(path, "block_0.npz"))
    assert os.path.exists(os.path.join(path, "block_1.npz"))
    restored = TStore.restore(path)
    assert restored.num_free_blocks == 1
    assert restored.get(TaskKey("b", "w", "b0"))["mu"].shape == (2,)
    with pytest.raises(KeyError):
        restored.snapshot().row_of(TaskKey("a", "w", "a0"))


def test_evict_drops_the_namespace_saved_state(tmp_path):
    """A restored namespace that is evicted before it is resumed is not
    written into the next checkpoint."""
    store = TStore()
    _warm(TPKG, store, "a")
    _warm(TPKG, store, "b", seed=4)
    store.save(str(tmp_path / "c1"))
    restored = TStore.restore(str(tmp_path / "c1"))
    assert set(restored._saved_states) == {"a/w", "b/w"}
    restored.evict("a", "w")
    assert set(restored._saved_states) == {"b/w"}
    restored.save(str(tmp_path / "c2"))
    with open(os.path.join(str(tmp_path / "c2"), "manifest.json")) as f:
        assert set(json.load(f)["namespaces"]) == {"b/w"}


# --- keep_last retention -----------------------------------------------------

def test_save_keep_last_retains_and_restores_old_generations(tmp_path):
    store = TStore(block_size=2)
    online, svc = _warm(TPKG, store, "t", ("a0", "a1", "a2", "a3"))
    path = str(tmp_path / "ckpt")
    store.save(path, keep_last=2)
    g1 = store.generation
    mu_old = store.get(TaskKey("t", "w", "a0"))["mu"].copy()
    q_old = svc.predict_batch([TQuery("a0", None, 1.0)])
    online.observe(TComp("wf", "u", "a0", "local", 2.0, 99.0))
    q_new = svc.predict_batch([TQuery("a0", None, 1.0)])
    store.save(path, incremental=True, keep_last=2)
    assert store.generation > g1
    assert os.path.exists(os.path.join(path, f"manifest.g{g1}.json"))
    old = TStore.restore(path, generation=g1)
    np.testing.assert_array_equal(old.get(TaskKey("t", "w", "a0"))["mu"],
                                  mu_old)
    _, svc_old = _resumed(TPKG, old, "t", ("a0", "a1", "a2", "a3"))
    np.testing.assert_array_equal(
        svc_old.predict_batch([TQuery("a0", None, 1.0)]), q_old)
    new = TStore.restore(path)
    assert not np.array_equal(new.get(TaskKey("t", "w", "a0"))["mu"],
                              mu_old)
    _, svc_new = _resumed(TPKG, new, "t", ("a0", "a1", "a2", "a3"))
    np.testing.assert_array_equal(
        svc_new.predict_batch([TQuery("a0", None, 1.0)]), q_new)


def test_save_keep_last_prunes_history_and_orphans(tmp_path):
    store = TStore(block_size=2)
    online, svc = _warm(TPKG, store, "t", ("a0", "a1"))
    path = str(tmp_path / "ckpt")
    store.save(path, keep_last=2)
    gens = [store.generation]
    for i in range(2):
        online.observe(TComp("wf", f"u{i}", "a0", "local", 2.0 + i,
                             70.0 + i))
        svc.predict_batch([TQuery("a0", None, 1.0)])
        orphan = os.path.join(path, "block_9.npz")
        temp = os.path.join(path, "block_0.npz.tmp")
        open(orphan, "wb").close()
        open(temp, "wb").close()
        store.save(path, incremental=True, keep_last=2)
        gens.append(store.generation)
        assert not os.path.exists(orphan)
        assert not os.path.exists(temp)
    hist = sorted(f for f in os.listdir(path) if f.startswith("manifest.g"))
    assert hist == [f"manifest.g{gens[-2]}.json"]
    with pytest.raises(FileNotFoundError):
        TStore.restore(path, generation=gens[0])
    assert TStore.restore(path, generation=gens[-2]).generation == gens[-2]


def test_save_keep_last_one_keeps_live_only(tmp_path):
    store = TStore(block_size=2)
    online, svc = _warm(TPKG, store, "t", ("a0", "a1"))
    path = str(tmp_path / "ckpt")
    store.save(path, keep_last=1)
    online.observe(TComp("wf", "u", "a0", "local", 2.0, 80.0))
    svc.predict_batch([TQuery("a0", None, 1.0)])
    store.save(path, incremental=True, keep_last=1)
    assert not [f for f in os.listdir(path) if ".g" in f]
    assert TStore.restore(path).generation == store.generation


def test_save_keep_last_validation(tmp_path):
    store = TStore()
    _warm(TPKG, store, "t", ("a0",))
    with pytest.raises(ValueError, match="keep_last"):
        store.save(str(tmp_path / "c"), keep_last=0)


# --- migration and replica shipping ------------------------------------------

def test_export_import_namespaces_roundtrip_into_live_store():
    """export_namespaces of one tenant, imported into a live store that
    owns another namespace and allocates rows differently: the rows merge
    bitwise, resume reloads the exported state, the other namespace
    survives; the payload equals the reference's."""
    def run(pkg):
        src = pkg.Store(block_size=4)
        p0, svc0 = _warm(pkg, src, "acme", seed=3)
        _warm(pkg, src, "globex", seed=4, salt=1.0)
        payload = src.export_namespaces(["acme/w"])
        dst = pkg.Store(block_size=3)
        other, svc_o = _warm(pkg, dst, "kept", ("bwa", "idx"), seed=5,
                             salt=7.0)
        q_o = svc_o.predict_batch(_queries(pkg, ("bwa",)))
        gen = dst.generation
        n = dst.import_namespaces(payload)
        gen = (gen, dst.generation)
        fresh, svc = _resumed(pkg, dst, "acme")
        qs = _queries(pkg)
        return (src, dst, payload, n, gen, p0, fresh, q_o,
                svc_o.predict_batch(_queries(pkg, ("bwa",))),
                svc.predict_batch(qs), svc0.predict_batch(qs))
    j, t = _both(run)
    src, dst, payload, n, gen, p0, fresh, q_o, q_o2, got, want = t
    assert all(k.startswith("acme/w/") for k in payload["keys"])
    assert list(payload["namespaces"]) == ["acme/w"]
    assert payload["keys"] == j[2]["keys"]
    assert payload["namespaces"] == j[2]["namespaces"]
    for leaf in j[2]["leaves"]:
        assert np.array_equal(payload["leaves"][leaf], j[2]["leaves"][leaf])
    assert n == len(payload["keys"]) and gen[1] == gen[0] + 1
    assert fresh.export_state() == p0.export_state()
    assert "kept/w" in dst.namespaces()
    np.testing.assert_array_equal(q_o2, q_o)
    _gathers_equal(dst, src, payload["keys"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j[9])


def test_import_blocks_replica_gathers_bitwise_and_ships_deltas():
    """export_blocks(-1) into a passive store, then the delta after a
    write: only the moved blocks ship, and the replica's gathers are
    bitwise the primary's; arrays are copied, never aliased."""
    primary = TStore(block_size=2)
    online, svc = _warm(TPKG, primary, "a", ("a0", "a1", "a2", "a3"))
    _warm(TPKG, primary, "b", ("b0", "b1"), seed=4)
    replica = TStore(block_size=2)
    boot = primary.export_blocks(-1)
    assert replica.import_blocks(boot) == primary.num_blocks
    keys = primary.task_keys()
    _gathers_equal(replica, primary, keys)
    assert replica._blocks[0]["mu"] is not primary._blocks[0]["mu"]
    g = primary.generation
    online.observe(TComp("wf", "u", "a2", "local", 2.0, 60.0))
    svc.predict_batch([TQuery("a2", None, 1.0)])
    moved = [i for i, gen in primary._block_gen.items() if gen > g]
    delta = primary.export_blocks(g)
    assert sorted(int(i) for i in delta["blocks"]) == sorted(moved) == [1]
    assert replica.import_blocks(delta) == 1
    _gathers_equal(replica, primary, keys)
    assert replica.generation == primary.generation
    assert replica._saved_states == delta["namespaces"]


def test_import_blocks_refusals():
    """import_blocks is refused with live bindings, on a stale generation,
    on a block-size mismatch and on a block of the wrong shape (the last
    leaves the replica as it was)."""
    primary = TStore(block_size=2)
    _warm(TPKG, primary, "a", ("a0", "a1"))
    payload = primary.export_blocks(-1)
    live = TStore(block_size=2)
    live.bind("x", "w", TPKG.online(("bwa",)))
    with pytest.raises(RuntimeError, match="live bindings"):
        live.import_blocks(payload)
    with pytest.raises(ValueError, match="block_size"):
        TStore(block_size=4).import_blocks(payload)
    ahead = TStore(block_size=2)
    ahead.generation = payload["generation"] + 1
    with pytest.raises(ValueError, match="stale"):
        ahead.import_blocks(payload)
    bad = dict(payload, blocks={"0": dict(payload["blocks"]["0"],
                                          mu=np.zeros((2, 3)))})
    replica = TStore(block_size=2)
    with pytest.raises(ValueError, match="shape"):
        replica.import_blocks(bad)
    assert (replica.num_blocks, len(replica), replica.generation) == (0, 0, 0)


# --- across the two packages ---------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(JPKG, TPKG), (TPKG, JPKG)],
                         ids=["repro->repro_torch", "repro_torch->repro"])
def test_checkpoint_crosses_packages_bitwise(tmp_path, writer, reader):
    """A checkpoint saved by one package (two tenants, one evicted block,
    an incremental save with keep_last) restores and resumes in the other:
    the same rows, generations and states, and predictions bitwise those
    of the writer; an older generation restores too."""
    store = writer.Store(block_size=2)
    _warm(writer, store, "gone", ("x0", "x1"), seed=7)     # block 0
    on_a, svc_a = _warm(writer, store, "a", seed=3)
    on_b, svc_b = _warm(writer, store, "b", ("bwa", "idx"), seed=4,
                        salt=2.0)
    path = str(tmp_path / "c")
    store.save(path, keep_last=2)
    g1 = store.generation
    q_b1 = svc_b.predict_batch(_queries(writer, ("bwa", "idx")))
    store.evict("gone", "w")
    on_b.observe(writer.Comp("wf", "late", "idx", "local", 3.0, 90.0))
    store.save(path, incremental=True, keep_last=2)
    want_a = svc_a.predict_batch(_queries(writer))
    want_b = svc_b.predict_batch(_queries(writer, ("bwa", "idx")))

    restored = reader.Store.restore(path)
    assert restored.generation == store.generation
    assert restored.num_free_blocks == store.num_free_blocks == 1
    assert restored._block_gen == store._block_gen
    _gathers_equal(restored, store, store.task_keys())
    ra, sa = _resumed(reader, restored, "a")
    rb, sb = _resumed(reader, restored, "b", ("bwa", "idx"), salt=2.0)
    assert ra.export_state() == on_a.export_state()
    assert rb.export_state() == on_b.export_state()
    np.testing.assert_array_equal(sa.predict_batch(_queries(reader)), want_a)
    np.testing.assert_array_equal(
        sb.predict_batch(_queries(reader, ("bwa", "idx"))), want_b)
    old = reader.Store.restore(path, generation=g1)
    _, sb_old = _resumed(reader, old, "b", ("bwa", "idx"), salt=2.0)
    np.testing.assert_array_equal(
        sb_old.predict_batch(_queries(reader, ("bwa", "idx"))), q_b1)
    # the reader's store extends the writer's checkpoint in its lineage
    rb.observe(reader.Comp("wf", "later", "bwa", "local", 1.0, 40.0))
    restored.save(path, incremental=True)
    assert writer.Store.restore(path).generation == restored.generation


@pytest.mark.parametrize("writer,reader", [(JPKG, TPKG), (TPKG, JPKG)],
                         ids=["repro->repro_torch", "repro_torch->repro"])
def test_export_blocks_payload_crosses_packages(writer, reader):
    """An export_blocks payload of either package installs in the other
    (bootstrap, then a delta): gathers, generations and states equal."""
    primary = writer.Store(block_size=3)
    online, svc = _warm(writer, primary, "a", seed=3)
    _warm(writer, primary, "b", ("bwa",), seed=4)
    replica = reader.Store(block_size=3)
    replica.import_blocks(primary.export_blocks(-1))
    _gathers_equal(replica, primary, primary.task_keys())
    g = primary.generation
    online.observe(writer.Comp("wf", "u", "merge", "local", 2.0, 70.0))
    svc.predict_batch([writer.Query("merge", None, 1.0)])
    delta = primary.export_blocks(g)
    assert 0 < len(delta["blocks"]) < primary.num_blocks
    replica.import_blocks(delta)
    _gathers_equal(replica, primary, primary.task_keys())
    assert replica.generation == primary.generation
    assert replica._block_gen == primary._block_gen
    assert replica._saved_states == delta["namespaces"]


@pytest.mark.parametrize("writer,reader", [(JPKG, TPKG), (TPKG, JPKG)],
                         ids=["repro->repro_torch", "repro_torch->repro"])
def test_namespace_payload_crosses_packages(writer, reader):
    src = writer.Store(block_size=4)
    p0, svc0 = _warm(writer, src, "acme", seed=3)
    payload = src.export_namespaces(["acme/w"])
    dst = reader.Store(block_size=2)
    _warm(reader, dst, "kept", ("bwa",), seed=5)
    assert dst.import_namespaces(payload) == len(payload["keys"])
    fresh, svc = _resumed(reader, dst, "acme")
    assert fresh.export_state() == p0.export_state()
    np.testing.assert_array_equal(svc.predict_batch(_queries(reader)),
                                  svc0.predict_batch(_queries(writer)))


# --- the resident plane over a restored, imported or migrated store ----------

def _plane(svc, tasks=TASKS):
    rng = np.random.default_rng(11)
    entries = [(f"u{i}", t, float(rng.uniform(0.1, 4.0)))
               for i, t in enumerate(tasks * 3)]
    return FusedPlane(svc, TMACHINES[:4], entries=entries)


def _fresh_matrix(svc, plane):
    """The plane's matrix as a new plane over the same service gives it."""
    return _plane(svc).matrix()


@pytest.mark.parametrize("how", ["restored", "replica", "migrated"])
def test_plane_over_a_new_store_repredicts_all_then_none(tmp_path, how):
    """A FusedPlane over a restored store (resume), a replica that took an
    export_blocks payload and then a binding, or a live store that
    imported a migrated namespace: its first round re-predicts every row
    it holds, a warm round none, and after an ingest only the dirtied
    rows; every matrix bitwise a fresh plane's and the source's."""
    src = TStore(block_size=2)
    online, src_svc = _warm(TPKG, src, "acme", seed=3)
    _warm(TPKG, src, "globex", ("bwa",), seed=4)
    want = _plane(src_svc).matrix()
    if how == "restored":
        src.save(str(tmp_path / "c"))
        dst = TStore.restore(str(tmp_path / "c"))
    elif how == "replica":
        dst = TStore(block_size=2)
        dst.import_blocks(src.export_blocks(-1))
    else:
        dst = TStore(block_size=3)
        _warm(TPKG, dst, "kept", ("idx",), seed=5)
        dst.import_namespaces(src.export_namespaces(["acme/w"]))
    pred, svc = _resumed(TPKG, dst, "acme")
    plane = _plane(svc)
    m = plane.matrix()
    assert plane.stats.rows_refreshed == len(plane.uids)
    assert plane.stats.full_gathers == 1
    np.testing.assert_array_equal(m.means, want.means)
    np.testing.assert_array_equal(m.stds, want.stds)
    plane.matrix()
    assert plane.stats.rows_refreshed == len(plane.uids)
    assert plane.stats.predict_dispatches == 1
    pred.observe(TComp("wf", "x", "idx", "local", 2.0, 70.0))
    gen = dst.generation
    m2 = plane.matrix()
    dirty = int(dst.snapshot().rows_changed_since(plane._keys, gen).sum())
    assert 0 < dirty < len(plane.uids)
    assert plane.stats.rows_refreshed == len(plane.uids) + dirty
    f = _fresh_matrix(svc, plane)
    np.testing.assert_array_equal(m2.means, f.means)
    np.testing.assert_array_equal(m2.stds, f.stds)


def test_plane_never_serves_a_row_of_a_replaced_index():
    """import_blocks replaces a store's row index wholesale, and only on a
    store with no live binding: a plane over the store before has lost its
    binding (evict) and refuses to serve; a plane over the replaced index
    gathers it whole and serves the imported rows."""
    primary = TStore(block_size=2)
    p_online, p_svc = _warm(TPKG, primary, "acme", seed=3)
    for i in range(2):                  # the primary runs ahead
        p_online.observe(TComp("wf", f"v{i}", "idx", "local", 1.0 + i, 40.0))
        p_svc.predict_batch([TQuery("idx", None, 1.0)])
    replica = TStore(block_size=2)
    _, r_svc = _warm(TPKG, replica, "acme", seed=9, salt=3.0)
    old = _plane(r_svc)
    stale = old.matrix()
    with pytest.raises(RuntimeError, match="live bindings"):
        replica.import_blocks(primary.export_blocks(-1))
    replica.evict("acme", "w")
    replica.import_blocks(primary.export_blocks(-1))
    with pytest.raises(RuntimeError, match="evicted"):
        old.matrix()
    _, svc = _resumed(TPKG, replica, "acme")
    new = _plane(svc)
    m = new.matrix()
    assert new.stats.rows_refreshed == len(new.uids)
    want = _plane(p_svc).matrix()
    np.testing.assert_array_equal(m.means, want.means)
    assert not np.array_equal(m.means, stale.means)


def test_store_constants_are_the_reference_names():
    assert (tposterior.MANIFEST_NAME, tposterior.BLOCKS_NAME,
            tposterior.CHECKPOINT_FORMAT, tposterior.DEFAULT_BLOCK_SIZE) == \
        ("manifest.json", "blocks.npz", 2, 512)
    assert tposterior._block_file(3) == "block_3.npz"
    assert tposterior._hist_block_file(3, 12) == "block_3.g12.npz"
    assert tposterior._hist_manifest_file(12) == "manifest.g12.json"
