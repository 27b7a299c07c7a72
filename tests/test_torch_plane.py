"""The port's store dirty-block feed and resident decision plane against
the JAX package, on the CPU.

  * Block generations and `StoreSnapshot.rows_changed_since` equal the
    reference store's over the same `put_many` / `evict` sequence.
  * `sync_bindings` lands several namespaces' rows in one generation, and
    `TenantBinding._advance_cursor` moves (or holds) the change cursor,
    as the reference does.
  * `FusedPlane`, serving the reference's posteriors (`repro_torch.convert`)
    through a CPU service, gives matrices bitwise the reference
    `FusedPlane.matrix()` and `PredictionMatrix.from_service` after
    dirty-row updates, schedules identical to `heft_schedule_matrix`, and
    `PlaneStats` equal to the reference plane's over the same rounds.

Fixed seeds, small problems (tens of tasks on four to six nodes)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.core.traces import TraceRow as JTrace
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online.events import TaskCompletion as JComp
from repro.sched.cluster import LOCAL as JLOCAL
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.sched.fused import FusedPlane as JPlane
from repro.sched.heft import heft_schedule_matrix as jheft
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.store import PosteriorStore as JStore
from repro.workflow.dag import TaskInstance as JTask
from repro.workflow.dag import WorkflowDAG as JDAG
from repro.workflow.simulator import random_cluster as jcluster
from repro_torch import convert
from repro_torch.core.microbench import NodeSpec as TNode
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.core.traces import TraceRow as TTrace
from repro_torch.kernels import ops
from repro_torch.kernels.bayes_fit import slab_table
from repro_torch.online import OnlinePredictor as TOnline
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.sched import fused as tfused
from repro_torch.sched.fused import FusedPlane as TPlane
from repro_torch.sched.heft import heft_schedule_matrix as theft
from repro_torch.sched.plane import PredictionMatrix as TMatrix
from repro_torch.store import PosteriorStore as TStore
from repro_torch.store.posterior import TenantBinding
from repro_torch.workflow.dag import TaskInstance as TTask
from repro_torch.workflow.dag import WorkflowDAG as TDAG

TASK_TYPES = ("bwa", "idx", "dedup", "qc", "merge", "report")
LEAF_SHAPES = {"mu": (2,), "sigma": (2, 2), "beta_prec": (), "x_mu": (),
               "x_sd": (), "y_mu": (), "y_sd": ()}


# --- store: block generations and the dirty-row feed ---------------------------

def _rows(rng, tenant, names):
    return [(f"{tenant}/wf/{n}",
             {k: rng.normal(size=s) for k, s in LEAF_SHAPES.items()})
            for n in names]


@pytest.mark.parametrize("block_size", [1, 3, 512])
def test_block_generations_and_dirty_rows_equal_reference(block_size):
    rng = np.random.default_rng(block_size)
    stores = (JStore(block_size), TStore(block_size))
    a = _rows(rng, "t0", [f"a{i}" for i in range(7)])
    b = _rows(rng, "t1", [f"b{i}" for i in range(5)])
    c = _rows(rng, "t2", [f"c{i}" for i in range(4)])
    steps = [("put", a), ("put", b), ("put", [a[2], b[4]]),
             ("evict", ("t0", "wf")), ("put", c), ("put", [b[0]])]
    keys = [k for k, _ in a + b + c] + ["t9/wf/unknown"]
    for op, arg in steps:
        for s in stores:
            if op == "put":
                s.put_many(arg)
            else:
                s.evict(*arg)
        j, t = stores
        assert t._block_gen == j._block_gen
        assert t.generation == j.generation
        jsnap, tsnap = j.snapshot(), t.snapshot()
        for g in range(-1, j.generation + 1):
            want = jsnap.rows_changed_since(keys, g)
            got = tsnap.rows_changed_since(keys, g)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    # a snapshot built without generation tags reads as all dirty
    bare = type(tsnap)(tsnap._blocks, tsnap._rows, tsnap._n_rows,
                       block_size, tsnap.generation)
    assert bare.rows_changed_since(keys, 10 ** 6).all()


# --- bindings: sync_bindings and the cursor -----------------------------------

def _traces(cls, tasks):
    rows = []
    for j, t in enumerate(tasks):
        rows += [cls("wf", t, "local", s, 2.0 + j + (20.0 + 7 * j) * s)
                 for s in np.linspace(0.05, 0.4, 6)]
    return rows


def _onlines(tasks=("bwa", "idx", "sort")):
    """A reference OnlinePredictor and the port's over the same fitted
    posteriors (carried), each with its package's benches."""
    base = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    base.fit(_traces(JTrace, tasks))
    carried = convert.predictor_from_state(convert.predictor_state(base),
                                           device="cpu")
    jb = {n.name: jbench(n, 1) for n in JMACHINES}
    tb = {n.name: tbench(n, 1) for n in TMACHINES}
    return JOnline(base, jb), TOnline(carried, tb, device="cpu")


def _observe(pair, stream):
    for j, t in zip(pair, (JComp, TComp)):
        for task, node, gb, rt in stream:
            j.observe(t("wf", f"{task}-{gb}", task, node, gb, rt))


def _stream(rng, tasks, n, node="local"):
    return [(tasks[i % len(tasks)], node, float(rng.uniform(0.1, 3.0)),
             float(rng.uniform(5.0, 90.0))) for i in range(n)]


def test_sync_bindings_writes_the_same_rows_in_one_generation():
    rng = np.random.default_rng(3)
    stores = (JStore(block_size=2), TStore(block_size=2))
    tenants = {ten: _onlines() for ten in ("acme", "globex", "initech")}
    svcs = {}
    for ten, pair in tenants.items():
        svcs[ten] = (JService(pair[0], store=stores[0], tenant=ten),
                     TService(pair[1], store=stores[1], tenant=ten,
                              device="cpu"))
    for ten in ("acme", "initech"):
        _observe(tenants[ten], _stream(rng, ("bwa", "sort"), 5))
    gens = [s.generation for s in stores]
    written = [s.sync_bindings() for s in stores]
    assert written[1] == written[0] == 4
    assert [s.generation for s in stores] == [g + 1 for g in gens]
    assert stores[1]._block_gen == stores[0]._block_gen
    keys = stores[0].task_keys()
    assert stores[1].task_keys() == keys
    got, want = stores[1].gather(keys), stores[0].gather(keys)
    for leaf in want:
        assert np.array_equal(got[leaf], want[leaf]), leaf
    # nothing pending: no write, no generation
    assert [s.sync_bindings() for s in stores] == [0, 0]
    assert [s.generation for s in stores] == [g + 1 for g in gens]
    # a subset, in any order, once each
    _observe(tenants["globex"], _stream(rng, ("idx",), 2))
    bs = [s.binding("globex", "default") for s in stores]
    assert [s.sync_bindings([b, b]) for s, b in zip(stores, bs)] == [1, 1]
    # a detached binding raises, as sync() does
    for s, svc in zip(stores, svcs["acme"]):
        s.evict("acme", "default")
        with pytest.raises(RuntimeError, match="evicted"):
            s.sync_bindings([svc._binding])


def test_advance_cursor_moves_only_past_unmoved_published_seqs():
    rng = np.random.default_rng(5)
    pair = _onlines()
    stores = (JStore(), TStore())
    svcs = (JService(pair[0], store=stores[0]),
            TService(pair[1], store=stores[1], device="cpu"))
    bs = [s._binding for s in svcs]
    _observe(pair, _stream(rng, ("bwa", "idx"), 4))

    def published():
        return [{t: p.change_seq(t) for t in ("bwa", "idx")} for p in pair]

    # a publish of every pending task moves the cursor to the head
    seqs = published()
    for b, s in zip(bs, seqs):
        b._advance_cursor(s)
    assert bs[1]._change_cursor == bs[0]._change_cursor == \
        pair[1].changed_since(-1)[1]
    assert [b.is_current() for b in bs] == [True, True]
    # an observe that moves a published task's seq keeps the cursor put
    _observe(pair, _stream(rng, ("bwa",), 1))
    seqs = published()
    _observe(pair, _stream(rng, ("bwa",), 1))
    cursors = [b._change_cursor for b in bs]
    for b, s in zip(bs, seqs):
        b._advance_cursor(s)
    assert [b._change_cursor for b in bs] == cursors
    assert bs[1]._change_cursor == bs[0]._change_cursor
    assert [b.is_current() for b in bs] == [False, False]
    # a pending task that was not published keeps it put too
    for b in bs:
        b._advance_cursor({"idx": 10 ** 9})
    assert [b._change_cursor for b in bs] == cursors
    # a binding that never synced is left alone
    fresh = [JStore().bind("t", "w", pair[0], sync=False),
             TStore().bind("t", "w", pair[1], sync=False)]
    for b in fresh:
        b._advance_cursor({"bwa": 10 ** 9, "idx": 10 ** 9})
        assert b._change_cursor == -1.0 and b._synced_version is None


# --- the resident plane -------------------------------------------------------

def _build(n_tasks, n_nodes, seed, block_size=512, benches=False):
    """The reference's tests/test_fused_plane.py problem (six task types,
    a random cluster and DAG from `seed`) in both packages; the port's
    OnlinePredictor serves the reference's fitted posteriors.  With
    `benches` both online predictors know the cluster's machines, so
    remote completions move node corrections."""
    rng = np.random.default_rng(seed)
    traces = []
    for j, t in enumerate(TASK_TYPES):
        traces += [JTrace("wf", t, "local", s, 2.0 + j + (15.0 + 6 * j) * s)
                   for s in np.linspace(0.05, 0.4, 6)]
    lot = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    lot.fit(traces)
    carried = convert.predictor_from_state(convert.predictor_state(lot),
                                           device="cpu")
    jnodes = jcluster(rng, list(JMACHINES), n_nodes=n_nodes)
    jb = {n.name: jbench(n, 1) for n in jnodes}
    tnodes = [TNode(**dataclasses.asdict(n)) for n in jnodes]
    tb = {n.name: tbench(n, 1) for n in tnodes}
    jon = JOnline(lot, jb if benches else None)
    ton = TOnline(carried, tb if benches else None, device="cpu")
    jsvc = JService(jon, jb, store=JStore(block_size))
    tsvc = TService(ton, tb, store=TStore(block_size), device="cpu")
    jdag, tdag = JDAG("fused"), TDAG("fused")
    for i in range(n_tasks):
        deps = [f"t{j}" for j in range(i)
                if rng.random() < min(3.0 / max(i, 1), 0.5)]
        args = (f"t{i}", TASK_TYPES[i % len(TASK_TYPES)], "fused",
                float(rng.uniform(0.05, 4.0)))
        kw = dict(output_gb=float(rng.uniform(0.0, 2.0)), deps=deps)
        jdag.add(JTask(*args, **kw))
        tdag.add(TTask(*args, **kw))
    return (jdag, jnodes, jsvc), (tdag, tnodes, tsvc)


def _entries(dag):
    return [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]


def _same_schedule(a, b):
    assert a.assignment == b.assignment
    assert a.order == b.order
    assert a.est == b.est


def _same_matrix(got, want):
    assert got.uids == want.uids and got.node_names == want.node_names
    assert np.array_equal(got.means, want.means)
    assert np.array_equal(got.stds, want.stds)


def _observe_both(jsvc, tsvc, rounds, rng, nodes=("local",)):
    for k in range(rounds[1]):
        task, node = TASK_TYPES[(rounds[0] + k) % 3], nodes[k % len(nodes)]
        args = ("fused", f"obs{rounds[0]}-{k}", task, node,
                float(rng.uniform(0.1, 0.5)), float(rng.uniform(10.0, 60.0)))
        jsvc.predictor.observe(JComp(*args, finish_time=float(k)))
        tsvc.predictor.observe(TComp(*args, finish_time=float(k)))


def test_dirty_row_update_matches_full_regather():
    """Observes interleaved with plane rounds (block_size 1): the
    resident rows stay bitwise what a cold full gather computes, while
    only the dirty subset is re-predicted."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _build(36, 4, 7,
                                                        block_size=1)
    jplane = JPlane(jsvc, jnodes, dag=jdag)
    tplane = TPlane(tsvc, tnodes, dag=tdag)
    rng = np.random.default_rng(0)
    n_rows = len(tplane.uids)
    for step in range(3):
        _observe_both(jsvc, tsvc, (step, 4), rng)
        got, want = tplane.matrix(), jplane.matrix()
        _same_matrix(got, want)
        fresh = TMatrix.from_service(tsvc, _entries(tdag), tnodes)
        _same_matrix(got, fresh)
        sched = tplane.schedule(tdag, quantile=0.95)
        _same_schedule(sched, jplane.schedule(jdag, quantile=0.95))
        _same_schedule(sched, jheft(jdag, jnodes, JMatrix.from_service(
            jsvc, _entries(jdag), jnodes), quantile=0.95))
        _same_schedule(sched, theft(tdag, tnodes, fresh, quantile=0.95))
    assert dataclasses.asdict(tplane.stats) == \
        dataclasses.asdict(jplane.stats)
    assert tplane.stats.full_gathers == 1
    refreshed_after_first = tplane.stats.rows_refreshed - n_rows
    assert 0 < refreshed_after_first < 2 * n_rows


def test_dirty_rounds_write_rows_in_the_predictive_not_an_index_copy(
        monkeypatch):
    """A dirty round is one predictive call that writes the rows into the
    plane's resident rows (its one target) and returns nothing: no index
    copy follows.  Matrices, schedules and PlaneStats stay the
    reference plane's."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _build(36, 4, 7,
                                                        block_size=1)
    jplane = JPlane(jsvc, jnodes, dag=jdag)
    tplane = TPlane(tsvc, tnodes, dag=tdag)

    def refuse(*a, **k):
        raise AssertionError("an index copy on the plane's path")
    monkeypatch.setattr(torch.Tensor, "index_copy_", refuse)
    calls = []
    real = ops.bayes_predict

    def predict(batch):
        calls.append(batch)
        out = real(batch)
        assert out is None
        return out
    monkeypatch.setattr(ops, "bayes_predict", predict)
    rng = np.random.default_rng(0)
    for step in range(3):
        _observe_both(jsvc, tsvc, (step, 4), rng)
        _same_matrix(tplane.matrix(), jplane.matrix())
        _same_schedule(tplane.schedule(tdag, quantile=0.95),
                       jplane.schedule(jdag, quantile=0.95))
    assert len(calls) == tplane.stats.predict_dispatches == 3
    assert sum(b.q for b in calls) == tplane.stats.rows_refreshed
    for batch in calls:
        assert len(batch.targets) == 1 and slab_table(batch)[0, 0] == 0
        assert batch.targets[0].mean is tplane._mean_raw
        assert batch.targets[0].std is tplane._std_raw
    assert dataclasses.asdict(tplane.stats) == \
        dataclasses.asdict(jplane.stats)


def test_plane_matrix_cached_until_store_moves():
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _build(12, 4, 5)
    jplane = JPlane(jsvc, jnodes, dag=jdag)
    tplane = TPlane(tsvc, tnodes, dag=tdag)
    m1 = tplane.matrix()
    m2 = tplane.matrix()
    assert m1 is m2
    assert tplane.stats.matrix_rebuilds == 1
    assert tplane.stats.cost_rebuilds == 0
    tplane.schedule(tdag, quantile=0.95)
    tplane.schedule(tdag, quantile=0.95)
    assert tplane.stats.cost_rebuilds == 1      # resident (T, N) cost view
    jplane.matrix()
    jplane.matrix()
    jplane.schedule(jdag, quantile=0.95)
    jplane.schedule(jdag, quantile=0.95)
    assert dataclasses.asdict(tplane.stats) == \
        dataclasses.asdict(jplane.stats)


def test_warm_round_launches_nothing_and_builds_no_factors(monkeypatch):
    """A round in which store, factors and corrections did not move: no
    predictive call, no factor matrix, no new W; the schedule the same."""
    _, (tdag, tnodes, tsvc) = _build(20, 5, 11, benches=True)
    plane = TPlane(tsvc, tnodes, dag=tdag)
    calls = {"predict": 0, "factors": 0}
    real_predict = ops.bayes_predict
    real_factors = TenantBinding.base_factor_matrix

    def predict(*a, **k):
        calls["predict"] += 1
        return real_predict(*a, **k)

    def factors(self, *a, **k):
        calls["factors"] += 1
        return real_factors(self, *a, **k)

    monkeypatch.setattr(ops, "bayes_predict", predict)
    monkeypatch.setattr(TenantBinding, "base_factor_matrix", factors)
    cold = plane.schedule(tdag, quantile=0.95, engine="device")
    assert calls == {"predict": 1, "factors": 1}
    before = dataclasses.asdict(plane.stats)
    warm = plane.schedule(tdag, quantile=0.95, engine="device")
    _same_schedule(warm, cold)
    assert calls == {"predict": 1, "factors": 1}
    after = dataclasses.asdict(plane.stats)
    assert after["rounds"] == before["rounds"] + 1
    assert after["sweep_dispatches"] == before["sweep_dispatches"] + 1
    for k in ("full_gathers", "rows_refreshed", "predict_dispatches",
              "matrix_rebuilds", "cost_rebuilds"):
        assert after[k] == before[k], k
    # remote completions move a node correction and no posterior row: no
    # predictive call and no factor matrix, but a new scaled matrix and W
    rng = np.random.default_rng(1)
    node = tnodes[0].name
    for k in range(8):
        tsvc.predictor.observe(TComp("fused", f"r{k}", ("bwa", "idx")[k % 2],
                                     node, 1.0,
                                     float(rng.uniform(300.0, 400.0))))
    assert tsvc.predictor.node_correction(node) != 1.0
    moved = plane.schedule(tdag, quantile=0.95, engine="device")
    assert calls == {"predict": 1, "factors": 1}
    assert plane.stats.matrix_rebuilds == after["matrix_rebuilds"] + 1
    assert plane.stats.cost_rebuilds == after["cost_rebuilds"] + 1
    fresh = TMatrix.from_service(tsvc, _entries(tdag), tnodes)
    _same_matrix(plane.matrix(), fresh)
    _same_schedule(moved, theft(tdag, tnodes, fresh, quantile=0.95))


@pytest.mark.parametrize("quantile", [None, 0.5, 0.95])
def test_device_engine_and_cost_view_match_reference(quantile):
    """engine="device" on the CPU runs the plain sweep once a round; the
    plane's cost view is bitwise the reference plane's, with corrections
    moved by remote completions in both packages."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _build(30, 6, 13,
                                                        benches=True)
    jplane = JPlane(jsvc, jnodes, dag=jdag)
    tplane = TPlane(tsvc, tnodes, dag=tdag)
    rng = np.random.default_rng(2)
    for step in range(2):
        _observe_both(jsvc, tsvc, (step, 6), rng,
                      nodes=("local", jnodes[1].name, jnodes[3].name))
        _, W = tplane.cost_view(tdag, quantile)
        _, jW = jplane.cost_view(jdag, quantile)
        assert np.array_equal(W.numpy(), jW)
        want = jheft(jdag, jnodes, jplane.matrix(), quantile=quantile)
        for engine in ("device", "numpy"):
            _same_schedule(tplane.schedule(tdag, quantile=quantile,
                                           engine=engine), want)
    assert tplane.stats.sweep_dispatches == 2
    assert tsvc.predictor.node_correction(tnodes[1].name) != 1.0


@pytest.mark.parametrize("quantile", [None, 0.95])
def test_cost_view_bitwise_after_node_corrections_move(quantile):
    """`cost_view` (one cost slab, the resident static factors, the
    corrections multiplied in by the cost kernel's plain version) is
    bitwise the reference's `PredictionMatrix.from_service(...).costs`
    before and after remote completions move node corrections in both
    packages."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _build(30, 6, 17,
                                                        benches=True)
    rng = np.random.default_rng(4)
    order, names = jdag.topo_order(), [n.name for n in jnodes]
    for step in range(3):
        if step:
            _observe_both(jsvc, tsvc, (step, 6), rng,
                          nodes=(jnodes[0].name, jnodes[2].name, "local"))
        want = JMatrix.from_service(jsvc, _entries(jdag), jnodes).costs(
            order, names, quantile)
        got = tfused.cost_view(tsvc, tdag, tnodes, quantile)
        assert got.dtype == torch.float64 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
    assert tsvc.predictor.node_correction(tnodes[0].name) != 1.0


def test_cost_view_keeps_its_static_factors_resident(monkeypatch):
    """Three warm `cost_view` rounds build the static factor matrix once
    and never the full factor matrix; a refit that moves
    `factor_version` builds it again, and W stays bitwise
    `PredictionMatrix.costs`."""
    _, (tdag, tnodes, tsvc) = _build(20, 5, 11, benches=True)
    calls = {"base": 0, "full": 0}
    real_base = TenantBinding.base_factor_matrix
    real_full = TenantBinding.factor_matrix

    def base(self, *a, **k):
        calls["base"] += 1
        return real_base(self, *a, **k)

    def full(self, *a, **k):
        calls["full"] += 1
        return real_full(self, *a, **k)

    monkeypatch.setattr(TenantBinding, "base_factor_matrix", base)
    cold = tfused.cost_view(tsvc, tdag, tnodes, 0.95)
    monkeypatch.setattr(TenantBinding, "factor_matrix", full)
    for _ in range(3):
        assert torch.equal(tfused.cost_view(tsvc, tdag, tnodes, 0.95), cold)
    assert calls == {"base": 1, "full": 0}
    version = tsvc._binding.factor_version
    tsvc.predictor.base.fit(_traces(TTrace, TASK_TYPES))
    got = tfused.cost_view(tsvc, tdag, tnodes, 0.95)
    assert tsvc._binding.factor_version != version
    assert calls == {"base": 2, "full": 0}
    monkeypatch.setattr(TenantBinding, "factor_matrix", real_full)
    order = tdag.topo_order()
    want = TMatrix.from_service(tsvc, _entries(tdag), tnodes).costs(
        order, [n.name for n in tnodes], 0.95)
    assert np.array_equal(got.numpy(), want)


def test_plane_needs_entries_or_dag():
    _, (_, tnodes, tsvc) = _build(3, 4, 1)
    with pytest.raises(ValueError, match="entries"):
        TPlane(tsvc, tnodes)
    plane = TPlane(tsvc, tnodes, entries=[("u0", "bwa", 1.5),
                                          ("u1", "qc", 0.2)])
    mat = plane.matrix()
    assert mat.uids == ("u0", "u1") and mat.means.shape == (2, 4)
