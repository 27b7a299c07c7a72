"""Replanning many workflows at once in the port against the JAX package,
on the CPU: the device engine's upward ranks and rank order, the
many-lane insertion sweep, and `replan_many`.

  * `upward_rank_ref` is bitwise the reference's jitted `upward_rank` in
    float64 and its host `_PlanContext.ranks`, on a random DAG, a chain,
    a pack of rank ties, a fan and a DAG whose levels alternate between
    more and at most 32 rows; the device engine's rank order (the stable
    sort of -rank) is `np.argsort(-rank, kind="stable")`.
  * `eft_sweep_many_ref`, lane by lane, is bitwise the reference's
    vmapped `eft_sweep_many` in float64 on lanes padded to one shape, and
    bitwise `eft_sweep_ref` on each lane's own operands.
  * `replan_many` over CPU planes gives schedules identical to the
    reference `replan_many(..., fuse_sweeps=False)` on the reference's
    planes and to `heft_schedule_matrix` per request, with the same
    `PlaneStats`, at q = None, 0.5 and 0.95 and on a constrained replan;
    a round makes one predictive dispatch and, per cluster, one rank and
    one many-lane sweep dispatch.

Fixed seeds, at most 115 tasks on 8 nodes, 4 requests."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.core.traces import TraceRow as JTrace
from repro.kernels import decision_plane as jdp
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online.events import TaskCompletion as JComp
from repro.sched import fused as jfused
from repro.sched.cluster import LOCAL as JLOCAL
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.sched.heft import heft_schedule_matrix as jheft
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.workflow.dag import TaskInstance as JTask
from repro.workflow.dag import WorkflowDAG as JDAG
from repro.workflow.simulator import random_cluster as jcluster
from repro_torch import convert
from repro_torch.core.microbench import NodeSpec as TNode
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.kernels import decision_plane as tdp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bayes_fit import slab_table
from repro_torch.online import OnlinePredictor as TOnline
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched import fused as tfused
from repro_torch.workflow.dag import TaskInstance as TTask
from repro_torch.workflow.dag import WorkflowDAG as TDAG

TASK_TYPES = ("bwa", "idx", "dedup", "qc", "merge", "report")


# the narrow/wide DAG's layers from the sources down: levels of more and
# of at most 32 rows in turn (the rank kernel's block and warp walks)
NARROW_WIDE = (34, 2, 33, 1, 40, 5)


def _dags(rng, n_tasks, name, kind="random"):
    """The same DAG in both packages: random (the replan problem's
    generator), a chain, a tie pack (every task one type and input size,
    so W rows repeat, with many sinks of equal rank), a fan (one task
    feeding every other) or the narrow/wide layers (n_tasks must be
    sum(NARROW_WIDE))."""
    jdag, tdag = JDAG(name), TDAG(name)
    layered = (chip_smoke.layer_deps(rng, NARROW_WIDE)
               if kind == "narrow_wide" else [])
    for i in range(n_tasks):
        if kind == "chain":
            deps = [f"t{i - 1}"] if i else []
        elif kind == "ties":
            deps = [f"t{i // 4 - 1}"] if i >= 4 else []
        elif kind == "fan":
            deps = ["t0"] if i else []
        elif kind == "narrow_wide":
            deps = [f"t{j}" for j in layered[i]]
        else:
            deps = [f"t{j}" for j in range(i)
                    if rng.random() < min(3.0 / max(i, 1), 0.5)]
        task = "bwa" if kind == "ties" else TASK_TYPES[i % len(TASK_TYPES)]
        gb = 1.0 if kind == "ties" else float(rng.uniform(0.05, 4.0))
        out = 0.5 if kind == "ties" else float(rng.uniform(0.0, 2.0))
        args = (f"t{i}", task, name, gb)
        jdag.add(JTask(*args, output_gb=out, deps=deps))
        tdag.add(TTask(*args, output_gb=out, deps=deps))
    return jdag, tdag


def _nodes(rng, n_nodes):
    jnodes = jcluster(rng, list(JMACHINES), n_nodes=n_nodes)
    return jnodes, [TNode(**dataclasses.asdict(n)) for n in jnodes]


def _bits(a):
    return np.ascontiguousarray(a).view(np.int64)


# --- upward ranks and the rank order -----------------------------------------

@pytest.mark.parametrize("kind,n_tasks,n_nodes", [
    ("random", 60, 8), ("chain", 40, 5), ("ties", 48, 6),
    ("narrow_wide", sum(NARROW_WIDE), 7), ("fan", 45, 6)])
def test_upward_rank_ref_bitwise_jax_and_host_ranks(kind, n_tasks, n_nodes):
    rng = np.random.default_rng(3)
    jdag, tdag = _dags(rng, n_tasks, "r", kind)
    jnodes, tnodes = _nodes(rng, n_nodes)
    W = rng.uniform(1.0, 100.0, (n_tasks, n_nodes))
    if kind == "ties":
        W = np.repeat(rng.integers(1, 4, (1, n_nodes)).astype(np.float64),
                      n_tasks, axis=0)
    jctx = jfused._PlanContext(jdag, jnodes)
    tctx = tfused._PlanContext(tdag, tnodes)
    host = jctx.ranks(jdag, W)
    want = np.asarray([host[u] for u in jctx.order])
    tab = tctx.rank_table
    rank, bad = ref.upward_rank_ref([torch.from_numpy(W)], [tab])
    assert rank.shape == (1, n_tasks) and bad.tolist() == [0]
    got = rank[0].numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(np.asarray(
        [tctx.ranks(tdag, W)[u] for u in tctx.order])))
    # the reference's jitted recurrence, fed as its host wrapper fed it
    succ = [[tctx.row_of[v] for v in tctx.succ[u]] for u in tctx.order]
    succ_pad = np.full((n_tasks, max(map(len, succ)) or 1), -1, np.int32)
    for i, s in enumerate(succ):
        succ_pad[i, :len(s)] = s
    with jax.enable_x64(True):
        jrank = np.asarray(jdp.upward_rank(
            W.cumsum(axis=1)[:, -1] / n_nodes,
            np.asarray([jctx.avg_comm[u] for u in jctx.order]), succ_pad))
    assert jrank.dtype == np.float64
    assert np.array_equal(_bits(got), _bits(jrank))
    # the device engine's order: a stable sort of -rank
    order = tfused._rank_order(tfused._device_ranks([tctx],
                                                    [torch.from_numpy(W)]))
    assert np.array_equal(order[0].numpy(),
                          np.argsort(-want, kind="stable").astype(np.int32))
    if kind == "ties":
        assert len(np.unique(want)) < n_tasks // 2     # ties were there
    widths = np.diff(tab.level_ptr.numpy()).tolist()
    if kind == "narrow_wide":     # the levels alternate past and within 32
        assert widths == list(NARROW_WIDE[::-1])
    if kind == "fan":
        assert widths == [n_tasks - 1, 1]


def test_rank_table_levels_and_many_lanes():
    """Each level's rows have all their successors on lower levels; a
    batch of lanes of different T gives each lane its own ranks, -inf
    past its rows, and flags only the lane whose W is not finite."""
    rng = np.random.default_rng(5)
    ctxs, Ws = [], []
    for k, (n, kind) in enumerate(((30, "random"), (12, "chain"),
                                   (20, "ties"))):
        _, tdag = _dags(rng, n, f"w{k}", kind)
        ctxs.append(tfused._PlanContext(tdag, _nodes(rng, 4)[1]))
        Ws.append(torch.from_numpy(rng.uniform(1.0, 9.0, (n, 4))))
    for ctx in ctxs:
        tab = ctx.rank_table
        ptr, idx = tab.succ_ptr.tolist(), tab.succ_idx.tolist()
        lp, rows = tab.level_ptr.tolist(), tab.level_rows.tolist()
        level = {}
        for lvl in range(len(lp) - 1):
            for i in rows[lp[lvl]:lp[lvl + 1]]:
                level[i] = lvl
        assert sorted(level) == list(range(len(ctx.order)))
        for i in level:
            succ = idx[ptr[i]:ptr[i + 1]]
            assert all(level[s] < level[i] for s in succ)
            assert level[i] == (1 + max(level[s] for s in succ)
                                if succ else 0)
    Ws[1] = Ws[1].clone()
    Ws[1][3, 2] = float("inf")
    rank, bad = ops.upward_rank(Ws, [c.rank_table for c in ctxs])
    assert rank.shape == (3, 30) and bad.tolist() == [0, 1, 0]
    for k, (ctx, W) in enumerate(zip(ctxs, Ws)):
        t = len(ctx.order)
        one = ref.upward_rank_ref([W], [ctx.rank_table])[0][0]
        assert torch.equal(rank[k, :t], one)
        assert bool(torch.isneginf(rank[k, t:]).all())
    with pytest.raises(ValueError, match=r"W\[3, 2\]"):
        tfused._device_ranks(ctxs, Ws)


# --- the many-lane sweep -----------------------------------------------------

def _lanes(seed):
    """Three lanes on one 8-node cluster, of 40, 25 and 33 tasks, with
    busy prefixes, one constrained lane and one lane of exact ties."""
    rng = np.random.default_rng(seed)
    packs = [chip_smoke.wide_pack(rng, 40, 8),
             chip_smoke.tie_pack(rng, 25, 8),
             chip_smoke.chain_pack(rng, 33, 8)]
    packs[0][4] = rng.uniform(0.0, 30.0, (40, 8))     # ready times
    for p in packs:          # rank-like orders; the cluster is lane 0's
        p[1] = rng.permutation(p[1].shape[0]).astype(np.int32)
        p[6], p[7] = packs[0][6], packs[0][7]
    return packs, packs[0][6], packs[0][7]


@pytest.mark.parametrize("S", [48, 4])
def test_eft_sweep_many_ref_bitwise_jax_and_single_lanes(S):
    packs, same, gbps = _lanes(11)
    t = max(p[0].shape[0] for p in packs)
    d = max(p[2].shape[1] for p in packs)
    b = len(packs)
    order = np.full((b, t), -1, np.int32)
    stacks = [np.ones((b, t, 8)), np.full((b, t, d), -1, np.int32),
              np.zeros((b, t)), np.zeros((b, t, 8)), np.zeros((b, 8))]
    for k, p in enumerate(packs):
        tk = p[0].shape[0]
        order[k, :tk] = p[1]
        stacks[0][k, :tk] = p[0]
        stacks[1][k, :tk, :p[2].shape[1]] = p[2]
        stacks[2][k, :tk] = p[3]
        stacks[3][k, :tk] = p[4]
        stacks[4][k] = p[5]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = ref.eft_sweep_many_ref(
        [T(p[0]) for p in packs], T(order), [T(p[2]) for p in packs],
        [T(p[3]) for p in packs], [T(p[4]) for p in packs],
        [T(p[5]) for p in packs], T(same), T(gbps), S=S)
    assert [tuple(g.shape) for g in got] == [(b, t)] * 3 + [(b, 8)]
    with jax.enable_x64(True):
        want = [np.asarray(w) for w in jdp.eft_sweep_many(
            stacks[0], order, stacks[1], stacks[2], stacks[3], stacks[4],
            same.astype(np.float64), gbps, S=S)]
    assert want[1].dtype == np.float64
    assert np.array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(_bits(g.numpy()), _bits(w))
    assert np.array_equal(got[3].numpy(), want[3])
    if S == 4:
        assert int(got[3].max()) > S - 1     # the stacks overflowed
    for k, p in enumerate(packs):
        tk = p[0].shape[0]
        one = ref.eft_sweep_ref(*(T(a) for a in p), S=S)
        for g, w in zip(got[:3], one[:3]):
            assert torch.equal(g[k, :tk], w)
        assert torch.equal(got[3][k], one[3])


def test_many_lane_wrappers_refuse_cpu_tensors():
    packs, same, gbps = _lanes(2)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        tdp.eft_sweep_many([T(packs[0][0])], T(packs[0][1][None]),
                           [T(packs[0][2])], [T(packs[0][3])],
                           [T(packs[0][4])], [T(packs[0][5])], T(same),
                           T(gbps), S=4)
    tab = tfused._PlanContext(_dags(np.random.default_rng(0), 5, "w")[1],
                              _nodes(np.random.default_rng(0), 3)[1])
    with pytest.raises(ValueError, match="CUDA"):
        tdp.upward_rank([torch.zeros((5, 3), dtype=torch.float64)],
                        [tab.rank_table])


# --- replan_many -----------------------------------------------------------

def _fleet(seed, sizes=((60, "A"), (45, "A"), (52, "A"), (40, "B"))):
    """Two clusters (8 and 5 nodes) and one DAG a request, in both
    packages, the planes of each package over one service: the port's
    OnlinePredictor serves the reference's fitted posteriors, and both
    know every node's microbenchmark."""
    rng = np.random.default_rng(seed)
    traces = []
    for j, t in enumerate(TASK_TYPES):
        traces += [JTrace("wf", t, "local", s, 2.0 + j + (15.0 + 6 * j) * s)
                   for s in np.linspace(0.05, 0.4, 6)]
    lot = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    lot.fit(traces)
    carried = convert.predictor_from_state(convert.predictor_state(lot),
                                           device="cpu")
    clusters = {"A": _nodes(rng, 8), "B": _nodes(rng, 5)}
    jb = {n.name: jbench(n, 1) for c in clusters.values() for n in c[0]}
    tb = {n.name: tbench(n, 1) for c in clusters.values() for n in c[1]}
    jon, ton = JOnline(lot, jb), TOnline(carried, tb, device="cpu")
    jsvc, tsvc = JService(jon, jb), TService(ton, tb, device="cpu")
    out = []
    for k, (n, c) in enumerate(sizes):
        jdag, tdag = _dags(rng, n, f"wf{k}")
        out.append(((jdag, clusters[c][0]), (tdag, clusters[c][1])))
    return jsvc, tsvc, out


def _observe(jsvc, tsvc, rng, nodes, k0):
    for k in range(6):
        args = ("fused", f"obs{k0}-{k}", TASK_TYPES[(k0 + k) % 4],
                nodes[k % len(nodes)], float(rng.uniform(0.1, 0.5)),
                float(rng.uniform(10.0, 60.0)))
        jsvc.predictor.observe(JComp(*args, finish_time=float(k)))
        tsvc.predictor.observe(TComp(*args, finish_time=float(k)))


def _same_schedule(a, b):
    assert a.assignment == b.assignment
    assert a.order == b.order
    assert a.est == b.est


@pytest.mark.parametrize("case", [None, 0.5, 0.95, "constrained"])
def test_replan_many_matches_reference_and_heft(case):
    q = 0.95 if case == "constrained" else case
    jsvc, tsvc, reqs = _fleet(13)
    jplanes = [jfused.FusedPlane(jsvc, n, dag=d) for (d, n), _ in reqs]
    tplanes = [tfused.FusedPlane(tsvc, n, dag=d) for _, (d, n) in reqs]
    twins = [tfused.FusedPlane(tsvc, n, dag=d) for _, (d, n) in reqs]
    rng = np.random.default_rng(4)
    kw = [{} for _ in reqs]
    if case == "constrained":
        (jdag, jnodes), _ = reqs[1]
        kw[1] = {"ready_at": {u: float(rng.uniform(0.0, 20.0))
                              for u in jdag.tasks},
                 "node_available": {n.name: float(rng.uniform(0.0, 30.0))
                                    for n in jnodes[::2]}}
    # the A-cluster lanes start with 2 interval columns, so the group's
    # sweep overflows and runs again at twice the columns
    for p, (_, (d, n)) in list(zip(tplanes, reqs))[:3]:
        tfused._context(d, n, p.rank_cache).slot_cap = 2
    remote = [reqs[0][0][1][0].name, reqs[3][0][1][1].name, "local"]
    for rnd in range(3):
        if rnd == 1:
            _observe(jsvc, tsvc, rng, remote, rnd)
        jgot = jfused.replan_many(
            [jfused.ReplanRequest(p, d, quantile=q, **a)
             for p, ((d, _), _), a in zip(jplanes, reqs, kw)],
            fuse_sweeps=False)
        tgot = tfused.replan_many(
            [tfused.ReplanRequest(p, d, quantile=q, **a)
             for p, (_, (d, _)), a in zip(tplanes, reqs, kw)])
        twin = tfused.replan_many(
            [tfused.ReplanRequest(p, d, quantile=q, **a)
             for p, (_, (d, _)), a in zip(twins, reqs, kw)],
            fuse_sweeps=False)
        for k, ((jdag, jnodes), _) in enumerate(reqs):
            entries = [(u, t.task_name, t.input_gb)
                       for u, t in jdag.tasks.items()]
            want = jheft(jdag, jnodes, JMatrix.from_service(
                jsvc, entries, jnodes), quantile=q, **kw[k])
            _same_schedule(jgot[k], want)
            _same_schedule(tgot[k], want)
            _same_schedule(twin[k], want)
    assert tplanes[0].rank_cache and all(
        c.slot_cap >= 4 for c in tplanes[0].rank_cache.values())
    for jp, tp, tw in zip(jplanes, tplanes, twins):
        want = dataclasses.asdict(jp.stats)
        assert dataclasses.asdict(tw.stats) == want
        # the fused path counts one sweep dispatch a request a round, as
        # the reference's fused path counts
        assert dataclasses.asdict(tp.stats) == dict(want, sweep_dispatches=3)
        assert tp.stats.rounds == 3 and tp.stats.full_gathers == 1
        assert tp.w_host_copies == 0


def test_replan_many_dispatches_once_per_round_and_group(monkeypatch):
    """Four requests, two on each cluster: a round with dirty rows makes
    one predictive dispatch, and every round one rank dispatch and one
    many-lane sweep dispatch per cluster (no single-lane sweep); a round
    with nothing moved makes no predictive dispatch."""
    jsvc, tsvc, reqs = _fleet(7, ((30, "A"), (24, "B"), (28, "A"),
                                  (20, "B")))
    planes = [tfused.FusedPlane(tsvc, n, dag=d) for _, (d, n) in reqs]
    calls = {"bayes_predict": [], "upward_rank": [], "eft_sweep_many": [],
             "eft_sweep": []}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name].append(a)
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, counted)

    def round_():
        for v in calls.values():
            v.clear()
        got = tfused.replan_many([tfused.ReplanRequest(p, d, quantile=0.95)
                                  for p, (_, (d, _)) in zip(planes, reqs)])
        return got, {k: len(v) for k, v in calls.items()}

    cold, n = round_()
    assert n == {"bayes_predict": 1, "upward_rank": 2, "eft_sweep_many": 2,
                 "eft_sweep": 0}
    assert sorted(len(a[0]) for a in calls["eft_sweep_many"]) == [2, 2]
    assert calls["bayes_predict"][0][0].q == sum(
        len(p.uids) for p in planes)
    warm, n = round_()
    assert n == {"bayes_predict": 0, "upward_rank": 2, "eft_sweep_many": 2,
                 "eft_sweep": 0}
    for a, b in zip(cold, warm):
        _same_schedule(a, b)
    _observe(jsvc, tsvc, np.random.default_rng(1), ["local"], 0)
    _, n = round_()
    assert n["bayes_predict"] == 1
    for p in planes:
        assert p.stats.predict_dispatches == 2
        assert p.stats.sweep_dispatches == 3


def test_replan_many_writes_every_plane_in_one_predictive(monkeypatch):
    """A round with dirty rows is one predictive call whose targets are
    the dirty planes' resident rows, in request order, each at the first
    of its rows in the slab; no index copy follows, and the schedules stay
    the reference's."""
    jsvc, tsvc, reqs = _fleet(19)
    jplanes = [jfused.FusedPlane(jsvc, n, dag=d) for (d, n), _ in reqs]
    tplanes = [tfused.FusedPlane(tsvc, n, dag=d) for _, (d, n) in reqs]

    def refuse(*a, **k):
        raise AssertionError("an index copy on the replan path")
    monkeypatch.setattr(torch.Tensor, "index_copy_", refuse)
    calls = []
    real = ops.bayes_predict

    def predict(batch):
        calls.append(batch)
        return real(batch)
    monkeypatch.setattr(ops, "bayes_predict", predict)
    rng = np.random.default_rng(8)
    for rnd in range(3):
        if rnd:
            _observe(jsvc, tsvc, rng, ["local"], rnd)
        calls.clear()
        jgot = jfused.replan_many(
            [jfused.ReplanRequest(p, d, quantile=0.95)
             for p, ((d, _), _) in zip(jplanes, reqs)], fuse_sweeps=False)
        tgot = tfused.replan_many(
            [tfused.ReplanRequest(p, d, quantile=0.95)
             for p, (_, (d, _)) in zip(tplanes, reqs)])
        for a, b in zip(tgot, jgot):
            _same_schedule(a, b)
        batch, = calls
        firsts = np.cumsum([0] + [len(p.uids) for p in tplanes])
        assert batch.q == firsts[-1]
        assert slab_table(batch)[:, 0].tolist() == firsts[:-1].tolist()
        assert all(t.mean is p._mean_raw and t.std is p._std_raw
                   for t, p in zip(batch.targets, tplanes))
    for jp, tp in zip(jplanes, tplanes):
        assert dataclasses.asdict(tp.stats) == dict(
            dataclasses.asdict(jp.stats), sweep_dispatches=3)


def test_replan_many_refuses_mixed_devices():
    _, tsvc, reqs = _fleet(3, ((10, "A"), (12, "A")))
    planes = [tfused.FusedPlane(tsvc, n, dag=d) for _, (d, n) in reqs]
    planes[1].device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        tfused.replan_many([tfused.ReplanRequest(p, d)
                            for p, (_, (d, _)) in zip(planes, reqs)])
