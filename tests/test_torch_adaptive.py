"""The port's online path — speculation policy, adaptive execution and the
in-flight rescheduler — against live runs of the JAX package, on the CPU.

  * (a) `straggler_threshold`, `decide_speculation`, `speculative_finish`
    and the `SpeculationPolicy` defaults are bitwise the reference's.
  * (b) `execute_adaptive` under one deterministic stub planner gives
    records, makespan and counters bitwise the reference's, with node
    failures, a straggler factor and both budget caps; a planner without
    `decide_speculation` raises TypeError.
  * (c) The golden-replay scenario (eager, seed 0, 20 nodes, 8 %
    stragglers x 5, drift C2 2.5 / N2 0.6, speculation at q 0.95) run live
    through both packages: the port's predictor carried from the JAX fit
    (`repro_torch.convert`), the port on the numpy engine and on the
    device engine (`device="cpu"`: the plain rank and sweep), the
    reference on numpy.  Records, `RescheduleStats`, backup counters and
    the served predictions after the run are bitwise equal; `PlaneStats`
    equal the reference plane's.
  * (d) A quantile planner with a narrow band (z 0.5) and a cooldown, and
    two planners sharing one store under different workflow ids.
  * (e) The frontier's ready-rows array is bitwise the reference's
    per-(task, node) closure at a mid-run state.
  * (f) A device-engine replan makes no host copy of W.
  * (g) `device="cuda"` raises without a card.

Fixed seeds, workflows of 74-145 tasks on 6-20 nodes; no hypothesis."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.online import OnlinePredictor as JOnline
from repro.online import OnlineReschedulingPlanner as JPlanner
from repro.online.events import PredictionQuery as JQuery
from repro.sched import straggler as jstrag
from repro.sched.cluster import LOCAL as JLOCAL
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.sched.heft import Schedule as JSchedule
from repro.sched.heft import comm_seconds as jcomm
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.store import PosteriorStore as JStore
from repro.workflow import simulator as jsim
from repro.workflow.generator import GroundTruth as JGT
from repro.workflow.generator import build_workflow as jbuild
from repro.workflow.profiling import local_profiling as jprofile
from repro_torch import convert
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.online import OnlinePredictor as TOnline
from repro_torch.online import OnlineReschedulingPlanner as TPlanner
from repro_torch.online import RescheduleStats as TStats
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.sched import straggler as tstrag
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.sched.heft import Schedule as TSchedule
from repro_torch.sched.plane import PredictionMatrix as TMatrix
from repro_torch.store import PosteriorStore as TStore
from repro_torch.workflow import simulator as tsim
from repro_torch.workflow.generator import GroundTruth as TGT
from repro_torch.workflow.generator import build_workflow as tbuild

SEED = 0
N_NODES = 20
STRAGGLER_FRAC, STRAGGLER_FACTOR = 0.08, 5.0
DRIFT = {"C2": 2.5, "N2": 0.6}           # tests/test_replay_golden.py
# the plane's counters that the reference planner's plane keeps the same
# way (the reference planner places off host row subsets, not through its
# plane's cost view and sweep, so those two counters differ by design)
SHARED_PLANE_STATS = ("rounds", "full_gathers", "rows_refreshed",
                      "predict_dispatches", "matrix_rebuilds")

JAX = dict(Planner=JPlanner, Online=JOnline, Query=JQuery, sim=jsim,
           strag=jstrag, Schedule=JSchedule, Matrix=JMatrix, Store=JStore,
           GT=JGT, build=jbuild, machines=JMACHINES, bench=jbench)
TORCH = dict(Planner=TPlanner, Online=TOnline, Query=TQuery, sim=tsim,
             strag=tstrag, Schedule=TSchedule, Matrix=TMatrix, Store=TStore,
             GT=TGT, build=tbuild, machines=TMACHINES, bench=tbench)


def _records(res):
    return [(r.uid, r.node, r.start, r.finish, r.attempt)
            for r in res.records]


def _result(res):
    return (_records(res), res.makespan, res.n_reschedules, res.n_backups,
            res.backup_waste_s, res.node_busy)


# --- (a) the speculation policy -------------------------------------------------

def test_speculation_policy_bitwise_reference():
    assert (dataclasses.asdict(tstrag.SpeculationPolicy())
            == dataclasses.asdict(jstrag.SpeculationPolicy()))
    assert tsim.SpeculationPolicy is tstrag.SpeculationPolicy
    rng = np.random.default_rng(5)
    means = rng.uniform(1.0, 500.0, 64)
    stds = np.concatenate([rng.uniform(0.0, 80.0, 60), [0.0, 1e-12, -1.0,
                                                         1e-9]])
    for q in (0.5, 0.9, 0.95, 0.999, 1e-6):
        for m, s in zip(means, stds):
            got = tstrag.straggler_threshold(float(m), float(s), q)
            want = jstrag.straggler_threshold(float(m), float(s), q)
            assert type(got) is type(want) and got == want
    names = [f"n{j}" for j in range(7)]
    nodes = [dataclasses.replace(TMACHINES[j % 5], name=nm)
             for j, nm in enumerate(names)]
    mean_rows = rng.uniform(5.0, 100.0, (12, 7))
    mean_rows[3, 2] = mean_rows[3, 5]            # a tie among idle nodes
    std_rows = rng.uniform(0.0, 20.0, (12, 7))
    uids = [f"u{i}" for i in range(12)]
    tm = TMatrix(uids, names, mean_rows, std_rows)
    jm = JMatrix(uids, names, mean_rows, std_rows)
    for i, u in enumerate(uids):
        idle = [nodes[j] for j in range(7) if rng.random() < 0.6]
        for elapsed in rng.uniform(0.0, 160.0, 4):
            for q in (0.9, 0.95):
                node = names[i % 7]
                got = tstrag.decide_speculation(float(elapsed), tm.row(u),
                                                node, idle, q=q)
                want = jstrag.decide_speculation(float(elapsed), jm.row(u),
                                                 node, idle, q=q)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a, b, c in rng.uniform(0.0, 300.0, (20, 3)):
        assert (tstrag.speculative_finish(a, b, c)
                == jstrag.speculative_finish(a, b, c))


# --- (b) the executor under a stub planner ----------------------------------------

class _StubPlanner:
    """A deterministic planner in one package's types: nodes round-robin
    over topo order, a re-plan every `every` completions that rotates the
    frontier by one node, and a straggler verdict from a fixed multiple of
    each task's size."""

    def __init__(self, pkg, dag, nodes, every=9, speculate=True):
        self.pkg, self.dag, self.nodes, self.every = pkg, dag, nodes, every
        self.n = 0
        if speculate:
            self.decide_speculation = self._decide

    def _schedule(self, uids, shift):
        sched = self.pkg["Schedule"](order={n.name: [] for n in self.nodes})
        for i, u in enumerate(uids):
            name = self.nodes[(i + shift) % len(self.nodes)].name
            sched.assignment[u] = name
            sched.order[name].append(u)
        return sched

    def initial_schedule(self):
        return self._schedule(self.dag.topo_order(), 0)

    def on_completion(self, rec, state):
        self.n += 1
        if self.n % self.every:
            return None
        return self._schedule([u for u in self.dag.topo_order()
                               if u not in state.started], self.n)

    def _decide(self, uid, node, elapsed_s, idle_nodes, q=0.95):
        thr = 40.0 * self.dag.tasks[uid].input_gb + 5.0
        if elapsed_s <= thr or not idle_nodes:
            return self.pkg["strag"].SpeculationDecision(thr, False)
        best = sorted(n.name for n in idle_nodes)[-1]
        return self.pkg["strag"].SpeculationDecision(thr, True, best)


def _stub_run(pkg, spec_kw, failures):
    gt = pkg["GT"]("chipseq", seed=1)
    dag = pkg["build"]("chipseq", seed=1)
    rng = np.random.default_rng(7)
    nodes = pkg["sim"].random_cluster(rng, list(pkg["machines"]), n_nodes=6)
    slow = {u for u in sorted(dag.tasks) if rng.random() < 0.15}

    def true_rt(uid, node):
        t = dag.tasks[uid]
        return gt.runtime(t.task_name, t.input_gb, node, uid)
    spec = (None if spec_kw is None
            else pkg["sim"].SpeculationPolicy(**spec_kw))
    planner = _StubPlanner(pkg, dag, nodes)
    return pkg["sim"].execute_adaptive(
        dag, nodes, planner, true_rt,
        failures={nodes[1].name: failures} if failures else None,
        straggler_factor=lambda u: 4.0 if u in slow else 1.0,
        speculation=spec)


@pytest.mark.parametrize("spec_kw,failures", [
    (None, None),
    (None, 2000.0),
    (dict(q=0.9, check_interval_s=10.0), None),
    (dict(check_interval_s=10.0), 4300.0),
    (dict(check_interval_s=10.0, max_concurrent_backups=1), None),
    (dict(check_interval_s=10.0, max_total_backups=2), 2000.0),
], ids=["plain", "failure", "speculation", "speculation-failure",
        "concurrent-cap", "total-cap"])
def test_execute_adaptive_stub_planner_bitwise(spec_kw, failures):
    want = _stub_run(JAX, spec_kw, failures)
    got = _stub_run(TORCH, spec_kw, failures)
    assert _result(got) == _result(want)
    assert got.n_reschedules > 0
    if spec_kw is not None:
        assert got.n_backups > 0
    if spec_kw and "max_total_backups" in spec_kw:
        assert got.n_backups == spec_kw["max_total_backups"]
    if spec_kw and "max_concurrent_backups" in spec_kw:
        uncapped = _stub_run(TORCH, dict(check_interval_s=10.0), failures)
        assert _records(uncapped) != _records(got)
    assert any(r.attempt for r in got.records) == bool(failures)


def test_execute_adaptive_needs_decide_speculation():
    for pkg in (JAX, TORCH):
        dag = pkg["build"]("bacass", seed=0)
        nodes = list(pkg["machines"])
        planner = _StubPlanner(pkg, dag, nodes, speculate=False)
        with pytest.raises(TypeError, match="decide_speculation"):
            pkg["sim"].execute_adaptive(
                dag, nodes, planner, lambda u, n: 1.0,
                speculation=pkg["sim"].SpeculationPolicy())


# --- (c)-(f) the rescheduler against live reference runs -------------------------

@pytest.fixture(scope="module")
def fitted():
    """The eager workflow's Lotaru-G fit in the JAX package, and the same
    posteriors carried into the port."""
    traces, _ = jprofile("eager", JGT("eager", seed=SEED), training_set=0)
    lot = JLotaru("G", local_bench=jbench(JLOCAL, 1)).fit(traces)
    carried = convert.predictor_from_state(convert.predictor_state(lot),
                                           device="cpu")
    return lot, carried


def _scenario(pkg, fitted, workflow="eager"):
    lot = fitted[0] if pkg is JAX else fitted[1]
    gt = pkg["GT"](workflow, seed=SEED)
    dag = pkg["build"](workflow, seed=SEED)
    benches = {n.name: pkg["bench"](n, 1) for n in pkg["machines"]}
    rng = np.random.default_rng(SEED)
    nodes = pkg["sim"].random_cluster(rng, list(pkg["machines"]),
                                      n_nodes=N_NODES)
    stragglers = {u for u in sorted(dag.tasks)
                  if rng.random() < STRAGGLER_FRAC}

    def true_rt(uid, node):
        t = dag.tasks[uid]
        return gt.runtime(t.task_name, t.input_gb, node, uid) \
            * DRIFT.get(node.name.rsplit("-", 1)[0], 1.0)
    return dict(lot=lot, dag=dag, benches=benches, nodes=nodes,
                stragglers=stragglers, true_rt=true_rt)


def _online(pkg, sc):
    if pkg is JAX:
        return JOnline(sc["lot"], benches=sc["benches"])
    return TOnline(sc["lot"], benches=sc["benches"], device="cpu")


def _planner(pkg, sc, engine, online=None, **kw):
    online = online if online is not None else _online(pkg, sc)
    if pkg is TORCH:
        kw["device"] = "cpu"
    return pkg["Planner"](sc["dag"], sc["nodes"], online,
                          benches=sc["benches"], engine=engine, **kw)


def _execute(pkg, sc, planner):
    return pkg["sim"].execute_adaptive(
        sc["dag"], sc["nodes"], planner, sc["true_rt"],
        straggler_factor=lambda u: (STRAGGLER_FACTOR
                                    if u in sc["stragglers"] else 1.0),
        speculation=pkg["sim"].SpeculationPolicy(q=0.95,
                                                 check_interval_s=15.0))


def _served(pkg, sc, planner):
    """The post-run probe sweep of tests/test_replay_golden.py."""
    dag = sc["dag"]
    probe = [None] + [n.name for n in sc["nodes"][:4]]
    queries = [pkg["Query"](dag.tasks[u].task_name, nn, dag.tasks[u].input_gb)
               for u in sorted(dag.tasks)[:16] for nn in probe]
    return np.asarray(planner.service.predict_batch(queries), np.float64)


def _plane_stats(planner):
    st = dataclasses.asdict(planner._plane.stats)
    return {k: st[k] for k in SHARED_PLANE_STATS}


@pytest.fixture(scope="module")
def golden_reference(fitted):
    sc = _scenario(JAX, fitted)
    planner = _planner(JAX, sc, "numpy")
    res = _execute(JAX, sc, planner)
    return res, planner, _served(JAX, sc, planner)


def _no_host_w(planner):
    def refuse(quantile):
        raise AssertionError("the device engine asked for W on the host")
    planner._plane._host_costs = refuse


@pytest.mark.parametrize("engine", ["numpy", "device"])
def test_golden_scenario_bitwise_reference(engine, fitted, golden_reference):
    want, jplanner, jserved = golden_reference
    sc = _scenario(TORCH, fitted)
    planner = _planner(TORCH, sc, engine)
    if engine == "device":
        _no_host_w(planner)
    got = _execute(TORCH, sc, planner)
    assert _records(got) == _records(want)
    assert _result(got) == _result(want)
    assert want.n_reschedules > 0 and want.n_backups > 0
    assert isinstance(planner.stats, TStats)
    assert dataclasses.asdict(planner.stats) == dataclasses.asdict(
        jplanner.stats)
    assert np.array_equal(_served(TORCH, sc, planner), jserved)
    assert _plane_stats(planner) == _plane_stats(jplanner)
    st = planner._plane.stats
    rounds = 1 + got.n_reschedules
    assert st.rounds == st.cost_rebuilds == rounds
    assert st.sweep_dispatches == (rounds if engine == "device" else 0)
    # (f) a device-engine pass leaves W on the device
    assert planner._plane.w_host_copies == (0 if engine == "device"
                                            else rounds)


def test_quantile_planner_with_cooldown_bitwise_reference(fitted):
    out = {}
    for pkg, engine in ((JAX, "numpy"), (TORCH, "device")):
        sc = _scenario(pkg, fitted)
        planner = _planner(pkg, sc, engine, quantile=0.9, cooldown=3,
                           z=0.5)
        res = _execute(pkg, sc, planner)
        out[pkg is TORCH] = (_result(res), dataclasses.asdict(planner.stats),
                             _plane_stats(planner),
                             _served(pkg, sc, planner))
    want, got = out[False], out[True]
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert np.array_equal(got[3], want[3])
    assert got[1]["drift_events"] > got[1]["reschedules"] > 0


def test_planners_sharing_a_store_bitwise_reference(fitted):
    """Two runs of the workflow under workflow ids "run-a" and "run-b" of
    one tenant, on one store, each planner with its own predictor: the
    second run's plane starts after the first's generations."""
    out = {}
    for pkg, engine in ((JAX, "numpy"), (TORCH, "numpy")):
        sc = _scenario(pkg, fitted)
        store = pkg["Store"]()
        planners = [_planner(pkg, sc, engine, store=store, tenant="acme",
                             workflow=wid) for wid in ("run-a", "run-b")]
        results = [_result(_execute(pkg, sc, p)) for p in planners]
        out[pkg is TORCH] = (results, [_plane_stats(p) for p in planners],
                             [dataclasses.asdict(p.stats) for p in planners],
                             store.generation,
                             [_served(pkg, sc, p) for p in planners])
    want, got = out[False], out[True]
    assert got[:4] == want[:4]
    for a, b in zip(got[4], want[4]):
        assert np.array_equal(a, b)
    assert got[1][1]["full_gathers"] == 1


def test_ready_rows_bitwise_reference_closure(fitted):
    """At the first re-plan of the golden scenario: the (T, N) ready-time
    array against the reference's closure (src/repro/online/
    rescheduler.py:222-230, with the reference's comm_seconds) evaluated
    cell by cell in the sub-DAG's topo order."""
    seen = []

    class Probe(TPlanner):
        def _replan(self, state, frontier):
            sub, ctx = self._frontier_dag(frontier)
            done_at, node_avail = self._running_ends(state)
            ready = self._ready_rows(ctx, frontier, done_at, state.now)
            node_by_name = {n.name: n for n in self.nodes}

            def ready_at(uid, node):
                r = state.now
                for d in self.dag.tasks[uid].deps:
                    if d in frontier:
                        continue
                    dn_name, end = done_at[d]
                    r = max(r, end + jcomm(self.dag.tasks[d].output_gb,
                                           node_by_name[dn_name], node))
                return r
            want = np.asarray([[ready_at(u, n) for n in self.nodes]
                               for u in sub.topo_order()], np.float64)
            seen.append((ready, want, len(state.running)))
            return super()._replan(state, frontier)

    sc = _scenario(TORCH, fitted)
    planner = Probe(sc["dag"], sc["nodes"], _online(TORCH, sc),
                    benches=sc["benches"], engine="numpy", device="cpu")
    _execute(TORCH, sc, planner)
    assert seen
    for ready, want, _ in seen:
        assert ready.shape == want.shape
        assert np.array_equal(ready.view(np.int64), want.view(np.int64))
    # the constraints bind: some cells past `now`, on a comm charge
    assert any((r > r.min()).any() for r, _, _ in seen)
    assert any(n for _, _, n in seen)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")


def test_planner_on_cuda_raises_without_a_card(no_card, fitted):
    sc = _scenario(TORCH, fitted, "bacass")
    online = TOnline(sc["lot"], benches=sc["benches"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPlanner(sc["dag"], sc["nodes"], online, benches=sc["benches"],
                 engine="device", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPlanner(sc["dag"], sc["nodes"], online, benches=sc["benches"])
