"""The whole port slice against the JAX package, for each of the paper's
five workflows: profiling traces, fitted models, the prediction service
and HEFT placement plus simulation, and a replan-latency style 100x20
problem.

Traces and inputs are pure numpy in both packages and must be equal.  The
fits are float32 fixed points, held at rtol 1e-4 / atol 1e-5.  With the
reference's posteriors carried across (`repro_torch.convert`), everything
downstream is float64 host arithmetic plus the predictive, so predictions
are held bitwise and schedules and makespans must be identical."""
import dataclasses
import functools

import numpy as np
import pytest

import chip_smoke
from benchmarks import replan_latency
from repro.core import microbench as jmb
from repro.core import predictor as jpred
from repro.online import PredictionService as JService
from repro.online.events import PredictionQuery as JQuery
from repro.sched import cluster as jcl
from repro.sched import heft as jheft
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.workflow import generator as jgen
from repro.workflow import profiling as jprof
from repro.workflow import simulator as jsim
from repro_torch import convert
from repro_torch.core import microbench as tmb
from repro_torch.core import predictor as tpred
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.sched import cluster as tcl
from repro_torch.sched import heft as theft
from repro_torch.sched.plane import PredictionMatrix as TMatrix
from repro_torch.workflow import generator as tgen
from repro_torch.workflow import profiling as tprof
from repro_torch.workflow import simulator as tsim

FIT_TOL = dict(rtol=1e-4, atol=1e-5)
WORKFLOWS = jgen.WORKFLOWS


def _setup(mb, cl, gen, prof, pred_mod, wf, **kw):
    gt = gen.GroundTruth(wf, seed=0)
    traces, prof_s = prof.local_profiling(wf, gt, training_set=0)
    local = mb.simulate_microbench(cl.LOCAL, seed=1)
    benches = {n.name: mb.simulate_microbench(n, seed=1)
               for n in cl.TARGET_MACHINES}
    app_bench = {}
    for m in gen.WORKFLOW_TASKS[wf]:
        b = {"local": mb.app_benchmark_runtime(m.cpu_frac, cl.LOCAL,
                                               cl.LOCAL)}
        for n in cl.TARGET_MACHINES:
            b[n.name] = mb.app_benchmark_runtime(m.cpu_frac, n, cl.LOCAL)
        app_bench[m.name] = b
    fitted = pred_mod.LotaruPredictor("G", local_bench=local, **kw)
    fitted.fit(traces)
    preds = {}
    for v in ("G", "A", "W"):
        # the three variants share the fitted models; only factors differ
        p = pred_mod.LotaruPredictor(v, local_bench=local,
                                     app_bench=app_bench, **kw)
        p.models = fitted.models
        p.version = 1
        preds[v] = p
    return dict(gt=gt, traces=traces, prof_s=prof_s, benches=benches,
                app_bench=app_bench, preds=preds,
                dag=gen.build_workflow(wf, 0))


@functools.lru_cache(maxsize=None)
def _pair(wf):
    ref = _setup(jmb, jcl, jgen, jprof, jpred, wf)
    port = _setup(tmb, tcl, tgen, tprof, tpred, wf, device="cpu")
    # the port serving the reference's posteriors
    port["carried"] = {v: convert.predictor_from_state(
        convert.predictor_state(p), device="cpu")
        for v, p in ref["preds"].items()}
    return ref, port


def _astuples(rows):
    return [dataclasses.astuple(r) for r in rows]


@pytest.mark.parametrize("wf", WORKFLOWS)
def test_traces_and_inputs_equal(wf):
    ref, port = _pair(wf)
    assert _astuples(port["traces"]) == _astuples(ref["traces"])
    assert port["prof_s"] == ref["prof_s"]
    assert {k: dataclasses.astuple(b) for k, b in port["benches"].items()} \
        == {k: dataclasses.astuple(b) for k, b in ref["benches"].items()}
    assert port["app_bench"] == ref["app_bench"]
    assert list(port["dag"].tasks) == list(ref["dag"].tasks)
    assert [dataclasses.astuple(t) for t in port["dag"].tasks.values()] == \
        [dataclasses.astuple(t) for t in ref["dag"].tasks.values()]
    assert port["dag"].topo_order() == ref["dag"].topo_order()


@pytest.mark.parametrize("wf", WORKFLOWS)
def test_fitted_models_within_tolerance(wf):
    ref, port = _pair(wf)
    jm, tm = ref["preds"]["G"].models, port["preds"]["G"].models
    assert list(tm) == list(jm)
    for task, a in jm.items():
        b = tm[task]
        assert b.correlated == a.correlated, task
        assert (b.median_s, b.spread_s, b.cpu_fraction) == \
            (a.median_s, a.spread_s, a.cpu_fraction), task
        assert np.array_equal(b.fit_x, a.fit_x)
        assert np.array_equal(b.fit_y, a.fit_y)
        assert (a.posterior is None) == (b.posterior is None), task
        for leaf, v in (a.posterior or {}).items():
            assert b.posterior[leaf].dtype == np.asarray(v).dtype
            np.testing.assert_allclose(b.posterior[leaf], np.asarray(v),
                                       **FIT_TOL, err_msg=f"{task} {leaf}")


@pytest.mark.parametrize("wf", WORKFLOWS)
def test_service_paths_bitwise(wf):
    ref, port = _pair(wf)
    targets = [ref["benches"][n.name] for n in jcl.TARGET_MACHINES]
    tasks = list(ref["dag"].tasks.values())
    for v, jp in ref["preds"].items():
        tp = port["carried"][v]
        assert _astuples(tp.predict_rows(tasks, targets, wf)) == \
            _astuples(jp.predict_rows(tasks, targets, wf)), v
        jsvc = JService(jp, ref["benches"])
        tsvc = TService(tp, port["benches"], device="cpu")
        q = [(t.task_name, n.name, t.input_gb) for t in tasks
             for n in jcl.TARGET_MACHINES] + [(tasks[0].task_name, None, 1.5)]
        assert np.array_equal(tsvc.predict_batch([TQuery(*a) for a in q]),
                              jsvc.predict_batch([JQuery(*a) for a in q])), v
        pairs = [(t.task_name, t.input_gb) for t in tasks]
        names = [n.name for n in jcl.TARGET_MACHINES] + [None]
        for a, b in zip(tsvc.predict_matrix(pairs, names),
                        jsvc.predict_matrix(pairs, names)):
            assert np.array_equal(a, b), v


@pytest.mark.parametrize("wf", WORKFLOWS)
def test_heft_schedules_and_makespans_identical(wf):
    ref, port = _pair(wf)
    jnodes = jsim.random_cluster(np.random.default_rng(5),
                                 list(jcl.TARGET_MACHINES), 20)
    tnodes = tsim.random_cluster(np.random.default_rng(5),
                                 list(tcl.TARGET_MACHINES), 20)
    assert [dataclasses.astuple(n) for n in tnodes] == \
        [dataclasses.astuple(n) for n in jnodes]
    dag_j, dag_t = ref["dag"], port["dag"]
    entries = [(u, t.task_name, t.input_gb) for u, t in dag_j.tasks.items()]

    def true_rt(gt, dag):
        def rt(uid, node):
            t = dag.tasks[uid]
            return gt.runtime(t.task_name, t.input_gb, node, uid)
        return rt

    for v, jp in ref["preds"].items():
        jmat = JMatrix.from_service(JService(jp, ref["benches"]), entries,
                                    jnodes)
        tmat = TMatrix.from_service(
            TService(port["carried"][v], port["benches"], device="cpu"),
            entries, tnodes)
        assert np.array_equal(tmat.means, jmat.means)
        assert np.array_equal(tmat.stds, jmat.stds)
        for q in (None, 0.9):
            js = jheft.heft_schedule_matrix(dag_j, jnodes, jmat, quantile=q)
            ts = theft.heft_schedule_matrix(dag_t, tnodes, tmat, quantile=q)
            assert ts.assignment == js.assignment, (v, q)
            assert ts.order == js.order, (v, q)
            assert ts.est == js.est, (v, q)
        jr = jsim.execute_schedule(dag_j, js, jnodes,
                                   true_rt(ref["gt"], dag_j))
        tr = tsim.execute_schedule(dag_t, ts, tnodes,
                                   true_rt(port["gt"], dag_t))
        assert tr.makespan == jr.makespan, v
        assert [dataclasses.astuple(r) for r in tr.records] == \
            [dataclasses.astuple(r) for r in jr.records], v


def test_replan_style_problem_100x20():
    """chip_smoke's fleet problem generator reproduces the reference's
    benchmarks/replan_latency.py `_build` input for input; with the
    reference's posteriors the 100x20 round predicts bitwise and schedules
    identically."""
    jdag, jnodes, jsvc = replan_latency._build(100, 20, 0)
    tdag, tnodes, tsvc = chip_smoke.replan_problem(100, 20, 0, "cpu")
    assert [dataclasses.astuple(t) for t in tdag.tasks.values()] == \
        [dataclasses.astuple(t) for t in jdag.tasks.values()]
    assert [dataclasses.astuple(n) for n in tnodes] == \
        [dataclasses.astuple(n) for n in jnodes]
    for task, m in jsvc.predictor.models.items():
        for leaf, v in m.posterior.items():
            np.testing.assert_allclose(
                tsvc.predictor.models[task].posterior[leaf], v, **FIT_TOL)
    carried = TService(convert.predictor_from_state(
        convert.predictor_state(jsvc.predictor), device="cpu"),
        dict(tsvc.benches), device="cpu")
    entries = [(u, t.task_name, t.input_gb) for u, t in jdag.tasks.items()]
    jmat = JMatrix.from_service(jsvc, entries, jnodes)
    tmat = TMatrix.from_service(carried, entries, tnodes)
    assert np.array_equal(tmat.means, jmat.means)
    assert np.array_equal(tmat.stds, jmat.stds)
    js = jheft.heft_schedule_matrix(jdag, jnodes, jmat)
    ts = theft.heft_schedule_matrix(tdag, tnodes, tmat)
    assert (ts.assignment, ts.order, ts.est) == \
        (js.assignment, js.order, js.est)
    ref_sched = jheft.heft_schedule_reference(
        jdag, jnodes, lambda u, n: jmat.mean(u, n.name))
    assert ts.assignment == ref_sched.assignment
