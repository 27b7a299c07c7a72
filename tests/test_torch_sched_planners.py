"""The port's consumers of the predictions — cloud cost (`sched.cost`),
carbon-aware shifting (`sched.carbon`) and elastic scaling
(`sched.elastic`) — against the JAX package on the same inputs, on the
CPU.  All three are host float64 code in the reference's expressions, so
every number is compared bitwise."""
import dataclasses

import numpy as np
import pytest

from repro.sched import carbon as jcarbon
from repro.sched import cost as jcost
from repro.sched import elastic as jelastic
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.sched.heft import heft_schedule_matrix as jheft
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.sched.plane import RuntimeDist as JDist
from repro.workflow.generator import GroundTruth as JGT
from repro.workflow.generator import build_workflow as jbuild
from repro.workflow.simulator import execute_schedule as jexec
from repro.workflow.simulator import random_cluster as jcluster
from repro_torch.sched import carbon as tcarbon
from repro_torch.sched import cost as tcost
from repro_torch.sched import elastic as telastic
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.sched.heft import heft_schedule_matrix as theft
from repro_torch.sched.plane import PredictionMatrix as TMatrix
from repro_torch.sched.plane import RuntimeDist as TDist
from repro_torch.workflow.generator import GroundTruth as TGT
from repro_torch.workflow.generator import build_workflow as tbuild
from repro_torch.workflow.simulator import execute_schedule as texec
from repro_torch.workflow.simulator import random_cluster as tcluster


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


# --- carbon ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("region", jcarbon.REGIONS)
def test_intensity_series_bitwise(region, seed):
    assert tcarbon.REGIONS == jcarbon.REGIONS
    got = tcarbon.intensity_series(region, seed)
    want = jcarbon.intensity_series(region, seed)
    assert got.shape == want.shape == (tcarbon.HOURS,)
    assert np.array_equal(_bits(got), _bits(want))
    for start, dur, kw in ((0.0, 5.5, 1.2), (17.25, 30.0, 0.4),
                           (600.0, 200.0, 2.0)):
        assert (tcarbon.emissions_g(got, start, dur, kw)
                == jcarbon.emissions_g(want, start, dur, kw))


@pytest.mark.parametrize("policy", ["semi_weekly", "next_monday"])
@pytest.mark.parametrize("kind", ["float", "dist"])
def test_shift_workload_bitwise(policy, kind):
    assert tcarbon.candidate_starts(policy) == jcarbon.candidate_starts(
        policy)
    rng = np.random.default_rng(11)
    for region in jcarbon.REGIONS:
        for _ in range(4):
            mean, std = rng.uniform(0.5, 40.0), rng.uniform(0.0, 8.0)
            actual = float(mean * rng.uniform(0.6, 1.6))
            power = float(rng.uniform(0.1, 3.0))
            for q in (0.5, 0.95):
                pred = ((float(mean), float(mean)) if kind == "float"
                        else (TDist(mean, std), JDist(mean, std)))
                got = tcarbon.shift_workload(region, policy, pred[0], actual,
                                             power, seed=1, q=q)
                want = jcarbon.shift_workload(region, policy, pred[1],
                                              actual, power, seed=1, q=q)
                assert (dataclasses.asdict(got)
                        == dataclasses.asdict(want))
                assert got.savings_pct == want.savings_pct


# --- cost -----------------------------------------------------------------------

def _costed(build, gt_cls, cluster, machines, matrix_cls, heft, execute):
    """A seeded schedule of chipseq on an 8-node cluster from a noisy
    prediction matrix, and its execution with the true runtimes."""
    dag = build("chipseq", seed=2)
    gt = gt_cls("chipseq", seed=2)
    rng = np.random.default_rng(4)
    nodes = cluster(rng, list(machines), n_nodes=8)
    uids = list(dag.tasks)
    true = np.asarray([[gt.runtime(dag.tasks[u].task_name,
                                   dag.tasks[u].input_gb, n, u)
                        for n in nodes] for u in uids])
    means = true * rng.uniform(0.7, 1.3, true.shape)
    stds = means * rng.uniform(0.02, 0.3, true.shape)
    mat = matrix_cls(uids, [n.name for n in nodes], means, stds)
    sched = heft(dag, nodes, mat)
    res = execute(dag, sched, nodes,
                  lambda u, n: gt.runtime(dag.tasks[u].task_name,
                                          dag.tasks[u].input_gb, n, u))
    return sched, mat, res, nodes


@pytest.fixture(scope="module")
def costed():
    return (_costed(jbuild, JGT, jcluster, JMACHINES, JMatrix, jheft, jexec),
            _costed(tbuild, TGT, tcluster, TMACHINES, TMatrix, theft, texec))


@pytest.mark.parametrize("billing", ["minute", "hourly"])
def test_costs_bitwise(billing, costed):
    (js, jm, jr, jn), (ts, tm, tr, tn) = costed
    assert ts.est == js.est and tr.node_busy == jr.node_busy
    pairs = [(tcost.predicted_cost(ts, tn, billing),
              jcost.predicted_cost(js, jn, billing)),
             (tcost.actual_cost(tr, tn, billing),
              jcost.actual_cost(jr, jn, billing))]
    for q in (0.5, 0.9, 0.95):
        pairs.append((tcost.predicted_cost_quantile(ts, tm, tn, billing, q),
                      jcost.predicted_cost_quantile(js, jm, jn, billing, q)))
    for got, want in pairs:
        assert got == want and got > 0.0
    pred, act = pairs[0][0], pairs[1][0]
    assert (tcost.cost_deviation_pct(pred, act)
            == jcost.cost_deviation_pct(pred, act))
    with pytest.raises(ValueError):
        tcost.predicted_cost(ts, tn, "daily")


# --- elastic --------------------------------------------------------------------

def test_elastic_helpers_bitwise():
    rng = np.random.default_rng(8)
    for _ in range(40):
        step, ckpt = rng.uniform(0.01, 5.0), rng.uniform(1.0, 600.0)
        mtbf, n = rng.uniform(3600.0, 1e7), int(rng.integers(1, 4096))
        assert (telastic.young_daly_interval_s(ckpt, mtbf)
                == jelastic.young_daly_interval_s(ckpt, mtbf))
        every = telastic.checkpoint_every_n_steps(step, ckpt, mtbf, n)
        assert every == jelastic.checkpoint_every_n_steps(step, ckpt, mtbf,
                                                          n)
        assert (telastic.expected_waste_fraction(step, every, ckpt, mtbf, n)
                == jelastic.expected_waste_fraction(step, every, ckpt, mtbf,
                                                    n))
    assert telastic.young_daly_interval_s(0.0, 0.0) == \
        jelastic.young_daly_interval_s(0.0, 0.0)


@pytest.mark.parametrize("deadline_h", [0.5, 4.0, 48.0, 1e-3])
def test_choose_workers_bitwise(deadline_h):
    rng = np.random.default_rng(int(deadline_h * 1000))
    for _ in range(10):
        steps = int(rng.integers(100, 200000))
        mean, std = rng.uniform(0.05, 3.0), rng.uniform(0.0, 0.5)
        for eff in (0.92, 0.75):
            got = telastic.choose_workers(steps, mean, std, deadline_h, 64,
                                          scaling_efficiency=eff)
            want = jelastic.choose_workers(steps, mean, std, deadline_h, 64,
                                           scaling_efficiency=eff)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
