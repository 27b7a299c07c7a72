"""Fixtures of the port's serving-tier tests that import the port only:
a deterministic multi-tenant predictor fleet on the CPU and the shard
bootstrap that port shard children import
(`tests.torch_serve_helpers:bootstrap`; the supervisor starts them with
the repo root as their working directory).  The fleet is
`tests/serve_helpers.py`'s, fitted by the port's `LotaruPredictor` on
device="cpu", so a child that imports this module pulls in no JAX."""
import numpy as np

from repro_torch.core.microbench import simulate_microbench
from repro_torch.core.predictor import LotaruPredictor
from repro_torch.core.traces import TraceRow
from repro_torch.online import OnlinePredictor
from repro_torch.sched.cluster import LOCAL, TARGET_MACHINES

TENANTS = [("acme", "rnaseq"), ("globex", "atacseq"),
           ("initech", "chipseq"), ("umbrella", "mag")]
TASKS = ("bwa", "idx", "sort")


def make_traces(task, n=6, slope=30.0, base=4.0):
    return [TraceRow("wf", task, "local", s, base + slope * s)
            for s in np.linspace(0.05, 0.4, n)]


def make_predictor(tasks=TASKS, salt=0):
    lot = LotaruPredictor("G", local_bench=simulate_microbench(LOCAL, 1),
                          device="cpu")
    traces = []
    for j, t in enumerate(tasks):
        traces += make_traces(t, slope=20.0 + 7 * j + salt, base=2.0 + j)
    return OnlinePredictor(lot.fit(traces), device="cpu")


def make_benches():
    return {n.name: simulate_microbench(n, 1) for n in TARGET_MACHINES}


def bootstrap(shard_id, shard_map):
    """Every tenant's predictor, identically rebuilt in any process (a
    deterministic fit on the CPU); the shard binds only the namespaces
    the map places on it."""
    benches = make_benches()
    return {(t, w): (make_predictor(salt=i), benches)
            for i, (t, w) in enumerate(TENANTS)}
