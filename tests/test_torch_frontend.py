"""The port's async batch-window front-end (`repro_torch.store.frontend`)
against the JAX package's, and the port's real microbenchmark probes
(`repro_torch.core.microbench`), on the CPU.

The same tenants (each port predictor carries the reference's fitted
posteriors through `repro_torch.convert` and takes the same completion
stream) are bound to one reference store and one port store.  The same
callers go through the reference's `AsyncPredictionFrontend(impl="numpy")`
and the port's `AsyncPredictionFrontend(device="cpu")`: every caller's
array is bitwise the reference frontend's and the port's own
`PredictionService.predict_batch` (the float64 predictive is bitwise in
both packages), and a manual flush is one predictive launch over every
caller's queries.  Then the lifecycle: auto-flush, an unknown namespace,
a failure isolated to its caller, a cancelled future, back-pressure, a
refresher started and stopped by the front-end, and `device="cuda"`
refused without a card.  Fixed seeds, two tenants."""
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.core.traces import TraceRow as JTrace
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online.events import PredictionQuery as JQuery
from repro.online.events import TaskCompletion as JComp
from repro.sched.cluster import LOCAL as JLOCAL
from repro.sched.cluster import TARGET_MACHINES as JMACHINES
from repro.store import AsyncPredictionFrontend as JFrontend
from repro.store import PosteriorStore as JStore
from repro_torch import convert
from repro_torch.core import microbench
from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.microbench import simulate_microbench as tbench
from repro_torch.kernels import ops
from repro_torch.online import FleetRefresher, OnlinePredictor
from repro_torch.online import PredictionService as TService
from repro_torch.online import RefreshPolicy
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched.cluster import TARGET_MACHINES as TMACHINES
from repro_torch.store import AsyncPredictionFrontend, QueueFullError
from repro_torch.store import PosteriorStore as TStore

TENANTS = {("acme", "wf_a"): ("bwa", "idx"),
           ("globex", "wf_b"): ("bwa", "merge")}
NODES = (None, "N1", "A2", "C2")


def _jbase(tasks, salt):
    lot = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    rows = []
    for j, t in enumerate(tasks):
        rows += [JTrace("wf", t, "local", s, 2.0 + j + (20.0 + 7 * j + salt)
                        * s) for s in np.linspace(0.05, 0.4, 6)]
    return lot.fit(rows)


class _Fleet:
    """Two tenants, each a warm OnlinePredictor in both packages, bound
    to one reference store and one port store through services."""

    def __init__(self, block_size=512):
        self.jstore, self.tstore = JStore(block_size), TStore(block_size)
        jb = {n.name: jbench(n, 1) for n in JMACHINES}
        tb = {n.name: tbench(n, 1) for n in TMACHINES}
        self.j, self.t, self.jsvc, self.tsvc = {}, {}, {}, {}
        for k, ((ten, wf), tasks) in enumerate(TENANTS.items()):
            base = _jbase(tasks, 3.0 * k)
            carried = convert.predictor_from_state(
                convert.predictor_state(base), device="cpu")
            self.j[ten] = JOnline(base, benches=jb)
            self.t[ten] = OnlinePredictor(carried, benches=tb, device="cpu")
            self.jsvc[ten] = JService(self.j[ten], jb, store=self.jstore,
                                      tenant=ten, workflow=wf)
            self.tsvc[ten] = TService(self.t[ten], tb, store=self.tstore,
                                      tenant=ten, workflow=wf, device="cpu")
            rng = np.random.default_rng(20 + k)
            for i in range(12):
                x = float(rng.uniform(0.5, 6.0))
                args = ("wf", f"u{i}", tasks[i % 2],
                        ("local", "N1", "C2")[i % 3], x,
                        float(5 + 25 * x + rng.normal(0, 1)))
                self.j[ten].observe(JComp(*args))
                self.t[ten].observe(TComp(*args))
            assert self.t[ten].export_state() == self.j[ten].export_state()


def _callers(n=10):
    """(tenant, workflow, query tuples) of n callers, alternating tenants."""
    out = []
    names = list(TENANTS)
    for i in range(n):
        ten, wf = names[i % 2]
        tasks = TENANTS[(ten, wf)]
        out.append((ten, wf, [(t, node, x) for t in tasks for node in NODES
                              for x in (0.5 + 0.1 * i, 2.0)]))
    return out


def _submit_concurrently(fe, callers, cls):
    futs = [None] * len(callers)
    barrier = threading.Barrier(len(callers))

    def submit(i):
        ten, wf, qs = callers[i]
        barrier.wait()
        futs[i] = fe.predict_async([cls(*q) for q in qs], tenant=ten,
                                   workflow=wf)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(callers))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return futs


@pytest.fixture
def launches(monkeypatch):
    """Every predictive launch through kernels.ops, by Q."""
    seen = []
    real = ops.bayes_predict
    monkeypatch.setattr(ops, "bayes_predict",
                        lambda batch: seen.append(batch.q) or real(batch))
    return seen


def test_manual_flush_coalesces_callers_into_one_launch(launches):
    """Ten concurrent callers over two tenants: one flush, one predictive
    launch over all their queries; every caller bitwise the reference
    frontend's answer and the port's predict_batch."""
    fleet = _Fleet()
    callers = _callers()
    jfe = JFrontend(fleet.jstore, impl="numpy", auto_flush=False)
    tfe = AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                  auto_flush=False)
    jfuts = _submit_concurrently(jfe, callers, JQuery)
    tfuts = _submit_concurrently(tfe, callers, TQuery)
    assert all(not f.done() for f in tfuts)       # parked in the window
    assert launches == []
    assert tfe.flush() == jfe.flush() == len(callers)
    assert tfe.dispatch_count == jfe.dispatch_count == 1
    assert tfe.coalesced == jfe.coalesced == [len(callers)]
    assert launches == [sum(len(qs) for _, _, qs in callers)]
    for (ten, _, qs), jf, tf in zip(callers, jfuts, tfuts):
        got = tf.result(timeout=5)
        np.testing.assert_array_equal(got, jf.result(timeout=5))
        np.testing.assert_array_equal(
            got, fleet.tsvc[ten].predict_batch([TQuery(*q) for q in qs]))
    assert tfe.flush() == 0 and tfe.dispatch_count == 1


def test_auto_flush_under_thread_stress_answers_every_caller_bitwise():
    """More callers than cores, with a short switch interval, through the
    auto-flushing worker while this thread calls predict_batch: no caller
    is lost or mixed up, every array is bitwise its quiet answer, and no
    flush answers more callers than were queued."""
    import sys
    fleet = _Fleet()
    callers = _callers(32)
    quiet = [fleet.tsvc[ten].predict_batch([TQuery(*q) for q in qs])
             for ten, _, qs in callers]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                     window_s=0.001) as fe:
            futs = _submit_concurrently(fe, callers, TQuery)
            for (ten, _, qs), want in zip(callers, quiet):
                np.testing.assert_array_equal(
                    fleet.tsvc[ten].predict_batch([TQuery(*q) for q in qs]),
                    want)
            got = [f.result(timeout=30) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for g, want in zip(got, quiet):
        np.testing.assert_array_equal(g, want)
    assert sum(fe.coalesced) == len(callers)
    assert fe.dispatch_count == len(fe.coalesced) <= len(callers)
    assert fe._worker is not None and not fe._worker.is_alive()


def test_auto_flush_window_resolves_futures():
    fleet = _Fleet()
    qs = [TQuery(t, n, 1.5) for t in ("bwa", "idx") for n in NODES]
    with AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                 window_s=0.01) as fe:
        futs = [fe.predict_async(qs, tenant="acme", workflow="wf_a")
                for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(
                f.result(timeout=10), fleet.tsvc["acme"].predict_batch(qs))
        assert fe.predict(qs[:2], "acme", "wf_a").shape == (2, 3)
    assert 1 <= fe.dispatch_count <= 5
    with pytest.raises(RuntimeError, match="closed"):
        fe.predict_async(qs, tenant="acme", workflow="wf_a")


def test_unknown_namespace_raises_and_empty_queries_resolve():
    fe = AsyncPredictionFrontend(TStore(), device="cpu", auto_flush=False)
    with pytest.raises(KeyError):
        fe.predict_async([TQuery("bwa", None, 1.0)], tenant="ghost")
    fleet = _Fleet()
    fe = AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                 auto_flush=False)
    f = fe.predict_async([], tenant="acme", workflow="wf_a")
    assert f.result(timeout=1).shape == (0, 3)
    assert fe.flush() == 0 and fe.dispatch_count == 0


def test_failure_isolated_to_offending_caller(launches):
    """an unknown task rejects only its caller, before anything is
    packed: the one launch holds only the good callers' queries; a caller
    whose namespace was evicted fails alone too."""
    fleet = _Fleet()
    fe = AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                 auto_flush=False)
    good = [TQuery("bwa", n, 1.0) for n in (None, "N1")]
    other = [TQuery("merge", "C2", 2.0)]
    f_good = fe.predict_async(good, tenant="acme", workflow="wf_a")
    f_bad = fe.predict_async([TQuery("no_such_task", None, 1.0)],
                             tenant="acme", workflow="wf_a")
    f_other = fe.predict_async(other, tenant="globex", workflow="wf_b")
    fleet.tstore.evict("globex", "wf_b")
    assert fe.flush() == 3
    assert fe.dispatch_count == 1 and launches == [len(good)]
    with pytest.raises(KeyError):
        f_bad.result(timeout=5)
    with pytest.raises(RuntimeError, match="evicted"):
        f_other.result(timeout=5)
    np.testing.assert_array_equal(f_good.result(timeout=5),
                                  fleet.tsvc["acme"].predict_batch(good))


def test_frontend_survives_cancelled_future():
    fleet = _Fleet()
    fe = AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                 auto_flush=False)
    qs = [TQuery("bwa", None, 1.0)]
    f1 = fe.predict_async(qs, tenant="acme", workflow="wf_a")
    f2 = fe.predict_async(qs, tenant="acme", workflow="wf_a")
    assert f1.cancel()
    assert fe.flush() == 2
    assert f1.cancelled()
    np.testing.assert_array_equal(f2.result(timeout=5),
                                  fleet.tsvc["acme"].predict_batch(qs))


def test_backpressure_cap():
    """QueueFullError once max_pending_batches caller batches are parked;
    a flush drains the window and the front-end accepts again."""
    fleet = _Fleet()
    fe = AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                 auto_flush=False, max_pending_batches=2)
    qs = [TQuery("bwa", None, 1.0)]
    futs = [fe.predict_async(qs, "acme", "wf_a") for _ in range(2)]
    with pytest.raises(QueueFullError, match="max_pending_batches=2"):
        fe.predict_async(qs, "acme", "wf_a")
    assert fe.flush() == 2
    for f in futs:
        assert f.result(timeout=5).shape == (1, 3)
    f3 = fe.predict_async(qs, "acme", "wf_a")
    fe.flush()
    assert f3.result(timeout=5).shape == (1, 3)
    with pytest.raises(ValueError):
        AsyncPredictionFrontend(fleet.tstore, device="cpu",
                                auto_flush=False, max_pending_batches=0)


def test_refresher_started_and_stopped_with_the_frontend():
    """The front-end starts its refresher and stops it on close; the
    refresh runs out of band while callers are answered, and serving after
    it is bitwise the service path."""
    fleet = _Fleet()
    online = fleet.t["acme"]
    rng = np.random.default_rng(5)
    for i in range(8):
        x = float(rng.uniform(0.5, 6.0))
        online.observe(TComp("wf", f"d{i}", "bwa", "local", x,
                             float(4.0 + 35.0 * x + rng.normal(0, 0.5))))
    refresher = FleetRefresher(fleet.tstore, RefreshPolicy(every_n=4),
                               device="cpu")
    q = [TQuery("bwa", None, 2.0)]
    with AsyncPredictionFrontend(fleet.tstore, device="cpu", window_s=0.005,
                                 refresher=refresher,
                                 refresh_interval_s=0.005) as fe:
        assert refresher._thread is not None and refresher._thread.is_alive()
        deadline = time.time() + 30.0
        while refresher.dispatch_count == 0 and time.time() < deadline:
            assert fe.predict(q, "acme", "wf_a").shape == (1, 3)
        assert refresher.dispatch_count >= 1
        np.testing.assert_array_equal(fe.predict(q, "acme", "wf_a"),
                                      fleet.tsvc["acme"].predict_batch(q))
        thread = refresher._thread
    assert refresher._thread is None and not thread.is_alive()
    assert online.tasks["bwa"].since_refresh < 8


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")


def test_cuda_frontend_and_probes_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncPredictionFrontend(TStore())            # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncPredictionFrontend(TStore(), device="cuda", auto_flush=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.cpu_probe_gflops(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.mem_probe_gbps(8)


# --- the real microbenchmark probes -------------------------------------------

@pytest.mark.parametrize("probe,arg", [
    (microbench.cpu_probe_gflops, 64),
    (microbench.mem_probe_gbps, 1 << 12),
    (lambda size_mb: microbench.io_probe_mbps(size_mb)["read"], 1),
    (lambda size_mb: microbench.io_probe_mbps(size_mb)["write"], 1),
], ids=["cpu", "mem", "io_read", "io_write"])
def test_probe_reads_positive_finite_on_the_cpu(probe, arg):
    kw = {} if probe.__name__ == "<lambda>" else {"device": "cpu"}
    v = probe(arg, **kw)
    assert isinstance(v, float) and math.isfinite(v) and v > 0


def test_time_it_warms_up_and_takes_the_best():
    calls = []
    best = microbench._time_it(lambda: calls.append(time.perf_counter()),
                               repeats=4)
    assert len(calls) == 5 and 0 <= best < 1.0


def test_run_local_microbench_on_the_cpu():
    mb = microbench.run_local_microbench("here", device="cpu")
    assert isinstance(mb, MachineBench) and mb.name == "here"
    for v in (mb.cpu, mb.mem, mb.io_read, mb.io_write):
        assert math.isfinite(v) and v > 0
