"""The port's posterior maintenance plane (`repro_torch.online.maintenance`)
against the JAX package's, on the CPU.

The same completion streams go into the reference's `OnlinePredictor`s and
into the port's (each port predictor carries the reference's fitted
posteriors through `repro_torch.convert`, and its streaming state is
checked equal after the first ingest), each bound to its package's store.  Then:

  * `due()` lists are equal, with and without the per-tenant budget and
    `min_interval_s`;
  * one refresh of two tenants gives equal `RefreshReport` counts and
    generation step, one fit call, and refreshed states and store rows
    within the fit tolerance, rtol 1e-4 / atol 1e-5
    (tests/test_torch_slice.py:41: both fits are float32);
  * a fit that races an observe is rejected and its task stays due;
  * `maybe_refresh` with nothing due makes no fit call;
  * `start` and `stop` end the thread.

Fixed seeds, three task types a tenant."""
import threading
import time

import numpy as np
import pytest

from repro.core.microbench import simulate_microbench as jbench
from repro.core.predictor import LotaruPredictor as JLotaru
from repro.core.traces import TraceRow as JTrace
from repro.online import FleetRefresher as JRefresher
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online import RefreshPolicy as JPolicy
from repro.online.events import PredictionQuery as JQuery
from repro.online.events import TaskCompletion as JComp
from repro.sched.cluster import LOCAL as JLOCAL
from repro.store import PosteriorStore as JStore
from repro.store import compute as jcompute
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.online import FleetRefresher, OnlinePredictor
from repro_torch.online import PredictionService as TService
from repro_torch.online import RefreshPolicy, RefreshReport
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.store import PosteriorStore as TStore
from repro_torch.store import compute as tcompute

FIT_TOL = dict(rtol=1e-4, atol=1e-5)          # tests/test_torch_slice.py:41
TASKS = ("bwa", "idx", "sort")
TENANTS = ("acme", "globex")
POLICY = dict(every_n=4)


def _base():
    base = JLotaru("G", local_bench=jbench(JLOCAL, 1))
    rows = []
    for j, t in enumerate(TASKS):
        rows += [JTrace("wf", t, "local", s, 2.0 + j + (20.0 + 7 * j) * s)
                 for s in np.linspace(0.05, 0.4, 6)]
    return base.fit(rows)


def _stream(seed, counts):
    """Local completions: counts[task] of each, noisy lines of their own."""
    rng = np.random.default_rng(seed)
    out = []
    for j, t in enumerate(TASKS):
        for i in range(counts.get(t, 0)):
            x = float(rng.uniform(0.5, 6.0))
            out.append((t, f"{t}-{seed}-{i}", x,
                        float(4.0 + j + (30.0 + 5 * j) * x
                              + rng.normal(0.0, 0.5))))
    return out


def _observe(pred, cls, stream):
    for task, uid, x, y in stream:
        pred.observe(cls("wf", uid, task, "local", x, y))


class _Fleet:
    """Tenants bound to one reference store and one port store, fed the
    same streams."""

    def __init__(self, counts, block_size=512):
        base = _base()
        carried = convert.predictor_from_state(convert.predictor_state(base),
                                               device="cpu")
        self.jstore, self.tstore = JStore(block_size), TStore(block_size)
        self.j, self.t, self.jsvc, self.tsvc = {}, {}, {}, {}
        for k, ten in enumerate(TENANTS):
            self.j[ten] = JOnline(base)
            self.t[ten] = OnlinePredictor(carried, device="cpu")
            self.jsvc[ten] = JService(self.j[ten], store=self.jstore,
                                      tenant=ten, workflow="w")
            self.tsvc[ten] = TService(self.t[ten], store=self.tstore,
                                      tenant=ten, workflow="w", device="cpu")
            self.feed(ten, _stream(10 + k, counts[ten]))
            assert self.t[ten].export_state() == self.j[ten].export_state()
            self.jsvc[ten].predict_batch([JQuery("bwa", None, 1.0)])
            self.tsvc[ten].predict_batch([TQuery("bwa", None, 1.0)])

    def feed(self, ten, stream):
        _observe(self.j[ten], JComp, stream)
        _observe(self.t[ten], TComp, stream)


def _due(refresher):
    return [(b.tenant, b.workflow, t) for b, t in refresher.due()]


def _allclose_state(got, want, tol):
    """Equal structure; floats within `tol` (lists elementwise)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _allclose_state(got[k], want[k], tol)
    elif isinstance(want, list):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), **tol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert got == want


@pytest.mark.parametrize("budget", [
    {},
    {"max_tasks_per_tenant_per_cycle": 1},
    {"max_tasks_per_tenant_per_cycle": 2},
    {"min_interval_s": 3600.0},
])
def test_due_lists_equal_reference(budget):
    fleet = _Fleet({"acme": {"bwa": 6, "idx": 5, "sort": 2},
                    "globex": {"bwa": 4, "sort": 7}})
    jr = JRefresher(fleet.jstore, JPolicy(**POLICY, **budget))
    tr = FleetRefresher(fleet.tstore, RefreshPolicy(**POLICY, **budget),
                        device="cpu")
    seen = []
    for _ in range(4):                      # deferred, never dropped
        want = _due(jr)
        assert _due(tr) == want
        if not want:
            break
        seen += want
        jr.refresh()
        tr.refresh()
    assert sorted(seen) == [("acme", "w", "bwa"), ("acme", "w", "idx"),
                            ("globex", "w", "bwa"), ("globex", "w", "sort")]
    # due again by the counter; min_interval_s holds such tasks back
    for ten, k in (("acme", 20), ("globex", 21)):
        fleet.feed(ten, _stream(k, {"bwa": 4}))
    assert _due(tr) == _due(jr)
    assert bool(_due(tr)) == ("min_interval_s" not in budget)


def test_refresh_of_two_tenants_matches_reference(monkeypatch):
    fleet = _Fleet({"acme": {"bwa": 6, "idx": 6, "sort": 1},
                    "globex": {"bwa": 5, "idx": 9}})
    fits = []
    real = ops.bayes_fit
    monkeypatch.setattr(ops, "bayes_fit",
                        lambda *a: fits.append(a[0].shape) or real(*a))
    jr = JRefresher(fleet.jstore, JPolicy(**POLICY))
    tr = FleetRefresher(fleet.tstore, RefreshPolicy(**POLICY), device="cpu")
    gens = (fleet.jstore.generation, fleet.tstore.generation)
    want, got = jr.refresh(), tr.refresh()
    assert len(fits) == 1 and fits[0][0] == 4     # one fit over 4 tasks
    for f in ("n_tasks", "n_tenants", "n_dispatches", "n_stale"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.n_tasks, got.n_tenants, got.n_dispatches) == (4, 2, 1)
    assert got.generation - gens[1] == want.generation - gens[0] == 1
    assert list(got.split_s) == ["due", "snapshot", "pad", "fit", "apply",
                                 "put_many", "cursor"]
    assert got.duration_s == pytest.approx(sum(got.split_s.values()))
    assert tr.dispatch_count == jr.dispatch_count == 1
    for ten in TENANTS:
        _allclose_state(fleet.t[ten].export_state(),
                        fleet.j[ten].export_state(), FIT_TOL)
    keys = fleet.jstore.task_keys()
    assert fleet.tstore.task_keys() == keys
    grows, jrows = fleet.tstore.gather(keys), fleet.jstore.gather(keys)
    for leaf in jrows:
        np.testing.assert_allclose(grows[leaf], jrows[leaf], **FIT_TOL,
                                   err_msg=leaf)
    # the publish advanced the cursors: the next predict syncs nothing
    for ten in TENANTS:
        fleet.tsvc[ten].predict_batch([TQuery("idx", None, 2.0)])
    assert fleet.tstore.generation == got.generation
    assert all(b.is_current() for b in fleet.tstore.bindings())
    assert _due(tr) == _due(jr) == []


def test_fit_racing_an_observe_is_rejected_and_stays_due(monkeypatch):
    """An observe landing between the snapshot and the apply wins: the
    stale fit is dropped, the task stays due, its row is not published,
    and the binding's cursor stays put so the next sync writes it."""
    fleet = _Fleet({"acme": {"bwa": 6, "idx": 5}, "globex": {}})
    race = _stream(30, {"bwa": 1})

    def racing(module, pred, cls):
        real = module.fit_stacked

        def fit(*a, **k):
            out = real(*a, **k)
            _observe(pred, cls, race)
            return out
        monkeypatch.setattr(module, "fit_stacked", fit)

    racing(jcompute, fleet.j["acme"], JComp)
    racing(tcompute, fleet.t["acme"], TComp)
    jr = JRefresher(fleet.jstore, JPolicy(**POLICY))
    tr = FleetRefresher(fleet.tstore, RefreshPolicy(**POLICY), device="cpu")
    want, got = jr.refresh(), tr.refresh()
    for f in ("n_tasks", "n_tenants", "n_dispatches", "n_stale"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.n_tasks, got.n_stale) == (1, 1)
    assert _due(tr) == _due(jr) == [("acme", "w", "bwa")]
    tb = fleet.tstore.binding("acme", "w")
    jb = fleet.jstore.binding("acme", "w")
    assert not tb.is_current() and not jb.is_current()
    assert tb.sync() == jb.sync() == 2        # bwa, and idx held back
    _allclose_state(fleet.t["acme"].export_state(),
                    fleet.j["acme"].export_state(), FIT_TOL)


def test_maybe_refresh_with_nothing_due_makes_no_fit(monkeypatch):
    fleet = _Fleet({"acme": {"bwa": 2}, "globex": {"idx": 3}})
    fits = []
    monkeypatch.setattr(ops, "bayes_fit", lambda *a: fits.append(1))
    tr = FleetRefresher(fleet.tstore, RefreshPolicy(**POLICY), device="cpu")
    gen = fleet.tstore.generation
    assert tr.maybe_refresh() is None
    report = tr.refresh()                    # an explicit pass: no rows
    assert (report.n_tasks, report.n_dispatches) == (0, 0)
    assert report.generation == gen == fleet.tstore.generation
    assert fits == [] and tr.dispatch_count == 0
    assert tr.reports == [report]


def test_start_and_stop_end_the_thread():
    fleet = _Fleet({"acme": {"bwa": 6}, "globex": {}})
    tr = FleetRefresher(fleet.tstore, RefreshPolicy(**POLICY), device="cpu")
    with tr.start(interval_s=0.01):
        thread = tr._thread
        assert thread.is_alive()
        with pytest.raises(RuntimeError, match="already running"):
            tr.start()
        deadline = time.monotonic() + 30.0
        while not tr.reports and time.monotonic() < deadline:
            time.sleep(0.01)
    thread.join(timeout=10.0)
    assert not thread.is_alive() and tr._thread is None
    assert [r.n_tasks for r in tr.reports] == [1]
    assert tr.failure_count == 0
    assert "posterior-refresher" not in [t.name for t in threading.enumerate()]
    tr.stop()                                 # stopping twice is a no-op


def test_refresher_device_defaults_to_cuda_and_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRefresher(TStore())
    assert RefreshReport().split_s == {}
