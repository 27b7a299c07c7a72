"""The port's online write path against the JAX package: the streaming NIG
algebra, the `nig_fold` kernel's plain version, `fold_stacked` and the
`OnlinePredictor`.

Every float64 fold form of the port (the scalar `nig_update` chain,
`nig_update_batch` with impl 'chain', 'vec' and 'numpy', and the card's
form `store.compute.fold_kernel` on the CPU, which runs
`kernels.ref.nig_fold_ref`) must be bitwise equal to the
reference's scalar `nig_update` chain on every leaf; the reference's
float32 fold forms agree with the port's float64 fold at their own bound,
rtol 2e-3 / atol 2e-3.  An `OnlinePredictor` carried across packages
(`repro_torch.convert`) and fed the same completions must export an equal
state, except where a median-fallback task is promoted through a float32
fit, which is held at the slice tests' fit tolerance, rtol 1e-4 /
atol 1e-5.  Fixed seeds throughout; inputs are finite."""
import copy
import json

import numpy as np
import pytest
import torch

from repro.core import bayes as jbayes
from repro.core import microbench as jmb
from repro.core import predictor as jpred
from repro.core.traces import TraceRow as JTrace
from repro.kernels import bayes_fit as jkernels
from repro.online import OnlinePredictor as JOnline
from repro.online import PredictionService as JService
from repro.online.events import PredictionQuery as JQuery
from repro.online.events import TaskCompletion as JComp
from repro.sched import cluster as jcl
from repro_torch import convert
from repro_torch.core import bayes as tbayes
from repro_torch.core import microbench as tmb
from repro_torch.kernels import bayes_fit as tkernels
from repro_torch.kernels import ops, ref
from repro_torch.online import IngestStats, OnlinePredictor
from repro_torch.online import PredictionService as TService
from repro_torch.online.events import PredictionQuery as TQuery
from repro_torch.online.events import TaskCompletion as TComp
from repro_torch.sched import cluster as tcl
from repro_torch.store.compute import fold_kernel, fold_stacked

LEAVES = ("mu", "v", "prec", "a", "b", "n_obs")
JAX_FOLD_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_ingest.py:98-113
FIT_TOL = dict(rtol=1e-4, atol=1e-5)          # tests/test_torch_slice.py:41


# --- inputs --------------------------------------------------------------------

_FIT_ROWS = 256                 # one batched fit shape: one compile


def _fitted_nigs(rng, t):
    """t <= 256 NIG states lifted (by the reference) from float32 MacKay
    fits of 4-8 noisy linear points each: the fitted sigma, and so v, can
    be asymmetric in the last ulp."""
    k = rng.integers(4, 9, _FIT_ROWS)
    m = (np.arange(8)[None, :] < k[:, None]).astype(np.float32)
    x = rng.uniform(0.05, 2.0, (_FIT_ROWS, 8))
    y = 2.0 + 20.0 * x + rng.normal(0.0, 0.3, (_FIT_ROWS, 8))
    post = {key: np.asarray(v) for key, v in
            jbayes.fit_blr_batch(x * m, y * m, m).items()}
    return [jbayes.nig_from_blr({key: v[i] for key, v in post.items()})
            for i in range(t)]


def _rows(rng, t, kmax=8):
    """Ragged observation rows of 0..kmax completions per state."""
    xs = [list(rng.uniform(0.05, 3.0, int(rng.integers(0, kmax + 1))))
          for _ in range(t)]
    ys = [[float(rng.uniform(4.0, 120.0)) for _ in row] for row in xs]
    return xs, ys


def _chain(nigs, xs, ys):
    """The reference's scalar oracle: nig_update once per observation."""
    out = []
    for nig, xr, yr in zip(nigs, xs, ys):
        w = dict(nig)
        for x, y in zip(xr, yr):
            w = jbayes.nig_update(w, x, y)
        out.append(w)
    return out


def _assert_leaves_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for leaf in LEAVES:
            np.testing.assert_array_equal(
                np.asarray(g[leaf]), np.asarray(w[leaf]),
                err_msg=f"{what}: state {i} leaf {leaf!r} is not bitwise")


def _port_chain(nigs, xs, ys):
    out = []
    for nig, xr, yr in zip(nigs, xs, ys):
        w = dict(nig)
        for x, y in zip(xr, yr):
            w = tbayes.nig_update(w, x, y)
        out.append(w)
    return out


# --- (a) the NIG algebra, bitwise ----------------------------------------------

@pytest.mark.parametrize("form", ["nig_update", "chain", "vec", "numpy",
                                  "kernel"])
@pytest.mark.parametrize("t", [1, 5, 63, 64, 200])
def test_fold_forms_bitwise_equal_jax_scalar_chain(t, form):
    rng = np.random.default_rng(1000 + t)
    nigs = _fitted_nigs(rng, t)
    xs, ys = _rows(rng, t)
    if t > 1:
        xs[0], ys[0] = [], []                    # a row with no observation
    before = copy.deepcopy(nigs)
    want = _chain(nigs, xs, ys)
    if form == "nig_update":
        got = _port_chain(nigs, xs, ys)
    elif form == "kernel":
        got = fold_kernel(nigs, xs, ys, device="cpu")
    else:
        got = tbayes.nig_update_batch(nigs, xs, ys, impl=form)
    _assert_leaves_equal(got, want, form)
    for g, n in zip(got, nigs):
        assert g is not n
    # the inputs come back unchanged (a predictor hands over live state)
    for b, n in zip(before, nigs):
        assert b.keys() == n.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(n[k]), np.asarray(b[k]))


def test_fold_inputs_hold_asymmetric_v_and_empty_rows():
    """The bitwise cases above do meet the two places a restacking fold
    would differ: a v asymmetric in the last ulp, passed through verbatim
    on a row with no observation."""
    rng = np.random.default_rng(1200)
    nigs = _fitted_nigs(rng, 200)
    asym = [i for i, n in enumerate(nigs)
            if n["v"][0, 1] != n["v"][1, 0]]
    assert asym
    xs, ys = _rows(rng, 200)
    i = asym[0]
    xs[i], ys[i] = [], []
    got = fold_kernel(nigs, xs, ys, device="cpu")
    assert got[i]["v"] is nigs[i]["v"]
    assert got[i]["v"][0, 1] != got[i]["v"][1, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nig_from_blr_and_to_blr_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 2.0, 6)
    y = 3.0 + 11.0 * x + rng.normal(0.0, 0.2, 6)
    post = {k: np.asarray(v) for k, v in jbayes.fit_blr(x, y).items()}
    a, b = jbayes.nig_from_blr(post), tbayes.nig_from_blr(post)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    xs, ys = _rows(rng, 1)
    a = _chain([a], xs, ys)[0]
    ea, eb = jbayes.nig_to_blr(a), tbayes.nig_to_blr(a)
    for k in ea:
        np.testing.assert_array_equal(eb[k], np.asarray(ea[k]))
        assert eb[k].dtype == np.asarray(ea[k]).dtype


def test_nig_update_batch_validates_rows():
    nigs = _fitted_nigs(np.random.default_rng(0), 2)
    with pytest.raises(ValueError):
        tbayes.nig_update_batch(nigs, [[1.0]], [[2.0]])
    with pytest.raises(ValueError):
        tbayes.nig_update_batch(nigs, [[1.0], []], [[2.0, 3.0], []])
    with pytest.raises(ValueError):
        tbayes.nig_update_batch(nigs, [[1.0], []], [[2.0], []], impl="scan")
    out = tbayes.nig_update_batch(nigs, [[], []], [[], []])
    for o, n in zip(out, nigs):
        assert o is not n and o["n_obs"] == n["n_obs"]


# --- (b) the plain fold against the JAX kernel forms, float32 ------------------

def _packed(seed, t, kmax):
    """Standardized (T, K) packs of ragged rows, as nig_update_batch packs
    them, with the mask and the states' stacked leaves."""
    rng = np.random.default_rng(seed)
    nigs = _fitted_nigs(rng, t)
    xs, ys = _rows(rng, t, kmax)
    k = max(len(r) for r in xs)
    x, y, m = (np.zeros((t, k)) for _ in range(3))
    for i, (xr, yr) in enumerate(zip(xs, ys)):
        x[i, :len(xr)], y[i, :len(yr)], m[i, :len(xr)] = xr, yr, 1.0
    st = np.array([[n["x_mu"], n["x_sd"], n["y_mu"], n["y_sd"]]
                   for n in nigs])
    sx = (x - st[:, 0:1]) / st[:, 1:2]
    sy = (y - st[:, 2:3]) / st[:, 3:4]
    return (sx, sy, m, np.stack([n["mu"] for n in nigs]),
            np.stack([n["v"] for n in nigs]),
            np.stack([n["prec"] for n in nigs]),
            np.array([n["b"] for n in nigs]))


def _with_counts(args):
    """A (sx, sy, mask, ...) pack as the port's fold takes it: one ragged
    slab of T rows (`core.bayes.fold_pack` of states whose standardization
    is the identity, so the standardized values go in as they are) and
    T."""
    sx, sy, m, mu, v, prec, b = args
    counts = np.count_nonzero(m, axis=1)
    nigs = [dict(mu=mu[i], v=v[i], prec=prec[i], b=b[i], a=0.0, n_obs=0.0,
                 x_mu=0.0, x_sd=1.0, y_mu=0.0, y_sd=1.0)
            for i in range(len(counts))]
    slab, *_ = tbayes.fold_pack(nigs, [r[:k] for r, k in zip(sx, counts)],
                                [r[:k] for r, k in zip(sy, counts)])
    return torch.from_numpy(slab), len(counts)


@pytest.mark.parametrize("jax_form", ["interpret", "scan"])
@pytest.mark.parametrize("seed", [3, 4])
def test_nig_fold_ref_within_jax_kernel_tolerance(seed, jax_form):
    args = _packed(seed, 37, 6)
    if jax_form == "interpret":
        want = jkernels.nig_fold(*args, interpret=True)
    else:
        want = jkernels.nig_fold_scan(*args)
    got = tbayes.fold_leaves(ref.nig_fold_ref(*_with_counts(args)))
    for name, g, w in zip(("mu", "v", "prec", "b"), got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **JAX_FOLD_TOL,
                                   err_msg=f"{jax_form}: {name}")


def test_nig_fold_ref_equals_numpy_fold_and_routes_by_device():
    args = _packed(5, 80, 8)
    t = _with_counts(args)
    state = ops.nig_fold(*t)
    got = tbayes.fold_leaves(state)
    a = np.zeros(80)
    want = jbayes._nig_fold_np(args[3], args[4], args[5], a, args[6], a,
                               args[0], args[1], args[2])
    for g, w in zip(got, (want[0], want[1], want[2], want[4])):
        assert np.array_equal(g.numpy(), w)
    assert state.data_ptr() != t[0].data_ptr()   # nothing aliases an input
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernels.nig_fold(*t)                    # the wrapper takes no CPU


def test_kernel_form_hands_the_kernel_contiguous_operands(monkeypatch):
    """A state lifted from a fit on the card holds a column-major sigma
    (torch.linalg.inv's layout there), so its v is Fortran-ordered; the
    kernel takes raw pointers, and its wrapper refuses anything but
    C-contiguous operands.  The kernel form packs them contiguous."""
    rng = np.random.default_rng(7)
    nigs = _fitted_nigs(rng, 70)
    for n in nigs:
        n["v"] = np.asfortranarray(n["v"])
        n["prec"] = np.asfortranarray(n["prec"])
    xs, ys = _rows(rng, 70)
    seen = []

    def checked(*args):
        seen.append([a.is_contiguous() for a in args
                     if isinstance(a, torch.Tensor)])
        return ref.nig_fold_ref(*args)
    monkeypatch.setattr(ops, "nig_fold", checked)
    got = fold_kernel(nigs, xs, ys, device="cpu")
    assert seen and all(all(flags) for flags in seen)
    _assert_leaves_equal(got, _chain(nigs, xs, ys), "kernel")


# --- (c) fold_stacked ------------------------------------------------------------

@pytest.mark.parametrize("t", [5, 80])
def test_fold_stacked_on_cpu_is_the_scalar_chain(t):
    """The port's mirror of the reference's
    test_fold_stacked_auto_stays_on_float64_chain: the fold feeds
    checkpointed streaming states, so it is bitwise the scalar chain."""
    rng = np.random.default_rng(11 + t)
    nigs = _fitted_nigs(rng, t)
    xs, ys = _rows(rng, t, 4)
    want = _chain(nigs, xs, ys)
    _assert_leaves_equal(fold_stacked(nigs, xs, ys, device="cpu"), want,
                         "fold_stacked")
    _assert_leaves_equal(fold_kernel(nigs, xs, ys, device="cpu"), want,
                         "fold_kernel")


# --- (d)-(f) the predictor -------------------------------------------------------

REG_TASKS = ("bwa", "idx", "sort")
MEDIAN_TASK = "merge"


def _traces(trace_cls):
    rows = []
    for j, task in enumerate(REG_TASKS):
        rows += [trace_cls("wf", task, "local", s, 2.0 + j + (20.0 + 7 * j) * s)
                 for s in np.linspace(0.05, 0.4, 6)]
    # a merge task whose runtime does not follow its input: median fallback
    rows += [trace_cls("wf", MEDIAN_TASK, "local", s, r) for s, r in
             zip(np.linspace(0.05, 0.4, 6), (40.0, 31.0, 44.0, 29.0, 41.0,
                                             33.0))]
    return rows


def _pair():
    """The reference's fitted base and its carried copy in the port, each
    wrapped in its package's OnlinePredictor, with each package's benches
    for the cluster's machines."""
    jb = {n.name: jmb.simulate_microbench(n, 1) for n in jcl.TARGET_MACHINES}
    tb = {n.name: tmb.simulate_microbench(n, 1) for n in tcl.TARGET_MACHINES}
    base = jpred.LotaruPredictor(
        "G", local_bench=jmb.simulate_microbench(jcl.LOCAL, 1))
    base.fit(_traces(JTrace))
    assert not base.models[MEDIAN_TASK].correlated
    carried = convert.predictor_from_state(convert.predictor_state(base),
                                           device="cpu")
    return base, jb, carried, tb


def _factor(carried, tb):
    return lambda task, node: carried.factor(task, tb[node.split("-")[0]])


def _stream(seed, factor, n=90, promote=False):
    """Local completions of the regression tasks (the last of them only
    local, so every batch has a fold group); remote completions on known
    nodes running 1.6x slower than their static factor says, enough to
    move the A1 correction and mature its median-fallback feed;
    completions on an unknown node; and median-fallback completions of
    one input size (or, with `promote`, of spread sizes whose runtime
    follows the input).  `factor(task, node)` is the static factor."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.45:
            task, node = REG_TASKS[i % 3], "local"
        elif r < 0.75:
            task, node = REG_TASKS[i % 2], ("A1", "A1-2", "N2")[i % 3]
        elif r < 0.82:
            task, node = REG_TASKS[i % 2], "ghost"
        else:
            task, node = MEDIAN_TASK, ("local", "A1")[i % 2]
        gb = float(rng.uniform(0.05, 4.0))
        j = REG_TASKS.index(task) if task in REG_TASKS else 0
        if task == MEDIAN_TASK:
            if promote:
                rt = 5.0 + 30.0 * gb
            else:                      # one input size: never correlated
                gb, rt = 1.0, float(rng.uniform(30.0, 45.0))
        else:
            rt = (2.0 + j + (20.0 + 7 * j) * gb) * float(rng.uniform(0.9, 1.1))
        if node not in ("local", "ghost"):
            rt *= 1.6 * factor(task, node)
        out.append((task, node, gb, rt))
    return out


def _comps(cls, stream):
    return [cls("wf", f"u{i}", task, node, gb, rt)
            for i, (task, node, gb, rt) in enumerate(stream)]


def _queries(cls):
    return [cls(task, node, gb) for task in REG_TASKS + (MEDIAN_TASK,)
            for node in (None, "A1", "A1-2", "N2", "C2")
            for gb in (0.3, 1.7, 3.9)]


@pytest.mark.parametrize("chunk", [1, 7, None])
def test_observe_many_equals_jax_observe_chain(chunk):
    base, jb, carried, tb = _pair()
    stream = _stream(21, _factor(carried, tb))
    oracle = JOnline(base, jb)                   # the scalar chain
    batched = JOnline(base, jb)                  # the reference's batches
    port = OnlinePredictor(carried, tb, device="cpu")
    v0 = port.version
    for c in _comps(JComp, stream):
        oracle.observe(c)
    size = chunk or len(stream)
    applied = 0
    for i in range(0, len(stream), size):
        part = stream[i:i + size]
        batched.observe_many(_comps(JComp, part))
        applied += port.observe_many(_comps(TComp, part))
    state = port.export_state()
    assert state == oracle.export_state()
    assert applied == port.version - v0 == oracle.version - v0
    assert port.changed_since(0) == batched.changed_since(0)
    assert port.ingest.as_dict() == batched.ingest.as_dict()
    assert port.ingest.folded > 0 and port.ingest.fold_dispatches > 0
    # what the stream was built to reach
    assert oracle.node_correction("A1") != 1.0
    assert port.node_correction("A1") == oracle.node_correction("A1")
    assert state["tasks"][MEDIAN_TASK]["nig"] is None      # not promoted
    assert len(state["tasks"][MEDIAN_TASK]["xs"]) > 0
    got = TService(port, tb, device="cpu").predict_batch(_queries(TQuery))
    want = JService(oracle, jb).predict_batch(_queries(JQuery))
    assert np.array_equal(got, want)
    assert port.predict("bwa", 1.3, tb["A1"]) == \
        oracle.predict("bwa", 1.3, jb["A1"])
    assert port.prediction_std("idx", 2.2) == oracle.prediction_std("idx",
                                                                    2.2)


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


def test_promotion_goes_through_the_fit_within_fit_tolerance():
    base, jb, carried, tb = _pair()
    stream = _stream(23, _factor(carried, tb), promote=True)
    oracle = JOnline(base, jb)
    port = OnlinePredictor(carried, tb, device="cpu")
    for c in _comps(JComp, stream):
        oracle.observe(c)
    port.observe_many(_comps(TComp, stream))
    want, got = oracle.export_state(), port.export_state()
    assert want["tasks"][MEDIAN_TASK]["nig"] is not None   # promoted

    def promoted(state):
        """The promoted task's state and its node ratios, which its
        float32 fit moves, taken out of `state`."""
        return {"task": state["tasks"].pop(MEDIAN_TASK),
                "nodes": {n: logs.pop(MEDIAN_TASK, [])
                          for n, logs in state["nodes"].items()}}
    moved_got, moved_want = promoted(got), promoted(want)
    assert got == want                         # everything else: equal
    assert moved_got["task"]["xs"] == moved_want["task"]["xs"]
    _allclose_state(moved_got, moved_want, FIT_TOL)


def test_state_carries_across_packages_both_ways():
    base, jb, carried, tb = _pair()
    stream = _stream(25, _factor(carried, tb))
    src = JOnline(base, jb)
    src.observe_many(_comps(JComp, stream))
    state = json.loads(json.dumps(src.export_state()))
    port = OnlinePredictor(carried, tb, device="cpu")
    port.load_state(state)
    assert port.export_state() == src.export_state()
    # and back: the port's state after more ingest loads into the reference
    more = _stream(26, _factor(carried, tb), n=40)
    port.observe_many(_comps(TComp, more))
    src.observe_many(_comps(JComp, more))
    back = JOnline(base, jb)
    back.load_state(json.loads(json.dumps(port.export_state())))
    assert back.export_state() == port.export_state() == src.export_state()


def test_refresh_protocol_matches_the_reference():
    """refresh_due / refresh_snapshot / apply_refresh: the same due tasks,
    the same evidence and the same seq guard as the reference."""
    from repro.online.maintenance import RefreshPolicy
    base, jb, carried, tb = _pair()
    stream = _stream(27, _factor(carried, tb))
    a, b = JOnline(base, jb), OnlinePredictor(carried, tb, device="cpu")
    a.observe_many(_comps(JComp, stream))
    b.observe_many(_comps(TComp, stream))
    policy = RefreshPolicy(every_n=3, min_points=4)
    due = a.refresh_due(policy)
    assert due and b.refresh_due(policy) == due
    sa, sb = a.refresh_snapshot(due), b.refresh_snapshot(due)
    for t in due:
        assert sb[t][0] == sa[t][0]
        assert np.array_equal(sb[t][1], sa[t][1])
        assert np.array_equal(sb[t][2], sa[t][2])
    post = {k: np.asarray(v) for k, v in
            jbayes.refresh_fit([], [], sa[due[0]][1], sa[due[0]][2]).items()}
    assert not b.apply_refresh(due[0], post, seq=sb[due[0]][0] - 1)
    assert a.apply_refresh(due[0], post, seq=sa[due[0]][0])
    assert b.apply_refresh(due[0], post, seq=sb[due[0]][0])
    assert b.export_state() == a.export_state()
    assert b.refresh_due(policy) == a.refresh_due(policy)


def test_ingest_stats_merge_and_dict_roundtrip():
    a = IngestStats(batches=1, records=3, folded=2, scalar=1,
                    fold_dispatches=1, lock_acquisitions=1)
    b = IngestStats(batches=2, records=5, flushes=2, generations_published=1)
    m = a.merge(b)
    assert m.batches == 3 and m.records == 8 and m.folded == 2
    assert m.as_dict()["flushes"] == 2
    assert set(m.as_dict()) == set(IngestStats().as_dict())


# --- (g) devices -----------------------------------------------------------------

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")


def test_cuda_write_path_raises_without_a_card(no_card):
    _, _, carried, tb = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlinePredictor(carried, tb)               # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlinePredictor(carried, tb, device="cuda")
    nigs = _fitted_nigs(np.random.default_rng(0), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fold_stacked(nigs, [[1.0], []], [[2.0], []])
    with pytest.raises(RuntimeError, match="CUDA"):
        fold_kernel(nigs, [[1.0], []], [[2.0], []])
