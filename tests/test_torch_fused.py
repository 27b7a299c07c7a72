"""HEFT placement in the port against the JAX package, on the CPU.

Problems are built through both packages from the same numpy seeds
(`benchmarks/replan_latency._build` and its port in
`chip_smoke.replan_problem`), and the port serves the reference's
posteriors (`repro_torch.convert`).  Everything compared is float64 host
arithmetic or the plain versions of the kernels, so:

  * the port's cost view (`fused_cost_ref`) is bitwise the reference's
    `PredictionMatrix.costs`;
  * the port's plain sweep is bitwise the reference's float32
    `kernels.decision_plane.eft_sweep` on the same float32 packs, masked pad
    rows included;
  * the port's `fused_heft_schedule`, with either engine, gives schedules
    identical to the reference's `heft_schedule_matrix` and to its
    `fused_heft_schedule(engine="numpy")`.

Cases are fixed seeds (no hypothesis), so a failing case writes nothing
under `.hypothesis/`."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import replan_latency
from repro.core.bayes import predict_blr_np
from repro.kernels import decision_plane as jdp
from repro.sched import fused as jfused
from repro.sched.heft import heft_schedule_matrix as jheft
from repro.sched.plane import PredictionMatrix as JMatrix
from repro.sched.plane import quantile_z as jquantile_z
from repro.store import compute as jcompute
from repro_torch import convert
from repro_torch.kernels import bayes_fit as tkernels
from repro_torch.kernels import decision_plane as tdp
from repro_torch.kernels import ops, ref
from repro_torch.online import PredictionService as TService
from repro_torch.sched import fused as tfused
from repro_torch.sched.plane import PredictionMatrix as TMatrix

QUANTILES = (None, 0.5, 0.95)


@functools.lru_cache(maxsize=None)
def _pair(n_tasks, n_nodes, seed):
    """(reference problem, port problem): the same DAG and cluster, the
    port's service serving the reference's fitted posteriors."""
    jdag, jnodes, jsvc = replan_latency._build(n_tasks, n_nodes, seed)
    tdag, tnodes, tsvc = chip_smoke.replan_problem(n_tasks, n_nodes, seed,
                                                   "cpu")
    carried = convert.predictor_from_state(
        convert.predictor_state(jsvc.predictor), device="cpu")
    return ((jdag, jnodes, jsvc),
            (tdag, tnodes, TService(carried, tsvc.benches, device="cpu")))


def _jmatrix(dag, nodes, svc):
    entries = [(u, t.task_name, t.input_gb) for u, t in dag.tasks.items()]
    return JMatrix.from_service(svc, entries, nodes)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_schedule(a, b):
    assert a.assignment == b.assignment
    assert a.order == b.order
    assert a.est == b.est


# (tasks, nodes) per seed: random DAGs of 5-40 tasks on 4-6 nodes
_SIZES = ((5, 4), (12, 5), (23, 6), (40, 4), (31, 6), (17, 5))


def _sizes(seed):
    return _SIZES[seed]


# --- (a) the cost view ------------------------------------------------------

@pytest.mark.parametrize("q", QUANTILES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_view_bitwise_equals_prediction_matrix_costs(seed, q):
    n_tasks, n_nodes = _sizes(seed)
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(n_tasks, n_nodes,
                                                       seed)
    order = jdag.topo_order()
    want = _jmatrix(jdag, jnodes, jsvc).costs(order,
                                              [n.name for n in jnodes], q)
    got = tfused.cost_view(tsvc, tdag, tnodes, q)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert got.shape == want.shape
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def _cost_case(t, n, seed):
    """t posterior rows (from four rows up, a quarter under the 1e-3 mean
    floor and a quarter with var_s <= 0), their inputs, a (t, n) static
    factor matrix and n node corrections, every third 1."""
    return chip_smoke.cost_inputs(np.random.default_rng(seed), t, n)


def _cost_want(x, post, base, corr, z):
    """The reference's chain: predict_blr_np, the factor matrix's
    base * correction products, store.compute.scale, cost_matrix."""
    mean, std = predict_blr_np(post, x)
    f = np.asarray([[b * c for b, c in zip(row, corr)] for row in base])
    mean_s, std_s = jcompute.scale(mean[:, None], std[:, None], f)
    return jcompute.cost_matrix(mean_s, std_s, z)


def _cost_got(x, post, base, corr, z):
    batch = tdp.pack_cost("cpu", x, post, corr)
    return ops.fused_cost(batch, torch.from_numpy(base), z)


@pytest.mark.parametrize("z", [None, 0.0, jquantile_z(0.95)])
def test_fused_cost_ref_is_predict_scale_cost_matrix(z):
    """Rows whose mean falls under the 1e-3 floor and rows whose var_s is
    <= 0 (a non-PSD sigma) take numpy.maximum's path in both; the node
    corrections are not all 1."""
    x, post, base, corr = _cost_case(64, 7, 5)
    mean, _ = predict_blr_np(post, x)
    assert (mean < 1e-3).sum() >= 16
    xs = (x - post["x_mu"]) / post["x_sd"]
    var_s = (1.0 / post["beta_prec"] + post["sigma"][:, 0, 0]
             + 2.0 * post["sigma"][:, 0, 1] * xs
             + post["sigma"][:, 1, 1] * xs * xs)
    assert (var_s <= 0.0).sum() >= 16
    assert (corr != 1.0).sum() >= 4
    got = _cost_got(x, post, base, corr, z)
    assert got.dtype == torch.float64 and got.shape == (64, 7)
    assert np.array_equal(_bits(got.numpy()),
                          _bits(_cost_want(x, post, base, corr, z)))


@pytest.mark.parametrize("z", [None, 0.0, jquantile_z(0.95)])
@pytest.mark.parametrize("t,n", [(37, 7), (37, 1), (1, 1), (9, 101)])
def test_fused_cost_ref_ragged_shapes(t, n, z):
    """T and N odd, one node, one cell, more nodes than a tile's rows:
    the plain version on the cost slab stays bitwise the reference's
    chain (the card's kernel is held to it by chip_smoke.py)."""
    x, post, base, corr = _cost_case(t, n, 100 + t + n)
    got = _cost_got(x, post, base, corr, z)
    assert np.array_equal(_bits(got.numpy()),
                          _bits(_cost_want(x, post, base, corr, z)))


@pytest.mark.parametrize("z", [0.0, jquantile_z(0.95)])
def test_fused_cost_ref_matches_jax_pallas_interpret(z):
    """The JAX Pallas `fused_cost` in interpret mode computes in float32:
    held at rtol 1e-5 and an atol of 1e-5 of the largest cost (float32
    operands, a cancellation in mean_s * y_sd + y_mu)."""
    x, post, base, corr = _cost_case(37, 7, 7)
    f = np.asarray([[b * c for b, c in zip(row, corr)] for row in base])
    want = np.asarray(jdp.fused_cost(
        jnp.asarray(x, jnp.float32),
        {k: jnp.asarray(v, jnp.float32) for k, v in post.items()},
        jnp.asarray(f, jnp.float32), z=z, interpret=True))
    got = _cost_got(x, post, base, corr, z).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(got).max())


def test_cost_slab_layout():
    """The cost slab: the rows' column groups as `pack_predict` lays them
    out (destinations 0), then the corrections on a 16-byte boundary; a
    callable `post` (the store's gather) writes the leaves in place."""
    x, post, base, corr = _cost_case(5, 3, 9)
    batch = tdp.pack_cost("cpu", x, lambda out: [
        v.__setitem__(slice(None), post[k]) for k, v in out.items()], corr)
    assert (batch.t, batch.n) == (5, 3)
    assert batch.slab.numel() == tdp.cost_slots(5, 3)
    at = tkernels.predict_slots(5)
    assert at % 2 == 0
    cols = tkernels.slab_columns(batch.slab, 5)
    assert torch.equal(cols["x"], torch.from_numpy(x))
    assert torch.equal(cols["sigma"], torch.from_numpy(post["sigma"]))
    assert (cols["dest"] == 0).all()
    assert torch.equal(tdp.cost_corr(batch), torch.from_numpy(corr))
    assert torch.equal(batch.slab[at:], torch.from_numpy(corr))


# --- (b) the plain sweep against the reference's float32 sweep --------------

@pytest.mark.parametrize("S", [48, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_sweep_bitwise_equals_reference_float32(seed, S):
    """The reference packs pad T to a multiple of 64 with masked rows
    (order -1).  At S = 2 the interval stacks overflow (more tasks than
    nodes), and both sweeps flag it the same way."""
    n_tasks, n_nodes = _sizes(seed)
    (jdag, jnodes, jsvc), _ = _pair(n_tasks, n_nodes, seed)
    rng = np.random.default_rng(seed)
    avail = ({n.name: float(rng.uniform(0.0, 30.0)) for n in jnodes[::2]}
             if seed % 2 else None)
    ctx = jfused._context(jdag, jnodes, None)
    W = _jmatrix(jdag, jnodes, jsvc).costs(ctx.order, ctx.names, 0.95)
    rank = ctx.ranks(jdag, W)
    pack = jfused._sweep_inputs(ctx, jdag, jnodes, W, rank, None, avail)
    assert (pack[1] == -1).any()                  # masked pad rows
    f32 = [a.astype(np.float32) if a.dtype == np.float64 else a
           for a in pack]
    gbps = ctx.gbps_min.astype(np.float32)
    want = [np.asarray(a) for a in jdp.eft_sweep(*f32, ctx.same, gbps, S=S)]
    got = ref.eft_sweep_ref(*(torch.from_numpy(a) for a in f32),
                            torch.from_numpy(ctx.same),
                            torch.from_numpy(gbps), S=S)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(_bits(g.numpy()), _bits(w))
    if S == 2:
        assert int(got[3].max()) > S - 1          # overflow flagged


@pytest.mark.parametrize("case", ["chain", "ties"])
def test_plain_sweep_bitwise_equals_reference_float32_on_smoke_cases(case):
    """The chain (every task depends on the one placed just before it) and
    the tie-heavy pack (identical nodes in every warp of nodes) on which
    chip_smoke.py holds the sweep kernel to the plain sweep: the same
    arrays, cast to float32, through both packages' sweeps."""
    pack = chip_smoke.sweep_cases()[case]
    f32 = [a.astype(np.float32) if a.dtype == np.float64 else a
           for a in pack]
    want = [np.asarray(a) for a in jdp.eft_sweep(*f32, S=48)]
    got = ref.eft_sweep_ref(*(torch.from_numpy(a) for a in f32), S=48)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(_bits(g.numpy()), _bits(w))
    assert int(got[3].max()) <= 47                 # no stack overflowed
    if case == "chain":
        dep, order = pack[2], pack[1]
        assert (dep[order[1:], 0] == order[:-1]).all()
    else:
        # the first task's candidates tie on every node of class 0, which
        # spans all four warps of nodes; np.argmin keeps node 0
        first = pack[0][0]
        assert (first == first.min()).sum() == 25 and int(got[0][0]) == 0


# --- (c) fused_heft_schedule against the reference HEFT ---------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_fused_engines_match_reference_heft(seed):
    n_tasks, n_nodes = _sizes(seed)
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(n_tasks, n_nodes,
                                                       seed)
    jmat = _jmatrix(jdag, jnodes, jsvc)
    tmat = TMatrix(jmat.uids, jmat.node_names, jmat.means, jmat.stds)
    cache = {}
    for q in QUANTILES:
        want = jheft(jdag, jnodes, jmat, quantile=q)
        _same_schedule(jfused.fused_heft_schedule(jdag, jnodes, jmat,
                                                  quantile=q,
                                                  engine="numpy"), want)
        W = tfused.cost_view(tsvc, tdag, tnodes, q)
        for engine in ("numpy", "device"):
            _same_schedule(tfused.fused_heft_schedule(
                tdag, tnodes, tmat, quantile=q, rank_cache=cache,
                engine=engine, device="cpu"), want)
            _same_schedule(tfused.fused_heft_schedule(
                tdag, tnodes, None, rank_cache=cache, engine=engine,
                W=W, device="cpu"), want)


@pytest.mark.parametrize("form", ["dict", "callable", "array"])
def test_fused_engines_match_on_constrained_replans(form):
    """node_available busy prefixes + external ready times in each form
    the fused engine takes (the reference HEFT takes dict or callable)."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(24, 4, 7)
    rng = np.random.default_rng(7)
    avail = {n.name: float(rng.uniform(0.0, 30.0)) for n in jnodes}
    ready_d = {u: float(rng.uniform(0.0, 20.0)) for u in jdag.tasks}
    off = {n.name: 0.25 * (k % 7) for k, n in enumerate(jnodes)}

    def ready_fn(uid, node):
        return ready_d[uid] + off[node.name]

    order = jdag.topo_order()
    ready = {"dict": ready_d, "callable": ready_fn,
             "array": np.asarray([[ready_fn(u, n) for n in jnodes]
                                  for u in order])}[form]
    ref_ready = ready_fn if form == "array" else ready
    jmat = _jmatrix(jdag, jnodes, jsvc)
    want = jheft(jdag, jnodes, jmat, quantile=0.95, ready_at=ref_ready,
                 node_available=avail)
    W = tfused.cost_view(tsvc, tdag, tnodes, 0.95)
    for engine in ("numpy", "device"):
        _same_schedule(tfused.fused_heft_schedule(
            tdag, tnodes, None, ready_at=ready, node_available=avail,
            engine=engine, W=W, device="cpu"), want)


def test_slot_overflow_retry_doubles_the_stacks():
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(40, 4, 3)
    want = jheft(jdag, jnodes, _jmatrix(jdag, jnodes, jsvc))
    cache = {}
    ctx = tfused._context(tdag, tnodes, cache)
    ctx.slot_cap = 2
    got = tfused.fused_heft_schedule(
        tdag, tnodes, None, rank_cache=cache, engine="device",
        W=tfused.cost_view(tsvc, tdag, tnodes), device="cpu")
    _same_schedule(got, want)
    assert ctx.slot_cap > 2


def test_auto_engine_policy_is_size_based(monkeypatch):
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(20, 4, 3)
    W = tfused.cost_view(tsvc, tdag, tnodes)
    want = jheft(jdag, jnodes, _jmatrix(jdag, jnodes, jsvc))
    calls = []
    real = tfused._schedule_device
    monkeypatch.setattr(tfused, "_schedule_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _same_schedule(tfused.fused_heft_schedule(tdag, tnodes, None, W=W,
                                              device="cpu"), want)
    assert not calls                               # 80 cells < threshold
    monkeypatch.setattr(tfused, "_DEVICE_MIN_CELLS", 80)
    _same_schedule(tfused.fused_heft_schedule(tdag, tnodes, None, W=W,
                                              device="cpu"), want)
    assert calls


# --- the kernels' wrappers take CUDA tensors only ---------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(3, dtype=torch.float64)
    _, post, base, corr = _cost_case(3, 2, 3)
    batch = tdp.pack_cost("cpu", np.zeros(3), post, corr)
    with pytest.raises(ValueError, match="CUDA"):
        tdp.fused_cost(batch, torch.from_numpy(base))
    with pytest.raises(ValueError, match="CUDA"):
        tdp.eft_sweep(torch.zeros((3, 2), dtype=torch.float64), *([x] * 7),
                      S=4)


H100_SMEM_OPTIN = 232448        # cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.mark.parametrize("shape,route", [
    ((1000, 100, 48, 10), "shared"),   # the main path's replan round
    ((1000, 100, 96, 10), "shared"),   # its first slot retry
    ((1000, 100, 192, 10), "global"),  # 307 KB of interval stacks
    ((200, 1500, 48, 3), "global"),    # more nodes than a block's threads
    ((20000, 100, 48, 0), "global"),   # order and dependency rows too large
    ((512, 512, 4, 3), "shared"),      # the most nodes the shared route takes
    ((512, 513, 4, 3), "global"),
])
def test_sweep_route_is_a_function_of_shapes_and_the_limit(shape, route):
    assert tdp.sweep_route(*shape, H100_SMEM_OPTIN) == route
    fits = tdp.sweep_smem_bytes(*shape) <= H100_SMEM_OPTIN
    assert (route == "shared") == (
        fits and shape[1] <= tdp.SWEEP_SHARED_MAX_NODES)
    # a card with less shared memory sends the same shape to global
    assert tdp.sweep_route(*shape, tdp.sweep_smem_bytes(*shape) - 1) \
        == "global"


def test_device_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    _, (tdag, tnodes, tsvc) = _pair(20, 4, 3)
    W = tfused.cost_view(tsvc, tdag, tnodes)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfused.fused_heft_schedule(tdag, tnodes, None, W=W, engine="device")
    with pytest.raises(ValueError, match="engine"):
        tfused.fused_heft_schedule(tdag, tnodes, None, W=W, engine="jit",
                                   device="cpu")


# --- non-finite costs are refused -------------------------------------------

def _sink_row(dag):
    """The topo row of the first task no other task depends on."""
    used = {d for t in dag.tasks.values() for d in t.deps}
    return next(i for i, u in enumerate(dag.topo_order()) if u not in used)


@pytest.mark.parametrize("engine,bad,as_tensor", [
    ("numpy", float("nan"), False),
    ("device", float("nan"), True),
    ("numpy", float("inf"), True),
    ("device", float("inf"), False),
])
def test_non_finite_costs_are_refused(monkeypatch, engine, bad, as_tensor):
    """A NaN or +inf cost row, on which the reference HEFT and each engine
    would start the task at a different time, raises a ValueError that
    names the first bad (task, node) before the ranks and any launch."""
    _, (tdag, tnodes, tsvc) = _pair(23, 6, 2)
    W = tfused.cost_view(tsvc, tdag, tnodes).clone()
    i = _sink_row(tdag)
    W[i, 2:] = bad
    calls = []
    monkeypatch.setattr(tfused._PlanContext, "ranks",
                        lambda *a: calls.append("ranks"))
    monkeypatch.setattr(tfused, "_schedule_device",
                        lambda *a: calls.append("device"))
    monkeypatch.setattr(tfused, "_schedule_numpy",
                        lambda *a: calls.append("numpy"))
    u, node = tdag.topo_order()[i], tnodes[2].name
    with pytest.raises(ValueError, match=rf"W\[{i}, 2\] \(task '{u}' on "
                       rf"node '{node}'\) is {bad!r}"):
        tfused.fused_heft_schedule(tdag, tnodes, None,
                                   W=W if as_tensor else W.numpy(),
                                   engine=engine, device="cpu")
    assert calls == []


def test_finite_costs_still_schedule_as_the_reference():
    """The check passes finite W through untouched: the same round as
    above, unmodified, is identical to heft_schedule_matrix on both
    engines."""
    (jdag, jnodes, jsvc), (tdag, tnodes, tsvc) = _pair(23, 6, 2)
    want = jheft(jdag, jnodes, _jmatrix(jdag, jnodes, jsvc))
    W = tfused.cost_view(tsvc, tdag, tnodes)
    for engine in ("numpy", "device"):
        _same_schedule(tfused.fused_heft_schedule(
            tdag, tnodes, None, W=W, engine=engine, device="cpu"), want)
