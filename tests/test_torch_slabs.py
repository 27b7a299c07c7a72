"""The port's packed operand slabs against the JAX package, on the CPU.

`bayes_predict` and `nig_fold` take their operands as one packed float64
slab each: the predictive's queries in column groups
(`kernels.bayes_fit.fill_slab`) with, when the results go to resident
rows, the table of its targets, packed together by `pack_predict` into
one `PredictBatch`; the fold's ragged
rows (`core.bayes.fold_pack`), its states back as one (T, 9) slab
(`fold_unpack`).  Here:

  * both slabs round-trip bitwise, with sigma, V and prec asymmetric in
    the last ulp (as lifted from float32 fits) and fold rows with no
    observation;
  * `bayes_predict_ref` on the slab is bitwise `predict_blr_np` and within
    the float32 tolerance of the JAX `bayes_predict` in interpret mode, at
    Q in {1, 140, 1000, 4097}, with the results interleaved and scattered
    into resident rows;
  * `nig_fold_ref` and the numpy fold on the ragged slab are bitwise the
    JAX `nig_update` chain, for T in {1, 5, 63, 64, 200} with ragged rows
    of 0 to 8 observations, and on a row of 300 observations;
  * the wrappers' and plain versions' argument checks: neither takes a
    slab and targets that `pack_predict` did not pack together.

Fixed seeds, no hypothesis."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bayes as jbayes
from repro.kernels import bayes_fit as jkernels
from repro_torch.core import bayes as tbayes
from repro_torch.kernels import bayes_fit as tkernels
from repro_torch.kernels import decision_plane as tdp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.staging import staged
from repro_torch.store import PosteriorStore as TStore

Q_CASES = [1, 140, 1000, 4097]
FOLD_T = [1, 5, 63, 64, 200]
LEAVES = ("mu", "v", "prec", "b")


def _posteriors(q, seed):
    """q posterior rows whose sigma is asymmetric in the last ulp (as a
    float32 fit lifted to float64 can be), and their inputs."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(q, 2, 2)) * 0.3
    sigma = lo @ lo.transpose(0, 2, 1)
    sigma[:, 1, 0] = np.nextafter(sigma[:, 0, 1], np.inf)
    post = {"mu": rng.normal(size=(q, 2)), "sigma": sigma,
            "beta_prec": rng.uniform(0.5, 50.0, q),
            "x_mu": rng.uniform(0.0, 5.0, q),
            "x_sd": rng.uniform(0.1, 3.0, q),
            "y_mu": rng.uniform(10.0, 5000.0, q),
            "y_sd": rng.uniform(1.0, 100.0, q)}
    return rng.uniform(0.0, 10.0, q), post


def _fitted_nigs(rng, t):
    """t NIG states lifted (by the reference) from float32 MacKay fits of
    4-8 noisy linear points each: v and prec can be asymmetric in the
    last ulp."""
    n = max(t, 8)
    k = rng.integers(4, 9, n)
    m = (np.arange(8)[None, :] < k[:, None]).astype(np.float32)
    x = rng.uniform(0.05, 2.0, (n, 8))
    y = 2.0 + 20.0 * x + rng.normal(0.0, 0.3, (n, 8))
    post = {key: np.asarray(v) for key, v in
            jbayes.fit_blr_batch(x * m, y * m, m).items()}
    return [jbayes.nig_from_blr({key: v[i] for key, v in post.items()})
            for i in range(t)]


def _rows(rng, lengths):
    xs = [list(rng.uniform(0.05, 3.0, k)) for k in lengths]
    ys = [[float(rng.uniform(4.0, 120.0)) for _ in r] for r in xs]
    return xs, ys


def _jax_chain(nigs, xs, ys):
    out = []
    for nig, xr, yr in zip(nigs, xs, ys):
        w = dict(nig)
        for x, y in zip(xr, yr):
            w = jbayes.nig_update(w, x, y)
        out.append(w)
    return out


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


# --- the predictive's row slab -----------------------------------------------

@pytest.mark.parametrize("q", [0, 1, 140, 1000, 4097])
def test_predict_slab_round_trips_bitwise(q):
    """The predictive's slab holds each query's values in column groups,
    each group on a 16-byte boundary, bit for bit as given; filled from a
    dict of leaves or by a callable writing into the groups (the store's
    gather), the same slab."""
    x, post = _posteriors(q, seed=q)
    dest = np.random.default_rng(q).permutation(q)
    slab = np.full(tkernels.predict_slots(q), np.nan)
    cols = tkernels.fill_slab(slab, q, x, post, dest)
    assert [k for k, _ in tkernels.QUERY_GROUPS] == list(cols)
    for k, v in cols.items():
        assert np.shares_memory(v, slab) or not q
        assert (v.__array_interface__["data"][0] - slab.ctypes.data) % 16 == 0
        want = {"x": x, "dest": dest}.get(k, post.get(k))
        assert v.shape == np.shape(want)
        assert np.array_equal(_bits(v), _bits(want)), k
    assert cols["dest"].dtype == np.int64
    again = np.full_like(slab, np.nan)

    def gather(out):
        for k, v in out.items():
            v[:] = post[k]
    tkernels.fill_slab(again, q, x, gather, dest)
    assert np.array_equal(_bits(again), _bits(slab))
    # without destinations the group holds 0; the CPU batch is the slab
    batch = tkernels.pack_predict("cpu", x, post)
    got = tkernels.slab_columns(batch.slab, q)
    assert not got["dest"].any()
    assert batch.slab.shape == (tkernels.predict_slots(q),)
    assert np.array_equal(_bits(got["sigma"].numpy()), _bits(post["sigma"]))


@pytest.mark.parametrize("block_size", [1, 3, 512])
def test_store_gather_into_given_arrays(block_size):
    """A gather written into the caller's arrays (each plane's stretch of
    a replan batch) is the gather, bit for bit, block by block."""
    _, post = _posteriors(11, seed=block_size)
    store = TStore(block_size)
    store.put_many([(f"t/wf/k{i}", {k: v[i] for k, v in post.items()})
                    for i in range(11)])
    snap = store.snapshot()
    keys = [f"t/wf/k{i}" for i in (7, 0, 3, 3, 10, 1)]
    want = snap.gather(keys)
    given = {k: np.full((len(keys) + 2,) + v.shape[1:], 0.5)
             for k, v in want.items()}
    got = snap.gather(keys, {k: v[1:-1] for k, v in given.items()})
    for k, v in want.items():
        assert np.shares_memory(got[k], given[k])
        assert np.array_equal(_bits(given[k][1:-1]), _bits(v))
        assert (given[k][[0, -1]] == 0.5).all()     # the rest untouched


@pytest.mark.parametrize("q", Q_CASES)
def test_bayes_predict_ref_on_the_slab_interleaved(q):
    x, post = _posteriors(q, seed=100 + q)
    batch = tkernels.pack_predict("cpu", x, post)
    assert batch.slab.shape == (tkernels.predict_slots(q),)
    out = ops.bayes_predict(batch)
    assert out.shape == (q, 2) and out.dtype == torch.float64
    want_mean, want_std = jbayes.predict_blr_np(post, x)
    assert np.array_equal(_bits(out[:, 0].numpy()), _bits(want_mean))
    assert np.array_equal(_bits(out[:, 1].numpy()), _bits(want_std))
    jm, js = jkernels.bayes_predict(
        jnp.asarray(x, jnp.float32),
        {k: jnp.asarray(v, jnp.float32) for k, v in post.items()},
        interpret=True)
    # float32 kernel vs float64 plain version: a few float32 ulps of the
    # outputs' scale (tests/test_torch_kernels.py)
    for j, g in ((jm, want_mean), (js, want_std)):
        np.testing.assert_allclose(np.asarray(j), g, rtol=2e-6,
                                   atol=2e-6 * np.abs(g).max())


def _targets(rng, q, n_planes, pad=5):
    """n_planes resident planes sharing q rows in order: (first row,
    length) a plane, each a few rows longer than its share, and each
    row's destination (its plane's rows shuffled)."""
    cuts = np.sort(rng.choice(np.arange(1, q), n_planes - 1, replace=False))
    firsts = np.concatenate([[0], cuts]).astype(int)
    share = np.diff(np.append(firsts, q))
    lens = share + rng.integers(0, pad + 1, n_planes)
    dest = np.concatenate([rng.permutation(n)[:k]
                           for n, k in zip(lens, share)])
    return firsts, lens, dest


def _nan_target(n):
    t = tkernels.PredictTarget(n, "cpu")
    t.mean.fill_(float("nan"))
    t.std.fill_(float("nan"))
    return t


@pytest.mark.parametrize("q", Q_CASES)
def test_bayes_predict_ref_scatters_into_resident_rows(q):
    x, post = _posteriors(q, seed=200 + q)
    rng = np.random.default_rng(q)
    n_planes = min(q, 7)
    firsts, lens, dest = _targets(rng, q, n_planes)
    share = np.diff(np.append(firsts, q))
    targets = [_nan_target(n) for n in lens]
    batch = tkernels.pack_predict("cpu", x, post, dest,
                                  list(zip(targets, share)))
    table = tkernels.slab_table(batch)
    assert table[:, 0].tolist() == firsts.tolist()
    assert table[:, 3].tolist() == lens.tolist()
    assert table[:, 1].tolist() == [t.mean.data_ptr() for t in targets]
    assert ops.bayes_predict(batch) is None
    want_mean, want_std = jbayes.predict_blr_np(post, x)
    jm, _ = jkernels.bayes_predict(
        jnp.asarray(x, jnp.float32),
        {k: jnp.asarray(v, jnp.float32) for k, v in post.items()},
        interpret=True)
    for k, t in enumerate(targets):
        rows = slice(firsts[k], firsts[k] + share[k])
        d = dest[rows]
        assert np.array_equal(_bits(t.mean[d].numpy()),
                              _bits(want_mean[rows]))
        assert np.array_equal(_bits(t.std[d].numpy()), _bits(want_std[rows]))
        np.testing.assert_allclose(
            np.asarray(jm)[rows], t.mean[d].numpy(), rtol=2e-6,
            atol=2e-6 * np.abs(want_mean).max())
        untouched = np.setdiff1d(np.arange(t.n), d)
        assert torch.isnan(t.mean[untouched]).all()
        assert torch.isnan(t.std[untouched]).all()


def test_predict_argument_checks():
    x, post = _posteriors(4, seed=0)
    slab = tkernels.pack_predict("cpu", x, post).slab
    batch = lambda s: tkernels.PredictBatch._packed(s, 4, ())
    with pytest.raises(ValueError, match="at least"):
        ops.bayes_predict(batch(slab[:40]))            # a short slab
    spare = torch.cat([torch.zeros(1, dtype=torch.float64), slab])
    with pytest.raises(ValueError, match="16-byte"):
        ops.bayes_predict(batch(spare[1:]))            # off a boundary
    with pytest.raises(ValueError, match="vector"):
        ops.bayes_predict(batch(slab.view(4, -1)))     # not a vector
    resident = _nan_target(4)
    pack = lambda targets, dest=np.arange(4): tkernels.pack_predict(
        "cpu", x, post, dest, targets)
    with pytest.raises(ValueError, match="at least one"):
        pack([])
    for bad in ([(resident, 3)], [(resident, 3), (resident, 2)],
                [(resident, 5), (resident, -1)]):
        with pytest.raises(ValueError, match="sum to 4"):
            pack(bad)
    with pytest.raises(ValueError, match="destination"):
        pack([(resident, 4)], dest=None)
    with pytest.raises(ValueError, match="PredictTarget"):
        pack([((resident.mean, resident.std), 4)])
    with pytest.raises(ValueError, match="PredictTarget on cpu"):
        pack([(tkernels.PredictTarget(4, "meta"), 4)])
    assert tkernels.bayes_predict.launches == 0


def test_a_slab_and_targets_packed_apart_are_refused_on_both_routes():
    """Both routes take only what `pack_predict` packed: a slab handed
    beside a target list (whose table the kernel would follow) is
    refused before anything is read or written."""
    x, post = _posteriors(6, seed=1)
    resident = _nan_target(6)
    good = tkernels.pack_predict("cpu", x, post, np.arange(6),
                                 [(resident, 6)])
    other = _nan_target(6)
    for route in (ops.bayes_predict, tkernels.bayes_predict,
                  ref.bayes_predict_ref):
        with pytest.raises(TypeError):
            route(good.slab, 6, [(0, other.mean, other.std)])
        for forged in (good.slab, (good.slab, 6, (other,))):
            with pytest.raises(TypeError, match="PredictBatch"):
                route(forged)
    assert torch.isnan(resident.mean).all() and torch.isnan(other.mean).all()
    assert tkernels.bayes_predict.launches == 0
    # packed together, the rows land in the targets the table names
    assert ops.bayes_predict(good) is None
    assert not torch.isnan(resident.mean).any()


@pytest.mark.parametrize("kind", ["predict", "cost"])
def test_batches_are_made_by_their_packers_alone(kind):
    """A `PredictBatch` or `CostBatch` constructed other than by its
    packer is refused when it is made, before any route can read it: a
    forged batch cannot pair a slab with targets its table does not
    name."""
    x, post = _posteriors(6, seed=2)
    resident, other = _nan_target(6), _nan_target(6)
    if kind == "predict":
        good = tkernels.pack_predict("cpu", x, post, np.arange(6),
                                     [(resident, 6)])
        with pytest.raises(TypeError, match="pack_predict alone"):
            tkernels.PredictBatch(good.slab, 6, (other,))
        with pytest.raises(TypeError, match="pack_predict alone"):
            tkernels.PredictBatch(slab=good.slab, q=6, targets=())
        assert ops.bayes_predict(good) is None
        assert not torch.isnan(resident.mean).any()
    else:
        good = tdp.pack_cost("cpu", x, post, [1.0, 1.5])
        with pytest.raises(TypeError, match="pack_cost alone"):
            tdp.CostBatch(good.slab, 6, 2)
        with pytest.raises(TypeError, match="CostBatch"):
            ops.fused_cost(good.slab, torch.ones((6, 2), dtype=torch.float64))
        w = ops.fused_cost(good, torch.ones((6, 2), dtype=torch.float64))
        assert w.shape == (6, 2) and torch.isfinite(w).all()
    assert torch.isnan(other.mean).all()
    assert tkernels.bayes_predict.launches == 0
    assert tdp.fused_cost.launches == 0


def test_cost_argument_checks():
    """The cost routes' checks: a short slab, a slab off a 16-byte
    boundary, and a static factor matrix of the wrong shape, type or
    alignment are refused on the plain route as on the card's."""
    x, post = _posteriors(4, seed=3)
    good = tdp.pack_cost("cpu", x, post, [1.0, 2.0, 0.5])
    base = torch.ones((4, 3), dtype=torch.float64)
    batch = lambda s: tdp.CostBatch._packed(s, 4, 3)
    with pytest.raises(ValueError, match="at least"):
        ops.fused_cost(batch(good.slab[:40]), base)
    spare = torch.cat([torch.zeros(1, dtype=torch.float64), good.slab])
    with pytest.raises(ValueError, match="16-byte"):
        ops.fused_cost(batch(spare[1:]), base)
    with pytest.raises(ValueError, match="shape"):
        ops.fused_cost(good, torch.ones((3, 4), dtype=torch.float64))
    with pytest.raises(TypeError, match="dtype"):
        ops.fused_cost(good, base.float())
    wide = torch.ones(13, dtype=torch.float64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.fused_cost(good, wide[1:].view(4, 3))
    assert ops.fused_cost(good, base).shape == (4, 3)


def test_predict_target_rows_are_what_the_table_says():
    t = tkernels.PredictTarget(5, "cpu")
    for v in (t.mean, t.std):
        assert v.dtype == torch.float64 and v.shape == (5,)
        assert v.is_contiguous() and v.device == t.device
    assert t.n == 5 and t.mean.data_ptr() != t.std.data_ptr()


# --- the fold's ragged slab ------------------------------------------------

@pytest.mark.parametrize("t", FOLD_T)
def test_fold_slab_round_trips_bitwise(t):
    rng = np.random.default_rng(300 + t)
    nigs = _fitted_nigs(rng, t)
    xs, ys = _rows(rng, rng.integers(0, 9, t))
    if t > 1:
        xs[0], ys[0] = [], []                     # a row with no observation
    slab, counts, a, n_obs = tbayes.fold_pack(nigs, xs, ys)
    assert slab.dtype == np.float64 and slab.ndim == 1
    head = tbayes.fold_head(t)
    assert head % 2 == 0 and head >= t + 1
    off = slab[:t + 1].view(np.int64)
    assert off[0] == head and off[-1] == len(slab)
    assert (off % 2 == 0).all()                   # 16-byte rows
    assert np.array_equal(np.diff(off), tbayes.FOLD_HEAD + 2 * counts)
    assert counts.tolist() == [len(r) for r in xs]
    for i, nig in enumerate(nigs):
        row = slab[off[i]:off[i + 1]]
        hdr = [len(xs[i]), *nig["mu"], nig["v"][0, 0], nig["v"][0, 1],
               nig["v"][1, 1], nig["prec"][0, 0], nig["prec"][0, 1],
               nig["prec"][1, 1], nig["b"]]
        assert np.array_equal(_bits(row[:tbayes.FOLD_HEAD]), _bits(hdr))
        sx = (np.asarray(xs[i], np.float64) - nig["x_mu"]) / nig["x_sd"]
        sy = (np.asarray(ys[i], np.float64) - nig["y_mu"]) / nig["y_sd"]
        assert np.array_equal(_bits(row[tbayes.FOLD_HEAD::2]), _bits(sx))
        assert np.array_equal(_bits(row[tbayes.FOLD_HEAD + 1::2]), _bits(sy))
    assert np.array_equal(a, [n["a"] for n in nigs])
    assert np.array_equal(n_obs, [n["n_obs"] for n in nigs])
    # the header's states back, unfolded: rows with no observation
    # verbatim (their asymmetric v untouched), the others symmetric
    state = np.stack([slab[o + 1:o + tbayes.FOLD_HEAD] for o in off[:-1]])
    back = tbayes.fold_unpack(nigs, counts, state, a, n_obs)
    for i, (b, nig) in enumerate(zip(back, nigs)):
        if not counts[i]:
            assert b["v"] is nig["v"] and b["prec"] is nig["prec"]
            continue
        for leaf in ("v", "prec"):
            w = np.asarray(nig[leaf])
            assert np.array_equal(_bits(b[leaf]), _bits(
                [[w[0, 0], w[0, 1]], [w[0, 1], w[1, 1]]]))
        assert np.array_equal(_bits(b["mu"]), _bits(nig["mu"]))
    assert any(n["v"][0, 1] != n["v"][1, 0] for n in nigs) or t < 63


def test_fold_slab_takes_the_callers_buffer_and_checks_rows():
    rng = np.random.default_rng(9)
    nigs = _fitted_nigs(rng, 3)
    xs, ys = _rows(rng, [2, 0, 5])
    given = []

    def alloc(n):
        given.append(np.full(n, np.nan))
        return given[-1]
    slab, *_ = tbayes.fold_pack(nigs, xs, ys, alloc=alloc)
    assert slab is given[0] and not np.isnan(slab).any()
    with pytest.raises(ValueError, match="as many y"):
        tbayes.fold_pack(nigs, xs, [ys[0], ys[1], ys[2][:4]])
    empty, counts, *_ = tbayes.fold_pack([], [], [])
    assert empty.shape == (tbayes.fold_head(0),) and counts.shape == (0,)


def _fold_against_chain(nigs, xs, ys):
    t = len(nigs)
    slab, counts, a, n_obs = tbayes.fold_pack(nigs, xs, ys)
    state = ref.nig_fold_ref(torch.from_numpy(slab), t)
    assert state.shape == (t, tbayes.FOLD_STATE)
    assert np.array_equal(_bits(tbayes._nig_fold_np(slab, t)),
                          _bits(state.numpy()))
    a, n_obs = tbayes.fold_counts(a, n_obs, counts)
    got = tbayes.fold_unpack(nigs, counts, state.numpy(), a, n_obs)
    for i, (g, w) in enumerate(zip(got, _jax_chain(nigs, xs, ys))):
        for leaf in LEAVES + ("a", "n_obs"):
            assert np.array_equal(_bits(g[leaf]), _bits(w[leaf])), (i, leaf)


@pytest.mark.parametrize("t", FOLD_T)
def test_nig_fold_ref_on_the_ragged_slab_is_the_jax_chain(t):
    rng = np.random.default_rng(400 + t)
    nigs = _fitted_nigs(rng, t)
    xs, ys = _rows(rng, rng.integers(0, 9, t))
    if t > 1:
        xs[-1], ys[-1] = [], []
    _fold_against_chain(nigs, xs, ys)


def test_nig_fold_ref_on_a_row_of_300_observations():
    rng = np.random.default_rng(500)
    nigs = _fitted_nigs(rng, 7)
    lengths = [3, 0, 300, 8, 1, 0, 5]
    xs, ys = _rows(rng, lengths)
    _fold_against_chain(nigs, xs, ys)


def test_fold_argument_checks():
    rng = np.random.default_rng(1)
    nigs = _fitted_nigs(rng, 4)
    slab, *_ = tbayes.fold_pack(nigs, *_rows(rng, [1, 2, 0, 3]))
    st = torch.from_numpy(slab)
    with pytest.raises(ValueError, match="at least"):
        ops.nig_fold(st[:20], 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernels.nig_fold(st, 4)
    assert tkernels.nig_fold.launches == 0
    assert ops.nig_fold(torch.from_numpy(tbayes.fold_pack([], [], [])[0]),
                        0).shape == (0, tbayes.FOLD_STATE)


def test_staged_on_the_cpu_hands_the_array_over():
    with staged("cpu") as st:
        buf = st.host(6)
        buf[:] = np.arange(6.0)
        out = st.send()
    assert out.dtype == torch.float64 and out.tolist() == list(range(6))
    assert out.data_ptr() == buf.ctypes.data
