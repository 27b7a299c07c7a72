"""core.bayes and core.correlation of the port against the JAX package.

`fit_blr` is a float32 fixed point in both packages; held at rtol 1e-4 /
atol 1e-5, well inside the 5e-3 / 5e-4 the kernels are held to.  An atol is
needed because the standardized intercept and sigma[0,1] sit near 0, where
a relative error means nothing.  `predict_blr_np`, `constant_posterior`
and the Pearson gate are the same host arithmetic: held bitwise, or to the
same decision."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bayes as jbayes
from repro.core import correlation as jcorr
from repro_torch.core import bayes as tbayes
from repro_torch.core import correlation as tcorr

FIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _tasks(seed, t=40):
    """t random 3-10 point tasks, linear with noise, padded to 10 cols."""
    rng = np.random.default_rng(seed)
    x = np.zeros((t, 10), np.float32)
    y = np.zeros((t, 10), np.float32)
    m = np.zeros((t, 10), np.float32)
    for i, k in enumerate(rng.integers(3, 11, t)):
        xi = rng.uniform(0.05, 5.0, k)
        x[i, :k] = xi
        y[i, :k] = (rng.uniform(2, 40) + rng.uniform(0.5, 60) * xi) \
            * (1 + rng.normal(0, rng.choice([0.01, 0.1, 0.5]), k))
        m[i, :k] = 1.0
    return x, y, m


@pytest.mark.parametrize("seed", range(5))
def test_fit_blr_matches_reference(seed):
    x, y, m = _tasks(seed)
    want = jbayes.fit_blr_batch(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(m))
    for i in range(x.shape[0]):
        k = int(m[i].sum())
        got = tbayes.fit_blr(torch.from_numpy(x[i, :k]),
                             torch.from_numpy(y[i, :k]))
        for leaf, w in want.items():
            np.testing.assert_allclose(got[leaf].numpy(), np.asarray(w[i]),
                                       **FIT_TOL, err_msg=f"{i} {leaf}")


@pytest.mark.parametrize("seed", range(3))
def test_fit_blr_batch_masked_matches_reference(seed):
    x, y, m = _tasks(100 + seed)
    want = jbayes.fit_blr_batch(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(m))
    got = tbayes.fit_blr_batch(*(torch.from_numpy(a) for a in (x, y, m)))
    for leaf, w in want.items():
        np.testing.assert_allclose(got[leaf].numpy(), np.asarray(w),
                                   **FIT_TOL, err_msg=leaf)


def test_predict_blr_matches_reference():
    x, y, m = _tasks(7, t=1)
    k = int(m[0].sum())
    jpost = jbayes.fit_blr(jnp.asarray(x[0, :k]), jnp.asarray(y[0, :k]))
    tpost = {k_: torch.tensor(np.asarray(v)) for k_, v in jpost.items()}
    x_new = np.linspace(0.1, 8.0, 17).astype(np.float32)
    jm, js = jbayes.predict_blr(jpost, jnp.asarray(x_new))
    tm, ts = tbayes.predict_blr(tpost, torch.from_numpy(x_new))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_predict_blr_np_bitwise():
    x, y, m = _tasks(9, t=8)
    post = {k: np.asarray(v) for k, v in jbayes.fit_blr_batch(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)).items()}
    x_new = np.random.default_rng(0).uniform(0, 9, 8)
    for a, b in zip(tbayes.predict_blr_np(post, x_new),
                    jbayes.predict_blr_np(post, x_new)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mean,std", [(12.5, 3.0), (3600.25, 0.0),
                                      (0.001, 1e-9)])
def test_constant_posterior_identical(mean, std):
    a, b = tbayes.constant_posterior(mean, std), \
        jbayes.constant_posterior(mean, std)
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        assert np.array_equal(a[k], b[k]), k
    # its predictive is exactly (mean, max(std, 1e-6)) at any input
    pm, ps = tbayes.predict_blr_np(a, np.array([0.0, 7.0, 1e4]))
    assert np.all(pm == mean) and np.all(ps == max(std, 1e-6))


@pytest.mark.parametrize("seed", range(4))
def test_pearson_gate_matches_reference(seed):
    """The port's numpy Pearson gate (no JAX) agrees with the reference's
    array version: the same r to float32 rounding, the same gate decision
    and the same masked median."""
    rng = np.random.default_rng(seed)
    n = 12
    x = rng.uniform(0.1, 5, n).astype(np.float32)
    y = (3 + rng.uniform(-4, 4) * x + rng.normal(0, 2, n)).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    for mm in (None, mask):
        jr = float(jcorr.pearson(jnp.asarray(x), jnp.asarray(y),
                                 None if mm is None else jnp.asarray(mm)))
        tr = float(tcorr.pearson(x, y, mm))
        assert tr == pytest.approx(jr, rel=1e-5, abs=1e-6)
        for thr in (0.3, 0.75, 0.95):
            if abs(abs(jr) - thr) > 1e-5:
                assert bool(tcorr.strongly_correlated(x, y, mm, thr)) == \
                    bool(jcorr.strongly_correlated(
                        jnp.asarray(x), jnp.asarray(y),
                        None if mm is None else jnp.asarray(mm), thr))
    assert float(tcorr.masked_median(y, mask)) == pytest.approx(
        float(jcorr.masked_median(jnp.asarray(y), jnp.asarray(mask))))
    assert float(tcorr.masked_median(y)) == pytest.approx(
        float(jcorr.masked_median(jnp.asarray(y))))


def test_fit_blr_batch_eigvalsh_slices_bitwise(monkeypatch):
    """A batch over EIGVALSH_SLICE (the slice size cuSOLVER takes on an
    H100, lowered here to keep the test small) fits bitwise what one
    unsliced eigvalsh gives."""
    x, y, m = _tasks(11, t=45)
    args = [torch.from_numpy(a) for a in (x, y, m)]
    whole = tbayes.fit_blr_batch(*args)
    monkeypatch.setattr(tbayes, "EIGVALSH_SLICE", 8)
    sliced = tbayes.fit_blr_batch(*args)
    for leaf, v in whole.items():
        assert torch.equal(sliced[leaf], v), leaf
