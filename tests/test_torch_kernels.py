"""The port's kernel modules against the JAX package, on the CPU.

A CPU tensor takes each kernel's plain PyTorch version, so these tests hold
the plain versions (the oracles the CUDA kernels are held against on the
card) to the reference: `bayes_predict` bitwise against
`core.bayes.predict_blr_np` and at float32 tolerance against the Pallas
kernel in interpret mode; `bayes_fit` against the Pallas kernel at the
rtol 5e-3 / atol 5e-4 of tests/test_kernels.py (its closed-form 2x2
algebra and its reduction order differ from the batched fit's) and against
the reference's batched `fit_blr`, the same algorithm, at rtol 1e-3 /
atol 1e-5.  Inputs are made with seeded numpy and fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bayes as jbayes
from repro.kernels import bayes_fit as jkernels
from repro.kernels import ref as jref
from repro.store import compute as jcompute
from repro_torch.kernels import bayes_fit as tkernels
from repro_torch.kernels import ops
from repro_torch.store import compute as tcompute

FIT_TOL = dict(rtol=5e-3, atol=5e-4)
# the plain fit and the reference's batched fit_blr run the same float32
# algorithm; over 30 fixed-point steps beta_prec drifts to about 1.5e-4
# relative on 10-point tasks, every other leaf stays within 1e-4
BATCH_TOL = dict(rtol=1e-3, atol=1e-5)
LEAVES = ("mu", "sigma", "beta_prec", "x_mu", "x_sd", "y_mu", "y_sd")


def _posteriors(q, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(q, 2, 2)) * 0.3
    post = {"mu": rng.normal(size=(q, 2)),
            "sigma": np.ascontiguousarray(lo @ lo.transpose(0, 2, 1)),
            "beta_prec": rng.uniform(0.5, 50.0, q),
            "x_mu": rng.uniform(0.0, 5.0, q),
            "x_sd": rng.uniform(0.1, 3.0, q),
            "y_mu": rng.uniform(10.0, 5000.0, q),
            "y_sd": rng.uniform(1.0, 100.0, q)}
    return rng.uniform(0.0, 10.0, q), post


def _buffers(t, seed, lo=3, hi=11):
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(0.1, 5.0, k) for k in rng.integers(lo, hi + 1, t)]
    ys = [rng.uniform(5, 50) + rng.uniform(1, 10) * x
          + rng.normal(0, 0.05, len(x)) for x in xs]
    return xs, ys


def _torch_post(post):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in post.items()}


# Q values off any tile multiple: the port pads nothing (the reference
# padded to _PREDICT_TILE = 1024 only to avoid recompiles)
@pytest.mark.parametrize("q", [0, 1, 7, 1023, 1025, 4099])
def test_bayes_predict_plain_bitwise_vs_predict_blr_np(q):
    x, post = _posteriors(q, seed=q)
    mean, std = ops.bayes_predict(torch.from_numpy(x), _torch_post(post))
    want_mean, want_std = jbayes.predict_blr_np(post, x)
    assert mean.shape == (q,) and std.shape == (q,)
    assert np.array_equal(mean.numpy(), want_mean)
    assert np.array_equal(std.numpy(), want_std)


@pytest.mark.parametrize("q", [5, 1000, 2500])
def test_bayes_predict_plain_vs_pallas_interpret(q):
    x, post = _posteriors(q, seed=100 + q)
    mean, std = ops.bayes_predict(torch.from_numpy(x), _torch_post(post))
    jm, js = jkernels.bayes_predict(
        jnp.asarray(x, jnp.float32),
        {k: jnp.asarray(v, jnp.float32) for k, v in post.items()},
        interpret=True)
    # float32 kernel vs float64 plain version: a few float32 ulps of the
    # outputs' scale
    np.testing.assert_allclose(np.asarray(jm), mean.numpy(),
                               rtol=2e-6, atol=2e-6 * np.abs(mean.numpy()).max())
    np.testing.assert_allclose(np.asarray(js), std.numpy(),
                               rtol=2e-6, atol=2e-6 * np.abs(std.numpy()).max())


def test_predict_stacked_bitwise_vs_reference():
    x, post = _posteriors(777, seed=3)
    got = tcompute.predict_stacked(x, post, device="cpu")
    want = jcompute.predict_stacked(x, post)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w)


# (T, max points): task counts off the Pallas block of 128, ragged masks
@pytest.mark.parametrize("t,hi", [(1, 5), (64, 10), (130, 10), (257, 40)])
def test_bayes_fit_plain_vs_pallas_and_ref(t, hi):
    x, y, m = jkernels.pad_ragged(*_buffers(t, seed=t, hi=hi))
    got = ops.bayes_fit(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(m))
    pallas = jkernels.bayes_fit_ragged(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(m), interpret=True)
    oracle = jref.bayes_fit_ref(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(m))
    for leaf in pallas:
        g = got[leaf].numpy()
        assert g.shape == np.shape(pallas[leaf]), leaf
        np.testing.assert_allclose(g, np.asarray(pallas[leaf]), **FIT_TOL,
                                   err_msg=leaf)
        np.testing.assert_allclose(g, np.asarray(oracle[leaf]), **BATCH_TOL,
                                   err_msg=leaf)


def test_bayes_fit_padded_rows_are_no_ops():
    """A fully masked row fits to a finite default posterior and leaves
    the other rows exactly as they fit alone."""
    x, y, m = jkernels.pad_ragged(*_buffers(9, seed=5))
    pad = np.zeros((3, x.shape[1]), np.float32)
    alone = ops.bayes_fit(*(torch.from_numpy(a) for a in (x, y, m)))
    padded = ops.bayes_fit(*(torch.from_numpy(np.concatenate([a, pad]))
                             for a in (x, y, m)))
    for leaf, v in alone.items():
        assert torch.equal(padded[leaf][:9], v), leaf
        assert bool(torch.isfinite(padded[leaf][9:]).all()), leaf
    assert torch.equal(padded["n"][9:], torch.ones(3))


def test_fit_stacked_vs_reference():
    x, y, m = jkernels.pad_ragged(*_buffers(50, seed=8, hi=20))
    got = tcompute.fit_stacked(x, y, m, device="cpu")
    want = jcompute.fit_stacked(x, y, m)
    assert set(got) == set(want)
    for leaf, w in want.items():
        assert got[leaf].dtype == np.float64
        np.testing.assert_allclose(got[leaf], w, **BATCH_TOL, err_msg=leaf)


@pytest.mark.parametrize("lengths,min_cols,col_bucket", [
    ([3, 10, 64], 2, 64),
    ([1, 65, 7], 2, 64),
    ([4, 4], 2, 1),
    ([], 2, 64),
    ([5, 2, 9], 16, 8),
])
def test_pad_ragged_byte_identical(lengths, min_cols, col_bucket):
    rng = np.random.default_rng(len(lengths) + min_cols)
    xs = [rng.uniform(0, 5, k) for k in lengths]
    ys = [rng.uniform(0, 50, k) for k in lengths]
    got = tkernels.pad_ragged(xs, ys, min_cols, col_bucket)
    want = jkernels.pad_ragged(xs, ys, min_cols, col_bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_pad_ragged_rejects_mismatched_rows():
    with pytest.raises(ValueError):
        tkernels.pad_ragged([np.ones(3)], [np.ones(2)])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only: a CPU tensor is refused
    before any build or launch (the CPU goes through kernels.ops)."""
    x, post = _posteriors(4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.bayes_predict(torch.from_numpy(x), _torch_post(post))
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.bayes_fit(z, z, z)
    assert tkernels.bayes_predict.launches == 0
    assert tkernels.bayes_fit.launches == 0


def test_ops_refuse_other_devices():
    z = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.bayes_fit(z, z, z)
