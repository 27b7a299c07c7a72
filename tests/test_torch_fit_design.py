"""The arithmetic of the CUDA `bayes_fit` kernel, rehearsed on the CPU.

The kernel (`repro_torch/kernels/csrc/bayes.cu`, `bayes_fit_kernel`) runs
only on the card.  It takes each row's float32 means, then in one pass
over the centred row its variances, the Gram of [1, xs], phi^T y and six
float64 moments, scaled by the reciprocal sds afterwards, and runs the 30
fixed-point iterations on those alone: the residual
sum (ys - (mu1 + mu2 xs) m)^2 is taken as a quadratic form in (mu1, mu2).
These tests hold that algebra: the moment residual against the per-column
one in float64 (fractional masks too), and a numpy mirror of the kernel's
arithmetic against the JAX Pallas kernel in interpret mode and against the
port's plain batched fit at the kernels' rtol 5e-3 / atol 5e-4
(tests/test_kernels.py), on ragged rows, low-noise rows, one-point rows
and fully masked rows.  Inputs are made with seeded numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bayes_fit as jkernels
from repro_torch.core.bayes import fit_blr_batch
from repro_torch.kernels.bayes_fit import pad_ragged

FIT_TOL = dict(rtol=5e-3, atol=5e-4)
F32 = np.float32


def _moments(xs, ys, m):
    """The six float64 moments the kernel accumulates over a row:
    sum ys^2, m ys, m xs ys, m^2, m^2 xs, m^2 xs^2."""
    x, y, w = (np.asarray(a, np.float64) for a in (xs, ys, m))
    return ((y * y).sum(-1), (w * y).sum(-1), (w * x * y).sum(-1),
            (w * w).sum(-1), (w * w * x).sum(-1), (w * w * x * x).sum(-1))


def _moment_resid(mom, mu1, mu2):
    syy, smy, smxy, smm, smmx, smmxx = mom
    return (syy - 2.0 * (mu1 * smy + mu2 * smxy) + mu1 * mu1 * smm
            + 2.0 * mu1 * mu2 * smmx + mu2 * mu2 * smmxx)


def mirror_fit(x, y, m) -> dict:
    """The kernel's arithmetic in numpy: float32 means, then one pass over
    the centred row (dx = x - x_mu) for the variances, the sums of
    dx m, (dx m)^2, dy m, dx m dy m and the float64 moments of
    (m, dx m, dy m), all scaled by the reciprocal sds afterwards; then the
    closed-form float32 fixed point with one reciprocal of det and the
    residual from the moments."""
    x, y, m = (np.asarray(a, F32) for a in (x, y, m))
    sm = m.sum(-1, dtype=F32)
    n = np.maximum(sm, F32(1))
    x_mu = (x * m).sum(-1, dtype=F32) / n
    y_mu = (y * m).sum(-1, dtype=F32) / n
    dx, dy = x - x_mu[:, None], y - y_mu[:, None]
    x_sd = np.sqrt((dx * dx * m).sum(-1, dtype=F32) / n + F32(1e-9))
    y_sd = np.sqrt((dy * dy * m).sum(-1, dtype=F32) / n + F32(1e-9))
    rx, ry = F32(1) / x_sd, F32(1) / y_sd
    dxm, dym = dx * m, dy * m
    g11 = sm
    g12 = dxm.sum(-1, dtype=F32) * rx
    g22 = (dxm * dxm).sum(-1, dtype=F32) * rx * rx
    p1 = dym.sum(-1, dtype=F32) * ry
    p2 = (dxm * dym).sum(-1, dtype=F32) * rx * ry
    syy, smy, smxy, smm, smmx, smmxx = _moments(dxm, dym, m)
    rxd, ryd = rx.astype(np.float64), ry.astype(np.float64)
    mom = (syy * ryd * ryd, smy * ryd, smxy * rxd * ryd, smm, smmx * rxd,
           smmxx * rxd * rxd)

    def solve(alpha, beta):
        a11, a12, a22 = alpha + beta * g11, beta * g12, alpha + beta * g22
        rdet = F32(1) / np.maximum(a11 * a22 - a12 * a12, F32(1e-30))
        i11, i12, i22 = a22 * rdet, -a12 * rdet, a11 * rdet
        return (i11, i12, i22), (beta * (i11 * p1 + i12 * p2),
                                 beta * (i12 * p1 + i22 * p2))

    alpha = np.ones_like(n)
    beta = np.ones_like(n)
    for _ in range(30):
        _, (mu1, mu2) = solve(alpha, beta)
        b11, b12, b22 = beta * g11, beta * g12, beta * g22
        tr = b11 + b22
        disc = np.sqrt(np.maximum(tr * tr / F32(4) - (b11 * b22 - b12 * b12),
                                  F32(0)))
        l1, l2 = tr / F32(2) - disc, tr / F32(2) + disc
        gamma = l1 / (alpha + l1) + l2 / (alpha + l2)
        resid = _moment_resid(mom, mu1.astype(np.float64),
                              mu2.astype(np.float64)).astype(F32)
        alpha = gamma / np.maximum(mu1 * mu1 + mu2 * mu2, F32(1e-9))
        beta = np.maximum(n - gamma, F32(1e-9)) / np.maximum(resid, F32(1e-9))
        alpha = np.clip(alpha, F32(1e-6), F32(1e6))
        beta = np.clip(beta, F32(1e-6), F32(1e8))
    (i11, i12, i22), (mu1, mu2) = solve(alpha, beta)
    return {"mu": np.stack([mu1, mu2], -1),
            "sigma": np.stack([i11, i12, i12, i22], -1).reshape(-1, 2, 2),
            "alpha": alpha, "beta_prec": beta, "x_mu": x_mu, "x_sd": x_sd,
            "y_mu": y_mu, "y_sd": y_sd, "n": n}


def _buffers(t, seed, lo=3, hi=11, noise=0.05):
    """tests/test_torch_kernels.py's ragged buffers; `noise` is the
    standard deviation of the additive noise."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(0.1, 5.0, k) for k in rng.integers(lo, hi + 1, t)]
    ys = [rng.uniform(5, 50) + rng.uniform(1, 10) * x
          + rng.normal(0, noise, len(x)) for x in xs]
    return xs, ys


def _low_noise(t, seed):
    """3-8 point rows with 1e-3 relative noise: the residual is about 1e-6
    of sum ys^2, and beta_prec runs to 1e5-1e7."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(0.1, 5.0, k) for k in rng.integers(3, 9, t)]
    ys = [(rng.uniform(5, 50) + rng.uniform(1, 10) * x)
          * (1.0 + rng.normal(0, 1e-3, len(x))) for x in xs]
    return xs, ys


def _hold(x, y, m):
    """The mirror within FIT_TOL of the Pallas kernel and the plain fit."""
    got = mirror_fit(x, y, m)
    pallas = jkernels.bayes_fit_ragged(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(m), interpret=True)
    plain = fit_blr_batch(*(torch.from_numpy(a) for a in (x, y, m)))
    for leaf, g in got.items():
        assert np.isfinite(g).all(), leaf
        np.testing.assert_allclose(g, np.asarray(pallas[leaf]), **FIT_TOL,
                                   err_msg=f"{leaf} vs Pallas")
        np.testing.assert_allclose(g, plain[leaf].numpy(), **FIT_TOL,
                                   err_msg=f"{leaf} vs fit_blr_batch")
    return got


@pytest.mark.parametrize("seed", range(3))
def test_moment_residual_equals_column_residual(seed):
    rng = np.random.default_rng(seed)
    t, n = 64, 23
    xs, ys = rng.normal(size=(t, n)), rng.normal(size=(t, n))
    m = rng.uniform(0.0, 1.0, (t, n))              # fractional masks
    m[: t // 4] = (m[: t // 4] > 0.3)               # and 0/1 ones
    m[0] = 0.0                                      # a fully masked row
    xs, ys = xs * m, ys * m                         # as the kernel's xs, ys
    mu1, mu2 = rng.normal(size=t) * 3, rng.normal(size=t) * 3
    want = ((ys - (mu1[:, None] + mu2[:, None] * xs) * m) ** 2).sum(-1)
    got = _moment_resid(_moments(xs, ys, m), mu1, mu2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


# the shapes of test_torch_kernels.test_bayes_fit_plain_vs_pallas_and_ref
@pytest.mark.parametrize("t,hi", [(1, 5), (64, 10), (130, 10), (257, 40)])
def test_mirror_vs_pallas_and_plain(t, hi):
    _hold(*pad_ragged(*_buffers(t, seed=t, hi=hi)))


def test_mirror_on_low_noise_rows():
    x, y, m = pad_ragged(*_low_noise(300, seed=1))
    got = _hold(x, y, m)
    assert got["beta_prec"].max() > 1e5        # the regime this case is for


def test_mirror_on_one_point_and_masked_rows():
    """One-point rows and fully masked rows among 2-5 point rows: each
    fits a finite posterior, and a masked row the plain fit's default."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(0, 6, 120)
    lengths[:4] = (0, 1, 0, 1)
    xs = [rng.uniform(0.1, 5.0, k) for k in lengths]
    ys = [3.0 + 2.0 * v + rng.normal(0, 0.1, len(v)) for v in xs]
    x, y, m = pad_ragged(xs, ys)
    got = _hold(x, y, m)
    masked = lengths == 0
    np.testing.assert_array_equal(got["n"][masked], 1.0)
    np.testing.assert_array_equal(got["mu"][masked], 0.0)
