"""Bayesian linear regression (the paper's Eq. 1-3) in PyTorch.

Model:  y_i = X beta + eps_i,  eps ~ N(0, 1/beta_prec),  beta ~ N(0, 1/alpha I)
(Gaussian prior == L2 regularization, exactly as Section 4.5 argues).

Hyper-parameters (alpha, beta_prec) are set by evidence (type-II maximum
likelihood) fixed-point iteration a la MacKay / sklearn's BayesianRidge —
appropriate for the tiny training sets local profiling yields (3-10 points).

The fit is float32 tensor code on whatever device its inputs live on: a
batch dimension written out (`fit_blr_batch`) with masks, so thousands of
task models fit in one call; `fit_blr` is the one-task view of it.  The
hand-written CUDA form of the batched fit is `kernels.bayes_fit.bayes_fit`.
The serving predictive is `predict_blr_np`, float64 host code that the
CUDA `bayes_predict` kernel matches bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

N_ITERS = 30
EPS = 1e-9


def fit_blr_batch(x: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor) -> dict:
    """Fit T task models.  x, y, mask: (T, N) tensors (mask 1.0 for valid
    points); computed in float32 on their device.

    Returns a dict of tensors with leading dim T:
      mu (T,2), sigma (T,2,2), alpha, beta_prec, x_mu, x_sd, y_mu, y_sd, n
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m = mask.to(torch.float32)
    n = torch.clamp_min(m.sum(-1), 1.0)

    # standardize over valid points (keeps the fixed-point iteration stable)
    x_mu = (x * m).sum(-1) / n
    y_mu = (y * m).sum(-1) / n
    x_sd = torch.sqrt(((x - x_mu[:, None]) ** 2 * m).sum(-1) / n + EPS)
    y_sd = torch.sqrt(((y - y_mu[:, None]) ** 2 * m).sum(-1) / n + EPS)
    xs = (x - x_mu[:, None]) / x_sd[:, None] * m
    ys = (y - y_mu[:, None]) / y_sd[:, None] * m

    phi = torch.stack([torch.ones_like(xs), xs], dim=-1) * m[..., None]
    phi_t = phi.transpose(-1, -2)                             # (T,2,N)
    gram = phi_t @ phi                                        # (T,2,2)
    phi_y = (phi_t @ ys[..., None])[..., 0]                   # (T,2)
    eye = torch.eye(2, dtype=torch.float32, device=x.device)

    def posterior(alpha, beta):
        sigma = torch.linalg.inv(alpha[:, None, None] * eye
                                 + beta[:, None, None] * gram)
        mu = ((beta[:, None, None] * sigma) @ phi_y[..., None])[..., 0]
        return sigma, mu

    alpha = torch.ones_like(n)
    beta = torch.ones_like(n)
    for _ in range(N_ITERS):
        sigma, mu = posterior(alpha, beta)
        # effective number of well-determined parameters
        lam = torch.linalg.eigvalsh(beta[:, None, None] * gram)
        gamma = (lam / (alpha[:, None] + lam)).sum(-1)
        resid = ((ys - (phi @ mu[..., None])[..., 0]) ** 2 * m).sum(-1)
        alpha = gamma / torch.clamp_min((mu * mu).sum(-1), EPS)
        beta = torch.clamp_min(n - gamma, EPS) / torch.clamp_min(resid, EPS)
        alpha = torch.clamp(alpha, 1e-6, 1e6)
        beta = torch.clamp(beta, 1e-6, 1e8)
    sigma, mu = posterior(alpha, beta)
    return {"mu": mu, "sigma": sigma, "alpha": alpha, "beta_prec": beta,
            "x_mu": x_mu, "x_sd": x_sd, "y_mu": y_mu, "y_sd": y_sd, "n": n}


def fit_blr(x: torch.Tensor, y: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> dict:
    """Fit one task model.  x, y: (N,) tensors (input size, runtime);
    mask: (N,) 1.0 for valid points.  Returns the posterior dict with
    scalar leaves: mu (2,), sigma (2,2), alpha, beta_prec, x_mu, x_sd,
    y_mu, y_sd, n."""
    m = torch.ones_like(x, dtype=torch.float32) if mask is None else mask
    post = fit_blr_batch(x[None], y[None], m[None])
    return {k: v[0] for k, v in post.items()}


def predict_blr(post: dict, x_new: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean and std (in original units) at x_new (...,), float32
    tensors from a one-task posterior of tensors."""
    xs = (x_new.to(torch.float32) - post["x_mu"]) / post["x_sd"]
    phi = torch.stack([torch.ones_like(xs), xs], dim=-1)
    mean_s = phi @ post["mu"]
    var_s = 1.0 / post["beta_prec"] + torch.einsum(
        "...i,ij,...j->...", phi, post["sigma"], phi)
    mean = mean_s * post["y_sd"] + post["y_mu"]
    std = torch.sqrt(torch.clamp_min(var_s, 0.0)) * post["y_sd"]
    return mean, std


def predict_blr_np(post: dict, x_new) -> Tuple[np.ndarray, np.ndarray]:
    """predict_blr in float64 numpy, vectorized over any leading dims shared
    by x_new and the posterior leaves (stacked posteriors: leaves (..., 2),
    (..., 2, 2), scalars (...)).

    The serving contract: because the scalar and batched paths are the
    *same* float64 elementwise ops, they agree bit-for-bit at any runtime
    magnitude (fp32 ulps at hour-scale runtimes exceed the service's 1e-4
    parity budget).  The CUDA `bayes_predict` kernel evaluates these terms
    in this order with FMA contraction off, and so matches it bitwise."""
    mu = np.asarray(post["mu"], np.float64)
    sig = np.asarray(post["sigma"], np.float64)
    x = np.asarray(x_new, np.float64)
    xs = (x - np.asarray(post["x_mu"], np.float64)) \
        / np.asarray(post["x_sd"], np.float64)
    y_mu = np.asarray(post["y_mu"], np.float64)
    y_sd = np.asarray(post["y_sd"], np.float64)
    mean_s = mu[..., 0] + mu[..., 1] * xs
    var_s = 1.0 / np.asarray(post["beta_prec"], np.float64) \
        + sig[..., 0, 0] + 2.0 * sig[..., 0, 1] * xs + sig[..., 1, 1] * xs * xs
    mean = mean_s * y_sd + y_mu
    std = np.sqrt(np.maximum(var_s, 0.0)) * y_sd
    return mean, std


def constant_posterior(mean: float, std: float) -> dict:
    """Degenerate posterior whose predictive is exactly (mean, std) at any
    input — lets median-fallback tasks ride the same batched predict path
    as the regression tasks (predict_blr of this dict returns (mean, std)).

    float64 leaves: the scalar path returns the median at full precision,
    so the batched path must carry it at full precision too (an fp32 ulp
    at hour-scale runtimes already exceeds the 1e-4 parity budget)."""
    return {"mu": np.zeros(2), "sigma": np.zeros((2, 2)),
            "alpha": np.float64(1.0), "beta_prec": np.float64(1.0),
            "x_mu": np.float64(0.0), "x_sd": np.float64(1.0),
            "y_mu": np.float64(mean), "y_sd": np.float64(max(std, 1e-6)),
            "n": np.float64(0.0)}
