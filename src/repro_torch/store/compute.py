"""Batched posterior-predictive evaluation shared by every serving path.

`PredictionService.predict_batch` and `predict_matrix` must produce
bit-identical numbers for the same queries, so both call the functions
here: `predict_stacked` (one kernel launch over gathered posterior rows)
and `finalize` (factor rescaling + z-bands).  On either device the math is
the same float64 elementwise ops as the scalar `predict_blr_np` path, so
slicing a batch apart yields exactly what each caller would have computed
alone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops

# the posterior leaves the serving stack stores and gathers, with their
# per-row shapes ('n' is fit metadata, not needed by the predictive)
LEAVES = ("mu", "sigma", "beta_prec", "x_mu", "x_sd", "y_mu", "y_sd")
LEAF_SHAPES = {"mu": (2,), "sigma": (2, 2), "beta_prec": (), "x_mu": (),
               "x_sd": (), "y_mu": (), "y_sd": ()}


def predict_stacked(x: np.ndarray, post: dict, device=DEFAULT_DEVICE
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q,) inputs + per-query gathered leaves (Q, ...) -> (mean, std) in
    float64 numpy.  On "cuda" the rows go to the card and through the
    `bayes_predict` kernel; on "cpu" through its plain version.  Both are
    bit-exact against the scalar `predict_blr_np` path."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64)).to(dev)
    pt = {leaf: torch.as_tensor(np.ascontiguousarray(post[leaf],
                                                     np.float64)).to(dev)
          for leaf in LEAVES}
    mean, std = ops.bayes_predict(xt, pt)
    return mean.cpu().numpy(), std.cpu().numpy()


def fit_stacked(x: np.ndarray, y: np.ndarray, mask: np.ndarray,
                device=DEFAULT_DEVICE) -> dict:
    """(T, N) padded/masked observation buffers -> stacked posterior dict
    (float64 numpy leaves, incl. `alpha`/`n` fit metadata) from ONE batched
    MacKay evidence fixed-point launch: the `bayes_fit` kernel on "cuda"
    (ragged rows straight from `kernels.bayes_fit.pad_ragged`), its plain
    version on "cpu".  A fleet of task models re-fits in a single launch
    instead of one fixed-point solve per task."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(dev)
    post = ops.bayes_fit(t(x), t(y), t(mask))
    return {k: v.cpu().numpy().astype(np.float64) for k, v in post.items()}


def scale(mean: np.ndarray, std: np.ndarray, factors: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Extrapolation-factor rescaling (with the mean floor) shared by the
    flat path (`finalize`) and the decision plane's matrix path — one
    definition, so the two can never drift apart (broadcasts, so factors
    may be per-query (Q,) or a (T, N) matrix against (T, 1) predictions)."""
    f = np.asarray(factors, np.float64)
    return np.maximum(mean, 1e-3) * f, std * f


def cost_matrix(mean_s: np.ndarray, std_s: np.ndarray,
                z: Optional[float]) -> np.ndarray:
    """Quantile cost view over an already-scaled (T, N) mean/std pair:
    `mean + z * std` at the requested band, or the mean itself when no
    quantile is asked for.  Matches `plane.PredictionMatrix.costs`
    term-for-term (same expressions, no reassociation) so a resident
    plane serving this view schedules bitwise like the gather path."""
    if z is None:
        return np.array(mean_s, np.float64, copy=True)
    return mean_s + z * std_s


def finalize(mean: np.ndarray, std: np.ndarray, factors: np.ndarray,
             z: float) -> np.ndarray:
    """Apply extrapolation factors and credible bands -> (Q, 3) array of
    [mean, lower, upper] seconds."""
    mean, std = scale(mean, std, factors)
    lower = np.maximum(mean - z * std, 0.0)
    upper = mean + z * std
    return np.stack([mean, lower, upper], axis=1)
