"""Batched posterior-predictive evaluation shared by every serving path.

`PredictionService.predict_batch` and `predict_matrix` must produce
bit-identical numbers for the same queries, so both call the functions
here: `predict_stacked` (one kernel launch over gathered posterior rows)
and `finalize` (factor rescaling + z-bands).  On either device the math is
the same float64 elementwise ops as the scalar `predict_blr_np` path, so
slicing a batch apart yields exactly what each caller would have computed
alone.  The write side's batched fold, `fold_stacked`, lives here too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bayes
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.bayes_fit import pack_predict
from repro_torch.kernels.staging import staged

# the posterior leaves the serving stack stores and gathers, with their
# per-row shapes ('n' is fit metadata, not needed by the predictive)
LEAVES = ("mu", "sigma", "beta_prec", "x_mu", "x_sd", "y_mu", "y_sd")
LEAF_SHAPES = {"mu": (2,), "sigma": (2, 2), "beta_prec": (), "x_mu": (),
               "x_sd": (), "y_mu": (), "y_sd": ()}


def predict_stacked(x: np.ndarray, post, device=DEFAULT_DEVICE
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q,) inputs + per-query posterior leaves (Q, ...) -> (mean, std) in
    float64 numpy.  The queries are packed into one slab (`pack_predict`,
    in pinned memory on a card; `post` is the leaves, or a callable that
    writes them into the slab, as `lambda out: snapshot.gather(keys, out)`
    does) and cross in one copy; on "cuda" they go through the
    `bayes_predict` kernel, on "cpu" through its plain version, and mean
    and std come back interleaved in one copy.  Both are bit-exact against
    the scalar `predict_blr_np` path."""
    batch = pack_predict(resolve_device(device), x, post)
    out = ops.bayes_predict(batch).cpu().numpy()
    return out[:, 0], out[:, 1]


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


def fold_stacked(nigs, xs, ys, device=DEFAULT_DEVICE):
    """Batched streaming-observation fold — the ingest-side sibling of
    `fit_stacked`: T NIG states + ragged per-task observation rows -> T
    updated states from ONE fold, routed by the device alone: the
    `nig_fold` kernel on "cuda" (`fold_kernel`), the float64 numpy fold
    (`core.bayes.nig_update_batch`) on "cpu".

    The reference keeps its fold off the device because its kernel is
    float32, and the ingest plane's contract — states bit-identical to the
    scalar `nig_update` chain, which feeds checkpoints and replay — holds
    only for a float64 fold.  This kernel is float64, evaluates the
    chain's expressions in the chain's order with FMA contraction off, and
    so is bitwise equal to it: here digest-bearing ingest may run on the
    card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return fold_kernel(nigs, xs, ys, dev)
    return bayes.nig_update_batch(nigs, xs, ys)


def fold_kernel(nigs, xs, ys, device=DEFAULT_DEVICE):
    """The fold as the card runs it: the rows packed once into one ragged
    slab (`core.bayes.fold_pack`, in pinned memory on a card) and copied up
    once, one `ops.nig_fold` on `device` (the kernel on "cuda", its plain
    version on "cpu"), the (T, 9) folded states copied down once, a and
    n_obs counted on the host, and rows with no observation passed through
    verbatim (`core.bayes.fold_unpack`).  Inputs are not mutated."""
    if bayes.check_rows(nigs, xs, ys) == 0:
        return [dict(n) for n in nigs]
    dev = resolve_device(device)
    with staged(dev) as st:
        _, counts, a, n_obs = bayes.fold_pack(nigs, xs, ys, alloc=st.host)
        slab = st.send()
    state = ops.nig_fold(slab, len(nigs)).cpu().numpy()
    a, n_obs = bayes.fold_counts(a, n_obs, counts)
    return bayes.fold_unpack(nigs, counts, state, a, n_obs)


def scale(mean, std, factors):
    """Extrapolation-factor rescaling (with the mean floor) shared by the
    flat path (`finalize`) and the decision plane's matrix path — one
    definition, so the two can never drift apart (broadcasts, so factors
    may be per-query (Q,) or a (T, N) matrix against (T, 1) predictions).
    Float64 numpy arrays, or float64 tensors on one device (the resident
    plane's rows): the same two elementwise ops either way, so the same
    bits."""
    if isinstance(mean, torch.Tensor):
        return torch.clamp_min(mean, 1e-3) * factors, std * factors
    f = np.asarray(factors, np.float64)
    return np.maximum(mean, 1e-3) * f, std * f


def cost_matrix(mean_s, std_s, z: Optional[float]):
    """Quantile cost view over an already-scaled (T, N) mean/std pair
    (numpy arrays or tensors): `mean + z * std` at the requested band, or
    a copy of the mean when no quantile is asked for.  Matches
    `plane.PredictionMatrix.costs` term-for-term (same expressions, no
    reassociation, and on a tensor two separate ops, which nothing
    contracts into an FMA) so a resident plane serving this view schedules
    bitwise like the gather path."""
    if z is None:
        if isinstance(mean_s, torch.Tensor):
            return mean_s.clone()
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
