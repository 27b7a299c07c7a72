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

The streaming section below lifts a fit into a Normal-Inverse-Gamma state
and folds completions into it exactly.  Its host forms are here; the card's
form (`store.compute.fold_stacked` over the CUDA `nig_fold` kernel) packs
with `fold_pack` and unpacks with `fold_unpack`, float64 and bit for bit
the scalar `nig_update` chain.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

N_ITERS = 30
EPS = 1e-9
# cuSOLVER refuses a batched eigvalsh of 32,768 or more 2x2 matrices on an
# H100 (CUSOLVER_STATUS_INVALID_VALUE); fit_blr_batch takes it in slices
# of at most this many matrices, which each give what one call would
EIGVALSH_SLICE = 16384


def _eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """torch.linalg.eigvalsh over a (T, 2, 2) batch, EIGVALSH_SLICE
    matrices a call."""
    if a.shape[0] <= EIGVALSH_SLICE:
        return torch.linalg.eigvalsh(a)
    return torch.cat([torch.linalg.eigvalsh(a[i:i + EIGVALSH_SLICE])
                      for i in range(0, a.shape[0], EIGVALSH_SLICE)])


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
        lam = _eigvalsh(beta[:, None, None] * gram)
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


# ---------------------------------------------------------------------------
# streaming conjugate updates (the online-prediction subsystem)
# ---------------------------------------------------------------------------
# The MacKay fit above is a one-shot offline procedure.  For the online
# service a fitted posterior is lifted into a conjugate Normal-Inverse-Gamma
# state:  beta | s2 ~ N(mu, s2 V),  s2 ~ IG(a, b),  which admits EXACT
# rank-1 updates as task completions stream in — no refit, O(1) per event.
# The standardization stats are frozen at lift time (they only fix the
# affine coordinate system; the conjugate algebra is exact in it).
# All state is float64 numpy: thousands of sequential Sherman-Morrison
# updates stay exact to ~1e-12 where float32 would drift.

def nig_from_blr(post: dict) -> dict:
    """Lift a fitted BLR posterior into a streaming NIG state.

    Moment matching: the MacKay posterior has weight covariance `sigma` and
    noise precision `beta_prec`; we take E[s2] = b/a = 1/beta_prec with
    a = max(n/2, 1) pseudo-observations of noise, and V = sigma * beta_prec
    so that E[s2] * V equals the fitted weight covariance exactly."""
    sigma = np.asarray(post["sigma"], np.float64)
    beta = float(post["beta_prec"])
    a = max(float(post["n"]) / 2.0, 1.0)
    v = sigma * beta
    return {"mu": np.asarray(post["mu"], np.float64).copy(),
            "v": v, "prec": np.linalg.inv(v),
            "a": a, "b": a / beta,
            "x_mu": float(post["x_mu"]), "x_sd": float(post["x_sd"]),
            "y_mu": float(post["y_mu"]), "y_sd": float(post["y_sd"]),
            "n0": float(post["n"]), "n_obs": 0.0,
            # noise level the evidence fixed point chose at lift time; a
            # drift trigger compares the streaming estimate b/a against it
            # (OnlinePredictor.refresh_due)
            "s2_lift": 1.0 / beta}


def nig_update(nig: dict, x_new: float, y_new: float) -> dict:
    """Exact conjugate rank-1 update with one observation (original units).

    Sherman-Morrison keeps V = prec^-1 without re-inversion:
        prec' = prec + phi phi^T
        V'    = V - (V phi)(V phi)^T / (1 + phi^T V phi)
        mu'   = V' (prec mu + phi y)
        a'    = a + 1/2
        b'    = b + (y^2 + mu^T prec mu - mu'^T prec' mu') / 2

    All 2x2 algebra is unrolled to explicit component arithmetic — the
    SAME expressions `_nig_fold_np`, `kernels.ref.nig_fold_ref` and the
    CUDA `nig_fold` kernel evaluate — so the scalar chain and every batched
    fold perform identical float64 IEEE op sequences per task and agree
    bit for bit.
    """
    xs = (float(x_new) - nig["x_mu"]) / nig["x_sd"]
    ys = (float(y_new) - nig["y_mu"]) / nig["y_sd"]
    prec, v, mu = nig["prec"], nig["v"], nig["mu"]
    mu1, mu2 = mu[0], mu[1]
    v11, v12, v22 = v[0, 0], v[0, 1], v[1, 1]
    p11, p12, p22 = prec[0, 0], prec[0, 1], prec[1, 1]

    (nmu1, nmu2, nv11, nv12, nv22, np11, np12, np22, nb) = _nig_step(
        mu1, mu2, v11, v12, v22, p11, p12, p22, nig["b"], xs, ys)

    out = dict(nig)
    out.update(mu=np.array([nmu1, nmu2], np.float64),
               v=np.array([[nv11, nv12], [nv12, nv22]], np.float64),
               prec=np.array([[np11, np12], [np12, np22]], np.float64),
               a=nig["a"] + 0.5, b=nb if nb > 1e-12 else 1e-12,
               n_obs=nig["n_obs"] + 1.0)
    return out


def _nig_step(mu1, mu2, v11, v12, v22, p11, p12, p22, b, xs, ys):
    """One Sherman-Morrison rank-1 NIG update in explicit 2x2 component
    form, on standardized (xs, ys).  Polymorphic over scalars, (T,)
    float64 numpy vectors and float64 tensors: each operation is one
    correctly rounded IEEE add, multiply or divide per element, so
    evaluating these expressions lane-wise over T tasks is bit-identical
    to evaluating them one task at a time — the property
    `nig_update_batch` is built on."""
    # vp = V phi with phi = (1, xs);  denom = 1 + phi^T V phi
    vp1 = v11 + v12 * xs
    vp2 = v12 + v22 * xs
    denom = 1.0 + (vp1 + xs * vp2)
    nv11 = v11 - vp1 * vp1 / denom
    nv12 = v12 - vp1 * vp2 / denom
    nv22 = v22 - vp2 * vp2 / denom
    np11 = p11 + 1.0
    np12 = p12 + xs
    np22 = p22 + xs * xs
    r1 = (p11 * mu1 + p12 * mu2) + ys            # prec mu + phi y
    r2 = (p12 * mu1 + p22 * mu2) + xs * ys
    nmu1 = nv11 * r1 + nv12 * r2
    nmu2 = nv12 * r1 + nv22 * r2
    qo = (mu1 * p11 + mu2 * p12) * mu1 + (mu1 * p12 + mu2 * p22) * mu2
    qn = (nmu1 * np11 + nmu2 * np12) * nmu1 \
        + (nmu1 * np12 + nmu2 * np22) * nmu2
    # callers floor nb at 1e-12 (np.maximum for vectors, a branch for
    # scalars — identical values on finite inputs)
    nb = b + 0.5 * (ys * ys + qo - qn)
    return nmu1, nmu2, nv11, nv12, nv22, np11, np12, np22, nb


# The fold's packed operands (`fold_pack`), one float64 slab: its head
# holds the T + 1 row offsets (int64, in slots from the slab's start),
# padded to an even count; row i, at offsets[i], holds a FOLD_HEAD-slot
# header (its count, mu[0], mu[1], V at [0,0], [0,1], [1,1], prec at the
# same three, b) and then its count standardized (x, y) pairs.  Every row
# is an even number of slots, so each starts on a 16-byte boundary.  The
# folded states come back as one (T, FOLD_STATE) slab: the header's
# state, folded.
FOLD_HEAD = 10
FOLD_STATE = 9


def fold_head(t: int) -> int:
    """Slots of a T-row fold slab's offset head (T + 1, made even)."""
    return (t + 2) & ~1


def _nig_fold_np(slab: np.ndarray, t: int) -> np.ndarray:
    """Vectorized fold of a T-row ragged slab (`fold_pack`) -> the
    (T, FOLD_STATE) folded states, one step per observation column over
    every row that still has one.

    Bit-identical to chaining `nig_update` per task: both evaluate the
    SAME `_nig_step` component expressions, and numpy float64 elementwise
    ufuncs are IEEE-deterministic per lane.  Lanes past their count keep
    their old state via `where` selection."""
    off = slab[:t + 1].view(np.int64)
    start = off[:-1]
    hdr = slab[start[:, None] + np.arange(FOLD_HEAD)]
    counts = np.minimum(hdr[:, 0], (off[1:] - start - FOLD_HEAD) // 2)
    mu1, mu2, v11, v12, v22, p11, p12, p22, b = hdr[:, 1:].T
    for k in range(int(counts.max(initial=0))):
        mk = counts > k
        at = np.where(mk, start + FOLD_HEAD + 2 * k, start)
        xk = np.where(mk, slab[at], 0.0)
        yk = np.where(mk, slab[at + 1], 0.0)
        (nmu1, nmu2, nv11, nv12, nv22, np11, np12, np22, nb) = _nig_step(
            mu1, mu2, v11, v12, v22, p11, p12, p22, b, xk, yk)
        nb = np.maximum(nb, 1e-12)
        mu1 = np.where(mk, nmu1, mu1)
        mu2 = np.where(mk, nmu2, mu2)
        v11 = np.where(mk, nv11, v11)
        v12 = np.where(mk, nv12, v12)
        v22 = np.where(mk, nv22, v22)
        p11 = np.where(mk, np11, p11)
        p12 = np.where(mk, np12, p12)
        p22 = np.where(mk, np22, p22)
        b = np.where(mk, nb, b)
    return np.stack([mu1, mu2, v11, v12, v22, p11, p12, p22, b], axis=1)


def fold_counts(a, n_obs, counts):
    """a and n_obs after a fold of counts[i] observations into row i, one
    masked +0.5 / +1.0 per observation column as the vectorized fold adds
    them (the kernel leaves both on the host)."""
    for k in range(int(np.max(counts, initial=0))):
        mk = counts > k
        a = np.where(mk, a + 0.5, a)
        n_obs = np.where(mk, n_obs + 1.0, n_obs)
    return a, n_obs


_FOLD_VEC_MIN_TASKS = 64
"""Below this many tasks the vectorized fold's numpy per-op dispatch
overhead loses to per-task python-float chains; both are the identical
IEEE op sequence, so the size dispatch is invisible to the results."""


def _nig_chain_py(nig: dict, xrow, yrow) -> dict:
    """Per-task scalar chain on python floats: the same `_nig_step`
    component expressions `nig_update` evaluates (python float and numpy
    float64 scalar arithmetic share the hardware double ops, so results
    are bit-identical), minus numpy's per-op scalar dispatch — the fast
    form for narrow folds."""
    if not len(xrow):
        return dict(nig)
    x_mu, x_sd = float(nig["x_mu"]), float(nig["x_sd"])
    y_mu, y_sd = float(nig["y_mu"]), float(nig["y_sd"])
    mu, v, prec = nig["mu"], nig["v"], nig["prec"]
    mu1, mu2 = float(mu[0]), float(mu[1])
    v11, v12, v22 = float(v[0, 0]), float(v[0, 1]), float(v[1, 1])
    p11, p12, p22 = float(prec[0, 0]), float(prec[0, 1]), float(prec[1, 1])
    b = float(nig["b"])
    for x, y in zip(xrow, yrow):
        sx = (float(x) - x_mu) / x_sd
        sy = (float(y) - y_mu) / y_sd
        (mu1, mu2, v11, v12, v22, p11, p12, p22, b) = _nig_step(
            mu1, mu2, v11, v12, v22, p11, p12, p22, b, sx, sy)
        b = b if b > 1e-12 else 1e-12
    k = len(xrow)
    out = dict(nig)
    out.update(mu=np.array([mu1, mu2], np.float64),
               v=np.array([[v11, v12], [v12, v22]], np.float64),
               prec=np.array([[p11, p12], [p12, p22]], np.float64),
               a=nig["a"] + 0.5 * k, b=b,
               n_obs=nig["n_obs"] + float(k))
    return out


def nig_update_batch(nigs, xs, ys, impl: str = "numpy"):
    """Fold grouped observations into many streaming NIG states in ONE
    call: `nigs` is a list of T states, `xs[i]`/`ys[i]` the (ragged)
    observation sequence for state i, in arrival order.  Returns T updated
    states; the inputs are not mutated.

    Every form is bit-identical to `[chain of nig_update]` per task (the
    scalar chain is the exactness oracle):
      'chain'  per-task python-float chains (fastest at small T);
      'vec'    the masked (T, K) numpy fold `_nig_fold_np`;
      'numpy'  (default) 'chain' below `_FOLD_VEC_MIN_TASKS` tasks, else
               'vec'.
    The reference's JAX forms ('scan', 'pallas', 'interpret') are not
    carried over; the card's form is `store.compute.fold_stacked`.
    """
    kmax = check_rows(nigs, xs, ys)
    if kmax == 0:
        return [dict(n) for n in nigs]
    if impl == "numpy":
        impl = "chain" if len(nigs) < _FOLD_VEC_MIN_TASKS else "vec"
    if impl == "chain":
        return [_nig_chain_py(n, xr, yr)
                for n, xr, yr in zip(nigs, xs, ys)]
    if impl != "vec":
        raise ValueError(f"unknown impl {impl!r}")
    slab, counts, a, n_obs = fold_pack(nigs, xs, ys)
    state = _nig_fold_np(slab, len(nigs))
    a, n_obs = fold_counts(a, n_obs, counts)
    return fold_unpack(nigs, counts, state, a, n_obs)


def check_rows(nigs, xs, ys) -> int:
    """Validate one observation row per state, each with as many x as y;
    returns the longest row's length."""
    if len(xs) != len(nigs) or len(ys) != len(nigs):
        raise ValueError(f"need one observation row per state: "
                         f"{len(nigs)} states, {len(xs)}/{len(ys)} rows")
    kmax = 0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        if len(xi) != len(yi):
            raise ValueError(f"row {i}: len(x)={len(xi)} != len(y)={len(yi)}")
        kmax = max(kmax, len(xi))
    return kmax


def fold_pack(nigs, xs, ys, alloc=None):
    """T states and their ragged observation rows -> (slab, counts, a,
    n_obs): the fold's one float64 slab (layout above FOLD_HEAD; written
    into `alloc(n)`, n float64 slots, when given, else a new array), the
    int64 per-row counts and the stacked a and n_obs, which stay on the
    host.  Built with array operations over the chained rows: each
    observation standardized as the scalar update does, (x - x_mu) / x_sd
    and (y - y_mu) / y_sd, two IEEE operations.  V and prec are read at
    [0, 0], [0, 1] and [1, 1] whatever their layout (a state lifted from a
    fit on the card holds a column-major sigma)."""
    t = len(nigs)
    counts = np.fromiter(map(len, xs), np.int64, t)
    if not np.array_equal(counts, np.fromiter(map(len, ys), np.int64, t)):
        raise ValueError("every row needs as many y as x")
    total = int(counts.sum())
    x = np.fromiter(itertools.chain.from_iterable(xs), np.float64, total)
    y = np.fromiter(itertools.chain.from_iterable(ys), np.float64, total)
    stats = np.array([(n["x_mu"], n["x_sd"], n["y_mu"], n["y_sd"], n["a"],
                       n["b"], n["n_obs"]) for n in nigs],
                     np.float64).reshape(t, 7)
    row = np.repeat(np.arange(t), counts)
    sx = (x - stats[row, 0]) / stats[row, 1]
    sy = (y - stats[row, 2]) / stats[row, 3]
    stack = lambda leaf, k: np.array([n[leaf] for n in nigs],
                                     np.float64).reshape(t, k)
    mu, v, prec = stack("mu", 2), stack("v", 4), stack("prec", 4)
    a, b, n_obs = stats[:, 4], stats[:, 5], stats[:, 6]

    head = fold_head(t)
    off = np.empty(t + 1, np.int64)
    off[0] = head
    np.cumsum(FOLD_HEAD + 2 * counts, out=off[1:])
    off[1:] += head
    slab = (np.empty if alloc is None else alloc)(int(off[-1]))
    slab[:head] = 0.0
    slab[:t + 1].view(np.int64)[:] = off
    start = off[:-1]
    hdr = np.column_stack((counts, mu, v[:, [0, 1, 3]], prec[:, [0, 1, 3]],
                           b))
    slab[start[:, None] + np.arange(FOLD_HEAD)] = hdr
    first = np.cumsum(counts) - counts        # each row's first observation
    at = np.repeat(start + FOLD_HEAD, counts) \
        + 2 * (np.arange(total) - np.repeat(first, counts))
    slab[at] = sx
    slab[at + 1] = sy
    return slab, counts, a, n_obs


def fold_leaves(state: np.ndarray):
    """A (T, FOLD_STATE) state slab -> (mu (T, 2), v (T, 2, 2), prec (T, 2,
    2), b (T,)), v and prec symmetric."""
    sym = lambda c: state[:, [c, c + 1, c + 1, c + 2]].reshape(-1, 2, 2)
    return state[:, 0:2], sym(2), sym(5), state[:, 8]


def fold_unpack(nigs, counts, state, a, n_obs):
    """The folded (T, FOLD_STATE) states and a, n_obs -> T state dicts.
    Rows with no observations pass through VERBATIM: restacking them would
    symmetrize v/prec ([1,0] := [0,1]) and a fitted input matrix can be
    asymmetric in the last ulp — the scalar chain (zero updates) leaves
    those bytes untouched."""
    mu, v, prec, b = fold_leaves(state)
    out = []
    for nig, k, *row in zip(nigs, counts, mu, v, prec, a, b, n_obs):
        o = dict(nig)
        if k:
            o.update(zip(("mu", "v", "prec", "a", "b", "n_obs"), row))
        out.append(o)
    return out


def nig_refit(nig0: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """Batch posterior from the prior state `nig0` and ALL observations at
    once (closed form).  Mathematically identical to folding the points in
    one at a time with `nig_update`."""
    xs = (np.asarray(x, np.float64) - nig0["x_mu"]) / nig0["x_sd"]
    ys = (np.asarray(y, np.float64) - nig0["y_mu"]) / nig0["y_sd"]
    phi = np.stack([np.ones_like(xs), xs], axis=-1)          # (N, 2)
    prec0, mu0 = nig0["prec"], nig0["mu"]
    prec_n = prec0 + phi.T @ phi
    v_n = np.linalg.inv(prec_n)
    mu_n = v_n @ (prec0 @ mu0 + phi.T @ ys)
    b_n = nig0["b"] + 0.5 * (ys @ ys + mu0 @ prec0 @ mu0
                             - mu_n @ prec_n @ mu_n)
    out = dict(nig0)
    out.update(mu=mu_n, v=v_n, prec=prec_n,
               a=nig0["a"] + 0.5 * len(xs), b=max(b_n, 1e-12),
               n_obs=nig0["n_obs"] + float(len(xs)))
    return out


def refresh_fit(fit_x, fit_y, buf_x, buf_y, device) -> dict:
    """Periodic evidence refresh: re-run the MacKay fixed point over the
    fit-time profiling points plus every streamed observation retained in
    the buffer, in one `fit_blr` on `device`.

    Streaming NIG updates are exact *given* the hyperparameters frozen at
    lift time; this refit re-chooses both the (alpha, beta) evidence lift
    and the standardization from everything observed.  Either side may be
    empty (a promoted median-fallback task has no fit-time regression
    data), but not both.  Returns a predict_blr/nig_from_blr-compatible
    posterior of float32 numpy leaves."""
    x = np.concatenate([np.asarray(fit_x, np.float64).ravel(),
                        np.asarray(buf_x, np.float64).ravel()])
    y = np.concatenate([np.asarray(fit_y, np.float64).ravel(),
                        np.asarray(buf_y, np.float64).ravel()])
    if x.size == 0:
        raise ValueError("refresh_fit needs at least one observation")
    post = fit_blr(torch.from_numpy(x.astype(np.float32)).to(device),
                   torch.from_numpy(y.astype(np.float32)).to(device))
    return {k: v.cpu().numpy() for k, v in post.items()}


def nig_to_blr(nig: dict) -> dict:
    """Export a streaming state back to the predict_blr posterior format.

    The Student-t predictive scale^2 = (b/a) (1 + phi V phi) maps onto the
    Gaussian form 1/beta_prec + phi sigma phi with beta_prec = a/b and
    sigma = (b/a) V, so downstream (batched) predict code is unchanged."""
    s2 = nig["b"] / nig["a"]
    return {"mu": nig["mu"].astype(np.float32),
            "sigma": (s2 * nig["v"]).astype(np.float32),
            "alpha": np.float32(1.0),
            "beta_prec": np.float32(1.0 / s2),
            "x_mu": np.float32(nig["x_mu"]), "x_sd": np.float32(nig["x_sd"]),
            "y_mu": np.float32(nig["y_mu"]), "y_sd": np.float32(nig["y_sd"]),
            "n": np.float32(nig["n0"] + nig["n_obs"])}
