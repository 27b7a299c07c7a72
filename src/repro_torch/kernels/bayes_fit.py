"""Launch wrappers for the hand-written CUDA kernels in `csrc/bayes.cu`:
the batched Bayesian-linear-regression fit (the paper's Section 4.5 model,
thousands of task models in one launch), the batched streaming fold of
observations into NIG states (the ingest hot path) and the batched
posterior predictive (the prediction service's hot path).

Each wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its outputs with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in a plain integer attribute
(`bayes_fit.launches`, `nig_fold.launches`, `bayes_predict.launches`) so
a run can show that a path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bayes")
    lib.lotaru_error_string.argtypes = [ctypes.c_int]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_bayes_predict.argtypes = [_P] * 10 + [ctypes.c_longlong, _P]
    lib.lotaru_bayes_predict.restype = ctypes.c_int
    lib.lotaru_bayes_fit.argtypes = ([_P] * 3 + [ctypes.c_int] * 2
                                     + [_P] * 9 + [_P])
    lib.lotaru_bayes_fit.restype = ctypes.c_int
    lib.lotaru_bayes_fit_config.argtypes = ([_P] * 3 + [ctypes.c_int] * 2
                                            + [_IP] * 5)
    lib.lotaru_bayes_fit_config.restype = ctypes.c_int
    lib.lotaru_nig_fold.argtypes = ([_P] * 3
                                    + [ctypes.c_longlong, ctypes.c_int]
                                    + [_P] * 8 + [_P])
    lib.lotaru_nig_fold.restype = ctypes.c_int
    return lib


def bayes_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
    """x, y, mask: (T, N) float32 CUDA tensors -> posterior dict matching
    core.bayes.fit_blr (leaves stacked over T).  Any T and N: the kernel
    takes one lane a task, guards the tail of T itself and stages rows
    longer than its shared-memory chunk a chunk at a time, so nothing is
    padded."""
    dev = cuda_device(x, "x")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, N), got shape {tuple(x.shape)}")
    t, n = x.shape
    for name, v in (("x", x), ("y", y), ("mask", mask)):
        check(v, name, torch.float32, (t, n), dev)
    out = {k: torch.empty(shape, dtype=torch.float32, device=dev)
           for k, shape in (("mu", (t, 2)), ("sigma", (t, 2, 2)),
                            ("alpha", (t,)), ("beta_prec", (t,)),
                            ("x_mu", (t,)), ("x_sd", (t,)), ("y_mu", (t,)),
                            ("y_sd", (t,)), ("n", (t,)))}
    if t == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_bayes_fit(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), t, n,
            *(out[k].data_ptr() for k in ("mu", "sigma", "alpha",
                                          "beta_prec", "x_mu", "x_sd",
                                          "y_mu", "y_sd", "n")),
            stream)
    raise_on(_lib(), rc, "bayes_fit")
    bayes_fit.launches += 1
    return out


bayes_fit.launches = 0


def fit_config(t: int, n: int, x: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> dict:
    """The fit kernel's launch shape at (T, N) on the current card, as
    `bayes_fit` launches it for these operands (default: operands aligned
    as torch allocates them): its route ("bulk": a tile's rows in one bulk
    copy an array, for N <= 64 and 16-byte aligned operands; "cp_async":
    4-byte copies from every lane, a 64-column chunk at a time), blocks in
    the grid, dynamic shared memory a block, blocks an SM and column
    chunks a row."""
    ptrs = [0 if a is None else a.data_ptr() for a in (x, y, mask)]
    vals = [ctypes.c_int(0) for _ in range(5)]
    rc = _lib().lotaru_bayes_fit_config(*ptrs, t, n,
                                        *(ctypes.byref(v) for v in vals))
    raise_on(_lib(), rc, "bayes_fit_config")
    route, *rest = (v.value for v in vals)
    return dict(route="bulk" if route else "cp_async",
                **dict(zip(("grid", "smem_bytes", "blocks_per_sm", "chunks"),
                           rest)))


def pad_ragged(xs, ys, min_cols: int = 2, col_bucket: int = 64):
    """Variable-length per-task observation buffers -> fixed-shape
    (T, N) float32 (x, y, mask) numpy arrays for one batched fit launch.

    Rows are right-padded to the longest buffer with mask=0 — the fit
    kernel's masked reductions make padded columns exact no-ops, so a
    (3-point, 200-point) pair costs one launch.  N is rounded up to a
    `col_bucket` multiple, as in the reference, so the buffers (and the
    posteriors fitted from them) are the same in both packages."""
    t = len(xs)
    n = max(min_cols, max((len(v) for v in xs), default=min_cols))
    if col_bucket > 1:
        n = -(-n // col_bucket) * col_bucket
    x = np.zeros((t, n), np.float32)
    y = np.zeros((t, n), np.float32)
    m = np.zeros((t, n), np.float32)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        k = len(xi)
        if k != len(yi):
            raise ValueError(f"row {i}: len(x)={k} != len(y)={len(yi)}")
        x[i, :k] = np.asarray(xi, np.float32)
        y[i, :k] = np.asarray(yi, np.float32)
        m[i, :k] = 1.0
    return x, y, m


# The TPU form padded the task dimension to a grid-block multiple; the CUDA
# kernel guards its ragged tail, so ragged buffers go straight to it.
bayes_fit_ragged = bayes_fit


def nig_fold(xs: torch.Tensor, ys: torch.Tensor, counts: torch.Tensor,
             mu: torch.Tensor, v: torch.Tensor, prec: torch.Tensor,
             b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Fold of (T, K) standardized observations into T NIG states, float64
    on the card: xs, ys (T, K), of which row i holds counts[i] observations
    (int32 (T,), clamped to [0, K]); mu (T, 2); v, prec (T, 2, 2); b (T,).
    Returns the folded (mu, v, prec, b), bitwise equal to
    core.bayes._nig_fold_np on the same values.  Any T and K: no padding
    rows or column buckets are added."""
    dev = cuda_device(xs, "xs")
    if xs.dim() != 2:
        raise ValueError(f"xs must be (T, K), got shape {tuple(xs.shape)}")
    t, k = xs.shape
    check(counts, "counts", torch.int32, (t,), dev)
    for name, a, shape in (("xs", xs, (t, k)), ("ys", ys, (t, k)),
                           ("mu", mu, (t, 2)), ("v", v, (t, 2, 2)),
                           ("prec", prec, (t, 2, 2)), ("b", b, (t,))):
        check(a, name, torch.float64, shape, dev)
    out = tuple(torch.empty_like(a) for a in (mu, v, prec, b))
    if t == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_nig_fold(
            xs.data_ptr(), ys.data_ptr(), counts.data_ptr(), t, k,
            mu.data_ptr(), v.data_ptr(), prec.data_ptr(), b.data_ptr(),
            *(o.data_ptr() for o in out), stream)
    raise_on(_lib(), rc, "nig_fold")
    nig_fold.launches += 1
    return out


nig_fold.launches = 0


_PREDICT_LEAVES = (("mu", (2,)), ("sigma", (2, 2)), ("beta_prec", ()),
                   ("x_mu", ()), ("x_sd", ()), ("y_mu", ()), ("y_sd", ()))


def bayes_predict(x: torch.Tensor, post: dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Q,) float64 CUDA tensor; post: posterior leaves gathered per
    query (Q, ...), float64 and contiguous on the same card.  Returns
    (mean, std), each (Q,) float64, bitwise equal to
    core.bayes.predict_blr_np on the same values."""
    dev = cuda_device(x, "x")
    if x.dim() != 1:
        raise ValueError(f"x must be (Q,), got shape {tuple(x.shape)}")
    q = x.shape[0]
    check(x, "x", torch.float64, (q,), dev)
    for leaf, shape in _PREDICT_LEAVES:
        check(post[leaf], leaf, torch.float64, (q,) + shape, dev)
    mean = torch.empty(q, dtype=torch.float64, device=dev)
    std = torch.empty(q, dtype=torch.float64, device=dev)
    if q == 0:
        return mean, std
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_bayes_predict(
            x.data_ptr(), *(post[leaf].data_ptr()
                            for leaf, _ in _PREDICT_LEAVES),
            mean.data_ptr(), std.data_ptr(), q, stream)
    raise_on(_lib(), rc, "bayes_predict")
    bayes_predict.launches += 1
    return mean, std


bayes_predict.launches = 0
