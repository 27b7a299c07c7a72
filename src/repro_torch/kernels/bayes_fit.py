"""Launch wrappers for the hand-written CUDA kernels in `csrc/bayes.cu`:
the batched Bayesian-linear-regression fit (the paper's Section 4.5 model,
thousands of task models in one launch) and the batched posterior
predictive (the prediction service's hot path).

Each wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its outputs with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in a plain integer attribute
(`bayes_fit.launches`, `bayes_predict.launches`) so a run can show that a
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p


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
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = _lib().lotaru_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors; {name} is on "
                         f"{t.device} (kernels.ops picks the plain version "
                         f"for CPU tensors)")
    return t.device


def bayes_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
    """x, y, mask: (T, N) float32 CUDA tensors -> posterior dict matching
    core.bayes.fit_blr (leaves stacked over T).  Any T: the kernel takes
    one warp per task and guards the tail itself, so no padding rows are
    added."""
    dev = _cuda_device(x, "x")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, N), got shape {tuple(x.shape)}")
    t, n = x.shape
    for name, v in (("x", x), ("y", y), ("mask", mask)):
        _check(v, name, torch.float32, (t, n), dev)
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
    _raise_on(rc, "bayes_fit")
    bayes_fit.launches += 1
    return out


bayes_fit.launches = 0


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


_PREDICT_LEAVES = (("mu", (2,)), ("sigma", (2, 2)), ("beta_prec", ()),
                   ("x_mu", ()), ("x_sd", ()), ("y_mu", ()), ("y_sd", ()))


def bayes_predict(x: torch.Tensor, post: dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Q,) float64 CUDA tensor; post: posterior leaves gathered per
    query (Q, ...), float64 and contiguous on the same card.  Returns
    (mean, std), each (Q,) float64, bitwise equal to
    core.bayes.predict_blr_np on the same values."""
    dev = _cuda_device(x, "x")
    if x.dim() != 1:
        raise ValueError(f"x must be (Q,), got shape {tuple(x.shape)}")
    q = x.shape[0]
    _check(x, "x", torch.float64, (q,), dev)
    for leaf, shape in _PREDICT_LEAVES:
        _check(post[leaf], leaf, torch.float64, (q,) + shape, dev)
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
    _raise_on(rc, "bayes_predict")
    bayes_predict.launches += 1
    return mean, std


bayes_predict.launches = 0
