"""Carry state across packages and devices: a fitted `LotaruPredictor`,
and the LM side's parameters (`lm_params_from_jax`).

The state is plain Python and numpy, so it names no framework:

    {"variant": "G" | "A" | "W",
     "threshold": float,
     "local_bench": {"name", "cpu", "mem", "io_read", "io_write"} or None,
     "app_bench": {task: {node_or_"local": benchmark runtime}},
     "models": {task: {"correlated": bool,
                       "posterior": {leaf: ndarray} or None,
                       "median_s", "spread_s", "cpu_fraction": float,
                       "fit_x", "fit_y": ndarray or None}}}

`predictor_state` reads it off any predictor with the reference's
fitted-state attributes (the JAX package's `LotaruPredictor` has them, and
so does this package's); `predictor_from_state` builds an equivalent
predictor of this package on the given device.  Posterior leaves keep
their dtype, so a carried predictor serves bit for bit what the source
served.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.predictor import LotaruPredictor, TaskRuntimeModel
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.transformer import init_params

_BENCH_FIELDS = ("name", "cpu", "mem", "io_read", "io_write")


def _array(v) -> Optional[np.ndarray]:
    return None if v is None else np.array(v)


def predictor_state(pred) -> dict:
    """The fitted state of `pred` as plain Python and numpy (see module
    docstring)."""
    lb = pred.local_bench
    return {
        "variant": pred.variant,
        "threshold": float(pred.threshold),
        "local_bench": (None if lb is None
                        else {f: getattr(lb, f) for f in _BENCH_FIELDS}),
        "app_bench": {t: dict(b) for t, b in pred.app_bench.items()},
        "models": {
            task: {"correlated": bool(m.correlated),
                   "posterior": (None if m.posterior is None else
                                 {k: np.array(v)
                                  for k, v in m.posterior.items()}),
                   "median_s": float(m.median_s),
                   "spread_s": float(m.spread_s),
                   "cpu_fraction": float(m.cpu_fraction),
                   "fit_x": _array(m.fit_x),
                   "fit_y": _array(m.fit_y)}
            for task, m in pred.models.items()},
    }


def predictor_from_state(state: Mapping, device=DEFAULT_DEVICE
                         ) -> LotaruPredictor:
    """A fitted `LotaruPredictor` on `device` holding exactly `state`."""
    lb = state.get("local_bench")
    pred = LotaruPredictor(
        state["variant"],
        local_bench=None if lb is None else MachineBench(
            **{f: lb[f] for f in _BENCH_FIELDS}),
        app_bench=state.get("app_bench"),
        threshold=float(state["threshold"]),
        device=device)
    for task, m in state["models"].items():
        post = m["posterior"]
        pred.models[task] = TaskRuntimeModel(
            task=task, correlated=bool(m["correlated"]),
            posterior=(None if post is None
                       else {k: np.array(v) for k, v in post.items()}),
            median_s=float(m["median_s"]), spread_s=float(m["spread_s"]),
            cpu_fraction=float(m["cpu_fraction"]),
            fit_x=_array(m["fit_x"]), fit_y=_array(m["fit_y"]))
    pred.version += 1                 # fitted: bindings sync on first use
    return pred


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":          # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _carry(src, want, device: torch.device, path: str):
    if isinstance(want, torch.Tensor):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{tuple(want.shape)}")
        t = _tensor(arr)
        if t.dtype != want.dtype:
            raise TypeError(f"{path}: dtype {t.dtype}, want {want.dtype}")
        return t.to(device)
    if not isinstance(src, Mapping) or set(src) != set(want):
        got = sorted(src) if isinstance(src, Mapping) else type(src).__name__
        raise ValueError(f"{path}: keys {got}, want {sorted(want)}")
    return {k: _carry(src[k], want[k], device, f"{path}/{k}") for k in want}


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig,
                       device=DEFAULT_DEVICE) -> dict:
    """The JAX package's `init_params(key, cfg)` pytree, its leaves as
    numpy arrays (the stacked `cycles` leaves and the `tail` blocks), ->
    the port's parameters on `device`, leaf for leaf: the same keys,
    shapes and dtypes, checked against the port's own layout."""
    return _carry(tree, init_params(0, cfg, device="meta"),
                  resolve_device(device), "params")
