"""Pearson correlation gate (Section 4.5): |r| >= 0.75 -> linear model,
otherwise the task runtime is treated as input-independent (median).

Host-side numpy in float32, the same elementwise expressions as the
reference's array version, so the gate decides identically."""
from __future__ import annotations

from typing import Optional

import numpy as np

STRONG_CORRELATION = 0.75


def pearson(x, y, mask: Optional[np.ndarray] = None) -> np.float32:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    m = np.ones_like(x) if mask is None else np.asarray(mask, np.float32)
    n = np.maximum(m.sum(), np.float32(1.0))
    xm = (x * m).sum() / n
    ym = (y * m).sum() / n
    xc = (x - xm) * m
    yc = (y - ym) * m
    cov = (xc * yc).sum()
    vx = (xc * xc).sum()
    vy = (yc * yc).sum()
    return cov / np.sqrt(np.maximum(vx * vy, np.float32(1e-18)))


def strongly_correlated(x, y, mask=None,
                        threshold: float = STRONG_CORRELATION) -> np.bool_:
    return np.abs(pearson(x, y, mask)) >= threshold


def masked_median(v, mask: Optional[np.ndarray] = None):
    v = np.asarray(v)
    if mask is None:
        return np.median(v)
    mask = np.asarray(mask)
    big = np.where(mask > 0, v, np.inf)
    order = np.sort(big)
    n = int(mask.sum())
    lo = max((n - 1) // 2, 0)
    hi = n // 2
    return 0.5 * (order[lo] + order[hi])
