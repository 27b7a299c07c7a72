"""Prediction baselines from Section 6.2.

  * Naive:    mean of per-tuple runtime/size ratios, scaled by target size.
  * Online-M: (da Silva et al. [26]) nearest training point by input size
              (stands in for the density cluster, which sparse local data
              cannot support — exactly the paper's adaptation), Pearson gate;
              correlated -> ratio prediction, uncorrelated -> MEAN runtime.
  * Online-P: (da Silva et al. [27]) like Online-M, but the uncorrelated
              case fits a Normal or Gamma distribution and samples from it.

All baselines are pure predictors: they never see the microbenchmarks, so on
heterogeneous targets they predict local-machine-scale runtimes (Section 7.2
shows exactly this failure mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.correlation import STRONG_CORRELATION


def _pearson_np(x: np.ndarray, y: np.ndarray) -> float:
    if len(x) < 2 or np.std(x) < 1e-12 or np.std(y) < 1e-12:
        return 0.0
    return float(np.corrcoef(x, y)[0, 1])


@dataclass
class NaivePredictor:
    ratio: float = 0.0

    def fit(self, sizes: Sequence[float], runtimes: Sequence[float]):
        s = np.asarray(sizes, np.float64)
        r = np.asarray(runtimes, np.float64)
        self.ratio = float(np.mean(r / np.maximum(s, 1e-12)))
        return self

    def predict(self, size: float) -> float:
        return self.ratio * size


@dataclass
class OnlineBase:
    sizes: Optional[np.ndarray] = None
    runtimes: Optional[np.ndarray] = None
    r: float = 0.0

    def fit(self, sizes: Sequence[float], runtimes: Sequence[float]):
        self.sizes = np.asarray(sizes, np.float64)
        self.runtimes = np.asarray(runtimes, np.float64)
        self.r = _pearson_np(self.sizes, self.runtimes)
        return self

    def _nearest_ratio(self, size: float) -> float:
        i = int(np.argmin(np.abs(self.sizes - size)))
        return self.runtimes[i] / max(self.sizes[i], 1e-12)

    def _uncorrelated(self, rng: np.random.Generator) -> float:
        raise NotImplementedError

    def predict(self, size: float, seed: int = 0) -> float:
        if abs(self.r) >= STRONG_CORRELATION:
            return self._nearest_ratio(size) * size
        return self._uncorrelated(np.random.default_rng(seed))


class OnlineM(OnlineBase):
    def _uncorrelated(self, rng) -> float:
        return float(np.mean(self.runtimes))


class OnlineP(OnlineBase):
    """Uncorrelated case: sample from a fitted Normal or Gamma distribution
    (Gamma via method-of-moments when the data is non-negative and skewed)."""

    def _uncorrelated(self, rng) -> float:
        mu = float(np.mean(self.runtimes))
        sd = float(np.std(self.runtimes))
        if sd < 1e-12:
            return mu
        skew = float(np.mean(((self.runtimes - mu) / sd) ** 3))
        if skew > 0.5 and mu > 0:
            shape = (mu / sd) ** 2
            scale = sd * sd / mu
            return float(rng.gamma(shape, scale))
        return float(rng.normal(mu, sd))
