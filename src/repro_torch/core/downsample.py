"""Input downsampling (Section 4.4 / 5.3).

The paper's rule: >= 3 partitions, accumulated size >= 10% of one input
file.  `partition_sizes` produces a geometric spread of partition sizes (a
diverse range improves the regression); `downsample_tokens` is the ML-fleet
analogue (slicing a token batch), and `LocalProfiler` in core.predictor
consumes either.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

MIN_PARTITIONS = 3
MIN_FRACTION = 0.10


def partition_sizes(input_gb: float, n: int = 5,
                    fraction: float = MIN_FRACTION) -> List[float]:
    """Geometric spread p_i with sum == fraction * input_gb, n >= 3."""
    n = max(n, MIN_PARTITIONS)
    fraction = max(fraction, MIN_FRACTION)
    weights = np.geomspace(1.0, 4.0, n)
    sizes = weights / weights.sum() * (fraction * input_gb)
    return [float(s) for s in sizes]


def validate_partitions(sizes: Sequence[float], input_gb: float) -> bool:
    return (len(sizes) >= MIN_PARTITIONS
            and sum(sizes) >= MIN_FRACTION * input_gb - 1e-9)


def downsample_tokens(tokens, n: int = 5, fraction: float = MIN_FRACTION):
    """ML analogue: slice a (B, S) token batch into >=3 smaller batches whose
    total token count is >= fraction of the original."""
    b, s = tokens.shape
    total = int(b * s * fraction)
    sizes = partition_sizes(float(b * s), n, fraction)
    out = []
    for sz in sizes:
        rows = max(1, min(b, int(round(sz / s))))
        out.append(tokens[:rows])
    return out
