"""Deterministic synthetic token pipeline with per-host sharding, a copy
of `make_batch` of the JAX package's `data/pipeline.py`: the same seed
gives the same tokens in both packages.

Sequences follow a Zipf-ish unigram mixture with injected n-gram structure
so small models show a real learning curve (loss decreases measurably within
~100 steps), while remaining fully deterministic given (seed, step, host).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 97 + cfg.host_id)


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """host-local shard of the global batch at `step`."""
    assert cfg.global_batch % cfg.num_hosts == 0
    b = cfg.global_batch // cfg.num_hosts
    rng = _batch_rng(cfg, step)
    v = cfg.vocab_size
    # zipf-ish unigram distribution
    ranks = np.arange(1, v + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(v, size=(b, cfg.seq_len + 1), p=probs)
    # inject learnable bigram structure: x[t+1] = (x[t]*7+3) % v on ~40% steps
    mask = rng.random((b, cfg.seq_len)) < 0.4
    nxt = (toks[:, :-1] * 7 + 3) % v
    toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
