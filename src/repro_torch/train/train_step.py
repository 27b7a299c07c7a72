"""Serving step builders, the counterparts of `make_prefill_step` and
`make_decode_step` of the JAX package's `train/train_step.py`.  Training
(the optimizer, the train step) is not yet ported."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ModelConfig):
    """-> prefill_step(params, batch) -> (last-position logits (B, V),
    cache).  Only the last position goes through the head: the same logits
    as the reference's forward()[:, -1], without the (B, S, V) tensor."""
    def prefill_step(params, batch):
        x, cache = transformer.trunk(params, cfg, batch["tokens"],
                                     make_cache=True)
        return transformer.head(params, cfg, x[:, -1]), cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """-> serve_step(params, tokens (B, 1), cache, pos) -> (logits (B, V),
    new cache)."""
    def serve_step(params, tokens, cache, pos: int):
        logits, new_cache = transformer.decode_step(params, cfg, tokens,
                                                    cache, pos)
        return logits[:, -1], new_cache
    return serve_step
