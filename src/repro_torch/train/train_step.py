"""Train and serve step factories, the counterparts of the JAX package's
`train/train_step.py`.

The training state holds only the optimizer state (float32 master weights
and moments), as the reference's does; each step casts the master to the
compute dtype (`cast_params`) and takes gradients on that cast: a fresh
leaf that requires grad each step, bfloat16 for the weights the reference
casts and float32 for the ones it keeps (`_KEEP_FP32`), so the gradients
have the reference's dtypes.  Microbatched steps accumulate float32
gradients over `cfg.microbatches` splits of the batch, as the reference's
`lax.scan` does.  The reference constrains the gradients to the parameter
sharding (`_shard_like_params`); on one card that is a no-op and is left
out.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn, transformer
from repro_torch.models.layers import pdtype
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map)

Tree = Any

# weights deliberately kept fp32 (routers, gates, norms): never downcast
_KEEP_FP32 = {"scale", "router", "w_if", "w_slstm", "w_rec", "bias",
              "lru_lambda", "gate_a", "gate_x"}


def cast_params(master: Tree, dtype: torch.dtype, name: str = "") -> Tree:
    """The master cast to `dtype`, except the leaves named in _KEEP_FP32
    and leaves that are not float32, which stay as they are (the same
    tensors)."""
    if isinstance(master, dict):
        return {k: cast_params(v, dtype, str(k)) for k, v in master.items()}
    if name in _KEEP_FP32 or master.dtype != torch.float32:
        return master
    return master.to(dtype)


def init_train_state(seed: int, cfg: ModelConfig, oc: OptConfig,
                     device="cuda") -> dict:
    params = transformer.init_params(seed, cfg, device)
    return {"opt": init_opt_state(params, oc)}


def params_of(state: dict, cfg: ModelConfig) -> Tree:
    return cast_params(state["opt"]["master"], pdtype(cfg))


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """(B, ...) -> n microbatches of B / n rows: microbatch i holds rows
    i, n + i, 2n + i, ..., the reference's outer reshape factor.  M-RoPE
    `positions` (3, B, S) split on their batch axis, 1."""
    out = {}
    for k, x in batch.items():
        axis = 1 if k == "positions" else 0
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of {n} "
                             f"microbatches")
        shape = tuple(x.shape)
        out[k] = x.reshape(shape[:axis] + (b // n, n)
                           + shape[axis + 1:]).movedim(axis + 1, 0)
    return [{k: v[i] for k, v in out.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, oc: OptConfig):
    """-> train_step(state, batch) -> (new state, metrics): the loss and
    its float32 gradients on the compute-dtype cast of the master, then
    one AdamW update of the state (in place; see `adamw_update`).
    batch: {"tokens", "labels"} (B, S) int tensors on the state's device."""
    nmb = max(cfg.microbatches, 1)
    dtype = pdtype(cfg)

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        loss, met = loss_fn(params, cfg, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        return (loss.detach(), {k: v.detach() for k, v in met.items()},
                _like_sorted(params, grads))

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          cast_params(state["opt"]["master"], dtype))
        if nmb == 1:
            loss, met, grads = grads_of(params, batch)
        else:
            grads, loss = None, None
            for mb in _split_microbatches(batch, nmb):
                l, _, g = grads_of(params, mb)
                g = tree_map(lambda x: x.to(torch.float32), g)
                grads = g if grads is None else tree_map(
                    lambda a, b: a + b, grads, g)
                loss = l if loss is None else loss + l
            grads = tree_map(lambda g: g / nmb, grads)
            loss = loss / nmb
            met = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        del params
        _, new_opt, ometr = adamw_update(grads, state["opt"], oc)
        return {"opt": new_opt}, {"loss": loss, **met, **ometr}

    return train_step


def _like_sorted(tree: Tree, it) -> Tree:
    """A tree shaped as `tree` whose leaves are taken from `it` in the
    reference's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        got = {k: _like_sorted(tree[k], it) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    return next(it)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig):
    """-> prefill_step(params, batch) -> (last-position logits (B, V),
    cache).  Only the last position goes through the head: the same logits
    as the reference's forward()[:, -1], without the (B, S, V) tensor."""
    def prefill_step(params, batch):
        x, cache, _ = transformer.trunk(params, cfg, batch["tokens"],
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
