"""Model assembly: block dispatch, the layer loop, train/prefill forward,
the loss and decode, the counterpart of the JAX package's `models/transformer.py` for
the block kinds the port runs (full and local attention, RG-LRU).

Layer plan, as in the reference: `n_cycles` copies of `block_pattern`
whose parameters are stacked on a leading cycle axis, then a tail
remainder (RecurrentGemma's 38 = 12 * (r, r, l) + (r, r)); the
reference's dense prefix layers (DeepSeek's) are not ported.  The
reference scans over the stacked cycles; here a Python loop indexes them.
Parameters are plain nested dicts of tensors with the reference's keys
and shapes, so `repro_torch.convert` carries its weights across leaf for
leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import (
    ATTENTION_KINDS, ATTN_FULL, ATTN_LOCAL, ATTN_SWA, BLK_RGLRU, ModelConfig,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_init, ffn_apply, ffn_init, pdtype,
    rmsnorm, rmsnorm_init, softcap,
)

PORTED_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL, BLK_RGLRU)


def _check(cfg: ModelConfig) -> None:
    other = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if other:
        raise NotImplementedError(f"block kinds {other} of {cfg.name} are "
                                  f"not yet ported to repro_torch")
    if cfg.is_moe or cfg.first_dense_layers or cfg.cross_attn \
            or cfg.mrope_sections or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: MoE, dense prefix layers, "
                                  f"cross-attention, M-RoPE and frontends "
                                  f"are not yet ported to repro_torch")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------
def layer_plan(cfg: ModelConfig):
    kinds = cfg.layer_kinds()
    n_prefix = cfg.first_dense_layers
    prefix = kinds[:n_prefix]
    rest = kinds[n_prefix:]
    plen = len(cfg.block_pattern)
    n_cycles = len(rest) // plen
    tail = rest[n_cycles * plen:]
    return prefix, cfg.block_pattern, n_cycles, tail


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return cfg.ffn_kind != "none" and (kind in ATTENTION_KINDS
                                       or kind == BLK_RGLRU)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def block_init(gen, cfg: ModelConfig, kind: str, device="cpu") -> dict:
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        p["attn"] = attn.attn_init(gen, cfg, device)
    elif kind == BLK_RGLRU:
        p["mix"] = rglru_mod.rglru_init(gen, cfg, device)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    if _has_ffn(cfg, kind):
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["ffn"] = ffn_init(gen, cfg, cfg.d_ff, device)
    return p


def block_apply_seq(p: dict, cfg: ModelConfig, kind: str, x, positions,
                    make_cache: bool):
    """Full-sequence block.  Returns (x, cache)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        mix, c = attn.attn_apply_seq(p["attn"], cfg, kind, h, positions,
                                     make_cache)
    elif kind == BLK_RGLRU:
        mix, c = rglru_mod.rglru_apply_seq(p["mix"], cfg, h, make_cache)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    x = x + mix
    if "ffn" in p:
        x = x + ffn_apply(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, c or {}


def block_decode(p: dict, cfg: ModelConfig, kind: str, x, cache, pos: int):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        mix, c = attn.attn_decode(p["attn"], cfg, kind, h, cache, pos)
    elif kind == BLK_RGLRU:
        mix, c = rglru_mod.rglru_decode(p["mix"], cfg, h, cache, pos)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    x = x + mix
    if "ffn" in p:
        x = x + ffn_apply(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, c


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _stack_blocks(blocks):
    """Per-cycle block dicts -> one dict of leaves stacked on axis 0."""
    first = blocks[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(blocks)
    return {k: _stack_blocks([b[k] for b in blocks]) for k in first}


def _cycle(tree, c: int):
    """Cycle c's view of stacked parameters or caches."""
    if isinstance(tree, torch.Tensor):
        return tree[c]
    return {k: _cycle(v, c) for k, v in tree.items()}


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _stacked_cycles(gen, cfg: ModelConfig, pattern, n_cycles: int, device):
    """The cycles' parameters with a leading (n_cycles,) axis, made one
    cycle at a time into preallocated leaves, so that making them never
    holds more than one extra cycle."""
    def one():
        return {f"b{i}": block_init(gen, cfg, kind, device)
                for i, kind in enumerate(pattern)}

    def alloc(leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.empty((n_cycles,) + tuple(leaf.shape),
                               dtype=leaf.dtype, device=leaf.device)
        return {k: alloc(v) for k, v in leaf.items()}

    def fill(dst, src, c):
        if isinstance(src, torch.Tensor):
            dst[c].copy_(src)
            return
        for k in src:
            fill(dst[k], src[k], c)

    first = one()
    out = alloc(first)
    if _is_meta(device):
        return out
    fill(out, first, 0)
    del first
    for c in range(1, n_cycles):
        fill(out, one(), c)
    return out


def init_params(seed: int, cfg: ModelConfig, device=DEFAULT_DEVICE) -> dict:
    """The model's weights, made on `device` from a `torch.Generator`
    seeded by `seed`, at the reference's shapes, dtypes and scales.  On
    `torch.device("meta")` only the shapes are made (no generator, no
    memory)."""
    _check(cfg)
    meta = _is_meta(device)
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    _, pattern, n_cycles, tail = layer_plan(cfg)
    dt = pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                    device=dev)
    if n_cycles:
        params["cycles"] = _stacked_cycles(gen, cfg, pattern, n_cycles, dev)
    if tail:
        params["tail"] = {str(i): block_init(gen, cfg, kind, dev)
                          for i, kind in enumerate(tail)}
    return params


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in tree.values():
        yield from _leaves(v)


def param_count_exact(cfg: ModelConfig) -> int:
    """Parameters of `init_params`, counted from shapes alone."""
    return sum(math.prod(t.shape)
               for t in _leaves(init_params(0, cfg, device="meta")))


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def head(params, cfg: ModelConfig, x):
    """Final norm, the (tied) unembedding and the soft-cap: x (..., d) ->
    float32 logits (..., V)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    return softcap(logits.float(), cfg.logits_softcap)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def trunk(params, cfg: ModelConfig, tokens: torch.Tensor,
          make_cache: bool):
    """Embedding and every block over a full sequence: tokens (B, S) ->
    (the last block's output (B, S, d), the per-layer caches)."""
    _check(cfg)
    _, pattern, n_cycles, tail = layer_plan(cfg)
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache: Dict[str, Any] = {}
    if n_cycles:
        per_cycle = []
        for c in range(n_cycles):
            cyc = _cycle(params["cycles"], c)
            caches = {}
            for i, kind in enumerate(pattern):
                x, caches[f"b{i}"] = block_apply_seq(
                    cyc[f"b{i}"], cfg, kind, x, positions, make_cache)
            per_cycle.append(caches)
        if make_cache:
            cache["cycles"] = _stack_blocks(per_cycle)
    if tail:
        cache["tail"] = {}
        for i, kind in enumerate(tail):
            x, cache["tail"][str(i)] = block_apply_seq(
                params["tail"][str(i)], cfg, kind, x, positions, make_cache)
    return x, cache


def forward(params, cfg: ModelConfig, batch, mode: str = "train"):
    """mode 'train' -> (logits, aux); 'prefill' -> (logits, aux, cache).
    batch {"tokens": (B, S) int}; logits (B, S, V) float32; aux is the
    reference's auxiliary loss, zero without MoE."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}: 'train' or 'prefill'")
    x, cache = trunk(params, cfg, batch["tokens"], mode == "prefill")
    logits = head(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if mode == "prefill":
        return logits, aux, cache
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch):
    """The reference's loss: float32 cross-entropy of the train forward's
    logits against batch["labels"], masked by batch["mask"] when given,
    plus the auxiliary loss -> (loss, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, batch, mode="train")
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                pos: int):
    """tokens (B, 1) int; pos: the new token's position -> (logits
    (B, 1, V) float32, new cache).  The cache passed in is not modified."""
    _, pattern, n_cycles, tail = layer_plan(cfg)
    x = _embed_tokens(params, cfg, tokens)
    new_cache: Dict[str, Any] = {}
    if n_cycles:
        per_cycle = []
        for c in range(n_cycles):
            cyc, cyc_cache = _cycle(params["cycles"], c), _cycle(
                cache["cycles"], c)
            caches = {}
            for i, kind in enumerate(pattern):
                x, caches[f"b{i}"] = block_decode(
                    cyc[f"b{i}"], cfg, kind, x, cyc_cache[f"b{i}"], pos)
            per_cycle.append(caches)
        new_cache["cycles"] = _stack_blocks(per_cycle)
    if tail:
        new_cache["tail"] = {}
        for i, kind in enumerate(tail):
            x, new_cache["tail"][str(i)] = block_decode(
                params["tail"][str(i)], cfg, kind, x,
                cache["tail"][str(i)], pos)
    return head(params, cfg, x), new_cache


# ---------------------------------------------------------------------------
# decode-cache construction (zeros)
# ---------------------------------------------------------------------------
def _block_cache_zeros(cfg: ModelConfig, kind: str, batch: int,
                       cache_len: int, device):
    dt = pdtype(cfg)
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        c_len = attn.kv_cache_len(cfg, kind, cache_len)
        shape = (batch, c_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "slot_pos": torch.full((c_len,), -1, dtype=torch.int32,
                                       device=device)}
    if kind == BLK_RGLRU:
        w = cfg.rglru_width or cfg.d_model
        return {"lru_h": torch.zeros((batch, w), dtype=torch.float32,
                                     device=device),
                "lru_conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                        dtype=dt, device=device)}
    raise NotImplementedError(f"block kind {kind!r} is not yet ported")


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      device=DEFAULT_DEVICE) -> dict:
    _check(cfg)
    dev = resolve_device(device)
    _, pattern, n_cycles, tail = layer_plan(cfg)
    cache: Dict[str, Any] = {}
    if n_cycles:
        cache["cycles"] = _stack_blocks(
            [{f"b{i}": _block_cache_zeros(cfg, k, batch, cache_len, dev)
              for i, k in enumerate(pattern)}] * n_cycles)
    if tail:
        cache["tail"] = {str(i): _block_cache_zeros(cfg, k, batch,
                                                    cache_len, dev)
                         for i, k in enumerate(tail)}
    return cache
