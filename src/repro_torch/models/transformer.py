"""Model assembly: block dispatch, the layer loop, train/prefill forward,
the loss and decode, the counterpart of the JAX package's
`models/transformer.py` for the block kinds the port runs (full, sliding
window and local attention, DeepSeek-V2's MLA, RG-LRU, xLSTM's mLSTM and
sLSTM; a dense FFN or a mixture of experts).

Layer plan, as in the reference: `first_dense_layers` prefix blocks with
a dense FFN (DeepSeek's dense layer 0), then `n_cycles` copies of
`block_pattern` whose parameters are stacked on a leading cycle axis,
then a tail remainder (RecurrentGemma's 38 = 12 * (r, r, l) + (r, r));
the cycles and the tail take the MoE when the config has experts.  The
reference scans over the stacked cycles; here a Python loop indexes them.
In training, `cfg.remat` wraps each cycle as the reference's
`_remat_wrap` wraps its scan body: "full" keeps only the cycle's inputs,
"dots" also the outputs of the products without a batch dimension (the
reference's `dots_with_no_batch_dims_saveable`), and the backward
recomputes the rest.  Parameters are plain nested dicts of tensors with
the reference's keys and shapes, so `repro_torch.convert` carries its
weights across leaf for leaf.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (
    ATTENTION_KINDS, ATTN_FULL, ATTN_LOCAL, ATTN_MLA, ATTN_SWA, BLK_MLSTM,
    BLK_RGLRU, BLK_SLSTM, ModelConfig,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_init, ffn_apply, ffn_init, pdtype,
    rmsnorm, rmsnorm_init, softcap,
)

PORTED_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL, ATTN_MLA, BLK_RGLRU,
                BLK_MLSTM, BLK_SLSTM)


def _check(cfg: ModelConfig) -> None:
    other = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if other:
        raise NotImplementedError(f"block kinds {other} of {cfg.name} are "
                                  f"not yet ported to repro_torch")
    if cfg.cross_attn or cfg.mrope_sections or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: cross-attention, M-RoPE and "
                                  f"frontends are not yet ported to "
                                  f"repro_torch")


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
def block_init(gen, cfg: ModelConfig, kind: str, use_moe: bool,
               device="cpu") -> dict:
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        p["attn"] = attn.attn_init(gen, cfg, device)
    elif kind == ATTN_MLA:
        p["attn"] = attn.mla_init(gen, cfg, device)
    elif kind == BLK_RGLRU:
        p["mix"] = rglru_mod.rglru_init(gen, cfg, device)
    elif kind == BLK_MLSTM:
        p["mix"] = xlstm_mod.mlstm_init(gen, cfg, device)
    elif kind == BLK_SLSTM:
        p["mix"] = xlstm_mod.slstm_init(gen, cfg, device)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    if _has_ffn(cfg, kind):
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        if use_moe:
            p["moe"] = moe_mod.moe_init(gen, cfg, device)
        else:
            d_ff = cfg.dense_d_ff if (cfg.is_moe and cfg.dense_d_ff) \
                else cfg.d_ff
            p["ffn"] = ffn_init(gen, cfg, d_ff, device)
    return p


def block_apply_seq(p: dict, cfg: ModelConfig, kind: str, x, positions,
                    make_cache: bool):
    """Full-sequence block.  Returns (x, cache, aux): aux the MoE's
    auxiliary loss, a float32 zero without one."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        mix, c = attn.attn_apply_seq(p["attn"], cfg, kind, h, positions,
                                     make_cache)
    elif kind == ATTN_MLA:
        mix, c = attn.mla_apply_seq(p["attn"], cfg, h, positions, make_cache)
    elif kind == BLK_RGLRU:
        mix, c = rglru_mod.rglru_apply_seq(p["mix"], cfg, h, make_cache)
    elif kind == BLK_MLSTM:
        mix, c = xlstm_mod.mlstm_apply_seq(p["mix"], cfg, h, make_cache)
    elif kind == BLK_SLSTM:
        mix, c = xlstm_mod.slstm_apply_seq(p["mix"], cfg, h, make_cache)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    x = x + mix
    if "moe" in p:
        y, a = moe_mod.moe_apply(p["moe"], cfg,
                                 rmsnorm(p["norm2"], x, cfg.norm_eps))
        x = x + y
        aux = aux + a
    elif "ffn" in p:
        x = x + ffn_apply(p["ffn"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, c or {}, aux


def block_decode(p: dict, cfg: ModelConfig, kind: str, x, cache, pos: int):
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
        mix, c = attn.attn_decode(p["attn"], cfg, kind, h, cache, pos)
    elif kind == ATTN_MLA:
        mix, c = attn.mla_decode(p["attn"], cfg, h, cache, pos)
    elif kind == BLK_RGLRU:
        mix, c = rglru_mod.rglru_decode(p["mix"], cfg, h, cache, pos)
    elif kind == BLK_MLSTM:
        mix, c = xlstm_mod.mlstm_decode(p["mix"], cfg, h, cache, pos)
    elif kind == BLK_SLSTM:
        mix, c = xlstm_mod.slstm_decode(p["mix"], cfg, h, cache, pos)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    x = x + mix
    if "moe" in p:
        y, _ = moe_mod.moe_apply(p["moe"], cfg,
                                 rmsnorm(p["norm2"], x, cfg.norm_eps))
        x = x + y
    elif "ffn" in p:
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
        return {f"b{i}": block_init(gen, cfg, kind, cfg.is_moe, device)
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
    prefix, pattern, n_cycles, tail = layer_plan(cfg)
    dt = pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                    device=dev)
    if prefix:
        params["prefix"] = {str(i): block_init(gen, cfg, kind, False, dev)
                            for i, kind in enumerate(prefix)}
    if n_cycles:
        params["cycles"] = _stacked_cycles(gen, cfg, pattern, n_cycles, dev)
    if tail:
        params["tail"] = {str(i): block_init(gen, cfg, kind, cfg.is_moe,
                                             dev)
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
# the outputs of products without a batch dimension (a 2-d @ 2-d, which a
# 3-d @ 2-d matmul reaches): the reference's dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


REMAT = ("none", "dots", "full")


def _remat_wrap(fn, remat: str):
    """fn recomputed in the backward (`_remat_wrap` of the reference):
    "full" saves nothing of it, "dots" the outputs of its products with no
    batch dimension."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: one of {REMAT}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _blocks_seq(blocks, kinds, cfg: ModelConfig, x, positions,
                make_cache: bool, aux):
    """The blocks `blocks[key]` of `kinds` ({key: kind}) in order over a
    full sequence -> (x, {key: cache}, aux plus theirs)."""
    caches = {}
    for key, kind in kinds.items():
        x, caches[key], a = block_apply_seq(blocks[key], cfg, kind, x,
                                            positions, make_cache)
        aux = aux + a
    return x, caches, aux


def trunk(params, cfg: ModelConfig, tokens: torch.Tensor,
          make_cache: bool, remat: str = "none"):
    """Embedding and every block over a full sequence: tokens (B, S) ->
    (the last block's output (B, S, d), the per-layer caches, the summed
    float32 auxiliary loss).  `remat` wraps each cycle (see
    `_remat_wrap`); the caller sets it for training alone."""
    _check(cfg)
    prefix, pattern, n_cycles, tail = layer_plan(cfg)
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: Dict[str, Any] = {}
    if prefix:
        x, cache["prefix"], aux = _blocks_seq(
            params["prefix"], {str(i): k for i, k in enumerate(prefix)}, cfg,
            x, positions, make_cache, aux)
    if n_cycles:
        kinds = {f"b{i}": k for i, k in enumerate(pattern)}

        def cycle(xc, auxc, cyc):
            return _blocks_seq(cyc, kinds, cfg, xc, positions, make_cache,
                               auxc)
        cycle = _remat_wrap(cycle, remat)
        per_cycle = []
        for c in range(n_cycles):
            x, caches, aux = cycle(x, aux, _cycle(params["cycles"], c))
            per_cycle.append(caches)
        if make_cache:
            cache["cycles"] = _stack_blocks(per_cycle)
    if tail:
        x, cache["tail"], aux = _blocks_seq(
            params["tail"], {str(i): k for i, k in enumerate(tail)}, cfg, x,
            positions, make_cache, aux)
    return x, cache, aux


def forward(params, cfg: ModelConfig, batch, mode: str = "train"):
    """mode 'train' -> (logits, aux); 'prefill' -> (logits, aux, cache).
    batch {"tokens": (B, S) int}; logits (B, S, V) float32; aux the MoE's
    float32 auxiliary loss summed over its layers (zero without one).
    `cfg.remat` acts in training with grad enabled, as the reference's
    acts under its gradient."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}: 'train' or 'prefill'")
    remat = cfg.remat if mode == "train" and torch.is_grad_enabled() \
        else "none"
    x, cache, aux = trunk(params, cfg, batch["tokens"], mode == "prefill",
                          remat)
    logits = head(params, cfg, x)
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
def _blocks_decode(blocks, kinds, cfg: ModelConfig, x, cache, pos: int):
    new = {}
    for key, kind in kinds.items():
        x, new[key] = block_decode(blocks[key], cfg, kind, x, cache[key], pos)
    return x, new


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                pos: int):
    """tokens (B, 1) int; pos: the new token's position -> (logits
    (B, 1, V) float32, new cache).  The cache passed in is not modified."""
    prefix, pattern, n_cycles, tail = layer_plan(cfg)
    x = _embed_tokens(params, cfg, tokens)
    new_cache: Dict[str, Any] = {}
    if prefix:
        x, new_cache["prefix"] = _blocks_decode(
            params["prefix"], {str(i): k for i, k in enumerate(prefix)}, cfg,
            x, cache["prefix"], pos)
    if n_cycles:
        kinds = {f"b{i}": k for i, k in enumerate(pattern)}
        per_cycle = []
        for c in range(n_cycles):
            x, caches = _blocks_decode(_cycle(params["cycles"], c), kinds,
                                       cfg, x, _cycle(cache["cycles"], c),
                                       pos)
            per_cycle.append(caches)
        new_cache["cycles"] = _stack_blocks(per_cycle)
    if tail:
        x, new_cache["tail"] = _blocks_decode(
            params["tail"], {str(i): k for i, k in enumerate(tail)}, cfg, x,
            cache["tail"], pos)
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
    if kind == ATTN_MLA:
        return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                    dtype=dt, device=device),
                "k_rope": torch.zeros((batch, cache_len,
                                       cfg.qk_rope_head_dim), dtype=dt,
                                      device=device),
                "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                       device=device)}
    if kind == BLK_RGLRU:
        w = cfg.rglru_width or cfg.d_model
        return {"lru_h": torch.zeros((batch, w), dtype=torch.float32,
                                     device=device),
                "lru_conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                        dtype=dt, device=device)}
    if kind == BLK_MLSTM:
        pd = int(cfg.d_model * cfg.mlstm_proj_factor)
        nh = cfg.num_heads
        dh = pd // nh
        f32 = torch.float32
        return {"mc": torch.zeros((batch, nh, dh, dh), dtype=f32,
                                  device=device),
                "mn": torch.zeros((batch, nh, dh), dtype=f32, device=device),
                "mm": torch.zeros((batch, nh), dtype=f32, device=device),
                "conv_m": torch.zeros((batch, cfg.conv_width - 1, pd),
                                      dtype=dt, device=device)}
    if kind == BLK_SLSTM:
        # sn starts at ones, as the reference's does: decode over this
        # cache differs from the sequence form's first step (zeros)
        c = {key: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                              device=device)
             for key in ("sc", "sn", "sh", "sm")}
        c["sn"] = torch.ones((batch, cfg.d_model), dtype=torch.float32,
                             device=device)
        return c
    raise NotImplementedError(f"block kind {kind!r} is not yet ported")


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      device=DEFAULT_DEVICE) -> dict:
    _check(cfg)
    dev = resolve_device(device)
    prefix, pattern, n_cycles, tail = layer_plan(cfg)
    cache: Dict[str, Any] = {}
    if prefix:
        cache["prefix"] = {str(i): _block_cache_zeros(cfg, k, batch,
                                                      cache_len, dev)
                           for i, k in enumerate(prefix)}
    if n_cycles:
        cache["cycles"] = _stack_blocks(
            [{f"b{i}": _block_cache_zeros(cfg, k, batch, cache_len, dev)
              for i, k in enumerate(pattern)}] * n_cycles)
    if tail:
        cache["tail"] = {str(i): _block_cache_zeros(cfg, k, batch,
                                                    cache_len, dev)
                         for i, k in enumerate(tail)}
    return cache
