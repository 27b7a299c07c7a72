"""Attention blocks with grouped key-value heads (full and local/sliding
window), the counterpart of the JAX package's `models/attention.py` for
the kinds the port runs.

Full-sequence attention (training and prefill) goes through
`kernels.ops.flash_attention` on q at its H heads and k, v at their K
heads (the hand-written CUDA kernels, forward and backward, on a card;
their plain versions on the CPU).  That is the function the reference's
`chunked_causal_attention` computes on head-expanded k and v; the kernel
reads kv head h * K / H for query head h, so nothing is expanded.  Decode
attends over the KV cache (a ring of `window` slots for local attention)
with plain tensor code, as the reference's decode uses no kernel either.

Padded heads (SmolLM's 15 query heads padded to 16): `wq` and `wo` keep
the reference's padded shapes, pad rows zero, so that weights and
checkpoints cross between the packages leaf for leaf.  The reference maps
real head i to kv head i * K // H and masks the pad heads' outputs to
zero (`head_mask`, `_kv_map`); here attention runs on the H real heads
alone, sliced from `wq` and `wo`, which gives the same output and exactly
zero gradients on the pad rows.  MLA, cross-attention and M-RoPE are not
ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, pdtype

NEG_INF = -1e30
WINDOWED = ("swa", "local")


def attn_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d, k_h, hd, h = cfg.d_model, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    hp = cfg.padded_heads
    dt = pdtype(cfg)
    p = {
        "wq": dense_init(gen, (d, hp, hd), dt, fan_in=d, device=device),
        "wk": dense_init(gen, (d, k_h, hd), dt, fan_in=d, device=device),
        "wv": dense_init(gen, (d, k_h, hd), dt, fan_in=d, device=device),
        "wo": dense_init(gen, (hp, hd, d), dt, fan_in=h * hd, device=device),
    }
    if hp != h and p["wq"].device.type != "meta":
        p["wq"][:, h:] = 0                   # the reference's head mask
        p["wo"][h:] = 0
    return p


def real_heads(p: dict, cfg: ModelConfig):
    """wq (d, H, hd) and wo (H, hd, d) at the H real query heads: the
    leaves themselves, or slices of the padded leaves (autograd gives the
    pad rows exactly zero gradients)."""
    h = cfg.num_heads
    if cfg.padded_heads == h:
        return p["wq"], p["wo"]
    return p["wq"][:, :h], p["wo"][:h]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, hd) -> (B, S, H, hd), contiguous."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(x.shape[:2] + (h, hd))


def _qkv(p, cfg: ModelConfig, x, positions):
    q = apply_rope(_project(x, real_heads(p, cfg)[0]), positions, cfg)
    k = apply_rope(_project(x, p["wk"]), positions, cfg)
    return q, k, _project(x, p["wv"])


def _out(p, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d)."""
    wo = real_heads(p, cfg)[1]
    h, hd, d = wo.shape
    return o.reshape(o.shape[:2] + (h * hd,)) @ wo.reshape(h * hd, d)


def attn_apply_seq(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                   positions: torch.Tensor, make_cache: bool = False):
    """Full-sequence (train / prefill).  Returns (out, cache or None)."""
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.window if kind in WINDOWED else 0
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    out = _out(p, cfg, o)
    cache = make_kv_cache(cfg, kind, k, v, x.shape[1]) if make_cache else None
    return out, cache


# --- KV caches --------------------------------------------------------------
def kv_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind in WINDOWED and cfg.window > 0:
        return min(seq_len, cfg.window)
    return seq_len


def make_kv_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                  v: torch.Tensor, seq_len: int) -> dict:
    """Build the cache from prefill kv (B, S, K, hd).  Windowed kinds keep
    a ring of the last `window` positions: slot pos % c_len holds pos."""
    c_len = kv_cache_len(cfg, kind, seq_len)
    s = k.shape[1]
    dev = k.device
    if c_len < s:
        tail_pos = torch.arange(s - c_len, s, device=dev)
        slot = tail_pos % c_len
        k_ring = torch.zeros_like(k[:, :c_len])
        v_ring = torch.zeros_like(v[:, :c_len])
        k_ring[:, slot] = k[:, -c_len:]
        v_ring[:, slot] = v[:, -c_len:]
        slots = torch.zeros(c_len, dtype=torch.int32, device=dev)
        slots[slot] = tail_pos.to(torch.int32)
        return {"k": k_ring, "v": v_ring, "slot_pos": slots}
    return {"k": k, "v": v,
            "slot_pos": torch.arange(c_len, dtype=torch.int32, device=dev)}


def attn_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                cache: dict, pos: int):
    """One-token decode.  x: (B, 1, d); pos: the new token's position.
    Returns (out, new_cache); the cache passed in is not modified."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    c_len = cache["k"].shape[1]
    slot = pos % c_len               # the ring for windowed kinds; == pos
    k, v, slot_pos = (cache[n].clone() for n in ("k", "v", "slot_pos"))
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    slot_pos[slot] = pos
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if kind in WINDOWED and cfg.window > 0:
        valid &= slot_pos > pos - cfg.window
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    # grouped: query head h reads kv head h // (H / K), nothing expanded
    qg = q.float().reshape(b, 1, kh, cfg.num_heads // kh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg * (1.0 / math.sqrt(hd)),
                     k.float())
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, v.float())
    o = o.reshape(b, 1, cfg.num_heads, hd).to(x.dtype)
    return _out(p, cfg, o), {"k": k, "v": v, "slot_pos": slot_pos}
