"""Attention blocks with grouped key-value heads (full and local/sliding
window) and DeepSeek-V2's multi-head latent attention (MLA), the
counterpart of the JAX package's `models/attention.py` for the kinds the
port runs.

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
zero gradients on the pad rows.

MLA trains and prefills in the expanded form: q and k of head dim
nope + rope (192 for DeepSeek-V2), v of its own (128), all H heads,
through `ops.flash_attention` at that pair of head dims; it decodes in
the absorbed form over the compressed (c_kv, k_rope) cache, in plain
tensor code, as the reference does.  `wkv_b` is split into its k and v
parts before the two products, so that k_nope and v come out contiguous
(the kernel takes contiguous operands): the split copies the weight's
parts, 16.8 MB a layer at DeepSeek-V2's widths, where slicing v off one
(B, S, H, 256) product would copy 268 MB of v a layer at B 2 x 4,096.

Cross-attention and M-RoPE are not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope, dense_init, pdtype, rmsnorm, rmsnorm_init,
)

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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dt = pdtype(cfg)
    return {
        "wq_a": dense_init(gen, (d, cfg.q_lora_rank), dt, device=device),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, device),
        "wq_b": dense_init(gen, (cfg.q_lora_rank, h, qk), dt,
                           fan_in=cfg.q_lora_rank, device=device),
        "wkv_a": dense_init(gen, (d, cfg.kv_lora_rank
                                  + cfg.qk_rope_head_dim), dt, device=device),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, device),
        "wkv_b": dense_init(gen, (cfg.kv_lora_rank, h, cfg.qk_nope_head_dim
                                  + cfg.v_head_dim), dt,
                            fan_in=cfg.kv_lora_rank, device=device),
        "wo_mla": dense_init(gen, (h, cfg.v_head_dim, d), dt,
                             fan_in=h * cfg.v_head_dim, device=device),
    }


def _mla_q(p, cfg: ModelConfig, x, positions):
    """-> q_nope (B, S, H, nope), a view, and the rotated q_rope
    (B, S, H, rope)."""
    q = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
    q = _project(q, p["wq_b"])
    nope = cfg.qk_nope_head_dim
    q_rope = apply_rope(q[..., nope:], positions, cfg)
    return q[..., :nope], q_rope


def _mla_ckv(p, cfg: ModelConfig, x, positions):
    """-> c_kv (B, S, kv_lora), normed, and the rotated k_rope (B, S,
    rope), shared by every head."""
    kv_a = x @ p["wkv_a"]
    r = cfg.kv_lora_rank
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions, cfg)
    return c_kv, k_rope[:, :, 0, :]


def _mla_out(p, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, v) @ wo_mla (H, v, d) -> (B, S, d)."""
    h, vd, d = p["wo_mla"].shape
    return o.reshape(o.shape[:2] + (h * vd,)) @ p["wo_mla"].reshape(h * vd, d)


def mla_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, make_cache: bool = False):
    """Expanded-form MLA for train / prefill.  Returns (out, cache or
    None); the cache is (c_kv, k_rope) and the positions' slots."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    nope = cfg.qk_nope_head_dim
    k_nope = _project(c_kv, p["wkv_b"][..., :nope])
    v = _project(c_kv, p["wkv_b"][..., nope:])
    b, s, h = k_nope.shape[:3]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_head_dim)], -1)
    o = ops.flash_attention(q, k, v, causal=True)
    cache = None
    if make_cache:
        cache = {"c_kv": c_kv, "k_rope": k_rope,
                 "slot_pos": torch.arange(s, dtype=torch.int32,
                                          device=x.device)}
    return _mla_out(p, o), cache


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int):
    """Absorbed-form MLA decode over the compressed cache: x (B, 1, d) ->
    (out, new cache); the cache passed in is not modified.  q_nope goes
    through wkv_b's k part into the latent space (a product in x's dtype),
    the scores and softmax are float32 over c_kv and k_rope, and the
    latent output goes back through wkv_b's v part in x's dtype, as the
    reference computes them."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)           # (B, 1, H, *)
    c_new, kr_new = _mla_ckv(p, cfg, x, positions)
    c_kv, k_rope, slot_pos = (cache[n].clone()
                              for n in ("c_kv", "k_rope", "slot_pos"))
    c_kv[:, pos] = c_new[:, 0]
    k_rope[:, pos] = kr_new[:, 0]
    slot_pos[pos] = pos
    nope = cfg.qk_nope_head_dim
    q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, p["wkv_b"][..., :nope])
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    s = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_kv.float())
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope.float())
         ) * scale
    s = torch.where((slot_pos >= 0) & (slot_pos <= pos), s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhqs,bsr->bqhr", pr, c_kv.float())
    o = torch.einsum("bqhr,rhv->bqhv", o_c.to(x.dtype),
                     p["wkv_b"][..., nope:])
    return _mla_out(p, o), {"c_kv": c_kv, "k_rope": k_rope,
                            "slot_pos": slot_pos}
