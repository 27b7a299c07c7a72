"""Mixture-of-Experts: capacity-based top-k dispatch (GShard-style), the
counterpart of the JAX package's `models/moe.py`.

Routing is per sequence: a choice's slot in its expert is its count among
the sequence's earlier choices of that expert, in (token, k) order, and
a choice whose slot is past the expert's capacity is dropped.  Tokens are
gathered into (B, E, C, d) dispatch buffers, the experts run as batched
products over E, and each token gathers its top-k outputs back, weighted
by its renormalised router probabilities.  Shared experts (DeepSeek) are
one dense FFN of width num_shared * moe_d_ff.  The reference's GSPMD
sharding constraints are no-ops on one card and are left out; its expert
products are plain XLA einsums, not a Pallas kernel, and stay PyTorch
products here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, ffn_apply, pdtype


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = -(-seq_len * cfg.top_k // cfg.num_experts)
    c = int(c * cfg.capacity_factor)
    return max(8, _round_up(c, 8)) if seq_len > 1 else 1


def moe_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = pdtype(cfg)
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "we_i": dense_init(gen, (e, d, f), dt, fan_in=d, device=device),
        "we_down": dense_init(gen, (e, f, d), dt, fan_in=f, device=device),
    }
    if cfg.ffn_kind == "swiglu":
        p["we_g"] = dense_init(gen, (e, d, f), dt, fan_in=d, device=device)
    if cfg.num_shared_experts > 0:
        fs = cfg.num_shared_experts * f
        p["shared"] = {"wi": dense_init(gen, (d, fs), dt, device=device),
                       "wdown": dense_init(gen, (fs, d), dt, device=device)}
        if cfg.ffn_kind == "swiglu":
            p["shared"]["wg"] = dense_init(gen, (d, fs), dt, device=device)
    return p


def route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The router: float32 logits, softmax over experts, top-k ->
    (probs (B, S, E), top-k probabilities (B, S, K), their experts)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_p, top_i


def slots(top_i: torch.Tensor, num_experts: int) -> torch.Tensor:
    """top_i (B, S, K) -> each choice's slot in its expert (B, S * K), in
    (token, k) order: its count among the sequence's earlier choices of
    that expert.  The one-hot is laid out (B, E, SK), so that the count
    is a scan along the innermost axis (along an outer axis of 8 columns
    the card's scan took 2.4 ms a Mixtral prefill layer)."""
    flat_i = top_i.reshape(top_i.shape[0], 1, -1)                  # (B,1,SK)
    experts = torch.arange(num_experts, device=top_i.device)[:, None]
    onehot = (flat_i == experts).to(torch.int32)                   # (B,E,SK)
    pos_in_e = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    return torch.gather(pos_in_e, 1, flat_i)[:, 0].long()


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), the float32 auxiliary loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, s)

    probs, top_p, top_i = route(p, cfg, x)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # --- slot assignment (per sequence, position-priority) -----------------
    flat_i = top_i.reshape(b, s * k)                               # (B,SK)
    flat_p = top_p.reshape(b, s * k).to(x.dtype)
    slot = slots(top_i, e)
    keep = slot < c
    dest = torch.where(keep, flat_i * c + slot, e * c)
    token_of = torch.arange(s * k, device=x.device) // k           # (SK,)

    # token indices into the (B, E*C) slot table; a dropped choice writes
    # the one extra column, which is sliced off (the reference's
    # out-of-range scatter with mode="drop")
    slot_tok = torch.full((b, e * c + 1), -1, dtype=torch.int64,
                          device=x.device)
    slot_tok.scatter_(1, dest, token_of.expand(b, s * k))
    slot_tok = slot_tok[:, : e * c]

    # --- dispatch -----------------------------------------------------------
    rows = torch.arange(b, device=x.device)[:, None]
    x_e = x[rows, slot_tok.clamp(min=0)]                           # (B,EC,d)
    x_e = x_e * (slot_tok >= 0)[..., None].to(x.dtype)
    x_e = x_e.reshape(b, e, c, d)

    # --- expert compute ------------------------------------------------------
    h = torch.einsum("becd,edf->becf", x_e, p["we_i"])
    if cfg.ffn_kind == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", x_e, p["we_g"])) * h
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    y_e = torch.einsum("becf,efd->becd", h, p["we_down"])

    # --- combine: each choice gathers its expert's output back --------------
    src = torch.where(keep, dest, 0)                               # (B,SK)
    y_k = y_e.reshape(b, e * c, d)[rows, src]                      # (B,SK,d)
    w_k = torch.where(keep, flat_p, torch.zeros_like(flat_p))[..., None]
    y = (y_k * w_k).reshape(b, s, k, d).sum(dim=2)

    # --- shared experts --------------------------------------------------------
    if "shared" in p:
        y = y + ffn_apply(p["shared"], cfg, x)

    # --- load-balancing aux loss (Switch-style) ---------------------------------
    me = probs.mean(dim=(0, 1))                                     # (E,)
    ce = F.one_hot(top_i, e).float().sum(2).mean(dim=(0, 1)) * (1.0 / k)
    aux = cfg.router_aux_loss * e * torch.sum(me * ce) * k
    return y, aux
