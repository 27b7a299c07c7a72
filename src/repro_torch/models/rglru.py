"""Griffin recurrent block (RecurrentGemma): causal depthwise conv + RG-LRU,
the counterpart of the JAX package's `models/rglru.py`.

RG-LRU recurrence (per channel, gates block-diagonal over heads):
    r_t = sigmoid(x_t W_a)           (recurrence gate)
    i_t = sigmoid(x_t W_x)           (input gate)
    log a_t = -c * softplus(Lambda) * r_t,   c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through `kernels.ops.rglru_scan` (the
hand-written CUDA scan on a card, its sequential plain version on the
CPU), where the reference takes an associative scan: the same function.
Decode carries (h, conv window) state and runs plain tensor code, as the
reference's decode uses no kernel either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, pdtype

_C = 8.0


def rglru_init(gen, cfg: ModelConfig, device="cpu") -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    nh = cfg.num_heads
    wh = w // nh
    dt = pdtype(cfg)
    f32 = torch.float32
    lam = torch.rand(w, generator=gen, dtype=f32, device=device)
    return {
        "w_x": dense_init(gen, (d, w), dt, device=device),
        "w_gate": dense_init(gen, (d, w), dt, device=device),
        "w_out": dense_init(gen, (w, d), dt, fan_in=w, device=device),
        "conv_w": dense_init(gen, (cfg.conv_width, w), dt,
                             fan_in=cfg.conv_width, device=device),
        "conv_b": torch.zeros(w, dtype=dt, device=device),
        "gate_a": dense_init(gen, (nh, wh, wh), f32, fan_in=wh,
                             device=device),
        "gate_x": dense_init(gen, (nh, wh, wh), f32, fan_in=wh,
                             device=device),
        "lru_lambda": lam * 3.0 - 6.0,             # uniform on [-6, -3)
    }


def _block_gate(wm: torch.Tensor, x: torch.Tensor, nh: int) -> torch.Tensor:
    """block-diagonal linear over heads: x (..., w) -> (..., w) float32."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (nh, shp[-1] // nh)).float()
    return torch.einsum("...hk,hkj->...hj", xh, wm).reshape(shp)


def _gates(p, cfg: ModelConfig, xb):
    nh = cfg.num_heads
    r = torch.sigmoid(_block_gate(p["gate_a"], xb, nh))
    i = torch.sigmoid(_block_gate(p["gate_x"], xb, nh))
    log_a = -_C * F.softplus(p["lru_lambda"]) * r               # float32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0))
    return a, beta * (i * xb.float())


def _conv_seq(p, x):
    """causal depthwise conv via shifted adds; x (B, S, w)."""
    cw = p["conv_w"].shape[0]
    s = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(cw):
        shift = cw - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xs * p["conv_w"][j]
    return y + p["conv_b"]


def rglru_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    make_cache: bool = False):
    """x: (B, S, d) -> (out, cache or None)."""
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xc = _conv_seq(p, xb)
    a, gx = _gates(p, cfg, xc)
    h0 = torch.zeros((x.shape[0], a.shape[-1]), dtype=torch.float32,
                     device=x.device)
    h = ops.rglru_scan(a.contiguous(), gx.contiguous(), h0).to(x.dtype)
    out = (h * gate) @ p["w_out"]
    cache = None
    if make_cache:
        cw = cfg.conv_width
        # copies, so that the cache does not hold the (B, S, w) tensors
        conv_state = F.pad(xb, (0, 0, cw - 1, 0))[:, -(cw - 1):].clone()
        cache = {"lru_h": h[:, -1].to(torch.float32, copy=True),
                 "lru_conv": conv_state}
    return out, cache


def rglru_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                 pos: int):
    """One-step decode.  x (B, 1, d); cache {'lru_h': (B, w) float32,
    'lru_conv': (B, cw-1, w)}.  Returns (out, new_cache)."""
    xb = (x @ p["w_x"])[:, 0]                                    # (B, w)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")[:, 0]
    conv = cache["lru_conv"]
    cw = p["conv_w"].shape[0]
    xc = xb * p["conv_w"][cw - 1] + p["conv_b"]
    for j in range(cw - 1):
        xc = xc + conv[:, j] * p["conv_w"][j]
    a, gx = _gates(p, cfg, xc)
    h = a * cache["lru_h"] + gx                                  # float32
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    new_conv = torch.cat([conv[:, 1:], xb[:, None]], dim=1)
    return out, {"lru_h": h, "lru_conv": new_conv}
