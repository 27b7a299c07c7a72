"""Shared building blocks: dtypes, initializers, RMS norm, soft-capping,
rotary embeddings and the gated FFN, each the counterpart of the JAX
package's `models/layers.py` on torch tensors.

Weights are made from an explicit `torch.Generator`, at the reference's
shapes and scales; the reference's `jax.random` stream is not reproduced
(`repro_torch.convert` carries its weights across where the two must
compute the same thing).  A generator of None makes the shapes alone
(used on `torch.device("meta")`)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pdtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port runs "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _normal(gen: Optional[torch.Generator], shape: Sequence[int],
            device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, shape, dtype, fan_in: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    return (_normal(gen, shape, device) / math.sqrt(max(fan, 1))).to(dtype)


def embed_init(gen, shape, dtype, device="cpu") -> torch.Tensor:
    return (_normal(gen, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device="cpu") -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings (standard / partial)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, fraction: float, theta: float,
               device="cpu") -> torch.Tensor:
    rot = int(head_dim * fraction)
    rot -= rot % 2
    half = rot // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / max(half, 1)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Rotates the first
    cfg.rope_fraction of head dims (pairs as [..half, half..])."""
    hd = x.shape[-1]
    rot = int(hd * cfg.rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_freqs(hd, cfg.rope_fraction, cfg.rope_theta, x.device)
    ang = positions.float()[..., None] * inv                  # (B, S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2: rot].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x[..., rot:]], -1)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def ffn_init(gen, cfg: ModelConfig, d_ff: int, device="cpu") -> dict:
    d, dt = cfg.d_model, pdtype(cfg)
    p = {"wi": dense_init(gen, (d, d_ff), dt, device=device),
         "wdown": dense_init(gen, (d_ff, d), dt, device=device)}
    if cfg.ffn_kind == "swiglu":
        p["wg"] = dense_init(gen, (d, d_ff), dt, device=device)
    return p


def ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.ffn_kind == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    return h @ p["wdown"]
