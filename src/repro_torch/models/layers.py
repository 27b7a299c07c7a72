"""Shared building blocks: dtypes, initializers, RMS norm, soft-capping,
rotary embeddings, the gated FFN and the cross-entropy loss, each the
counterpart of the JAX package's `models/layers.py` on torch tensors.

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
from repro_torch.kernels.ops import records

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


# The scaling is in place: the same values as out of place, without a
# second float32 copy of the leaf (5 GB for one of DeepSeek-V2's stacked
# expert leaves).
def dense_init(gen, shape, dtype, fan_in: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, device).div_(math.sqrt(max(fan, 1))).to(dtype)


def embed_init(gen, shape, dtype, device="cpu") -> torch.Tensor:
    return _normal(gen, shape, device).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device="cpu") -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rstd * scale).to(x.dtype), rstd


class _RMSNorm(torch.autograd.Function):
    """rmsnorm whose backward keeps x and one float32 per row, not the
    two float32 copies of x that autograd of the forward's ops would keep:
    the forward is the same ops, the backward the analytic gradient in
    float32."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        out, rstd = _rmsnorm(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, scale, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        g = gy.float()
        dscale = (g * xhat).reshape(-1, xhat.shape[-1]).sum(0)
        gx = g * scale
        dx = rstd * (gx - xhat * torch.mean(gx * xhat, dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32, the output in x's dtype."""
    if records(x, p["scale"]):
        return _RMSNorm.apply(x, p["scale"], eps)
    return _rmsnorm(x, p["scale"], eps)[0]


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


def _rotate(x: torch.Tensor, cos, sin, rot: int, sign: float):
    """The first `rot` dims of x (pairs as [..half, half..]) rotated by
    the angles whose cosines and sines are given (sign -1: back), in
    float32, returned in x's dtype."""
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2: rot].float()
    if sign > 0:
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
    else:
        r1 = x1 * cos + x2 * sin
        r2 = x2 * cos - x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x[..., rot:]], -1)


class _Rope(torch.autograd.Function):
    """The rotation whose backward keeps only the angles' cosines and
    sines (the inverse rotation), not the float32 halves that autograd of
    the forward's ops would keep."""

    @staticmethod
    def forward(ctx, x, cos, sin, rot: int):
        ctx.save_for_backward(cos, sin)
        ctx.rot = rot
        return _rotate(x, cos, sin, rot, 1.0)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rotate(g, cos, sin, ctx.rot, -1.0), None, None, None


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
    if records(x):
        return _Rope.apply(x, cos, sin, rot)
    return _rotate(x, cos, sin, rot, 1.0)


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _nll(logits: torch.Tensor, labels: torch.Tensor):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold, lse


def _reduce(nll: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


class _CrossEntropy(torch.autograd.Function):
    """The loss whose backward writes softmax(logits) minus the one-hot
    labels, scaled by each token's weight, into one new float32 tensor
    (autograd of the forward's ops makes three of the logits' size)."""

    @staticmethod
    def forward(ctx, logits, labels, mask):
        nll, lse = _nll(logits, labels)
        ctx.save_for_backward(logits, labels, lse, mask)
        return _reduce(nll, mask)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, mask = ctx.saved_tensors
        if mask is None:
            w = (g / lse.numel()).expand(lse.shape)
        else:
            m = mask.float()
            w = m * (g / torch.clamp(m.sum(), min=1.0))
        w = w.to(logits.dtype)
        grad = torch.exp(logits - lse[..., None]).mul_(w[..., None])
        grad.scatter_add_(-1, labels.long()[..., None], -w[..., None])
        return grad, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token negative log-likelihood in float32: logits (..., V),
    labels (...,) int; with a mask, the masked mean (sum over at least one
    token)."""
    logits = logits.float()
    if records(logits):
        return _CrossEntropy.apply(logits, labels, mask)
    return _reduce(_nll(logits, labels)[0], mask)
