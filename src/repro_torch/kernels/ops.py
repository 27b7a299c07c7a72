"""Public entry points for the kernels, dispatched by the tensors' device:
a CUDA tensor launches the hand-written kernel (or the launch raises), a
CPU tensor takes the plain PyTorch version in `kernels.ref`.  There is no
fallback from one to the other: a caller that wants the plain version
hands over CPU tensors.

`flash_attention` and `rglru_scan` are differentiable: when autograd
records (grad enabled and an input requires grad) they run through a
`torch.autograd.Function` whose backward is the backward kernel on a card
(`flash_attention_bwd`, `rglru_scan_bwd`) and its plain version on the
CPU; otherwise (serving, `inference_mode`) the forward kernel is launched
as it is, with nothing saved.  Where the backward kernel lacks the head
dims (a pair outside `flash_attention.BWD_PAIRS`), a recording forward on
a card raises NotImplementedError before it launches anything: there is
no fallback to the plain backward."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import bayes_fit as _kernels
from repro_torch.kernels import decision_plane as _plane
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def bayes_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
    """Batched MacKay evidence fit: (T, N) float32 x, y, mask -> posterior
    dict with leaves stacked over T."""
    if _route(x) == "cuda":
        return _kernels.bayes_fit(x, y, mask)
    return ref.bayes_fit_ref(x, y, mask)


def nig_fold(slab: torch.Tensor, t: int) -> torch.Tensor:
    """Float64 fold of the T-row ragged slab (`core.bayes.fold_pack`: each
    row its state and its standardized observations) -> the (T, 9) folded
    states, bitwise equal to the scalar `nig_update` chain.  Any row
    lengths: nothing is padded (the TPU form bucketed columns because its
    kernel unrolled K)."""
    if _route(slab) == "cuda":
        return _kernels.nig_fold(slab, t)
    return ref.nig_fold_ref(slab, t)


def bayes_predict(batch) -> Optional[torch.Tensor]:
    """Batched float64 posterior predictive over the packed queries of
    `batch` (`kernels.bayes_fit.pack_predict`) -> (Q, 2) mean and std
    interleaved, or, when the batch has targets, each query's pair written
    at its destination index in its target's resident rows (None
    returned).  Any Q: nothing is padded (the TPU form padded to a tile
    multiple to avoid recompiles, which eager launches never pay)."""
    if _route(_kernels.slab_of(batch)) == "cuda":
        return _kernels.bayes_predict(batch)
    return ref.bayes_predict_ref(batch)


def fused_cost(batch, base: torch.Tensor,
               z: Optional[float] = None) -> torch.Tensor:
    """Fused predict -> scale -> quantile cost matrix for the decision
    plane: one packed `CostBatch` (`kernels.decision_plane.pack_cost`: the
    T task rows and the N node corrections) and the (T, N) static factor
    matrix `base` in, the float64 (T, N) HEFT cost matrix out.  `z` None
    (or 0) schedules on the mean."""
    if _route(_plane.cost_slab(batch)) == "cuda":
        return _plane.fused_cost(batch, base, z)
    return ref.fused_cost_ref(batch, base, z)


def eft_sweep(W: torch.Tensor, order_arr: torch.Tensor,
              dep_rows: torch.Tensor, gb8: torch.Tensor,
              ready0: torch.Tensor, avail: torch.Tensor, same: torch.Tensor,
              gbps_min: torch.Tensor, *, S: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One workflow's HEFT insertion sweep -> (assign, est, eft, cnt)
    (see `kernels.decision_plane.eft_sweep`).  No task padding: the TPU
    form padded T to a bucket to avoid recompiles, which eager launches
    never pay."""
    args = (W, order_arr, dep_rows, gb8, ready0, avail, same, gbps_min)
    if _route(W) == "cuda":
        return _plane.eft_sweep(*args, S=S)
    return ref.eft_sweep_ref(*args, S=S)


def eft_sweep_many(W: Sequence[torch.Tensor], order_arr: torch.Tensor,
                   dep_rows: Sequence[torch.Tensor],
                   gb8: Sequence[torch.Tensor],
                   ready0: Sequence[torch.Tensor],
                   avail: Sequence[torch.Tensor], same: torch.Tensor,
                   gbps_min: torch.Tensor, *, S: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """B workflows' sweeps on one cluster -> (assign, est, eft) (B, T) and
    cnt (B, N) (see `kernels.decision_plane.eft_sweep_many`).  The lanes'
    operands stay where they lie, at their own T_b and D_b: only the rank
    order is padded, with -1 (the TPU form stacked every operand at one
    padded shape because it vmapped one compiled sweep)."""
    args = (W, order_arr, dep_rows, gb8, ready0, avail, same, gbps_min)
    if _route(order_arr) == "cuda":
        return _plane.eft_sweep_many(*args, S=S)
    return ref.eft_sweep_many_ref(*args, S=S)


def upward_rank(W: Sequence[torch.Tensor], tables: Sequence
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HEFT's upward ranks of B workflows -> (rank (B, T), -inf past each
    lane's rows; bad (B,), 1 where a lane's W is not finite) (see
    `kernels.decision_plane.upward_rank`)."""
    if _route(W[0]) == "cuda":
        return _plane.upward_rank(W, tables)
    return ref.upward_rank_ref(W, tables)


def records(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is `flash_attention_bwd` (the CUDA
    kernel) or `ref.attention_bwd_ref` (the plain version), from the
    output and each row's log-sum-exp saved by the forward.  `plain`
    picks the plain versions for both passes; `flash_attention` sets it
    from the device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, plain: bool):
        pair = (q.shape[-1], v.shape[-1])
        if not plain and pair not in _flash.BWD_PAIRS:
            raise NotImplementedError(
                f"flash_attention_bwd has no kernel for head dims {pair} "
                f"(q and k, v; it takes {_flash.BWD_PAIRS}): attention at "
                f"this pair does not train on the card")
        if plain:
            o, lse = ref.attention_fwd_ref(q, k, v, causal=causal,
                                           window=window)
        else:
            o, lse = _flash.flash_attention(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, plain = ctx.args
        bwd = ref.attention_bwd_ref if plain else _flash.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, causal=causal,
                         window=window)
        return dq, dk, dv, None, None, None


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan whose backward is `rglru_scan_bwd` (the CUDA
    kernel) or `ref.rglru_scan_bwd_ref` (the plain version), from the
    output h saved by the forward."""

    @staticmethod
    def forward(ctx, a, gx, h0, plain: bool):
        h = (ref.rglru_scan_ref if plain else _rglru.rglru_scan)(a, gx, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.plain = plain
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        bwd = ref.rglru_scan_bwd_ref if ctx.plain else _rglru.rglru_scan_bwd
        da, dgx, dh0 = bwd(a, h, h0, g.contiguous())
        return da, dgx, (dh0 if ctx.needs_input_grad[2] else None), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (and, for window > 0, sliding-window) attention with grouped
    kv heads: q (B, Sq, H, hd), k (B, Skv, K, hd) and v (B, Skv, K, hd_v)
    at their K heads, never expanded -> (B, Sq, H, hd_v) in q's dtype,
    the scores scaled by 1 / sqrt(hd).  Any Sq: nothing is padded (the TPU
    form asserted tile multiples, a TPU tiling limit).  Differentiable in
    q, k and v (see the module docstring)."""
    plain = _route(q) == "cpu"
    if records(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, plain)
    if plain:
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def rglru_scan(a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence h_t = a_t * h_{t-1} + gx_t over (B, T, W)
    float32 from h0 (B, W) -> h (B, T, W) float32.  Differentiable in a,
    gx and h0 (see the module docstring)."""
    plain = _route(a) == "cpu"
    if records(a, gx, h0):
        return RGLRUScan.apply(a, gx, h0, plain)
    if plain:
        return ref.rglru_scan_ref(a, gx, h0)
    return _rglru.rglru_scan(a, gx, h0)
