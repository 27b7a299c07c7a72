"""Mixtral-8x7B [arXiv:2401.04088] — MoE 8 experts top-2, GQA kv=8, SWA.

Sliding-window attention (4096) makes decode sub-quadratic in window size:
long_500k RUNS for this arch (bounded KV ring cache).

A copy of the JAX package's `configs/mixtral_8x7b.py`, field for field.
"""
from repro_torch.configs.base import ModelConfig, ATTN_SWA

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,                # per-expert hidden
    vocab_size=32000,
    block_pattern=(ATTN_SWA,),
    ffn_kind="swiglu",
    window=4096,
    num_experts=8,
    top_k=2,
    moe_d_ff=14336,
    rope_theta=1000000.0,
    fsdp=True,
    remat="dots",
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=(ATTN_SWA,),
    ffn_kind="swiglu",
    window=16,
    num_experts=4,
    top_k=2,
    moe_d_ff=256,
)
