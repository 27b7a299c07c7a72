"""StarCoder2-15B [arXiv:2402.19173] — dense, 40L, GQA kv=4, RoPE, GELU FFN.
A copy of the JAX package's `configs/starcoder2_15b.py`, field for field."""
from repro_torch.configs.base import ModelConfig, ATTN_FULL

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=(ATTN_FULL,),
    ffn_kind="gelu",            # StarCoder2 uses a plain (non-gated) GELU MLP
    rope_theta=100000.0,
    fsdp=True,
    remat="dots",
)

REDUCED = ModelConfig(
    name="starcoder2-15b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=320,
    vocab_size=512,
    block_pattern=(ATTN_FULL,),
    ffn_kind="gelu",
)
