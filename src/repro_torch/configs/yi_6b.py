"""Yi-6B [arXiv:2403.04652] — llama-arch dense, 32L, GQA kv=4.
A copy of the JAX package's `configs/yi_6b.py`, field for field."""
from repro_torch.configs.base import ModelConfig, ATTN_FULL

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
    rope_theta=5000000.0,
    fsdp=True,
    remat="dots",
)

REDUCED = ModelConfig(
    name="yi-6b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
)
