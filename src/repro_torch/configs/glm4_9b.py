"""GLM-4-9B [hf:THUDM/glm-4-9b] — dense, 40L, GQA kv=2, partial RoPE.
A copy of the JAX package's `configs/glm4_9b.py`, field for field."""
from repro_torch.configs.base import ModelConfig, ATTN_FULL

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
    rope_fraction=0.5,       # GLM applies rotary to half the head dims
    rope_theta=10000.0,
    fsdp=True,
    remat="dots",
)

REDUCED = ModelConfig(
    name="glm4-9b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
    rope_fraction=0.5,
)
