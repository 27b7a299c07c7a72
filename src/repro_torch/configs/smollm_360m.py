"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small, GQA kv=5.
A copy of the JAX package's `configs/smollm_360m.py`, field for field."""
from repro_torch.configs.base import ModelConfig, ATTN_FULL

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    pad_heads_multiple=16,   # 15 -> 16 zero-padded heads (exact)
)

REDUCED = ModelConfig(
    name="smollm-360m-reduced",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=3,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=(ATTN_FULL,),
    ffn_kind="swiglu",
    tie_embeddings=True,
)
