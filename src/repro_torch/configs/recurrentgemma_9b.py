"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — RG-LRU + local attn, 1:2.

38 blocks cycling (recurrent, recurrent, local-attention) — i.e. one local
MQA attention block per two RG-LRU blocks.  Local attention window 2048,
MQA (kv=1), head_dim 256.  Sub-quadratic: long_500k RUNS for this arch.
"""
from repro_torch.configs.base import ModelConfig, BLK_RGLRU, ATTN_LOCAL

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=(BLK_RGLRU, BLK_RGLRU, ATTN_LOCAL),
    ffn_kind="swiglu",         # GeGLU in the paper; gated 3-matrix MLP
    window=2048,
    rglru_width=4096,
    conv_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    logits_softcap=30.0,
    fsdp=True,
    remat="dots",
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-reduced",
    family="hybrid",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=(BLK_RGLRU, BLK_RGLRU, ATTN_LOCAL),
    ffn_kind="swiglu",
    window=16,
    rglru_width=128,
    conv_width=4,
    tie_embeddings=True,
    embed_scale=True,
    logits_softcap=30.0,
)
