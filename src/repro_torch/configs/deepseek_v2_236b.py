"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora=512) + MoE 160e top-6.

60L, d_model 5120, 128 heads.  MLA: q_lora 1536, kv_lora 512, rope-dim 64,
nope-dim 128, v-dim 128.  MoE: 2 shared + 160 routed experts (top-6),
per-expert hidden 1536; first layer dense FFN (hidden 12288).

System knobs for the 236B scale: ZeRO-3 (fsdp) over the data axis, full
remat, int8 Adam states, gradient accumulation.

A copy of the JAX package's `configs/deepseek_v2_236b.py`, field for
field.
"""
from repro_torch.configs.base import ModelConfig, ATTN_MLA

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,              # v head dim (qk use rope+nope dims below)
    d_ff=1536,
    vocab_size=102400,
    block_pattern=(ATTN_MLA,),
    ffn_kind="swiglu",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    dense_d_ff=12288,
    rope_theta=10000.0,
    fsdp=True,
    remat="full",
    int8_opt_state=True,
    microbatches=8,
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-reduced",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    block_pattern=(ATTN_MLA,),
    ffn_kind="swiglu",
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_rope_head_dim=16,
    qk_nope_head_dim=32,
    v_head_dim=32,
    num_experts=8,
    num_shared_experts=1,
    top_k=2,
    moe_d_ff=64,
    first_dense_layers=1,
    dense_d_ff=256,
)
