"""xLSTM-125M [arXiv:2405.04517] — alternating sLSTM + mLSTM blocks.

12 layers, d_model 768, 4 heads, no separate FFN (d_ff=0; the xLSTM blocks
carry their own up/down projections).  Fully recurrent → sub-quadratic:
long_500k RUNS for this arch.

A copy of the JAX package's `configs/xlstm_125m.py`, field for field.
"""
from repro_torch.configs.base import ModelConfig, BLK_MLSTM, BLK_SLSTM

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(BLK_MLSTM, BLK_SLSTM),
    ffn_kind="none",
    mlstm_chunk=128,
    mlstm_impl="chunked",   # matmul-based chunkwise-parallel (equivalent to
                            # the recurrent form; validated against it in tests)
    mlstm_proj_factor=2.0,
    slstm_proj_factor=1.5,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="xlstm-125m-reduced",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=256,
    block_pattern=(BLK_MLSTM, BLK_SLSTM),
    ffn_kind="none",
    mlstm_chunk=8,
    tie_embeddings=True,
)
