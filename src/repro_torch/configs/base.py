"""Model configuration dataclass, a copy of the JAX package's
`configs/base.py` (the port imports nothing of that package).

Every architecture is expressed as a frozen ``ModelConfig``.  Configs are
pure data; ``repro_torch.models`` interprets them.  The fields are the
reference's, so a config reads the same in both packages, even where the
port does not yet run what a field selects; one more, ``embed_scale``,
states what the reference's model reads from the config's name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Block kinds understood by repro.models.transformer
ATTN_FULL = "full"          # dense causal attention
ATTN_SWA = "swa"            # sliding-window causal attention
ATTN_LOCAL = "local"        # local attention (Griffin-style window)
ATTN_MLA = "mla"            # DeepSeek-V2 multi-head latent attention
BLK_RGLRU = "rglru"         # Griffin recurrent block (conv + RG-LRU)
BLK_MLSTM = "mlstm"         # xLSTM matrix-memory block
BLK_SLSTM = "slstm"         # xLSTM scalar-memory block (true recurrence)

RECURRENT_KINDS = (BLK_RGLRU, BLK_MLSTM, BLK_SLSTM)
ATTENTION_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL, ATTN_MLA)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- block pattern (cycled over layers) ---
    block_pattern: Tuple[str, ...] = (ATTN_FULL,)

    # --- ffn ---
    ffn_kind: str = "swiglu"         # swiglu | gelu | none
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # embeddings times sqrt(d_model) (Griffin)

    # --- attention details ---
    window: int = 0                  # sliding/local window (swa/local)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # partial rotary (GLM-4: 0.5)
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (t, h, w)
    logits_softcap: float = 0.0
    # pad query heads up to a multiple (zero weights + in-model head mask ->
    # exact model, shards on a 16-way tensor axis; see DESIGN.md)
    pad_heads_multiple: int = 0

    # --- cross attention (MusicGen text conditioning) ---
    cross_attn: bool = False
    num_cond_tokens: int = 0

    # --- MLA (DeepSeek-V2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # leading layers with a dense FFN
    dense_d_ff: int = 0              # their hidden size (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # --- recurrent blocks ---
    rglru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    mlstm_chunk: int = 128           # chunked-parallel mLSTM chunk length
    mlstm_impl: str = "scan"         # scan (paper-faithful) | chunked (perf)
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.5   # sLSTM block FFN factor (4/3 rounded)

    # --- modality frontend (stubbed: embeddings come from input_specs) ---
    frontend: str = "none"           # none | audio_frames | vision_patches
    num_vision_tokens: int = 0

    # --- training-time system knobs ---
    remat: str = "none"              # none | dots | full
    fsdp: bool = False               # ZeRO-3 parameter sharding over data axis
    # parallelism policy (see dist.sharding.make_rules):
    #   megatron — TP over 'model' (heads/ffn/vocab), DP over (pod,data) [baseline]
    #   fsdp     — pure ZeRO-3: batch over (pod,data,model), params fully sharded
    #   ep_fsdp  — EP over 'model' for experts, no dense TP, ZeRO-3 over 'data'
    parallelism: str = "megatron"
    # decode-time GQA without KV expansion (grouped einsum; perf variant)
    decode_grouped_gqa: bool = False
    int8_opt_state: bool = False     # 8-bit Adam m/v (block-wise scales)
    microbatches: int = 1            # gradient accumulation
    dtype: str = "bfloat16"
    scan_unroll: bool = False        # unroll layer scans (dry-run cost pass:
                                     # XLA's cost analysis counts while bodies
                                     # once, so costs are extracted unrolled)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_heads(self) -> int:
        m = self.pad_heads_multiple
        if m <= 0 or self.num_heads % m == 0:
            return self.num_heads
        return -(-self.num_heads // m) * m

    # ---- derived helpers -------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, cycling block_pattern over num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches models.init_params; used for
        roofline MODEL_FLOPS = 6*N*D and memory budgeting)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.layer_kinds():
            n += 2 * d  # pre-norms (attn/ffn) rms weights (approx; recurrent same)
            if kind in (ATTN_FULL, ATTN_SWA, ATTN_LOCAL):
                n += d * self.num_heads * hd          # q
                n += 2 * d * self.num_kv_heads * hd   # k,v
                n += self.num_heads * hd * d          # o
            elif kind == ATTN_MLA:
                n += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                    self.qk_rope_head_dim + self.qk_nope_head_dim)
                n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                n += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_head_dim + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d
            elif kind == BLK_RGLRU:
                w = self.rglru_width or d
                n += 2 * d * w + w * d                # in/gate/out projections
                n += self.conv_width * w + 3 * w      # conv + lru params
            elif kind == BLK_MLSTM:
                pd = int(d * self.mlstm_proj_factor)
                n += d * pd * 2 + pd * d              # up(x2: value+gate), down
                n += 3 * pd * pd // max(self.num_heads, 1) * 0  # qkv counted next
                n += 3 * pd * pd + 2 * pd             # qkv + i/f gates (approx)
            elif kind == BLK_SLSTM:
                n += 8 * d * d + int(d * self.slstm_proj_factor) * d * 2
            # ffn / moe
            if kind in ATTENTION_KINDS or kind == BLK_RGLRU:
                dense_here = (not self.is_moe)
                if self.is_moe:
                    li = 0  # handled below per-layer via index; approximate here
                if self.ffn_kind == "none":
                    pass
                elif dense_here:
                    mult = 3 if self.ffn_kind == "swiglu" else 2
                    n += mult * d * self.d_ff
        if self.is_moe:
            mult = 3 if self.ffn_kind == "swiglu" else 2
            kinds = self.layer_kinds()
            moe_layers = sum(1 for i, k in enumerate(kinds)
                             if k in ATTENTION_KINDS and i >= self.first_dense_layers)
            dense_layers = sum(1 for i, k in enumerate(kinds)
                               if k in ATTENTION_KINDS and i < self.first_dense_layers)
            n += moe_layers * (self.num_experts + self.num_shared_experts) * mult * d * self.moe_d_ff
            n += moe_layers * d * self.num_experts  # router
            n += dense_layers * mult * d * (self.dense_d_ff or self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top_k + shared)."""
        if not self.is_moe:
            return self.param_count()
        mult = 3 if self.ffn_kind == "swiglu" else 2
        kinds = self.layer_kinds()
        moe_layers = sum(1 for i, k in enumerate(kinds)
                         if k in ATTENTION_KINDS and i >= self.first_dense_layers)
        total = self.param_count()
        all_experts = moe_layers * (self.num_experts + self.num_shared_experts) * mult * self.d_model * self.moe_d_ff
        active = moe_layers * (self.top_k + self.num_shared_experts) * mult * self.d_model * self.moe_d_ff
        return total - all_experts + active


def replace(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
