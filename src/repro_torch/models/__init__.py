"""The LM side of the port: the model zoo for the architectures that run
here (RecurrentGemma: RG-LRU and local attention; SmolLM, Yi, GLM-4 and
StarCoder2: full attention, SmolLM's over padded heads; Mixtral: sliding
window attention and a mixture of experts; DeepSeek-V2: multi-head latent
attention and a mixture of experts with shared experts; xLSTM: mLSTM and
sLSTM), serving and training."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, forward, init_decode_cache, init_params, layer_plan,
    loss_fn, param_count_exact,
)
