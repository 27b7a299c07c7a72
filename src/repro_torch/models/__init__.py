"""The LM side of the port: the model zoo for the architectures that run
here (RecurrentGemma: RG-LRU and local attention, serving and training;
SmolLM: full attention over padded heads, training)."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, forward, init_decode_cache, init_params, layer_plan,
    loss_fn, param_count_exact,
)
