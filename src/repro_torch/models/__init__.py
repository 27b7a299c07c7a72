"""The LM side of the port: the model zoo for the architectures whose
serving path runs here (RecurrentGemma: RG-LRU and local attention)."""
from repro_torch.models.transformer import (  # noqa: F401
    decode_step, forward, init_decode_cache, init_params, layer_plan,
    param_count_exact,
)
