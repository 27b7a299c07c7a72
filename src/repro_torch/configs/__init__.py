"""Architecture registry of the port: `get_config(arch)` and
`get_reduced_config(arch)` for the architectures the port runs
(RecurrentGemma-9B, Yi-6B, GLM-4-9B, StarCoder2-15B, Mixtral-8x7B,
DeepSeek-V2-236B and xLSTM-125M serve and train; SmolLM-360M trains).
Any other architecture of the JAX package raises, saying that it is not
yet ported."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_236b, glm4_9b, mixtral_8x7b, recurrentgemma_9b, smollm_360m,
    starcoder2_15b, xlstm_125m, yi_6b,
)
from repro_torch.configs.base import (  # noqa: F401
    ATTN_FULL, ATTN_LOCAL, ATTN_MLA, ATTN_SWA, BLK_MLSTM, BLK_RGLRU,
    BLK_SLSTM, ModelConfig, replace,
)

_MODULES = {"recurrentgemma-9b": recurrentgemma_9b,
            "smollm-360m": smollm_360m,
            "yi-6b": yi_6b,
            "glm4-9b": glm4_9b,
            "starcoder2-15b": starcoder2_15b,
            "mixtral-8x7b": mixtral_8x7b,
            "deepseek-v2-236b": deepseek_v2_236b,
            "xlstm-125m": xlstm_125m}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not yet ported to repro_torch; "
                       f"ported: {ARCHS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED
