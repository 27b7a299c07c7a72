"""Architecture registry of the port: `get_config(arch)` and
`get_reduced_config(arch)` for the architectures the port runs
(RecurrentGemma-9B serves and trains, SmolLM-360M trains).  Any other architecture of the JAX package raises, saying that
it is not yet ported."""
from __future__ import annotations

from repro_torch.configs import recurrentgemma_9b, smollm_360m
from repro_torch.configs.base import (  # noqa: F401
    ATTN_FULL, ATTN_LOCAL, ATTN_MLA, ATTN_SWA, BLK_MLSTM, BLK_RGLRU,
    BLK_SLSTM, ModelConfig, replace,
)

_MODULES = {"recurrentgemma-9b": recurrentgemma_9b,
            "smollm-360m": smollm_360m}

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
