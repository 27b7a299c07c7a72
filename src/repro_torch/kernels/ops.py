"""Public entry points for the kernels, dispatched by the tensors' device:
a CUDA tensor launches the hand-written kernel (or the launch raises), a
CPU tensor takes the plain PyTorch version in `kernels.ref`.  There is no
fallback from one to the other: a caller that wants the plain version
hands over CPU tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import bayes_fit as _kernels
from repro_torch.kernels import ref


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def bayes_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
    """Batched MacKay evidence fit: (T, N) float32 x, y, mask -> posterior
    dict with leaves stacked over T."""
    if _route(x) == "cuda":
        return _kernels.bayes_fit(x, y, mask)
    return ref.bayes_fit_ref(x, y, mask)


def bayes_predict(x: torch.Tensor, post: dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched float64 posterior predictive: x (Q,), post leaves gathered
    per query (Q, ...) -> (mean, std) each (Q,).  Any Q: nothing is padded
    (the TPU form padded to a tile multiple to avoid recompiles, which
    eager launches never pay)."""
    if _route(x) == "cuda":
        return _kernels.bayes_predict(x, post)
    return ref.bayes_predict_ref(x, post)
