"""Device selection for the port's entry points.

Every entry point takes an explicit `device` that defaults to "cuda".  A
CUDA device runs the hand-written kernels; "cpu" runs their plain PyTorch
versions.  Asking for a card where there is none raises: nothing falls
back to the CPU behind the caller's back."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but no CUDA card is "
                f"available; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"'cuda' or 'cpu'")
    return dev
