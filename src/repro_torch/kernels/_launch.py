"""Checks shared by the ctypes launch wrappers of the CUDA kernels."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`: the kernels take raw pointers and trust these."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors; {name} is on "
                         f"{t.device} (kernels.ops picks the plain version "
                         f"for CPU tensors)")
    return t.device


def raise_on(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a C entry point returned a CUDA error
    (`cudaGetLastError()` right after the launch)."""
    if rc != 0:
        msg = lib.lotaru_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
