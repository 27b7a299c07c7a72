"""Launch wrapper for the hand-written CUDA kernel in `csrc/rglru_scan.cu`:
the RG-LRU linear recurrence h_t = a_t * h_{t-1} + gx_t of the Griffin
recurrent block, the prefill scan of every RG-LRU layer.

The wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its output with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in `rglru_scan.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_rglru_scan.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.lotaru_rglru_scan.restype = _I
    return lib


def rglru_scan(a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, gx: (B, T, W) float32; h0: (B, W) float32, all on one card ->
    h (B, T, W) float32, bitwise equal to `ref.rglru_scan_ref`."""
    dev = cuda_device(a, "a")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, T, W), got shape {tuple(a.shape)}")
    b, t, w = a.shape
    check(a, "a", torch.float32, (b, t, w), dev)
    check(gx, "gx", torch.float32, (b, t, w), dev)
    check(h0, "h0", torch.float32, (b, w), dev)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_rglru_scan(a.data_ptr(), gx.data_ptr(),
                                      h0.data_ptr(), h.data_ptr(), b, t, w,
                                      stream)
    raise_on(_lib(), rc, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
