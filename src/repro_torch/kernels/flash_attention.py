"""Launch wrapper for the hand-written CUDA kernels in
`csrc/flash_attention.cu`: causal attention with an optional sliding
window and grouped key-value heads, the prefill attention of every local
attention layer.  bfloat16 runs on the tensor cores, float32 on the CUDA
cores.

The wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its output with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in `flash_attention.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_flash_attention.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    lib.lotaru_flash_attention.restype = _I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd), H a multiple of K; one
    dtype, float32 or bfloat16; hd 64, 128 or 256; any Sq and Skv.  Query
    i sees key j when j <= i (causal) and j > i - window (window > 0).
    Returns (B, Sq, H, hd) in q's dtype, within the stated tolerance of
    `ref.attention_ref`."""
    dev = cuda_device(q, "q")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, want float32 or bfloat16")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads over {kh} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel takes {HEAD_DIMS}")
    check(q, "q", q.dtype, (b, sq, h, hd), dev)
    check(k, "k", q.dtype, (b, skv, kh, hd), dev)
    check(v, "v", q.dtype, (b, skv, kh, hd), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernel "
                             f"loads rows as 16-byte vectors)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, skv, h, kh, hd, int(causal),
            int(window), stream)
    raise_on(_lib(), rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
