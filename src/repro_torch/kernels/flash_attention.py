"""Launch wrappers for the hand-written CUDA kernels in
`csrc/flash_attention.cu`: causal attention with an optional sliding
window and grouped key-value heads, the prefill and training attention of
every attention layer.  bfloat16 runs on the tensor cores (a
warp-specialised block: a TMA producer and two `wgmma` consumers that share
each K/V tile), float32 on the CUDA cores.  With `with_lse=True` the
forward also returns each row's log-sum-exp, which `flash_attention_bwd`
takes (`csrc/flash_attention_bwd.cu`: dq, dk and dv, no atomics; bf16 on
the tensor cores through mma.sync, float32 on the CUDA cores,
`bwd_route`); it counts its launches in `flash_attention_bwd.launches`
and, by route, in `flash_attention_bwd.route_launches`.

The wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its output with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in `flash_attention.launches`
and, by `flash_route`, in `flash_attention.route_launches`.

The bf16 kernel's shape arithmetic is mirrored here in plain Python, so
that the CPU tests reach it: `flash_smem_bytes` and `flash_stages` (its
shared memory), `flash_route` (which pairing its two consumers take) and
`flash_band`, `flash_tile_kind` and `flash_tile_plan` (the kv tiles a block
walks and what each consumer does with each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
BLOCK_Q = 64        # query rows of a bf16 consumer
BLOCK_K = 64        # keys of a kv tile
# the bf16 kernel by the pairing of its two consumers, and the f32 kernel
ROUTES = ("wgmma_heads", "wgmma_tiles", "f32")
TILE_KINDS = ("skip", "full", "masked")   # tile_kind's 0, 1, 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_flash_attention.argtypes = [_P] * 4 + [_I] * 9 + [_P, _P]
    lib.lotaru_flash_attention.restype = _I
    lib.lotaru_flash_smem_bytes.argtypes = [_I, _I]
    lib.lotaru_flash_smem_bytes.restype = ctypes.c_longlong
    lib.lotaru_flash_stages.argtypes = [_I]
    lib.lotaru_flash_stages.restype = _I
    lib.lotaru_flash_tile_kind.argtypes = [_I] * 6
    lib.lotaru_flash_tile_kind.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 9 + [_P]
    lib.lotaru_flash_attention_bwd.restype = _I
    lib.lotaru_flash_bwd_smem_bytes.argtypes = [_I, _I, _I]
    lib.lotaru_flash_bwd_smem_bytes.restype = _I
    return lib


# the backward's routes: bf16 on the tensor cores (mma.sync), float32 on
# the CUDA cores
BWD_ROUTES = ("mma", "cuda_cores")
# the CUDA-core route's tiles by head dim: (keys of a dK/dV block and of
# a dQ block's key tile, queries of a dQ block and of a dK/dV query tile)
BWD_TILES = {64: (64, 64), 128: (64, 32), 256: (32, 32)}
BWD_MMA_ROWS = 64       # the mma route's rows, tiles and output columns


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    return "mma" if dtype == torch.bfloat16 else "cuda_cores"


def bwd_smem_bytes(hd: int, which: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of the backward's dK/dV kernel (which 0) or
    dQ kernel (which 1) (`lotaru_flash_bwd_smem_bytes` in the source).
    The mma route: bf16 tiles of 64 rows padded by 8 elements (dK/dV: K,
    V, Q, dO, and the block's 64 columns of Q and dO transposed; dQ: Q,
    dO, K, V, and 64 columns of K transposed), lse and D.  The CUDA-core
    route: float32 tiles padded by 4 (dK/dV: K and V transposed, Q and dO
    transposed and row-major, P and dS; dQ: Q, dO, K and V transposed, K
    row-major, dS), lse and D."""
    if bwd_route(dtype, hd) == "mma":
        r = BWD_MMA_ROWS
        tiles = 4 * r * (hd + 8) + (2 if which == 0 else 1) * r * (r + 8)
        return tiles * 2 + 512
    bk, bq = BWD_TILES[hd]
    if which == 0:
        floats = (2 * hd * (bk + 4) + 2 * hd * (bq + 4) + 2 * bq * (hd + 4)
                  + 2 * bq * (bk + 4) + 2 * bq)
    else:
        floats = (2 * hd * (bq + 4) + 2 * hd * (bk + 4) + bk * (hd + 4)
                  + bk * (bq + 4) + 2 * bq)
    return 4 * floats


def flash_stages(hd: int) -> int:
    """Stages of the bf16 kernel's K/V ring: two at hd = 256 (all that
    fits beside Q), four below (`flash_stages` in the source)."""
    return 2 if hd == 256 else 4


def flash_smem_bytes(hd: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 kernel: Q for both consumers and
    `stages` K and V tiles, each 64 rows of hd bfloat16, plus 1024 bytes
    to start the tiles on the swizzle's 1024-byte period and 128 for the
    mbarriers (`flash_smem_bytes` in the source)."""
    return (2 + 2 * stages) * BLOCK_K * hd * 2 + 1024 + 128


def flash_route(dtype: torch.dtype, heads: int, kv_heads: int) -> str:
    """The kernel a call takes: float32 the CUDA-core kernel; bfloat16 the
    wgmma kernel, whose two consumers take two query heads of one kv head
    over the same rows when H / K is even ("wgmma_heads"), else two
    consecutive 64-row query tiles of one head ("wgmma_tiles": MHA, an odd
    group)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma_heads" if (heads // kv_heads) % 2 == 0 else "wgmma_tiles"


def flash_band(q_lo: int, q_hi: int, skv: int, causal: bool,
               window: int) -> Tuple[int, int]:
    """The keys [lo, hi) that the query rows [q_lo, q_hi) may see."""
    lo = max(0, q_lo - window + 1) if window > 0 else 0
    hi = min(q_hi, skv) if causal else skv
    return lo, hi


def flash_tile_kind(q_lo: int, q_hi: int, j0: int, skv: int, causal: bool,
                    window: int, block_k: int = BLOCK_K) -> str:
    """What a consumer with query rows [q_lo, q_hi) does with the kv tile
    [j0, j0 + block_k), keys at or past skv counting as hidden: "skip"
    (every pair hidden), "full" (every pair visible: no per-element mask)
    or "masked" (the causal diagonal, the window edge or skv cuts it)."""
    if q_lo >= q_hi or j0 >= skv:
        return "skip"
    j_last = min(j0 + block_k, skv) - 1
    if causal and j0 > q_hi - 1:
        return "skip"
    if window > 0 and j_last <= q_lo - window:
        return "skip"
    full = (j_last == j0 + block_k - 1 and (not causal or j_last <= q_lo)
            and (window <= 0 or j0 > q_hi - 1 - window))
    return "full" if full else "masked"


def flash_tile_plan(sq: int, skv: int, causal: bool, window: int,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                    consumers: int = 1
                    ) -> List[Tuple[int, int, int, str]]:
    """The bf16 kernel's walk: for each block, which holds `consumers`
    consecutive query tiles of block_q rows (1 in the heads pairing, where
    both consumers read the same rows; 2 in the tiles pairing), the kv
    tiles j0 = lo, lo + block_k, ... < hi over the union of the tiles'
    bands, and for each consumer with rows, (q_lo, q_hi, j0, kind)."""
    plan = []
    for b0 in range(0, sq, block_q * consumers):
        rows = [(q, min(q + block_q, sq))
                for q in range(b0, min(b0 + block_q * consumers, sq),
                               block_q)]
        bands = [flash_band(a, z, skv, causal, window) for a, z in rows]
        lo, hi = min(x for x, _ in bands), max(y for _, y in bands)
        for j0 in range(lo, hi, block_k):
            plan += [(a, z, j0, flash_tile_kind(a, z, j0, skv, causal,
                                                window, block_k))
                     for a, z in rows]
    return plan


def _check_qkv(q, k, v):
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
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{n} must start on 16 bytes (the kernel "
                             f"loads rows as 16-byte vectors or TMA boxes)")
    return dev, (b, sq, skv, h, kh, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd), H a multiple of K; one
    dtype, float32 or bfloat16; hd 64, 128 or 256; any Sq and Skv.  Query
    i sees key j when j <= i (causal) and j > i - window (window > 0).
    Returns (B, Sq, H, hd) in q's dtype, within the stated tolerance of
    `ref.attention_ref`; with `with_lse`, (out, lse): lse (B, H, Sq)
    float32, each row's log-sum-exp of its scaled scores (-inf for a row
    that sees no key)."""
    dev, (b, sq, skv, h, kh, hd) = _check_qkv(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    route = flash_route(q.dtype, h, kh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, skv, h, kh, hd, int(causal),
            int(window), lse.data_ptr() if with_lse else None, stream)
    raise_on(_lib(), rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """The gradient of `flash_attention` at (q, k, v): o its output, do
    the gradient of o (both (B, Sq, H, hd) in q's dtype), lse (B, H, Sq)
    float32 from the forward's `with_lse` -> (dq, dk, dv) in q's dtype,
    within the stated tolerance of `ref.attention_bwd_ref`.  Deterministic:
    no atomics, two launches give bitwise equal results."""
    dev, (b, sq, skv, h, kh, hd) = _check_qkv(q, k, v)
    check(o, "o", q.dtype, (b, sq, h, hd), dev)
    check(do, "do", q.dtype, (b, sq, h, hd), dev)
    check(lse, "lse", torch.float32, (b, h, sq), dev)
    for n, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{n} must start on 16 bytes")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_lib().lotaru_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h,
            kh, hd, int(causal), int(window), stream)
    raise_on(_bwd_lib(), rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[bwd_route(q.dtype, hd)] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
