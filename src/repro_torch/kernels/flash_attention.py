"""Launch wrappers for the hand-written CUDA kernels in
`csrc/flash_attention.cu`: causal attention with an optional sliding
window and grouped key-value heads, the prefill and training attention of
every attention layer.  Both passes take q and k of one head dim and v
of its own (`FWD_PAIRS` = `BWD_PAIRS`: 64, 128 and 256 for all three, and
DeepSeek-V2's expanded MLA, q and k 192 and v 128).  bfloat16 runs on the
tensor cores (a
warp-specialised block: a TMA producer and two `wgmma` consumers that share
each K/V tile), float32 on the CUDA cores.  With `with_lse=True` the
forward also returns each row's log-sum-exp, which `flash_attention_bwd`
takes (`csrc/flash_attention_bwd.cu`: dq, dk and dv, no atomics; bf16 on
the tensor cores through TMA-fed `wgmma` blocks, float32 on the CUDA
cores, `bwd_route`); it counts its launches in
`flash_attention_bwd.launches`, by route in
`flash_attention_bwd.route_launches` and by head-dim pair in
`flash_attention_bwd.pair_launches`.

The wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its output with
`torch.empty`, launches on PyTorch's current stream, raises when the launch
reports an error, and counts its launches in `flash_attention.launches`
and, by `flash_route`, in `flash_attention.route_launches`.

The bf16 kernel's shape arithmetic is mirrored here in plain Python, so
that the CPU tests reach it: `flash_smem_bytes` and `flash_stages` (its
shared memory), `flash_route` (which pairing its two consumers take) and
`flash_band`, `flash_tile_kind` and `flash_tile_plan` (the kv tiles a block
walks and what each consumer does with each); the backward's likewise:
`bwd_smem_bytes`, `bwd_stages`, `bwd_head_splits`, `bwd_scratch_floats`
and `flash_bwd_plan` (the query tiles a dK/dV block walks).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)     # one for q, k and v
# both passes' head-dim pairs (q and k, v): the equal pairs and MLA's
# expanded form
FWD_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
BWD_PAIRS = FWD_PAIRS
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
    lib.lotaru_flash_attention.argtypes = [_P] * 4 + [_I] * 10 + [_P, _P]
    lib.lotaru_flash_attention.restype = _I
    lib.lotaru_flash_smem_bytes.argtypes = [_I, _I, _I]
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
    lib.lotaru_flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 10 + [_P]
    lib.lotaru_flash_attention_bwd.restype = _I
    lib.lotaru_flash_bwd_smem_bytes.argtypes = [_I] * 4
    lib.lotaru_flash_bwd_smem_bytes.restype = _I
    lib.lotaru_flash_bwd_stages.argtypes = [_I] * 3
    lib.lotaru_flash_bwd_stages.restype = _I
    lib.lotaru_flash_bwd_head_splits.argtypes = [_I] * 7
    lib.lotaru_flash_bwd_head_splits.restype = _I
    lib.lotaru_flash_bwd_scratch_floats.argtypes = [_I] * 9
    lib.lotaru_flash_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


# the backward's routes: bf16 on the tensor cores (wgmma), float32 on the
# CUDA cores
BWD_ROUTES = ("wgmma", "cuda_cores")
# the CUDA-core route's tiles by q's head dim: (keys of a dK/dV block and
# of a dQ block's key tile, queries of a dQ block and of a dK/dV query tile)
BWD_TILES = {64: (64, 64), 128: (64, 32), 192: (32, 32), 256: (32, 32)}
BWD_ROW_FLOATS = 2 * BLOCK_Q    # a query tile's lse (base 2) and D rows
BWD_MAX_SPLITS = 4              # blocks a dK/dV group's heads split over
BWD_MAX_STAGES = 4
SMEM_OPTIN = 232448             # an H100 block's opt-in shared memory


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "cuda_cores"


def bwd_smem_bytes_at(hd: int, hd_v: int, which: int, stages: int) -> int:
    """The wgmma route's dynamic shared memory at the pair (hd, hd_v)
    with `stages` in its pass's ring (`dkdv_smem_at`, `dq_smem_at` in the
    source); `bwd_smem_bytes` at `bwd_stages`."""
    tiles = BLOCK_K * (hd + hd_v) * 2      # a K/Q tile and a V/dO tile
    rows = BWD_ROW_FLOATS * 4
    if which == 0:
        exchange = 0 if hd == 64 else BLOCK_K * BLOCK_Q * 4
        return ((bwd_block_keys(hd) // BLOCK_K + stages) * tiles
                + stages * rows + exchange + 1024 + 128)
    return (2 + stages) * tiles + 2 * rows + 1024 + 128


def bwd_stages(hd: int, which: int, hd_v: Optional[int] = None) -> int:
    """Stages of the wgmma route's rings at the pair (hd, hd_v), hd_v
    defaulting to hd: the most, up to 4, with which the pass fits a
    block's 232,448 bytes.  The dK/dV pass's Q/dO ring (which 0): two at
    hd 256, four below and at (192, 128); the dQ pass's K/V ring (which 1),
    beside both consumers' Q and dO: one at hd 256, three at (192, 128),
    four below (`ring_stages` in the source)."""
    hd_v = hd if hd_v is None else hd_v
    st = BWD_MAX_STAGES
    while st > 1 and bwd_smem_bytes_at(hd, hd_v, which, st) > SMEM_OPTIN:
        st -= 1
    return st


def bwd_smem_bytes(hd: int, which: int,
                   dtype: torch.dtype = torch.float32,
                   hd_v: Optional[int] = None) -> int:
    """Dynamic shared memory of the backward's dK/dV kernel (which 0) or
    dQ kernel (which 1) at the pair (hd, hd_v), hd_v defaulting to hd
    (`lotaru_flash_bwd_smem_bytes` in the source).  The wgmma route: bf16
    tiles of 64 rows, K and Q hd wide, V and dO hd_v (dK/dV: K and V of the
    block's keys, a ring of Q, dO and their 512 bytes of rows, and, above
    hd 64, the 16 KB P^T exchange; dQ: both consumers' Q, dO and rows, a
    ring of K and V), 1024 bytes to align the tiles to the swizzle and 128
    for the mbarriers.  The CUDA-core route: float32 tiles padded by 4
    (dK/dV: K and V transposed, Q and dO transposed and row-major, P and
    dS; dQ: Q, dO, K and V transposed, K row-major, dS), lse and D."""
    hd_v = hd if hd_v is None else hd_v
    if bwd_route(dtype, hd) == "wgmma":
        return bwd_smem_bytes_at(hd, hd_v, which,
                                 bwd_stages(hd, which, hd_v))
    bk, bq = BWD_TILES[hd]
    if which == 0:
        floats = ((hd + hd_v) * (bk + 4) + (hd + hd_v) * (bq + 4)
                  + bq * (hd + 4) + bq * (hd_v + 4) + 2 * bq * (bk + 4)
                  + 2 * bq)
    else:
        floats = ((hd + hd_v) * (bq + 4) + (hd + hd_v) * (bk + 4)
                  + bk * (hd + 4) + bk * (bq + 4) + 2 * bq)
    return 4 * floats


def bwd_block_keys(hd: int) -> int:
    """Keys of a wgmma-route dK/dV block at q's head dim hd: 128 at hd 64,
    where each consumer takes 64 of them and runs the whole chain, 64
    wider, where one consumer takes P and dV and the other dS and dK
    (`dkdv_keys` in the source)."""
    return 2 * BLOCK_K if hd == 64 else BLOCK_K


def bwd_head_splits(batch: int, skv: int, heads: int, kv_heads: int,
                    sms: int, hd: int) -> int:
    """Blocks over which the wgmma route's dK/dV pass splits a kv head's
    query heads, at q's head dim hd (the block's keys follow it): of 1 to
    min(4, group), the split that minimises waves of blocks x heads a
    block, the fewest on a tie.  MQA at B 1 (RecurrentGemma: 64 blocks,
    fewer than the SMs) splits; SmolLM's 640 blocks do not (`head_splits`
    in the source)."""
    n = batch * kv_heads * -(-skv // bwd_block_keys(hd))
    group = heads // kv_heads
    if n == 0 or sms <= 0:
        return 1
    best, best_cost = 1, -(-n // sms) * group
    for s in range(2, min(BWD_MAX_SPLITS, group) + 1):
        cost = -(-n * s // sms) * -(-group // s)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def bwd_scratch_floats(dtype: torch.dtype, batch: int, sq: int, skv: int,
                       heads: int, kv_heads: int, hd: int, sms: int,
                       hd_v: Optional[int] = None) -> int:
    """float32 elements of the backward's scratch at the pair (hd, hd_v),
    hd_v defaulting to hd: the wgmma route's rows (B, H, query tiles, 128:
    lse in base 2 and D, zeros past Sq) and, with head splits, the partial
    dV (splits, B, Skv, K, hd_v) and dK (splits, B, Skv, K, hd); the
    CUDA-core route's D (B, H, Sq) (`scratch_floats` in the source)."""
    hd_v = hd if hd_v is None else hd_v
    if bwd_route(dtype, hd) != "wgmma":
        return batch * heads * sq
    rows = batch * heads * -(-sq // BLOCK_Q) * BWD_ROW_FLOATS
    splits = bwd_head_splits(batch, skv, heads, kv_heads, sms, hd)
    return rows + (splits * batch * skv * kv_heads * (hd + hd_v)
                   if splits > 1 else 0)


def flash_bwd_plan(sq: int, skv: int, heads: int, kv_heads: int,
                   causal: bool, window: int, hd: int, splits: int = 1
                   ) -> List[Tuple[int, int, Tuple[int, ...],
                                   List[Tuple[int, str]]]]:
    """The wgmma route's dK/dV walk at q's head dim hd, the same for every
    batch and for any v head dim: for each
    block of `bwd_block_keys(hd)` keys, kv head and head split, and each
    64-key tile of the block with keys (one a consumer at hd 64), (its
    first key, kv head, the split's query heads, [(q0, kind), ...]): the
    64-row query tiles the block walks (those that may see a key of the
    block), each for every head of the split, with `flash_tile_kind`'s
    kind of the (query tile, key tile) box.  The dQ pass walks the
    forward's tiles (`flash_tile_plan`)."""
    group = heads // kv_heads
    keys = bwd_block_keys(hd)
    plan = []
    for k0 in range(0, skv, keys):
        k1 = min(k0 + keys, skv)
        q_first = k0 if causal else 0
        q_end = min(sq, k1 - 1 + window) if window > 0 else sq
        for kc in range(k0, k1, BLOCK_K):
            tiles = [(q0, flash_tile_kind(q0, min(q0 + BLOCK_Q, sq), kc,
                                          skv, causal, window))
                     for q0 in range(q_first, q_end, BLOCK_Q)]
            for kvh in range(kv_heads):
                for sp in range(splits):
                    hs = tuple(range(kvh * group + sp * group // splits,
                                     kvh * group + (sp + 1) * group
                                     // splits))
                    plan.append((kc, kvh, hs, tiles))
    return plan


def flash_stages(hd: int) -> int:
    """Stages of the bf16 kernel's K/V ring at q and k's head dim hd: two
    at hd = 256 (all that fits beside Q), four below (`flash_stages` in the
    source)."""
    return 2 if hd == 256 else 4


def flash_smem_bytes(hd: int, hd_v: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 kernel: Q for both consumers (64
    rows of hd bfloat16 each) and `stages` K tiles (64 x hd) and V tiles
    (64 x hd_v), plus 1024 bytes to start the tiles on the swizzle's
    1024-byte period and 128 for the mbarriers (`flash_smem_bytes` in the
    source)."""
    return (2 * hd + stages * (hd + hd_v)) * BLOCK_K * 2 + 1024 + 128


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


def _check_qkv(q, k, v, pairs):
    dev = cuda_device(q, "q")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, want float32 or bfloat16")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads over {kh} kv heads")
    if (hd, hd_v) not in pairs:
        raise ValueError(f"head dims {hd} (q, k) and {hd_v} (v): the kernel "
                         f"takes {pairs}")
    check(q, "q", q.dtype, (b, sq, h, hd), dev)
    check(k, "k", q.dtype, (b, skv, kh, hd), dev)
    check(v, "v", q.dtype, (b, skv, kh, hd_v), dev)
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{n} must start on 16 bytes (the kernel "
                             f"loads rows as 16-byte vectors or TMA boxes)")
    return dev, (b, sq, skv, h, kh, hd, hd_v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """q (B, Sq, H, hd); k (B, Skv, K, hd); v (B, Skv, K, hd_v), H a
    multiple of K; one dtype, float32 or bfloat16; (hd, hd_v) one of
    `FWD_PAIRS`; any Sq and Skv.  Query i sees key j when j <= i (causal)
    and j > i - window (window > 0); the scores are scaled by 1 / sqrt(hd).
    Returns (B, Sq, H, hd_v) in q's dtype, within the stated tolerance of
    `ref.attention_ref`; with `with_lse`, (out, lse): lse (B, H, Sq)
    float32, each row's log-sum-exp of its scaled scores (-inf for a row
    that sees no key)."""
    dev, (b, sq, skv, h, kh, hd, hd_v) = _check_qkv(q, k, v, FWD_PAIRS)
    out = q.new_empty((b, sq, h, hd_v))
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    route = flash_route(q.dtype, h, kh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, skv, h, kh, hd, hd_v, int(causal),
            int(window), lse.data_ptr() if with_lse else None, stream)
    raise_on(_lib(), rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.pair_launches[(hd, hd_v)] += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.pair_launches = dict.fromkeys(FWD_PAIRS, 0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """The gradient of `flash_attention` at (q, k, v), (hd, hd_v) one of
    `BWD_PAIRS`: o its output, do the gradient of o (both (B, Sq, H, hd_v)
    in q's dtype), lse (B, H, Sq) float32 from the forward's `with_lse` ->
    (dq, dk, dv) in q's dtype, within the stated tolerance of
    `ref.attention_bwd_ref`.  Deterministic: no atomics, two launches give
    bitwise equal results.  Its scratch (`bwd_scratch_floats`: the rows,
    and the dK/dV partials of a head split) is allocated here."""
    dev, (b, sq, skv, h, kh, hd, hd_v) = _check_qkv(q, k, v, BWD_PAIRS)
    check(o, "o", q.dtype, (b, sq, h, hd_v), dev)
    check(do, "do", q.dtype, (b, sq, h, hd_v), dev)
    check(lse, "lse", torch.float32, (b, h, sq), dev)
    for n, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{n} must start on 16 bytes")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0:
        return dq, dk, dv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    delta = torch.empty(bwd_scratch_floats(q.dtype, b, sq, skv, h, kh, hd,
                                           sms, hd_v),
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_lib().lotaru_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h,
            kh, hd, hd_v, int(causal), int(window), stream)
    raise_on(_bwd_lib(), rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[bwd_route(q.dtype, hd)] += 1
    flash_attention_bwd.pair_launches[(hd, hd_v)] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
flash_attention_bwd.pair_launches = dict.fromkeys(BWD_PAIRS, 0)
