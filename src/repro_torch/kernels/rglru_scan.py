"""Launch wrapper for the hand-written CUDA kernel in `csrc/rglru_scan.cu`:
the RG-LRU linear recurrence h_t = a_t * h_{t-1} + gx_t of the Griffin
recurrent block, the prefill and training scan of every RG-LRU layer, and
its gradient (`rglru_scan_bwd`, the reverse scan, counted in
`rglru_scan_bwd.launches` and, by route, in
`rglru_scan_bwd.route_launches`).  The gradient's route is
`scan_bwd_route`: `tma` (a TMA-fed ring of time tiles in shared memory,
da and dgx written back by TMA stores, `scan_bwd_smem_bytes` a block)
when W * 4 bytes and the (B, T, W) operands' addresses are 16-byte
aligned, `direct` (a thread a channel, loads from global memory)
otherwise.  The wrapper launches on the route it computed
(`lotaru_rglru_scan_bwd_on_route`, which refuses a tma launch TMA cannot
take) and counts that route; a launch that fails on its route raises,
never retried on the other.  The C entry point `lotaru_rglru_scan_bwd`
chooses the same route from the same facts.

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
# the gradient's routes, by the C side's code (0, 1)
SCAN_BWD_ROUTES = ("direct", "tma")
SCAN_BWD_COLS = 32        # channels of a tma block (one consumer warp)
SCAN_BWD_ROWS = 64        # steps of a tile
SCAN_BWD_STAGES = 4       # tiles in the ring
SCAN_BWD_OUT_BUFS = 2     # staging buffers of da and dgx, a tile each


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_rglru_scan.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.lotaru_rglru_scan.restype = _I
    lib.lotaru_rglru_scan_bwd.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    lib.lotaru_rglru_scan_bwd.restype = _I
    lib.lotaru_rglru_scan_bwd_on_route.argtypes = [_I] + [_P] * 7 + [_I] * 3 \
        + [_P]
    lib.lotaru_rglru_scan_bwd_on_route.restype = _I
    lib.lotaru_rglru_scan_bwd_route.argtypes = [_I, _I]
    lib.lotaru_rglru_scan_bwd_route.restype = _I
    lib.lotaru_rglru_scan_bwd_smem_bytes.argtypes = [_I, _I]
    lib.lotaru_rglru_scan_bwd_smem_bytes.restype = _I
    return lib


def scan_bwd_route(width: int, aligned: bool) -> str:
    """The gradient's route: `tma` when a row of W float32 is a multiple
    of 16 bytes (TMA's rule for a global stride) and a, h, g, da and dgx
    all start on a 16-byte boundary (`aligned`, TMA's rule for a global
    address), else `direct` (`lotaru_rglru_scan_bwd_route` in the
    source)."""
    return "tma" if width > 0 and width * 4 % 16 == 0 and aligned \
        else "direct"


def scan_bwd_smem_bytes(width: int, aligned: bool) -> int:
    """Dynamic shared memory of a gradient block: on the tma route a ring
    of SCAN_BWD_STAGES stages, each a box of SCAN_BWD_COLS channels x
    SCAN_BWD_ROWS steps of a, g and h in float32, SCAN_BWD_OUT_BUFS
    staging buffers of a box of da and one of dgx, 128 bytes to align the
    boxes and 128 for the mbarriers; none on the direct route
    (`lotaru_rglru_scan_bwd_smem_bytes` in the source)."""
    if scan_bwd_route(width, aligned) == "direct":
        return 0
    box = SCAN_BWD_COLS * SCAN_BWD_ROWS * 4
    return (3 * SCAN_BWD_STAGES + 2 * SCAN_BWD_OUT_BUFS) * box + 256


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


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


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   g: torch.Tensor):
    """The scan's gradient: a, h (the forward's output) and g = dL/dh
    (B, T, W) float32, h0 (B, W) float32, all on one card -> (da, dgx
    (B, T, W), dh0 (B, W)) float32, bitwise equal to
    `ref.rglru_scan_bwd_ref` on either route (`scan_bwd_route`)."""
    dev = cuda_device(a, "a")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, T, W), got shape {tuple(a.shape)}")
    b, t, w = a.shape
    for name, x in (("a", a), ("h", h), ("g", g)):
        check(x, name, torch.float32, (b, t, w), dev)
    check(h0, "h0", torch.float32, (b, w), dev)
    da, dgx = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.zeros_like(h0)
    if da.numel() == 0:
        return da, dgx, dh0
    route = scan_bwd_route(w, aligned16(a, h, g, da, dgx))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_rglru_scan_bwd_on_route(
            SCAN_BWD_ROUTES.index(route), a.data_ptr(), h.data_ptr(),
            h0.data_ptr(), g.data_ptr(), da.data_ptr(), dgx.data_ptr(),
            dh0.data_ptr(), b, t, w, stream)
    raise_on(_lib(), rc, f"rglru_scan_bwd ({route})")
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.route_launches[route] += 1
    return da, dgx, dh0


rglru_scan_bwd.launches = 0
rglru_scan_bwd.route_launches = dict.fromkeys(SCAN_BWD_ROUTES, 0)
