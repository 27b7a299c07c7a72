"""Launch wrappers for the hand-written CUDA kernels in
`csrc/decision_plane.cu`: the fused cost matrix of a planning round
(predictive -> factor scaling -> quantile shift) and the HEFT
insertion sweep of one workflow, both in float64.

Each wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its outputs and
scratch with `torch.empty`/`torch.zeros`, launches on PyTorch's current
stream, raises when the launch reports an error, and counts its launches
in a plain integer attribute (`fused_cost.launches`,
`eft_sweep.launches`) so a run can show that a path went through the
kernel.  The sweep has two routes, chosen by `sweep_route` from the
shapes and the device's shared-memory limit, and also counts its
launches per route (`eft_sweep.launches_by_route`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decision_plane")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_fused_cost.argtypes = ([_P] * 10 + [ctypes.c_longlong, _I,
                                                   ctypes.c_double, _I, _P])
    lib.lotaru_fused_cost.restype = _I
    lib.lotaru_eft_sweep.argtypes = ([_P] * 3 + [_I] + [_P] * 5
                                     + [_I] * 4 + [_P] * 7 + [_P])
    lib.lotaru_eft_sweep.restype = _I
    lib.lotaru_eft_sweep_smem_bytes.argtypes = [_I] * 4
    lib.lotaru_eft_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.lotaru_smem_optin.argtypes = [_I]
    lib.lotaru_smem_optin.restype = _I
    return lib


_COST_LEAVES = (("mu", (2,)), ("sigma", (2, 2)), ("beta_prec", ()),
                ("x_mu", ()), ("x_sd", ()), ("y_mu", ()), ("y_sd", ()))


def fused_cost(x: torch.Tensor, post: dict, factors: torch.Tensor,
               z: Optional[float] = None) -> torch.Tensor:
    """x: (T,) float64 CUDA tensor; post: posterior leaves of the T task
    rows (T, ...); factors: (T, N).  Returns the (T, N) float64 HEFT cost
    matrix max(mean, 1e-3) * f, plus z * (std * f) when z is neither None
    nor 0 — bitwise `store.compute.cost_matrix` over `store.compute.scale`
    of the predictive."""
    dev = cuda_device(x, "x")
    if x.dim() != 1 or factors.dim() != 2:
        raise ValueError(f"x must be (T,) and factors (T, N), got "
                         f"{tuple(x.shape)} and {tuple(factors.shape)}")
    t, n = factors.shape
    check(x, "x", torch.float64, (t,), dev)
    check(factors, "factors", torch.float64, (t, n), dev)
    for leaf, shape in _COST_LEAVES:
        check(post[leaf], leaf, torch.float64, (t,) + shape, dev)
    w = torch.empty((t, n), dtype=torch.float64, device=dev)
    if t * n == 0:
        return w
    has_z = z is not None and z != 0.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_fused_cost(
            x.data_ptr(), *(post[leaf].data_ptr() for leaf, _ in _COST_LEAVES),
            factors.data_ptr(), w.data_ptr(), t, n,
            float(z) if has_z else 0.0, int(has_z), stream)
    raise_on(_lib(), rc, "fused_cost")
    fused_cost.launches += 1
    return w


fused_cost.launches = 0


SWEEP_ROUTES = ("shared", "global")
SWEEP_SHARED_MAX_NODES = 512   # the shared route's block


def sweep_smem_bytes(t: int, n: int, s: int, d: int) -> int:
    """Dynamic shared memory of the sweep's shared route: the (S, N)
    begin and end stacks, a three-slot ring of each node's W and ready0
    cells and the argmin slots' eft, est and key in 8-byte words; the rank
    order, each step's count and compacted dependency terms and the slots'
    node in 4-byte words (`sweep_smem_bytes` in
    csrc/decision_plane.cu; the kernel also stages the (N, N) link rates
    and locality where they fit beside that)."""
    return 8 * (2 * s * n + 2 * 3 * n + 3 * 64) + 4 * (2 * t + t * d + 64)


def sweep_route(t: int, n: int, s: int, d: int, smem_optin: int) -> str:
    """"shared" for at most 512 nodes whose sweep state fits the
    `smem_optin` bytes of shared memory a block may opt in to; else
    "global" (stacks in device memory, a thread looping over nodes)."""
    if (n <= SWEEP_SHARED_MAX_NODES
            and sweep_smem_bytes(t, n, s, d) <= smem_optin):
        return "shared"
    return "global"


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of a card (232,448 bytes on
    an H100)."""
    return _lib().lotaru_smem_optin(device_index)


def eft_sweep(W: torch.Tensor, order_arr: torch.Tensor,
              dep_rows: torch.Tensor, gb8: torch.Tensor,
              ready0: torch.Tensor, avail: torch.Tensor, same: torch.Tensor,
              gbps_min: torch.Tensor, *, S: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One workflow's HEFT insertion sweep in one launch.

    Rows are topo positions: W, ready0 (T, N) float64; order_arr (T,)
    int32, the rows in rank order (-1 = a masked row); dep_rows (T, D)
    int32, -1 padded; gb8 (T,) float64 (output GB x 8); avail (N,) float64
    (node_available, 0 = free); same (N, N) bool and gbps_min (N, N)
    float64 (`sched.heft.comm_structure`).  S is the number of interval
    columns per node.  Returns (assign (T,) int32, est (T,), eft (T,),
    cnt (N,) int32); cnt.max() > S - 1 means the interval stacks
    overflowed and the caller must run again with a larger S.  The route
    is `sweep_route` of the shapes and the card: both are bitwise the
    plain sweep."""
    dev = cuda_device(W, "W")
    if W.dim() != 2 or dep_rows.dim() != 2:
        raise ValueError(f"W must be (T, N) and dep_rows (T, D), got "
                         f"{tuple(W.shape)} and {tuple(dep_rows.shape)}")
    t, n = W.shape
    d = dep_rows.shape[1]
    if n == 0 and t > 0:
        raise ValueError("a sweep over tasks needs at least one node")
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    f64, i32 = torch.float64, torch.int32
    for v, name, dtype, shape in (
            (W, "W", f64, (t, n)), (order_arr, "order_arr", i32, (t,)),
            (dep_rows, "dep_rows", i32, (t, d)), (gb8, "gb8", f64, (t,)),
            (ready0, "ready0", f64, (t, n)), (avail, "avail", f64, (n,)),
            (same, "same", torch.bool, (n, n)),
            (gbps_min, "gbps_min", f64, (n, n))):
        check(v, name, dtype, shape, dev)
    route = sweep_route(t, n, S, d, smem_optin(dev.index))
    # outputs carry a dump row T for masked tasks; scratch: each row's
    # arrival time at each node and, on the global route, the interval
    # stacks (S, N)
    cnt = torch.empty(n, dtype=i32, device=dev)
    assign = torch.zeros(t + 1, dtype=i32, device=dev)
    est = torch.zeros(t + 1, dtype=f64, device=dev)
    eft = torch.zeros(t + 1, dtype=f64, device=dev)
    if n == 0:
        return assign[:t], est[:t], eft[:t], cnt
    arr = torch.empty((t + 1, n), dtype=f64, device=dev)
    stacks = []
    if route == "global":
        stacks = [torch.empty((S, n), dtype=f64, device=dev),
                  torch.empty((S, n), dtype=f64, device=dev)]
    ptrs = [x.data_ptr() for x in stacks] or [None, None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_eft_sweep(
            W.data_ptr(), order_arr.data_ptr(), dep_rows.data_ptr(), d,
            gb8.data_ptr(), ready0.data_ptr(), avail.data_ptr(),
            same.data_ptr(), gbps_min.data_ptr(), t, n, S,
            SWEEP_ROUTES.index(route), *ptrs, arr.data_ptr(), cnt.data_ptr(),
            assign.data_ptr(), est.data_ptr(), eft.data_ptr(), stream)
    raise_on(_lib(), rc, f"eft_sweep ({route} route)")
    eft_sweep.launches += 1
    eft_sweep.launches_by_route[route] += 1
    return assign[:t], est[:t], eft[:t], cnt


eft_sweep.launches = 0
eft_sweep.launches_by_route = dict.fromkeys(SWEEP_ROUTES, 0)
