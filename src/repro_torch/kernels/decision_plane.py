"""Launch wrappers for the hand-written CUDA kernels in
`csrc/decision_plane.cu`, all in float64: the fused cost matrix of a
planning round (predictive -> factor scaling -> quantile shift), HEFT's
upward ranks of B workflows, and the HEFT insertion sweep of one workflow
(`eft_sweep`) or of B workflows on one cluster (`eft_sweep_many`, a block
a workflow; `eft_sweep` is the same kernel at B = 1).

The cost matrix takes one packed slab (`pack_cost`: the task rows in the
predictive's column groups, then the node corrections), copied up once,
and the static factor matrix, which its caller keeps on the card.

Each wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape and contiguity, allocates its outputs and
scratch with `torch.empty`/`torch.zeros`, launches on PyTorch's current
stream, raises when the launch reports an error, and counts its launches
in a plain integer attribute (`fused_cost.launches`,
`upward_rank.launches`, `eft_sweep.launches`, `eft_sweep_many.launches`)
so a run can show that a path went through the kernel.  The sweeps have
two routes, chosen by `sweep_route` from the shapes and the device's
shared-memory limit, and the ranks two, chosen by `rank_config` from the
shapes, the tables' alignment and the card; both also count their
launches per route (`.launches_by_route`).

The many-workflow kernels read each workflow's operands where they lie:
a lane table of device pointers (one row of int64 words a workflow) is
copied to the card once a launch, so nothing is stacked or padded but the
(B, T) rank order.  At B = 1 the lane goes by value in the launch's
parameters and no table is copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, staging
from repro_torch.kernels._launch import check, cuda_device, raise_on
from repro_torch.kernels.bayes_fit import (PackedBatch, check_slab,
                                           fill_slab, predict_slots)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decision_plane")
    lib.lotaru_error_string.argtypes = [_I]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_fused_cost.argtypes = [_P] * 3 + [_I] * 2 + [
        ctypes.c_double, _I, _P]
    lib.lotaru_fused_cost.restype = _I
    lib.lotaru_eft_sweep.argtypes = ([_P] * 3 + [_I] + [_P] * 5
                                     + [_I] * 4 + [_P] * 7 + [_P])
    lib.lotaru_eft_sweep.restype = _I
    lib.lotaru_eft_sweep_many.argtypes = ([_P, _I, _P, _I, _P, _P]
                                          + [_I] * 3 + [_P] * 6)
    lib.lotaru_eft_sweep_many.restype = _I
    lib.lotaru_upward_rank.argtypes = [_P, _P] + [_I] * 7 + [_P] * 4
    lib.lotaru_upward_rank.restype = _I
    lib.lotaru_eft_sweep_smem_bytes.argtypes = [_I] * 4
    lib.lotaru_eft_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.lotaru_smem_optin.argtypes = [_I]
    lib.lotaru_smem_optin.restype = _I
    return lib


class CostBatch(PackedBatch):
    """`fused_cost`'s operand on a device: one slab of the T task rows'
    queries in the predictive's column groups (`kernels.bayes_fit.
    slab_columns`; their destinations 0 and unused), then the N node
    corrections, 16-byte aligned.  Made by `pack_cost` alone."""

    __slots__ = ("slab", "t", "n")
    PACKER = "pack_cost"


def cost_slots(t: int, n: int) -> int:
    """float64 slots of a cost slab: T rows' column groups, then N
    corrections (the groups end on 16 bytes, `predict_slots`)."""
    return predict_slots(t) + n


def pack_cost(device, x, post, corr) -> CostBatch:
    """The operand of one `fused_cost` on `device`: the T = len(x) task
    rows' inputs and posterior leaves (`fill_slab`: a dict of (T, ...)
    leaves, or a callable that writes them, as the store's gather does)
    and the N node corrections `corr`, packed into one slab in host memory
    that `kernels.staging` sends up in one copy (pinned on a card)."""
    t, n = len(x), len(corr)
    with staging.staged(staging.resolve(device)) as st:
        buf = st.host(cost_slots(t, n))
        fill_slab(buf, t, x, post)
        buf[predict_slots(t):] = corr
        slab = st.send()
    return CostBatch._packed(slab, t, n)


def cost_slab(batch) -> torch.Tensor:
    """`batch`'s slab; raise unless `batch` is a CostBatch."""
    if not isinstance(batch, CostBatch):
        raise TypeError(f"fused_cost takes a CostBatch (pack_cost: the task "
                        f"rows and the node corrections packed together), "
                        f"got {type(batch).__name__}")
    return batch.slab


def check_cost(batch, base: torch.Tensor) -> torch.Tensor:
    """Raise unless `batch` is a CostBatch whose slab holds its rows and
    corrections and `base` its (T, N) float64 static factors on the same
    device, both on a 16-byte boundary; returns the slab."""
    slab = cost_slab(batch)
    t, n = batch.t, batch.n
    check_slab(slab, cost_slots(t, n), slab.device)
    check(base, "base", torch.float64, (t, n), slab.device)
    if base.numel() and base.data_ptr() % 16:
        raise ValueError("base must start on a 16-byte boundary")
    return slab


def cost_corr(batch: CostBatch) -> torch.Tensor:
    """A cost batch's N node corrections, as a view of its slab."""
    at = predict_slots(batch.t)
    return batch.slab[at:at + batch.n]


def fused_cost(batch: CostBatch, base: torch.Tensor,
               z: Optional[float] = None) -> torch.Tensor:
    """The (T, N) float64 HEFT cost matrix of the packed task rows of
    `batch` (`pack_cost`, on the card) and the resident (T, N) static
    factors `base`: with fc = base[i, j] * corr[j], max(mean_i, 1e-3) * fc,
    plus z * (std_i * fc) when z is neither None nor 0 -- bitwise
    `store.compute.cost_matrix` over `store.compute.scale` of the
    predictive and `TenantBinding.factor_matrix`.  Any T and N: a block
    takes 8 task rows and guards the ragged tail itself."""
    dev = cuda_device(check_cost(batch, base), "slab")
    t, n = batch.t, batch.n
    if t * n >= 1 << 31:
        raise ValueError(f"fused_cost takes fewer than 2**31 cells, got "
                         f"{t} x {n}")
    w = torch.empty((t, n), dtype=torch.float64, device=dev)
    if t * n == 0:
        return w
    has_z = z is not None and z != 0.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_fused_cost(
            batch.slab.data_ptr(), base.data_ptr(), w.data_ptr(), t, n,
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


def _lane_table(rows, dev: torch.device) -> torch.Tensor:
    """A (B, k) int64 table of device pointers and counts on `dev`: staged
    in pinned memory and copied without a synchronisation (the caching
    host allocator keeps the staging buffer until the copy has run)."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(dev, non_blocking=True)


def eft_sweep_many(W: Sequence[torch.Tensor], order_arr: torch.Tensor,
                   dep_rows: Sequence[torch.Tensor],
                   gb8: Sequence[torch.Tensor],
                   ready0: Sequence[torch.Tensor],
                   avail: Sequence[torch.Tensor], same: torch.Tensor,
                   gbps_min: torch.Tensor, *, S: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """B workflows' HEFT insertion sweeps on one cluster in one launch,
    lane b (thread block b) sweeping workflow b as `eft_sweep` does.

    order_arr (B, T) int32: lane b's rows in rank order, -1 for a masked
    step (so lanes of fewer tasks are padded with -1); lane b's entries
    are rows of its own operands.  Per lane, as sequences of B tensors:
    W[b], ready0[b] (T_b, N) float64 with T_b <= T; dep_rows[b] (T_b, D_b)
    int32, -1 padded; gb8[b] (T_b,) float64; avail[b] (N,) float64.  A
    (B, T, N) stack is such a sequence.  same (N, N) bool and gbps_min
    (N, N) float64 are shared by the lanes.  Returns (assign, est, eft)
    (B, T) and cnt (B, N) int32; cnt.max() > S - 1 means some lane's
    stacks overflowed.  Each lane has its own dump row, arrival rows and
    counts.  The route is `sweep_route` of (T, N, S, max D_b) and the
    card: "shared" is one launch of B blocks; "global" runs the lanes in
    turn, one global-route `eft_sweep` launch each, every one counted."""
    dev = cuda_device(order_arr, "order_arr")
    if order_arr.dim() != 2 or same.dim() != 2:
        raise ValueError(f"order_arr must be (B, T) and same (N, N), got "
                         f"{tuple(order_arr.shape)} and {tuple(same.shape)}")
    b, t = order_arr.shape
    n = same.shape[0]
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    f64, i32 = torch.float64, torch.int32
    lanes = (W, dep_rows, gb8, ready0, avail)
    if any(len(x) != b for x in lanes):
        raise ValueError(f"W, dep_rows, gb8, ready0 and avail must hold "
                         f"{b} lanes each, got {[len(x) for x in lanes]}")
    check(order_arr, "order_arr", i32, (b, t), dev)
    check(same, "same", torch.bool, (n, n), dev)
    check(gbps_min, "gbps_min", f64, (n, n), dev)
    d = 0
    for k in range(b):
        if W[k].dim() != 2 or dep_rows[k].dim() != 2:
            raise ValueError(f"lane {k}: W must be (T_b, N) and dep_rows "
                             f"(T_b, D_b)")
        tk, dk = W[k].shape[0], dep_rows[k].shape[1]
        if tk > t or (tk == 0 and t > 0):
            raise ValueError(f"lane {k} has {tk} task rows; a lane needs "
                             f"1 to {t} (T) of them")
        for v, name, dtype, shape in (
                (W[k], "W", f64, (tk, n)), (dep_rows[k], "dep_rows", i32,
                                            (tk, dk)),
                (gb8[k], "gb8", f64, (tk,)), (ready0[k], "ready0", f64,
                                              (tk, n)),
                (avail[k], "avail", f64, (n,))):
            check(v, f"{name}[{k}]", dtype, shape, dev)
        d = max(d, dk)
    if n == 0 and t > 0:
        raise ValueError("a sweep over tasks needs at least one node")
    route = sweep_route(t, n, S, d, smem_optin(dev.index))
    cnt = torch.empty((b, n), dtype=i32, device=dev)
    assign = torch.zeros((b, t + 1), dtype=i32, device=dev)
    est = torch.zeros((b, t + 1), dtype=f64, device=dev)
    eft = torch.zeros((b, t + 1), dtype=f64, device=dev)
    if n == 0:
        return assign[:, :t], est[:, :t], eft[:, :t], cnt
    arr = torch.empty((b, t + 1, n), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "shared":
            table = _lane_table(
                [[W[k].data_ptr(), ready0[k].data_ptr(),
                  dep_rows[k].data_ptr(), gb8[k].data_ptr(),
                  avail[k].data_ptr(), dep_rows[k].shape[1]]
                 for k in range(b)], dev)
            rc = _lib().lotaru_eft_sweep_many(
                table.data_ptr(), b, order_arr.data_ptr(), d,
                same.data_ptr(), gbps_min.data_ptr(), t, n, S,
                arr.data_ptr(), cnt.data_ptr(), assign.data_ptr(),
                est.data_ptr(), eft.data_ptr(), stream)
            raise_on(_lib(), rc, "eft_sweep_many (shared route)")
            eft_sweep_many.launches += 1
            eft_sweep_many.launches_by_route[route] += 1
        else:
            # the lanes in turn on the global route, which holds one
            # workflow's stacks in device scratch (reused: stream order)
            b0 = torch.empty((S, n), dtype=f64, device=dev)
            b1 = torch.empty((S, n), dtype=f64, device=dev)
            for k in range(b):
                rc = _lib().lotaru_eft_sweep(
                    W[k].data_ptr(), order_arr[k].data_ptr(),
                    dep_rows[k].data_ptr(), dep_rows[k].shape[1],
                    gb8[k].data_ptr(), ready0[k].data_ptr(),
                    avail[k].data_ptr(), same.data_ptr(),
                    gbps_min.data_ptr(), t, n, S, 1, b0.data_ptr(),
                    b1.data_ptr(), arr[k].data_ptr(), cnt[k].data_ptr(),
                    assign[k].data_ptr(), est[k].data_ptr(),
                    eft[k].data_ptr(), stream)
                raise_on(_lib(), rc, "eft_sweep_many (global route)")
                eft_sweep_many.launches += 1
                eft_sweep_many.launches_by_route[route] += 1
    return assign[:, :t], est[:, :t], eft[:, :t], cnt


eft_sweep_many.launches = 0
eft_sweep_many.launches_by_route = dict.fromkeys(SWEEP_ROUTES, 0)


class RankTable:
    """One DAG's operands of the upward rank that W does not move, rows in
    topo order: avg_comm (T,) float64, the average pairwise transfer time
    of each row's output; the successors as a CSR, row i's in
    succ_idx[succ_ptr[i]:succ_ptr[i + 1]] (int32); and the rows grouped by
    level, their height above the sinks (a sink is level 0, a row one
    above its highest successor), level l's in
    level_rows[level_ptr[l]:level_ptr[l + 1]] (int32).

    Checked once, where it is built or moved: dtypes, shapes, contiguity
    and one device for all five (and, on the CPU, that the CSRs end at E
    and T), so `upward_rank` checks only W against it; its fields cannot
    be rebound.  It unpacks as the five tensors in that order."""
    __slots__ = ("avg_comm", "succ_ptr", "succ_idx", "level_ptr",
                 "level_rows", "device", "T", "E", "L")

    def __init__(self, avg_comm: torch.Tensor, succ_ptr: torch.Tensor,
                 succ_idx: torch.Tensor, level_ptr: torch.Tensor,
                 level_rows: torch.Tensor):
        dev = avg_comm.device
        if (avg_comm.dim() != 1 or succ_idx.dim() != 1
                or level_ptr.dim() != 1 or level_ptr.shape[0] < 1):
            raise ValueError("avg_comm, succ_idx and level_ptr must be 1-D, "
                             "level_ptr of at least one entry")
        t, e, n_levels = (avg_comm.shape[0], succ_idx.shape[0],
                          level_ptr.shape[0] - 1)
        f64, i32 = torch.float64, torch.int32
        for v, name, dtype, shape in (
                (avg_comm, "avg_comm", f64, (t,)),
                (succ_ptr, "succ_ptr", i32, (t + 1,)),
                (succ_idx, "succ_idx", i32, (e,)),
                (level_ptr, "level_ptr", i32, (n_levels + 1,)),
                (level_rows, "level_rows", i32, (t,))):
            check(v, name, dtype, shape, dev)
        if dev.type == "cpu" and (int(succ_ptr[-1]) != e
                                  or int(level_ptr[-1]) != t):
            raise ValueError(f"the CSRs must end at E = {e} and T = {t}, "
                             f"got succ_ptr[-1] = {int(succ_ptr[-1])} and "
                             f"level_ptr[-1] = {int(level_ptr[-1])}")
        for name, v in zip(self.__slots__, (avg_comm, succ_ptr, succ_idx,
                                            level_ptr, level_rows, dev, t,
                                            e, n_levels)):
            object.__setattr__(self, name, v)

    def __setattr__(self, name, value):
        raise AttributeError("a RankTable is checked once: build a new one")

    def __iter__(self):
        return iter((self.avg_comm, self.succ_ptr, self.succ_idx,
                     self.level_ptr, self.level_rows))

    def to(self, device) -> "RankTable":
        return RankTable(*(x.to(device) for x in self))


def rank_table(succ_rows: Sequence[Sequence[int]],
               avg_comm: np.ndarray) -> RankTable:
    """The RankTable of a DAG on the CPU, from each topo row's successor
    rows (all later rows) and avg_comm (T,)."""
    t = len(succ_rows)
    ptr = np.zeros(t + 1, np.int64)
    ptr[1:] = np.cumsum([len(s) for s in succ_rows])
    idx = np.fromiter((s for ss in succ_rows for s in ss), np.int64,
                      count=int(ptr[-1]))
    height = np.zeros(t, np.int64)
    for i in range(t - 1, -1, -1):
        if len(succ_rows[i]):
            height[i] = 1 + max(height[s] for s in succ_rows[i])
    rows = np.argsort(height, kind="stable")
    per_level = np.bincount(height, minlength=1) if t else np.zeros(0,
                                                                    np.int64)
    level_ptr = np.concatenate([[0], np.cumsum(per_level)])
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return RankTable(torch.from_numpy(np.asarray(avg_comm, np.float64)),
                     as_i32(ptr), as_i32(idx), as_i32(level_ptr),
                     as_i32(rows))


RANK_ROUTES = ("shared", "global")
RANK_CLUSTERS = (1, 2, 4, 8, 16)   # 16 is a non-portable cluster size
RANK_DEFAULT_CLUSTER = 8
_RANK_HEAD = 128                   # two mbarriers, then a flag a block


def rank_layout(t: int, e: int, l: int) -> Tuple[int, ...]:
    """The shared route's leader's shared memory for T rows, E edges and
    L levels, as byte offsets (`RankSmem` in csrc/decision_plane.cu, which
    takes them as given): rank and avg_comm (8 bytes a row), succ_ptr,
    level_ptr, level_rows and succ_idx (4 bytes an entry), each 16-byte
    aligned past a head of _RANK_HEAD bytes, then the tables' end, where a
    W tile or the row descriptors start."""
    offsets = [_RANK_HEAD]
    for nbytes in (8 * t, 8 * t, 4 * (t + 1), 4 * (l + 1), 4 * t, 4 * e):
        offsets.append(offsets[-1] + ((nbytes + 15) & ~15))
    return tuple(offsets)


def rank_config(t: int, e: int, l: int, n: int, b: int, smem_optin: int,
                sm_count: int, aligned: bool = True,
                cluster: Optional[int] = None) -> dict:
    """The upward-rank launch for B lanes on N nodes whose largest lane has
    T rows, E edges and L levels, on a card with `smem_optin` bytes of
    opt-in shared memory a block and `sm_count` SMs; `aligned`: every
    lane's tables start on a 16-byte boundary.  The C entry point launches
    this shape as given.

    Route "shared" where the tables are aligned and they fit with one W
    row and with the leader's row descriptors (24 bytes a row): a cluster
    of `cluster` blocks a lane (default 8, halved while B x cluster
    exceeds the SMs), whose workers (every block but the leader, or the
    leader alone in a cluster of one) stage their share of W's rows in
    tiles of `tile_rows` (as few balanced tiles as fit beside the tables)
    at an odd stride; `smem_bytes` a block, laid out as `layout`
    (`rank_layout`).  Else route "global": a block a lane, the ranks in
    `smem_bytes` = 8 T of shared memory where that fits (else 0: in the
    output row)."""
    if cluster is not None and cluster not in RANK_CLUSTERS:
        raise ValueError(f"cluster must be one of {RANK_CLUSTERS}, got "
                         f"{cluster}")
    c = cluster
    if c is None:
        c = RANK_DEFAULT_CLUSTER
        while c > 1 and b * c > sm_count:
            c //= 2
    layout = rank_layout(t, e, l)
    tab = layout[-1]
    rows = max(1, -(-t // (c - 1 if c > 1 else 1)))
    described = 24 * t
    fits = tab + described <= smem_optin
    if n > 0 and fits:
        cap = (smem_optin - tab) // (8 * n)
        cap -= cap % 2 == 0
        fits = cap >= 1
        if fits:
            tiles = -(-rows // cap)
            rows = -(-rows // tiles)
    if aligned and fits:
        return dict(route="shared", cluster=c, tile_rows=rows,
                    tables_bytes=tab, layout=layout,
                    smem_bytes=tab + max(8 * n * (rows | 1), described))
    return dict(route="global", cluster=1, tile_rows=0, tables_bytes=0,
                layout=None, smem_bytes=8 * t if 8 * t <= smem_optin else 0)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def upward_rank(W: Sequence[torch.Tensor], tables: Sequence[RankTable]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HEFT's upward ranks of B workflows on one cluster in one launch: rank[i]
    = w_avg[i] + max(0, max over successors s of (avg_comm[i] +
    rank[s])), w_avg[i] = W[i].cumsum()[-1] / N (a left-to-right sum,
    then one division), as `_PlanContext.ranks`.

    W[b] (T_b, N) float64 and tables[b] (`RankTable`, checked when it was
    built) per lane; each call checks W and that each table lies on W's
    device.  Returns rank (B, T) float64, T = max T_b, with -inf past
    each lane's rows, and bad (B,) int32, 1 where the lane's W holds a NaN
    or infinite cell.  The route and cluster size are `rank_config`'s for
    the largest lane's shapes, the tables' alignment and the card; both
    routes are bitwise the plain version, and `launches_by_route` counts
    each."""
    b = len(W)
    if b == 0 or len(tables) != b:
        raise ValueError(f"upward_rank needs one table per lane and at "
                         f"least one lane, got {b} W and {len(tables)} "
                         f"tables")
    dev = cuda_device(W[0], "W[0]")
    f64 = torch.float64
    if W[0].dim() != 2:
        raise ValueError(f"W[0] must be (T_b, N), got {tuple(W[0].shape)}")
    n = W[0].shape[1]
    rows, misaligned = [], 0
    for k, (w, tab) in enumerate(zip(W, tables)):
        if not isinstance(tab, RankTable):
            raise TypeError(f"tables[{k}] must be a RankTable, got "
                            f"{type(tab).__name__}")
        if tab.device != dev:
            raise ValueError(f"tables[{k}] is on {tab.device}, want {dev}")
        check(w, f"W[{k}]", f64, (tab.T, n), dev)
        ptrs = [x.data_ptr() for x in tab]
        for p in ptrs:
            misaligned |= p & 15
        rows.append([w.data_ptr(), *ptrs, tab.T, tab.L])
    t, e, l = (max(getattr(tab, k) for tab in tables) for k in "TEL")
    cfg = rank_config(t, e, l, n, b, smem_optin(dev.index),
                      sm_count(dev.index), aligned=not misaligned)
    route = cfg["route"]
    rank = torch.empty((b, t), dtype=f64, device=dev)
    bad = torch.empty(b, dtype=torch.int32, device=dev)
    layout = (None if cfg["layout"] is None
              else np.asarray(cfg["layout"], np.int32))
    shape = (b, n, t, RANK_ROUTES.index(route), cfg["cluster"],
             cfg["tile_rows"], cfg["smem_bytes"],
             None if layout is None else layout.ctypes.data,
             rank.data_ptr(), bad.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if b == 1:          # the lane goes by value: no table to copy
            host = np.asarray(rows, np.int64)
            rc = _lib().lotaru_upward_rank(None, host.ctypes.data, *shape,
                                           stream)
        else:
            table = _lane_table(rows, dev)
            rc = _lib().lotaru_upward_rank(table.data_ptr(), None, *shape,
                                           stream)
    raise_on(_lib(), rc, f"upward_rank ({route} route)")
    upward_rank.launches += 1
    upward_rank.launches_by_route[route] += 1
    return rank, bad


upward_rank.launches = 0
upward_rank.launches_by_route = dict.fromkeys(RANK_ROUTES, 0)
