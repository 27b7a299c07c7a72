"""HEFT placement on the card and the resident decision plane: the fused
decision plane, one workflow or a megabatch of them.

  * `cost_view` builds a round's (T, N) quantile cost matrix W in
    `dag.topo_order()` rows and cluster column order, on the service's
    device, from ONE `fused_cost` launch over one packed slab (the
    gathered posterior rows, the input sizes and the node corrections,
    one copy up) and the static factor matrix kept on the device.  It is
    bitwise `PredictionMatrix.from_service(...).costs(order, names,
    quantile)`.

  * `fused_heft_schedule` ranks and places off W.  It is bitwise
    `heft.heft_schedule_matrix` with either engine:
      - "numpy": host ranks, then the host sweep on flat (N, S)
        busy-interval arrays, one vectorized gap search over every node
        per task (the oracle);
      - "device": on `device`, ONE `upward_rank` launch (which also flags
        a non-finite W), the rank order as a stable sort of -rank, and the
        whole insertion sweep as ONE `eft_sweep` launch; W stays on the
        card and one copy brings the order and the placements back (the
        plain versions on "cpu");
      - "auto": "device" from `_DEVICE_MIN_CELLS` (T x N) cells up, by
        size alone.
    The rank terms that do not depend on W (the average pairwise comm per
    task, the successor and level tables) and the sweep's static arrays
    are kept per (dag, cluster) in the caller's `rank_cache`, on each
    device used, so a warm round pays only the W-dependent work.

  * `FusedPlane` keeps one workflow's decision plane resident on the
    service's device across rounds: the raw (factor-free) predictive rows,
    the static factor matrix, the scaled matrix and each quantile's W.  A
    round asks the store which blocks moved since the last one
    (`StoreSnapshot.rows_changed_since`) and re-predicts only those rows:
    gathered into one packed slab, copied up once, and through ONE
    `bayes_predict` launch that writes each row in place; the predictive
    is elementwise per row, so that is bitwise a full re-gather.  Scaling
    and the cost view are float64 torch ops on the
    device in `compute.scale` / `compute.cost_matrix` order, so its
    matrices are bitwise `PredictionMatrix.from_service`.  A round in
    which the store, the factors and the corrections did not move gathers
    nothing, launches no predictive, builds no factor matrix and makes no
    W; W's host copy is made only when an engine that reads it (the numpy
    engine) asks, and kept beside the device W under the same key.

  * `replan_many` replans B workflows (tenants) at once: the dirty rows
    of every plane in ONE slab and ONE `bayes_predict` launch, which
    writes each plane's rows where it keeps them, then, for each group of
    requests on one cluster, ONE `upward_rank` and ONE `eft_sweep_many`
    launch (a block a workflow).  Bitwise `plane.schedule(...)` per
    request.

Why the sweep is exact: the insertion policy keeps each node's busy
intervals non-overlapping and sorted, so interval ends are non-decreasing;
the candidate start before interval k is max(ready, end[k-1]) whatever the
earlier fit checks said, and the first k with `cand + dur <= begin[k]` is
the slot the reference's sequential walk returns.  max, min and compare
are exact in IEEE floats, and every arithmetic term (`cand + dur`,
`est + dur`, comm charges) is a single add or divide in the reference's
expression, so schedules match bitwise, not approximately.  The ranks use
only the reference's adds, one division and max, so they are bitwise too,
and a stable sort breaks their ties by topo row as `sorted` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.microbench import NodeSpec
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.bayes_fit import (PredictBatch, PredictTarget,
                                           pack_predict)
from repro_torch.kernels.decision_plane import pack_cost, rank_table
from repro_torch.sched.heft import Schedule, comm_structure
from repro_torch.sched.plane import PredictionMatrix, quantile_z
from repro_torch.store import compute
from repro_torch.workflow.dag import WorkflowDAG

__all__ = ["FusedPlane", "PlaneStats", "ReplanRequest", "cost_view",
           "fused_heft_schedule", "replan_many", "sync_planes"]

_NEG_INF = float("-inf")

# auto engine policy: below this many (task x node) cells the host sweep
# beats a launch plus the copies around it
_DEVICE_MIN_CELLS = 5000


class _PlanContext:
    """Per-(dag, cluster) invariants cached across planning rounds: the
    topo order and row maps, the pairwise comm structure, successor
    lists, the W-independent avg-comm rank terms and the rank kernel's
    successor and level tables, and the sweep's static arrays (dep rows,
    output bits), with their copies on each device used.  All of it is
    derived data — cached values are bitwise what a cold round
    recomputes, so warm and cold rounds schedule identically."""

    __slots__ = ("dag", "order", "row_of", "names", "same", "gbps_min",
                 "cluster", "succ", "avg_comm", "rank_table", "dep_rows",
                 "gb8", "slot_cap", "_on_device")

    def __init__(self, dag: WorkflowDAG, nodes: List[NodeSpec]):
        self.dag = dag      # strong ref: the cache key includes id(dag),
        # which stays unique only while the dag is alive
        self.order = dag.topo_order()
        self.row_of = {u: i for i, u in enumerate(self.order)}
        self.names = [n.name for n in nodes]
        self.same, self.gbps_min = comm_structure(nodes)
        # what groups replans onto one sweep launch: one comm structure
        self.cluster = (tuple(self.names), self.same.tobytes(),
                        self.gbps_min.tobytes())
        self.succ = dag.successors()
        n_nodes = len(nodes)
        self.avg_comm: Dict[str, float] = {}
        for u in self.order:
            gb = dag.tasks[u].output_gb
            terms = np.where(self.same, 0.0, (gb * 8.0) / self.gbps_min)
            self.avg_comm[u] = (float(terms.ravel().cumsum()[-1])
                                / (n_nodes ** 2))
        self.rank_table = rank_table(
            [[self.row_of[v] for v in self.succ[u]] for u in self.order],
            np.asarray([self.avg_comm[u] for u in self.order], np.float64))
        n_tasks = len(self.order)
        depth = max((len(dag.tasks[u].deps) for u in self.order), default=0)
        self.dep_rows = np.full((n_tasks, max(depth, 1)), -1, np.int32)
        for i, u in enumerate(self.order):
            for k, d in enumerate(dag.tasks[u].deps):
                self.dep_rows[i, k] = self.row_of[d]
        self.gb8 = np.asarray([dag.tasks[u].output_gb * 8.0
                               for u in self.order], np.float64)
        self.slot_cap = 48        # doubled on interval-stack overflow
        self._on_device: Dict[torch.device, dict] = {}

    def ranks(self, dag: WorkflowDAG, W: np.ndarray) -> Dict[str, float]:
        """Upward ranks off this round's W: the per-round halves only
        (w_avg cumsum + reverse-topo recurrence); avg_comm is cached."""
        n_nodes = len(self.names)
        w_avg_arr = (W.cumsum(axis=1)[:, -1] / n_nodes if n_nodes
                     else W.sum(1))
        rank: Dict[str, float] = {}
        avg_comm, succ, row_of = self.avg_comm, self.succ, self.row_of
        for u in reversed(self.order):
            best = 0.0
            for v in succ[u]:
                best = max(best, avg_comm[u] + rank[v])
            rank[u] = float(w_avg_arr[row_of[u]]) + best
        return rank

    def on_device(self, dev: torch.device) -> dict:
        """The rank tables and the sweep's static arrays on `dev`, copied
        once per device."""
        st = self._on_device.get(dev)
        if st is None:
            st = self._on_device[dev] = {
                "rank": self.rank_table.to(dev),
                "dep_rows": torch.from_numpy(self.dep_rows).to(dev),
                "gb8": torch.from_numpy(self.gb8).to(dev),
                "same": torch.from_numpy(self.same).to(dev),
                "gbps_min": torch.from_numpy(self.gbps_min).to(dev),
                "zeros": torch.zeros((len(self.order), len(self.names)),
                                     dtype=torch.float64, device=dev),
                "avail0": torch.zeros(len(self.names), dtype=torch.float64,
                                      device=dev)}
        return st


_CTX_CACHE_MAX = 32


def _context(dag: WorkflowDAG, nodes: List[NodeSpec],
             rank_cache: Optional[dict]) -> _PlanContext:
    if rank_cache is None:
        return _PlanContext(dag, nodes)
    key = (id(dag), len(dag.tasks), tuple(n.name for n in nodes))
    ctx = rank_cache.get(key)
    if ctx is None or ctx.dag is not dag:
        ctx = rank_cache[key] = _PlanContext(dag, nodes)
        while len(rank_cache) > _CTX_CACHE_MAX:    # bound replan-frontier
            rank_cache.pop(next(iter(rank_cache)))  # churn (FIFO evict)
    return ctx


class _SlotArrays:
    """Per-node busy intervals as flat (N, S) arrays: `b0`/`b1` are the
    interval begins/ends sorted by begin, `cnt` the live count per node.
    Padding is +inf / -inf so the vectorized gap search needs no masking:
    the +inf begin past the last interval always fits, and the -inf ends
    make the shifted `prev` ends a no-op under max."""

    __slots__ = ("b0", "b1", "cnt", "cap", "_prev", "_cand", "_tmp")

    def __init__(self, n_nodes: int, cap: int = 8):
        self.cap = cap
        self.b0 = np.full((n_nodes, cap), np.inf)
        self.b1 = np.full((n_nodes, cap), _NEG_INF)
        self.cnt = np.zeros(n_nodes, np.int64)
        self._prev = np.empty((n_nodes, cap))
        self._cand = np.empty((n_nodes, cap))
        self._tmp = np.empty((n_nodes, cap))

    def seed_available(self, avail: np.ndarray) -> None:
        """node_available entries > 0 enter as a [0, avail) busy prefix —
        same convention as the reference's slot lists."""
        busy = avail > 0.0
        self.b0[busy, 0] = 0.0
        self.b1[busy, 0] = avail[busy]
        self.cnt[busy] = 1

    def _grow(self) -> None:
        n, cap = self.b0.shape
        new_cap = cap * 2
        for name, fill in (("b0", np.inf), ("b1", _NEG_INF)):
            a = np.full((n, new_cap), fill)
            a[:, :cap] = getattr(self, name)
            setattr(self, name, a)
        self.cap = new_cap
        self._prev = np.empty((n, new_cap))
        self._cand = np.empty((n, new_cap))
        self._tmp = np.empty((n, new_cap))

    def earliest(self, ready: np.ndarray, dur: np.ndarray) -> np.ndarray:
        """The vectorized `_earliest_slot`: the earliest fitting start on
        every node at once, (N,)."""
        b0, b1 = self.b0, self.b1
        prev = self._prev
        prev[:, 0] = _NEG_INF
        prev[:, 1:] = b1[:, :-1]
        cand = np.maximum(ready[:, None], prev, out=self._cand)
        np.add(cand, dur[:, None], out=self._tmp)
        fits = self._tmp <= b0                     # +inf pad: always a fit
        ff = fits.argmax(axis=1)
        return cand[np.arange(cand.shape[0]), ff]

    def insert(self, j: int, est: float, eft: float) -> None:
        """Insert [est, eft) into node j's sorted intervals (the tuple
        (b0, b1) lexicographic order the reference's list.sort() keeps)."""
        c = int(self.cnt[j])
        if c + 1 >= self.cap:
            self._grow()      # keep >= 1 spare +inf column: the gap search
            # relies on the pad past the last interval always fitting
        b0r, b1r = self.b0[j], self.b1[j]
        pos = int(np.searchsorted(b0r[:c], est))
        while pos < c and b0r[pos] == est and b1r[pos] < eft:
            pos += 1                               # zero-length-interval ties
        if pos < c:
            b0r[pos + 1:c + 1] = b0r[pos:c].copy()
            b1r[pos + 1:c + 1] = b1r[pos:c].copy()
        b0r[pos] = est
        b1r[pos] = eft
        self.cnt[j] = c + 1


def _ready_rows(ctx: _PlanContext, dag: WorkflowDAG, nodes: List[NodeSpec],
                ready_at) -> Optional[np.ndarray]:
    """Materialize external ready-time constraints as a (T, N) array in
    topo-row order (None when unconstrained).  The callable form pays the
    same T x N calls the reference engine would have made."""
    if ready_at is None:
        return None
    if isinstance(ready_at, np.ndarray):
        rows = np.ascontiguousarray(ready_at, np.float64)
        want = (len(ctx.order), len(nodes))
        if rows.shape != want:
            raise ValueError(f"ready_at array must be {want}, got "
                             f"{rows.shape}")
        return rows
    if callable(ready_at):
        return np.asarray([[ready_at(u, n) for n in nodes]
                           for u in ctx.order], np.float64)
    col = np.asarray([ready_at.get(u, 0.0) for u in ctx.order], np.float64)
    return np.repeat(col[:, None], len(nodes), axis=1)


def cost_view(service, dag: WorkflowDAG, nodes: List[NodeSpec],
              quantile: Optional[float] = None) -> torch.Tensor:
    """The round's (T, N) float64 quantile cost matrix W, rows in
    `dag.topo_order()` and columns in `nodes` order, on `service.device`:
    the T task rows gathered by the store straight into one packed slab
    with their input sizes and the N node corrections (`pack_cost`, one
    copy up), then ONE `fused_cost` launch over it and the binding's
    static factor matrix, which stays resident on the device until a refit
    (`device_base_factors`).  Bitwise `PredictionMatrix.from_service(
    service, entries, nodes).costs(order, names, quantile)`."""
    order = dag.topo_order()
    names = [n.name for n in nodes]
    tasks = [dag.tasks[u].task_name for u in order]
    binding = service._binding
    binding.sync()
    snap = service.store.snapshot()
    keys = [binding.key_str(t) for t in tasks]
    x = np.asarray([dag.tasks[u].input_gb for u in order], np.float64)
    corr = binding.node_corrections(names)
    batch = pack_cost(service.device, x, lambda out: snap.gather(keys, out),
                      [corr.get(n, 1.0) for n in names])
    base = binding.device_base_factors(tasks, names, service.device)
    z = None if quantile is None else quantile_z(quantile)
    return ops.fused_cost(batch, base, z)


def _check_finite(ctx: _PlanContext, W: np.ndarray) -> None:
    """Refuse a cost matrix with a NaN or infinite cell.  The engines are
    bitwise `heft_schedule_matrix` only for finite costs: on a NaN row
    the reference HEFT, the numpy engine and the sweep each start the task
    at a different time."""
    bad = np.argwhere(~np.isfinite(W))
    if bad.size:
        i, j = (int(x) for x in bad[0])
        raise ValueError(f"cost W[{i}, {j}] (task {ctx.order[i]!r} on node "
                         f"{ctx.names[j]!r}) is {float(W[i, j])!r}: HEFT "
                         f"placement needs finite costs")


def fused_heft_schedule(dag: WorkflowDAG, nodes: List[NodeSpec],
                        matrix: Optional[PredictionMatrix],
                        ready_at=None,
                        node_available: Optional[Dict[str, float]] = None,
                        quantile: Optional[float] = None,
                        rank_cache: Optional[dict] = None,
                        engine: str = "auto",
                        W=None, device=DEFAULT_DEVICE) -> Schedule:
    """Fused-engine HEFT: bit-identical to `heft.heft_schedule_matrix`.

    `ready_at` additionally accepts a precomputed (T, N) array (rows in
    `dag.topo_order()` order) so replans can charge external dependency
    comm without T x N Python callbacks.  `rank_cache` is an optional
    dict the caller keeps across rounds; per-(dag, cluster) invariants are
    memoized in it.  `engine`: 'numpy' = host ranks and the flat-array
    host sweep; 'device' = one `upward_rank` and one `eft_sweep` launch on
    `device` ("cuda" by default; "cpu" runs their plain versions); 'auto'
    picks by problem size.  `W` overrides the cost matrix (topo-row order,
    a numpy array or a tensor such as `cost_view`'s), and then `matrix`
    may be None.  A W with a NaN or infinite cell raises ValueError naming
    the first bad cell: on the numpy engine before the ranks, on the
    device engine from the rank launch's flag, before any sweep launch."""
    ctx = _context(dag, nodes, rank_cache)
    if W is None:
        if matrix is None:
            raise ValueError("fused_heft_schedule needs a matrix or W")
        W = matrix.costs(ctx.order, ctx.names, quantile=quantile)  # (T, N)
    if isinstance(W, torch.Tensor):
        host = lambda: W.cpu().numpy()
    else:
        W = np.asarray(W, np.float64)
        host = lambda: W
    return _place(ctx, dag, nodes, W, host, ready_at, node_available,
                  engine, device)[0]


def _place(ctx: _PlanContext, dag: WorkflowDAG, nodes: List[NodeSpec], W,
           host, ready_at, node_available: Optional[Dict[str, float]],
           engine: str, device) -> Tuple[Schedule, int]:
    """Rank and place off W (a numpy array or a tensor); `host()` gives
    W's host copy, asked for only by the numpy engine -> (schedule,
    eft_sweep launches)."""
    if engine == "auto":
        cells = int(np.prod(W.shape))
        engine = "device" if cells >= _DEVICE_MIN_CELLS else "numpy"
    if engine == "device":
        dev = resolve_device(device)
        W_dev = torch.as_tensor(W, dtype=torch.float64).to(dev).contiguous()
        rank = _device_ranks([ctx], [W_dev])
        return _schedule_device(ctx, dag, nodes, W_dev, rank, ready_at,
                                node_available)
    if engine != "numpy":
        raise ValueError(f"engine must be 'auto', 'numpy' or 'device', "
                         f"got {engine!r}")
    W_host = host()
    _check_finite(ctx, W_host)
    rank = ctx.ranks(dag, W_host)
    return (_schedule_numpy(ctx, dag, nodes, W_host, rank, ready_at,
                            node_available), 0)


def _schedule_numpy(ctx: _PlanContext, dag: WorkflowDAG,
                    nodes: List[NodeSpec], W: np.ndarray,
                    rank: Dict[str, float], ready_at,
                    node_available: Optional[Dict[str, float]]) -> Schedule:
    order, names = ctx.order, ctx.names
    same, gbps_min = ctx.same, ctx.gbps_min
    n_nodes = len(nodes)
    sched = Schedule(order={name: [] for name in names})
    row_of = ctx.row_of
    slots = _SlotArrays(n_nodes)
    if node_available:
        slots.seed_available(np.asarray(
            [node_available.get(name, 0.0) for name in names], np.float64))

    ready_rows = _ready_rows(ctx, dag, nodes, ready_at)
    finish: Dict[str, float] = {}
    assign_idx: Dict[str, int] = {}
    zeros = np.zeros(n_nodes)

    for u in sorted(order, key=lambda u: -rank[u]):
        t = dag.tasks[u]
        i = row_of[u]
        ready = zeros.copy() if ready_rows is None else ready_rows[i].copy()
        for d in t.deps:
            dn = assign_idx[d]
            comm = np.where(same[dn], 0.0,
                            (dag.tasks[d].output_gb * 8.0) / gbps_min[dn])
            np.maximum(ready, finish[d] + comm, out=ready)
        dur = W[i]
        est = slots.earliest(ready, dur)
        eft = est + dur
        j = int(np.argmin(eft))
        est_j, eft_j = float(est[j]), float(eft[j])
        slots.insert(j, est_j, eft_j)
        name = names[j]
        sched.assignment[u] = name
        sched.order[name].append(u)
        sched.est[u] = (est_j, eft_j)
        finish[u] = eft_j
        assign_idx[u] = j
    for name in sched.order:
        sched.order[name].sort(key=lambda u: sched.est[u][0])
    return sched


def _device_ranks(ctxs: Sequence[_PlanContext],
                  Ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The upward ranks of B workflows on one device in ONE `upward_rank`
    launch -> (B, T), -inf past each workflow's rows.  The launch also
    flags a W that holds a NaN or infinite cell; the flags are read here,
    once, before any sweep, and a flagged W raises `_check_finite`'s
    ValueError naming its first bad cell."""
    dev = Ws[0].device
    rank, bad = ops.upward_rank(Ws, [c.on_device(dev)["rank"] for c in ctxs])
    for k in torch.nonzero(bad.cpu()).flatten().tolist():
        _check_finite(ctxs[k], Ws[k].cpu().numpy())
    return rank


def _rank_order(rank: torch.Tensor) -> torch.Tensor:
    """(B, T) ranks -> each workflow's rows in rank order, int32: a stable
    sort of -rank, which is `np.argsort(-rank, kind="stable")` and
    `sorted(order, key=-rank)` (ties keep topo order); the -inf pads sort
    last and become -1, a masked step.  The reference sorts on the host,
    so this sort stands in for no TPU kernel."""
    neg, order = torch.sort(-rank, dim=-1, stable=True)
    return torch.where(neg == float("inf"), -1, order).to(torch.int32)


def _sweep_inputs(ctx: _PlanContext, dag: WorkflowDAG,
                  nodes: List[NodeSpec], ready_at,
                  node_available: Optional[Dict[str, float]]):
    """One replan's external constraints on the host: the (T, N) ready
    times (None when unconstrained) and the per-node available times (None
    when no node is busy).  Nothing is padded: the TPU form padded T to a
    bucket to reuse one compiled sweep."""
    ready0 = _ready_rows(ctx, dag, nodes, ready_at)
    avail = None
    if node_available:
        avail = np.asarray([node_available.get(name, 0.0)
                            for name in ctx.names], np.float64)
    return ready0, avail


def _build_schedule(ctx: _PlanContext, order_arr: np.ndarray,
                    assign: np.ndarray, est: np.ndarray,
                    eft: np.ndarray) -> Schedule:
    """Rehydrate a `Schedule` from the sweep's flat outputs, visiting
    tasks in rank order (the order the reference appends in) so per-node
    lists tie-break identically before the final est sort."""
    n_tasks = len(ctx.order)
    sched = Schedule(order={name: [] for name in ctx.names})
    order, names = ctx.order, ctx.names
    for t in range(len(order_arr)):
        i = int(order_arr[t])
        if i < 0 or i >= n_tasks:
            continue
        u = order[i]
        name = names[int(assign[i])]
        sched.assignment[u] = name
        sched.order[name].append(u)
        sched.est[u] = (float(est[i]), float(eft[i]))
    for name in sched.order:
        sched.order[name].sort(key=lambda u: sched.est[u][0])
    return sched


def _schedule_device(ctx: _PlanContext, dag: WorkflowDAG,
                     nodes: List[NodeSpec], W: torch.Tensor,
                     rank: torch.Tensor, ready_at,
                     node_available: Optional[Dict[str, float]]
                     ) -> Tuple[Schedule, int]:
    """One workflow placed off its (1, T) device ranks -> (schedule,
    eft_sweep launches: more than one after a slot retry)."""
    scheds, launches = _sweep_lanes(
        [ctx], [W], rank, [_sweep_inputs(ctx, dag, nodes, ready_at,
                                         node_available)])
    return scheds[0], launches


def _sweep_lanes(ctxs: Sequence[_PlanContext], Ws: Sequence[torch.Tensor],
                 rank: torch.Tensor, inputs: Sequence[tuple]
                 ) -> Tuple[List[Schedule], int]:
    """Place B workflows on one cluster off their (B, T) device ranks:
    the rank order, then ONE sweep launch for all of them (`eft_sweep` at
    B = 1, `eft_sweep_many` above), run again at twice the interval
    columns while any workflow's stacks overflow, which raises every
    context's slot_cap.  `inputs` holds each workflow's `_sweep_inputs`.
    One copy brings the order, the placements and the counts back.
    -> (schedules, sweep launches)."""
    dev = Ws[0].device
    order = _rank_order(rank)
    sts = [c.on_device(dev) for c in ctxs]
    ready0 = [st["zeros"] if r is None else torch.from_numpy(r).to(dev)
              for st, (r, _) in zip(sts, inputs)]
    avail = [st["avail0"] if a is None else torch.from_numpy(a).to(dev)
             for st, (_, a) in zip(sts, inputs)]
    dep_rows = [st["dep_rows"] for st in sts]
    gb8 = [st["gb8"] for st in sts]
    same, gbps_min = sts[0]["same"], sts[0]["gbps_min"]
    launches = 0
    while True:
        S = max(c.slot_cap for c in ctxs)
        if len(ctxs) == 1:
            out = ops.eft_sweep(Ws[0], order[0], dep_rows[0], gb8[0],
                                ready0[0], avail[0], same, gbps_min, S=S)
            out = [x[None] for x in out]
        else:
            out = ops.eft_sweep_many(Ws, order, dep_rows, gb8, ready0, avail,
                                     same, gbps_min, S=S)
        launches += 1
        o, assign, est, eft, cnt = _fetch(order, *out)
        if cnt.size == 0 or cnt.max() <= S - 1:
            break
        # interval stacks overflowed: the gap search needs >= 1 spare pad
        # column per node — run again larger
        for c in ctxs:
            c.slot_cap = max(c.slot_cap, S * 2)
    return [_build_schedule(c, o[b], assign[b], est[b], eft[b])
            for b, c in enumerate(ctxs)], launches


def _fetch(order: torch.Tensor, assign: torch.Tensor, est: torch.Tensor,
           eft: torch.Tensor, cnt: torch.Tensor) -> List[np.ndarray]:
    """The sweep's (B, T) order, assign, est, eft and (B, N) counts on the
    host in ONE copy (the int32 columns ride as float64, exactly)."""
    t = order.shape[1]
    f64 = torch.float64
    host = torch.cat([order.to(f64), assign.to(f64), est, eft, cnt.to(f64)],
                     dim=1).cpu().numpy()
    o, a, e, f, c = np.split(host, [t, 2 * t, 3 * t, 4 * t], axis=1)
    return [o.astype(np.int64), a.astype(np.int64), e, f, c]


# ---------------------------------------------------------------------------
# resident prediction plane
# ---------------------------------------------------------------------------

@dataclass
class PlaneStats:
    """Residency telemetry: how much work each round actually did."""
    rounds: int = 0
    full_gathers: int = 0          # complete (re)builds of the row stack
    rows_refreshed: int = 0        # dirty rows re-gathered + re-predicted
    predict_dispatches: int = 0    # bayes_predict launches carrying this
    # plane's rows (one a dirty round; a megabatch's one launch counts on
    # every plane it refreshed, as the reference counts)
    matrix_rebuilds: int = 0       # scaled-view recomputations
    cost_rebuilds: int = 0         # (T, N) quantile cost-view recomputations
    sweep_dispatches: int = 0      # sweep launches (a megabatch: one a
    # request, whatever its slot retries, as the reference counts)


class FusedPlane:
    """One workflow's slice of the decision plane, resident on
    `service.device` across planning rounds (see module docstring).

    `entries` are (uid, task_name, input_gb) triples, or `dag` gives them.
    `matrix()` serves the scaled host `PredictionMatrix`, copied back only
    when rows, factors or corrections moved; `cost_view` the (T, N)
    quantile cost matrix on the device; `schedule` one replan round.
    `w_host_copies` counts the host copies of W made (by the numpy
    engine's asks): a device round makes none."""

    def __init__(self, service, nodes: Sequence[NodeSpec],
                 entries: Optional[Sequence[Tuple[str, str, float]]] = None,
                 dag: Optional[WorkflowDAG] = None):
        if entries is None:
            if dag is None:
                raise ValueError("FusedPlane needs `entries` or a `dag`")
            entries = [(u, dag.tasks[u].task_name, dag.tasks[u].input_gb)
                       for u in dag.tasks]
        self.service = service
        self.device = service.device
        self.nodes = list(nodes)
        self.node_names = [n.name for n in self.nodes]
        self.entries = [(u, t, float(gb)) for u, t, gb in entries]
        self.uids: Tuple[str, ...] = tuple(u for u, _, _ in self.entries)
        self._tasks = [t for _, t, _ in self.entries]
        self._x = np.asarray([gb for _, _, gb in self.entries], np.float64)
        self._keys = [service._binding.key_str(t) for t in self._tasks]
        self.stats = PlaneStats()
        self.rank_cache: dict = {}
        # resident state, on self.device
        self._rows: Optional[PredictTarget] = None       # the two below
        self._mean_raw: Optional[torch.Tensor] = None   # (T,) factor-free
        self._std_raw: Optional[torch.Tensor] = None
        self._generation = -1          # store generation the rows reflect
        self._base_f: Optional[torch.Tensor] = None     # (T, N) static
        self._base_f_version: Optional[int] = None
        self._scaled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._matrix: Optional[PredictionMatrix] = None  # its host copy
        self._matrix_key = None
        # the scaled pair reindexed to one dag's topo order, and per
        # quantile W on the device off it, with W's host copy once asked
        self._view: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._view_key = None
        self._cost_cache: Dict[Optional[float], torch.Tensor] = {}
        self._host_cache: Dict[Optional[float], np.ndarray] = {}
        self.w_host_copies = 0

    @property
    def binding(self):
        return self.service._binding

    @property
    def last_matrix(self) -> Optional[PredictionMatrix]:
        """The host `PredictionMatrix` of the latest round (None before
        the first)."""
        return self._matrix

    # ---- dirty-row sync ----------------------------------------------------
    def collect_dirty(self):
        """Sync the binding, snapshot the store, and return
        (snapshot, dirty row indices as a numpy array): the rows whose
        backing blocks moved since this plane's last gather (all rows on
        first use)."""
        self.binding.sync()
        snap = self.service.store.snapshot()
        if self._mean_raw is None:
            idx = np.arange(len(self._keys))
            self.stats.full_gathers += 1
        elif snap.generation == self._generation:
            idx = np.empty(0, np.int64)
        else:
            dirty = snap.rows_changed_since(self._keys, self._generation)
            idx = np.nonzero(dirty)[0]
        return snap, idx

    def _resident_rows(self) -> PredictTarget:
        """The resident raw rows, allocated on first use as the target the
        predictive writes into."""
        if self._mean_raw is None:
            self._rows = PredictTarget(len(self._keys), self.device)
            self._mean_raw, self._std_raw = self._rows.mean, self._rows.std
        return self._rows

    def gather_rows(self, snap, idx: np.ndarray) -> PredictBatch:
        """The rows `idx` as the predictive reads them on the device, ready
        for `ops.bayes_predict`: the rows packed on the host with their
        destination in this plane's resident rows and copied once
        (`_gather_many` over this plane alone)."""
        return _gather_many([(self, snap, idx)], self.device)

    def apply_rows(self, snap, idx) -> None:
        """Adopt the snapshot's generation after the rows `idx` were
        re-predicted into the resident rows (the predictive writes them in
        place).  The predictive is elementwise per row, so those values
        are bitwise what a full re-gather would put there."""
        self._resident_rows()
        self.stats.rows_refreshed += len(idx)
        self._generation = snap.generation

    def sync(self) -> int:
        """One round's resident-row maintenance: the dirty rows gathered
        and re-predicted in one `bayes_predict` launch that writes them
        into the resident rows.  Returns the number of rows refreshed."""
        snap, idx = self.collect_dirty()
        if len(idx):
            ops.bayes_predict(self.gather_rows(snap, idx))
            self.stats.predict_dispatches += 1
        self.apply_rows(snap, idx)
        return len(idx)

    # ---- scaled matrix view ------------------------------------------------
    def matrix(self) -> PredictionMatrix:
        """The round's scaled (T, N) `PredictionMatrix`: resident raw rows
        x (static factor matrix x streaming node corrections), bitwise
        `PredictionMatrix.from_service`.  Cached until rows, factors or
        corrections move."""
        self.stats.rounds += 1
        self.sync()
        return self._scale()

    def _scale(self) -> PredictionMatrix:
        binding = self.binding
        if self._base_f is None \
                or binding.factor_version != self._base_f_version:
            f = binding.base_factor_matrix(self._tasks, self.node_names)
            self._base_f = torch.from_numpy(np.ascontiguousarray(
                f, np.float64).reshape(len(self._tasks),
                                       len(self.node_names))).to(self.device)
            self._base_f_version = binding.factor_version
        corr_map = binding.node_corrections(self.node_names)
        corr = tuple(corr_map.get(n, 1.0) for n in self.node_names)
        key = (self._generation, self._base_f_version, corr)
        if self._matrix is None or key != self._matrix_key:
            f = self._base_f * torch.tensor(corr, dtype=torch.float64,
                                            device=self.device)[None, :]
            mean, std = compute.scale(self._mean_raw[:, None],
                                      self._std_raw[:, None], f)
            self._scaled = (mean, std)
            self._matrix = PredictionMatrix(self.uids, self.node_names,
                                            mean.cpu().numpy(),
                                            std.cpu().numpy())
            self._matrix_key = key
            self.stats.matrix_rebuilds += 1
        return self._matrix

    # ---- resident cost view ------------------------------------------------
    def cost_view(self, dag: WorkflowDAG, quantile: Optional[float]
                  ) -> Tuple[PredictionMatrix, torch.Tensor]:
        """(matrix, W): the (T, N) quantile cost matrix in `dag`'s topo
        order on the device, resident across rounds (same expressions as
        `PredictionMatrix.costs`, hence bitwise-equal schedules)."""
        mat = self.matrix()
        return mat, self._costs(dag, quantile)

    def _costs(self, dag: WorkflowDAG, quantile: Optional[float]
               ) -> torch.Tensor:
        """W on the device off the current scaled pair, rebuilt only when
        the matrix key, the dag's context or the quantile moves."""
        mat = self._matrix
        ctx = _context(dag, self.nodes, self.rank_cache)
        # the ctx object in the key pins the dag: id-recycling after a
        # frontier dag dies can never alias a stale view
        vkey = (self._matrix_key, ctx)
        if self._view is None or self._view_key != vkey:
            dev = self.device
            rows = torch.tensor([mat.uid_index[u] for u in ctx.order],
                                dtype=torch.int64, device=dev)
            cols = torch.tensor([mat.node_index[n] for n in ctx.names],
                                dtype=torch.int64, device=dev)
            mean, std = self._scaled
            self._view = (mean.index_select(0, rows).index_select(1, cols),
                          std.index_select(0, rows).index_select(1, cols))
            self._view_key = vkey
            self._cost_cache.clear()
            self._host_cache.clear()
        W = self._cost_cache.get(quantile)
        if W is None:
            z = None if quantile is None else quantile_z(quantile)
            W = self._cost_cache[quantile] = compute.cost_matrix(*self._view,
                                                                  z)
            self.stats.cost_rebuilds += 1
        return W

    def _host_costs(self, quantile: Optional[float]) -> np.ndarray:
        """W's host copy, made at the first ask and kept under W's key."""
        got = self._host_cache.get(quantile)
        if got is None:
            got = self._host_cache[quantile] = \
                self._cost_cache[quantile].cpu().numpy()
            self.w_host_copies += 1
        return got

    # ---- scheduling --------------------------------------------------------
    def schedule(self, dag: WorkflowDAG, ready_at=None,
                 node_available: Optional[Dict[str, float]] = None,
                 quantile: Optional[float] = None,
                 engine: str = "auto") -> Schedule:
        """One replan round off the resident rows and cost view, placed
        as `fused_heft_schedule` places (the "device" engine on the
        plane's device)."""
        self.matrix()
        W = self._costs(dag, quantile)
        ctx = _context(dag, self.nodes, self.rank_cache)
        sched, sweeps = _place(ctx, dag, self.nodes, W,
                               lambda: self._host_costs(quantile), ready_at,
                               node_available, engine, self.device)
        self.stats.sweep_dispatches += sweeps
        return sched


def _gather_many(items, dev: torch.device) -> PredictBatch:
    """The dirty rows of several planes, [(plane, snapshot, row indices)],
    as one predictive batch on `dev` for `ops.bayes_predict`, the rows in
    the order given: each plane's rows gathered by its snapshot straight
    into its stretch of the slab (`pack_predict`), each with its index in
    its plane's resident rows; the slab crosses in one copy (pinned on a
    card)."""
    idx = [np.asarray(i, np.int64) for _, _, i in items]
    firsts = np.cumsum([0] + [len(i) for i in idx])

    def gather(out):
        for (plane, snap, _), ii, a in zip(items, idx, firsts):
            snap.gather([plane._keys[i] for i in ii],
                        {k: v[a:a + len(ii)] for k, v in out.items()})
    x = np.concatenate([plane._x[ii] for (plane, _, _), ii in zip(items, idx)])
    return pack_predict(dev, x, gather, np.concatenate(idx),
                        [(plane._resident_rows(), len(ii))
                         for (plane, _, _), ii in zip(items, idx)])


# ---------------------------------------------------------------------------
# megabatched replans
# ---------------------------------------------------------------------------

@dataclass
class ReplanRequest:
    """One tenant's (workflow's) replan in a megabatch."""
    plane: FusedPlane
    dag: WorkflowDAG
    ready_at: object = None
    node_available: Optional[Dict[str, float]] = None
    quantile: Optional[float] = None


def replan_many(requests: Sequence[ReplanRequest],
                fuse_sweeps: bool = True) -> List[Schedule]:
    """Replan many tenants' workflows at once, on their planes' device
    (requests on different devices raise ValueError).

    The dirty rows of every plane go through ONE `bayes_predict` launch,
    which writes them into each plane's resident rows; then the
    requests on one cluster (node names, `same`, `gbps_min`) are placed
    as a group: ONE `upward_rank` launch and ONE `eft_sweep_many` launch
    (a block a workflow), run again at twice the interval columns while
    any lane overflows, which raises every member's slot_cap.  The
    reference grouped only requests of one bucketed shape, because the
    TPU compiled one sweep a shape; here a group's lanes keep their own T
    and D and only the rank order is padded, with -1.  `fuse_sweeps=False`
    schedules each request through `plane.schedule`.  Either way the
    schedules are bitwise `plane.schedule(...)` per request: the
    predictive is elementwise, and each lane runs the single sweep's
    steps."""
    sync_planes([req.plane for req in requests])
    return _schedule_requests(requests, fuse_sweeps)


def sync_planes(planes: Sequence[FusedPlane]) -> int:
    """`FusedPlane.sync` for many planes on one device (planes on
    different devices raise ValueError) in ONE predictive launch: the
    dirty rows of every plane gathered into one slab, copied up once, and
    re-predicted into each plane's resident rows.  Returns the rows
    refreshed."""
    devices = {plane.device for plane in planes}
    if len(devices) > 1:
        raise ValueError(f"replan_many takes planes on one device, got "
                         f"{sorted(str(d) for d in devices)}")
    # every binding syncs BEFORE any snapshot is taken: planes sharing one
    # store then collect against the same generation, so the launch below
    # leaves them all clean and the per-request rounds re-gather nothing
    # (block-granular dirtiness would otherwise let tenant B's sync,
    # landing after tenant A's snapshot, re-dirty a shared block)
    for plane in planes:
        plane.binding.sync()
    collected = [(plane,) + plane.collect_dirty() for plane in planes]
    dirty = [c for c in collected if len(c[2])]
    if dirty:
        ops.bayes_predict(_gather_many(dirty, dirty[0][0].device))
        for plane, _, _ in dirty:
            plane.stats.predict_dispatches += 1
    for plane, snap, idx in collected:
        plane.apply_rows(snap, idx)
    return sum(len(idx) for _, _, idx in collected)


def _schedule_requests(requests: Sequence[ReplanRequest],
                       fuse_sweeps: bool) -> List[Schedule]:
    """Schedule every (synced) request; with `fuse_sweeps`, the requests
    of one cluster as one group (`_dispatch_group`)."""
    if not fuse_sweeps:
        return [req.plane.schedule(req.dag, ready_at=req.ready_at,
                                   node_available=req.node_available,
                                   quantile=req.quantile)
                for req in requests]
    results: List[Optional[Schedule]] = [None] * len(requests)
    groups: Dict[tuple, list] = {}
    for pos, req in enumerate(requests):
        plane = req.plane
        _, W = plane.cost_view(req.dag, req.quantile)
        ctx = _context(req.dag, plane.nodes, plane.rank_cache)
        if not ctx.order:           # nothing to place: no lane
            results[pos] = Schedule(order={n: [] for n in ctx.names})
            continue
        groups.setdefault(ctx.cluster, []).append((pos, req, ctx, W))
    for members in groups.values():
        _dispatch_group(members, results)
    return results


def _dispatch_group(members: list, results: List[Optional[Schedule]]
                    ) -> None:
    """One cluster's requests, [(position, request, context, W)]: their
    ranks in one launch, then their sweeps in one (`_sweep_lanes`)."""
    ctxs = [m[2] for m in members]
    Ws = [m[3] for m in members]
    rank = _device_ranks(ctxs, Ws)
    inputs = [_sweep_inputs(ctx, req.dag, req.plane.nodes, req.ready_at,
                            req.node_available)
              for _, req, ctx, _ in members]
    scheds, _ = _sweep_lanes(ctxs, Ws, rank, inputs)
    for (pos, req, _, _), sched in zip(members, scheds):
        req.plane.stats.sweep_dispatches += 1
        results[pos] = sched
