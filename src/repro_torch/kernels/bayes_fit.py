"""Launch wrappers for the hand-written CUDA kernels in `csrc/bayes.cu`:
the batched Bayesian-linear-regression fit (the paper's Section 4.5 model,
thousands of task models in one launch), the batched streaming fold of
observations into NIG states (the ingest hot path) and the batched
posterior predictive (the prediction service's hot path).

The fold and the predictive take their operands as one packed float64
slab (built on the host in place, `kernels.staging`, and copied up once):
`pack_predict` here lays out the predictive's (its queries in column
groups, and the table of the resident rows it writes into),
`core.bayes.fold_pack` the fold's.

Each wrapper takes CUDA tensors only (device dispatch is `kernels.ops`),
checks device, dtype, shape, contiguity and alignment, allocates its
outputs with `torch.empty`, launches on PyTorch's current stream, raises
when the launch reports an error, and counts its launches in a plain
integer attribute (`bayes_fit.launches`, `nig_fold.launches`,
`bayes_predict.launches`) so a run can show that a path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bayes import FOLD_HEAD, FOLD_STATE, fold_head
from repro_torch.kernels import _build, staging
from repro_torch.kernels._launch import check, cuda_device, raise_on

_P = ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bayes")
    lib.lotaru_error_string.argtypes = [ctypes.c_int]
    lib.lotaru_error_string.restype = ctypes.c_char_p
    lib.lotaru_bayes_predict.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                         _P, _P]
    lib.lotaru_bayes_predict.restype = ctypes.c_int
    lib.lotaru_bayes_fit.argtypes = ([_P] * 3 + [ctypes.c_int] * 2
                                     + [_P] * 9 + [_P])
    lib.lotaru_bayes_fit.restype = ctypes.c_int
    lib.lotaru_bayes_fit_config.argtypes = ([_P] * 3 + [ctypes.c_int] * 2
                                            + [_IP] * 5)
    lib.lotaru_bayes_fit_config.restype = ctypes.c_int
    lib.lotaru_nig_fold.argtypes = [_P, ctypes.c_longlong, _P, _P]
    lib.lotaru_nig_fold.restype = ctypes.c_int
    lib.lotaru_nig_fold_shape.argtypes = [_IP, _IP]
    lib.lotaru_nig_fold_shape.restype = None
    lib.lotaru_empty.argtypes = [ctypes.c_int, ctypes.c_int, _P]
    lib.lotaru_empty.restype = ctypes.c_int
    return lib


def bayes_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
    """x, y, mask: (T, N) float32 CUDA tensors -> posterior dict matching
    core.bayes.fit_blr (leaves stacked over T).  Any T and N: the kernel
    takes one lane a task, guards the tail of T itself and stages rows
    longer than its shared-memory chunk a chunk at a time, so nothing is
    padded."""
    dev = cuda_device(x, "x")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, N), got shape {tuple(x.shape)}")
    t, n = x.shape
    for name, v in (("x", x), ("y", y), ("mask", mask)):
        check(v, name, torch.float32, (t, n), dev)
    out = {k: torch.empty(shape, dtype=torch.float32, device=dev)
           for k, shape in (("mu", (t, 2)), ("sigma", (t, 2, 2)),
                            ("alpha", (t,)), ("beta_prec", (t,)),
                            ("x_mu", (t,)), ("x_sd", (t,)), ("y_mu", (t,)),
                            ("y_sd", (t,)), ("n", (t,)))}
    if t == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_bayes_fit(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), t, n,
            *(out[k].data_ptr() for k in ("mu", "sigma", "alpha",
                                          "beta_prec", "x_mu", "x_sd",
                                          "y_mu", "y_sd", "n")),
            stream)
    raise_on(_lib(), rc, "bayes_fit")
    bayes_fit.launches += 1
    return out


bayes_fit.launches = 0


def fit_config(t: int, n: int, x: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> dict:
    """The fit kernel's launch shape at (T, N) on the current card, as
    `bayes_fit` launches it for these operands (default: operands aligned
    as torch allocates them): its route ("bulk": a tile's rows in one bulk
    copy an array, for N <= 64 and 16-byte aligned operands; "cp_async":
    4-byte copies from every lane, a 64-column chunk at a time), blocks in
    the grid, dynamic shared memory a block, blocks an SM and column
    chunks a row."""
    ptrs = [0 if a is None else a.data_ptr() for a in (x, y, mask)]
    vals = [ctypes.c_int(0) for _ in range(5)]
    rc = _lib().lotaru_bayes_fit_config(*ptrs, t, n,
                                        *(ctypes.byref(v) for v in vals))
    raise_on(_lib(), rc, "bayes_fit_config")
    route, *rest = (v.value for v in vals)
    return dict(route="bulk" if route else "cp_async",
                **dict(zip(("grid", "smem_bytes", "blocks_per_sm", "chunks"),
                           rest)))


def pad_ragged(xs, ys, min_cols: int = 2, col_bucket: int = 64):
    """Variable-length per-task observation buffers -> fixed-shape
    (T, N) float32 (x, y, mask) numpy arrays for one batched fit launch.

    Rows are right-padded to the longest buffer with mask=0 — the fit
    kernel's masked reductions make padded columns exact no-ops, so a
    (3-point, 200-point) pair costs one launch.  N is rounded up to a
    `col_bucket` multiple, as in the reference, so the buffers (and the
    posteriors fitted from them) are the same in both packages."""
    t = len(xs)
    n = max(min_cols, max((len(v) for v in xs), default=min_cols))
    if col_bucket > 1:
        n = -(-n // col_bucket) * col_bucket
    x = np.zeros((t, n), np.float32)
    y = np.zeros((t, n), np.float32)
    m = np.zeros((t, n), np.float32)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        k = len(xi)
        if k != len(yi):
            raise ValueError(f"row {i}: len(x)={k} != len(y)={len(yi)}")
        x[i, :k] = np.asarray(xi, np.float32)
        y[i, :k] = np.asarray(yi, np.float32)
        m[i, :k] = 1.0
    return x, y, m


# The TPU form padded the task dimension to a grid-block multiple; the CUDA
# kernel guards its ragged tail, so ragged buffers go straight to it.
bayes_fit_ragged = bayes_fit


# ---------------------------------------------------------------------------
# packed slabs
# ---------------------------------------------------------------------------
QUERY_GROUPS = (("x", ()), ("mu", (2,)), ("sigma", (2, 2)),
                ("beta_prec", ()), ("x_mu", ()), ("x_sd", ()), ("y_mu", ()),
                ("y_sd", ()), ("dest", ()))
"""The predictive slab's column groups in order, each with its per-query
shape: the input, the posterior leaves as the store keeps them, and each
query's destination index (int64)."""
QUERY_SLOTS = 13
"""float64 slots a query takes in a predictive slab (104 bytes: the 88 the
predictive needs, sigma's [1,0] and the destination)."""
_GROUP_SLOTS = tuple(int(np.prod(shape, dtype=np.int64))
                     for _, shape in QUERY_GROUPS)
TARGET_SLOTS = 4
"""int64 slots a target-table row: the target's first query in the slab,
its mean and std pointers, their length."""


class PredictTarget:
    """Resident rows a scattering `bayes_predict` writes into: mean and
    std, contiguous float64 vectors of n rows on one device, allocated here
    (uninitialized) so that they are always what the kernel's target table
    says they are."""

    __slots__ = ("mean", "std", "n", "device")

    def __init__(self, n: int, device):
        self.mean = torch.empty(int(n), dtype=torch.float64, device=device)
        self.std = torch.empty_like(self.mean)
        self.n = int(n)
        self.device = self.mean.device


class PackedBatch:
    """A kernel's operand packed on a device, made by its packer alone
    (`PACKER`): constructing one directly raises TypeError, so no route
    meets a slab beside a description its packer did not write.  The check
    runs when a batch is made, not when it is launched."""

    __slots__ = ()
    PACKER = ""

    def __init__(self, *args, **kwargs):
        raise TypeError(f"a {type(self).__name__} is made by {self.PACKER} "
                        f"alone")

    @classmethod
    def _packed(cls, *values):
        """The packer's constructor: the slots' values in order."""
        batch = object.__new__(cls)
        for name, v in zip(cls.__slots__, values, strict=True):
            setattr(batch, name, v)
        return batch


class PredictBatch(PackedBatch):
    """The predictive's operand on a device: one slab of q packed queries
    and, when the results are scattered, the targets whose table follows
    them.  Made by `pack_predict` alone, which writes the table from the
    same targets, so a batch's table is that of its targets.  What stays
    the caller's contract: do not write into a batch's slab after packing
    (the kernel follows the pointers of the table as it finds them)."""

    __slots__ = ("slab", "q", "targets")
    PACKER = "pack_predict"


def _even(q: int) -> int:
    return q + (q & 1)


def predict_slots(q: int, n_targets: int = 0) -> int:
    """float64 slots of a predictive slab: q queries' groups (each group
    of an even length of slots, so that every group starts on 16 bytes),
    then the table."""
    return QUERY_SLOTS * _even(q) + TARGET_SLOTS * n_targets


def slab_columns(slab, q: int) -> dict:
    """The column groups of a predictive slab of q queries (a float64
    numpy array or tensor), as views: {name: (q,) + shape}, "dest" as
    int64."""
    p, at, out = _even(q), 0, {}
    for (name, shape), k in zip(QUERY_GROUPS, _GROUP_SLOTS):
        v = slab[at:at + q * k]
        if name == "dest":
            v = v.view(np.int64 if isinstance(v, np.ndarray) else torch.int64)
        out[name] = v.reshape((q,) + shape)
        at += p * k
    return out


def fill_slab(slab: np.ndarray, q: int, x, post, dest=None) -> dict:
    """Write q queries into the column groups of a predictive slab
    (`slab_columns`): the inputs `x`, the destinations `dest` (0 when the
    results come back interleaved) and the posterior leaves, each group in
    one contiguous copy from `post` ({leaf: (q, ...)}), or, when `post` is
    callable, by `post(leaves)` writing into the groups' views itself (the
    store's gather does: `lambda out: snapshot.gather(keys, out)`).
    Returns the views."""
    cols = slab_columns(slab, q)
    cols["x"][:] = x
    cols["dest"][:] = 0 if dest is None else dest
    leaves = {k: v for k, v in cols.items() if k not in ("x", "dest")}
    if callable(post):
        post(leaves)
    else:
        for k, v in leaves.items():
            v[:] = post[k]
    return cols


def pack_predict(device, x, post, dest=None, targets=None) -> PredictBatch:
    """The operand of one `bayes_predict` on `device`: the q = len(x)
    queries' inputs, posterior leaves (`fill_slab`: a dict of (q, ...)
    leaves, or a callable that writes them) and destinations packed into
    one slab in host memory that `kernels.staging` sends up in one copy
    (pinned on a card).  With `targets`, [(PredictTarget, queries)] in
    query order, the queries go to the targets in turn, as many to each
    as it says, query i to index dest[i] of its target's resident rows;
    the targets' table (first query, mean and std pointers, length)
    follows the groups.  Without, the results come back interleaved."""
    q = len(x)
    dev = staging.resolve(device)
    table = _target_table(targets, q, dest, dev)
    with staging.staged(dev) as st:
        buf = st.host(predict_slots(q, len(table)))
        fill_slab(buf, q, x, post, dest)
        buf[predict_slots(q):].view(np.int64)[:] = table.ravel()
        slab = st.send()
    return PredictBatch._packed(slab, q, tuple(t for t, _ in targets or ()))


def _target_table(targets, q: int, dest, dev: torch.device) -> np.ndarray:
    """[(PredictTarget, queries)] -> their (P, TARGET_SLOTS) int64 table,
    after checking them against the q queries and `dev`."""
    if targets is None:
        return np.empty((0, TARGET_SLOTS), np.int64)
    if not len(targets):
        raise ValueError("targets must be None (results interleaved) or "
                         "hold at least one target")
    if dest is None or len(dest) != q:
        raise ValueError("scattered queries need a destination each")
    table = np.empty((len(targets), TARGET_SLOTS), np.int64)
    for k, (t, n) in enumerate(targets):
        if not isinstance(t, PredictTarget) or t.device != dev:
            raise ValueError(f"target {k} must be a PredictTarget on {dev}, "
                             f"got {t!r}")
        table[k] = (n, t.mean.data_ptr(), t.std.data_ptr(), t.n)
    counts = table[:, 0].copy()
    if (counts < 0).any() or counts.sum() != q:
        raise ValueError(f"the targets' queries must be >= 0 and sum to "
                         f"{q}, got {counts.tolist()}")
    table[:, 0] = np.cumsum(counts) - counts
    return table


def slab_table(batch: PredictBatch) -> torch.Tensor:
    """A batch's target table, (P, TARGET_SLOTS) int64, as a view."""
    at = predict_slots(batch.q)
    return batch.slab[at:predict_slots(batch.q, len(batch.targets))] \
        .view(torch.int64).view(len(batch.targets), TARGET_SLOTS)


def slab_of(batch) -> torch.Tensor:
    """`batch`'s slab; raise unless `batch` is a PredictBatch."""
    if not isinstance(batch, PredictBatch):
        raise TypeError(f"bayes_predict takes a PredictBatch (pack_predict: "
                        f"the queries and their targets packed together), got "
                        f"{type(batch).__name__}")
    return batch.slab


def check_batch(batch) -> torch.Tensor:
    """Raise unless `batch` is a PredictBatch whose slab holds its queries
    and table; returns the slab."""
    slab = slab_of(batch)
    check_slab(slab, predict_slots(batch.q, len(batch.targets)), slab.device)
    return slab


def check_slab(slab: torch.Tensor, slots: int, device: torch.device
               ) -> None:
    """Raise unless `slab` is a contiguous float64 vector on `device` of
    at least `slots` slots, on a 16-byte boundary (the fold stages it with
    bulk copies, the predictive reads it in 16-byte loads; the port
    allocates every slab itself, so it always is)."""
    check(slab, "slab", torch.float64, tuple(slab.shape), device)
    if slab.dim() != 1 or slab.numel() < slots:
        raise ValueError(f"slab must be a vector of at least {slots} "
                         f"slots, got shape {tuple(slab.shape)}")
    if slab.numel() and slab.data_ptr() % 16:
        raise ValueError("slab must start on a 16-byte boundary")


# ---------------------------------------------------------------------------
# the fold and the predictive
# ---------------------------------------------------------------------------
def nig_fold(slab: torch.Tensor, t: int) -> torch.Tensor:
    """Fold of the ragged slab of T rows (`core.bayes.fold_pack`: the row
    offsets at its head, each row a 10-slot state header and its
    standardized (x, y) pairs) into T NIG states, float64 on the card.
    Returns the (T, FOLD_STATE) state slab (mu, V and prec at [0,0],
    [0,1], [1,1], b), bitwise equal to core.bayes._nig_fold_np on the same
    slab.  Any T and row lengths: nothing is padded."""
    dev = cuda_device(slab, "slab")
    check_slab(slab, fold_head(t) + FOLD_HEAD * t, dev)
    out = torch.empty((t, FOLD_STATE), dtype=torch.float64, device=dev)
    if t == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_nig_fold(slab.data_ptr(), t, out.data_ptr(),
                                    stream)
    raise_on(_lib(), rc, "nig_fold")
    nig_fold.launches += 1
    return out


nig_fold.launches = 0


def fold_config() -> dict:
    """The fold kernel's tile: rows a block (a lane a row) and the slab
    slots a block stages in shared memory; a row ending past them is
    walked from global memory (`fold_global_rows`)."""
    rows, slots = ctypes.c_int(0), ctypes.c_int(0)
    _lib().lotaru_nig_fold_shape(ctypes.byref(rows), ctypes.byref(slots))
    return {"tile_rows": rows.value, "stage_slots": slots.value}


def fold_global_rows(slab: np.ndarray, t: int, tile_rows: int,
                     stage_slots: int) -> int:
    """How many rows of a T-row fold slab the kernel walks from global
    memory: those ending past the first `stage_slots` slots of their
    tile's range."""
    off = slab[:t + 1].view(np.int64)
    tile0 = off[:-1][(np.arange(t) // tile_rows) * tile_rows]
    return int(((off[1:] - tile0) > stage_slots).sum())


def bayes_predict(batch: PredictBatch) -> Optional[torch.Tensor]:
    """The posterior predictive of the q packed queries of `batch`
    (`pack_predict`, on the card), bitwise equal to
    core.bayes.predict_blr_np on the same values.  With no targets,
    returns (Q, 2) float64, mean and std interleaved.  With targets, each
    query's mean and std are written at its destination index in its
    target's resident rows (an index outside them is not written); returns
    None."""
    dev = cuda_device(check_batch(batch), "slab")
    q, n_targets = batch.q, len(batch.targets)
    out = (torch.empty((q, 2), dtype=torch.float64, device=dev)
           if not n_targets else None)
    if q == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().lotaru_bayes_predict(
            batch.slab.data_ptr(), q, n_targets,
            None if out is None else out.data_ptr(), stream)
    raise_on(_lib(), rc, "bayes_predict")
    bayes_predict.launches += 1
    return out


bayes_predict.launches = 0
