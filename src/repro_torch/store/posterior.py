"""PosteriorStore: the single multi-tenant owner of all posterior state.

  * **Namespaced keys** — rows are addressed `tenant/workflow/task`
    (keys.TaskKey); any number of workflows/tenants share one store with
    hard isolation (a write touches exactly one row).
  * **Contiguous blocks + copy-on-write snapshots** — leaves live in
    fixed-size float64 host blocks (`block_size` rows).  A write copies
    only the touched block and bumps the store generation; readers gather
    from an immutable `StoreSnapshot`, so an online update rewrites one row
    of one block and never restacks the rest.
  * **Shard-aware layout** — when the stack outgrows one block the store
    splits into more blocks; `gather` resolves rows block-by-block.
  * **Dirty-block feed** — each block remembers the generation of its
    last rewrite; `StoreSnapshot.rows_changed_since` tells a resident
    consumer (`sched.fused.FusedPlane`) which of its rows moved since the
    generation it last read.  `sync_bindings` lands several namespaces'
    changed rows in one generation.
  * **Checkpoint/restore** — `save()` writes one npz a block plus a JSON
    manifest with the key index, the blocks' generations and each bound
    predictor's streaming state (NIG posteriors, node-correction logs,
    observation buffers); `restore()` + `resume()` bring a restarted
    service back warm and bit-identical.  The files are the reference
    package's (`repro.store.posterior`): a checkpoint written by either
    restores in the other.  `save(incremental=True)` rewrites only the
    blocks whose generation moved, `keep_last=N` keeps superseded
    generations restorable through hard links.
  * **Replica shipping and migration** — `export_blocks` /
    `import_blocks` ship whole blocks to a passive replica,
    `export_namespaces` / `import_namespaces` move namespaces into a live
    store; the payloads are the reference's.

The gathered rows are what the predictive kernel reads: a gather is one
contiguous float64 array per leaf, packed into the kernel's rows
(`kernels.bayes_fit.pack_predict`), which cross to the card in one
transfer.  The block generations feed both the incremental checkpoint and
the resident plane: a store restored or imported whole is a new store (or
one with no live binding), so a plane over it starts from a full gather.

`TenantBinding` is the per-namespace glue: it owns the sync cursor between
a predictor's mutable state and the store rows (incremental via the
predictor's non-destructive change feed, `changed_since(cursor)`, where the
predictor has one) and the version-scoped static-factor cache.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import staging
from repro_torch.store.compute import LEAF_SHAPES, LEAVES
from repro_torch.store.keys import (DEFAULT_TENANT, DEFAULT_WORKFLOW, SEP,
                                    TaskKey, namespace_str, resolve_bench)

DEFAULT_BLOCK_SIZE = 512
DEVICE_FACTOR_MATRICES = 8      # resident factor matrices a binding keeps
MANIFEST_NAME = "manifest.json"
BLOCKS_NAME = "blocks.npz"           # format-1 checkpoints (read-only compat)
CHECKPOINT_FORMAT = 2


def _block_file(i: int) -> str:
    return f"block_{i}.npz"


def _hist_block_file(i: int, gen: int) -> str:
    """Name a superseded block generation keeps under retention
    (`save(keep_last=...)`): the content block i had at generation `gen`."""
    return f"block_{i}.g{gen}.npz"


def _hist_manifest_file(gen: int) -> str:
    return f"manifest.g{gen}.json"


_BLOCK_FILE_RE = re.compile(r"block_(\d+)(?:\.g(\d+))?\.npz$")
_HIST_MANIFEST_RE = re.compile(r"manifest\.g(\d+)\.json$")


def _preserve_history(path: str, prev: dict, rewritten, deleted) -> None:
    """Hard-link the outgoing checkpoint generation under suffixed names
    before `save(keep_last=...)` overwrites or deletes it, so it stays
    restorable (`restore(path, generation=...)`) until retention prunes
    it.  Linking is additive — a crash mid-preserve leaves the live
    checkpoint untouched, it just keeps one extra generation."""
    prev_block_gen = {int(k): int(v)
                      for k, v in (prev.get("block_gen") or {}).items()}
    gen = int(prev.get("generation", 0))
    hist_manifest = os.path.join(path, _hist_manifest_file(gen))
    if not os.path.exists(hist_manifest):
        try:
            os.link(os.path.join(path, MANIFEST_NAME), hist_manifest)
        except FileNotFoundError:
            return                   # no previous checkpoint: nothing to keep
    for i in sorted(set(rewritten) | set(deleted)):
        g = prev_block_gen.get(i)
        if g is None:                # legacy format-1 history lives in the
            continue                 # blocks.npz blob, which save never touches
        hist = os.path.join(path, _hist_block_file(i, g))
        if os.path.exists(hist):
            continue
        try:
            os.link(os.path.join(path, _block_file(i)), hist)
        except FileNotFoundError:    # block file already missing: the live
            pass                     # checkpoint self-repairs, so can history


def _gc_checkpoint(path: str, keep_last: int, manifest: dict) -> None:
    """Prune checkpoint history beyond the newest `keep_last - 1`
    superseded generations (the live checkpoint is the Nth), plus any
    block npz / stale temp no surviving manifest references — orphans of
    a different store saved at the same path or of a crashed save."""
    files = set(os.listdir(path))
    hist = sorted(((int(m.group(1)), f) for f in files
                   if (m := _HIST_MANIFEST_RE.fullmatch(f)) is not None),
                  reverse=True)
    kept = hist[:keep_last - 1]
    referenced = {MANIFEST_NAME, BLOCKS_NAME}
    referenced.update(_block_file(int(i))
                      for i in (manifest.get("block_gen") or {}))
    for _, fname in kept:
        referenced.add(fname)
        try:
            with open(os.path.join(path, fname)) as f:
                hm = json.load(f)
        except (OSError, ValueError):
            continue                 # unreadable history: keep, never guess
        for bid, g in (hm.get("block_gen") or {}).items():
            suffixed = _hist_block_file(int(bid), int(g))
            # a block unchanged since that generation has no suffixed
            # copy — the live file still holds those exact bytes
            referenced.add(suffixed if suffixed in files
                           else _block_file(int(bid)))
    for fname in files:
        if fname in referenced:
            continue
        if (_BLOCK_FILE_RE.fullmatch(fname) is not None
                or _HIST_MANIFEST_RE.fullmatch(fname) is not None
                or fname.endswith(".tmp")):
            try:
                os.remove(os.path.join(path, fname))
            except FileNotFoundError:
                pass


# scale-like leaves default to 1 in unassigned slots so a stray read can
# never divide by zero (assigned-row reads are guarded by the snapshot)
_UNIT_LEAVES = ("beta_prec", "x_sd", "y_sd")


def _new_block(block_size: int) -> Dict[str, np.ndarray]:
    blk = {}
    for leaf, shape in LEAF_SHAPES.items():
        fill = 1.0 if leaf in _UNIT_LEAVES else 0.0
        blk[leaf] = np.full((block_size,) + shape, fill, np.float64)
    return blk


class StoreSnapshot:
    """Immutable view of the store at one generation.

    Writers replace whole blocks (copy-on-write), so holding references to
    the block arrays is enough; the key index is copied at snapshot time —
    `evict()` may recycle freed row slots for *new* keys, and a shared
    live index would silently resolve such a key to the evicted tenant's
    old row (`n_rows` still guards keys appended past the snapshot)."""

    __slots__ = ("_blocks", "_rows", "_n_rows", "_block_size", "generation",
                 "_block_gen")

    def __init__(self, blocks, rows, n_rows, block_size, generation,
                 block_gen=None):
        self._blocks = tuple(blocks)
        self._rows = rows
        self._n_rows = n_rows
        self._block_size = block_size
        self.generation = generation
        # block id -> generation of its last rewrite, captured with the
        # snapshot: the dirty-row feed of the resident plane
        # (sched.fused.FusedPlane).  A hand-built snapshot without it
        # reads as "every row may have changed".
        self._block_gen = dict(block_gen) if block_gen is not None else None

    def __contains__(self, key) -> bool:
        row = self._rows.get(str(key))
        return row is not None and row < self._n_rows

    def row_of(self, key) -> int:
        row = self._rows.get(str(key))
        if row is None or row >= self._n_rows:
            raise KeyError(str(key))
        return row

    def gather(self, keys: Sequence,
               out: Optional[Dict[str, np.ndarray]] = None
               ) -> Dict[str, np.ndarray]:
        """Stack the posterior leaves of `keys` -> {leaf: (Q, ...)},
        written into `out`'s float64 arrays when given.
        Rows are resolved block-by-block: with one block this is a single
        fancy index per leaf; with a sharded stack each block is touched at
        most once."""
        rows = np.asarray([self.row_of(k) for k in keys], np.int64)
        bids, slots = np.divmod(rows, self._block_size)
        given, out = out, {}
        for leaf in LEAVES:
            res = (np.empty((len(rows),) + LEAF_SHAPES[leaf], np.float64)
                   if given is None else given[leaf])
            for b in np.unique(bids):
                m = bids == b
                res[m] = self._blocks[b][leaf][slots[m]]
            out[leaf] = res
        return out

    def get(self, key) -> Dict[str, np.ndarray]:
        """One row's leaves (copies), as a predict_blr-compatible dict."""
        g = self.gather([key])
        return {leaf: v[0] for leaf, v in g.items()}

    def rows_changed_since(self, keys: Sequence, generation: int
                           ) -> np.ndarray:
        """(len(keys),) bool mask: True where a key's backing block was
        rewritten after `generation` — the dirty-row feed for consumers
        that keep gathered rows resident across snapshots.  It works at
        block granularity (a neighbour's write marks the whole block;
        re-predicting a clean row gives the same bits).  A key unknown to
        this snapshot, or a block with no generation tag, is dirty."""
        out = np.empty(len(keys), bool)
        for i, k in enumerate(keys):
            row = self._rows.get(str(k))
            if row is None or row >= self._n_rows or self._block_gen is None:
                out[i] = True
                continue
            g = self._block_gen.get(row // self._block_size)
            out[i] = g is None or g > generation
        return out


class TenantBinding:
    """One (tenant, workflow) namespace bound to the predictor that updates
    it.  Owns (a) the sync cursor — store rows are refreshed incrementally
    from the predictor's change feed instead of restacked wholesale — and
    (b) the static-factor cache, scoped to the *base* predictor's fit
    version so a refit (changed `cpu_fraction`, swapped `app_bench`) can
    never serve factors computed for the previous model."""

    def __init__(self, store: "PosteriorStore", tenant: str, workflow: str,
                 predictor, benches: Optional[Mapping] = None):
        self.store = store
        self.tenant = tenant
        self.workflow = workflow
        self.predictor = predictor
        self.benches = dict(benches or {})
        self._detached = False           # set when another predictor takes
        self._detach_reason: Optional[str] = None    # the namespace over,
        self._synced_version: Optional[int] = None   # or on evict()
        self._change_cursor = -1.0       # this binding's position in the
        self._sync_lock = threading.Lock()   # predictor's change feed
        self._keys: Dict[str, TaskKey] = {}       # task -> key (hot-path
        self._key_strs: Dict[str, str] = {}       # memo: tenant/workflow
                                                  # are fixed per binding)
        self._factor_cache: Dict[Tuple[str, str], float] = {}
        self._factor_version: Optional[int] = None
        # (tasks, nodes, device) -> the static-factor matrix resident on
        # that device; dropped with _factor_cache (`_drop_factors`)
        self._device_factors: Dict[tuple, torch.Tensor] = {}

    @property
    def namespace(self) -> str:
        return namespace_str(self.tenant, self.workflow)

    def key(self, task: str) -> TaskKey:
        k = self._keys.get(task)
        if k is None:
            k = self._keys[task] = TaskKey(self.tenant, self.workflow, task)
        return k

    def key_str(self, task: str) -> str:
        """Memoized str(key) — the per-query handle the serving hot path
        passes to snapshot gathers (avoids a dataclass + join per query)."""
        s = self._key_strs.get(task)
        if s is None:
            s = self._key_strs[task] = str(self.key(task))
        return s

    def keys(self) -> List[TaskKey]:
        return [self.key(t) for t in self.predictor.task_names()]

    def add_benches(self, benches: Mapping) -> None:
        """Merge benchmark entries; replacing an existing node's bench with
        a different reading drops the factor cache (factors derived from
        the old bench must not survive a re-benchmark)."""
        changed = any(k in self.benches and self.benches[k] != v
                      for k, v in benches.items())
        self.benches.update(benches)
        if changed:
            self._drop_factors()

    # ---- predictor -> store sync -------------------------------------------
    def sync(self, full: bool = False) -> int:
        """Push posterior rows the predictor changed since the last sync
        into the store.  Returns the number of rows written.  `full` forces
        a complete rewrite (explicit `refresh()`), which also drops the
        factor cache so even out-of-band model edits (a swapped app_bench)
        are picked up."""
        with self._sync_lock:       # serialize concurrent syncs (frontend
            self._check_attached()  # worker vs predict_batch: a sync in one
            # thread must land its put before another thread concludes the
            # namespace is clean and snapshots stale rows)
            items, cursor, version = self._pending(full)
            if items:
                self.store.put_many(items)
            self._synced(cursor, version, full)
            return len(items)

    def _check_attached(self) -> None:
        """Raise if detached (the caller holds `_sync_lock`: bind()/evict()
        detach under this same lock, so an in-flight sync either lands its
        rows BEFORE the displacing restack/purge or dies here)."""
        if self._detached:
            raise RuntimeError(self._detach_reason or (
                f"binding for {self.namespace!r} was detached from "
                f"the store; services holding it must be rebuilt"))

    def _pending(self, full: bool):
        """(store items of the rows due, feed cursor to adopt after the
        put, predictor version) for one sync; the caller holds
        `_sync_lock`."""
        p = self.predictor
        version = getattr(p, "version", 0)
        changed_since = getattr(p, "changed_since", None)
        cursor: Optional[float] = None
        if full or self._synced_version is None:
            if changed_since is not None:    # capture the feed position
                _, cursor = changed_since(float("inf"))   # BEFORE export
            tasks = list(p.task_names())
        elif changed_since is not None:
            # the feed is non-destructive and per-binding (cursor), so one
            # predictor can feed many bindings; a failed put keeps the old
            # cursor and the rows stay due
            tasks, cursor = changed_since(self._change_cursor)
        else:
            tasks = ([] if self._synced_version == version
                     else list(p.task_names()))
        return ([(self.key(t), p.export_posterior(t)) for t in tasks],
                cursor, version)

    def _synced(self, cursor: Optional[float], version: int,
                full: bool) -> None:
        """Adopt a landed sync: the feed cursor, the synced version, and a
        factor cache scoped to the live base-predictor version."""
        if cursor is not None:
            self._change_cursor = cursor
        self._synced_version = version
        base = getattr(self.predictor, "base", self.predictor)
        base_version = getattr(base, "version", 0)
        if full or base_version != self._factor_version:
            self._drop_factors()
            self._factor_version = base_version

    def _drop_factors(self) -> None:
        """Forget every static factor, on the host and on the devices."""
        self._factor_cache.clear()
        self._device_factors.clear()

    def is_current(self) -> bool:
        """True when a sync would be a no-op: the change cursor sits at the
        head of the predictor's feed, the synced version matches, and the
        factor cache is scoped to the live base-predictor version.  The
        generation-aware guard behind PredictionService.refresh()."""
        with self._sync_lock:
            if self._detached or self._synced_version is None:
                return False
            p = self.predictor
            if getattr(p, "version", 0) != self._synced_version:
                return False
            changed_since = getattr(p, "changed_since", None)
            if changed_since is not None:
                tasks, _ = changed_since(self._change_cursor)
                if tasks:
                    return False
            base = getattr(p, "base", p)
            return getattr(base, "version", 0) == self._factor_version

    def _advance_cursor(self, applied_seqs: Mapping) -> None:
        """Move the change cursor past rows the maintenance plane already
        published (the caller holds `_sync_lock` and did the put_many).
        `applied_seqs` maps task -> the change seq captured when its row
        was exported; the cursor advances only when every pending change
        belongs to a published task whose seq has not moved since, so a
        concurrent observe() (even on a published task) keeps its row due
        for the next sync.  A never-synced binding is left alone: its
        first sync must stay a full restack."""
        p = self.predictor
        changed_since = getattr(p, "changed_since", None)
        seq_of = getattr(p, "change_seq", None)
        if changed_since is None or seq_of is None \
                or self._synced_version is None:
            return
        tasks, head = changed_since(self._change_cursor)
        if all(t in applied_seqs and seq_of(t) <= applied_seqs[t]
               for t in tasks):
            self._change_cursor = head
            self._synced_version = getattr(p, "version", 0)

    # ---- extrapolation factors ----------------------------------------------
    def base_factor(self, task: str, node: Optional[str]) -> float:
        """Static Section 4.6 factor, cached per base-predictor version
        (streaming node corrections are composed on top per query)."""
        if node is None:
            return 1.0                 # local machine (events.py contract)
        cache_key = (task, node)
        f = self._factor_cache.get(cache_key)
        if f is None:
            bench = resolve_bench(self.benches, node)
            if bench is None:
                raise KeyError(f"no benchmark registered for node {node!r}; "
                               f"known: {sorted(self.benches)}")
            base = getattr(self.predictor, "base", self.predictor)
            f = base.factor(task, bench)
            self._factor_cache[cache_key] = f
        return f

    def factors(self, queries) -> np.ndarray:
        """Per-query multiplicative factor: static extrapolation x the
        predictor's streaming node correction (if it has one)."""
        corr_fn = getattr(self.predictor, "node_correction", None)
        corr = ({n: corr_fn(n) for n in {q.node for q in queries}}
                if corr_fn else {})
        return np.asarray([self.base_factor(q.task, q.node)
                           * corr.get(q.node, 1.0) for q in queries])

    def node_corrections(self, nodes: Sequence[Optional[str]]
                         ) -> Dict[Optional[str], float]:
        """node -> streaming correction factor (1.0 when the predictor has
        none) — the per-round multiplicative term composed onto
        `base_factor` by `factors`/`factor_matrix`."""
        corr_fn = getattr(self.predictor, "node_correction", None)
        if corr_fn is None:
            return {n: 1.0 for n in set(nodes)}
        return {n: corr_fn(n) for n in set(nodes)}

    @property
    def factor_version(self) -> Optional[int]:
        """Base-predictor fit version the static-factor cache is scoped to
        (moves on refit).  The resident plane keys its cached base-factor
        matrix on it, so a refit invalidates both at once."""
        return self._factor_version

    def base_factor_matrix(self, tasks: Sequence[str],
                           nodes: Sequence[Optional[str]]) -> np.ndarray:
        """(T, N) static-factor matrix (no streaming corrections): the
        slowly moving part of `factor_matrix`, cacheable against
        `factor_version`."""
        return np.asarray([[self.base_factor(t, n) for n in nodes]
                           for t in tasks])

    def device_base_factors(self, tasks: Sequence[str],
                            nodes: Sequence[Optional[str]],
                            device) -> torch.Tensor:
        """`base_factor_matrix` resident on `device`: float64, (T, N),
        C-contiguous, 16-byte aligned (the cost kernel reads it in 16-byte
        loads).  Built and copied once per (tasks, nodes, device) and kept
        (the DEVICE_FACTOR_MATRICES newest) until the factor cache is
        dropped (a refit moving `factor_version`, a full sync, a
        re-benchmarked node), so a warm round builds and copies no factor
        matrix."""
        key = (tuple(tasks), tuple(nodes), staging.resolve(device))
        f = self._device_factors.get(key)
        if f is None:
            host = np.asarray(self.base_factor_matrix(tasks, nodes),
                              np.float64).reshape(len(tasks), len(nodes))
            f = torch.empty(host.shape, dtype=torch.float64,
                            device=key[2])
            f.copy_(torch.from_numpy(host))
            while len(self._device_factors) >= DEVICE_FACTOR_MATRICES:
                self._device_factors.pop(next(iter(self._device_factors)),
                                         None)
            self._device_factors[key] = f
        return f

    def factor_matrix(self, tasks: Sequence[str],
                      nodes: Sequence[Optional[str]]) -> np.ndarray:
        """(T, N) multiplicative factor matrix for the decision plane: the
        same static x streaming product `factors` computes per query, laid
        out for a tasks x nodes prediction matrix (None column -> local,
        factor 1)."""
        corr = self.node_corrections(nodes)
        return np.asarray([[self.base_factor(t, n) * corr.get(n, 1.0)
                            for n in nodes] for t in tasks])


class PosteriorStore:
    """See module docstring.  Thread-safe for concurrent put/snapshot."""

    def __init__(self, block_size: int = DEFAULT_BLOCK_SIZE):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = int(block_size)
        self.generation = 0
        self._lock = threading.RLock()
        self._rows: Dict[str, int] = {}          # key str -> row (a live key
                                                 # never moves; evict() may
                                                 # recycle freed row slots)
        self._next_row = 0                       # allocation cursor (> any
                                                 # restored row index)
        self._free_rows: List[int] = []          # heap of evicted row slots
        self._blocks: List[Dict[str, np.ndarray]] = []
        self._block_gen: Dict[int, int] = {}     # block id -> generation of
                                                 # its last rewrite (the
                                                 # dirty-row feed and the
                                                 # incremental checkpoint)
        self.last_checkpoint_blocks: List[int] = []   # blocks written by the
                                                      # most recent save()
        self._last_save_id: Optional[str] = None  # lineage token of the last
                                                  # checkpoint this store
                                                  # wrote or was restored
                                                  # from (incremental saves
                                                  # must extend exactly it)
        self._bindings: Dict[Tuple[str, str], TenantBinding] = {}
        self._saved_states: Dict[str, dict] = {}  # namespace -> checkpointed
        self._snap: Optional[StoreSnapshot] = None  # predictor stream state

    # ---- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._rows)

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    @property
    def num_free_blocks(self) -> int:
        """Blocks fully released by evict() (backing arrays dropped)."""
        with self._lock:
            return sum(b is None for b in self._blocks)

    def task_keys(self) -> List[str]:
        with self._lock:
            return list(self._rows)

    def namespaces(self) -> List[str]:
        with self._lock:
            return [b.namespace for b in self._bindings.values()]

    # ---- namespace bindings -------------------------------------------------
    def binding(self, tenant: str = DEFAULT_TENANT,
                workflow: str = DEFAULT_WORKFLOW) -> Optional[TenantBinding]:
        with self._lock:
            return self._bindings.get((tenant, workflow))

    def bindings(self) -> List[TenantBinding]:
        """Every live namespace binding (the maintenance plane iterates
        these to find predictors with refresh-due tasks)."""
        with self._lock:
            return list(self._bindings.values())

    def sync_bindings(self, bindings: Optional[Sequence[TenantBinding]]
                      = None) -> int:
        """Sync several namespaces' changed rows in ONE copy-on-write
        generation: every binding's due rows land in a single `put_many`
        instead of one generation bump per binding.  Returns rows written.

        Binding sync locks are taken in namespace order, always before the
        store lock inside put_many (the order `sync()` and the maintenance
        plane's publish use), so concurrent syncs serialize instead of
        deadlocking.  A detached binding raises, as `sync()` does."""
        if bindings is None:
            bindings = self.bindings()
        bindings = sorted({id(b): b for b in bindings}.values(),
                          key=lambda b: b.namespace)
        with contextlib.ExitStack() as stack:
            for b in bindings:
                stack.enter_context(b._sync_lock)
                b._check_attached()
            pending = [(b,) + b._pending(False) for b in bindings]
            items = [item for _, its, _, _ in pending for item in its]
            if items:
                self.put_many(items)        # ONE generation for the batch
            for b, _, cursor, version in pending:
                b._synced(cursor, version, False)
            return len(items)

    def bind(self, tenant: str, workflow: str, predictor,
             benches: Optional[Mapping] = None, sync: bool = True
             ) -> TenantBinding:
        """Attach `predictor` as the updater of namespace tenant/workflow.
        Re-binding the same predictor returns the existing binding (benches
        merge; a replaced bench reading drops cached factors); a different
        predictor takes the namespace over and fully restacks it."""
        while True:
            with self._lock:
                old = self._bindings.get((tenant, workflow))
                if old is not None and old.predictor is predictor:
                    if benches:
                        old.add_benches(benches)
                    return old
                if old is None:
                    b = TenantBinding(self, tenant, workflow, predictor,
                                      benches)
                    self._bindings[(tenant, workflow)] = b
                    break
            # displacement: detach the old updater under ITS sync lock (and
            # outside the store lock — its in-flight sync may need put_many)
            # so any in-flight sync finishes BEFORE our full restack and no
            # later one can write rows again
            with old._sync_lock:
                old._detached = True
                old._detach_reason = (
                    f"binding for {old.namespace!r} was displaced by a "
                    f"later bind() of a different predictor; services "
                    f"holding it must be rebuilt (two live updaters would "
                    f"silently alternate overwriting the same rows)")
            with self._lock:
                if self._bindings.get((tenant, workflow)) is old:
                    b = TenantBinding(self, tenant, workflow, predictor,
                                      benches)
                    self._bindings[(tenant, workflow)] = b
                    break
                # another thread re-bound concurrently; re-evaluate
        if sync:
            b.sync(full=True)
        return b

    # ---- writes (copy-on-write) ---------------------------------------------
    def put(self, key, post: Mapping) -> None:
        self.put_many([(key, post)])

    def put_many(self, items: Sequence[Tuple[object, Mapping]]) -> None:
        """Write posterior rows in one generation bump.  Only the touched
        blocks are copied; blocks held by live snapshots are never mutated.
        Atomic: keys and leaves are validated/staged up front, so a
        malformed posterior raises before any row, block, or generation
        state changes (no phantom rows, no stale cached snapshot)."""
        if not items:
            return
        staged = []
        for key, post in items:
            ks = str(key)
            leaves = {}
            for leaf in LEAVES:
                v = np.asarray(post[leaf], np.float64)
                if v.shape != LEAF_SHAPES[leaf]:
                    raise ValueError(f"leaf {leaf!r} of {ks!r} has shape "
                                     f"{v.shape}, want {LEAF_SHAPES[leaf]}")
                leaves[leaf] = v
            staged.append((ks, leaves))
        with self._lock:
            for ks, _ in staged:
                if ks not in self._rows:
                    TaskKey.parse(ks)            # validate shape of new keys
            fresh = set()
            touched: Dict[int, List[Tuple[int, dict]]] = {}
            for ks, leaves in staged:
                row = self._rows.get(ks)
                if row is None:
                    if self._free_rows:         # recycle evicted slots first
                        row = heapq.heappop(self._free_rows)
                    else:
                        row = self._next_row   # never len(_rows): restored
                        self._next_row += 1    # manifests may have row ids
                    self._rows[ks] = row       # beyond the key count
                bid, slot = divmod(row, self.block_size)
                while bid >= len(self._blocks):
                    self._blocks.append(_new_block(self.block_size))
                    fresh.add(len(self._blocks) - 1)
                if self._blocks[bid] is None:   # released by evict()
                    self._blocks[bid] = _new_block(self.block_size)
                    fresh.add(bid)
                touched.setdefault(bid, []).append((slot, leaves))
            for bid, writes in touched.items():
                block = self._blocks[bid]
                if bid not in fresh:             # copy-on-write
                    block = {k: v.copy() for k, v in block.items()}
                for slot, leaves in writes:
                    for leaf, v in leaves.items():
                        block[leaf][slot] = v
                self._blocks[bid] = block
            self.generation += 1
            for bid in touched:
                self._block_gen[bid] = self.generation
            self._snap = None

    # ---- reads --------------------------------------------------------------
    def snapshot(self) -> StoreSnapshot:
        with self._lock:
            if self._snap is None:
                self._snap = StoreSnapshot(self._blocks, dict(self._rows),
                                           self._next_row, self.block_size,
                                           self.generation, self._block_gen)
            return self._snap

    def get(self, key) -> Dict[str, np.ndarray]:
        return self.snapshot().get(key)

    def gather(self, keys: Sequence) -> Dict[str, np.ndarray]:
        return self.snapshot().gather(keys)

    # ---- checkpoint / restore -----------------------------------------------
    def _sync_all(self, namespaces=None) -> None:
        """Sync every live binding (or those of `namespaces`), outside the
        store lock: what is saved or shipped must agree with the exported
        stream state (an observe() with no predict since must not ship new
        state over a pre-observe row)."""
        with self._lock:
            bindings = [b for b in self._bindings.values()
                        if namespaces is None or b.namespace in namespaces]
        for b in bindings:
            b.sync()

    def _states(self, namespaces=None) -> Dict[str, Optional[dict]]:
        """namespace -> streaming state: the restored-but-not-resumed
        namespaces' checkpointed states, overwritten by each live
        binding's `export_state()` (None for a predictor without one).
        The caller holds the store lock."""
        states = {ns: st for ns, st in self._saved_states.items()
                  if namespaces is None or ns in namespaces}
        for b in self._bindings.values():
            if namespaces is None or b.namespace in namespaces:
                exp = getattr(b.predictor, "export_state", None)
                states[b.namespace] = exp() if exp is not None else None
        return states

    def save(self, path: str, incremental: bool = False,
             keep_last: Optional[int] = None) -> str:
        """Write per-block npz files + a manifest (JSON): key index,
        generation, per-block generations, and each bound predictor's
        streaming state via `export_state()`.  JSON float repr round-trips
        float64 exactly, so restore is bit-identical.

        `incremental=True` is the generation-delta mode: against the
        manifest already at `path` (which this store must have written or
        been restored from: `save_id`), only blocks whose generation moved
        are rewritten and files of blocks released by evict() are removed.
        The manifest is always rewritten, so the directory is a complete,
        self-contained checkpoint after every save.  The block ids actually
        written land in `last_checkpoint_blocks`.

        `keep_last=N` keeps the last N checkpoint generations restorable
        (`restore(path, generation=...)`): before a block file is
        overwritten or dropped its previous content is hard-linked as
        `block_i.g<gen>.npz`, the outgoing manifest as
        `manifest.g<gen>.json`; older history, orphaned block files and
        staging temps are pruned.  `keep_last=1` keeps only the live
        checkpoint.

        Crash-safe order: new block files are staged under temp names and
        renamed into place, THEN the manifest is replaced, THEN evicted
        blocks' files are deleted, so every manifest on disk references
        complete files."""
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        os.makedirs(path, exist_ok=True)
        self._sync_all()
        with self._lock:
            prev: Optional[dict] = None
            prev_gen: Optional[Dict[int, int]] = None
            mpath = os.path.join(path, MANIFEST_NAME)
            if (incremental or keep_last is not None) \
                    and os.path.exists(mpath):
                with open(mpath) as f:
                    prev = json.load(f)
            if incremental:
                if prev is None:
                    raise FileNotFoundError(
                        f"incremental save needs an existing checkpoint at "
                        f"{path!r}; do a full save first")
                if (prev.get("format") != CHECKPOINT_FORMAT
                        or prev.get("block_size") != self.block_size):
                    raise ValueError(
                        f"cannot incrementally extend checkpoint at "
                        f"{path!r}: format/block_size mismatch")
                if prev.get("save_id") is None \
                        or prev.get("save_id") != self._last_save_id:
                    # generation counters are not comparable across
                    # divergent histories: only the store that wrote or
                    # restored this exact checkpoint may extend it
                    raise ValueError(
                        f"checkpoint at {path!r} was not written by (or "
                        f"restored into) this store — its history may have "
                        f"diverged; do a full save instead")
                prev_gen = {int(k): int(v)
                            for k, v in prev.get("block_gen", {}).items()}
            to_write, to_delete = [], []
            block_gen_out: Dict[str, int] = {}
            for i, blk in enumerate(self._blocks):
                if blk is None:                  # released by evict()
                    if prev_gen is None or i in prev_gen:
                        to_delete.append(i)
                    continue
                # setdefault: a block with no tracked generation (restored
                # from a format-1 checkpoint) gets one stable value — a
                # moving fallback would make every incremental save
                # rewrite it
                g = self._block_gen.setdefault(i, self.generation)
                block_gen_out[str(i)] = g
                if prev_gen is not None and prev_gen.get(i) == g:
                    continue                     # unchanged since last save
                to_write.append((i, {leaf: blk[leaf] for leaf in LEAVES}))
            save_id = os.urandom(8).hex()
            manifest = {"format": CHECKPOINT_FORMAT,
                        "block_size": self.block_size,
                        "generation": self.generation,
                        "save_id": save_id,
                        "n_blocks": len(self._blocks),
                        "block_gen": block_gen_out,
                        "rows": dict(self._rows),
                        "namespaces": self._states()}
        if keep_last is not None and prev is not None:
            _preserve_history(path, prev, [i for i, _ in to_write], to_delete)
        for i, arrs in to_write:
            tmp = os.path.join(path, _block_file(i) + ".tmp")
            with open(tmp, "wb") as f:       # file handle: np.savez must not
                np.savez(f, **arrs)          # append .npz to the temp name
            os.replace(tmp, os.path.join(path, _block_file(i)))
        mtmp = os.path.join(path, MANIFEST_NAME + ".tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(path, MANIFEST_NAME))
        for i in to_delete:
            try:
                os.remove(os.path.join(path, _block_file(i)))
            except FileNotFoundError:
                pass
        if keep_last is not None:
            _gc_checkpoint(path, keep_last, manifest)
        with self._lock:
            self._last_save_id = save_id
        self.last_checkpoint_blocks = [i for i, _ in to_write]
        return path

    @classmethod
    def restore(cls, path: str,
                generation: Optional[int] = None) -> "PosteriorStore":
        """Rebuild a store from the checkpoint at `path`.  By default the
        live checkpoint; `generation=g` selects a superseded one retained
        by `save(keep_last=...)` (its manifest is `manifest.g<g>.json`,
        its blocks resolve to suffixed history files where the live ones
        have since moved on).  Format-1 checkpoints (one `blocks.npz`) are
        read; a missing block file that still holds live rows restores as
        a fresh block (its rows self-repair on resume)."""
        mname = (MANIFEST_NAME if generation is None
                 else _hist_manifest_file(int(generation)))
        with open(os.path.join(path, mname)) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt not in (1, CHECKPOINT_FORMAT):
            raise ValueError(f"unsupported checkpoint format in {path!r}: "
                             f"{fmt!r}")
        store = cls(block_size=manifest["block_size"])
        rows = {k: int(v) for k, v in manifest["rows"].items()}
        if rows:
            vals = list(rows.values())
            if min(vals) < 0 or len(set(vals)) != len(vals):
                raise ValueError(f"manifest rows must be unique and >= 0 "
                                 f"(checkpoint {path!r})")
        store._rows = rows
        store._next_row = max(rows.values()) + 1 if rows else 0
        n_blocks = max(int(manifest.get("n_blocks", 0)),
                       -(-store._next_row // store.block_size))
        live_bids = {r // store.block_size for r in rows.values()}
        block_gen = {int(k): int(v)
                     for k, v in manifest.get("block_gen", {}).items()}

        def load(z) -> Dict[str, np.ndarray]:
            return {leaf: (np.array(z[leaf], np.float64) if leaf in z.files
                           else _new_block(store.block_size)[leaf])
                    for leaf in LEAVES}

        if fmt == 1:                 # legacy single-npz layout (read-only)
            with np.load(os.path.join(path, BLOCKS_NAME)) as z:
                store._blocks = [
                    {leaf: (np.array(z[f"b{i}__{leaf}"], np.float64)
                            if f"b{i}__{leaf}" in z.files
                            else _new_block(store.block_size)[leaf])
                     for leaf in LEAVES} for i in range(n_blocks)]
        else:
            for i in range(n_blocks):
                fpath = os.path.join(path, _block_file(i))
                if generation is not None and i in block_gen:
                    hist = os.path.join(path,
                                        _hist_block_file(i, block_gen[i]))
                    if os.path.exists(hist):
                        fpath = hist
                if os.path.exists(fpath):
                    with np.load(fpath) as z:
                        store._blocks.append(load(z))
                elif i in live_bids:   # tolerated: self-repairs on resume
                    store._blocks.append(_new_block(store.block_size))
                else:                  # released before the checkpoint
                    store._blocks.append(None)
        store.generation = int(manifest["generation"])
        store._block_gen = block_gen
        store._last_save_id = manifest.get("save_id")   # restored state ==
        store._saved_states = manifest.get("namespaces") or {}   # this ckpt:
        return store                                    # may extend it

    def resume(self, tenant: str, workflow: str, predictor,
               benches: Optional[Mapping] = None) -> TenantBinding:
        """Re-attach a freshly constructed predictor to its checkpointed
        namespace.  For predictors with `export_state`/`load_state`
        (OnlinePredictor) the streaming state is loaded back and the first
        sync rewrites every row of the namespace from it in one `put_many`,
        bit-identically — a restarted service reproduces pre-restart
        predictions exactly.  A predictor without `load_state` restacks
        from its own fit on first predict."""
        state = self._saved_states.get(namespace_str(tenant, workflow))
        if state is not None and hasattr(predictor, "load_state"):
            predictor.load_state(state)
        # bind without pinning the sync cursor: the first predict re-syncs
        # every row from the restored state (bit-identical to the stored
        # blocks when the checkpoint was consistent, and self-repairing
        # when it was not — e.g. a manifest written by an external tool)
        return self.bind(tenant, workflow, predictor, benches, sync=False)

    # ---- replica shipping ---------------------------------------------------
    def export_blocks(self, since_generation: int = -1) -> dict:
        """Serializable snapshot delta for read-replica shipping: every
        block whose generation moved past `since_generation`, plus the
        full row index, per-block generations, released block ids, and
        the bound predictors' streaming states.  Blocks are immutable once
        published (copy-on-write), so the returned arrays are references;
        `import_blocks` copies.  `-1` ships everything (bootstrap)."""
        self._sync_all()
        with self._lock:
            blocks: Dict[str, Dict[str, np.ndarray]] = {}
            released: List[int] = []
            for i, blk in enumerate(self._blocks):
                if blk is None:
                    released.append(i)
                    continue
                g = self._block_gen.setdefault(i, self.generation)
                if g > since_generation:
                    blocks[str(i)] = {leaf: blk[leaf] for leaf in LEAVES}
            return {"block_size": self.block_size,
                    "generation": self.generation,
                    "n_blocks": len(self._blocks),
                    "released": released,
                    "block_gen": {str(i): int(g)
                                  for i, g in self._block_gen.items()},
                    "rows": dict(self._rows),
                    "blocks": blocks,
                    "namespaces": self._states()}

    # ---- live resharding (namespace migration) ------------------------------
    def export_namespaces(self, namespaces: Sequence[str]) -> dict:
        """Serializable migration payload for a set of `tenant/workflow`
        namespaces: their posterior rows, gathered leaf-stacked off one
        copy-on-write snapshot (a concurrent writer cannot tear a row),
        plus their streaming states, in a layout `import_namespaces` can
        merge into a live store whose row allocation differs.  The caller
        quiesces writes first; the named bindings are synced here."""
        wanted = set(namespaces)
        self._sync_all(wanted)
        with self._lock:
            prefixes = tuple(ns + SEP for ns in wanted)
            keys = [k for k in self._rows if k.startswith(prefixes)]
            snap = self.snapshot()
            states = {ns: self._saved_states.get(ns) for ns in wanted}
            states.update(self._states(wanted))
        leaves = (snap.gather(keys) if keys
                  else {leaf: np.empty((0,) + LEAF_SHAPES[leaf], np.float64)
                        for leaf in LEAVES})
        return {"keys": keys, "leaves": leaves,
                "generation": snap.generation, "namespaces": states}

    def import_namespaces(self, payload: Mapping) -> int:
        """Merge an `export_namespaces` payload into this store: every
        shipped row lands via `put_many` (ONE copy-on-write generation,
        rows allocated in *this* store's layout, so a resident plane sees
        them as dirty) and the shipped streaming states are staged so a
        following `resume()` re-attaches a predictor bit-identically.
        Unlike `import_blocks` this is a merge: the store may be live and
        own other namespaces.  Returns the number of rows installed."""
        leaves = payload["leaves"]
        items = [(k, {leaf: np.asarray(leaves[leaf][i], np.float64)
                      for leaf in LEAVES})
                 for i, k in enumerate(payload["keys"])]
        if items:
            self.put_many(items)
        with self._lock:
            for ns, state in (payload.get("namespaces") or {}).items():
                self._saved_states[ns] = state
        return len(items)

    def import_blocks(self, payload: Mapping) -> int:
        """Install an `export_blocks` payload into a *passive* replica
        store (refused when live bindings exist: a binding's sync would
        race the install and row indices could diverge; so no resident
        plane can outlive the row index this replaces).  The row index is
        replaced wholesale and arrays are copied, so the replica never
        aliases the primary in-process.  Returns the number of blocks
        installed."""
        with self._lock:
            if self._bindings:
                raise RuntimeError(
                    "import_blocks targets passive replica stores; this "
                    "store has live bindings — evict them first")
            if int(payload["block_size"]) != self.block_size:
                raise ValueError(
                    f"block_size mismatch: snapshot has "
                    f"{payload['block_size']}, store has {self.block_size}")
            gen = int(payload["generation"])
            if gen < self.generation:
                raise ValueError(
                    f"stale snapshot: generation {gen} behind replica "
                    f"generation {self.generation}")
            staged: Dict[int, Dict[str, np.ndarray]] = {}
            for k, arrs in (payload.get("blocks") or {}).items():
                blk: Dict[str, np.ndarray] = {}
                for leaf in LEAVES:
                    a = np.array(arrs[leaf], np.float64)
                    want = (self.block_size,) + LEAF_SHAPES[leaf]
                    if a.shape != want:
                        raise ValueError(
                            f"snapshot block {k} leaf {leaf!r} has shape "
                            f"{a.shape}, expected {want}")
                    blk[leaf] = a
                staged[int(k)] = blk
            n_blocks = int(payload["n_blocks"])
            while len(self._blocks) < n_blocks:
                self._blocks.append(None)
            for i in payload.get("released") or []:
                self._blocks[int(i)] = None
            for i, blk in staged.items():
                self._blocks[i] = blk
            self._rows = {str(k): int(v)
                          for k, v in payload["rows"].items()}
            self._next_row = (max(self._rows.values()) + 1
                              if self._rows else 0)
            self._free_rows = []
            self._block_gen = {int(k): int(v) for k, v in
                               (payload.get("block_gen") or {}).items()}
            self.generation = gen
            if payload.get("namespaces") is not None:
                self._saved_states = dict(payload["namespaces"])
            self._snap = None
            return len(staged)

    # ---- row eviction -------------------------------------------------------
    def evict(self, tenant: str, workflow: str) -> int:
        """Retire a workflow's namespace: drop its binding, checkpointed
        streaming state, and every `tenant/workflow/*` row.  Freed row
        slots are recycled by later put_many allocations, and blocks left
        with no live row release their backing arrays (`num_free_blocks`).
        Returns the number of rows evicted; raises KeyError when the
        namespace has neither rows nor a binding.

        Snapshots taken before the evict keep serving the old rows (the
        key index is replaced, not mutated); afterwards, a service still
        holding the binding fails loudly on sync, and new snapshots refuse
        the evicted keys."""
        ns = namespace_str(tenant, workflow)
        with self._lock:
            binding = self._bindings.pop((tenant, workflow), None)
            self._saved_states.pop(ns, None)
        if binding is not None:
            # outside the store lock (an in-flight sync may need put_many):
            # after this, no later sync can write the purged rows back
            with binding._sync_lock:
                binding._detached = True
                binding._detach_reason = (
                    f"namespace {ns!r} was evicted from the store; services "
                    f"holding this binding must be rebuilt")
        prefix = ns + SEP
        with self._lock:
            victims = [k for k in self._rows if k.startswith(prefix)]
            if not victims and binding is None:
                raise KeyError(f"namespace {ns!r} has no rows and no "
                               f"binding; known: {self.namespaces()}")
            if not victims:
                return 0
            for k in victims:
                heapq.heappush(self._free_rows, self._rows[k])
            rows = {k: r for k, r in self._rows.items()
                    if not k.startswith(prefix)}
            self._rows = rows            # old snapshots keep the old index
            live_bids = {r // self.block_size for r in rows.values()}
            for bid in range(len(self._blocks)):
                if bid not in live_bids:
                    self._blocks[bid] = None
                    self._block_gen.pop(bid, None)
            self.generation += 1
            self._snap = None
            return len(victims)
