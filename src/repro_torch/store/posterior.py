"""PosteriorStore: the single multi-tenant owner of all posterior state
(the in-memory store; checkpointing and replica shipping are not part of
this package yet).

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

The gathered rows are what the predictive kernel reads: a gather is one
contiguous float64 array per leaf, packed into the kernel's rows
(`kernels.bayes_fit.pack_predict`), which cross to the card in one
transfer.

`TenantBinding` is the per-namespace glue: it owns the sync cursor between
a predictor's mutable state and the store rows (incremental via the
predictor's non-destructive change feed, `changed_since(cursor)`, where the
predictor has one) and the version-scoped static-factor cache.
"""
from __future__ import annotations

import contextlib
import heapq
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
        self._next_row = 0                       # allocation cursor
        self._free_rows: List[int] = []          # heap of evicted row slots
        self._blocks: List[Dict[str, np.ndarray]] = []
        self._block_gen: Dict[int, int] = {}     # block id -> generation of
                                                 # its last rewrite (the
                                                 # dirty-row feed)
        self._bindings: Dict[Tuple[str, str], TenantBinding] = {}
        self._snap: Optional[StoreSnapshot] = None

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
                        row = self._next_row   # never len(_rows): evicted
                        self._next_row += 1    # slots leave gaps
                    self._rows[ks] = row
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

    # ---- row eviction -------------------------------------------------------
    def evict(self, tenant: str, workflow: str) -> int:
        """Retire a workflow's namespace: drop its binding and every
        `tenant/workflow/*` row.  Freed row
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
