"""Fault-tolerant checkpointing, the counterpart of the JAX package's
`train/checkpoint.py`, writing and reading the reference's files: atomic
writes, resumable state, the newest readable checkpoint restored.

A checkpoint is one `.npz` of every leaf, its key the leaf's path joined
with "||" in the reference's order (dict keys sorted, None skipped), with
a `__meta__` JSON of the step, the caller's meta and each leaf's dtype;
bfloat16 is stored as a uint16 view.  A checkpoint written by either
package restores in the other.  Writes go to a temp file and an atomic
rename, so a crash mid-save never corrupts the latest checkpoint;
`restore_checkpoint` falls back to the previous one if the newest is
unreadable; three are kept.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import tree_items

Tree = Any
_SEP = "||"
KEEP = 3


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """path -> (host array, dtype name) in the reference's leaf order."""
    flat = {}
    for path, leaf in tree_items(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = _host(leaf)
        flat[_SEP.join(path)] = (arr, "bfloat16" if bf16 else str(arr.dtype))
    return flat


def save_checkpoint(directory: str, step: int, state: Tree,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(state)
    arrays = {k: a for k, (a, _) in flat.items()}
    payload = dict(meta or {})
    payload.update({"step": int(step),
                    "dtypes": {k: d for k, (_, d) in flat.items()}})
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(payload).encode(), dtype=np.uint8), **arrays)
        final = os.path.join(directory, f"ckpt_{step:08d}.npz")
        os.replace(tmp, final)               # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc(directory, keep=KEEP)
    return final


def _ckpt_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for fn in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", fn)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, fn)))
    return sorted(out)


def _gc(directory: str, keep: int):
    ckpts = _ckpt_steps(directory)
    for _, path in ckpts[:-keep]:
        os.unlink(path)


def latest_step(directory: str) -> Optional[int]:
    ckpts = _ckpt_steps(directory)
    return ckpts[-1][0] if ckpts else None


def _tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


def _rebuild(like: Tree, leaves: Dict[str, torch.Tensor],
             prefix: Tuple[str, ...] = ()) -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    return leaves[_SEP.join(prefix)]


def restore_checkpoint(directory: str, like: Tree
                       ) -> Optional[Tuple[int, Tree, dict]]:
    """Restore the newest readable checkpoint into the structure of `like`
    (each leaf on the device of `like`'s leaf) -> (step, state, meta), or
    None when no checkpoint reads."""
    for step, path in reversed(_ckpt_steps(directory)):
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
                dtypes = meta.pop("dtypes")
                leaves = {}
                for p, leaf in tree_items(like):
                    k = _SEP.join(p)
                    leaves[k] = _tensor(z[k], dtypes[k], leaf)
            return step, _rebuild(like, leaves), meta
        except Exception:          # corrupted/partial: fall back to previous
            continue
    return None


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one in flight at a time).  The
    state is copied from the device to the host before the writing thread
    starts, so the caller may update it in place at once."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Tree, meta: Optional[dict] = None):
        self.wait()
        host_state = _host_tree(state)                # device -> host copy
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, host_state, meta), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _host_tree(tree: Tree) -> Tree:
    """Copies of the leaves on the host (tensors stay tensors, so bfloat16
    keeps its dtype tag)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)
