"""Packed operand slabs on their way to the device, built in place.

A kernel whose operands cross as one packed float64 slab (`bayes_predict`'s
column groups, `nig_fold`'s ragged rows) is fed through `staged(device)`:

    with staged(dev) as st:
        buf = st.host(n)        # n float64 slots of host memory to fill
        ...                     # the packer writes the slab into buf
        slab = st.send()        # the slab as a tensor on dev

On a card the slots are a pinned buffer, one a device, kept and reused:
the slab goes up in ONE asynchronous copy, and before the buffer is
written again `host` waits on the event recorded after its last copy.  The
context holds the device's buffer from `host` to `send`, so two threads
never fill it at once.  On the CPU the slots are a new numpy array and
`send` wraps it, copying nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

import numpy as np
import torch

_F64 = torch.float64


class _Plain:
    """The CPU's stage: a new array, handed over as it is."""

    def host(self, n: int) -> np.ndarray:
        self._arr = np.empty(n, np.float64)
        return self._arr

    def send(self) -> torch.Tensor:
        return torch.from_numpy(self._arr)


class _Pinned:
    """A device's stage: one pinned buffer, grown to the largest slab
    asked for, and the event of its last copy up."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self._buf = None
        self._copied = None          # event recorded after the last copy
        self._n = 0

    def host(self, n: int) -> np.ndarray:
        if self._buf is None or self._buf.numel() < n:
            # a new buffer; the caching host allocator holds the old one
            # until its recorded copy has run
            size = max(n, 2 * (0 if self._buf is None else self._buf.numel()))
            self._buf = torch.empty(size, dtype=_F64, pin_memory=True)
        elif self._copied is not None:
            self._copied.synchronize()
        self._n = n
        return self._buf.numpy()[:n]

    def send(self) -> torch.Tensor:
        out = torch.empty(self._n, dtype=_F64, device=self.device)
        out.copy_(self._buf[:self._n], non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out


_PINNED: Dict[torch.device, _Pinned] = {}
_PINNED_LOCK = threading.Lock()


def resolve(device) -> torch.device:
    """`device` with a card's index filled in (the current card's)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def staged(device) -> Iterator:
    """The stage for one slab to `device` (see the module docstring)."""
    dev = resolve(device)
    if dev.type != "cuda":
        yield _Plain()
        return
    with _PINNED_LOCK:
        stage = _PINNED.get(dev)
        if stage is None:
            stage = _PINNED[dev] = _Pinned(dev)
    with stage.lock:
        yield stage
