"""Process-stable RNG seed derivation.

Python's builtin `hash()` of strings is salted per process
(PYTHONHASHSEED), so `abs(hash(key)) % m` gives a *different* ground
truth / benchmark reading in every interpreter — simulations were not
reproducible across runs or between the CLI and the test-suite.  All
simulation seeds now derive from a CRC-32 digest of the key's repr,
which is stable across processes, platforms, and Python versions.
"""
from __future__ import annotations

import zlib


def stable_seed(*parts) -> int:
    """Deterministic 31-bit seed from an arbitrary key tuple."""
    key = "\x1f".join(repr(p) for p in parts).encode("utf-8")
    return zlib.crc32(key) & 0x7FFFFFFF
