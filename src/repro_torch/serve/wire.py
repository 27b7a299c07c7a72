"""Length-prefixed binary RPC framing for the distributed serving plane.

One frame = a 4-byte big-endian payload length followed by a msgpack
payload (JSON + base64 when msgpack is unavailable — same wire contract,
slower).  Numpy arrays travel as raw little-endian bytes with dtype/shape
tags, so a (Q, 3) prediction block costs ~24 bytes/row instead of a float
repr per cell, and decoding is a single `np.frombuffer`.

The same framing is reused for three different byte streams:
  * the shard RPC sockets (asyncio `read_frame`/`write_frame`),
  * the per-shard append-only observation oplog (`append_frame`/
    `iter_frames`, which tolerate a torn tail — a crash mid-append must
    not poison replay of everything before it),
  * replica snapshot shipping (block payloads are just frames).

Frames are bounded (`MAX_FRAME`): a corrupt or adversarial header must
fail fast instead of asking asyncio to buffer gigabytes.
"""
from __future__ import annotations

import asyncio
import base64
import json
import struct
from typing import Any, BinaryIO, Iterator, Optional, Tuple

import numpy as np

try:                                     # baked into the serving image; the
    import msgpack                       # JSON fallback keeps dev machines
except ModuleNotFoundError:              # without it on the same wire shape
    msgpack = None

MAX_FRAME = 64 * 1024 * 1024             # 64 MiB: > any sane batch/snapshot
_HEADER = struct.Struct(">I")

# tag keys for the ndarray encoding ({tag: 1, d: dtype, s: shape, b: bytes})
_ND, _ND_DTYPE, _ND_SHAPE, _ND_BYTES = "__nd__", "d", "s", "b"
_B64 = "__b64__"                         # JSON fallback: bytes leaves


class WireError(RuntimeError):
    """Base of every framing failure."""


class FrameTooLarge(WireError):
    """A header announced (or a payload reached) more than MAX_FRAME."""


class TruncatedFrame(WireError):
    """The stream ended mid-frame (torn write / dropped connection)."""


def _pack_default(o):
    if isinstance(o, np.ndarray):
        a = np.ascontiguousarray(o)
        return {_ND: 1, _ND_DTYPE: a.dtype.str, _ND_SHAPE: list(a.shape),
                _ND_BYTES: a.tobytes()}
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    raise TypeError(f"cannot encode {type(o).__name__} on the wire")


def _unpack_hook(d):
    if d.get(_ND) == 1:
        # .copy(): frombuffer views are read-only and would pin the whole
        # receive buffer alive; callers expect ordinary writable arrays
        return np.frombuffer(d[_ND_BYTES], d[_ND_DTYPE]) \
            .reshape(d[_ND_SHAPE]).copy()
    return d


def _jsonize(o):
    if isinstance(o, np.ndarray):
        o = _pack_default(o)
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    if isinstance(o, (bytes, bytearray)):
        return {_B64: base64.b64encode(bytes(o)).decode("ascii")}
    if isinstance(o, dict):
        return {k: _jsonize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonize(v) for v in o]
    return o


def _dejson(o):
    if isinstance(o, dict):
        if _B64 in o and len(o) == 1:
            return base64.b64decode(o[_B64])
        d = {k: _dejson(v) for k, v in o.items()}
        return _unpack_hook(d)
    if isinstance(o, list):
        return [_dejson(v) for v in o]
    return o


def encode(obj: Any) -> bytes:
    """Object -> payload bytes (no header)."""
    if msgpack is not None:
        return msgpack.packb(obj, default=_pack_default, use_bin_type=True)
    return json.dumps(_jsonize(obj)).encode()


def decode(payload: bytes) -> Any:
    """Payload bytes -> object (inverse of `encode`)."""
    if msgpack is not None:
        return msgpack.unpackb(payload, object_hook=_unpack_hook, raw=False,
                               strict_map_key=False)
    return _dejson(json.loads(payload.decode()))


def frame(obj: Any) -> bytes:
    """Object -> one complete frame (header + payload)."""
    payload = encode(obj)
    if len(payload) > MAX_FRAME:
        raise FrameTooLarge(f"frame of {len(payload)} bytes exceeds "
                            f"MAX_FRAME={MAX_FRAME}")
    return _HEADER.pack(len(payload)) + payload


# ---- asyncio stream framing -------------------------------------------------
async def read_frame(reader: asyncio.StreamReader) -> Optional[Any]:
    """Read one frame; None on clean EOF (peer closed between frames)."""
    try:
        header = await reader.readexactly(_HEADER.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise TruncatedFrame("stream ended inside a frame header") from e
    (size,) = _HEADER.unpack(header)
    if size > MAX_FRAME:
        raise FrameTooLarge(f"peer announced a {size}-byte frame "
                            f"(MAX_FRAME={MAX_FRAME})")
    try:
        payload = await reader.readexactly(size)
    except asyncio.IncompleteReadError as e:
        raise TruncatedFrame(f"stream ended {size - len(e.partial)} bytes "
                             f"short of a {size}-byte frame") from e
    return decode(payload)


async def write_frame(writer: asyncio.StreamWriter, obj: Any) -> int:
    """Write one frame; returns its bytes (header included)."""
    buf = frame(obj)
    writer.write(buf)
    await writer.drain()
    return len(buf)


# ---- file framing (oplog / snapshot files) ----------------------------------
def append_frame(f: BinaryIO, obj: Any) -> int:
    """Append one frame to a file; returns bytes written.  flush() moves
    the bytes to the OS, so the record survives the *process* dying (the
    kill-one-shard failover contract); surviving a machine crash would
    additionally need fsync, which the serving path deliberately skips."""
    buf = frame(obj)
    f.write(buf)
    f.flush()
    return len(buf)


def iter_frames(f: BinaryIO) -> Iterator[Tuple[int, Any]]:
    """Yield (offset, obj) for every complete frame; a torn tail (crash
    mid-append) ends iteration instead of raising — everything before it
    is intact by construction (append-only, flushed per record)."""
    while True:
        offset = f.tell()
        header = f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            return
        (size,) = _HEADER.unpack(header)
        if size > MAX_FRAME:
            return                       # corrupt header: stop at the tear
        payload = f.read(size)
        if len(payload) < size:
            return
        try:
            yield offset, decode(payload)
        except Exception:                # noqa: BLE001 — torn payload bytes
            return
