"""The port's wire framing, placement and oplog (`repro_torch.serve.wire`,
`placement`, `failover.OpLog`) against the JAX package's copies, on the
CPU: frames byte for byte the reference's under msgpack and under the
JSON + base64 fallback, each package decoding the other's frames, the
torn-tail rules, one ring placing every namespace on the same shard in
both packages, and an oplog written by either replaying in the other.

Fixed seeds, no hypothesis."""
import asyncio
import struct

import numpy as np
import pytest

from repro.serve import failover as jfailover
from repro.serve import placement as jplacement
from repro.serve import wire as jwire
from repro_torch.serve import failover as tfailover
from repro_torch.serve import placement as tplacement
from repro_torch.serve import wire as twire

WIRES = {"repro": jwire, "repro_torch": twire}
CODECS = ("msgpack", "json")
N_NAMESPACES = 10_000


@pytest.fixture(params=CODECS)
def codec(request, monkeypatch):
    """Both packages' wire modules on one codec: msgpack, or the JSON +
    base64 fallback (msgpack patched to None in both)."""
    if request.param == "json":
        monkeypatch.setattr(jwire, "msgpack", None)
        monkeypatch.setattr(twire, "msgpack", None)
    else:
        assert jwire.msgpack is not None and twire.msgpack is not None
    return request.param


def _corpus():
    """Nested dicts, ndarrays of several dtypes and shapes, numpy scalars,
    bytes, None and the shapes the tier really sends."""
    rng = np.random.default_rng(34)
    arrays = [rng.normal(size=(5, 3)), rng.normal(size=7).astype(np.float32),
              rng.integers(-9, 9, size=(2, 2, 3)).astype(np.int64),
              rng.integers(0, 255, size=11).astype(np.uint8),
              np.array([True, False, True]), np.zeros((0, 3)),
              np.asfortranarray(rng.normal(size=(3, 4))),
              rng.normal(size=(4, 6))[:, ::2],           # not contiguous
              rng.normal(size=(2, 3)).astype(">f8")]     # big-endian
    return [
        {"op": "predict", "i": 7, "v": 3, "t": "acme", "w": "rnaseq",
         "x": [["bwa", None, 1.5], ["idx", "A1", 0.25]]},
        {"i": 1, "ok": True, "r": {"p": arrays[0].astype(np.float32)}},
        {"arrays": arrays, "nested": {"a": [1, 2.5, True, None, "s"],
                                      "b": b"\x00\xffraw", "c": {"d": []}}},
        {"f": np.float64(1.0 / 3.0), "g": np.float32(0.1), "h": np.int64(-3),
         "k": np.int32(5), "m": np.bool_(True), "n": np.uint16(9)},
        {"i": 2, "ok": False, "e": {"k": "wrong_shard", "m": "x",
                                    "map": {"version": 3, "vnodes": 64,
                                            "shards": [["s0", "h", 1]]}}},
        {"q": 12, "g": [{"q": 11, "t": "a", "w": "b",
                         "c": {"workflow": "b", "uid": "u", "task": "bwa",
                               "node": "local", "input_gb": 1e-300,
                               "runtime_s": 1.5e300, "finish_time": 0.0}},
                        {"q": 12, "t": "a", "w": "b", "c": {}}]},
        [1, -1, 2 ** 40, -(2 ** 63), 2 ** 64 - 1, 0.5, float("inf"), "é"],
    ]


def _same(a, b) -> bool:
    """Structural equality that compares ndarrays by dtype, shape and
    bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", range(len(_corpus())))
def test_frames_byte_equal_across_packages(codec, case):
    obj = _corpus()[case]
    got, want = twire.frame(obj), jwire.frame(obj)
    assert got == want
    assert twire.encode(obj) == jwire.encode(obj)
    # each package decodes the other's frames to the same objects
    assert _same(twire.decode(want[4:]), jwire.decode(want[4:]))
    assert _same(jwire.decode(got[4:]), twire.decode(got[4:]))


def test_ndarray_decodes_writable_and_exact(codec):
    arr = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
    for src, dst in ((jwire, twire), (twire, jwire)):
        out = dst.decode(src.encode({"p": arr}))["p"]
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert out.tobytes() == arr.tobytes() and out.flags.writeable


def test_max_frame_is_the_wire_contract(codec):
    assert twire.MAX_FRAME == jwire.MAX_FRAME == 64 * 1024 * 1024
    big = np.zeros(twire.MAX_FRAME // 8 + 16, dtype=np.float64)
    with pytest.raises(twire.FrameTooLarge):
        twire.frame({"p": big})


def _stream_with(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


@pytest.mark.parametrize("writer", sorted(WIRES))
def test_read_frame_rules_on_either_packages_frames(codec, writer):
    """The port's stream reader on frames either package wrote: clean EOF
    between frames, a torn header or payload raises TruncatedFrame, an
    oversized header FrameTooLarge."""
    w = WIRES[writer]

    async def go():
        r = _stream_with(w.frame({"i": 1}) + w.frame({"i": 2}))
        assert (await twire.read_frame(r))["i"] == 1
        assert (await twire.read_frame(r))["i"] == 2
        assert await twire.read_frame(r) is None
        with pytest.raises(twire.TruncatedFrame):
            await twire.read_frame(_stream_with(b"\x00\x00"))
        whole = w.frame({"i": 1, "pad": "x" * 64})
        with pytest.raises(twire.TruncatedFrame):
            await twire.read_frame(_stream_with(whole[:-5]))
        evil = struct.pack(">I", twire.MAX_FRAME + 1) + b"x"
        with pytest.raises(twire.FrameTooLarge):
            await twire.read_frame(_stream_with(evil))
    asyncio.run(go())


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_file_framing_torn_tail_across_packages(codec, tmp_path, writer,
                                                reader):
    p = tmp_path / "log.bin"
    with open(p, "ab") as f:
        for i in range(5):
            n = WIRES[writer].append_frame(f, {"q": i + 1, "v": "x" * 10})
            assert n == len(WIRES[reader].frame({"q": i + 1,
                                                 "v": "x" * 10}))
    raw = p.read_bytes()
    p.write_bytes(raw[:-7])                       # torn mid-frame
    with open(p, "rb") as f:
        assert [r["q"] for _, r in WIRES[reader].iter_frames(f)] == \
            [1, 2, 3, 4]
    p.write_bytes(raw + struct.pack(">I", twire.MAX_FRAME + 99) + b"junk")
    with open(p, "rb") as f:                      # a corrupt header stops
        assert len(list(WIRES[reader].iter_frames(f))) == 5


# --- placement -----------------------------------------------------------------
def _namespaces():
    rng = np.random.default_rng(7)
    return [f"t{int(rng.integers(0, 10 ** 9))}/w{i % 37}"
            for i in range(N_NAMESPACES)]


def _maps(n=3, version=1):
    shards = [(f"s{i}", "127.0.0.1", 9000 + i) for i in range(n)]
    return (tplacement.ShardMap([tplacement.ShardInfo(*s) for s in shards],
                                version=version),
            jplacement.ShardMap([jplacement.ShardInfo(*s) for s in shards],
                                version=version))


def test_stable_hash_and_ring_equal_across_packages():
    names = _namespaces()
    assert [tplacement.stable_hash(s) for s in names] == \
        [jplacement.stable_hash(s) for s in names]
    assert tplacement.VNODES == jplacement.VNODES == 64
    tm, jm = _maps(3, version=5)
    assert tm.to_wire() == jm.to_wire()
    assert tm._ring == jm._ring
    owners = [tm.shard_for(ns) for ns in names]
    assert owners == [jm.shard_for(ns) for ns in names]
    assert min(owners.count(s) for s in ("s0", "s1", "s2")) \
        > N_NAMESPACES // 10
    # a map crossing the wire keeps its placement, in either direction
    tj = tplacement.ShardMap.from_wire(jm.to_wire())
    jt = jplacement.ShardMap.from_wire(tm.to_wire())
    assert tj.version == jt.version == 5
    assert [tj.shard_for(ns) for ns in names] == owners
    assert [jt.shard_for(ns) for ns in names] == owners


@pytest.mark.parametrize("change", ["with_shard", "without_shard",
                                    "with_address"])
def test_moved_equal_across_packages(change):
    names = _namespaces()
    tm, jm = _maps(3)
    if change == "with_shard":
        tn, jn = (m.with_shard("s3", "127.0.0.1", 9003) for m in (tm, jm))
    elif change == "without_shard":
        tn, jn = tm.without_shard("s1"), jm.without_shard("s1")
    else:
        tn, jn = (m.with_address("s1", "127.0.0.1", 19999)
                  for m in (tm, jm))
    assert tn.to_wire() == jn.to_wire() and tn.version == tm.version + 1
    moved = tm.moved(tn, names)
    assert moved == jm.moved(jn, names)
    if change == "with_address":
        assert moved == []
    else:
        assert 0 < len(moved) < N_NAMESPACES // 2
    with pytest.raises(KeyError):
        tm.without_shard("nope")
    with pytest.raises(ValueError):
        tplacement.ShardMap([])


# --- the oplog -----------------------------------------------------------------
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_oplog_replays_in_the_other_package(codec, tmp_path, writer):
    """Singles and group commits written by one package's OpLog: the
    other's replay yields the same records past a watermark, its reopen
    recovers the sequence, a torn group is dropped whole, and both
    packages' appends interleave into one dense log."""
    logs = {"repro": jfailover.OpLog, "repro_torch": tfailover.OpLog}
    other = "repro" if writer == "repro_torch" else "repro_torch"
    path = str(tmp_path / "s0.oplog")
    log = logs[writer](path)
    comp = {"workflow": "w", "uid": "u", "task": "bwa", "node": "local",
            "input_gb": 1.25, "runtime_s": 31.5, "finish_time": 0.0}
    assert log.append({"t": "a", "w": "w", "c": comp}) == 1
    assert log.append_many([{"t": "a", "w": "w", "c": comp},
                            {"t": "b", "w": "v", "c": comp}]) == [2, 3]
    assert log.append_many([]) == []
    log.close()
    want = list(logs[writer].replay(path, after_seq=1))
    got = list(logs[other].replay(path, after_seq=1))
    assert got == want and [r["q"] for r in got] == [2, 3]
    assert [r["t"] for r in logs[other].replay(path)] == ["a", "a", "b"]
    reopened = logs[other](path)                  # the other package
    assert reopened.last_seq == 3                 # appends after it
    assert reopened.append({"t": "c", "w": "w", "c": comp}) == 4
    assert reopened.append_many([{"t": "c", "w": "w", "c": comp}]) == [5]
    reopened.close()
    assert [r["q"] for r in logs[writer].replay(path)] == [1, 2, 3, 4, 5]
    with open(path, "rb+") as f:                  # tear the last group
        f.truncate(len(f.read()) - 3)
    assert logs[writer](path).last_seq == logs[other](path).last_seq == 4
