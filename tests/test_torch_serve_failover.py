"""Warm failover of the port's shards as real processes, on the CPU: the
port's `ShardSupervisor` starts `python -m repro_torch.serve.shard
--device cpu` children (bootstrap `tests.torch_serve_helpers:bootstrap`,
which imports no JAX), one is SIGKILLed with acknowledged observations
past its checkpoint, and `failover` restores and replays it: its digests
and predictions are bit-identical, it replayed exactly the tail acked
after the checkpoint, and no ack was lost.  Then `HealthMonitor.classify`
on the reference's cases, poll for poll against the reference monitor.

Fixed seeds, no hypothesis; one kill (three child starts)."""
import asyncio
import json
import os

import numpy as np
import pytest

from repro.serve import HealthMonitor as JMonitor
from repro.serve import HealthPolicy as JPolicy
from repro.serve import ShardInfo as JInfo
from repro.serve import ShardMap as JMap
from repro.serve import ShardSupervisor as JSupervisor
from repro_torch.online import TaskCompletion
from repro_torch.serve import failover as tfailover
from repro_torch.serve import (HealthMonitor, HealthPolicy, ServingClient,
                               ShardInfo, ShardMap, ShardSpec,
                               ShardSupervisor)
from torch_serve_helpers import TENANTS

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOTSTRAP = "tests.torch_serve_helpers:bootstrap"


def test_supervisor_spawns_the_ports_shard_without_jax(monkeypatch):
    """The child is `python -m repro_torch.serve.shard` with the spec's
    extra arguments, and its environment gains no JAX setting."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    seen = {}

    class Refused(Exception):
        pass

    def popen(cmd, **kw):
        seen.update(cmd=cmd, env=kw["env"])
        raise Refused

    monkeypatch.setattr(tfailover.subprocess, "Popen", popen)
    with pytest.raises(Refused):
        ShardSupervisor(repo_root=_REPO_ROOT).start(
            ShardSpec("s0", BOOTSTRAP, "ckpt", "oplog",
                      extra_args=["--device", "cpu"]), "{}")
    assert seen["cmd"][1:3] == ["-m", "repro_torch.serve.shard"]
    assert seen["cmd"][-2:] == ["--device", "cpu"]
    assert "JAX_PLATFORMS" not in seen["env"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == \
        os.path.join(_REPO_ROOT, "src")


def test_kill_and_failover_bit_identical(tmp_path):
    async def go():
        sids = ["s0", "s1"]
        m = ShardMap([ShardInfo(s, "127.0.0.1", 0) for s in sids])
        with ShardSupervisor(repo_root=_REPO_ROOT,
                             ready_timeout_s=240) as sup:
            for sid in sids:
                spec = ShardSpec(sid, BOOTSTRAP,
                                 os.path.join(str(tmp_path), sid + "_ckpt"),
                                 os.path.join(str(tmp_path), sid + ".oplog"),
                                 extra_args=["--device", "cpu"])
                port = sup.start(spec, json.dumps(m.to_wire()))
                m = m.with_address(sid, "127.0.0.1", port)
                assert sup.ready[sid]["replayed"] == 0
            client = ServingClient(m)
            try:
                await client.update_maps()
                t, w = TENANTS[0]
                victim = m.shard_for(f"{t}/{w}")
                survivor = next(s for s in sids if s != victim)
                acked = []
                for i in range(6):
                    acked.append(await client.observe(TaskCompletion(
                        w, f"u{i}", "bwa", "local", 1.0 + 0.5 * i,
                        20.0 + 10.0 * i), t, w))
                ck = await client.checkpoint(victim)
                assert ck["seq"] == acked[-1]
                # the tail past the watermark: one group commit, local and
                # remote completions
                acked += await client.observe_many(
                    [(TaskCompletion(w, f"u{i}", ("bwa", "idx")[i % 2],
                                     ("local", "N1")[i % 2], 1.0 + 0.5 * i,
                                     20.0 + 10.0 * i), t, w)
                     for i in range(6, 12)])
                assert acked == list(range(1, 13))
                digests = {ns: await client.digest(*ns) for ns in TENANTS
                           if m.shard_for("/".join(ns)) == victim}
                qs = [("bwa", None, 2.0), ("idx", "A1", 1.5)]
                pred_before = await client.predict(qs, t, w)

                sup.kill(victim)
                surv_ns = next((t2, w2) for t2, w2 in TENANTS
                               if m.shard_for(f"{t2}/{w2}") == survivor)
                out = await client.predict([("bwa", None, 1.0)], *surv_ns)
                assert out.shape == (1, 3)

                loop = asyncio.get_running_loop()
                port = await loop.run_in_executor(
                    None, sup.failover, victim, json.dumps(m.to_wire()))
                assert sup.ready[victim]["replayed"] == 6
                assert {"port", "pid", "replay_ms", "boot_ms"} <= \
                    set(sup.ready[victim])
                client.set_map(m.with_address(victim, "127.0.0.1", port))
                await client.update_maps()
                health = await client.health(victim)
                assert health["seq"] == acked[-1]
                for ns, d in digests.items():
                    assert await client.digest(*ns) == d
                np.testing.assert_array_equal(
                    await client.predict(qs, t, w), pred_before)
                seq = await client.observe(TaskCompletion(
                    w, "u-post", "sort", "local", 2.0, 44.0), t, w)
                assert seq == acked[-1] + 1
            finally:
                await client.close()
    asyncio.run(go())


# --- health monitor: classification (no processes) -----------------------------
_OK = {"last_ingest_error": None, "pending_ingest": 0}
_BAD = {"last_ingest_error": "OSError('disk')", "pending_ingest": 0}
_DEEP = {"last_ingest_error": None, "pending_ingest": 500}
CLASSIFY_CASES = {
    "dead": (dict(), [(False, None)]),
    "missed": (dict(max_missed_polls=3),
               [(True, None), (True, None), (True, _OK), (True, None),
                (True, None), (True, None)]),
    "ingest_error": (dict(max_error_polls=2, max_backlog_polls=2,
                          max_pending_ingest=10),
                     [(True, _BAD), (True, _OK), (True, _BAD),
                      (True, _BAD)]),
    "backlog": (dict(max_backlog_polls=2, max_pending_ingest=10),
                [(True, _DEEP), (True, _OK), (True, _DEEP), (True, _DEEP)]),
    "backlog_off": (dict(), [(True, _DEEP)] * 5),
}
CLASSIFY_LAST = {"dead": "process exited", "missed": "unreachable",
                 "ingest_error": "ingest error", "backlog": "backlog",
                 "backlog_off": None}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_health_classify_matches_reference(case):
    pol, polls = CLASSIFY_CASES[case]
    mon = HealthMonitor(ShardSupervisor(repo_root=_REPO_ROOT),
                        ShardMap([ShardInfo("s0", "127.0.0.1", 1)]),
                        policy=HealthPolicy(**pol))
    ref = JMonitor(JSupervisor(repo_root=_REPO_ROOT),
                   JMap([JInfo("s0", "127.0.0.1", 1)]),
                   policy=JPolicy(**pol))
    got = [mon.classify("s0", alive, h) for alive, h in polls]
    assert got == [ref.classify("s0", alive, h) for alive, h in polls]
    assert all(v is None for v in got[:-1])
    if CLASSIFY_LAST[case] is None:
        assert got[-1] is None
    else:
        assert CLASSIFY_LAST[case] in got[-1]
