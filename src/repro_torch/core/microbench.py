"""Infrastructure profiling (Sections 4.3, 5.1).

Two layers:
  * `run_local_microbench()` — REAL measurements of the machine this code
    runs on, via torch compute probes on an explicit device ("cuda" by
    default, "cpu" for the host) and file I/O (the 'scientist's local
    computer' role; the only wall-clock measurement in the whole system).
  * `simulate_microbench(spec)` — deterministic noisy benchmark readings
    for modeled cluster nodes (the six Table-2 machines), since the
    paper's physical clusters are unavailable offline.

Application-specific benchmarks (Section 5.2) are modeled as running a
reference task on a reference input on each node (Docker-container
analogue): `app_benchmark_runtime`.  The modeled side is pure numpy and
seeded by `stable_seed`, so it reads the same numbers as the reference
package.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.seeding import stable_seed
from repro_torch.device import DEFAULT_DEVICE, resolve_device


# ---------------------------------------------------------------------------
# real local probes
# ---------------------------------------------------------------------------
def _time_it(fn, repeats: int = 3) -> float:
    fn()  # warmup
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _done(dev: torch.device) -> None:
    """Wait for the device's queued work (a CPU op has finished when it
    returns)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cpu_probe_gflops(n: int = 512, device=DEFAULT_DEVICE) -> float:
    """float32 matmul throughput on one device (sysbench-CPU analogue).
    A plain `torch.matmul`, with TF32 as the caller set it."""
    dev = resolve_device(device)
    a = torch.ones((n, n), dtype=torch.float32, device=dev)

    def run():
        torch.matmul(a, a)
        _done(dev)
    return 2 * n ** 3 / _time_it(run) / 1e9


def mem_probe_gbps(n: int = 1 << 22, device=DEFAULT_DEVICE) -> float:
    """stream bandwidth (sysbench-memory analogue): x * 1.0000001 + 1 in
    one elementwise pass, counted as the reference counts it (3 x 4 bytes
    an element)."""
    dev = resolve_device(device)
    a = torch.ones((n,), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def run():
        torch.add(one, a, alpha=1.0000001)
        _done(dev)
    return 3 * 4 * n / _time_it(run) / 1e9


def io_probe_mbps(size_mb: int = 64) -> Dict[str, float]:
    """sequential write/read (fio analogue)."""
    buf = os.urandom(size_mb << 20)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        path = f.name
    try:
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        w = size_mb / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            f.read()
        r = size_mb / (time.perf_counter() - t0)
    finally:
        os.unlink(path)
    return {"read": r, "write": w}


def run_local_microbench(name: str = "local-real",
                         device=DEFAULT_DEVICE) -> MachineBench:
    dev = resolve_device(device)
    io = io_probe_mbps()
    return MachineBench(name=name, cpu=cpu_probe_gflops(device=dev),
                        mem=mem_probe_gbps(device=dev),
                        io_read=io["read"], io_write=io["write"])


# ---------------------------------------------------------------------------
# simulated node benchmarks
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NodeSpec:
    """Ground-truth capability of a modeled node (hidden from predictors;
    microbenchmarks observe it with noise, exactly as real benchmarks do)."""
    name: str
    cpu: float
    mem: float
    io_read: float
    io_write: float
    cores: int = 8
    power_watts: float = 200.0
    price_per_hour: float = 0.38
    net_gbps: float = 1.0


def simulate_microbench(spec: NodeSpec, seed: int = 0,
                        noise: float = 0.03) -> MachineBench:
    rng = np.random.default_rng(stable_seed(spec.name, seed))
    jitter = lambda v: float(v * rng.lognormal(0.0, noise))
    return MachineBench(name=spec.name, cpu=jitter(spec.cpu),
                        mem=jitter(spec.mem),
                        io_read=jitter(spec.io_read),
                        io_write=jitter(spec.io_write))


def app_benchmark_runtime(task_cpu_frac: float, spec: NodeSpec,
                          ref_spec: NodeSpec, base_runtime: float = 30.0,
                          seed: int = 0, noise: float = 0.02) -> float:
    """Application-specific benchmark (Section 5.2): run the task's container
    on a small reference input on `spec`; returns the measured runtime."""
    rng = np.random.default_rng(stable_seed(spec.name, "app", seed))
    t = base_runtime * (task_cpu_frac * ref_spec.cpu / spec.cpu
                        + (1 - task_cpu_frac) * (ref_spec.io_read + ref_spec.io_write)
                        / (spec.io_read + spec.io_write))
    return float(t * rng.lognormal(0.0, noise))
