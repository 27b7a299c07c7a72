"""Infrastructure profiling (Sections 4.3, 5.1): the modeled side.

`simulate_microbench(spec)` gives deterministic noisy benchmark readings for
modeled cluster nodes (the six Table-2 machines), since the paper's
physical clusters are unavailable offline.  Application-specific
benchmarks (Section 5.2) are modeled as running a reference task on a
reference input on each node (Docker-container analogue):
`app_benchmark_runtime`.  Both are pure numpy and seeded by
`stable_seed`, so they read the same numbers as the reference package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.extrapolation import MachineBench
from repro_torch.core.seeding import stable_seed


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
