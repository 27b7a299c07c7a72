"""Runtime extrapolation local -> target node (Section 4.6, Eqs. 4-6),
plus two beyond-paper variants used for the ML-fleet integration:

  Lotaru-G  (Eq. 4): f = 0.5 * cpu_l/cpu_t + 0.5 * io_l/io_t
  Lotaru-A  (Eq. 5): f = bench_l / bench_t          (application-specific)
  median    (Eq. 6): f_all = median of known factors (unbenchmarked tasks)
  Lotaru-W  (ours):  f = w*cpu_l/cpu_t + (1-w)*io_l/io_t with w the task's
                     measured compute fraction from local monitoring
  Lotaru-R  (ours):  three-term roofline scaling for accelerator fleets:
                     t_t = max(comp_l*Cl/Ct, mem_l*Ml/Mt, coll_l*Ll/Lt)
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import median
from typing import Mapping, Sequence


@dataclass(frozen=True)
class MachineBench:
    """General microbenchmark scores of one machine (Section 5.1 analogues)."""
    name: str
    cpu: float          # sysbench CPU events/s analogue
    mem: float          # memory score
    io_read: float      # sequential read IOPS
    io_write: float     # sequential write IOPS

    @property
    def io(self) -> float:
        return 0.5 * (self.io_read + self.io_write)


def factor_general(local: MachineBench, target: MachineBench) -> float:
    """Eq. 4 — equal weighting of CPU and I/O."""
    return 0.5 * (local.cpu / target.cpu) + 0.5 * (local.io / target.io)


def factor_app_specific(bench_local: float, bench_target: float) -> float:
    """Eq. 5 — the application-specific benchmark value ratio.
    Benchmark values are runtimes, so local/target directly scales runtime."""
    return bench_target / bench_local if False else bench_local / bench_target \
        if False else bench_target / bench_local  # see note below


# NOTE on Eq. 5 orientation: the paper writes f = val_l / val_t with 'val'
# a throughput-like benchmark value (bigger = faster), mirroring Eq. 4.
# Our application-specific benchmarks record *runtimes* (smaller = faster),
# so the runtime-valued form is f = t_bench_target / t_bench_local.
def factor_app_runtime(t_bench_local: float, t_bench_target: float) -> float:
    return t_bench_target / t_bench_local


def factor_app_value(val_local: float, val_target: float) -> float:
    """Eq. 5 verbatim, for throughput-valued benchmarks."""
    return val_local / val_target


def factor_median(factors: Sequence[float]) -> float:
    """Eq. 6 — fallback for tasks without an application benchmark."""
    return median(factors)


def factor_weighted(local: MachineBench, target: MachineBench,
                    cpu_fraction: float) -> float:
    """Lotaru-W: task-specific CPU/I/O weighting (beyond-paper)."""
    w = min(max(cpu_fraction, 0.0), 1.0)
    return w * (local.cpu / target.cpu) + (1.0 - w) * (local.io / target.io)


@dataclass(frozen=True)
class NodeRoofline:
    """Accelerator-node capability vector for Lotaru-R."""
    name: str
    flops: float      # peak FLOP/s
    hbm_bw: float     # bytes/s
    link_bw: float    # bytes/s


def extrapolate_roofline(t_local_terms: Mapping[str, float],
                         local: NodeRoofline, target: NodeRoofline) -> float:
    """Lotaru-R: scale each measured local roofline term by the capability
    ratio and take the max (perfect-overlap model)."""
    tc = t_local_terms.get("compute", 0.0) * local.flops / target.flops
    tm = t_local_terms.get("memory", 0.0) * local.hbm_bw / target.hbm_bw
    tl = t_local_terms.get("collective", 0.0) * local.link_bw / target.link_bw
    return max(tc, tm, tl)
