"""Three-term roofline model of one NVIDIA H100 SXM, the counterpart of
the JAX package's `perf/roofline.py` (whose constants describe a TPU):

    compute    = FLOPs_per_device / peak_FLOPs_per_card
    memory     = bytes_per_device / HBM_bandwidth
    collective = per-device link bytes / (links x link_bw)

`model_flops` (6 N D a training step, 2 N D a forward) is what a training
run's model-flop utilisation is stated against; `decision_plane_roofline`
is the analytic cost of one fused replan round.  The terms' arithmetic is
the reference's; only the constants differ.  They are published peaks,
not measurements: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column
(dense, without sparsity), and the DGX H100 datasheet for the network.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# NVIDIA H100 SXM5 datasheet peaks
PEAK_FLOPS = 989e12        # dense bfloat16 (and fp16) tensor cores
PEAK_FLOPS_FP32 = 67e12    # float32 outside the tensor cores
PEAK_FLOPS_FP64 = 34e12    # float64 outside the tensor cores
HBM_BW = 3.35e12           # HBM3
HBM_PER_CHIP = 80e9
LINK_BW = 50e9             # one NVLink 4 link; 18 links, 900 GB/s in all
LINKS_PER_CHIP = 18
DCN_BW = 50e9              # DGX H100: one 400 Gb/s ConnectX-7 a card


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    hbm_bytes_per_dev: float           # HLO-counted (no fusion model)
    coll_bytes_per_dev: float
    model_flops_per_dev: float     # 6*N*D (train) or 2*N*D (serve), / chips
    n_chips: int
    hbm_bytes_model_per_dev: float = 0.0   # analytic fused model (perf.hbm_model)
    per_kind: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        """memory term used for bottleneck classification: the analytic
        fused model when available, else the raw HLO count."""
        b = self.hbm_bytes_model_per_dev or self.hbm_bytes_per_dev
        return b / HBM_BW

    @property
    def t_memory_hlo(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / (LINKS_PER_CHIP * LINK_BW)

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """perfect-overlap model: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute fraction of the modeled step: MODEL_FLOPS at peak
        vs modeled step time; 1 when compute-bound with zero waste."""
        ideal = self.model_flops_per_dev / PEAK_FLOPS
        return ideal / max(self.step_time, 1e-30)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_dev / max(self.flops_per_dev, 1e-30)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops_per_dev": self.model_flops_per_dev,
            "hbm_bytes_model_per_dev": self.hbm_bytes_model_per_dev,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_memory_hlo": self.t_memory_hlo,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_model": self.step_time,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "per_kind_collectives": self.per_kind,
        }


def model_flops(n_active_params: float, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward-only serve)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


@dataclass
class DecisionPlaneTerms:
    """Roofline terms for ONE fused replan round (predict -> quantile ->
    rank -> EFT sweep) at (T tasks, N nodes, D dep width, S slots).

    The model is hardware-aware, not wall-clock: HBM traffic counts the
    posterior planes, factor/cost matrices, and per-task row reads once
    each (the interval stacks are on-chip carries and never round-trip),
    and the compute term counts the arithmetic of each
    fused stage.  `device_time` is the perfect-overlap max of the two:
    what the fused pipeline costs a device per replan, the number the
    <1 ms fleet-scale target is stated against."""
    n_tasks: int
    n_nodes: int
    dep_width: int
    slots: int
    flops: float
    hbm_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def bottleneck(self) -> str:
        return "memory" if self.t_memory >= self.t_compute else "compute"

    @property
    def device_time(self) -> float:
        return max(self.t_compute, self.t_memory)

    def achieved_fraction(self, measured_seconds: float) -> float:
        """Achieved-vs-peak: modeled device time over a measured time;
        1.0 means the measurement hit the roofline."""
        return self.device_time / max(measured_seconds, 1e-30)

    def to_dict(self) -> dict:
        return {
            "n_tasks": self.n_tasks, "n_nodes": self.n_nodes,
            "dep_width": self.dep_width, "slots": self.slots,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "bottleneck": self.bottleneck,
            "device_time_model": self.device_time,
        }


def decision_plane_roofline(n_tasks: int, n_nodes: int, dep_width: int = 4,
                            slots: int = 48, dtype_bytes: int = 4
                            ) -> DecisionPlaneTerms:
    """Analytic cost of one fused replan round at (T, N, D, S).

    Stages (T=n_tasks, N=n_nodes, D=dep_width, S=slots, db=dtype_bytes):

      predict+quantile  ~12 flops/task scalar predictive + 4 flops/cell
                        scale + z-band; reads 11 posterior planes (T,)
                        + the (T, N) factor matrix, writes (T, N) costs
      upward rank       (T, N) mean reduce + 2 flops/edge recurrence;
                        re-reads the cost matrix
      EFT sweep         per task: (D, N) dep comm gather (2 flops/cell),
                        (N, S) gap search (~6 flops/cell: shift, max,
                        add, compare, select, min-reduce), S-wide
                        insertion update; re-reads each task's cost row,
                        writes 3 scalars/task.  Interval stacks are
                        resident carries: no HBM round-trips.
    """
    T, N, D, S = n_tasks, n_nodes, dep_width, slots
    db = float(dtype_bytes)
    cells = T * N
    flops = (12.0 * T + 4.0 * cells)                  # predict + quantile
    flops += cells + 2.0 * T * D                      # rank
    flops += T * (6.0 * N * S + 2.0 * D * N + 8.0 * S)  # sweep
    hbm = 11.0 * T * db + cells * db + cells * db     # posts+factors, W out
    hbm += cells * db + T * db                        # rank pass
    hbm += cells * db + 3.0 * T * db                  # sweep row reads+outs
    hbm += 2.0 * N * S * db                           # interval stack init
    return DecisionPlaneTerms(n_tasks=T, n_nodes=N, dep_width=D, slots=S,
                              flops=flops, hbm_bytes=hbm)
