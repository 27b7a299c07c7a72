"""Local workflow profiling (Section 4.4): downsample one input, run the
workflow locally, and collect traces — the predictor's only training data.

Mirrors the paper's protocol: two training sets per workflow (two different
input files downsampled to ~10%), >= 3 partitions each (Table 4).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.downsample import partition_sizes
from repro_torch.core.seeding import stable_seed
from repro_torch.core.traces import TraceRow
from repro_torch.sched.cluster import LOCAL
from repro_torch.workflow.generator import (GroundTruth, WORKFLOW_TASKS,
                                      sample_sizes)


def local_profiling(workflow: str, gt: GroundTruth, training_set: int = 0,
                    n_partitions: int = 5,
                    fraction: float = 0.1) -> Tuple[List[TraceRow], float]:
    """Run all tasks of `workflow` locally on downsampled partitions.
    Returns (traces, total local execution seconds) — the latter reproduces
    Table 4's local profiling times."""
    sizes = sample_sizes(workflow, seed=gt.seed)
    base_input = sizes[training_set % len(sizes)]
    parts = partition_sizes(base_input, n=n_partitions, fraction=fraction)
    rng = np.random.default_rng(stable_seed(workflow, "prof", training_set))
    traces: List[TraceRow] = []
    total_s = 0.0
    for m in WORKFLOW_TASKS[workflow]:
        for i, p in enumerate(parts):
            rt = gt.runtime(m.name, p, LOCAL,
                            instance_key=f"prof{training_set}_{i}")
            # monitoring measures the compute share with some error
            cpu_meas = float(np.clip(m.cpu_frac + rng.normal(0, 0.05), 0, 1))
            traces.append(TraceRow(
                workflow=workflow, task=m.name, node=LOCAL.name,
                input_gb=p, runtime_s=rt, read_gb=p,
                write_gb=p * m.output_ratio, cpu_fraction=cpu_meas,
                instance=f"prof{training_set}_{i}"))
            total_s += rt
    return traces, total_s
