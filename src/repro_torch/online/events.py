"""Event vocabulary of the online subsystem (near-leaf module: depends
only on `repro_torch.store.keys`, so the simulator and service can both
speak it)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.store.keys import resolve_bench  # noqa: F401  (re-export)


@dataclass(frozen=True)
class TaskCompletion:
    """One finished task execution, as observed by the resource manager."""
    workflow: str
    uid: str                  # physical DAG vertex (e.g. 'bwa_mem__s3')
    task: str                 # abstract task name (e.g. 'bwa_mem')
    node: str                 # node the task ran on
    input_gb: float
    runtime_s: float
    finish_time: float = 0.0


@dataclass(frozen=True)
class PredictionQuery:
    """One (task, node, input) runtime request against the service."""
    task: str
    node: Optional[str]       # None -> local machine (factor 1)
    input_gb: float
