"""SWMS-independent CSV interface (Section 5.4).

Input: a table of task executions (one row per task run); output: a table of
predicted runtimes per (task, node).  Any workflow system that can emit CSV
monitoring data can use the predictor; Nextflow's trace file maps 1:1.
"""
from __future__ import annotations

import csv
import os
from dataclasses import asdict, dataclass, fields
from typing import List


@dataclass
class TraceRow:
    workflow: str
    task: str
    node: str
    input_gb: float           # uncompressed input size (Section 4.5 argues
                              # for the uncompressed size as the feature)
    runtime_s: float
    read_gb: float = 0.0
    write_gb: float = 0.0
    cpu_fraction: float = 0.5   # measured compute share (for Lotaru-W)
    instance: str = ""


@dataclass
class PredictionRow:
    workflow: str
    task: str
    node: str
    input_gb: float
    predicted_s: float
    lower_s: float
    upper_s: float
    method: str


def write_csv(path: str, rows) -> None:
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = [f.name for f in fields(rows[0])]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in rows:
            w.writerow(asdict(r))


def read_traces(path: str) -> List[TraceRow]:
    out = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            out.append(TraceRow(
                workflow=rec["workflow"], task=rec["task"], node=rec["node"],
                input_gb=float(rec["input_gb"]),
                runtime_s=float(rec["runtime_s"]),
                read_gb=float(rec.get("read_gb", 0) or 0),
                write_gb=float(rec.get("write_gb", 0) or 0),
                cpu_fraction=float(rec.get("cpu_fraction", 0.5) or 0.5),
                instance=rec.get("instance", "")))
    return out
