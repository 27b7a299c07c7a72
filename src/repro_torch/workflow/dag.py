"""Workflow DAG model (Section 1's execution model, assumption A1)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TaskInstance:
    """One schedulable task execution (a vertex of the physical DAG)."""
    uid: str
    task_name: str                # the abstract task (e.g. 'bwa') it instantiates
    workflow: str
    input_gb: float               # uncompressed input size
    output_gb: float = 0.0
    sample: Optional[str] = None
    deps: List[str] = field(default_factory=list)


@dataclass
class WorkflowDAG:
    name: str
    tasks: Dict[str, TaskInstance] = field(default_factory=dict)

    def add(self, t: TaskInstance):
        assert t.uid not in self.tasks, t.uid
        for d in t.deps:
            assert d in self.tasks, (t.uid, d)
        self.tasks[t.uid] = t

    def successors(self) -> Dict[str, List[str]]:
        succ: Dict[str, List[str]] = {u: [] for u in self.tasks}
        for t in self.tasks.values():
            for d in t.deps:
                succ[d].append(t.uid)
        return succ

    def topo_order(self) -> List[str]:
        indeg = {u: len(t.deps) for u, t in self.tasks.items()}
        succ = self.successors()
        ready = sorted([u for u, d in indeg.items() if d == 0])
        out: List[str] = []
        while ready:
            u = ready.pop(0)
            out.append(u)
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
            ready.sort()
        assert len(out) == len(self.tasks), "cycle detected"
        return out

    def sources(self) -> List[str]:
        return [u for u, t in self.tasks.items() if not t.deps]

    def sinks(self) -> List[str]:
        succ = self.successors()
        return [u for u, s in succ.items() if not s]

    def critical_path_length(self, runtimes: Dict[str, float]) -> float:
        """longest path under given per-task runtimes (zero comm)."""
        dist: Dict[str, float] = {}
        for u in self.topo_order():
            t = self.tasks[u]
            base = max((dist[d] for d in t.deps), default=0.0)
            dist[u] = base + runtimes[u]
        return max(dist.values()) if dist else 0.0
