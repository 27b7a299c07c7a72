"""Task-key namespace of the shared posterior store (leaf module).

Every posterior the serving stack owns is addressed by a three-part key
`tenant/workflow/task`: the tenant isolates customers (or experiments)
sharing one store, the workflow scopes abstract task names (two workflows
may both define a `multiqc` with different posteriors), and the task is the
abstract task model name.  Keys are append-only — a key, once assigned a
storage row, never moves — which is what lets snapshots share the live
index (see posterior.StoreSnapshot).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT_TENANT = "default"
DEFAULT_WORKFLOW = "default"
SEP = "/"


@dataclass(frozen=True, order=True)
class TaskKey:
    tenant: str
    workflow: str
    task: str

    def __post_init__(self):
        for part in (self.tenant, self.workflow, self.task):
            if not part or SEP in part:
                raise ValueError(
                    f"key parts must be non-empty and {SEP!r}-free, got "
                    f"({self.tenant!r}, {self.workflow!r}, {self.task!r})")

    def __str__(self) -> str:
        return SEP.join((self.tenant, self.workflow, self.task))

    @property
    def namespace(self) -> str:
        return SEP.join((self.tenant, self.workflow))

    @classmethod
    def parse(cls, s: str) -> "TaskKey":
        parts = s.split(SEP)
        if len(parts) != 3:
            raise ValueError(f"expected tenant/workflow/task, got {s!r}")
        return cls(*parts)


def namespace_str(tenant: str, workflow: str) -> str:
    return SEP.join((tenant, workflow))


def resolve_bench(benches, node: Optional[str]):
    """Benchmark lookup shared by predictor, service, and store bindings:
    exact name first, then the cluster-instance convention 'N2-3' -> 'N2'.
    None when the node is unknown (callers decide whether that is an error
    or a drop)."""
    if node is None:
        return None
    b = benches.get(node)
    if b is None and "-" in node:
        b = benches.get(node.rsplit("-", 1)[0])
    return b
