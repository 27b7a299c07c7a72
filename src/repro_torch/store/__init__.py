"""Shared posterior storage layer: the single owner of all serving state.

Layering (leaf -> top): `keys` (namespace vocabulary), `compute` (the
batched predictive math every serving path shares, on the card through
the `bayes_predict` kernel), `posterior` (PosteriorStore: COW
block-sharded leaves, tenant bindings, checkpoint/restore, replica
shipping and namespace migration), `frontend` (async batch-window
coalescing: one `bayes_predict` launch a flush).  `repro_torch.online`
sits on top of this package, never the other way around.
"""
from repro_torch.store.compute import predict_stacked               # noqa: F401
from repro_torch.store.frontend import (AsyncPredictionFrontend,     # noqa: F401
                                        QueueFullError)
from repro_torch.store.keys import (DEFAULT_TENANT,                  # noqa: F401
                                    DEFAULT_WORKFLOW, TaskKey,
                                    resolve_bench)
from repro_torch.store.posterior import (PosteriorStore,             # noqa: F401
                                         StoreSnapshot, TenantBinding)
