"""Online prediction subsystem: the event vocabulary and the batched
prediction service.

Layering: `events` is leaf-level (shared vocabulary); `service` is a
(tenant, workflow) view over the shared `repro_torch.store.PosteriorStore`
that answers a batch of queries with one launch of the posterior
predictive kernel.
"""
from repro_torch.online.events import PredictionQuery, TaskCompletion  # noqa: F401
from repro_torch.online.service import PredictionService              # noqa: F401
