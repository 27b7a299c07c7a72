"""Online prediction subsystem: the event vocabulary, the streaming
predictor and the batched prediction service.

Layering: `events` is leaf-level (shared vocabulary); `predictor` wraps a
fitted LotaruPredictor with exact conjugate updates, folding completion
batches through the `nig_fold` kernel; `service` is a (tenant, workflow)
view over the shared `repro_torch.store.PosteriorStore` that answers a
batch of queries with one launch of the posterior predictive kernel;
`maintenance` is the posterior maintenance plane (fleet-wide periodic
evidence refresh in one `bayes_fit` launch, published in one store
generation); `rescheduler` drives `workflow.simulator.execute_adaptive`
(in-flight HEFT rescheduling and speculation off the resident decision
plane).
"""
from repro_torch.online.events import PredictionQuery, TaskCompletion  # noqa: F401
from repro_torch.online.predictor import (IngestStats,                 # noqa: F401
                                          OnlinePredictor)
from repro_torch.online.service import PredictionService              # noqa: F401
from repro_torch.online.maintenance import (FleetRefresher,  # noqa: F401
                                            RefreshPolicy, RefreshReport)
from repro_torch.online.rescheduler import (                        # noqa: F401
    OnlineReschedulingPlanner, RescheduleStats)
