"""Multi-tenant query service over the cost-based planner.

Counterpart of ``tempo_tpu/service``:

* ``service/service.py``: :class:`QueryService`, plan-signature-keyed
  queries from N concurrent tenants against the shared executable cache
  (single-flight builds, captured CUDA graphs replayed on a hit,
  per-tenant counters), a fair scheduler (per-tenant token accounting
  and per-tenant submit backpressure), graceful drain, and the standing
  queries of :mod:`tempo_tpu_torch.query` (``register``,
  ``register_sql``, ``push``);
* ``service/admission.py``: admission control, each query's projected
  shared memory a block and device memory; over-budget queries are
  rejected with the named :class:`AdmissionError` (never queued
  forever), queries over the free share queue until running work
  releases budget.
"""

from tempo_tpu_torch.resilience import (Cancelled, Deadline,
                                        DeadlineExceeded, QuarantinedError,
                                        ShutdownError)
from tempo_tpu_torch.service.admission import (AdmissionController,
                                               AdmissionError, Footprint,
                                               project_footprint)
from tempo_tpu_torch.service.service import (QueryService, QueryTicket,
                                             lazy_frame)

__all__ = [
    "QueryService", "QueryTicket", "lazy_frame",
    "AdmissionController", "AdmissionError", "Footprint",
    "project_footprint",
    # the fault-domain vocabulary (tempo_tpu_torch.resilience),
    # re-exported: service callers meet these on submit() and tickets
    "Deadline", "DeadlineExceeded", "Cancelled", "ShutdownError",
    "QuarantinedError",
]
