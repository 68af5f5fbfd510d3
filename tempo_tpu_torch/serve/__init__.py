"""Serving one stream: the incremental ``StreamingTSDF`` operators behind
an async micro-batch executor.

Counterpart of ``tempo_tpu/serve``, one stream so far: explicit carry
state (``serve/state.py``: the AS-OF join carry, the EMA carry of the
hand-written ``ema_scan`` kernel and a ring of recent rows, stepped by
CUDA graphs from the planner's cache), the streaming frame
(``serve/stream.py``: ``push`` / ``push_left`` emitting results for
exactly the new rows, bitwise the batch operators over the concatenated
history; snapshots and ``resume``), and the shape-bucketing executor
(``serve/executor.py``: bounded queue, backpressure, deadlines,
cancellation, a supervised worker, per-ticket p50/p99 latency).  The
cohort engine (``StreamCohort``, ``CohortMember``, ``row_bucket``,
``CohortExecutor``) is not ported yet (ROADMAP A12b).
"""

from tempo_tpu_torch.resilience import (Cancelled, Deadline,
                                        DeadlineExceeded, QuarantinedError,
                                        ShutdownError)
from tempo_tpu_torch.serve.executor import MicroBatchExecutor, Ticket
from tempo_tpu_torch.serve.state import (StreamConfig, init_state,
                                         window_stats_batch)
from tempo_tpu_torch.serve.stream import LateTickError, StreamingTSDF

__all__ = [
    "StreamingTSDF", "MicroBatchExecutor", "Ticket", "LateTickError",
    "StreamConfig", "init_state", "window_stats_batch",
    # the fault-domain vocabulary (defined in tempo_tpu_torch.resilience,
    # re-exported here because serving callers meet them on tickets)
    "Deadline", "DeadlineExceeded", "Cancelled", "ShutdownError",
    "QuarantinedError",
]
