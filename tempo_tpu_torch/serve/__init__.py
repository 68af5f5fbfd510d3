"""Serving: the incremental ``StreamingTSDF`` operators, the cohort
engine, and the async micro-batch executors in front of them.

Counterpart of ``tempo_tpu/serve``: explicit carry state
(``serve/state.py``: the AS-OF join carry, the EMA carry of the
hand-written ``ema_scan`` kernel and a ring of recent rows, stepped by
CUDA graphs from the planner's cache), the streaming frame
(``serve/stream.py``: ``push`` / ``push_left`` emitting results for
exactly the new rows, bitwise the batch operators over the concatenated
history; snapshots and ``resume``), the cohort engine
(``serve/cohort.py``: thousands of streams as one ``[S, ...]`` state
block a shape bucket, stepped by one graph, block dispatch, a spill
tier, differential snapshots, the stream axis over a mesh with no copy
between entries in a push), and the shape-bucketing executors
(``serve/executor.py``: bounded queue, backpressure, deadlines,
cancellation, a supervised worker, per-ticket p50/p99 latency;
``CohortExecutor`` with ``submit_many``, ``submit_block`` and a
per-member circuit breaker).
"""

from tempo_tpu_torch.resilience import (Cancelled, Deadline,
                                        DeadlineExceeded, QuarantinedError,
                                        ShutdownError)
from tempo_tpu_torch.serve.cohort import CohortMember, StreamCohort, row_bucket
from tempo_tpu_torch.serve.executor import (BlockTicket, CohortExecutor,
                                            MicroBatchExecutor, Ticket)
from tempo_tpu_torch.serve.state import (StreamConfig, init_state,
                                         window_stats_batch)
from tempo_tpu_torch.serve.stream import LateTickError, StreamingTSDF

__all__ = [
    "StreamingTSDF", "StreamCohort", "CohortMember", "row_bucket",
    "MicroBatchExecutor", "CohortExecutor", "BlockTicket", "Ticket",
    "LateTickError", "StreamConfig", "init_state", "window_stats_batch",
    # the fault-domain vocabulary (defined in tempo_tpu_torch.resilience,
    # re-exported here because serving callers meet them on tickets)
    "Deadline", "DeadlineExceeded", "Cancelled", "ShutdownError",
    "QuarantinedError",
]
