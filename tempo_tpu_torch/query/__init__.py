"""Continuous queries: standing plans over live streams.

Counterpart of ``tempo_tpu/query``.  Register a planned method chain or
SQL statement as a **standing query** over
:class:`~tempo_tpu_torch.query.unified.StreamTable` streams: every
admitted push fans out to subscribers as an incremental delta, and the
accumulated standing result is bitwise identical to re-running the
registered batch query over the concatenated history at every push
boundary.  See :mod:`tempo_tpu_torch.query.standing` for the engine,
:mod:`tempo_tpu_torch.query.split` for the incremental/remainder split
pass, and :mod:`tempo_tpu_torch.query.unified` for the history + live
unified scan.
"""

# NOTE: the split PASS lives in the `split` submodule; it is not
# re-exported here because the bare name would shadow the submodule
# attribute on the package (plan/executor dispatches through
# `tempo_tpu_torch.query.split`).  Use `query.split.split(root)` /
# `query.split.canonicalize(root)` directly.
from tempo_tpu_torch.query.split import EmaSpec, JoinSpec, StandingPlan
from tempo_tpu_torch.query.standing import (Notification,
                                            StandingQueryEngine,
                                            Subscription,
                                            resume_subscription,
                                            snapshot_subscription)
from tempo_tpu_torch.query.unified import StreamTable, UnifiedSource

__all__ = [
    "StreamTable", "UnifiedSource",
    "StandingQueryEngine", "Subscription", "Notification",
    "snapshot_subscription", "resume_subscription",
    "StandingPlan", "EmaSpec", "JoinSpec",
]
