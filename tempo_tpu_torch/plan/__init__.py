"""Lazy query planner for TSDF / DistributedTSDF chains.

Counterpart of ``tempo_tpu/plan/``.  The reference library hands query
planning to Spark's Catalyst; the port executes every op eagerly unless
``TEMPO_TPU_PLAN=1``, in which case the op methods named in
:data:`~tempo_tpu_torch.plan.ir.PLANNED_METHODS` record plan nodes
instead and return lazy wrappers:

* :mod:`~tempo_tpu_torch.plan.ir` — deferred op nodes, the logical
  signature and the executable-cache key;
* :mod:`~tempo_tpu_torch.plan.optimizer` — rewrite passes: SQL-filter
  fusion, ``resampleEMA`` fusion, the mesh join -> stats -> EMA chain as
  one node, engine hoisting, reshard placement, column pruning,
  checkpoint barriers, barrier marking and stitching;
* :mod:`~tempo_tpu_torch.plan.cost` — the cost model behind those
  decisions, with the card's measured rates as priors; every argmin
  runs over bitwise-equal candidates;
* :mod:`~tempo_tpu_torch.plan.cache` — built executables keyed by the
  optimized-plan signature, the sources' shapes and the mesh, with an
  LRU bound (``TEMPO_TPU_PLAN_CACHE_SIZE``) and single-flight builds;
  its device segments (:mod:`~tempo_tpu_torch.plan.fused`,
  :mod:`~tempo_tpu_torch.plan.stitch`) are captured as CUDA graphs
  once and replayed;
* :mod:`~tempo_tpu_torch.plan.render` — ``explain()``;
* :mod:`~tempo_tpu_torch.plan.contracts` and
  :mod:`~tempo_tpu_torch.plan.contract_rules` — the compiled contracts:
  each production program's declared guarantees, checked on the record
  of one run and, on the card, on its captured CUDA graph
  (``python -m tempo_tpu_torch.plan.contracts``).

Recording is suspended inside the executor (and inside eager bodies
that call other recorded methods) via :func:`suspended`, so replaying a
plan through the eager methods never re-records.
"""

from __future__ import annotations

import contextlib
import contextvars

_SUSPENDED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "tempo_tpu_torch_plan_suspended", default=False)


def planning_enabled() -> bool:
    """``TEMPO_TPU_PLAN`` truthiness (read live: tests and notebooks
    toggle it mid-process)."""
    from tempo_tpu_torch import config

    return config.get_bool("TEMPO_TPU_PLAN")


def recording() -> bool:
    """Should an op method record a plan node right now?  True only
    when planning is enabled and no executor / eager-internal frame is
    on the stack (replaying a plan must not re-record)."""
    return not _SUSPENDED.get() and planning_enabled()


@contextlib.contextmanager
def suspended():
    """Run a block with plan recording off (the executor replays plans
    through the eager API inside this; eager methods whose bodies call
    other recorded methods wrap themselves too)."""
    token = _SUSPENDED.set(True)
    try:
        yield
    finally:
        _SUSPENDED.reset(token)
