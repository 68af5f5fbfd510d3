"""Plan-time engine hints.

Counterpart of ``tempo_tpu/plan/hints.py``.  The optimizer hoists the
join engine's selection (``profiling.pick_join_engine``) to plan time;
while the executor replays a node whose annotations carry a hoisted
decision, the hint is installed here and the pick consults it.  The
range engines differ in float rounding, so ``ops/rolling``'s pick
reads no hint.  Import-light on purpose: read from ``profiling``
without an import cycle.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

_HINTS: contextvars.ContextVar[Dict[str, object]] = contextvars.ContextVar(
    "tempo_tpu_torch_plan_hints", default={})


def get(name: str) -> Optional[object]:
    """The active hint value (``join_engine``), or
    None when no planned node is executing."""
    return _HINTS.get().get(name)


@contextlib.contextmanager
def installed(hints: Dict[str, object]):
    token = _HINTS.set(dict(hints))
    try:
        yield
    finally:
        _HINTS.reset(token)
