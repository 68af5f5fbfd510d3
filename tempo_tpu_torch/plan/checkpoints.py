"""Plan-integrated checkpoint barriers.

Counterpart of ``tempo_tpu/plan/checkpoints.py``.  Inside a
:func:`checkpointed` context the optimizer's ``TEMPO_TPU_CKPT_PLACEMENT``
pass (:func:`tempo_tpu_torch.plan.optimizer._place_checkpoints`)
inserts first-class ``checkpoint`` nodes at the materialization and
reshard boundaries of the chain, ``explain()`` renders them with their
estimated bytes, and the executor:

* **saves** each barrier as a ``step_NNNNN`` checkpoint whose manifest
  is stamped with the optimized-plan signature, the source frames'
  content fingerprints and the predecessor barrier's manifest CRC-32
  (the chained-manifest scheme);
* **resumes** a re-submitted plan from the newest intact,
  chain-consistent barrier — the subtree under it is skipped (never
  re-executed; the executable comes from the plan cache) — and
  **refuses** by name (:class:`~tempo_tpu_torch.resilience.
  CheckpointError`) a barrier stamped by a different plan.

``run_resumable`` is the eager wrapper over the same stamping and
refusal (:func:`tempo_tpu_torch.checkpoint.resolve_step`).

The context is a contextvar, so concurrent planned queries only
checkpoint the chains run inside it.  The placement spec (``every``) is
folded into the executable-cache key (:func:`fingerprint`); the
directory is read at run time, so one cached executable serves any
number of checkpoint directories.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Active barrier policy: where step checkpoints land, how often a
    boundary gets one, and how many are retained."""

    ckpt_dir: str
    every: int = 1
    keep_last: int = 3
    sharded: bool = False


_ACTIVE: contextvars.ContextVar[Optional[CheckpointSpec]] = \
    contextvars.ContextVar("tempo_tpu_torch_plan_ckpt", default=None)


def active() -> Optional[CheckpointSpec]:
    """The live :class:`CheckpointSpec`, or None outside any
    :func:`checkpointed` context."""
    return _ACTIVE.get()


@contextlib.contextmanager
def checkpointed(ckpt_dir, every: int = 1, keep_last: int = 3,
                 sharded: bool = False):
    """Run planned chains with checkpoint barriers: every ``every``-th
    materialization boundary (and the reshard boundaries / the final
    pre-collect frame) becomes a signed ``step_NNNNN`` checkpoint under
    ``ckpt_dir``; re-running the SAME chain inside the context resumes
    from the newest intact barrier and re-executes only the ops above
    it."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    spec = CheckpointSpec(str(ckpt_dir), int(every), int(keep_last),
                          bool(sharded))
    token = _ACTIVE.set(spec)
    try:
        yield spec
    finally:
        _ACTIVE.reset(token)


def placement_mode() -> str:
    """``TEMPO_TPU_CKPT_PLACEMENT`` — ``auto`` (default: barriers at
    materialization/reshard boundaries of chains run inside a
    :func:`checkpointed` context) or ``off`` (no plan barriers; the
    context then has no effect on planned chains)."""
    from tempo_tpu_torch import config

    mode = (config.get("TEMPO_TPU_CKPT_PLACEMENT") or "auto")
    mode = mode.strip().lower()
    return mode if mode in ("auto", "off") else "auto"


def fingerprint() -> Optional[tuple]:
    """Executable-cache key component: barrier placement changes the
    optimized plan, so a chain planned inside a checkpointed context
    must never replay the barrier-free executable (or vice versa).
    Directory/retention are runtime-only and stay out of the key."""
    spec = active()
    if spec is None or placement_mode() == "off":
        return None
    return ("ckpt", spec.every)


def source_fingerprint(frame) -> str:
    """Content fingerprint of one source frame, folded into the
    stamped barrier signature.  The plan signature alone covers only
    STRUCTURE — without this, re-running the same chain over
    different same-shape data inside the same checkpoint directory
    would silently restore the previous data's barriers (exactly the
    stale-restore hazard the refusal semantics exist for).

    Content-derived (host frames: ``pd.util.hash_pandas_object``;
    mesh frames: every fetched plane + the layout), so
    it is stable across process restarts — a crash-resumed pipeline
    that re-ingests the same bytes matches its own barriers.  Memoized
    on the frame (frames are immutable), so repeated submissions of a
    live frame pay the O(data) fetch once."""
    cached = getattr(frame, "_plan_ckpt_fp", None)
    if cached is not None:
        return cached
    import hashlib

    import numpy as np

    from tempo_tpu_torch.dist import DistributedTSDF
    from tempo_tpu_torch.parallel.mesh import process_count

    h = hashlib.sha1()

    def eat(a):
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())

    if isinstance(frame, DistributedTSDF):
        h.update(repr(("dist", tuple(frame.cols), frame.ts_col,
                       tuple(frame.partitionCols),
                       frame.seq_col or "")).encode())
        if process_count() > 1:
            # another process's shards are placeholders: stamp the
            # host-resident layout (keys + per-series lengths) instead,
            # weaker (same-layout different-value frames collide) but
            # the same on every process without a gather
            h.update(repr(("multiprocess", frame.K_dev, frame.L)).encode())
        else:
            planes = [frame.ts, frame.mask]
            if frame.seq is not None:
                planes.append(frame.seq)
            for col in frame.cols.values():
                planes += [col.values, col.valid]
            for arr in frame._host_planes(planes):
                eat(arr)
            for col in frame.cols.values():
                if col.host_gather is not None:
                    _vals, starts, perm = col.host_gather
                    h.update(repr(len(_vals)).encode())
                    eat(starts)
                    eat(perm)
        eat(frame.layout.starts)
        h.update(frame.layout.key_frame.to_json().encode())
    else:
        import pandas as pd

        h.update(repr(("host", tuple(frame.df.columns), frame.ts_col,
                       tuple(frame.partitionCols),
                       frame.sequence_col or "")).encode())
        eat(pd.util.hash_pandas_object(frame.df, index=False).to_numpy())
    fp = h.hexdigest()[:16]
    frame._plan_ckpt_fp = fp
    return fp
