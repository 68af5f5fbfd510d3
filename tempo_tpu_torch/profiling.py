"""Whole-chain traces, AS-OF join strategy and engine picks, the
planner's counters and the cost probe of a device segment.

Counterpart of ``tempo_tpu/profiling.py`` (``trace``, ``annotate``,
``pick_asof_strategy``, ``join_engine_override``, ``pick_join_engine``,
``compiled_cost``, ``plan_cache_stats``) and of
``tempo_tpu.resilience.max_merged_lanes``.  ``trace`` records the host
and, with a card present, the card's kernels and copies through
``torch.profiler`` into a Chrome trace; ``annotate`` names a span in it
(the library places none of its own, as the reference places none).
``pick_join_engine`` honours the planner's hoisted hint
(``plan/hints.py``) and, with the cost model on, takes the cost
argmin (``plan/cost.py``), which reproduces the rule under the default
priors.  ``window_roofline`` is not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import pandas as pd
import torch

from tempo_tpu_torch import config

logger = logging.getLogger(__name__)

# reference tsdf.py:482-509: broadcast when either side is under 30 MiB
BROADCAST_BYTES_THRESHOLD = 30 * 1024 * 1024

# merged-lane limit of a single AS-OF program (the reference's measured
# compiler ceiling); past it the chunked engine takes the join
DEFAULT_MAX_MERGED_LANES = 196_608


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile everything inside the block into a Chrome trace JSON under
    ``log_dir`` (``trace_<pid>_<ns>.json``; Perfetto and
    ``chrome://tracing`` load it).  CPU activity is always recorded,
    CUDA kernels and copies too when a card is present.  The block
    yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    block.  ``create_perfetto_link`` (an upload to a hosted viewer in
    the reference) raises ``ValueError``: the trace stays local.

    Usage::

        with profiling.trace("/tmp/tempo-trace"):
            tsdf.asofJoin(other).df
    """
    if create_perfetto_link:
        raise ValueError("create_perfetto_link is not supported: the port "
                         "writes the trace file only and uploads nothing")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span inside a :func:`trace` block (on the host timeline,
    with the kernels it launches beneath it):
    ``with profiling.annotate("asof-join"): ...``"""
    return torch.profiler.record_function(name)


def max_merged_lanes() -> int:
    """``TEMPO_TPU_MAX_MERGED_LANES`` or the default; 0/negative
    disables the limit."""
    env = config.get_int("TEMPO_TPU_MAX_MERGED_LANES")
    return DEFAULT_MAX_MERGED_LANES if env is None else env


def host_bytes(df: pd.DataFrame) -> int:
    return int(df.memory_usage(deep=True).sum())


def join_engine_override() -> Optional[str]:
    """``TEMPO_TPU_JOIN_ENGINE``: ``single``, ``chunked`` or ``bracket``
    (``vmem`` spells ``single``); unset or unknown means auto."""
    env = (config.get("TEMPO_TPU_JOIN_ENGINE") or "").strip().lower()
    if env == "vmem":
        env = "single"
    return env if env in ("single", "chunked", "bracket") else None


def pick_join_engine(est_lanes: int, limit: int, chunked_ok: bool) -> str:
    """'single' | 'chunked' | 'bracket': one program while the merged
    width fits ``limit``, else the lane-chunked engine, else host time
    brackets.  A plan-time hoisted decision (``plan/hints.py``) wins
    while the planner replays the node, when the freshly probed bounds
    still admit it; ``TEMPO_TPU_JOIN_ENGINE`` forces one; with the cost
    model on the unforced pick is the cost argmin (every engine gives
    the same bits)."""
    from tempo_tpu_torch.plan import hints as plan_hints

    hinted = plan_hints.get("join_engine")
    if hinted == "single" and (limit <= 0 or est_lanes <= limit):
        return "single"
    if hinted == "chunked" and chunked_ok:
        return "chunked"
    if hinted == "bracket":
        return "bracket"
    forced = join_engine_override()
    if forced is not None:
        return forced
    from tempo_tpu_torch.plan import cost as plan_cost

    if plan_cost.enabled():
        return plan_cost.decide_join_engine(est_lanes, limit, chunked_ok)
    if limit <= 0 or est_lanes <= limit:
        return "single"
    return "chunked" if chunked_ok else "bracket"


def pick_asof_strategy(left_df: pd.DataFrame, right_df: pd.DataFrame,
                       sql_join_opt: bool, has_sequence: bool,
                       max_lookback: int) -> str:
    """'broadcast' | 'merge' | 'searchsorted', the reference's decision
    tree (tsdf.py:482-509); ``maxLookback`` wins over broadcast."""
    if max_lookback and max_lookback > 0:
        if sql_join_opt:
            logger.warning(
                "asofJoin: sql_join_opt is ignored when maxLookback is "
                "set — the broadcast fast path cannot bound lookback")
        return "merge"
    if sql_join_opt and (
        host_bytes(left_df) < BROADCAST_BYTES_THRESHOLD
        or host_bytes(right_df) < BROADCAST_BYTES_THRESHOLD
    ):
        return "broadcast"
    if has_sequence:
        return "merge"
    return "searchsorted"


def plan_cache_stats() -> Dict[str, object]:
    """Counters of the planner's executable cache (``plan/cache.py``;
    LRU bound ``TEMPO_TPU_PLAN_CACHE_SIZE``): hits, misses, evictions,
    builds, the ``by_signature`` and ``by_tenant`` breakdowns, and the
    CUDA graphs captured (``graph_captures``) and replayed
    (``graph_replays``).  A steady-state query mix should be all hits
    and replays: a miss re-runs the optimizer, a capture re-records a
    graph."""
    from tempo_tpu_torch.plan.cache import CACHE

    return CACHE.stats()


def compiled_cost(fn, *args) -> Dict[str, Optional[float]]:
    """What the card states of ``fn(*args)`` (tensors in, a sequence of
    tensors out), under the reference's keys: ``argument_bytes`` and
    ``output_bytes``, and, for CUDA tensors, ``temp_bytes``, the bytes
    the private pool of a CUDA graph of the call takes (captured after
    one warm-up run, then dropped).  The reference reads XLA's compiled
    cost and memory analysis; a CUDA graph states no flop count, so
    ``flops``, ``bytes_accessed`` and ``generated_code_bytes`` stay
    None, as the reference leaves a key a backend does not report."""
    out: Dict[str, Optional[float]] = {
        "flops": None,
        "bytes_accessed": None,
        "output_bytes": None,
        "temp_bytes": None,
        "argument_bytes": None,
        "generated_code_bytes": None,
    }
    if fn is None:
        return out
    nbytes = lambda ts: int(sum(t.numel() * t.element_size() for t in ts
                                if isinstance(t, torch.Tensor)))
    out["argument_bytes"] = nbytes(args)
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    if dev.type != "cuda":
        out["output_bytes"] = nbytes(fn(*args))
        return out
    from tempo_tpu_torch.plan.fused import capture

    graph = capture(None, dev, fn, args)
    out["temp_bytes"] = graph.pool_bytes
    out["output_bytes"] = nbytes(graph.static_out)
    graph.free()
    return out
