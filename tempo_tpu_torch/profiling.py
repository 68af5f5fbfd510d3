"""AS-OF join strategy and engine picks.

Counterpart of ``tempo_tpu/profiling.py`` (``pick_asof_strategy``,
``join_engine_override``, ``pick_join_engine``) and of
``tempo_tpu.resilience.max_merged_lanes``.  The planner hints and the
cost model of the reference are not part of this eager-only port, so
the picks are the reference's rule forms.
"""

from __future__ import annotations

import logging
from typing import Optional

import pandas as pd

from tempo_tpu_torch import config

logger = logging.getLogger(__name__)

# reference tsdf.py:482-509: broadcast when either side is under 30 MiB
BROADCAST_BYTES_THRESHOLD = 30 * 1024 * 1024

# merged-lane limit of a single AS-OF program (the reference's measured
# compiler ceiling); past it the chunked engine takes the join
DEFAULT_MAX_MERGED_LANES = 196_608


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
    brackets.  ``TEMPO_TPU_JOIN_ENGINE`` forces one."""
    forced = join_engine_override()
    if forced is not None:
        return forced
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
