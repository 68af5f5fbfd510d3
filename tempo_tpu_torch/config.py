"""The ``TEMPO_TPU_*`` environment knobs this package reads.

Counterpart of ``tempo_tpu/config.py``, cut to the knobs the port's
eager frame consults.  The
names are kept so one environment drives both packages the same way.
Every ``os.environ`` read of the package goes through :func:`get`.
"""

from __future__ import annotations

import os
from typing import Optional

#: name -> one-line contract of every knob read here
KNOBS = {
    "TEMPO_TPU_COMPUTE_DTYPE":
        "float dtype of metric math (float32|float64); default float32 "
        "on CUDA, float64 on the CPU",
    "TEMPO_TPU_SORT_KERNELS":
        "0 routes withRangeStats to the windowed (prefix-sum) engine",
    "TEMPO_TPU_JOIN_ENGINE":
        "force an AS-OF engine: single | chunked | bracket",
    "TEMPO_TPU_MAX_MERGED_LANES":
        "merged-lane limit of a single AS-OF program (0 disables)",
    "TEMPO_TPU_BINPACK":
        "1/0 forces/forbids the bin-packed AS-OF layout",
    "TEMPO_TPU_WINDOW_ENGINE":
        "force a range-stats engine: auto | shifted | stream | windowed | "
        "legacy (the legacy shifted-window kernel within the shifted row "
        "budget, as the reference picks it)",
    "TEMPO_TPU_STREAM_MAX_ROWS":
        "row-extent ceiling of the runtime-width range-stats engine",
    "TEMPO_TPU_DMA_BUFFERS":
        "depth of the staging ring of the bucket-stats, range-stats and "
        "resample-EMA kernels, clamped to [2, 8]; default 2",
    "TEMPO_TPU_SQL_STRICT":
        "strict SQL: selectExpr/filter raise StrictSqlFallback instead of "
        "falling back to pandas eval/query (per-call strict= wins)",
    "TEMPO_TPU_STRICT_SQL":
        "legacy alias of TEMPO_TPU_SQL_STRICT",
    "TEMPO_TPU_KERNEL_BUILD_DIR":
        "directory the CUDA kernels are built into (default "
        "tempo_tpu_torch/_build)",
}


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string value of a declared knob (``KeyError`` otherwise)."""
    if name not in KNOBS:
        raise KeyError(f"undeclared knob {name!r}: add it to KNOBS first")
    return os.environ.get(name, default)


def get_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Integer knob; unset or empty -> ``default``."""
    val = get(name)
    if val is None or not val.strip():
        return default
    return int(val)


def get_bool(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> ``default``; '', '0', 'false', 'no' and
    'off' -> False; anything else -> True."""
    val = get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("", "0", "false", "no", "off")
