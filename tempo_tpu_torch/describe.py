"""TSDF.describe (parity: python/tempo/tsdf.py:384-431).

A copy of ``tempo_tpu/describe.py`` (host pandas/numpy; the port keeps
its own copy).  Produces the same 7-row summary table: a ``global`` row
(unique series count, min/max timestamp, granularity classification)
followed by the classic count/mean/stddev/min/max describe rows and a
``missing_vals_pct`` row.  Granularity uses the reference's modular
classifier over the double-seconds timestamp (tsdf.py:409-413).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from tempo_tpu_torch import packing


def _fmt(v):
    return None if v is None or (isinstance(v, float) and np.isnan(v)) else str(v)


def col_describe_series(s: pd.Series) -> dict:
    """count/mean/stddev/min/max of one column, Spark describe style
    (strings get count + lexicographic min/max)."""
    n = int(s.notna().sum())
    if pd.api.types.is_numeric_dtype(s.dtype) and not \
            pd.api.types.is_bool_dtype(s.dtype):
        vals = pd.to_numeric(s, errors="coerce")
        return {
            "count": str(n),
            "mean": _fmt(float(vals.mean())) if n else None,
            "stddev": _fmt(float(vals.std(ddof=1))) if n > 1 else None,
            "min": _fmt(vals.min()) if n else None,
            "max": _fmt(vals.max()) if n else None,
        }
    non_null = s.dropna()
    return {
        "count": str(n),
        "mean": None,
        "stddev": None,
        "min": _fmt(non_null.min()) if n else None,
        "max": _fmt(non_null.max()) if n else None,
    }


def classify_granularity(has_frac, sub_minute, sub_hour, sub_day) -> str:
    """The reference's finest-unit classifier (tsdf.py:409-413) from
    precomputed any() flags."""
    if has_frac:
        return "millis"
    if sub_minute:
        return "seconds"
    if sub_hour:
        return "minutes"
    if sub_day:
        return "hours"
    return "days"


def assemble_table(stat_cols, stats, missing, unique_ts, min_ts, max_ts,
                   granularity) -> pd.DataFrame:
    """The 7-row describe table from precomputed per-column stats."""
    rows = [{
        "summary": "global",
        "unique_ts_count": str(unique_ts),
        "min_ts": str(min_ts),
        "max_ts": str(max_ts),
        "granularity": granularity,
        **{c: " " for c in stat_cols},
    }]
    for stat in ("count", "mean", "stddev", "min", "max"):
        rows.append({
            "summary": stat,
            "unique_ts_count": " ",
            "min_ts": " ",
            "max_ts": " ",
            "granularity": " ",
            **{c: stats[c][stat] for c in stat_cols},
        })
    rows.append({
        "summary": "missing_vals_pct",
        "unique_ts_count": " ",
        "min_ts": " ",
        "max_ts": " ",
        "granularity": " ",
        **{c: str(round(missing[c], 2)) for c in stat_cols},
    })
    return pd.DataFrame(rows)


def describe(tsdf) -> pd.DataFrame:
    df = tsdf.df
    ts_col = tsdf.ts_col
    double_ts_col = ts_col + "_dbl"
    ts_sec = packing.series_to_ns(df[ts_col]) / packing.NS_PER_S

    # columns summarised: everything except the raw timestamp col, plus
    # the derived double view of it (tsdf.py:393-400)
    work = df.drop(columns=[ts_col]).copy()
    work[double_ts_col] = ts_sec
    stat_cols = list(work.columns)

    stats = {c: col_describe_series(work[c]) for c in stat_cols}
    missing = {
        c: 100.0 * float(work[c].isna().sum()) / max(len(work), 1) for c in stat_cols
    }

    # granularity classifier (tsdf.py:409-413): finest unit present
    frac = ts_sec - np.floor(ts_sec)
    gran = classify_granularity(
        (frac > 0).any(),
        (np.mod(ts_sec, 60) != 0).any(),
        (np.mod(ts_sec, 3600) != 0).any(),
        (np.mod(ts_sec, 86400) != 0).any(),
    )

    if tsdf.partitionCols:
        unique_ts = int(df[tsdf.partitionCols].drop_duplicates().shape[0])
    else:
        unique_ts = 1

    return assemble_table(stat_cols, stats, missing, unique_ts,
                          df[ts_col].min(), df[ts_col].max(), gran)
