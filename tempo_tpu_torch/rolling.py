"""Frame-level ``withRangeStats`` and ``EMA``, and the tumbling-bucket
segments that resample builds on.

Counterpart of ``tempo_tpu/rolling.py`` (``with_range_stats``, ``ema``,
``_bucket_ns``, ``_segments``): reference surface tsdf.py:673-721 and
tsdf.py:615-635.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.ops import sortmerge as sm
from tempo_tpu_torch.ops import window


def _packed_metric_stack(tsdf, cols: List[str]):
    """[C, K, L] values + valids on the frame's device."""
    pairs = [tsdf.packed_numeric(c) for c in cols]
    return (torch.stack([v for v, _ in pairs]),
            torch.stack([m for _, m in pairs]))


def plan_range_engine(tsdf, rangeBackWindowSecs):
    """``(engine, rowbounds, ts_long, w)`` for this frame and window:
    the rebased per-series seconds, the clamped window, and the row
    bounds the row-bounded kernel needs (None when spans pass int32
    or the sort engines are off, which leaves the windowed form)."""
    ts_long = tsdf.packed_ts() // packing.NS_PER_S
    ts_long, _ = packing.rebase_seconds(ts_long, ~tsdf.packed_mask())
    # a window past every rebased span is 'unbounded preceding'; clamp
    # so huge windows cannot overflow the int32 keys
    w = min(int(rangeBackWindowSecs), int(np.iinfo(ts_long.dtype).max) // 2)
    rb = (packing.layout_rowbounds(tsdf.layout, w)
          if ts_long.dtype == np.int32 and sm.use_sort_kernels() else None)
    engine = "windowed" if rb is None else rk.pick_range_engine(*rb)
    return engine, rb, ts_long, w


def with_range_stats(tsdf, colsToSummarize=None, rangeBackWindowSecs=1000):
    cols = colsToSummarize or tsdf.summarizable_columns()
    layout = tsdf.layout
    out = tsdf.df.iloc[layout.order].reset_index(drop=True)
    seq = tsdf.sequence_col or None
    if not cols:
        # the reference adds no stat columns then (tsdf.py:691-721)
        return tsdf._with_df(out, sequence_col=seq)
    if layout.n_rows == 0:
        for c in cols:
            for stat in packing.RANGE_STATS:
                out[f"{stat}_{c}"] = np.zeros(
                    0, dtype=np.int64 if stat == "count" else np.float64)
        return tsdf._with_df(out, sequence_col=seq)
    vals, valids = _packed_metric_stack(tsdf, cols)
    engine, rb, ts_long, w = plan_range_engine(tsdf, rangeBackWindowSecs)
    keys = tsdf._upload(ts_long)
    if engine in ("shifted", "legacy"):
        fn = window.range_stats if engine == "shifted" else \
            rk.legacy_range_stats
        stats = fn(keys, vals, valids, w, int(rb[0]), int(rb[1]))
    else:
        start, end = rk.range_window_bounds(keys, w)
        # the min/max tables need levels up to the widest real window
        # only; pad lanes share the clamped pad seconds, so their
        # windows span the pad run and are left out
        real = tsdf._upload(tsdf.packed_mask())
        max_w = max(1, int(torch.where(real, end - start, 0).max()))
        C, K, L = vals.shape
        flat = rk.windowed_stats(vals.reshape(C * K, L),
                                 valids.reshape(C * K, L),
                                 start.repeat(C, 1), end.repeat(C, 1),
                                 max_window=1 << (max_w - 1).bit_length())
        stats = {k: v.reshape(C, K, L) for k, v in flat.items()}
    clip = stats.get("clipped")
    if clip is not None and float(clip.sum()) != 0.0:
        raise AssertionError(
            f"withRangeStats: {float(clip.sum())} rows exceeded the derived "
            f"row bounds {rb}; this is a tempo_tpu_torch bug")
    host = {k: stats[k].double().cpu().numpy() for k in packing.RANGE_STATS}
    for ci, c in enumerate(cols):
        for stat in packing.RANGE_STATS:
            flat = packing.unpack_column(host[stat][ci], layout)
            out[f"{stat}_{c}"] = (flat.astype(np.int64) if stat == "count"
                                  else flat)
    return tsdf._with_df(out, sequence_col=seq)


def _bucket_ns(ts_ns: np.ndarray, freq_sec: int) -> np.ndarray:
    """Epoch-aligned tumbling window start (Spark f.window semantics)."""
    step = np.int64(freq_sec) * packing.NS_PER_S
    return (ts_ns // step) * step


def _segments(layout, bucket: np.ndarray):
    """Contiguous (series, bucket) runs over the sorted flat layout:
    (segment id per row, first row of each segment, its bucket)."""
    n = layout.n_rows
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.ones(n, dtype=bool)
    change[1:] = (layout.key_ids[1:] != layout.key_ids[:-1]) | (
        bucket[1:] != bucket[:-1]
    )
    seg_ids = np.cumsum(change) - 1
    first_row = np.flatnonzero(change)
    return seg_ids.astype(np.int32), first_row, bucket[first_row]


def ema(tsdf, colName: str, window: int = 30, exp_factor: float = 0.2,
        exact: bool = False, inclusive_window: bool = False):
    """``inclusive_window=True`` reproduces the Scala lag range 0..window
    (EMA.scala:31), one more tap than the Python 0..window-1 range."""
    layout = tsdf.layout
    v, m = tsdf.packed_numeric(colName)
    if exact:
        y = rk.ema_exact(v, m, exp_factor)
    else:
        n_taps = int(window) + (1 if inclusive_window else 0)
        y = rk.ema_compat(v, m, n_taps, float(exp_factor))
    out = tsdf.df.iloc[layout.order].reset_index(drop=True)
    out["EMA_" + colName] = packing.unpack_column(
        y.double().cpu().numpy(), layout)
    return tsdf._with_df(out, sequence_col=tsdf.sequence_col or None)
