"""Resampling, upsample-fill, OHLC bars and the fused resample + EMA.

Counterpart of ``tempo_tpu/resample.py`` (reference semantics:
python/tempo/resample.py):

* ``aggregate`` (resample.py:38-117): epoch-aligned tumbling buckets;
  floor/ceil pick the *whole record* with the min/max timestamp in the
  bucket, mean/min/max aggregate each metric column; the bucket start
  becomes the new ts; metric columns default to every non-grouping
  column (Spark's avg() of a string is a null double); output columns
  are partition cols + ts + sorted(rest); ``fill`` upsamples to a dense
  grid and zero-fills numeric columns.
* ``_ResampledTSDF`` (tsdf.py:905-944) remembers (freq, func) so a
  chained ``.interpolate(method=...)`` needs no re-sample.
* ``resample_ema``: floor-resample + exact EMA in one kernel pass
  (``ops/bucket.resample_ema``).

Bucketing is integer arithmetic on the sorted int64-ns time axis;
per-bucket aggregation is a segment reduction over contiguous segment
ids (``ops/rolling.segment_stats``, tensor ops on the frame's device);
floor/ceil gather first/last rows of each segment on the host, so
string columns ride along.  Every frame built here keeps the source
frame's device and dtype.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.freq import (
    CLOSEST_LEAD,
    MAX_LEAD,
    MEAN_LEAD,
    MIN_LEAD,
    average,
    ceiling,
    floor,
    freq_to_seconds,
    max_func,
    min_func,
    validateFuncExists,
)
from tempo_tpu_torch.frame import TSDF
from tempo_tpu_torch.ops import bucket
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.rolling import _bucket_ns, _segments


def _is_numeric_col(df: pd.DataFrame, c: str) -> bool:
    return (
        pd.api.types.is_numeric_dtype(df[c].dtype)
        and not pd.api.types.is_bool_dtype(df[c].dtype)
    )


_LEAD_ALIASES = {CLOSEST_LEAD: floor, MEAN_LEAD: average,
                 MIN_LEAD: min_func, MAX_LEAD: max_func}


def aggregate(tsdf, freq: str, func: str, metricCols=None, prefix=None,
              fill=None) -> pd.DataFrame:
    func = _LEAD_ALIASES.get(func, func)
    freq_sec = freq_to_seconds(freq)

    layout = tsdf.layout
    grouping = set(tsdf.partitionCols + [tsdf.ts_col])
    if metricCols is None:
        metricCols = [c for c in tsdf.df.columns if c not in grouping]
    prefix = "" if prefix is None else prefix + "_"

    bucket_ns = _bucket_ns(layout.ts_ns, freq_sec)
    seg_ids, first_row, seg_bucket = _segments(layout, bucket_ns)
    n_seg = len(first_row)
    last_row = (np.append(first_row[1:], layout.n_rows) - 1) if n_seg else first_row

    sorted_df = tsdf.df.iloc[layout.order].reset_index(drop=True)
    out = {}
    for c in tsdf.partitionCols:
        out[c] = sorted_df[c].to_numpy()[first_row]
    out[tsdf.ts_col] = packing.ns_to_original(seg_bucket, tsdf.ts_dtype())

    if func in (floor, ceiling):
        # whole-record min/max-by-timestamp (struct trick equivalent):
        # gather the first/last row of each contiguous segment
        pick = first_row if func == floor else last_row
        for c in metricCols:
            out[prefix + c] = sorted_df[c].to_numpy()[pick]
    else:
        segs = tsdf._upload(seg_ids)
        for c in metricCols:
            if _is_numeric_col(sorted_df, c):
                vals = pd.to_numeric(sorted_df[c], errors="coerce").to_numpy(np.float64)
                valid = ~np.isnan(vals)
                stats = rk.segment_stats(
                    tsdf._upload(vals).to(tsdf.dtype), tsdf._upload(valid),
                    segs, n_seg)
                key = {average: "mean", min_func: "min", max_func: "max"}[func]
                out[prefix + c] = stats[key].cpu().numpy().astype(np.float64)
            elif func == average:
                # Spark avg(string) -> null double (exercised by the
                # reference's 5-minute mean resample golden)
                out[prefix + c] = np.full(n_seg, np.nan)
            else:
                # lexicographic min/max for non-numerics, host-side
                s = pd.Series(sorted_df[c].to_numpy(), copy=False)
                agg = s.groupby(seg_ids).min() if func == min_func else s.groupby(seg_ids).max()
                out[prefix + c] = agg.to_numpy()

    res = pd.DataFrame(out)
    # deterministic column order (resample.py:97-100)
    non_part = sorted(set(res.columns) - set(tsdf.partitionCols) - {tsdf.ts_col})
    res = res[tsdf.partitionCols + [tsdf.ts_col] + non_part]

    if fill:
        res = upsample_fill(res, tsdf.partitionCols, tsdf.ts_col, freq_sec)
    return res


def upsample_fill(res: pd.DataFrame, pcols: List[str], ts_col: str,
                  freq_sec: int) -> pd.DataFrame:
    """Dense per-key grid from min to max ts, left-join, zero-fill
    numerics (resample.py:102-116)."""
    step = np.int64(freq_sec) * packing.NS_PER_S
    ts_ns = packing.series_to_ns(res[ts_col])
    frames = []
    key_iter = (
        res.assign(__ts_ns=ts_ns).groupby(pcols, sort=False, dropna=False)
        if pcols
        else [((), res.assign(__ts_ns=ts_ns))]
    )
    for key, g in key_iter:
        lo, hi = g["__ts_ns"].min(), g["__ts_ns"].max()
        grid = np.arange(lo, hi + step, step, dtype=np.int64)
        gdf = pd.DataFrame({ts_col: packing.ns_to_original(grid, res[ts_col].dtype)})
        if pcols:
            if not isinstance(key, tuple):
                key = (key,)
            for c, v in zip(pcols, key):
                gdf[c] = v
        frames.append(gdf)
    imputes = pd.concat(frames, ignore_index=True)
    merged = imputes.merge(res.drop(columns="__ts_ns", errors="ignore"),
                           on=pcols + [ts_col], how="left")
    metrics = [c for c in merged.columns if _is_numeric_col(merged, c)
               and c not in pcols and c != ts_col]
    merged[metrics] = merged[metrics].fillna(0)
    return merged


def resample_ema(tsdf, freq: str, colName: str, exp_factor: float = 0.2):
    """Fused floor-resample + exact EMA in one kernel pass.

    Per (series, epoch-aligned ``freq`` bucket): the value of the
    bucket's first row when that row is non-null (a bucket whose first
    row is null yields a null sample and the EMA carries), and the exact
    infinite-horizon EMA over those samples.  Returns a TSDF with one row
    per bucket: partition cols, the bucket start as the new ts,
    ``colName`` (the floor sample) and ``EMA_<colName>``.

    Bucket boundaries are epoch-aligned, so the kernel takes the absolute
    seconds as int32: until 2038 (and from 1902).  Past that the heads
    are picked with int64 tensor ops and the EMA runs on the ladder of
    ``ops/scan`` (the reference's fallback, resample.py:219-226).
    """
    freq_sec = freq_to_seconds(freq)
    layout = tsdf.layout

    v, m = tsdf.packed_numeric(colName)            # [K, L] + mask
    secs = tsdf.packed_ts() // packing.NS_PER_S    # absolute int64 s
    # pads carry the TS_PAD sentinel and are never heads (a head needs a
    # valid row), so only real rows bound the cast
    real = tsdf.packed_mask()
    secs_max = int(np.where(real, secs, 0).max(initial=0))
    secs_min = int(np.where(real, secs, 0).min(initial=0))
    if secs_max + freq_sec < 2**31 and secs_min >= -2**31:
        res, ema = bucket.resample_ema(
            tsdf._upload(secs.astype(np.int32)), v, m, step=freq_sec,
            alpha=float(exp_factor))
    else:
        head = bucket.heads(tsdf._upload(secs), m, freq_sec)
        res = torch.where(head, v, torch.full((), float("nan"),
                                              dtype=v.dtype, device=v.device))
        ema = scan.ema(v, head, float(exp_factor))

    # float32 before unpacking, as the reference does in every dtype
    planes = torch.stack([res.float(), ema.float()]).cpu().numpy()
    res_flat = packing.unpack_column(planes[0], layout)
    ema_flat = packing.unpack_column(planes[1], layout)

    seg_ids, first_row, seg_bucket = _segments(
        layout, _bucket_ns(layout.ts_ns, freq_sec))
    sorted_df = tsdf.df.iloc[layout.order].reset_index(drop=True)
    out = {}
    for c in tsdf.partitionCols:
        out[c] = sorted_df[c].to_numpy()[first_row]
    out[tsdf.ts_col] = packing.ns_to_original(seg_bucket, tsdf.ts_dtype())
    out[colName] = res_flat[first_row].astype(np.float64)
    out["EMA_" + colName] = ema_flat[first_row].astype(np.float64)
    return tsdf._with_df(pd.DataFrame(out))


def resample(tsdf, freq: str, func=None, metricCols=None, prefix=None,
             fill=None):
    """TSDF.resample (tsdf.py:764-776): validates the func, aggregates,
    returns a _ResampledTSDF that remembers (freq, func)."""
    validateFuncExists(func)
    enriched = aggregate(tsdf, freq, func, metricCols, prefix, fill)
    return _ResampledTSDF(
        enriched, ts_col=tsdf.ts_col, partition_cols=tsdf.partitionCols,
        freq=freq, func=func, device=tsdf.device, dtype=tsdf.dtype,
    )


def calc_bars(tsdf, freq: str, func=None, metricCols=None, fill=None):
    """OHLC bars (tsdf.py:813-826): four resamples joined on key+ts."""
    opens = resample(tsdf, freq=freq, func="floor", metricCols=metricCols,
                     prefix="open", fill=fill)
    lows = resample(tsdf, freq=freq, func="min", metricCols=metricCols,
                    prefix="low", fill=fill)
    highs = resample(tsdf, freq=freq, func="max", metricCols=metricCols,
                     prefix="high", fill=fill)
    closes = resample(tsdf, freq=freq, func="ceil", metricCols=metricCols,
                      prefix="close", fill=fill)

    join_cols = opens.partitionCols + [opens.ts_col]
    bars = (
        opens.df.merge(highs.df, on=join_cols)
        .merge(lows.df, on=join_cols)
        .merge(closes.df, on=join_cols)
    )
    non_part = sorted(set(bars.columns) - set(opens.partitionCols) - {opens.ts_col})
    bars = bars[opens.partitionCols + [opens.ts_col] + non_part]
    return tsdf._with_df(bars, partition_cols=opens.partitionCols)


class _ResampledTSDF(TSDF):
    """A TSDF that remembers its (freq, func) so a chained
    ``.interpolate(method=...)`` needs no re-sample (tsdf.py:905-944)."""

    def __init__(self, df, ts_col="event_ts", partition_cols=None,
                 sequence_col=None, freq=None, func=None, device=None,
                 dtype=None):
        super().__init__(df, ts_col, partition_cols, sequence_col,
                         device=device, dtype=dtype)
        self._freq = freq
        self._func = func

    def interpolate(self, method: str, target_cols: Optional[List[str]] = None,
                    show_interpolated: bool = False):
        from tempo_tpu_torch import interpol

        if target_cols is None:
            prohibited = set(self.partitionCols + [self.ts_col])
            target_cols = [
                c for c in self.df.columns
                if _is_numeric_col(self.df, c) and c not in prohibited
            ]
        service = interpol.Interpolation(is_resampled=True)
        out = service.interpolate(
            tsdf=self, ts_col=self.ts_col, partition_cols=self.partitionCols,
            target_cols=target_cols, freq=self._freq, func=self._func,
            method=method, show_interpolated=show_interpolated,
        )
        return self._with_df(out)
