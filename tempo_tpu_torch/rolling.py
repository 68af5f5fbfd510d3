"""Frame-level rolling and grouped statistics, EMA, VWAP and lookback
features, and the tumbling-bucket segments that resample builds on.

Counterpart of ``tempo_tpu/rolling.py``:

* ``withRangeStats`` - tsdf.py:673-721
* ``withGroupedStats`` - tsdf.py:723-759
* ``EMA`` - tsdf.py:615-635 (plus the exact scan form)
* ``eval_ema_stream`` - the batch form of the standing queries'
  ``ema_stream`` node (``tempo_tpu/query/split.py``)
* ``vwap`` - scala TSDF.scala:378-401 (the Scala version is the working
  spec; the Python one cannot run)
* ``withLookbackFeatures`` - tsdf.py:637-671 (with the exactSize=True
  bare-DataFrame quirk) and the dense ``lookbackTensor``.

Grouped stats and vwap reduce over flat segments with
``ops/rolling.segment_stats`` on the frame's device; the reference's
frame never reaches its bucket kernel there either.
"""

from __future__ import annotations

from typing import List

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.freq import UNIT_SECONDS, freq_to_seconds
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.ops import scan
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
    K, L = ts_long.shape
    engine = "windowed" if rb is None else rk.pick_range_engine(K * L, *rb)
    return engine, rb, ts_long, w


def with_range_stats(tsdf, colsToSummarize=None, rangeBackWindowSecs=1000):
    cols = colsToSummarize or tsdf.summarizable_columns()
    layout = tsdf.layout
    out = tsdf.df.iloc[layout.order].reset_index(drop=True)
    if not cols:
        # the reference adds no stat columns then (tsdf.py:691-721)
        return tsdf._with_rows(out)
    if layout.n_rows == 0:
        for c in cols:
            for stat in packing.RANGE_STATS:
                out[f"{stat}_{c}"] = np.zeros(
                    0, dtype=np.int64 if stat == "count" else np.float64)
        return tsdf._with_rows(out)
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
    return tsdf._with_rows(out)


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


def segment_frame(tsdf, freq_sec: int):
    """The (series, epoch-aligned ``freq_sec`` bucket) runs of a frame:
    (segment id per row of the sorted flat layout, first row of each
    segment, the output columns so far: the partition columns and the
    bucket start as the frame's ts column)."""
    layout = tsdf.layout
    seg_ids, first_row, seg_bucket = _segments(
        layout, _bucket_ns(layout.ts_ns, freq_sec))
    rows = layout.order[first_row]
    out = {c: tsdf.df[c].to_numpy()[rows] for c in tsdf.partitionCols}
    out[tsdf.ts_col] = packing.ns_to_original(seg_bucket, tsdf.ts_dtype())
    return seg_ids, first_row, out


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
    return tsdf._with_rows(out)


def eval_ema_stream(tsdf, col: str, alpha: float):
    """Batch evaluation of one ``ema_stream`` node: the sequential
    split-invariant EMA (``ops/scan.ema_scan``; on a CUDA tensor the
    hand-written ``csrc/ema_scan.cu`` kernel, on the CPU its plain
    version) over the packed layout, assembled exactly like :func:`ema`
    (layout row order, ``EMA_<col>`` widened to float64).

    It computes at float32 on every device, an exception to the port's
    float64-on-the-CPU rule: the serving plane's EMA carry is float32
    (``serve/state.py`` pins the ``ema_y`` plane), and the
    standing == batch bitwise contract needs both sides at one
    precision, as the reference pins it."""
    if not len(tsdf.df):
        out = tsdf.df.copy()
        out["EMA_" + col] = np.array([], np.float64)
        return tsdf._with_df(out, sequence_col=tsdf.sequence_col or None)
    layout = tsdf.layout
    v, m = tsdf.packed_numeric(col)
    ys, _ = scan.ema_scan(v.to(torch.float32), m, float(np.float32(alpha)))
    out = tsdf.df.iloc[layout.order].reset_index(drop=True)
    out["EMA_" + col] = packing.unpack_column(
        ys.cpu().numpy(), layout).astype(np.float64)
    return tsdf._with_df(out, sequence_col=tsdf.sequence_col or None)


def _flat_metric(tsdf, col: str):
    """(values in the frame's dtype, valid) of a column in the sorted
    flat layout, on the frame's device."""
    v, m = tsdf.numeric_flat(col)
    return tsdf._upload(v).to(tsdf.dtype), tsdf._upload(m)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


def with_grouped_stats(tsdf, metricCols=None, freq=None):
    """Per (series, ``freq`` tumbling bucket): mean, count, min, max, sum
    and stddev of each metric column (tsdf.py:723-759)."""
    cols = metricCols or tsdf.summarizable_columns()
    seg_ids, first_row, out = segment_frame(tsdf, freq_to_seconds(freq))
    seg = tsdf._upload(seg_ids)
    for c in cols:
        stats = rk.segment_stats(*_flat_metric(tsdf, c), seg, len(first_row))
        for stat, v in stats.items():
            arr = _host(v)
            out[f"{stat}_{c}"] = arr.astype(np.int64) if stat == "count" \
                else arr
    return tsdf._with_df(pd.DataFrame(out))


_VWAP_TRUNC = {"m": "min", "H": "hr", "D": "day"}


def vwap(tsdf, frequency: str = "m", volume_col: str = "volume",
         price_col: str = "price"):
    """Scala-spec VWAP (TSDF.scala:378-401): truncate the ts to the
    given frequency, then per (partition, time group):
    dllr_value = sum(price*volume), volume = sum(volume),
    max_<price> = max(price), vwap = dllr_value / volume."""
    if frequency not in _VWAP_TRUNC:
        raise ValueError("vwap frequency must be one of 'm', 'H', 'D'")
    seg_ids, first_row, out = segment_frame(
        tsdf, UNIT_SECONDS[_VWAP_TRUNC[frequency]])
    seg, n_seg = tsdf._upload(seg_ids), len(first_row)
    price, p_ok = _flat_metric(tsdf, price_col)
    vol, v_ok = _flat_metric(tsdf, volume_col)
    dllr = _host(rk.segment_stats(price * vol, p_ok & v_ok, seg, n_seg)["sum"])
    vol_sum = _host(rk.segment_stats(vol, v_ok, seg, n_seg)["sum"])
    out["dllr_value"] = dllr
    out[volume_col] = vol_sum
    out["max_" + price_col] = _host(
        rk.segment_stats(price, p_ok, seg, n_seg)["max"])
    out["vwap"] = dllr / vol_sum
    return tsdf._with_df(pd.DataFrame(out))


def with_lookback_features(tsdf, featureCols: List[str],
                           lookbackWindowSize: int, exactSize: bool = True,
                           featureColName: str = "features"):
    """Parity: tsdf.py:637-671.  Per row, the [w, n_features] list of
    the previous ``lookbackWindowSize`` observations (rowsBetween(-N,
    -1)); rows nearer the series start get shorter lists unless
    exactSize drops them.  The window stack is built on the frame's
    device (``lookback_tensor``); the lists are Python objects, one per
    row, as in the reference.

    Returns a bare DataFrame when exactSize=True (reference quirk,
    tsdf.py:668-669), else a TSDF."""
    layout = tsdf.layout
    sorted_df = tsdf.df.iloc[layout.order].reset_index(drop=True)
    n = len(sorted_df)
    w = int(lookbackWindowSize)
    tensor, _ = lookback_tensor(tsdf, featureCols, w)
    pos = np.arange(n, dtype=np.int64) - layout.starts[layout.key_ids]
    # [n, w, F] in the sorted flat layout, gathered on the device
    flat = _host(tensor[tsdf._upload(layout.key_ids.astype(np.int64)),
                        tsdf._upload(pos)])
    # rows nearer their series start have only pos lookback entries, at
    # the end of the window axis
    cnt = np.minimum(pos, w)
    out = sorted_df.copy()
    if exactSize:
        keep = cnt == w
        out = out[keep].reset_index(drop=True)
        out[featureColName] = pd.Series(flat[keep].tolist(), index=out.index,
                                        dtype=object)
        return out
    nested = flat.tolist()
    out[featureColName] = pd.Series(
        [nested[i][w - cnt[i]:] for i in range(n)], dtype=object)
    return tsdf._with_rows(out)


def lookback_stack(x: torch.Tensor, m: torch.Tensor, w: int):
    """[K, L, F] (values, mask) -> [K, L, w, F] shifted stacks: window
    slot j holds observation t - w + j (oldest first), zero / False
    where absent."""
    K, L, F = x.shape

    def stack(a):
        padded = torch.cat([a.new_zeros((K, w, F)), a], dim=1)
        # unfold: [K, L + 1, F, w], window t = padded[t : t + w]
        return padded.unfold(1, w, 1)[:, :L].permute(0, 1, 3, 2).contiguous()

    return stack(x), stack(m)


def lookback_tensor(tsdf, featureCols: List[str], lookbackWindowSize: int):
    """The dense [K, L, w, F] lookback tensor (zero-padded) and its
    validity mask, on the frame's device."""
    vals, valids = _packed_metric_stack(tsdf, featureCols)   # [F, K, L]
    return lookback_stack(vals.permute(1, 2, 0), valids.permute(1, 2, 0),
                          int(lookbackWindowSize))
