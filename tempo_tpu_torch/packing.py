"""Ragged -> padded packing: the layout every kernel of the port reads.

Counterpart of ``tempo_tpu/packing.py``: the ragged per-key row groups
of a pandas frame become dense ``[K series, L lanes]`` arrays with
validity masks, sorted by (key, ts, seq) once at ingest so the kernels
may assume sorted rows.  Time is int64 nanoseconds; range windows
compare per-series rebased int32 seconds.  Everything here is host
code; the frame layer moves the packed arrays to the device.

The sort (:func:`_sort_layout`), the gather (:func:`take`) and the
pack and unpack run the C++ engine (``native/``) unless
``TEMPO_TPU_NATIVE=0``; its results are bitwise those of the numpy
path.  Two cases stay on numpy whatever the knob says, as in the
reference, because the engine cannot express them: object columns
(no fixed item size) and ``uint64`` sequence values above 2^63 (the
engine compares int64).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from tempo_tpu_torch import native

NS_PER_S = 1_000_000_000

# padded slots of the time axis: above every real timestamp, so sorted
# kernels ignore them, with headroom against int64 overflow
TS_PAD = np.int64(2**62)

# any ts at or above this is a sentinel, not data (real ns timestamps
# stay far below 2^61, about the year 2043): the time axis's halo and
# join audits tell real rows from padding by it
TS_REAL_MAX = np.int64(2**61)

# canonical name/order of the per-column withRangeStats aggregates
RANGE_STATS = ("mean", "count", "min", "max", "sum", "stddev", "zscore")

# series id of bin-packed pad slots
SID_PAD = np.int32(2**31 - 1)


def rebase_seconds(ts_sec: np.ndarray, pad_mask: Optional[np.ndarray] = None):
    """Per-series rebase of a [K, L] seconds axis to small offsets.

    Returns (rebased int32 [K, L], ok); pads (``pad_mask`` True) clamp
    to INT32_MAX.  ``ok`` False means a span overflows int32 and the
    int64 seconds come back unchanged."""
    if ts_sec.size == 0:
        return ts_sec.astype(np.int32), True
    first = ts_sec[:, :1]
    span = ts_sec - first
    if pad_mask is not None:
        span = np.where(pad_mask, 0, span)
    if span.max(initial=0) >= 2**31 - 2:
        return ts_sec.astype(np.int64), False
    out = span.astype(np.int32)
    if pad_mask is not None:
        out = np.where(pad_mask, np.int32(2**31 - 1), out)
    return out, True


def _before_pad(latest, what) -> None:
    """Refuse a timestamp at or past :data:`TS_PAD` (2^62 ns after the
    epoch, 2116-02-20 23:53:38.427387904): the packed layouts pad with
    that key, so a real row there would sort among the pads and every
    windowed, joined or ranked answer past it would be wrong (the
    reference computes them silently).  ``what()`` names the timestamp,
    built only when it raises."""
    if latest >= TS_PAD:
        raise ValueError(
            f"timestamp {what()} is at or past 2^62 ns after the epoch "
            f"(2116-02-20 23:53:38.427387904), the key the packed layouts "
            f"pad with; integer timestamps are read as seconds")


def series_to_ns(values: "pd.Series | np.ndarray") -> np.ndarray:
    """A timestamp-like column as int64 nanoseconds (datetimes as is,
    integers and floats as seconds).  A timestamp at or past
    :data:`TS_PAD` raises ``ValueError``."""
    if isinstance(values, pd.Series) and isinstance(
        values.dtype, pd.DatetimeTZDtype
    ):
        values = values.dt.tz_convert("UTC").dt.tz_localize(None)
    arr = values.to_numpy() if isinstance(values, pd.Series) else np.asarray(values)
    if np.issubdtype(arr.dtype, np.datetime64):
        ns = arr.astype("datetime64[ns]").astype(np.int64)
        if ns.size:
            top = int(ns.max())
            _before_pad(top, lambda: str(np.int64(top).astype(
                "datetime64[ns]")))
        return ns
    if np.issubdtype(arr.dtype, np.integer):
        if arr.size:
            top = int(arr.max())
            _before_pad(top * int(NS_PER_S), lambda: f"{top} s")
        return arr.astype(np.int64) * NS_PER_S
    if np.issubdtype(arr.dtype, np.floating):
        if arr.size and np.isfinite(arr).any():
            top = float(np.nanmax(np.where(np.isinf(arr), np.nan, arr)))
            _before_pad(top * float(NS_PER_S), lambda: f"{top} s")
        return np.round(arr * NS_PER_S).astype(np.int64)
    raise TypeError(f"Unsupported timestamp dtype: {arr.dtype}")


def ns_to_original(ns: np.ndarray, like_dtype):
    """Map canonical ns back to the dtype the user supplied."""
    if isinstance(like_dtype, pd.DatetimeTZDtype):
        utc = pd.Series(ns.astype("datetime64[ns]")).dt.tz_localize("UTC")
        return utc.dt.tz_convert(like_dtype.tz).to_numpy()
    if np.issubdtype(like_dtype, np.datetime64):
        return ns.astype("datetime64[ns]")
    if np.issubdtype(like_dtype, np.integer):
        return (ns // NS_PER_S).astype(like_dtype)
    if np.issubdtype(like_dtype, np.floating):
        return (ns / NS_PER_S).astype(like_dtype)
    raise TypeError(f"Unsupported timestamp dtype: {like_dtype}")


def encode_keys(
    df: pd.DataFrame, partition_cols: List[str]
) -> Tuple[np.ndarray, pd.DataFrame]:
    """Partition-key tuples as dense series ids, in order of first
    appearance.  Returns (key_ids [n_rows], key_frame)."""
    if not partition_cols:
        return np.zeros(len(df), dtype=np.int64), pd.DataFrame(index=[0])
    if len(partition_cols) == 1:
        codes, uniques = pd.factorize(df[partition_cols[0]], use_na_sentinel=False)
        return codes.astype(np.int64), pd.DataFrame({partition_cols[0]: uniques})
    mi = pd.MultiIndex.from_frame(df[partition_cols])
    codes, uniques = pd.factorize(mi, use_na_sentinel=False)
    key_frame = pd.DataFrame([list(t) for t in uniques], columns=partition_cols)
    return codes.astype(np.int64), key_frame


def encode_keys_joint(
    df_left: pd.DataFrame, df_right: pd.DataFrame, partition_cols: List[str]
) -> Tuple[np.ndarray, np.ndarray, pd.DataFrame]:
    """Series ids over the union of both frames' keys."""
    nl = len(df_left)
    if not partition_cols:
        return (np.zeros(nl, dtype=np.int64),
                np.zeros(len(df_right), dtype=np.int64),
                pd.DataFrame(index=[0]))
    both = pd.concat(
        [df_left[partition_cols], df_right[partition_cols]], ignore_index=True
    )
    codes, key_frame = encode_keys(both, partition_cols)
    return codes[:nl], codes[nl:], key_frame


@dataclasses.dataclass
class FlatLayout:
    """Rows sorted by (key_id, ts_ns, seq), with per-series offsets."""

    key_ids: np.ndarray       # int64 [n]
    ts_ns: np.ndarray         # int64 [n]
    order: np.ndarray         # int64 [n]  positions into the user's df
    starts: np.ndarray        # int64 [K+1] row offsets per series
    key_frame: pd.DataFrame   # [K x partition_cols]

    @property
    def n_rows(self) -> int:
        return int(self.ts_ns.shape[0])

    @property
    def n_series(self) -> int:
        return int(self.starts.shape[0] - 1)

    @property
    def lengths(self) -> np.ndarray:
        return self.starts[1:] - self.starts[:-1]


def _sort_layout(key_ids, ts_ns, seq, n_series):
    """(order, starts) of the (key, ts, seq) total order."""
    use_native = native.enabled()
    if use_native and seq is not None and \
            np.issubdtype(np.asarray(seq).dtype, np.unsignedinteger):
        # uint64 ids above 2^63 would wrap through the engine's int64
        use_native = seq.size == 0 or \
            int(seq.max()) <= np.iinfo(np.int64).max
    if use_native:
        return native.sort_layout(key_ids, ts_ns, seq, n_series)
    if seq is not None:
        order = np.lexsort((seq, ts_ns, key_ids))
    else:
        order = np.lexsort((ts_ns, key_ids))
    counts = np.bincount(key_ids, minlength=n_series)
    starts = np.zeros(n_series + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts


def build_flat_layout(df: pd.DataFrame, ts_col: str,
                      partition_cols: List[str],
                      sequence_col: Optional[str] = None) -> FlatLayout:
    key_ids, key_frame = encode_keys(df, partition_cols)
    ts_ns = series_to_ns(df[ts_col])
    # integer sequence columns stay exact (no float64 round trip)
    seq = pd.to_numeric(df[sequence_col]).to_numpy() if sequence_col else None
    order, starts = _sort_layout(key_ids, ts_ns, seq, len(key_frame))
    return FlatLayout(key_ids=take(key_ids, order),
                      ts_ns=take(ts_ns, order),
                      order=order, starts=starts, key_frame=key_frame)


def take(values: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``values[order]``: the engine's threaded gather for a fixed item
    size."""
    if values.dtype != object and native.enabled():
        return native.take(values, order)
    return values[order]


def build_layout_from_codes(key_ids: np.ndarray, ts_ns: np.ndarray,
                            seq: Optional[np.ndarray],
                            n_series: int) -> FlatLayout:
    """:func:`build_flat_layout` with externally assigned series ids."""
    order, starts = _sort_layout(key_ids, ts_ns, seq, n_series)
    return FlatLayout(key_ids=take(key_ids, order),
                      ts_ns=take(ts_ns, order), order=order, starts=starts,
                      key_frame=pd.DataFrame(index=range(n_series)))


def pad_length(max_len: int, multiple: int = 8) -> int:
    """Series length rounded up to ``multiple`` (at least one block)."""
    if max_len <= 0:
        return multiple
    return int(-(-max_len // multiple) * multiple)


def _positions(layout: FlatLayout) -> np.ndarray:
    return np.arange(layout.n_rows, dtype=np.int64) - layout.starts[layout.key_ids]


def pack_column(values: np.ndarray, layout: FlatLayout,
                padded_len: Optional[int] = None, fill=0) -> np.ndarray:
    """Scatter a flat (key/ts-sorted) column into [K, L] dense form."""
    if padded_len is None:
        padded_len = pad_length(int(layout.lengths.max(initial=0)))
    if values.dtype != object and native.enabled():
        return native.pack(values, layout.starts, int(padded_len), fill)
    out = np.full((layout.n_series, padded_len), fill, dtype=values.dtype)
    out[layout.key_ids, _positions(layout)] = values
    return out


def unpack_column(packed: np.ndarray, layout: FlatLayout) -> np.ndarray:
    """Gather [K, L] padded form back into the sorted flat layout."""
    if packed.dtype != object and native.enabled():
        return native.unpack(packed, layout.starts)
    return packed[layout.key_ids, _positions(layout)]


def row_mask(layout: FlatLayout, padded_len: int) -> np.ndarray:
    """Boolean [K, L] mask of real (non-padding) rows."""
    return np.arange(padded_len)[None, :] < layout.lengths[:, None]


def layout_rowbounds(layout: FlatLayout, window_secs: float):
    """(max rows back, max tie rows ahead) that any
    rangeBetween(-window_secs, 0) frame spans over this layout, or None
    when a per-series span plus the window overflows the int32 rebased
    keys.  Cached per (layout, window)."""
    cache = layout.__dict__.setdefault("_rowbound_cache", {})
    key = float(window_secs)
    if key not in cache:
        secs = layout.ts_ns // NS_PER_S
        w = np.int64(window_secs)
        behind = 0
        ahead = 0
        span_i32 = True
        for k in range(layout.n_series):
            s = secs[layout.starts[k]: layout.starts[k + 1]]
            if len(s) == 0:
                continue
            idx = np.arange(len(s))
            behind = max(
                behind,
                int((idx - np.searchsorted(s, s - w, side="left")).max()))
            ahead = max(
                ahead,
                int((np.searchsorted(s, s, side="right") - 1 - idx).max()))
            if int(s[-1] - s[0]) + int(w) >= 2**31 - 2:
                span_i32 = False
        cache[key] = (behind, ahead) if span_i32 else None
    return cache[key]


@dataclasses.dataclass
class BinPackLayout:
    """Series assigned to shared lane rows: ``row[s]`` is the lane row
    of series ``s``, ``l_off[s]``/``r_off[s]`` its first lane on each
    side.  Within a row series ascend by id and pads sit at the tail
    (sid = SID_PAD), the layout the segmented join requires."""

    row: np.ndarray     # [S] int32
    l_off: np.ndarray   # [S] int32
    r_off: np.ndarray   # [S] int32
    n_rows: int
    l_width: int
    r_width: int


def bin_pack_series(l_lengths: np.ndarray, r_lengths: np.ndarray,
                    l_width: int, r_width: int) -> BinPackLayout:
    """First-fit-decreasing packing of series into lane rows with two
    capacities; series keep ascending id order within each row."""
    l_lengths = np.asarray(l_lengths, np.int64)
    r_lengths = np.asarray(r_lengths, np.int64)
    S = len(l_lengths)
    if np.any(l_lengths > l_width) or np.any(r_lengths > r_width):
        raise ValueError("a series exceeds the lane-row width")
    sev = np.maximum(l_lengths / max(l_width, 1), r_lengths / max(r_width, 1))
    order = np.argsort(-sev, kind="stable")
    l_rem: list = []
    r_rem: list = []
    row = np.zeros(S, np.int32)
    for s in order:
        for b in range(len(l_rem)):
            if l_rem[b] >= l_lengths[s] and r_rem[b] >= r_lengths[s]:
                row[s] = b
                l_rem[b] -= l_lengths[s]
                r_rem[b] -= r_lengths[s]
                break
        else:
            row[s] = len(l_rem)
            l_rem.append(l_width - int(l_lengths[s]))
            r_rem.append(r_width - int(r_lengths[s]))
    l_off = np.zeros(S, np.int32)
    r_off = np.zeros(S, np.int32)
    l_cur = np.zeros(len(l_rem), np.int64)
    r_cur = np.zeros(len(l_rem), np.int64)
    for s in range(S):
        b = row[s]
        l_off[s] = l_cur[b]
        r_off[s] = r_cur[b]
        l_cur[b] += l_lengths[s]
        r_cur[b] += r_lengths[s]
    return BinPackLayout(row=row, l_off=l_off, r_off=r_off,
                         n_rows=len(l_rem), l_width=int(l_width),
                         r_width=int(r_width))


def binpack_dest(starts: np.ndarray, row: np.ndarray, off: np.ndarray,
                 width: int) -> np.ndarray:
    """Flat destination slot, in the bin-packed [n_rows, width] grid, of
    every row of a flat per-series-sorted column."""
    n = int(starts[-1])
    key_ids = np.repeat(np.arange(len(row), dtype=np.int64), np.diff(starts))
    pos = np.arange(n, dtype=np.int64) - starts[key_ids]
    return row[key_ids].astype(np.int64) * width + off[key_ids] + pos


def binpack_scatter(flat: np.ndarray, dest: np.ndarray, n_rows: int,
                    width: int, fill, dtype=None) -> np.ndarray:
    """Scatter a flat column into the bin-packed grid."""
    out = np.full(n_rows * width, fill, dtype=dtype or flat.dtype)
    out[dest] = flat
    return out.reshape(n_rows, width)
