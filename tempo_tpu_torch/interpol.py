"""Interpolation service (parity: python/tempo/interpol.py).

Counterpart of ``tempo_tpu/interpol.py``.  ``Interpolation(is_resampled)``
validates inputs (interpol.py:17-64), optionally resamples
(interpol.py:292-296), lays the resampled rows on a dense per-series
grid (host numpy), and fills missing grid slots and null values with one
of zero/null/ffill/bfill/linear on the frame's device
(``ops/interpolate.interpolate_columns``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.freq import freq_to_seconds, validateFuncExists
from tempo_tpu_torch.frame import TSDF
from tempo_tpu_torch.ops import interpolate as ik

method_options = ["zero", "null", "bfill", "ffill", "linear"]


def dense_grid(sampled_tsdf: TSDF, freq_sec: int, target_cols: List[str]):
    """The resampled rows of ``sampled_tsdf`` on a dense [K, G] grid of
    ``freq_sec`` steps, host numpy: ``(real [K, G] bool, glen [K] int64,
    ts_sec [K, G] float64, vals [C, K, G] float64, valid [C, K, G] bool,
    grid_ns [n_slots] int64)``.

    Per-row generated-slot counts mirror the reference's
    explode(sequence(ts, next_ts - freq, freq)) (interpol.py:330-336):
    row i emits floor((next_ts - ts)/freq) slots at ts, ts+freq, ...; the
    last row of a series emits exactly itself; a row whose gap to the
    next is < freq emits nothing and is dropped (explode of an empty
    sequence removes the row - duplicate/misaligned input)."""
    layout = sampled_tsdf.layout
    K = layout.n_series
    n = layout.n_rows
    kid = layout.key_ids
    ts_ns = layout.ts_ns
    step_ns = np.int64(freq_sec) * packing.NS_PER_S

    m = np.ones(n, dtype=np.int64)
    if n > 1:
        next_same_key = kid[1:] == kid[:-1]
        gaps = ts_ns[1:] - ts_ns[:-1]
        m[:-1] = np.where(next_same_key, gaps // step_ns, 1)

    total = int(m.sum())
    excl = np.concatenate([[0], np.cumsum(m)[:-1]])
    row_of_slot = np.repeat(np.arange(n), m)
    j = np.arange(total) - excl[row_of_slot]
    grid_ns = ts_ns[row_of_slot] + j * step_ns
    key_of_slot = kid[row_of_slot]
    glen = np.bincount(key_of_slot, minlength=K).astype(np.int64)
    G = packing.pad_length(int(glen.max(initial=1)))
    key_starts = np.concatenate([[0], np.cumsum(glen)[:-1]])
    slot_in_key = np.arange(total) - key_starts[key_of_slot]

    real = np.zeros((K, G), dtype=bool)
    real[key_of_slot, slot_in_key] = j == 0
    ts_sec = np.zeros((K, G), dtype=np.float64)
    # unix_timestamp() truncation semantics (interpol.py:78-84)
    ts_sec[key_of_slot, slot_in_key] = grid_ns // packing.NS_PER_S

    kept = m > 0
    kept_slot = excl[kept]  # flat slot of each kept row's own position
    vals = np.full((len(target_cols), K, G), np.nan)
    valid = np.zeros((len(target_cols), K, G), dtype=bool)
    for ci, c in enumerate(target_cols):
        v, ok = sampled_tsdf.numeric_flat(c)
        vals[ci, key_of_slot[kept_slot], slot_in_key[kept_slot]] = v[kept]
        valid[ci, key_of_slot[kept_slot], slot_in_key[kept_slot]] = ok[kept]
    return real, glen, ts_sec, vals, valid, grid_ns


class Interpolation:
    def __init__(self, is_resampled: bool):
        self.is_resampled = is_resampled

    def __validate_fill(self, method: str):
        if method not in method_options:
            raise ValueError(
                f"Please select from one of the following fill options: {method_options}"
            )

    def __validate_col(
        self,
        df: pd.DataFrame,
        partition_cols: List[str],
        target_cols: List[str],
        ts_col: str,
    ):
        for column in partition_cols:
            if column not in df.columns:
                raise ValueError(
                    f"Partition Column: '{column}' does not exist in DataFrame."
                )
        for column in target_cols:
            if column not in df.columns:
                raise ValueError(
                    f"Target Column: '{column}' does not exist in DataFrame."
                )
            if not (
                pd.api.types.is_numeric_dtype(df[column].dtype)
                and not pd.api.types.is_bool_dtype(df[column].dtype)
            ):
                raise ValueError(
                    "Target Column needs to be one of the following types: "
                    "['int', 'bigint', 'float', 'double']"
                )
        if ts_col not in df.columns:
            raise ValueError(
                f"Timestamp Column: '{ts_col}' does not exist in DataFrame."
            )
        if not pd.api.types.is_datetime64_any_dtype(df[ts_col].dtype):
            raise ValueError("Timestamp Column needs to be of timestamp type.")

    def interpolate(
        self,
        tsdf,
        ts_col: str,
        partition_cols: List[str],
        target_cols: List[str],
        freq: str,
        func: str,
        method: str,
        show_interpolated: bool,
    ) -> pd.DataFrame:
        from tempo_tpu_torch import resample as rs

        self.__validate_fill(method)
        self.__validate_col(tsdf.df, partition_cols, target_cols, ts_col)

        freq_sec = freq_to_seconds(freq)

        if not self.is_resampled:
            validateFuncExists(func)
            sampled = rs.aggregate(tsdf, freq, func, metricCols=target_cols)
        else:
            sampled = tsdf.df[[*partition_cols, ts_col, *target_cols]]

        sampled_tsdf = tsdf._with_df(sampled, ts_col=ts_col,
                                     partition_cols=partition_cols)
        real, glen, ts_sec, vals, valid, grid_ns = dense_grid(
            sampled_tsdf, freq_sec, target_cols)

        # float32 compute (the card's): rebase grid seconds to per-series
        # offsets (linear interpolation only ever differences timestamps
        # within a series) so they stay exactly representable; grids
        # spanning >= 2^24 s (~194 days) keep float64
        dt = tsdf.dtype
        ts_dev = ts_sec
        if dt == torch.float32:
            span = ts_sec - ts_sec[:, :1]
            if span.max(initial=0.0) < 2**24:
                ts_dev = span
            else:
                dt = torch.float64
        up = sampled_tsdf._upload
        out_v, out_ok, ts_interp, col_interp = ik.interpolate_columns(
            up(real), up(glen.astype(np.int32)), up(ts_dev).to(dt),
            float(freq_sec), up(vals).to(dt), up(valid), method,
        )
        out_v = out_v.cpu().numpy()
        out_ok = out_ok.cpu().numpy()
        ts_interp = ts_interp.cpu().numpy()
        col_interp = col_interp.cpu().numpy()

        # unpack grid -> flat rows (slots are already in key-major order)
        K, G = real.shape
        gmask = np.arange(G)[None, :] < glen[:, None]
        key_ids = np.repeat(np.arange(K), glen)

        out = {}
        key_frame = sampled_tsdf.layout.key_frame
        for c in partition_cols:
            out[c] = key_frame[c].to_numpy()[key_ids]
        out[ts_col] = packing.ns_to_original(grid_ns, sampled[ts_col].dtype)
        for ci, c in enumerate(target_cols):
            col = out_v[ci][gmask].astype(np.float64)
            col[~out_ok[ci][gmask]] = np.nan
            out[c] = col
        out["is_ts_interpolated"] = ts_interp[gmask]
        for ci, c in enumerate(target_cols):
            out[f"is_interpolated_{c}"] = col_interp[ci][gmask]

        result = pd.DataFrame(out)
        if not show_interpolated:
            result = result.drop(
                columns=["is_ts_interpolated"]
                + [f"is_interpolated_{c}" for c in target_cols]
            )
        return result


def interpolate_frame(
    tsdf,
    freq: str,
    func: str,
    method: str,
    target_cols=None,
    ts_col=None,
    partition_cols=None,
    show_interpolated: bool = False,
):
    """TSDF.interpolate (tsdf.py:778-811): defaults resolve from the
    frame; resamples first, then fills."""
    if ts_col is None:
        ts_col = tsdf.ts_col
    if partition_cols is None:
        partition_cols = tsdf.partitionCols
    if target_cols is None:
        prohibited = set(partition_cols + [ts_col])
        target_cols = [
            c
            for c in tsdf.df.columns
            if (
                pd.api.types.is_numeric_dtype(tsdf.df[c].dtype)
                and not pd.api.types.is_bool_dtype(tsdf.df[c].dtype)
                and c not in prohibited
            )
        ]

    service = Interpolation(is_resampled=False)
    tsdf_input = tsdf._with_df(tsdf.df, ts_col=ts_col,
                               partition_cols=partition_cols)
    out = service.interpolate(
        tsdf_input, ts_col, partition_cols, target_cols, freq, func, method,
        show_interpolated,
    )
    return tsdf_input._with_df(out)
