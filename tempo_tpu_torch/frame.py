"""TSDF: the time-series frame of the port.

Counterpart of ``tempo_tpu/frame.py``, cut to the ported slices: the
constructor and its validation, the packed accessors, ``asofJoin``,
``withRangeStats``, ``EMA``, ``resample``, ``calc_bars``,
``resampleEMA``, ``interpolate`` and ``df``.  The frame wraps host pandas
data plus a cache of packed [K series, L lanes] tensors on its device;
every op is eager (the reference's lazy planner is not part of this
port).  ``device=None`` means the CUDA card; ``device="cpu"`` runs the
kernels' plain versions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import device as devices
from tempo_tpu_torch import packing
from tempo_tpu_torch.packing import FlatLayout


def _is_numeric(dtype) -> bool:
    return (pd.api.types.is_numeric_dtype(dtype)
            and not pd.api.types.is_bool_dtype(dtype)
            and not pd.api.types.is_complex_dtype(dtype))


class TSDF:
    """A time-series frame: (data, ts_col, partition_cols, sequence_col).

    Validation follows the reference (tsdf.py:45-64): case-insensitive
    presence checks and typed errors."""

    def __init__(
        self,
        df: pd.DataFrame,
        ts_col: str = "event_ts",
        partition_cols: Optional[Union[str, List[str]]] = None,
        sequence_col: Optional[str] = None,
        device: devices.DeviceLike = None,
        dtype: Union[str, torch.dtype, None] = None,
    ):
        if not isinstance(df, pd.DataFrame):
            raise TypeError(
                f"TSDF expects a pandas DataFrame; got {type(df)} instead!")
        self.device = devices.resolve(device)
        self.dtype = devices.compute_dtype(self.device, dtype)
        self.ts_col = self._validated_column(df, ts_col)
        self.partitionCols = ([] if partition_cols is None
                              else self._validated_columns(df, partition_cols))
        self.sequence_col = "" if sequence_col is None else sequence_col
        if self.sequence_col:
            self._validated_column(df, self.sequence_col)
        self.df = df.reset_index(drop=True)
        self._layout: Optional[FlatLayout] = None
        self._packed: Dict[str, object] = {}

    @staticmethod
    def _validated_column(df: pd.DataFrame, colname: str) -> str:
        if not isinstance(colname, str):
            raise TypeError(
                f"Column names must be of type str; found {type(colname)} instead!")
        if colname.lower() not in [c.lower() for c in df.columns]:
            raise ValueError(f"Column {colname} not found in Dataframe")
        return colname

    @classmethod
    def _validated_columns(cls, df, colnames) -> List[str]:
        if isinstance(colnames, str):
            colnames = [colnames]
        elif not isinstance(colnames, list):
            raise TypeError(
                f"Columns must be of type list, str, or None; found {type(colnames)} instead!")
        for col in colnames:
            cls._validated_column(df, col)
        return colnames

    def _with_df(self, df: pd.DataFrame, ts_col: Optional[str] = None,
                 partition_cols=None, sequence_col=None) -> "TSDF":
        """A frame over new data on this frame's device and dtype."""
        return TSDF(df, ts_col or self.ts_col,
                    self.partitionCols if partition_cols is None
                    else partition_cols,
                    sequence_col, device=self.device, dtype=self.dtype)

    def _check_partition_cols_match(self, other: "TSDF") -> None:
        for lc, rc in zip(self.partitionCols, other.partitionCols):
            if lc != rc:
                raise ValueError(
                    "left and right dataframe partition columns should "
                    "have same name in same order")

    def _validate_ts_col_match(self, other: "TSDF") -> None:
        if self.df[self.ts_col].dtype.kind != other.df[other.ts_col].dtype.kind:
            raise ValueError(
                "left and right dataframe timestamp index columns should "
                "have same type")

    @property
    def columns(self) -> List[str]:
        return list(self.df.columns)

    def summarizable_columns(self) -> List[str]:
        """Numeric columns other than ts and partition columns
        (tsdf.py:691-701)."""
        prohibited = {self.ts_col.lower()}
        prohibited.update(pc.lower() for pc in self.partitionCols)
        return [c for c in self.df.columns
                if _is_numeric(self.df[c].dtype) and c.lower() not in prohibited]

    # ------------------------------------------------------------------
    # Packed layout accessors
    # ------------------------------------------------------------------

    @property
    def layout(self) -> FlatLayout:
        if self._layout is None:
            self._layout = packing.build_flat_layout(
                self.df, self.ts_col, self.partitionCols,
                self.sequence_col or None)
        return self._layout

    def numeric_flat(self, col: str):
        """(float64 values, valid) in the sorted flat layout; NaN is
        null."""
        series = self.df[col]
        vals = pd.to_numeric(series, errors="coerce").to_numpy(dtype=np.float64)
        valid = ~pd.isna(series).to_numpy() & ~np.isnan(vals)
        return vals[self.layout.order], valid[self.layout.order]

    def packed_len(self) -> int:
        return packing.pad_length(int(self.layout.lengths.max(initial=0)))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # pandas may hand out read-only views; torch wants a writable
        # buffer to wrap
        arr = np.require(arr, requirements=("C_CONTIGUOUS", "WRITEABLE"))
        return torch.from_numpy(arr).to(self.device)

    def packed_ts(self) -> np.ndarray:
        """[K, L] int64 ns timestamps (host), padded with TS_PAD."""
        if "__ts__" not in self._packed:
            self._packed["__ts__"] = packing.pack_column(
                self.layout.ts_ns, self.layout, self.packed_len(),
                fill=packing.TS_PAD)
        return self._packed["__ts__"]

    def packed_numeric(self, col: str):
        """([K, L] values in the frame's dtype with NaN padding, [K, L]
        valid bool), both on the frame's device."""
        key = f"num:{col}"
        if key not in self._packed:
            vals, valid = self.numeric_flat(col)
            L = self.packed_len()
            pv = packing.pack_column(vals, self.layout, L, fill=np.nan)
            pm = packing.pack_column(valid, self.layout, L, fill=False)
            self._packed[key] = (self._upload(pv).to(self.dtype),
                                 self._upload(pm))
        return self._packed[key]

    def packed_mask(self) -> np.ndarray:
        """[K, L] bool mask of real rows (host)."""
        if "__mask__" not in self._packed:
            self._packed["__mask__"] = packing.row_mask(self.layout,
                                                        self.packed_len())
        return self._packed["__mask__"]

    def ts_dtype(self):
        return self.df[self.ts_col].dtype

    # ------------------------------------------------------------------
    # Operations
    # ------------------------------------------------------------------

    def asofJoin(self, right_tsdf: "TSDF", left_prefix: Optional[str] = None,
                 right_prefix: str = "right", tsPartitionVal=None,
                 fraction: float = 0.5, skipNulls: bool = True,
                 sql_join_opt: bool = False,
                 suppress_null_warning: bool = False,
                 maxLookback: int = 0) -> "TSDF":
        """AS-OF join (parity: tsdf.py:463-560; maxLookback from scala
        asofJoin.scala:64-88)."""
        from tempo_tpu_torch import join

        return join.asof_join(
            self, right_tsdf, left_prefix=left_prefix,
            right_prefix=right_prefix, tsPartitionVal=tsPartitionVal,
            fraction=fraction, skipNulls=skipNulls,
            sql_join_opt=sql_join_opt,
            suppress_null_warning=suppress_null_warning,
            maxLookback=maxLookback)

    def withRangeStats(self, type: str = "range", colsToSummarize=None,
                       rangeBackWindowSecs: int = 1000) -> "TSDF":
        """Rolling range statistics (parity: tsdf.py:673-721)."""
        from tempo_tpu_torch import rolling

        return rolling.with_range_stats(self, colsToSummarize,
                                        rangeBackWindowSecs)

    def EMA(self, colName: str, window: int = 30, exp_factor: float = 0.2,
            exact: bool = False, inclusive_window: bool = False) -> "TSDF":
        """Exponential moving average (parity: tsdf.py:615-635;
        ``exact=True`` is the untruncated recursive EMA;
        ``inclusive_window=True`` the Scala 0..window lag range)."""
        from tempo_tpu_torch import rolling

        return rolling.ema(self, colName, window, exp_factor, exact,
                           inclusive_window)

    def resample(self, freq: str, func=None, metricCols=None, prefix=None,
                 fill=None):
        """Downsample by a coarser frequency (parity: tsdf.py:764-776).
        Returns a ``_ResampledTSDF`` supporting chained ``.interpolate``."""
        from tempo_tpu_torch import resample as rs

        return rs.resample(self, freq, func, metricCols, prefix, fill)

    def calc_bars(self, freq: str, func=None, metricCols=None,
                  fill=None) -> "TSDF":
        """OHLC bars (parity: tsdf.py:813-826)."""
        from tempo_tpu_torch import resample as rs

        return rs.calc_bars(self, freq, func, metricCols, fill)

    def resampleEMA(self, freq: str, colName: str,
                    exp_factor: float = 0.2) -> "TSDF":
        """Fused floor-resample + exact EMA in one kernel pass: the
        single-read form of ``resample(freq, 'floor')`` followed by
        ``EMA(..., exact=True)`` (``resample.resample_ema``)."""
        from tempo_tpu_torch import resample as rs

        return rs.resample_ema(self, freq, colName, exp_factor)

    def interpolate(self, freq: str = None, func: str = None,
                    method: str = None, target_cols=None, ts_col: str = None,
                    partition_cols=None,
                    show_interpolated: bool = False) -> "TSDF":
        """Resample + fill missing values (parity: tsdf.py:778-811)."""
        from tempo_tpu_torch import interpol

        return interpol.interpolate_frame(
            self, freq, func, method, target_cols, ts_col, partition_cols,
            show_interpolated)
