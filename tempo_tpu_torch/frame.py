"""TSDF: the time-series frame of the port.

Counterpart of ``tempo_tpu/frame.py`` on one device: the constructor and
its validation, the column classes, the packed accessors, the
DataFrame-mirror ops (``select``, ``selectExpr``, ``filter``, ...; SQL
strings through the host evaluator ``sql.py``), ``asofJoin``,
``withRangeStats``, ``withGroupedStats``, ``EMA``, ``vwap``, the lookback
features, ``fourier_transform``, ``autocorr``, ``describe``, the
resample family, ``fromOrderingColumns``, ``on_mesh`` (the
series-sharded ``DistributedTSDF``, ``dist.py``) and the I/O (``write``
through ``io/writer.py``, ``to_arrow``/``from_arrow``,
``from_spark``/``to_spark``) and ``explain``.  The frame wraps host
pandas data plus a cache of packed [K series, L lanes] tensors on its
device; every op is eager unless ``TEMPO_TPU_PLAN=1``, under which the
methods named in ``plan.ir.PLANNED_METHODS`` record plan nodes and
return lazy wrappers (``plan/lazy.py``) that optimize and execute at a
terminal.  Every derived frame keeps the device and dtype.
``device=None`` means the CUDA card; ``device="cpu"`` runs the kernels'
plain versions.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import config, packing
from tempo_tpu_torch import device as devices
from tempo_tpu_torch.packing import FlatLayout

logger = logging.getLogger(__name__)

DEFAULT_SEQ_COLNAME = "sequence_num"  # parity: scala TSDF.scala:529


def _strict_sql(strict: Optional[bool]) -> bool:
    """Resolve the strict-SQL switch: an explicit argument wins, else
    ``TEMPO_TPU_SQL_STRICT``, else the legacy ``TEMPO_TPU_STRICT_SQL``
    (both default off)."""
    if strict is not None:
        return bool(strict)
    return (config.get_bool("TEMPO_TPU_SQL_STRICT")
            or config.get_bool("TEMPO_TPU_STRICT_SQL"))


def _split_alias(raw: str):
    """Split ``expr as alias`` at the last top-level ``as``/``AS``
    (outside single/double quotes and backticks) for the selectExpr
    fallback path.  Returns (expr, alias) or None when no plausible
    alias exists."""
    low = raw.lower()
    in_q = None
    last = -1
    for i, ch in enumerate(raw):
        if in_q:
            if ch == in_q:
                in_q = None
        elif ch in ("'", '"', "`"):
            in_q = ch
        elif low.startswith(" as ", i):
            last = i
    if last < 0:
        return None
    expr, alias = raw[:last].strip(), raw[last + 4:].strip()
    if re.fullmatch(r"`[^`]+`", alias):
        return expr, alias[1:-1]
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", alias):
        return expr, alias
    return None


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

    def _with_rows(self, df: pd.DataFrame) -> "TSDF":
        """A frame over new data with this frame's column roles (ts,
        partition and sequence columns), device and dtype."""
        return self._with_df(df, sequence_col=self.sequence_col or None)

    # ------------------------------------------------------------------
    # Lazy query planning (plan/; TEMPO_TPU_PLAN=1)
    # ------------------------------------------------------------------

    def _plan_record(self, op: str, others=(), params=None, objs=None):
        """Record a deferred plan node over this frame instead of
        executing (planning on).  Returns the lazy wrapper the planned
        chain continues on; its terminals (``collect``, ``.df``, ...)
        optimize and execute it through the executable cache."""
        from tempo_tpu_torch.plan import lazy as plan_lazy

        return plan_lazy.record(self, op, others, params, objs)

    def explain(self, cost: bool = False) -> str:
        """Render this frame's query plan.  An eager frame defers
        nothing, so its plan is a bare source; under ``TEMPO_TPU_PLAN=1``
        the lazy wrappers' ``explain`` shows the recorded logical plan,
        the optimizer's rewrites, per-node engine choices and barriers
        (the analog of the reference's ``explain cost``)."""
        from tempo_tpu_torch.plan import ir, render

        text = render.explain_text(ir.Node("source", payload=self),
                                   cost=cost)
        print(text)
        return text

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

    @property
    def structuralColumns(self) -> List[str]:
        """ts col + partition cols (scala TSDF.scala:193)."""
        cols = [self.ts_col] + self.partitionCols
        if self.sequence_col:
            cols.append(self.sequence_col)
        return cols

    @property
    def observationColumns(self) -> List[str]:
        """All non-structural columns (scala TSDF.scala:198-199)."""
        structural = set(self.structuralColumns)
        return [c for c in self.df.columns if c not in structural]

    @property
    def measureColumns(self) -> List[str]:
        """Numeric observation columns (scala TSDF.scala:204-205)."""
        return [c for c in self.observationColumns
                if _is_numeric(self.df[c].dtype)]

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

    def sorted_flat(self, col: str) -> np.ndarray:
        """Column values in the sorted flat layout (host)."""
        return packing.take(self.df[col].to_numpy(), self.layout.order)

    def numeric_flat(self, col: str):
        """(float64 values, valid) in the sorted flat layout; NaN is
        null."""
        series = self.df[col]
        vals = pd.to_numeric(series, errors="coerce").to_numpy(dtype=np.float64)
        valid = ~pd.isna(series).to_numpy() & ~np.isnan(vals)
        order = self.layout.order
        return packing.take(vals, order), packing.take(valid, order)

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
    # DataFrame-mirror operations (parity: scala TSDF.scala:218-293)
    # ------------------------------------------------------------------

    def select(self, *cols) -> "TSDF":
        """Parity: tsdf.py:319-343 - structural columns must be kept."""
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("select", params=dict(cols=tuple(cols)))
        if "*" in cols:
            cols = tuple(self.df.columns)
        seq_stub = [self.sequence_col] if self.sequence_col else []
        mandatory = [self.ts_col] + self.partitionCols + seq_stub
        if set(mandatory).issubset(set(cols)):
            return self._with_rows(self.df[list(cols)])
        raise Exception(
            "In TSDF's select statement original ts_col, partitionCols and "
            "seq_col_stub(optional) must be present")

    def selectExpr(self, *exprs, strict: Optional[bool] = None) -> "TSDF":
        """Spark-style SQL projections (parity: TSDF.scala:226-229) by
        the host expression engine (``sql.py``): arithmetic, CASE WHEN,
        CAST, IN/BETWEEN/LIKE and the common function library, with
        ``expr AS alias`` naming.  Expressions the SQL grammar rejects
        fall back to pandas ``eval`` syntax (e.g. ``price ** 2``); the
        switch is logged (the two engines differ on NULL semantics and
        function surface), and ``strict=True`` (or
        ``TEMPO_TPU_SQL_STRICT=1`` / the legacy ``TEMPO_TPU_STRICT_SQL=1``)
        raises ``StrictSqlFallback`` instead.  Under plan recording the
        parsed expressions lower into a ``sql_project`` node
        (``plan/sql_compile.py``)."""
        from tempo_tpu_torch import plan, sql

        strict = _strict_sql(strict)
        if plan.recording():
            from tempo_tpu_torch.plan import sql_compile

            try:
                lowered, objs = sql_compile.lower_select_exprs(
                    exprs, columns=list(self.df.columns))
            except sql.SqlError as e:
                if strict:
                    raise sql.StrictSqlFallback(
                        f"selectExpr{tuple(exprs)!r} left the compiled "
                        f"SQL surface ({e}); strict mode forbids the "
                        f"host-pandas fallback") from e
                logger.debug("selectExpr%r: outside the SQL grammar "
                             "(%s); evaluating eagerly", tuple(exprs), e)
            else:
                return self._plan_record("sql_project", params=dict(
                    exprs=lowered["exprs"], aliases=lowered["aliases"],
                    asts=lowered["asts"], cols=lowered["cols"],
                    strict=strict), objs=objs)
        out = {}
        for raw in exprs:
            try:
                out.update(sql.select_exprs(self.df, [raw]))
                logger.debug("selectExpr(%r): evaluated by the SQL "
                             "engine", raw)
            except sql.SqlError as e:
                if strict:
                    raise sql.StrictSqlFallback(
                        f"selectExpr({raw!r}) left the compiled SQL "
                        f"surface ({e}); strict mode forbids the "
                        f"pandas-eval fallback") from e
                logger.warning(
                    "selectExpr(%r): SQL engine rejected the expression "
                    "(%s); falling back to pandas eval semantics — pass "
                    "strict=True (or set TEMPO_TPU_SQL_STRICT=1) to "
                    "re-raise instead", raw, e)
                split = _split_alias(raw)
                if split is not None:
                    src, alias = split
                    out[alias] = (self.df[src] if src in self.df.columns
                                  else self.df.eval(src))
                else:
                    out[raw.strip()] = self.df[raw.strip()]
        return self._with_rows(pd.DataFrame(out))

    def filter(self, condition, strict: Optional[bool] = None) -> "TSDF":
        """Row filter (parity: TSDF.scala:232-238).  String predicates
        parse as SQL (three-valued logic: NULL rows drop, as in Spark);
        other strings fall back to pandas ``query`` syntax, logged,
        because the engines disagree on NULL handling, and turned into a
        ``StrictSqlFallback`` error by ``strict=True`` /
        ``TEMPO_TPU_SQL_STRICT=1`` (legacy ``TEMPO_TPU_STRICT_SQL``).  A
        callable gets the frame's DataFrame; anything else is a mask.
        Under plan recording a string predicate lowers into a
        ``sql_filter`` node (``plan/sql_compile.py``)."""
        from tempo_tpu_torch import plan

        if plan.recording() and isinstance(condition, str):
            from tempo_tpu_torch import sql
            from tempo_tpu_torch.plan import sql_compile

            try:
                lowered, objs = sql_compile.lower_filter(
                    condition, columns=list(self.df.columns))
            except sql.SqlError as e:
                if _strict_sql(strict):
                    raise sql.StrictSqlFallback(
                        f"filter({condition!r}) left the compiled SQL "
                        f"surface ({e}); strict mode forbids the "
                        f"host-pandas fallback") from e
                logger.debug("filter(%r): outside the SQL grammar (%s); "
                             "evaluating eagerly", condition, e)
            else:
                return self._plan_record("sql_filter", params=dict(
                    condition=condition, ast=lowered["ast"],
                    cols=lowered["cols"],
                    strict=_strict_sql(strict)), objs=objs)
        if callable(condition):
            mask = condition(self.df)
        elif isinstance(condition, str):
            from tempo_tpu_torch import sql

            try:
                mask = sql.filter_mask(self.df, condition)
                logger.debug("filter(%r): evaluated by the SQL engine",
                             condition)
            except sql.SqlError as e:
                if _strict_sql(strict):
                    raise sql.StrictSqlFallback(
                        f"filter({condition!r}) left the compiled SQL "
                        f"surface ({e}); strict mode forbids the "
                        f"pandas-query fallback") from e
                logger.warning(
                    "filter(%r): SQL engine rejected the predicate "
                    "(%s); falling back to pandas query semantics — "
                    "pass strict=True (or set TEMPO_TPU_SQL_STRICT=1) "
                    "to re-raise instead", condition, e)
                return self._with_rows(self.df.query(condition))
        else:
            mask = condition
        return self._with_rows(self.df[mask])

    where = filter

    def limit(self, n: int) -> "TSDF":
        return self._with_rows(self.df.head(n))

    def union(self, other: "TSDF") -> "TSDF":
        return self._with_rows(
            pd.concat([self.df, other.df[self.df.columns]],
                      ignore_index=True))

    unionAll = union

    def withColumn(self, colName: str, values) -> "TSDF":
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record(
                "with_column", params=dict(colName=colName, values=values),
                objs=dict(values=values))
        df = self.df.copy()
        df[colName] = values(df) if callable(values) else values
        return self._with_rows(df)

    def withColumnRenamed(self, existing: str, new: str) -> "TSDF":
        df = self.df.rename(columns={existing: new})
        ts_col = new if existing == self.ts_col else self.ts_col
        pcols = [new if c == existing else c for c in self.partitionCols]
        seq = new if existing == self.sequence_col else (
            self.sequence_col or None)
        return self._with_df(df, ts_col=ts_col, partition_cols=pcols,
                             sequence_col=seq)

    def drop(self, *cols) -> "TSDF":
        return self._with_rows(self.df.drop(columns=list(cols)))

    def withPartitionCols(self, partitionCols) -> "TSDF":
        """Parity: tsdf.py:583-590 (drops sequence_col, as the reference
        does)."""
        return self._with_df(self.df, partition_cols=partitionCols or [])

    # Scala front-end spellings (TSDF.scala:89 partitionedBy, :72 rangeStats)
    partitionedBy = withPartitionCols

    def rangeStats(self, colsToSummarise=None,
                   rangeBackWindowSecs: int = 1000) -> "TSDF":
        return self.withRangeStats(colsToSummarize=colsToSummarise,
                                   rangeBackWindowSecs=rangeBackWindowSecs)

    def show(self, n: int = 20, truncate: bool = True,
             vertical: bool = False) -> None:
        """Parity: tsdf.py:345-382, rendered by pandas."""
        view = self.df.head(n)
        if vertical:
            for i, row in view.iterrows():
                print(f"-RECORD {i}-")
                for c in view.columns:
                    print(f" {c}: {row[c]}")
        else:
            with pd.option_context("display.max_colwidth",
                                   20 if truncate else None):
                print(view.to_string(index=False))

    def count(self) -> int:
        return len(self.df)

    def to_pandas(self) -> pd.DataFrame:
        return self.df

    def to_arrow(self):
        """The frame as a pyarrow Table."""
        import pyarrow as pa

        return pa.Table.from_pandas(self.df, preserve_index=False)

    @classmethod
    def from_arrow(cls, table, ts_col: str = "event_ts",
                   partition_cols: Optional[Union[str, List[str]]] = None,
                   sequence_col: Optional[str] = None,
                   device: devices.DeviceLike = None,
                   dtype: Union[str, torch.dtype, None] = None) -> "TSDF":
        """A frame from a pyarrow Table (e.g. a Parquet read)."""
        return cls(table.to_pandas(), ts_col, partition_cols, sequence_col,
                   device=device, dtype=dtype)

    @classmethod
    def from_spark(cls, spark_df, ts_col: str = "event_ts",
                   partition_cols: Optional[Union[str, List[str]]] = None,
                   sequence_col: Optional[str] = None,
                   device: devices.DeviceLike = None,
                   dtype: Union[str, torch.dtype, None] = None) -> "TSDF":
        """A frame from a Spark DataFrame (collected with ``toPandas``):
        the hand-off from the original Spark library."""
        return cls(spark_df.toPandas(), ts_col, partition_cols, sequence_col,
                   device=device, dtype=dtype)

    def to_spark(self, spark=None):
        """The frame as a Spark DataFrame (through Arrow).  Needs pyspark;
        for Spark-readable files without a session use
        ``write(..., format="delta")``."""
        try:
            from pyspark.sql import SparkSession
        except ImportError as e:
            raise RuntimeError(
                "to_spark() needs pyspark installed; alternatively "
                "export files with write(..., format='delta') or "
                "to_arrow()") from e
        spark = spark or SparkSession.builder.getOrCreate()
        spark.conf.set("spark.sql.execution.arrow.pyspark.enabled", "true")
        return spark.createDataFrame(self.df)

    def write(self, tabName=None, optimizationCols=None, spark=None,
              base_dir=None, format: str = "parquet") -> str:
        """Clustered columnar persistence (parity: tsdf.py:761-762,
        io.py:10-43) through ``io/writer.py``; returns the table path.
        Also takes the original library's ``write(spark, tabName,
        optimizationCols)`` order.  ``format="delta"`` adds a Delta
        transaction log."""
        from tempo_tpu_torch.io import writer

        if not isinstance(tabName, str) and isinstance(optimizationCols,
                                                       str):
            # write(spark, tabName, optimizationCols) positional call
            tabName, optimizationCols = (
                optimizationCols, spark if isinstance(spark, list) else None)
        if not isinstance(tabName, str):
            raise TypeError("write() requires a table name")
        return writer.write(self, tabName, optimizationCols, base_dir,
                            format=format)

    def on_mesh(self, mesh=None, time_axis=None, series_axis: str = "series",
                halo_fraction: float = 0.5):
        """Distribute this frame over a device mesh
        (``parallel.make_mesh``): packs the columns once, cuts them over
        the mesh's series axis (and, with ``time_axis``, the time axis
        over that one: a ``[K/n_s, L/n_t]`` block a device) and returns a
        :class:`~tempo_tpu_torch.dist.DistributedTSDF` whose ops run on
        each shard's device and chain there until ``collect()``.  With no
        mesh, as the reference: one ``series`` axis over every visible
        card for a CUDA frame (``parallel.default_mesh``; on one card the
        device-residency path for chained ops), one shard for a CPU
        frame.  ``halo_fraction`` sizes the time axis's halo (a fraction
        of a block, for ``withRangeStats(strategy="halo")``)."""
        from tempo_tpu_torch import plan

        if plan.recording():
            from tempo_tpu_torch.plan import ir as plan_ir

            return self._plan_record("on_mesh", params=dict(
                time_axis=time_axis, series_axis=series_axis,
                halo_fraction=halo_fraction,
                mesh=plan_ir._mesh_state(mesh)), objs=dict(mesh=mesh))
        from tempo_tpu_torch.dist import DistributedTSDF

        return DistributedTSDF.from_tsdf(
            self, mesh, series_axis=series_axis, time_axis=time_axis,
            halo_fraction=halo_fraction)

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
        from tempo_tpu_torch import join, plan

        if plan.recording():
            return self._plan_record("asof_join", (right_tsdf,), dict(
                left_prefix=left_prefix, right_prefix=right_prefix,
                tsPartitionVal=tsPartitionVal, fraction=fraction,
                skipNulls=skipNulls, sql_join_opt=sql_join_opt,
                suppress_null_warning=suppress_null_warning,
                maxLookback=maxLookback))
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
        from tempo_tpu_torch import plan, rolling

        if plan.recording():
            return self._plan_record("range_stats", params=dict(
                type=type,
                colsToSummarize=tuple(colsToSummarize)
                if colsToSummarize else None,
                rangeBackWindowSecs=rangeBackWindowSecs))
        return rolling.with_range_stats(self, colsToSummarize,
                                        rangeBackWindowSecs)

    def EMA(self, colName: str, window: int = 30, exp_factor: float = 0.2,
            exact: bool = False, inclusive_window: bool = False) -> "TSDF":
        """Exponential moving average (parity: tsdf.py:615-635;
        ``exact=True`` is the untruncated recursive EMA;
        ``inclusive_window=True`` the Scala 0..window lag range)."""
        from tempo_tpu_torch import plan, rolling

        if plan.recording():
            return self._plan_record("ema", params=dict(
                colName=colName, window=window, exp_factor=exp_factor,
                exact=exact, inclusive_window=inclusive_window))
        return rolling.ema(self, colName, window, exp_factor, exact,
                           inclusive_window)

    def resample(self, freq: str, func=None, metricCols=None, prefix=None,
                 fill=None):
        """Downsample by a coarser frequency (parity: tsdf.py:764-776).
        Returns a ``_ResampledTSDF`` supporting chained ``.interpolate``."""
        from tempo_tpu_torch import plan
        from tempo_tpu_torch import resample as rs

        if plan.recording():
            return self._plan_record("resample", params=dict(
                freq=freq, func=func,
                metricCols=tuple(metricCols) if metricCols else None,
                prefix=prefix, fill=fill))
        return rs.resample(self, freq, func, metricCols, prefix, fill)

    def calc_bars(self, freq: str, func=None, metricCols=None,
                  fill=None) -> "TSDF":
        """OHLC bars (parity: tsdf.py:813-826)."""
        from tempo_tpu_torch import plan
        from tempo_tpu_torch import resample as rs

        with plan.suspended():
            # an eager-only op whose body chains recorded methods
            return rs.calc_bars(self, freq, func, metricCols, fill)

    def resampleEMA(self, freq: str, colName: str,
                    exp_factor: float = 0.2) -> "TSDF":
        """Fused floor-resample + exact EMA in one kernel pass: the
        single-read form of ``resample(freq, 'floor')`` followed by
        ``EMA(..., exact=True)`` (``resample.resample_ema``)."""
        from tempo_tpu_torch import plan
        from tempo_tpu_torch import resample as rs

        if plan.recording():
            return self._plan_record("resample_ema", params=dict(
                freq=freq, colName=colName, exp_factor=exp_factor))
        return rs.resample_ema(self, freq, colName, exp_factor)

    def interpolate(self, freq: str = None, func: str = None,
                    method: str = None, target_cols=None, ts_col: str = None,
                    partition_cols=None,
                    show_interpolated: bool = False) -> "TSDF":
        """Resample + fill missing values (parity: tsdf.py:778-811)."""
        from tempo_tpu_torch import interpol, plan

        if plan.recording():
            return self._plan_record("interpolate", params=dict(
                freq=freq, func=func, method=method,
                target_cols=tuple(target_cols) if target_cols else None,
                ts_col=ts_col,
                partition_cols=tuple(partition_cols) if partition_cols
                else None,
                show_interpolated=show_interpolated))
        return interpol.interpolate_frame(
            self, freq, func, method, target_cols, ts_col, partition_cols,
            show_interpolated)

    def withGroupedStats(self, metricCols=None, freq=None) -> "TSDF":
        """Tumbling-window grouped statistics (parity: tsdf.py:723-759)."""
        from tempo_tpu_torch import rolling

        return rolling.with_grouped_stats(self, metricCols, freq)

    def vwap(self, frequency: str = "m", volume_col: str = "volume",
             price_col: str = "price") -> "TSDF":
        """Volume-weighted average price (spec: scala TSDF.scala:378-401)."""
        from tempo_tpu_torch import rolling

        return rolling.vwap(self, frequency, volume_col, price_col)

    def withLookbackFeatures(self, featureCols, lookbackWindowSize: int,
                             exactSize: bool = True,
                             featureColName: str = "features"):
        """Trailing lookback feature lists (parity: tsdf.py:637-671)."""
        from tempo_tpu_torch import rolling

        return rolling.with_lookback_features(
            self, featureCols, lookbackWindowSize, exactSize, featureColName)

    def lookbackTensor(self, featureCols, lookbackWindowSize: int):
        """The dense [K, L, w, F] lookback tensor and its validity mask,
        on the frame's device."""
        from tempo_tpu_torch import rolling

        return rolling.lookback_tensor(self, featureCols, lookbackWindowSize)

    def fourier_transform(self, timestep: float, valueCol: str) -> "TSDF":
        """Frequency-domain representation per series (parity:
        tsdf.py:828-902): batched ``torch.fft`` on the frame's device."""
        from tempo_tpu_torch import spectral

        return spectral.fourier_transform(self, timestep, valueCol)

    def autocorr(self, col: str, lag: int = 1) -> pd.DataFrame:
        """Autocorrelation at a given lag per series (parity:
        tsdf.py:192-316; returns a bare DataFrame like the reference)."""
        from tempo_tpu_torch import spectral

        return spectral.autocorr(self, col, lag)

    def describe(self) -> pd.DataFrame:
        """Global + per-column summary table (parity: tsdf.py:384-431)."""
        from tempo_tpu_torch import describe as describe_mod

        return describe_mod.describe(self)

    # ------------------------------------------------------------------
    # Sequence-number constructor (parity: scala TSDF.scala:584-616)
    # ------------------------------------------------------------------

    @classmethod
    def fromOrderingColumns(
        cls,
        df: pd.DataFrame,
        ts_col: str,
        ordering_cols: Sequence[str],
        partition_cols: Optional[List[str]] = None,
        sequence_col_name: str = DEFAULT_SEQ_COLNAME,
        device: devices.DeviceLike = None,
        dtype: Union[str, torch.dtype, None] = None,
    ) -> "TSDF":
        """Synthesize a total-order sequence column from ordering columns
        by a per-key row_number, like the Scala sequence-number ctor."""
        pcols = partition_cols or []
        sort_cols = pcols + list(ordering_cols)
        order = df.sort_values(sort_cols, kind="stable").index
        seq = np.empty(len(df), dtype=np.int64)
        if pcols:
            grouped = df.loc[order].groupby(pcols, sort=False).cumcount() + 1
            seq[order] = grouped.to_numpy()
        else:
            seq[order] = np.arange(1, len(df) + 1)
        out = df.copy()
        out[sequence_col_name] = seq
        return cls(out, ts_col, pcols, sequence_col_name, device=device,
                   dtype=dtype)
