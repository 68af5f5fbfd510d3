"""Lazy frame wrappers: record ops as plan nodes, execute on demand.

Counterpart of ``tempo_tpu/plan/lazy.py``.

``TEMPO_TPU_PLAN=1`` makes the recorded op methods of TSDF /
DistributedTSDF return these wrappers instead of executing.  Recorded
ops extend the plan; terminal ops (``collect``, ``.df``,
``to_pandas``, ``count``, ``show``) optimize + execute through the
executable cache.  Any *other* attribute access materialises the chain
recorded so far and delegates to the eager result (logged at debug
level), so the full eager API keeps working under planning — ops
outside the IR simply act as plan boundaries.
"""

from __future__ import annotations

import logging
from typing import Optional

from tempo_tpu_torch.plan import ir

logger = logging.getLogger(__name__)


def _frame_strict(strict) -> bool:
    """The frame layer's strict-SQL resolution (explicit arg >
    TEMPO_TPU_SQL_STRICT > legacy TEMPO_TPU_STRICT_SQL)."""
    from tempo_tpu_torch.frame import _strict_sql

    return _strict_sql(strict)


def _as_node(frame) -> ir.Node:
    """Plan node for an op input: lazy wrappers contribute their
    recorded node; eager frames become fresh source nodes."""
    if isinstance(frame, _LazyBase):
        return frame._node
    from tempo_tpu_torch.dist import DistributedTSDF

    if isinstance(frame, DistributedTSDF):
        return ir.Node("dist_source", payload=frame)
    return ir.Node("source", payload=frame)


def record(frame, op: str, others=(), params=None, objs=None):
    """Entry point for the ``_plan_record`` preambles in frame.py /
    dist.py: build the op node over ``frame`` (+ any other frame
    operands) and wrap it."""
    node = ir.Node(op, params=params, objs=objs,
                   inputs=(_as_node(frame),)
                   + tuple(_as_node(o) for o in others))
    return wrap(node)


def wrap(node: ir.Node):
    """The lazy wrapper class a node's result belongs to: ``on_mesh``
    moves a chain onto the mesh; ops over a mesh chain stay there."""
    mesh_side = node.op == "on_mesh"
    cur = node
    while not mesh_side and cur.inputs:
        cur = cur.inputs[0]
        mesh_side = cur.op in ("on_mesh", "dist_source")
    return (LazyDistributedTSDF if mesh_side else LazyTSDF)(node)


class _LazyBase:
    """Shared recording/terminal machinery."""

    def __init__(self, node: ir.Node):
        self._node = node

    # -- plan access ----------------------------------------------------

    @property
    def plan(self) -> ir.Node:
        return self._node

    def explain(self, cost: bool = False) -> str:
        """Render (and return) the logical + optimized plans, per-node
        engine choices and barriers; ``cost=True`` adds what the card
        states of the plan's device segments (argument, output and
        captured-graph pool bytes)."""
        from tempo_tpu_torch.plan import render

        text = render.explain_text(self._node, cost=cost)
        print(text)
        return text

    # -- recording helpers ---------------------------------------------

    def _rec(self, op, others=(), params=None, objs=None):
        node = ir.Node(op, params=params, objs=objs,
                       inputs=(self._node,)
                       + tuple(_as_node(o) for o in others))
        return wrap(node)

    def _execute(self, terminal: Optional[str] = None):
        from tempo_tpu_torch.plan import executor

        node = self._node if terminal is None else \
            ir.Node(terminal, inputs=(self._node,))
        return executor.execute(node)

    def __getattr__(self, name):
        # not a recorded op: materialise the chain and delegate — the
        # plan boundary is explicit in the log
        if name.startswith("_"):
            raise AttributeError(name)
        logger.debug(
            "plan: %r is not a recorded op — materialising the lazy "
            "chain and continuing eagerly", name)
        from tempo_tpu_torch import plan as plan_mod

        result = self._execute()
        with plan_mod.suspended():
            return getattr(result, name)

    def __repr__(self):
        chain = " <- ".join(n.op for n in self._node.walk()
                            if not n.is_source())
        return f"{type(self).__name__}({chain or 'source'})"


class LazyTSDF(_LazyBase):
    """Deferred host-frame chain."""

    # -- recorded ops ---------------------------------------------------

    def select(self, *cols):
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        return self._rec("select", params=dict(cols=tuple(cols)))

    def withColumn(self, colName: str, values):
        # the value rides in objs for execution; its canonical form (an
        # opaque token for callables/arrays) keys the signature
        return self._rec("with_column",
                         params=dict(colName=colName, values=values),
                         objs=dict(values=values))

    def selectExpr(self, *exprs, strict: Optional[bool] = None):
        from tempo_tpu_torch import sql
        from tempo_tpu_torch.plan import sql_compile

        try:
            lowered, objs = sql_compile.lower_select_exprs(
                exprs, columns=ir.output_columns(self._node))
        except sql.SqlError as e:
            return self._sql_boundary("selectExpr", e, strict,
                                      lambda f: f.selectExpr(*exprs))
        lowered["strict"] = _frame_strict(strict)
        return self._rec("sql_project", params=lowered, objs=objs)

    def filter(self, condition, strict: Optional[bool] = None):
        if not isinstance(condition, str):
            # callable / mask filters are eager-only: plan boundary
            from tempo_tpu_torch import plan as plan_mod

            result = self._execute()
            with plan_mod.suspended():
                return result.filter(condition, strict=strict)
        from tempo_tpu_torch import sql
        from tempo_tpu_torch.plan import sql_compile

        try:
            lowered, objs = sql_compile.lower_filter(
                condition, columns=ir.output_columns(self._node))
        except sql.SqlError as e:
            return self._sql_boundary(
                "filter", e, strict,
                lambda f: f.filter(condition, strict=strict))
        lowered["strict"] = _frame_strict(strict)
        return self._rec("sql_filter", params=lowered, objs=objs)

    where = filter

    def _sql_boundary(self, what, err, strict, cont):
        """An expression outside the SQL grammar under planning: strict
        raises by name; otherwise the chain materialises here and the
        eager fallback engine continues (the logged plan boundary)."""
        from tempo_tpu_torch import plan as plan_mod
        from tempo_tpu_torch import sql

        if _frame_strict(strict):
            raise sql.StrictSqlFallback(
                f"{what} left the compiled SQL surface ({err}); strict "
                f"mode forbids the host-pandas fallback")
        logger.debug(
            "plan: %s is outside the SQL grammar (%s) — materialising "
            "the lazy chain and continuing eagerly", what, err)
        result = self._execute()
        with plan_mod.suspended():
            return cont(result)

    def asofJoin(self, right_tsdf, left_prefix=None, right_prefix="right",
                 tsPartitionVal=None, fraction=0.5, skipNulls=True,
                 sql_join_opt=False, suppress_null_warning=False,
                 maxLookback=0):
        return self._rec("asof_join", (right_tsdf,), params=dict(
            left_prefix=left_prefix, right_prefix=right_prefix,
            tsPartitionVal=tsPartitionVal, fraction=fraction,
            skipNulls=skipNulls, sql_join_opt=sql_join_opt,
            suppress_null_warning=suppress_null_warning,
            maxLookback=maxLookback))

    def withRangeStats(self, type: str = "range", colsToSummarize=None,
                       rangeBackWindowSecs: int = 1000):
        return self._rec("range_stats", params=dict(
            type=type,
            colsToSummarize=tuple(colsToSummarize) if colsToSummarize
            else None,
            rangeBackWindowSecs=rangeBackWindowSecs))

    def EMA(self, colName: str, window: int = 30, exp_factor: float = 0.2,
            exact: bool = False, inclusive_window: bool = False):
        return self._rec("ema", params=dict(
            colName=colName, window=window, exp_factor=exp_factor,
            exact=exact, inclusive_window=inclusive_window))

    def resample(self, freq: str, func=None, metricCols=None, prefix=None,
                 fill=None):
        return self._rec("resample", params=dict(
            freq=freq, func=func,
            metricCols=tuple(metricCols) if metricCols else None,
            prefix=prefix, fill=fill))

    def resampleEMA(self, freq: str, colName: str,
                    exp_factor: float = 0.2):
        return self._rec("resample_ema", params=dict(
            freq=freq, colName=colName, exp_factor=exp_factor))

    def interpolate(self, *args, **kw):
        if self._node.op == "resample":
            # chained _ResampledTSDF signature: (method, target_cols,
            # show_interpolated)
            names = ("method", "target_cols", "show_interpolated")
            p = dict(zip(names, args))
            p.update(kw)
            p.setdefault("target_cols", None)
            p.setdefault("show_interpolated", False)
            if p.get("target_cols"):
                p["target_cols"] = tuple(p["target_cols"])
            return self._rec("interpolate_resampled", params=p)
        names = ("freq", "func", "method", "target_cols", "ts_col",
                 "partition_cols", "show_interpolated")
        p = dict(zip(names, args))
        p.update(kw)
        for n in names:
            p.setdefault(n, False if n == "show_interpolated" else None)
        for key in ("target_cols", "partition_cols"):
            if p.get(key):
                p[key] = tuple(p[key])
        return self._rec("interpolate", params=p)

    def on_mesh(self, mesh=None, time_axis=None, series_axis="series",
                halo_fraction: float = 0.5):
        return self._rec("on_mesh", params=dict(
            time_axis=time_axis, series_axis=series_axis,
            halo_fraction=halo_fraction,
            mesh=ir._mesh_state(mesh)), objs=dict(mesh=mesh))

    # -- terminals ------------------------------------------------------

    @property
    def df(self):
        return self._execute().df

    def to_pandas(self):
        return self._execute().df

    def count(self) -> int:
        return int(self._execute("count"))

    def show(self, n: int = 20, truncate: bool = True,
             vertical: bool = False):
        return self._execute().show(n, truncate, vertical)


class LazyDistributedTSDF(_LazyBase):
    """Deferred mesh chain; ``collect()`` is the explicit
    materialisation barrier that optimizes + executes."""

    def asofJoin(self, right, left_prefix=None, right_prefix="right",
                 tsPartitionVal=None, fraction=0.5, skipNulls=True,
                 sql_join_opt=False, suppress_null_warning=False,
                 maxLookback=0):
        return self._rec("asof_join", (right,), params=dict(
            left_prefix=left_prefix, right_prefix=right_prefix,
            tsPartitionVal=tsPartitionVal, fraction=fraction,
            skipNulls=skipNulls, sql_join_opt=sql_join_opt,
            suppress_null_warning=suppress_null_warning,
            maxLookback=maxLookback))

    def withRangeStats(self, colsToSummarize=None,
                       rangeBackWindowSecs: int = 1000,
                       strategy: str = "exact"):
        return self._rec("range_stats", params=dict(
            colsToSummarize=tuple(colsToSummarize) if colsToSummarize
            else None,
            rangeBackWindowSecs=rangeBackWindowSecs, strategy=strategy))

    rangeStats = withRangeStats

    def EMA(self, colName: str, window: int = 30, exp_factor: float = 0.2,
            exact: bool = False, inclusive_window: bool = False):
        return self._rec("ema", params=dict(
            colName=colName, window=window, exp_factor=exp_factor,
            exact=exact, inclusive_window=inclusive_window))

    def resample(self, freq: str, func: str, metricCols=None):
        return self._rec("resample", params=dict(
            freq=freq, func=func,
            metricCols=tuple(metricCols) if metricCols else None))

    def interpolate(self, freq=None, func=None, method=None,
                    target_cols=None, show_interpolated=False):
        return self._rec("interpolate", params=dict(
            freq=freq, func=func, method=method,
            target_cols=tuple(target_cols) if target_cols else None,
            show_interpolated=show_interpolated))

    def calc_bars(self, freq: str, func=None, metricCols=None,
                  fill=None):
        return self._rec("calc_bars", params=dict(
            freq=freq, func=func,
            metricCols=tuple(metricCols) if metricCols else None,
            fill=fill))

    def fourier_transform(self, timestep: float, valueCol: str):
        return self._rec("fourier", params=dict(
            timestep=timestep, valueCol=valueCol))

    def withLookbackFeatures(self, featureCols, lookbackWindowSize: int,
                             exactSize: bool = True,
                             featureColName: str = "features"):
        # host-materialisation barrier (collect_list semantics) — the
        # optimizer marks it; execution collects like the eager path
        return self._rec("lookback_features", params=dict(
            featureCols=tuple(featureCols),
            lookbackWindowSize=lookbackWindowSize, exactSize=exactSize,
            featureColName=featureColName))

    # -- terminals ------------------------------------------------------

    def collect(self):
        return self._execute("collect")

    def to_pandas(self):
        return self._execute("collect").df

    def count(self) -> int:
        return int(self._execute("count"))

    def show(self, n: int = 20, truncate: bool = True):
        return self._execute("collect").show(n, truncate)
