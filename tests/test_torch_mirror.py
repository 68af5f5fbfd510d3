"""The DataFrame-mirror ops, the SQL surface (``selectExpr`` and
``filter`` through the port's copy of the host expression engine),
the column classes and ``fromOrderingColumns``: the port
(``device="cpu"``) against ``tempo_tpu.TSDF`` on the same pandas
inputs.  These are host ops: results are equal, column roles included,
and every derived frame keeps the port frame's device and dtype.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
from tempo_tpu import sql as ref_sql
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch import sql

T = 1_000_000_000


def _df(seed=0):
    rng = np.random.default_rng(seed)
    n = 40
    return pd.DataFrame({
        "symbol": rng.choice(["AAPL", "MSFT", "IBM"], n),
        "event_ts": pd.to_datetime(
            (1_600_000_000 + rng.integers(0, 5000, n)) * T),
        "seq": rng.integers(0, 5, n),
        "price": np.where(rng.random(n) > 0.2,
                          np.round(100 + 10 * rng.random(n), 2), np.nan),
        "qty": rng.integers(1, 100, n),
        "venue": np.where(rng.random(n) > 0.3,
                          rng.choice(["NYSE", "ARCA", "nasdaq"], n), None),
    })


def _both(df, seq="seq"):
    return (tempo_tpu.TSDF(df, "event_ts", ["symbol"], sequence_col=seq),
            PortTSDF(df, "event_ts", ["symbol"], sequence_col=seq,
                     device="cpu", dtype=torch.float32))


def _same(got, want):
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert (got.ts_col, got.partitionCols, got.sequence_col) == \
        (want.ts_col, want.partitionCols, want.sequence_col)
    pd.testing.assert_frame_equal(got.df, want.df)


@pytest.mark.parametrize("name,call", [
    ("select", lambda t: t.select("event_ts", "symbol", "seq", "price")),
    ("select_list", lambda t: t.select(["symbol", "event_ts", "seq"])),
    ("select_star", lambda t: t.select("*")),
    ("limit", lambda t: t.limit(7)),
    ("union", lambda t: t.union(t.limit(3))),
    ("unionAll", lambda t: t.unionAll(t)),
    ("withColumn_value", lambda t: t.withColumn("one", 1)),
    ("withColumn_callable",
     lambda t: t.withColumn("notional", lambda d: d["price"] * d["qty"])),
    ("withColumnRenamed_ts", lambda t: t.withColumnRenamed("event_ts", "ts")),
    ("withColumnRenamed_part",
     lambda t: t.withColumnRenamed("symbol", "sym")),
    ("withColumnRenamed_seq", lambda t: t.withColumnRenamed("seq", "s")),
    ("drop", lambda t: t.drop("venue", "qty")),
    ("withPartitionCols", lambda t: t.withPartitionCols(["venue"])),
    ("partitionedBy", lambda t: t.partitionedBy("venue")),
    ("filter_callable", lambda t: t.filter(lambda d: d["qty"] > 50)),
    ("filter_mask", lambda t: t.filter(t.df["qty"] % 2 == 0)),
    ("where", lambda t: t.where("qty < 30")),
])
def test_mirror_ops_match_reference(name, call):
    ref, port = _both(_df(1))
    _same(call(port), call(ref))


def test_range_stats_spelling_matches_reference():
    """The Scala spelling ``rangeStats``: float64 against the reference
    within 1e-9 (the engines sum in their own orders), and a float32
    frame's stats in float32."""
    ref, port = _both(_df(1))
    want = ref.rangeStats(["price"], 600).df
    port64 = PortTSDF(_df(1), "event_ts", ["symbol"], sequence_col="seq",
                      device="cpu")
    got = port64.rangeStats(["price"], 600).df
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["count_price"], want["count_price"])
    for c in ("mean_price", "sum_price", "stddev_price", "zscore_price"):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-9, atol=1e-9,
                                   equal_nan=True, err_msg=c)
    small = port.rangeStats(["price"], 600)
    assert small.dtype == torch.float32
    np.testing.assert_allclose(small.df["mean_price"], want["mean_price"],
                               rtol=1e-6, equal_nan=True)


def test_select_without_structural_columns_raises():
    _, port = _both(_df())
    with pytest.raises(Exception, match="must be present"):
        port.select("price", "qty")


def test_column_classes_and_accessors_match_reference():
    ref, port = _both(_df(2))
    for attr in ("columns", "structuralColumns", "observationColumns",
                 "measureColumns"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.sorted_flat("price"),
                                  ref.sorted_flat("price"))
    assert port.count() == ref.count() == 40
    assert port.to_pandas() is port.df


@pytest.mark.parametrize("kw", [{}, dict(truncate=False),
                                dict(n=3, vertical=True)])
def test_show_prints_like_reference(capsys, kw):
    ref, port = _both(_df(3))
    ref.show(**kw)
    want = capsys.readouterr().out
    port.show(**kw)
    assert capsys.readouterr().out == want and want


@pytest.mark.parametrize("pcols", [["symbol"], None])
def test_from_ordering_columns_matches_reference(pcols):
    df = _df(4).drop(columns=["seq"])
    want = tempo_tpu.TSDF.fromOrderingColumns(df, "event_ts",
                                              ["event_ts", "qty"], pcols)
    got = PortTSDF.fromOrderingColumns(df, "event_ts", ["event_ts", "qty"],
                                       pcols, device="cpu",
                                       dtype="float32")
    _same(got, want)


PREDICATES = [
    "price > 105",
    "qty BETWEEN 10 AND 40 AND price IS NOT NULL",
    "venue IN ('NYSE', 'ARCA')",
    "venue NOT IN ('NYSE')",            # NULL venue rows drop
    "venue IS NULL OR qty = 7",
    "NOT (price < 103)",                # NULL price rows drop
    "lower(venue) LIKE 'nas%'",
    "symbol = 'AAPL' AND (qty % 3 = 0 OR price >= 108.5)",
    "CASE WHEN price IS NULL THEN qty > 50 ELSE price > 104 END",
    "coalesce(price, 0) < 101",
]

PROJECTIONS = [
    ("price * qty AS notional", "qty + 1", "upper(symbol) AS sym"),
    ("CAST(qty AS double) / 4 AS quarter",
     "CASE WHEN venue IS NULL THEN 'none' ELSE venue END AS v"),
    ("round(price, 1) AS p1", "abs(qty - 50) AS dist",
     "concat(symbol, '-', venue) AS tag"),
]


@pytest.mark.parametrize("predicate", PREDICATES)
def test_sql_filter_matches_reference(predicate):
    ref, port = _both(_df(5))
    got, want = port.filter(predicate), ref.filter(predicate)
    _same(got, want)
    assert 0 < got.count() < port.count()


@pytest.mark.parametrize("exprs", PROJECTIONS)
def test_sql_select_expr_matches_reference(exprs):
    ref, port = _both(_df(6))
    exprs = ("event_ts", "symbol", "seq") + exprs
    _same(port.selectExpr(*exprs), ref.selectExpr(*exprs))


def test_sql_fallback_logs_and_strict_raises(monkeypatch, caplog):
    """Outside the SQL grammar both frames fall back to pandas
    (``eval``/``query``) with a warning; ``strict=True`` or the knobs
    raise ``StrictSqlFallback`` instead."""
    ref, port = _both(_df(7))
    exprs = ("event_ts", "symbol", "seq", "price ** 2 as p2")
    with caplog.at_level(logging.WARNING):
        got = port.selectExpr(*exprs)
    assert "falling back to pandas eval" in caplog.text
    _same(got, ref.selectExpr(*exprs))
    with caplog.at_level(logging.WARNING):
        _same(port.filter("qty ** 2 > 100"),
              ref.filter("qty ** 2 > 100"))
    assert "falling back to pandas query" in caplog.text
    assert issubclass(sql.StrictSqlFallback, sql.SqlError)
    with pytest.raises(sql.StrictSqlFallback, match="strict mode"):
        port.selectExpr(*exprs, strict=True)
    with pytest.raises(sql.StrictSqlFallback, match="strict mode"):
        port.filter("qty ** 2 > 100", strict=True)
    for knob in ("TEMPO_TPU_SQL_STRICT", "TEMPO_TPU_STRICT_SQL"):
        monkeypatch.setenv(knob, "1")
        with pytest.raises(sql.StrictSqlFallback):
            port.filter("qty ** 2 > 100")
        port.filter("qty ** 2 > 100", strict=False)
        monkeypatch.delenv(knob)


def test_sql_engine_is_a_copy_of_the_reference():
    """The port keeps its own copy of the host evaluator: same public
    surface, same results on an expression of every kind above."""
    assert sql.__all__ == ref_sql.__all__
    df = _df(8)
    for text in PREDICATES + ["price * qty", "upper(venue)"]:
        pd.testing.assert_series_equal(sql.eval_expr(df, text),
                                       ref_sql.eval_expr(df, text))
