"""The port's SQL lowering (``tempo_tpu_torch/plan/sql_compile.py``)
against the reference's (``tempo_tpu/plan/sql_compile.py``).

* The canonical ASTs (the ``sql_filter`` / ``sql_project`` params that
  key the plan signature) and the backend annotations (``jit-plane``
  for the plane subset, ``host-vector`` for the rest) are the
  reference's, for every predicate and projection of the reference's
  matrix (``tests/test_sql_compile.py``).
* Planned ``filter`` / ``selectExpr`` are bitwise the port's eager ones
  and the host pandas oracle's (selections are exact); statements
  (``compile_statement``) record the reference's plan (the same
  signature) and run bitwise their method-chain twins.
* Strict mode never fires on the compiled surface and raises by name
  off it.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu import sql as ref_sql
from tempo_tpu.plan import ir as ref_ir
from tempo_tpu.plan import sql_compile as ref_sc
from tempo_tpu_torch import TSDF, plan, sql
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import ir, lazy, optimizer, sql_compile

N = 60


def _df(seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "ts": pd.date_range("2024-01-01", periods=N, freq="1s"),
        "sym": ["A", "B", "C"] * (N // 3),
        "price": rng.normal(100.0, 5.0, N),
        "vol": rng.integers(1, 100, N).astype("int64"),
        "extra": rng.standard_normal(N),
    })
    if nulls:
        df.loc[::7, "price"] = np.nan
    return df


def _quotes(seed=1, rows=18):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.date_range("2024-01-01", periods=rows, freq="3s"),
        "sym": ["A", "B", "C"] * (rows // 3),
        "bid": rng.normal(99.0, 5.0, rows)})


def make_frame(seed=0, nulls=True):
    return TSDF(_df(seed, nulls), ts_col="ts", partition_cols=["sym"],
                device="cpu")


@pytest.fixture
def plan_on(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    plan_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()


@pytest.fixture
def plan_off(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_PLAN", raising=False)


def exact(a: pd.DataFrame, b: pd.DataFrame):
    pd.testing.assert_frame_equal(a.reset_index(drop=True),
                                  b.reset_index(drop=True), check_exact=True)


PREDICATES = [
    ("price > 100", "jit-plane"),
    ("price > 100 AND vol < 50", "jit-plane"),
    ("price IS NULL OR vol >= 90", "jit-plane"),
    ("NOT (price > 100 OR vol < 20)", "jit-plane"),
    ("price BETWEEN 95 AND 105", "jit-plane"),
    ("vol IN (1, 2, 3, 40, 41)", "jit-plane"),
    ("price + vol > 150", "jit-plane"),
    ("price * 2 - vol / 4 >= 180", "jit-plane"),
    ("price IS NOT NULL AND price <= 98", "jit-plane"),
    ("price <=> NULL", "jit-plane"),
    ("ts > '2024-01-01 00:00:10'", "jit-plane"),
    ("ts BETWEEN '2024-01-01 00:00:05' AND '2024-01-01 00:00:30'",
     "jit-plane"),
    ("sym = 'A'", "host-vector"),
    ("sym LIKE 'A%' AND price > 90", "host-vector"),
    ("CASE WHEN price > 100 THEN TRUE ELSE FALSE END", "host-vector"),
    ("vol % 2 = 0", "host-vector"),
]


@pytest.mark.parametrize("pred,backend", PREDICATES,
                         ids=[p for p, _ in PREDICATES])
def test_filter_parity_ast_and_backend(plan_on, pred, backend):
    t = make_frame()
    lz = t.filter(pred)
    assert isinstance(lz, lazy.LazyTSDF)
    planned = lz.df
    with plan.suspended():
        eager = t.filter(pred).df
        mask = sql.filter_mask(t.df, pred)
    exact(planned, eager)
    exact(planned, t.df[mask])
    cols = list(t.df.columns)
    got, _ = sql_compile.lower_filter(pred, columns=cols)
    want, _ = ref_sc.lower_filter(pred, columns=cols)
    assert got == want                       # the canonical AST and refs
    dtypes = {c: t.df[c].dtype for c in cols}
    ast = sql_compile._resolve(sql.parse(pred), cols)
    assert sql_compile.filter_backend(ast, dtypes) == backend == \
        ref_sc.filter_backend(ref_sc._resolve(ref_sql.parse(pred), cols),
                              dtypes)


def test_filter_backend_annotated_in_explain(plan_on):
    t = make_frame()
    assert "eval[sql]=jit-plane" in t.filter("price > 100").explain()
    assert "eval[sql]=host-vector" in t.filter("sym = 'A'").explain()


def test_plane_backend_takes_only_numpy_promoting_dtypes():
    """float32 / int32 columns evaluate on the host-vector path: their
    promotions against float64 literals differ between torch and
    numpy."""
    df = pd.DataFrame({"a": np.arange(4, dtype=np.float32),
                       "b": np.arange(4, dtype=np.int32)})
    for pred in ("a > 1.5", "b > 1"):
        ast = sql.parse(pred)
        assert sql_compile.filter_backend(
            ast, {c: df[c].dtype for c in df}) == "host-vector"
        assert sql_compile._plane_mask(ast, df) is None


PROJECTIONS = [
    ("ts", "sym", "price * 2 as p2"),
    ("ts", "sym", "price + vol as pv", "price - vol as mv"),
    ("ts", "sym", "vol / 4 as q", "price as p"),
    ("ts", "sym", "CASE WHEN price > 100 THEN 1 ELSE 0 END as hi"),
    ("ts", "sym", "coalesce(price, 0) as p0"),
    ("ts", "sym", "abs(price - 100) as dev", "round(price, 1) as r1"),
]


@pytest.mark.parametrize("exprs", PROJECTIONS,
                         ids=[" | ".join(e[2:]) for e in PROJECTIONS])
def test_selectexpr_parity_and_ast(plan_on, exprs):
    t = make_frame()
    lz = t.selectExpr(*exprs)
    assert isinstance(lz, lazy.LazyTSDF)
    planned = lz.df
    with plan.suspended():
        eager = t.selectExpr(*exprs).df
    exact(planned, eager)
    cols = list(t.df.columns)
    assert sql_compile.lower_select_exprs(exprs, cols)[0] == \
        ref_sc.lower_select_exprs(exprs, cols)[0]


def test_three_valued_null_chain_matches_oracle(plan_on):
    t = make_frame()
    null_rows = t.df["price"].isna()
    assert len(t.filter("price > 1e9 OR vol >= 0").df) == len(t.df)
    assert len(t.filter("price < 1e9 AND vol >= 0").df) == \
        int((~null_rows).sum())


def test_adjacent_filters_and_fuse(plan_on):
    t = make_frame()
    lz = t.filter("price > 95").filter("vol < 80")
    (f,) = [n for n in optimizer.optimize(lz.plan).walk()
            if n.op == "sql_filter"]
    rt = tempo_tpu.TSDF(_df(), ts_col="ts", partition_cols=["sym"])
    from tempo_tpu.plan import optimizer as ref_opt

    (rf,) = [n for n in ref_opt.optimize(
        rt.filter("price > 95").filter("vol < 80").plan).walk()
        if n.op == "sql_filter"]
    assert f.params == rf.params and "AND" in f.param("condition")
    with plan.suspended():
        eager = t.filter("price > 95").filter("vol < 80").df
    exact(lz.df, eager)


def test_dead_column_pruning_through_sql_ops(plan_on):
    t = make_frame()
    opt = optimizer.optimize(
        t.filter("price > 95").select("ts", "sym", "price").plan)
    src = [n for n in opt.walk() if n.op == "source"][0]
    assert {"extra", "vol"} <= set(src.ann.get("pruned") or ())


def test_sql_plans_are_cacheable_and_typed(plan_on):
    t = make_frame()
    lz = t.filter("price > 100")
    assert not lz.plan.uncacheable() and ir.state_key(lz.plan) is not None
    lz.df
    st0 = plan_cache.CACHE.stats()
    t.filter("price > 100").df
    st1 = plan_cache.CACHE.stats()
    assert (st1["hits"], st1["misses"]) == (st0["hits"] + 1, st0["misses"])
    assert ir.signature(t.filter("vol > 2").plan) != \
        ir.signature(t.filter("vol > 2.0").plan)


# ----------------------------------------------------------------------
# Statements
# ----------------------------------------------------------------------

STATEMENTS = {
    "where": ("SELECT * FROM trades WHERE price > 100 AND vol < 80",
              lambda t, q: t.filter("price > 100 AND vol < 80")),
    "projection": ("SELECT price * 2 AS p2 FROM trades",
                   lambda t, q: t.selectExpr("ts", "sym",
                                             "price * 2 as p2")),
    "group_by": ("SELECT mean(price) FROM trades "
                 "GROUP BY time_bucket('10 seconds')",
                 lambda t, q: t.resample(freq="10 seconds", func="mean",
                                         metricCols=["price"])),
    "asof_join": ("SELECT * FROM trades ASOF JOIN quotes PREFIX 'q'",
                  lambda t, q: t.asofJoin(q, right_prefix="q")),
    "asof_join_where": ("SELECT * FROM trades ASOF JOIN quotes PREFIX 'q' "
                        "WHERE q_bid > 95",
                        lambda t, q: t.asofJoin(q, right_prefix="q")
                        .filter("q_bid > 95")),
}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_method_chain_and_reference_plan(plan_off, name):
    text, chain = STATEMENTS[name]
    t = make_frame()
    q = TSDF(_quotes(), ts_col="ts", partition_cols=["sym"], device="cpu")
    got = sql_compile.run_statement(text, {"trades": t, "quotes": q})
    exact(got.df, chain(t, q).df)
    rt = tempo_tpu.TSDF(_df(), ts_col="ts", partition_cols=["sym"])
    rq = tempo_tpu.TSDF(_quotes(), ts_col="ts", partition_cols=["sym"])
    port_root = sql_compile.compile_statement(text, {"trades": t,
                                                     "quotes": q})
    ref_root = ref_sc.compile_statement(text, {"trades": rt, "quotes": rq})
    assert port_root.param("_origin") == "sql"
    assert ir.signature(port_root) == ref_ir.signature(ref_root)


def test_statement_group_by_alias_renames(plan_off):
    t = make_frame()
    got = sql_compile.run_statement(
        "SELECT max(price) AS px FROM trades "
        "GROUP BY time_bucket('10 seconds')", {"trades": t})
    want = t.resample(freq="10 seconds", func="max", metricCols=["price"]).df
    np.testing.assert_array_equal(got.df["px"].to_numpy(),
                                  want["price"].to_numpy())


def test_statement_errors_are_named(plan_off):
    t = make_frame()
    with pytest.raises(sql.SqlError, match="unknown table"):
        sql_compile.run_statement("SELECT * FROM nope", {"trades": t})
    with pytest.raises(sql.SqlError, match="GROUP BY"):
        sql_compile.run_statement("SELECT mean(price) FROM trades",
                                  {"trades": t})
    with pytest.raises(sql.SqlError, match="trailing"):
        sql_compile.run_statement("SELECT * FROM trades LIMIT 5",
                                  {"trades": t})


def test_sql_origin_distinct_signature(plan_on):
    t = make_frame()
    root = sql_compile.compile_statement(
        "SELECT * FROM trades WHERE price > 100", {"trades": t})
    assert ir.signature(root) != ir.signature(t.filter("price > 100").plan)


# ----------------------------------------------------------------------
# Strict mode
# ----------------------------------------------------------------------

def test_strict_never_fires_on_supported_surface(plan_on, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_SQL_STRICT", "1")
    t = make_frame()
    for pred, _ in PREDICATES:
        t.filter(pred).df
    for exprs in PROJECTIONS:
        t.selectExpr(*exprs).df
    assert len(sql_compile.run_statement(
        "SELECT * FROM trades WHERE price > 100", {"trades": t}).df)


@pytest.mark.parametrize("planning", ["1", "0"])
def test_strict_kwarg_raises_by_name(monkeypatch, planning):
    monkeypatch.setenv("TEMPO_TPU_PLAN", planning)
    t = make_frame()
    with pytest.raises(sql.StrictSqlFallback):
        t.filter("1 < price < 3", strict=True)
    with pytest.raises(sql.StrictSqlFallback):
        t.selectExpr("price ** 2 as p2", strict=True)


def test_strict_env_knob_and_priority(plan_on, monkeypatch):
    t = make_frame()
    monkeypatch.setenv("TEMPO_TPU_SQL_STRICT", "1")
    with pytest.raises(sql.StrictSqlFallback):
        t.filter("1 < vol < 30")
    assert len(t.filter("1 < vol < 30", strict=False).df)
    monkeypatch.delenv("TEMPO_TPU_SQL_STRICT")
    monkeypatch.setenv("TEMPO_TPU_STRICT_SQL", "1")
    with pytest.raises(sql.SqlError):
        t.filter("1 < vol < 30")


def test_non_strict_fallback_still_works_under_planning(plan_on):
    t = make_frame()
    got = t.filter("vol > 10").filter("1 < vol < 30").df
    with plan.suspended():
        want = t.filter("vol > 10").filter("1 < vol < 30").df
    exact(got, want)
