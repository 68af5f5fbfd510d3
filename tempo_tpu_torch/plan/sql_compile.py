"""Compile the SQL surface into plan IR.

Counterpart of ``tempo_tpu/plan/sql_compile.py``.

* :func:`lower_select_exprs` / :func:`lower_filter` turn the parsed
  ``tempo_tpu_torch.sql`` expression ASTs into the node parts of the
  ``sql_project`` / ``sql_filter`` IR ops.  Column references resolve at
  compile time through :func:`sql.resolve_column`, the ladder host
  evaluation uses, so pruning and execution agree on which column an
  expression reads.  The canonical AST (``Expr.canon()``) rides in the
  node params: it is the plan signature, so two spellings of the same
  query share one cached executable while ``x + 2`` and ``x + 2.0``
  never do.
* :func:`compile_statement` parses a full ``SELECT`` statement
  (projections, ``ASOF JOIN``, ``WHERE``, ``GROUP BY time_bucket``) and
  lowers it onto the same planned ops method chains record, plus
  ``sql_project`` / ``sql_filter``.  The plan root carries
  ``_origin='sql'`` so SQL-born plans get signatures of their own.
* Predicates evaluate on the *plane* backend where they can
  (:func:`plane_program`): numeric and timestamp predicates over
  (values, validity) tensor planes with SQL three-valued logic in the
  validity lane (the reference's ``jit-plane`` backend, a jitted XLA
  program there, torch tensor code here; the annotation keeps the
  reference's name).  The plane backend takes int64, float64, bool and
  timestamp columns, whose promotions torch and numpy share; anything
  else (strings, CASE, casts, other widths, nullable
  extension dtypes) evaluates through the shared vectorized AST
  (``host-vector``).  Both give the host oracle's row set bitwise.

The host pandas engine stays the oracle and the fallback for the
unsupported tail (pandas eval/query syntax); strict mode (``strict=True``
/ ``TEMPO_TPU_SQL_STRICT=1``) turns that tail into a named
:class:`sql.StrictSqlFallback` error.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import sql
from tempo_tpu_torch.plan import ir

logger = logging.getLogger(__name__)

__all__ = ["lower_select_exprs", "lower_filter", "compile_statement",
           "run_statement", "run_project", "run_filter",
           "filter_backend"]


# ----------------------------------------------------------------------
# Expression lowering: selectExpr / filter -> sql_project / sql_filter
# ----------------------------------------------------------------------

def _resolve(ast: sql.Expr, columns) -> sql.Expr:
    """Compile-time column resolution through the shared ladder; names
    with no match stay as written (evaluation raises the same 'column
    not found' the eager path would)."""
    if columns is None:
        return ast
    return sql.map_columns(
        ast, lambda n: sql.resolve_column(n, list(columns)) or n)


def lower_select_exprs(exprs, columns=None) -> Tuple[Dict, Dict]:
    """Parse + lower ``selectExpr`` strings; returns the ``(params,
    objs)`` of a ``sql_project`` node.  Raises :class:`sql.SqlError`
    when any expression is outside the SQL grammar (the caller decides
    fallback vs strict)."""
    raws, aliases, canons, projs = [], [], [], []
    refs = set()
    for raw in exprs:
        alias, body = sql.split_projection(raw)
        ast = _resolve(sql.parse(body), columns)
        raws.append(raw)
        aliases.append(alias)
        canons.append(ast.canon())
        projs.append((alias, ast))
        refs |= sql.column_refs(ast)
    params = dict(exprs=tuple(raws), aliases=tuple(aliases),
                  asts=tuple(canons), cols=tuple(sorted(refs)))
    return params, dict(projs=tuple(projs))


def lower_filter(condition: str, columns=None) -> Tuple[Dict, Dict]:
    """Parse + lower a string predicate; returns the ``(params, objs)``
    of a ``sql_filter`` node.  Raises :class:`sql.SqlError` for
    non-SQL predicates (pandas ``query`` syntax)."""
    ast = _resolve(sql.parse(condition), columns)
    params = dict(condition=condition, ast=ast.canon(),
                  cols=tuple(sorted(sql.column_refs(ast))))
    return params, dict(ast=ast)


# ----------------------------------------------------------------------
# Execution: the two sql ops' evaluators (called by plan/executor.py)
# ----------------------------------------------------------------------

def run_project(frame, node: ir.Node):
    """Evaluate a ``sql_project`` node over a host TSDF — the pre-parsed
    Exprs evaluate through the SAME ``Expr.__call__`` bodies as
    ``sql.select_exprs``, so planned output is bitwise the eager
    output with zero re-parsing per run."""
    df = frame.df
    env = {c: df[c] for c in df.columns}
    out = {}
    for alias, ast in node.objs["projs"]:
        val = ast(env)
        if isinstance(val, pd.Series):
            val = val.reset_index(drop=True)
            val.index = df.index
        else:
            val = pd.Series([val] * len(df), index=df.index)
        out[alias] = val
    return frame._with_rows(pd.DataFrame(out, index=df.index))


def run_filter(frame, node: ir.Node):
    """Evaluate a ``sql_filter`` node over a host TSDF: the plane
    backend when the predicate compiles to it, else the shared
    vectorized AST; both produce the exact ``filter_mask`` row set
    (TRUE rows only)."""
    df = frame.df
    ast = node.objs["ast"]
    mask = _plane_mask(ast, df)
    if mask is not None:
        node.ann["sql_eval"] = "jit-plane"
    else:
        node.ann["sql_eval"] = "host-vector"
        v = sql.evaluate(ast, df)
        if not isinstance(v, pd.Series):
            v = pd.Series([v] * len(df), index=df.index)
        mask = v.astype("boolean").fillna(False).astype(bool)
    return frame._with_rows(df[mask])


# ----------------------------------------------------------------------
# The plane backend: numeric/timestamp predicates as tensor code over
# (values, validity) planes
# ----------------------------------------------------------------------
#
# SQL three-valued logic is encoded in a validity lane: every
# sub-expression evaluates to (value, valid) with the invariant that
# boolean values are False wherever invalid (canonical NULL), which
# makes Kleene AND/OR plain bitwise ops plus a validity formula.  The
# final mask is value & valid — exactly filter_mask's "TRUE rows only".

class _Unsupported(Exception):
    pass


_AGG_FUNCS = {"mean": "mean", "avg": "mean", "min": "min", "max": "max",
              "first": "floor", "last": "ceil"}

_PLANE_CACHE: Dict[tuple, tuple] = {}


#: column dtypes the plane backend takes: those whose promotions with
#: int64 / float64 literals torch and numpy share (and timestamps of any
#: unit, compared as int64 ns)
_PLANE_DTYPES = (np.dtype("int64"), np.dtype("float64"), np.dtype("bool"))


def _col_kinds(ast: sql.Expr, dtypes) -> Dict[str, str]:
    """dtype-kind map for the predicate's column refs; raises
    _Unsupported for extension dtypes and dtypes outside
    :data:`_PLANE_DTYPES`."""
    kinds = {}
    for name in sql.column_refs(ast):
        if name not in dtypes:
            raise _Unsupported(name)
        dt = dtypes[name]
        if not isinstance(dt, np.dtype) or (
                dt not in _PLANE_DTYPES and dt.kind != "M"):
            raise _Unsupported(str(dt))
        kinds[name] = dt.kind
    return kinds


def _t(v) -> torch.Tensor:
    """A plane or a literal as a tensor (literals as 0-d int64 /
    float64 / bool tensors, so promotion follows numpy's)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _emit(e: sql.Expr, kinds: Dict[str, str]):
    """Build one plane evaluator: returns (tag, fn) where tag is
    'num:<kind>' / 'bool' / 'null' and fn(cols) -> (value, valid)
    tensors (or scalars for literals)."""
    if isinstance(e, sql.Col):
        k = kinds[e.name]
        name = e.name
        if k == "b":
            return "bool", lambda cols: cols[name]
        tag = "num:M" if k == "M" else ("num:f" if k == "f" else "num:i")
        return tag, lambda cols: cols[name]
    if isinstance(e, sql.Lit):
        v = e.value
        if v is None:
            return "null", lambda cols: (0.0, False)
        if isinstance(v, bool):
            return "bool", lambda cols: (v, True)
        if isinstance(v, int):
            return "num:i", lambda cols: (np.int64(v), True)
        if isinstance(v, float):
            return "num:f", lambda cols: (np.float64(v), True)
        # string literals only survive next to a timestamp operand
        # (_promote_ts rewrites them); bare ones are unsupported here
        raise _Unsupported("string literal")
    if isinstance(e, sql.Neg):
        tag, f = _emit(e.inner, kinds)
        if not tag.startswith("num:") or tag == "num:M":
            raise _Unsupported("negate non-numeric")

        def neg(cols, f=f):
            v, ok = f(cols)
            return -_t(v), ok
        return tag, neg
    if isinstance(e, sql.Arith):
        if e.op == "%":
            # truncated-remainder corner cases (int zero divisors)
            # diverge between numpy and torch: host-vector handles them
            raise _Unsupported("% stays on the host vector path")
        lt, lf = _emit(e.left, kinds)
        rt, rf = _emit(e.right, kinds)
        for t in (lt, rt):
            if t == "num:M" or t == "bool":
                raise _Unsupported("arith on non-numeric")
            if t == "null":
                pass
            elif not t.startswith("num:"):
                raise _Unsupported(t)
        int_out = lt == "num:i" and rt == "num:i" and e.op != "/"
        op = e.op

        def arith(cols, lf=lf, rf=rf, op=op, int_out=int_out):
            a, av = lf(cols)
            b, bv = rf(cols)
            a, b = _t(a), _t(b)
            if op == "/":
                a = a.to(torch.float64)
                b = b.to(torch.float64)
            r = {"+": lambda: a + b, "-": lambda: a - b,
                 "*": lambda: a * b, "/": lambda: a / b}[op]()
            ok = torch.logical_and(_t(av), _t(bv))
            if not int_out:
                ok = torch.logical_and(ok, ~torch.isnan(
                    r.to(torch.float64)))
            return r, ok
        return ("num:i" if int_out else "num:f"), arith
    if isinstance(e, sql.Cmp):
        return "bool", _emit_cmp(e.op, e.left, e.right, kinds)
    if isinstance(e, sql.Between):
        lo = _emit_cmp(">=", e.inner, e.lo, kinds)
        hi = _emit_cmp("<=", e.inner, e.hi, kinds)
        return "bool", _kleene_and(lo, hi)
    if isinstance(e, sql.And):
        return "bool", _kleene_and(_emit_bool(e.left, kinds),
                                   _emit_bool(e.right, kinds))
    if isinstance(e, sql.Or):
        lf, rf = _emit_bool(e.left, kinds), _emit_bool(e.right, kinds)

        def f_or(cols, lf=lf, rf=rf):
            a, av = lf(cols)
            b, bv = rf(cols)
            a, av, b, bv = _t(a), _t(av), _t(b), _t(bv)
            val = torch.logical_or(a, b)
            ok = torch.logical_or(torch.logical_and(av, bv),
                                  torch.logical_or(a, b))
            return val, ok
        return "bool", f_or
    if isinstance(e, sql.Not):
        f = _emit_bool(e.inner, kinds)

        def f_not(cols, f=f):
            v, ok = f(cols)
            v, ok = _t(v), _t(ok)
            return torch.logical_and(~v, ok), ok
        return "bool", f_not
    if isinstance(e, sql.IsNull):
        tag, f = _emit(e.inner, kinds)
        if tag == "null":
            return "bool", lambda cols: (True, True)

        def f_isnull(cols, f=f):
            _, ok = f(cols)
            return ~_t(ok).to(torch.bool), True
        return "bool", f_isnull
    if isinstance(e, sql.Flip):
        f = _emit(e.inner, kinds)[1]

        def f_flip(cols, f=f):
            v, _ = f(cols)
            return ~_t(v).to(torch.bool), True
        return "bool", f_flip
    if isinstance(e, sql.IsTrue):
        f = _emit_bool(e.inner, kinds)

        def f_istrue(cols, f=f):
            v, ok = f(cols)
            return torch.logical_and(_t(v), _t(ok)), True
        return "bool", f_istrue
    if isinstance(e, sql.IsFalse):
        f = _emit_bool(e.inner, kinds)

        def f_isfalse(cols, f=f):
            v, ok = f(cols)
            return torch.logical_and(~_t(v), _t(ok)), True
        return "bool", f_isfalse
    if isinstance(e, sql.InList):
        # numeric non-null literals only: pandas isin treats NaN/None
        # literals specially (NaN matches NaN), host-vector keeps those
        if not all(isinstance(i, sql.Lit)
                   and isinstance(i.value, (int, float))
                   and not isinstance(i.value, bool)
                   and not pd.isna(i.value) for i in e.items):
            raise _Unsupported("IN over non-numeric-literal list")
        fns = [_emit_cmp("=", e.inner, i, kinds) for i in e.items]
        out = fns[0]
        for nxt in fns[1:]:
            lf, rf = out, nxt

            def f_or(cols, lf=lf, rf=rf):
                a, av = lf(cols)
                b, bv = rf(cols)
                return (torch.logical_or(_t(a), _t(b)),
                        torch.logical_and(_t(av), _t(bv)))
            out = f_or
        return "bool", out
    raise _Unsupported(type(e).__name__)


def _emit_bool(e: sql.Expr, kinds):
    tag, f = _emit(e, kinds)
    if tag == "bool":
        return f
    if tag == "null":
        return lambda cols: (False, False)
    raise _Unsupported(f"non-boolean operand ({tag})")


def _promote_ts(other: sql.Expr, other_tag: str):
    """A string literal next to a timestamp operand compares as its
    parsed timestamp (pandas' coercion rule), lowered to int64 ns."""
    if other_tag == "null":
        return lambda cols: (np.int64(0), False)
    if isinstance(other, sql.Lit) and isinstance(other.value, str):
        ns = pd.Timestamp(other.value).value
        return lambda cols: (np.int64(ns), True)
    return None


def _emit_cmp(op: str, left: sql.Expr, right: sql.Expr, kinds):
    lt = rt = None
    try:
        lt, lf = _emit(left, kinds)
    except _Unsupported:
        lt = None
    try:
        rt, rf = _emit(right, kinds)
    except _Unsupported:
        rt = None
    # timestamp vs string-literal promotion (either side)
    if lt == "num:M" and rt is None:
        pf = _promote_ts(right, "lit")
        if pf is None:
            raise _Unsupported("timestamp vs non-literal")
        rt, rf = "num:M", pf
    elif rt == "num:M" and lt is None:
        pf = _promote_ts(left, "lit")
        if pf is None:
            raise _Unsupported("timestamp vs non-literal")
        lt, lf = "num:M", pf
    if lt is None or rt is None:
        raise _Unsupported("comparison operand")
    if lt == "null":
        lf = lambda cols: (np.int64(0), False)  # noqa: E731
    if rt == "null":
        rf = lambda cols: (np.int64(0), False)  # noqa: E731
    num_tags = ("num:i", "num:f", "num:M", "null")
    if lt not in num_tags or rt not in num_tags:
        raise _Unsupported("non-numeric comparison")
    # datetime compares only against datetime (pandas raises otherwise
    # — that path must go through the vector engine to raise alike)
    if ("num:M" in (lt, rt)) and not (
            lt in ("num:M", "null") and rt in ("num:M", "null")):
        raise _Unsupported("timestamp vs number")

    def cmp(cols, lf=lf, rf=rf, op=op):
        a, av = lf(cols)
        b, bv = rf(cols)
        a, av, b, bv = _t(a), _t(av), _t(b), _t(bv)
        ok = torch.logical_and(av, bv)
        if op in ("=", "=="):
            r = a == b
        elif op in ("!=", "<>"):
            r = a != b
        elif op == "<":
            r = a < b
        elif op == "<=":
            r = a <= b
        elif op == ">":
            r = a > b
        elif op == ">=":
            r = a >= b
        else:  # <=> null-safe equal: never NULL
            both_null = torch.logical_and(~av.to(torch.bool),
                                          ~bv.to(torch.bool))
            r = torch.logical_or(torch.logical_and(a == b, ok), both_null)
            return r, True
        return torch.logical_and(r, ok), ok
    return cmp


def _kleene_and(lf, rf):
    def f_and(cols, lf=lf, rf=rf):
        a, av = lf(cols)
        b, bv = rf(cols)
        a, av, b, bv = _t(a), _t(av), _t(b), _t(bv)
        val = torch.logical_and(a, b)
        # NULL AND FALSE = FALSE; NULL AND TRUE = NULL
        ok = torch.logical_or(
            torch.logical_and(av, bv),
            torch.logical_or(torch.logical_and(av, ~a.to(torch.bool)),
                             torch.logical_and(bv, ~b.to(torch.bool))))
        return val, ok
    return f_and


def plane_program(ast: sql.Expr, dtypes: Dict[str, np.dtype]):
    """Compile a predicate AST to a (values, valid)-plane mask function
    for the given column dtypes, ``(names, fn)``; ``None`` when the
    predicate is outside the plane subset (strings, CASE, casts,
    dtypes outside :data:`_PLANE_DTYPES`)."""
    try:
        kinds = _col_kinds(ast, dtypes)
        key = (ast.canon(), tuple(sorted(kinds.items())))
        hit = _PLANE_CACHE.get(key)
        if hit is not None:
            return hit
        tag, f = _emit(ast, kinds)
        if tag != "bool":
            raise _Unsupported("non-boolean predicate")
        names = sorted(kinds)

        def fn(*flat):
            cols = {n: (flat[2 * i], flat[2 * i + 1])
                    for i, n in enumerate(names)}
            val, ok = f(cols)
            return torch.logical_and(_t(val).to(torch.bool),
                                     _t(ok).to(torch.bool))
        prog = (names, fn)
        _PLANE_CACHE[key] = prog
        return prog
    except _Unsupported:
        return None


def filter_backend(ast: sql.Expr, dtypes) -> str:
    """Which backend a predicate lands on for a given schema: the
    optimizer's ``explain()`` annotation."""
    return ("jit-plane" if plane_program(ast, dict(dtypes)) is not None
            else "host-vector")


def _series_planes(s: pd.Series):
    k = s.dtype.kind
    if k == "M":
        vals = s.to_numpy("datetime64[ns]").view("int64")
        return vals, s.notna().to_numpy()
    vals = s.to_numpy()
    if k == "f":
        return vals, ~np.isnan(vals)
    return vals, np.ones(len(vals), bool)


def _plane_mask(ast: sql.Expr, df: pd.DataFrame) -> Optional[np.ndarray]:
    prog = plane_program(ast, {c: df[c].dtype for c in df.columns
                               if isinstance(df[c].dtype, np.dtype)})
    if prog is None:
        return None
    names, fn = prog
    flat = []
    for n in names:
        v, ok = _series_planes(df[n])
        flat += [torch.from_numpy(np.require(v, requirements=("C", "W"))),
                 torch.from_numpy(np.require(ok, requirements=("C", "W")))]
    mask = fn(*flat)
    if mask.dim() == 0:
        mask = mask.expand(len(df))
    return mask.numpy().astype(bool)


# ----------------------------------------------------------------------
# Statement compiler: SELECT ... FROM ... [ASOF JOIN ...] [WHERE ...]
#                     [GROUP BY time_bucket('<freq>')]
# ----------------------------------------------------------------------

class _Statement:
    __slots__ = ("projs", "star", "table", "join_table", "join_params",
                 "where", "bucket")

    def __init__(self):
        self.projs = []         # ("expr", ast, alias, raw) |
        #                         ("agg", func, col, alias)
        self.star = False
        self.table = None
        self.join_table = None
        self.join_params = {}
        self.where = None       # sql.Expr
        self.bucket = None      # freq string


def _ident(p: "sql._Parser", what: str) -> str:
    t = p.next()
    if t.kind != "ident":
        raise sql.SqlError(f"expected {what}, found {t.text!r}")
    return t.text[1:-1] if t.text.startswith("`") else t.text


def _str_lit(p: "sql._Parser", what: str) -> str:
    t = p.next()
    if t.kind != "str":
        raise sql.SqlError(f"expected a string literal for {what}, "
                           f"found {t.text!r}")
    return t.text[1:-1]


def _parse_projection(p: "sql._Parser"):
    t = p.peek()
    # aggregate call: <agg>(<col>) — agg names are not expression
    # functions, so they are recognised structurally here
    if (t.kind == "ident" and t.text.lower() in _AGG_FUNCS
            and p.toks[p.pos + 1].kind == "op"
            and p.toks[p.pos + 1].text == "("):
        func = _AGG_FUNCS[t.text.lower()]
        p.pos += 2
        col = _ident(p, "an aggregated column")
        p.expect_op(")")
        alias = _ident(p, "an alias") if p.kw("as") else col
        return ("agg", func, col, alias)
    ast = p.parse_expr()
    if p.kw("as"):
        alias = _ident(p, "an alias")
    elif isinstance(ast, sql.Col):
        alias = ast.name.split(".")[-1]
    else:
        raise sql.SqlError(
            "statement projections other than bare columns require an "
            "AS alias")
    return ("expr", ast, alias, None)


def parse_statement(text: str) -> _Statement:
    """Parse the supported statement grammar::

        SELECT <proj> [, <proj>]* | *
        FROM <table>
        [ASOF JOIN <table> [PREFIX '<p>'] [LEFT PREFIX '<p>']
                           [LOOKBACK <seconds>]]
        [WHERE <predicate>]
        [GROUP BY time_bucket('<freq>')]

    Aggregate projections (``mean``/``avg``/``min``/``max``/``first``/
    ``last``) require GROUP BY and lower onto the bucket-stats resample
    kernels; everything else is an expression projection."""
    p = sql._Parser(sql._tokenize(text))
    if not p.kw("select"):
        raise sql.SqlError("statement must start with SELECT")
    st = _Statement()
    if p.op("*"):
        st.star = True
    else:
        st.projs.append(_parse_projection(p))
        while p.op(","):
            st.projs.append(_parse_projection(p))
    if not p.kw("from"):
        raise sql.SqlError("statement requires FROM <table>")
    st.table = _ident(p, "a table name")
    if p.kw("asof"):
        if not p.kw("join"):
            raise sql.SqlError("ASOF must be followed by JOIN")
        st.join_table = _ident(p, "a join table name")
        while True:
            if p.kw("prefix"):
                st.join_params["right_prefix"] = _str_lit(p, "PREFIX")
            elif p.kw("left"):
                if not p.kw("prefix"):
                    raise sql.SqlError("LEFT must be followed by PREFIX")
                st.join_params["left_prefix"] = _str_lit(p, "LEFT PREFIX")
            elif p.kw("lookback"):
                t = p.next()
                if t.kind != "num":
                    raise sql.SqlError("LOOKBACK requires a number")
                st.join_params["maxLookback"] = int(float(t.text))
            else:
                break
    if p.kw("where"):
        st.where = p.parse_expr()
    if p.kw("group"):
        if not p.kw("by"):
            raise sql.SqlError("GROUP must be followed by BY")
        t = p.next()
        if not (t.kind == "ident" and t.text.lower() == "time_bucket"):
            raise sql.SqlError(
                "only GROUP BY time_bucket('<freq>') is compiled")
        p.expect_op("(")
        st.bucket = _str_lit(p, "time_bucket")
        p.expect_op(")")
    if p.peek().kind != "end":
        raise sql.SqlError(
            f"trailing tokens at {p.peek().text!r} in statement")
    return st


def _table_node(name: str, tables) -> ir.Node:
    from tempo_tpu_torch.plan import lazy as plan_lazy

    key = sql.resolve_column(name, tables)
    if key is None:
        raise sql.SqlError(
            f"unknown table {name!r}; registered: "
            + ", ".join(sorted(tables)))
    return plan_lazy._as_node(tables[key])


def _structural(node: ir.Node) -> List[str]:
    """ts + partition (+ sequence) columns of the frame under a plan
    chain — the spine every statement result retains."""
    src = node.sources()[0]
    f = src.payload
    seq = getattr(f, "sequence_col", "") or getattr(f, "seq_col", "")
    return ([f.ts_col] + list(f.partitionCols) + ([seq] if seq else []))


def compile_statement(text: str, tables) -> ir.Node:
    """Compile one SELECT statement into a plan-IR root over the given
    ``{name: TSDF|DistributedTSDF|lazy}`` tables.  The root carries
    ``_origin='sql'`` (a distinct cache signature from the equivalent
    method chain)."""
    from tempo_tpu_torch import freq as freq_mod

    st = parse_statement(text)
    cur = _table_node(st.table, tables)
    if st.join_table is not None:
        right = _table_node(st.join_table, tables)
        jp = dict(left_prefix=None, right_prefix="right",
                  tsPartitionVal=None, fraction=0.5, skipNulls=True,
                  sql_join_opt=False, suppress_null_warning=False,
                  maxLookback=0)
        jp.update(st.join_params)
        cur = ir.Node("asof_join", params=jp, inputs=(cur, right))
    if st.where is not None:
        cols = ir.output_columns(cur)
        ast = _resolve(st.where, cols)
        params = dict(condition=sql.unparse(ast), ast=ast.canon(),
                      cols=tuple(sorted(sql.column_refs(ast))))
        cur = ir.Node("sql_filter", params=params, inputs=(cur,),
                      objs=dict(ast=ast))
    aggs = [pr for pr in st.projs if pr[0] == "agg"]
    exprs = [pr for pr in st.projs if pr[0] == "expr"]
    if st.bucket is not None:
        if not aggs:
            raise sql.SqlError(
                "GROUP BY time_bucket requires aggregate projections")
        freq_mod.checkAllowableFreq(st.bucket)
        funcs = {f for _, f, _, _ in aggs}
        if len(funcs) > 1:
            raise sql.SqlError(
                "one aggregate function per statement (the bucket-stats "
                f"kernels aggregate uniformly); got {sorted(funcs)}")
        structural = _structural(cur)
        cols = ir.output_columns(cur)
        metric = []
        for _, _, col, _ in aggs:
            rc = (sql.resolve_column(col, cols) if cols else col) or col
            metric.append(rc)
        for pr in exprs:
            if not (isinstance(pr[1], sql.Col)
                    and (sql.resolve_column(pr[1].name, structural)
                         or pr[1].name in structural)):
                raise sql.SqlError(
                    "non-aggregate projections in a GROUP BY statement "
                    "must be the frame's time/partition columns")
        cur = ir.Node("resample", params=dict(
            freq=st.bucket, func=next(iter(funcs)),
            metricCols=tuple(metric), prefix=None, fill=None),
            inputs=(cur,))
        # post-resample aliasing only when some alias differs from its
        # source column (the bucket kernels keep metric column names)
        if any(alias != col for _, _, col, alias in aggs):
            projs = [(c, sql.Col(c)) for c in structural]
            projs += [(alias, sql.Col(col)) for _, _, col, alias in aggs]
            params = dict(
                exprs=tuple(f"{e.name} AS {a}" if a != e.name else a
                            for a, e in projs),
                aliases=tuple(a for a, _ in projs),
                asts=tuple(e.canon() for _, e in projs),
                cols=tuple(sorted({e.name for _, e in projs})))
            cur = ir.Node("sql_project", params=params, inputs=(cur,),
                          objs=dict(projs=tuple(projs)))
    elif aggs:
        raise sql.SqlError(
            "aggregate projections require GROUP BY time_bucket")
    elif not st.star:
        structural = _structural(cur)
        out_cols = ir.output_columns(cur)
        projs, aliases = [], []
        for _, ast, alias, _ in exprs:
            projs.append((alias, _resolve(ast, out_cols)))
            aliases.append(alias)
        # auto-inject the structural spine (a time-series SELECT always
        # keeps its time/partition columns; explicit projections win)
        inject = [c for c in structural if c not in aliases]
        projs = [(c, sql.Col(c)) for c in inject] + projs
        refs = set()
        for _, ast in projs:
            refs |= sql.column_refs(ast)
        params = dict(
            exprs=tuple(f"<{a}>" for a, _ in projs),
            aliases=tuple(a for a, _ in projs),
            asts=tuple(e.canon() for _, e in projs),
            cols=tuple(sorted(refs)))
        cur = ir.Node("sql_project", params=params, inputs=(cur,),
                      objs=dict(projs=tuple(projs)))
    # the origin marker: SQL-born plans never share a cache signature
    # (and therefore never a cached executable) with method-chain twins
    root_params = dict(cur.params)
    root_params["_origin"] = "sql"
    root = ir.Node(cur.op, params=root_params, inputs=cur.inputs,
                   payload=cur.payload, objs=cur.objs)
    return root


def run_statement(text: str, tables):
    """One-shot compile + plan-execute."""
    from tempo_tpu_torch.plan import executor, optimizer

    root = compile_statement(text, tables)
    if optimizer._mesh_side(root):
        root = ir.Node("collect", inputs=(root,))
    return executor.execute(root)
