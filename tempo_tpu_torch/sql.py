"""Vectorized SQL expression engine for ``selectExpr`` / ``filter``.

The host evaluator of the port's ``TSDF.selectExpr`` / ``filter``: a
copy of ``tempo_tpu/sql.py`` (numpy/pandas only), which the port keeps
as its own so that it imports nothing of the JAX package.

The reference exposes Spark SQL expression strings through
``TSDF.selectExpr`` (scala/.../TSDF.scala:226-229) and string predicates
through ``filter``/``where`` (TSDF.scala:232-238); the Python tree routes
the same strings through Spark's parser via ``f.expr``.  tempo_tpu_torch
has no Catalyst, so this module implements the expression surface
directly: a tokenizer + Pratt parser producing a small AST that
evaluates vectorized over the frame's pandas/numpy columns on the host
(the expressions are host-side projections, as Spark evaluates them
outside its operators' kernels).

Supported grammar (Spark-compatible subset, case-insensitive keywords):

* literals: integers, floats, ``'strings'``/``"strings"``, TRUE/FALSE/NULL
* identifiers, including backquoted ``` `weird col` ```
* arithmetic ``+ - * / %``, unary ``-``/``+``, string ``||`` concat
* comparisons ``= == != <> < <= > >=``
* boolean ``AND OR NOT``
* ``IS [NOT] NULL``, ``[NOT] IN (...)``, ``[NOT] BETWEEN a AND b``,
  ``[NOT] LIKE 'pat%'``, ``RLIKE 'regex'``
* ``CASE [expr] WHEN ... THEN ... [ELSE ...] END``
* ``CAST(expr AS type)`` for int/bigint/smallint/tinyint/float/double/
  string/boolean/timestamp/date/long
* function calls from the registry below (math, string, conditional,
  datetime — the set the reference's notebooks/tests actually use)

Null semantics follow SQL three-valued logic where it is observable:
comparisons and boolean ops propagate null (represented as pandas NA /
NaN), ``filter`` keeps only rows where the predicate is exactly TRUE.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

__all__ = ["SqlError", "StrictSqlFallback", "parse", "evaluate",
           "eval_expr", "select_exprs", "filter_mask", "split_projection",
           "resolve_column", "column_refs", "map_columns", "unparse"]


class SqlError(ValueError):
    """Raised for unparseable or unsupported SQL expressions."""


class StrictSqlFallback(SqlError):
    """Raised under strict mode (``strict=True`` / TEMPO_TPU_SQL_STRICT)
    when an expression would silently leave the compiled SQL surface and
    fall back to a host-pandas engine."""


# ----------------------------------------------------------------------
# Tokenizer
# ----------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[dDlL]?)
     |(?P<str>'(?:[^'\\]|\\.|'')*'|"(?:[^"\\]|\\.)*")
     |(?P<ident>`[^`]+`|[A-Za-z_][A-Za-z_0-9]*)
     |(?P<op><=>|<=|>=|!=|<>|==|\|\||&&|[-+*/%<>=(),.])
    )""",
    re.X,
)


class _Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{self.kind}:{self.text}"


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            rest = src[pos:].lstrip()
            if not rest:
                break
            raise SqlError(f"cannot tokenize SQL at: {rest[:30]!r}")
        pos = m.end()
        for kind in ("num", "str", "ident", "op"):
            text = m.group(kind)
            if text is not None:
                toks.append(_Tok(kind, text))
                break
    toks.append(_Tok("end", ""))
    return toks


# ----------------------------------------------------------------------
# AST: every node is a callable env -> value (pandas Series or scalar)
# ----------------------------------------------------------------------

Env = Dict[str, pd.Series]
Node = Callable[[Env], object]

_KEYWORDS = {
    "and", "or", "not", "in", "is", "null", "like", "rlike", "between",
    "case", "when", "then", "else", "end", "as", "true", "false", "cast",
    "distinct",
}


def _is_null(v):
    if isinstance(v, pd.Series):
        return v.isna()
    return pd.isna(v)


def _to_float(v):
    if isinstance(v, pd.Series):
        return pd.to_numeric(v, errors="coerce").astype(float)
    return float(v) if v is not None and not pd.isna(v) else np.nan


def _numeric_binop(op: str, a, b):
    # int/int keeps int for + - * % (Spark); / is always fractional
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return _to_float(a) / _to_float(b)
    if op == "%":
        # Spark % is the truncated remainder (sign of the dividend),
        # not Python's floored modulo: -7 % 3 = -1, not 2
        r = np.fmod(np.asarray(a) if not isinstance(a, pd.Series) else a, b)
        int_in = all(
            (isinstance(x, pd.Series)
             and pd.api.types.is_integer_dtype(x))
            or isinstance(x, (int, np.integer))
            for x in (a, b)
        )
        if isinstance(r, pd.Series):
            return r.astype("int64") if int_in else r
        r = r.item() if isinstance(r, np.ndarray) else r
        return int(r) if int_in else r
    raise SqlError(f"unknown arithmetic op {op}")  # pragma: no cover


def _sql_and(a, b):
    # three-valued AND over pandas nullable booleans
    a = _as_bool(a)
    b = _as_bool(b)
    return a & b


def _sql_or(a, b):
    a = _as_bool(a)
    b = _as_bool(b)
    return a | b


def _as_bool(v):
    if isinstance(v, pd.Series):
        if v.dtype == object or str(v.dtype) in ("bool", "boolean"):
            return v.astype("boolean")
        return v.astype("boolean")
    if v is None or (np.isscalar(v) and pd.isna(v)):
        return pd.NA
    return bool(v)


def _compare(op: str, a, b):
    """SQL comparison with null propagation: null op x -> null."""
    na = _is_null(a)
    nb = _is_null(b)
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
    elif op == "<=>":  # null-safe equal
        both_null = _null_and(na, nb)
        r = (a == b) | both_null
        if isinstance(r, pd.Series):
            return r.fillna(False).astype("boolean")
        return bool(r)
    else:  # pragma: no cover
        raise SqlError(f"unknown comparison {op}")
    anynull = _null_and(na, nb, how="or")
    if isinstance(r, (pd.Series, np.ndarray)):
        r = pd.Series(r) if not isinstance(r, pd.Series) else r
        r = r.astype("boolean")
        return r.mask(pd.Series(anynull, index=r.index)
                      if not np.isscalar(anynull) else anynull)
    if (np.isscalar(anynull) and anynull) or anynull is True:
        return pd.NA
    return r


def _null_and(na, nb, how: str = "and"):
    if how == "or":
        return na | nb
    return na & nb


# ----------------------------------------------------------------------
# Function registry (vectorized over Series or plain scalars)
# ----------------------------------------------------------------------

def _series_or_scalar(fn_series, fn_scalar):
    def wrapped(v, *a):
        if isinstance(v, pd.Series):
            return fn_series(v, *a)
        return fn_scalar(v, *a)
    return wrapped


def _f_coalesce(*args):
    args = list(args)
    out = args[0]
    if not isinstance(out, pd.Series):
        for s in args:
            if isinstance(s, pd.Series):
                out = pd.Series(out, index=s.index, dtype=object)
                break
        else:
            for v in args:
                if not pd.isna(v):
                    return v
            return None
    out = out.copy()
    for nxt in args[1:]:
        mask = out.isna()
        if not mask.any():
            break
        if isinstance(nxt, pd.Series):
            out = out.mask(mask, nxt)
        else:
            out = out.mask(mask, nxt)
    return out


def _f_concat(*args):
    out = None
    for a in args:
        s = a.astype(str) if isinstance(a, pd.Series) else str(a)
        out = s if out is None else out + s
    return out


def _f_substring(s, start, length=None):
    # SQL substring is 1-indexed; 0 behaves like 1
    start = int(start)
    py = max(start - 1, 0)
    end = None if length is None else py + int(length)
    if isinstance(s, pd.Series):
        return s.astype(str).str.slice(py, end)
    return str(s)[py:end]


def _f_round(v, nd=0):
    nd = int(nd)
    if isinstance(v, pd.Series):
        return v.round(nd)
    return round(float(v), nd)


def _f_lpad(s, n, pad):
    n = int(n)
    if isinstance(s, pd.Series):
        return s.astype(str).str.pad(n, side="left", fillchar=str(pad)[0]).str.slice(0, n)
    t = str(s).rjust(n, str(pad)[0])
    return t[:n]


def _f_rpad(s, n, pad):
    n = int(n)
    if isinstance(s, pd.Series):
        return s.astype(str).str.pad(n, side="right", fillchar=str(pad)[0]).str.slice(0, n)
    return str(s).ljust(n, str(pad)[0])[:n]


def _dt_accessor(attr):
    def fn(v):
        if isinstance(v, pd.Series):
            return getattr(pd.to_datetime(v).dt, attr)
        return getattr(pd.Timestamp(v), attr)
    return fn


_TRUNC_MAP = {
    "year": "YS", "yyyy": "YS", "yy": "YS",
    "month": "MS", "mon": "MS", "mm": "MS",
    "day": "D", "dd": "D",
    "hour": "h", "minute": "min", "second": "s", "week": "W",
}


def _f_date_trunc(unit, v):
    unit = str(unit).lower()
    if unit not in _TRUNC_MAP:
        raise SqlError(f"date_trunc: unsupported unit {unit!r}")
    freq = _TRUNC_MAP[unit]
    ts = pd.to_datetime(v) if isinstance(v, pd.Series) else pd.Timestamp(v)
    if freq in ("YS", "MS", "W"):
        per = {"YS": "Y", "MS": "M", "W": "W"}[freq]
        if isinstance(ts, pd.Series):
            return ts.dt.to_period(per).dt.start_time
        return ts.to_period(per).start_time
    return ts.dt.floor(freq) if isinstance(ts, pd.Series) else ts.floor(freq)


def _f_unix_timestamp(v):
    ts = pd.to_datetime(v)
    if isinstance(ts, pd.Series):
        # normalise the unit first: pandas 2 infers datetime64[s]/[ms]
        # for strings, and astype(int64) counts in the stored unit
        return ts.astype("datetime64[ns]").astype("int64") // 1_000_000_000
    return int(pd.Timestamp(ts).value // 1_000_000_000)


def _f_if(cond, a, b):
    cond = _as_bool(cond)
    if isinstance(cond, pd.Series):
        return pd.Series(np.where(cond.fillna(False), a, b))
    return a if (cond is not pd.NA and cond) else b


def _minmax(npf, pyf):
    """Spark greatest/least SKIP nulls (null only when all args null) —
    np.fmax/fmin give exactly that for numerics."""

    def f(*args):
        series = [a for a in args if isinstance(a, pd.Series)]
        if series:
            idx = series[0].index
            out = None
            for a in args:
                arr = (pd.to_numeric(a, errors="coerce").to_numpy(float)
                       if isinstance(a, pd.Series) else a)
                out = arr if out is None else npf(out, arr)
            return pd.Series(out, index=idx)
        vals = [a for a in args if a is not None and not pd.isna(a)]
        return pyf(vals) if vals else None
    return f


_FUNCTIONS: Dict[str, Callable] = {
    "abs": _series_or_scalar(lambda s: s.abs(), abs),
    "ceil": _series_or_scalar(lambda s: np.ceil(_to_float(s)), math.ceil),
    "ceiling": _series_or_scalar(lambda s: np.ceil(_to_float(s)), math.ceil),
    "floor": _series_or_scalar(lambda s: np.floor(_to_float(s)), math.floor),
    "round": _f_round,
    "sqrt": _series_or_scalar(lambda s: np.sqrt(_to_float(s)), math.sqrt),
    "exp": _series_or_scalar(lambda s: np.exp(_to_float(s)), math.exp),
    "ln": _series_or_scalar(lambda s: np.log(_to_float(s)), math.log),
    "log": _series_or_scalar(lambda s: np.log(_to_float(s)), math.log),
    "log10": _series_or_scalar(lambda s: np.log10(_to_float(s)), math.log10),
    "log2": _series_or_scalar(lambda s: np.log2(_to_float(s)), math.log2),
    "pow": lambda a, b: _to_float(a) ** _to_float(b),
    "power": lambda a, b: _to_float(a) ** _to_float(b),
    "sin": _series_or_scalar(lambda s: np.sin(_to_float(s)), math.sin),
    "cos": _series_or_scalar(lambda s: np.cos(_to_float(s)), math.cos),
    "tan": _series_or_scalar(lambda s: np.tan(_to_float(s)), math.tan),
    "sign": _series_or_scalar(lambda s: np.sign(_to_float(s)),
                              lambda v: float(np.sign(v))),
    "signum": _series_or_scalar(lambda s: np.sign(_to_float(s)),
                                lambda v: float(np.sign(v))),
    "greatest": _minmax(np.fmax, max),
    "least": _minmax(np.fmin, min),
    "coalesce": _f_coalesce,
    "nvl": _f_coalesce,
    "nanvl": lambda a, b: (a.where(~a.isna(), b) if isinstance(a, pd.Series)
                           else (b if pd.isna(a) else a)),
    "isnull": lambda v: _is_null(v),
    "isnotnull": lambda v: ~_is_null(v) if isinstance(v, pd.Series)
                 else not pd.isna(v),
    "isnan": _series_or_scalar(lambda s: np.isnan(_to_float(s)),
                               lambda v: math.isnan(float(v))),
    "if": _f_if,
    "concat": _f_concat,
    "upper": _series_or_scalar(lambda s: s.astype(str).str.upper(),
                               lambda v: str(v).upper()),
    "lower": _series_or_scalar(lambda s: s.astype(str).str.lower(),
                               lambda v: str(v).lower()),
    "trim": _series_or_scalar(lambda s: s.astype(str).str.strip(),
                              lambda v: str(v).strip()),
    "ltrim": _series_or_scalar(lambda s: s.astype(str).str.lstrip(),
                               lambda v: str(v).lstrip()),
    "rtrim": _series_or_scalar(lambda s: s.astype(str).str.rstrip(),
                               lambda v: str(v).rstrip()),
    "length": _series_or_scalar(lambda s: s.astype(str).str.len(),
                                lambda v: len(str(v))),
    "substring": _f_substring,
    "substr": _f_substring,
    "replace": lambda s, a, b="": (s.astype(str).str.replace(str(a), str(b),
                                                             regex=False)
                                   if isinstance(s, pd.Series)
                                   else str(s).replace(str(a), str(b))),
    "lpad": _f_lpad,
    "rpad": _f_rpad,
    "split": lambda s, pat: (s.astype(str).str.split(str(pat))
                             if isinstance(s, pd.Series)
                             else str(s).split(str(pat))),
    "year": _dt_accessor("year"),
    "month": _dt_accessor("month"),
    "day": _dt_accessor("day"),
    "dayofmonth": _dt_accessor("day"),
    "hour": _dt_accessor("hour"),
    "minute": _dt_accessor("minute"),
    "second": _dt_accessor("second"),
    "date_trunc": _f_date_trunc,
    "to_timestamp": lambda v: pd.to_datetime(v),
    "to_date": lambda v: (pd.to_datetime(v).dt.normalize()
                          if isinstance(v, pd.Series)
                          else pd.Timestamp(v).normalize()),
    "unix_timestamp": _f_unix_timestamp,
    "negative": lambda v: -v,
    "positive": lambda v: v,
}


_CAST_TYPES = {
    "int": "int32", "integer": "int32", "smallint": "int16",
    "tinyint": "int8", "bigint": "int64", "long": "int64",
    "float": "float32", "double": "float64", "string": "str",
    "boolean": "bool", "timestamp": "timestamp", "date": "date",
}


def _cast(v, typ: str):
    typ = typ.lower()
    if typ not in _CAST_TYPES:
        raise SqlError(f"CAST: unsupported type {typ!r}")
    target = _CAST_TYPES[typ]
    if target == "timestamp":
        return pd.to_datetime(v)
    if target == "date":
        t = pd.to_datetime(v)
        return t.dt.normalize() if isinstance(t, pd.Series) else t.normalize()
    if isinstance(v, pd.Series):
        if target == "str":
            return v.astype(str)
        if target == "bool":
            return v.astype("boolean")
        if target.startswith("int"):
            if pd.api.types.is_datetime64_any_dtype(v):
                return v.astype("int64") // 1_000_000_000
            # SQL casts truncate toward zero; nulls stay null
            f = pd.to_numeric(v, errors="coerce")
            out = pd.Series(np.trunc(f.astype("float64")), index=v.index)
            return out.astype("Int64" if f.isna().any() else target)
        return pd.to_numeric(v, errors="coerce").astype(target)
    if pd.isna(v):
        return None
    if target == "str":
        return str(v)
    if target == "bool":
        return bool(v)
    if target.startswith("int"):
        return int(v)
    return float(v)


def _like_to_regex(pat: str) -> str:
    """LIKE pattern -> anchored regex.  ``\\`` escapes the next char
    (Spark's default LIKE escape).  Spark only permits the escape
    before ``%``, ``_`` or another escape char and rejects a trailing
    lone escape (ParseException); the same inputs raise here so a
    migrated query fails loudly instead of silently matching
    differently."""
    out = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == "\\":
            if i + 1 >= len(pat) or pat[i + 1] not in ("%", "_", "\\"):
                raise SqlError(
                    f"invalid LIKE escape sequence in {pat!r}: the "
                    "escape character must precede '%', '_' or itself"
                )
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


# ----------------------------------------------------------------------
# AST node classes
# ----------------------------------------------------------------------
#
# Every node is callable ``env -> value`` (a pandas Series or scalar), so
# a parsed tree evaluates exactly like the closure engine it replaced —
# and it is introspectable: ``canon()`` renders the tree as nested
# hashable tuples (the plan IR embeds these in node params so SQL-born
# plans get stable cache signatures), ``column_refs`` collects referenced
# columns for dead-column pruning, and ``map_columns`` rewrites
# references for compile-time resolution and filter pushdown.


def resolve_column(name: str, env) -> Optional[str]:
    """THE column-resolution ladder, shared by host evaluation and plan
    compilation so the two paths cannot diverge: exact match, then the
    dotted-suffix base (``tbl.col`` -> ``col``), then Spark's
    case-insensitive scan in column order.  ``env`` is any mapping or
    iterable of column names; returns the matching key or ``None``."""
    if name in env:
        return name
    base = name.split(".")[-1]
    if base in env:
        return base
    low = name.lower()
    for k in env:
        if k.lower() == low:
            return k
    return None


def null_masked_bool(computed: pd.Series, source: pd.Series) -> pd.Series:
    """Nullable-boolean coercion with the source's NULLs restored.

    Shared by LIKE / RLIKE / IN: passing ``na=pd.NA`` into a bool-dtype
    string op raises on this image's pandas ("boolean value of NA is
    ambiguous"), so predicates are computed over stringified values and
    the source NAs masked back in afterwards — one helper so the host
    path and the compiled path use byte-identical NULL handling."""
    return computed.astype("boolean").mask(source.isna())


class Expr:
    """Base class for parsed SQL expression nodes."""

    __slots__ = ()

    def __call__(self, env: "Env"):  # pragma: no cover - abstract
        raise NotImplementedError

    def canon(self) -> tuple:  # pragma: no cover - abstract
        raise NotImplementedError

    def children(self) -> Tuple["Expr", ...]:
        return ()

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{type(self).__name__}{self.canon()!r}"


class Lit(Expr):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __call__(self, env):
        return self.value

    def canon(self):
        # the type tag keeps 2 / 2.0 / True apart: they compare equal as
        # tuple elements but evaluate differently (int preservation), so
        # they must not share a plan signature
        return ("lit", type(self.value).__name__, self.value)


class Col(Expr):
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, env):
        k = resolve_column(self.name, env)
        if k is None:
            raise SqlError(f"column {self.name!r} not found")
        return env[k]

    def canon(self):
        return ("col", self.name)


class Func(Expr):
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Tuple[Expr, ...]):
        self.name = name  # lowercase registry key
        self.args = tuple(args)

    def __call__(self, env):
        return _FUNCTIONS[self.name](*[a(env) for a in self.args])

    def canon(self):
        return ("func", self.name, tuple(a.canon() for a in self.args))

    def children(self):
        return self.args


class Cast(Expr):
    __slots__ = ("inner", "typ")

    def __init__(self, inner: Expr, typ: str):
        self.inner = inner
        self.typ = typ

    def __call__(self, env):
        return _cast(self.inner(env), self.typ)

    def canon(self):
        return ("cast", self.typ.lower(), self.inner.canon())

    def children(self):
        return (self.inner,)


class Neg(Expr):
    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        return -self.inner(env)

    def canon(self):
        return ("neg", self.inner.canon())

    def children(self):
        return (self.inner,)


class Arith(Expr):
    __slots__ = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def __call__(self, env):
        return _numeric_binop(self.op, self.left(env), self.right(env))

    def canon(self):
        return ("arith", self.op, self.left.canon(), self.right.canon())

    def children(self):
        return (self.left, self.right)


class Concat(Expr):
    __slots__ = ("left", "right")

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    def __call__(self, env):
        return _f_concat(self.left(env), self.right(env))

    def canon(self):
        return ("concat", self.left.canon(), self.right.canon())

    def children(self):
        return (self.left, self.right)


class Cmp(Expr):
    __slots__ = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def __call__(self, env):
        return _compare(self.op, self.left(env), self.right(env))

    def canon(self):
        return ("cmp", self.op, self.left.canon(), self.right.canon())

    def children(self):
        return (self.left, self.right)


class And(Expr):
    __slots__ = ("left", "right")

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    def __call__(self, env):
        return _sql_and(self.left(env), self.right(env))

    def canon(self):
        return ("and", self.left.canon(), self.right.canon())

    def children(self):
        return (self.left, self.right)


class Or(Expr):
    __slots__ = ("left", "right")

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    def __call__(self, env):
        return _sql_or(self.left(env), self.right(env))

    def canon(self):
        return ("or", self.left.canon(), self.right.canon())

    def children(self):
        return (self.left, self.right)


class Not(Expr):
    """Three-valued NOT (both the prefix ``NOT`` and predicate negation:
    Series negate through the nullable-boolean dtype, scalar NULL stays
    NULL)."""

    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        v = self.inner(env)
        if isinstance(v, pd.Series):
            return ~_as_bool(v)
        return _scalar_not(v)

    def canon(self):
        return ("not", self.inner.canon())

    def children(self):
        return (self.inner,)


class Flip(Expr):
    """Plain two-valued complement for IS NOT NULL / IS NOT TRUE|FALSE —
    the inner result is never NULL, so no NA handling."""

    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        v = self.inner(env)
        if isinstance(v, pd.Series):
            return ~v
        return not v

    def canon(self):
        return ("flip", self.inner.canon())

    def children(self):
        return (self.inner,)


class IsNull(Expr):
    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        return _is_null(self.inner(env))

    def canon(self):
        return ("isnull", self.inner.canon())

    def children(self):
        return (self.inner,)


class IsTrue(Expr):
    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        v = self.inner(env)
        if isinstance(v, pd.Series):
            return _as_bool(v).fillna(False)
        # bool() also accepts np.bool_, which `is True` does not
        return (not pd.isna(v)) and bool(v)

    def canon(self):
        return ("istrue", self.inner.canon())

    def children(self):
        return (self.inner,)


class IsFalse(Expr):
    __slots__ = ("inner",)

    def __init__(self, inner: Expr):
        self.inner = inner

    def __call__(self, env):
        v = self.inner(env)
        if isinstance(v, pd.Series):
            return ~_as_bool(v).fillna(True)
        return (not pd.isna(v)) and not bool(v)

    def canon(self):
        return ("isfalse", self.inner.canon())

    def children(self):
        return (self.inner,)


class Between(Expr):
    __slots__ = ("inner", "lo", "hi")

    def __init__(self, inner: Expr, lo: Expr, hi: Expr):
        self.inner = inner
        self.lo = lo
        self.hi = hi

    def __call__(self, env):
        v = self.inner(env)
        return _sql_and(_compare(">=", v, self.lo(env)),
                        _compare("<=", v, self.hi(env)))

    def canon(self):
        return ("between", self.inner.canon(), self.lo.canon(),
                self.hi.canon())

    def children(self):
        return (self.inner, self.lo, self.hi)


class InList(Expr):
    __slots__ = ("inner", "items")

    def __init__(self, inner: Expr, items: Tuple[Expr, ...]):
        self.inner = inner
        self.items = tuple(items)

    def __call__(self, env):
        v = self.inner(env)
        vals = [it(env) for it in self.items]
        if isinstance(v, pd.Series):
            return null_masked_bool(v.isin(vals), v)
        if pd.isna(v):
            return pd.NA
        return v in vals

    def canon(self):
        return ("in", self.inner.canon(),
                tuple(it.canon() for it in self.items))

    def children(self):
        return (self.inner,) + self.items


class Like(Expr):
    __slots__ = ("inner", "pat")

    def __init__(self, inner: Expr, pat: Expr):
        self.inner = inner
        self.pat = pat

    def __call__(self, env):
        v, p = self.inner(env), self.pat(env)
        rx = _like_to_regex(str(p))
        if isinstance(v, pd.Series):
            return null_masked_bool(v.astype(str).str.match(rx), v)
        return bool(re.match(rx, str(v)))

    def canon(self):
        return ("like", self.inner.canon(), self.pat.canon())

    def children(self):
        return (self.inner, self.pat)


class RLike(Expr):
    __slots__ = ("inner", "pat")

    def __init__(self, inner: Expr, pat: Expr):
        self.inner = inner
        self.pat = pat

    def __call__(self, env):
        v, p = self.inner(env), self.pat(env)
        if isinstance(v, pd.Series):
            return null_masked_bool(
                v.astype(str).str.contains(str(p), regex=True), v)
        return bool(re.search(str(p), str(v)))

    def canon(self):
        return ("rlike", self.inner.canon(), self.pat.canon())

    def children(self):
        return (self.inner, self.pat)


class Case(Expr):
    __slots__ = ("subject", "branches", "default")

    def __init__(self, subject: Optional[Expr],
                 branches: Tuple[Tuple[Expr, Expr], ...],
                 default: Optional[Expr]):
        self.subject = subject
        self.branches = tuple(branches)
        self.default = default

    def __call__(self, env):
        subject, branches, default = self.subject, self.branches, self.default
        conds = []
        vals = []
        for c, v in branches:
            cv = c(env)
            if subject is not None:
                cv = _compare("=", subject(env), cv)
            cv = _as_bool(cv)
            if isinstance(cv, pd.Series):
                cv = cv.fillna(False).to_numpy(bool)
            conds.append(cv)
            vals.append(v(env))
        dv = default(env) if default is not None else None

        def numeric_branch(v):
            if v is None:
                return True
            if isinstance(v, pd.Series):
                return pd.api.types.is_numeric_dtype(v)
            return isinstance(v, (int, float, np.number)) \
                and not isinstance(v, bool)

        all_numeric = all(numeric_branch(v) for v in vals + [dv])
        # vectorized if any piece is a Series
        series = [x for x in conds + vals + [dv]
                  if isinstance(x, (pd.Series, np.ndarray))]
        if series:
            n = len(series[0])
            conds = [np.broadcast_to(np.asarray(c), (n,))
                     if not np.isscalar(c)
                     else np.full(n, bool(c)) for c in conds]
            vals = [np.asarray(v.astype(object) if isinstance(v, pd.Series)
                               else v)
                    if isinstance(v, (pd.Series, np.ndarray))
                    else np.full(n, v, dtype=object) for v in vals]
            dvv = (np.asarray(dv.astype(object)) if isinstance(dv, pd.Series)
                   else np.full(n, dv, dtype=object))
            out = pd.Series(np.select(conds, vals, default=dvv))
            if not all_numeric:
                # string/object branches keep their dtype — Spark
                # does not re-parse '01' into 1
                return out
            try:
                return pd.to_numeric(out)
            except (ValueError, TypeError):
                return out
        for c, v in zip(conds, vals):
            if c is not pd.NA and c:
                return v
        return dv

    def canon(self):
        return ("case",
                self.subject.canon() if self.subject is not None else None,
                tuple((c.canon(), v.canon()) for c, v in self.branches),
                self.default.canon() if self.default is not None else None)

    def children(self):
        kids = [] if self.subject is None else [self.subject]
        for c, v in self.branches:
            kids += [c, v]
        if self.default is not None:
            kids.append(self.default)
        return tuple(kids)


def unparse(expr: Expr) -> str:
    """Render a parsed tree back to SQL text (fully parenthesized — for
    ``explain()`` display and plan params, not for round-tripping the
    user's exact formatting)."""
    e, u = expr, unparse
    if isinstance(e, Lit):
        v = e.value
        if v is None:
            return "NULL"
        if v is True:
            return "TRUE"
        if v is False:
            return "FALSE"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return repr(v)
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Func):
        return f"{e.name}({', '.join(u(a) for a in e.args)})"
    if isinstance(e, Cast):
        return f"CAST({u(e.inner)} AS {e.typ})"
    if isinstance(e, Neg):
        return f"(-{u(e.inner)})"
    if isinstance(e, (Arith, Cmp)):
        return f"({u(e.left)} {e.op} {u(e.right)})"
    if isinstance(e, Concat):
        return f"({u(e.left)} || {u(e.right)})"
    if isinstance(e, And):
        return f"({u(e.left)} AND {u(e.right)})"
    if isinstance(e, Or):
        return f"({u(e.left)} OR {u(e.right)})"
    if isinstance(e, Not):
        return f"(NOT {u(e.inner)})"
    if isinstance(e, Flip):
        inner = e.inner
        for cls, word in ((IsNull, "NULL"), (IsTrue, "TRUE"),
                          (IsFalse, "FALSE")):
            if isinstance(inner, cls):
                return f"({u(inner.inner)} IS NOT {word})"
        return f"(NOT {u(inner)})"
    if isinstance(e, IsNull):
        return f"({u(e.inner)} IS NULL)"
    if isinstance(e, IsTrue):
        return f"({u(e.inner)} IS TRUE)"
    if isinstance(e, IsFalse):
        return f"({u(e.inner)} IS FALSE)"
    if isinstance(e, Between):
        return f"({u(e.inner)} BETWEEN {u(e.lo)} AND {u(e.hi)})"
    if isinstance(e, InList):
        return f"({u(e.inner)} IN ({', '.join(u(i) for i in e.items)}))"
    if isinstance(e, Like):
        return f"({u(e.inner)} LIKE {u(e.pat)})"
    if isinstance(e, RLike):
        return f"({u(e.inner)} RLIKE {u(e.pat)})"
    if isinstance(e, Case):
        parts = ["CASE"]
        if e.subject is not None:
            parts.append(u(e.subject))
        for c, v in e.branches:
            parts.append(f"WHEN {u(c)} THEN {u(v)}")
        if e.default is not None:
            parts.append(f"ELSE {u(e.default)}")
        parts.append("END")
        return " ".join(parts)
    return repr(e)  # pragma: no cover - new node classes


def walk(expr: Expr):
    """Yield every node of a parsed tree (pre-order)."""
    yield expr
    for child in expr.children():
        yield from walk(child)


def column_refs(expr: Expr):
    """The set of column names an expression reads."""
    return {n.name for n in walk(expr) if isinstance(n, Col)}


def map_columns(expr: Expr, fn) -> Expr:
    """Rebuild a tree with every column reference renamed through
    ``fn(name) -> name`` (compile-time resolution, filter pushdown
    through projection aliases).  Shared subtrees are rebuilt, never
    mutated, so parsed Exprs stay immutable/cacheable."""
    if isinstance(expr, Col):
        nn = fn(expr.name)
        return expr if nn == expr.name else Col(nn)
    if isinstance(expr, Lit):
        return expr
    m = lambda e: map_columns(e, fn)  # noqa: E731
    if isinstance(expr, Func):
        return Func(expr.name, tuple(m(a) for a in expr.args))
    if isinstance(expr, Cast):
        return Cast(m(expr.inner), expr.typ)
    if isinstance(expr, (Neg, Not, Flip, IsNull, IsTrue, IsFalse)):
        return type(expr)(m(expr.inner))
    if isinstance(expr, (Arith, Cmp)):
        return type(expr)(expr.op, m(expr.left), m(expr.right))
    if isinstance(expr, (Concat, And, Or)):
        return type(expr)(m(expr.left), m(expr.right))
    if isinstance(expr, Between):
        return Between(m(expr.inner), m(expr.lo), m(expr.hi))
    if isinstance(expr, InList):
        return InList(m(expr.inner), tuple(m(i) for i in expr.items))
    if isinstance(expr, (Like, RLike)):
        return type(expr)(m(expr.inner), m(expr.pat))
    if isinstance(expr, Case):
        return Case(None if expr.subject is None else m(expr.subject),
                    tuple((m(c), m(v)) for c, v in expr.branches),
                    None if expr.default is None else m(expr.default))
    raise SqlError(f"unknown expression node {type(expr).__name__}")


# ----------------------------------------------------------------------
# Parser (precedence climbing)
# ----------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.pos = 0

    # -- token helpers --------------------------------------------------
    def peek(self) -> _Tok:
        return self.toks[self.pos]

    def next(self) -> _Tok:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def kw(self, word: str) -> bool:
        t = self.peek()
        if t.kind == "ident" and t.text.lower() == word:
            self.pos += 1
            return True
        return False

    def op(self, *texts: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.text in texts:
            self.pos += 1
            return t.text
        return None

    def expect_op(self, text: str):
        if not self.op(text):
            raise SqlError(f"expected {text!r}, found {self.peek().text!r}")

    # -- grammar --------------------------------------------------------
    def parse_expr(self) -> Node:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.kw("or"):
            left = Or(left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.kw("and"):
            left = And(left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.kw("not"):
            return Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        left = self.parse_additive()
        # IS [NOT] NULL / IS [NOT] TRUE|FALSE
        if self.kw("is"):
            negate = self.kw("not")
            if self.kw("null"):
                node = IsNull(left)
            elif self.kw("true"):
                node = IsTrue(left)
            elif self.kw("false"):
                node = IsFalse(left)
            else:
                raise SqlError("expected NULL/TRUE/FALSE after IS")
            return Flip(node) if negate else node
        negate = self.kw("not")
        if self.kw("between"):
            lo = self.parse_additive()
            if not self.kw("and"):
                raise SqlError("BETWEEN requires AND")
            hi = self.parse_additive()
            return _maybe_negate(Between(left, lo, hi), negate)
        if self.kw("in"):
            self.expect_op("(")
            items = [self.parse_expr()]
            while self.op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return _maybe_negate(InList(left, tuple(items)), negate)
        if self.kw("like"):
            return _maybe_negate(Like(left, self.parse_additive()), negate)
        if self.kw("rlike"):
            return _maybe_negate(RLike(left, self.parse_additive()), negate)
        if negate:
            raise SqlError("dangling NOT")
        cmp = self.op("<=>", "<=", ">=", "!=", "<>", "==", "=", "<", ">")
        if cmp:
            return Cmp(cmp, left, self.parse_additive())
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            o = self.op("+", "-", "||")
            if not o:
                break
            right = self.parse_multiplicative()
            left = Concat(left, right) if o == "||" else Arith(o, left, right)
        return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            o = self.op("*", "/", "%")
            if not o:
                break
            left = Arith(o, left, self.parse_unary())
        return left

    def parse_unary(self) -> Expr:
        if self.op("-"):
            return Neg(self.parse_unary())
        if self.op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if self.op("("):
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if t.kind == "num":
            self.pos += 1
            text = t.text.rstrip("dDlL")
            suffix = t.text[len(text):].lower()
            if "." in text or "e" in text.lower() or suffix == "d":
                val = float(text)
            else:
                val = int(text)
            return Lit(val)
        if t.kind == "str":
            self.pos += 1
            body = t.text[1:-1]
            if t.text[0] == "'":
                body = body.replace("''", "'")
            body = re.sub(r"\\(.)", r"\1", body)
            return Lit(body)
        if t.kind == "ident":
            low = t.text.lower()
            if low == "case":
                return self.parse_case()
            if low == "cast":
                self.pos += 1
                self.expect_op("(")
                inner = self.parse_expr()
                if not self.kw("as"):
                    raise SqlError("CAST requires AS <type>")
                typ_tok = self.next()
                if typ_tok.kind != "ident":
                    raise SqlError("CAST requires a type name")
                self.expect_op(")")
                return Cast(inner, typ_tok.text)
            if low == "true":
                self.pos += 1
                return Lit(True)
            if low == "false":
                self.pos += 1
                return Lit(False)
            if low == "null":
                self.pos += 1
                return Lit(None)
            self.pos += 1
            # function call?
            if self.peek().kind == "op" and self.peek().text == "(" \
                    and low not in _KEYWORDS:
                self.pos += 1  # consume (
                args: List[Expr] = []
                if not self.op(")"):
                    args.append(self.parse_expr())
                    while self.op(","):
                        args.append(self.parse_expr())
                    self.expect_op(")")
                if low not in _FUNCTIONS:
                    raise SqlError(
                        f"unsupported SQL function {t.text!r}; supported: "
                        + ", ".join(sorted(_FUNCTIONS)))
                return Func(low, tuple(args))
            name = t.text[1:-1] if t.text.startswith("`") else t.text
            # dotted access (`tbl.col`) resolves to the bare column
            while self.peek().kind == "op" and self.peek().text == ".":
                self.pos += 1
                nxt = self.next()
                if nxt.kind != "ident":
                    raise SqlError("expected identifier after '.'")
                name = name + "." + nxt.text
            return Col(name)
        raise SqlError(f"unexpected token {t.text!r}")

    def parse_case(self) -> Expr:
        self.pos += 1  # consume CASE
        subject: Optional[Expr] = None
        if not (self.peek().kind == "ident"
                and self.peek().text.lower() == "when"):
            subject = self.parse_expr()
        branches: List[Tuple[Expr, Expr]] = []
        while self.kw("when"):
            cond = self.parse_expr()
            if not self.kw("then"):
                raise SqlError("WHEN requires THEN")
            val = self.parse_expr()
            branches.append((cond, val))
        default: Optional[Expr] = None
        if self.kw("else"):
            default = self.parse_expr()
        if not self.kw("end"):
            raise SqlError("CASE requires END")
        if not branches:
            raise SqlError("CASE requires at least one WHEN")
        return Case(subject, tuple(branches), default)


def _scalar_not(v):
    if v is None or (np.isscalar(v) and pd.isna(v)):
        return pd.NA
    return not v


def _maybe_negate(node: Expr, negate: bool) -> Expr:
    # predicate negation is the same three-valued NOT as the prefix
    # keyword (~astype("boolean") == ~_as_bool for any Series dtype)
    return Not(node) if negate else node


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------

def parse(expr: str) -> Expr:
    """Parse one SQL expression into an evaluatable, introspectable
    ``Expr`` node."""
    p = _Parser(_tokenize(expr))
    node = p.parse_expr()
    if p.peek().kind != "end":
        raise SqlError(f"trailing tokens at {p.peek().text!r} in {expr!r}")
    return node


def evaluate(node: Expr, df: pd.DataFrame):
    """Evaluate a parsed node against a DataFrame's columns."""
    env = {c: df[c] for c in df.columns}
    out = node(env)
    if isinstance(out, pd.Series):
        out = out.reset_index(drop=True)
        out.index = df.index
    return out


def eval_expr(df: pd.DataFrame, expr: str):
    """One-shot parse + evaluate."""
    return evaluate(parse(expr), df)


_AS_SPLIT_RE = re.compile(r"\s+as\s+(`[^`]+`|[A-Za-z_][A-Za-z_0-9]*)\s*$",
                          re.IGNORECASE)


def split_projection(raw: str) -> Tuple[str, str]:
    """Split one ``selectExpr`` string into ``(alias, body)``: a trailing
    ``AS alias`` names the output column, otherwise the expression text
    itself does (bare columns keep their name)."""
    m = _AS_SPLIT_RE.search(raw)
    if m:
        alias = m.group(1)
        alias = alias[1:-1] if alias.startswith("`") else alias
        return alias, raw[: m.start()]
    return raw.strip(), raw


def select_exprs(df: pd.DataFrame, exprs: Sequence[str]) -> pd.DataFrame:
    """Spark ``selectExpr`` semantics: each string is an expression with
    an optional trailing ``AS alias``; unaliased expressions use their
    text as the output column name (bare columns keep their name)."""
    out = {}
    for raw in exprs:
        alias, body = split_projection(raw)
        val = eval_expr(df, body)
        if not isinstance(val, pd.Series):
            val = pd.Series([val] * len(df), index=df.index)
        out[alias] = val
    return pd.DataFrame(out, index=df.index)


def filter_mask(df: pd.DataFrame, predicate: str) -> pd.Series:
    """Boolean row mask for ``filter``/``where``: TRUE rows only (SQL
    three-valued logic drops NULL rows, matching Spark)."""
    v = eval_expr(df, predicate)
    if not isinstance(v, pd.Series):
        v = pd.Series([v] * len(df), index=df.index)
    return v.astype("boolean").fillna(False).astype(bool)
