"""The plain reference of the benchmarked chain, in NumPy and pandas.

``asofJoin(right_prefix=...)`` -> ``withRangeStats([col], window)`` ->
``EMA(col, exact=True)`` with the dbl-tempo semantics the port keeps:

* AS-OF join, per partition key: each left row takes the last right row
  whose timestamp is at or before its own (right rows tied at one
  timestamp: the last in the input's order); with ``skipNulls`` each
  right column takes its last non-null value up to that row.  Right
  columns, the right timestamp included, are prefixed.
* Range stats: Spark's ``rangeBetween(-window, 0)`` over the timestamp
  cast to whole seconds, so a frame holds every row of its own second
  and of the ``window`` seconds before it: mean, count, min, max, sum,
  sample stddev and zscore of the non-null values.
* Exact EMA: ``y = (1 - a) y + a x`` over the non-null values in the
  sorted order from ``y = 0``, carried unchanged over null rows.

Rows come out sorted by (partition key value, timestamp, input order).
The whole chain is vectorised over rows; only the EMA's recursion
loops, once a key, inside ``scipy.signal.lfilter``.

``precision="bfloat16"`` is the control: the same arithmetic in
float32 with every value stored as bfloat16 (inputs and outputs
rounded to bfloat16, counts included), the next precision below the
port's float32.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.signal import lfilter

NS_PER_S = 1_000_000_000
STATS = ("mean", "count", "min", "max", "sum", "stddev", "zscore")


def to_bf16(a: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), as float32."""
    f = np.ascontiguousarray(a, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = r.view(np.float32)
    return np.where(np.isfinite(f), out, f)


def key_codes(keys: np.ndarray) -> np.ndarray:
    """Codes of ``keys`` numbered in the order of their values (a hash
    factorisation, then the few distinct values ranked)."""
    codes, uniques = pd.factorize(keys)
    rank = np.empty(len(uniques), dtype=np.int64)
    rank[np.argsort(np.asarray(uniques, dtype=object))] = \
        np.arange(len(uniques))
    return rank[codes]


def stable_order(codes: np.ndarray) -> np.ndarray:
    """The stable sort of small non-negative codes (a radix sort on
    16-bit codes where they fit)."""
    small = codes.max(initial=0) < 2**15
    return np.argsort(codes.astype(np.int16) if small else codes,
                      kind="stable")


def _codes(left_keys: np.ndarray, right_keys: np.ndarray):
    """Joint key codes, ordered by key value."""
    inv = key_codes(np.concatenate([left_keys, right_keys]))
    return inv[:len(left_keys)], inv[len(left_keys):]


def _starts(codes_sorted: np.ndarray, n_keys: int) -> np.ndarray:
    return np.searchsorted(codes_sorted, np.arange(n_keys + 1), side="left")


def _ns(series: pd.Series) -> np.ndarray:
    return series.to_numpy("datetime64[ns]").view(np.int64)


def asof_indices(lc, lts, rc, rts, n_keys: int) -> np.ndarray:
    """Index of the last right row at or before each left row of its key
    (-1: none), over both sides sorted by (key, ts)."""
    rs = _starts(rc, n_keys)
    ls = _starts(lc, n_keys)
    out = np.full(len(lc), -1, dtype=np.int64)
    for k in range(n_keys):
        a, b = ls[k], ls[k + 1]
        if a == b:
            continue
        pos = np.searchsorted(rts[rs[k]:rs[k + 1]], lts[a:b], side="right")
        out[a:b] = np.where(pos > 0, rs[k] + pos - 1, -1)
    return out


def last_valid(match: np.ndarray, valid: np.ndarray, rc: np.ndarray,
               n_keys: int) -> np.ndarray:
    """For each matched right row, the last non-null row of its key at or
    before it (-1: none)."""
    rs = _starts(rc, n_keys)
    lv = np.maximum.accumulate(np.where(valid, np.arange(len(valid)), -1))
    ok = match >= 0
    got = np.where(ok, lv[np.where(ok, match, 0)], -1)
    key_start = rs[rc[np.where(ok, match, 0)]] if len(rc) else got
    return np.where(ok & (got >= key_start), got, -1)


def window_bounds(codes: np.ndarray, ts_ns: np.ndarray, window: int,
                  n_keys: int):
    """``[start, end)`` of ``rangeBetween(-window, 0)`` over whole seconds
    for rows sorted by (key, ts); ``end`` takes the following ties."""
    secs = ts_ns // NS_PER_S
    rel = secs - (secs.min() if len(secs) else 0)
    comp = (codes << 36) + rel
    start = np.searchsorted(comp, comp - int(window), side="left")
    start = np.maximum(start, _starts(codes, n_keys)[codes])
    end = np.searchsorted(comp, comp, side="right")
    return start, end


def window_minmax(x: np.ndarray, valid: np.ndarray, start: np.ndarray,
                  end: np.ndarray):
    """Min and max of the valid ``x`` over each ``[start, end)``: a sparse
    table built one level at a time, each row answered at the level of
    its window's length (two overlapping power-of-two spans)."""
    n = len(x)
    length = end - start
    lev = np.zeros(n, dtype=np.int64)
    nz = length > 0
    lev[nz] = np.floor(np.log2(length[nz])).astype(np.int64)
    # a float log2 can land one off near powers of two: fix by the bits
    lev[nz] -= (1 << lev[nz]) > length[nz]
    lev[nz] += (1 << (lev[nz] + 1)) <= length[nz]
    out = []
    for fill, red in ((np.inf, np.minimum), (-np.inf, np.maximum)):
        cur = np.where(valid, x, fill)
        res = np.full(n, fill)
        span = 1
        for level in range(int(lev.max(initial=0)) + 1):
            sel = nz & (lev == level)
            if sel.any():
                res[sel] = red(cur[start[sel]], cur[end[sel] - span])
            cur = red(cur[:len(cur) - span], cur[span:]) \
                if len(cur) > span else cur[:0]
            span *= 2
        out.append(res)
    return out


def ema(x: np.ndarray, valid: np.ndarray, codes: np.ndarray, alpha: float,
        n_keys: int, dtype=np.float64) -> np.ndarray:
    """The exact EMA a key, carried over null rows."""
    starts = _starts(codes, n_keys)
    y = np.zeros(len(x), dtype=dtype)
    b, a = [dtype(alpha)], [dtype(1.0), dtype(alpha) - dtype(1.0)]
    for k in range(n_keys):
        s, e = starts[k], starts[k + 1]
        if s == e:
            continue
        ok = valid[s:e]
        yk = lfilter(b, a, x[s:e][ok].astype(dtype))
        # null rows keep the last value (0 before the first)
        idx = np.maximum.accumulate(np.where(ok, np.arange(e - s), -1))
        pos = np.cumsum(ok) - 1
        filled = np.where(idx >= 0, yk[np.maximum(pos, 0)] if len(yk)
                          else 0.0, 0.0)
        y[s:e] = filled
    return y


def chain(left: pd.DataFrame, right: pd.DataFrame, cfg: dict,
          precision: str = "float64") -> pd.DataFrame:
    """The reference output frame of ``cfg``'s chain over the generated
    ``left`` and ``right`` frames."""
    if precision not in ("float64", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    low = precision == "bfloat16"
    ft = np.float32 if low else np.float64
    rnd = to_bf16 if low else (lambda a: np.asarray(a, dtype=np.float64))
    key, ts = cfg["partition_col"], cfg["ts_col"]
    ch = cfg["chain"]
    col, w, alpha = ch["stats_col"], int(ch["window_secs"]), ch["exp_factor"]
    if not len(left):
        raise ValueError("the reference needs left rows")
    lk, rk = left[key].to_numpy(), right[key].to_numpy()
    lc, rc = _codes(lk, rk)
    n_keys = int(max(lc.max(initial=-1), rc.max(initial=-1))) + 1
    lts, rts = _ns(left[ts]), _ns(right[ts])
    lo = np.lexsort((lts, lc))
    ro = np.lexsort((rts, rc))
    lc, lts, rc, rts = lc[lo], lts[lo], rc[ro], rts[ro]

    out = {key: lk[lo], ts: lts.view("datetime64[ns]")}
    for c in left.columns:
        if c not in (key, ts):
            out[c] = left[c].to_numpy()[lo]
    match = asof_indices(lc, lts, rc, rts, n_keys)
    prefix = ch["right_prefix"]
    for c in right.columns:
        if c == key:
            continue
        vals = right[c].to_numpy()[ro]
        valid = ~pd.isna(vals)
        j = last_valid(match, valid, rc, n_keys)
        ok = j >= 0
        if c == ts:
            got = np.where(ok, rts[np.where(ok, j, 0)], 0)
            out[f"{prefix}_{c}"] = np.where(
                ok, got.view("datetime64[ns]"), np.datetime64("NaT"))
        else:
            v = rnd(vals.astype(np.float64))[np.where(ok, j, 0)]
            out[f"{prefix}_{c}"] = np.where(ok, v, np.nan)

    x = left[col].to_numpy(dtype=np.float64)[lo]
    xv = ~np.isnan(x)
    x = np.asarray(rnd(x), dtype=ft)
    start, end = window_bounds(lc, lts, w, n_keys)
    # prefix sums of the key-centred values
    cnt_p = np.concatenate([[0], np.cumsum(xv)])
    kcnt = np.maximum(np.bincount(lc, weights=xv, minlength=n_keys), 1)
    xz = np.where(xv, x, 0).astype(ft)
    centre = (np.bincount(lc, weights=xz, minlength=n_keys) / kcnt
              ).astype(ft)[lc]
    xc = np.where(xv, x - centre, 0).astype(ft)
    s1_p = np.concatenate([[0], np.cumsum(xc, dtype=ft)])
    s2_p = np.concatenate([[0], np.cumsum(xc * xc, dtype=ft)])
    cnt = (cnt_p[end] - cnt_p[start]).astype(np.int64)
    s1 = (s1_p[end] - s1_p[start]).astype(np.float64)
    s2 = (s2_p[end] - s2_p[start]).astype(np.float64)
    c = cnt.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(cnt > 0, s1 / np.maximum(c, 1) + centre, np.nan)
        total = np.where(cnt > 0, s1 + c * centre, np.nan)
        var = np.where(cnt > 1, (s2 - s1 * s1 / np.maximum(c, 1))
                       / np.maximum(c - 1, 1), np.nan)
        std = np.sqrt(np.maximum(var, 0))
        mn, mx = window_minmax(x.astype(np.float64), xv, start, end)
        mn = np.where(cnt > 0, mn, np.nan)
        mx = np.where(cnt > 0, mx, np.nan)
        z = np.where(xv, (x - mean) / std, np.nan)
    if low:
        mean, total, std, mn, mx, z = (to_bf16(a).astype(np.float64)
                                       for a in (mean, total, std, mn, mx, z))
        cnt = to_bf16(cnt).astype(np.int64)
    stats = dict(mean=mean, count=cnt, min=mn, max=mx, sum=total,
                 stddev=std, zscore=z)
    for s in STATS:
        out[f"{s}_{col}"] = stats[s]
    e_col = ch["ema_col"]
    ex = left[e_col].to_numpy(dtype=np.float64)[lo]
    ev = ~np.isnan(ex)
    y = ema(np.asarray(rnd(ex), dtype=ft), ev, lc, alpha, n_keys, ft)
    out[f"EMA_{e_col}"] = (to_bf16(y) if low else y).astype(np.float64)
    return pd.DataFrame(out)
