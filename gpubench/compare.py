"""The comparison that decides ``correct``: the program's output frame
against the plain reference's, over every row.

Three numbers, each held to the cell's limit (``cells/<workload>.json``):

* ``rows_bad``: rows that differ where the chain is exact - a missing or
  extra row, the key, the timestamp, the joined right timestamp, the
  null pattern of every joined column and statistic, ``count``, and the
  left and joined values beyond the rounding of a float32 plane
  (``|got - ref| <= 2^-24 |ref|``).  Its limit is 0.
* ``stats_err``: the widest gap of mean, min, max, sum, stddev and
  zscore, each over its natural scale: ``|got - ref| / (|ref| + s)``
  with ``s`` the column's mean absolute value (``count * s`` for the
  sum).  The zscore is compared as ``x - mean``, both sides' zscores
  times the reference's stddev: a float32 zscore of a window whose
  values agree to float32's rounding is noise over a stddev near 0.
  Where the reference's stddev is within float32's rounding of the
  window's mean (``8 * 2^-24 * |mean|``) the window's values are one
  float32 value: the program's zscore is 0/0 there, and its null
  pattern is not held against the reference's.
* ``ema_err``: the same for the EMA, with ``s`` of the EMA's column.

Rows are aligned by sorting the program's output stably by the key's
value: within a key both sides hold (timestamp, input order).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from gpubench.reference.chain import STATS, key_codes, stable_order

F32_REL = 2.0 ** -24


def _ns(col: pd.Series) -> np.ndarray:
    return col.to_numpy("datetime64[ns]").view(np.int64)


def _mean_abs(x: np.ndarray) -> float:
    x = x[np.isfinite(x)]
    return float(np.abs(x).mean()) if len(x) else 1.0


def _value_bad(g: np.ndarray, r: np.ndarray) -> np.ndarray:
    gn, rn = np.isnan(g), np.isnan(r)
    close = np.abs(g - r) <= F32_REL * np.abs(r)
    return (gn != rn) | (~rn & ~gn & ~close)


def _gap(g: np.ndarray, r: np.ndarray, scale) -> float:
    both = np.isfinite(g) & np.isfinite(r)
    if not both.any():
        return 0.0
    s = scale[both] if isinstance(scale, np.ndarray) else scale
    return float((np.abs(g[both] - r[both]) / (np.abs(r[both]) + s)).max())


def compare(got: pd.DataFrame, ref: pd.DataFrame, cfg: dict) -> dict:
    """``{"rows_bad", "stats_err", "ema_err", "rows"}`` of ``got``
    against ``ref``; an error is None where the frames cannot be
    aligned (a missing column, another row count)."""
    missing = [c for c in ref.columns if c not in got.columns]
    if missing or len(got) != len(ref):
        return {"rows_bad": max(len(got), len(ref)), "stats_err": None,
                "ema_err": None, "rows": len(ref)}
    key, ts = cfg["partition_col"], cfg["ts_col"]
    ch = cfg["chain"]
    col, e_col = ch["stats_col"], ch["ema_col"]
    order = stable_order(key_codes(got[key].to_numpy()))
    g = got.iloc[order].reset_index(drop=True)
    bad = g[key].to_numpy() != ref[key].to_numpy()
    bad |= _ns(g[ts]) != _ns(ref[ts])
    prefix = ch["right_prefix"] + "_"
    for c in ref.columns:
        if c.startswith(prefix) or c in (col, e_col):
            if np.issubdtype(ref[c].dtype, np.datetime64):
                gn, rn = g[c].isna().to_numpy(), ref[c].isna().to_numpy()
                bad |= (gn != rn) | (~rn & (_ns(g[c]) != _ns(ref[c])))
            else:
                bad |= _value_bad(g[c].to_numpy(np.float64),
                                  ref[c].to_numpy(np.float64))
    cnt_g = g[f"count_{col}"].to_numpy()
    cnt_r = ref[f"count_{col}"].to_numpy()
    bad |= cnt_g != cnt_r
    s = _mean_abs(ref[col].to_numpy(np.float64))
    scales = {"mean": s, "min": s, "max": s, "stddev": s, "zscore": s,
              "sum": s * np.maximum(cnt_r, 1).astype(np.float64)}
    std_r = ref[f"stddev_{col}"].to_numpy(np.float64)
    flat = std_r <= 8 * F32_REL * np.abs(
        ref[f"mean_{col}"].to_numpy(np.float64))
    stats_err = 0.0
    for st in STATS:
        if st == "count":
            continue
        gv = g[f"{st}_{col}"].to_numpy(np.float64)
        rv = ref[f"{st}_{col}"].to_numpy(np.float64)
        differ = np.isfinite(gv) != np.isfinite(rv)
        bad |= differ & ~flat if st == "zscore" else differ
        if st == "zscore":
            gv, rv = gv * std_r, rv * std_r
        stats_err = max(stats_err, _gap(gv, rv, scales[st]))
    ge = g[f"EMA_{e_col}"].to_numpy(np.float64)
    re_ = ref[f"EMA_{e_col}"].to_numpy(np.float64)
    bad |= np.isfinite(ge) != np.isfinite(re_)
    ema_err = _gap(ge, re_, _mean_abs(ref[e_col].to_numpy(np.float64)))
    return {"rows_bad": int(bad.sum()), "stats_err": stats_err,
            "ema_err": ema_err, "rows": len(ref)}


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit", "ok"}}`` of each number ``limits``
    names, in its order, and whether it is within its limit (None never
    is)."""
    out = {}
    for name in limits:
        v = numbers.get(name)
        out[name] = {"value": v, "limit": limits[name],
                     "ok": v is not None and v <= limits[name]}
    return out
