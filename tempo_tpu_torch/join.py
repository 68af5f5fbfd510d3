"""Frame-level AS-OF join: packing, prefixing, skew brackets, assembly.

Counterpart of ``tempo_tpu/join.py`` (reference tsdf.py:463-560):

* non-partition columns of both sides get prefixed, ``right_prefix``
  defaulting to ``"right"``;
* ``skipNulls`` both ways and the sequence-number tie-break ride the
  merge kernel (``ops/merge.py``), over the dense layout or, for
  Zipf-skewed keys, the bin-packed one (short series share lane rows);
* ``tsPartitionVal``/``fraction`` compose the key with overlapping time
  brackets (tsdf.py:164-190);
* ``sql_join_opt`` takes the broadcast strategy, an inner range join
  that drops left rows with no preceding right row (tsdf.py:482-509);
* ``maxLookback`` caps the match to the trailing rows of the merged
  stream (scala asofJoin.scala:64-88).

Engines past the single-program limit (``profiling.pick_join_engine``):
``chunked`` and ``maxLookback`` need the chunked merge kernel, which is
not ported: on the card they raise ``KernelNotPortedError``, on the CPU
the plain forms run (all engines give the same indices).  ``bracket``
splits series into exact host time brackets and runs the merge kernel.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import config, packing, profiling
from tempo_tpu_torch.ops import asof as asof_ops
from tempo_tpu_torch.ops import sortmerge as sm

logger = logging.getLogger(__name__)


def _estimate_merged_lanes(l_codes, r_codes, n_series: int) -> int:
    """Padded merged-lane count of the dense layout, before packing."""
    max_l = int(np.bincount(l_codes, minlength=max(n_series, 1)).max(initial=0))
    max_r = int(np.bincount(r_codes, minlength=max(n_series, 1)).max(initial=0))
    return packing.pad_length(max_l) + packing.pad_length(max_r)


def _auto_bracket(l_codes, l_ts_ns, r_codes, r_ts_ns, r_seq_vals,
                  n_series, est_lanes, limit, valid_masks):
    """Exact host time brackets: each (key, bracket) series carries the
    per-column last valid right row and the last right row from before
    the bracket, so the bracketed join equals the unbracketed one.
    Returns ``(l_brackets, r_take, r_bracket_all)`` or None (zero span)."""
    lo = min(int(l_ts_ns.min()), int(r_ts_ns.min()))
    hi = max(int(l_ts_ns.max()), int(r_ts_ns.max()))
    span = hi - lo + 1
    if span <= 1:
        return None
    n_brackets = max(2, min(int(-(-2 * est_lanes // max(limit, 1))), 1 << 16))
    width_ns = max(1, -(-span // n_brackets))
    l_b = (l_ts_ns - lo) // width_ns
    r_b = (r_ts_ns - lo) // width_ns
    r_layout0 = packing.build_layout_from_codes(r_codes, r_ts_ns, r_seq_vals,
                                                n_series)
    rs_ts = r_layout0.ts_ns
    starts = r_layout0.starts
    idx = np.arange(len(r_codes), dtype=np.int64)
    last_valid = [np.maximum.accumulate(
        np.where(valid_masks[c][r_layout0.order], idx, -1))
        for c in range(valid_masks.shape[0])] if len(r_codes) else []
    pairs = (np.unique(np.stack([l_codes, l_b], axis=1), axis=0)
             if len(l_codes) else np.zeros((0, 2), np.int64))
    carry_rows: List[int] = []
    carry_brackets: List[int] = []
    for k, b in pairs:
        s0, s1 = int(starts[k]), int(starts[k + 1])
        if s1 <= s0:
            continue
        boundary = lo + int(b) * width_ns
        p = s0 + int(np.searchsorted(rs_ts[s0:s1], boundary, side="left"))
        if p <= s0:
            continue
        carry = {p - 1}
        for lv in last_valid:
            j = int(lv[p - 1])
            if j >= s0:
                carry.add(j)
        for j in carry:
            carry_rows.append(j)
            carry_brackets.append(int(b))
    carried = np.asarray(carry_rows, dtype=np.int64)
    r_take = np.concatenate([idx, r_layout0.order[carried]])
    r_bracket_all = np.concatenate(
        [r_b, np.asarray(carry_brackets, dtype=np.int64)])
    return l_b, r_take, r_bracket_all


def _prefixed(cols: List[str], prefix: Optional[str]) -> dict:
    if not prefix:
        return {c: c for c in cols}
    return {c: f"{prefix}_{c}" for c in cols}


def _gather(values: np.ndarray, idx: np.ndarray, ok: np.ndarray):
    """Host gather with Spark-null semantics for any dtype."""
    if values.shape[0] == 0:
        ok = np.zeros(idx.shape, dtype=bool)
        values = np.empty(1, dtype=values.dtype)
    taken = values[np.where(ok, idx, 0)]
    if values.dtype == object:
        out = taken.astype(object)
        out[~ok] = None
        return out
    if np.issubdtype(values.dtype, np.datetime64):
        out = taken.astype("datetime64[ns]")
        out[~ok] = np.datetime64("NaT")
        return out
    if np.issubdtype(values.dtype, np.floating):
        out = taken.astype(values.dtype)
        out[~ok] = np.nan
        return out
    if ok.all():
        return taken
    if np.issubdtype(values.dtype, np.bool_):
        out = pd.array(taken, dtype="boolean")
    else:
        out = pd.array(taken.astype(np.int64), dtype="Int64")
    out[~ok] = pd.NA
    return out


def _binpack_worthwhile(l_layout, r_layout) -> bool:
    """Bin-pack when one-series-per-row padding would waste most lanes
    (Zipf-skewed keys); ``TEMPO_TPU_BINPACK=1/0`` forces/forbids."""
    K = l_layout.n_series
    Ll = int(l_layout.lengths.max(initial=0))
    Lr = int(r_layout.lengths.max(initial=0))
    env = config.get("TEMPO_TPU_BINPACK")
    if env is not None:
        return env not in ("0", "false", "no")
    slots = K * (Ll + Lr)
    if slots == 0:
        return False
    return (l_layout.n_rows + r_layout.n_rows) / slots < 0.35


def _check_engine(engine: str, device: torch.device) -> None:
    if engine == "chunked" and device.type == "cuda":
        raise sm.not_ported("the chunked AS-OF join engine", sm.CHUNKED_JOIN)


def _binpacked_indices(right, l_layout, r_layout, r_sorted_take, valid_cols,
                       device, max_lookback=0, r_seq_sorted=None):
    """Join indices over the bin-packed layout: positions within each
    lane row, plus the packing."""
    Wl = packing.pad_length(max(int(l_layout.lengths.max(initial=0)), 1), 128)
    Wr = packing.pad_length(max(int(r_layout.lengths.max(initial=0)), 1), 128)
    bp = packing.bin_pack_series(l_layout.lengths, r_layout.lengths, Wl, Wr)
    K2 = packing.pad_length(bp.n_rows)
    dest_l = packing.binpack_dest(l_layout.starts, bp.row, bp.l_off, Wl)
    dest_r = packing.binpack_dest(r_layout.starts, bp.row, bp.r_off, Wr)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lt = packing.binpack_scatter(l_layout.ts_ns, dest_l, K2, Wl, packing.TS_PAD)
    rt = packing.binpack_scatter(r_layout.ts_ns, dest_r, K2, Wr, packing.TS_PAD)
    lsid = packing.binpack_scatter(l_layout.key_ids.astype(np.int32), dest_l,
                                   K2, Wl, packing.SID_PAD)
    rsid = packing.binpack_scatter(r_layout.key_ids.astype(np.int32), dest_r,
                                   K2, Wr, packing.SID_PAD)
    rv = (np.stack([packing.binpack_scatter(
        (~pd.isna(right.df[c])).to_numpy()[r_sorted_take], dest_r, K2, Wr,
        False) for c in valid_cols])
        if valid_cols else np.zeros((0, K2, Wr), bool))
    rsq = (up(packing.binpack_scatter(r_seq_sorted, dest_r, K2, Wr, np.inf))
           if r_seq_sorted is not None else None)
    last_idx, per_col = sm.asof_indices_binpacked(
        up(lt), up(rt), up(rv), up(lsid), up(rsid),
        max_lookback=int(max_lookback), r_seq=rsq)
    return last_idx.cpu().numpy(), per_col.cpu().numpy(), bp


def _joint_bracket_codes(l_codes, r_codes_taken, l_brackets, r_brackets):
    """(key, time-bracket) joint series ids for both sides."""
    all_codes = np.concatenate([l_codes, r_codes_taken])
    all_brackets = np.concatenate([l_brackets, r_brackets])
    joint = all_codes * np.int64(2 ** 31) + pd.factorize(all_brackets)[0]
    joint_codes, _ = pd.factorize(joint)
    n_series = int(joint_codes.max()) + 1
    nl = len(l_brackets)
    return (joint_codes[:nl].astype(np.int64),
            joint_codes[nl:].astype(np.int64), n_series)


def _time_brackets(ts_ns: np.ndarray, ts_partition_val: float):
    """Bracket id and remainder fraction in double seconds (tsdf.py:176-180)."""
    ts_sec = ts_ns / packing.NS_PER_S
    bracket = ts_partition_val * (ts_sec / ts_partition_val).astype(np.int64)
    return bracket, (ts_sec - bracket) / ts_partition_val


def asof_join(left, right, left_prefix: Optional[str] = None,
              right_prefix: str = "right",
              tsPartitionVal: Optional[float] = None, fraction: float = 0.5,
              skipNulls: bool = True, sql_join_opt: bool = False,
              suppress_null_warning: bool = False, maxLookback: int = 0):
    device = left.device
    max_lookback = int(maxLookback or 0)
    strategy = profiling.pick_asof_strategy(
        left.df, right.df, sql_join_opt, has_sequence=bool(right.sequence_col),
        max_lookback=max_lookback)
    broadcast_path = strategy == "broadcast"
    if max_lookback and device.type == "cuda":
        raise sm.not_ported("asofJoin(maxLookback > 0)", sm.CHUNKED_JOIN)

    if tsPartitionVal is not None:
        if not skipNulls:
            raise ValueError("Disabling null skipping with a partition value "
                             "is not supported yet.")
        logger.warning(
            "You are using the skew version of the AS OF join. This may "
            "result in null values if there are any values outside of the "
            "maximum lookback. For maximum efficiency, choose smaller values "
            "of maximum lookback, trading off performance and potential "
            "blank AS OF values for sparse keys")

    left._check_partition_cols_match(right)
    left._validate_ts_col_match(right)
    pcols = left.partitionCols
    left_value_cols = [c for c in left.df.columns if c not in pcols]
    right_value_cols = [c for c in right.df.columns if c not in pcols]
    lmap = _prefixed(left_value_cols, left_prefix)
    rmap = _prefixed(right_value_cols, right_prefix)
    right_valid = {c: (~pd.isna(right.df[c])).to_numpy()
                   for c in right_value_cols}

    l_codes, r_codes, key_frame = packing.encode_keys_joint(left.df, right.df,
                                                            pcols)
    l_ts_ns = packing.series_to_ns(left.df[left.ts_col])
    r_ts_ns = packing.series_to_ns(right.df[right.ts_col])
    r_seq_vals = (pd.to_numeric(right.df[right.sequence_col])
                  .to_numpy(dtype=np.float64) if right.sequence_col else None)
    if r_seq_vals is not None:
        # Spark orders the merged stream by (ts, seq ASC NULLS FIRST,
        # rec_ind), tsdf.py:117-121: -inf realises NULLS FIRST
        r_seq_vals = np.where(np.isnan(r_seq_vals), -np.inf, r_seq_vals)

    r_take = np.arange(len(right.df), dtype=np.int64)
    if broadcast_path:
        tsPartitionVal = None   # the broadcast join never buckets
    if tsPartitionVal is not None:
        l_bracket, _ = _time_brackets(l_ts_ns, tsPartitionVal)
        r_bracket, r_rem = _time_brackets(r_ts_ns, tsPartitionVal)
        spill = r_rem >= (1.0 - fraction)
        r_take = np.concatenate([r_take, r_take[spill]])
        r_bracket = np.concatenate([r_bracket, r_bracket[spill] + tsPartitionVal])
        l_codes_j, r_codes_j, n_series = _joint_bracket_codes(
            l_codes, r_codes[r_take], l_bracket, r_bracket)
        r_ts_j = r_ts_ns[r_take]
        r_seq_j = r_seq_vals[r_take] if r_seq_vals is not None else None
    else:
        n_series = len(key_frame)
        l_codes_j, r_codes_j = l_codes, r_codes
        r_ts_j = r_ts_ns
        r_seq_j = r_seq_vals

    auto_bracketed = False
    join_engine = "single"
    if tsPartitionVal is None and not broadcast_path \
            and len(left.df) and len(right.df):
        limit = profiling.max_merged_lanes()
        est = _estimate_merged_lanes(l_codes, r_codes, n_series)
        if 0 < limit < est or profiling.join_engine_override():
            join_engine = profiling.pick_join_engine(
                est, limit, chunked_ok=est < (1 << 24))
        _check_engine(join_engine, device)
        if join_engine == "bracket" and not max_lookback:
            carry_cols = right_value_cols if skipNulls else []
            masks = (np.stack([right_valid[c] for c in carry_cols])
                     if carry_cols else np.zeros((0, len(right.df)), bool))
            plan = _auto_bracket(l_codes, l_ts_ns, r_codes, r_ts_ns,
                                 r_seq_vals, n_series, est, limit, masks)
            if plan is not None:
                l_b, r_take, r_bracket_all = plan
                l_codes_j, r_codes_j, n_series = _joint_bracket_codes(
                    l_codes, r_codes[r_take], l_b, r_bracket_all)
                r_ts_j = r_ts_ns[r_take]
                r_seq_j = r_seq_vals[r_take] if r_seq_vals is not None else None
                auto_bracketed = True

    l_layout = packing.build_layout_from_codes(l_codes_j, l_ts_ns, None,
                                               n_series)
    r_layout = packing.build_layout_from_codes(r_codes_j, r_ts_j, r_seq_j,
                                               n_series)
    r_sorted_take = r_take[r_layout.order]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    use_binpack = (not broadcast_path and tsPartitionVal is None
                   and n_series > 1 and _binpack_worthwhile(l_layout, r_layout))
    keep_mask = None
    if use_binpack:
        last_row_idx, per_col_idx, bp = _binpacked_indices(
            right, l_layout, r_layout, r_sorted_take,
            right_value_cols if skipNulls else [], device,
            max_lookback=max_lookback,
            r_seq_sorted=(r_seq_j[r_layout.order]
                          if r_seq_j is not None else None))
    else:
        Ll = packing.pad_length(int(l_layout.lengths.max(initial=0)))
        Lr = packing.pad_length(int(r_layout.lengths.max(initial=0)))
        l_ts_p = up(packing.pack_column(l_layout.ts_ns, l_layout, Ll,
                                        fill=packing.TS_PAD))
        r_ts_p = up(packing.pack_column(r_layout.ts_ns, r_layout, Lr,
                                        fill=packing.TS_PAD))
        r_valids = up(np.stack([
            packing.pack_column(right_valid[c][r_sorted_take], r_layout, Lr,
                                fill=False)
            for c in right_value_cols]) if right_value_cols
            else np.zeros((0, n_series, Lr), bool))
        if broadcast_path:
            idx, matched = asof_ops.asof_indices_inner(l_ts_p, r_ts_p)
            last_row_idx, per_col_idx = idx.cpu().numpy(), None
            keep_mask = matched.cpu().numpy()
        else:
            # the reference's 'merge' and 'searchsorted' strategies
            # compute the same indices: both run the merge kernel
            r_seq_p = (up(packing.pack_column(
                r_seq_j[r_layout.order], r_layout, Lr, fill=np.inf))
                if r_seq_j is not None else None)
            last, per_col = asof_ops.asof_indices_merge(
                l_ts_p, None, r_ts_p, r_seq_p, r_valids,
                n_cols=len(right_value_cols), max_lookback=max_lookback)
            last_row_idx, per_col_idx = last.cpu().numpy(), per_col.cpu().numpy()

    # --- flatten back to left row coordinates -------------------------
    pos = np.arange(l_layout.n_rows) - l_layout.starts[l_layout.key_ids]
    k_ids = l_layout.key_ids

    def flat_right_indices(packed_idx):
        if use_binpack:
            ridx = packed_idx[bp.row[k_ids], bp.l_off[k_ids] + pos]
            ok = ridx >= 0
            within = np.where(ok, ridx - bp.r_off[k_ids], 0)
        else:
            ridx = packed_idx[k_ids, pos]
            ok = ridx >= 0
            within = np.where(ok, ridx, 0)
        return r_layout.starts[k_ids] + within, ok

    out = {}
    left_sorted = left.df.iloc[l_layout.order].reset_index(drop=True)
    for c in pcols:
        out[c] = left_sorted[c].to_numpy()
    for c in left_value_cols:
        out[lmap[c]] = left_sorted[c].to_numpy()
    r_sorted_df = right.df.iloc[r_sorted_take].reset_index(drop=True)
    row_level = broadcast_path or not skipNulls
    for ci, c in enumerate(right_value_cols):
        flat, ok = flat_right_indices(last_row_idx if row_level
                                      else per_col_idx[ci])
        vals = r_sorted_df[c].to_numpy()
        if not skipNulls and not broadcast_path:
            # the last right row's value, nulls included (tsdf.py:123-136)
            col_valid = (~pd.isna(r_sorted_df[c])).to_numpy()
            ok = ok & col_valid[np.where(ok, flat, 0)]
        out[rmap[c]] = _gather(vals, flat, ok)
        if tsPartitionVal is not None and not suppress_null_warning \
                and (~ok).any():
            logger.warning(
                "Column " + rmap[c] + " had no values within the lookback "
                "window. Consider using a larger window to avoid missing "
                "values. If this is the first record in the data frame, "
                "this warning can be ignored.")

    res = pd.DataFrame(out)
    if broadcast_path:
        res = res[keep_mask[k_ids, pos]].reset_index(drop=True)
    if tsPartitionVal is not None or auto_bracketed:
        # restore the (key, ts) row order of the unbracketed join
        perm = np.lexsort((l_ts_ns[l_layout.order], l_codes[l_layout.order]))
        res = res.iloc[perm].reset_index(drop=True)
    return left._with_df(res, ts_col=lmap[left.ts_col], partition_cols=pcols)
