"""AS-OF merge join and batched searchsorted on packed [K, L] series:
the CUDA kernels and their plain versions.

Counterpart of ``tempo_tpu/ops/pallas_merge.py``:

* ``asof_merge``: the Pallas kernel ``_make_kernel`` (through
  ``_merge_call``) behind ``asof_merge_values_pallas`` and
  ``asof_merge_indices_pallas``, including the sequence re-encoding of
  ``seq_kernel_form``; the kernel walks each row's merged stream in
  steps of ``cuda_lib.asof_walk_step()`` positions with each column's
  carry (``asof_merge_walk_plain`` runs that design on the CPU), and
  calls with fewer rows than ``WALK_ROWS_PER_SM`` a streaming
  multiprocessor (or more than ``cuda_lib.asof_walk_cols()`` right
  columns) go to the lookback kernel's tiles at ``max_lookback = 0``
  instead;
* ``asof_merge_lookback``: ``_make_chunked_kernel`` (through
  ``_chunked_call``) behind ``asof_merge_values_chunked`` and
  ``asof_merge_indices_chunked``, the join with Scala's ``maxLookback``
  horizon; the TPU's merged-lane chunks, carried in sequence, become
  parallel merge-path tiles with a look-back carry
  (``asof_merge_lookback_tiled_plain`` runs that design on the CPU);
* ``merge_rank``: ``_make_rank_kernel`` (through ``_rank_call``) behind
  ``merge_rank_pallas``; the TPU's merge network becomes merge-path tiles
  of ``RANK_TILE`` merged positions, ``RANK_PER`` a thread
  (``merge_rank_tiled_plain`` runs that design on the CPU);
* ``asof_carry_init``: the chunked kernel's carry as named arrays, the
  serving steps' join state.

For every left row, the last right row at or before it in the total
order (sid?, ts, seq?, side): right rows win full ties (the reference's
rec_ind -1 < 1, tsdf.py:119,546).  ``skip_nulls`` takes each column's
last valid row independently (tsdf.py:139); otherwise every column
comes from the single last right row, nulls included (tsdf.py:123-136).
With ``l_sid``/``r_sid`` (bin-packed rows, several series back to back
in ascending sid) a row of another series never matches.  A right row
counts as valid for a column when its validity bit is set and its
value is not NaN, as in the kernel's NaN-encoded payload.

REQUIRES both sides ascending per row in (sid?, ts, seq?), the packed
layout invariant.  Indices are int32 positions within the right row,
-1 where none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tempo_tpu_torch.ops import cuda_lib, window_utils

_I32_MIN = -(2**31)
_I64_MIN = -(2**63)
#: merged positions a tile of the lookback kernel (``csrc/asof_merge.cu``
#: kTileMax)
LOOKBACK_TILE = 1024
#: rows a streaming multiprocessor below which the merge join runs on
#: the lookback kernel's tiles (a row walk is one block a row)
WALK_ROWS_PER_SM = 3
#: merged positions a block of the rank kernel, and a thread
#: (``csrc/merge_rank.cu`` kRankTile, kRankPer)
RANK_TILE, RANK_PER = 2048, 8


def seq_kernel_form(seq: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A float64 sequence plane re-encoded as the TPU kernel takes it
    (pallas_merge.seq_kernel_form): float32 when every value round-trips
    exactly (±inf included), else int64 when every finite value is
    integral and below 2^62 (±inf to the int64 extremes), else None.
    Other dtypes pass through."""
    if seq is None or seq.dtype != np.float64:
        return seq
    f32 = seq.astype(np.float32)
    if np.array_equal(f32.astype(np.float64), seq):
        return f32
    finite = np.isfinite(seq)
    af = seq[finite]
    if np.array_equal(af, np.floor(af)) and (
            af.size == 0 or np.abs(af).max() < 2.0**62):
        i = np.where(finite, seq, 0.0).astype(np.int64)
        i = np.where(seq == np.inf, np.iinfo(np.int64).max, i)
        return np.where(seq == -np.inf, np.iinfo(np.int64).min, i)
    return None


def _order_key(seq: torch.Tensor) -> torch.Tensor:
    """int64 plane ordering exactly like ``seq`` (floats by the IEEE
    sign-fold the kernel's key planes use; NaN is excluded upstream)."""
    if seq.dtype == torch.float32:
        b = seq.contiguous().view(torch.int32)
        return torch.where(b >= 0, b, _I32_MIN - b).to(torch.int64)
    if seq.dtype == torch.float64:
        b = seq.contiguous().view(torch.int64)
        return torch.where(b >= 0, b, _I64_MIN - b)
    if seq.dtype in (torch.int32, torch.int64):
        return seq.to(torch.int64)
    raise TypeError(f"unsupported sequence dtype {seq.dtype}")


def _kernel_seq(seq: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if seq is None or seq.dtype != torch.float64:
        return seq
    form = seq_kernel_form(seq.cpu().numpy())
    return seq if form is None else torch.from_numpy(form).to(seq.device)


def seq_keys(l_seq, r_seq, l_shape, r_shape):
    """(l_key, r_key) int64 order planes of the sequence tie-break, or
    (None, None).  A missing side sits at the present dtype's minimum:
    above the -inf null-seq encoding, below every real value (Spark ASC
    NULLS FIRST with rec_ind, tsdf.py:117-121) — the kernel's
    ``_seq_sides``."""
    if l_seq is None and r_seq is None:
        return None, None
    l_seq, r_seq = _kernel_seq(l_seq), _kernel_seq(r_seq)
    present = l_seq if l_seq is not None else r_seq
    dt = present.dtype
    neg = torch.finfo(dt).min if dt.is_floating_point else torch.iinfo(dt).min
    if l_seq is None:
        l_seq = torch.full(l_shape, neg, dtype=dt, device=present.device)
    if r_seq is None:
        r_seq = torch.full(r_shape, neg, dtype=dt, device=present.device)
    pdt = torch.promote_types(l_seq.dtype, r_seq.dtype)
    return _order_key(l_seq.to(pdt)), _order_key(r_seq.to(pdt))


def _right_valid(r_valids, r_values):
    if r_values is None:
        return r_valids
    return r_valids & ~torch.isnan(r_values)


def _merged_order(l_ts, r_ts, l_sid=None, r_sid=None, l_key=None,
                  r_key=None) -> torch.Tensor:
    """[K, Ll + Lr] lanes (left first, then right) in merged order: a
    stable lexsort by (sid?, ts, seq?, side), right before left on full
    ties, each side keeping its lane order."""
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    dev = l_ts.device
    keys: List[torch.Tensor] = []
    if l_sid is not None:
        keys.append(torch.cat([l_sid, r_sid], -1).to(torch.int64))
    keys.append(torch.cat([l_ts, r_ts], -1))
    if l_key is not None:
        keys.append(torch.cat([l_key, r_key], -1))
    keys.append(torch.cat([torch.ones(K, Ll, dtype=torch.int64, device=dev),
                           torch.zeros(K, Lr, dtype=torch.int64, device=dev)],
                          -1))
    # least significant key first; the initial order keeps each side's
    # own lane order on full ties
    order = torch.arange(Ll + Lr, device=dev).expand(K, -1)
    for key in reversed(keys):
        perm = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        order = torch.gather(order, 1, perm)
    return order


def _fence(idx, l_sid, r_sid):
    """-1 where a right row index belongs to another series than its left
    row (bin-packed rows); ``idx`` unchanged without sids."""
    if l_sid is None:
        return idx
    got = torch.gather(r_sid, 1, idx.clamp(min=0))
    return torch.where((idx >= 0) & (got == l_sid), idx, -1)


def _gather_values(r_values, col_idx):
    """[C, K, Ll] right values at ``col_idx``, NaN where it is -1."""
    if r_values is None:
        return None
    C, K, Ll = col_idx.shape
    if not C:
        return torch.zeros(0, K, Ll, dtype=r_values.dtype,
                           device=r_values.device)
    nan = torch.tensor(float("nan"), dtype=r_values.dtype,
                       device=r_values.device)
    idx = col_idx.to(torch.int64)
    return torch.where(idx >= 0,
                       torch.gather(r_values, 2, idx.clamp(min=0)), nan)


def _stack_cols(cols, K, Ll, dev):
    return (torch.stack(cols) if cols else
            torch.zeros(0, K, Ll, dtype=torch.int64, device=dev))


def asof_merge_plain(l_ts, r_ts, r_valids, r_values=None, l_sid=None,
                     r_sid=None, l_key=None, r_key=None,
                     skip_nulls: bool = True):
    """The join as tensor code: a stable lexsort merge of both sides,
    a running max of the right position over the merged stream, and
    per-column last-valid scans.  Returns ``(last_idx [K, Ll],
    col_idx [C, K, Ll], vals [C, K, Ll] or None)``."""
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    dev = l_ts.device
    order = _merged_order(l_ts, r_ts, l_sid, r_sid, l_key, r_key)
    is_right = order >= Ll
    ridx = torch.where(is_right, order - Ll, -1)
    last_m = torch.cummax(ridx, dim=1).values
    left_slots = order[~is_right].view(K, Ll)
    last = torch.empty(K, Ll, dtype=torch.int64, device=dev)
    last.scatter_(1, left_slots, last_m[~is_right].view(K, Ll))
    last = _fence(last, l_sid, r_sid)
    rvalid = _right_valid(r_valids, r_values)
    lane = torch.arange(Lr, device=dev)
    cols = []
    for c in range(r_valids.shape[0]):
        if skip_nulls:
            scan = torch.cummax(torch.where(rvalid[c], lane, -1), dim=1).values
            j = torch.where(last >= 0,
                            torch.gather(scan, 1, last.clamp(min=0)), -1)
            j = _fence(j, l_sid, r_sid)
        else:
            ok = torch.gather(rvalid[c], 1, last.clamp(min=0))
            j = torch.where((last >= 0) & ok, last, -1)
        cols.append(j)
    col_idx = _stack_cols(cols, K, Ll, dev)
    return (last.to(torch.int32), col_idx.to(torch.int32),
            _gather_values(r_values, col_idx))


def _join_cuda(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key,
               skip_nulls, max_lookback=None, tile=None, form=None):
    """Check the operands and launch the merge kernel's row walk, or the
    lookback kernel over tiles of ``tile`` merged positions: with
    ``max_lookback`` given, or at 0 for a merge join of too few rows to
    fill the card by a block a row (counted as ``asof_merge``).  A merge
    join's ``form`` ("walk" or "tiles") overrides that pick."""
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    C = r_valids.shape[0]
    dev = l_ts.device
    parts = [l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key]
    if any(p is not None and p.device != dev for p in parts) \
            or dev.type != "cuda":
        raise ValueError("merge kernel operands must lie on one CUDA device")
    if l_ts.dtype != torch.int64 or r_ts.dtype != torch.int64 \
            or r_ts.shape[0] != K:
        raise TypeError("merge kernel takes int64 [K, Ll] / [K, Lr] ts")
    if r_valids.dtype != torch.bool or tuple(r_valids.shape) != (C, K, Lr):
        raise TypeError("r_valids must be bool [C, K, Lr]")
    if r_values is not None and (r_values.dtype != torch.float32
                                 or r_values.shape != r_valids.shape):
        raise TypeError("merge kernel takes float32 [C, K, Lr] values")
    if (l_sid is None) != (r_sid is None) or (l_key is None) != (r_key is None):
        raise ValueError("sid and sequence planes come in left/right pairs")
    if l_sid is not None and (l_sid.dtype != torch.int32
                              or r_sid.dtype != torch.int32):
        raise TypeError("sid planes must be int32")
    l_ts, r_ts, r_valids = (t.contiguous() for t in (l_ts, r_ts, r_valids))
    opt = lambda t: None if t is None else t.contiguous()
    r_values, l_sid, r_sid, l_key, r_key = map(
        opt, (r_values, l_sid, r_sid, l_key, r_key))
    last = torch.empty(K, Ll, dtype=torch.int32, device=dev)
    col_idx = torch.empty(C, K, Ll, dtype=torch.int32, device=dev)
    vals = (torch.empty(C, K, Ll, dtype=torch.float32, device=dev)
            if r_values is not None else None)
    if K and Ll:
        p = cuda_lib.ptr
        head = (p(l_ts), p(r_ts), p(l_sid), p(r_sid), p(l_key), p(r_key),
                p(r_valids), p(r_values))
        tail = (p(last), p(col_idx), p(vals), K, Ll, Lr, C,
                int(bool(skip_nulls)))
        if max_lookback is None and form is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            form = ("walk" if K >= WALK_ROWS_PER_SM * sms
                    and C <= cuda_lib.asof_walk_cols()
                    else "tiles")
        if form == "walk":
            if C > cuda_lib.asof_walk_cols():
                raise ValueError(f"the merge kernel's row walk takes at most "
                                 f"{cuda_lib.asof_walk_cols()} right "
                                 f"columns, got {C}")
            cuda_lib.launch("asof_merge", dev, "tempo_asof_merge", *head,
                            *tail)
        else:
            # few rows: the lookback kernel's tiles at max_lookback = 0
            # (the same join); positions stay below Ll + Lr < 2^31, so a
            # wider horizon caps nothing, as the plain version's windows
            # clamp to the row
            counter = "asof_merge" if max_lookback is None else \
                "asof_merge_lookback"
            ml = min(max_lookback or 0, 2**31 - 1)
            tile = tile or LOOKBACK_TILE
            # per tile: its split and the position of the right row before
            # it; per (column, tile): the carry-in and its position
            ntiles = -(-(Ll + Lr) // tile)
            split = torch.empty(2, K, ntiles + 1, dtype=torch.int32,
                                device=dev)
            carry = (torch.empty(2, C, K, ntiles, dtype=torch.int32,
                                 device=dev) if skip_nulls and C else None)
            cuda_lib.launch(counter, dev,
                            "tempo_asof_merge_lookback", *head, p(split),
                            p(carry), *tail, ml, tile)
    return last, col_idx, vals


def asof_merge_cuda(l_ts, r_ts, r_valids, r_values=None, l_sid=None,
                    r_sid=None, l_key=None, r_key=None,
                    skip_nulls: bool = True, _form=None):
    """Launch the merge kernel (the row walk, or the lookback tiles for
    few rows); same contract as :func:`asof_merge_plain`, with float32
    values.  ``_form`` ("walk" or "tiles") forces a form, for tests and
    ``chip_smoke.py``."""
    if _form not in (None, "walk", "tiles"):
        raise ValueError(f"merge form must be 'walk' or 'tiles', got "
                         f"{_form!r}")
    return _join_cuda(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key,
                      r_key, skip_nulls, form=_form)


def asof_merge(l_ts, r_ts, r_valids, r_values=None, l_sid=None, r_sid=None,
               l_seq=None, r_seq=None, skip_nulls: bool = True):
    """The join on either device: ``(last_idx, col_idx, vals or None)``;
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    l_key, r_key = seq_keys(l_seq, r_seq, tuple(l_ts.shape),
                            tuple(r_ts.shape))
    fn = asof_merge_cuda if l_ts.is_cuda else asof_merge_plain
    return fn(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key,
              skip_nulls=skip_nulls)


def asof_merge_values(l_ts, r_ts, r_valids, r_values, l_sid=None,
                      r_sid=None, l_seq=None, r_seq=None,
                      skip_nulls: bool = True):
    """``(vals [C, K, Ll], found [C, K, Ll], last_row_idx [K, Ll])``, the
    contract of ``pallas_merge.asof_merge_values_pallas``."""
    last, col_idx, vals = asof_merge(l_ts, r_ts, r_valids, r_values, l_sid,
                                     r_sid, l_seq, r_seq, skip_nulls)
    return vals, col_idx >= 0, last


def asof_merge_indices(l_ts, r_ts, r_valids, l_sid=None, r_sid=None,
                       l_seq=None, r_seq=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(last_row_idx [K, Ll], per_col_idx [C, K, Ll])`` with skipNulls
    semantics, the contract of ``pallas_merge.asof_merge_indices_pallas``
    (with ``l_sid``/``r_sid``, of the reference's bin-packed index form,
    ``sortmerge.asof_indices_binpacked``)."""
    last, col_idx, _ = asof_merge(l_ts, r_ts, r_valids, None, l_sid, r_sid,
                                  l_seq, r_seq, True)
    return last, col_idx


def asof_carry_init(n_cols: int, n_series: int):
    """The AS-OF join's carry as named numpy arrays, for callers that
    thread the fill state through steps of their own (the serving steps,
    ``serve/state.py``); the reference's ``pallas_merge.asof_carry_init``,
    names, shapes, dtypes and initial values included.  Per series ``k``:

    * ``last_val [C, K] f32``: last valid right value per column (NaN:
      none yet), the per-column ``skipNulls=True`` fill;
    * ``last_src [C, K] i64``: its merged-stream position (far negative,
      so any horizon has expired);
    * ``lock_val [C, K] f32`` / ``lock_valid [C, K] bool`` / ``lock_src
      [K] i64``: the single last right row's values, validity and merged
      position, the lockstep ``skipNulls=False`` fill;
    * ``last_ridx [K] i64``: that row's index within the right side (-1:
      none);
    * ``n_merged [K] i64``: merged positions consumed, both sides.

    Fills select values and compute none, so a carry threaded across any
    split of the stream gives the batch join's bits."""
    C, K = int(n_cols), int(n_series)
    far = np.int64(-(1 << 62))
    return {
        "last_val": np.full((C, K), np.nan, np.float32),
        "last_src": np.full((C, K), far, np.int64),
        "lock_val": np.full((C, K), np.nan, np.float32),
        "lock_valid": np.zeros((C, K), bool),
        "lock_src": np.full((K,), far, np.int64),
        "last_ridx": np.full((K,), -1, np.int64),
        "n_merged": np.zeros((K,), np.int64),
    }


def _check_lookback(max_lookback) -> int:
    ml = int(max_lookback)
    if ml < 0:
        raise ValueError(f"max_lookback must be >= 0, got {ml}")
    return ml


def asof_merge_lookback_plain(l_ts, r_ts, r_valids, max_lookback: int,
                              r_values=None, l_sid=None, r_sid=None,
                              l_key=None, r_key=None,
                              skip_nulls: bool = True):
    """The join capped by Scala's ``maxLookback`` (asofJoin.scala:64-88)
    as tensor code: a match must lie within the trailing
    ``max_lookback + 1`` rows of the merged left+right stream, by a
    windowed running max of the right position over the merged stream
    (the reference's argmax ladder, ``sortmerge.py:300-316``).  0 turns
    the cap off (:func:`asof_merge_plain`).  Same outputs as
    :func:`asof_merge_plain`."""
    ml = _check_lookback(max_lookback)
    if ml == 0:
        return asof_merge_plain(l_ts, r_ts, r_valids, r_values, l_sid, r_sid,
                                l_key, r_key, skip_nulls)
    K, Ll = l_ts.shape
    dev = l_ts.device
    order = _merged_order(l_ts, r_ts, l_sid, r_sid, l_key, r_key)
    is_right = order >= Ll
    ridx = torch.where(is_right, order - Ll, -1)
    left = ~is_right
    left_slots = order[left].view(K, Ll)

    def to_left(merged):
        out = torch.empty(K, Ll, dtype=torch.int64, device=dev)
        out.scatter_(1, left_slots, merged[left].view(K, Ll))
        return out

    win = ml + 1
    last = _fence(to_left(window_utils.windowed_max_last(ridx, win)), l_sid,
                  r_sid)
    rvalid = _right_valid(r_valids, r_values)
    cols = []
    for c in range(r_valids.shape[0]):
        if skip_nulls:
            ok = torch.gather(rvalid[c], 1, ridx.clamp(min=0)) & is_right
            j = _fence(to_left(window_utils.windowed_max_last(
                torch.where(ok, ridx, -1), win)), l_sid, r_sid)
        else:
            ok = torch.gather(rvalid[c], 1, last.clamp(min=0))
            j = torch.where((last >= 0) & ok, last, -1)
        cols.append(j)
    col_idx = _stack_cols(cols, K, Ll, dev)
    return (last.to(torch.int32), col_idx.to(torch.int32),
            _gather_values(r_values, col_idx))


def _right_first(r, l):
    """Whether right keys ``r`` come before left keys ``l`` (each a
    (sid or None, ts, seq key or None) triple of like-shaped tensors) in
    the merged order: right wins full ties."""
    r_sid, r_ts, r_key = r
    l_sid, l_ts, l_key = l
    tie = r_ts == l_ts
    if r_key is not None:
        tie = tie & (r_key <= l_key)
    first = (r_ts < l_ts) | tie
    if r_sid is not None:
        first = torch.where(r_sid != l_sid, r_sid < l_sid, first)
    return first


def _keys_at(keys, idx):
    """The (sid, ts, seq) triple of a [K, L] side at [K, n] indices
    (clamped into the row)."""
    n = keys[1].shape[-1]
    at = idx.clamp(0, max(n - 1, 0))
    return tuple(None if k is None else torch.gather(k, 1, at) for k in keys)


def _first_false(lo, hi, pred):
    """Per element, the first m in [lo, hi) with ``pred(m)`` False
    (``pred`` True on a prefix), by a binary search."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        ok = pred(mid)
        lo = torch.where(active & ok, mid + 1, lo)
        hi = torch.where(active & ~ok, mid, hi)
    return lo


def asof_merge_lookback_tiled_plain(l_ts, r_ts, r_valids, max_lookback: int,
                                    r_values=None, l_sid=None, r_sid=None,
                                    l_key=None, r_key=None,
                                    skip_nulls: bool = True,
                                    tile: int = LOOKBACK_TILE):
    """:func:`asof_merge_lookback_plain`'s outputs by the lookback
    kernel's merge-path tiles, as tensor code: each tile of ``tile``
    merged positions finds its split by a co-rank search on its
    diagonals, ranks its left and right rows against the other side's
    slice alone (so merged positions come from the tile), and for
    skipNulls takes each column's last valid right row before it from
    an exclusive running max of the tiles' aggregates (the look-back
    carry)."""
    ml = _check_lookback(max_lookback)
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    C = r_valids.shape[0]
    dev = l_ts.device
    total = Ll + Lr
    nt = -(-total // tile)
    lk, rk = (l_sid, l_ts, l_key), (r_sid, r_ts, r_key)
    row = lambda n: torch.arange(n, device=dev).expand(K, n)
    # the splits: left rows among the first d merged positions
    d = (torch.arange(nt + 1, device=dev) * tile).clamp(max=total).expand(K, -1)
    split = _first_false(
        (d - Lr).clamp(min=0), d.clamp(max=Ll),
        lambda m: ~_right_first(_keys_at(rk, d - 1 - m), _keys_at(lk, m)))
    d_right = d - split                        # right rows before each diagonal
    # each left row's tile, and its right rows before it inside the tile
    li = row(Ll)
    ql = torch.searchsorted(split.contiguous(), li.contiguous(),
                            right=True) - 1
    j_lo_l = torch.gather(d_right, 1, ql)
    j_hi_l = torch.gather(d_right, 1, ql + 1)
    lkeys = _keys_at(lk, li)
    lo = _first_false(j_lo_l, j_hi_l,
                      lambda m: _right_first(_keys_at(rk, m), lkeys))
    # each right row's tile, and the left rows strictly before it there
    rj = row(Lr)
    qr = torch.searchsorted(d_right.contiguous(), rj.contiguous(),
                            right=True) - 1
    rkeys = _keys_at(rk, rj)
    lb = _first_false(torch.gather(split, 1, qr),
                      torch.gather(split, 1, qr + 1),
                      lambda m: ~_right_first(rkeys, _keys_at(lk, m)))
    rpos = rj + lb
    pos = li + lo

    def stale(j):
        return (ml > 0) & (pos - torch.gather(rpos, 1, j.clamp(min=0)) > ml)

    def other(j):
        if l_sid is None:
            return torch.zeros_like(j, dtype=torch.bool)
        return torch.gather(r_sid, 1, j.clamp(min=0)) != l_sid

    base = lo - 1
    base = torch.where((base >= 0) & other(base), -1, base)
    last = torch.where((base >= 0) & stale(base), -1, base)
    rvalid = _right_valid(r_valids, r_values)
    cols = []
    for c in range(C):
        if skip_nulls:
            cand = torch.where(rvalid[c], rj, -1)
            agg = torch.full((K, nt), -1, dtype=cand.dtype, device=dev)
            agg = agg.scatter_reduce(1, qr, cand, "amax")
            carry = torch.cat([torch.full((K, 1), -1, dtype=agg.dtype,
                                          device=dev),
                               torch.cummax(agg, 1).values[:, :-1]], 1)
            run = torch.cummax(cand, 1).values
            run = torch.where(run >= torch.gather(d_right, 1, qr), run, -1)
            lv = torch.maximum(torch.gather(carry, 1, qr), run)
            j = torch.where(base >= j_lo_l,
                            torch.gather(lv, 1, base.clamp(min=0)),
                            torch.gather(carry, 1, ql))
            j = torch.where(base >= 0, j, -1)
            j = torch.where((j >= 0) & (other(j) | stale(j)), -1, j)
        else:
            ok = torch.gather(rvalid[c], 1, last.clamp(min=0))
            j = torch.where((last >= 0) & ok, last, -1)
        cols.append(j)
    col_idx = _stack_cols(cols, K, Ll, dev)
    return (last.to(torch.int32), col_idx.to(torch.int32),
            _gather_values(r_values, col_idx))


def asof_merge_walk_plain(l_ts, r_ts, r_valids, r_values=None, l_sid=None,
                          r_sid=None, l_key=None, r_key=None,
                          skip_nulls: bool = True, step: int = 1024):
    """:func:`asof_merge_plain`'s outputs by the merge kernel's row walk,
    as tensor code: every row walks its merged stream in steps of
    ``step`` positions (the kernel's is ``cuda_lib.asof_walk_step()``;
    the result does not depend on it) from (i_lo, j_lo), the left and
    right rows before the step, ranking the step's positions against the
    next ``step`` rows of each side alone (a co-rank search at each
    position); each column's last valid right row before the step is the
    carry, and a running max over the step's right rows from it gives
    each left row its last valid row.  The walk of a row ends with its
    last left row."""
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    C = r_valids.shape[0]
    dev = l_ts.device
    lk, rk = (l_sid, l_ts, l_key), (r_sid, r_ts, r_key)
    rvalid = _right_valid(r_valids, r_values)
    i64 = dict(dtype=torch.int64, device=dev)
    # one spare slot a row takes the writes of positions that are none
    last = torch.full((K, Ll + 1), -1, **i64)
    cols = torch.full((C, K, Ll + 1), -1, **i64)
    carry = torch.full((C, K), -1, **i64)
    i_lo = torch.zeros(K, **i64)
    j_lo = torch.zeros(K, **i64)
    pos = torch.arange(step + 1, **i64)
    rc = lambda t: t.clamp(0, max(Lr - 1, 0))   # a gather's right row
    if not Lr:
        i_lo = torch.full_like(i_lo, Ll)        # no right rows: all -1
    while bool((i_lo < Ll).any()):
        live = i_lo < Ll
        nla = (Ll - i_lo).clamp(max=step)
        nra = (Lr - j_lo).clamp(max=step)
        n = torch.where(live, torch.clamp(nla + nra, max=step), 0)[:, None]
        P = torch.minimum(pos.expand(K, -1), n)
        li = _first_false(
            (P - nra[:, None]).clamp(min=0), torch.minimum(P, nla[:, None]),
            lambda m: ~_right_first(_keys_at(rk, j_lo[:, None] + P - 1 - m),
                                    _keys_at(lk, i_lo[:, None] + m)))
        nl = torch.gather(li, 1, n)[:, 0]
        nr = n[:, 0] - nl
        q = pos[:step].expand(K, -1)
        is_left = (q < n) & (li[:, 1:] > li[:, :-1])
        e = li[:, :-1]                              # left row of position q
        at = torch.where(is_left, i_lo[:, None] + e, Ll)
        base = j_lo[:, None] + q - e - 1            # its last right row
        if l_sid is not None:
            l_s = torch.gather(l_sid, 1, at.clamp(max=Ll - 1))
            other = torch.gather(r_sid, 1, rc(base)) != l_s
            base = torch.where((base >= 0) & other, -1, base)
        last.scatter_(1, at, torch.where(is_left, base, -1))
        # the step's right rows j_lo + m, m < nr
        rj = j_lo[:, None] + q
        in_step = q < nr[:, None]
        for c in range(C):
            if skip_nulls:
                ok = torch.gather(rvalid[c], 1, rc(rj))
                cand = torch.where(in_step & ok, rj, -1)
                lv = torch.maximum(torch.cummax(cand, 1).values,
                                   carry[c][:, None])
                j = torch.where(base >= j_lo[:, None],
                                torch.gather(lv, 1, (base - j_lo[:, None])
                                             .clamp(min=0)),
                                carry[c][:, None])
                j = torch.where(base >= 0, j, -1)
                if l_sid is not None:
                    other = torch.gather(r_sid, 1, rc(j)) != l_s
                    j = torch.where((j >= 0) & other, -1, j)
                carry[c] = torch.maximum(carry[c], cand.max(1).values)
            else:
                ok = torch.gather(rvalid[c], 1, rc(base))
                j = torch.where((base >= 0) & ok, base, -1)
            cols[c].scatter_(1, at, torch.where(is_left, j, -1))
        i_lo = i_lo + nl
        j_lo = j_lo + nr
    last = last[:, :Ll]
    col_idx = cols[..., :Ll]
    return (last.to(torch.int32), col_idx.to(torch.int32),
            _gather_values(r_values, col_idx))


def asof_merge_lookback_cuda(l_ts, r_ts, r_valids, max_lookback: int,
                             r_values=None, l_sid=None, r_sid=None,
                             l_key=None, r_key=None,
                             skip_nulls: bool = True,
                             _tile: int = LOOKBACK_TILE):
    """Launch the lookback kernel (any ``max_lookback``, 0 included);
    same contract as :func:`asof_merge_lookback_plain`, with float32
    values.  ``_tile`` (1 to ``LOOKBACK_TILE`` merged positions) is for
    tests that put tile edges inside small cases."""
    if not 1 <= _tile <= LOOKBACK_TILE:
        raise ValueError(f"lookback tile must be 1..{LOOKBACK_TILE}, got "
                         f"{_tile}")
    return _join_cuda(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key,
                      r_key, skip_nulls, _check_lookback(max_lookback),
                      int(_tile))


def asof_merge_lookback(l_ts, r_ts, r_valids, max_lookback: int,
                        r_values=None, l_sid=None, r_sid=None, l_seq=None,
                        r_seq=None, skip_nulls: bool = True):
    """The ``maxLookback`` join on either device: ``(last_idx, col_idx,
    vals or None)``; the lookback kernel for CUDA tensors, the plain
    version for CPU tensors."""
    l_key, r_key = seq_keys(l_seq, r_seq, tuple(l_ts.shape),
                            tuple(r_ts.shape))
    fn = asof_merge_lookback_cuda if l_ts.is_cuda else asof_merge_lookback_plain
    return fn(l_ts, r_ts, r_valids, max_lookback, r_values, l_sid, r_sid,
              l_key, r_key, skip_nulls=skip_nulls)


def merge_rank_plain(sorted_keys: torch.Tensor, sorted_queries: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """``searchsorted`` of each query row into each key row, by a stable
    merge and a prefix count (both inputs ascending per row); int64
    ranks."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    K, Lk = sorted_keys.shape
    Lq = sorted_queries.shape[-1]
    dev = sorted_keys.device
    dt = torch.promote_types(sorted_keys.dtype, sorted_queries.dtype)
    vals = torch.cat([sorted_keys.to(dt), sorted_queries.to(dt)], -1)
    # side='left': queries sort before equal keys; 'right': after
    tq, tk = (0, 1) if side == "left" else (1, 0)
    tie = torch.cat([torch.full((K, Lk), tk, device=dev),
                     torch.full((K, Lq), tq, device=dev)], -1)
    order = torch.arange(Lk + Lq, device=dev).expand(K, -1)
    for key in (tie, vals):
        perm = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        order = torch.gather(order, 1, perm)
    is_key = (order < Lk).to(torch.int64)
    nkeys = torch.cumsum(is_key, dim=1)
    q_slots = order[order >= Lk].view(K, Lq) - Lk
    rank = torch.empty(K, Lq, dtype=torch.int64, device=dev)
    rank.scatter_(1, q_slots, nkeys[order >= Lk].view(K, Lq))
    return rank


def merge_rank_tiled_plain(sorted_keys: torch.Tensor,
                           sorted_queries: torch.Tensor, side: str = "left",
                           *, tile: int = RANK_TILE,
                           per_thread: int = RANK_PER) -> torch.Tensor:
    """:func:`merge_rank_plain`'s ranks by the rank kernel's merge-path
    tiles, as tensor code: in the merge that takes a key before a query
    iff key < query (side right: <=), each tile of ``tile`` merged
    positions finds the keys before its two diagonals by a co-rank
    search of the rows; each of its threads (``per_thread`` positions
    apart) co-ranks its own diagonal within the tile's key and query
    slices, then merges its positions in order, giving each query it
    passes the keys taken so far."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if tile % per_thread:
        raise ValueError("a tile must be whole threads")
    dt = torch.promote_types(sorted_keys.dtype, sorted_queries.dtype)
    keys, qs = sorted_keys.to(dt), sorted_queries.to(dt)
    K, Lk = keys.shape
    Lq = qs.shape[-1]
    dev = keys.device
    rank = torch.zeros(K, Lq + 1, dtype=torch.int64, device=dev)
    if Lk == 0 or Lq == 0 or K == 0:
        return rank[:, :Lq]
    right = side == "right"

    def key_first(m, j):
        """Whether key m goes before query j ([K, ...] row indices)."""
        kv = torch.gather(keys, 1, m.clamp(0, Lk - 1).reshape(K, -1))
        qv = torch.gather(qs, 1, j.clamp(0, Lq - 1).reshape(K, -1))
        return (kv <= qv if right else kv < qv).reshape(m.shape)

    n = Lk + Lq
    nt = -(-n // tile)
    d = (torch.arange(nt + 1, device=dev) * tile).clamp(max=n).expand(K, -1)
    cut = _first_false((d - Lq).clamp(min=0), d.clamp(max=Lk),
                       lambda m: key_first(m, d - 1 - m))     # [K, nt + 1]
    i0, j0 = cut[:, :-1, None], (d - cut)[:, :-1, None]       # [K, nt, 1]
    nk = cut[:, 1:, None] - i0
    nq = (d - cut)[:, 1:, None] - j0
    # each thread's first position in its tile, and its co-rank there
    p = torch.arange(0, tile, per_thread, device=dev).expand(K, nt, -1)
    live = p < nk + nq
    ki = _first_false((p - nq).clamp(min=0), torch.minimum(p, nk),
                      lambda m: key_first(i0 + m, j0 + p - 1 - m))
    qi = p - ki
    for _ in range(per_thread):
        has_k, has_q = ki < nk, qi < nq
        take_k = live & has_k & (~has_q | key_first(i0 + ki, j0 + qi))
        take_q = live & ~take_k & has_q
        at = torch.where(take_q, j0 + qi, Lq).reshape(K, -1)
        rank.scatter_(1, at, (i0 + ki).reshape(K, -1))
        ki = ki + take_k.long()
        qi = qi + take_q.long()
    return rank[:, :Lq].contiguous()


def merge_rank_cuda(sorted_keys: torch.Tensor, sorted_queries: torch.Tensor,
                    side: str = "left") -> torch.Tensor:
    """Launch the rank kernel on int32/int64 [K, Lk] / [K, Lq] CUDA
    tensors (promoted to one type, as ``merge_rank_pallas`` does); int64
    ranks.  One launch count covers the call's two kernels (the split
    pass, then the tiles)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    dev = sorted_keys.device
    if dev.type != "cuda" or sorted_queries.device != dev:
        raise ValueError("rank kernel operands must lie on one CUDA device")
    dt = torch.promote_types(sorted_keys.dtype, sorted_queries.dtype)
    if dt not in (torch.int32, torch.int64):
        raise TypeError(f"rank kernel takes int32/int64 operands, got {dt}")
    if sorted_keys.dim() != 2 or sorted_queries.dim() != 2 \
            or sorted_queries.shape[0] != sorted_keys.shape[0]:
        raise TypeError("rank kernel takes [K, Lk] keys and [K, Lq] queries")
    keys = sorted_keys.to(dt).contiguous()
    queries = sorted_queries.to(dt).contiguous()
    K, Lk = keys.shape
    Lq = queries.shape[-1]
    out = torch.empty(K, Lq, dtype=torch.int64, device=dev)
    if K and Lq:
        # the split pass's co-ranks: every tile's diagonals, then Lk + Lq
        ncuts = -(-(Lk + Lq) // RANK_TILE) + 1
        cuts = torch.empty(K, ncuts, dtype=torch.int32, device=dev)
        cuda_lib.launch("merge_rank", dev, "tempo_merge_rank",
                        keys.data_ptr(), queries.data_ptr(), out.data_ptr(),
                        cuts.data_ptr(), K, Lk, Lq, ncuts,
                        int(side == "right"), int(dt == torch.int64))
    return out
