"""AS-OF merge join on packed [K, L] series: the CUDA kernel and its
plain version.

Counterpart of ``tempo_tpu/ops/pallas_merge.py``: the Pallas kernel
``_make_kernel`` (through ``_merge_call``) behind
``asof_merge_values_pallas`` and ``asof_merge_indices_pallas``,
including the sequence re-encoding of ``seq_kernel_form``.

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

from tempo_tpu_torch.ops import cuda_lib

_I32_MIN = -(2**31)
_I64_MIN = -(2**63)


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
    keys: List[torch.Tensor] = []
    if l_sid is not None:
        keys.append(torch.cat([l_sid, r_sid], -1).to(torch.int64))
    keys.append(torch.cat([l_ts, r_ts], -1))
    if l_key is not None:
        keys.append(torch.cat([l_key, r_key], -1))
    side = torch.cat([torch.ones(K, Ll, dtype=torch.int64, device=dev),
                      torch.zeros(K, Lr, dtype=torch.int64, device=dev)], -1)
    keys.append(side)
    # least significant key first; the initial order keeps each side's
    # own lane order on full ties
    order = torch.arange(Ll + Lr, device=dev).expand(K, -1)
    for key in reversed(keys):
        perm = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        order = torch.gather(order, 1, perm)
    is_right = order >= Ll
    ridx = torch.where(is_right, order - Ll, -1)
    last_m = torch.cummax(ridx, dim=1).values
    left_slots = order[~is_right].view(K, Ll)
    last = torch.empty(K, Ll, dtype=torch.int64, device=dev)
    last.scatter_(1, left_slots, last_m[~is_right].view(K, Ll))

    def fence(idx):
        if l_sid is None:
            return idx
        got = torch.gather(r_sid, 1, idx.clamp(min=0))
        return torch.where((idx >= 0) & (got == l_sid), idx, -1)

    last = fence(last)
    C = r_valids.shape[0]
    rvalid = _right_valid(r_valids, r_values)
    lane = torch.arange(Lr, device=dev)
    cols = []
    for c in range(C):
        if skip_nulls:
            scan = torch.cummax(torch.where(rvalid[c], lane, -1), dim=1).values
            j = torch.where(last >= 0,
                            torch.gather(scan, 1, last.clamp(min=0)), -1)
            j = fence(j)
        else:
            ok = torch.gather(rvalid[c], 1, last.clamp(min=0))
            j = torch.where((last >= 0) & ok, last, -1)
        cols.append(j)
    col_idx = (torch.stack(cols) if C else
               torch.zeros(0, K, Ll, dtype=torch.int64, device=dev))
    vals = None
    if r_values is not None:
        nan = torch.tensor(float("nan"), dtype=r_values.dtype, device=dev)
        vals = torch.stack([
            torch.where(col_idx[c] >= 0,
                        torch.gather(r_values[c], 1,
                                     col_idx[c].clamp(min=0)), nan)
            for c in range(C)
        ]) if C else torch.zeros(0, K, Ll, dtype=r_values.dtype, device=dev)
    return last.to(torch.int32), col_idx.to(torch.int32), vals


def asof_merge_cuda(l_ts, r_ts, r_valids, r_values=None, l_sid=None,
                    r_sid=None, l_key=None, r_key=None,
                    skip_nulls: bool = True):
    """Launch the merge kernel; same contract as
    :func:`asof_merge_plain`, with float32 values."""
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
    scan = (torch.empty(C, K, Lr, dtype=torch.int32, device=dev)
            if skip_nulls and C else None)
    if K and Ll:
        p = cuda_lib.ptr
        code = cuda_lib.lib().tempo_asof_merge(
            p(l_ts), p(r_ts), p(l_sid), p(r_sid), p(l_key), p(r_key),
            p(r_valids), p(r_values), p(scan), p(last), p(col_idx), p(vals),
            K, Ll, Lr, C, int(bool(skip_nulls)), cuda_lib.stream_handle(dev))
        cuda_lib.check(code, "asof_merge")
    return last, col_idx, vals


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
