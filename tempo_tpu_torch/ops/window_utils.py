"""Window primitives.

Counterpart of the parts of ``tempo_tpu/ops/window_utils.py`` and
``tempo_tpu/ops/sortmerge.py:merge_rank`` that the windowed range engine,
the ``maxLookback`` join and interpolation need.  ``last_valid_index``
and ``first_valid_index`` reach the index-scan kernels of ``ops/scan``
on a CUDA tensor (any L) and their plain versions on a CPU tensor; the
rest is plain tensor code for the CPU engines, dtype-generic.
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import scan


def _over_rows(fn, valid: torch.Tensor) -> torch.Tensor:
    """``fn`` of a [K, L] scan applied along the last axis of any shape."""
    L = valid.shape[-1]
    return fn(valid.reshape(-1, L)).reshape(valid.shape)


def last_valid_index(valid: torch.Tensor) -> torch.Tensor:
    """Running index of the last True up to and including each position
    along the last axis; -1 where none has been seen yet.

    The vectorised ``last(col, ignoreNulls=True)`` over an
    unbounded-preceding window (reference tsdf.py:139).  Plain form:
    ``scan.last_valid_index_scan_plain`` (a ``torch.cummax``)."""
    return _over_rows(scan.last_valid_index_scan, valid)


def first_valid_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the first True at or after each position along the last
    axis; its length where none.

    ``first(col, ignoreNulls=True)`` over a current-row-to-unbounded-
    following window (reference interpol.py:216-222).  Plain form:
    ``scan.first_valid_index_scan_plain`` (the mirrored ``cummin``)."""
    return _over_rows(scan.first_valid_index_scan, valid)


def shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[..., i] = x[..., i - k], ``fill`` for i < k."""
    if k == 0:
        return x
    k = min(k, x.shape[-1])
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - k]], dim=-1)


def windowed_max_last(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max over the trailing ``window`` elements (inclusive) at every
    position, by log-doubling (Spark rowsBetween(-window+1, 0))."""
    if window <= 0:
        raise ValueError("window must be >= 1")
    window = min(int(window), int(x.shape[-1]))
    neg = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    levels = [x]
    span = 1
    while span < window:
        prev = levels[-1]
        levels.append(torch.maximum(prev, shift_right(prev, span, neg)))
        span *= 2
    if span == window:
        return levels[-1]
    half = 1 << (len(levels) - 2)
    lo = levels[-2]
    return torch.maximum(lo, shift_right(lo, window - half, neg))


def merge_rank(sorted_keys: torch.Tensor, sorted_queries: torch.Tensor,
               side: str = "left") -> torch.Tensor:
    """``searchsorted`` of each query row into each key row, by a stable
    merge and a prefix count (both inputs ascending per row)."""
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
