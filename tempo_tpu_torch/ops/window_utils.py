"""Window primitives.

Counterpart of the parts of ``tempo_tpu/ops/window_utils.py`` and
``tempo_tpu/ops/sortmerge.py:merge_rank`` that the windowed range engine,
the ``maxLookback`` join and interpolation need.  ``last_valid_index``
and ``first_valid_index`` reach the index-scan kernels of ``ops/scan``,
``merge_rank`` and ``searchsorted_batched`` the rank kernel of
``ops/merge``, on a CUDA tensor (any L), and their plain versions on a
CPU tensor.  ``shift_right`` and ``windowed_max_last`` are plain tensor
code, dtype-generic (the latter for the plain ``maxLookback`` join).
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import merge, scan


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
    """``searchsorted`` of each query row into each key row (both
    ascending per row), int64 ranks: the rank kernel for CUDA tensors,
    ``merge.merge_rank_plain`` (a stable merge and a prefix count) for
    CPU tensors."""
    if sorted_keys.is_cuda:
        return merge.merge_rank_cuda(sorted_keys, sorted_queries, side)
    return merge.merge_rank_plain(sorted_keys, sorted_queries, side)


def searchsorted_batched(sorted_keys: torch.Tensor, queries: torch.Tensor,
                         side: str = "left") -> torch.Tensor:
    """Batched searchsorted over the leading (series) axis: row ``k`` of
    the result is ``searchsorted(sorted_keys[k], queries[k], side)``.

    API CONTRACT (the reference's): ``queries`` MUST be ascending along
    the last axis, as ``sorted_keys`` is; every caller passes shifted
    versions of an already-sorted time axis.  The plain merge form
    returns wrong ranks for unsorted queries, not an error."""
    return merge_rank(sorted_keys, queries, side)
