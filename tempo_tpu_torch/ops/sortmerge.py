"""The join dispatchers of the one-program step and the frame join.

Counterpart of ``tempo_tpu/ops/sortmerge.py``: ``asof_merge_values``,
``asof_indices_binpacked``, ``asof_indices_lookback`` and
``use_sort_kernels``.  On the TPU these picked between Pallas kernels and
XLA sort forms; here a CUDA tensor goes to a hand-written kernel
(``ops/merge.py``) and a CPU tensor to its plain version: the merge
kernel for the plain join, the lookback kernel for ``maxLookback`` and
for the ``chunked`` engine (whatever ``maxLookback``, as the reference's
chunked engine runs its one kernel).  The reference's other dispatchers
have nothing left to pick: its ``asof_merge_indices`` is
``merge.asof_merge_indices`` and its ``range_stats_shifted[_packed]`` is
``window.range_stats`` (``stats.legacy_stats`` under
``TEMPO_TPU_WINDOW_ENGINE=legacy``), which callers use directly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tempo_tpu_torch import config
from tempo_tpu_torch.ops import merge


def use_sort_kernels() -> bool:
    """Whether withRangeStats takes the row-bounded shifted/stream
    engines (default) rather than the windowed prefix-sum form;
    ``TEMPO_TPU_SORT_KERNELS=0`` turns them off."""
    env = config.get("TEMPO_TPU_SORT_KERNELS")
    if env is not None:
        return env not in ("0", "false", "no")
    return True


def takes_lookback_kernel(max_lookback: int, engine: str) -> bool:
    """Whether a join takes the lookback kernel: for ``maxLookback`` and
    for the ``chunked`` engine."""
    return bool(max_lookback) or engine == "chunked"


def asof_merge_values(l_ts, r_ts, r_valids, r_values, l_seq=None,
                      r_seq=None, skip_nulls: bool = True,
                      max_lookback: int = 0):
    """AS-OF join returning ``(vals [C, K, Ll], found, last_row_idx)``."""
    if max_lookback:
        last, col_idx, vals = merge.asof_merge_lookback(
            l_ts, r_ts, r_valids, max_lookback, r_values, l_seq=l_seq,
            r_seq=r_seq, skip_nulls=skip_nulls)
        return vals, col_idx >= 0, last
    return merge.asof_merge_values(l_ts, r_ts, r_valids, r_values,
                                   l_seq=l_seq, r_seq=r_seq,
                                   skip_nulls=skip_nulls)


def asof_indices_binpacked(l_ts, r_ts, r_valids, l_sid, r_sid,
                           max_lookback: int = 0, r_seq=None,
                           engine: str = "single"):
    """Index join over bin-packed rows; positions are within the lane
    row (callers subtract the series' offset)."""
    if takes_lookback_kernel(max_lookback, engine):
        return asof_indices_lookback(l_ts, r_ts, r_valids, max_lookback,
                                     l_sid=l_sid, r_sid=r_sid, r_seq=r_seq)
    return merge.asof_merge_indices(l_ts, r_ts, r_valids, l_sid=l_sid,
                                    r_sid=r_sid, r_seq=r_seq)


def asof_indices_lookback(l_ts, r_ts, r_valids, max_lookback: int,
                          l_sid=None, r_sid=None, l_seq=None, r_seq=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scala's ``maxLookback`` cap (asofJoin.scala:64-88), index form:
    ``(last_row_idx [K, Ll], per_col_idx [C, K, Ll])``; the match must
    lie within the trailing ``max_lookback + 1`` rows of the merged
    left+right stream (0: no cap)."""
    last, col_idx, _ = merge.asof_merge_lookback(
        l_ts, r_ts, r_valids, max_lookback, l_sid=l_sid, r_sid=r_sid,
        l_seq=l_seq, r_seq=r_seq)
    return last, col_idx
