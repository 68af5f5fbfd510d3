"""AS-OF join index forms on packed [K, L] series.

Counterpart of ``tempo_tpu/ops/asof.py``.  Every form returns int32
row indices into the right side (-1 for no match); the frame layer
gathers the values, so any column dtype rides the same join.  The
reference's ``asof_indices_searchsorted`` and ``asof_indices_merge``
compute the same indices; here ``asof_indices_merge`` serves both and
runs the merge kernel or, for ``maxLookback`` and the ``chunked``
engine, the lookback kernel (``ops/merge.py``); the plain versions on a
CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tempo_tpu_torch.ops import merge, sortmerge


def asof_indices_merge(l_ts, l_seq, r_ts, r_seq, r_valids, n_cols: int,
                       max_lookback: int = 0, engine: str = "single"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge form with a sequence tie-break and the optional
    ``maxLookback`` merged-row cap (0 = unbounded).  ``maxLookback`` and
    the ``chunked`` engine take the lookback kernel, the rest the merge
    kernel (plain versions on a CPU tensor)."""
    if sortmerge.takes_lookback_kernel(max_lookback, engine):
        return sortmerge.asof_indices_lookback(
            l_ts, r_ts, r_valids, max_lookback, l_seq=l_seq, r_seq=r_seq)
    return merge.asof_merge_indices(l_ts, r_ts, r_valids, l_seq=l_seq,
                                    r_seq=r_seq)


def asof_indices_inner(l_ts, r_ts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast (sql_join_opt) flavour: the last right row at or before
    each left row and whether one exists; the frame drops the rows with
    none (the reference's inner range join, tsdf.py:482-509)."""
    C0 = torch.zeros((0,) + tuple(r_ts.shape), dtype=torch.bool,
                     device=r_ts.device)
    idx, _ = merge.asof_merge_indices(l_ts, r_ts, C0)
    return idx, idx >= 0
