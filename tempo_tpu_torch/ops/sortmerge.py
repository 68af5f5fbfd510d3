"""The join and range-stats dispatchers of the one-program step.

Counterpart of ``tempo_tpu/ops/sortmerge.py``: ``asof_merge_values``,
``asof_indices_binpacked`` and ``use_sort_kernels``.  On the TPU these
picked between Pallas kernels and XLA sort forms; here a CUDA tensor
goes to the hand-written kernel (``ops/merge.py``) and a CPU tensor to
its plain version.  The reference's other dispatchers have nothing left
to pick: its ``asof_merge_indices`` is ``merge.asof_merge_indices`` and
its ``range_stats_shifted[_packed]`` is ``window.range_stats``, which
callers use directly.  The
``maxLookback`` row cap has no CUDA kernel yet (the chunked join,
``pallas_merge._make_chunked_kernel``): on a CUDA tensor it raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tempo_tpu_torch import config
from tempo_tpu_torch.ops import merge
from tempo_tpu_torch.ops.window_utils import windowed_max_last


class KernelNotPortedError(NotImplementedError):
    """An engine whose TPU kernel has no CUDA port yet was asked to run
    on a CUDA tensor.  The message names the ROADMAP.md item."""


def not_ported(what: str, roadmap_item: str) -> KernelNotPortedError:
    return KernelNotPortedError(
        f"{what} needs a CUDA kernel that is not ported yet "
        f"(ROADMAP.md {roadmap_item}); run it with device='cpu' for the "
        f"plain version")


CHUNKED_JOIN = "queue B item 1: chunked merge join, pallas_merge.py:976"


def use_sort_kernels() -> bool:
    """Whether withRangeStats takes the row-bounded shifted/stream
    engines (default) rather than the windowed prefix-sum form;
    ``TEMPO_TPU_SORT_KERNELS=0`` turns them off."""
    env = config.get("TEMPO_TPU_SORT_KERNELS")
    if env is not None:
        return env not in ("0", "false", "no")
    return True


def asof_merge_values(l_ts, r_ts, r_valids, r_values, l_seq=None,
                      r_seq=None, skip_nulls: bool = True,
                      max_lookback: int = 0):
    """AS-OF join returning ``(vals [C, K, Ll], found, last_row_idx)``."""
    if max_lookback:
        last, per_col = asof_indices_lookback(
            l_ts, r_ts, r_valids, max_lookback, r_values=r_values,
            l_seq=l_seq, r_seq=r_seq, skip_nulls=skip_nulls)
        nan = torch.tensor(float("nan"), dtype=r_values.dtype,
                           device=r_values.device)
        vals = torch.where(
            per_col >= 0,
            torch.gather(r_values, 2, per_col.clamp(min=0).long()), nan)
        return vals, per_col >= 0, last
    return merge.asof_merge_values(l_ts, r_ts, r_valids, r_values,
                                   l_seq=l_seq, r_seq=r_seq,
                                   skip_nulls=skip_nulls)


def asof_indices_binpacked(l_ts, r_ts, r_valids, l_sid, r_sid,
                           max_lookback: int = 0, r_seq=None):
    """Index join over bin-packed rows; positions are within the lane
    row (callers subtract the series' offset)."""
    if max_lookback:
        return asof_indices_lookback(l_ts, r_ts, r_valids, max_lookback,
                                     l_sid=l_sid, r_sid=r_sid, r_seq=r_seq)
    return merge.asof_merge_indices(l_ts, r_ts, r_valids, l_sid=l_sid,
                                    r_sid=r_sid, r_seq=r_seq)


def asof_indices_lookback(l_ts, r_ts, r_valids, max_lookback: int,
                          r_values=None, l_sid=None, r_sid=None,
                          l_seq=None, r_seq=None, skip_nulls: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scala's ``maxLookback`` cap (asofJoin.scala:64-88): the match must
    lie within the trailing ``max_lookback + 1`` rows of the merged
    left+right stream.  Plain tensor code (CPU only)."""
    if l_ts.is_cuda:
        raise not_ported("asofJoin(maxLookback > 0)", CHUNKED_JOIN)
    K, Ll = l_ts.shape
    Lr = r_ts.shape[-1]
    dev = l_ts.device
    l_key, r_key = merge.seq_keys(l_seq, r_seq, (K, Ll), (K, Lr))
    keys = []
    if l_sid is not None:
        keys.append(torch.cat([l_sid, r_sid], -1).to(torch.int64))
    keys.append(torch.cat([l_ts, r_ts], -1))
    if l_key is not None:
        keys.append(torch.cat([l_key, r_key], -1))
    keys.append(torch.cat([torch.ones(K, Ll, dtype=torch.int64, device=dev),
                           torch.zeros(K, Lr, dtype=torch.int64,
                                       device=dev)], -1))
    order = torch.arange(Ll + Lr, device=dev).expand(K, -1)
    for key in reversed(keys):
        perm = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        order = torch.gather(order, 1, perm)
    is_right = order >= Ll
    ridx = torch.where(is_right, order - Ll, -1)
    left = ~is_right
    left_slots = order[left].view(K, Ll)

    def to_left(merged):
        out = torch.empty(K, Ll, dtype=torch.int64, device=dev)
        out.scatter_(1, left_slots, merged[left].view(K, Ll))
        return out

    def fence(idx):
        if l_sid is None:
            return idx
        got = torch.gather(r_sid, 1, idx.clamp(min=0))
        return torch.where((idx >= 0) & (got == l_sid), idx, -1)

    win = int(max_lookback) + 1
    last = fence(to_left(windowed_max_last(ridx, win)))
    rvalid = merge._right_valid(r_valids, r_values)
    cols = []
    for c in range(r_valids.shape[0]):
        if skip_nulls:
            ok = torch.gather(rvalid[c], 1, ridx.clamp(min=0)) & is_right
            j = fence(to_left(windowed_max_last(torch.where(ok, ridx, -1),
                                                win)))
        else:
            ok = torch.gather(rvalid[c], 1, last.clamp(min=0))
            j = torch.where((last >= 0) & ok, last, -1)
        cols.append(j)
    per_col = (torch.stack(cols) if cols else
               torch.zeros(0, K, Ll, dtype=torch.int64, device=dev))
    return last.to(torch.int32), per_col.to(torch.int32)
