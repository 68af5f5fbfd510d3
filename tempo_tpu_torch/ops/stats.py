"""The legacy shifted-window range statistics: the CUDA kernel and its
plain version.

Counterpart of ``tempo_tpu/ops/pallas_stats.py``: the Pallas kernel
``_make_kernel`` behind ``_stats_call`` and ``range_stats_pallas``, whose
XLA form ``sortmerge._range_stats_shifted_xla`` runs the same op
sequence.  ``TEMPO_TPU_WINDOW_ENGINE=legacy`` takes it for row extents
within ``ops/rolling.shifted_row_budget``.

It computes the rangeBetween(-window, 0) aggregates of
``ops/window.range_stats`` in another order: every shift
``j = -max_ahead .. max_behind`` (``j = 0`` included) is one masked pass
over accumulators that start at 0 and +-inf; row ``i - j`` is in the
frame of row ``i`` when it is valid and its key lies in
``[secs[i] - window, secs[i]]``; sums accumulate values centred on the
row's mean, min and max take the raw values.  Lanes shifted in from
outside the row carry the largest key and no validity, so they add 0.
The ``clipped`` audit counts, per row and column, the lanes whose frame
reaches the first row beyond either bound.

Outputs as ``window.range_stats``: ``mean``, ``count``, ``min``, ``max``,
``sum``, ``stddev``, ``zscore`` as [C, K, L] (or [K, L] for a single
column) and ``clipped`` as [C, K, 1] (or [K, 1]).
"""

from __future__ import annotations

from typing import Dict

import torch

from tempo_tpu_torch.ops import cuda_lib
from tempo_tpu_torch.ops.window import STATS, _clamp_window, _shift


def legacy_stats_plain(secs, xs, valids, window, max_behind, max_ahead
                       ) -> Dict[str, torch.Tensor]:
    """``_make_kernel``'s op sequence as tensor code over [C, K, L]
    stacks sharing one [K, L] key plane; dtype-generic."""
    dt, dev = xs.dtype, xs.device
    C, K, L = xs.shape
    big = torch.iinfo(secs.dtype).max
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    pinf = torch.tensor(float("inf"), dtype=dt, device=dev)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    x, valid = xs, valids
    secs = secs[None]
    lo = secs - _clamp_window(window)

    xz = torch.where(valid, x, zero)
    nv = valid.to(dt).sum(-1, keepdim=True)
    center = xz.sum(-1, keepdim=True) / torch.maximum(nv, one)
    xc = torch.where(valid, x - center, zero)

    cnt = torch.zeros_like(x)
    s1 = torch.zeros_like(x)
    s2 = torch.zeros_like(x)
    mn = torch.full_like(x, float("inf"))
    mx = torch.full_like(x, float("-inf"))
    # shifts of a row's length or more are all fill: they add 0 and
    # +-inf, which leaves every accumulator as it is
    for j in range(-min(int(max_ahead), L - 1),
                   min(int(max_behind), L - 1) + 1):
        sj = _shift(secs, j, big)
        inw = (sj >= lo) & (sj <= secs) & _shift(valid, j, False)
        xj = _shift(xc, j, 0.0)
        xr = _shift(x, j, 0.0)
        cnt = cnt + inw.to(dt)
        s1 = s1 + torch.where(inw, xj, zero)
        s2 = s2 + torch.where(inw, xj * xj, zero)
        mn = torch.minimum(mn, torch.where(inw, xr, pinf))
        mx = torch.maximum(mx, torch.where(inw, xr, -pinf))

    mean = torch.where(cnt > 0, s1 / torch.maximum(cnt, one) + center, nan)
    total = s1 + cnt * center
    var = torch.where(cnt > 1, (s2 - s1 * s1 / torch.maximum(cnt, one))
                      / torch.maximum(cnt - one, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)

    clipped = torch.zeros_like(valid)
    for j in (min(int(max_behind) + 1, L), -min(int(max_ahead) + 1, L)):
        sj = _shift(secs, j, big)
        clipped = clipped | ((sj >= lo) & (sj <= secs)
                             & (valid | _shift(valid, j, False)))

    return {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, mn, nan),
        "max": torch.where(cnt > 0, mx, nan),
        "sum": torch.where(cnt > 0, total, nan),
        "stddev": std,
        "zscore": torch.where(valid, (x - mean) / std, nan),
        "clipped": clipped.to(dt).sum(-1, keepdim=True),
    }


def legacy_stats_cuda(secs, xs, valids, window, max_behind, max_ahead
                      ) -> Dict[str, torch.Tensor]:
    """Launch the legacy stats kernel: int32 [K, L] keys, float32 and
    bool [C, K, L] stacks, all on one CUDA device."""
    if secs.dtype != torch.int32 or secs.dim() != 2:
        raise TypeError("legacy stats kernel takes int32 [K, L] keys "
                        "(rebased seconds)")
    if xs.dtype != torch.float32 or xs.dim() != 3:
        raise TypeError("legacy stats kernel takes float32 [C, K, L] values")
    if valids.dtype != torch.bool or valids.shape != xs.shape \
            or tuple(xs.shape[1:]) != tuple(secs.shape):
        raise TypeError("valid must be bool [C, K, L] over [K, L] keys")
    if not (secs.is_cuda and xs.device == secs.device
            and valids.device == secs.device):
        raise ValueError("keys, values and valid must lie on one CUDA "
                         "device")
    C, K, L = xs.shape
    secs, xs, valids = secs.contiguous(), xs.contiguous(), valids.contiguous()
    out = torch.empty((len(STATS), C, K, L), dtype=torch.float32,
                      device=xs.device)
    clipped = torch.empty((C, K, 1), dtype=torch.float32, device=xs.device)
    if C and K and L:
        # bounds past the row act as the row length (all-fill shifts)
        cuda_lib.launch(
            "legacy_stats", xs.device, "tempo_legacy_stats",
            secs.data_ptr(), xs.data_ptr(), valids.data_ptr(),
            out.data_ptr(), clipped.data_ptr(), _clamp_window(window),
            min(int(max_behind), L), min(int(max_ahead), L), C, K, L)
    else:
        clipped.zero_()
    stats = {name: out[i] for i, name in enumerate(STATS)}
    stats["clipped"] = clipped
    return stats


def legacy_stats(secs, xs, valids, window, max_behind, max_ahead=0
                 ) -> Dict[str, torch.Tensor]:
    """Legacy rangeBetween(-window, 0) aggregates of [C, K, L] (or
    [K, L]) values over one [K, L] ascending key plane: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    single = xs.dim() == 2
    if single:
        xs, valids = xs[None], valids[None]
    fn = legacy_stats_cuda if xs.is_cuda else legacy_stats_plain
    stats = fn(secs, xs, valids, window, max_behind, max_ahead)
    if single:
        stats = {k: v[0] for k, v in stats.items()}
    return stats
