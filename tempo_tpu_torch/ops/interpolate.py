"""Interpolation over dense per-series time grids.

Counterpart of ``tempo_tpu/ops/interpolate.py`` (reference semantics:
python/tempo/interpol.py).  The resampled rows sit on a dense [K, G]
grid from each series' first to last bucket, and every scaffold of the
reference's explode + window plan is an index scan: the last real slot
at or before each slot (the source row), the first real slot at or after
it, and per column the last / first non-null slot.  Those four scans are
the index-scan kernels (``ops/window_utils`` -> ``ops/scan``) on a CUDA
tensor; the gathers and ``where``s around them are tensor ops.  The
reference maps ``per_col`` over the columns with ``vmap``; here the
columns' masks are flattened to one [C*K, G] scan, so a call launches
each index kernel twice (once on the grid's mask, once on the columns').

Semantics, as the reference goldens pin them:

* an existing-but-null row is flagged interpolated but NOT
  ts-interpolated (interpol.py:114-119);
* generated slots inherit their *source* row's scaffolds, so ``next``
  means "next real row after the source", not "next grid slot";
* bfill falls back to the first non-null at or after the slot only when
  the next real value is null AND the source value is null
  (interpol.py:153-170);
* linear uses unix-seconds arithmetic and two formulas, for a null and
  a non-null source (interpol.py:66-94), with the tail edge
  ``next_timestamp = ts + freq`` (interpol.py:315-321).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tempo_tpu_torch.ops import window_utils as wu

METHODS = ("zero", "null", "ffill", "bfill", "linear")


def _gather(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, fill):
    """``x`` at ``idx`` along the last axis (clamped), ``fill`` where not
    ``ok``."""
    idx = idx.clamp(0, x.shape[-1] - 1).to(torch.int64)
    g = torch.gather(x, -1, idx.expand(x.shape[:-1] + idx.shape[-1:]))
    return torch.where(ok, g, torch.as_tensor(fill, dtype=x.dtype,
                                              device=x.device))


def interpolate_columns(
    real: torch.Tensor,      # [K, G] bool: slot holds a resampled row
    glen: torch.Tensor,      # [K] int32 grid length per series
    ts_sec: torch.Tensor,    # [K, G] float grid timestamps (unix seconds)
    freq_sec: float,         # seconds between slots
    values: torch.Tensor,    # [C, K, G] float (NaN where null/absent)
    valid: torch.Tensor,     # [C, K, G] bool (non-null real value)
    method: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out_values [C,K,G], out_valid [C,K,G],
    is_ts_interpolated [K,G], is_interpolated [C,K,G])."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method}")
    K, G = real.shape
    dt, dev = values.dtype, values.device
    nan = float("nan")
    slot = torch.arange(G, dtype=torch.int32, device=dev).expand(K, G)
    in_grid = slot < glen[:, None]

    src = wu.last_valid_index(real)                   # [K, G] source row slot
    # src is >= 0 inside the grid (a grid starts at a real row)
    is_ts_interp = in_grid & (slot != src.clamp(min=0))

    # next real slot strictly after the source (== strictly after g,
    # since there is no real slot in (src, g])
    fr = wu.first_valid_index(real)                   # first real >= g
    nxt = torch.cat([fr[:, 1:], torch.full((K, 1), G, dtype=fr.dtype,
                                           device=dev)], -1)
    nxt_ok = nxt < glen[:, None]

    src_ok = src >= 0
    src_ts = _gather(ts_sec, src, src_ok, nan)
    nxt_ts = torch.where(nxt_ok, _gather(ts_sec, nxt, nxt_ok, 0.0),
                         src_ts + freq_sec)           # tail edge rule

    # per column, on [C, K, G] (the grid's [K, G] scaffolds broadcast)
    v, ok = values, valid
    v_src = _gather(v, src, src_ok, nan)
    ok_src = _gather(ok, src, src_ok, False)
    flag = in_grid & (is_ts_interp | ~ok_src)

    prev_i = wu.last_valid_index(ok)                  # last non-null <= g
    prev_ok = prev_i >= 0
    prev_v = _gather(v, prev_i, prev_ok, nan)
    prev_t = _gather(ts_sec.expand_as(v), prev_i, prev_ok, nan)

    nn_i = wu.first_valid_index(ok)                   # first non-null >= g
    nn_ok = nn_i < glen[:, None]
    nn_v = _gather(v, nn_i, nn_ok, nan)
    nn_t = _gather(ts_sec.expand_as(v), nn_i, nn_ok, nan)

    next_v = _gather(v, nxt, nxt_ok, nan)             # may be null
    next_value_ok = nxt_ok & _gather(ok, nxt, nxt_ok, False)

    true = torch.ones((), dtype=torch.bool, device=dev)
    if method == "zero":
        out = torch.where(flag, torch.zeros((), dtype=dt, device=dev), v_src)
        out_ok = in_grid.expand_as(flag)
    elif method == "null":
        out = torch.where(flag, torch.full((), nan, dtype=dt, device=dev),
                          v_src)
        out_ok = in_grid & ~flag
    elif method == "ffill":
        out = torch.where(flag, prev_v, v_src)
        out_ok = in_grid & torch.where(flag, prev_ok, true)
    elif method == "bfill":
        use_nn = ~next_value_ok & ~ok_src
        filled = torch.where(use_nn, nn_v, next_v)
        filled_ok = torch.where(use_nn, nn_ok, next_value_ok)
        out = torch.where(flag, filled, v_src)
        out_ok = in_grid & torch.where(flag, filled_ok, true)
    else:  # linear
        # null-source branch: between prev non-null and next non-null
        lin_null = prev_v + (nn_v - prev_v) * (ts_sec - prev_t) / (nn_t - prev_t)
        lin_null_ok = prev_ok & nn_ok
        # non-null-source branch: between source value and next real value
        lin_src = v_src + (next_v - v_src) * (ts_sec - src_ts) / (nxt_ts - src_ts)
        lin_src_ok = next_value_ok
        filled = torch.where(ok_src, lin_src, lin_null)
        filled_ok = torch.where(ok_src, lin_src_ok, lin_null_ok)
        out = torch.where(flag, filled, v_src)
        out_ok = in_grid & torch.where(flag, filled_ok, true)
    out = torch.where(out_ok, out, torch.full((), nan, dtype=dt, device=dev))
    return out, out_ok, is_ts_interp, flag
