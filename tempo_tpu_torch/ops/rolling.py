"""Range-stats engines and EMA forms on packed [K, L] series.

Counterpart of ``tempo_tpu/ops/rolling.py``: ``pick_range_engine``,
``shifted_row_budget``, ``windowed_stats``, ``bucket_stats``,
``bucket_stats_multi``, ``segment_stats``, ``ema_exact``, ``ema_compat``
and ``ema_scan`` (re-exported from ``ops/scan.py``, where the reference's
callers look for it).

The reference has three range engines; two of them, ``shifted`` and
``stream``, are the unrolled and runtime-width forms of one Pallas
kernel, and here one CUDA kernel (``ops/window.range_stats``) serves
both, so the port picks between two:

* ``shifted``: the range-stats kernel over the frame's row bounds, up to
  ``TEMPO_TPU_STREAM_MAX_ROWS`` rows of extent;
* ``windowed``: prefix sums (the ``cumsum3`` kernel of ``ops/scan``)
  + sparse-table min/max over per-row [start, end) bounds (two launches
  of the rank kernel, ``range_window_bounds``), for spans past int32 or
  wider frames.

``TEMPO_TPU_WINDOW_ENGINE=legacy`` adds a third, ``legacy``: the
reference's legacy shifted-window kernel (``pallas_stats._make_kernel``,
here ``ops/stats.legacy_stats``), for extents within
``shifted_row_budget``, as the reference's ``shifted`` engine runs legacy
arithmetic under that knob.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from tempo_tpu_torch import config
from tempo_tpu_torch.ops import bucket, scan, stats
from tempo_tpu_torch.ops.scan import ema_scan  # noqa: F401 (re-export)
from tempo_tpu_torch.ops.window_utils import merge_rank, shift_right

# The reference's ceiling on the shifted form's row extent (compile-time
# growth on small shards), and the window ceilings of its two unrolled
# VMEM kernels (pallas_stats._PALLAS_STATS_MAX_W, pallas_window.
# UNROLL_MAX_W), which floor ``shifted_row_budget`` when they can run.
SHIFTED_MAX_ROWS = 512
_PALLAS_STATS_MAX_W = 64
_UNROLL_MAX_W = 64


def stream_max_rows() -> int:
    """Row-extent ceiling of the runtime-width engine: the knob, else the
    tuned profile's value (the autotuner's audit-gated winner, which by
    its rule is never another ceiling than the default), else 16384."""
    from tempo_tpu_torch import tune

    return tune.resolve("TEMPO_TPU_STREAM_MAX_ROWS", 16384)


def shifted_row_budget(n_elems: int, pallas_ok: bool = False) -> int:
    """Largest row extent the reference's shifted form takes on a shard
    of ``n_elems`` values (a copy of its ``shifted_row_budget``): its
    XLA form materialises shifted operand copies, so the bound falls
    with the shard's size (12 GB at 3 copies of 4 B a pass); a shard
    its VMEM kernels can take (``pallas_ok``) is floored at their window
    ceiling; never past ``SHIFTED_MAX_ROWS``."""
    mem_rows = int(12e9 // max(n_elems * 4 * 3, 1))
    if pallas_ok:
        mem_rows = max(mem_rows, _PALLAS_STATS_MAX_W, _UNROLL_MAX_W)
    return min(SHIFTED_MAX_ROWS, mem_rows)


def pick_range_engine(n_elems: int, max_behind: int, max_ahead: int
                      ) -> str:
    """'shifted' | 'windowed' | 'legacy' for a frame of ``n_elems``
    packed lanes whose row extent is (max_behind, max_ahead).
    ``TEMPO_TPU_WINDOW_ENGINE=windowed`` forces the windowed form, and
    'shifted' or 'stream' the row-bounded kernel.  Under 'legacy' the
    pick is the reference's for a shard its kernels can take: its
    ``shifted`` engine (legacy arithmetic under that knob, here the
    legacy kernel, which takes every extent) up to
    ``shifted_row_budget(n_elems, pallas_ok=True)`` rows, its ``stream``
    engine (the row-bounded kernel) up to ``TEMPO_TPU_STREAM_MAX_ROWS``,
    then windowed."""
    forced = (config.get("TEMPO_TPU_WINDOW_ENGINE") or "auto").lower()
    if forced == "windowed":
        return "windowed"
    if forced in ("shifted", "stream"):
        return "shifted"
    extent = int(max_behind) + int(max_ahead)
    if forced == "legacy" and extent <= shifted_row_budget(n_elems, True):
        return "legacy"
    if extent <= stream_max_rows():
        return "shifted"
    return "windowed"


def legacy_range_stats(secs, x, valid, window_secs, max_behind: int,
                       max_ahead: int = 0) -> Dict[str, torch.Tensor]:
    """The legacy engine: ``ops/stats.legacy_stats``, the legacy kernel
    on a CUDA tensor and its plain version on the CPU."""
    return stats.legacy_stats(secs, x, valid, window_secs, max_behind,
                              max_ahead)


def range_window_bounds(ts_long: torch.Tensor, window_secs):
    """Per-row [start, end) of rangeBetween(-window_secs, 0) over a
    sorted integer seconds axis; ``end`` includes following ties.  Two
    rank launches on a CUDA tensor."""
    w = int(window_secs)
    start = merge_rank(ts_long, ts_long - w, side="left")
    end = merge_rank(ts_long, ts_long, side="right")
    return start, end


def _sparse_table(arr, fill, reducer, nlev):
    levels = [arr]
    span = 1
    for _ in range(nlev - 1):
        levels.append(reducer(levels[-1], shift_right(levels[-1], span, fill)))
        span *= 2
    return torch.stack(levels, dim=-1)


def _range_query(table, start, end, reducer):
    """Reduce the table's base array over [start, end) per row by the
    two overlapping power-of-two spans."""
    K, L, nlev = table.shape
    flat = table.reshape(K, L * nlev)
    length = torch.clamp(end - start, min=1)
    k = torch.clamp(torch.floor(torch.log2(length.double())).long(),
                    max=nlev - 1)
    span = 1 << k
    p1 = (end - 1).clamp(min=0) * nlev + k
    p2 = (start + span - 1).clamp(min=0) * nlev + k
    return reducer(torch.gather(flat, 1, p1), torch.gather(flat, 1, p2))


def windowed_stats(x, valid, start, end, max_window: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """mean/count/min/max/sum/stddev/zscore over per-row [start, end)
    windows: mean-centred prefix sums (``scan.cumsum3``) plus sparse-table
    min/max.  ``max_window`` (0 = the row length) bounds end - start in
    rows, so the tables build only the levels a window can query, as the
    reference's ``windowed_stats`` does; a bound below a real window
    would leave min/max short, so callers compute it from the bounds."""
    dt, dev = x.dtype, x.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    # fills made on the device (no host-to-device copy, no host read):
    # the form runs inside captured CUDA graphs too (plan/stitch.py)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    xz = torch.where(valid, x, zero)
    n_valid = valid.to(dt).sum(-1, keepdim=True)
    center = xz.sum(-1, keepdim=True) / torch.maximum(n_valid, one)
    xc = torch.where(valid, x - center, zero)

    def win(p):
        hi = torch.where(end > 0, torch.gather(p, 1, (end - 1).clamp(min=0)),
                         zero)
        lo = torch.where(start > 0,
                         torch.gather(p, 1, (start - 1).clamp(min=0)), zero)
        return hi - lo

    s1, s2, cnt = (win(p) for p in scan.cumsum3(xc, valid))
    mean = torch.where(cnt > 0, s1 / torch.maximum(cnt, one) + center, nan)
    total = s1 + cnt * center
    var = torch.where(cnt > 1, (s2 - s1 * s1 / torch.maximum(cnt, one))
                      / torch.maximum(cnt - 1, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    L = x.shape[-1]
    nlev = max(1, (L - 1).bit_length() + 1)
    if max_window:
        nlev = min(nlev, (max(1, int(max_window)) - 1).bit_length() + 1)
    tmin = _sparse_table(torch.where(valid, x, pinf), float("inf"),
                         torch.minimum, nlev)
    tmax = _sparse_table(torch.where(valid, x, -pinf), float("-inf"),
                         torch.maximum, nlev)
    wmin = _range_query(tmin, start, end, torch.minimum)
    wmax = _range_query(tmax, start, end, torch.maximum)
    return {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, wmin, nan),
        "max": torch.where(cnt > 0, wmax, nan),
        "sum": torch.where(cnt > 0, total, nan),
        "stddev": std,
        "zscore": torch.where(valid, (x - mean) / std, nan),
    }


def bucket_stats(bid, x, valid) -> Dict[str, torch.Tensor]:
    """Tumbling-bucket aggregates broadcast to every row of the bucket
    (the resample / grouped-stats reduction), for one [K, L] column over
    its int32 bucket-id plane: ``ops/bucket.bucket_stats`` on every
    device, the kernel on a CUDA tensor and its plain version on the
    CPU.  (The reference takes its Pallas kernel only on the TPU and
    ``windowed_stats`` over searchsorted bucket bounds elsewhere; the
    port keeps one arithmetic on both devices.)"""
    return bucket.bucket_stats(bid, x, valid)


def bucket_stats_multi(bid, xs, valids) -> Dict[str, torch.Tensor]:
    """:func:`bucket_stats` of a [C, K, L] column stack sharing one id
    plane, in one kernel launch; each column's planes equal a
    single-column call's."""
    return bucket.bucket_stats(bid, xs, valids)


def segment_stats(x: torch.Tensor, valid: torch.Tensor,
                  seg_ids: torch.Tensor, num_segments: int
                  ) -> Dict[str, torch.Tensor]:
    """Six grouped aggregates per segment of flat ``[n]`` rows
    (withGroupedStats tsdf.py:750-754), as tensor ops on either device.
    The ids are sorted (non-decreasing), as the reference's
    ``segment_stats`` requires, so each segment is a contiguous run:
    its bounds come from ``searchsorted`` and the sums from
    ``torch.segment_reduce`` over them, which adds a segment's rows in a
    fixed order (left to right on the CPU; on the card a segmented
    reduction without atomics), so a call repeats bitwise.  Ids outside
    ``[0, num_segments)`` are dropped, as the reference drops them.
    ``min``/``max`` are ``scatter_reduce_``, exact in any order."""
    dt, dev = x.dtype, x.device
    seg = seg_ids.to(torch.int64)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    xz = torch.where(valid, x, zero)
    bounds = torch.searchsorted(
        seg, torch.arange(num_segments + 1, dtype=torch.int64, device=dev))

    def seg_sum(v):
        return torch.segment_reduce(v[bounds[0]:bounds[-1]], "sum",
                                    offsets=bounds - bounds[0], initial=0.0)

    def seg_reduce(v, fill, how):
        inside = (seg >= 0) & (seg < num_segments)
        return torch.full((num_segments,), fill, dtype=dt,
                          device=dev).scatter_reduce_(
            0, seg[inside], v[inside], how)

    cnt = seg_sum(valid.to(dt))
    s1 = seg_sum(xz)
    s2 = seg_sum(xz * xz)
    mn = seg_reduce(torch.where(valid, x, pinf), float("inf"), "amin")
    mx = seg_reduce(torch.where(valid, x, -pinf), float("-inf"), "amax")
    mean = torch.where(cnt > 0, s1 / torch.maximum(cnt, one), nan)
    var = torch.where(cnt > 1, (s2 - s1 * s1 / torch.maximum(cnt, one))
                      / torch.maximum(cnt - 1, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    return {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, mn, nan),
        "max": torch.where(cnt > 0, mx, nan),
        "sum": torch.where(cnt > 0, s1, nan),
        "stddev": std,
    }


def ema_exact(x, valid, alpha: float) -> torch.Tensor:
    """Exact infinite-horizon EMA (the ladder of ``ops/scan.py``)."""
    return scan.ema(x, valid, alpha)


def ema_compat(x, valid, window: int, exp_factor: float) -> torch.Tensor:
    """Reference-parity truncated EMA (tsdf.py:615-635):
    EMA_t = sum_{i<window} e(1-e)^i x_{t-i}, null lags contribute 0; one
    causal depthwise convolution."""
    w = exp_factor * (1.0 - exp_factor) ** torch.arange(
        window, dtype=x.dtype, device=x.device)
    xz = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))[:, None, :]
    # full-precision float32: cuDNN would run the convolution in TF32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(F.pad(xz, (window - 1, 0)), w.flip(0)[None, None, :])
    return y[:, 0, :]
