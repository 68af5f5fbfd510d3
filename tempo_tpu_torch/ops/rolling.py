"""Range-stats engines and EMA forms on packed [K, L] series.

Counterpart of ``tempo_tpu/ops/rolling.py``: ``pick_range_engine``,
``windowed_stats``, ``segment_stats``, ``ema_exact`` and ``ema_compat``.

The reference has three range engines; two of them, ``shifted`` and
``stream``, are the unrolled and runtime-width forms of one Pallas
kernel, and here one CUDA kernel (``ops/window.range_stats``) serves
both, so the port picks between two:

* ``shifted``: the range-stats kernel over the frame's row bounds, up to
  ``TEMPO_TPU_STREAM_MAX_ROWS`` rows of extent;
* ``windowed``: prefix sums + sparse-table min/max, for spans past int32
  or wider frames.  Its TPU kernel (``pallas_kernels._cumsum3_kernel``)
  is not ported yet, so on a CUDA tensor it raises; on the CPU its plain
  form runs.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from tempo_tpu_torch import config
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.ops.sortmerge import not_ported
from tempo_tpu_torch.ops.window_utils import merge_rank, shift_right

WINDOWED_ENGINE = "queue B item 2: cumsum3, pallas_kernels.py:161"


def stream_max_rows() -> int:
    n = config.get_int("TEMPO_TPU_STREAM_MAX_ROWS")
    return 16384 if n is None else int(n)


def pick_range_engine(max_behind: int, max_ahead: int) -> str:
    """'shifted' | 'windowed' for a frame whose row extent is
    (max_behind, max_ahead).  ``TEMPO_TPU_WINDOW_ENGINE=windowed`` forces
    the windowed form; the reference's other values ('shifted',
    'stream') both name the row-bounded kernel."""
    forced = (config.get("TEMPO_TPU_WINDOW_ENGINE") or "auto").lower()
    if forced == "windowed":
        return "windowed"
    if forced in ("shifted", "stream"):
        return "shifted"
    if int(max_behind) + int(max_ahead) <= stream_max_rows():
        return "shifted"
    return "windowed"


def range_window_bounds(ts_long: torch.Tensor, window_secs):
    """Per-row [start, end) of rangeBetween(-window_secs, 0) over a
    sorted integer seconds axis; ``end`` includes following ties."""
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


def windowed_stats(x, valid, start, end) -> Dict[str, torch.Tensor]:
    """mean/count/min/max/sum/stddev/zscore over per-row [start, end)
    windows: mean-centred prefix sums plus sparse-table min/max.  Plain
    tensor code for CPU tensors."""
    if x.is_cuda:
        raise not_ported("the windowed range-stats engine", WINDOWED_ENGINE)
    dt = x.dtype
    zero = torch.zeros((), dtype=dt)
    one = torch.ones((), dtype=dt)
    nan = torch.tensor(float("nan"), dtype=dt)
    pinf = torch.tensor(float("inf"), dtype=dt)
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

    s1 = win(torch.cumsum(xc, -1))
    s2 = win(torch.cumsum(xc * xc, -1))
    cnt = win(torch.cumsum(valid.to(dt), -1))
    mean = torch.where(cnt > 0, s1 / torch.maximum(cnt, one) + center, nan)
    total = s1 + cnt * center
    var = torch.where(cnt > 1, (s2 - s1 * s1 / torch.maximum(cnt, one))
                      / torch.maximum(cnt - 1, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    L = x.shape[-1]
    nlev = max(1, (L - 1).bit_length() + 1)
    tmin = _sparse_table(torch.where(valid, x, pinf), pinf, torch.minimum,
                         nlev)
    tmax = _sparse_table(torch.where(valid, x, -pinf), -pinf, torch.maximum,
                         nlev)
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


def segment_stats(x: torch.Tensor, valid: torch.Tensor,
                  seg_ids: torch.Tensor, num_segments: int
                  ) -> Dict[str, torch.Tensor]:
    """Six grouped aggregates per segment of flat ``[n]`` rows
    (withGroupedStats tsdf.py:750-754), as tensor ops on either device:
    ``index_add_`` sums and ``scatter_reduce_`` min/max over the segment
    ids.  On a CUDA tensor ``index_add_`` adds with atomics, in an order
    that changes from run to run, so float32 sums there are exact only to
    about ``n_seg * eps * sum|x|`` (n_seg the rows of a segment)."""
    dt, dev = x.dtype, x.device
    seg = seg_ids.to(torch.int64)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    xz = torch.where(valid, x, zero)

    def seg_sum(v):
        return torch.zeros(num_segments, dtype=dt, device=dev).index_add_(
            0, seg, v)

    def seg_reduce(v, fill, how):
        return torch.full((num_segments,), fill, dtype=dt,
                          device=dev).scatter_reduce_(0, seg, v, how)

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
