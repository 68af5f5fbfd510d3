"""Sliding-window range statistics: the CUDA kernel and its plain
version.

Counterpart of ``tempo_tpu/ops/pallas_window.py``: the Pallas kernel
``_make_kernel`` over ``_window_math``, behind
``range_stats_unrolled[_packed]`` and ``range_stats_stream[_packed]``.
Spark's rangeBetween(-window, +window_ahead) frame at row i holds the
rows j with ``secs[j]`` in ``[secs[i] - window, secs[i] + window_ahead]``;
the caller bounds its extent in rows (``max_behind`` back,
``max_ahead`` ahead) and the sweep visits exactly those shifts.  Bounds
too small truncate frames; the ``clipped`` audit counts, per row and
column, the lanes whose frame reaches past them.

One kernel serves the TPU's unrolled and runtime-width forms: the
bounds are scalars.  Outputs: ``mean``, ``count``, ``min``, ``max``,
``sum``, ``stddev``, ``zscore`` as [C, K, L] (or [K, L] for a single
column) and ``clipped`` as [C, K, 1] (or [K, 1]).
"""

from __future__ import annotations

from typing import Dict

import torch

from tempo_tpu_torch.ops import cuda_lib

STATS = ("mean", "count", "min", "max", "sum", "stddev", "zscore")

_I32_BIG = 2**31 - 1


def _clamp_window(window) -> int:
    """Key windows clamp to INT32_MAX // 2 so ``secs - w`` / ``secs + wa``
    cannot wrap for rebased (non-negative) keys (pallas_window._params)."""
    return min(int(window), _I32_BIG // 2)


def _shift(a: torch.Tensor, j: int, fill) -> torch.Tensor:
    """out[..., i] = a[..., i - j] (j < 0 looks ahead); ``fill`` outside."""
    L = a.shape[-1]
    out = torch.full_like(a, fill)
    if 0 < j < L:
        out[..., j:] = a[..., :L - j]
    elif -L < j < 0:
        out[..., :L + j] = a[..., -j:]
    elif j == 0:
        out.copy_(a)
    return out


def range_stats_plain(secs, xs, valids, window, max_behind, max_ahead,
                      window_ahead=0, scales=None) -> Dict[str, torch.Tensor]:
    """``_window_math``'s op sequence as tensor code over [C, K, L]
    stacks sharing one [K, L] key plane; dtype-generic."""
    dt = xs.dtype
    idt = secs.dtype
    C, K, L = xs.shape
    big = torch.iinfo(idt).max
    imin = torch.iinfo(idt).min
    w = _clamp_window(window)
    wa = _clamp_window(window_ahead)
    scale = _scale_vector(scales, C, dt, xs.device)
    x = xs * scale[:, None, None]
    valid = valids
    secs = secs[None]
    lane = torch.arange(L, device=xs.device)

    lo = secs - w
    hi = torch.clamp(secs + torch.clamp(big - secs, max=wa), max=big - 1)
    s_lo = torch.where(valid, secs, imin)
    s_hi = torch.where(valid, secs, big)
    zero = torch.zeros((), dtype=dt, device=xs.device)
    one = torch.ones((), dtype=dt, device=xs.device)
    pinf = torch.tensor(float("inf"), dtype=dt, device=xs.device)
    validf = valid.to(dt)
    xz = torch.where(valid, x, zero)
    nv = validf.sum(-1, keepdim=True)
    center = xz.sum(-1, keepdim=True) / torch.maximum(nv, one)
    xc = torch.where(valid, x - center, zero)
    xc2 = xc * xc

    cnt, s1, s2 = validf, xc, xc2
    mn = torch.where(valid, xc, pinf)
    mx = torch.where(valid, xc, -pinf)

    def accumulate(inw, xj, xj2):
        nonlocal cnt, s1, s2, mn, mx
        cnt = cnt + inw.to(dt)
        s1 = s1 + torch.where(inw, xj, zero)
        s2 = s2 + torch.where(inw, xj2, zero)
        mn = torch.minimum(mn, torch.where(inw, xj, pinf))
        mx = torch.maximum(mx, torch.where(inw, xj, -pinf))

    for j in range(1, min(int(max_behind), L - 1) + 1):
        inw = (_shift(s_lo, j, imin) >= lo) & (lane >= j)
        accumulate(inw, _shift(xc, j, 0.0), _shift(xc2, j, 0.0))
    for j in range(1, min(int(max_ahead), L - 1) + 1):
        inw = (_shift(s_hi, -j, big) <= hi) & (lane < L - j)
        accumulate(inw, _shift(xc, -j, 0.0), _shift(xc2, -j, 0.0))

    nan = torch.tensor(float("nan"), dtype=dt, device=xs.device)
    cnt1 = torch.maximum(cnt, one)
    mean = torch.where(cnt > 0, s1 / cnt1 + center, nan)
    total = s1 + cnt * center
    var = torch.where(cnt > 1, (s2 - s1 * s1 / cnt1)
                      / torch.maximum(cnt - one, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)

    clipped = torch.zeros_like(valid)
    for behind in (True, False):
        jb = min((int(max_behind) if behind else int(max_ahead)) + 1, L)
        shift = jb if behind else -jb
        ok = (lane >= jb) if behind else (lane < L - jb)
        sj = torch.where(ok, _shift(secs, shift, big), big)
        vj = ok & _shift(valid, shift, False)
        clipped = clipped | ((sj >= lo) & (sj <= hi) & (valid | vj))

    return {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, mn + center, nan),
        "max": torch.where(cnt > 0, mx + center, nan),
        "sum": torch.where(cnt > 0, total, nan),
        "stddev": std,
        "zscore": torch.where(valid, (x - mean) / std, nan),
        "clipped": clipped.to(dt).sum(-1, keepdim=True),
    }


def _scale_vector(scales, C: int, dtype, device) -> torch.Tensor:
    if scales is None:
        return torch.ones(C, dtype=dtype, device=device)
    s = torch.as_tensor(scales, dtype=dtype, device=device).reshape(-1)
    return s if s.shape[0] == C else s.expand(C).contiguous()


def range_stats_cuda(secs, xs, valids, window, max_behind, max_ahead,
                     window_ahead=0, scales=None) -> Dict[str, torch.Tensor]:
    """Launch the range-stats kernel: int32 [K, L] keys, float32 and
    bool [C, K, L] stacks, all on one CUDA device."""
    if secs.dtype != torch.int32 or secs.dim() != 2:
        raise TypeError("range-stats kernel takes int32 [K, L] keys "
                        "(rebased seconds)")
    if xs.dtype != torch.float32 or xs.dim() != 3:
        raise TypeError("range-stats kernel takes float32 [C, K, L] values")
    if valids.dtype != torch.bool or valids.shape != xs.shape \
            or tuple(xs.shape[1:]) != tuple(secs.shape):
        raise TypeError("valid must be bool [C, K, L] over [K, L] keys")
    if not (secs.is_cuda and xs.device == secs.device
            and valids.device == secs.device):
        raise ValueError("keys, values and valid must lie on one CUDA "
                         "device")
    C, K, L = xs.shape
    secs, xs, valids = secs.contiguous(), xs.contiguous(), valids.contiguous()
    scale = _scale_vector(scales, C, torch.float32, xs.device)
    out = torch.empty((len(STATS), C, K, L), dtype=torch.float32,
                      device=xs.device)
    clipped = torch.empty((C, K, 1), dtype=torch.float32, device=xs.device)
    if C and K and L:
        code = cuda_lib.lib().tempo_range_stats(
            secs.data_ptr(), xs.data_ptr(), valids.data_ptr(),
            scale.data_ptr(), out.data_ptr(), clipped.data_ptr(),
            _clamp_window(window), _clamp_window(window_ahead),
            int(max_behind), int(max_ahead), C, K, L,
            cuda_lib.stream_handle(xs.device))
        cuda_lib.check(code, "range_stats")
    else:
        clipped.zero_()
    stats = {name: out[i] for i, name in enumerate(STATS)}
    stats["clipped"] = clipped
    return stats


def range_stats(secs, xs, valids, window, max_behind, max_ahead,
                window_ahead=0, scales=None) -> Dict[str, torch.Tensor]:
    """rangeBetween(-window, +window_ahead) aggregates of [C, K, L] (or
    [K, L]) values over one [K, L] ascending key plane: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    single = xs.dim() == 2
    if single:
        xs, valids = xs[None], valids[None]
    fn = range_stats_cuda if xs.is_cuda else range_stats_plain
    stats = fn(secs, xs, valids, window, max_behind, max_ahead,
               window_ahead=window_ahead, scales=scales)
    if single:
        stats = {k: v[0] for k, v in stats.items()}
    return stats
