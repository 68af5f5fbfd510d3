"""Tumbling-bucket kernels over packed [K, L] series.

Counterpart of ``tempo_tpu/ops/pallas_bucket.py``:

* ``resample_ema`` (``resample_ema_pallas``, Pallas kernel
  ``_resample_ema_kernel``; bench config 3), the fused floor-resample +
  exact EMA: ``res`` is ``x * scale`` at each bucket's first row when that
  row is valid (NaN elsewhere), ``ema`` the exact EMA over those head
  samples (``csrc/resample_ema.cu``);
* ``bucket_stats`` (``bucket_stats_pallas`` / ``bucket_stats_packed``,
  Pallas kernel ``_make_bucket_kernel`` over ``_bucket_math``): mean,
  count, min, max, sum, stddev and zscore of each row's tumbling bucket
  (runs of equal int32 bucket id), broadcast to every row of the bucket,
  for a [C, K, L] stack of columns sharing one [K, L] id plane
  (``csrc/bucket_stats.cu``).

A CUDA tensor goes to the kernel, a CPU tensor to the plain version,
which repeats the kernel's op sequence and ladders and is dtype-generic.

Both kernels have a row form and a staged form (``ops/stream.py``, the
counterpart of the reference's ``TEMPO_TPU_DMA_BUFFERS`` ring): the
wrapper takes the staged form where its planner finds a plan, else the
row form; the private keyword ``_form`` ("row" | "ring") forces one,
for tests and ``chip_smoke.py``.  :func:`bucket_stats_windowed` emulates
the staged bucket form's tile-local ladder in tensor code, so the CPU
tests can pin its bits against the plain version.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tempo_tpu_torch.ops import cuda_lib, scan, stream


def _integral_step(step) -> int:
    """``step`` as an int >= 1 (the bucketing is exact integer
    division), else ``ValueError``."""
    step_i = int(step)
    if step_i != step or step_i < 1:
        raise ValueError(
            f"resample_ema needs an integral step >= 1 in the "
            f"seconds unit of `secs`, got {step!r}; rescale secs (e.g. "
            f"to ms) for sub-second buckets"
        )
    return step_i


def heads(secs: torch.Tensor, valid: torch.Tensor, step: int):
    """First row of each floor(secs / step) bucket run, where it is
    valid (any integer dtype of ``secs``)."""
    bucket = torch.div(secs, step, rounding_mode="floor")
    first = torch.ones_like(bucket[:, :1], dtype=torch.bool)
    return torch.cat([first, bucket[:, 1:] != bucket[:, :-1]], -1) & valid


def resample_ema_plain(secs: torch.Tensor, x: torch.Tensor,
                       valid: torch.Tensor, step, alpha: float,
                       scale=None):
    """(res, ema) as tensor code, in ``x``'s dtype; ``secs`` integral."""
    step = _integral_step(step)
    xs = x * torch.as_tensor(1.0 if scale is None else scale, dtype=x.dtype,
                             device=x.device)
    head = heads(secs, valid, step)
    res = torch.where(head, xs, torch.full((), float("nan"), dtype=x.dtype,
                                           device=x.device))
    return res, scan.ema_plain(xs, head, alpha)


def resample_ema_cuda(secs: torch.Tensor, x: torch.Tensor,
                      valid: torch.Tensor, step, alpha: float, scale=None, *,
                      _form: Optional[str] = None):
    """Launch the fused kernel on int32 secs, float32 x and bool valid,
    all [K, L] on one CUDA device: the staged form where
    ``stream.resample_plan`` fits, else the row form."""
    step = _integral_step(step)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"resample_ema kernel takes float32 [K, L], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if secs.dtype != torch.int32 or secs.shape != x.shape:
        raise TypeError("secs must be an int32 tensor shaped like x")
    if valid.dtype != torch.bool or valid.shape != x.shape:
        raise TypeError("valid must be a bool tensor shaped like x")
    if not (x.is_cuda and secs.device == x.device == valid.device):
        raise ValueError("secs, x and valid must lie on one CUDA device")
    secs, x, valid = secs.contiguous(), x.contiguous(), valid.contiguous()
    K, L = x.shape
    res = torch.empty_like(x)
    ema = torch.empty_like(x)
    if K == 0 or L == 0:
        return res, ema
    plan = stream.pick("resample_ema", stream.resample_plan(L), _form,
                       f"L={L}")
    if plan is not None:
        cuda_lib.launch("resample_ema_ring", x.device,
                        "tempo_resample_ema_ring", secs.data_ptr(),
                        x.data_ptr(), valid.data_ptr(), step, float(alpha),
                        1.0 if scale is None else float(scale),
                        res.data_ptr(), ema.data_ptr(), K, L, plan.tile,
                        plan.depth)
        return res, ema
    scratch = cuda_lib.ladder_scratch(K, L, 4, x.device)
    cuda_lib.launch("resample_ema", x.device, "tempo_resample_ema",
                    secs.data_ptr(), x.data_ptr(), valid.data_ptr(), step,
                    float(alpha), 1.0 if scale is None else float(scale),
                    res.data_ptr(), ema.data_ptr(), cuda_lib.ptr(scratch),
                    K, L)
    return res, ema


def resample_ema(secs: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                 step, alpha: float, scale=None):
    """Fused floor-resample + exact EMA: the kernel for CUDA tensors, the
    plain version for CPU tensors.  ``step`` must be an integer >= 1 in
    the unit of ``secs``; ``scale`` (a scalar) multiplies x first."""
    if x.is_cuda:
        return resample_ema_cuda(secs, x, valid, step, alpha, scale)
    return resample_ema_plain(secs, x, valid, step, alpha, scale)


BUCKET_STATS = ("mean", "count", "min", "max", "sum", "stddev", "zscore")
# the ladder's float planes (two sets of count, s1, s2, min, max, flag)
# and the static shared memory of the kernel's block reduction
_BUCKET_PLANES = 12
_BUCKET_STATIC_SMEM = 256


def _bucket_flags(bid: torch.Tensor, dtype):
    """(head, tail) flags of each run of equal ids along the lanes, as
    0/1 planes of ``dtype``."""
    edge = torch.ones_like(bid[:, :1], dtype=torch.bool)
    change = bid[:, 1:] != bid[:, :-1]
    return (torch.cat([edge, change], -1).to(dtype),
            torch.cat([change, edge], -1).to(dtype))


def _shift_back(a: torch.Tensor, span: int, fill: float) -> torch.Tensor:
    """``a[..., i - span]``, ``fill`` where that runs off the row."""
    return scan._shift(a, span, fill)


def _shift_fwd(a: torch.Tensor, span: int, fill: float) -> torch.Tensor:
    """``a[..., i + span]``, ``fill`` where that runs off the row."""
    pad = torch.full(a.shape[:-1] + (span,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[..., span:], pad], dim=-1)


def _bucket_center(xs: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """Each row's centre, ``sum(valid ? x : 0) / max(n_valid, 1)``."""
    dt, dev = xs.dtype, xs.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nv = valids.to(dt).sum(-1, keepdim=True)
    return torch.where(valids, xs, zero).sum(-1, keepdim=True) \
        / torch.maximum(nv, one)


def _bucket_ladder(bid, xs, valids, center, stop_early: bool = False):
    """The two ladders and the outputs over the lanes given, around the
    given centre ([C, K, 1]).  ``stop_early`` ends each ladder after the
    first pass that leaves every flag set (the staged kernel's stop):
    the passes after it would only copy."""
    dt, dev = xs.dtype, xs.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    L = xs.shape[-1]
    f, g = _bucket_flags(bid, dt)
    validf = valids.to(dt)
    xc = torch.where(valids, xs - center, zero)
    planes = [validf, xc, xc * xc, torch.where(valids, xs, pinf),
              torch.where(valids, xs, -pinf)]
    ops = [(torch.add, 0.0)] * 3 + [(torch.minimum, float("inf")),
                                    (torch.maximum, float("-inf"))]
    span = 1
    while span < L:
        planes = [torch.where(f > 0, p, combine(p, _shift_back(p, span, ident)))
                  for p, (combine, ident) in zip(planes, ops)]
        f = torch.maximum(f, _shift_back(f, span, 1.0))
        span *= 2
        if stop_early and bool((f > 0).all()):
            break
    span = 1
    while span < L:
        planes = [torch.where(g > 0, p, _shift_fwd(p, span, 0.0))
                  for p in planes]
        g = torch.maximum(g, _shift_fwd(g, span, 0.0))
        span *= 2
        if stop_early and bool((g > 0).all()):
            break
    cnt, s1, s2, mn, mx = planes
    cnt1 = torch.maximum(cnt, one)
    mean = torch.where(cnt > 0, s1 / cnt1 + center, nan)
    total = s1 + cnt * center
    var = torch.where(cnt > 1, (s2 - s1 * s1 / cnt1)
                      / torch.maximum(cnt - one, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    return {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, mn, nan),
        "max": torch.where(cnt > 0, mx, nan),
        "sum": torch.where(cnt > 0, total, nan),
        "stddev": std,
        "zscore": torch.where(valids, (xs - mean) / std, nan),
    }


def bucket_stats_plain(bid: torch.Tensor, xs: torch.Tensor,
                       valids: torch.Tensor):
    """``_bucket_math`` op for op as tensor code over [C, K, L] stacks
    sharing one [K, L] id plane, in ``xs``'s dtype: the row centre, the
    forward segmented Hillis-Steele scan of the five planes (identity and
    flag 1 shifted in), the reverse tail broadcast (0 shifted in), then
    the outputs."""
    return _bucket_ladder(bid, xs, valids, _bucket_center(xs, valids))


def bucket_windows(bid_row: torch.Tensor, tile: int) -> Optional[List[int]]:
    """The staged bucket form's window starts over one row of ids: 0,
    then repeatedly the last bucket head in (s, s + tile], until a window
    reaches the row's end; None where a bucket is longer than ``tile``
    (the kernel leaves that row to the row form)."""
    L = int(bid_row.shape[0])
    starts, s = [0], 0
    while s + tile < L:
        seg = bid_row[s:s + tile + 1]
        heads = torch.nonzero(seg[1:] != seg[:-1]).flatten()
        if heads.numel() == 0:
            return None
        s += int(heads.max()) + 1
        starts.append(s)
    return starts


def bucket_stats_windowed(bid: torch.Tensor, xs: torch.Tensor,
                          valids: torch.Tensor, tile: int):
    """The staged bucket form's arithmetic in tensor code: each row's
    centre over the whole row, then the ladders over windows of at most
    ``tile`` lanes that start at bucket heads (:func:`bucket_windows`),
    each window writing the lanes up to the next start and stopping its
    ladders once every lane is complete; a row with a bucket longer than
    ``tile`` takes the whole-row ladder.  Tests hold it bitwise against
    :func:`bucket_stats_plain`."""
    C, K, L = xs.shape
    center = _bucket_center(xs, valids)
    out = {k: torch.empty_like(xs) for k in BUCKET_STATS}
    for k in range(K):
        starts = bucket_windows(bid[k], tile)
        cuts = [(0, L, L)] if starts is None else [
            (s, e, min(tile, L - s)) for s, e in zip(starts, starts[1:] + [L])]
        for s, e, n in cuts:
            got = _bucket_ladder(bid[k:k + 1, s:s + n],
                                 xs[:, k:k + 1, s:s + n],
                                 valids[:, k:k + 1, s:s + n],
                                 center[:, k:k + 1],
                                 stop_early=starts is not None)
            for name in BUCKET_STATS:
                out[name][:, k, s:e] = got[name][:, 0, :e - s]
    return out


def _bucket_row_form(bid, xs, valids, out) -> None:
    C, K, L = xs.shape
    scratch = cuda_lib.ladder_scratch(K, L, _BUCKET_PLANES, xs.device,
                                      _BUCKET_STATIC_SMEM)
    cuda_lib.launch("bucket_stats", xs.device, "tempo_bucket_stats",
                    bid.data_ptr(), xs.data_ptr(), valids.data_ptr(),
                    out.data_ptr(), cuda_lib.ptr(scratch), C, K, L)


def bucket_stats_cuda(bid: torch.Tensor, xs: torch.Tensor,
                      valids: torch.Tensor, *, _form: Optional[str] = None):
    """Launch the bucket-stats kernel on an int32 [K, L] id plane and
    float32 / bool [C, K, L] stacks, all on one CUDA device: the staged
    form where ``stream.bucket_plan`` fits (rows with a bucket longer
    than its tile then take the row form, one more launch), else the row
    form."""
    if bid.dtype != torch.int32 or bid.dim() != 2:
        raise TypeError("bucket-stats kernel takes int32 [K, L] bucket ids")
    if xs.dtype != torch.float32 or xs.dim() != 3:
        raise TypeError("bucket-stats kernel takes float32 [C, K, L] values")
    if valids.dtype != torch.bool or valids.shape != xs.shape \
            or tuple(xs.shape[1:]) != tuple(bid.shape):
        raise TypeError("valid must be bool [C, K, L] over [K, L] ids")
    if not (bid.is_cuda and xs.device == bid.device
            and valids.device == bid.device):
        raise ValueError("ids, values and valid must lie on one CUDA device")
    C, K, L = xs.shape
    bid, xs, valids = bid.contiguous(), xs.contiguous(), valids.contiguous()
    out = torch.empty((len(BUCKET_STATS), C, K, L), dtype=torch.float32,
                      device=xs.device)
    if C and K and L:
        plan = stream.pick("bucket_stats", stream.bucket_plan(C, L), _form,
                           f"C={C}, L={L}")
        if plan is None:
            _bucket_row_form(bid, xs, valids, out)
        else:
            long_rows = torch.empty(K, dtype=torch.int32, device=xs.device)
            n_long = torch.zeros(1, dtype=torch.int32, device=xs.device)
            cuda_lib.launch("bucket_stats_ring", xs.device,
                            "tempo_bucket_stats_ring", bid.data_ptr(),
                            xs.data_ptr(), valids.data_ptr(), out.data_ptr(),
                            long_rows.data_ptr(), n_long.data_ptr(), C, K, L,
                            plan.tile, plan.depth)
            n = int(n_long.item())
            stream.last_plan["bucket_stats"]["long_rows"] = n
            if n:
                rows = long_rows[:n].long()
                sub = torch.empty((len(BUCKET_STATS), C, n, L),
                                  dtype=torch.float32, device=xs.device)
                _bucket_row_form(bid[rows], xs[:, rows], valids[:, rows], sub)
                out[:, :, rows] = sub
    return {name: out[i] for i, name in enumerate(BUCKET_STATS)}


def bucket_stats(bid: torch.Tensor, xs: torch.Tensor, valids: torch.Tensor):
    """Tumbling-bucket aggregates of [C, K, L] (or [K, L]) values over one
    [K, L] int32 bucket-id plane, non-decreasing along each row (pad
    lanes carry an id of their own; callers mask their outputs): the
    kernel for CUDA tensors, the plain version for CPU tensors.  Returns
    the seven ``BUCKET_STATS`` planes shaped like ``xs``."""
    single = xs.dim() == 2
    if single:
        xs, valids = xs[None], valids[None]
    fn = bucket_stats_cuda if xs.is_cuda else bucket_stats_plain
    stats = fn(bid, xs, valids)
    if single:
        stats = {k: v[0] for k, v in stats.items()}
    return stats
