"""Tumbling-bucket kernels over packed [K, L] series.

Counterpart of ``tempo_tpu/ops/pallas_bucket.py``, so far its fused
floor-resample + exact EMA (``resample_ema_pallas``, Pallas kernel
``_resample_ema_kernel``; bench config 3): ``res`` is ``x * scale`` at
each bucket's first row when that row is valid (NaN elsewhere), ``ema``
the exact EMA over those head samples.  A CUDA tensor goes to the kernel
(``csrc/resample_ema.cu``), a CPU tensor to the plain version, which
repeats the kernel's op sequence and ladder and is dtype-generic.
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import cuda_lib, scan


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
                      valid: torch.Tensor, step, alpha: float, scale=None):
    """Launch the fused kernel on int32 secs, float32 x and bool valid,
    all [K, L] on one CUDA device."""
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
    scratch = cuda_lib.ladder_scratch(K, L, 4, x.device)
    code = cuda_lib.lib().tempo_resample_ema(
        secs.data_ptr(), x.data_ptr(), valid.data_ptr(), step, float(alpha),
        1.0 if scale is None else float(scale), res.data_ptr(),
        ema.data_ptr(), cuda_lib.ptr(scratch), K, L,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(code, "resample_ema")
    return res, ema


def resample_ema(secs: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                 step, alpha: float, scale=None):
    """Fused floor-resample + exact EMA: the kernel for CUDA tensors, the
    plain version for CPU tensors.  ``step`` must be an integer >= 1 in
    the unit of ``secs``; ``scale`` (a scalar) multiplies x first."""
    if x.is_cuda:
        return resample_ema_cuda(secs, x, valid, step, alpha, scale)
    return resample_ema_plain(secs, x, valid, step, alpha, scale)
