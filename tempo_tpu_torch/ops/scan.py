"""Exact EMA over packed [K, L] series: the CUDA ladder and its plain
version.

Counterpart of ``tempo_tpu/ops/pallas_kernels.py:ema_scan`` (Pallas
kernel ``_ema_kernel`` through ``_ema_call``).  ``y_t = (1-a) y_{t-1} +
a x_t``; rows with ``valid`` False carry the previous value forward.
Both forms combine the recurrence's (d, v) pairs by the same
Hillis-Steele ladder with the same association as the TPU kernel, so
f32 results round the same way; the plain version is dtype-generic
(float64 on the CPU).
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import cuda_lib


def _shift(a: torch.Tensor, span: int, identity: float) -> torch.Tensor:
    """``a`` moved right by ``span`` lanes, ``identity`` in the gap."""
    pad = torch.full(a.shape[:-1] + (span,), identity, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-span]], dim=-1)


def ema_plain(x: torch.Tensor, valid: torch.Tensor, alpha: float
              ) -> torch.Tensor:
    """The ladder as tensor code, in ``x``'s dtype."""
    a = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    d = torch.where(valid, 1 - a, torch.ones_like(x))
    v = torch.where(valid, a * x, torch.zeros_like(x))
    span = 1
    while span < x.shape[-1]:
        d_prev = _shift(d, span, 1.0)
        v_prev = _shift(v, span, 0.0)
        v = v + d * v_prev
        d = d * d_prev
        span *= 2
    return v


def ema_cuda(x: torch.Tensor, valid: torch.Tensor, alpha: float
             ) -> torch.Tensor:
    """Launch the ladder kernel on [K, L] float32 CUDA tensors."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"ema kernel takes float32 [K, L], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if valid.dtype != torch.bool or valid.shape != x.shape:
        raise TypeError("valid must be a bool tensor shaped like x")
    if not (valid.is_cuda and x.device == valid.device):
        raise ValueError("x and valid must lie on the same CUDA device")
    x = x.contiguous()
    valid = valid.contiguous()
    K, L = x.shape
    out = torch.empty_like(x)
    if K == 0 or L == 0:
        return out
    lib = cuda_lib.lib()
    scratch = None
    if 16 * L > lib.tempo_ema_smem_limit():
        scratch = torch.empty((K, 4, L), dtype=torch.float32,
                              device=x.device)
    code = lib.tempo_ema_ladder(
        x.data_ptr(), valid.data_ptr(), float(alpha), out.data_ptr(),
        cuda_lib.ptr(scratch), K, L, cuda_lib.stream_handle(x.device))
    cuda_lib.check(code, "ema_ladder")
    return out


def ema(x: torch.Tensor, valid: torch.Tensor, alpha: float) -> torch.Tensor:
    """Exact EMA: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return ema_cuda(x, valid, alpha)
    return ema_plain(x, valid, alpha)
