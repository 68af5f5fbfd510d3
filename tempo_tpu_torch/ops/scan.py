"""Scans over packed [K, L] series: the exact EMA, the valid-index
scans and the forward fill, each a CUDA kernel beside its plain version.

Counterpart of ``tempo_tpu/ops/pallas_kernels.py``:

* ``ema`` (``ema_scan``, Pallas kernel ``_ema_kernel``): ``y_t = (1-a)
  y_{t-1} + a x_t``; rows with ``valid`` False carry the previous value
  forward.  Both forms combine the recurrence's (d, v) pairs by the
  same Hillis-Steele ladder with the same association as the TPU
  kernel, so f32 results round the same way.
* ``last_valid_index_scan`` / ``first_valid_index_scan``
  (``_last/_first_valid_index_kernel``): the running max of ``valid ?
  lane : -1`` and the reverse running min of ``valid ? lane : L``, int32.
* ``last_valid_scan`` (``_last_valid_kernel``): the value at the last
  valid lane at or before each lane (0 before the first) and has-valid.

A CUDA tensor goes to the kernel (``csrc/ema_ladder.cu``,
``csrc/index_scan.cu``), a CPU tensor to the plain version, which is
dtype-generic (float64 on the CPU).
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


def _lanes(valid: torch.Tensor) -> torch.Tensor:
    return torch.arange(valid.shape[-1], dtype=torch.int32,
                        device=valid.device).expand(valid.shape)


def last_valid_index_scan_plain(valid: torch.Tensor) -> torch.Tensor:
    """Running index of the last True at or before each lane; -1 before
    the first (``torch.cummax`` of the candidate lanes)."""
    cand = torch.where(valid, _lanes(valid), -1)
    return torch.cummax(cand, dim=-1).values


def first_valid_index_scan_plain(valid: torch.Tensor) -> torch.Tensor:
    """Index of the first True at or after each lane; L where none (the
    mirrored ``torch.cummin``)."""
    cand = torch.where(valid, _lanes(valid), valid.shape[-1])
    return torch.cummin(cand.flip(-1), dim=-1).values.flip(-1)


def last_valid_scan_plain(x: torch.Tensor, valid: torch.Tensor):
    """(value at the last valid lane at or before each lane, 0 before the
    first; whether there is one), in ``x``'s dtype."""
    idx = last_valid_index_scan_plain(valid)
    has = idx >= 0
    got = torch.gather(x, -1, idx.clamp(min=0).to(torch.int64))
    return torch.where(has, got, torch.zeros((), dtype=x.dtype,
                                             device=x.device)), has


def _check_mask(valid: torch.Tensor) -> None:
    if valid.dtype != torch.bool or valid.dim() != 2:
        raise TypeError(f"index scans take a bool [K, L] mask, got "
                        f"{valid.dtype} {tuple(valid.shape)}")
    if not valid.is_cuda:
        raise ValueError("the mask must lie on a CUDA device")


def _index_scan_cuda(valid: torch.Tensor, entry: str) -> torch.Tensor:
    _check_mask(valid)
    valid = valid.contiguous()
    K, L = valid.shape
    out = torch.empty((K, L), dtype=torch.int32, device=valid.device)
    if K == 0 or L == 0:
        return out
    code = getattr(cuda_lib.lib(), f"tempo_{entry}")(
        valid.data_ptr(), out.data_ptr(), K, L,
        cuda_lib.stream_handle(valid.device))
    cuda_lib.check(code, entry)
    return out


def last_valid_index_scan_cuda(valid: torch.Tensor) -> torch.Tensor:
    """Launch the last-valid-index kernel on a bool [K, L] CUDA mask."""
    return _index_scan_cuda(valid, "last_valid_index")


def first_valid_index_scan_cuda(valid: torch.Tensor) -> torch.Tensor:
    """Launch the first-valid-index kernel on a bool [K, L] CUDA mask."""
    return _index_scan_cuda(valid, "first_valid_index")


def last_valid_scan_cuda(x: torch.Tensor, valid: torch.Tensor):
    """Launch the forward-fill kernel on float32 [K, L] CUDA tensors."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"last_valid_scan kernel takes float32 [K, L], got "
                        f"{x.dtype} {tuple(x.shape)}")
    _check_mask(valid)
    if valid.shape != x.shape or x.device != valid.device:
        raise ValueError("x and valid must share shape and CUDA device")
    x = x.contiguous()
    valid = valid.contiguous()
    K, L = x.shape
    val = torch.empty_like(x)
    has = torch.empty_like(valid)
    if K == 0 or L == 0:
        return val, has
    code = cuda_lib.lib().tempo_last_valid_scan(
        x.data_ptr(), valid.data_ptr(), val.data_ptr(), has.data_ptr(), K, L,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(code, "last_valid_scan")
    return val, has


def last_valid_index_scan(valid: torch.Tensor) -> torch.Tensor:
    """Last-valid lane index: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if valid.is_cuda:
        return last_valid_index_scan_cuda(valid)
    return last_valid_index_scan_plain(valid)


def first_valid_index_scan(valid: torch.Tensor) -> torch.Tensor:
    """First-valid lane index: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if valid.is_cuda:
        return first_valid_index_scan_cuda(valid)
    return first_valid_index_scan_plain(valid)


def last_valid_scan(x: torch.Tensor, valid: torch.Tensor):
    """(ffilled values, any-valid-so-far mask) over [K, L]: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return last_valid_scan_cuda(x, valid)
    return last_valid_scan_plain(x, valid)
