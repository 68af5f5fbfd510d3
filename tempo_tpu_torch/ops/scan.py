"""Scans over packed [K, L] series: the exact EMA, the valid-index
scans and the forward fill, each a CUDA kernel beside its plain version.

Counterpart of ``tempo_tpu/ops/pallas_kernels.py``:

* ``ema`` (``ema_scan``, Pallas kernel ``_ema_kernel``): ``y_t = (1-a)
  y_{t-1} + a x_t``; rows with ``valid`` False carry the previous value
  forward.  Both forms combine the recurrence's (d, v) pairs by the
  same Hillis-Steele ladder with the same association as the TPU
  kernel, so f32 results round the same way.  The kernel holds a row
  in one block's registers up to 16,384 lanes and tiles longer rows in
  two stages; ``ema_tiled_plain`` runs those forms as tensor code.
* ``last_valid_index_scan`` / ``first_valid_index_scan``
  (``_last/_first_valid_index_kernel``): the running max of ``valid ?
  lane : -1`` and the reverse running min of ``valid ? lane : L``, int32.
* ``last_valid_scan`` (``_last_valid_kernel``): the value at the last
  valid lane at or before each lane (0 before the first) and has-valid.
* ``cumsum3`` (``_cumsum3_kernel``): inclusive prefix sums of masked x,
  masked x² and the valid count, by the TPU kernel's Hillis-Steele
  ladder, so float32 sums round the same way.  The kernel tiles the
  ladder (a tile-local stage, then a ladder along each residue class);
  ``cumsum3_tiled_plain`` runs the same two stages as tensor code.

A CUDA tensor goes to the kernel (``csrc/ema_ladder.cu``,
``csrc/index_scan.cu``, ``csrc/cumsum3.cu``), a CPU tensor to the plain
version, which is dtype-generic (float64 on the CPU).
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import cuda_lib


def _shift(a: torch.Tensor, span: int, identity: float) -> torch.Tensor:
    """``a`` moved right by ``span`` lanes, ``identity`` in the gap."""
    pad = torch.full(a.shape[:-1] + (span,), identity, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-span]], dim=-1)


def _ema_planes(x, valid, alpha):
    a = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    d = torch.where(valid, 1 - a, torch.ones_like(x))
    v = torch.where(valid, a * x, torch.zeros_like(x))
    return d, v


def _affine_levels(d, v, span, end, shift):
    """The EMA ladder's levels of spans ``span``, 2 ``span``, ... <
    ``end`` on (d, v), ``shift(a, span, identity)`` moving a plane."""
    while span < end:
        d_prev = shift(d, span, 1.0)
        v_prev = shift(v, span, 0.0)
        v = v + d * v_prev
        d = d * d_prev
        span *= 2
    return d, v


def ema_plain(x: torch.Tensor, valid: torch.Tensor, alpha: float
              ) -> torch.Tensor:
    """The ladder as tensor code, in ``x``'s dtype."""
    d, v = _ema_planes(x, valid, alpha)
    return _affine_levels(d, v, 1, x.shape[-1], _shift)[1]


def ema_tiled_plain(x: torch.Tensor, valid: torch.Tensor, alpha: float,
                    tile_log2: int = 10, window_log2: int = 13,
                    row_log2: int = 14) -> torch.Tensor:
    """:func:`ema_plain`'s values by the kernel's forms, bit for bit: a
    row of at most 2^``row_log2`` lanes runs the whole ladder at once
    (the one-launch form); a longer row, with T = 2^``tile_log2``, runs
    stage 1, the levels of spans < T on windows of 2^``window_log2``
    lanes (a T-lane halo, the identity (1, 0) before the row's start,
    then the window's outputs), and stage 2, the levels of spans T, 2T,
    ... < L as a ladder along each residue class ``i mod T``, the
    identity where the class index m < span / T.  In ``x``'s dtype."""
    K, L = x.shape
    d, v = _ema_planes(x, valid, alpha)
    if L <= 1 << row_log2:
        return _affine_levels(d, v, 1, L, _shift)[1]
    T, W = 1 << tile_log2, 1 << window_log2
    step = W - T
    nt = -(-L // step)
    wins = []
    for p, ident in ((d, 1.0), (v, 0.0)):
        row = torch.cat([torch.full((K, T), ident, dtype=x.dtype,
                                    device=x.device), p,
                         torch.full((K, nt * step - L), ident,
                                    dtype=x.dtype, device=x.device)], -1)
        wins.append(row.unfold(-1, W, step))        # [K, nt, W]
    wd, wv = _affine_levels(*wins, 1, T, _shift)
    M = -(-L // T)
    planes = []
    for p, ident in ((wd, 1.0), (wv, 0.0)):
        flat = p[..., T:].reshape(K, nt * step)[:, :L]
        pad = torch.full((K, M * T - L), ident, dtype=x.dtype,
                         device=x.device)
        planes.append(torch.cat([flat, pad], -1).view(K, M, T))
    _, cv = _affine_levels(*planes, 1, M,
                           lambda z, s, i: _shift(z.transpose(1, 2), s,
                                                  i).transpose(1, 2))
    return cv.reshape(K, M * T)[:, :L]


def ema_cuda(x: torch.Tensor, valid: torch.Tensor, alpha: float
             ) -> torch.Tensor:
    """Launch the ladder kernel on [K, L] float32 CUDA tensors (one call:
    one launch for rows of at most ``cuda_lib.ema_row_max()`` lanes, two
    past it, the second reading the first's d plane)."""
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
    if L > cuda_lib.ema_max_lanes():
        raise ValueError(f"ema kernel takes rows of at most "
                         f"{cuda_lib.ema_max_lanes()} lanes, got {L}")
    dplane = torch.empty_like(x) if L > cuda_lib.ema_row_max() else None
    cuda_lib.launch("ema_ladder", x.device, "tempo_ema_ladder",
                    x.data_ptr(), valid.data_ptr(), float(alpha),
                    out.data_ptr(), cuda_lib.ptr(dplane), K, L)
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
    cuda_lib.launch(entry, valid.device, f"tempo_{entry}", valid.data_ptr(),
                    out.data_ptr(), K, L)
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
    cuda_lib.launch("last_valid_scan", x.device, "tempo_last_valid_scan",
                    x.data_ptr(), valid.data_ptr(), val.data_ptr(),
                    has.data_ptr(), K, L)
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


def cumsum3_plain(x: torch.Tensor, valid: torch.Tensor):
    """(prefix sum of ``xz``, of ``xz * xz``, of the valid count), ``xz``
    = x where valid else 0, inclusive along the last axis, in ``x``'s
    dtype: the ladder ``s += shift(s, span)`` for spans 1, 2, 4, ...,
    with ``xz * xz`` formed first."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xz = torch.where(valid, x, zero)
    sums = [xz, xz * xz, valid.to(x.dtype)]
    span = 1
    while span < x.shape[-1]:
        sums = [s + _shift(s, span, 0.0) for s in sums]
        span *= 2
    return tuple(sums)


def _ladder_levels(L: int) -> int:
    """Levels of a Hillis-Steele ladder over ``L`` lanes (spans < L)."""
    return max(int(L) - 1, 0).bit_length()


def _shift_m(z: torch.Tensor, span: int) -> torch.Tensor:
    """[K, M, T] moved by ``span`` along M, 0 in the gap."""
    return _shift(z.transpose(1, 2), span, 0.0).transpose(1, 2)


def cumsum3_tiled_plain(x: torch.Tensor, valid: torch.Tensor,
                        tile_log2: int = 10):
    """:func:`cumsum3_plain`'s sums by the kernel's two stages, bit for
    bit: with T = 2^min(tile_log2, levels), stage 1 runs the ladder's
    levels of spans < T on each tile of T lanes from the tile and the T
    lanes before it alone (0 before the row's start); stage 2 runs the
    levels of spans T, 2T, ... < L as a ladder along each residue class
    ``i mod T``, 0 added where the class index m < span / T.  In
    ``x``'s dtype."""
    K, L = x.shape
    t = min(int(tile_log2), _ladder_levels(L))
    T = 1 << t
    nt = -(-L // T)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xz = torch.where(valid, x, zero)
    out = []
    for p in (xz, xz * xz, valid.to(x.dtype)):
        row = torch.cat([torch.zeros(K, T, dtype=x.dtype, device=x.device),
                         p, torch.zeros(K, nt * T - L, dtype=x.dtype,
                                        device=x.device)], -1)
        win = row.unfold(-1, 2 * T, T)          # [K, nt, 2T] tile + halo
        span = 1
        while span < T:
            win = win + _shift(win, span, 0.0)
            span *= 2
        z = win[..., T:]                         # [K, nt, T]
        span = 1
        while span * T < L:
            z = z + _shift_m(z, span)
            span *= 2
        out.append(z.reshape(K, nt * T)[:, :L])
    return tuple(out)


def cumsum3_cuda(x: torch.Tensor, valid: torch.Tensor):
    """Launch the tiled prefix-sum kernel on float32 [K, L] CUDA tensors
    (one call, two launches for rows longer than 1024 lanes)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"cumsum3 kernel takes float32 [K, L], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if valid.dtype != torch.bool or valid.shape != x.shape:
        raise TypeError("valid must be a bool tensor shaped like x")
    if not (valid.is_cuda and x.device == valid.device):
        raise ValueError("x and valid must lie on the same CUDA device")
    x, valid = x.contiguous(), valid.contiguous()
    K, L = x.shape
    out = tuple(torch.empty_like(x) for _ in range(3))
    if K == 0 or L == 0:
        return out
    if L > cuda_lib.cumsum3_max_lanes():
        raise ValueError(f"cumsum3 kernel takes rows of at most "
                         f"{cuda_lib.cumsum3_max_lanes()} lanes, got {L}")
    cuda_lib.launch("cumsum3", x.device, "tempo_cumsum3", x.data_ptr(),
                    valid.data_ptr(), *(o.data_ptr() for o in out), K, L)
    return out


def cumsum3(x: torch.Tensor, valid: torch.Tensor):
    """The three prefix sums of the windowed range engine: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return cumsum3_cuda(x, valid)
    return cumsum3_plain(x, valid)
