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

The kernel (``csrc/legacy_stats.cu``) is range stats' walk in the legacy
order: ``window.cuh``'s centre pass, then a block per (column, row, tile
of 1024 outputs), each thread walking four consecutive outputs over a
shared-memory window of the tile and its halo (several windows where the
halo is wider).  ``_center_out`` receives the kernel's centres, which
:func:`legacy_stats_plain` takes back as ``_centers`` to give the same
bits; :func:`legacy_stats_tiled_plain` runs the kernel's tiles, windows
and walk as tensor code.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tempo_tpu_torch.ops import cuda_lib
from tempo_tpu_torch.ops.window import (STATS, _clamp_window, _given_center,
                                        _shift)


def legacy_stats_plain(secs, xs, valids, window, max_behind, max_ahead, *,
                       _centers=None) -> Dict[str, torch.Tensor]:
    """``_make_kernel``'s op sequence as tensor code over [C, K, L]
    stacks sharing one [K, L] key plane; dtype-generic.  ``_centers``
    ([C, K]) replaces each row's centre (the card passes its kernel's)."""
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

    if _centers is None:
        xz = torch.where(valid, x, zero)
        nv = valid.to(dt).sum(-1, keepdim=True)
        center = xz.sum(-1, keepdim=True) / torch.maximum(nv, one)
    else:
        center = _given_center(_centers, C, K, dt)
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


#: the kernel's block (threads), the consecutive outputs a thread owns,
#: and the most lanes its shared-memory window holds (``kLegacyThreads``,
#: ``kLanes`` and ``kLegacyWindow`` in ``csrc/legacy_stats.cu``)
LEGACY_THREADS, LEGACY_LANES, LEGACY_WINDOW = 256, 4, 1536


def legacy_windows(hb: int, ha: int, lanes: int, tile: int,
                   window_cap: Optional[int]):
    """The kernel's windows over the offsets d from a thread's first
    output, [-hb, lanes - 1 + ha] from the top down, each ``window_cap -
    (tile - lanes)`` offsets wide (one window where the tile and its halo
    fit ``window_cap`` lanes, or where it is None): [(dl, dh), ...]."""
    top, bottom = lanes - 1 + ha, -hb
    cap = tile + hb + ha
    if window_cap is not None:
        cap = min(cap, int(window_cap))
    span = cap - (tile - lanes)
    out, dh = [], top
    while dh >= bottom:
        dl = max(dh - span + 1, bottom)
        out.append((dl, dh))
        dh = dl - 1
    return out


def legacy_stats_tiled_plain(secs, xs, valids, window, max_behind, max_ahead,
                             *, threads: int = LEGACY_THREADS,
                             window_cap: Optional[int] = LEGACY_WINDOW,
                             _centers=None) -> Dict[str, torch.Tensor]:
    """:func:`legacy_stats_plain`'s stats as the kernel cuts them, bit for
    bit: tiles of ``threads * 4`` outputs, each thread four consecutive
    ones (its first at i0), its own lanes read from the rows; the windows
    of :func:`legacy_windows`, each neighbour read checked to lie inside
    the current one; the walk over offsets d from ``3 + ma`` down to
    ``-mb`` (neighbours inside the row), output e taking d in [e - mb,
    e + ma], with the active outputs of each step as the kernel's head,
    middle and tail (or its generic loop where the bounds sum below 3);
    every accumulator updated only where the neighbour is in the frame,
    min and max NaN-propagating; the audit's lanes beyond the row as the
    largest key, not valid.  ``_centers`` as for
    :func:`legacy_stats_plain`."""
    dt, idt, dev = xs.dtype, secs.dtype, xs.device
    C, K, L = xs.shape
    big = torch.iinfo(idt).max
    x, valid = xs, valids
    if _centers is None:
        nv = valid.to(dt).sum(-1, keepdim=True)
        center = (torch.where(valid, x, torch.zeros((), dtype=dt, device=dev))
                  .sum(-1, keepdim=True) / torch.clamp(nv, min=1))
    else:
        center = _given_center(_centers, C, K, dt)
    w = _clamp_window(window)
    E = LEGACY_LANES
    T = int(threads) * E
    mb, ma = min(int(max_behind), L), min(int(max_ahead), L)
    jb, ja = min(mb, L - 1), min(ma, L - 1)
    hb, ha = min(mb + 1, L), min(ma + 1, L)
    nth = -(-L // T) * int(threads)
    i0 = torch.arange(nth, device=dev) * E             # [NTH]
    t0 = i0 // T * T
    e = torch.arange(E, device=dev)
    i = i0[:, None] + e                                  # [NTH, E]
    zero = torch.zeros((), dtype=dt, device=dev)
    nzero = torch.tensor(-0.0, dtype=dt, device=dev)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)     # positive
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    bigt = torch.tensor(big, dtype=idt, device=dev)
    # the window entries: c, c*c (-0.0 where invalid; a NaN made positive,
    # as the card's), key, raw x
    c_pl = torch.where(valid, x - center, zero)
    c2_pl = c_pl * c_pl
    c2_pl = torch.where(valid, torch.where(torch.isnan(c2_pl), nan, c2_pl),
                        nzero)
    key_pl = secs[None].expand(C, K, L)
    win = {}

    def at(p):
        """Entries at lanes p ([NTH] or [NTH, E]) -> [C, K, *p.shape]
        each, the pad entry outside the row; p must lie in the current
        window."""
        lo_, hi_ = win["offsets"]
        tt = t0.reshape((-1,) + (1,) * (p.dim() - 1))
        assert bool(((p >= tt + lo_) & (p <= tt + T - E + hi_)).all()), \
            "read outside the window"
        inrow = (p >= 0) & (p < L)
        q = p.clamp(0, L - 1).reshape(-1)
        shape = (C, K) + tuple(p.shape)
        pick = lambda pl, pad: torch.where(inrow, pl[..., q].reshape(shape),
                                           pad)
        return (pick(c_pl, zero), pick(c2_pl, nzero), pick(key_pl, bigt),
                pick(x, zero))

    # own lanes, from the rows
    inrow = i < L
    q = i.clamp(0, L - 1).reshape(-1)
    si = torch.where(inrow, key_pl[..., q].reshape(C, K, nth, E), bigt)
    xi = torch.where(inrow, x[..., q].reshape(C, K, nth, E), zero)
    vi = inrow & valid[..., q].reshape(C, K, nth, E)
    lo = si - w
    beyond = (i - hb < 0) | (i + ha >= L)
    acc = dict(cnt=torch.zeros_like(xi), s1=torch.zeros_like(xi),
               s2=torch.zeros_like(xi), mn=torch.full_like(xi, inf),
               mx=torch.full_like(xi, -inf),
               clip=beyond & (big >= lo) & (big <= si) & vi)

    def step(d, active):
        """Offset d's neighbour into the outputs where ``active`` ([NTH,
        E]) holds."""
        c, c2, key, raw = at(i0 + d)
        ok = ~torch.signbit(c2)
        key = key[..., None]
        take = active & ok[..., None] & (key >= lo) & (key <= si)
        c, c2, raw = c[..., None], c2[..., None], raw[..., None]
        acc["cnt"] = torch.where(take, acc["cnt"] + 1, acc["cnt"])
        acc["s1"] = torch.where(take, acc["s1"] + c, acc["s1"])
        acc["s2"] = torch.where(take, acc["s2"] + c2, acc["s2"])
        acc["mn"] = torch.where(take, torch.minimum(acc["mn"], raw),
                                acc["mn"])
        acc["mx"] = torch.where(take, torch.maximum(acc["mx"], raw),
                                acc["mx"])

    def row_at(d):
        return ((i0 + d >= 0) & (i0 + d < L))[:, None]

    def walk(dl, dh):
        if ja + jb >= E - 1:
            for s in range(E - 1):                       # head
                d = ja + E - 1 - s
                if dl <= d <= dh:
                    step(d, row_at(d) & (e >= E - 1 - s))
            for d in range(min(dh, ja), max(dl, E - 1 - jb) - 1, -1):
                step(d, row_at(d).expand(-1, E))
            for s in range(E - 1):                       # tail
                d = E - 2 - jb - s
                if dl <= d <= dh:
                    step(d, row_at(d) & (e <= E - 2 - s))
        else:
            for d in range(min(dh, ja + E - 1), max(dl, -jb) - 1, -1):
                step(d, row_at(d) & (d - ja <= e) & (e <= d + jb))

    def clip_at(off, dl, dh):
        for j in range(E):
            d = j + off
            if dl <= d <= dh:
                p = i0 + d
                _, c2, key, _ = at(p)
                hit = ((key >= lo[..., j]) & (key <= si[..., j])
                       & (vi[..., j] | ~torch.signbit(c2))
                       & ((p >= 0) & (p < L)))
                acc["clip"][..., j] |= hit

    for dl, dh in legacy_windows(hb, ha, E, T, window_cap):
        win["offsets"] = (dl, dh)
        walk(dl, dh)
        clip_at(-hb, dl, dh)
        clip_at(ha, dl, dh)

    cnt, s1, s2, mn, mx = (acc[k] for k in ("cnt", "s1", "s2", "mn", "mx"))
    c3 = center[..., None]
    one = torch.ones((), dtype=dt, device=dev)
    cnt1 = torch.maximum(cnt, one)
    mean = torch.where(cnt > 0, s1 / cnt1 + c3, nan)
    total = s1 + cnt * c3
    var = torch.where(cnt > 1, (s2 - s1 * s1 / cnt1)
                      / torch.maximum(cnt - one, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    planes = {
        "mean": mean, "count": cnt,
        "min": torch.where(cnt > 0, mn, nan),
        "max": torch.where(cnt > 0, mx, nan),
        "sum": torch.where(cnt > 0, total, nan), "stddev": std,
        "zscore": torch.where(vi, (xi - mean) / std, nan)}
    out = {k: v.reshape(C, K, -1)[..., :L] for k, v in planes.items()}
    out["clipped"] = (acc["clip"] & (i < L)).to(dt).sum((-2, -1))[..., None]
    return out


def legacy_stats_cuda(secs, xs, valids, window, max_behind, max_ahead, *,
                      _center_out: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Launch the legacy stats kernel: int32 [K, L] keys, float32 and
    bool [C, K, L] stacks, all on one CUDA device.  One launch count
    covers the call's two kernels (the centres, then the stats); the
    private ``_center_out`` ([C, K] float32) receives the centres."""
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
    centre = (torch.empty((C, K), dtype=torch.float32, device=xs.device)
              if _center_out is None else _center_out)
    if centre.shape != (C, K) or centre.dtype != torch.float32 \
            or centre.device != xs.device or not centre.is_contiguous():
        raise TypeError("_center_out must be a contiguous float32 [C, K] "
                        "tensor on the values' device")
    if C and K and L:
        tally = torch.empty((C, K), dtype=torch.int32, device=xs.device)
        # bounds past the row act as the row length (all-fill shifts)
        cuda_lib.launch(
            "legacy_stats", xs.device, "tempo_legacy_stats",
            secs.data_ptr(), xs.data_ptr(), valids.data_ptr(),
            out.data_ptr(), clipped.data_ptr(), centre.data_ptr(),
            tally.data_ptr(), _clamp_window(window),
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
