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
bounds are scalars.  A call launches the row centres, then the stats
(``csrc/range_stats.cu``): a row form (blocks of 1024 outputs, each
thread walking four consecutive outputs over a shared-memory window of
the tile and its halo, several windows where the halo is wider) and a
staged form (``ops/stream.py``: the card's blocks each walk a contiguous
run of tiles through the staging ring, carrying each tile's halo to the
next).  The wrapper takes the staged form where
``stream.range_plan`` fits the halo, else the row form, and the private
keyword ``_form`` ("row" | "ring") forces one, for tests and
``chip_smoke.py``; ``_center_out`` receives the kernel's centres, which
:func:`range_stats_plain` takes back as ``_centers`` to give the same
bits.  :func:`range_stats_tiled_plain` runs the kernel's tiles, windows
and walk as tensor code, :func:`range_stats_staged_plain` the staged
form's runs and carried halo.  Outputs: ``mean``, ``count``, ``min``, ``max``,
``sum``, ``stddev``, ``zscore`` as [C, K, L] (or [K, L] for a single
column) and ``clipped`` as [C, K, 1] (or [K, 1]).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tempo_tpu_torch.ops import cuda_lib, stream

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


def _center(x, valid):
    """Each row's centre: the mean of its valid (scaled) values, 0 where
    none; [C, K, 1]."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    nv = valid.to(x.dtype).sum(-1, keepdim=True)
    return (torch.where(valid, x, zero).sum(-1, keepdim=True)
            / torch.clamp(nv, min=1))


def _given_center(centers, C, K, dtype):
    return torch.as_tensor(centers).to(dtype).reshape(C, K, 1)


def range_stats_plain(secs, xs, valids, window, max_behind, max_ahead,
                      window_ahead=0, scales=None, *,
                      _centers=None) -> Dict[str, torch.Tensor]:
    """``_window_math``'s op sequence as tensor code over [C, K, L]
    stacks sharing one [K, L] key plane; dtype-generic.  ``_centers``
    ([C, K]) replaces each row's centre (the card passes its kernel's)."""
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
    center = (_center(x, valid) if _centers is None
              else _given_center(_centers, C, K, dt))
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


#: the row form's block (threads), the consecutive outputs a thread owns,
#: and the most lanes its shared-memory window holds (``kRowThreads``,
#: ``kLanes`` and ``kRowWindow`` in ``csrc/range_stats.cu``)
ROW_THREADS, LANES, ROW_WINDOW = 256, 4, 2048


def range_windows(hb: int, ha: int, lanes: int, tile: int,
                  window_cap: Optional[int]):
    """The kernel's windows over the offsets d from a thread's first
    output: ``[("one", -hb, lanes - 1 + ha)]`` where the tile and its
    halo fit ``window_cap`` lanes (None: always, the staged form), else
    the behind offsets [-hb, lanes - 1] in windows from the top down and
    the ahead offsets [1, lanes - 1 + ha] from the bottom up, each
    window ``window_cap - (tile - lanes)`` offsets wide."""
    top = lanes - 1 + ha
    if window_cap is None or tile + hb + ha <= window_cap:
        return [("one", -hb, top)]
    span = window_cap - (tile - lanes)
    out, dh = [], lanes - 1
    while dh >= -hb:
        dl = max(dh - span + 1, -hb)
        out.append(("behind", dl, dh))
        dh = dl - 1
    dl = 1
    while dl <= top:
        dh = min(dl + span - 1, top)
        out.append(("ahead", dl, dh))
        dl = dh + 1
    return out


def _entry_planes(secs, xs, valids, scales, _centers):
    """The window entries of every lane as [C, K, L] planes: c, c*c with
    the validity in its sign (-0.0 where invalid; a NaN the card computes
    is positive, 0x7fffffff, one the CPU computes from inf - inf negative,
    so c*c's NaN is made positive), the key and x * scale; and the
    centres [C, K, 1]."""
    dt, dev = xs.dtype, xs.device
    C, K, L = xs.shape
    zero = torch.zeros((), dtype=dt, device=dev)
    nzero = torch.tensor(-0.0, dtype=dt, device=dev)
    nan = torch.tensor(float("nan"), dtype=dt, device=dev).abs()
    x = xs * _scale_vector(scales, C, dt, dev)[:, None, None]
    center = (_center(x, valids) if _centers is None
              else _given_center(_centers, C, K, dt))
    c_pl = torch.where(valids, x - center, zero)
    c2_pl = c_pl * c_pl
    c2_pl = torch.where(valids, torch.where(torch.isnan(c2_pl), nan, c2_pl),
                        nzero)
    return (c_pl, c2_pl, secs[None].expand(C, K, L), x), center


def _walk_tiles(at, i0, E, mb, ma, hb, ha, L, w, wa, windows, dt, idt, dev,
                enter=lambda dl, dh: None):
    """The kernel's walk of the threads whose first outputs are ``i0``
    ([NTH]), ``E`` outputs each, over ``windows`` (:func:`range_windows`):
    ``at(p, need)`` gives the entries (c, c2, key, x * scale) at lanes p
    as [C', K', *p.shape] (``need``: where a thread of the kernel reads
    p), ``enter(dl, dh)`` opens each window.  Returns the accumulators
    ([C', K', NTH, E]: cnt, s1, s2, mn, mx, xs, vi, clip)."""
    big = torch.iinfo(idt).max
    imin = torch.iinfo(idt).min
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    e = torch.arange(E, device=dev)
    acc = {}

    def step(d, active, behind):
        """Offset d's neighbour into the outputs where ``active`` ([NTH,
        E]) holds."""
        need = active.expand(i0.shape[0], E).any(-1)
        c, c2, key, _ = at(i0 + d, need)
        ok = ~torch.signbit(c2)
        if behind:
            inw = torch.where(ok, key, imin)[..., None] >= acc["lo"]
        else:
            inw = torch.where(ok, key, big)[..., None] <= acc["hi"]
        take = inw & active
        c, c2 = c[..., None], c2[..., None]
        acc["cnt"] = torch.where(take, acc["cnt"] + 1, acc["cnt"])
        acc["s2"] = torch.where(take, acc["s2"] + c2, acc["s2"])
        acc["mn"] = torch.where(take, torch.fmin(acc["mn"], c), acc["mn"])
        acc["mx"] = torch.where(take, torch.fmax(acc["mx"], c), acc["mx"])
        acc["s1"] = torch.where(active, acc["s1"] + torch.where(inw, c, zero),
                                acc["s1"])

    def walk_behind(dl, dh):
        if mb >= E - 1:
            for s in range(E - 1):                       # head
                d = E - 2 - s
                if dl <= d <= dh:
                    step(d, (e > d)[None], True)
            for d in range(min(dh, -1), max(dl, E - 1 - mb) - 1, -1):
                step(d, (i0 + d >= 0)[:, None].expand(-1, E), True)
            for s in range(E - 1):                       # tail
                d = E - 2 - mb - s
                if dl <= d <= dh:
                    step(d, (i0 + d >= 0)[:, None] & (e <= E - 2 - s), True)
        elif mb > 0:
            for d in range(min(dh, E - 2), max(dl, -mb) - 1, -1):
                step(d, (i0 + d >= 0)[:, None] & (e - d >= 1) & (e - d <= mb),
                     True)

    def walk_ahead(dl, dh):
        if ma >= E - 1:
            for s in range(E - 1):                       # head
                d = s + 1
                if dl <= d <= dh:
                    step(d, (i0 + d < L)[:, None] & (e < d), False)
            for d in range(max(dl, E), min(dh, ma) + 1):
                step(d, (i0 + d < L)[:, None].expand(-1, E), False)
            for s in range(E - 1):                       # tail
                d = ma + 1 + s
                if dl <= d <= dh:
                    step(d, (i0 + d < L)[:, None] & (e > s), False)
        elif ma > 0:
            for d in range(max(dl, 1), min(dh, E - 1 + ma) + 1):
                step(d, (i0 + d < L)[:, None] & (d - e >= 1) & (d - e <= ma),
                     False)

    def clip_at(off, dl, dh):
        for j in range(E):
            d = j + off
            if dl <= d <= dh:
                p = i0 + d
                inrow = (p >= 0) & (p < L)
                _, c2, key, _ = at(p, inrow)
                hit = ((key >= acc["lo"][..., j]) & (key <= acc["hi"][..., j])
                       & (acc["vi"][..., j] | ~torch.signbit(c2)) & inrow)
                acc["clip"][..., j] |= hit

    for kind, dl, dh in windows:
        enter(dl, dh)
        if kind != "ahead" and "cnt" not in acc:         # own lanes first
            own = i0[:, None] + e
            c, c2, key, xsv = at(own, torch.ones_like(own, dtype=torch.bool))
            vi = ~torch.signbit(c2)
            acc.update(
                lo=key - w,
                hi=torch.clamp(key + torch.clamp(big - key, max=wa),
                               max=big - 1),
                cnt=vi.to(dt), s1=c, s2=c * c,
                mn=torch.where(vi, c, inf), mx=torch.where(vi, c, -inf),
                xs=xsv, vi=vi, clip=torch.zeros_like(vi))
        if kind != "ahead":
            walk_behind(dl, dh)
            clip_at(-hb, dl, dh)
        if kind != "behind":
            walk_ahead(dl, dh)
            clip_at(ha, dl, dh)
    return acc


def _finish_tiles(acc, i, mb, ma, L, c3, dt, dev):
    """The kernel's epilogue on :func:`_walk_tiles`' accumulators at
    output lanes ``i`` ([NTH, E]), centres ``c3`` broadcast to them:
    the seven stats, and each output's clip flag where ``i < L``."""
    nan = torch.tensor(float("nan"), dtype=dt, device=dev).abs()
    zero = torch.zeros((), dtype=dt, device=dev)
    s1 = torch.where((i < mb) | (i + ma >= L), acc["s1"] + zero, acc["s1"])
    cnt, s2, mn, mx = acc["cnt"], acc["s2"], acc["mn"], acc["mx"]
    if mb + ma > 0:
        mn = torch.where(torch.isnan(s2), nan, mn)
        mx = torch.where(torch.isnan(s2), nan, mx)
    one = torch.ones((), dtype=dt, device=dev)
    cnt1 = torch.maximum(cnt, one)
    mean = torch.where(cnt > 0, s1 / cnt1 + c3, nan)
    total = s1 + cnt * c3
    var = torch.where(cnt > 1, (s2 - s1 * s1 / cnt1)
                      / torch.maximum(cnt - one, one), nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.maximum(var, zero)), nan)
    planes = {
        "mean": mean, "count": cnt,
        "min": torch.where(cnt > 0, mn + c3, nan),
        "max": torch.where(cnt > 0, mx + c3, nan),
        "sum": torch.where(cnt > 0, total, nan), "stddev": std,
        "zscore": torch.where(acc["vi"], (acc["xs"] - mean) / std, nan)}
    return planes, acc["clip"] & (i < L)


def _bounds(max_behind, max_ahead, L):
    """(mb, ma, hb, ha): the walks' loop counts and the clip lanes'
    offsets (``range_params``)."""
    mb, ma = min(int(max_behind), L - 1), min(int(max_ahead), L - 1)
    hb = L if int(max_behind) >= L - 1 else int(max_behind) + 1
    ha = L if int(max_ahead) >= L - 1 else int(max_ahead) + 1
    return mb, ma, hb, ha


def range_stats_tiled_plain(secs, xs, valids, window, max_behind, max_ahead,
                            window_ahead=0, scales=None, *,
                            threads: int = ROW_THREADS, lanes: int = LANES,
                            window_cap: Optional[int] = ROW_WINDOW,
                            _centers=None) -> Dict[str, torch.Tensor]:
    """:func:`range_stats_plain`'s stats as the kernel cuts them, bit for
    bit: tiles of ``threads * lanes`` outputs, each thread ``lanes``
    consecutive ones (its first at i0); the windows of
    :func:`range_windows` (``window_cap=None``: one window), each
    neighbour read checked to lie inside the current one; the behind walk
    over offsets d = lanes - 2 down to -mb (the ahead walk from 1 up to
    lanes - 1 + ma) with the active outputs of each step as the kernel's
    head, middle and tail (or its generic loop where a bound is below
    ``lanes - 1``); count, sum of squares and min/max updated under the
    in-window predicate (min/max ignoring NaN, set to NaN at the end
    where the sum of squares is NaN), the sum by ``inw ? c : 0``, steps
    past the row skipped and one ``s1 + 0`` for them at the end.
    ``_centers`` as for :func:`range_stats_plain`."""
    dt, idt, dev = xs.dtype, secs.dtype, xs.device
    C, K, L = xs.shape
    big = torch.iinfo(idt).max
    (c_pl, c2_pl, key_pl, x), center = _entry_planes(secs, xs, valids,
                                                     scales, _centers)
    E, T = int(lanes), int(threads) * int(lanes)
    mb, ma, hb, ha = _bounds(max_behind, max_ahead, L)
    nth = -(-L // T) * int(threads)
    i0 = torch.arange(nth, device=dev) * E            # [NTH]
    t0 = i0 // T * T
    zero = torch.zeros((), dtype=dt, device=dev)
    nzero = torch.tensor(-0.0, dtype=dt, device=dev)
    win = {}

    def at(p, need):
        """Entries at lanes p (any shape S) -> [C, K, *S] each, the pad
        entry outside the row; p must lie in the current window."""
        lo_, hi_ = win["lanes"]
        assert bool(((p >= t0.reshape((-1,) + (1,) * (p.dim() - 1)) + lo_)
                     & (p <= t0.reshape((-1,) + (1,) * (p.dim() - 1))
                        + hi_)).all()), "read outside the window"
        inrow = (p >= 0) & (p < L)
        q = p.clamp(0, L - 1).reshape(-1)
        shape = (C, K) + tuple(p.shape)
        pick = lambda pl, pad: torch.where(inrow, pl[..., q].reshape(shape),
                                           pad)
        return (pick(c_pl, zero), pick(c2_pl, nzero),
                pick(key_pl, torch.tensor(big, dtype=idt, device=dev)),
                pick(x, zero))

    def enter(dl, dh):
        win["lanes"] = (dl, T - E + dh)

    acc = _walk_tiles(at, i0, E, mb, ma, hb, ha, L, _clamp_window(window),
                      _clamp_window(window_ahead),
                      range_windows(hb, ha, E, T, window_cap), dt, idt, dev,
                      enter)
    i = i0[:, None] + torch.arange(E, device=dev)
    planes, clip = _finish_tiles(acc, i, mb, ma, L, center[..., None], dt,
                                 dev)
    out = {k: v.reshape(C, K, -1)[..., :L] for k, v in planes.items()}
    out["clipped"] = clip.to(dt).sum((-2, -1))[..., None]
    return out


def range_stats_staged_plain(secs, xs, valids, window, max_behind,
                             max_ahead, window_ahead=0, scales=None, *,
                             tile: int = 1024, blocks: int = 1,
                             lanes: int = LANES,
                             _centers=None) -> Dict[str, torch.Tensor]:
    """The staged form's walk (``range_ring_kernel``) emulated in run
    order, bit for bit: the (column, row, tile) items cut into
    ``blocks`` runs (:func:`stream.ring_runs`); each run walked over two
    windows of the tile and its halo, item j's the window j % 2, whose
    entries carry the row and lane they hold; an item that continues its
    row takes its first lanes, the halo it shares with the tile before,
    from the other window (each checked to hold its lane), and forms the
    lanes after them; one that starts the run or its row forms them all;
    pads past the row in the last tile; each read of the walk checked to
    find its own lane's entry; clipped lanes counted in integers a row,
    added at each row's end and at the run's end, and rounded once.
    ``_centers`` as for :func:`range_stats_plain`."""
    dt, idt, dev = xs.dtype, secs.dtype, xs.device
    C, K, L = xs.shape
    big = torch.iinfo(idt).max
    E, T = int(lanes), int(tile)
    mb, ma, hb, ha = _bounds(max_behind, max_ahead, L)
    WL = T + hb + ha
    (c_pl, c2_pl, key_pl, x), center = _entry_planes(secs, xs, valids,
                                                     scales, _centers)
    w, wa = _clamp_window(window), _clamp_window(window_ahead)
    nt = -(-L // T)
    pad = (torch.zeros((), dtype=dt, device=dev),
           torch.tensor(-0.0, dtype=dt, device=dev),
           torch.tensor(big, dtype=idt, device=dev),
           torch.zeros((), dtype=dt, device=dev))
    out = {k: torch.full((C, K, L), float("nan"), dtype=dt, device=dev)
           for k in STATS}
    tally = torch.zeros((C, K), dtype=torch.int64)
    i0 = torch.arange(T // E, device=dev) * E
    e = torch.arange(E, device=dev)
    for s0, s1 in stream.ring_runs(C * K * nt, blocks):
        tags = [torch.full((WL,), -1, dtype=torch.int64, device=dev)
                for _ in range(2)]
        ents = [[torch.zeros(WL, dtype=p.dtype, device=dev) for p in pad]
                for _ in range(2)]
        nclip = 0
        for it in range(s0, s1):
            ck, t = divmod(it, nt)
            c, k = divmod(ck, K)
            t0 = t * T
            base = t0 - hb
            row = ck << 40
            first = it == s0 or t == 0
            tag, ent = tags[(it - s0) & 1], ents[(it - s0) & 1]
            if not first:
                # the halo shared with the tile before, from the other window
                nc = min(hb + ha, L - base)
                src = torch.arange(T, T + nc, device=dev)
                other = tags[(it - s0 + 1) & 1]
                lane = base + torch.arange(nc, device=dev)
                assert bool(((other[src] == row + lane) | (lane < 0)).all()), \
                    "the carried halo lacks a lane"
                tag[:nc] = other[src]
                for j in range(4):
                    ent[j][:nc] = ents[(it - s0 + 1) & 1][j][src]
            lo = min(max(t0 - hb if first else t0 + ha, 0), L)
            hi = min(max(t0 + T + ha, lo), L)
            # the slot: keys, x and valid of lanes [lo, hi)
            slot = [pl[c, k, lo:hi] for pl in (c_pl, c2_pl, key_pl, x)]
            end = hi if hi < L else max(L, t0 + T)
            new = torch.arange(lo, end, device=dev)
            tag[new - base] = row + new
            inrow = new < L
            for j, (sl, pv) in enumerate(zip(slot, pad)):
                vals = torch.full(new.shape, pv.item(), dtype=sl.dtype,
                                  device=dev)
                vals[inrow] = sl[(new[inrow] - lo)]
                ent[j][new - base] = vals

            def at(p, need):
                q = (p - base).clamp(0, WL - 1)
                ok = (tag[q] == row + p) | ~need.expand(p.shape)
                assert bool(ok.all()), "a walk read a lane its window lacks"
                return tuple(en[q][None, None] for en in ent)

            acc = _walk_tiles(at, t0 + i0, E, mb, ma, hb, ha, L, w, wa,
                              [("one", -hb, E - 1 + ha)], dt, idt, dev)
            i = (t0 + i0)[:, None] + e
            planes, clip = _finish_tiles(acc, i, mb, ma, L,
                                         center[c, k].reshape(()), dt, dev)
            n_out = min(T, L - t0)
            for name, v in planes.items():
                out[name][c, k, t0:t0 + n_out] = v.reshape(-1)[:n_out]
            nclip += int(clip.sum())
            if t == nt - 1 or it == s1 - 1:
                tally[c, k] += nclip
                nclip = 0
    out["clipped"] = tally.to(dt).to(dev)[..., None]
    return out


def _scale_vector(scales, C: int, dtype, device) -> torch.Tensor:
    if scales is None:
        return torch.ones(C, dtype=dtype, device=device)
    s = torch.as_tensor(scales, dtype=dtype, device=device).reshape(-1)
    return s if s.shape[0] == C else s.expand(C).contiguous()


def range_stats_cuda(secs, xs, valids, window, max_behind, max_ahead,
                     window_ahead=0, scales=None, *,
                     _form: Optional[str] = None,
                     _center_out: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Launch the range-stats kernel: int32 [K, L] keys, float32 and
    bool [C, K, L] stacks, all on one CUDA device; the staged form where
    ``stream.range_plan`` fits, else the row form.  One launch count
    covers the call's two kernels (the centres, then the stats); the
    private ``_center_out`` ([C, K] float32) receives the centres."""
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
    if L > cuda_lib.range_max_lanes():
        raise ValueError(f"range-stats kernel takes rows of at most "
                         f"{cuda_lib.range_max_lanes()} lanes (a lane plus "
                         f"a bound in int32), got {L}")
    secs, xs, valids = secs.contiguous(), xs.contiguous(), valids.contiguous()
    scale = (None if scales is None
             else _scale_vector(scales, C, torch.float32, xs.device))
    out = torch.empty((len(STATS), C, K, L), dtype=torch.float32,
                      device=xs.device)
    centre = (torch.empty((C, K), dtype=torch.float32, device=xs.device)
              if _center_out is None else _center_out)
    if centre.shape != (C, K) or centre.dtype != torch.float32 \
            or centre.device != xs.device or not centre.is_contiguous():
        raise TypeError("_center_out must be a contiguous float32 [C, K] "
                        "tensor on the values' device")
    clipped = torch.empty((C, K, 1), dtype=torch.float32, device=xs.device)
    if C and K and L:
        mb, ma = int(max_behind), int(max_ahead)
        plan = stream.pick("range_stats", stream.range_plan(mb, ma, L),
                           _form, f"bounds ({mb}, {ma}), L={L}")
        args = (secs.data_ptr(), xs.data_ptr(), valids.data_ptr(),
                cuda_lib.ptr(scale), out.data_ptr(), clipped.data_ptr(),
                centre.data_ptr(), _clamp_window(window),
                _clamp_window(window_ahead), mb, ma, C, K, L)
        tally = torch.empty((C, K), dtype=torch.int32, device=xs.device)
        if plan is None:
            cuda_lib.launch("range_stats", xs.device, "tempo_range_stats",
                            *args[:7], tally.data_ptr(), *args[7:])
        else:
            items = C * K * -(-L // plan.tile)
            blocks = min(items, cuda_lib.range_ring_blocks(
                xs.device, plan.tile, plan.smem))
            stream.record_grid("range_stats", blocks, -(-items // blocks))
            cuda_lib.launch("range_stats_ring", xs.device,
                            "tempo_range_stats_ring", *args[:7],
                            tally.data_ptr(), *args[7:], plan.tile,
                            plan.depth, blocks)
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
