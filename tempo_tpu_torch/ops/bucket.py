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
for tests and ``chip_smoke.py``.  The CPU mirrors run each form's
arithmetic in tensor code, so the CPU tests can pin its bits against the
plain version: :func:`bucket_stats_windowed` the staged bucket form's
windows and carries, :func:`bucket_stats_tiled_plain` the bucket row
form's tiled forward ladder and tail gather, :func:`resample_ema_tiled_plain`
the resample EMA's register ladder (both forms) and
:func:`resample_ema_warp_runs_plain` its staged form's ring a warp.  The card's main path
uses none of them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


def resample_ema_tiled_plain(secs: torch.Tensor, x: torch.Tensor,
                             valid: torch.Tensor, step, alpha: float,
                             scale=None, tile_log2: int = 10,
                             window_log2: int = 13, row_log2: int = 14,
                             class_tile_log2=None):
    """:func:`resample_ema_plain`'s (res, ema) by the kernel's launches,
    bit for bit: res as the fill writes it, the EMA over the bucket heads
    by the register ladder's forms (``scan.ema_tiled_plain``: one launch
    up to 2^``row_log2`` lanes, else a tile-local stage over windows and
    the class stages along the residue classes mod 2^``tile_log2``,
    ``class_tile_log2`` their cut)."""
    step = _integral_step(step)
    xs = x * torch.as_tensor(1.0 if scale is None else scale, dtype=x.dtype,
                             device=x.device)
    head = heads(secs, valid, step)
    res = torch.where(head, xs, torch.full((), float("nan"), dtype=x.dtype,
                                           device=x.device))
    return res, scan.ema_tiled_plain(xs, head, alpha, tile_log2, window_log2,
                                     row_log2, class_tile_log2)


def resample_ema_warp_runs_plain(secs: torch.Tensor, x: torch.Tensor,
                                 valid: torch.Tensor, step, alpha: float,
                                 scale=None, *, tile: int = 128,
                                 depth: int = 2, offsets=(0, 0),
                                 order: str = "forward", warps: int = 16):
    """The resample EMA's staged form (``resample_ema_ring_kernel``)
    emulated a warp at a time, bit for bit, on rows of at most
    ``stream.EMA_ROW_MAX`` lanes: each of ``warps`` warps streams its run
    of ceil(G / warps) of the row's G segments in items of ``tile`` lanes
    through a ring of ``depth`` slots (its valid bytes), secs and x landing
    in place in the ladder's two planes, lane i at word i + ``offsets``
    (the rows' starts off 16 bytes, in words); the predecessor segment
    read from the inputs for the run's carries; each segment's (d, v)
    written over its row of the planes (the run's first after every
    warp's run), then the column levels and the outputs.  Every word of
    the planes carries a tag, so a copy that lands on a word still in use,
    a read of a word that holds another lane and a (d, v) written over a
    lane not yet read all raise.  ``order`` runs the warps "forward" or
    "reverse" (each to its end in turn: the two extremes of their
    interleaving).  In ``x``'s dtype."""
    step = _integral_step(step)
    K, L = x.shape
    dt, dev = x.dtype, x.device
    if L > stream.EMA_ROW_MAX:
        raise ValueError(f"the staged form takes rows of at most "
                         f"{stream.EMA_ROW_MAX} lanes, got {L}")
    T = int(tile)
    G = -(-L // 32)
    per = -(-G // warps)
    sc = torch.tensor(1.0 if scale is None else scale, dtype=dt, device=dev)
    a = torch.tensor(alpha, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    one_minus_a = one - a
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    lane = torch.arange(32, device=dev)
    res = torch.empty_like(x)
    ema = torch.empty_like(x)
    EMPTY, USED, DV = 0, -1, -2          # tags beside a staged lane's i + 1

    def fill(si, sb, ok, xi, i):
        head = ok & ((i == 0) | (torch.div(si, step, rounding_mode="floor")
                                 != torch.div(sb, step, rounding_mode="floor")))
        xs = xi * sc
        return (torch.where(head, one_minus_a, one),
                torch.where(head, a * xs, torch.zeros((), dtype=dt,
                                                      device=dev)),
                torch.where(head, xs, nan))

    def row_levels(d, v, carry):
        for ls in range(5):
            s_ = 1 << ls
            if s_ >= L:
                break
            dc, vc = torch.roll(d, s_), torch.roll(v, s_)
            low = lane < s_
            dp = torch.where(low, carry[0][ls], dc)
            vp = torch.where(low, carry[1][ls], vc)
            v = v + d * vp
            d = d * dp
            carry[0][ls], carry[1][ls] = dc, vc
        return d, v

    for k in range(K):
        sk, xk, vk = secs[k].to(torch.int64), x[k], valid[k]
        nw = 32 * G + 4
        planes = {"s": [torch.zeros(nw, dtype=torch.int64, device=dev),
                        torch.zeros(nw, dtype=torch.int64, device=dev)],
                  "x": [torch.zeros(nw, dtype=dt, device=dev),
                        torch.zeros(nw, dtype=torch.int64, device=dev)]}
        ds = torch.zeros(32 * G, dtype=dt, device=dev)
        vs = torch.zeros(32 * G, dtype=dt, device=dev)
        off = {"s": int(offsets[0]), "x": int(offsets[1])}

        def stage(name, src, lo, hi):
            vals, tags = planes[name]
            words = torch.arange(lo, hi, device=dev) + off[name]
            assert bool((tags[words] == EMPTY).all()), \
                "a copy landed on a word in use"
            vals[words] = src[lo:hi].to(vals.dtype)
            tags[words] = torch.arange(lo, hi, device=dev) + 1

        def take(name, i, inn):
            vals, tags = planes[name]
            words = i[inn] + off[name]
            assert bool((tags[words] == i[inn] + 1).all()), \
                "a read found another lane's word"
            tags[words] = USED
            out = torch.zeros(32, dtype=vals.dtype, device=dev)
            out[inn] = vals[words]
            return out

        def write_row(g, d, v):
            for name in ("s", "x"):
                tags = planes[name][1]
                words = torch.arange(32 * g, 32 * g + 32, device=dev)
                assert bool(((tags[words] == EMPTY) | (tags[words] == USED))
                            .all()), "a (d, v) landed on a lane not yet read"
                tags[words] = DV
            slot = 32 * g + (lane ^ (g & 31))
            ds[slot], vs[slot] = d, v

        deferred = []
        ws = range(warps) if order == "forward" else range(warps - 1, -1, -1)
        for w in ws:
            g0, g1 = min(G, w * per), min(G, w * per + per)
            a0, a1 = 32 * g0, min(L, 32 * g1)
            n = -(-(a1 - a0) // T) if a1 > a0 else 0
            slots = [None] * depth

            def load(j):
                lo, hi = a0 + j * T, min(a1, a0 + j * T + T)
                stage("s", sk, lo, hi)
                stage("x", xk, lo, hi)
                assert slots[j % depth] is None, "a slot refilled in use"
                slots[j % depth] = (lo, vk[lo:hi].clone())

            for j in range(min(depth - 1, n)):
                load(j)
            carry = [[torch.ones(32, dtype=dt, device=dev) for _ in range(5)],
                     [torch.zeros(32, dtype=dt, device=dev)
                      for _ in range(5)]]
            prev_s = torch.zeros((), dtype=torch.int64, device=dev)
            if 0 < g0 < g1:
                i = a0 - 32 + lane
                si = sk[i]
                sb = torch.where(i > 0, sk[(i - 1).clamp(min=0)], 0)
                d, v, _ = fill(si, sb, vk[i], xk[i], i)
                row_levels(d, v, carry)
                prev_s = si[31]
            for j in range(n):
                if j + depth - 1 < n:
                    load(j + depth - 1)
                lo, vb = slots[j % depth]
                hi = min(a1, lo + T)
                for g in range(lo // 32, -(-hi // 32)):
                    i = 32 * g + lane
                    inn = i < L
                    si = take("s", i, inn)
                    xi = take("x", i, inn).to(dt)
                    ok = torch.zeros(32, dtype=torch.bool, device=dev)
                    ok[inn] = vb[i[inn] - lo]
                    sb = torch.cat([prev_s.reshape(1), si[:-1]])
                    d, v, r = fill(si, sb, ok, xi, i)
                    res[k, i[inn]] = r[inn]
                    prev_s = si[31]
                    d, v = row_levels(d, v, carry)
                    if g == g0:
                        deferred.append((g, d, v))
                    else:
                        write_row(g, d, v)
                slots[j % depth] = None
        for g, d, v in deferred:
            write_row(g, d, v)
        # the column levels: spans 32 m < L along the segments
        swz = lane[None, :] ^ (torch.arange(G, device=dev)[:, None] & 31)
        dd, vv = (p.view(G, 32).gather(1, swz) for p in (ds, vs))
        m = 1
        while 32 * m < L:
            dp = torch.cat([torch.ones((m, 32), dtype=dt, device=dev),
                            dd[:-m]])[:G]
            vp = torch.cat([torch.zeros((m, 32), dtype=dt, device=dev),
                            vv[:-m]])[:G]
            vv = vv + dd * vp
            dd = dd * dp
            m *= 2
        ema[k] = vv.reshape(-1)[:L]
    return res, ema


def resample_ema_cuda(secs: torch.Tensor, x: torch.Tensor,
                      valid: torch.Tensor, step, alpha: float, scale=None, *,
                      _form: Optional[str] = None):
    """Launch the fused kernel on int32 secs, float32 x and bool valid,
    all [K, L] on one CUDA device: the staged form where
    ``stream.resample_plan`` fits, else the row form (one launch up to
    ``cuda_lib.ema_row_max()`` lanes, two or more past it, the class
    stages reading the first's d plane)."""
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
    if L > cuda_lib.ema_max_lanes():
        raise ValueError(f"resample_ema kernel takes rows of at most "
                         f"{cuda_lib.ema_max_lanes()} lanes (int32 lane "
                         f"indices), got {L}")
    plan = stream.pick("resample_ema", stream.resample_plan(L), _form,
                       f"L={L}")
    if plan is not None:
        stream.record_grid("resample_ema", K,
                           -(-stream.resample_run(L) // plan.tile))
        cuda_lib.launch("resample_ema_ring", x.device,
                        "tempo_resample_ema_ring", secs.data_ptr(),
                        x.data_ptr(), valid.data_ptr(), step, float(alpha),
                        1.0 if scale is None else float(scale),
                        res.data_ptr(), ema.data_ptr(), K, L, plan.tile,
                        plan.depth)
        return res, ema
    dplane = torch.empty_like(x) if L > cuda_lib.ema_row_max() else None
    cuda_lib.launch("resample_ema", x.device, "tempo_resample_ema",
                    secs.data_ptr(), x.data_ptr(), valid.data_ptr(), step,
                    float(alpha), 1.0 if scale is None else float(scale),
                    res.data_ptr(), ema.data_ptr(), cuda_lib.ptr(dplane),
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
# the row form's window: 3072 outputs after a halo of T = 1024 lanes
_BUCKET_WINDOW = 3072


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


def _bucket_fill(bid, xs, valids, center):
    """The forward ladder's element as six planes (flag, count, centred
    sum and sum of squares, min, max), the head flags from ``bid``."""
    dt, dev = xs.dtype, xs.device
    zero = torch.zeros((), dtype=dt, device=dev)
    pinf = torch.full((), float("inf"), dtype=dt, device=dev)
    f = _bucket_flags(bid, dt)[0].expand(xs.shape)
    xc = torch.where(valids, xs - center, zero)
    return [f, valids.to(dt), xc, xc * xc, torch.where(valids, xs, pinf),
            torch.where(valids, xs, -pinf)]


# the value planes' combine and identity (the flag's identity is 1)
_SEG_OPS = [(torch.add, 0.0)] * 3 + [(torch.minimum, float("inf")),
                                     (torch.maximum, float("-inf"))]


def _seg_level(planes, span, shift):
    """One level of the forward segmented ladder on (flag, five value
    planes): a head keeps its values, else each takes its partner's in
    (``shift(a, span, identity)`` moves a plane); the flag takes the
    max, 1 shifted in."""
    f, vals = planes[0], planes[1:]
    out = [torch.where(f > 0, p, combine(p, shift(p, span, ident)))
           for p, (combine, ident) in zip(vals, _SEG_OPS)]
    return [torch.maximum(f, shift(f, span, 1.0))] + out


def _bucket_outputs(cnt, s1, s2, mn, mx, center, xs, valids):
    """The seven outputs from each lane's bucket totals."""
    dt, dev = xs.dtype, xs.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
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


def _bucket_ladder(bid, xs, valids, center):
    """The two ladders and the outputs over the lanes given, around the
    given centre ([C, K, 1])."""
    L = xs.shape[-1]
    planes = _bucket_fill(bid, xs, valids, center)
    span = 1
    while span < L:
        planes = _seg_level(planes, span, _shift_back)
        span *= 2
    g = _bucket_flags(bid, xs.dtype)[1]
    planes = planes[1:]
    span = 1
    while span < L:
        planes = [torch.where(g > 0, p, _shift_fwd(p, span, 0.0))
                  for p in planes]
        g = torch.maximum(g, _shift_fwd(g, span, 0.0))
        span *= 2
    return _bucket_outputs(*planes, center, xs, valids)


def bucket_stats_plain(bid: torch.Tensor, xs: torch.Tensor,
                       valids: torch.Tensor):
    """``_bucket_math`` op for op as tensor code over [C, K, L] stacks
    sharing one [K, L] id plane, in ``xs``'s dtype: the row centre, the
    forward segmented Hillis-Steele scan of the five planes (identity and
    flag 1 shifted in), the reverse tail broadcast (0 shifted in), then
    the outputs."""
    return _bucket_ladder(bid, xs, valids, _bucket_center(xs, valids))


def _tail_outputs(bid, planes, center, xs, valids):
    """The seven outputs of every lane from the five value planes
    (count, s1, s2, min, max) at its bucket's tail (the lane before the
    next id change), as the kernels read them."""
    C, K, L = xs.shape
    lanes = torch.arange(L, device=xs.device).expand(K, L)
    tail = torch.where(_bucket_flags(bid, xs.dtype)[1] > 0, lanes, L)
    tail = torch.cummin(tail.flip(-1), -1).values.flip(-1).expand(C, K, L)
    return _bucket_outputs(*(torch.gather(p, -1, tail) for p in planes),
                           center, xs, valids)


def bucket_windows(bid_row: torch.Tensor, tile: int,
                   span: int = stream.BUCKET_SPAN
                   ) -> Optional[List[Tuple[int, int, int]]]:
    """The staged bucket form's regions over one row of ids: window w
    takes lanes [w tile, (w + 1) tile) after the carry, the lanes of the
    previous window's last bucket, and outputs the lanes before its
    region's last bucket head (every lane in the row's last window).
    Returns (start, out_end, end) for each window, or None where a bucket
    is longer than ``span`` lanes (the kernel leaves that row to the row
    form)."""
    L = int(bid_row.shape[0])
    head = torch.ones(L, dtype=torch.bool, device=bid_row.device)
    head[1:] = bid_row[1:] != bid_row[:-1]
    heads = torch.nonzero(head).flatten()
    if int(torch.diff(heads, append=heads.new_tensor([L])).max()) > span:
        return None
    regions, start = [], 0
    nw = -(-L // tile)
    for w in range(nw):
        end = min(L, (w + 1) * tile)
        out_end = end if w == nw - 1 else int(heads[heads < end].max())
        regions.append((start, out_end, end))
        start = out_end
    return regions


def _tail_trees(bid_r, xs_r, valids_r, center):
    """The forward ladder's five value planes at each bucket's tail in one
    region ([1, n] ids, [C, 1, n] values), by the tree the staged kernel
    evaluates: r = 0 .. n_b - 1 over lanes t - r, a binary counter of
    complete pairwise nodes (the node of lower r, the later lanes, first
    in each combine), then the remaining nodes folded from the highest r
    down (the kernel takes the leaves eight at a time, the same tree).
    Returns the planes at every lane's tail, equal to the segmented
    Hillis-Steele ladder's values there bit for bit."""
    C, _, n = xs_r.shape
    dev = xs_r.device
    flag, cnt, s1, s2, mn, mx = _bucket_fill(bid_r, xs_r, valids_r, center)
    lanes = torch.arange(n, device=dev)
    tail = torch.cat([bid_r[0, 1:] != bid_r[0, :-1],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    tails = lanes[tail]                                     # [B]
    heads = lanes[flag[0, 0] > 0]
    length = tails - heads + 1
    ops = [torch.add, torch.add, torch.add, torch.minimum, torch.maximum]
    leaf = [cnt, s1, s2, mn, mx]
    lv = {}
    for r in range(int(length.max())):
        on = r < length
        at = (tails - r).clamp(min=0)
        cur = [p[:, 0, at] for p in leaf]                   # [C, B]
        k = 0
        while (r >> k) & 1:
            cur = [op(a, c) for op, a, c in zip(ops, lv[k], cur)]
            k += 1
        lv[k] = [torch.where(on, c, old) for c, old in zip(
            cur, lv.get(k, cur))]
    acc, started = None, torch.zeros_like(length, dtype=torch.bool)
    for k in sorted(lv):
        has = ((length >> k) & 1) > 0
        if acc is None:
            acc = lv[k]
        else:
            acc = [torch.where(has & started, op(a, c),
                               torch.where(has, a, c))
                   for op, a, c in zip(ops, lv[k], acc)]
        started = started | has
    which = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.long,
                                                device=dev),
                                    tail[:-1].long()]), 0)  # bucket of lane
    return [p[:, None, which] for p in acc]


def bucket_stats_windowed(bid: torch.Tensor, xs: torch.Tensor,
                          valids: torch.Tensor, tile: int,
                          span: int = stream.BUCKET_SPAN):
    """The staged bucket form's arithmetic in tensor code: each row's
    centre over the whole row, then over each region of
    :func:`bucket_windows` every bucket's forward-ladder value at its tail
    by the kernel's binary counter (:func:`_tail_trees`), and the outputs
    of the region's lanes before ``out_end``; a row with a bucket longer
    than ``span`` takes the whole-row ladder (the row form).  Tests hold
    it bitwise against :func:`bucket_stats_plain`."""
    C, K, L = xs.shape
    center = _bucket_center(xs, valids)
    out = {k: torch.empty_like(xs) for k in BUCKET_STATS}
    for k in range(K):
        regions = bucket_windows(bid[k], tile, span)
        if regions is None:
            got = _bucket_ladder(bid[k:k + 1], xs[:, k:k + 1],
                                 valids[:, k:k + 1], center[:, k:k + 1])
            for name in BUCKET_STATS:
                out[name][:, k] = got[name][:, 0]
            continue
        for s, e, end in regions:
            b_r, x_r, v_r = (bid[k:k + 1, s:end], xs[:, k:k + 1, s:end],
                             valids[:, k:k + 1, s:end])
            planes = _tail_trees(b_r, x_r, v_r, center[:, k:k + 1])
            got = _bucket_outputs(*planes, center[:, k:k + 1], x_r, v_r)
            for name in BUCKET_STATS:
                out[name][:, k, s:e] = got[name][:, 0, :e - s]
    return out


def bucket_stats_tiled_plain(bid: torch.Tensor, xs: torch.Tensor,
                             valids: torch.Tensor, tile_log2: int = 10,
                             center: Optional[torch.Tensor] = None,
                             class_tile_log2=None):
    """:func:`bucket_stats_plain`'s outputs by the row form's launches,
    bit for bit, around ``center`` ([C, K]; each row's centre where None):
    with T = 2^``tile_log2``, the forward ladder's levels of spans < T on
    each tile of T lanes from the tile and the T lanes before it alone
    (the identity before the row's start), then the class stages
    (``scan.class_stages``, ``class_tile_log2`` their cut), the levels of
    spans T, 2T, ... < L as a ladder along each residue class ``i mod T``
    (the identity where the class index m < span / T); then each lane
    reads the five planes at its bucket's tail (the lane before the next
    id change) and forms the outputs.  Levels past the ladder's own
    (spans >= L) leave every lane as it is: its flag is set by then."""
    C, K, L = xs.shape
    dt, dev = xs.dtype, xs.device
    center = (_bucket_center(xs, valids) if center is None
              else center.reshape(C, K, 1).to(dt))
    T = 1 << int(tile_log2)
    nt = -(-L // T)
    idents = [1.0] + [ident for _, ident in _SEG_OPS]
    wins = []
    for p, ident in zip(_bucket_fill(bid, xs, valids, center), idents):
        row = torch.cat([torch.full((C, K, T), ident, dtype=dt, device=dev),
                         p, torch.full((C, K, nt * T - L), ident, dtype=dt,
                                       device=dev)], -1)
        wins.append(row.unfold(-1, 2 * T, T))      # [C, K, nt, 2T]
    span = 1
    while span < T:
        wins = _seg_level(wins, span, _shift_back)
        span *= 2
    planes = [w[..., T:].reshape(C, K, nt * T)[..., :L] for w in wins]

    def levels(z, end):
        span = 1
        while span < end:
            z = _seg_level(z, span, _shift_back)
            span *= 2
        return z
    planes = scan.class_stages(planes, idents, L, T, levels, class_tile_log2)
    return _tail_outputs(bid, planes[1:], center, xs, valids)


def _bucket_row_form(bid, xs, valids, out) -> torch.Tensor:
    """The row form's launches into ``out``; returns the [C, K] centres
    it used."""
    C, K, L = xs.shape
    if L > cuda_lib.bucket_max_lanes():
        raise ValueError(f"bucket-stats kernel takes rows of at most "
                         f"{cuda_lib.bucket_max_lanes()} lanes (int32 lane "
                         f"indices), got {L}")
    dev = xs.device
    planes = torch.empty((6, C, K, L), dtype=torch.float32, device=dev)
    centre = torch.empty((C, K), dtype=torch.float32, device=dev)
    live = torch.zeros((C, K), dtype=torch.int32, device=dev)
    first_tail = torch.empty((K, -(-L // _BUCKET_WINDOW)), dtype=torch.int32,
                             device=dev)
    cuda_lib.launch("bucket_stats", dev, "tempo_bucket_stats",
                    bid.data_ptr(), xs.data_ptr(), valids.data_ptr(),
                    out.data_ptr(), planes.data_ptr(), centre.data_ptr(),
                    live.data_ptr(), first_tail.data_ptr(), C, K, L)
    return centre


def bucket_stats_cuda(bid: torch.Tensor, xs: torch.Tensor,
                      valids: torch.Tensor, *, _form: Optional[str] = None):
    """Launch the bucket-stats kernel on an int32 [K, L] id plane and
    float32 / bool [C, K, L] stacks, all on one CUDA device: the staged
    form where ``stream.bucket_plan`` fits (rows with a bucket longer
    than ``stream.BUCKET_SPAN`` lanes then take the row form, one more
    launch), else the row form."""
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
            centre = torch.empty((C, K), dtype=torch.float32,
                                 device=xs.device)
            long_rows = torch.empty(K, dtype=torch.int32, device=xs.device)
            n_long = torch.zeros(1, dtype=torch.int32, device=xs.device)
            cuda_lib.launch("bucket_stats_ring", xs.device,
                            "tempo_bucket_stats_ring", bid.data_ptr(),
                            xs.data_ptr(), valids.data_ptr(), out.data_ptr(),
                            centre.data_ptr(), long_rows.data_ptr(),
                            n_long.data_ptr(), C, K, L, plan.tile, plan.depth)
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
