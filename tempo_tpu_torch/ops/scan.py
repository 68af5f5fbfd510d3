"""Scans over packed [K, L] series: the exact EMA, the valid-index
scans and the forward fill, each a CUDA kernel beside its plain version.

Counterpart of ``tempo_tpu/ops/pallas_kernels.py``:

* ``ema`` (``ema_scan``, Pallas kernel ``_ema_kernel``): ``y_t = (1-a)
  y_{t-1} + a x_t``; rows with ``valid`` False carry the previous value
  forward.  Both forms combine the recurrence's (d, v) pairs by the
  same Hillis-Steele ladder with the same association as the TPU
  kernel, so f32 results round the same way.  The kernel holds a row
  in one block's registers up to 16,384 lanes and tiles longer rows
  (a tile-local stage, then the class stages of :func:`class_stages`);
  ``ema_tiled_plain`` runs those forms as tensor code.
* ``last_valid_index_scan`` / ``first_valid_index_scan``
  (``_last/_first_valid_index_kernel``): the running max of ``valid ?
  lane : -1`` and the reverse running min of ``valid ? lane : L``, int32.
* ``last_valid_scan`` (``_last_valid_kernel``): the value at the last
  valid lane at or before each lane (0 before the first) and has-valid.
  The three share one kernel (16-lane segments cut on the row's address,
  a warp scan, a block combine and a carry over tiles);
  ``index_scan_tiled_plain`` runs those levels as tensor code.
* ``cumsum3`` (``_cumsum3_kernel``): inclusive prefix sums of masked x,
  masked x² and the valid count, by the TPU kernel's Hillis-Steele
  ladder, so float32 sums round the same way.  The kernel tiles the
  ladder (a tile-local stage, then ladders along residue classes);
  ``cumsum3_tiled_plain`` runs the same stages as tensor code.

* ``ema_scan`` (``tempo_tpu/ops/rolling.py:ema_scan``, a ``lax.scan``
  and no Pallas kernel): the same recurrence strictly left to right
  with an explicit carry, ``(ys, y_end)``, one multiply and one add a
  lane, so resuming from ``y_end`` at any split is bitwise one run.
  The serving steps run it on every push.  The kernel runs a thread a
  row over tiles that helper warps stream through a ring in shared
  memory; :func:`ema_scan_plan` picks its launch by shape.

A CUDA tensor goes to the kernel (``csrc/ema_ladder.cu``,
``csrc/index_scan.cu``, ``csrc/cumsum3.cu``, ``csrc/ema_scan.cu``), a CPU
tensor to the plain version, which is dtype-generic (float64 on the CPU).
"""

from __future__ import annotations

import torch

from tempo_tpu_torch.ops import cuda_lib
from tempo_tpu_torch.ops.stream import (BLOCK_RESERVE, SM_SMEM, SMEM_LIMIT,
                                        _align16, _plane)


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


#: the class stages' cut (``kClass2Log2`` and ``class_whole_max`` in
#: ``csrc/common.cuh``): a class of P planes is laddered whole up to
#: 232,448 / (8 P) entries (two buffers in one block's shared memory),
#: else its class-index spans < 2^8 run on windows and the next stage runs
#: along the classes mod 2^8 times the stride
CLASS2_LOG2 = 8
CLASS_SMEM = 232_448


def class_whole_max(planes: int) -> int:
    """Most entries of ``planes`` planes a whole-class stage holds."""
    return CLASS_SMEM // (8 * planes)


def class_stages(planes, idents, L: int, T: int, levels,
                 class_tile_log2=None):
    """The kernels' class stages (``launch_class_ladder`` in
    ``csrc/common.cuh``) on [..., L] planes whose levels of spans < T have
    run: with the lane stride S = T, the planes' entries along each
    residue class ``i mod S`` (the identity past the row); a class of at
    most the whole-class size is laddered over every remaining level (the
    last stage), a longer one over the class-index spans < T2 on windows
    of T2 entries after a T2-entry halo (the identity before the class),
    and S grows by T2.  ``class_tile_log2`` None is the kernel's cut (T2 =
    2^8, whole up to :func:`class_whole_max` entries); an int n makes T2
    = 2^n and the whole size 2^n, so that several stages run on short
    rows.  ``levels(z, end)`` runs the ladder's levels of spans 1, 2, ...
    < ``end`` along the last axis of the planes ``z``."""
    t2 = CLASS2_LOG2 if class_tile_log2 is None else int(class_tile_log2)
    T2 = 1 << t2
    whole = (class_whole_max(len(planes)) if class_tile_log2 is None
             else T2)
    lead = planes[0].shape[:-1]
    dt, dev = planes[0].dtype, planes[0].device

    def full(shape, ident):
        return torch.full(tuple(lead) + shape, ident, dtype=dt, device=dev)

    S = T
    while S < L:
        M = -(-L // S)
        z = [torch.cat([p, full((M * S - L,), i)], -1)
             .view(*lead, M, S).transpose(-1, -2)           # [..., S, M]
             for p, i in zip(planes, idents)]
        last = M <= whole
        if last:
            z = levels(z, M)
        else:
            nw = -(-M // T2)
            wins = [torch.cat([full((S, T2), i), c, full((S, nw * T2 - M), i)],
                              -1).unfold(-1, 2 * T2, T2)     # [..., S, nw, 2T2]
                    for c, i in zip(z, idents)]
            z = [w[..., T2:].reshape(*lead, S, nw * T2)[..., :M]
                 for w in levels(wins, T2)]
        planes = [c.transpose(-1, -2).reshape(*lead, M * S)[..., :L]
                  for c in z]
        if last:
            break
        S *= T2
    return planes


def ema_tiled_plain(x: torch.Tensor, valid: torch.Tensor, alpha: float,
                    tile_log2: int = 10, window_log2: int = 13,
                    row_log2: int = 14, class_tile_log2=None) -> torch.Tensor:
    """:func:`ema_plain`'s values by the kernel's forms, bit for bit: a
    row of at most 2^``row_log2`` lanes runs the whole ladder at once
    (the one-launch form); a longer row, with T = 2^``tile_log2``, runs
    stage 1, the levels of spans < T on windows of 2^``window_log2``
    lanes (a T-lane halo, the identity (1, 0) before the row's start,
    then the window's outputs), and the class stages (:func:`class_stages`,
    ``class_tile_log2`` their cut), the levels of spans T, 2T, ... < L as
    a ladder along each residue class ``i mod T``, the identity where the
    class index m < span / T.  In ``x``'s dtype."""
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
    planes = [p[..., T:].reshape(K, nt * step)[:, :L] for p in (wd, wv)]
    return class_stages(
        planes, (1.0, 0.0), L, T,
        lambda z, end: list(_affine_levels(*z, 1, end, _shift)),
        class_tile_log2)[1]


def ema_cuda(x: torch.Tensor, valid: torch.Tensor, alpha: float
             ) -> torch.Tensor:
    """Launch the ladder kernel on [K, L] float32 CUDA tensors (one call:
    one launch for rows of at most ``cuda_lib.ema_row_max()`` lanes, two
    or more past it, the class stages reading the first's d plane)."""
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
                         f"{cuda_lib.ema_max_lanes()} lanes (int32 lane "
                         f"indices), got {L}")
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


def _scan_planes(x, valid, alpha):
    """The sequential EMA's (decay, input) planes, as the reference's
    ``ema_scan`` forms them: ``1 - a`` / ``a * x`` at valid lanes, ``1``
    / ``0`` elsewhere, in ``x``'s dtype."""
    a = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return (torch.where(valid, one - a, one),
            torch.where(valid, a * x, torch.zeros_like(one)))


def _check_scan_carry(x, y0):
    if y0 is not None and (y0.shape != x.shape[:-1] or y0.dtype != x.dtype):
        raise TypeError(f"y0 must be {x.dtype} {tuple(x.shape[:-1])}, got "
                        f"{y0.dtype} {tuple(y0.shape)}")


def ema_scan_plain(x: torch.Tensor, valid: torch.Tensor, alpha,
                   y0: torch.Tensor = None):
    """``(ys, y_end)`` of ``y = decay * y + inp`` along the last axis of
    ``[..., L]``, from ``y0`` (None: the zero carry): a multiply, then an
    add, two torch ops a lane (never ``addcmul``), so each rounds as the
    kernel's ``__fmul_rn`` and ``__fadd_rn`` do.  In ``x``'s dtype."""
    _check_scan_carry(x, y0)
    decay, inp = _scan_planes(x, valid, alpha)
    y = (torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
         if y0 is None else y0)
    ys = []
    for d, i in zip(decay.unbind(-1), inp.unbind(-1)):
        y = d * y
        y = y + i
        ys.append(y)
    if not ys:
        return torch.empty_like(x), y.clone()
    return torch.stack(ys, -1), y


#: the sequential-EMA kernel's block (``csrc/ema_scan.cu``): a scan warp
#: (a thread a row, at most ``EMA_SCAN_MAX_ROWS`` rows) and three helper
#: warps; the ring depth it asks for, and the lanes a tile of a block
#: holds about (``EMA_SCAN_TILE_LANES / rows``, at least 64)
EMA_SCAN_MAX_ROWS, EMA_SCAN_DEPTH, EMA_SCAN_TILE_LANES = 32, 4, 2048
#: blocks an SM the plan spreads the rows over, and so the shared memory
#: a block may take to keep them all resident (57,344 bytes)
EMA_SCAN_BLOCKS_A_SM = 4
EMA_SCAN_SMEM = SM_SMEM // EMA_SCAN_BLOCKS_A_SM - BLOCK_RESERVE
#: an H100 SXM's SMs, the plan's default card
H100_SMS = 132


def ema_scan_layout(rows: int, tile: int, depth: int, L: int,
                    itemsize: int) -> dict:
    """Shared memory of a block of the sequential-EMA kernel, offsets in
    bytes (``scan_layout`` in ``csrc/ema_scan.cu``; its ``total`` is
    ``tempo_ema_scan_smem`` on the card): ``depth`` barriers, then
    ``depth`` raw slots of ``slot`` bytes from ``slots``, each a 16-byte
    span plane (:func:`stream._plane`) of x (``px``) and of valid
    (``pv``, from ``raw_v``) a row, or one each for all the block's rows
    where they fit one tile (``tile == L``); then from ``planes`` the
    scan's decay and input planes of ``plane`` bytes, rows ``stride``
    elements (an odd number of 16-byte words: eight rows' 128-bit
    accesses at one lane hit distinct banks) apart, in one buffer for one
    tile, else two."""
    whole = tile >= L
    if whole:
        px, pv = _plane(rows * L * itemsize), _plane(rows * L)
        raw_v = px
    else:
        px, pv = _plane(tile * itemsize), _plane(tile)
        raw_v = rows * px
    slot = raw_v + (pv if whole else rows * pv)
    stride = ((_align16(tile * itemsize) // 16) | 1) * 16 // itemsize
    plane = rows * stride * itemsize
    slots = _align16(8 * depth)
    planes = slots + depth * slot
    return dict(px=px, pv=pv, raw_v=raw_v, slot=slot, slots=slots,
                planes=planes, plane=plane, stride=stride,
                total=planes + (2 if whole else 4) * plane)


def ema_scan_plan(R: int, L: int, itemsize: int, sms: int = H100_SMS) -> dict:
    """The sequential-EMA kernel's launch over ``R`` rows of ``L`` lanes
    of ``itemsize``-byte floats on a card of ``sms`` SMs, from the shape
    alone (a CUDA graph captures it): ``rows`` a block (the rows spread
    over four blocks an SM, at most 32), ``tile`` lanes a tile and the
    ring's ``depth`` (at most ``EMA_SCAN_DEPTH`` and the tiles a row, at
    least two where a row has two).  The first, from the widest tile
    (about 2048 lanes a block's tile) down to 64 and then the deepest
    ring, whose block fits ``EMA_SCAN_SMEM`` (four blocks an SM), else
    the one of least shared memory.  ``tile`` is ``L`` where a row fits
    (the ``"rows"`` form: the block's rows are one contiguous copy and
    one scan).  Also its shared memory and ``blocks``.  Raises where the
    kernel takes no such launch."""
    if not (1 <= R < 2**31 and 1 <= L < 2**31):
        raise ValueError(f"ema_scan kernel takes int32 row counts and "
                         f"lengths of at least 1, got [{R}, {L}]")
    if itemsize not in (4, 8):
        raise TypeError(f"ema_scan kernel takes float32 or float64, got "
                        f"{itemsize}-byte items")
    rows = min(EMA_SCAN_MAX_ROWS, -(-R // (EMA_SCAN_BLOCKS_A_SM * sms)))
    widest = max(64, EMA_SCAN_TILE_LANES >> (rows - 1).bit_length())
    plans = []
    for lanes in (widest >> i for i in range(widest.bit_length())
                  if widest >> i >= 64):
        tile = min(L, lanes)
        tiles = -(-L // tile)
        for d in range(min(EMA_SCAN_DEPTH, tiles), min(2, tiles) - 1, -1):
            smem = ema_scan_layout(rows, tile, d, L, itemsize)["total"]
            plans.append(dict(form="rows" if tile == L else "tiles",
                              rows=rows, tile=tile, depth=d, tiles=tiles,
                              smem=smem, blocks=-(-R // rows)))
            if smem <= EMA_SCAN_SMEM:
                return plans[-1]
    least = min(plans, key=lambda p: p["smem"])
    if least["smem"] > SMEM_LIMIT:
        raise ValueError(f"ema_scan: no plan of [{R}, {L}] fits "
                         f"{SMEM_LIMIT} B of shared memory")
    return least


#: (R, L, itemsize, SMs) -> the launch's (rows, tile, depth)
_scan_plans: dict = {}


def ema_scan_cuda(x: torch.Tensor, valid: torch.Tensor, alpha,
                  y0: torch.Tensor = None):
    """Launch the sequential-EMA kernel on a float32 or float64 [..., L]
    CUDA tensor (one launch at :func:`ema_scan_plan`'s plan: ``y0`` read
    and ``y_end`` written in it, on the current stream, nothing read back
    or allocated in the launch, so a CUDA graph captures it)."""
    if x.dtype not in (torch.float32, torch.float64) or x.dim() < 1:
        raise TypeError(f"ema_scan kernel takes float32 or float64 [..., L], "
                        f"got {x.dtype} {tuple(x.shape)}")
    if valid.dtype != torch.bool or valid.shape != x.shape:
        raise TypeError("valid must be a bool tensor shaped like x")
    _check_scan_carry(x, y0)
    if not (x.is_cuda and valid.device == x.device
            and (y0 is None or y0.device == x.device)):
        raise ValueError("x, valid and y0 must lie on the same CUDA device")
    L = x.shape[-1]
    R = x.numel() // L if L else 0
    if R >= 2**31 or L >= 2**31:
        raise ValueError(f"ema_scan kernel takes int32 row counts and "
                         f"lengths, got {tuple(x.shape)}")
    ys = torch.empty_like(x, memory_format=torch.contiguous_format)
    y_end = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    if R == 0 or L == 0:
        if y0 is None:
            y_end.zero_()
        else:
            y_end.copy_(y0)
        return ys, y_end
    x, valid = x.contiguous(), valid.contiguous()
    y0 = None if y0 is None else y0.contiguous()
    key = (R, L, x.element_size(), cuda_lib.sm_count(x.device))
    if key not in _scan_plans:
        plan = ema_scan_plan(*key)
        _scan_plans[key] = (plan["rows"], plan["tile"], plan["depth"])
    cuda_lib.launch("ema_scan", x.device, "tempo_ema_scan", x.data_ptr(),
                    valid.data_ptr(), float(alpha), cuda_lib.ptr(y0),
                    ys.data_ptr(), y_end.data_ptr(), R, L, *_scan_plans[key],
                    int(x.dtype == torch.float64))
    return ys, y_end


def ema_scan(x: torch.Tensor, valid: torch.Tensor, alpha,
             y0: torch.Tensor = None):
    """Sequential EMA with an explicit carry, ``(ys, y_end)``: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return ema_scan_cuda(x, valid, alpha, y0)
    return ema_scan_plain(x, valid, alpha, y0)


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


#: the index-scan kernel's block and the lanes a thread scans
#: (``kThreads``, ``kSeg`` in ``csrc/index_scan.cu``)
SCAN_THREADS, SCAN_SEG = 128, 16


def index_scan_tiled_plain(valid: torch.Tensor, reverse: bool = False,
                           x: torch.Tensor = None, *, offset: int = 0,
                           threads: int = SCAN_THREADS, seg: int = SCAN_SEG):
    """The valid-index scans (and, with ``x``, the forward fill's
    ``(values, has)``) as the kernel cuts them, bit for bit: row k's
    lanes start ``(offset + k L) % 16`` bytes into a 16-byte word, and
    the segments of ``seg`` lanes follow those words (the row's first
    segment holds the lanes up to the first boundary); each thread scans
    a segment, each warp of 32 threads scans its threads' totals by
    shuffles, a block of ``threads`` combines its warps, and a carry
    joins its tiles, walked from the row's end when ``reverse``.  The fill
    carries the pair (index, value) through every level.  Equal to
    :func:`last_valid_index_scan_plain` (``reverse``:
    :func:`first_valid_index_scan_plain`; ``x``:
    :func:`last_valid_scan_plain`)."""
    K, L = valid.shape
    dev = valid.device
    T = threads * seg
    none = L if reverse else -1
    off = (offset + torch.arange(K, device=dev) * L) % 16           # [K]
    nt = -(-(L + 15) // T)
    lane = torch.arange(nt * T, device=dev)[None] - off[:, None]     # [K, V]
    inrow = (lane >= 0) & (lane < L)
    q = lane.clamp(0, max(L - 1, 0))
    ok = inrow & torch.gather(valid, 1, q)
    xv = (torch.gather(x, 1, q) if x is not None
          else torch.zeros(ok.shape, device=dev))
    ok = ok.view(K, nt, threads // 32, 32, seg)
    lane = lane.view(ok.shape)
    xv = xv.view(ok.shape)

    def better(a, b):
        return a < b if reverse else a > b

    def take(dst, src, where):
        return tuple(torch.where(where, s, d) for d, s in zip(dst, src))

    # each thread's segment, in walk order
    m = (torch.full(ok.shape[:-1], none, device=dev),
         torch.zeros(ok.shape[:-1], dtype=xv.dtype, device=dev))
    run_i, run_v = torch.empty_like(lane), torch.empty_like(xv)
    for jj in range(seg):
        j = seg - 1 - jj if reverse else jj
        m = take(m, (lane[..., j], xv[..., j]), ok[..., j])
        run_i[..., j], run_v[..., j] = m
    # the warp's inclusive scan by shuffles (from higher lanes in reverse)
    w = torch.arange(32, device=dev)
    for o in (1, 2, 4, 8, 16):
        src = tuple(torch.roll(a, -o if reverse else o, dims=-1) for a in m)
        inl = (w + o < 32) if reverse else (w >= o)
        m = take(m, src, inl & better(src[0], m[0]))
    ex = tuple(torch.roll(a, -1 if reverse else 1, dims=-1) for a in m)
    first = w == (31 if reverse else 0)
    ex = (torch.where(first, none, ex[0]), torch.where(first, 0.0, ex[1]))
    wt = tuple(a[..., 31 if not reverse else 0] for a in m)           # [K, nt, W]
    # the block's warps in walk order, then the carry over tiles
    before = (torch.empty_like(ex[0]), torch.empty_like(ex[1]))
    carry = (torch.full((K,), none, device=dev),
             torch.zeros(K, dtype=xv.dtype, device=dev))
    nw = threads // 32
    for tt in range(nt):
        s = nt - 1 - tt if reverse else tt
        run = carry
        for ww in range(nw):
            wi = nw - 1 - ww if reverse else ww
            before[0][:, s, wi], before[1][:, s, wi] = (
                run[0][:, None].expand(-1, 32), run[1][:, None].expand(-1, 32))
            src = (wt[0][:, s, wi], wt[1][:, s, wi])
            run = take(run, src, better(src[0], run[0]))
        carry = run
    before = take(before, ex, better(ex[0], before[0]))
    if x is None:
        out = torch.where(better(run_i, before[0][..., None]), run_i,
                          before[0][..., None])
    else:
        own = run_i != none
        c = torch.where(own, run_i, before[0][..., None])
        has = c >= 0
        out = (torch.where(has, torch.where(own, run_v, before[1][..., None]),
                           0.0), has)

    def lanes_of(a):
        flat = a.reshape(K, -1)
        return torch.gather(flat, 1, torch.arange(L, device=dev)[None]
                            + off[:, None])
    if x is None:
        return lanes_of(out).to(torch.int32)
    return lanes_of(out[0]).to(x.dtype), lanes_of(out[1])


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


def cumsum3_tiled_plain(x: torch.Tensor, valid: torch.Tensor,
                        tile_log2: int = 10, class_tile_log2=None):
    """:func:`cumsum3_plain`'s sums by the kernel's stages, bit for bit:
    with T = 2^min(tile_log2, levels), stage 1 runs the ladder's levels of
    spans < T on each tile of T lanes from the tile and the T lanes before
    it alone (0 before the row's start); the class stages
    (:func:`class_stages`, ``class_tile_log2`` their cut) run the levels
    of spans T, 2T, ... < L as a ladder along each residue class ``i mod
    T``, 0 added where the class index m < span / T.  In ``x``'s
    dtype."""
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
        out.append(win[..., T:].reshape(K, nt * T)[:, :L])

    def levels(z, end):
        span = 1
        while span < end:
            z = [c + _shift(c, span, 0.0) for c in z]
            span *= 2
        return z
    return tuple(class_stages(out, (0.0,) * 3, L, T, levels,
                              class_tile_log2))


def cumsum3_cuda(x: torch.Tensor, valid: torch.Tensor):
    """Launch the tiled prefix-sum kernel on float32 [K, L] CUDA tensors
    (one call; two launches or more for rows longer than 1024 lanes)."""
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
                         f"{cuda_lib.cumsum3_max_lanes()} lanes (int32 lane "
                         f"indices), got {L}")
    cuda_lib.launch("cumsum3", x.device, "tempo_cumsum3", x.data_ptr(),
                    valid.data_ptr(), *(o.data_ptr() for o in out), K, L)
    return out


def cumsum3(x: torch.Tensor, valid: torch.Tensor):
    """The three prefix sums of the windowed range engine: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return cumsum3_cuda(x, valid)
    return cumsum3_plain(x, valid)
