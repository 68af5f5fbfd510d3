"""Time-axis sharding with neighbour halo exchange (sequence parallelism).

Counterpart of ``tempo_tpu/parallel/halo.py``.  The reference handles
"too many rows a key" with overlapping time brackets: round ts into
``tsPartitionVal``-second buckets and duplicate the trailing
``fraction`` of each bucket into the next, so windowed lookbacks see
their history (tsdf.py:164-190, consumed at :549-558).  Here the same
algebra is a device layout: the packed time axis of a ``[K, L]`` array
is cut over a ``time`` mesh axis (a list of ``[K/n_s, L/n_t]`` blocks,
``parallel/mesh.py``), each block receives the last ``halo`` columns of
its left neighbour (and, for ties, the first ``halo`` of its right
one), moved between the blocks' devices (``mesh.transfer``), and the
port's kernels run on the extended block; the halo is dropped from the
outputs.

Correctness contract (the reference's): the halo must cover the
lookback.  Like the reference's missing-value audit (tsdf.py:141-159),
the functions count the rows whose window may have been cut at the
halo (``clipped``, one count a block) instead of failing.

A packed row is non-decreasing along the whole time axis (real
timestamps, then ``TS_PAD``), so [left neighbour's tail | block] is a
contiguous slice of the row and stays sorted: the rank kernel's merge
needs no re-sort.  The first block's left halo is ``TS_NEG`` (nothing
before the beginning), the last block's right halo ``TS_POS``, both in
the caller's units: the frame passes seconds (``ts // NS_PER_S``, as
the reference divides before the exchange), so the sentinels sit in the
seconds domain, where ``TS_NEG - window`` cannot wrap int64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.ops import sortmerge as sm
from tempo_tpu_torch.parallel.mesh import (Mesh, device_guard, shard_map,
                                           transfer, unzip)
from tempo_tpu_torch.parallel.reshard import _grid, time_axes

Shards = List[torch.Tensor]

# below every real ns timestamp, with headroom so subtracting a window
# cannot underflow int64 (the mirror of TS_PAD)
TS_NEG = np.int64(-packing.TS_REAL_MAX)
# the last block's right-halo fill: above every real timestamp, so the
# extended row stays sorted and no window reaches it (the packed rows'
# own padding sentinel)
TS_POS = packing.TS_PAD


def _neighbour(mesh: Mesh, blocks: Shards, halo: int, fill, step: int,
               time_axis: str, series_axis: str) -> Shards:
    """Each block's halo from the neighbour ``step`` (-1: left, +1:
    right) along the time axis: that neighbour's last (left) or first
    (right) ``halo`` columns, moved to this block's device; ``fill`` at
    the end of the axis."""
    axes = time_axes(mesh, series_axis, time_axis)
    _, n_s, n_t = _grid(mesh, series_axis, time_axis)
    devs, ranks = mesh.axis_devices(axes), mesh.axis_ranks(axes)
    ent = mesh.axis_entries(axes)
    moves, dst, entries = [], [], []
    for s in range(n_s):
        for t in range(n_t):
            src_t = t + step
            if 0 <= src_t < n_t:
                b = blocks[s * n_t + src_t]
                piece = b[..., -halo:] if step < 0 else b[..., :halo]
                moves.append((piece, ranks[s * n_t + src_t],
                              devs[s * n_t + t], ranks[s * n_t + t]))
                dst.append(s * n_t + t)
                entries.append((ent[s * n_t + src_t], ent[s * n_t + t]))
    moved = dict(zip(dst, transfer(moves, "collective-permute", entries)))
    out = []
    for i, b in enumerate(blocks):
        if i in moved:
            out.append(moved[i])
        else:
            with device_guard(devs[i]):
                out.append(torch.full_like(b[..., :halo], fill))
    return out


def _halo_from_left(mesh: Mesh, blocks: Shards, halo: int, fill,
                    time_axis: str = "time",
                    series_axis: str = "series") -> Shards:
    """Each block's left halo: the last ``halo`` columns of its left
    neighbour (``fill`` on the first block of a series group)."""
    return _neighbour(mesh, blocks, halo, fill, -1, time_axis, series_axis)


def _halo_from_right(mesh: Mesh, blocks: Shards, halo: int, fill,
                     time_axis: str = "time",
                     series_axis: str = "series") -> Shards:
    """Each block's right halo: the first ``halo`` columns of its right
    neighbour (``fill`` on the last block).  Needed because a Spark
    range frame includes *following* rows that share the current row's
    order-key value, and such ties can straddle a block boundary."""
    return _neighbour(mesh, blocks, halo, fill, +1, time_axis, series_axis)


def _check_halo(mesh: Mesh, L: int, halo: int, time_axis: str) -> int:
    n_time = mesh.shape[time_axis]
    if L % n_time != 0:
        raise ValueError(f"time axis {L} not divisible by mesh axis {n_time}")
    if not (0 < halo <= L // n_time):
        raise ValueError(f"halo {halo} must be in (0, {L // n_time}]")
    return n_time


def _time_index(mesh: Mesh, time_axis: str, series_axis: str) -> list:
    """Each block's index along the time axis."""
    _, n_s, n_t = _grid(mesh, series_axis, time_axis)
    return [t for _ in range(n_s) for t in range(n_t)]


def range_stats_time_sharded(mesh: Mesh, ts_long: Shards, x: Shards,
                             valid: Shards, window_secs: float, halo: int,
                             time_axis: str = "time",
                             series_axis: str = "series"
                             ) -> Tuple[Dict[str, Shards], Shards]:
    """``withRangeStats`` (tsdf.py:673-721 semantics) over time-sharded
    blocks of a sorted int64 seconds axis ``ts_long``, values ``x`` and
    ``valid``.  Each block is extended by a left and a right halo and
    runs the windowed engine (``ops/rolling.range_window_bounds``, the
    rank kernel, then ``windowed_stats``, the ``cumsum3`` kernel).
    Returns (stats name -> blocks, clipped: one int64 count a block).

    ``clipped`` audits both truncation sides: rows whose window start
    hit the left halo's edge on a non-first block, and rows whose tie
    run reached the right halo's end on a non-last block."""
    n_t = _check_halo(mesh, int(ts_long[0].shape[-1]) * mesh.shape[time_axis],
                      halo, time_axis)
    w = math.floor(float(window_secs))
    h_ts = _halo_from_left(mesh, ts_long, halo, int(TS_NEG), time_axis,
                           series_axis)
    h_x = _halo_from_left(mesh, x, halo, 0.0, time_axis, series_axis)
    h_v = _halo_from_left(mesh, valid, halo, False, time_axis, series_axis)
    r_ts = _halo_from_right(mesh, ts_long, halo, int(TS_POS), time_axis,
                            series_axis)
    r_x = _halo_from_right(mesh, x, halo, 0.0, time_axis, series_axis)
    r_v = _halo_from_right(mesh, valid, halo, False, time_axis, series_axis)

    def block(ti, ts_l, x_l, v_l, hts, hx, hv, rts, rx, rv):
        ext_ts = torch.cat([hts, ts_l, rts], dim=-1)
        ext_x = torch.cat([hx, x_l, rx], dim=-1)
        ext_v = torch.cat([hv, v_l, rv], dim=-1)
        L_ext, Ll = ext_ts.shape[-1], ts_l.shape[-1]
        start, end = rk.range_window_bounds(ext_ts, w)
        span = torch.where(ext_v, end - start, 0)
        max_w = max(1, int(span.max())) if span.numel() else 1
        stats = rk.windowed_stats(ext_x, ext_v, start, end,
                                  max_window=1 << (max_w - 1).bit_length())
        out = {k: v[..., halo:halo + Ll] for k, v in stats.items()}
        s_loc = start[..., halo:halo + Ll]
        e_loc = end[..., halo:halo + Ll]
        cut = ((s_loc == 0) & v_l & (ti > 0)) \
            | ((e_loc == L_ext) & v_l & (ti < n_t - 1))
        return out, cut.sum(dtype=torch.int64)

    axes = time_axes(mesh, series_axis, time_axis)
    stats, clipped = unzip(shard_map(
        block, mesh, _time_index(mesh, time_axis, series_axis), ts_long, x,
        valid, h_ts, h_x, h_v, r_ts, r_x, r_v, axis=axes))
    return unzip(stats), clipped


def _gather_to_later(mesh: Mesh, parts: Shards, time_axis: str,
                     series_axis: str) -> List[List[torch.Tensor]]:
    """For each block, the ``parts`` of the blocks before it on its time
    axis (in time order), moved to its device: the exclusive half of
    the reference's ``all_gather`` over the time axis."""
    axes = time_axes(mesh, series_axis, time_axis)
    _, n_s, n_t = _grid(mesh, series_axis, time_axis)
    devs, ranks = mesh.axis_devices(axes), mesh.axis_ranks(axes)
    ent = mesh.axis_entries(axes)
    moves, dst, entries = [], [], []
    for s in range(n_s):
        for t in range(n_t):
            for j in range(t):
                src = s * n_t + j
                moves.append((parts[src], ranks[src], devs[s * n_t + t],
                              ranks[s * n_t + t]))
                dst.append(s * n_t + t)
                entries.append((ent[src], ent[s * n_t + t]))
    got: List[List[torch.Tensor]] = [[] for _ in parts]
    for i, t in zip(dst, transfer(moves, "all-gather", entries)):
        got[i].append(t)
    return got


def ema_time_sharded(mesh: Mesh, x: Shards, valid: Shards, alpha: float,
                     time_axis: str = "time",
                     series_axis: str = "series") -> Shards:
    """Exact infinite-horizon EMA across a time-sharded axis.

    The recurrence is an associative (decay, value) monoid: each block
    runs the EMA ladder kernel (``ops/scan.ema``, from a zero state) and
    ``torch.cumprod`` of its decay plane (the kernel returns ``y``
    only); the blocks' totals (last decay prefix, last value) reach the
    later blocks of their series group, each combines them in time order
    from (1, 0) into its exclusive carry, and adds ``d * carry``.  The
    ladder and the reference's associative scan associate the products
    differently, so the two agree to rounding, not bitwise."""
    n_t = mesh.shape[time_axis]
    a = float(alpha)
    axes = time_axes(mesh, series_axis, time_axis)

    def local(x_l, v_l):
        decay = torch.where(v_l, torch.full_like(x_l, 1.0 - a),
                            torch.ones_like(x_l))
        y = rk.ema_exact(x_l, v_l, a)
        d = torch.cumprod(decay, dim=-1)
        return y, d, torch.stack([d[..., -1], y[..., -1]])

    y, d, tot = unzip(shard_map(local, mesh, x, valid, axis=axes))
    if n_t == 1:
        return y
    prior = _gather_to_later(mesh, tot, time_axis, series_axis)

    def stitch(y_l, d_l, before):
        carry_d = torch.ones_like(y_l[..., 0])
        carry_v = torch.zeros_like(y_l[..., 0])
        for p in before:
            # combine((carry_d, carry_v), (d_j, v_j))
            carry_d, carry_v = carry_d * p[0], p[1] + p[0] * carry_v
        return y_l + d_l * carry_v[..., None]

    return shard_map(stitch, mesh, y, d, prior, axis=axes)


def asof_time_sharded(mesh: Mesh, l_ts: Shards, r_ts: Shards,
                      r_valids: Shards, r_values: Shards, halo: int,
                      time_axis: str = "time", series_axis: str = "series"
                      ) -> Tuple[Shards, Shards, Shards]:
    """AS-OF join over time-sharded left/right with unbounded lookback.

    Each block joins its left rows against its right block extended by
    the first ``halo`` columns of the right neighbour (a tie run can
    straddle the boundary, and equal timestamps match) through
    ``ops/sortmerge.asof_merge_values`` (the ``asof_merge`` kernel).
    Matches further back ride a cross-block carry: each block publishes
    its last non-null value a (column, series), from its own block only,
    and a row with no local match takes the latest one of the blocks
    before it (the associative-scan form of the reference's
    ``last(col, ignoreNulls)``).  ``r_valids`` must be False on padding
    rows (the carry relies on it).

    Precondition (value-aligned shards, the reference's): for every
    block i, every right row in blocks j < i is at or before every left
    row in block i, as when both sides share a time grid.  For sides
    packed independently use the exact all-to-all join
    (``DistributedTSDF.asofJoin``); under misalignment this carry can
    surface a later right value than the true as-of match.

    Returns (values [C, K, Ll] blocks, found blocks, clipped: one count a
    block of left rows whose tie run may continue past the right
    halo)."""
    L_r = int(r_ts[0].shape[-1]) * mesh.shape[time_axis]
    n_t = _check_halo(mesh, L_r, halo, time_axis)
    axes = time_axes(mesh, series_axis, time_axis)
    g_ts = _halo_from_right(mesh, r_ts, halo, int(TS_POS), time_axis,
                            series_axis)
    g_val = _halo_from_right(mesh, r_valids, halo, False, time_axis,
                             series_axis)
    g_x = _halo_from_right(mesh, r_values, halo, 0.0, time_axis,
                           series_axis)

    def local(ti, lts, rts, rval, rx, gts, gval, gx):
        ext_ts = torch.cat([rts, gts], dim=-1)
        ext_val = torch.cat([rval, gval], dim=-1)
        ext_x = torch.cat([rx, gx], dim=-1)
        vals, found, last_idx = sm.asof_merge_values(lts, ext_ts, ext_val,
                                                     ext_x)
        lane = torch.arange(rts.shape[-1], device=rts.device)
        lv = torch.where(rval, lane, -1).amax(dim=-1)          # [C, K]
        v_local = torch.gather(rx, -1, lv.clamp(min=0)[..., None])[..., 0]
        l_real = lts < int(packing.TS_REAL_MAX)
        cut = (last_idx == ext_ts.shape[-1] - 1) & l_real & (ti < n_t - 1)
        pub = torch.stack([(lv >= 0).to(rx.dtype), v_local])
        return vals, found, pub, cut.sum(dtype=torch.int64)

    vals, found, pub, clipped = unzip(shard_map(
        local, mesh, _time_index(mesh, time_axis, series_axis), l_ts, r_ts,
        r_valids, r_values, g_ts, g_val, g_x, axis=axes))
    prior = (_gather_to_later(mesh, pub, time_axis, series_axis)
             if n_t > 1 else [[] for _ in pub])

    def carry(v, f, before):
        has = torch.zeros_like(f[..., 0])
        val = torch.zeros_like(v[..., 0])
        for p in before:
            take = p[0] > 0.5
            has = has | take
            val = torch.where(take, p[1], val)
        v = torch.where(f, v, val[..., None])
        f = f | has[..., None]
        return torch.where(f, v, torch.full_like(v, float("nan"))), f

    vals, found = unzip(shard_map(carry, mesh, vals, found, prior,
                                  axis=axes))
    return vals, found, clipped

