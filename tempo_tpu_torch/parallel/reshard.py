"""Resharding between parallelism layouts (the shuffle analog).

Counterpart of ``tempo_tpu/parallel/reshard.py``.  The reference
switches distribution layouts with Spark shuffles (a
``Window.partitionBy(key)`` stage hash-shuffles by key, a skew-bucketed
stage by (key, bracket), tsdf.py:164-190, 549-558); here a packed
``[..., K, L]`` array moves between

* the **time-sharded** layout ``("series", "time")``: a ``[K/n_s,
  L/n_t]`` block a device (what the halo functions of
  :mod:`tempo_tpu_torch.parallel.halo` want for series too long for one
  device), and
* the **series-local** layout ``(("series", "time"), None)``: whole
  rows, K cut over every device (what every per-series op wants),

by moving blocks between the shards' devices (``mesh.transfer``:
``tensor.to(device)`` in a process, point-to-point sends across
processes).  Three entry points, as the reference's:

* :func:`reshard`: declarative, any layout to any layout (each target
  block gathered from the source blocks it overlaps);
* :func:`all_to_all_series_to_time` / :func:`all_to_all_time_to_series`:
  the tiled all-to-all of ``lax.all_to_all(..., tiled=True)`` over the
  time axis, on lists of shards: each block splits along one dimension
  into ``n_t`` chunks, chunk ``j`` goes to time peer ``j``, and each
  peer concatenates what it receives in sender order along the other
  dimension.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tempo_tpu_torch.parallel.mesh import (Mesh, block_slices, device_guard,
                                           meta_like, process_index,
                                           spec_axes, transfer)

Shards = List[torch.Tensor]


def _grid(mesh: Mesh, series_axis: str, time_axis: str):
    """(series axes present, n_s, n_t): a mesh without the series axis
    has one series group."""
    s = (series_axis,) if series_axis in mesh.axis_names else ()
    n_s = mesh.shape[series_axis] if s else 1
    return s, n_s, mesh.shape[time_axis]


def time_axes(mesh: Mesh, series_axis: str = "series",
              time_axis: str = "time") -> tuple:
    """The axes of the time-sharded layout's flat shard list: (series,
    time), or (time,) on a mesh without the series axis.  The series-
    local layout's joint axis is the same tuple."""
    return _grid(mesh, series_axis, time_axis)[0] + (time_axis,)


def _a2a(blocks: Shards, mesh: Mesh, series_axis: str, time_axis: str,
         split_dim: int, concat_dim: int) -> Shards:
    """The tiled all-to-all over the time axis, within each series
    group: block (s, t) splits along ``split_dim`` into n_t chunks,
    chunk j goes to (s, j), and (s, j) concatenates its chunks in sender
    order t = 0..n_t-1 along ``concat_dim``."""
    axes = time_axes(mesh, series_axis, time_axis)
    _, n_s, n_t = _grid(mesh, series_axis, time_axis)
    devs, ranks = mesh.axis_devices(axes), mesh.axis_ranks(axes)
    if len(blocks) != n_s * n_t:
        raise ValueError(f"{len(blocks)} blocks for a {n_s}x{n_t} grid")
    size = int(blocks[0].shape[split_dim])
    if size % n_t:
        raise ValueError(f"dimension {size} does not split into {n_t} "
                         f"chunks")
    c = size // n_t
    ent = mesh.axis_entries(axes)
    moves, entries = [], []
    for s in range(n_s):
        for j in range(n_t):
            for t in range(n_t):
                src = s * n_t + t
                moves.append((blocks[src].narrow(split_dim, j * c, c),
                              ranks[src], devs[s * n_t + j],
                              ranks[s * n_t + j]))
                entries.append((ent[src], ent[s * n_t + j]))
    moved = transfer(moves, "all-to-all", entries)
    me = process_index()
    out = []
    for g in range(n_s * n_t):
        parts = moved[g * n_t:(g + 1) * n_t]
        if ranks[g] != me:
            shape = list(parts[0].shape)
            shape[concat_dim] = sum(int(p.shape[concat_dim]) for p in parts)
            out.append(meta_like(parts[0], shape))
            continue
        with device_guard(devs[g]):
            out.append(torch.cat(parts, dim=concat_dim))
    return out


def all_to_all_series_to_time(blocks: Shards, mesh: Mesh,
                              series_axis: str = "series",
                              time_axis: str = "time") -> Shards:
    """Time-sharded ``[..., K/n_s, L/n_t]`` blocks -> series-local
    ``[..., K/(n_s*n_t), L]`` full rows (the joint ``(series, time)``
    axis owns contiguous series blocks): one tiled all-to-all over the
    time axis a series group, splitting the rows and concatenating the
    lanes.  Use when a time-sharded stage feeds a per-series stage
    (resample, FFT) without a host round trip."""
    nd = blocks[0].dim()
    if int(blocks[0].shape[-2]) % mesh.shape[time_axis]:
        raise ValueError(f"series dim {int(blocks[0].shape[-2])} must "
                         f"divide over the time axis")
    return _a2a(blocks, mesh, series_axis, time_axis, nd - 2, nd - 1)


def all_to_all_time_to_series(blocks: Shards, mesh: Mesh,
                              series_axis: str = "series",
                              time_axis: str = "time") -> Shards:
    """Inverse of :func:`all_to_all_series_to_time`: full-row blocks cut
    over the joint (series, time) axis -> time-sharded blocks."""
    nd = blocks[0].dim()
    if int(blocks[0].shape[-1]) % mesh.shape[time_axis]:
        raise ValueError(f"shape {tuple(blocks[0].shape)} incompatible "
                         f"with {mesh.shape[time_axis]} time shards")
    return _a2a(blocks, mesh, series_axis, time_axis, nd - 1, nd - 2)


def global_shape(shards: Shards, mesh: Mesh, spec: Sequence) -> tuple:
    """The global shape of an array held as ``shards`` under ``spec``."""
    shape = list(shards[0].shape)
    lead = len(shape) - len(spec)
    for d, e in enumerate(spec):
        if e is not None:
            shape[lead + d] *= mesh.axis_size(e)
    return tuple(shape)


def reshard(shards: Shards, mesh: Mesh, spec: Sequence,
            src_spec: Sequence) -> Shards:
    """Move an array from layout ``src_spec`` to ``spec`` on ``mesh``
    (the counterpart of ``jax.device_put`` to a ``NamedSharding``):
    each target block is gathered from the source blocks it overlaps,
    one move a (source, target) pair, and copied into place.  An axis a
    spec leaves out replicates the array over it; the source is read
    from the replica at index 0."""
    shape = global_shape(shards, mesh, src_spec)
    src_axes, dst_axes = spec_axes(src_spec), spec_axes(spec)
    src_ranks = (mesh.axis_ranks(src_axes) if src_axes
                 else [int(mesh.ranks.flat[0])])
    dst_devs = (mesh.axis_devices(dst_axes) if dst_axes
                else [mesh.devices.flat[0]])
    dst_ranks = (mesh.axis_ranks(dst_axes) if dst_axes
                 else [int(mesh.ranks.flat[0])])
    src_ent = mesh.axis_entries(src_axes) if src_axes else [0]
    dst_ent = mesh.axis_entries(dst_axes) if dst_axes else [0]
    src_sl = block_slices(mesh, src_spec, shape)
    dst_sl = block_slices(mesh, spec, shape)
    moves, plan, entries = [], [], []
    for d, dsl in enumerate(dst_sl):
        for j, ssl in enumerate(src_sl):
            lo = [max(a.start, b.start) for a, b in zip(dsl, ssl)]
            hi = [min(a.stop, b.stop) for a, b in zip(dsl, ssl)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            piece = shards[j][tuple(slice(l - b.start, h - b.start)
                                    for l, h, b in zip(lo, hi, ssl))]
            moves.append((piece, src_ranks[j], dst_devs[d], dst_ranks[d]))
            entries.append((src_ent[j], dst_ent[d]))
            plan.append((d, tuple(slice(l - a.start, h - a.start)
                                  for l, h, a in zip(lo, hi, dsl))))
    moved = transfer(moves, "all-to-all", entries)
    me = process_index()
    out = []
    for d, dsl in enumerate(dst_sl):
        bshape = [s.stop - s.start for s in dsl]
        if dst_ranks[d] != me:
            out.append(meta_like(shards[0], bshape))
            continue
        block = torch.empty(bshape, dtype=shards[0].dtype,
                            device=dst_devs[d])
        for (dd, sl), piece in zip(plan, moved):
            if dd == d:
                block[sl].copy_(piece)
        out.append(block)
    return out


def assemble(shards: Shards, mesh: Mesh, spec: Sequence, device=None,
             rank: int = 0) -> torch.Tensor:
    """The global array of ``shards`` under ``spec`` as one tensor on
    ``device`` of process ``rank`` (default: the first device that
    process owns); the other processes send their blocks and get a
    placeholder."""
    shape = global_shape(shards, mesh, spec)
    axes = spec_axes(spec)
    devs = mesh.axis_devices(axes) if axes else [mesh.devices.flat[0]]
    ranks = mesh.axis_ranks(axes) if axes else [int(mesh.ranks.flat[0])]
    dev = torch.device(device) if device is not None else \
        devs[ranks.index(rank)]
    # the destination is a mesh entry only when the caller names none
    ent = mesh.axis_entries(axes) if axes else [0]
    dst_e = ent[ranks.index(rank)] if device is None else -1
    moved = transfer([(s, r, dev, rank) for s, r in zip(shards, ranks)],
                     "all-to-all", [(e, dst_e) for e in ent])
    if rank != process_index():
        return meta_like(shards[0], shape)
    out = torch.empty(shape, dtype=shards[0].dtype, device=dev)
    for sl, piece in zip(block_slices(mesh, spec, shape), moved):
        out[sl].copy_(piece)
    return out
