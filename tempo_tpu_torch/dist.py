"""DistributedTSDF: the frame on a device mesh, its ops chained on the
devices.

Counterpart of ``tempo_tpu/dist.py``.  ``TSDF.on_mesh(...)`` packs the
frame once, cuts the packed ``[K, L]`` arrays over the mesh and returns
a :class:`DistributedTSDF` whose ops (``asofJoin``, ``withRangeStats``,
``EMA``, ``resample``, ``calc_bars``, ``interpolate``,
``withGroupedStats``, ``vwap``, ``describe``, ``autocorr``,
``fourier_transform``, ``lookback_tensor``) run on each shard on its
device, the results staying there across chained ops.  ``collect()``
brings the frame back to a host-backed :class:`TSDF` with one
device-to-host copy a shard.

On a one-device mesh this is the engine's device-residency path: a chain
of N ops does one pack and one fetch (``_PACK_EVENTS`` /
``_FETCH_EVENTS`` count them), where the host frame re-packs for every
op.

Layouts (``parallel/mesh.py``): a frame is cut along K over its
``series`` axis and, with a ``time_axis``, along L over that axis too
(a ``[K/n_s, L/n_t]`` block a device, ``from_tsdf``).  A series-local
frame (:func:`reshard_frame`) holds whole rows over every device: its
``series_axis`` is the joint tuple ``(series, time)`` and its
``time_axis`` None, and every per-shard program runs on it unchanged.

Design notes:

* Every op but the join is series-local, so a shard computes its rows
  alone and the result of a row does not depend on the shard it lies
  in.  The join gathers the right frame's rows into the left frame's
  series order across shards (``_align_rows``: one ``index_select`` a
  source shard, moved to the destination shard's device).
* On a time axis the per-series ops switch to the series-local layout
  and back (:func:`reshard_frame`, or an all-to-all of the planes an op
  reads), exactly where the reference does; the exact join joins whole
  rows; ``EMA`` composes across time blocks (``parallel/halo.
  ema_time_sharded``) and ``withRangeStats(strategy="halo")`` reads its
  lookback through a neighbour halo with a deferred truncation audit.
* Timestamps compute in int64 ns on the device.  The joined right
  timestamp rides the value planes as three 21-bit chunk planes (each
  exact in float32) and is recomposed to int64 ns at collect.
* Counts ride as floats (exact below 2^24) and are cast to int64 at
  collect.
* Non-numeric columns stay on the host and rejoin the frame at collect.
* ``asofJoin``, ``withRangeStats``, ``EMA`` and ``collect`` open spans
  ``tempo.dist.<op>[.<phase>]`` (``profiling.annotate``; free with no
  profiler active): the host preparation of each op is named in a
  trace, on the clock of the card's records.
* Several processes (``parallel/multihost.py``): a process uploads and
  computes its own devices' shards (the others' are ``meta``
  placeholders); the join's row gather and the time axis's moves cross
  processes point to point, and ``collect()``, the deferred audits and
  the host reductions gather host arrays over the process group.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import device as device_policy
from tempo_tpu_torch import packing, profiling
from tempo_tpu_torch.freq import (
    CLOSEST_LEAD, MAX_LEAD, MEAN_LEAD, MIN_LEAD, UNIT_SECONDS, average,
    ceiling, floor, freq_to_seconds, max_func, min_func, validateFuncExists,
)
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.ops import sortmerge as sm
from tempo_tpu_torch.ops import stats as legacy
from tempo_tpu_torch.ops import window
from tempo_tpu_torch.parallel import halo as ph
from tempo_tpu_torch.parallel.reshard import (
    all_to_all_series_to_time, all_to_all_time_to_series, assemble, time_axes,
)
from tempo_tpu_torch.parallel.mesh import (
    Mesh, default_mesh, host_gather, is_local, meta_like, place,
    place_planes, process_index, shard_map, transfer, unzip,
)
from tempo_tpu_torch.parallel.mesh import upload_planes as _upload_planes

logger = logging.getLogger(__name__)

# transfer-count instrumentation: a chain of N ops must do 1 pack + 1
# fetch (the tests and chip_smoke.py assert this)
_PACK_EVENTS = 0
_FETCH_EVENTS = 0

_I32_MAX = 2**31 - 1
_NEG = -(2**62)
_GROUPED_STATS = ("mean", "count", "min", "max", "sum", "stddev")

Shards = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistCol:
    """One device-resident column: a values shard and a validity shard a
    device, with materialisation hints."""

    values: Shards             # [K_shard, L_shard] compute dtype
    valid: Shards              # [K_shard, L_shard] bool
    int64: bool = False        # cast to int64 at collect (counts)
    # (target ts column, bit shift): one 21-bit chunk of an int64-ns
    # timestamp; three such planes recompose the ts exactly at collect
    ts_chunk: Optional[Tuple[str, int]] = None
    # (flat host values [n_right_rows], right starts [K_r+1], perm
    # [K_dev] left->right series map): ``values`` holds matched right
    # ROW positions and collect() gathers the host-resident data
    host_gather: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def _time_axis_size(mesh: Mesh, time_axis: Optional[str]) -> int:
    if time_axis is None:
        return 1
    if time_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis named {time_axis!r}")
    return mesh.shape[time_axis]


def _mesh_packed_geometry(layout, mesh: Mesh, series_axis: str,
                          time_axis: Optional[str] = None):
    """``(K_dev, L, n_series_shards, n_time)``: the reference's geometry.
    K is a multiple of every mesh axis the frame spans (so the
    layout-switching all-to-alls stay legal), L a multiple of 8 times
    the time axis (``tempo_tpu/dist.py:1448-1462``)."""
    n_s = mesh.shape[series_axis]
    n_t = _time_axis_size(mesh, time_axis)
    k_mult = n_s * n_t
    K_dev = max(1, -(-layout.n_series // k_mult)) * k_mult
    L = packing.pad_length(int(layout.lengths.max(initial=0)),
                           multiple=8 * n_t)
    return K_dev, L, n_s, n_t


def _pad_k(arr: np.ndarray, K_dev: int, fill) -> np.ndarray:
    K = arr.shape[0]
    if K == K_dev:
        return arr
    pad = np.full((K_dev - K,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _flat_host(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """The bytes of tensors of one device on the host with ONE
    device-to-host copy (their byte views concatenated on the device)."""
    if not tensors:
        return np.zeros(0, np.uint8)
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()


def _fetch_planes(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors of one device -> host arrays with one device-to-host
    copy."""
    return _split_host(_flat_host(tensors), tensors)


def _split_host(host: np.ndarray, like: Sequence[torch.Tensor]
                ) -> List[np.ndarray]:
    out, off = [], 0
    for t in like:
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        n = t.numel()
        out.append(np.frombuffer(host, dtype=dt, count=n,
                                 offset=off).reshape(tuple(t.shape)))
        off += n * dt.itemsize
    return out


def _fetch_shards(per_shard: Sequence[Sequence[torch.Tensor]],
                  ranks: Sequence[int]) -> List[List[np.ndarray]]:
    """Each shard's tensors on the host, on every process: one
    device-to-host copy a shard of this process, then the shards'
    bytes broadcast from their owners over the process group (nothing
    moves in one process)."""
    bufs = [_flat_host(ts) if not ts or is_local(ts[0]) else None
            for ts in per_shard]
    sizes = [sum(t.numel() * t.element_size() for t in ts)
             for ts in per_shard]
    hosts = host_gather(bufs, ranks, sizes)
    return [_split_host(h, ts) for h, ts in zip(hosts, per_shard)]


def _key_perm(left_kf: pd.DataFrame, right_kf: pd.DataFrame,
              pcols: List[str], K_dev: int):
    """For each left series id, the right series id with the same
    partition-key tuple (``ok`` False where absent)."""
    if not pcols:
        perm = np.zeros(K_dev, np.int64)
        ok = np.zeros(K_dev, bool)
        ok[0] = len(right_kf.index) > 0
        return perm, ok
    rk_idx = right_kf.reset_index().rename(columns={"index": "__rid__"})
    merged = left_kf.merge(rk_idx, on=pcols, how="left")
    rid = merged["__rid__"].to_numpy()
    ok = ~pd.isna(rid)
    perm = np.where(ok, rid, 0).astype(np.int64)
    perm = np.concatenate([perm, np.zeros(K_dev - len(perm), np.int64)])
    okp = np.concatenate([ok, np.zeros(K_dev - len(ok), bool)])
    return perm, okp


def _align_rows(mesh: Mesh, src: Shards, src_axis, dst_axis,
                perm: np.ndarray, ok: np.ndarray, fill,
                row_axis: int = 0) -> Shards:
    """Gather rows ``perm`` of an array held as whole rows over
    ``src_axis`` (rows on ``row_axis``) into the whole-row shards of
    ``dst_axis`` (``len(perm)`` rows split evenly); rows where ``ok`` is
    False take ``fill``.  Each destination shard takes one
    ``index_select`` from every source shard that holds rows it needs,
    moved to its device (across processes too)."""
    ks_src = int(src[0].shape[row_axis])
    src_ranks = mesh.axis_ranks(src_axis)
    dst_devs, dst_ranks = mesh.axis_devices(dst_axis), \
        mesh.axis_ranks(dst_axis)
    n_dst = len(dst_devs)
    ks_dst = len(perm) // n_dst
    perm = np.clip(perm, 0, ks_src * len(src) - 1)
    src_ent, dst_ent = mesh.axis_entries(src_axis), \
        mesh.axis_entries(dst_axis)
    moves, plan, entries = [], [], []
    for d in range(n_dst):
        p = perm[d * ks_dst:(d + 1) * ks_dst]
        owner, local = p // ks_src, p % ks_src
        for j in np.unique(owner):
            sel = np.flatnonzero(owner == j)
            s = src[j]
            shape = list(s.shape)
            shape[row_axis] = len(sel)
            if is_local(s):
                idx = torch.from_numpy(local[sel]).to(s.device)
                piece = s.index_select(row_axis, idx)
            else:
                piece = meta_like(s, shape)
            moves.append((piece, src_ranks[j], dst_devs[d], dst_ranks[d]))
            entries.append((src_ent[j], dst_ent[d]))
            plan.append((d, sel))
    moved = transfer(moves, "all-gather", entries)
    me = process_index()
    out = []
    for d, dev in enumerate(dst_devs):
        pieces = [(sel, t) for (dd, sel), t in zip(plan, moved) if dd == d]
        shape = list(src[0].shape)
        shape[row_axis] = ks_dst
        if dst_ranks[d] != me:
            out.append(meta_like(src[0], shape))
            continue
        if len(pieces) == 1:
            g = pieces[0][1]
        else:
            g = torch.empty(shape, dtype=src[0].dtype, device=dev)
            for sel, t in pieces:
                g.index_copy_(row_axis, torch.from_numpy(sel).to(dev), t)
        okt = torch.from_numpy(np.ascontiguousarray(
            ok[d * ks_dst:(d + 1) * ks_dst])).to(dev)
        okt = okt.reshape([-1 if a == row_axis else 1
                           for a in range(g.dim())])
        out.append(torch.where(okt, g, torch.tensor(fill, dtype=g.dtype,
                                                    device=dev)))
    return out


def _canon_func(func: str) -> str:
    return {CLOSEST_LEAD: floor, MEAN_LEAD: average, MIN_LEAD: min_func,
            MAX_LEAD: max_func}.get(func, func)


def _pick_range_engine_for_shard(shard_k: int, L: int, rb):
    """``(engine, rowbounds)`` for one shard shape and static row bounds
    (None = unboundable -> the windowed form): the host frame's pick
    (``ops/rolling.pick_range_engine``) at the shard's element count."""
    if rb is None:
        return "windowed", None
    engine = rk.pick_range_engine(max(shard_k, 1) * L, rb[0], rb[1])
    return engine, (None if engine == "windowed" else rb)


def plan_range_engine_choice(layout, mesh: Mesh, series_axis: str,
                             time_axis: Optional[str],
                             window_secs: float):
    """``(engine, rowbounds)`` a frame packed from ``layout`` onto
    ``mesh`` takes in :meth:`DistributedTSDF._range_engine_choice`,
    computed without packing (the plan optimizer's hoist)."""
    if not sm.use_sort_kernels():
        return "windowed", None
    K_dev, L, n_s, n_t = _mesh_packed_geometry(layout, mesh, series_axis,
                                               time_axis)
    rb = (packing.layout_rowbounds(layout, window_secs)
          if layout.n_rows > 0 and int(layout.starts[-1]) == layout.n_rows
          else None)
    return _pick_range_engine_for_shard(K_dev // (n_s * max(n_t, 1)), L, rb)


def stream_mesh(n_devices: Optional[int] = None,
                stream_axis: str = "streams",
                devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh whose one axis is the cohort stream axis, the
    fleet-serving layout: scale-out is stream-parallel, so the whole
    device budget goes to one axis (the first ``n_devices`` of
    ``devices``, default every visible card)."""
    from tempo_tpu_torch.parallel.mesh import make_mesh

    if devices is None:
        device_policy.resolve("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n = len(devices) if n_devices is None else int(n_devices)
    return make_mesh({stream_axis: n}, devices=list(devices))


def stream_shardings(mesh: Mesh, stream_axis: str,
                     n_slots: int) -> List[Tuple[torch.device, int, int]]:
    """The placement of a cohort's ``[S]`` stream axis over ``mesh``'s
    ``stream_axis``: ``(device, first slot, end slot)`` a mesh entry along
    the axis, contiguous slot ranges of ``n_slots / n`` slots each, in
    axis order.  Every state tensor of a cohort shard, and each of its
    steps, lives on its entry's device; no op of a step mixes streams, so
    a push moves nothing between entries (the reference's "zero per-push
    collectives").  ``n_slots`` must divide by the axis size (cohorts
    round their capacity up to it)."""
    if mesh.n_processes > 1:
        raise ValueError(
            "a cohort's stream mesh lies in one process: its shards are "
            "stepped by the process that admits their ticks")
    devs = mesh.axis_devices(stream_axis)
    n = len(devs)
    if n_slots % n:
        raise ValueError(f"{n_slots} cohort slots do not divide over the "
                         f"{n} entries of the mesh's {stream_axis!r} axis")
    per = n_slots // n
    out = []
    for i, d in enumerate(devs):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append((d, i * per, (i + 1) * per))
    return out


class DistributedTSDF:
    """A TSDF whose packed arrays are cut over a device mesh (its series
    axis, and its time axis when it has one) and whose ops run on each
    shard's device."""

    def __init__(self, mesh: Mesh, series_axis, time_axis: Optional[str],
                 ts: Shards, mask: Shards, cols: Dict[str, DistCol], layout,
                 ts_col: str, partition_cols: List[str], ts_dtype, source_df,
                 host_cols: Dict[str, str], dtype: torch.dtype,
                 audits: Optional[List[Tuple[str, Shards]]] = None,
                 resampled: bool = False, seq: Optional[Shards] = None,
                 seq_col: str = "", resample_freq: Optional[str] = None,
                 halo_fraction: float = 0.5):
        self.mesh = mesh
        self.series_axis = series_axis    # an axis name, or the joint tuple
        self.time_axis = time_axis
        self.ts = ts                      # [K_shard, L_shard] int64 ns
        self.mask = mask                  # [K_shard, L_shard] bool
        self.cols = cols
        self.layout = layout
        self.ts_col = ts_col
        self.partitionCols = list(partition_cols)
        self._ts_dtype = ts_dtype
        self._source_df = source_df
        self.host_cols = dict(host_cols)  # output name -> source column
        self.dtype = dtype
        self.audits = list(audits or [])
        self.resampled = resampled
        self.seq = seq                    # [K_shard, L_shard] sort key
        self.seq_col = seq_col
        self._resample_freq = resample_freq
        self.halo_fraction = halo_fraction

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @property
    def n_time(self) -> int:
        return self.mesh.shape[self.time_axis] if self.time_axis else 1

    @property
    def n_series_shards(self) -> int:
        # a series-local frame (reshard_frame) cuts K over the joint
        # (series, time) axis: the shard count is the product
        return self.mesh.axis_size(self.series_axis)

    @property
    def axes(self):
        """The mesh axes of the frame's flat shard list: (series, time)
        on a time axis, else the series axis (or the joint tuple)."""
        if self.time_axis is not None:
            return (self.series_axis, self.time_axis)
        return self.series_axis

    @property
    def spec(self) -> tuple:
        """The layout of the frame's [K, L] planes."""
        return (self.series_axis, self.time_axis)

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.axis_devices(self.axes)

    @property
    def L(self) -> int:
        return int(self.ts[0].shape[1]) * self.n_time

    @property
    def K_dev(self) -> int:
        return int(self.ts[0].shape[0]) * self.n_series_shards

    def _map(self, fn, *shards) -> list:
        return shard_map(fn, self.mesh, *shards, axis=self.axes)

    def _halo(self, L: int) -> int:
        shard = L // self.n_time
        return max(1, min(shard, int(shard * self.halo_fraction)))

    def _place(self, plane: np.ndarray) -> Shards:
        """A global host [K_dev, L] plane cut into this frame's layout."""
        return place(plane, self.mesh, self.spec)

    @classmethod
    def from_tsdf(cls, tsdf, mesh: Optional[Mesh] = None,
                  series_axis: str = "series",
                  time_axis: Optional[str] = None,
                  halo_fraction: float = 0.5) -> "DistributedTSDF":
        """Pack a host TSDF and cut it over the mesh (the ingest
        boundary, the analog of Spark's shuffle on the partition
        columns): along K over ``series_axis`` and, with ``time_axis``,
        along L over it, one ``[K_dev/n_s, L/n_t]`` block a device with
        one host-to-device copy a block (only the blocks of this
        process's devices).  With no mesh, ``parallel.default_mesh`` of
        the frame's device: every visible card for a CUDA frame, one
        shard for a CPU frame.  ``halo_fraction`` sizes the time axis's
        halo (``withRangeStats(strategy="halo")``)."""
        global _PACK_EVENTS
        if mesh is None:
            mesh = default_mesh(tsdf.device)
        if series_axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis named {series_axis!r}")
        _time_axis_size(mesh, time_axis)
        spec = (series_axis, time_axis)
        devs = mesh.axis_devices(
            (series_axis, time_axis) if time_axis else series_axis)
        if len({d.type for d in devs}) != 1:
            raise ValueError("a mesh's devices must be all CUDA or all CPU")
        dtype = (tsdf.dtype if tsdf.device.type == devs[0].type
                 else device_policy.compute_dtype(devs[0]))
        dt = np.float32 if dtype == torch.float32 else np.float64

        layout = tsdf.layout
        K_dev, L, _, _ = _mesh_packed_geometry(layout, mesh, series_axis,
                                               time_axis)
        planes = [
            _pad_k(packing.pack_column(layout.ts_ns, layout, L,
                                       fill=packing.TS_PAD),
                   K_dev, packing.TS_PAD),
            _pad_k(packing.row_mask(layout, L), K_dev, False),
        ]
        names: List[str] = []
        host_cols: Dict[str, str] = {}
        structural = {tsdf.ts_col, *tsdf.partitionCols}
        has_seq = bool(tsdf.sequence_col)
        if has_seq:
            # the sequence column is both an output column (host row
            # identity) and a device join sort key; a null RIGHT sequence
            # sorts first (-inf) per Spark's ASC NULLS FIRST
            # (tsdf.py:117-121)
            structural.add(tsdf.sequence_col)
            host_cols[tsdf.sequence_col] = tsdf.sequence_col
            sv, sok = tsdf.numeric_flat(tsdf.sequence_col)
            sv = np.where(sok, sv, -np.inf).astype(dt)
            seq_p = _pad_k(packing.pack_column(sv, layout, L, fill=np.inf),
                           K_dev, np.inf)
        for c in tsdf.df.columns:
            if c in structural:
                continue
            dtype_c = tsdf.df[c].dtype
            if pd.api.types.is_numeric_dtype(dtype_c) and not \
                    pd.api.types.is_bool_dtype(dtype_c):
                vals, valid = tsdf.numeric_flat(c)
                if pd.api.types.is_integer_dtype(dtype_c) and valid.any() \
                        and np.abs(vals[valid]).max() >= 2.0 ** 53:
                    # integers past float64's exact range stay on the
                    # host (row identity / join-index gather)
                    host_cols[c] = c
                    continue
                planes.append(_pad_k(packing.pack_column(
                    vals.astype(dt), layout, L, fill=np.nan), K_dev, np.nan))
                planes.append(_pad_k(packing.pack_column(
                    valid, layout, L, fill=False), K_dev, False))
                names.append(c)
            else:
                host_cols[c] = c
        if has_seq:
            planes.append(seq_p)
        shards = place_planes(planes, mesh, spec)
        ts_d = [s[0] for s in shards]
        mask_d = [s[1] for s in shards]
        cols = {c: DistCol([s[2 + 2 * j] for s in shards],
                           [s[3 + 2 * j] for s in shards])
                for j, c in enumerate(names)}
        seq_d = [s[-1] for s in shards] if has_seq else None
        _PACK_EVENTS += 1
        return cls(mesh, series_axis, time_axis, ts_d, mask_d, cols, layout,
                   tsdf.ts_col, tsdf.partitionCols, tsdf.ts_dtype(), tsdf.df,
                   host_cols, dtype, seq=seq_d,
                   seq_col=tsdf.sequence_col or "",
                   halo_fraction=halo_fraction)

    def _plan_record(self, op: str, others=(), params=None, objs=None):
        """Record a deferred plan node over this (already packed) mesh
        frame instead of executing (``TEMPO_TPU_PLAN=1``); the lazy
        wrapper's ``collect()`` optimizes and executes it through the
        plan's executable cache (``plan/``)."""
        from tempo_tpu_torch.plan import lazy as plan_lazy

        return plan_lazy.record(self, op, others, params, objs)

    def explain(self, cost: bool = False) -> str:
        """Render this frame's query plan (a bare mesh source when eager;
        the lazy wrappers show recorded chains and the optimizer's
        rewrites)."""
        from tempo_tpu_torch.plan import ir, render

        text = render.explain_text(ir.Node("dist_source", payload=self),
                                   cost=cost)
        print(text)
        return text

    def _with(self, **kw) -> "DistributedTSDF":
        base = dict(
            mesh=self.mesh, series_axis=self.series_axis,
            time_axis=self.time_axis, ts=self.ts, mask=self.mask,
            cols=self.cols, layout=self.layout, ts_col=self.ts_col,
            partition_cols=self.partitionCols, ts_dtype=self._ts_dtype,
            source_df=self._source_df, host_cols=self.host_cols,
            dtype=self.dtype,
            audits=self.audits, resampled=self.resampled, seq=self.seq,
            seq_col=self.seq_col, resample_freq=self._resample_freq,
            halo_fraction=self.halo_fraction,
        )
        base.update(kw)
        return DistributedTSDF(**base)

    def numeric_columns(self) -> List[str]:
        return [c for c, col in self.cols.items()
                if col.ts_chunk is None and col.host_gather is None]

    def _stack(self, cols: Sequence[str]) -> Tuple[Shards, Shards]:
        """[C, K_shard, L_shard] value and validity stacks a shard."""
        vals = [torch.stack([self.cols[c].values[i] for c in cols])
                for i in range(len(self.ts))]
        valids = [torch.stack([self.cols[c].valid[i] for c in cols])
                  for i in range(len(self.ts))]
        return vals, valids

    def _to_local(self, *planes: Shards) -> List[Shards]:
        """Planes of a time-sharded frame in the series-local layout, one
        tiled all-to-all a plane (the reference's ``_to_series_local_fn``);
        unchanged on any other layout."""
        if self.n_time <= 1:
            return list(planes)
        return [all_to_all_series_to_time(p, self.mesh, self.series_axis,
                                          self.time_axis)
                for p in planes]

    def _to_blocks(self, *planes: Shards) -> List[Shards]:
        """The inverse of :meth:`_to_local`: series-local planes back to
        this frame's time-sharded blocks."""
        if self.n_time <= 1:
            return list(planes)
        return [all_to_all_time_to_series(p, self.mesh, self.series_axis,
                                              self.time_axis)
                for p in planes]

    @property
    def _local_axes(self):
        """The axes of this frame's series-local layout."""
        return (time_axes(self.mesh, self.series_axis, self.time_axis)
                if self.n_time > 1 else self.axes)

    def _window_rowbounds(self, window_secs: float):
        """Static (max rows back, max tie rows ahead) of any
        rangeBetween(-window_secs, 0) frame, from the host layout; None
        when the layout cannot vouch for the device timestamps
        (resampled frames, whose device ts are bucket starts) or the
        spans pass int32."""
        lay = self.layout
        if (self.resampled or lay.n_rows == 0
                or int(lay.starts[-1]) != lay.n_rows):
            return None
        return packing.layout_rowbounds(lay, window_secs)

    def _range_engine_choice(self, window_secs: float):
        """``(engine, rowbounds)`` of ``withRangeStats(exact)``: the host
        frame's pick at one shard's size (whole rows: the exact strategy
        runs series-local)."""
        if not sm.use_sort_kernels():
            return "windowed", None
        shard_k = self.K_dev // (self.n_series_shards * self.n_time)
        return _pick_range_engine_for_shard(
            shard_k, self.L, self._window_rowbounds(window_secs))

    # ------------------------------------------------------------------
    # withRangeStats (tsdf.py:673-721) / EMA (tsdf.py:615-635)
    # ------------------------------------------------------------------

    def withRangeStats(self, colsToSummarize=None,
                       rangeBackWindowSecs: int = 1000,
                       strategy: str = "exact") -> "DistributedTSDF":
        """Rolling range stats.  On a time-sharded mesh:

        * ``strategy="exact"`` (default): one switch to the series-local
          layout (:func:`reshard_frame`), the series-local stats every
          frame runs, and one switch back; exact Spark rangeBetween
          frames for any window;
        * ``strategy="halo"``: stay time-sharded and read the lookback
          through a neighbour halo of ``halo_fraction`` of a block
          (``parallel/halo.range_stats_time_sharded``); windows longer
          than the halo are cut, and a deferred audit (a warning at
          ``collect()``) counts the rows affected, the reference's own
          ``tsPartitionVal`` trade-off (tsdf.py:164-190).

        Without a time axis both strategies compute the exact frames
        (``"halo"`` takes the windowed form, as the reference does on one
        time shard).

        The trace spans ``tempo.dist.range_stats``; the series-local
        computation's phases are ``.engine``, ``.stack``, ``.compute``
        and ``.outputs``."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("range_stats", params=dict(
                colsToSummarize=tuple(colsToSummarize) if colsToSummarize
                else None,
                rangeBackWindowSecs=rangeBackWindowSecs, strategy=strategy))
        if strategy not in ("exact", "halo"):
            raise ValueError("strategy must be 'exact' or 'halo'")
        with profiling.annotate("tempo.dist.range_stats"):
            return self._range_stats(colsToSummarize, rangeBackWindowSecs,
                                     strategy)

    def _range_stats(self, colsToSummarize, rangeBackWindowSecs,
                     strategy: str) -> "DistributedTSDF":
        if strategy == "exact" and self.n_time > 1:
            local = reshard_frame(self, RESHARD_SERIES_LOCAL)
            out = local.withRangeStats(
                colsToSummarize=colsToSummarize,
                rangeBackWindowSecs=rangeBackWindowSecs, strategy=strategy)
            return reshard_frame(out, RESHARD_TIME_SHARDED)
        cols = colsToSummarize or self.numeric_columns()
        if not cols:
            return self._with()
        w = float(rangeBackWindowSecs)
        new_cols = dict(self.cols)
        audits = list(self.audits)
        if strategy == "halo" and self.n_time > 1:
            halo = self._halo(self.L)
            secs = self._map(_secs, self.ts)
            for c in cols:
                col = self.cols[c]
                valid = self._map(torch.logical_and, col.valid, self.mask)
                stats, clipped = ph.range_stats_time_sharded(
                    self.mesh, secs, col.values, valid, w, halo,
                    time_axis=self.time_axis, series_axis=self.series_axis)
                audits.append((
                    f"withRangeStats({c}): %d rows had windows truncated "
                    f"at the time-shard halo ({halo} rows); increase the "
                    f"halo_fraction or shard count", clipped))
                for stat in packing.RANGE_STATS:
                    new_cols[f"{stat}_{c}"] = DistCol(
                        stats[stat], self.mask, int64=(stat == "count"))
            return self._with(cols=new_cols, audits=audits)
        with profiling.annotate("tempo.dist.range_stats.engine"):
            if strategy == "exact":
                engine, rowbounds = self._range_engine_choice(w)
            else:
                engine, rowbounds = "windowed", None
        with profiling.annotate("tempo.dist.range_stats.stack"):
            xs, vs = self._stack(cols)
        with profiling.annotate("tempo.dist.range_stats.compute"):
            stats, clipped = unzip(self._map(
                lambda ts, mask, x, v: _range_stats_shard(
                    ts, x, v & mask, w, rowbounds, engine),
                self.ts, self.mask, xs, vs))
        with profiling.annotate("tempo.dist.range_stats.outputs"):
            for ci, c in enumerate(cols):
                if rowbounds is not None:
                    # deferred audit: the host-derived row bounds cover
                    # every frame by construction; a count here is a bug
                    audits.append((
                        f"withRangeStats({c}): %d rows had window frames "
                        f"extending past the static row bounds "
                        f"{rowbounds}; this is a tempo_tpu_torch bug",
                        [cl[ci] for cl in clipped]))
                for stat in packing.RANGE_STATS:
                    new_cols[f"{stat}_{c}"] = DistCol(
                        [s[stat][ci] for s in stats], self.mask,
                        int64=(stat == "count"))
            return self._with(cols=new_cols, audits=audits)

    rangeStats = withRangeStats

    def EMA(self, colName: str, window: int = 30, exp_factor: float = 0.2,
            exact: bool = False,
            inclusive_window: bool = False) -> "DistributedTSDF":
        """EMA with ``TSDF.EMA``'s defaults (the truncated-lag reference
        form, or ``exact=True`` for the infinite-horizon ladder).  The
        exact form composes across time blocks (an associative carry,
        ``parallel/halo.ema_time_sharded``); the truncated form does not,
        so a time-sharded frame needs ``exact=True``.  The trace spans
        ``tempo.dist.ema``."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("ema", params=dict(
                colName=colName, window=window, exp_factor=exp_factor,
                exact=exact, inclusive_window=inclusive_window))
        with profiling.annotate("tempo.dist.ema"):
            return self._ema(colName, window, exp_factor, exact,
                             inclusive_window)

    def _ema(self, colName: str, window: int, exp_factor: float,
             exact: bool, inclusive_window: bool) -> "DistributedTSDF":
        col = self.cols[colName]
        alpha = float(exp_factor)
        if self.n_time > 1:
            if not exact:
                raise ValueError(
                    "truncated-lag EMA does not cross time shards; use "
                    "exact=True (or a series-only mesh)")
            y = ph.ema_time_sharded(self.mesh, col.values, col.valid, alpha,
                                    time_axis=self.time_axis,
                                    series_axis=self.series_axis)
        elif exact:
            y = self._map(lambda x, v: rk.ema_exact(x, v, alpha),
                          col.values, col.valid)
        else:
            n_taps = int(window) + (1 if inclusive_window else 0)
            y = self._map(lambda x, v: rk.ema_compat(x, v, n_taps, alpha),
                          col.values, col.valid)
        new_cols = dict(self.cols)
        new_cols["EMA_" + colName] = DistCol(y, self.mask)
        return self._with(cols=new_cols)

    # ------------------------------------------------------------------
    # Materialisation
    # ------------------------------------------------------------------

    def _host_planes(self, planes: Sequence[Shards]) -> List[np.ndarray]:
        """Global host arrays of [.., K, L] planes in this frame's layout:
        one fetch a shard (the planes of a shard in one copy), the
        blocks joined along L within a series group, then along K."""
        per_shard = [[p[i] for p in planes] for i in range(len(self.ts))]
        fetched = _fetch_shards(per_shard, self.mesh.axis_ranks(self.axes))
        n_t = self.n_time
        n_g = len(fetched) // n_t
        out = []
        for j in range(len(planes)):
            rows = [np.concatenate([fetched[g * n_t + t][j]
                                    for t in range(n_t)], axis=-1)
                    for g in range(n_g)]
            out.append(np.concatenate(rows, axis=-2))
        return out

    def collect(self):
        """One device-to-host copy a shard -> a host-backed TSDF on the
        mesh's first device.  The trace spans ``tempo.dist.collect``,
        with the phases ``.fetch`` (the copies) and ``.assemble`` (the
        host frame)."""
        with profiling.annotate("tempo.dist.collect"):
            return self._collect()

    def _collect(self):
        global _FETCH_EVENTS
        from tempo_tpu_torch.frame import TSDF

        names = list(self.cols)
        planes = [self.ts, self.mask] \
            + [self.cols[c].values for c in names] \
            + [self.cols[c].valid for c in names]
        n_planes = len(planes)
        # the audit counts ride the same fetch (a [1, 1] block a shard)
        counts = [[c.reshape(1, 1) for c in counts]
                  for _, counts in self.audits]
        with profiling.annotate("tempo.dist.collect.fetch"):
            host = self._host_planes(planes + counts)
        _FETCH_EVENTS += 1
        with profiling.annotate("tempo.dist.collect.assemble"):
            for j, (msg, _) in enumerate(self.audits):
                n = int(round(float(
                    host[n_planes + j].astype(np.float64).sum())))
                if n > 0:
                    logger.warning(msg, *((n,) if "%d" in msg else ()))
            K = self.layout.n_series
            ts_h, mask_h = host[0][:K], host[1][:K]
            val_block = host[2:2 + len(names)]
            ok_block = host[2 + len(names):2 + 2 * len(names)]

            lengths = mask_h.sum(axis=1).astype(np.int64)
            key_ids = np.repeat(np.arange(K, dtype=np.int64), lengths)
            flat = lambda a: a[:K][mask_h]

            out = {}
            kf = self.layout.key_frame
            for c in self.partitionCols:
                out[c] = kf[c].to_numpy()[key_ids]
            out[self.ts_col] = packing.ns_to_original(flat(ts_h),
                                                      self._ts_dtype)
            ts_parts: Dict[str, dict] = {}
            for i, c in enumerate(names):
                col = self.cols[c]
                v = flat(val_block[i]).astype(np.float64)
                okv = flat(ok_block[i])
                if col.ts_chunk is not None:
                    target, shift = col.ts_chunk
                    part = ts_parts.setdefault(target, {"ns": 0, "ok": okv})
                    part["ns"] = part["ns"] + (
                        np.round(np.where(okv, v, 0.0)).astype(np.int64)
                        << shift)
                elif col.host_gather is not None:
                    flat_vals, r_starts, perm = col.host_gather
                    ridx = np.round(np.where(okv, v, 0.0)).astype(np.int64)
                    pos = r_starts[perm[key_ids]] + ridx
                    pos = np.clip(pos, 0, max(len(flat_vals) - 1, 0))
                    if len(flat_vals) and np.issubdtype(flat_vals.dtype,
                                                        np.integer):
                        # an integer host column (e.g. a joined sequence
                        # column) keeps int exactness; unmatched rows are NA
                        arr = pd.array(flat_vals[pos].astype(np.int64),
                                       dtype="Int64")
                        arr[~okv] = pd.NA
                        out[c] = arr
                        continue
                    if len(flat_vals) and np.issubdtype(flat_vals.dtype,
                                                        np.number):
                        out[c] = np.where(
                            okv, flat_vals[pos].astype(np.float64), np.nan)
                        continue
                    gathered = (flat_vals[pos] if len(flat_vals)
                                else np.full(len(pos), None, object))
                    res = np.empty(len(pos), dtype=object)
                    res[:] = gathered
                    res[~okv] = None
                    out[c] = res
                elif col.int64:
                    out[c] = np.where(okv, v, 0).astype(np.int64)
                else:
                    out[c] = np.where(okv, v, np.nan)
            for target, part in ts_parts.items():
                tsv = packing.ns_to_original(part["ns"], self._ts_dtype)
                if np.issubdtype(np.asarray(tsv).dtype, np.datetime64):
                    tsv = np.where(part["ok"], tsv, np.datetime64("NaT"))
                out[target] = tsv
            if not self.resampled:
                # host-resident (non-numeric) columns rejoin by row identity
                for c, src in self.host_cols.items():
                    out[c] = self._source_df[src].to_numpy()[self.layout.order]
            return TSDF(pd.DataFrame(out), self.ts_col, self.partitionCols,
                        device=self.devices[0], dtype=self.dtype)

    def audit_counts(self) -> List[Tuple[str, int]]:
        """Each deferred audit's message and count, summed over the
        shards (gathered over the process group), without a collect."""
        if not self.audits:
            return []
        host = self._host_planes([[c.reshape(1, 1) for c in counts]
                                  for _, counts in self.audits])
        return [(msg, int(round(float(h.astype(np.float64).sum()))))
                for (msg, _), h in zip(self.audits, host)]

    def to_pandas(self) -> pd.DataFrame:
        return self.collect().df

    def count(self) -> int:
        sums = self._map(lambda m: m.sum().reshape(1), self.mask)
        got = _fetch_shards([[s] for s in sums],
                            self.mesh.axis_ranks(self.axes))
        return int(sum(int(g[0][0]) for g in got))

    def show(self, n: int = 20, truncate: bool = True) -> None:
        """Materialise and display (host TSDF.show semantics)."""
        self.collect().show(n, truncate)

    def __repr__(self) -> str:
        return (
            f"DistributedTSDF(mesh={self.mesh.shape}, "
            f"series={self.layout.n_series}, packed=[{self.K_dev}, {self.L}], "
            f"cols={self.numeric_columns()}, host_cols={list(self.host_cols)}, "
            f"ts_col={self.ts_col!r}, partition_cols={self.partitionCols})"
        )

    # ------------------------------------------------------------------
    # asofJoin (tsdf.py:463-560)
    # ------------------------------------------------------------------

    def asofJoin(self, right: "DistributedTSDF",
                 left_prefix: Optional[str] = None,
                 right_prefix: str = "right",
                 tsPartitionVal: Optional[int] = None,
                 fraction: float = 0.5,
                 skipNulls: bool = True,
                 sql_join_opt: bool = False,
                 suppress_null_warning: bool = False,
                 maxLookback: int = 0) -> "DistributedTSDF":
        """AS-OF join.  The right frame's rows are gathered into the left
        frame's series order (``_align_rows``, the co-partitioning shuffle
        analog), then every left shard joins on its device.

        Right-side host-resident columns join by carrying the matched
        right row position as a value plane (exact in float32 below
        2^24 rows a series) and gathering the values on the host at
        ``collect()``.  A right ``sequence_col`` breaks timestamp ties
        (left rows sort after null right sequences and before the rest,
        tsdf.py:117-121).  ``maxLookback`` > 0 caps the fill at the
        trailing maxLookback+1 merged rows (asofJoin.scala:64-88).
        ``tsPartitionVal``, ``fraction`` and ``sql_join_opt`` are accepted
        and ignored, as in the reference's mesh join.  The trace spans
        ``tempo.dist.asof_join`` with the phases ``.key_perm``,
        ``.right_stacks``, ``.align``, ``.merge`` and ``.outputs``."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("asof_join", (right,), dict(
                left_prefix=left_prefix, right_prefix=right_prefix,
                tsPartitionVal=tsPartitionVal, fraction=fraction,
                skipNulls=skipNulls, sql_join_opt=sql_join_opt,
                suppress_null_warning=suppress_null_warning,
                maxLookback=maxLookback))
        with profiling.annotate("tempo.dist.asof_join"):
            return self._asof_join(right, left_prefix, right_prefix,
                                   tsPartitionVal, skipNulls, maxLookback)

    def _asof_join(self, right: "DistributedTSDF",
                   left_prefix: Optional[str], right_prefix: str,
                   tsPartitionVal: Optional[int], skipNulls: bool,
                   maxLookback: int) -> "DistributedTSDF":
        if tsPartitionVal is not None:
            logger.info("asofJoin: tsPartitionVal ignored on the mesh — "
                        "the packed layout needs no skew brackets")
        if right.mesh != self.mesh:
            raise ValueError("both frames must live on the same mesh")
        if self.partitionCols != right.partitionCols:
            raise ValueError(
                "left and right dataframe partition columns should have same name in same order"
            )
        with profiling.annotate("tempo.dist.asof_join.key_perm"):
            perm, ok = _key_perm(self.layout.key_frame,
                                 right.layout.key_frame,
                                 self.partitionCols, self.K_dev)
        mesh = self.mesh
        # the join runs on whole rows: a time-sharded side switches to its
        # series-local layout (one all-to-all a plane), the right rows are
        # gathered into the left's series-local shards, and the outputs
        # switch back to the left's blocks
        l_axes, r_axes = self._local_axes, right._local_axes
        n_dst = mesh.axis_size(l_axes)

        def align(shards, fill, row_axis=0):
            return _align_rows(mesh, shards, r_axes, l_axes, perm, ok, fill,
                               row_axis)

        r_recs = list(right.cols.items())
        h_names = [c for c in right.host_cols
                   if right._source_df is not None]
        n, H = len(r_recs), len(h_names)
        dt = self.dtype
        host_flat: Dict[str, np.ndarray] = {}

        # value stack layout (offsets named below):
        #   [0, n)              right col values (all kinds)
        #   [n, n+3)            right ts as three 21-bit ns chunks
        #   skipNulls=True:
        #     [n+3, n+3+H)      host-col row-position planes
        #   skipNulls=False:
        #     [n+3, 2n+3)       per-col validity planes (to recover nulls)
        #     [2n+3, 2n+3+H)    host-col row-position planes
        #     [2n+3+H, 2n+3+2H) host-col non-null planes
        def right_stacks(ts, mask, *rest):
            vals, valids = rest[:n], rest[n:2 * n]
            notna = rest[2 * n:]
            planes = list(vals)
            planes += [((ts >> shift) & ((1 << 21) - 1)).to(dt)
                       for shift in (42, 21, 0)]
            ridx = torch.arange(ts.shape[1], dtype=dt,
                                device=ts.device).expand(ts.shape)
            if skipNulls:
                planes += [ridx] * H
                vstack = list(valids) + [mask] * 3 + list(notna)
            else:
                planes += [v.to(dt) for v in valids]
                planes += [ridx] * H + [v.to(dt) for v in notna]
                vstack = [mask] * len(planes)
            return torch.stack(planes), torch.stack(vstack)

        with profiling.annotate("tempo.dist.asof_join.right_stacks"):
            h_notna: List[Shards] = []
            for c in h_names:
                flat = right._source_df[right.host_cols[c]].to_numpy()[
                    right.layout.order]
                host_flat[c] = flat
                h_notna.append(right._place(_pad_k(packing.pack_column(
                    ~pd.isna(flat), right.layout, right.L, fill=False),
                    right.K_dev, False)))
            r_local = right._to_local(right.ts, right.mask,
                                      *[col.values for _, col in r_recs],
                                      *[col.valid for _, col in r_recs],
                                      *h_notna)
            pstack, vstack = unzip(shard_map(right_stacks, mesh, *r_local,
                                             axis=r_axes))

        ml = int(maxLookback or 0)
        # resampled (bucket-head) views keep real-looking ts on masked
        # lanes; maxLookback counts real rows only, so those lanes are
        # sorted to the row's tail first, on either side
        compact = bool(ml and right.resampled)
        compact_left = bool(ml and self.resampled)
        with profiling.annotate("tempo.dist.asof_join.align"):
            pstack = align(pstack, float("nan"), row_axis=1)
            vstack = align(vstack, False, row_axis=1)
            r_ts = align(r_local[0], int(packing.TS_PAD))
            r_mask = (align(r_local[1], False) if compact
                      else [None] * n_dst)
            r_seq = (align(right._to_local(right.seq)[0], float("inf"))
                     if right.seq is not None else [None] * n_dst)

        def join(l_ts, l_mask, rt, rm, rs, vs, ps):
            if compact:
                rt, vs, ps = _compact_right_lanes(rt, rm, vs, ps)
            if compact_left:
                l_ts, src = _compact_left_rows(l_ts, l_mask)
            vals, found, _ = sm.asof_merge_values(l_ts, rt, vs, ps, r_seq=rs,
                                                  max_lookback=ml)
            if compact_left:
                vals, found = _uncompact_left(src, vals, found)
            return vals, found

        with profiling.annotate("tempo.dist.asof_join.merge"):
            l_ts, l_mask = self._to_local(self.ts, self.mask)
            vals, found = unzip(shard_map(join, mesh, l_ts, l_mask, r_ts,
                                          r_mask, r_seq, vstack, pstack,
                                          axis=l_axes))
            vals, found = self._to_blocks(vals, found)

        def plane(p):
            return [v[p] for v in vals], [f[p] for f in found]

        def plane_and(p, q):
            """Plane p's values, found where plane q (a validity plane
            carried as 0/1 floats) says the matched row is not null."""
            return ([v[p] for v in vals],
                    [f[p] & (v[q] > 0.5) for v, f in zip(vals, found)])

        with profiling.annotate("tempo.dist.asof_join.outputs"):
            rename = ((lambda c: f"{left_prefix}_{c}") if left_prefix
                      else (lambda c: c))
            new_cols = {rename(c): col for c, col in self.cols.items()}
            new_host = {rename(c): src for c, src in self.host_cols.items()}
            hidx_off = (n + 3) if skipNulls else (2 * n + 3)
            for i, (c, rcol) in enumerate(r_recs):
                v, f = plane(i) if skipNulls else plane_and(i, n + 3 + i)
                if rcol.ts_chunk is not None:
                    # an earlier join's timestamp chunk: re-target its
                    # recompose name under this join's prefix
                    target, shift = rcol.ts_chunk
                    nt = f"{right_prefix}_{target}"
                    j = {42: 0, 21: 1, 0: 2}[shift]
                    new_cols[f"__{nt}__c{j}"] = DistCol(
                        v, f, ts_chunk=(nt, shift))
                elif rcol.host_gather is not None:
                    # an earlier join's host-column plane: compose this
                    # join's series map into its gather map
                    fv, st, pm = rcol.host_gather
                    pm2 = pm[np.clip(perm, 0, max(len(pm) - 1, 0))]
                    new_cols[f"{right_prefix}_{c}"] = DistCol(
                        v, f, host_gather=(fv, st, pm2))
                else:
                    masked = [torch.where(fi, vi, float("nan"))
                              for vi, fi in zip(v, f)]
                    new_cols[f"{right_prefix}_{c}"] = DistCol(
                        masked, f, int64=rcol.int64)
            rts_name = f"{right_prefix}_{right.ts_col}"
            for j, shift in enumerate((42, 21, 0)):
                v, f = plane(n + j)
                new_cols[f"__{rts_name}__c{j}"] = DistCol(
                    v, f, ts_chunk=(rts_name, shift))
            for i, c in enumerate(h_names):
                v, f = (plane(hidx_off + i) if skipNulls
                        else plane_and(hidx_off + i, hidx_off + H + i))
                new_cols[f"{right_prefix}_{c}"] = DistCol(
                    v, f,
                    host_gather=(host_flat[c], right.layout.starts, perm))
            # the join result has no sequence column (chained joins must
            # not re-apply the tie-break); the left sequence rides the
            # host cols
            return self._with(cols=new_cols, host_cols=new_host,
                              ts_col=rename(self.ts_col), seq=None,
                              seq_col="")

    # ------------------------------------------------------------------
    # resample (resample.py:38-117) as a bucket-head view, calc_bars
    # ------------------------------------------------------------------

    def resample(self, freq: str, func: str,
                 metricCols=None) -> "DistributedTSDF":
        """Downsample to ``freq`` buckets.  The result keeps the packed
        [K, L] shape as a bucket-head view: each row's ts becomes its
        bucket start, only the first real row of each bucket is valid,
        and the columns hold the bucket's aggregate there.  ``collect()``
        compacts the view; chained ops treat it as any masked frame."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("resample", params=dict(
                freq=freq, func=func,
                metricCols=tuple(metricCols) if metricCols else None))
        validateFuncExists(func)
        if self.n_time > 1:
            # a whole-frame switch to the series-local layout, the
            # series-local resample, and a switch back
            local = reshard_frame(self, RESHARD_SERIES_LOCAL)
            return reshard_frame(local.resample(freq, func,
                                                metricCols=metricCols),
                                 RESHARD_TIME_SHARDED)
        step = freq_to_seconds(freq) * packing.NS_PER_S
        cols = metricCols or self.numeric_columns()
        fkey = {floor: 0, ceiling: 1, average: 2, min_func: 3,
                max_func: 4}[_canon_func(func)]
        xs, vs = self._stack(cols)
        new_ts, head, out_vals, out_valid = unzip(self._map(
            lambda ts, mask, x, v: _resample_shard(ts, mask, x, v, step,
                                                   fkey),
            self.ts, self.mask, xs, vs))
        new_cols = {c: DistCol([o[i] for o in out_vals],
                               [o[i] for o in out_valid])
                    for i, c in enumerate(cols)}
        return self._with(ts=new_ts, mask=head, cols=new_cols,
                          resampled=True, seq=None, seq_col="",
                          resample_freq=freq)

    def calc_bars(self, freq: str, func=None, metricCols=None,
                  fill=None) -> "DistributedTSDF":
        """OHLC bars (tsdf.py:813-826): four resamples on identical
        bucket grids, their columns combined by name (no join);
        ``fill=True`` zero-fills each series' dense bucket grid through
        ``interpolate(method="zero")``."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("calc_bars", params=dict(
                freq=freq, func=func,
                metricCols=tuple(metricCols) if metricCols else None,
                fill=fill))
        with plan.suspended():
            # its body chains recorded methods (resample, interpolate)
            mc = metricCols or self.numeric_columns()
            new_cols: Dict[str, DistCol] = {}
            base = None
            for prefix, f in (("open", "floor"), ("low", "min"),
                              ("high", "max"), ("close", "ceil")):
                base = self.resample(freq, f, metricCols=mc)
                for c in mc:
                    new_cols[f"{prefix}_{c}"] = base.cols[c]
            # host column order parity: prefixed metrics sorted by name
            bars = base._with(cols={c: new_cols[c]
                                    for c in sorted(new_cols)})
            if fill:
                bars = bars.interpolate(method="zero")
            return bars

    # ------------------------------------------------------------------
    # withGroupedStats (tsdf.py:723-759) / vwap (TSDF.scala:378-401)
    # ------------------------------------------------------------------

    def _bucket_stats(self, step_ns: int, xs: Shards, vs: Shards):
        """Bucket stats of [C, K, L] stacks; a time-sharded frame's
        planes switch to the series-local layout around the reduction
        (the reference's ``_bucket_stats_fn``)."""
        ts, mask, xs, vs = self._to_local(self.ts, self.mask, xs, vs)
        out = unzip(shard_map(
            lambda ts, mask, x, v: _bucket_stats_shard(ts, mask, x, v,
                                                       step_ns),
            self.mesh, ts, mask, xs, vs, axis=self._local_axes))
        return tuple(self._to_blocks(*out))

    def withGroupedStats(self, metricCols=None,
                         freq: str = None) -> "DistributedTSDF":
        """Tumbling-window grouped statistics: six aggregates per metric
        column and epoch-aligned bucket, as a bucket-head view (one valid
        row a bucket, ts = bucket start)."""
        step = freq_to_seconds(freq) * packing.NS_PER_S
        cols = metricCols or self.numeric_columns()
        xs, vs = self._stack(cols)
        new_ts, head, stats = self._bucket_stats(step, xs, vs)
        new_cols = {}
        for i, c in enumerate(cols):
            for j, stat in enumerate(_GROUPED_STATS):
                new_cols[f"{stat}_{c}"] = DistCol(
                    [s[j, i] for s in stats], head, int64=(stat == "count"))
        return self._with(ts=new_ts, mask=head, cols=new_cols,
                          resampled=True, seq=None, seq_col="",
                          resample_freq=freq)

    def vwap(self, frequency: str = "m", volume_col: str = "volume",
             price_col: str = "price") -> "DistributedTSDF":
        """VWAP (Scala spec): per (series, truncated-ts) bucket,
        dllr_value = sum(price*volume), the total volume, the max price
        and vwap = dllr_value / volume."""
        from tempo_tpu_torch.rolling import _VWAP_TRUNC

        if frequency not in _VWAP_TRUNC:
            raise ValueError("vwap frequency must be one of 'm', 'H', 'D'")
        step = UNIT_SECONDS[_VWAP_TRUNC[frequency]] * packing.NS_PER_S
        price, vol = self.cols[price_col], self.cols[volume_col]

        def stack(p, pv, v, vv):
            both = pv & vv
            return (torch.stack([torch.where(both, p * v, 0.0), v, p]),
                    torch.stack([both, vv, pv]))

        xs, vs = unzip(self._map(stack, price.values, price.valid,
                                 vol.values, vol.valid))
        new_ts, head, stats = self._bucket_stats(step, xs, vs)
        dllr = [s[4, 0] for s in stats]     # sum of price*volume
        vsum = [s[4, 1] for s in stats]     # sum of volume
        new_cols = {
            "dllr_value": DistCol(dllr, head),
            volume_col: DistCol(vsum, head),
            "max_" + price_col: DistCol([s[3, 2] for s in stats], head),
            "vwap": DistCol([d / v for d, v in zip(dllr, vsum)], head),
        }
        bucket_freq = {"m": "1 minute", "H": "1 hour", "D": "1 day"}[frequency]
        return self._with(ts=new_ts, mask=head, cols=new_cols,
                          resampled=True, seq=None, seq_col="",
                          resample_freq=bucket_freq)

    # ------------------------------------------------------------------
    # interpolate (interpol.py; tsdf.py:778-811)
    # ------------------------------------------------------------------

    def interpolate(self, freq: str = None, func: str = None,
                    method: str = None, target_cols=None,
                    show_interpolated: bool = False) -> "DistributedTSDF":
        """Resample + gap fill.  Aggregates to ``freq`` buckets (unless
        the frame is already a resampled view), generates each series'
        dense bucket grid and fills it with ``method`` (zero / null /
        ffill / bfill / linear): the previous and next bucket heads come
        from two merge joins of the grid against the heads, the linear
        weights from exact bucket indices.  ``show_interpolated`` adds
        the reference's ``is_ts_interpolated`` / ``is_interpolated_<col>``
        flags (interpol.py:330-364)."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("interpolate", params=dict(
                freq=freq, func=func, method=method,
                target_cols=tuple(target_cols) if target_cols else None,
                show_interpolated=show_interpolated))
        if method not in ("zero", "null", "ffill", "bfill", "linear"):
            raise ValueError(
                f"Please select from one of the following fill options: "
                f"['zero', 'null', 'bfill', 'ffill', 'linear']: got {method}"
            )
        if self.n_time > 1:
            # the result is a new dense frame: the inputs switch to the
            # series-local layout once and the grid stays there
            return reshard_frame(self, RESHARD_SERIES_LOCAL).interpolate(
                freq=freq, func=func, method=method, target_cols=target_cols,
                show_interpolated=show_interpolated)
        if self.resampled:
            freq = freq or self._resample_freq
            if freq != self._resample_freq:
                raise ValueError(
                    f"interpolate freq {freq!r} must match the resample "
                    f"freq {self._resample_freq!r} on a resampled frame")
        if freq is None:
            raise ValueError("interpolate requires freq")
        cols = target_cols or self.numeric_columns()
        if not self.resampled:
            validateFuncExists(func)
        res = self if self.resampled else self.resample(freq, func,
                                                        metricCols=cols)
        step = int(freq_to_seconds(freq) * packing.NS_PER_S)
        # static grid bound from the host layout: every series' bucket
        # span fits (span // step + 2) buckets
        lay = self.layout
        real = lay.lengths > 0
        span = int((lay.ts_ns[lay.starts[1:][real] - 1]
                    - lay.ts_ns[lay.starts[:-1][real]]).max(initial=0))
        G = span // step + 2
        G = max(8, -(-G // 8) * 8)
        mkey = ("zero", "null", "ffill", "bfill", "linear").index(method)
        flags = bool(show_interpolated)
        xs, vs = res._stack(cols)
        outs = unzip(self._map(
            lambda ts, head, x, v: _interp_shard(ts, head, x, v, step, G,
                                                 mkey, flags),
            res.ts, res.mask, xs, vs))
        grid_ts, grid_mask, out_vals, out_valid = outs[:4]
        new_cols = {c: DistCol([o[i] for o in out_vals],
                               [o[i] for o in out_valid])
                    for i, c in enumerate(cols)}
        if flags:
            ts_interp, col_interp = outs[4], outs[5]
            new_cols["is_ts_interpolated"] = DistCol(
                [t.to(self.dtype) for t in ts_interp], grid_mask, int64=True)
            for i, c in enumerate(cols):
                new_cols[f"is_interpolated_{c}"] = DistCol(
                    [t[i].to(self.dtype) for t in col_interp], grid_mask,
                    int64=True)
        return self._with(ts=grid_ts, mask=grid_mask, cols=new_cols,
                          resampled=True, seq=None, seq_col="",
                          resample_freq=freq)

    # ------------------------------------------------------------------
    # describe (tsdf.py:384-431) / autocorr (tsdf.py:192-316)
    # ------------------------------------------------------------------

    def describe(self) -> pd.DataFrame:
        """Numeric columns reduce on the devices: each shard computes
        partial counts, float64 sums, minima and maxima, and the partials
        combine once on the host; host-resident columns and the table
        assembly share the host implementation (``describe.py``)."""
        from tempo_tpu_torch.describe import (
            assemble_table, classify_granularity, col_describe_series,
        )

        names = self.numeric_columns()
        if names:
            xs, vs = self._stack(names)
        else:
            xs = [torch.zeros((0,) + tuple(t.shape), dtype=self.dtype,
                              device=t.device) for t in self.ts]
            vs = [torch.zeros((0,) + tuple(t.shape), dtype=torch.bool,
                              device=t.device) for t in self.ts]
        parts = self._map(_describe_shard, self.ts, self.mask, xs, vs)
        keys = list(_DESCRIBE_COMBINE)
        host = _fetch_shards([[p[k] for k in keys] for p in parts],
                             self.mesh.axis_ranks(self.axes))
        r = _combine_describe([dict(zip(keys, h)) for h in host])

        n = int(r["n_rows"])
        gran = classify_granularity(r["has_frac"], r["sub_min"],
                                    r["sub_hr"], r["sub_day"])
        unique_ts = (len(self.layout.key_frame)
                     if self.partitionCols else 1)
        fmt = lambda x: None if x is None or (isinstance(x, float)
                                              and np.isnan(x)) else str(x)

        def reduced_stats(cnt, s1, s2, mn, mx):
            cnt = int(cnt)
            if cnt == 0:
                return {"count": "0", "mean": None, "stddev": None,
                        "min": None, "max": None}
            mean = s1 / cnt
            var = (s2 - s1 ** 2 / cnt) / max(cnt - 1, 1)
            return {
                "count": str(cnt),
                "mean": fmt(float(mean)),
                "stddev": fmt(float(np.sqrt(max(var, 0.0))))
                if cnt > 1 else None,
                "min": fmt(float(mn)),
                "max": fmt(float(mx)),
            }

        host_names = [c for c in self.host_cols
                      if self._source_df is not None and not self.resampled]
        stat_cols = (list(self.partitionCols) + names + host_names
                     + [self.ts_col + "_dbl"])
        stats, missing = {}, {}
        kf = self.layout.key_frame
        lengths = self.layout.lengths
        for c in self.partitionCols:
            sv = kf[c].dropna().astype(str)
            na_rows = int(lengths[kf[c].isna().to_numpy()].sum()) \
                if len(kf) else 0
            stats[c] = {"count": str(n - na_rows), "mean": None,
                        "stddev": None,
                        "min": fmt(sv.min()) if len(sv) else None,
                        "max": fmt(sv.max()) if len(sv) else None}
            missing[c] = 100.0 * na_rows / max(n, 1)
        for i, c in enumerate(names):
            stats[c] = reduced_stats(r["count"][i], r["sum"][i],
                                     r["sumsq"][i], r["min"][i], r["max"][i])
            missing[c] = 100.0 * (n - int(r["count"][i])) / max(n, 1)
        for c in host_names:
            s = pd.Series(self._source_df[self.host_cols[c]].to_numpy()
                          [self.layout.order])
            stats[c] = col_describe_series(s)
            missing[c] = 100.0 * float(s.isna().sum()) / max(n, 1)
        stats[self.ts_col + "_dbl"] = reduced_stats(
            n, r["ts_sum"], r["ts_sumsq"], r["ts_min"], r["ts_max"])
        missing[self.ts_col + "_dbl"] = 0.0
        min_ts = packing.ns_to_original(np.int64(r["min_ts"]),
                                        self._ts_dtype)
        max_ts = packing.ns_to_original(np.int64(r["max_ts"]),
                                        self._ts_dtype)
        if np.issubdtype(np.asarray(min_ts).dtype, np.datetime64):
            min_ts, max_ts = pd.Timestamp(min_ts), pd.Timestamp(max_ts)
        return assemble_table(stat_cols, stats, missing, unique_ts,
                              min_ts, max_ts, gran)

    def autocorr(self, col: str, lag: int = 1) -> pd.DataFrame:
        """Lag-k autocorrelation per series (reference tsdf.py:192-316
        semantics through the host frame's pair rule); a bare DataFrame.
        Bucket-head views first move their valid rows to the front of the
        row (a stable sort), so the lag pairs consecutive observations."""
        dcol = self.cols[col]
        # the lag pairs need series-contiguous rows: a time-sharded
        # frame's three planes switch to the series-local layout
        planes = self._to_local(dcol.values, dcol.valid, self.mask)
        axes = self._local_axes
        res = shard_map(
            lambda v, ok, mask: _autocorr_shard(v, ok, mask, int(lag),
                                                self.resampled),
            self.mesh, *planes, axis=axes)
        host = _fetch_shards([list(r) for r in res],
                             self.mesh.axis_ranks(axes))
        K = self.layout.n_series
        ac_h, cnt_h, len_h = (np.concatenate([h[i] for h in host])[:K]
                              for i in range(3))
        # a series yields a row only when the numerator join is
        # non-empty (reference tsdf.py:248-253)
        present = (len_h > lag) & (cnt_h > lag)
        out = self.layout.key_frame.copy()
        if not self.partitionCols:
            out = pd.DataFrame({"_dummy_group_col": ["dummy"]})
        out[f"autocorr_lag_{lag}"] = ac_h.astype(np.float64)
        return out[present].reset_index(drop=True)

    # ------------------------------------------------------------------
    # fourier_transform (tsdf.py:828-902) / lookback features
    # ------------------------------------------------------------------

    def fourier_transform(self, timestep: float, valueCol: str):
        """Each series' exact-length FFT on its shard's device: one
        ``torch.fft.fft`` a distinct series length (cuFFT takes any
        length), written into the front lanes.  Output columns as the
        host frame's: value, freq, ft_real, ft_imag.  Bucket-head views
        (real rows not front-packed) and columns without a plain device
        plane go through ``collect()`` and the host frame, and are
        packed again."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("fourier", params=dict(
                timestep=timestep, valueCol=valueCol))
        matches = [c for c in self.cols if c.lower() == valueCol.lower()
                   and self.cols[c].ts_chunk is None
                   and self.cols[c].host_gather is None]
        if self.resampled or not matches:
            logger.warning(
                "fourier_transform(%r): materialization barrier — the "
                "mesh chain collects to the host here (%s) and packs "
                "again afterwards; under TEMPO_TPU_PLAN=1 explain() marks "
                "this barrier in the plan", valueCol,
                "bucket-head (resampled) view" if self.resampled
                else "no plain device plane for the column")
            with plan.suspended():
                host = self.collect().fourier_transform(timestep, valueCol)
            s_ax, t_ax = self.series_axis, self.time_axis
            if isinstance(s_ax, tuple):
                # a series-local frame packs again onto the plain series
                # axis (nothing of its layout is left to keep)
                s_ax, t_ax = s_ax[0], None
            return DistributedTSDF.from_tsdf(
                host, self.mesh, series_axis=s_ax, time_axis=t_ax,
                halo_fraction=self.halo_fraction)
        if self.n_time > 1:
            local = reshard_frame(self, RESHARD_SERIES_LOCAL)
            return reshard_frame(local.fourier_transform(timestep, valueCol),
                                 RESHARD_TIME_SHARDED)
        vc = matches[0]
        col = self.cols[vc]
        lengths = _pad_k(self.layout.lengths, self.K_dev, 0)
        ks = self.K_dev // self.n_series_shards
        freq, ftr, fti = unzip(self._map(
            lambda v, mask, i: _fourier_shard(
                v, mask, lengths[i * ks:(i + 1) * ks], float(timestep)),
            col.values, self.mask, list(range(len(self.ts)))))
        new_cols = {
            vc: col,
            "freq": DistCol(freq, self.mask),
            "ft_real": DistCol(ftr, self.mask),
            "ft_imag": DistCol(fti, self.mask),
        }
        keep_host = {c: src for c, src in self.host_cols.items()
                     if c == self.seq_col}
        return self._with(cols=new_cols, host_cols=keep_host)

    def withLookbackFeatures(self, featureCols, lookbackWindowSize: int,
                             exactSize: bool = True,
                             featureColName: str = "features"):
        """Lookback feature lists through the host frame: the reference
        materialises them as array-of-array columns (collect_list,
        tsdf.py:637-671), a row materialisation, so the mesh frame
        collects once; the dense device form is :meth:`lookback_tensor`."""
        from tempo_tpu_torch import plan

        if plan.recording():
            return self._plan_record("lookback_features", params=dict(
                featureCols=tuple(featureCols),
                lookbackWindowSize=lookbackWindowSize,
                exactSize=exactSize, featureColName=featureColName))
        logger.warning(
            "withLookbackFeatures: materialization barrier — the mesh "
            "chain collects to the host here (collect_list semantics "
            "materialise rows); use lookback_tensor for the "
            "device-resident dense form, or TEMPO_TPU_PLAN=1 explain() "
            "to see the barrier in the plan")
        with plan.suspended():
            return self.collect().withLookbackFeatures(
                featureCols, lookbackWindowSize, exactSize, featureColName)

    def lookback_tensor(self, featureCols, lookbackWindowSize: int):
        """The dense lookback tensor: one ``([K_dev, L, w, F] values,
        [K_dev, L, w, F] validity)`` pair on the mesh's first device, the
        shards' stacks concatenated in shard order (K_dev the padded
        series count), as the reference returns one array pair.  Window
        slot j of row t holds observation t - w + j (oldest first), zero
        with the mask False where there is none.  Plain numeric device
        columns only, and not on bucket-head views (their real rows are
        spread over masked lanes); collect() and ``withLookbackFeatures``
        compact first."""
        from tempo_tpu_torch.rolling import lookback_stack

        if self.resampled:
            raise ValueError(
                "lookback_tensor on a resampled (bucket-head) view "
                "would window over physical lane slots, not the "
                "previous w buckets; collect() and use "
                "withLookbackFeatures (which compacts rows first)")
        cols = list(featureCols)
        eligible = set(self.numeric_columns())
        bad = [c for c in cols if c not in eligible]
        if bad:
            raise ValueError(
                f"lookback_tensor needs plain numeric device columns; "
                f"{bad} are missing or host/join-resident "
                f"(available: {sorted(eligible)})")
        w = int(lookbackWindowSize)
        # the shifts cross time blocks: a time-sharded frame's stacks
        # switch to the series-local layout first
        xs, vs = self._to_local(*self._stack(cols))
        axes = self._local_axes
        vals, masks = unzip(shard_map(
            lambda x, v: lookback_stack(x.permute(1, 2, 0),
                                        v.permute(1, 2, 0), w),
            self.mesh, xs, vs, axis=axes))
        spec = (axes, None, None, None)
        return (assemble(vals, self.mesh, spec),
                assemble(masks, self.mesh, spec))


# ----------------------------------------------------------------------
# Layout switches of the time axis
# ----------------------------------------------------------------------

#: targets of :func:`reshard_frame`: ``series_local`` re-lays a
#: time-sharded frame so every device owns whole series (K cut over the
#: joint (series, time) axis, rows whole), the layout every per-series
#: op wants; ``time_sharded`` is the inverse.
RESHARD_SERIES_LOCAL = "series_local"
RESHARD_TIME_SHARDED = "time_sharded"


def reshard_frame(d: DistributedTSDF, target: str) -> DistributedTSDF:
    """The whole-frame layout switch: every plane of the frame (ts,
    mask, each column's values and validity, seq) moves in one call, by
    the tiled all-to-all of ``parallel/reshard.py``.  The global logical
    ``[K, L]`` arrays are bitwise the same before and after (blocks
    move; nothing computes).  A no-op when the frame is already in the
    target layout.  Deliberately whole-frame, untouched columns too: a
    frame's planes always share one layout."""
    if target == RESHARD_SERIES_LOCAL:
        if d.time_axis is None:
            return d
        s_ax, t_ax = d.series_axis, d.time_axis
        new_series, new_time = (s_ax, t_ax), None
        move = all_to_all_series_to_time
    elif target == RESHARD_TIME_SHARDED:
        if d.time_axis is not None or not (
                isinstance(d.series_axis, tuple)
                and len(d.series_axis) == 2):
            return d
        s_ax, t_ax = d.series_axis
        new_series, new_time = s_ax, t_ax
        move = all_to_all_time_to_series
    else:
        raise ValueError(f"unknown reshard target {target!r}")
    names = list(d.cols)
    planes = [d.ts, d.mask] + [d.cols[c].values for c in names] \
        + [d.cols[c].valid for c in names] \
        + ([d.seq] if d.seq is not None else [])
    if d.mesh.shape[t_ax] > 1:
        planes = [move(p, d.mesh, s_ax, t_ax) for p in planes]
    n = len(names)
    new_cols = {c: dataclasses.replace(d.cols[c], values=planes[2 + j],
                                       valid=planes[2 + n + j])
                for j, c in enumerate(names)}
    return d._with(ts=planes[0], mask=planes[1], cols=new_cols,
                   seq=planes[-1] if d.seq is not None else None,
                   series_axis=new_series, time_axis=new_time)


def relayout_comm_bytes(K_dev: int, L: int, n_cols: int, n_shards: int,
                        has_seq: bool = False,
                        dtype: torch.dtype = torch.float32) -> int:
    """Modelled bytes a shard sends in one :func:`reshard_frame`: every
    plane's per-shard element count (K*L / shards) times its item size:
    int64 ts + bool mask + n_cols x (value of ``dtype``, the compute
    type, + bool validity) [+ seq]."""
    val_itemsize = torch.empty(0, dtype=dtype).element_size()
    elems = (K_dev * L) // max(n_shards, 1)
    per_elem = 8 + 1 + n_cols * (val_itemsize + 1)
    if has_seq:
        per_elem += val_itemsize
    return int(elems * per_elem)


# ----------------------------------------------------------------------
# Shard programs: each runs on one shard's tensors, on its device
# ----------------------------------------------------------------------

def _secs(ts: torch.Tensor) -> torch.Tensor:
    return torch.div(ts, packing.NS_PER_S, rounding_mode="floor")


def _range_stats_shard(ts, xs, valids, w: float, rowbounds, engine: str):
    """Range stats of a [C, K, L] stack over the shard's timestamps:
    ``(stats of [C, K, L] planes, clipped [C])``.  With row bounds, the
    row-bounded kernel (``shifted``) or the legacy kernel (``legacy``)
    over per-series int32 rebased seconds (pads clamp to INT32_MAX);
    without, the windowed form (rank + cumsum3 kernels) over int64
    seconds."""
    secs = _secs(ts)
    C, K, L = xs.shape
    if rowbounds is not None:
        behind, ahead = (int(b) for b in rowbounds)
        rb = torch.clamp(secs - secs[:, :1], max=_I32_MAX).to(torch.int32)
        fn = window.range_stats if engine == "shifted" else \
            legacy.legacy_stats
        stats = fn(rb, xs, valids, int(w), behind, ahead)
        clipped = stats.pop("clipped").sum(dim=(1, 2))
        return stats, clipped
    start, end = rk.range_window_bounds(secs, math.floor(w))
    if xs.is_cuda and torch.cuda.is_current_stream_capturing():
        # inside a captured graph (plan/stitch.py) the widest window
        # cannot be read back: bound it by the row (0); the min/max
        # tables then build more levels, and every window still reads
        # the level its length picks, so the bits are the same
        max_w = 0
    else:
        real = valids.any(0)
        max_w = (max(1, int(torch.where(real, end - start, 0).max()))
                 if L else 1)
    flat = rk.windowed_stats(xs.reshape(C * K, L), valids.reshape(C * K, L),
                             start.repeat(C, 1), end.repeat(C, 1),
                             max_window=(1 << (max_w - 1).bit_length()
                                         if max_w else 0))
    stats = {k: v.reshape(C, K, L) for k, v in flat.items()}
    return stats, torch.zeros(C, dtype=xs.dtype, device=xs.device)


def _compact_right_lanes(r_ts, r_mask, vstack, pstack):
    """Stable per-row sort moving masked-out right rows to the lane tail
    as TS_PAD (bucket-head views lack the ascending packed invariant
    that ``maxLookback``'s merged-row count needs), every plane along."""
    key, order = torch.sort(torch.where(r_mask, r_ts, int(packing.TS_PAD)),
                            dim=-1, stable=True)
    return (key, torch.gather(vstack, -1, order.expand_as(vstack)),
            torch.gather(pstack, -1, order.expand_as(pstack)))


def _compact_left_rows(l_ts, l_mask):
    """The left-side mirror of :func:`_compact_right_lanes`: the
    compacted keys and each lane's source lane."""
    return torch.sort(torch.where(l_mask, l_ts, int(packing.TS_PAD)),
                      dim=-1, stable=True)


def _uncompact_left(src, vals, found):
    """Route [C, K, L] join outputs back to their source lanes."""
    idx = src.expand_as(vals)
    return (torch.empty_like(vals).scatter_(-1, idx, vals),
            torch.empty_like(found).scatter_(-1, idx, found))


def _bucket_heads(ts, mask, step_ns: int):
    """Tumbling-bucket scaffolding of a shard: bucket start ``b``
    (TS_PAD on pads), bucket-head mask and int32 bucket ids.

    ``head`` compares each real row's bucket with the previous REAL
    row's (a running max carry, buckets being monotone over the sorted
    ts), not with the physically previous row: a masked neighbour would
    flag every real row after a gap as a head (chained resamples).
    Bucket ids are rebased per row and floored; pads clamp to INT32_MAX
    and form their own trailing bucket, masked downstream."""
    step = int(step_ns)
    b_all = torch.div(ts, step, rounding_mode="floor") * step
    b = torch.where(mask, b_all, int(packing.TS_PAD))
    last_real = torch.cummax(torch.where(mask, b_all, _NEG), dim=-1).values
    prev_real = torch.cat([torch.full_like(b[:, :1], _NEG),
                           last_real[:, :-1]], dim=-1)
    head = mask & (b_all != prev_real)
    rel = torch.div(b_all - b_all[:, :1], step, rounding_mode="floor")
    bid = torch.clamp(rel, max=_I32_MAX).to(torch.int32)
    return b, head, bid


def _bucket_stats_shard(ts, mask, xs, valids, step_ns: int):
    """Six aggregates per bucket at bucket-head rows: ``(new_ts, head,
    [6, C, K, L])``, by the bucket-stats kernel.  Values count on real
    rows only (a join marks its pad lanes found), so the row's centre,
    and with it every bit, does not depend on the row's padding."""
    valids = valids & mask
    b, head, bid = _bucket_heads(ts, mask, step_ns)
    stats = rk.bucket_stats_multi(bid, xs, valids)
    new_ts = torch.where(mask, b, int(packing.TS_PAD))
    return new_ts, head, torch.stack([stats[k] for k in _GROUPED_STATS])


def _last_real_lane_seg(fence, real):
    """Segmented last-real-lane scan (the reference's
    ``sortmerge._ffill_scan_seg`` over a lane plane): per lane, whether
    a real lane lies between its segment's head (``fence``) and it, and
    the last such lane (the segment's first lane where none)."""
    K, L = real.shape
    lane = torch.arange(L, device=real.device).expand(K, L)
    seg_start = torch.cummax(torch.where(fence, lane, 0), dim=-1).values
    last = torch.cummax(torch.where(real, lane, -1), dim=-1).values
    has = last >= seg_start
    return has, torch.where(has, last, seg_start)


def _resample_shard(ts, mask, xs, valids, step_ns: int, fkey: int):
    """Bucket-head resample of a [C, K, L] stack: floor (0) takes the
    bucket's first row, ceil (1) its last real row, mean/min/max (2-4)
    the bucket-stats kernel's aggregate (real rows only, as
    :func:`_bucket_stats_shard`)."""
    valids = valids & mask
    b, head, bid = _bucket_heads(ts, mask, step_ns)
    if fkey == 1:
        # ceil reads each bucket's last REAL row: a bucket-head view can
        # end a bucket's physical run on a masked row
        K, L = mask.shape
        lane = torch.arange(L, device=mask.device).expand(K, L)
        change = bid[:, 1:] != bid[:, :-1]
        edge = torch.ones_like(mask[:, :1])
        fence = torch.cat([edge, change], dim=-1)
        tail = torch.cat([change, edge], dim=-1)
        has_real, last_lane = _last_real_lane_seg(fence, mask)
        # the bucket's last physical lane: the first tail at or after
        last_phys = torch.cummin(torch.where(tail, lane, L).flip(-1),
                                 dim=-1).values.flip(-1)
        last = torch.gather(last_lane, -1, last_phys).clamp(min=0)
        has = torch.gather(has_real, -1, last_phys)
        idx = last.expand_as(xs)
        outs = torch.gather(xs, -1, idx)
        oks = head & has & torch.gather(valids, -1, idx)
    elif fkey == 0:
        outs, oks = xs, head & valids
    else:
        stats = rk.bucket_stats_multi(bid, xs, valids)
        outs = stats[{2: "mean", 3: "min", 4: "max"}[fkey]]
        oks = head & (stats["count"] > 0)
    new_ts = torch.where(mask, b, int(packing.TS_PAD))
    return new_ts, head, outs, oks


def _interp_shard(ts, head, vals, valids, step_ns: int, G: int, mkey: int,
                  flags: bool):
    """Dense-grid gap fill of a bucket-head view (interpol.py
    semantics): each series' [K, G] bucket grid, filled from the
    previous and next bucket heads (two merge joins; the next one on
    negated, reversed keys)."""
    step = int(step_ns)
    dt = vals.dtype
    dev = ts.device
    C = vals.shape[0]
    pad = int(packing.TS_PAD)
    first_b = torch.where(head, ts, pad).amin(dim=1, keepdim=True)
    last_b = torch.where(head, ts, -1).amax(dim=1, keepdim=True)
    # the merges take ``ts`` (sorted), not the pad-masked heads: interior
    # non-head rows are excluded by their validity planes instead
    has_any = last_b >= 0
    gridj = torch.arange(G, dtype=torch.int64, device=dev)[None, :]
    grid_ts = torch.where(has_any, first_b + gridj * step, pad)
    grid_mask = has_any & (grid_ts <= last_b)
    grid_ts = torch.where(grid_mask, grid_ts, pad)

    # per-column planes: the value and the exact bucket index; one row
    # plane of the bucket index at every head
    bidx = torch.where(head, torch.div(ts - torch.where(has_any, first_b, 0),
                                       step, rounding_mode="floor"),
                       -1).to(dt)
    planes = torch.cat([vals, bidx.expand((C,) + tuple(bidx.shape)),
                        bidx[None]])
    pvalid = torch.cat([valids, valids, head[None]])
    prev_v, prev_f, _ = sm.asof_merge_values(grid_ts, ts, pvalid, planes)
    flip = lambda a: a.flip(-1)
    neg = lambda a: -a.flip(-1)
    next_v, next_f, _ = sm.asof_merge_values(neg(grid_ts), neg(ts),
                                             flip(pvalid), flip(planes))
    next_v, next_f = flip(next_v), flip(next_f)

    gj = gridj.to(dt)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    out_vals, out_valid, col_interp = [], [], []
    for i in range(C):
        pv, pf, pi = prev_v[i], prev_f[i], prev_v[C + i]
        nv, nf, ni = next_v[i], next_f[i], next_v[C + i]
        exact = pf & (pi == gj)
        if mkey == 0:        # zero
            filled, ok = torch.where(exact, pv, zero), grid_mask
        elif mkey == 1:      # null
            filled, ok = torch.where(exact, pv, nan), grid_mask & exact
        elif mkey == 2:      # ffill
            filled, ok = torch.where(pf, pv, nan), grid_mask & pf
        elif mkey == 3:      # bfill
            filled, ok = torch.where(nf, nv, nan), grid_mask & nf
        else:                # linear
            both = pf & nf & (ni > pi)
            w = torch.where(both, (gj - pi) / torch.maximum(ni - pi, one),
                            zero)
            lerp = pv + (nv - pv) * w
            filled = torch.where(exact, pv, torch.where(both, lerp, nan))
            ok = grid_mask & (exact | both)
        out_vals.append(torch.where(grid_mask, filled, nan))
        out_valid.append(ok)
        col_interp.append(grid_mask & ~exact)
    ts_interp = grid_mask & ~(prev_f[2 * C] & (prev_v[2 * C] == gj))
    out = (grid_ts, grid_mask, torch.stack(out_vals), torch.stack(out_valid))
    if flags:
        out = out + (ts_interp, torch.stack(col_interp))
    return out


def _describe_shard(ts, mask, vals, valids) -> Dict[str, torch.Tensor]:
    """A shard's partial reductions of describe(): counts, float64 sums,
    minima and maxima, the timestamp extremes and the granularity
    flags."""
    f64 = torch.float64
    secs = ts.to(f64) / packing.NS_PER_S
    s = torch.where(mask, secs, 0.0)
    ok = valids & mask[None]
    v = torch.where(ok, vals, 0.0).to(f64)
    inf = float("inf")
    return {
        "min_ts": torch.where(mask, ts, int(packing.TS_PAD)).min(),
        "max_ts": torch.where(mask, ts, _NEG).max(),
        "n_rows": mask.sum(),
        "has_frac": (mask & (s - torch.floor(s) > 0)).any(),
        "sub_min": (mask & (torch.remainder(s, 60) != 0)).any(),
        "sub_hr": (mask & (torch.remainder(s, 3600) != 0)).any(),
        "sub_day": (mask & (torch.remainder(s, 86400) != 0)).any(),
        "count": ok.sum(dim=(1, 2)),
        "sum": v.sum(dim=(1, 2)),
        "sumsq": (v * v).sum(dim=(1, 2)),
        "min": torch.where(ok, vals, inf).to(f64).amin(dim=(1, 2)),
        "max": torch.where(ok, vals, -inf).to(f64).amax(dim=(1, 2)),
        "ts_sum": s.sum(),
        "ts_sumsq": torch.where(mask, secs * secs, 0.0).sum(),
        "ts_min": torch.where(mask, secs, inf).min(),
        "ts_max": torch.where(mask, secs, -inf).max(),
    }


_DESCRIBE_COMBINE = {"min_ts": np.min, "max_ts": np.max, "n_rows": np.sum,
                     "has_frac": np.any, "sub_min": np.any,
                     "sub_hr": np.any, "sub_day": np.any, "count": np.sum,
                     "sum": np.sum, "sumsq": np.sum, "min": np.min,
                     "max": np.max, "ts_sum": np.sum, "ts_sumsq": np.sum,
                     "ts_min": np.min, "ts_max": np.max}


def _combine_describe(parts: List[Dict[str, np.ndarray]]) -> dict:
    """The shards' partials combined (sums added in shard order, extremes
    and flags reduced): scalars, and [C] arrays for the columns."""
    return {k: fn(np.stack([p[k] for p in parts]), axis=0)
            for k, fn in _DESCRIBE_COMBINE.items()}


def _autocorr_shard(v, ok, mask, lag: int, compact: bool):
    """Per-series lag-``lag`` autocorrelation of a shard: (ac, non-null
    count, row count) [K_shard]; ``compact`` stable-sorts the valid rows
    of a bucket-head view to the front first."""
    ok = ok & mask
    if compact:
        order = torch.sort((~ok).to(torch.int32), dim=-1, stable=True).indices
        v = torch.gather(v, -1, order)
        ok = torch.gather(ok, -1, order)
        mask2 = ok
    else:
        mask2 = mask
    L = v.shape[-1]
    cnt = ok.sum(-1)
    mean = torch.where(ok, v, 0.0).sum(-1) / torch.clamp(cnt, min=1)
    sub = torch.where(ok, v - mean[:, None], 0.0)
    denom = (sub * sub).sum(-1)
    lengths = mask2.sum(-1)
    if lag >= L:
        return torch.full_like(denom, float("nan")), cnt, lengths
    pos = torch.arange(L - lag, device=v.device)
    keep = ((pos[None, :] + 1 <= cnt[:, None] - lag)
            & (pos[None, :] + lag < lengths[:, None])
            & ok[:, :-lag] & ok[:, lag:])
    num = torch.where(keep, sub[:, :-lag] * sub[:, lag:], 0.0).sum(-1)
    ac = torch.where(keep.any(-1), num, float("nan")) / denom
    return ac, cnt, lengths


def _fourier_shard(vals, mask, lengths: np.ndarray, timestep: float):
    """(freq, ft_real, ft_imag) [K_shard, L] planes: each series' FFT of
    its true length (``lengths``, host) in its front lanes, one
    ``torch.fft.fft`` a distinct length; NaN past the series' end."""
    K, L = vals.shape
    dt, dev = vals.dtype, vals.device
    x = torch.where(mask, vals, 0.0)
    re = torch.full((K, L), float("nan"), dtype=dt, device=dev)
    im = torch.full((K, L), float("nan"), dtype=dt, device=dev)
    for m in np.unique(lengths[lengths > 0]):
        m = int(m)
        rows = torch.from_numpy(np.flatnonzero(lengths == m)).to(dev)
        tran = torch.fft.fft(x[rows, :m], dim=-1)
        re[rows, :m] = tran.real.to(dt)
        im[rows, :m] = tran.imag.to(dt)
    n = torch.from_numpy(np.ascontiguousarray(lengths)).to(dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    n1 = torch.clamp(n, min=1)
    # np.fft.fftfreq order: [0 .. (n-1)//2, -(n//2) .. -1] / (n d)
    jj = torch.where(j <= torch.div(n1 - 1, 2, rounding_mode="floor"), j,
                     j - n1)
    freq = jj.to(dt) / (n1.to(dt) * timestep)
    ok = j < n
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    return (torch.where(ok, freq, nan), torch.where(ok, re, nan),
            torch.where(ok, im, nan))
