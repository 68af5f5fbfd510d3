"""``StreamCohort``: serving a fleet of streams with one step a dispatch.

Counterpart of ``tempo_tpu/serve/cohort.py``.  ``StreamingTSDF``
(serve/stream.py) is one stream an instance with its own steps: N
streams are N objects and N small dispatches, so aggregate throughput is
bound by dispatch long before the card is busy.  The incremental state
is already explicit tensors (serve/state.py), so the streams stack:

* **cohort state**: every carry tensor gains a leading ``[S]`` stream
  axis (``state.cohort_state_init``), one block a *shape bucket*:
  streams whose series count rounds to the same power of two
  (:func:`row_bucket`) share one ``[S, ...]`` state block and one push
  and one query step (``state.cohort_push_executable``: the rank-generic
  step over ``[S, ...]``, a CUDA graph on a card, so each stream's slice
  of the result is the single stream's bits).
* **scatter admission**: a dispatch takes ticks of any number of member
  streams, checks each member against its own rows of the cohort's
  ``[S, K]`` watermark planes (``stream.admit_batch``'s rule) and
  scatters the admitted ticks into one padded ``[S, K, Lb]`` batch on
  the card.  Idle slots ride along as masked no-op rows (the step leaves
  their state as it was), so a push is one scatter, one step and one
  gather however many streams ticked.
* **per-stream isolation**: a late tick rejects only its own member's
  rows: that member's sub-batch leaves the dispatch (its tickets get the
  :class:`~tempo_tpu_torch.serve.stream.LateTickError`), the rest steps,
  and the rejected member's state and watermarks stay as they were.
* **block dispatch**: :meth:`StreamCohort.dispatch_block` takes column
  arrays of ticks; those of single-tick (member, series) pairs run as
  one block program a side (``state.cohort_block_push_executable``:
  scatter, step and gather in one graph, traffic O(ticks)), the rest
  take the per-tick route in arrival order a member.  ``routes`` counts
  both.
* **mesh scale-out**: with a ``mesh``, the ``[S]`` axis is cut into
  contiguous slot ranges, one a mesh entry along ``stream_axis``
  (``dist.stream_shardings``); a shard's state lives on its entry's
  device and each shard runs its own captured step, so a push moves
  nothing between entries.
* **the spill tier**: with a ``spill_dir`` and a ``resident_budget``,
  cold members live as CRC'd ``kind="cohort_member"`` artifacts instead
  of slots and fault back in, bit for bit, on their next tick.
* **durability**: ``snapshot()`` writes one CRC'd artifact for the whole
  cohort (``checkpoint.save_state(kind="cohort_state")``, the
  reference's array names and manifest, so either package resumes the
  other's), optionally differential (only dirty bucket groups, chained
  by manifest CRCs); :meth:`StreamCohort.resume` restores it and reports
  per-stream ``acked`` so only each stream's unacknowledged tail
  replays.

The reference moves a whole group's state to host numpy for slot
surgery; here it stays on its devices: a release resets a slot with
in-place writes, growth concatenates on the device, and only snapshots
and spills fetch.  Results are bitwise S independent ``StreamingTSDF``s
fed the same per-stream events at any push interleaving, per-stream
watermarks and ``maxLookback`` expiry included.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tempo_tpu_torch import checkpoint as ckpt
from tempo_tpu_torch import config, resilience
from tempo_tpu_torch import device as device_mod
from tempo_tpu_torch.packing import TS_PAD
from tempo_tpu_torch.serve import state as sst
from tempo_tpu_torch.serve import stream as stream_mod
from tempo_tpu_torch.serve.stream import LateTickError, _SIDE_LEFT, _SIDE_RIGHT

logger = logging.getLogger(__name__)

#: per-state-array position of the SERIES axis (without the leading
#: stream axis); everything not listed keeps it last.  Used by bucket
#: migration, which copies series-row prefixes.
_K_AXIS = {"ring_ts": -2, "ring_x": -2, "ring_valid": -2}


def row_bucket(n: int) -> int:
    """Cohort membership: padded series-row count of a stream — next
    power of two, floor 1.  Streams sharing a bucket share one state
    block and one step; a stream that outgrows its bucket migrates to
    the next one (:meth:`CohortMember.add_series`)."""
    if n < 1:
        raise ValueError("a stream needs at least one series")
    b = 1
    while b < n:
        b *= 2
    return b


def _k_slice(arr_ndim: int, name: str, k: int) -> tuple:
    """Indexer selecting the first ``k`` series rows of a PER-SLOT
    state array (no stream axis)."""
    ax = _K_AXIS.get(name, -1) % arr_ndim
    sl = [slice(None)] * arr_ndim
    sl[ax] = slice(0, k)
    return tuple(sl)


class _Singles:
    """Per-dispatch accumulator for single-tick members (the fleet
    regime): plain python lists, turned into ONE set of index arrays
    and ONE vectorized watermark check in ``_dispatch_group``."""

    __slots__ = ("members", "idxs", "slots", "rows", "ts", "sqf",
                 "planes")

    def __init__(self, n_cols: int):
        self.members: List[CohortMember] = []
        self.idxs: List[int] = []
        self.slots: List[int] = []
        self.rows: List[int] = []
        self.ts: List[int] = []
        self.sqf: List[float] = []
        self.planes: List[List[float]] = [[] for _ in range(n_cols)]


class CohortMember:
    """One stream of a cohort: the ``StreamingTSDF``-shaped handle
    (``push`` / ``push_left`` with the same argument and emission
    contract), backed by one slot of its bucket group's stacked state.
    Single-writer like the standalone frame; route concurrent traffic
    through :class:`~tempo_tpu_torch.serve.executor.CohortExecutor`."""

    def __init__(self, cohort: "StreamCohort", name: str,
                 series: Sequence):
        self.cohort = cohort
        self.name = str(name)
        self.series = list(series)
        if len(set(self.series)) != len(self.series):
            raise ValueError("duplicate series keys")
        self._row = {s: k for k, s in enumerate(self.series)}
        self.acked = 0
        self._group: Optional["_Group"] = None
        self.slot: Optional[int] = None
        # spill tier: the bucket a non-resident member belongs to
        # (``_group is None`` = spilled or never-allocated cold member)
        self._spill_bucket: Optional[int] = None

    @property
    def resident(self) -> bool:
        """True when this member holds a live slot (hot tier); False
        when its state is spilled to a CRC'd artifact (or it has never
        ticked and its fresh state needs no artifact at all)."""
        return self._group is not None

    @property
    def bucket(self) -> int:
        """The member's current shape bucket (padded series rows)."""
        if self._group is None:
            return int(self._spill_bucket)
        return self._group.cfg.n_series

    # -- the StreamingTSDF-shaped surface ------------------------------

    def push(self, series_ids, ts, values: Dict[str, np.ndarray],
             seq=None) -> Dict[str, np.ndarray]:
        """Ingest right-side ticks for this stream (parallel arrays,
        same contract as ``StreamingTSDF.push``) — dispatched as this
        member's sub-batch of one cohort step."""
        items = self._items(series_ids, ts, seq, values)
        return self._collect(self.cohort.dispatch("right", items))

    def push_left(self, series_ids, ts, seq=None) -> Dict[str, np.ndarray]:
        """Answer AS-OF queries for new left rows (the
        ``StreamingTSDF.push_left`` contract)."""
        items = self._items(series_ids, ts, seq, None)
        return self._collect(self.cohort.dispatch("left", items))

    def _items(self, series_ids, ts, seq, values):
        ts = np.atleast_1d(np.asarray(ts, np.int64))
        series_ids = list(np.atleast_1d(np.asarray(series_ids, object)))
        n = len(series_ids)
        if len(ts) != n:
            raise ValueError(
                f"series_ids and ts are parallel arrays: got {n} "
                f"series ids but {len(ts)} timestamps")
        if seq is not None and len(np.atleast_1d(seq)) != n:
            raise ValueError(
                f"seq must align with series_ids: "
                f"{len(np.atleast_1d(seq))} != {n}")
        seqa = (np.full(n, None, object) if seq is None
                else list(np.atleast_1d(np.asarray(seq, object))))
        if values is None:
            return [(self, series_ids[i], int(ts[i]), seqa[i], None)
                    for i in range(n)]
        rows = []
        for i in range(n):
            row = {}
            for col, v in values.items():
                v = np.atleast_1d(np.asarray(v, np.float32))
                if len(v) != n:
                    raise ValueError(
                        f"values[{col!r}] must align with series_ids: "
                        f"{len(v)} != {n}")
                row[col] = v[i]
            rows.append((self, series_ids[i], int(ts[i]), seqa[i], row))
        return rows

    @staticmethod
    def _collect(results) -> Dict[str, np.ndarray]:
        for r in results:
            if isinstance(r, Exception):
                raise r
        if not results:
            return {}
        return {k: np.array([r[k] for r in results])
                for k in results[0]}

    # -- growth / introspection ----------------------------------------

    def add_series(self, new_series: Sequence) -> None:
        """Extend this stream's series set.  Within the current bucket
        the new rows are already-fresh state; outgrowing it migrates
        the stream to the next bucket's group (its carries copied
        bit-for-bit, the new rows fresh) — cohort membership follows
        the shape bucket, not the object."""
        new_series = list(new_series)
        dup = [s for s in new_series if s in self._row]
        if dup or len(set(new_series)) != len(new_series):
            raise ValueError(f"duplicate series keys: {dup or new_series}")
        self.cohort._grow_member(self, new_series)

    @property
    def clipped(self) -> int:
        """Rows of THIS stream whose true stats window exceeded the
        declared row bound (truncated — the declared-bound audit)."""
        if not self.cohort.cfg_has_window:
            return 0
        if self._group is None:
            # spilled member: its counts live in the artifact (a
            # never-ticked cold member has no artifact and no clips)
            arrays = self.cohort._spilled_arrays(self)
            if arrays is None:
                return 0
            return int(np.asarray(
                arrays["s.clipped"])[:len(self.series)].sum())
        part, j = self._group.locate(self.slot)
        return int(part["clipped"][j, :len(self.series)].sum().item())


class _Group:
    """One shape bucket's stacked state: ``[S, ...]`` tensors for up to
    ``capacity`` member slots, cut into one part a shard (one part on a
    meshless cohort; with a mesh, contiguous slot ranges on each entry's
    device), plus the host watermark planes and the pinned per-bucket
    executables."""

    def __init__(self, cohort: "StreamCohort", bucket: int,
                 capacity: int, arrays: Optional[dict] = None):
        self.cohort = cohort
        self.bucket = bucket
        self.cfg = cohort._member_cfg(bucket)
        self.capacity = capacity
        self.shards = cohort._shards(capacity)
        self.per = capacity // len(self.shards)
        if arrays is None:
            arrays = sst.cohort_state_init(self.cfg, capacity)
        self.parts = self._place(arrays)
        self._slot_init = [sst.to_device(sst.init_state(self.cfg), dev)
                           for dev, _, _ in self.shards]
        self.wm_ts = np.full((capacity, bucket), sst._FAR_PAST, np.int64)
        self.wm_seq = np.full((capacity, bucket), -np.inf, np.float64)
        self.wm_side = np.zeros((capacity, bucket), np.int8)
        self.members: List[Optional[CohortMember]] = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))
        # the group's own references to its steps, keyed (kind, Lb):
        # the steady state of a live cohort builds nothing however the
        # planner's cache evicts, and its graphs live while it does
        self._exes: Dict[Tuple[str, int], object] = {}

    # -- where slots live ----------------------------------------------

    def _place(self, arrays: dict) -> List[Dict[str, torch.Tensor]]:
        """Host ``[capacity, ...]`` arrays as one part a shard."""
        return [{n: torch.from_numpy(np.ascontiguousarray(a[s0:s1])).to(dev)
                 for n, a in arrays.items()}
                for dev, s0, s1 in self.shards]

    def locate(self, slot: int) -> Tuple[Dict[str, torch.Tensor], int]:
        """``(part, row)`` holding ``slot``."""
        i = slot // self.per
        return self.parts[i], slot - i * self.per

    def host_state(self) -> Dict[str, np.ndarray]:
        """The whole ``[capacity, ...]`` state as host arrays (a fetch: the
        snapshot's)."""
        return {n: np.concatenate([p[n].cpu().numpy() for p in self.parts])
                for n in self.cfg.state_names()}

    def slot_rows(self, slot: int) -> Dict[str, np.ndarray]:
        part, j = self.locate(slot)
        return {n: t[j].cpu().numpy() for n, t in part.items()}

    def set_slot(self, slot: int, rows: Dict[str, np.ndarray]) -> None:
        part, j = self.locate(slot)
        for n, t in part.items():
            t[j] = torch.from_numpy(np.ascontiguousarray(rows[n]))

    # -- membership ------------------------------------------------------

    def alloc(self, member: CohortMember) -> int:
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.members[slot] = member
        member._group, member.slot = self, slot
        self.cohort._dirty.add(self.bucket)
        return slot

    def release(self, slot: int) -> None:
        """Free a slot and reset its state and watermark rows to fresh
        init (in-place writes on the slot's device), so the slot is inert
        (a masked no-op) until reused."""
        self.cohort._dirty.add(self.bucket)
        self.members[slot] = None
        part, j = self.locate(slot)
        fresh = self._slot_init[slot // self.per]
        for name, t in part.items():
            t[j] = fresh[name]
        self.wm_ts[slot] = sst._FAR_PAST
        self.wm_seq[slot] = -np.inf
        self.wm_side[slot] = 0
        self._free.append(slot)

    def _grow(self) -> None:
        """Double the slot capacity (still a multiple of the mesh's
        stream-axis size): each new part is the old slots of its range,
        then fresh ones, concatenated on its device.  A capacity change is
        a new step shape (admission time, never the steady state), so the
        pinned executables go."""
        add, old = self.capacity, self.capacity
        new_cap = old + add
        shards = self.cohort._shards(new_cap)
        names = self.cfg.state_names()
        parts = []
        for dev, s0, s1 in shards:
            pieces = {n: [] for n in names}
            for (_, o0, o1), part in zip(self.shards, self.parts):
                lo, hi = max(s0, o0), min(s1, o1)
                if lo < hi:
                    for n in names:
                        pieces[n].append(part[n][lo - o0:hi - o0].to(dev))
            if s1 > old:
                tail = sst.to_device(sst.cohort_state_init(
                    self.cfg, s1 - max(s0, old)), dev)
                for n in names:
                    pieces[n].append(tail[n])
            parts.append({n: torch.cat(pieces[n]) for n in names})
        self.shards, self.parts = shards, parts
        self.per = new_cap // len(shards)
        self.wm_ts = np.concatenate(
            [self.wm_ts, np.full((add, self.bucket), sst._FAR_PAST,
                                 np.int64)])
        self.wm_seq = np.concatenate(
            [self.wm_seq, np.full((add, self.bucket), -np.inf,
                                  np.float64)])
        self.wm_side = np.concatenate(
            [self.wm_side, np.zeros((add, self.bucket), np.int8)])
        self.members.extend([None] * add)
        self._free.extend(range(new_cap - 1, old - 1, -1))
        self.capacity = new_cap
        self._exes = {}
        self.cohort._dirty.add(self.bucket)

    # -- steps -------------------------------------------------------------

    _BUILDERS = {
        "push": sst.cohort_push_executable,
        "query": sst.cohort_query_executable,
        # block kinds: the second key is the power-of-two TICK count Nb,
        # not a per-series row bucket (the block step always runs at the
        # singles' lane width, state.block_lanes())
        "block_push": sst.cohort_block_push_executable,
        "block_query": sst.cohort_block_query_executable,
    }

    def executable(self, kind: str, Lb: int):
        exe = self._exes.get((kind, Lb))
        if exe is None:
            exe = self._BUILDERS[kind](
                self.cfg, self.capacity, Lb, self.cohort.device,
                self.cohort.mesh, self.cohort.stream_axis)
            self._exes[(kind, Lb)] = exe
        return exe

    def _run(self, kind: str, Lb: int, per_shard: List[list]) -> List[list]:
        exe = self.executable(kind, Lb)
        if self.cohort.mesh is None:
            return [exe(*per_shard[0])]
        return exe(per_shard)

    def _shard_ticks(self, sl: np.ndarray):
        """``(shard index, tick indices, local slots)`` a shard."""
        if len(self.shards) == 1:
            yield 0, np.arange(len(sl)), sl
            return
        for i, (_, s0, s1) in enumerate(self.shards):
            idx = np.flatnonzero((sl >= s0) & (sl < s1))
            yield i, idx, sl[idx] - s0

    def step_ticks(self, right: bool, Lb: int, sl, rw, ln, tsv, colv):
        """One per-tick-route step of every shard over admitted ticks
        (``sl`` slots, ``rw`` series rows, ``ln`` lanes, ``tsv`` keys,
        ``colv [C, N]`` values): on each shard's device the compact ticks
        (two host-to-device copies) scatter into the padded ``[S, K, Lb]``
        batch, the step runs, and the ticks' emissions are gathered there
        and fetched in one copy.  Returns ``[N, E, C]`` float32 emissions
        (push) or ``(vals, found, idx)`` (query), in tick order."""
        K, C = self.bucket, len(self.cohort.value_cols)
        n = len(sl)
        names = self.cfg.state_names()
        inputs, where = [], []
        for i, idx, local in self._shard_ticks(sl):
            dev, s0, s1 = self.shards[i]
            Sp = s1 - s0
            ix = torch.from_numpy(np.stack(
                [local, rw[idx], ln[idx], tsv[idx]])).to(dev)
            pos = (ix[0], ix[1], ix[2])
            counts = torch.zeros(Sp * K, dtype=torch.int64, device=dev)
            counts.scatter_add_(0, ix[0] * K + ix[1], torch.ones_like(ix[0]))
            counts = counts.view(Sp, K)
            part = self.parts[i]
            if right:
                cv = torch.from_numpy(np.ascontiguousarray(
                    colv[:, idx])).to(dev)
                ts_p = torch.full((Sp, K, Lb), int(TS_PAD),
                                  dtype=torch.int64, device=dev)
                ts_p.index_put_(pos, ix[3])
                mask = torch.zeros((Sp, K, Lb), dtype=torch.bool, device=dev)
                mask.index_put_(pos, torch.ones_like(ix[0], dtype=torch.bool))
                xs = torch.full((Sp, C, K, Lb), float("nan"),
                                dtype=torch.float32, device=dev)
                xs.permute(0, 2, 3, 1).index_put_(pos, cv.t())
                inputs.append([part[nm] for nm in names]
                              + [ts_p, xs, mask, counts])
            else:
                inputs.append([part[nm] for nm in sst._QUERY_STATE]
                              + [counts])
            where.append((idx, pos))
        self.cohort.routes["per_tick"] += 1
        outs = self._run("push" if right else "query", Lb, inputs)
        if right:
            E = len(self.cfg.emit_keys())
            got = np.empty((n, E, C), np.float32)
            for part, out, (idx, pos) in zip(self.parts, outs, where):
                part.update(zip(names, out[:len(names)]))
                if E and len(idx):
                    l, r, ln_t = pos
                    got[idx] = out[len(names)][:, l, :, r, ln_t].cpu().numpy()
            return got
        packed = np.empty((n, 2 * C + 1), np.int32)
        for part, out, (idx, pos) in zip(self.parts, outs, where):
            part["n_merged"] = out[0]
            if len(idx):
                l, r, ln_t = pos
                packed[idx] = sst.pack_answers(
                    out[1][l, :, r, ln_t], out[2][l, :, r, ln_t],
                    out[3][l, r, ln_t]).cpu().numpy()
        return sst.unpack_answers(packed, C)


class StreamCohort:
    """See module docstring.  Shared shape config (``value_cols``,
    ``skip_nulls``, ``max_lookback``, window, ``ema_alpha``) fixes the
    operator set for every member; ``add_stream`` admits streams with
    arbitrary series sets, grouped by shape bucket.  ``mesh`` (with
    ``stream_axis``) cuts every bucket's stream axis over its entries;
    slot capacities are rounded up to the axis size.  ``slots`` is the
    initial per-bucket slot capacity (default
    ``TEMPO_TPU_SERVE_COHORT_SLOTS``); groups grow by doubling.
    ``diff_snapshots`` (default ``TEMPO_TPU_SERVE_COHORT_DIFF``) makes
    automatic snapshots differential — only dirty bucket groups,
    chained to the last full artifact by CRC'd manifests — with every
    ``full_every``-th automatic snapshot full.  ``device``: the CUDA
    card by default, ``"cpu"`` for the plain versions (a mesh brings its
    own devices)."""

    def __init__(self, value_cols: Sequence[str], *,
                 skip_nulls: bool = True, max_lookback: int = 0,
                 window_secs=None, window_rows_bound: int = 64,
                 ema_alpha=None, mesh=None, stream_axis: str = "streams",
                 slots: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 ckpt_every: Optional[int] = None, keep_last: int = 3,
                 diff_snapshots: Optional[bool] = None,
                 full_every: int = 16,
                 spill_dir: Optional[str] = None,
                 resident_budget: Optional[int] = None,
                 device=None):
        self.value_cols = [str(c) for c in value_cols]
        self.skip_nulls = bool(skip_nulls)
        self.max_lookback = int(max_lookback)
        self.window_ns = (None if window_secs is None
                          else sst.window_ns(window_secs))
        self.rows_bound = int(window_rows_bound)
        self.ema_alpha = (None if ema_alpha is None else float(ema_alpha))
        self.mesh = mesh
        self.stream_axis = str(stream_axis)
        if slots is None:
            slots = config.get_int("TEMPO_TPU_SERVE_COHORT_SLOTS", 1024)
        self._slots = max(1, int(slots))
        if mesh is not None:
            n_axis = int(mesh.shape[self.stream_axis])
            self._slots = -(-self._slots // n_axis) * n_axis
            self.device = self._shards(self._slots)[0][0]
        else:
            self.device = device_mod.resolve(device)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self._groups: Dict[int, _Group] = {}
        self._members: Dict[str, CohortMember] = {}
        self.acked_total = 0
        self.dispatches = 0
        #: steps a route ran: ``per_tick`` (one a touched group a
        #: dispatch), ``block`` (block programs), and ``fallback_ticks``,
        #: the ticks of blocks that took the per-tick route
        self.routes = {"per_tick": 0, "block": 0, "fallback_ticks": 0}
        self.checkpoint_dir = checkpoint_dir
        self.keep_last = int(keep_last)
        if ckpt_every is None:
            ckpt_every = config.get_int(
                "TEMPO_TPU_SERVE_COHORT_CKPT_EVERY", 0)
        self.ckpt_every = int(ckpt_every or 0)
        self._next_ckpt = self.ckpt_every or None
        self._emit_cache: Dict[tuple, list] = {}
        # -- incremental failover state: buckets whose stacked state /
        # watermarks / capacity changed since the previous snapshot
        # (ANY kind), the chain anchors, and the auto-snapshot policy
        if diff_snapshots is None:
            diff_snapshots = config.get_bool(
                "TEMPO_TPU_SERVE_COHORT_DIFF", False)
        self.diff_snapshots = bool(diff_snapshots)
        self.full_every = max(1, int(full_every))
        self._dirty: set = set()
        self._last_snapshot: Optional[str] = None
        self._last_full: Optional[str] = None
        self._diffs_since_full = 0
        # -- tiered member state: with a spill_dir, cold members live
        # as CRC'd kind="cohort_member" artifacts instead of slots.
        # 0 = unlimited (no LRU eviction; explicit spill() still works).
        self.spill_dir = spill_dir
        if resident_budget is None:
            resident_budget = config.get_int(
                "TEMPO_TPU_SERVE_COHORT_RESIDENT", 0)
        self.resident_budget = max(0, int(resident_budget))
        if self.resident_budget and not self.spill_dir:
            raise ValueError(
                "a resident_budget needs a spill_dir to evict into")
        self._spilled: Dict[str, str] = {}   # member name -> artifact
        self._lru: Dict[str, None] = {}      # resident members, LRU order
        self._resident = 0
        self.spills = 0
        self.restores = 0
        self.spill_s = 0.0
        self.restore_s = 0.0

    # -- membership ----------------------------------------------------

    @property
    def cfg_has_window(self) -> bool:
        return self.window_ns is not None

    def _shards(self, capacity: int) -> List[Tuple[torch.device, int, int]]:
        """Where a group of ``capacity`` slots lives: ``(device, first,
        end)`` a shard."""
        if self.mesh is None:
            return [(self.device, 0, capacity)]
        from tempo_tpu_torch import dist

        return dist.stream_shardings(self.mesh, self.stream_axis, capacity)

    def _member_cfg(self, bucket: int) -> sst.StreamConfig:
        return sst.StreamConfig(
            n_series=bucket, n_cols=len(self.value_cols),
            skip_nulls=self.skip_nulls, max_lookback=self.max_lookback,
            window_ns=self.window_ns, rows_bound=self.rows_bound,
            ema_alpha=self.ema_alpha)

    def _group(self, bucket: int) -> _Group:
        g = self._groups.get(bucket)
        if g is None:
            g = self._groups[bucket] = _Group(self, bucket, self._slots)
            self._dirty.add(bucket)
        return g

    def add_stream(self, name: str, series: Sequence) -> CohortMember:
        """Admit a stream: allocate a slot in its shape bucket's group
        (creating/growing the group as needed) and return its handle.

        With a ``resident_budget``, admission past the budget registers
        the stream COLD: no slot, no artifact (a fresh slot IS the init
        state, so nothing needs persisting) — it faults into a slot on
        its first tick.  Registration is O(1) regardless of fleet
        size."""
        name = str(name)
        if name in self._members:
            raise ValueError(f"stream {name!r} already exists")
        member = CohortMember(self, name, series)
        bucket = row_bucket(len(member.series))
        if self.resident_budget and self._resident >= self.resident_budget:
            member._spill_bucket = bucket
        else:
            self._group(bucket).alloc(member)
            self._resident += 1
            self._lru[name] = None
        self._members[name] = member
        return member

    def stream(self, name: str) -> CohortMember:
        return self._members[str(name)]

    @property
    def n_streams(self) -> int:
        return len(self._members)

    @property
    def acked(self) -> Dict[str, int]:
        """Per-stream acknowledged-event counts (the replay cursors a
        resumed server restarts its event sources from)."""
        return {name: m.acked for name, m in self._members.items()}

    @property
    def clipped(self) -> int:
        if not self.cfg_has_window:
            return 0
        total = 0
        for g in self._groups.values():
            plane = np.concatenate([p["clipped"].cpu().numpy()
                                    for p in g.parts])
            for m in g.members:
                if m is not None:
                    total += int(plane[m.slot, :len(m.series)].sum())
        for name in self._spilled:
            total += self._members[name].clipped
        return total

    def graph_pool_bytes(self) -> int:
        """Bytes the private pools of the groups' CUDA graphs hold (0 on
        the CPU)."""
        return sum(e.pool_bytes or 0 for g in self._groups.values()
                   for e in g._exes.values())

    def _grow_member(self, member: CohortMember,
                     new_series: Sequence) -> None:
        if member._group is None:    # spilled: surgery needs a slot
            self._fault_in(member)
        new_k = len(member.series) + len(new_series)
        old_g, old_slot = member._group, member.slot
        target = row_bucket(new_k)
        if target == old_g.bucket:
            # in-bucket growth: the new rows are untouched init rows of
            # the same slot — already bit-fresh, nothing to move; the
            # SERIES SET changed though, and it rides snapshot
            # manifests, so the bucket is snapshot-dirty
            member.series.extend(new_series)
            member._row = {s: k for k, s in enumerate(member.series)}
            self._dirty.add(old_g.bucket)
            return
        new_g = self._group(target)
        slot = new_g.alloc(member)   # re-pins member._group/.slot
        k_old = old_g.bucket
        src, i = old_g.locate(old_slot)
        dst, j = new_g.locate(slot)
        for name, t in dst.items():
            row = t[j]
            row[_k_slice(row.dim(), name, k_old)] = \
                src[name][i][_k_slice(row.dim(), name, k_old)].to(t.device)
        new_g.wm_ts[slot, :k_old] = old_g.wm_ts[old_slot, :k_old]
        new_g.wm_seq[slot, :k_old] = old_g.wm_seq[old_slot, :k_old]
        new_g.wm_side[slot, :k_old] = old_g.wm_side[old_slot, :k_old]
        old_g.release(old_slot)
        member.series.extend(new_series)
        member._row = {s: k for k, s in enumerate(member.series)}

    # -- the cohort step -----------------------------------------------

    def dispatch(self, side: str, items: List[tuple]) -> List[object]:
        """Run ONE cohort step per touched bucket group over a tick
        list ``[(member, series_key, ts, seq_or_None, values_or_None)]``
        (arrival order; ``side`` 'right' = data pushes, 'left' = AS-OF
        queries).  Returns a list parallel to ``items``: the per-tick
        emission dict, or the exception that rejected that member's
        sub-batch — **per-stream isolation**: a late tick (or bad
        payload) zeroes only its own member's rows out of the step,
        every other member's results and state are bit-identical to a
        dispatch that never contained the offender."""
        if side not in ("right", "left"):
            raise ValueError(f"side must be 'right' or 'left', got "
                             f"{side!r}")
        side_i = _SIDE_RIGHT if side == "right" else _SIDE_LEFT
        right = side_i == _SIDE_RIGHT
        results: List[object] = [None] * len(items)
        # first occurrence stored as a bare int (the fleet regime is
        # one tick per member — no per-tick list allocation), demoted
        # to an index list on a second tick from the same member
        by_member: Dict[int, object] = {}
        for i, it in enumerate(items):
            key = id(it[0])
            prev = by_member.get(key)
            if prev is None:
                by_member[key] = i
            elif type(prev) is int:
                by_member[key] = [prev, i]
            else:
                prev.append(i)

        # spill tier: fault cold members back into slots BEFORE
        # admission — per-member isolation holds here too: a corrupt or
        # foreign member artifact rejects only that member's ticks (the
        # refusal delivered by name as their result), never the
        # dispatch
        dead: set = set()
        touched: List[CohortMember] = []
        if self.spill_dir is not None:
            for key, idxs in by_member.items():
                member = items[idxs if type(idxs) is int else idxs[0]][0]
                if member.cohort is not self:
                    continue       # admission loop raises, as ever
                touched.append(member)
                if member._group is not None:
                    continue
                try:
                    self._fault_in(member)
                except Exception as e:  # noqa: BLE001 - per member
                    dead.add(key)
                    for i in ([idxs] if type(idxs) is int else idxs):
                        results[i] = e

        # per-member admission: validate payloads + watermark order,
        # assign lanes; a failing member is recorded and EXCLUDED.
        # Single-tick members take a deferred path: payloads validated
        # here (python scalars), the watermark predicate evaluated
        # VECTORIZED against the group's [S, K] planes inside
        # _dispatch_group — per-member numpy work is the aggregate
        # throughput bottleneck otherwise
        groups: Dict[int, List] = {}
        singles: Dict[int, "_Singles"] = {}
        n_cols = len(self.value_cols)
        for key, idxs in by_member.items():
            if key in dead:
                continue
            if type(idxs) is int:
                i = idxs
                member, skey, ts, sq, vals = items[i]
                if member.cohort is not self:
                    raise ValueError(
                        f"stream {member.name!r} belongs to a "
                        f"different cohort")
                try:
                    k, ts, sqf, row = self._admit_tick(
                        member, skey, ts, sq, vals, right)
                except Exception as e:  # noqa: BLE001 - per tick
                    results[i] = e
                    continue
                bucket = member._group.bucket
                sg = singles.get(bucket)
                if sg is None:
                    sg = singles[bucket] = _Singles(n_cols)
                sg.members.append(member)
                sg.idxs.append(i)
                sg.slots.append(member.slot)
                sg.rows.append(k)
                sg.ts.append(ts)
                sg.sqf.append(sqf)
                if row is not None:
                    planes = sg.planes
                    for c in range(n_cols):
                        planes[c].append(row[c])
                continue
            member = items[idxs[0]][0]
            if member.cohort is not self:
                raise ValueError(
                    f"stream {member.name!r} belongs to a different "
                    f"cohort")
            try:
                rec = self._admit_member(member, items, idxs, side_i)
            except Exception as e:  # noqa: BLE001 - delivered per tick
                for i in idxs:
                    results[i] = e
                continue
            groups.setdefault(member._group.bucket, []).append(
                (member, idxs, rec))

        for bucket in set(groups) | set(singles):
            self._dispatch_group(self._groups[bucket], side_i,
                                 groups.get(bucket, ()),
                                 singles.get(bucket), results)
            self._dirty.add(bucket)
        self.dispatches += 1
        # spill tier: everything that dispatched is hot (move to MRU),
        # then evict coldest residents past the budget — never a member
        # of THIS dispatch
        if self.spill_dir is not None and self.resident_budget:
            for m in touched:
                if m._group is not None:
                    self._lru.pop(m.name, None)
                    self._lru[m.name] = None
            self._enforce_budget({m.name for m in touched})
        self._maybe_snapshot()
        return results

    def _admit_tick(self, member: CohortMember, skey, ts, sq, vals,
                    right: bool):
        """Scalar per-tick validation shared by the singles fast path
        and the multi-tick ``_admit_member`` loop — ONE copy of the
        series-row lookup, the NULLS-FIRST seq normalization (None and
        ANY NaN, numpy scalars included, map to -inf — the
        ``StreamingTSDF._seq_array`` rule; an un-normalized NaN would
        poison the watermark and silently stop rejecting late ticks),
        and the payload check.  Returns ``(k, ts, sqf, row)``."""
        k = member._row.get(skey)
        if k is None:
            raise ValueError(
                f"unknown series {skey!r} on stream {member.name!r}: "
                f"a cohort stream's series set grows only through "
                f"add_series")
        ts = int(ts)
        if sq is None:
            sqf = -np.inf
        else:
            sqf = float(sq)
            if sqf != sqf:               # NaN of any flavour
                sqf = -np.inf            # NULLS FIRST
        row = None
        if right:
            if vals is None:
                raise ValueError(
                    f"right tick on stream {member.name!r} has no "
                    f"values")
            # python float(): validates per member (a bad payload
            # rejects only its own sub-batch); the f32 cast lands at
            # the batch-array build, bit-equal to a per-tick
            # np.float32() cast
            row = [float(vals[col]) if col in vals else
                   self._missing_col(member, col)
                   for col in self.value_cols]
        return k, ts, sqf, row

    def _missing_col(self, member, col):
        raise ValueError(
            f"push on stream {member.name!r} is missing value column "
            f"{col!r} (cohort columns: {self.value_cols})")

    def _admit_member(self, member: CohortMember, items, idxs,
                      side_i: int):
        """Validate one member's sub-batch (payloads first, then the
        merged-stream watermark rule — the same ordering predicate as
        ``stream.admit_batch``, evaluated against this member's rows
        of the group's watermark planes) — any failure rejects the
        whole sub-batch atomically, exactly like a standalone
        ``StreamingTSDF`` push.  Python scalars and lists until the
        group-level scatter: the fleet regime is thousands of members
        with a tick or two each a dispatch, where per-member numpy
        allocation would be the aggregate bottleneck."""
        g, slot = member._group, member.slot
        gw_ts, gw_seq, gw_side = g.wm_ts, g.wm_seq, g.wm_side
        n_cols = len(self.value_cols)
        right = side_i == _SIDE_RIGHT
        rows, lanes, ts_l = [], [], []
        planes = [[] for _ in range(n_cols)] if right else None
        cand: Dict[int, tuple] = {}     # candidate watermark per row
        lane_ct: Dict[int, int] = {}
        for i in idxs:
            _, skey, ts, sq, vals = items[i]
            k, ts, sqf, row = self._admit_tick(member, skey, ts, sq,
                                               vals, right)
            key = (ts, sqf, side_i)
            wm = cand.get(k)
            if wm is None:
                wm = (gw_ts[slot, k].item(), gw_seq[slot, k].item(),
                      gw_side[slot, k].item())
            if key < wm:
                raise LateTickError(
                    f"{member.name}/{member.series[k]!r}", ts, sqf,
                    side_i, wm)
            cand[k] = key
            if right:
                for c in range(n_cols):
                    planes[c].append(row[c])
            rows.append(k)
            lane = lane_ct.get(k, 0)
            lane_ct[k] = lane + 1
            lanes.append(lane)
            ts_l.append(ts)
        return dict(rows=rows, lanes=lanes, lane_ct=lane_ct, wm=cand,
                    ts=ts_l, planes=planes)

    def _emit_fields(self, keys) -> List[Tuple[str, str, int]]:
        """Flattened per-tick output fields ``(out_name, emit_key,
        col_index)`` for an emission-key set, cached — dict keys are
        rebuilt per tick, their NAMES are not."""
        cache_key = tuple(keys)
        fields = self._emit_cache.get(cache_key)
        if fields is None:
            fields = [(f"{col}_{key}", key, c)
                      for key in cache_key
                      for c, col in enumerate(self.value_cols)]
            self._emit_cache[cache_key] = fields
        return fields

    def _dispatch_group(self, g: _Group, side_i: int, recs, sg, results):
        """Gather the admitted sub-batches' ticks as compact arrays, run
        the bucket's step once (:meth:`_Group.step_ticks`: the scatter
        into the ``[S, K, Lb]`` batch, the step and the emission gather
        on the card), commit each admitted member's watermarks, and fan
        the emissions back out per tick.  Single-tick members (``sg``)
        are admitted here with ONE vectorized watermark check."""
        C = len(self.value_cols)
        max_rows = 1
        n_total = 0
        spans = []                     # (member, idxs, rec, pos0)
        slots_l: List[int] = []
        rows_l: List[int] = []
        lanes_l: List[int] = []
        ts_l: List[int] = []
        for member, idxs, rec in recs:
            m = max(rec["lane_ct"].values())
            if m > max_rows:
                max_rows = m
            spans.append((member, idxs, rec, n_total))
            n_total += len(idxs)
            slot = member.slot
            slots_l.extend([slot] * len(rec["rows"]))
            rows_l.extend(rec["rows"])
            lanes_l.extend(rec["lanes"])
            ts_l.extend(rec["ts"])
        sl = np.asarray(slots_l, np.int64)
        rw = np.asarray(rows_l, np.int64)
        ln = np.asarray(lanes_l, np.int64)
        tsv = np.asarray(ts_l, np.int64)

        # ---- singles: ONE vectorized admission over the [S, K]
        # watermark planes (key < wm, lexicographic on (ts, seq, side))
        s_members, s_idxs = [], []
        s_sl = s_rw = s_ts = s_sq = None
        s_planes = None
        if sg is not None and sg.idxs:
            s_sl = np.asarray(sg.slots, np.int64)
            s_rw = np.asarray(sg.rows, np.int64)
            s_ts = np.asarray(sg.ts, np.int64)
            s_sq = np.asarray(sg.sqf, np.float64)
            s_members, s_idxs = sg.members, sg.idxs
            wts = g.wm_ts[s_sl, s_rw]
            wsq = g.wm_seq[s_sl, s_rw]
            wsd = g.wm_side[s_sl, s_rw]
            late = (s_ts < wts) | (
                (s_ts == wts) & ((s_sq < wsq) |
                                 ((s_sq == wsq) & (side_i < wsd))))
            if side_i == _SIDE_RIGHT:
                s_planes = [np.asarray(p, np.float32)
                            for p in sg.planes]
            if late.any():
                for j in np.nonzero(late)[0]:
                    m = s_members[j]
                    results[s_idxs[j]] = LateTickError(
                        f"{m.name}/{m.series[int(s_rw[j])]!r}",
                        int(s_ts[j]), float(s_sq[j]), side_i,
                        (int(wts[j]), float(wsq[j]), int(wsd[j])))
                keep = np.nonzero(~late)[0]
                s_members = [s_members[j] for j in keep]
                s_idxs = [s_idxs[j] for j in keep]
                s_sl, s_rw = s_sl[keep], s_rw[keep]
                s_ts, s_sq = s_ts[keep], s_sq[keep]
                if s_planes is not None:
                    s_planes = [p[keep] for p in s_planes]
            if len(s_idxs):
                sl = np.concatenate([sl, s_sl])
                rw = np.concatenate([rw, s_rw])
                ln = np.concatenate([ln, np.zeros(len(s_idxs),
                                                  np.int64)])
                tsv = np.concatenate([tsv, s_ts])
        if not len(sl):          # every member of this bucket rejected
            return
        Lb = stream_mod._bucket(max_rows)

        if side_i == _SIDE_RIGHT:
            colv = np.empty((C, len(sl)), np.float32)
            for c in range(C):
                col = [v for _, _, rec, _ in spans
                       for v in rec["planes"][c]]
                colv[c, :n_total] = np.asarray(col, np.float32)
                if len(s_idxs):
                    colv[c, n_total:] = s_planes[c]
            got = g.step_ticks(True, Lb, sl, rw, ln, tsv, colv)
            # one column a field, then one bounded dict build per tick
            keys = g.cfg.emit_keys()
            flat = [(name, got[:, keys.index(key), c])
                    for name, key, c in self._emit_fields(keys)]
            for member, idxs, rec, pos0 in spans:
                self._commit(member, rec, len(idxs))
                for j, i in enumerate(idxs):
                    p = pos0 + j
                    results[i] = {name: arr[p] for name, arr in flat}
            for j, i in enumerate(s_idxs):
                p = n_total + j
                results[i] = {name: arr[p] for name, arr in flat}
        else:
            v_g, f_g, i_g = g.step_ticks(False, Lb, sl, rw, ln, tsv, None)
            flat = [(col, v_g[:, c])
                    for c, col in enumerate(self.value_cols)]
            flat += [(f"{col}_found", f_g[:, c])
                     for c, col in enumerate(self.value_cols)]
            for member, idxs, rec, pos0 in spans:
                self._commit(member, rec, len(idxs))
                for j, i in enumerate(idxs):
                    p = pos0 + j
                    out = {name: arr[p] for name, arr in flat}
                    out["right_row_idx"] = i_g[p]
                    results[i] = out
            for j, i in enumerate(s_idxs):
                p = n_total + j
                out = {name: arr[p] for name, arr in flat}
                out["right_row_idx"] = i_g[p]
                results[i] = out

        # singles commit: vectorized watermark advance + acked
        if len(s_idxs):
            g.wm_ts[s_sl, s_rw] = s_ts
            g.wm_seq[s_sl, s_rw] = s_sq
            g.wm_side[s_sl, s_rw] = side_i
            for m in s_members:
                m.acked += 1
            self.acked_total += len(s_idxs)

    def _commit(self, member: CohortMember, rec, n_ticks: int) -> None:
        g, slot = member._group, member.slot
        wm_ts, wm_seq, wm_side = g.wm_ts, g.wm_seq, g.wm_side
        for k, (t, sq, sd) in rec["wm"].items():
            wm_ts[slot, k] = t
            wm_seq[slot, k] = sq
            wm_side[slot, k] = sd
        member.acked += n_ticks
        self.acked_total += n_ticks

    # -- batched native dispatch ---------------------------------------

    def dispatch_block(self, kinds, members, series_ids, ts, seq=None,
                       values=None):
        """Dispatch a columnar tick BLOCK: parallel arrays instead of a
        per-tick item list, and (for the single-tick-per-(member,
        series) majority) ONE device program per side that scatters the
        whole block into the padded batch on device, steps, and gathers
        the emissions back compact (``state.cohort_block_push/
        query_executable``, one graph a side) — the host never builds
        or reads an ``[S, ...]`` array.

        ``kinds`` is ``'right'``/``'left'`` for a side-homogeneous
        block, or a per-tick array (booleans, True = left/query, or the
        side strings).  ``series_ids`` is one key applied to every tick
        or a per-tick sequence; ``ts`` int64 per tick; ``seq`` optional
        per-tick floats (NaN = no sequence number, NULLS FIRST);
        ``values`` maps every cohort value column to a float32 array
        (required when the block has data ticks).

        Returns ``(out, errors)``: ``out`` maps each emission field to
        a full-length column (rows of the other side, or rejected
        ticks, keep the fill value — NaN / False / -1), ``errors`` maps
        tick index to the exception that rejected it (late tick,
        unknown series, ...).  Everything else about the contract is
        :meth:`dispatch`'s, bitwise: ticks that need per-tick machinery
        — duplicate (member, series) ticks in one block (lane
        assignment and strict arrival order), spilled/tiered members,
        members of other shape buckets, or any mesh-sharded cohort —
        fall back to :meth:`dispatch` internally, in arrival order per
        member.  Single-tick members may legally reorder around each
        other (each member's own merged-stream order is the only
        contract), which is what lets a mixed block run as one push
        program plus one query program."""
        n = len(members)
        out: Dict[str, np.ndarray] = {}
        errors: Dict[int, Exception] = {}
        if n == 0:
            return out, errors
        ts = np.asarray(ts, np.int64)
        if ts.shape != (n,):
            raise ValueError(
                f"members and ts are parallel arrays: got {n} members "
                f"but ts of shape {ts.shape}")
        if isinstance(kinds, str):
            if kinds not in ("right", "left"):
                raise ValueError(f"kinds must be 'right' or 'left', "
                                 f"got {kinds!r}")
            is_left = np.full(n, kinds == "left")
        else:
            ka = np.asarray(kinds)
            is_left = (ka == "left") if ka.dtype.kind in "UO" \
                else ka.astype(bool)
            if is_left.shape != (n,):
                raise ValueError(
                    f"per-tick kinds must align with members: "
                    f"{is_left.shape} != ({n},)")
        skeys = None
        if isinstance(series_ids, (list, tuple, np.ndarray)):
            if len(series_ids) != n:
                raise ValueError(
                    f"per-tick series_ids must align with members: "
                    f"{len(series_ids)} != {n}")
            skeys = series_ids
        if seq is None:
            sq_arr = np.full(n, -np.inf)
        else:
            sq_arr = np.asarray(seq, np.float64)
            if sq_arr.shape != (n,):
                raise ValueError(
                    f"seq must align with members: {sq_arr.shape} != "
                    f"({n},)")
            sq_arr = np.where(np.isnan(sq_arr), -np.inf, sq_arr)
        colv_full = None
        if not is_left.all():
            if values is None:
                raise ValueError(
                    "block has data (right) ticks but no values")
            cols = []
            for col in self.value_cols:
                if col not in values:
                    raise ValueError(
                        f"push block is missing value column {col!r} "
                        f"(cohort columns: {self.value_cols})")
            for col in self.value_cols:
                v = np.asarray(values[col], np.float32)
                if v.shape != (n,):
                    raise ValueError(
                        f"values[{col!r}] must align with members: "
                        f"{v.shape} != ({n},)")
                cols.append(v)
            colv_full = (np.stack(cols) if cols
                         else np.zeros((0, n), np.float32))

        slow = np.zeros(n, bool)
        dead = np.zeros(n, bool)
        g0 = None
        sl = np.full(n, -1, np.int64)
        rw = np.zeros(n, np.int64)
        if self.mesh is not None or self.spill_dir is not None:
            # mesh-sharded batch builds are per-shard device-resident
            # already; tiered cohorts need fault-in/LRU bookkeeping —
            # both take the per-tick path wholesale
            slow[:] = True
            for i in range(n):
                if members[i].cohort is not self:
                    raise ValueError(
                        f"stream {members[i].name!r} belongs to a "
                        f"different cohort")
        else:
            for i in range(n):
                m = members[i]
                if m.cohort is not self:
                    raise ValueError(
                        f"stream {m.name!r} belongs to a different "
                        f"cohort")
                sk = skeys[i] if skeys is not None else series_ids
                k = m._row.get(sk)
                if k is None:
                    errors[i] = ValueError(
                        f"unknown series {sk!r} on stream {m.name!r}: "
                        f"a cohort stream's series set grows only "
                        f"through add_series")
                    dead[i] = True
                    continue
                rw[i] = k
                g = m._group
                if g is None:        # not resident (shouldn't happen
                    slow[i] = True   # without spill_dir; be safe)
                    continue
                if g0 is None:
                    g0 = g
                if g is not g0:      # other shape bucket
                    slow[i] = True
                    continue
                sl[i] = m.slot
            fastable = ~dead & ~slow & (sl >= 0)
            if fastable.any():
                # duplicate (member, series) ticks need lanes and
                # strict per-member arrival order: per-tick path
                kid = sl * np.int64(g0.bucket) + rw
                fi = np.nonzero(fastable)[0]
                _, inv, cnt = np.unique(kid[fi], return_inverse=True,
                                        return_counts=True)
                dup = cnt[inv] > 1
                if dup.any():
                    slow[fi[dup]] = True
                self._dispatch_block_fast(
                    np.nonzero(~dead & ~slow & (sl >= 0))[0], is_left,
                    members, sl, rw, ts, sq_arr, colv_full, g0, out,
                    errors, n)

        s_idx = np.nonzero(slow)[0]
        if len(s_idx):
            self.routes["fallback_ticks"] += len(s_idx)
            self._dispatch_block_slow(s_idx, is_left, members, skeys,
                                      series_ids, ts, seq, sq_arr,
                                      colv_full, out, errors, n)
        self._maybe_snapshot()
        return out, errors

    def _out_col(self, out, name, n):
        a = out.get(name)
        if a is None:
            if name == "right_row_idx":
                a = out[name] = np.full(n, -1, np.int32)
            elif name.endswith("_found"):
                a = out[name] = np.zeros(n, bool)
            else:
                a = out[name] = np.full(n, np.nan, np.float32)
        return a

    def _dispatch_block_fast(self, f_idx, is_left, members, sl, rw, ts,
                             sq_arr, colv_full, g0, out, errors, n):
        """The device block path for single-tick members of one bucket
        group: per side, ONE vectorized watermark admission (the
        singles rule) and ONE scatter+step+gather program: two copies to
        the card (the index rows, the values) and one back."""
        if not len(f_idx):
            return
        S, C = g0.capacity, len(self.value_cols)
        dev = self.device
        part = g0.parts[0]
        names = g0.cfg.state_names()
        for side_i in (_SIDE_RIGHT, _SIDE_LEFT):
            left = side_i == _SIDE_LEFT
            idx = f_idx[is_left[f_idx]] if left \
                else f_idx[~is_left[f_idx]]
            if not len(idx):
                continue
            isl, irw = sl[idx], rw[idx]
            its, isq = ts[idx], sq_arr[idx]
            wts = g0.wm_ts[isl, irw]
            wsq = g0.wm_seq[isl, irw]
            wsd = g0.wm_side[isl, irw]
            late = (its < wts) | ((its == wts) & (
                (isq < wsq) | ((isq == wsq) & (side_i < wsd))))
            if late.any():
                for j in np.nonzero(late)[0]:
                    i = int(idx[j])
                    m = members[i]
                    errors[i] = LateTickError(
                        f"{m.name}/{m.series[int(irw[j])]!r}",
                        int(its[j]), float(isq[j]), side_i,
                        (int(wts[j]), float(wsq[j]), int(wsd[j])))
                keep = ~late
                idx, isl, irw = idx[keep], isl[keep], irw[keep]
                its, isq = its[keep], isq[keep]
            nk = len(idx)
            if not nk:
                continue
            Nb = stream_mod._bucket(nk)
            # pad ticks go to the sink slot S (state.py's block programs)
            ix = np.zeros((3, Nb), np.int64)
            ix[0] = S
            ix[0, :nk] = isl
            ix[1, :nk] = irw
            ix[2] = TS_PAD
            ix[2, :nk] = its
            ix = torch.from_numpy(ix).to(dev)
            self.routes["block"] += 1
            if side_i == _SIDE_RIGHT:
                colp = np.full((C, Nb), np.nan, np.float32)
                if C:
                    colp[:, :nk] = colv_full[:, idx]
                exe = g0.executable("block_push", Nb)
                outs = exe(*(part[nm] for nm in names), ix[0], ix[1],
                           ix[2], torch.from_numpy(colp).to(dev))
                part.update(zip(names, outs[:len(names)]))
                keys = g0.cfg.emit_keys()
                if keys:
                    gath = outs[len(names)][:nk].cpu().numpy()
                    for name, key, c in self._emit_fields(keys):
                        self._out_col(out, name, n)[idx] = \
                            gath[:, keys.index(key), c]
            else:
                exe = g0.executable("block_query", Nb)
                new_nm, packed = exe(
                    *(part[nm] for nm in sst._QUERY_STATE), ix[0], ix[1])
                part["n_merged"] = new_nm
                v, f, ii = sst.unpack_answers(packed[:nk].cpu().numpy(), C)
                for c, col in enumerate(self.value_cols):
                    self._out_col(out, col, n)[idx] = v[:, c]
                    self._out_col(out, col + "_found", n)[idx] = f[:, c]
                self._out_col(out, "right_row_idx", n)[idx] = ii
            # commit-after-success: vectorized watermark advance
            g0.wm_ts[isl, irw] = its
            g0.wm_seq[isl, irw] = isq
            g0.wm_side[isl, irw] = side_i
            for i in idx:
                members[i].acked += 1
            self.acked_total += nk
            self.dispatches += 1
            self._dirty.add(g0.bucket)

    def _dispatch_block_slow(self, s_idx, is_left, members, skeys,
                             series_ids, ts, seq, sq_arr, colv_full,
                             out, errors, n):
        """Per-tick fallback for the block ticks the device path cannot
        take.  Ticks are regrouped into side-homogeneous runs with the
        executor's cross-member greedy rule (a tick lands in the
        earliest side-matching run at or after its member's last run —
        only each member's OWN order is a contract), then each run is
        one :meth:`dispatch`."""
        runs: List[list] = []            # [side_is_left, [tick idx]]
        last: Dict[int, int] = {}
        for i in s_idx:
            i = int(i)
            mid = id(members[i])
            want = bool(is_left[i])
            placed = -1
            for bi in range(last.get(mid, 0), len(runs)):
                if runs[bi][0] == want:
                    placed = bi
                    break
            if placed < 0:
                runs.append([want, [i]])
                placed = len(runs) - 1
            else:
                runs[placed][1].append(i)
            last[mid] = placed
        for want, lst in runs:
            items = []
            for i in lst:
                sk = skeys[i] if skeys is not None else series_ids
                sqi = None if seq is None else float(sq_arr[i])
                row = None
                if not want:
                    row = {col: colv_full[c, i]
                           for c, col in enumerate(self.value_cols)}
                items.append((members[i], sk, int(ts[i]), sqi, row))
            res = self.dispatch("left" if want else "right", items)
            for i, r in zip(lst, res):
                if isinstance(r, Exception):
                    errors[i] = r
                    continue
                for name, val in r.items():
                    self._out_col(out, name, n)[i] = val

    # -- tiered member-state spill -------------------------------------

    def _member_artifact(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name)[:40]
        h = hashlib.sha1(name.encode()).hexdigest()[:12]
        return os.path.join(self.spill_dir, f"member_{safe}_{h}")

    def spill(self, name: str) -> str:
        """Explicitly demote one resident member to the cold tier;
        returns the artifact path.  The LRU does this automatically
        past ``resident_budget``."""
        member = self._members[str(name)]
        if member._group is None:
            raise ValueError(f"stream {name!r} is not resident")
        return self._spill(member)

    def _spill(self, member: CohortMember) -> str:
        """Persist one member's slot rows (every state plane + its
        watermark rows) as a CRC'd ``kind="cohort_member"`` artifact
        and free the slot.  The artifact is the member's EXACT state:
        faulting it back in and ticking is bitwise the never-spilled
        run."""
        if not self.spill_dir:
            raise ValueError("StreamCohort has no spill_dir")
        t0 = time.perf_counter()
        g, slot = member._group, member.slot
        arrays = {f"s.{n}": a for n, a in g.slot_rows(slot).items()}
        arrays["wm_ts"] = np.ascontiguousarray(g.wm_ts[slot])
        arrays["wm_seq"] = np.ascontiguousarray(g.wm_seq[slot])
        arrays["wm_side"] = np.ascontiguousarray(g.wm_side[slot])
        meta = {"cohort_config": self._config_meta(),
                "name": member.name,
                "series_repr": [repr(s) for s in member.series],
                "acked": int(member.acked),
                "bucket": int(g.bucket)}
        path = self._member_artifact(member.name)
        ckpt.save_state(arrays, path, meta, kind="cohort_member")
        member._spill_bucket = g.bucket
        g.release(slot)
        member._group, member.slot = None, None
        self._spilled[member.name] = path
        self._lru.pop(member.name, None)
        self._resident -= 1
        self.spills += 1
        self.spill_s += time.perf_counter() - t0
        return path

    def _fault_in(self, member: CohortMember) -> None:
        """Promote a cold member into a slot.  With an artifact, its
        rows install bit-for-bit (the artifact stays on disk for any
        snapshot that references it); a never-ticked cold member just
        allocates — a fresh slot IS its state, no artifact needed.  A
        foreign, stale, or corrupt artifact is refused by name
        (CheckpointError), the member stays cold."""
        path = self._spilled.get(member.name)
        if path is None:
            bucket = int(member._spill_bucket
                         if member._spill_bucket is not None
                         else row_bucket(len(member.series)))
            self._group(bucket).alloc(member)
            member._spill_bucket = None
            self._resident += 1
            self._lru[member.name] = None
            return
        t0 = time.perf_counter()
        arrays, meta = ckpt.load_state(path, kind="cohort_member")
        if (meta.get("name") != member.name
                or meta.get("series_repr") != [repr(s)
                                               for s in member.series]
                or meta.get("cohort_config") != self._config_meta()):
            raise ckpt.CheckpointError(
                f"spilled member artifact {path!r} is FOREIGN to "
                f"stream {member.name!r} of this cohort (name / series "
                f"set / cohort config mismatch): refusing to install "
                f"it; delete the artifact to re-admit the stream with "
                f"fresh state")
        if int(meta["acked"]) != int(member.acked):
            # a spilled member's state is frozen, so artifact and
            # cursor agree by construction — disagreement means this
            # cohort resumed an OLD snapshot and the member re-spilled
            # NEWER state over the artifact since: installing it would
            # double-apply the replay tail
            raise ckpt.CheckpointError(
                f"spilled member artifact {path!r} holds stream "
                f"{member.name!r} at acked={meta['acked']} but this "
                f"cohort's cursor is {member.acked}: the artifact "
                f"outlived the snapshot this cohort resumed from — "
                f"resume from a newer snapshot")
        bucket = int(meta["bucket"])
        g = self._group(bucket)
        slot = g.alloc(member)
        g.set_slot(slot, {n: arrays[f"s.{n}"] for n in g.cfg.state_names()})
        g.wm_ts[slot] = np.asarray(arrays["wm_ts"], np.int64)
        g.wm_seq[slot] = np.asarray(arrays["wm_seq"], np.float64)
        g.wm_side[slot] = np.asarray(arrays["wm_side"], np.int8)
        member._spill_bucket = None
        # the artifact STAYS on disk: any cohort snapshot taken while
        # the member was spilled references it by name, and the
        # member's state was frozen from spill to now — the file is
        # exact for every one of those snapshots.  A later re-spill
        # overwrites it atomically.
        del self._spilled[member.name]
        self._resident += 1
        self._lru[member.name] = None
        self.restores += 1
        self.restore_s += time.perf_counter() - t0
        self._dirty.add(bucket)

    def _enforce_budget(self, protect: set) -> None:
        """Evict coldest-first until resident count fits the budget;
        members named in ``protect`` (this dispatch) are never
        evicted, so a dispatch touching more members than the budget
        temporarily exceeds it rather than thrash."""
        while self._resident > self.resident_budget:
            victim = next((n for n in self._lru if n not in protect),
                          None)
            if victim is None:
                return
            self._spill(self._members[victim])

    def _spilled_arrays(self, member: CohortMember):
        path = self._spilled.get(member.name)
        if path is None:
            return None
        arrays, _meta = ckpt.load_state(path, kind="cohort_member")
        return arrays

    @property
    def spill_stats(self) -> dict:
        """Tier occupancy and traffic counters, and the seconds spills
        and restores took."""
        return {"registered": len(self._members),
                "resident": self._resident,
                "spilled_artifacts": len(self._spilled),
                "spills": self.spills, "restores": self.restores,
                "spill_s": self.spill_s, "restore_s": self.restore_s}

    # -- warmup --------------------------------------------------------

    def warmup(self, max_rows: int, max_block: int = 0) -> int:
        """Pre-build (on a card, capture) every bucket group's push/query
        steps for the padded-batch ladder up to ``max_rows`` — a fresh
        process reaches the steady state, which builds nothing, before
        traffic.  With
        ``max_block`` set, also build the :meth:`dispatch_block` device
        programs for the pow2 block-size ladder up to ``max_block``
        (meshless cohorts only — a meshed cohort block-routes to the
        per-tick path, whose shapes the first ladder covers)."""
        shapes = []
        b = stream_mod._bucket(1)
        while True:
            shapes.append(b)
            if b >= max_rows:
                break
            b *= 2
        for g in self._groups.values():
            for Lb in shapes:
                g.executable("push", Lb)
                g.executable("query", Lb)
        built = len(shapes) * len(self._groups)
        if max_block and self.mesh is None:
            blocks = []
            b = stream_mod._bucket(1)
            while True:
                blocks.append(b)
                if b >= max_block:
                    break
                b *= 2
            for g in self._groups.values():
                for Nb in blocks:
                    g.executable("block_push", Nb)
                    g.executable("block_query", Nb)
            built += len(blocks) * len(self._groups)
        return built

    # -- durability ----------------------------------------------------

    def _config_meta(self) -> dict:
        return {
            "value_cols": self.value_cols,
            "skip_nulls": self.skip_nulls,
            "max_lookback": self.max_lookback,
            "window_ns": self.window_ns,
            "rows_bound": self.rows_bound,
            "ema_alpha": self.ema_alpha,
        }

    def _snapshot_arrays(self, buckets) -> Tuple[dict, list]:
        """``(arrays, groups_meta)`` for the given bucket set: every
        state plane + the watermark planes, prefixed ``g<bucket>.``."""
        arrays = {}
        groups_meta = []
        for bucket in sorted(buckets):
            g = self._groups[bucket]
            for name, arr in g.host_state().items():
                arrays[f"g{bucket}.{name}"] = arr
            arrays[f"g{bucket}.wm_ts"] = g.wm_ts
            arrays[f"g{bucket}.wm_seq"] = g.wm_seq
            arrays[f"g{bucket}.wm_side"] = g.wm_side
            groups_meta.append({"bucket": bucket,
                                "capacity": g.capacity})
        return arrays, groups_meta

    def snapshot(self, differential: bool = False) -> str:
        """CRC'd atomic cohort artifact (kind="cohort_state"), step
        number = total events acked.

        ``differential=False`` (default): every bucket group's stacked
        state + watermark planes — the standalone artifact.

        ``differential=True``: ONLY the bucket groups dirty since the
        previous snapshot (any kind), chained to it by the
        predecessor's manifest CRC-32 recorded in this manifest — so
        fleet-scale checkpoint cost is O(changed state), and a broken
        link is detected at resume, never silently skipped.  Member
        slot assignments and acked cursors (small) ride every
        manifest, so membership is exact at each link.  Falls back to
        a full snapshot when there is no predecessor in this process.
        Retention keeps every link of the last ``keep_last`` full
        snapshots' chains."""
        if not self.checkpoint_dir:
            raise ValueError("StreamCohort has no checkpoint_dir")
        if self._last_snapshot is not None and os.path.basename(
                self._last_snapshot) == f"step_{self.acked_total:010d}":
            if not self._dirty:
                # nothing acked AND nothing structurally dirty
                # (membership/capacity changes mark their bucket):
                # the artifact on disk is already exact
                return self._last_snapshot
            # same step number but changed state: the artifact must be
            # REWRITTEN in place — as a standalone full (a diff would
            # record its predecessor's manifest CRC and then replace
            # that very predecessor, breaking its own chain link)
            differential = False
        differential = differential and self._last_snapshot is not None
        buckets = (sorted(b for b in self._dirty if b in self._groups)
                   if differential else sorted(self._groups))
        arrays, groups_meta = self._snapshot_arrays(buckets)
        members_meta = []
        for m in self._members.values():
            mm = {"name": m.name, "series": list(m.series),
                  "acked": m.acked}
            if m._group is not None:
                mm["bucket"] = m._group.bucket
                mm["slot"] = m.slot
            else:
                # cold member: no slot; its artifact (if any — a
                # never-ticked member has none) is referenced by name
                # so resume reattaches the SAME spilled state
                mm["bucket"] = m._spill_bucket
                mm["slot"] = None
                mm["spilled"] = True
                ap = self._spilled.get(m.name)
                if ap is not None:
                    mm["artifact"] = os.path.basename(ap)
            members_meta.append(mm)
        meta = {"cohort_config": self._config_meta(),
                "groups": groups_meta, "members": members_meta,
                "acked_total": self.acked_total}
        if differential:
            prev = self._last_snapshot
            meta["snapshot"] = {
                "mode": "differential",
                "prev": os.path.basename(prev),
                "prev_manifest_crc": ckpt.file_crc(
                    os.path.join(self._resolved_dir(prev),
                                 "manifest.json")),
                "base": os.path.basename(self._last_full),
            }
        else:
            meta["snapshot"] = {"mode": "full"}
        path = os.path.join(self.checkpoint_dir,
                            f"step_{self.acked_total:010d}")
        resilience.retrying(resilience.DEFAULT_IO_POLICY,
                            label="cohort-snapshot")(ckpt.save_state)(
            arrays, path, meta, kind="cohort_state")
        self._last_snapshot = path
        if differential:
            self._diffs_since_full += 1
        else:
            self._last_full = path
            self._diffs_since_full = 0
        self._dirty.clear()
        self._prune_chain()
        return path

    @staticmethod
    def _resolved_dir(path: str) -> str:
        """The directory a load would actually read: ``path``, or its
        ``.bak`` survivor after a crash mid-swap (load_state's rule)."""
        if not os.path.exists(os.path.join(path, "manifest.json")) \
                and os.path.exists(os.path.join(path + ".bak",
                                                "manifest.json")):
            return path + ".bak"
        return path

    @staticmethod
    def _snapshot_mode(path: str) -> dict:
        man = ckpt._manifest(path)
        return (man.get("meta") or {}).get("snapshot") \
            or {"mode": "full"}

    def _prune_chain(self) -> None:
        """Chain-aware retention: keep the last ``keep_last`` FULL
        snapshots and every differential link newer than the oldest
        kept full — a plain keep-last-K would sever a live chain from
        its base.  Pre-chain snapshots (no ``snapshot`` meta) count as
        full, so all-full histories degrade to exactly the old
        keep-last-K behaviour."""
        steps = ckpt.list_steps(self.checkpoint_dir)   # newest first
        fulls = 0
        cut = None
        for step, path in steps:
            try:
                mode = self._snapshot_mode(
                    self._resolved_dir(path))["mode"]
            except ckpt.CheckpointError:
                continue            # unreadable: neither full nor kept
            if mode != "differential":
                fulls += 1
                if fulls >= max(1, self.keep_last):
                    cut = step
                    break
        if cut is None:
            return
        for step, path in steps:
            if step < cut:
                logger.info("pruning old cohort snapshot %s "
                            "(keep_last=%d fulls)", path, self.keep_last)
                shutil.rmtree(path, ignore_errors=True)
                shutil.rmtree(path + ".bak", ignore_errors=True)

    def _maybe_snapshot(self) -> None:
        if self._next_ckpt is not None and self.checkpoint_dir \
                and self.acked_total >= self._next_ckpt:
            diff = (self.diff_snapshots
                    and self._last_snapshot is not None
                    and self._diffs_since_full < self.full_every - 1)
            self.snapshot(differential=diff)
            self._next_ckpt = self.acked_total + self.ckpt_every

    # -- failover ------------------------------------------------------

    @classmethod
    def _resolve_chain(cls, checkpoint_dir: str, verify: bool = True):
        """Newest intact snapshot chain under ``checkpoint_dir``, as
        ``[(arrays, meta), ...]`` base-full first.  A differential head
        is walked back link by link — each link's recorded predecessor
        manifest CRC must match the predecessor on disk — down to its
        full base; ANY broken/corrupt/missing link disqualifies the
        whole head and the next-older candidate is tried (the
        fall-back-to-older discipline of ``checkpoint.latest``)."""
        candidates = ckpt.list_steps(checkpoint_dir)
        last_err: Optional[str] = None
        for _, head in candidates:
            entries = []
            path = head
            try:
                while True:
                    resolved = cls._resolved_dir(path)
                    ckpt.verify_checkpoint(resolved,
                                           verify_arrays=verify)
                    arrays, meta = ckpt.load_state(
                        resolved, verify=verify, kind="cohort_state")
                    snap = meta.get("snapshot") or {"mode": "full"}
                    entries.append((arrays, meta))
                    if snap["mode"] != "differential":
                        return list(reversed(entries))
                    prev = os.path.join(checkpoint_dir, snap["prev"])
                    prev_resolved = cls._resolved_dir(prev)
                    got = ckpt.file_crc(
                        os.path.join(prev_resolved, "manifest.json"))
                    if got != int(snap["prev_manifest_crc"]):
                        raise ckpt.CheckpointError(
                            f"differential chain broken at "
                            f"{path!r}: predecessor {snap['prev']!r} "
                            f"manifest crc32 {got} != recorded "
                            f"{snap['prev_manifest_crc']}")
                    path = prev
            except (ckpt.CheckpointError, OSError) as e:
                last_err = f"{head}: {e}"
                logger.warning(
                    "cohort snapshot chain headed at %s unusable (%s); "
                    "trying an older head", head, e)
        raise ckpt.CheckpointError(
            f"no intact cohort snapshot chain under "
            f"{checkpoint_dir!r}"
            + (f" (last failure: {last_err})" if last_err else ""))

    def _install_link(self, arrays: dict, meta: dict, mesh,
                      stream_axis: str) -> None:
        """Apply one chain link: replace/create every bucket group it
        carries (full arrays per carried bucket), then rebuild the
        whole membership from its manifest (membership is exact at
        every link)."""
        for gm in meta["groups"]:
            bucket, cap = int(gm["bucket"]), int(gm["capacity"])
            if mesh is not None:
                n_axis = int(mesh.shape[stream_axis])
                if cap % n_axis:
                    raise ckpt.CheckpointError(
                        f"cohort snapshot group bucket={bucket} has "
                        f"capacity {cap}, not divisible by the mesh's "
                        f"{stream_axis!r} axis ({n_axis}): resume onto "
                        f"a mesh whose stream axis divides it")
            cfg = self._member_cfg(bucket)
            g = _Group(self, bucket, cap, {
                name: arrays[f"g{bucket}.{name}"]
                for name in cfg.state_names()})
            g.wm_ts = np.asarray(arrays[f"g{bucket}.wm_ts"], np.int64)
            g.wm_seq = np.asarray(arrays[f"g{bucket}.wm_seq"],
                                  np.float64)
            g.wm_side = np.asarray(arrays[f"g{bucket}.wm_side"], np.int8)
            self._groups[bucket] = g
        self._members.clear()
        self._spilled.clear()
        for g in self._groups.values():
            g.members = [None] * g.capacity
        for mm in meta["members"]:
            member = CohortMember(self, mm["name"], mm["series"])
            member.acked = int(mm["acked"])
            self._members[member.name] = member
            if mm.get("spilled"):
                member._spill_bucket = (None if mm["bucket"] is None
                                        else int(mm["bucket"]))
                art = mm.get("artifact")
                if art is not None:
                    if not self.spill_dir:
                        raise ckpt.CheckpointError(
                            f"cohort snapshot records stream "
                            f"{member.name!r} spilled to artifact "
                            f"{art!r} but this cohort has no "
                            f"spill_dir: resume with the original "
                            f"spill_dir, or that member's state is "
                            f"unreachable")
                    self._spilled[member.name] = os.path.join(
                        self.spill_dir, art)
                continue
            g = self._groups[int(mm["bucket"])]
            slot = int(mm["slot"])
            g.members[slot] = member
            member._group, member.slot = g, slot
        for g in self._groups.values():
            g._free = [i for i in range(g.capacity - 1, -1, -1)
                       if g.members[i] is None]
        self._resident = sum(1 for m in self._members.values()
                             if m._group is not None)
        self._lru = {m.name: None for m in self._members.values()
                     if m._group is not None}
        self.acked_total = int(meta["acked_total"])

    @classmethod
    def resume(cls, checkpoint_dir: str, verify: bool = True,
               mesh=None, stream_axis: str = "streams",
               **overrides) -> "StreamCohort":
        """Restore the newest intact cohort snapshot — a standalone
        full artifact, or a differential chain replayed base-first
        (each link CRC-verified against its predecessor).  The
        returned cohort's per-stream ``acked`` dict tells the caller
        where each stream's event source restarts — replay every
        stream's tail after its own cursor and the output is
        byte-identical to a run that never died."""
        chain = cls._resolve_chain(checkpoint_dir, verify=verify)
        scfg = chain[-1][1]["cohort_config"]
        cohort = cls(
            scfg["value_cols"], skip_nulls=scfg["skip_nulls"],
            max_lookback=scfg["max_lookback"], window_secs=None,
            window_rows_bound=scfg["rows_bound"],
            ema_alpha=scfg["ema_alpha"], mesh=mesh,
            stream_axis=stream_axis,
            checkpoint_dir=overrides.pop("checkpoint_dir",
                                         checkpoint_dir),
            **overrides)
        # reconstruct the exact folded integer width (window_secs
        # would re-floor; the snapshot already holds the int)
        cohort.window_ns = scfg["window_ns"]
        for arrays, meta in chain:
            cohort._install_link(arrays, meta, mesh, stream_axis)
        # the resumed process continues the SAME chain: its first
        # differential snapshot links to the restored head
        head = os.path.join(checkpoint_dir,
                            f"step_{cohort.acked_total:010d}")
        base_meta = chain[0][1]
        cohort._last_snapshot = head
        cohort._last_full = os.path.join(
            checkpoint_dir, f"step_{int(base_meta['acked_total']):010d}")
        cohort._diffs_since_full = len(chain) - 1
        cohort._dirty.clear()
        if cohort.ckpt_every:
            cohort._next_ckpt = cohort.acked_total + cohort.ckpt_every
        return cohort
