"""Chunked, out-of-core Parquet ingest onto a port mesh.

Counterpart of ``tempo_tpu/io/ingest.py``.  A Parquet dataset is packed
straight into a series-sharded :class:`~tempo_tpu_torch.dist.
DistributedTSDF` with bounded host memory:

* **pass 1** streams only the (partition cols, ts) columns to build the
  key census: per-key row counts, the padded series length L, and a
  deterministic key order (lexicographic, independent of the file
  layout).
* **pass 2** takes one series shard at a time: it streams the row
  batches of that shard's keys (predicate pushdown prunes row groups of
  a dataset written sort-clustered by ``io.writer``), sorts and packs
  each numeric column to ``[K_shard, L]`` (``packing``: the native
  engine unless ``TEMPO_TPU_NATIVE=0``), and uploads the shard's planes
  to its device with one host-to-device copy (``dist._upload_planes``;
  on a mesh with a time axis, one copy a ``[K_shard, L/n_t]`` block to
  each device of the series group), the way
  ``DistributedTSDF.from_tsdf`` builds its shards.  No host holds
  more than one shard (plus one streaming batch).

``budget_bytes`` bounds the host working set: ingest fails loudly
rather than growing past it.

Transactional ingest:

* **per-shard progress manifests**: with ``resume_dir`` the key census
  and every completed shard's packed host blocks are persisted (CRC'd,
  atomic) as they finish, and a restarted ingest re-streams only the
  shards that never committed.  A resume directory stamped by another
  (dataset, schema, mesh) ingest is refused by name
  (:class:`~tempo_tpu_torch.resilience.CheckpointError`);
* **row-group quarantine**: a corrupt row group (or a torn file) is
  quarantined and either reported in one :class:`CorruptRowGroupError`
  listing every range (``on_corrupt="raise"``, the default) or skipped
  with a warning and recorded on the frame (``on_corrupt="quarantine"``);
* **one end-to-end deadline**: ``deadline_s`` (default
  ``TEMPO_TPU_INGEST_DEADLINE_S``) across validation, census, every
  shard stream and the uploads, dying with a stage-named
  :class:`~tempo_tpu_torch.resilience.DeadlineExceeded`;
* **per-file circuit breaker**: ``breaker`` quarantines a flapping file
  after ``TEMPO_TPU_BREAKER_THRESHOLD`` consecutive failures.

Non-numeric columns are skipped with a log notice; sequence columns are
not supported here.  A mesh with a time axis takes the reference's
geometry (K a multiple of every axis, L of 8 times the time axis).
One process only, as the reference's: its ``from_parquet`` places
every shard from one host (``device_put`` on every device of the mesh,
then ``make_array_from_single_device_arrays``), which no process of
several can do, so a ``torch.distributed`` run of several processes
raises ``NotImplementedError``.  Several processes pack their own
series instead (``parallel.multihost.process_series_range``,
``shard_series_global``).

Slab pipelining (``TEMPO_TPU_INGEST_RING``, default 2; the port has no
tuner): the shard loop, and any out-of-core sweep built on
:func:`sweep_slabs`, runs as a bounded-ring three-stage pipeline: the
load of slab N+1 (a producer thread) and the drain of slab N-1 (a
collector thread) overlap the compute of slab N (the calling thread).
Slabs are consumed strictly in order, so every depth gives the bits of
the serial loop; ``ring <= 1`` runs serially.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import config, packing, resilience
from tempo_tpu_torch.resilience import CheckpointError, FailureKind

logger = logging.getLogger(__name__)

_RESUME_FORMAT = 1


class CorruptRowGroupError(RuntimeError):
    """Parquet data corruption found during ingest, with every
    quarantined range listed: ``ranges`` is a tuple of dicts
    ``{"file", "row_group", "rows", "reason"}`` (``row_group`` None =
    the whole file is unreadable).  Self-describes as
    ``CORRUPTED_ARTIFACT`` for :func:`tempo_tpu_torch.resilience.classify`:
    re-reading corrupt bytes is never the recovery."""

    failure_kind = FailureKind.CORRUPTED_ARTIFACT

    def __init__(self, message: str, ranges: Sequence[dict] = ()):
        super().__init__(message)
        self.ranges = tuple(ranges)


@dataclasses.dataclass
class _IngestCtx:
    """Fault-domain state threaded through both streaming passes: the
    one end-to-end deadline, the per-file circuit breaker, and the
    quarantine ledger (frozen across passes — a range quarantined
    during the census stays skipped in the shard pass, so the packed
    layout can never see rows the census did not count)."""

    deadline: Optional[resilience.Deadline] = None
    breaker: Optional[resilience.CircuitBreaker] = None
    on_corrupt: str = "raise"
    quarantined: List[dict] = dataclasses.field(default_factory=list)
    skip: set = dataclasses.field(default_factory=set)

    def check(self, stage: str) -> None:
        if self.deadline is not None:
            self.deadline.check(stage)

    def quarantine(self, path: str, row_group: Optional[int],
                   rows: Optional[int], reason: str) -> None:
        key = (path, row_group)
        if key in self.skip:
            return
        self.skip.add(key)
        self.quarantined.append({
            "file": path, "row_group": row_group, "rows": rows,
            "reason": reason,
        })
        logger.warning(
            "from_parquet: quarantined %s%s (%s)", path,
            "" if row_group is None else f" row group {row_group}",
            reason)

    def ledger_crc(self) -> int:
        """CRC-32 of the current quarantine ledger's key set — stamped
        into every committed shard manifest, so a resume can tell a
        shard packed under a DIFFERENT ledger (rows included that are
        now quarantined, or vice versa) from a current one."""
        import zlib

        # key=repr: the skip set mixes int and None row-group slots,
        # which plain tuple comparison cannot order
        return zlib.crc32(
            repr(sorted(self.skip, key=repr)).encode()) & 0xFFFFFFFF

    def raise_if_corrupt(self) -> None:
        """``on_corrupt="raise"``: surface ONE named error listing
        every quarantined range instead of an opaque mid-stream
        abort."""
        if self.on_corrupt == "raise" and self.quarantined:
            lst = "; ".join(
                f"{q['file']}"
                + ("" if q["row_group"] is None
                   else f"[rg {q['row_group']}]")
                + f": {q['reason']}" for q in self.quarantined)
            raise CorruptRowGroupError(
                f"from_parquet: {len(self.quarantined)} corrupt/"
                f"unreadable range(s) quarantined — {lst}.  Pass "
                f"on_corrupt='quarantine' to ingest around them "
                f"(the skipped ranges are recorded on the frame).",
                ranges=self.quarantined)


def _dataset(path: str, ctx: Optional[_IngestCtx] = None):
    import pyarrow.dataset as pads

    try:
        return pads.dataset(path, partitioning="hive")
    except (OSError, ValueError) as e:
        # discovery itself reads footers: a torn-write file (footer
        # magic gone) fails the whole dataset open before any
        # row-group quarantine can act.  Re-discover excluding
        # unreadable files and quarantine exactly the excluded set.
        if ctx is None or resilience.classify(e) is FailureKind.TRANSIENT_IO:
            raise
        ds = pads.dataset(path, partitioning="hive",
                          exclude_invalid_files=True)
        present = set(getattr(ds, "files", ()) or ())
        if present:
            on_disk = []
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if not f.startswith(("_", ".")):
                        on_disk.append(os.path.join(root, f))
            for missing in sorted(set(on_disk) - present):
                ctx.quarantine(
                    missing, None, None,
                    f"unreadable file (torn write? footer does not "
                    f"parse): excluded at dataset discovery ({e})")
        if not ctx.quarantined:
            raise       # discovery failed for a reason we cannot name
        return ds


def _validate_dataset(ds, path: str, ts_col: str,
                      partition_cols: List[str]) -> None:
    """Fail fast, naming the offending column, instead of surfacing a
    downstream shape/KeyError after two streaming passes."""
    names = set(ds.schema.names)
    missing = [c for c in [ts_col, *partition_cols] if c not in names]
    if missing:
        raise ValueError(
            f"from_parquet: dataset at {path!r} has no column(s) "
            f"{', '.join(repr(c) for c in missing)}; schema columns are "
            f"{sorted(names)}"
        )
    try:
        n_rows = ds.count_rows()
    except (OSError, ValueError) as e:
        # metadata of some file is unreadable (torn footer): the
        # census pass quarantines it range-by-range; the empty check
        # just cannot run early
        logger.warning(
            "from_parquet: count_rows failed (%s); deferring the "
            "empty-dataset check to the census pass", e)
        return
    if n_rows == 0:
        raise ValueError(
            f"from_parquet: dataset at {path!r} is empty (0 rows) — "
            "nothing to pack"
        )


def _scan_fragment(frag, schema, columns, filt, batch_rows):
    """One scanner over one (row-group) fragment — module-level so the
    fault injectors and the flapping-file chaos phases can patch it."""
    import pyarrow.dataset as pads

    return pads.Scanner.from_fragment(
        frag, schema=schema, columns=columns, filter=filt,
        batch_size=batch_rows,
    ).to_batches()


def _iter_batches(ds, columns, filt, batch_rows, ctx: _IngestCtx,
                  stage: str):
    """Stream record batches row-group by row-group with the
    fault-domain contracts applied: the deadline is checked per batch
    (stage-named), transient IO errors re-raise (the pass-level retry
    wrapper owns them) after feeding the per-file breaker, an OPEN
    breaker quarantines the file instead of burning further attempts,
    and non-transient read failures quarantine exactly the corrupt
    row group (or the whole file when its footer is unreadable)."""
    ctx.check(stage)
    for frag in ds.get_fragments():
        path = getattr(frag, "path", "<fragment>")
        if (path, None) in ctx.skip:
            continue
        if ctx.breaker is not None:
            try:
                ctx.breaker.allow(path, label="ingest file")
            except resilience.QuarantinedError as e:
                ctx.quarantine(
                    path, None, None,
                    f"circuit breaker open after repeated failures "
                    f"({e})")
                continue
        try:
            rg_frags = list(frag.split_by_row_group())
        except (OSError, ValueError) as e:
            kind = resilience.classify(e)
            if kind is FailureKind.DEADLINE:
                raise           # a dead budget is never "corruption"
            if kind is FailureKind.TRANSIENT_IO:
                if ctx.breaker is not None:
                    ctx.breaker.record(path, False)
                raise
            ctx.quarantine(path, None, None,
                           f"unreadable file metadata: {e}")
            continue
        file_ok = True
        for rg in rg_frags:
            rg_id = rg.row_groups[0].id if rg.row_groups else None
            if (path, rg_id) in ctx.skip:
                continue
            try:
                for batch in _scan_fragment(rg, ds.schema, columns,
                                            filt, batch_rows):
                    ctx.check(stage)
                    yield batch
            except (OSError, ValueError) as e:
                kind = resilience.classify(e)
                if kind is FailureKind.DEADLINE:
                    # the per-batch ctx.check fired inside this try
                    # (DeadlineExceeded IS an OSError via TimeoutError)
                    # — quarantining readable data as corrupt because
                    # the BUDGET died would be silent data loss
                    raise
                if kind is FailureKind.TRANSIENT_IO:
                    file_ok = False
                    if ctx.breaker is not None:
                        ctx.breaker.record(path, False)
                    raise
                rows = rg.row_groups[0].num_rows if rg.row_groups \
                    else None
                ctx.quarantine(path, rg_id, rows,
                               f"corrupt row group: {e}")
        if file_ok and ctx.breaker is not None:
            ctx.breaker.record(path, True)


def _census(ds, ts_col: str, partition_cols: List[str], batch_rows: int,
            ctx: Optional[_IngestCtx] = None):
    """Pass 1: per-key row counts + global max series length."""
    ctx = ctx or _IngestCtx()
    counts: Dict[Tuple, int] = {}
    for batch in _iter_batches(ds, partition_cols + [ts_col], None,
                               batch_rows, ctx, stage="census"):
        if batch.num_rows == 0:
            continue
        dfb = batch.to_pandas()
        if partition_cols:
            grp = dfb.groupby(partition_cols, sort=False, dropna=False).size()
            for key, n in grp.items():
                key = key if isinstance(key, tuple) else (key,)
                counts[key] = counts.get(key, 0) + int(n)
        else:
            counts[()] = counts.get((), 0) + len(dfb)
    if not counts:
        counts[tuple([None] * len(partition_cols))] = 0
    keys = sorted(counts, key=lambda t: tuple(str(v) for v in t))
    key_frame = pd.DataFrame(
        [list(k) for k in keys] if partition_cols else None,
        columns=partition_cols or None,
        index=range(len(keys)),
    )
    lengths = np.asarray([counts[k] for k in keys], dtype=np.int64)
    return key_frame, lengths


def _numeric_schema_cols(ds, ts_col: str, partition_cols: List[str],
                         columns: Optional[List[str]]):
    import pyarrow as pa

    skip = {ts_col, *partition_cols, "event_dt", "event_time"}
    out = []
    for field in ds.schema:
        if field.name in skip:
            continue
        if columns is not None and field.name not in columns:
            continue
        if (pa.types.is_integer(field.type) or pa.types.is_floating(field.type)):
            out.append(field.name)
        else:
            logger.info(
                "out-of-core ingest skips non-numeric column %r", field.name
            )
    return out


def from_parquet(
    path: str,
    ts_col: str = "event_ts",
    partition_cols: Optional[List[str]] = None,
    mesh=None,
    time_axis: Optional[str] = None,
    series_axis: str = "series",
    columns: Optional[List[str]] = None,
    batch_rows: int = 1 << 18,
    budget_bytes: Optional[int] = None,
    halo_fraction: float = 0.5,
    retry_policy: Optional["resilience.RetryPolicy"] = None,
    deadline_s=None,
    resume_dir: Optional[str] = None,
    on_corrupt: str = "raise",
    breaker: Optional["resilience.CircuitBreaker"] = None,
    ring: Optional[int] = None,
):
    """Stream a Parquet dataset (or a store table's directory) into a
    :class:`DistributedTSDF` on the port ``mesh`` (default
    ``parallel.make_mesh()``: every CUDA card) with bounded host memory
    (see the module docstring).

    Both streaming passes are read-only, so transient IO faults are
    retried a pass at a time under ``retry_policy`` (default
    :data:`tempo_tpu_torch.resilience.DEFAULT_IO_POLICY`); budget and
    schema errors are permanent and surface at once.

    ``deadline_s`` (one stage-named wall-clock budget; default
    ``TEMPO_TPU_INGEST_DEADLINE_S``; a live
    :class:`~tempo_tpu_torch.resilience.Deadline` is accepted too),
    ``resume_dir`` (per-shard CRC'd progress manifests: a killed ingest
    restarted with the same directory re-streams only uncommitted
    shards), ``on_corrupt`` (``"raise"``: one :class:`CorruptRowGroupError`
    listing every quarantined range; ``"quarantine"``: skip them and
    record them on ``frame.ingest_quarantined``) and ``breaker`` (a
    per-file circuit breaker) are the fault-domain parameters.

    ``ring`` (default ``TEMPO_TPU_INGEST_RING``) is the slab-buffer ring
    depth of the shard pipeline (:func:`sweep_slabs`): a producer thread
    streams and packs shard N+1 while the calling thread uploads shard N
    and commits its manifest in shard order; every depth gives the same
    bits.  ``halo_fraction`` sizes the time axis's halo
    (``withRangeStats(strategy="halo")``) and is stored on the frame."""
    from tempo_tpu_torch import device as device_policy
    from tempo_tpu_torch import dist as dist_mod
    from tempo_tpu_torch.dist import DistCol, DistributedTSDF
    from tempo_tpu_torch.parallel.mesh import make_mesh
    from tempo_tpu_torch.store.engine import resolve_dataset_path

    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(
            f"on_corrupt must be 'raise' or 'quarantine', got "
            f"{on_corrupt!r}")
    # a store table directory resolves to its committed generation; a
    # torn pointer or commit refuses by name before any streaming pass
    path = resolve_dataset_path(path)
    pcols = list(partition_cols or [])
    mesh = mesh if mesh is not None else make_mesh()
    if series_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis named {series_axis!r}")
    from tempo_tpu_torch.parallel.mesh import process_count

    if process_count() > 1:
        raise NotImplementedError(
            f"from_parquet across {process_count()} processes: the JAX "
            f"package has no such path either (its from_parquet places "
            f"every shard from one host); ingest in one process, or pack "
            f"each process's series with parallel.multihost."
            f"process_series_range and shard_series_global")
    n_t = dist_mod._time_axis_size(mesh, time_axis)
    n_s = mesh.shape[series_axis]
    # one device a (series shard, time block), series-major
    devs = mesh.axis_devices((series_axis, time_axis) if time_axis
                             else series_axis)

    if deadline_s is None:
        deadline_s = config.get_float("TEMPO_TPU_INGEST_DEADLINE_S")
    ctx = _IngestCtx(
        deadline=resilience.Deadline.after(deadline_s),
        breaker=breaker, on_corrupt=on_corrupt,
    )
    retry = resilience.retrying(
        retry_policy or resilience.DEFAULT_IO_POLICY, label="parquet-ingest")
    ctx.check("dataset open")
    ds = retry(_dataset)(path, ctx)
    ctx.raise_if_corrupt()
    ctx.check("validation")
    _validate_dataset(ds, path, ts_col, pcols)

    resume = None
    if resume_dir is not None:
        resume = _ResumeLog(resume_dir, _resume_signature(
            path, ts_col, pcols, columns, mesh, series_axis, time_axis))
        resume.open(ctx)
    cached = resume.load_census() if resume is not None else None
    if cached is not None:
        key_frame, lengths = cached
        # the frozen quarantine ledger travels with the census: pass 2
        # of a resumed run skips exactly what pass 1 skipped
        for q in resume.census_quarantine():
            ctx.quarantine(q["file"], q.get("row_group"), q.get("rows"),
                           q["reason"])
        ctx.raise_if_corrupt()
        logger.info(
            "from_parquet: census restored from %s (%d keys, no "
            "Parquet re-read)", resume_dir, len(lengths))
    else:
        key_frame, lengths = retry(_census)(ds, ts_col, pcols,
                                            batch_rows, ctx)
        ctx.raise_if_corrupt()
        if int(lengths.sum()) == 0:
            raise ValueError(
                f"from_parquet: dataset at {path!r} is empty"
                + (f" after quarantining {len(ctx.quarantined)} "
                   f"range(s)" if ctx.quarantined else " (0 rows)")
                + " — nothing to pack")
        if resume is not None:
            resume.save_census(key_frame, lengths, ctx)
    K = len(lengths)
    k_mult = n_s * n_t
    K_dev = max(1, -(-K // k_mult)) * k_mult
    L = packing.pad_length(int(lengths.max(initial=0)), multiple=8 * n_t)
    Lt = L // n_t
    num_cols = _numeric_schema_cols(ds, ts_col, pcols, columns)

    blk = K_dev // n_s
    tdtype = device_policy.compute_dtype(devs[0])
    dt = np.float32 if tdtype == torch.float32 else np.float64
    shard_bytes = blk * L * max(np.dtype(dt).itemsize, 8)
    if budget_bytes is not None and shard_bytes > budget_bytes:
        raise MemoryError(
            f"one series shard needs {shard_bytes} host bytes "
            f"({blk} series x {L} slots) > budget {budget_bytes}; use a "
            "mesh with more series shards")

    import pyarrow.compute as pc

    read_cols = pcols + [ts_col] + num_cols
    plane_names = ["__ts__", "__mask__"] + [n for c in num_cols
                                            for n in (c, c + "/valid")]

    def run_shard_pass(use_manifests: bool):
        shards: List[List[torch.Tensor]] = []
        state = {"restored": 0}
        # per-key row counts as actually packed (quarantine may have
        # removed rows the census counted; the layout must not lie)
        true_lengths = np.zeros(K, dtype=np.int64)

        def load_slab(si: int):
            """Producer half: stream, decode and pack one shard.  Shards
            load strictly in order, so the quarantine-ledger CRC taken
            here is the one the serial loop would stamp."""
            ctx.check(f"shard {si} stream")
            k0, k1 = si * blk, min((si + 1) * blk, K)
            if k1 <= k0:
                # a padding shard past the real keys: all-pad blocks
                planes = {"__ts__": np.full((blk, L), packing.TS_PAD,
                                            np.int64),
                          "__mask__": np.zeros((blk, L), np.bool_)}
                for c in num_cols:
                    planes[c] = np.full((blk, L), np.nan, dt)
                    planes[c + "/valid"] = np.zeros((blk, L), np.bool_)
                return ("pad", planes, 0, 0)
            if use_manifests and resume is not None:
                planes = resume.load_shard(si, num_cols, (blk, L),
                                           ledger_crc=ctx.ledger_crc())
                if planes is not None:
                    return ("restored", planes, 0, 0)
            shard_keys = key_frame.iloc[k0:k1] if pcols else None
            filt = None
            if pcols:
                # pushdown on the first partition column
                vals = shard_keys[pcols[0]].unique().tolist()
                filt = pc.field(pcols[0]).isin(vals)
            shard_df = retry(_stream_shard)(
                ds, read_cols, batch_rows, filt, shard_keys, pcols,
                budget_bytes, si, ctx)

            # this shard's layout (series ids relative to k0)
            if pcols and len(shard_df):
                kid = shard_df.merge(
                    shard_keys.reset_index().rename(
                        columns={"index": "__kid__"}),
                    on=pcols, how="left",
                )["__kid__"].to_numpy(np.int64) - k0
            else:
                kid = np.zeros(len(shard_df), dtype=np.int64)
            ts_ns = (packing.series_to_ns(shard_df[ts_col])
                     if len(shard_df) else np.zeros(0, np.int64))
            order_idx, starts = packing._sort_layout(kid, ts_ns, None, blk)
            kid = packing.take(kid, order_idx)
            ts_ns = packing.take(ts_ns, order_idx)
            pos = np.arange(len(kid), dtype=np.int64) - starts[kid]
            overflow = pos >= L
            if overflow.any():
                # rows the census never counted (a file probed back to
                # life after pass 1 quarantined it) cannot fit the
                # padded layout: drop them loudly
                logger.warning(
                    "from_parquet: shard %d holds %d row(s) beyond the "
                    "census length L=%d (rows the census pass never "
                    "counted); dropping them", si, int(overflow.sum()), L)
                keep = ~overflow
                kid, ts_ns = kid[keep], ts_ns[keep]
                order_idx = order_idx[keep]
                starts = np.zeros(blk + 1, dtype=np.int64)
                np.cumsum(np.bincount(kid, minlength=blk), out=starts[1:])
            lay = packing.FlatLayout(key_ids=kid, ts_ns=ts_ns,
                                     order=order_idx, starts=starts,
                                     key_frame=None)
            planes = {
                "__ts__": packing.pack_column(ts_ns, lay, L,
                                              fill=packing.TS_PAD),
                "__mask__": packing.row_mask(lay, L),
            }
            for c in num_cols:
                raw = (packing.take(pd.to_numeric(shard_df[c],
                                                  errors="coerce")
                                    .to_numpy(np.float64), order_idx)
                       if len(shard_df) else np.zeros(0, np.float64))
                planes[c] = packing.pack_column(raw.astype(dt), lay, L,
                                                fill=np.nan)
                planes[c + "/valid"] = packing.pack_column(
                    ~np.isnan(raw), lay, L, fill=False)
            return ("packed", planes, int(len(shard_df)),
                    ctx.ledger_crc())

        def place_slab(si: int, loaded):
            """Calling-thread half: the shard's upload (one copy) in
            shard order and the ordered manifest commit."""
            kind, planes, n_rows, ledger = loaded
            ctx.check(f"shard {si} place")
            for t in range(n_t):
                shards.append(dist_mod._upload_planes(
                    [planes[n][:, t * Lt:(t + 1) * Lt] for n in plane_names],
                    devs[si * n_t + t]))
            if kind == "pad":
                return
            k0, k1 = si * blk, min((si + 1) * blk, K)
            # mask row sums are the packed per-key lengths
            true_lengths[k0:k1] = planes["__mask__"].sum(axis=1)[: k1 - k0]
            if kind == "restored":
                state["restored"] += 1
            elif resume is not None:
                resume.save_shard(si, planes, n_rows, ledger_crc=ledger)

        sweep_slabs(n_s, load_slab, place_slab, ring=ring)
        return shards, state["restored"], true_lengths

    passes = 0
    while True:
        q_mark = len(ctx.quarantined)
        shards, shards_restored, true_lengths = run_shard_pass(
            use_manifests=passes == 0)
        passes += 1
        if len(ctx.quarantined) == q_mark or ctx.on_corrupt != "quarantine":
            break       # raise mode surfaces growth via raise_if_corrupt
        if passes >= 3:
            raise CorruptRowGroupError(
                f"from_parquet: the quarantine kept growing across "
                f"{passes} shard-pass restarts ({len(ctx.quarantined)} "
                f"range(s)); refusing to return a partially-ingested "
                f"frame", ranges=ctx.quarantined)
        # a range quarantined mid-pass leaves earlier shards holding its
        # rows while later ones lost them: re-stream every shard under
        # the now-frozen ledger (manifests bypassed)
        logger.warning(
            "from_parquet: %d new range(s) quarantined while streaming "
            "shards; re-streaming every shard under the frozen ledger "
            "for a consistent frame", len(ctx.quarantined) - q_mark)

    ctx.raise_if_corrupt()
    ctx.check("device placement")
    if resume is not None and ctx.quarantined:
        # later resumes must expect the final ledger
        resume.update_quarantine(ctx)
    if shards_restored:
        logger.info(
            "from_parquet: %d/%d shard(s) restored from the progress "
            "manifest at %s (no Parquet re-read)", shards_restored, n_s,
            resume_dir)

    by_name = {n: [s[j] for s in shards] for j, n in enumerate(plane_names)}
    cols = {c: DistCol(by_name[c], by_name[c + "/valid"]) for c in num_cols}
    # layout lengths come from what was packed, not from the census
    layout = packing.FlatLayout(
        key_ids=np.zeros(0, np.int64), ts_ns=np.zeros(0, np.int64),
        order=np.zeros(0, np.int64),
        starts=np.concatenate(
            [[0], np.cumsum(true_lengths)]).astype(np.int64),
        key_frame=key_frame,
    )
    audits = []
    if ctx.quarantined:
        audits.append((
            "ingest: corrupt/unreadable Parquet ranges quarantined "
            "(frame.ingest_quarantined lists them)",
            [torch.tensor(float(len(ctx.quarantined)) if i == 0 else 0.0,
                          device=dev) for i, dev in enumerate(devs)]))
    frame = DistributedTSDF(
        mesh, series_axis, time_axis, by_name["__ts__"],
        by_name["__mask__"], cols, layout, ts_col, pcols,
        np.dtype("datetime64[ns]"), None, {}, tdtype, audits=audits,
        halo_fraction=halo_fraction)
    frame.ingest_quarantined = tuple(ctx.quarantined)
    # one logical pack event for the residency accounting
    dist_mod._PACK_EVENTS += 1
    return frame


def _stream_shard(ds, read_cols: List[str], batch_rows: int, filt,
                  shard_keys, pcols: List[str],
                  budget_bytes: Optional[int], si: int,
                  ctx: Optional[_IngestCtx] = None) -> pd.DataFrame:
    """Pass 2 unit of work: stream one series shard's row batches into
    a host frame.  Pure read (local ``parts`` rebuilt on every call),
    so the caller can retry it wholesale on transient IO faults."""
    ctx = ctx or _IngestCtx()
    parts = []
    held = 0
    for batch in _iter_batches(ds, read_cols, filt, batch_rows, ctx,
                               stage=f"shard {si} stream"):
        if batch.num_rows == 0:
            continue
        dfb = batch.to_pandas()
        if pcols:
            # exact membership for compound keys
            marked = dfb.merge(
                shard_keys.assign(__in__=True), on=pcols, how="left"
            )
            dfb = dfb[marked["__in__"].fillna(False).to_numpy(bool)]
        if len(dfb) == 0:
            continue
        held += int(dfb.memory_usage(deep=False).sum())
        if budget_bytes is not None and held > budget_bytes:
            raise MemoryError(
                f"series shard {si} exceeded the host ingest budget "
                f"({held} > {budget_bytes} bytes)"
            )
        parts.append(dfb)
    return (
        pd.concat(parts, ignore_index=True)
        if parts else pd.DataFrame(columns=read_cols)
    )


# ----------------------------------------------------------------------
# Slab pipelining: the bounded-ring three-stage sweep
# ----------------------------------------------------------------------

def sweep_slabs(n_slabs: int, load, compute, drain=None,
                ring: Optional[int] = None) -> List:
    """Run ``drain(i, compute(i, load(i)))`` for every slab, pipelined
    behind a bounded ring of slab buffers.

    ``load`` (decode/ingest, CPU- or IO-bound) runs on a producer
    thread one slab AHEAD of the main thread; ``drain`` (D2H fetch,
    digesting, spill) runs on a collector thread one slab BEHIND; the
    main thread runs ``compute`` (device dispatch / placement) on every
    slab strictly IN ORDER.  Slab N+1's load and slab N-1's drain
    overlap slab N's compute, so steady-state wall time approaches
    ``max(load, compute, drain)`` per slab instead of their sum.

    Bitwise contract: the main thread consumes load results in slab
    order and the collector drains compute results in slab order —
    exactly the serial loop's data flow — so the pipelined sweep is
    bit-identical to ``ring=1`` (the serial loop) by construction.

    ``ring`` is the slab-buffer ring depth (default
    ``TEMPO_TPU_INGEST_RING``): at most ``ring - 1`` loaded slabs
    queue ahead of compute and ``ring - 1`` computed slabs queue ahead
    of drain; ``ring <= 1`` (or a single slab) runs fully serially.
    The first failure from any stage re-raises in the caller with the
    pipeline cleanly drained (threads joined, no orphan slabs).
    Returns the per-slab results in slab order.
    """
    if ring is None:
        # the port has no tuner (ops/stream.py says the same of the
        # staging ring): the knob, else 2
        ring = config.get_int("TEMPO_TPU_INGEST_RING", 2)
    ring = max(1, int(ring))
    n = int(n_slabs)
    if ring <= 1 or n <= 1:
        out = []
        for i in range(n):
            y = compute(i, load(i))
            out.append(y if drain is None else drain(i, y))
        return out

    import queue as queue_mod
    import threading

    depth = ring - 1
    loaded: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    to_drain: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    results: List = [None] * n
    fail: List[BaseException] = []    # first failure wins

    def _offer(q, item) -> bool:
        """Bounded put that never deadlocks a dying pipeline."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for i in range(n):
                if stop.is_set():
                    return
                x = load(i)
                if not _offer(loaded, (i, x)):
                    return
        # fail is appended from the producer, the collector, AND the
        # host body: list.append is atomic under the GIL, the list is
        # only append-only while threads run, and the host reads it
        # after join() (first failure wins) — a lock would add nothing
        except BaseException as e:            # noqa: BLE001
            fail.append(e)  # lint-ok: guarded-attr: GIL-atomic append-only list, read after join
            stop.set()

    def collector():
        try:
            while True:
                try:
                    item = to_drain.get(timeout=0.05)
                except queue_mod.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is None:
                    return
                i, y = item
                results[i] = y if drain is None else drain(i, y)
        except BaseException as e:            # noqa: BLE001
            fail.append(e)
            stop.set()

    tp = threading.Thread(target=producer, name="slab-load", daemon=True)
    tc = threading.Thread(target=collector, name="slab-drain", daemon=True)
    tp.start()
    tc.start()
    try:
        for i in range(n):
            while True:
                try:
                    j, x = loaded.get(timeout=0.05)
                    break
                except queue_mod.Empty:
                    if stop.is_set():
                        raise fail[0] if fail else RuntimeError(
                            "slab pipeline stopped without a recorded "
                            "failure")
            assert j == i, "slab pipeline delivered out of order"
            y = compute(i, x)
            if not _offer(to_drain, (i, y)):
                break
        _offer(to_drain, None)
    except BaseException as e:                # noqa: BLE001
        if not fail:
            fail.append(e)
        stop.set()
    tp.join()
    tc.join()
    if fail:
        raise fail[0]
    return results


# ----------------------------------------------------------------------
# Transactional resume: per-shard progress manifests
# ----------------------------------------------------------------------

def _dataset_file_state(path: str) -> tuple:
    """(relpath, size, mtime_ns) of every data file under ``path`` —
    the cheap content fingerprint of the SOURCE.  Committed shard
    manifests hold packed rows of the dataset *as it was*; if the
    upstream writer rewrites a file between the kill and the resume,
    restoring them would silently stitch old and new data together —
    the same stale-restore hazard the plan barriers fingerprint their
    sources against."""
    if not os.path.isdir(path):
        st = os.stat(path)
        return ((os.path.basename(path), st.st_size, st.st_mtime_ns),)
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f.startswith(("_", ".")):
                continue
            fp = os.path.join(root, f)
            st = os.stat(fp)
            out.append((os.path.relpath(fp, path), st.st_size,
                        st.st_mtime_ns))
    return tuple(sorted(out))


def _resume_signature(path, ts_col, pcols, columns, mesh, series_axis,
                      time_axis) -> str:
    """Identity of one ingest configuration INCLUDING the dataset's
    file-level state (:func:`_dataset_file_state`).  A progress
    manifest stamped by a different (dataset content, schema, mesh)
    combination must be refused — resuming it would stitch foreign or
    stale packed blocks into this frame."""
    mesh_state = (tuple(mesh.axis_names), tuple(sorted(mesh.shape.items())))
    h = hashlib.sha1(repr((
        _RESUME_FORMAT, os.path.abspath(path), ts_col, tuple(pcols),
        tuple(columns or ()), mesh_state, series_axis, time_axis,
        _dataset_file_state(path),
    )).encode())
    return h.hexdigest()[:16]


def _array_crc(arr: np.ndarray) -> int:
    from tempo_tpu_torch import checkpoint

    return checkpoint.array_crc(arr)


def _plane_key(name: str) -> str:
    # npz member names cannot hold '/', the valid-plane separator
    return name.replace("/", "__")


class _ResumeLog:
    """Per-shard progress manifest of one out-of-core ingest.

    Layout under ``resume_dir``: ``ingest.json`` (the stamped ingest
    signature), ``census.npz`` + ``keys.parquet`` + ``census.json``
    (the pass-1 key census, CRC'd, including the quarantine ledger so
    pass 2 of a resumed run skips exactly what pass 1 skipped), and
    per shard ``shard_NNNN.npz`` + ``shard_NNNN.json`` (the packed
    host blocks with per-array CRCs).  Every artifact is written
    ``.tmp``-then-rename, and the sidecar JSON is written LAST — its
    presence is the commit record, so a kill mid-write can never leave
    a shard that looks complete.  Corrupt artifacts are detected by
    CRC on load and silently re-streamed (the Parquet source is the
    recovery); only a *foreign signature* refuses by name."""

    def __init__(self, resume_dir: str, signature: str):
        self.dir = str(resume_dir)
        self.signature = signature

    # -- paths ----------------------------------------------------------

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @staticmethod
    def _write_json(path: str, doc: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    # -- signature ------------------------------------------------------

    def open(self, ctx: _IngestCtx) -> None:
        os.makedirs(self.dir, exist_ok=True)
        ip = self._p("ingest.json")
        if os.path.exists(ip):
            try:
                with open(ip) as f:
                    doc = json.load(f)
            except (json.JSONDecodeError, UnicodeDecodeError):
                doc = {}
            stamped = doc.get("signature")
            if stamped != self.signature:
                raise CheckpointError(
                    f"ingest resume directory {self.dir!r} was written "
                    f"by a DIFFERENT ingest (stamped signature "
                    f"{stamped!r} != this call's {self.signature!r}: "
                    f"other dataset path, changed source files, other "
                    f"schema, columns or mesh) — refusing to stitch "
                    f"foreign/stale shards; point resume_dir elsewhere "
                    f"or clear it",
                    kind=FailureKind.PERMANENT,
                )
        else:
            self._write_json(ip, {"signature": self.signature,
                                  "format": _RESUME_FORMAT})

    # -- census ---------------------------------------------------------

    def save_census(self, key_frame: pd.DataFrame, lengths: np.ndarray,
                    ctx: _IngestCtx) -> None:
        tmp = self._p("census.npz.tmp.npz")
        np.savez(tmp, lengths=lengths)
        os.replace(tmp, self._p("census.npz"))
        key_frame.to_parquet(self._p("keys.parquet.tmp"))
        os.replace(self._p("keys.parquet.tmp"), self._p("keys.parquet"))
        from tempo_tpu_torch import checkpoint

        self._write_json(self._p("census.json"), {
            "signature": self.signature,
            "lengths_crc": _array_crc(lengths),
            "keys_crc": checkpoint.file_crc(self._p("keys.parquet")),
            "quarantined": list(ctx.quarantined),
        })

    def load_census(self):
        cp = self._p("census.json")
        if not os.path.exists(cp):
            return None
        try:
            with open(cp) as f:
                doc = json.load(f)
            lengths = np.load(self._p("census.npz"),
                              allow_pickle=False)["lengths"]
            key_frame = pd.read_parquet(self._p("keys.parquet"))
            from tempo_tpu_torch import checkpoint

            if _array_crc(lengths) != int(doc["lengths_crc"]) or \
                    checkpoint.file_crc(self._p("keys.parquet")) \
                    != int(doc["keys_crc"]):
                raise ValueError("census CRC mismatch")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                EOFError, json.JSONDecodeError) as e:
            logger.warning(
                "from_parquet: cached census at %s unusable (%s); "
                "re-running the census pass", self.dir, e)
            return None
        return key_frame, lengths

    def update_quarantine(self, ctx: _IngestCtx) -> None:
        """Re-persist the quarantine ledger after it grew during the
        shard pass, so a later resume expects the FINAL ledger and
        invalidates shard manifests stamped under older ones."""
        cp = self._p("census.json")
        if not os.path.exists(cp):
            return
        try:
            with open(cp) as f:
                doc = json.load(f)
        except (OSError, ValueError, json.JSONDecodeError):
            return
        doc["quarantined"] = list(ctx.quarantined)
        self._write_json(cp, doc)

    def census_quarantine(self) -> List[dict]:
        cp = self._p("census.json")
        if not os.path.exists(cp):
            return []
        try:
            with open(cp) as f:
                return list(json.load(f).get("quarantined") or [])
        except (OSError, ValueError, json.JSONDecodeError):
            return []

    # -- shards ---------------------------------------------------------

    def save_shard(self, si: int, planes: Dict[str, np.ndarray],
                   rows: int, ledger_crc: int = 0) -> None:
        """Persist one completed shard's packed host blocks; the JSON
        sidecar (written last) commits it, stamped with the quarantine
        ledger the shard was packed under."""
        npz = self._p(f"shard_{si:04d}.npz")
        tmp = npz + ".tmp.npz"
        np.savez(tmp, **{_plane_key(k): v for k, v in planes.items()})
        os.replace(tmp, npz)
        self._write_json(self._p(f"shard_{si:04d}.json"), {
            "si": si, "rows": rows, "ledger_crc": int(ledger_crc),
            "crcs": {_plane_key(k): _array_crc(v)
                     for k, v in planes.items()},
        })

    def load_shard(self, si: int, num_cols: List[str], shape,
                   ledger_crc: int = 0
                   ) -> Optional[Dict[str, np.ndarray]]:
        """Packed host blocks of a committed shard, CRC-verified; None
        (re-stream from Parquet) when absent, corrupt, shaped for a
        different layout, or stamped with a DIFFERENT quarantine
        ledger than the current run's (a kill during a consistency
        re-stream leaves manifests packed under mixed ledgers — the
        stale ones must not be stitched in)."""
        jp = self._p(f"shard_{si:04d}.json")
        if not os.path.exists(jp):
            return None
        wanted = ["__ts__", "__mask__"] + [n for c in num_cols
                                           for n in (c, c + "/valid")]
        try:
            with open(jp) as f:
                doc = json.load(f)
            crcs = doc["crcs"]
            if int(doc.get("ledger_crc", 0)) != int(ledger_crc):
                raise ValueError(
                    "packed under a different quarantine ledger")
            with np.load(self._p(f"shard_{si:04d}.npz"),
                         allow_pickle=False) as z:
                planes = {}
                for name in wanted:
                    arr = z[_plane_key(name)]
                    if _array_crc(arr) != int(crcs[_plane_key(name)]) \
                            or tuple(arr.shape) != tuple(shape):
                        raise ValueError(
                            f"plane {name!r} CRC/shape mismatch")
                    planes[name] = arr
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                EOFError, json.JSONDecodeError) as e:
            logger.warning(
                "from_parquet: shard %d progress manifest unusable "
                "(%s); re-streaming it from Parquet", si, e)
            return None
        return planes
