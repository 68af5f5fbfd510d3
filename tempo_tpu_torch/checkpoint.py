"""Checkpoint and resume of frames and raw state.

Counterpart of ``tempo_tpu/checkpoint.py``, with the same on-disk format
(file names, manifest fields, npz member names, ``FORMAT_VERSION``), so
a checkpoint either package writes loads in the other:

* :func:`save` writes a self-describing directory: ``manifest.json`` +
  ``arrays.npz`` (a :class:`~tempo_tpu_torch.dist.DistributedTSDF`'s
  planes as global ``[K_dev, L]`` arrays, one device-to-host copy a
  shard) or, with ``sharded=True``, ``shard_p0.npz`` + ``blocks_p0.json``
  (one block a shard) and ``host_arrays.npz``; ``keys.parquet``,
  ``host.parquet`` and ``objects.parquet`` hold the host-resident state.
  A host :class:`~tempo_tpu_torch.frame.TSDF` is ``host.parquet``.
* :func:`load` restores a mesh frame onto a caller's port ``Mesh`` (any
  number of series shards, with or without a time axis: one
  host-to-device copy a block through ``parallel.mesh.place_planes``), or a
  host frame onto ``device``.
* :func:`save_state` / :func:`load_state` snapshot a flat name -> array
  dict.

Saves are atomic (``<dir>.tmp``, then a three-step swap through
``<dir>.bak``); every npz array and parquet file carries a CRC-32 in the
manifest, and a load that finds a mismatch raises
:class:`~tempo_tpu_torch.resilience.CheckpointError` naming the array or
file.  :func:`list_steps`, :func:`latest`, :func:`resolve_step` and
:func:`prune` manage the ``step_NNNNN`` families of
:func:`~tempo_tpu_torch.resilience.run_resumable`.  Host IO rides the
transient-IO retry policy.

Several processes (``torch.distributed``): the process index and count
come from the process group (0 and 1 without one).  ``save(sharded=
True)`` writes each process's own shards into ``shard_p<pid>.npz`` /
``blocks_p<pid>.json``; process 0 writes the manifest (with
``n_processes``) and the host-side state and makes the swap, the
processes meeting at three barriers (``parallel.multihost.
sync_processes``) as the reference's ``sync_global_devices`` points.  A
dense (``sharded=False``) mesh save refuses several processes by name,
as the reference does.  ``load`` gives each process its own shards
(the others' are ``meta`` placeholders); one process assembles every
shard.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from tempo_tpu_torch import resilience
from tempo_tpu_torch.resilience import CheckpointError, FailureKind

logger = logging.getLogger(__name__)

FORMAT_VERSION = 2

_IO_RETRY = resilience.retrying(resilience.DEFAULT_IO_POLICY,
                                label="checkpoint-io")


def _procs() -> Tuple[int, int]:
    """``(process index, process count)`` of the ``torch.distributed``
    group, ``(0, 1)`` without one."""
    from tempo_tpu_torch.parallel.mesh import process_count, process_index

    return process_index(), process_count()


def _sync(name: str) -> None:
    from tempo_tpu_torch.parallel.multihost import sync_processes

    sync_processes(name)


# ----------------------------------------------------------------------
# Checksummed, retrying IO primitives
# ----------------------------------------------------------------------

def array_crc(arr: np.ndarray) -> int:
    """CRC-32 of an array's raw bytes (dtype-agnostic)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def file_crc(path: str, chunk: int = 1 << 20) -> int:
    """CRC-32 of a file's bytes."""
    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


@_IO_RETRY
def _read_parquet(path: str) -> pd.DataFrame:
    return pd.read_parquet(path)


@_IO_RETRY
def _write_parquet(df: pd.DataFrame, path: str) -> None:
    df.to_parquet(path)


@_IO_RETRY
def _savez(path: str, arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Write an npz and return the per-array CRCs for the manifest."""
    np.savez(path, **arrays)
    return {k: array_crc(v) for k, v in arrays.items()}


@_IO_RETRY
def _load_npz(path: str, checksums: Optional[Dict[str, int]] = None,
              verify: bool = True) -> Dict[str, np.ndarray]:
    """Read every array of an npz, naming the failing array on container
    corruption and checking the manifest's CRCs when given."""
    try:
        z = np.load(path, allow_pickle=False)
    except FileNotFoundError as e:
        raise CheckpointError(
            f"checkpoint file {path!r} is missing (incomplete save?)"
        ) from e
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        if resilience.classify(e) is FailureKind.TRANSIENT_IO:
            raise   # stays retryable under the IO policy
        raise CheckpointError(
            f"checkpoint file {path!r} is unreadable: {e}") from e
    out: Dict[str, np.ndarray] = {}
    with z:
        for name in z.files:
            try:
                arr = z[name]
            except Exception as e:
                if resilience.classify(e) is FailureKind.TRANSIENT_IO:
                    raise
                raise CheckpointError(
                    f"checkpoint array {name!r} in {path!r} is "
                    f"unreadable (corrupt container): {e}") from e
            if verify and checksums is not None and name in checksums:
                got = array_crc(arr)
                want = int(checksums[name])
                if got != want:
                    raise CheckpointError(
                        f"checksum mismatch for array {name!r} in "
                        f"{path!r}: manifest crc32 {want}, computed {got}")
            out[name] = arr
    return out


def _write_manifest(d: str, man: dict) -> None:
    """Finalize a manifest: the format version and the CRC of every
    parquet file already written into ``d``."""
    man.setdefault("format_version", FORMAT_VERSION)
    man["checksum_algo"] = "crc32"
    man["file_checksums"] = {
        os.path.basename(p): file_crc(p)
        for p in sorted(glob.glob(os.path.join(d, "*.parquet")))
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f, indent=2)


def _manifest(path: str) -> dict:
    """Read and validate a manifest; every failure is a
    :class:`CheckpointError`."""
    mp = os.path.join(path, "manifest.json")
    if not os.path.exists(mp):
        raise CheckpointError(
            f"no checkpoint at {path!r}: manifest.json not found",
            kind=FailureKind.PERMANENT)
    try:
        with open(mp) as f:
            man = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"checkpoint manifest {mp!r} is corrupt: {e}") from e
    fv = man.get("format_version") if isinstance(man, dict) else None
    # bool is an int subclass but never a valid version
    if not isinstance(fv, int) or isinstance(fv, bool) \
            or "kind" not in man:
        raise CheckpointError(
            f"checkpoint manifest {mp!r} is missing required fields "
            f"(integer format_version / kind): truncated or foreign file?")
    if fv > FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint at {path!r} has format_version {fv}, newer than "
            f"this library understands (expected <= {FORMAT_VERSION})",
            kind=FailureKind.PERMANENT)
    return man


def _clean_stale_tmp(path: str) -> None:
    """Remove the manifest-less ``<path>.tmp`` a hard-killed save left.
    A tmp with a manifest is a complete checkpoint whose rename never
    happened: it stays, with a warning."""
    tmp = path + ".tmp"
    if not os.path.isdir(tmp) or _procs()[0] != 0:
        return
    if os.path.exists(os.path.join(tmp, "manifest.json")):
        logger.warning(
            "checkpoint %s: %s holds a fully-written checkpoint from a "
            "save killed before its final rename; leaving it on disk "
            "(rename it to recover that state)", path, tmp)
        return
    logger.warning("checkpoint %s: removing stale crash residue %s",
                   path, tmp)
    shutil.rmtree(tmp, ignore_errors=True)


def _swap_into_place(tmp: str, path: str) -> None:
    """Three-step swap: at every crash point ``path`` or ``path.bak``
    holds a complete checkpoint (load falls back to ``.bak``)."""
    bak = path + ".bak"
    if os.path.exists(bak):
        shutil.rmtree(bak)
    if os.path.exists(path):
        os.replace(path, bak)
    os.replace(tmp, path)
    shutil.rmtree(bak, ignore_errors=True)


def save(frame, path: str, sharded: bool = False,
         meta: Optional[dict] = None) -> None:
    """Snapshot a :class:`DistributedTSDF` or a host :class:`TSDF` to the
    directory ``path``, atomically.  ``meta`` (JSON-serializable) rides
    in the manifest under ``"meta"``.  ``sharded=True`` (mesh frames)
    writes each process's blocks into its own ``shard_p<pid>.npz``, the
    reference's per-process layout; several processes need it (the
    dense format fetches the global planes).  Process 0 writes the
    manifest and the host-side state (a host frame is process-replicated
    state: process 0 writes it) and makes the swap; the processes wait
    for each other where the directory exists, where every shard file is
    written and where the swap is done."""
    from tempo_tpu_torch.dist import DistributedTSDF
    from tempo_tpu_torch.frame import TSDF

    pid, n_proc = _procs()
    # validation before the tmp directory and the first barrier exist:
    # every process raises the same error with nothing on disk
    if isinstance(frame, DistributedTSDF):
        if not sharded and n_proc > 1:
            raise ValueError(
                "multi-process checkpoints must use sharded=True (the "
                "dense format fetches the global array)")
    elif not isinstance(frame, TSDF):
        raise TypeError(f"cannot checkpoint {type(frame)}")
    tmp = path + ".tmp"
    if pid == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _sync("tempo_ckpt_dir")
    try:
        if isinstance(frame, DistributedTSDF):
            if sharded:
                _save_dist_sharded(frame, tmp, meta)
            else:
                _save_dist(frame, tmp, meta)
        elif pid == 0:
            _save_host(frame, tmp, meta)
        _sync("tempo_ckpt_written")
        if pid == 0:
            _swap_into_place(tmp, path)
        _sync("tempo_ckpt_swapped")
    except BaseException:
        # several processes: ``tmp`` stays (peers may still write into
        # it; no swap happened, so the previous checkpoint is intact)
        if pid == 0 and n_proc == 1:
            shutil.rmtree(tmp, ignore_errors=True)
        raise


def _resolve_bak(path: str) -> str:
    if not os.path.exists(os.path.join(path, "manifest.json")) \
            and os.path.exists(os.path.join(path + ".bak", "manifest.json")):
        return path + ".bak"   # crash mid-swap: the previous checkpoint
    return path


def load(path: str, mesh=None, series_axis: str = "series",
         time_axis: Optional[str] = None, verify: bool = True,
         device=None):
    """Restore a checkpoint.  Mesh checkpoints need a port ``mesh`` (any
    number of series shards); host checkpoints load onto ``device``
    (default the CUDA card, as every entry point).

    ``verify=True`` checks every artifact against the manifest's CRC-32s
    and raises :class:`CheckpointError` naming the corrupt array or
    file.  Stale ``<path>.tmp`` residue is cleaned."""
    _clean_stale_tmp(path)
    path = _resolve_bak(path)
    man = _manifest(path)
    if verify:
        _verify_file_checksums(path, man)
    if man["kind"] in ("stream_state", "cohort_state", "cohort_member",
                       "standing_state"):
        raise CheckpointError(
            f"{path!r} holds a {man['kind']!r} snapshot, not a frame: "
            f"restore it with checkpoint.load_state(kind="
            f"{man['kind']!r})", kind=FailureKind.PERMANENT)
    if man["kind"] == "host":
        return _load_host(path, man, device)
    if mesh is None:
        raise ValueError("distributed checkpoint needs a mesh to resume on")
    if man["kind"] == "dist_sharded":
        return _load_dist_sharded(path, man, mesh, series_axis, time_axis,
                                  verify=verify)
    return _load_dist(path, man, mesh, series_axis, time_axis, verify=verify)


def _verify_file_checksums(path: str, man: dict) -> None:
    for fname, want in (man.get("file_checksums") or {}).items():
        fp = os.path.join(path, fname)
        if not os.path.exists(fp):
            raise CheckpointError(
                f"checkpoint file {fname!r} recorded in the manifest is "
                f"missing from {path!r}")
        got = _IO_RETRY(file_crc)(fp)
        if got != int(want):
            raise CheckpointError(
                f"checksum mismatch for file {fname!r} in {path!r}: "
                f"manifest crc32 {want}, computed {got}")


def _npz_checksums(man: dict, npz_name: str) -> Optional[Dict[str, int]]:
    return (man.get("array_checksums") or {}).get(npz_name)


# ----------------------------------------------------------------------
# Raw-array state snapshots
# ----------------------------------------------------------------------

def save_state(arrays: Dict[str, np.ndarray], path: str,
               meta: Optional[dict] = None,
               kind: str = "stream_state") -> None:
    """Atomic, CRC'd snapshot of a flat ``name -> array`` dict (host
    arrays, or tensors, which are fetched).  The same guarantees as
    :func:`save`; ``meta`` rides in the manifest."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in arrays.items()}
        sums = _savez(os.path.join(tmp, "state.npz"), host)
        _write_manifest(tmp, {
            "kind": str(kind),
            "array_checksums": {"state.npz": sums},
            "meta": meta or {},
        })
        _swap_into_place(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_state(path: str, verify: bool = True,
               kind: str = "stream_state"):
    """Restore a :func:`save_state` snapshot: ``(arrays dict, meta)``.
    ``kind`` names the expected snapshot family; a mismatch raises by
    name.  ``verify=True`` checks every array against the manifest's
    CRCs and raises :class:`CheckpointError` naming the corrupt array."""
    _clean_stale_tmp(path)
    path = _resolve_bak(path)
    man = _manifest(path)
    if man["kind"] != kind:
        raise CheckpointError(
            f"{path!r} is a {man['kind']!r} checkpoint, not a {kind!r} "
            f"snapshot: restore frames with checkpoint.load and "
            f"snapshots with load_state(kind={man['kind']!r})")
    arrs = _load_npz(os.path.join(path, "state.npz"),
                     _npz_checksums(man, "state.npz"), verify=verify)
    return dict(arrs), man.get("meta") or {}


# ----------------------------------------------------------------------
# Checkpoint families (run_resumable's step_NNNNN layout)
# ----------------------------------------------------------------------

_STEP_RE = re.compile(r"^step_(\d+)$")


def list_steps(parent: str) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of the step checkpoints under ``parent``,
    newest first; ``*.tmp`` crash residue found on the way is cleaned."""
    if not os.path.isdir(parent):
        return []
    out: List[Tuple[int, str]] = []
    for name in sorted(os.listdir(parent)):
        full = os.path.join(parent, name)
        if name.endswith(".tmp") and os.path.isdir(full):
            _clean_stale_tmp(full[:-len(".tmp")])
            continue
        m = _STEP_RE.match(name)
        if m and os.path.isdir(full):
            out.append((int(m.group(1)), full))
    out.sort(reverse=True)
    return out


def verify_checkpoint(path: str, verify_arrays: bool = True) -> dict:
    """Validate a checkpoint end to end (manifest, file CRCs, every npz
    array's CRC) and return its manifest; raises
    :class:`CheckpointError` at the first problem."""
    man = _manifest(path)
    if not verify_arrays:
        return man
    _verify_file_checksums(path, man)
    for npz_name in sorted(man.get("array_checksums") or {}):
        _load_npz(os.path.join(path, npz_name),
                  _npz_checksums(man, npz_name), verify=True)
    if man["kind"] == "dist_sharded":
        for bp in sorted(glob.glob(os.path.join(path, "blocks_p*.json"))):
            doc = _read_blocks(bp)
            pid = os.path.basename(bp)[len("blocks_p"):-len(".json")]
            _load_npz(os.path.join(path, f"shard_p{pid}.npz"),
                      doc.get("checksums"), verify=True)
    return man


def manifest_crc(path: str) -> int:
    """CRC-32 of a checkpoint's ``manifest.json``: the link value of the
    chained step manifests."""
    return _IO_RETRY(file_crc)(os.path.join(path, "manifest.json"))


def read_meta(path: str) -> dict:
    """The ``meta`` dict stamped into a checkpoint's manifest."""
    return _manifest(path).get("meta") or {}


def resolve_step(parent: str, signature: Optional[str] = None,
                 max_step: Optional[int] = None, verify: bool = True,
                 below_step: Optional[int] = None
                 ) -> Optional[Tuple[int, str, dict]]:
    """``(step, path, manifest)`` of the newest step checkpoint under
    ``parent`` that is intact (every CRC verifies), ours (``signature``
    matches its stamped ``pipeline_signature``) and chain-consistent
    (its recorded predecessor-manifest CRC matches the predecessor on
    disk); ``None`` when there is none.

    Corruption and broken chain links fall back to the next older
    candidate; a signature mismatch raises :class:`CheckpointError`
    (state of another pipeline is never restored).  ``verify=False``
    checks manifests only; ``below_step`` skips steps at or above it."""
    for step_no, path in list_steps(parent):
        if below_step is not None and step_no >= below_step:
            continue
        if max_step is not None and step_no > max_step:
            logger.warning(
                "resolve_step: ignoring checkpoint %s beyond the %d-step "
                "pipeline (stale ckpt_dir?)", path, max_step)
            continue
        try:
            man = verify_checkpoint(path, verify_arrays=verify)
        except CheckpointError as e:
            logger.warning(
                "checkpoint %s unusable (%s); trying an older one", path, e)
            continue
        meta = man.get("meta") or {}
        stamped = meta.get("pipeline_signature")
        if signature is not None:
            if stamped is None:
                logger.warning(
                    "checkpoint %s carries no pipeline signature; "
                    "restoring it unverified", path)
            elif stamped != signature:
                raise CheckpointError(
                    f"checkpoint {path!r} was written by a DIFFERENT "
                    f"pipeline: stamped signature {stamped!r} != "
                    f"submitted {signature!r}; refusing to restore foreign "
                    f"state (point ckpt_dir at this pipeline's own "
                    f"directory, or clear it to recompute from scratch)",
                    kind=FailureKind.PERMANENT)
        prev_step = meta.get("prev_step")
        prev_crc = meta.get("prev_manifest_crc")
        if prev_step is not None and prev_crc is not None:
            prev_path = os.path.join(parent, f"step_{int(prev_step):05d}")
            if os.path.exists(os.path.join(prev_path, "manifest.json")) \
                    and manifest_crc(prev_path) != int(prev_crc):
                logger.warning(
                    "checkpoint %s unusable (chained predecessor step %s "
                    "manifest CRC mismatch); falling back to an older one",
                    path, prev_step)
                continue
        return step_no, path, man
    return None


def latest(parent: str, verify: bool = True) -> Optional[str]:
    """Path of the newest intact step checkpoint under ``parent``, or
    ``None``."""
    hit = resolve_step(parent, verify=verify)
    return hit[1] if hit is not None else None


def prune(parent: str, keep_last: int = 2) -> None:
    """Keep-last-K retention of a step-checkpoint family (process 0
    prunes)."""
    if _procs()[0] != 0:
        return
    for _, path in list_steps(parent)[max(keep_last, 1):]:
        logger.info("pruning old checkpoint %s (keep_last=%d)",
                    path, keep_last)
        shutil.rmtree(path, ignore_errors=True)
        shutil.rmtree(path + ".bak", ignore_errors=True)


# ----------------------------------------------------------------------
# host TSDF
# ----------------------------------------------------------------------

def _save_host(tsdf, d: str, meta: Optional[dict] = None) -> None:
    _write_parquet(tsdf.df, os.path.join(d, "host.parquet"))
    _write_manifest(d, {
        "kind": "host",
        "ts_col": tsdf.ts_col,
        "partition_cols": tsdf.partitionCols,
        "sequence_col": tsdf.sequence_col or None,
        "meta": meta or {},
    })


def _load_host(d: str, man: dict, device):
    from tempo_tpu_torch.frame import TSDF

    df = _read_parquet(os.path.join(d, "host.parquet"))
    return TSDF(df, man["ts_col"], man["partition_cols"],
                man.get("sequence_col"), device=device)


# ----------------------------------------------------------------------
# DistributedTSDF
# ----------------------------------------------------------------------

def _frame_planes(frame) -> Dict[str, list]:
    """Name -> shards of every device plane, in the reference's npz
    names (``ts``, ``mask``, ``seq``, ``col_<i>_values``,
    ``col_<i>_valid``)."""
    planes = {"ts": frame.ts, "mask": frame.mask}
    if frame.seq is not None:
        planes["seq"] = frame.seq
    for i, c in enumerate(frame.cols):
        planes[f"col_{i}_values"] = frame.cols[c].values
        planes[f"col_{i}_valid"] = frame.cols[c].valid
    return planes


def _column_meta(frame):
    """(per-column manifest entries, host-gather arrays)."""
    col_meta, hg_arrays = {}, {}
    hg_idx = 0
    for i, c in enumerate(frame.cols):
        col = frame.cols[c]
        cmeta = {"name": c, "int64": col.int64,
                 "ts_chunk": list(col.ts_chunk) if col.ts_chunk else None}
        if col.host_gather is not None:
            flat_vals, r_starts, perm = col.host_gather
            hg_arrays[f"hg_{hg_idx}_vals"] = (
                np.asarray(flat_vals, dtype=object)
                if flat_vals.dtype == object else flat_vals)
            hg_arrays[f"hg_{hg_idx}_starts"] = np.asarray(r_starts)
            hg_arrays[f"hg_{hg_idx}_perm"] = np.asarray(perm)
            cmeta["host_gather"] = hg_idx
            cmeta["host_gather_len"] = int(len(flat_vals))
            hg_idx += 1
        col_meta[str(i)] = cmeta
    return col_meta, hg_arrays


def _layout_arrays(frame) -> Dict[str, np.ndarray]:
    return {"layout_ts_ns": frame.layout.ts_ns,
            "layout_starts": frame.layout.starts,
            "layout_key_ids": frame.layout.key_ids,
            "layout_order": frame.layout.order}


def _audit_counts(frame) -> list:
    if _procs()[1] > 1:
        # other processes' counts are placeholders: gather them
        return [list(a) for a in frame.audit_counts()]
    return [(msg, int(sum(int(round(float(c))) for c in counts)))
            for msg, counts in frame.audits]


def _dist_manifest(frame, audits: Optional[list] = None) -> dict:
    """Manifest payload both mesh formats share."""
    return {
        "format_version": FORMAT_VERSION,
        "ts_col": frame.ts_col,
        "partition_cols": frame.partitionCols,
        "ts_dtype": str(frame._ts_dtype),
        "host_cols": frame.host_cols,
        "halo_fraction": frame.halo_fraction,
        "resampled": frame.resampled,
        "seq_col": frame.seq_col,
        "resample_freq": frame._resample_freq,
        "audits": _audit_counts(frame) if audits is None else audits,
    }


def _save_dist(frame, d: str, meta: Optional[dict] = None) -> None:
    planes = _frame_planes(frame)
    arrays = dict(zip(planes, frame._host_planes(list(planes.values()))))
    arrays.update(_layout_arrays(frame))
    col_meta, hg_arrays = _column_meta(frame)
    arrays.update(hg_arrays)
    crcs = _savez(os.path.join(d, "arrays.npz"),
                  {k: v for k, v in arrays.items() if v.dtype != object})
    _write_host_side(frame, d, {k: v for k, v in arrays.items()
                                if v.dtype == object})
    man = _dist_manifest(frame)
    man.update({"kind": "dist", "columns": col_meta,
                "n_cols": len(frame.cols),
                "array_checksums": {"arrays.npz": crcs},
                "meta": meta or {}})
    _write_manifest(d, man)


def _write_host_side(frame, d: str, obj_arrays: dict) -> None:
    """Host-resident state of both mesh formats: object planes, the key
    frame and the host columns' source."""
    objs = {k: v for k, v in obj_arrays.items() if v.dtype == object}
    if objs:
        _write_parquet(
            pd.DataFrame({k: pd.Series(v) for k, v in objs.items()}),
            os.path.join(d, "objects.parquet"))
    _write_parquet(frame.layout.key_frame, os.path.join(d, "keys.parquet"))
    if frame._source_df is not None and frame.host_cols:
        _write_parquet(
            frame._source_df[sorted(set(frame.host_cols.values()))],
            os.path.join(d, "host.parquet"))


def _save_dist_sharded(frame, d: str, meta: Optional[dict] = None) -> None:
    """``shard_p<pid>.npz`` with one block of every plane a shard of this
    process (a time-sharded frame's blocks carry their lane ranges) and
    its ``blocks_p<pid>.json`` index; process 0 adds
    ``host_arrays.npz``, the host-side state and the manifest."""
    from tempo_tpu_torch.dist import _fetch_planes
    from tempo_tpu_torch.parallel.mesh import block_slices

    pid, n_proc = _procs()
    planes = _frame_planes(frame)
    names = list(planes)
    ranks = frame.mesh.axis_ranks(frame.axes)
    local, blocks = {}, []
    shape = (frame.K_dev, frame.L)
    for j, ((rs, ls), rank) in enumerate(zip(
            block_slices(frame.mesh, frame.spec, shape), ranks)):
        if rank != pid:
            continue
        # one device-to-host copy a shard of this process
        for name, arr in zip(names, _fetch_planes(
                [planes[k][j] for k in names])):
            blocks.append({"plane": name, "key": f"{name}_b{j}",
                           "rows": [rs.start, rs.stop],
                           "lanes": [ls.start, ls.stop]})
            local[f"{name}_b{j}"] = arr
    shard_crcs = _savez(os.path.join(d, f"shard_p{pid}.npz"), local)
    with open(os.path.join(d, f"blocks_p{pid}.json"), "w") as f:
        json.dump({"blocks": blocks, "checksums": shard_crcs}, f)
    audits = _audit_counts(frame)     # a gather: every process calls it
    if pid != 0:
        return

    col_meta, hg_arrays = _column_meta(frame)
    host_arrays = dict(_layout_arrays(frame),
                       **{k: v for k, v in hg_arrays.items()
                          if v.dtype != object})
    host_crcs = _savez(os.path.join(d, "host_arrays.npz"), host_arrays)
    _write_host_side(frame, d, hg_arrays)
    man = _dist_manifest(frame, audits)
    man.update({
        "kind": "dist_sharded",
        "columns": col_meta,
        "n_cols": len(frame.cols),
        "n_processes": n_proc,
        "shape": list(shape),
        "has_seq": frame.seq is not None,
        "array_checksums": {"host_arrays.npz": host_crcs},
        "meta": meta or {},
    })
    _write_manifest(d, man)


def _read_host_gather(meta: dict, z, objs):
    """A column's host_gather triple from the saved arrays."""
    if "host_gather" not in meta:
        return None
    j = meta["host_gather"]
    key = f"hg_{j}_vals"
    vals = (objs[key].to_numpy(object) if objs is not None
            and key in objs.columns else z[key])
    return (vals[: meta["host_gather_len"]], z[f"hg_{j}_starts"],
            z[f"hg_{j}_perm"])


def _read_blocks(bp: str) -> dict:
    """Blocks index in its v2 form (``{"blocks", "checksums"}``); v1
    files were a bare list without checksums."""
    try:
        with open(bp) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"checkpoint shard index {bp!r} is corrupt: {e}") from e
    if isinstance(doc, list):
        return {"blocks": doc, "checksums": None}
    return doc


def _read_host_state(d: str):
    """(objects frame or None, key frame, host-column source or None)."""
    obj_path = os.path.join(d, "objects.parquet")
    objs = _read_parquet(obj_path) if os.path.exists(obj_path) else None
    key_frame = _read_parquet(os.path.join(d, "keys.parquet"))
    host_path = os.path.join(d, "host.parquet")
    source_df = _read_parquet(host_path) if os.path.exists(host_path) \
        else None
    return objs, key_frame, source_df


def _place(man: dict, mesh, series_axis: str, time_axis: Optional[str],
           z, objs, key_frame, source_df, plane_fn, saved_shape):
    """Build the port frame: every plane padded to the mesh's geometry
    (K a multiple of every axis the frame spans, L of 8 times its time
    axis, as ``dist._mesh_packed_geometry``) and cut into one block a
    device, uploaded with one host-to-device copy a block.
    ``plane_fn(name, fill)`` returns a saved global plane, or None when
    absent."""
    from tempo_tpu_torch import device as device_policy
    from tempo_tpu_torch import packing
    from tempo_tpu_torch.dist import DistCol, DistributedTSDF, _time_axis_size
    from tempo_tpu_torch.parallel.mesh import place_planes

    if series_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis named {series_axis!r}")
    n_t = _time_axis_size(mesh, time_axis)
    spec = (series_axis, time_axis)
    devs = mesh.axis_devices((series_axis, time_axis) if time_axis
                             else series_axis)
    k_mult = mesh.shape[series_axis] * n_t
    K, L = saved_shape
    L_new = -(-L // (8 * n_t)) * (8 * n_t)
    K_dev = max(1, -(-K // k_mult)) * k_mult

    def fit(a, fill):
        if a.shape != (K_dev, L_new):
            out = np.full((K_dev, L_new), fill, dtype=a.dtype)
            out[:a.shape[0], :a.shape[1]] = a
            a = out
        return a

    names, host = [], []
    ts = plane_fn("ts", packing.TS_PAD)
    names += ["ts", "mask"]
    host += [fit(ts, packing.TS_PAD), fit(plane_fn("mask", False), False)]
    col_specs = []
    for i in range(man["n_cols"]):
        cmeta = man["columns"][str(i)]
        v = plane_fn(f"col_{i}_values", np.nan)
        fill = np.nan if np.issubdtype(v.dtype, np.floating) else 0
        names += [f"col_{i}_values", f"col_{i}_valid"]
        host += [fit(v, fill), fit(plane_fn(f"col_{i}_valid", False), False)]
        col_specs.append(cmeta)
    seq = plane_fn("seq", np.inf)
    if seq is not None:
        # null sequence values of older checkpoints were packed as NaN:
        # the -inf encoding joins like a fresh frame (no-op otherwise)
        names.append("seq")
        host.append(fit(np.where(np.isnan(seq), -np.inf, seq), np.inf))
    shards = place_planes(host, mesh, spec)
    by_name = {n: [s[j] for s in shards] for j, n in enumerate(names)}
    cols = {}
    for i, cmeta in enumerate(col_specs):
        cols[cmeta["name"]] = DistCol(
            by_name[f"col_{i}_values"], by_name[f"col_{i}_valid"],
            int64=bool(cmeta["int64"]),
            ts_chunk=tuple(cmeta["ts_chunk"]) if cmeta["ts_chunk"] else None,
            host_gather=_read_host_gather(cmeta, z, objs))
    if cols:
        dtype = next(iter(cols.values())).values[0].dtype
    else:
        dtype = device_policy.compute_dtype(devs[0])
    # the count rides the first shard; another process's shard is a
    # placeholder (its owner holds the count)
    ranks = mesh.axis_ranks((series_axis, time_axis) if time_axis
                            else series_axis)
    me = _procs()[0]
    audits = []
    for msg, cnt in man["audits"]:
        audits.append((msg, [torch.tensor(float(cnt) if i == 0 else 0.0,
                                          device=dev if r == me else "meta")
                             for i, (dev, r) in enumerate(zip(devs, ranks))]))
    layout = packing.FlatLayout(
        key_ids=z["layout_key_ids"], ts_ns=z["layout_ts_ns"],
        order=z["layout_order"], starts=z["layout_starts"],
        key_frame=key_frame)
    return DistributedTSDF(
        mesh, series_axis, time_axis, by_name["ts"], by_name["mask"], cols,
        layout, man["ts_col"], man["partition_cols"],
        pd.api.types.pandas_dtype(man["ts_dtype"]), source_df,
        man["host_cols"], dtype, audits=audits, resampled=man["resampled"],
        seq=by_name.get("seq"), seq_col=man.get("seq_col") or "",
        resample_freq=man.get("resample_freq"),
        halo_fraction=float(man.get("halo_fraction", 0.5)))


def _load_dist(d: str, man: dict, mesh, series_axis: str,
               time_axis: Optional[str], verify: bool = True):
    z = _load_npz(os.path.join(d, "arrays.npz"),
                  _npz_checksums(man, "arrays.npz"), verify=verify)
    objs, key_frame, source_df = _read_host_state(d)

    def plane(name, fill):
        return z.get(name)      # ``seq`` is absent without a sequence

    return _place(man, mesh, series_axis, time_axis, z, objs, key_frame,
                  source_df, plane, tuple(int(s) for s in z["ts"].shape))


def _load_dist_sharded(d: str, man: dict, mesh, series_axis: str,
                       time_axis: Optional[str], verify: bool = True):
    z = _load_npz(os.path.join(d, "host_arrays.npz"),
                  _npz_checksums(man, "host_arrays.npz"), verify=verify)
    objs, key_frame, source_df = _read_host_state(d)
    all_blocks, shard_files = {}, {}
    for bp in sorted(glob.glob(os.path.join(d, "blocks_p*.json"))):
        pid = int(os.path.basename(bp)[len("blocks_p"):-len(".json")])
        doc = _read_blocks(bp)
        all_blocks[pid] = doc["blocks"]
        shard_files[pid] = _load_npz(os.path.join(d, f"shard_p{pid}.npz"),
                                     doc.get("checksums"), verify=verify)
    if len(all_blocks) != man["n_processes"]:
        raise ValueError(
            f"sharded checkpoint incomplete: manifest records "
            f"{man['n_processes']} writer processes but "
            f"{len(all_blocks)} shard file(s) are present; filling the "
            f"gap would fabricate empty series")
    K, L = (int(s) for s in man["shape"])

    def plane(name, fill):
        found = [(pid, b) for pid, blocks in all_blocks.items()
                 for b in blocks if b["plane"] == name]
        if not found:
            if name == "seq" and not man.get("has_seq"):
                return None
            raise ValueError(f"plane {name!r} missing from every shard "
                             f"file")
        dtype = shard_files[found[0][0]][found[0][1]["key"]].dtype
        out = np.full((K, L), fill, dtype=dtype)
        for pid, b in found:
            (r0, r1), (c0, c1) = b["rows"], b["lanes"]
            out[r0:r1, c0:c1] = shard_files[pid][b["key"]]
        return out

    return _place(man, mesh, series_axis, time_axis, z, objs, key_frame,
                  source_df, plane, (K, L))
