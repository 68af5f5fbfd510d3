"""The transactional table engine behind ``tempo_tpu_torch.store``.

Counterpart of ``tempo_tpu/store/engine.py`` with the same on-disk
format, so a table either package writes reads in the other.

On-disk layout of one table (all control files are ``_``-prefixed so
pyarrow dataset discovery ignores them; a generation directory IS a
plain Parquet dataset any engine can read)::

    <warehouse>/<table>/
      _CURRENT.json               # pointer: {"generation", "commit_crc"}
      gen_00000001/
        _staging.json             # write signature, stamped FIRST
        seg_00000.parquet         # clustered segment (sorted rows)
        _seg_00000.json           # segment commit sidecar, written LAST
        seg_00001.parquet
        _seg_00001.json           # chains _seg_00000.json by CRC-32
        _commit.json              # generation commit record, written LAST

Durability contract:

* a segment exists iff its ``_seg_NNNNN.json`` sidecar exists — the
  parquet file is staged ``.tmp`` → fsync → rename first, so the
  sidecar's presence is the commit record (the ingest shard-manifest
  discipline, ``io/ingest.py``'s ``_ResumeLog``);
* sidecars are CHAINED: each records the CRC-32 of its predecessor
  sidecar, so a resume can prove the committed prefix is the one
  uninterrupted write, not an interleaving of two;
* ``_commit.json`` (written last, ``.tmp`` → fsync → rename) makes the
  generation readable; ``_CURRENT.json`` is then atomically replaced —
  the previous generation stays on disk (retention keeps
  ``TEMPO_TPU_STORE_KEEP_GENERATIONS``) so live readers holding its
  path stay bitwise-correct and any kill leaves the old table intact;
* a re-issued killed write verifies the staged signature (dataset
  path + schema + clustering spec + source-frame content fingerprint,
  :func:`source_fingerprint`), CRC-verifies the
  committed segment chain, and writes ONLY the segments after it —
  zero committed-segment re-writes;
* a foreign staging signature, a torn commit record, a broken chain
  link or a CRC-mismatched segment is REFUSED BY NAME
  (:class:`StoreError` / :class:`StoreCommitError` — both self-describe
  their :class:`~tempo_tpu_torch.resilience.FailureKind` for
  ``resilience.classify``, and a torn commit is never transient);
  corruption is never silently rebuilt over.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from tempo_tpu_torch import checkpoint as ckpt
from tempo_tpu_torch import config
from tempo_tpu_torch.resilience import CheckpointError, FailureKind

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1

CURRENT_NAME = "_CURRENT.json"
COMMIT_NAME = "_commit.json"
STAGING_NAME = "_staging.json"

_GEN_RE = re.compile(r"^gen_(\d{8})$")


class StoreError(CheckpointError):
    """The storage engine refused an operation: foreign staged state,
    a missing generation, or an ill-formed request.  Self-describes as
    ``PERMANENT`` by default — re-running the same call is never the
    recovery; the message names the explicit operator action that is."""

    def __init__(self, message: str,
                 kind: FailureKind = FailureKind.PERMANENT):
        super().__init__(message, kind=kind)


class StoreCommitError(StoreError):
    """Torn or corrupt commit state: an unparseable commit record or
    pointer, a broken segment-manifest chain link, or a CRC-mismatched
    segment.  Self-describes as ``CORRUPTED_ARTIFACT`` — a torn commit
    is NEVER transient (retrying the read re-reads the same bad bytes);
    the recovery is an older generation or a re-issued write."""

    def __init__(self, message: str):
        super().__init__(message, kind=FailureKind.CORRUPTED_ARTIFACT)


# ----------------------------------------------------------------------
# fsync'd atomic file primitives
# ----------------------------------------------------------------------

def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:            # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj: dict) -> None:
    """``.tmp`` → fsync → rename: the file either holds the complete
    JSON document or does not exist; a kill can never leave a torn
    control file behind (so a torn one on disk is real corruption and
    is refused by name, not rebuilt over)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _read_json(path: str, what: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
        raise StoreCommitError(
            f"{what} {path!r} is torn/corrupt (does not parse as JSON: "
            f"{e}) — the file is written atomically, so this is real "
            f"corruption, not a crash artifact; restore from an older "
            f"generation or re-issue the write") from e
    if not isinstance(obj, dict):
        raise StoreCommitError(
            f"{what} {path!r} is not a JSON object — foreign file?")
    return obj


def _swing_pointer(tpath: str, gen_name: str, commit_crc: int) -> None:
    """Make a committed generation live: atomically replace the table
    pointer.  Module-level so fault injection can kill exactly the
    window between the commit record and the swing."""
    _write_json_atomic(os.path.join(tpath, CURRENT_NAME), {
        "format_version": FORMAT_VERSION,
        "generation": gen_name,
        "commit_crc": commit_crc,
    })


def _write_segment(df: pd.DataFrame, path: str) -> int:
    """Stage one clustered segment: parquet to ``.tmp``, fsync, atomic
    rename.  Module-level so fault injection can kill or count exactly
    the segment writes.  Returns the staged file's CRC-32."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tmp = path + ".tmp"
    table = pa.Table.from_pandas(df, preserve_index=False)
    pq.write_table(table, tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return ckpt.file_crc(path)


def _write_seg_manifest(gen_dir: str, seq: int, man: dict) -> None:
    """Commit one segment: its sidecar appears (atomically) only after
    the parquet rename; module-level so fault injection can kill
    between the two files."""
    _write_json_atomic(os.path.join(gen_dir, _seg_manifest_name(seq)),
                       man)


def _seg_name(seq: int) -> str:
    return f"seg_{seq:05d}.parquet"


def _seg_manifest_name(seq: int) -> str:
    return f"_seg_{seq:05d}.json"


def _json_scalar(v):
    """Key-range stats must ride JSON manifests: numpy scalars and
    timestamps to plain python."""
    if isinstance(v, (np.generic,)):
        v = v.item()
    if isinstance(v, (pd.Timestamp,)):
        return str(v)
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


def _signature(table_path: str, schema: Sequence[Tuple[str, str]],
               sort_cols: Sequence[str], source_fp: str) -> str:
    """The write signature refusal keys on: dataset path + schema +
    clustering spec + source content fingerprint.  Any difference means
    a staged generation belongs to a DIFFERENT write."""
    blob = repr((os.path.abspath(table_path),
                 tuple((str(n), str(t)) for n, t in schema),
                 tuple(str(c) for c in sort_cols), str(source_fp)))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _df_hash(h, df: pd.DataFrame) -> None:
    h.update(np.ascontiguousarray(
        pd.util.hash_pandas_object(df, index=False).to_numpy()).tobytes())


def source_fingerprint(obj) -> str:
    """Content fingerprint of a write-back or pipeline source, stable
    across process restarts: a host frame's data hashed by
    ``pd.util.hash_pandas_object`` (the reference's fingerprint of the
    same frame), a mesh frame's fetched planes and layout, a bare
    DataFrame's data.  Memoized on frames (frames are immutable)."""
    from tempo_tpu_torch.dist import DistributedTSDF
    from tempo_tpu_torch.frame import TSDF

    if isinstance(obj, pd.DataFrame):
        h = hashlib.sha1()
        h.update(repr(("df", tuple(obj.columns))).encode())
        _df_hash(h, obj)
        return h.hexdigest()[:16]
    if not isinstance(obj, (TSDF, DistributedTSDF)):
        raise TypeError(
            f"store.write_back accepts a TSDF, DistributedTSDF or pandas "
            f"DataFrame, got {type(obj).__name__}")
    cached = getattr(obj, "_source_fp", None)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    if isinstance(obj, DistributedTSDF):
        h.update(repr(("dist", tuple(obj.cols), obj.ts_col,
                       tuple(obj.partitionCols),
                       obj.seq_col or "")).encode())
        planes = ckpt._frame_planes(obj)
        for arr in obj._host_planes(list(planes.values())):
            h.update(np.ascontiguousarray(arr).tobytes())
        for col in obj.cols.values():
            if col.host_gather is not None:
                vals, starts, perm = col.host_gather
                h.update(repr(len(vals)).encode())
                h.update(np.ascontiguousarray(starts).tobytes())
                h.update(np.ascontiguousarray(perm).tobytes())
        h.update(np.ascontiguousarray(obj.layout.starts).tobytes())
        h.update(obj.layout.key_frame.to_json().encode())
    else:
        h.update(repr(("host", tuple(obj.df.columns), obj.ts_col,
                       tuple(obj.partitionCols),
                       obj.sequence_col or "")).encode())
        _df_hash(h, obj.df)
    fp = h.hexdigest()[:16]
    obj._source_fp = fp
    return fp


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------

class Store:
    """One warehouse directory of transactional generation tables.
    ``base_dir`` defaults to ``TEMPO_TPU_WAREHOUSE``."""

    def __init__(self, base_dir: Optional[str] = None):
        if base_dir is None:
            base_dir = config.get("TEMPO_TPU_WAREHOUSE",
                                  "tempo_tpu_warehouse")
        self.base_dir = str(base_dir)

    def table_path(self, table: str) -> str:
        return os.path.join(self.base_dir, str(table))

    # -- reading -------------------------------------------------------

    def current(self, table: str) -> Optional[Tuple[str, dict]]:
        """``(generation_name, commit_record)`` of the committed
        generation, or None for a table that has no pointer (never
        written / legacy layout).  A torn pointer, a pointer naming a
        generation without an intact commit record, or a commit CRC
        mismatch raises :class:`StoreCommitError` by name."""
        tpath = self.table_path(table)
        cur_path = os.path.join(tpath, CURRENT_NAME)
        if not os.path.exists(cur_path):
            return None
        cur = _read_json(cur_path, "store pointer")
        gen = cur.get("generation")
        want_crc = cur.get("commit_crc")
        if not isinstance(gen, str) or not _GEN_RE.match(gen) \
                or not isinstance(want_crc, int) \
                or isinstance(want_crc, bool):
            raise StoreCommitError(
                f"store pointer {cur_path!r} is malformed (generation="
                f"{gen!r}, commit_crc={want_crc!r}) — foreign or "
                f"corrupt pointer")
        commit = self._read_commit(os.path.join(tpath, gen), want_crc)
        return gen, commit

    def _read_commit(self, gen_dir: str, want_crc: Optional[int]) -> dict:
        cpath = os.path.join(gen_dir, COMMIT_NAME)
        if not os.path.isdir(gen_dir):
            raise StoreCommitError(
                f"store generation {gen_dir!r} named by the pointer "
                f"does not exist on disk")
        if not os.path.exists(cpath):
            raise StoreCommitError(
                f"store generation {gen_dir!r} has no commit record "
                f"({COMMIT_NAME}) — the generation never committed; "
                f"the pointer should not name it")
        if want_crc is not None:
            got = ckpt.file_crc(cpath)
            if got != int(want_crc):
                raise StoreCommitError(
                    f"torn commit: {cpath!r} has crc32 {got}, the "
                    f"pointer recorded {want_crc} — commit record and "
                    f"pointer disagree")
        commit = _read_json(cpath, "store commit record")
        fv = commit.get("format_version")
        if not isinstance(fv, int) or isinstance(fv, bool) \
                or "segments" not in commit:
            raise StoreCommitError(
                f"store commit record {cpath!r} is missing required "
                f"fields (integer format_version / segments) — "
                f"truncated or foreign file")
        if fv > FORMAT_VERSION:
            raise StoreError(
                f"store generation {gen_dir!r} has format_version {fv}, "
                f"newer than this library understands (expected <= "
                f"{FORMAT_VERSION}); upgrade to read it")
        return commit

    def dataset_path(self, table: str) -> str:
        """The committed generation directory — a plain clustered
        Parquet dataset, the path ``io.ingest.from_parquet`` reads
        without a shuffle."""
        cur = self.current(table)
        if cur is None:
            raise StoreError(
                f"table {self.table_path(table)!r} has no committed "
                f"generation (no {CURRENT_NAME})")
        gen, _ = cur
        return os.path.join(self.table_path(table), gen)

    def verify(self, table: str) -> dict:
        """Strict integrity pass over the committed generation: every
        segment file CRC-32 against its commit record, every sidecar
        chain link.  Raises :class:`StoreCommitError` naming the first
        broken artifact; returns the commit record when intact."""
        gen, commit = self._require_current(table)
        gen_dir = os.path.join(self.table_path(table), gen)
        prev_crc = 0
        for seq, seg in enumerate(commit["segments"]):
            fp = os.path.join(gen_dir, seg["file"])
            if not os.path.exists(fp):
                raise StoreCommitError(
                    f"committed segment {seg['file']!r} is missing "
                    f"from {gen_dir!r}")
            got = ckpt.file_crc(fp)
            if got != int(seg["crc"]):
                raise StoreCommitError(
                    f"committed segment {fp!r} is corrupt: crc32 {got} "
                    f"!= recorded {seg['crc']}")
            man_path = os.path.join(gen_dir, _seg_manifest_name(seq))
            man = _read_json(man_path, "store segment manifest")
            if int(man.get("prev_manifest_crc", -1)) != prev_crc:
                raise StoreCommitError(
                    f"segment manifest chain broken at {man_path!r}: "
                    f"prev_manifest_crc {man.get('prev_manifest_crc')} "
                    f"!= predecessor crc32 {prev_crc}")
            prev_crc = ckpt.file_crc(man_path)
        if int(commit.get("chain_head_crc", -1)) != prev_crc:
            raise StoreCommitError(
                f"commit record of {gen_dir!r} records chain_head_crc "
                f"{commit.get('chain_head_crc')}, the sidecar chain "
                f"ends at {prev_crc}")
        return commit

    def _require_current(self, table: str) -> Tuple[str, dict]:
        cur = self.current(table)
        if cur is None:
            raise StoreError(
                f"table {self.table_path(table)!r} has no committed "
                f"generation (no {CURRENT_NAME})")
        return cur

    def read(self, table: str, columns: Optional[List[str]] = None,
             on_corrupt: str = "raise", batch_rows: int = 65536,
             verify: bool = False) -> pd.DataFrame:
        """Read the committed generation through the hardened ingest
        path: corrupt row groups surface
        :class:`~tempo_tpu_torch.io.ingest.CorruptRowGroupError` with the
        exact ranges named (``on_corrupt="quarantine"`` reads around
        them), never an opaque pyarrow traceback.  ``verify=True``
        additionally CRC-checks every committed segment against the
        commit record first (:meth:`verify`)."""
        if verify:
            self.verify(table)
        return read_dataset_df(self.dataset_path(table),
                               columns=columns, on_corrupt=on_corrupt,
                               batch_rows=batch_rows)

    def generations(self, table: str) -> List[str]:
        """Generation directories on disk, oldest first (committed or
        staged)."""
        tpath = self.table_path(table)
        if not os.path.isdir(tpath):
            return []
        return sorted(d for d in os.listdir(tpath)
                      if _GEN_RE.match(d)
                      and os.path.isdir(os.path.join(tpath, d)))

    # -- writing -------------------------------------------------------

    def write_table(self, table: str, df: pd.DataFrame,
                    sort_cols: Sequence[str], *, source_fp: str,
                    segment_rows: Optional[int] = None,
                    keep_generations: Optional[int] = None) -> dict:
        """Write ``df`` as a new clustered generation of ``table`` and
        atomically swing the pointer to it.  Rows are stable-sorted by
        ``sort_cols`` (the ZORDER analogue: row-group statistics become
        selective for exactly those columns) and cut into segments of
        ``segment_rows`` (``TEMPO_TPU_STORE_SEGMENT_ROWS``), each
        committed by a chained CRC'd sidecar.

        Re-issuing a killed write (same frame, same table) resumes the
        staged generation: committed segments are CRC-verified and
        SKIPPED — the returned stats record ``segments_reused`` and the
        invariant ``segments_rewritten == 0``.  A staged generation
        with a different signature is refused by name (delete the
        staging directory, or call :meth:`discard_staging`, to
        overwrite with different data after a kill)."""
        tpath = self.table_path(table)
        os.makedirs(tpath, exist_ok=True)
        sort_cols = [c for c in sort_cols if c in df.columns]
        if sort_cols:
            df = df.sort_values(sort_cols, kind="stable")
        df = df.reset_index(drop=True)
        schema = [(c, str(df[c].dtype)) for c in df.columns]
        sig = _signature(tpath, schema, sort_cols, source_fp)
        if segment_rows is None:
            segment_rows = config.get_int("TEMPO_TPU_STORE_SEGMENT_ROWS",
                                          1_048_576)
        segment_rows = max(1, int(segment_rows))

        cur = self.current(table)
        if cur is not None and cur[1].get("signature") == sig:
            # this exact write (same content fingerprint, schema and
            # clustering spec) IS the committed generation already — a
            # re-issue after a kill that landed past the pointer swing,
            # or a verbatim retry.  Idempotent: zero writes.
            gen_name, commit = cur
            return {"path": os.path.join(tpath, gen_name),
                    "generation": gen_name,
                    "rows": int(commit["rows"]),
                    "segments": len(commit["segments"]),
                    "segments_reused": len(commit["segments"]),
                    "segments_rewritten": 0, "resumed": True,
                    "signature": sig}
        cur_id = int(_GEN_RE.match(cur[0]).group(1)) if cur else 0
        staged = self._find_staging(tpath, cur_id)
        reused = 0
        if staged is not None:
            gen_dir, st = staged
            if st is None:
                # killed before the signature stamp: nothing was
                # committed, the residue carries no promises — discard
                logger.warning("store: discarding unsigned staging "
                               "residue %s", gen_dir)
                shutil.rmtree(gen_dir)
                staged = None
            elif st.get("signature") != sig:
                raise StoreError(
                    f"staged generation {gen_dir!r} was written by a "
                    f"DIFFERENT write (staged signature "
                    f"{st.get('signature')!r} != {sig!r}: the "
                    f"signature folds dataset path, schema, clustering "
                    f"spec and source-frame content fingerprint) — "
                    f"refusing to resume onto foreign staged state; "
                    f"re-issue the original write, or discard the "
                    f"staging with Store.discard_staging({table!r})")
        if staged is not None:
            gen_dir, st = staged
            gen_name = os.path.basename(gen_dir)
            # resume continues the STAGED plan: its segment size, not
            # today's knob — chunk boundaries must line up exactly
            segment_rows = int(st["segment_rows"])
            resumed = True
        else:
            gen_name = f"gen_{cur_id + 1:08d}"
            gen_dir = os.path.join(tpath, gen_name)
            os.makedirs(gen_dir)
            st = {
                "format_version": FORMAT_VERSION,
                "signature": sig,
                "segment_rows": segment_rows,
                "sort_cols": list(sort_cols),
                "schema": [list(s) for s in schema],
                "source": str(source_fp),
                "rows": int(len(df)),
            }
            _write_json_atomic(os.path.join(gen_dir, STAGING_NAME), st)
            resumed = False

        n_segments = max(1, -(-len(df) // segment_rows))
        if os.path.exists(os.path.join(gen_dir, COMMIT_NAME)):
            # killed between commit and pointer swing: everything is
            # already durable — verify and swing, zero writes
            commit = self._read_commit(gen_dir, None)
            if commit.get("signature") != sig:
                raise StoreError(
                    f"committed staging {gen_dir!r} carries a foreign "
                    f"signature {commit.get('signature')!r} != {sig!r}")
            reused = len(commit["segments"])
        else:
            reused, prev_crc = self._verify_staged_segments(
                gen_dir, sig, n_segments)
            segments = self._staged_segment_records(gen_dir, reused)
            key_col = sort_cols[0] if sort_cols else None
            ts_col = sort_cols[-1] if sort_cols else None
            for seq in range(reused, n_segments):
                chunk = df.iloc[seq * segment_rows:
                                (seq + 1) * segment_rows]
                seg_file = _seg_name(seq)
                crc = _write_segment(chunk,
                                     os.path.join(gen_dir, seg_file))
                man = {
                    "format_version": FORMAT_VERSION,
                    "file": seg_file,
                    "seq": seq,
                    "rows": int(len(chunk)),
                    "crc": crc,
                    "signature": sig,
                    "prev_manifest_crc": prev_crc,
                    "key_min": _json_scalar(
                        chunk[key_col].iloc[0]) if key_col and len(chunk)
                    else None,
                    "key_max": _json_scalar(
                        chunk[key_col].iloc[-1]) if key_col and len(chunk)
                    else None,
                    "ts_min": _json_scalar(
                        chunk[ts_col].iloc[0]) if ts_col and len(chunk)
                    else None,
                    "ts_max": _json_scalar(
                        chunk[ts_col].iloc[-1]) if ts_col and len(chunk)
                    else None,
                }
                _write_seg_manifest(gen_dir, seq, man)
                prev_crc = ckpt.file_crc(
                    os.path.join(gen_dir, _seg_manifest_name(seq)))
                man["manifest_crc"] = prev_crc
                segments.append(man)
            commit = {
                "format_version": FORMAT_VERSION,
                "signature": sig,
                "rows": int(len(df)),
                "sort_cols": list(sort_cols),
                "schema": [list(s) for s in schema],
                "source": str(source_fp),
                "segments": [
                    {"file": s["file"], "rows": int(s["rows"]),
                     "crc": int(s["crc"]),
                     "manifest_crc": int(s["manifest_crc"]),
                     "key_min": s.get("key_min"),
                     "key_max": s.get("key_max")}
                    for s in segments],
                "chain_head_crc": prev_crc,
            }
            _write_json_atomic(os.path.join(gen_dir, COMMIT_NAME),
                               commit)
        commit_crc = ckpt.file_crc(os.path.join(gen_dir, COMMIT_NAME))
        _swing_pointer(tpath, gen_name, commit_crc)
        self._prune_generations(tpath, gen_name, keep_generations)
        logger.info(
            "store: committed %s/%s (%d rows, %d segments, %d reused%s)",
            table, gen_name, len(df), n_segments, reused,
            ", resumed" if resumed else "")
        return {
            "path": tpath, "generation": gen_name,
            "rows": int(len(df)), "segments": int(n_segments),
            "segments_reused": int(reused),
            "segments_rewritten": 0,
            "resumed": bool(resumed), "signature": sig,
        }

    def _find_staging(self, tpath: str, cur_id: int):
        """Newest staging generation (id > committed, no commit
        record): ``(dir, staging_record_or_None)``."""
        for name in reversed(sorted(os.listdir(tpath))
                             if os.path.isdir(tpath) else []):
            m = _GEN_RE.match(name)
            if not m or int(m.group(1)) <= cur_id:
                continue
            gen_dir = os.path.join(tpath, name)
            if not os.path.isdir(gen_dir):
                continue
            sp = os.path.join(gen_dir, STAGING_NAME)
            try:
                st = _read_json(sp, "store staging record")
            except FileNotFoundError:
                st = None
            return gen_dir, st
        return None

    def _verify_staged_segments(self, gen_dir: str, sig: str,
                                n_segments: int) -> Tuple[int, int]:
        """Walk the staged sidecar chain: ``(committed_count,
        chain_head_crc)``.  The committed prefix must verify exactly —
        a torn sidecar, broken chain link, foreign signature or
        CRC-mismatched segment file is refused by name (a kill cannot
        produce any of those states; rename-atomicity means they are
        corruption)."""
        reused = 0
        prev_crc = 0
        for seq in range(n_segments):
            man_path = os.path.join(gen_dir, _seg_manifest_name(seq))
            if not os.path.exists(man_path):
                break               # first uncommitted segment
            man = _read_json(man_path, "store segment manifest")
            if man.get("signature") != sig:
                raise StoreError(
                    f"staged segment manifest {man_path!r} carries a "
                    f"foreign signature {man.get('signature')!r} != "
                    f"{sig!r} — refusing to count it as committed")
            if int(man.get("prev_manifest_crc", -1)) != prev_crc:
                raise StoreCommitError(
                    f"staged segment chain broken at {man_path!r}: "
                    f"prev_manifest_crc {man.get('prev_manifest_crc')} "
                    f"!= predecessor sidecar crc32 {prev_crc}")
            seg_path = os.path.join(gen_dir, man["file"])
            if not os.path.exists(seg_path):
                raise StoreCommitError(
                    f"committed segment {seg_path!r} is missing though "
                    f"its sidecar {man_path!r} exists — the sidecar is "
                    f"written after the segment rename, so this is "
                    f"corruption, not a crash artifact")
            got = ckpt.file_crc(seg_path)
            if got != int(man["crc"]):
                raise StoreCommitError(
                    f"committed segment {seg_path!r} is corrupt: crc32 "
                    f"{got} != sidecar-recorded {man['crc']}")
            prev_crc = ckpt.file_crc(man_path)
            reused += 1
        # stray uncommitted residue past the verified prefix (partial
        # parquet, .tmp files): superseded by the re-write
        for p in glob.glob(os.path.join(gen_dir, "*.tmp")):
            os.remove(p)
        for seq in range(reused, n_segments + 1):
            stray = os.path.join(gen_dir, _seg_name(seq))
            if os.path.exists(stray):
                os.remove(stray)
        return reused, prev_crc

    def _staged_segment_records(self, gen_dir: str,
                                reused: int) -> List[dict]:
        out = []
        for seq in range(reused):
            man_path = os.path.join(gen_dir, _seg_manifest_name(seq))
            man = _read_json(man_path, "store segment manifest")
            man["manifest_crc"] = ckpt.file_crc(man_path)
            out.append(man)
        return out

    def _prune_generations(self, tpath: str, current_gen: str,
                           keep: Optional[int]) -> None:
        """Retention: keep the newest ``keep`` generations (default
        ``TEMPO_TPU_STORE_KEEP_GENERATIONS``, min 1 — the committed one
        is never pruned).  Keeping >= 2 is what lets readers opened on
        generation N stay bitwise-correct while N+1 commits."""
        if keep is None:
            keep = config.get_int("TEMPO_TPU_STORE_KEEP_GENERATIONS", 2)
        keep = max(1, int(keep))
        gens = sorted(d for d in os.listdir(tpath) if _GEN_RE.match(d))
        cur_id = int(_GEN_RE.match(current_gen).group(1))
        # stale staging above current cannot exist here (it just
        # committed); anything else beyond the keep window goes
        victims = [g for g in gens
                   if int(_GEN_RE.match(g).group(1)) <= cur_id][:-keep]
        for g in victims:
            logger.info("store: pruning old generation %s/%s (keep=%d)",
                        tpath, g, keep)
            shutil.rmtree(os.path.join(tpath, g), ignore_errors=True)

    def discard_staging(self, table: str) -> bool:
        """Explicitly drop a staged (uncommitted) generation — the
        named operator action the foreign-staging refusal points at."""
        tpath = self.table_path(table)
        cur = self.current(table)
        cur_id = int(_GEN_RE.match(cur[0]).group(1)) if cur else 0
        staged = self._find_staging(tpath, cur_id)
        if staged is None:
            return False
        shutil.rmtree(staged[0])
        return True


# ----------------------------------------------------------------------
# Module-level conveniences
# ----------------------------------------------------------------------

def write_back(source, table: str, *, base_dir: Optional[str] = None,
               ts_col: Optional[str] = None,
               partition_cols: Optional[Sequence[str]] = None,
               optimization_cols: Optional[Sequence[str]] = None,
               segment_rows: Optional[int] = None) -> dict:
    """Transactional clustered write-back of a frame, a distributed
    frame, or a query-result DataFrame.  Clustering is (series, time):
    partition cols + optimization cols + the derived ``event_time`` —
    the layout ``io.writer.write`` has always produced, now committed
    as a generation."""
    from tempo_tpu_torch.dist import DistributedTSDF
    from tempo_tpu_torch.frame import TSDF

    fp = source_fingerprint(source)
    if isinstance(source, DistributedTSDF):
        frame = source.collect()
    elif isinstance(source, TSDF):
        frame = source
    else:
        if ts_col is None:
            raise ValueError(
                "write_back of a bare DataFrame needs ts_col")
        # host-only use (clustering columns): no device work
        frame = TSDF(source, ts_col=ts_col,
                     partition_cols=list(partition_cols or []),
                     device="cpu")
    df, sort_cols = clustered_frame(frame, optimization_cols)
    return Store(base_dir).write_table(
        table, df, sort_cols, source_fp=fp, segment_rows=segment_rows)


def clustered_frame(tsdf, optimization_cols=None):
    """Derive the reference writer's columns (io.py:29-36 parity:
    ``event_dt`` date string + ``event_time`` HHMMSS.fff double,
    rotated to the front) and the clustering sort spec."""
    df = tsdf.df.copy()
    ts = pd.to_datetime(df[tsdf.ts_col])
    df["event_dt"] = ts.dt.date.astype(str)
    df["event_time"] = (
        ts.dt.hour * 10000 + ts.dt.minute * 100 + ts.dt.second
        + ts.dt.microsecond / 1e6
    ).astype(float)
    cols = list(df.columns)
    df = df[cols[-1:] + cols[:-1]]
    opt_cols = list(optimization_cols or []) + ["event_time"]
    sort_cols = [c for c in list(tsdf.partitionCols) + opt_cols
                 if c in df.columns]
    return df, sort_cols


def resolve_dataset_path(path: str) -> str:
    """Store-aware path resolution: a table directory holding a
    ``_CURRENT.json`` pointer resolves to its committed generation
    directory (verifying the pointer/commit pair, refusing torn state
    by name); any other path is returned unchanged.  ``from_parquet``
    and ``io.writer.read`` route through this, so a store table is
    ingestible by the exact path ``write`` returned."""
    cur_path = os.path.join(path, CURRENT_NAME)
    if not os.path.exists(cur_path):
        return path
    cur = _read_json(cur_path, "store pointer")
    gen = cur.get("generation")
    want_crc = cur.get("commit_crc")
    if not isinstance(gen, str) or not _GEN_RE.match(gen):
        raise StoreCommitError(
            f"store pointer {cur_path!r} is malformed "
            f"(generation={gen!r})")
    gen_dir = os.path.join(path, gen)
    cpath = os.path.join(gen_dir, COMMIT_NAME)
    if not os.path.exists(cpath):
        raise StoreCommitError(
            f"store pointer {cur_path!r} names generation {gen!r} "
            f"which has no commit record")
    if isinstance(want_crc, int) and not isinstance(want_crc, bool):
        got = ckpt.file_crc(cpath)
        if got != want_crc:
            raise StoreCommitError(
                f"torn commit: {cpath!r} has crc32 {got}, the pointer "
                f"recorded {want_crc}")
    return gen_dir


def read_dataset_df(path: str, columns: Optional[List[str]] = None,
                    on_corrupt: str = "raise",
                    batch_rows: int = 65536) -> pd.DataFrame:
    """Read a Parquet dataset directory through the hardened ingest
    machinery (``io/ingest._iter_batches``): deadline-free, but corrupt
    row groups surface :class:`~tempo_tpu_torch.io.ingest.CorruptRowGroupError`
    with exact ranges (``on_corrupt="quarantine"`` reads around them)
    instead of an opaque pyarrow traceback."""
    import pyarrow as pa

    from tempo_tpu_torch.io import ingest

    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(
            f"on_corrupt must be 'raise' or 'quarantine', got "
            f"{on_corrupt!r}")
    ctx = ingest._IngestCtx(on_corrupt=on_corrupt)
    ds = ingest._dataset(path, ctx)
    cols = list(columns) if columns is not None else None
    batches = list(ingest._iter_batches(ds, cols, None, batch_rows, ctx,
                                        stage="store-read"))
    ctx.raise_if_corrupt()
    schema = ds.schema if cols is None else pa.schema(
        [ds.schema.field(c) for c in cols])
    df = pa.Table.from_batches(batches, schema).to_pandas()
    return _restore_time_units(df, path)


def _restore_time_units(df: pd.DataFrame, path: str) -> pd.DataFrame:
    """Give each timestamp column of a store generation the dtype its
    commit record states.  Parquet has no seconds unit, so pyarrow
    writes a ``datetime64[s]`` column as milliseconds and reads it back
    so; the commit record's schema (``str(dtype)`` of every column, as
    written) keeps the unit, and the cast back is exact.  A directory
    without a commit record (a plain or Delta dataset) is returned as
    read: the Delta writer coerces timestamps to microseconds for Spark
    on purpose."""
    cpath = os.path.join(path, COMMIT_NAME)
    if not os.path.exists(cpath):
        return df
    for name, dtype in _read_json(cpath, "commit record").get("schema", []):
        if (name in df.columns and str(dtype).startswith("datetime64")
                and str(df[name].dtype) != str(dtype)):
            df[name] = df[name].astype(pd.api.types.pandas_dtype(dtype))
    return df
