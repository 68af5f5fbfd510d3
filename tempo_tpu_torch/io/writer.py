"""Optimized columnar persistence (parity: python/tempo/io.py:10-43).

Counterpart of ``tempo_tpu/io/writer.py``, with the same table layout,
so a table either package writes reads in the other.  The original
Spark library writes a Delta table partitioned by ``event_dt`` with a
derived ``event_time`` (HHMMSS double) column, then ZORDERs by
(partition cols + optimization cols + event_time) on Databricks.

Here: a partitioned Parquet dataset (pyarrow) laid out the
same way - hive-partitioned by ``event_dt``, rows *sorted* within each
file by (partition cols + optimization cols + event_time), which is the
single-dimension-ordering equivalent of the Z-order data-skipping
optimisation (row-group statistics become selective for exactly those
columns).  Reading back restores the frame for device packing.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

WAREHOUSE_ENV = "TEMPO_TPU_WAREHOUSE"
DEFAULT_WAREHOUSE = "tempo_tpu_warehouse"


def _table_path(tab_name: str, base_dir: Optional[str]) -> str:
    from tempo_tpu_torch import config

    base = base_dir or config.get(WAREHOUSE_ENV, DEFAULT_WAREHOUSE)
    return os.path.join(base, tab_name)


def write(tsdf, tab_name: str, optimization_cols: Optional[List[str]] = None,
          base_dir: Optional[str] = None, format: str = "parquet") -> str:
    """Write the TSDF as a clustered, sort-optimized Parquet table.

    Returns the table path.  Derived columns mirror io.py:29-33:
    ``event_dt`` = date of ts, ``event_time`` = HHMMSS.fff as double.

    Overwrite semantics: write a new generation transactionally, then
    atomically swing a pointer: the table is a
    :mod:`tempo_tpu_torch.store` generation table, so the previous
    version survives any kill, a killed write re-issued with the same
    frame resumes with zero committed-segment re-writes, and foreign
    staged state is refused by name.

    ``format="delta"`` keeps the Spark-readable root layout (hive
    partitions + ``_delta_log``) and therefore cannot use generation
    directories; it stages the whole table to a temp sibling, fsyncs,
    and atomically swaps — the old table survives a kill at any point
    (``read`` falls back to the ``.bak`` survivor of a mid-swap
    crash)."""
    if format not in ("parquet", "delta"):
        raise ValueError("format must be 'parquet' or 'delta'")
    from tempo_tpu_torch.store import engine as store_engine

    df, sort_cols = store_engine.clustered_frame(tsdf, optimization_cols)
    path = _table_path(tab_name, base_dir)
    if format == "delta":
        df = df.sort_values(sort_cols, kind="stable") if sort_cols else df
        _replace_table_dir(path, lambda tmp: _write_delta(df, tmp))
    else:
        store_engine.Store(os.path.dirname(path)).write_table(
            tab_name, df, sort_cols,
            source_fp=store_engine.source_fingerprint(tsdf))
    logger.info("wrote %d rows to %s (sorted by %s)", len(df), path, sort_cols)
    return path


def _fsync_tree(path: str) -> None:
    """fsync every file (and directory) under ``path`` so the staged
    replacement is durable BEFORE the atomic swap makes it live."""
    for root, _dirs, files in os.walk(path):
        for f in files:
            fd = os.open(os.path.join(root, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fd = os.open(root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _replace_table_dir(path: str, build) -> None:
    """Never delete the old table before its replacement exists.  ``build(tmp)`` writes the
    new table into a temp sibling; it is fsync'd, then swapped in with
    the checkpoint three-step (old → ``.bak``, staged → live, drop
    ``.bak``) — a kill at any point leaves either the old table at
    ``path`` or, mid-swap, at ``path + ".bak"`` where ``read`` finds
    it."""
    import shutil

    tmp = path + ".staging"
    bak = path + ".bak"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)          # residue of an earlier killed write
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        build(tmp)
        _fsync_tree(tmp)
        if os.path.exists(bak):
            shutil.rmtree(bak)
        if os.path.exists(path):
            os.replace(path, bak)
        os.replace(tmp, path)
        shutil.rmtree(bak, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# Spark SQL type names for the Delta schemaString
_SPARK_TYPES = {
    "int8": "byte", "int16": "short", "int32": "integer", "int64": "long",
    "uint8": "short", "uint16": "integer", "uint32": "long",
    "uint64": "long",
    "float32": "float", "float64": "double", "bool": "boolean",
    "object": "string", "string": "string",
}


def _spark_type(dtype) -> str:
    name = str(dtype)
    if name.startswith("datetime64"):
        return "timestamp"
    if name.startswith("Int"):
        return _SPARK_TYPES.get(name.lower(), "long")
    return _SPARK_TYPES.get(name, "string")


def _write_delta(df: pd.DataFrame, path: str) -> None:
    """One parquet file per event_dt partition + a version-0 Delta
    commit (protocol, metaData with a Spark-JSON schema, add actions)."""
    import json
    import time
    import uuid

    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    now_ms = int(time.time() * 1000)
    # Spark's parquet reader rejects TIMESTAMP(NANOS) and has no
    # unsigned types: coerce to micros + signed before writing
    df = df.copy()
    for c in df.columns:
        if str(df[c].dtype) == "uint64":
            if len(df) and int(df[c].max()) > np.iinfo(np.int64).max:
                raise OverflowError(
                    f"column {c!r}: uint64 values above int64 range "
                    "cannot be represented in a Spark-readable table"
                )
            df[c] = df[c].astype(np.int64)
    adds = []
    for i, (dt_val, part) in enumerate(df.groupby("event_dt", sort=True)):
        part_dir = os.path.join(path, f"event_dt={dt_val}")
        os.makedirs(part_dir, exist_ok=True)
        fname = f"part-{i:05d}-{uuid.uuid4()}.snappy.parquet"
        fpath = os.path.join(part_dir, fname)
        # Delta stores partition values in the log, not the file
        table = pa.Table.from_pandas(
            part.drop(columns=["event_dt"]), preserve_index=False
        )
        pq.write_table(table, fpath, compression="snappy",
                       coerce_timestamps="us",
                       allow_truncated_timestamps=True)
        adds.append({
            "add": {
                "path": f"event_dt={dt_val}/{fname}",
                "partitionValues": {"event_dt": str(dt_val)},
                "size": os.path.getsize(fpath),
                "modificationTime": now_ms,
                "dataChange": True,
                "stats": json.dumps({"numRecords": len(part)}),
            }
        })

    fields = [
        {"name": c, "type": _spark_type(df[c].dtype), "nullable": True,
         "metadata": {}}
        for c in df.columns if c != "event_dt"
    ] + [{"name": "event_dt", "type": "string", "nullable": True,
          "metadata": {}}]
    actions = [
        {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
        {"metaData": {
            "id": str(uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": json.dumps({"type": "struct", "fields": fields}),
            "partitionColumns": ["event_dt"],
            "configuration": {},
            "createdTime": now_ms,
        }},
        *adds,
        {"commitInfo": {"timestamp": now_ms, "operation": "WRITE",
                        "operationParameters": {"mode": "Overwrite"}}},
    ]
    log_dir = os.path.join(path, "_delta_log")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"{0:020d}.json"), "w") as f:
        for action in actions:
            f.write(json.dumps(action) + "\n")


def read(tab_name: str, ts_col: str = "event_ts",
         partition_cols: Optional[List[str]] = None,
         base_dir: Optional[str] = None, on_corrupt: str = "raise",
         device=None):
    """Read a table written by :func:`write` back into a TSDF, through
    the hardened read path: store tables resolve their committed
    generation (torn pointer/commit state refused by name), and corrupt
    row groups surface :class:`~tempo_tpu_torch.io.ingest.
    CorruptRowGroupError` with the exact ranges named
    (``on_corrupt="quarantine"`` reads around them) instead of an
    opaque pyarrow traceback.  Plain Parquet directories and
    delta-format tables read through the same machinery; a table caught
    mid-swap by a crash falls back to its ``.bak`` survivor.  The frame
    lands on ``device`` (default the CUDA card)."""
    from tempo_tpu_torch.frame import TSDF
    from tempo_tpu_torch.store import engine as store_engine

    path = _table_path(tab_name, base_dir)
    if not os.path.isdir(path) and os.path.isdir(path + ".bak"):
        path = path + ".bak"    # crash between the two swap renames
    ds_path = store_engine.resolve_dataset_path(path)
    df = store_engine.read_dataset_df(ds_path, on_corrupt=on_corrupt)
    df = df.drop(columns=[c for c in ("event_dt", "event_time") if c in df.columns])
    return TSDF(df, ts_col=ts_col, partition_cols=partition_cols,
                device=device)
