"""The unified history+live scan: one source over everything ever
written.

Counterpart of ``tempo_tpu/query/unified.py``.

A :class:`StreamTable` is a named, watermarked event table: optional
Parquet history in the transactional store (``tempo_tpu_torch/store``) plus
a live host tail of admitted pushes, in arrival order.  Its plan-facing
face is the ``unified_scan`` IR node (payload:
:class:`UnifiedSource`), which materializes history ∪ tail as ONE
``TSDF`` under the table's single watermark — so a registered query
(method chain or SQL) answers over all data ever seen, bitwise equal
to a batch run over the concatenated frames.  The kappa-architecture
answer to maintaining separate batch and speed codepaths in the
client.

Ordering contract: rows are admitted per series against the same
merged-stream watermark rule the serving plane enforces
(``serve.stream.admit_batch`` — one admission rule, so the standing
incremental path and the batch twin cannot drift on what "late"
means).  ``sync_to_store`` persists the tail as a new clustered store
generation WITHOUT re-sorting (empty ``sort_cols``), so arrival order
— and therefore the packed layouts' first-appearance key
factorization — survives the round trip, and a live ``store.compact``
mid-subscription republishes the same rows in the same order:
unified-scan results are bitwise stable across compaction.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from tempo_tpu_torch import packing

__all__ = ["StreamTable", "UnifiedSource"]


def _seq_sort_key(seq_vals: np.ndarray) -> np.ndarray:
    """NULLS FIRST realized as -inf, the serving plane's convention."""
    s = np.asarray(seq_vals, np.float64)
    return np.where(np.isnan(s), -np.inf, s)


class StreamTable:
    """One live event table: schema + watermark + host tail, with
    optional store-backed history.

    ``columns`` fixes the schema order (history and every pushed frame
    are re-projected onto it).  ``value_cols`` names the float metric
    columns the incremental operators stream; everything else is
    structural (``ts_col``, ``partition_cols``, ``sequence_col``).
    Pushes normally arrive through
    :meth:`~tempo_tpu_torch.query.standing.StandingQueryEngine.push` (which
    fans them out to subscribers); :meth:`append` is the direct,
    engine-less form for batch-only use, and is refused while an
    engine owns the table.  ``device`` is where the plans over the table
    run (the CUDA card by default, ``"cpu"`` for the plain versions): the
    ``unified_scan`` node materializes its snapshot there, and a
    standing engine steps the table's serving planes there.
    Thread-safe: all mutable state is guarded by the table lock."""

    def __init__(self, name: str, ts_col: str,
                 partition_cols: Sequence[str],
                 value_cols: Sequence[str], *,
                 sequence_col: Optional[str] = None,
                 store=None, columns: Optional[Sequence[str]] = None,
                 device=None):
        from tempo_tpu_torch import device as device_mod

        self.name = str(name)
        self.device = device_mod.resolve(device)
        self.ts_col = str(ts_col)
        self.partitionCols = [str(c) for c in partition_cols]
        self.value_cols = [str(c) for c in value_cols]
        self.sequence_col = str(sequence_col) if sequence_col else None
        self.store = store
        if columns is None:
            columns = ([self.ts_col] + self.partitionCols
                       + self.value_cols
                       + ([self.sequence_col] if self.sequence_col
                          else []))
        self.columns = [str(c) for c in columns]
        for c in ([self.ts_col] + self.partitionCols + self.value_cols
                  + ([self.sequence_col] if self.sequence_col else [])):
            if c not in self.columns:
                raise ValueError(
                    f"StreamTable {self.name!r}: declared column "
                    f"{c!r} is missing from the schema {self.columns}")
        self._lock = threading.RLock()
        self.version = 0          # guarded-by: self._lock
        self._tail: List[pd.DataFrame] = []   # guarded-by: self._lock
        self.tail_rows = 0        # guarded-by: self._lock
        self._history = None      # guarded-by: self._lock
        self._history_gen = None  # guarded-by: self._lock
        #: the adopting StandingQueryEngine, if any — while set,
        #: direct append() is refused (it would bypass the engine's
        #: watermarks and corrupt the per-boundary base row counts the
        #: join carries index against); released on engine close
        self._engine = None       # guarded-by: self._lock

    # -- admission ------------------------------------------------------

    def _normalize(self, df: pd.DataFrame) -> pd.DataFrame:
        missing = [c for c in self.columns if c not in df.columns]
        if missing:
            raise ValueError(
                f"push to table {self.name!r} is missing columns "
                f"{missing} (schema: {self.columns})")
        return df[self.columns].reset_index(drop=True)

    def _row_keys(self, df: pd.DataFrame) -> List[tuple]:
        cols = [df[c].to_numpy() for c in self.partitionCols]
        n = len(df)
        return [tuple(c[i] for c in cols) for i in range(n)]

    def prepare(self, df: pd.DataFrame):
        """Normalize one pushed frame: ``(frame, keys, ts_ns, seq)``
        with per-row series-key tuples, int64-ns timestamps and the
        NULLS-FIRST seq plane — the shared currency of admission and
        member dispatch.  Does NOT append."""
        df = self._normalize(df)
        ts_ns = packing.series_to_ns(df[self.ts_col])
        if self.sequence_col:
            seq = _seq_sort_key(
                pd.to_numeric(df[self.sequence_col]).to_numpy(np.float64))
        else:
            seq = np.full(len(df), -np.inf, np.float64)
        return df, self._row_keys(df), ts_ns, seq

    def commit(self, df: pd.DataFrame) -> None:
        """Append one admitted (already watermark-validated) frame to
        the live tail."""
        with self._lock:
            if len(df):
                self._tail.append(df)
                self.tail_rows += len(df)
            self.version += 1

    def append(self, df: pd.DataFrame) -> int:
        """Direct, engine-less append (no subscriber fanout, no
        watermark check beyond schema) — batch-only ingestion.  Refused
        once a standing-query engine has adopted the table: a direct
        append would slip rows past the engine's watermarks and shift
        the snapshot row indices its join carries point at — route live
        data through ``engine.push(table, df)`` instead."""
        with self._lock:
            if self._engine is not None:
                raise RuntimeError(
                    f"StreamTable {self.name!r} is adopted by a "
                    f"standing-query engine: direct append() would "
                    f"bypass its watermarks and subscriber carries — "
                    f"push through StandingQueryEngine.push(table, df)")
        df, _, _, _ = self.prepare(df)
        self.commit(df)
        return len(df)

    # -- the unified snapshot ------------------------------------------

    def _history_df(self) -> Optional[pd.DataFrame]:  # guarded-by: self._lock
        if self.store is None:
            return None
        cur = self.store.current(self.name)
        if cur is None:
            return None
        gen = cur[0]
        if self._history is None or self._history_gen != gen:
            self._history = self._normalize(self.store.read(self.name))
            self._history_gen = gen
        return self._history

    def snapshot_df(self) -> pd.DataFrame:
        """History ∪ tail in arrival order, projected to the schema."""
        with self._lock:
            parts = []
            hist = self._history_df()
            if hist is not None and len(hist):
                parts.append(hist)
            parts.extend(self._tail)
            if not parts:
                return pd.DataFrame({c: pd.Series([], dtype="float64")
                                     for c in self.columns})
            if len(parts) == 1:
                return parts[0].copy()
            return pd.concat(parts, ignore_index=True)

    def state_token(self) -> tuple:
        """What a compiled plan over this table is keyed by: version
        counter + committed store generation + tail length."""
        with self._lock:
            gen = None
            if self.store is not None:
                cur = self.store.current(self.name)
                gen = cur[0] if cur is not None else None
            return (self.name, self.version, gen, self.tail_rows)

    def rows_total(self) -> int:
        with self._lock:
            hist = self._history_df()
            return (len(hist) if hist is not None else 0) + self.tail_rows

    def prefix_df(self, rows: int) -> pd.DataFrame:
        """The first ``rows`` rows of the unified snapshot (resume
        replay cursor)."""
        return self.snapshot_df().iloc[:rows].reset_index(drop=True)

    # -- store sync -----------------------------------------------------

    def sync_to_store(self) -> Optional[dict]:
        """Persist the unified snapshot as a new store generation and
        truncate the live tail.  Rows are written with EMPTY sort_cols
        — arrival order is the table's bitwise identity (it drives the
        packed layouts' key factorization), so the store must preserve
        it verbatim; a later ``store.compact`` keeps it too (compaction
        re-clusters by the commit's recorded sort_cols, also empty)."""
        if self.store is None:
            raise ValueError(
                f"StreamTable {self.name!r} has no store to sync to")
        with self._lock:
            df = self.snapshot_df()
            stats = self.store.write_table(
                self.name, df, [],
                source_fp=f"standing:{self.name}:v{self.version}:"
                          f"rows{len(df)}")
            self._tail = []
            self.tail_rows = 0
            self._history = None
            self._history_gen = None
            self.version += 1
            return stats

    # -- plan integration ----------------------------------------------

    def frame(self):
        """A lazy frame over this table's ``unified_scan`` node — use
        it exactly like a planned TSDF (method chains, SQL ``tables=``
        entries, ``register``)."""
        from tempo_tpu_torch.plan import ir, lazy

        return lazy.wrap(ir.Node("unified_scan",
                                 payload=UnifiedSource(self)))

    def __repr__(self) -> str:
        with self._lock:
            rows, ver = self.rows_total(), self.version
        return f"StreamTable({self.name!r}, rows={rows}, v{ver})"


class UnifiedSource:
    """Payload of a ``unified_scan`` plan node: the TSDF-shaped view
    of one :class:`StreamTable` snapshot.  Duck-types the source-frame
    surface the optimizer touches (``df`` / ``ts_col`` /
    ``partitionCols`` / ``sequence_col``) and pins one snapshot per
    table version so a single plan execution never sees a torn
    read."""

    def __init__(self, table: StreamTable):
        self.table = table
        self._pin: Optional[Tuple[tuple, pd.DataFrame]] = None

    @property
    def ts_col(self) -> str:
        return self.table.ts_col

    @property
    def partitionCols(self) -> List[str]:
        return self.table.partitionCols

    @property
    def sequence_col(self) -> Optional[str]:
        return self.table.sequence_col

    @property
    def columns(self) -> List[str]:
        return self.table.columns

    @property
    def df(self) -> pd.DataFrame:
        token = self.table.state_token()
        if self._pin is None or self._pin[0] != token:
            self._pin = (token, self.table.snapshot_df())
        return self._pin[1]

    def materialize(self):
        from tempo_tpu_torch.frame import TSDF

        return TSDF(self.df, self.table.ts_col,
                    self.table.partitionCols,
                    self.table.sequence_col or None,
                    device=self.table.device)

    def _unified_state(self) -> tuple:
        """The ``plan.ir._frame_state`` entry for unified sources."""
        return ("unified",) + self.table.state_token() + (
            tuple(self.table.columns), self.table.ts_col,
            tuple(self.table.partitionCols),
            self.table.sequence_col or "", str(self.table.device))

    def __repr__(self) -> str:
        return f"UnifiedSource({self.table!r})"
