"""Transactional storage engine: crash-consistent clustered write-back.

Counterpart of ``tempo_tpu/store``, with the same on-disk format.  Sharded Parquet
write-back of frames, distributed frames and query results as
*generations* of (series, time)-clustered segments, committed by
per-segment CRC'd manifests chained by predecessor CRC with a JSON
commit record written last, published by an atomic pointer swing — so
the previous table version survives ANY kill, a killed write resumes
with zero committed-segment re-writes, and torn/foreign/corrupt
staged state is refused by name.  ``compact`` merges small segments
into clustered large ones as a new transactional generation under
live readers.
"""

from tempo_tpu_torch.store.compact import compact
from tempo_tpu_torch.store.engine import (
    Store,
    StoreCommitError,
    StoreError,
    clustered_frame,
    read_dataset_df,
    resolve_dataset_path,
    source_fingerprint,
    write_back,
)

__all__ = [
    "Store",
    "StoreError",
    "StoreCommitError",
    "clustered_frame",
    "compact",
    "read_dataset_df",
    "resolve_dataset_path",
    "source_fingerprint",
    "write_back",
]
