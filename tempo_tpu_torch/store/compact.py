"""Background compaction: small segments merge into clustered large
ones as a transactional NEW generation.

Counterpart of ``tempo_tpu/store/compact.py``.  Compaction is just
another :meth:`~tempo_tpu_torch.store.engine.Store.
write_table` — the merged rows stage as generation N+1 with a
signature whose source fingerprint is ``compact:<gen N>:<chain head
CRC>`` (deterministic: re-running a killed compaction resumes the same
staged plan, committed merge segments reused), commit, then the
pointer swings.  Until the swing, readers resolve exactly generation
N; after it, exactly N+1 — never a blend.  Retention
(``TEMPO_TPU_STORE_KEEP_GENERATIONS`` >= 2) keeps N on disk, so a
reader that resolved its dataset path before the swing keeps reading
bitwise-identical files after it.
"""

from __future__ import annotations

import logging
from typing import Optional

from tempo_tpu_torch import config
from tempo_tpu_torch.store.engine import Store

logger = logging.getLogger(__name__)


def compact(table: str, *, base_dir: Optional[str] = None,
            target_rows: Optional[int] = None,
            min_segments: Optional[int] = None) -> Optional[dict]:
    """Merge the committed generation's segments into fewer, larger
    clustered ones.  Returns the new generation's write stats, or None
    when the table is already compact (fewer than ``min_segments``
    segments, default ``TEMPO_TPU_STORE_COMPACT_MIN_SEGMENTS``).

    Safe under live traffic and kills: the merge is a transactional
    new generation — a compactor killed mid-merge leaves the pointer
    (and every reader) on generation N; re-running it resumes the
    staged merge with zero committed-segment re-writes."""
    store = Store(base_dir)
    gen, commit = store._require_current(table)
    if min_segments is None:
        min_segments = config.get_int(
            "TEMPO_TPU_STORE_COMPACT_MIN_SEGMENTS", 2)
    if len(commit["segments"]) < max(2, int(min_segments)):
        return None
    if target_rows is None:
        target_rows = config.get_int("TEMPO_TPU_STORE_SEGMENT_ROWS",
                                     1_048_576) * 8
    # strict read: a compactor must never launder a corrupt segment
    # into a fresh-looking generation
    df = store.read(table, verify=True)
    stats = store.write_table(
        table, df, commit.get("sort_cols") or [],
        source_fp=f"compact:{gen}:{int(commit['chain_head_crc'])}",
        segment_rows=int(target_rows))
    logger.info("store: compacted %s %s (%d segments) -> %s (%d)",
                table, gen, len(commit["segments"]),
                stats["generation"], stats["segments"])
    stats["compacted_from"] = gen
    return stats
