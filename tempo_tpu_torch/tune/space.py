"""The registered knob space the autotuner sweeps.

Counterpart of ``tempo_tpu/tune/space.py``.  Every axis is a
``TEMPO_TPU_*`` knob declared in ``tempo_tpu_torch/config.py`` whose
value is a performance choice: the sweep measures each candidate in a
child process, and the bitwise audit decides whether the candidate is
admissible at all.

* ``bitwise_neutral=True`` axes (the staging ring's depth, the serving
  micro-batch rows, the slab ring, the stitch length, the coalescing
  window) carry a contract: every value gives the same bits.  A digest
  that moves on such an axis is a regression; the sweep records it and
  ``python -m tempo_tpu_torch.tune --smoke`` exits non-zero.
* ``bitwise_neutral=False`` axes (``TEMPO_TPU_STREAM_MAX_ROWS``) gate
  which range engine is legal for a shape.  A candidate that flips the
  engine changes the float rounding order and the audit rejects it.
  Such an axis never crowns a winner either: a candidate with the same
  bits left the engine pick as it was, so any measured gain is noise,
  and a shipped ceiling could flip the engine at shapes no probe ran.

The reference's ``TEMPO_TPU_MEGACORE``, ``TEMPO_TPU_PACK_COLS`` and
``TEMPO_TPU_JOIN_CHUNK_LANES`` have no knob in the port (a TPU core
split, the column-packed Mosaic kernel and the lane-chunked Mosaic
join have no Hopper counterpart that reads them), so the reference's
``packed_stream`` and ``join_chunk`` classes are not here and
``stream_dense`` sweeps the ``TEMPO_TPU_DMA_BUFFERS`` ladder alone.

Each knob has exactly one owning class (``owns``) whose winner feeds
the profile's merged knob set; another class sweeping the same knob is
a cross-check, recorded and never merged.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class Axis(NamedTuple):
    """One knob ladder, walked in declared order from the default
    (``values[0]``, the incumbent the class baseline measures).  ``None``
    as a value means unset.  ``smoke_values`` is the smoke sweep's
    clipped ladder."""

    knob: str
    values: Tuple
    smoke_values: Tuple
    bitwise_neutral: bool = True


class ShapeClass(NamedTuple):
    name: str
    probe: str              # python -m tempo_tpu_torch.tune.probe <probe>
    axes: Tuple[Axis, ...]
    owns: Tuple[str, ...]   # knobs whose winner feeds profile["knobs"]
    requires_cuda: bool = False
    doc: str = ""


SPACE: Tuple[ShapeClass, ...] = (
    ShapeClass(
        "stream_dense", "stream_dense",
        axes=(
            Axis("TEMPO_TPU_DMA_BUFFERS", (2, 3, 4, 6, 8), (2, 4)),
        ),
        owns=("TEMPO_TPU_DMA_BUFFERS",),
        doc="~50 Hz density: range stats' staged form, the staging "
            "ring's home regime; owns the ring depth"),
    ShapeClass(
        "stream_medium", "stream_medium",
        axes=(
            Axis("TEMPO_TPU_DMA_BUFFERS", (2, 3, 4, 6, 8), (2, 4)),
            Axis("TEMPO_TPU_STREAM_MAX_ROWS", (16384, 8192, 32768),
                 (16384, 32768), bitwise_neutral=False),
        ),
        owns=("TEMPO_TPU_STREAM_MAX_ROWS",),
        doc="~10 Hz density near the engine crossover; owns the "
            "stream-engine row ceiling (audit-gated: a value that flips "
            "the engine changes bits and is rejected; same-bits values "
            "never win either, so the default ceiling always ships)"),
    ShapeClass(
        "fused_chain", "fused_chain",
        axes=(
            Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4)),
        ),
        owns=(),
        doc="entry.forward_step (join, range stats, EMA): a cross-check "
            "that the stream classes' winner holds on the whole chain "
            "(owns nothing; recorded, never merged)"),
    ShapeClass(
        "serve_batch", "serve_batch",
        axes=(
            Axis("TEMPO_TPU_SERVE_BATCH_ROWS", (64, 16, 32, 128, 256),
                 (64, 32)),
        ),
        owns=("TEMPO_TPU_SERVE_BATCH_ROWS",),
        doc="MicroBatchExecutor under a deterministic tick load; owns "
            "the per-series micro-batch row cap"),
    ShapeClass(
        "ingest_sweep", "ingest_sweep",
        axes=(
            Axis("TEMPO_TPU_INGEST_RING", (2, 1, 4, 8), (2, 4)),
        ),
        owns=("TEMPO_TPU_INGEST_RING",),
        doc="io.ingest.sweep_slabs (load thread, in-order compute, "
            "drain thread); owns the slab ring depth; every depth is "
            "bitwise by construction (in-order consumption)"),
    ShapeClass(
        "stitched_chain", "stitched_chain",
        axes=(
            Axis("TEMPO_TPU_STITCH_MAX_OPS", (8, 1, 4, 16), (8, 1)),
        ),
        owns=("TEMPO_TPU_STITCH_MAX_OPS",),
        doc="a planned resample -> EMA -> range stats chain; owns the "
            "longest stitched run (stitched == op by op, bitwise)"),
    ShapeClass(
        "serve_cohort", "serve_cohort",
        axes=(
            Axis("TEMPO_TPU_SERVE_COALESCE_S",
                 (0.002, 0.0, 0.001, 0.004, 0.008), (0.002, 0.0)),
        ),
        owns=("TEMPO_TPU_SERVE_COALESCE_S",),
        doc="CohortExecutor under a deterministic Poisson tick load; owns "
            "the one float knob (profile.FLOAT_KNOBS): the window moves "
            "the micro-batch split, never per-(slot, row) state math, so "
            "every value is bitwise"),
)


def classes(names=None, smoke: bool = False):
    """The shape classes to sweep: all of them, or the named subset.
    The smoke sweep defaults to one stream class and the serving class,
    one of each probe family."""
    if names:
        by_name = {c.name: c for c in SPACE}
        unknown = [n for n in names if n not in by_name]
        if unknown:
            raise KeyError(
                f"unknown shape class(es) {unknown}: "
                f"known = {[c.name for c in SPACE]}")
        return tuple(by_name[n] for n in names)
    if smoke:
        return tuple(c for c in SPACE
                     if c.name in ("stream_medium", "serve_batch"))
    return SPACE


def axis_values(axis: Axis, smoke: bool = False) -> Tuple:
    return axis.smoke_values if smoke else axis.values
