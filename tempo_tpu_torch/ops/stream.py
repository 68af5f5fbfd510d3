"""The staging ring's knob and planner.

Counterpart of ``tempo_tpu/ops/pallas_stream.py``: its ``ring_call``
(an N-deep HBM->VMEM DMA ring, ``_make_ring_kernel``) is
``csrc/ring.cuh`` here, a shared-memory ring of bulk copies that
completes on mbarriers, inside three kernels: bucket stats
(``csrc/bucket_stats.cu``), range stats (``csrc/range_stats.cu``) and
the resample EMA (``csrc/resample_ema.cu``).  Each of them keeps its
row form (the kernel without a ring) beside the staged form.

:func:`dma_buffers` reads ``TEMPO_TPU_DMA_BUFFERS``, the ring's depth.
The planners (:func:`bucket_plan`, :func:`range_plan`,
:func:`resample_plan`) are ``ring_plan`` / ``plan_with_ring`` rewritten
in Hopper terms: a staged form's tile width ``T`` and depth come from
the bytes a slot takes and the shared memory one block may take
(``SMEM_LIMIT``; the bucket-stats form keeps to ``BUCKET_SMEM``, two
blocks an SM).  The planner tries the widths in ``*_TILES`` from the
widest down at the asked depth, then at depth 2; it needs at least two
tiles a row (one tile has nothing to overlap, as ``ring_plan`` refuses
fewer than two slabs) and clamps the depth to the tile count.  Where
nothing fits it returns None and the caller takes the row form.  The
choice is made by shape, on the host, before the launch; each form
counts its own launches (``cuda_lib.launches``: ``bucket_stats`` and
``bucket_stats_ring``, ...), and :data:`last_plan` records the last
choice of each kernel.

The byte counts mirror the kernels' shared-memory layouts
(``*_ring_layout`` in the sources); ``cuda_lib`` exports the kernels'
own totals (``tempo_*_ring_smem``) so a run on the card can check them.

``pallas_stream.grid_semantics`` and ``TEMPO_TPU_MEGACORE`` have no
counterpart: they split a TPU grid over two TensorCores, and a CUDA
grid's blocks run in parallel already.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from tempo_tpu_torch import config

#: dynamic shared memory one block may take on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: the bucket-stats staged form's budget: two blocks an SM (228 KB of
#: shared memory an SM, 1 KB of it reserved a block)
BUCKET_SMEM = 115_712
#: the ring's depth range (``pallas_stream.dma_buffers``' clamp) and slot cap
MIN_DEPTH, MAX_DEPTH = 2, 8
#: tile widths each planner tries, widest first; the last is the floor
BUCKET_TILES = (2048, 1024, 512, 256)
RANGE_TILES = (1024, 512, 256)
RESAMPLE_TILES = (1024, 512, 256, 128)

_BARRIERS = 8 * MAX_DEPTH         # one 8-byte mbarrier a slot
_REDUCE = 32 * 4                  # a block reduction's 32 words
#: the longest bucket the bucket-stats staged form takes (the most its
#: carry holds; ``kSpan`` in ``csrc/bucket_stats.cu``): a row with a
#: longer one goes to the row form
BUCKET_SPAN = 1024
_BUCKET_PAIRS = 512               # (tail, column) totals a round of the kernel
_RESAMPLE_BEHIND = 33             # staged lanes before a resample tile
#: longest row of the EMA ladder's one-launch form (``kRowMax`` in
#: ``csrc/common.cuh``, ``cuda_lib.ema_row_max()`` on the card), the
#: only form the resample-EMA staged form has
EMA_ROW_MAX = 16_384

#: kernel name -> the last call's choice: form, tile, depth (and, for
#: bucket stats, the rows left to the row form by a bucket longer than
#: the tile)
last_plan: Dict[str, dict] = {}


def dma_buffers() -> int:
    """``TEMPO_TPU_DMA_BUFFERS``: the staging ring's depth, default 2,
    clamped to [2, 8] (one slot overlaps nothing; past 8 the slots crowd
    out the compute's shared memory).  The reference falls back, when the
    variable is unset, to the autotuner's tuned profile
    (``tempo_tpu/tune``) before the default; the port has no tuner yet
    (ROADMAP A14), so unset means 2."""
    n = config.get_int("TEMPO_TPU_DMA_BUFFERS")
    if n is None:
        n = 2
    return max(MIN_DEPTH, min(int(n), MAX_DEPTH))


@dataclass(frozen=True)
class RingPlan:
    """A staged form's launch plan: ``tile`` lanes a work item, ``depth``
    ring slots, ``smem`` bytes of dynamic shared memory a block."""
    tile: int
    depth: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _plane(nbytes: int) -> int:
    """Slot bytes of a plane of ``nbytes`` bytes staged from any
    alignment (``ring::plane_bytes``)."""
    return _align16(nbytes) + 16


def bucket_ring_bytes(C: int, T: int, depth: int) -> int:
    """Shared memory of the bucket-stats staged form (``bucket_ring_layout``
    in ``csrc/bucket_stats.cu``): barriers, a block reduction's 32 words,
    5 + 2C words a 32-lane segment of the largest region (the
    ``BUCKET_SPAN``-lane carry and the tile), four pointers a column, six
    planes of 512 bucket totals, the carry's ids and each column's x and
    valid, and ``depth`` slots of a tile's ids and each column's x and
    valid."""
    G = -(-(BUCKET_SPAN + T) // 32)
    fixed = (_BARRIERS + _REDUCE + _align16(4 * (5 + 2 * C) * G) + 32 * C
             + 4 * 6 * _BUCKET_PAIRS + _align16(4 * BUCKET_SPAN)
             + C * (_align16(4 * BUCKET_SPAN) + _align16(BUCKET_SPAN)))
    return fixed + depth * (_plane(4 * T) + C * (_plane(4 * T) + _plane(T)))


def _halo(bound: int, L: int) -> int:
    return L if bound >= L - 1 else bound + 1


def window_bytes(lanes: int) -> int:
    """Shared memory of a range-stats window of ``lanes`` lanes: a 16-byte
    entry a lane and one more every 8 (``win_entries`` in
    ``csrc/window.cuh``)."""
    return 16 * (lanes + (lanes >> 3) + 1)


def range_ring_bytes(mb: int, ma: int, L: int, T: int, depth: int) -> int:
    """Shared memory of the range-stats staged form (``range_ring_layout``
    in ``csrc/range_stats.cu``): barriers, reduction scratch, the window of
    the tile and its halo (``mb + 1`` lanes behind, ``ma + 1`` ahead; a
    16-byte entry a lane and one more every 8 lanes) and ``depth`` slots
    of the keys, x and valid of those lanes inside the row."""
    lanes = T + _halo(int(mb), L) + _halo(int(ma), L)
    span = min(lanes, L)
    return (_BARRIERS + _REDUCE + window_bytes(lanes)
            + depth * (2 * _plane(4 * span) + _plane(span)))


def resample_ring_bytes(L: int, T: int, depth: int) -> int:
    """Shared memory of the resample-EMA staged form
    (``resample_ring_layout`` in ``csrc/resample_ema.cu``): barriers, the
    register ladder's two planes of 32 * ceil(L / 32) floats and ``depth``
    slots of a tile's secs, x and valid with the 33 lanes before it."""
    slot = (2 * _plane(4 * (T + _RESAMPLE_BEHIND))
            + _plane(T + _RESAMPLE_BEHIND))
    return _BARRIERS + 8 * 32 * -(-L // 32) + depth * slot


def _plan(L: int, tiles: Sequence[int], nbytes, depth: Optional[int],
          limit: int = SMEM_LIMIT) -> Optional[RingPlan]:
    """First (tile, depth) that fits ``limit`` bytes: the widest tile at
    the asked depth (:func:`dma_buffers` when None), then narrower ones,
    then the same at depth 2 (``plan_with_ring``'s fallback).  None where
    nothing fits."""
    depth = dma_buffers() if depth is None else depth
    depth = max(MIN_DEPTH, min(int(depth), MAX_DEPTH))
    for want in ([depth, MIN_DEPTH] if depth > MIN_DEPTH else [MIN_DEPTH]):
        for T in tiles:
            n_tiles = -(-L // T)
            if n_tiles < 2:
                continue
            d = max(MIN_DEPTH, min(want, n_tiles))
            smem = nbytes(T, d)
            if smem <= limit:
                return RingPlan(T, d, smem)
    return None


def bucket_plan(C: int, L: int,
                depth: Optional[int] = None) -> Optional[RingPlan]:
    """Plan of the bucket-stats staged form for C columns of L lanes, or
    None (the row form).  A row's buckets must also be at most
    ``BUCKET_SPAN`` lanes long; the kernel leaves rows that have a longer
    one to the row form.  The budget is ``BUCKET_SMEM``: the kernel is
    sized for two blocks an SM."""
    return _plan(L, BUCKET_TILES, lambda T, d: bucket_ring_bytes(C, T, d),
                 depth, BUCKET_SMEM)


def range_plan(mb: int, ma: int, L: int,
               depth: Optional[int] = None) -> Optional[RingPlan]:
    """Plan of the range-stats staged form at row bounds (mb, ma), or
    None (the row form: no slot fits the halo)."""
    return _plan(L, RANGE_TILES,
                 lambda T, d: range_ring_bytes(mb, ma, L, T, d),
                 depth)


def resample_plan(L: int,
                  depth: Optional[int] = None) -> Optional[RingPlan]:
    """Plan of the resample-EMA staged form, or None (the row form: a row
    past ``EMA_ROW_MAX`` lanes, which the ladder takes in two launches, or
    no slot fits beside the row's ladder)."""
    if L > EMA_ROW_MAX:
        return None
    return _plan(L, RESAMPLE_TILES,
                 lambda T, d: resample_ring_bytes(L, T, d),
                 depth)


def pick(kernel: str, plan: Optional[RingPlan], form: Optional[str],
         what: str) -> Optional[RingPlan]:
    """The plan a wrapper launches: ``plan`` (None for the row form)
    unless the private ``form`` ("row" | "ring") forces one; forcing the
    staged form where nothing fits raises.  Records the choice in
    :data:`last_plan`."""
    if form not in (None, "row", "ring"):
        raise ValueError(f"form must be 'row' or 'ring', got {form!r}")
    if form == "row":
        plan = None
    elif form == "ring" and plan is None:
        raise ValueError(f"{kernel}: no staged plan fits {what}")
    last_plan[kernel] = (
        {"form": "row"} if plan is None else
        {"form": "ring", "tile": plan.tile, "depth": plan.depth,
         "smem": plan.smem})
    return plan
