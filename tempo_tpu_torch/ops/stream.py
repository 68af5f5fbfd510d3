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
the bytes a slot takes and a shared-memory budget a block
(``BUCKET_SMEM``, two blocks an SM, for bucket stats and the resample
EMA; range stats :func:`range_smem`, the row form's threads an SM, then
``SMEM_LIMIT``, the most one block may take).  The planner tries the
widths in ``*_TILES`` from the widest down at the asked depth, then at
depth 2; it needs at least two tiles a ring (one tile has nothing to
overlap, as ``ring_plan`` refuses fewer than two slabs) and clamps the
depth to the tile count.  Where nothing fits it returns None and the caller takes
the row form.  The choice is made by shape, on the host, before the
launch; each form counts its own launches (``cuda_lib.launches``:
``bucket_stats`` and ``bucket_stats_ring``, ...), and :data:`last_plan`
records the last choice of each kernel (with its grid: ``blocks`` and
the most ``items`` a block's ring walks).

The reference engages its ring only above depth 2: at the default depth
``plan_with_ring`` returns ``use_ring=False`` and its kernels run the
BlockSpec pipeline, with no ring.  The port takes the staged form at
depth 2 too, by its own rule (a slot fits, two tiles a ring); both give
the same bits, only the route differs.

Range stats' staged form spreads over the card: its (column, row, tile)
items are cut into one contiguous run a block (:func:`ring_runs`), the
grid the SM count times the blocks an SM holds; a block carries its
tile's halo along its run from one of two windows to the other.
The resample EMA's staged form runs a ring a warp, each warp streaming
its own run of segments in items of ``T`` lanes.

The byte counts mirror the kernels' shared-memory layouts
(``*_ring_layout`` in the sources); ``cuda_lib`` exports the kernels'
own totals (``tempo_*_ring_smem``) so a run on the card can check them.

``pallas_stream.grid_semantics`` and ``TEMPO_TPU_MEGACORE`` have no
counterpart: they split a TPU grid over two TensorCores, and a CUDA
grid's blocks run in parallel already.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: dynamic shared memory one block may take on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: shared memory an SM (228 KB) and the share of it each resident block
#: reserves
SM_SMEM, BLOCK_RESERVE = 233_472, 1024
#: the bucket-stats and resample-EMA staged forms' budget: two blocks an
#: SM (115,712 bytes)
BUCKET_SMEM = SM_SMEM // 2 - BLOCK_RESERVE
#: threads a range-stats staged block of tile T has (a thread walks four
#: outputs), and the threads an SM holds at the row form's occupancy
#: (four blocks of 256 threads)
RANGE_LANES, RANGE_SM_THREADS = 4, 1024
#: the ring's depth range (``pallas_stream.dma_buffers``' clamp) and slot cap
MIN_DEPTH, MAX_DEPTH = 2, 8
#: tile widths each planner tries, widest first; the last is the floor
BUCKET_TILES = (2048, 1024, 512, 256)
RANGE_TILES = (1024, 512, 256)
#: the resample EMA's are the lanes of a warp's item
RESAMPLE_TILES = (512, 256, 128)

_BARRIERS = 8 * MAX_DEPTH         # one 8-byte mbarrier a slot
_REDUCE = 32 * 4                  # a block reduction's 32 words
_LADDER_WARPS = 16                # the register ladder's warps a block
#: the longest bucket the bucket-stats staged form takes (the most its
#: carry holds; ``kSpan`` in ``csrc/bucket_stats.cu``): a row with a
#: longer one goes to the row form
BUCKET_SPAN = 1024
_BUCKET_PAIRS = 512               # (tail, column) totals a round of the kernel
#: longest row of the EMA ladder's one-launch form (``kRowMax`` in
#: ``csrc/common.cuh``, ``cuda_lib.ema_row_max()`` on the card), the
#: only form the resample-EMA staged form has
EMA_ROW_MAX = 16_384

#: kernel name -> the last call's choice: form, tile, depth (and, for
#: bucket stats, the rows left to the row form by a bucket longer than
#: the tile)
last_plan: Dict[str, dict] = {}


def dma_buffers() -> int:
    """``TEMPO_TPU_DMA_BUFFERS``: the staging ring's depth, clamped to
    [2, 8] (one slot overlaps nothing; past 8 the slots crowd out the
    compute's shared memory).  Unset falls back to the tuned profile's
    value (``tempo_tpu_torch/tune``, the autotuner's measured winner for
    this card), then to 2."""
    from tempo_tpu_torch import tune

    n = tune.resolve("TEMPO_TPU_DMA_BUFFERS", 2)
    return max(MIN_DEPTH, min(n, MAX_DEPTH))


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
    in ``csrc/range_stats.cu``): barriers, two windows of the tile and
    its halo (``mb + 1`` lanes behind, ``ma + 1`` ahead; a 16-byte entry a
    lane and one more every 8 lanes) and ``depth`` slots of the keys, x
    and valid of those lanes inside the row (the most an item stages)."""
    lanes = T + _halo(int(mb), L) + _halo(int(ma), L)
    span = min(lanes, L)
    return (_BARRIERS + 2 * window_bytes(lanes)
            + depth * (2 * _plane(4 * span) + _plane(span)))


def resample_ring_bytes(L: int, T: int, depth: int) -> int:
    """Shared memory of the resample-EMA staged form
    (``resample_ring_layout`` in ``csrc/resample_ema.cu``): a ring of
    ``depth`` barriers a warp, the register ladder's two planes of
    32 * ceil(L / 32) floats and 16 bytes each (secs and x land there, in
    place) and ``depth`` slots a warp of an item's ``T`` valid bytes."""
    return (_align16(8 * _LADDER_WARPS * depth)
            + 2 * (4 * 32 * -(-L // 32) + 16)
            + _LADDER_WARPS * depth * _plane(T))


def ring_runs(items: int, blocks: int) -> List[Tuple[int, int]]:
    """The range-stats staged form's partition: block b walks the items
    [b * items // blocks, (b + 1) * items // blocks), so the runs are
    contiguous, cover every item once and differ by at most one item."""
    return [(b * items // blocks, (b + 1) * items // blocks)
            for b in range(blocks)]


def _depths(depth: Optional[int]) -> List[int]:
    depth = dma_buffers() if depth is None else depth
    depth = max(MIN_DEPTH, min(int(depth), MAX_DEPTH))
    return [depth, MIN_DEPTH] if depth > MIN_DEPTH else [MIN_DEPTH]


def _plan(lanes: int, tiles: Sequence[int], nbytes, depth: Optional[int],
          limit: int = SMEM_LIMIT) -> Optional[RingPlan]:
    """First (tile, depth) that fits ``limit`` bytes: the widest tile at
    the asked depth (:func:`dma_buffers` when None), then narrower ones,
    then the same at depth 2 (the port's own fallback: the reference's
    ``plan_with_ring`` runs no ring at depth 2).  A ring walks ``lanes``
    lanes.  None where nothing fits."""
    for want in _depths(depth):
        for T in tiles:
            n_tiles = -(-lanes // T)
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


def range_smem(T: int) -> int:
    """The range-stats staged form's first budget at tile ``T``: the
    shared memory a block may take for the SM to hold the row form's
    threads (``RANGE_SM_THREADS``) in blocks of ``T / 4`` threads: 57,344
    bytes at T = 1024, 28,160 at 512, 13,568 at 256."""
    blocks = RANGE_SM_THREADS * RANGE_LANES // T
    return SM_SMEM // blocks - BLOCK_RESERVE


def range_candidates(L: int, depth: Optional[int] = None
                     ) -> Iterator[Tuple[int, int, int]]:
    """The range-stats planner's candidates in its order, (budget, tile,
    depth): each tile's :func:`range_smem` first, then ``SMEM_LIMIT``; in
    each the asked depth, then depth 2; the widest tile first.  Rows of
    fewer than two tiles have none."""
    for full in (False, True):
        for want in _depths(depth):
            for T in RANGE_TILES:
                n_tiles = -(-L // T)
                if n_tiles >= 2:
                    yield (SMEM_LIMIT if full else range_smem(T), T,
                           max(MIN_DEPTH, min(want, n_tiles)))


def range_plan(mb: int, ma: int, L: int,
               depth: Optional[int] = None) -> Optional[RingPlan]:
    """Plan of the range-stats staged form at row bounds (mb, ma), or
    None (the row form: no windows and slots fit the halo): the first of
    :func:`range_candidates` that fits its budget."""
    for limit, T, d in range_candidates(L, depth):
        smem = range_ring_bytes(mb, ma, L, T, d)
        if smem <= limit:
            return RingPlan(T, d, smem)
    return None


def resample_run(L: int) -> int:
    """Lanes of the longest run of segments a warp of the resample-EMA
    staged form streams: ceil(G / 16) of the row's G = ceil(L / 32)
    segments (``ema_block``'s row phase), cut at the row's end."""
    G = -(-L // 32)
    return min(32 * -(-G // _LADDER_WARPS), L)


def resample_plan(L: int,
                  depth: Optional[int] = None) -> Optional[RingPlan]:
    """Plan of the resample-EMA staged form, or None (the row form: a row
    past ``EMA_ROW_MAX`` lanes, which the ladder takes in two launches, or
    no slot fits beside the row's ladder within ``BUCKET_SMEM``, two
    blocks an SM).  A ring is a warp's run of ceil(G / 16) of the row's
    G segments; ``tile`` is the lanes of its items."""
    if L > EMA_ROW_MAX:
        return None
    return _plan(resample_run(L), RESAMPLE_TILES,
                 lambda T, d: resample_ring_bytes(L, T, d), depth,
                 BUCKET_SMEM)


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


def record_grid(kernel: str, blocks: int, items: int) -> None:
    """Add a staged launch's grid to :data:`last_plan`: ``blocks`` and
    the most ``items`` one ring walks."""
    last_plan[kernel].update(blocks=int(blocks), items=int(items))
