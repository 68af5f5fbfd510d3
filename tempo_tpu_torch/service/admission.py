"""Runtime admission control: project a query's device footprint and
reject or queue it before anything builds or launches.

Counterpart of ``tempo_tpu/service/admission.py``.  Two budgets:

* **Shared memory a block** (the knob keeps the reference's name,
  ``TEMPO_TPU_SERVICE_VMEM_BUDGET``, and :class:`Footprint` keeps
  ``vmem_bytes``).  The reference folds each op's worst per-step VMEM
  block through ``pallas_kernels._plan`` against the TPU's scoped
  budget.  On Hopper the matching limit is the dynamic shared memory one
  block may take (``ops.stream.SMEM_LIMIT``, 232,448 bytes), which is
  also the default budget.  For the reference's three ops the projection
  is the largest block any form of the op's kernels may take at the
  plan's packed geometry, from the host-side formulas the kernels are
  planned with:

  - ``range_stats``: the largest block ``ops.stream.range_plan``
    stages at any row bound (the bounds depend on the data, which
    admission does not read; :func:`range_stats_smem`), or the row
    form's fixed window (:data:`RANGE_ROW_SMEM`);
  - ``asof_join``: the larger of the merge walk's and the tile kernel's
    fixed layouts (:data:`ASOF_WALK_SMEM`, :data:`ASOF_TILE_SMEM`);
  - ``fused_asof_stats_ema``: the largest of the join, and range stats
    and the EMA ladder (:func:`ema_ladder_smem`) over the joined rows,
    which are the left frame's.

  Every form the kernels plan fits ``SMEM_LIMIT`` by construction (the
  planners take the row form where no staged tile fits), so under the
  default budget nothing is rejected for shared memory; a budget set
  below a chain's projection rejects it with :class:`AdmissionError`, by
  name, at submit.  Where no staged plan fits, the row form's bytes are
  reported: the smallest block the op can run with, as the reference
  reports its minimal ``[8, L]`` block.
* **Device memory** (``TEMPO_TPU_SERVICE_HBM_BUDGET``, default 2 GiB):
  the reference's model, every source's packed planes plus the two
  widest op results, ``K * L * (8 + 5 * planes)`` bytes a frame from
  ``optimizer._device_plane_count`` and ``packing.pad_length``, plus one
  term of the port's own: the device bytes of each CUDA graph the plan
  captures (:func:`graph_bytes`).  XLA's buffers lie inside the
  reference's model, but a CUDA graph keeps a private pool (its outputs
  and intermediates) and clones of its static inputs beside the frames,
  which the model does not count: without the term a budget between
  the model and the real peak admitted a query that then took more than
  the budget.  Where the planner's cache holds the plan's captured
  graph, the term is what it keeps (``Captured.nbytes``); otherwise an
  estimate from the node's packed geometry (:func:`fused_graph_estimate`,
  :func:`stitched_graph_estimate`).  Admission captures nothing, and a
  plan whose graphs would not be captured (on the CPU, or a mesh over
  several processes) adds nothing.  A query over the whole budget is
  rejected; one over the currently free share queues until running
  queries release theirs.

No card is needed: admission runs on the host before anything launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tempo_tpu_torch.ops import merge as ops_merge
from tempo_tpu_torch.ops import stream as ops_stream
from tempo_tpu_torch.ops import window as ops_window
from tempo_tpu_torch.plan import ir

#: default total device-memory admission budget (bytes) when unset
_DEFAULT_HBM_BUDGET = 2 << 30

#: the range-stats row form's shared memory at its widest window
#: (``ops.window.ROW_WINDOW`` lanes); ``cuda_lib.range_row_smem()`` is
#: the compiler's figure, which ``chip_smoke.py`` holds this to
RANGE_ROW_SMEM = ops_stream.window_bytes(ops_window.ROW_WINDOW)
#: the merge walk's shared memory with the sid and sequence planes
#: (``asof_walk_kernel`` in ``csrc/asof_merge.cu``, steps of
#: ``WALK_STEP`` positions, ``WALK_COLS`` right columns, 4 warp segments):
#: the dynamic ring of the step's rows a side (int64 keys and sequence,
#: int32 sids) and its left rows' ranks, then the static validity words,
#: segment and column carries and the left-row count, which the
#: compiler pads to 16 bytes; ``cuda_lib.asof_walk_smem()`` is the
#: compiler's figure
WALK_STEP, WALK_COLS, _WALK_SEGS = 1024, 32, 4
_WALK_STATIC = (WALK_COLS * _WALK_SEGS * 8 * 4
                + 2 * WALK_COLS * _WALK_SEGS * 4 + WALK_COLS * 4 + 4)
ASOF_WALK_SMEM = (2 * WALK_STEP * (8 + 8 + 4) + WALK_STEP * 4
                  + -(-_WALK_STATIC // 16) * 16)
#: the lookback kernels' tile join (``ops.merge.LOOKBACK_TILE``
#: positions: two int64 and four int32 planes, 256 scan words and 32
#: reduction words); ``cuda_lib.asof_tile_smem()`` is the compiler's
#: figure
ASOF_TILE_SMEM = (ops_merge.LOOKBACK_TILE * (8 + 8 + 4 * 4)
                  + 256 * 4 + 32 * 4)
ASOF_SMEM = max(ASOF_WALK_SMEM, ASOF_TILE_SMEM)

_OPS = ("range_stats", "fused_asof_stats_ema", "asof_join")


class AdmissionError(RuntimeError):
    """A query's projected footprint exceeds the service budget: the
    named rejection the admission controller raises instead of queueing a
    query that could never run."""

    def __init__(self, message: str, hbm_bytes: int = 0,
                 vmem_bytes: int = 0):
        super().__init__(message)
        self.hbm_bytes = hbm_bytes
        self.vmem_bytes = vmem_bytes


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Projected device working set of one query: ``hbm_bytes`` of
    device memory and ``vmem_bytes``, the shared memory of the largest
    block any of its kernels may take."""

    hbm_bytes: int
    vmem_bytes: int


def vmem_budget_bytes() -> int:
    """``TEMPO_TPU_SERVICE_VMEM_BUDGET``; unset = ``ops.stream.
    SMEM_LIMIT``, so by default admission rejects exactly what no kernel
    form could launch.  An explicit 0 means 0 (admit nothing)."""
    from tempo_tpu_torch import config

    val = config.get_int("TEMPO_TPU_SERVICE_VMEM_BUDGET")
    return ops_stream.SMEM_LIMIT if val is None else val


def hbm_budget_bytes() -> int:
    """``TEMPO_TPU_SERVICE_HBM_BUDGET``; unset = 2 GiB.  An explicit 0
    means 0 (admit nothing)."""
    from tempo_tpu_torch import config

    val = config.get_int("TEMPO_TPU_SERVICE_HBM_BUDGET")
    return _DEFAULT_HBM_BUDGET if val is None else val


def _geometry(node: ir.Node) -> Optional[tuple]:
    """(K, L) packed geometry of the frame feeding ``node``, walked down
    the primary input chain to a source; None when no source geometry is
    derivable."""
    import numpy as np

    from tempo_tpu_torch import packing

    cur = node
    while True:
        if cur.op == "dist_source":
            p = cur.payload
            return int(p.K_dev), int(p.L)
        if cur.op == "source":
            lay = cur.payload.layout
            L = packing.pad_length(int(np.max(lay.lengths, initial=0)))
            return int(lay.n_series), L
        if not cur.inputs:
            return None
        cur = cur.inputs[0]


def _node_hbm_bytes(node: ir.Node) -> int:
    """Packed plane bytes this node's result holds (int64 keys, and a
    float32 value and a bool validity plane a column) from the
    optimizer's plane-count model; the fallback doubles the input."""
    from tempo_tpu_torch.plan import optimizer

    geom = _geometry(node)
    if geom is None:
        return 0
    K, L = geom
    planes = optimizer._device_plane_count(node)
    if planes is None:
        planes = 2 * max(1, len(node.inputs))
    return K * L * (8 + 5 * int(planes))


def _largest_fitting(nbytes, hi: int, limit: int) -> int:
    """Largest ``mb`` in [0, hi] with ``nbytes(mb) <= limit`` (the bytes
    grow with ``mb``), -1 when none."""
    if nbytes(0) > limit:
        return -1
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if nbytes(mid) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def range_stats_smem(L: int) -> int:
    """Largest block of range stats over rows of ``L`` lanes, whatever
    the data's row bounds: the row form's fixed window, or the largest
    block ``ops.stream.range_plan`` returns at any row bound.  Each of
    the planner's candidates (``ops.stream.range_candidates``) fits up to
    a largest bound and its bytes grow with the bound, and the planner
    takes the first that fits; so a candidate is taken, if at all, up to
    its own largest bound, and the largest block is the planner's plan at
    one of those bounds (or at the widest, L - 1)."""
    hi = max(0, L - 1)
    bounds = {hi}
    for limit, T, d in ops_stream.range_candidates(L):
        mb = _largest_fitting(
            lambda mb, T=T, d=d: ops_stream.range_ring_bytes(mb, 0, L, T, d),
            hi, limit)
        if mb >= 0:
            bounds.add(mb)
    worst = RANGE_ROW_SMEM
    for mb in bounds:
        plan = ops_stream.range_plan(mb, 0, L)
        if plan is not None:
            worst = max(worst, plan.smem)
    return worst


def ema_ladder_smem(L: int) -> int:
    """Largest block of the EMA ladder over rows of ``L`` lanes
    (``launch_ema_ladder`` in ``csrc/common.cuh``): 8 bytes a lane of
    whole 32-lane segments up to ``EMA_ROW_MAX`` lanes; past it the
    stage-1 windows of 8192 lanes and the class stage's 16 bytes a class
    entry of 1024 lanes, at most ``SMEM_LIMIT``."""
    if L <= ops_stream.EMA_ROW_MAX:
        return 8 * 32 * -(-L // 32)
    return max(8 * 8192, min(16 * -(-L // 1024), ops_stream.SMEM_LIMIT))


def _node_vmem_bytes(node: ir.Node) -> int:
    """Shared memory of the largest block the kernels of this op may
    take at its packed geometry (see module docstring)."""
    if node.op not in _OPS:
        return 0
    geom = _geometry(node)
    if geom is None:
        return 0
    _, L = geom
    if node.op == "asof_join":
        return ASOF_SMEM
    if node.op == "range_stats":
        return range_stats_smem(L)
    return max(ASOF_SMEM, range_stats_smem(L), ema_ladder_smem(L))


#: plan ops a card runs as one captured CUDA graph
#: (``plan/fused.py``, ``plan/stitch.py``)
GRAPH_OPS = ("fused_asof_stats_ema", "stitched")
#: device bytes a lane of the fused node's graph holds beyond its value
#: planes: the static input clones' int64 left and right keys and left
#: mask; the join's int64 last-row index; the int64 seconds, their
#: rebase and clamp, and the int32 rebased seconds range stats read
_FUSED_FIXED = 8 + 8 + 1 + 8 + 3 * 8 + 4


def _mesh_of(node: ir.Node):
    """(mesh, device of the source frame) under ``node``'s primary
    input chain; the mesh is None for a frame not on one."""
    cur = node
    while True:
        if cur.op == "dist_source":
            return cur.payload.mesh, None
        if cur.op == "on_mesh":
            src = cur.inputs[0].payload if cur.inputs else None
            return cur.objs.get("mesh"), getattr(src, "device", None)
        if not cur.inputs:
            return None, None
        cur = cur.inputs[0]


def captures(node: ir.Node) -> bool:
    """Whether a card captures ``node`` as a CUDA graph: a graph op
    whose mesh lies in one process, over CUDA devices (a default mesh
    is every card, for a CUDA frame)."""
    import torch

    if node.op not in GRAPH_OPS:
        return False
    mesh, dev = _mesh_of(node)
    if mesh is None:
        return dev is not None and torch.device(dev).type == "cuda"
    return mesh.n_processes == 1 and all(
        torch.device(d).type == "cuda" for d in mesh.devices.flat)


def fused_graph_estimate(node: ir.Node) -> int:
    """Device bytes the graph of a ``fused_asof_stats_ema`` node keeps,
    from its packed geometry: the static input clones (keys, the left
    mask and value planes, the right stacks of the value and three key
    chunk planes with their validity), the static outputs (the joined
    planes and their validity, the masked right columns, seven stats
    planes a summarized column, the EMA) and the intermediates (the
    join's row index, the seconds range stats read, the stats stacks and
    the clipped plane, the EMA ladder's decay plane), float32 values."""
    from tempo_tpu_torch import packing
    from tempo_tpu_torch.plan import optimizer

    geom = _geometry(node)
    if geom is None or len(node.inputs) != 2:
        return 0
    K, L = geom
    n_l = optimizer._device_plane_count(node.inputs[0]) or 1
    n_r = optimizer._device_plane_count(node.inputs[1]) or 1
    picked = node.param("s_cols")
    n_s = len(picked) if picked else n_l + n_r
    ema = 1 if node.param("has_ema") else 0
    n_stats = len(packing.RANGE_STATS)
    per_lane = (_FUSED_FIXED
                + 5 * n_l + 2 * 5 * (n_r + 3)        # inputs and joined
                + 4 * n_r                             # masked right
                + (4 * n_stats + 6 + 4) * n_s         # stats, stacks
                + 2 * 4 * ema)                        # EMA, decay plane
    return K * L * per_lane


def stitched_graph_estimate(node: ir.Node) -> int:
    """Device bytes the graph of a ``stitched`` node keeps: the static
    input clones (its input frame's planes) and each stage's result
    planes (the intermediates, the last one the static outputs), by the
    reference's plane model."""
    cur = node.inputs[0] if node.inputs else None
    if cur is None:
        return 0
    total = _node_hbm_bytes(cur)
    for op, params in node.param("stages") or ():
        cur = ir.Node(op, params=dict(params), inputs=(cur,))
        total += _node_hbm_bytes(cur)
    return total


def graph_bytes(root: ir.Node) -> int:
    """Device bytes of the CUDA graphs the plan's graph nodes keep: what
    the planner's cached executable of the plan holds for a captured
    node (``fused.graph_bytes``: pool and static inputs), the estimate
    for one not captured yet.  With no cached executable the fusion and
    stitching passes run on a copy of the plan to find the graph nodes
    (host work only: nothing is captured or launched)."""
    from tempo_tpu_torch.plan import executor, fused, optimizer
    from tempo_tpu_torch.plan.cache import CACHE

    exe = CACHE.peek(executor.cache_key(root))
    if exe is not None:
        plan = exe.plan
    else:
        plan = optimizer._stitch_chains(
            optimizer._fuse_mesh_chain(optimizer._copy(root)))
    total = 0
    for n in plan.walk():
        held = sum(fused.graph_bytes(n).values())
        if held:
            total += held
        elif captures(n):
            total += (fused_graph_estimate(n)
                      if n.op == "fused_asof_stats_ema"
                      else stitched_graph_estimate(n))
    return total


def project_footprint(root: ir.Node) -> Footprint:
    """Project one plan's working set: all source planes resident plus
    the two widest op results (an op's input and output are live
    together), the reference's model, plus the bytes of the CUDA graphs
    the plan captures (:func:`graph_bytes`); and the largest kernel
    block any op takes."""
    hbm = 0
    op_bytes = []
    vmem = 0
    for n in root.walk():
        if n.is_source():
            hbm += _node_hbm_bytes(n)
        else:
            op_bytes.append(_node_hbm_bytes(n))
            vmem = max(vmem, _node_vmem_bytes(n))
    op_bytes.sort(reverse=True)
    hbm += sum(op_bytes[:2]) + graph_bytes(root)
    return Footprint(hbm_bytes=int(hbm), vmem_bytes=int(vmem))


class AdmissionController:
    """Budget bookkeeping for the query service.  Not itself locked: the
    service serializes calls under its scheduler condition."""

    def __init__(self, hbm_budget: Optional[int] = None,
                 vmem_budget: Optional[int] = None):
        # None = defaults; an explicit 0 is honoured (admit nothing)
        self.hbm_budget = int(
            hbm_budget_bytes() if hbm_budget is None else hbm_budget)
        self.vmem_budget = int(
            vmem_budget_bytes() if vmem_budget is None else vmem_budget)
        self.hbm_in_use = 0

    def check(self, fp: Footprint) -> None:
        """Raise :class:`AdmissionError` when the query could never run
        under the declared budgets (rejected at submit, not queued
        forever)."""
        if fp.vmem_bytes > self.vmem_budget:
            raise AdmissionError(
                f"query rejected: projected worst-case VMEM block (shared "
                f"memory a block) {fp.vmem_bytes} B exceeds the admission "
                f"budget {self.vmem_budget} B "
                f"(TEMPO_TPU_SERVICE_VMEM_BUDGET); no kernel form fits, "
                f"the shape cannot run",
                hbm_bytes=fp.hbm_bytes, vmem_bytes=fp.vmem_bytes)
        if fp.hbm_bytes > self.hbm_budget:
            raise AdmissionError(
                f"query rejected: projected HBM footprint "
                f"{fp.hbm_bytes} B exceeds the TOTAL admission budget "
                f"{self.hbm_budget} B (TEMPO_TPU_SERVICE_HBM_BUDGET); it "
                f"could never be scheduled",
                hbm_bytes=fp.hbm_bytes, vmem_bytes=fp.vmem_bytes)

    def fits_now(self, fp: Footprint) -> bool:
        return self.hbm_in_use + fp.hbm_bytes <= self.hbm_budget

    def acquire(self, fp: Footprint) -> None:
        self.hbm_in_use += fp.hbm_bytes

    def release(self, fp: Footprint) -> None:
        self.hbm_in_use = max(0, self.hbm_in_use - fp.hbm_bytes)
