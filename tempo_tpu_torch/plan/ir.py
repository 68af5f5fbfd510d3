"""Plan IR: deferred op nodes for TSDF / DistributedTSDF chains.

Counterpart of ``tempo_tpu/plan/ir.py``: the same node ops, parameter
canonicalisation and :func:`signature` (the same sha1 over the same
text), so a chain recorded in both packages has the same logical
signature.

A plan is a small DAG of :class:`Node`\\ s.  Source nodes carry the
actual frame as an execution-only ``payload``; op nodes carry the call
parameters in canonical (hashable, order-stable) form.  The *logical
signature* of a plan hashes only structure + parameters — two plans
recorded over different frames with the same schema and op chain share
a signature, which is exactly what lets the executable cache serve
millions of repeated queries without re-planning (ROADMAP north star).
Anything data-identity-like (shapes, dtypes, the mesh) lives in the
cache key (:func:`state_key`), not the signature.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: Methods of the eager classes that record plan nodes (class name ->
#: method names): each calls ``_plan_record`` under
#: :func:`tempo_tpu_torch.plan.recording`.
PLANNED_METHODS = {
    "TSDF": (
        "select", "selectExpr", "filter", "withColumn", "asofJoin",
        "withRangeStats", "EMA", "resample", "resampleEMA",
        "interpolate", "on_mesh",
    ),
    "DistributedTSDF": (
        "asofJoin", "withRangeStats", "EMA", "resample", "interpolate",
        "calc_bars", "fourier_transform", "withLookbackFeatures",
    ),
}

#: Ops whose execution forces a device->host materialisation (the
#: optimizer marks these in the plan; dist.py logs the same barrier at
#: execution time).
BARRIER_OPS = ("collect", "lookback_features")

_opaque_counter = itertools.count()


def canon(value):
    """Canonical hashable form of an op parameter.  Unhashable /
    identity-bearing values (callables, arrays) become unique opaque
    tokens — the node still records and executes, but the plan is
    marked uncacheable (two lambdas with equal source are not provably
    the same query)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.generic) and value.shape == ():
        # numpy scalars (np.int64 window widths out of pandas/numpy
        # arithmetic are routine) collapse to the Python scalar —
        # leaving them opaque would silently mark every such plan
        # uncacheable and re-trace per call
        return canon(value.item())
    if isinstance(value, (list, tuple)):
        return tuple(canon(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((str(k), canon(v)) for k, v in value.items()))
    return ("?opaque", next(_opaque_counter))


def is_opaque(cv) -> bool:
    if isinstance(cv, tuple):
        if len(cv) == 2 and cv[0] == "?opaque":
            return True
        return any(is_opaque(v) for v in cv)
    return False


class Node:
    """One deferred op (or source) in a plan DAG."""

    __slots__ = ("op", "params", "inputs", "payload", "objs", "ann")

    def __init__(self, op: str, params: Dict[str, object] = None,
                 inputs: Tuple["Node", ...] = (), payload=None,
                 objs: Dict[str, object] = None):
        self.op = op
        self.params: Tuple[Tuple[str, object], ...] = tuple(
            sorted((k, canon(v)) for k, v in (params or {}).items())
        )
        self.inputs = tuple(inputs)
        self.payload = payload          # source nodes: the actual frame
        self.objs = dict(objs or {})    # execution-only values (mesh, fns)
        self.ann: Dict[str, object] = {}  # optimizer annotations

    # -- structure ------------------------------------------------------

    def param(self, name: str, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default

    def is_source(self) -> bool:
        # ``unified_scan``: the query plane's history + live source
        # (``query/unified.py``, ``StreamTable.frame()``)
        return self.op in ("source", "dist_source", "unified_scan")

    def walk(self) -> Iterable["Node"]:
        """Post-order DFS (inputs before the node), each node once."""
        seen = set()

        def rec(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in n.inputs:
                yield from rec(c)
            yield n

        yield from rec(self)

    def sources(self) -> List["Node"]:
        return [n for n in self.walk() if n.is_source()]

    def uncacheable(self) -> bool:
        return any(
            is_opaque(v) for n in self.walk() for _, v in n.params
        )

    def __repr__(self) -> str:
        ps = ", ".join(f"{k}={v!r}" for k, v in self.params)
        return f"Node({self.op}{': ' if ps else ''}{ps})"


def signature(root: Node) -> str:
    """Stable logical-plan signature: structure + canonical params
    (payloads excluded).  Annotated (optimized) plans fold their
    annotations in, so a rewritten plan never collides with its
    un-rewritten twin."""
    h = hashlib.sha1()
    index = {}
    for i, n in enumerate(root.walk()):
        index[id(n)] = i
        h.update(
            f"{i}:{n.op}{n.params!r}"
            f"<{tuple(index[id(c)] for c in n.inputs)}>"
            f"@{tuple(sorted((k, repr(v)) for k, v in n.ann.items()))}"
            .encode()
        )
    return h.hexdigest()[:16]


def _frame_state(frame) -> tuple:
    """Shape/dtype/mesh/device state of one source frame: the part of the
    cache key that invalidates built executables (and their captured
    graphs) when the packed shapes or the device change."""
    from tempo_tpu_torch.dist import DistributedTSDF

    unified = getattr(frame, "_unified_state", None)
    if unified is not None:
        # a unified_scan payload (query/unified.UnifiedSource): its
        # version counter advances on every tail append and store sync,
        # so re-running a standing plan over grown data is a cache miss
        # by construction, while a same-version re-read hits
        return unified()
    if isinstance(frame, DistributedTSDF):
        return ("dist", _mesh_state(frame.mesh), frame.K_dev, frame.L,
                tuple(frame.cols), tuple(frame.host_cols),
                frame.resampled, frame.seq_col, str(frame.dtype),
                # the packed layout: a series-local (jointly sharded)
                # frame runs different shard programs than a
                # time-sharded one of the same shapes
                frame.series_axis, frame.time_axis)
    df = frame.df
    return ("host", len(df), tuple(df.columns),
            tuple(str(t) for t in df.dtypes),
            frame.ts_col, tuple(frame.partitionCols),
            frame.sequence_col or "", str(frame.device), str(frame.dtype))


def _mesh_state(mesh) -> tuple:
    """A port ``Mesh`` by axis names, shape, the shards'
    ``torch.device``s and their owner ranks."""
    if mesh is None:
        return ("default-mesh",)
    return (tuple(mesh.axis_names),
            tuple(sorted(mesh.shape.items())),
            tuple(str(d) for d in mesh.devices.flat),
            tuple(int(r) for r in mesh.ranks.flat))


def state_key(root: Node) -> Optional[tuple]:
    """Executable-cache key: (logical signature, per-source
    shapes/dtypes, mesh objects referenced by the plan).  None when the
    plan is uncacheable (opaque params)."""
    if root.uncacheable():
        return None
    meshes = tuple(
        _mesh_state(n.objs["mesh"]) for n in root.walk()
        if "mesh" in n.objs
    )
    return (signature(root),
            tuple(_frame_state(n.payload) for n in root.sources()),
            meshes)


# ----------------------------------------------------------------------
# Output-schema inference (drives dead-column pruning and explain())
# ----------------------------------------------------------------------

def _range_stats_names():
    from tempo_tpu_torch import packing

    return packing.RANGE_STATS


def output_columns(node: Node) -> Optional[List[str]]:
    """Column names this node's result exposes, or None when the op's
    output schema cannot be inferred statically (pruning then treats
    everything upstream as live)."""
    if node.op == "source":
        return list(node.payload.df.columns)
    if node.op == "unified_scan":
        return list(node.payload.columns)
    if node.op == "dist_source":
        p = node.payload
        return (list(p.partitionCols) + [p.ts_col] + list(p.cols)
                + list(p.host_cols))
    if not node.inputs:
        return None
    cols = output_columns(node.inputs[0])
    if cols is None:
        return None
    if node.op in ("on_mesh", "reshard", "checkpoint", "sql_filter"):
        return cols
    if node.op == "sql_project":
        return list(node.param("aliases", ()))
    if node.op == "select":
        sel = node.param("cols", ())
        if "*" in sel:
            return cols
        return list(sel)
    if node.op == "with_column":
        name = node.param("colName")
        return cols + ([name] if name not in cols else [])
    if node.op == "range_stats":
        pick = node.param("colsToSummarize")
        picked = list(pick) if pick else None
        if picked is None:
            return None  # "all numeric" needs dtypes; stay conservative
        return cols + [f"{s}_{c}" for c in picked
                       for s in _range_stats_names()]
    if node.op in ("ema", "ema_stream"):
        return cols + [f"EMA_{node.param('colName')}"]
    if node.op == "asof_join":
        right = output_columns(node.inputs[1])
        if right is None:
            return None
        lp = node.param("left_prefix")
        rp = node.param("right_prefix") or "right"
        ren = (lambda c: f"{lp}_{c}") if lp else (lambda c: c)
        # structural cols keep their names on the left; right side is
        # uniformly prefixed (incl. its ts col)
        return [ren(c) for c in cols] + [f"{rp}_{c}" for c in right]
    return None


def consumed_columns(node: Node) -> Optional[List[str]]:
    """Columns an op reads by name (beyond structural), or None for
    "potentially all"."""
    if node.op in ("select",):
        return list(node.param("cols", ()))
    if node.op in ("sql_project", "sql_filter"):
        # sql_compile stores the (compile-time resolved) column refs of
        # the parsed expressions in params, so pruning reads them here
        # without re-walking the ASTs
        return list(node.param("cols", ()))
    if node.op == "with_column":
        return None
    if node.op == "range_stats":
        pick = node.param("colsToSummarize")
        return list(pick) if pick else None
    if node.op == "ema":
        return [node.param("colName")]
    if node.op == "resample_ema":
        return [node.param("colName")]
    if node.op == "resample":
        pick = node.param("metricCols")
        return list(pick) if pick else None
    if node.op == "calc_bars":
        pick = node.param("metricCols")
        return list(pick) if pick else None
    if node.op == "interpolate":
        pick = node.param("target_cols")
        return list(pick) if pick else None
    if node.op == "fourier":
        return [node.param("valueCol")]
    if node.op in ("collect", "count", "on_mesh", "reshard",
                   "checkpoint"):
        return []
    return None
