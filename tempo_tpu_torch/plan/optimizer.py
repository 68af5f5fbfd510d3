"""Optimizer passes over a recorded plan.

Counterpart of ``tempo_tpu/plan/optimizer.py``: the same passes in the
same order (:func:`optimize`).  The decisions are cost-based
(``plan/cost.py``, ``TEMPO_TPU_COST_MODEL``): fusion, stitching, engine
hoisting and reshard placement are argmins over estimated cost among
bitwise-equal alternatives (all join engines; fused vs op-by-op;
stitched vs op-by-op; placed vs declarative resharding), and the range
engine's candidate set is the rule's singleton.  Under the default
priors every decision reproduces the rules.

* **Fusion** — ``resample(freq, 'floor')`` then ``EMA(col, exact=True)``
  over that one metric column becomes one ``resampleEMA`` node (the
  fused resample-EMA kernel, row 10: the column is read once); a mesh
  ``asofJoin -> withRangeStats [-> EMA]`` chain becomes one
  ``fused_asof_stats_ema`` node run as one captured CUDA graph
  (plan/fused.py).  The resampleEMA rewrite produces exactly
  ``TSDF.resampleEMA``'s output.
* **Engine hoisting** — ``pick_join_engine`` / ``pick_range_engine``
  run once at plan time; the decisions are annotated on the nodes
  (``explain()``), and the join engine is installed as a hint
  (plan/hints.py) while the executor replays the node.  The range
  engines differ in rounding, so their pick stays the eager rule.
* **Reshard placement** — explicit ``reshard`` nodes around maximal
  series-local runs on time-sharded mesh chains (``dist.reshard_frame``).
* **Dead-column pruning** — when a downstream ``select`` (or a
  ``count``) bounds the live column set, source frames are pruned
  before packing.
* **Checkpoint barriers, barrier marking, stitching** — see each pass.
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet, Optional, Union

from tempo_tpu_torch.plan import ir

logger = logging.getLogger(__name__)

#: sentinel: "every column may be needed"
ALL = None


def optimize(root: ir.Node) -> ir.Node:
    """A new, annotated (possibly rewritten) plan DAG; the logical plan
    is left untouched."""
    root = _copy(root)
    root = _fuse_sql_filters(root)
    root = _fuse_resample_ema(root)
    root = _fuse_mesh_chain(root)
    _hoist_engines(root)
    _annotate_sql_backends(root)
    root = _place_reshards(root)
    _prune_columns(root)
    _mark_barriers(root)
    root = _place_checkpoints(root)
    # stitching runs LAST so reshard and checkpoint nodes (placed
    # above) are natural stitch boundaries: a resumed chain re-runs
    # only whole post-barrier stitch groups, zero recompiles
    root = _stitch_chains(root)
    return root


def reshard_mode() -> str:
    """``TEMPO_TPU_RESHARD_PLACEMENT`` — how the planner places layout
    switches on time-sharded mesh chains: ``auto`` (default) inserts
    explicit reshard nodes around maximal series-local-preferring op
    runs, sinking/eliminating redundant switches; ``explicit`` reshards
    around every such op individually (never eliminates — the
    debugging view); ``declarative`` places no plan nodes and keeps
    each op's own switch pair (``dist.reshard_frame`` inside the op).
    Part of the executable-cache key (executor.py): flipping the knob
    never replays a plan placed under the other mode."""
    from tempo_tpu_torch import config

    mode = (config.get("TEMPO_TPU_RESHARD_PLACEMENT") or "auto")
    mode = mode.strip().lower()
    return mode if mode in ("auto", "declarative", "explicit") else "auto"


def _copy(root: ir.Node) -> ir.Node:
    memo: Dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        if id(n) in memo:
            return memo[id(n)]
        c = ir.Node.__new__(ir.Node)
        c.op = n.op
        c.params = n.params
        c.inputs = tuple(rec(i) for i in n.inputs)
        c.payload = n.payload
        c.objs = dict(n.objs)
        c.ann = dict(n.ann)
        memo[id(n)] = c
        return c

    return rec(root)


def _rewrite(root: ir.Node, fn) -> ir.Node:
    """Bottom-up node rewriter (``fn(node) -> node``)."""
    memo: Dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        if id(n) in memo:
            return memo[id(n)]
        n.inputs = tuple(rec(i) for i in n.inputs)
        out = fn(n)
        memo[id(n)] = out
        return out

    return rec(root)


def _mesh_processes(node: ir.Node) -> int:
    """Processes the mesh under a mesh-side node spans (1 when the
    mesh is the default one or not derivable)."""
    cur = node
    while True:
        if cur.op == "dist_source":
            return cur.payload.mesh.n_processes
        if cur.op == "on_mesh":
            mesh = cur.objs.get("mesh")
            return 1 if mesh is None else mesh.n_processes
        if not cur.inputs:
            return 1
        cur = cur.inputs[0]


def _note_uncaptured(node: ir.Node, base: ir.Node) -> None:
    """Annotate a fused or stitched node whose mesh spans processes:
    it runs planned but op by op, uncaptured (gloo collectives cannot
    be captured into a CUDA graph)."""
    n = _mesh_processes(base)
    if n > 1:
        node.ann["capture"] = (
            f"uncaptured: the mesh spans {n} processes (gloo collectives "
            f"cannot be captured); runs op by op")


def _mesh_side(node: ir.Node) -> bool:
    cur = node
    while True:
        if cur.op in ("on_mesh", "dist_source"):
            return True
        if not cur.inputs:
            return False
        cur = cur.inputs[0]


# ----------------------------------------------------------------------
# Pass 0: adjacent sql_filter fusion + backend annotation
# ----------------------------------------------------------------------

def _fuse_sql_filters(root: ir.Node) -> ir.Node:
    """``filter(p).filter(q)`` recorded as two ``sql_filter`` nodes
    collapses into ONE with the Kleene-AND predicate — bitwise-equal
    (both keep exactly the rows where p AND q is TRUE; row-wise pandas
    evaluation is pure, so evaluating q before p's row drop changes no
    surviving value) and one mask evaluation instead of two."""
    from tempo_tpu_torch import sql

    def fn(n: ir.Node) -> ir.Node:
        if n.op != "sql_filter" or not n.inputs:
            return n
        inner = n.inputs[0]
        if inner.op != "sql_filter":
            return n
        a, b = inner.objs.get("ast"), n.objs.get("ast")
        if a is None or b is None:
            return n
        combined = sql.And(a, b)
        fused = ir.Node("sql_filter", params=dict(
            condition=sql.unparse(combined), ast=combined.canon(),
            cols=tuple(sorted(set(inner.param("cols", ()))
                              | set(n.param("cols", ())))),
            strict=bool(inner.param("strict")) or bool(n.param("strict"))),
            inputs=inner.inputs, objs=dict(ast=combined))
        fused.ann["rewrite"] = (
            "adjacent sql_filter predicates AND-fused into one node "
            "(one mask evaluation instead of two)")
        return fused

    return _rewrite(root, fn)


def _derived_dtypes(node: ir.Node):
    """Static column->dtype map of a node's result, walked through the
    schema-preserving ops; None when not derivable at plan time."""
    if node.op == "source":
        df = node.payload.df
        return {c: df[c].dtype for c in df.columns}
    if not node.inputs:
        return None
    if node.op in ("sql_filter", "checkpoint"):
        return _derived_dtypes(node.inputs[0])
    if node.op == "select":
        base = _derived_dtypes(node.inputs[0])
        if base is None:
            return None
        sel = node.param("cols", ())
        if "*" in sel:
            return base
        return {c: base[c] for c in sel if c in base}
    return None


def _annotate_sql_backends(root: ir.Node) -> None:
    """Annotate each ``sql_filter`` with the execution backend its
    predicate lands on (``jit-plane`` / ``host-vector``) when the input
    schema is statically derivable — rendered by ``explain()`` as
    ``eval[sql]=...`` so a predicate silently outside the plane subset
    is visible before anything runs."""
    from tempo_tpu_torch.plan import sql_compile

    for n in root.walk():
        if n.op != "sql_filter" or "sql_eval" in n.ann:
            continue
        ast = n.objs.get("ast")
        if ast is None or not n.inputs:
            continue
        dtypes = _derived_dtypes(n.inputs[0])
        if dtypes is None:
            continue
        try:
            n.ann["sql_eval"] = sql_compile.filter_backend(ast, dtypes)
        except Exception as e:  # pragma: no cover - annotation only
            logger.debug("plan: sql backend annotation skipped (%s)", e)


# ----------------------------------------------------------------------
# Pass 1a: floor-resample + exact EMA -> the fused resampleEMA kernel
# ----------------------------------------------------------------------

def _fuse_resample_ema(root: ir.Node) -> ir.Node:
    def fn(n: ir.Node) -> ir.Node:
        if n.op != "ema" or not n.inputs:
            return n
        rs = n.inputs[0]
        if rs.op != "resample" or _mesh_side(rs):
            return n
        col = n.param("colName")
        metric = rs.param("metricCols")
        if (n.param("exact") is True
                and rs.param("func") in ("floor", "closest_lead")
                and rs.param("prefix") in (None, "")
                and not rs.param("fill")
                and metric == (col,)):
            fused = ir.Node("resample_ema", params=dict(
                freq=rs.param("freq"), colName=col,
                exp_factor=n.param("exp_factor")), inputs=rs.inputs)
            fused.ann["rewrite"] = (
                "floor-resample + exact EMA -> resampleEMA fused kernel "
                "(single column read)")
            return fused
        return n

    return _rewrite(root, fn)


# ----------------------------------------------------------------------
# Pass 1b: mesh asofJoin -> withRangeStats [-> EMA] as ONE graph
# ----------------------------------------------------------------------

def _plain_numeric_mesh_source(node: ir.Node) -> bool:
    """True when the node is an on_mesh(source)/dist_source whose value
    columns all ride plain numeric device planes (the fused graph has
    no host-gather / seq / resampled path)."""
    import pandas as pd

    if node.op == "dist_source":
        p = node.payload
        return (not p.resampled and p.seq is None and not p.host_cols
                and p.time_axis is None
                and all(c.ts_chunk is None and c.host_gather is None
                        for c in p.cols.values()))
    if node.op == "on_mesh" and node.inputs and node.inputs[0].op == "source":
        if node.param("time_axis") is not None:
            return False
        t = node.inputs[0].payload
        if t.sequence_col:
            return False
        structural = {t.ts_col, *t.partitionCols}
        for c in t.df.columns:
            if c in structural:
                continue
            dtype = t.df[c].dtype
            if not (pd.api.types.is_numeric_dtype(dtype)
                    and not pd.api.types.is_bool_dtype(dtype)):
                return False
        return True
    return False


def _host_value_cols(t) -> list:
    """Plane-backed value columns of a host TSDF — everything except
    ts, partitions, and the sequence column.  THE one column filter
    behind every host plane count: ``_device_plane_count``'s
    on_mesh(source) branch, ``_est_frame_bytes``'s fusion byte input,
    and the query service's runtime admission projection
    (``service/admission.py``) all call it, so the three models cannot
    drift column-accounting again."""
    return [c for c in t.df.columns
            if c not in {t.ts_col, *t.partitionCols,
                         t.sequence_col or ""}]


def _est_frame_bytes(node: ir.Node) -> int:
    """Best-effort device byte estimate of a source-adjacent node's
    packed planes (ts + value/validity per column) — the byte input of
    the fusion cost decision; 0 when not derivable at plan time."""
    try:
        frame = _source_frame(node)
        if frame is None:
            return 0
        lay = getattr(frame, "layout", None)
        if lay is not None:                     # host TSDF
            import numpy as np

            from tempo_tpu_torch import packing

            K = lay.n_series
            L = packing.pad_length(int(np.max(lay.lengths, initial=0)))
            n_cols = max(1, len(_host_value_cols(frame)))
            return K * L * (8 + 5 * n_cols)
        return int(frame.K_dev) * int(frame.L) * (
            8 + 5 * max(1, len(frame.cols)))    # DistributedTSDF
    except Exception:  # pragma: no cover - estimate must never kill a plan
        return 0


def _fuse_mesh_chain(root: ir.Node) -> ir.Node:
    def fn(n: ir.Node) -> ir.Node:
        # the rewriter runs bottom-up: range_stats(asof_join) fuses
        # first; an ema over a fused node then folds into it
        if (n.op == "ema" and n.inputs
                and n.inputs[0].op == "fused_asof_stats_ema"
                and not n.inputs[0].param("has_ema")):
            base = n.inputs[0]
            params = dict(base.params)
            params.update(
                has_ema=True,
                e_col=n.param("colName"), e_window=n.param("window"),
                e_exp_factor=n.param("exp_factor"),
                e_exact=n.param("exact"),
                e_inclusive=n.param("inclusive_window"))
            fused = ir.Node("fused_asof_stats_ema", params=params,
                            inputs=base.inputs)
            fused.ann.update(base.ann)
            fused.ann["rewrite"] = (
                "asofJoin + withRangeStats + EMA chained into ONE "
                "captured CUDA graph (plan/fused.py)")
            if "fusion_cost" in fused.ann:
                # re-cost at the TRUE op count: the folded EMA adds a
                # dispatch + a re-read to the op-by-op side while
                # the fused side stays one graph, so a 2-op verdict
                # of "fuse" only strengthens — no re-gate needed (a
                # 2-op decline already stopped the base rewrite; that
                # conservatively misses chains only a 3-op costing
                # would fuse, which is bitwise-safe either way)
                from tempo_tpu_torch.plan import cost as plan_cost

                est = sum(_est_frame_bytes(c) for c in base.inputs)
                _, costs3 = plan_cost.fusion_worthwhile(3, est)
                fused.ann["fusion_cost"] = dict(costs3,
                                                decision="fused")
            return fused
        if n.op != "range_stats" or not _mesh_side(n) or not n.inputs:
            return n
        if n.param("strategy", "exact") != "exact":
            return n
        jn = n.inputs[0]
        if jn.op != "asof_join" or len(jn.inputs) != 2:
            return n
        if not (jn.param("skipNulls") is True
                and not jn.param("maxLookback")
                and jn.param("tsPartitionVal") is None):
            return n
        left, right = jn.inputs
        if not (_plain_numeric_mesh_source(left)
                and _plain_numeric_mesh_source(right)):
            return n
        from tempo_tpu_torch.plan import cost as plan_cost

        fusion_costs = None
        if plan_cost.enabled():
            # cost-decided fusion: one graph vs the op-by-op chain —
            # both bitwise-identical (plan/fused.py pins the op
            # boundaries), so the decision is free to flip with the
            # cost inputs; the priors make fusion win (today's rule)
            est = _est_frame_bytes(left) + _est_frame_bytes(right)
            worthwhile, fusion_costs = plan_cost.fusion_worthwhile(2, est)
            if not worthwhile:
                n.ann["fusion_cost"] = dict(fusion_costs,
                                            decision="op-by-op")
                return n
        fused = ir.Node("fused_asof_stats_ema", params=dict(
            j_left_prefix=jn.param("left_prefix"),
            j_right_prefix=jn.param("right_prefix") or "right",
            s_cols=n.param("colsToSummarize"),
            s_window=n.param("rangeBackWindowSecs"),
            has_ema=False,
        ), inputs=(left, right))
        fused.ann["rewrite"] = (
            "asofJoin + withRangeStats chained into ONE captured "
            "CUDA graph (plan/fused.py)")
        _note_uncaptured(fused, left)
        if fusion_costs is not None:
            fused.ann["fusion_cost"] = dict(fusion_costs,
                                            decision="fused")
        return fused

    return _rewrite(root, fn)


# ----------------------------------------------------------------------
# Pass 2: hoist engine selection to plan time
# ----------------------------------------------------------------------

def _source_frame(node: ir.Node):
    """The concrete frame a source-adjacent node will execute over, if
    it is directly available at plan time (payload of a source, or of
    an on_mesh over a source)."""
    if node.is_source():
        return node.payload
    if node.op == "on_mesh" and node.inputs and node.inputs[0].is_source():
        return node.inputs[0].payload
    return None


def _hoist_engines(root: ir.Node) -> None:
    from tempo_tpu_torch import resilience

    for n in root.walk():
        if n.op in ("range_stats", "fused_asof_stats_ema"):
            w = n.param("s_window" if n.op == "fused_asof_stats_ema"
                        else "rangeBackWindowSecs", 1000)
            engine, rcosts = _plan_range_engine(n, float(w))
            if engine is not None:
                n.ann["range_engine"] = engine
                if rcosts is not None:
                    n.ann["cost"] = rcosts
        if n.op in ("asof_join", "fused_asof_stats_ema"):
            sides = [(_source_frame(c)) for c in n.inputs[:2]]
            if all(s is not None for s in sides):
                import numpy as np

                from tempo_tpu_torch import packing

                lens = []
                for s in sides:
                    lay = getattr(s, "layout", None)
                    if lay is None:
                        lens = None
                        break
                    lens.append(packing.pad_length(
                        int(np.max(lay.lengths, initial=0))))
                if lens:
                    limit = resilience.max_merged_lanes()
                    est = sum(lens)
                    from tempo_tpu_torch import profiling

                    engine = profiling.pick_join_engine(
                        est, limit, chunked_ok=True)
                    n.ann["join_engine"] = engine
                    n.ann["merged_lanes_est"] = est
                    n.ann.setdefault("hints", {})["join_engine"] = engine
                    from tempo_tpu_torch.plan import cost as plan_cost

                    if plan_cost.enabled():
                        n.ann["cost"] = {
                            k: v for k, v in plan_cost.join_costs(
                                est, limit, True).items()
                            if v is not None}


def _plan_range_engine(node: ir.Node, w: float):
    """``(engine, costs)`` the stats op will pick over this node's
    input chain, computed once at plan time — the SAME decision
    function the eager paths run per call (rolling.plan_range_engine
    for host frames, dist's shared shard pick for mesh frames), so
    replaying the hint can never change which kernel a planned chain
    runs.  ``costs`` is the per-engine estimate dict explain() renders
    next to the choice (host chains with derivable rowbounds, cost
    model on; None otherwise — the mesh picks are per-shard and
    annotate the engine only).  ``(None, None)`` when the shard shape
    is not derivable at plan time (e.g. stats after an op that
    reshapes) — the executor then picks at run time, exactly like
    eager."""
    if not node.inputs:
        return None, None
    child = node.inputs[0]
    try:
        if _mesh_side(child):
            from tempo_tpu_torch import dist

            if child.op == "dist_source":
                engine, _ = child.payload._range_engine_choice(w)
                return engine, None
            # mesh chains pick on the left frame's packed geometry; a
            # join keeps it, so walk past source-preserving ops to an
            # on_mesh(source) whose geometry is derivable pre-packing
            cur = child
            while cur.op in ("asof_join", "ema"):
                cur = cur.inputs[0]
            if cur.op == "on_mesh" and cur.inputs \
                    and cur.inputs[0].op == "source":
                t = cur.inputs[0].payload
                mesh = cur.objs.get("mesh")
                if mesh is None:
                    from tempo_tpu_torch.parallel.mesh import default_mesh

                    mesh = default_mesh(t.device)
                engine, _ = dist.plan_range_engine_choice(
                    t.layout, mesh, cur.param("series_axis", "series"),
                    cur.param("time_axis"), w)
                return engine, None
            return None, None
        src = _source_frame(child)
        if src is None:
            return None, None
        from tempo_tpu_torch import rolling as frame_rolling

        pick = node.param("colsToSummarize")
        cols = list(pick) if pick else src.summarizable_columns()
        if not cols:
            return None, None
        engine, rb, ts_long, _ = frame_rolling.plan_range_engine(src, w)
        costs = None
        if rb is not None and ts_long is not None:
            from tempo_tpu_torch.plan import cost as plan_cost

            if plan_cost.enabled():
                K, L = ts_long.shape
                costs = plan_cost.range_costs(
                    int(rb[0]) + int(rb[1]), K * L)
        return engine, costs
    except Exception as e:  # pragma: no cover - probe must never kill a plan
        logger.debug("plan: range-engine hoist skipped (%s)", e)
        return None, None


# ----------------------------------------------------------------------
# Pass 2b: plan-placed resharding on time-sharded mesh chains
# ----------------------------------------------------------------------

#: ops whose shard-local kernels want series-local FULL rows — on a
#: time-sharded mesh the eager methods bound each one with an explicit
#: ``dist.reshard_frame`` switch pair (the join keeps its in-program
#: ``_asof_a2a`` collectives: its math is float-accumulation-free and
#: therefore layout-robust bitwise).  Their
#: series-local twins are bitwise-identical (the kernels are batched
#: over the lead axis and never couple rows), so the planner may run
#: any RUN of them inside one series-local region bounded by two
#: explicit ``reshard`` nodes: the interior all_to_all pairs are
#: ELIMINATED (producer and consumer shardings already agree), and a
#: pending reshard-back SINKS through further members of the set.
_SERIES_LOCAL_OPS = ("asof_join", "range_stats", "resample", "fourier",
                     "interpolate", "calc_bars")

#: ops a pending reshard-back may NOT sink past: their time-sharded
#: and series-local executions differ in f32 association — EMA's
#: cross-shard carry stitch (parallel/halo.py) vs the plain local scan
#: bracket the same recurrence differently — so moving the layout
#: boundary across them would break the bitwise planned==eager
#: contract.  The reshard-back is placed immediately above them.
_RESHARD_SINK_BLOCKERS = ("ema",)


def _device_plane_count(node: ir.Node) -> Optional[int]:
    """Best-effort device value-plane count of a node's result frame
    (feeds the reshard nodes' modeled comm bytes in ``explain()``);
    None when not statically derivable."""
    if node.op == "dist_source":
        return len(node.payload.cols)
    if node.op == "source":
        # bare host frame (pre-mesh): the same value planes it packs —
        # a derivable LEAF, so downstream op nodes of pure host chains
        # derive their counts too (runtime admission projects whole
        # host chains through this model, not just mesh chains)
        return len(_host_value_cols(node.payload))
    if node.op == "on_mesh" and node.inputs \
            and node.inputs[0].op == "source":
        return len(_host_value_cols(node.inputs[0].payload))
    if not node.inputs:
        return None
    base = _device_plane_count(node.inputs[0])
    if base is None:
        return None
    if node.op in ("reshard", "checkpoint"):
        return base
    if node.op == "asof_join":
        right = _device_plane_count(node.inputs[1])
        if right is None:
            return None
        return base + right + 3          # + the joined-ts chunk planes
    if node.op == "range_stats":
        pick = node.param("colsToSummarize")
        from tempo_tpu_torch import packing

        n_sum = len(pick) if pick else base
        return base + len(packing.RANGE_STATS) * n_sum
    if node.op == "ema":
        return base + 1
    if node.op in ("resample",):
        pick = node.param("metricCols")
        return len(pick) if pick else base
    if node.op == "calc_bars":
        # four prefixed planes per metric (open/low/high/close); the
        # optional zero-fill interpolate adds no columns
        pick = node.param("metricCols")
        return 4 * (len(pick) if pick else base)
    return None


def _reshard_node(child: ir.Node, target: str) -> ir.Node:
    node = ir.Node("reshard", params=dict(target=target), inputs=(child,))
    node.ann["reshard"] = "placed"
    planes = _device_plane_count(child)
    src = next(iter(child.sources()), None)
    if planes is not None and src is not None \
            and src.op == "dist_source":
        from tempo_tpu_torch import dist

        p = src.payload
        node.ann["comm_bytes_model"] = dist.relayout_comm_bytes(
            p.K_dev, p.L, planes,
            p.n_series_shards * max(p.n_time, 1),
            has_seq=p.seq is not None)
    elif planes is not None and src is not None and src.op == "source":
        mesh_node = child
        while mesh_node.op != "on_mesh" and mesh_node.inputs:
            mesh_node = mesh_node.inputs[0]
        mesh = mesh_node.objs.get("mesh") if mesh_node.op == "on_mesh" \
            else None
        if mesh is not None:
            from tempo_tpu_torch import dist

            K_dev, L, n_s, n_t = dist._mesh_packed_geometry(
                src.payload.layout, mesh,
                mesh_node.param("series_axis", "series"),
                mesh_node.param("time_axis"))
            node.ann["comm_bytes_model"] = dist.relayout_comm_bytes(
                K_dev, L, planes, n_s * n_t,
                has_seq=bool(src.payload.sequence_col))
    return node


def _place_reshards(root: ir.Node) -> ir.Node:
    """Insert explicit ``reshard`` plan nodes on time-sharded mesh
    chains (see :data:`_SERIES_LOCAL_OPS`): one switch to the
    series-local layout at the head of each maximal series-local run,
    one switch back where a sink-blocked op (or ``explicit`` mode)
    requires the time-sharded layout again; the trailing switch is
    eliminated outright when the consumer is ``collect``/``count``
    (materialisation reads any layout).  ``declarative`` mode is a
    no-op: every op keeps its internal all_to_all pair.

    In ``auto`` mode the placement is **cost-decided**:
    the placed shape's modeled comm bytes + per-node dispatch cost is
    compared against the internal all_to_all pairs the ops would run
    declaratively, and the whole plan keeps whichever is cheaper —
    both shapes are bitwise-identical (the round-10 elimination
    contract), so the decision is free to flip with the cost inputs.
    Under the default priors placement wins whenever it eliminates a
    switch, which is today's rule."""
    mode = reshard_mode()
    if mode == "declarative":
        return root
    from tempo_tpu_torch.plan import cost as plan_cost

    if mode == "auto" and plan_cost.enabled():
        trial = _place_reshards_impl(_copy(root), mode)
        stats = _reshard_stats(trial)
        if stats["n_placed"] == 0:
            return trial               # no time-sharded chain: nothing
        #                                to decide, no annotation noise
        place, costs = plan_cost.reshard_decision(
            stats["n_placed"], stats["placed_bytes"],
            stats["n_internal"], stats["internal_bytes"])
        if not place:
            root.ann["reshard_cost"] = dict(costs,
                                            decision="declarative")
            return root
        trial.ann["reshard_cost"] = dict(costs, decision="placed")
        return trial
    return _place_reshards_impl(root, mode)


def _reshard_stats(placed: ir.Node) -> Dict[str, object]:
    """Switch counts and modeled bytes of a placed plan, feeding the
    cost decision above.  Internal pairs are modeled as 2 switches of
    the same frame geometry per series-local member (the eager
    time-sharded ops bracket themselves with ``dist.reshard_frame``);
    bytes fall back to None (count-only decision) when any placed node
    lacks a comm model."""
    n_placed = 0
    placed_bytes: Optional[int] = 0
    members = 0
    for n in placed.walk():
        if n.op == "reshard" and n.ann.get("reshard") == "placed":
            n_placed += 1
            b = n.ann.get("comm_bytes_model")
            if b is None or placed_bytes is None:
                placed_bytes = None
            else:
                placed_bytes += int(b)
        elif n.op in _SERIES_LOCAL_OPS and (
                "reshard_eliminated" in n.ann
                or (n.inputs and n.inputs[0].op == "reshard")):
            members += 1
    n_internal = 2 * members
    internal_bytes = None
    if placed_bytes is not None and n_placed:
        internal_bytes = n_internal * (placed_bytes // n_placed)
    return {"n_placed": n_placed, "placed_bytes": placed_bytes,
            "n_internal": n_internal, "internal_bytes": internal_bytes}


def _place_reshards_impl(root: ir.Node, mode: str) -> ir.Node:
    layout: Dict[int, str] = {}        # id(node) -> "time" | "joint"

    def fn(n: ir.Node) -> ir.Node:
        if n.op == "dist_source":
            p = n.payload
            if p.time_axis is not None:
                layout[id(n)] = "time"
            elif isinstance(p.series_axis, tuple):
                layout[id(n)] = "joint"
            return n
        if n.op == "on_mesh":
            if n.param("time_axis") is not None:
                layout[id(n)] = "time"
            return n
        if not n.inputs:
            return n
        in_layout = layout.get(id(n.inputs[0]))
        if in_layout is None:
            return n
        series_local = n.op in _SERIES_LOCAL_OPS
        if n.op == "range_stats" \
                and n.param("strategy", "exact") != "exact":
            # halo-strategy stats are DEFINED by the time-sharded
            # layout (windows truncate at the halo, with an audit):
            # resharding them series-local would silently compute the
            # exact form instead — treat them as a boundary so the
            # reshard-back lands above and eager/planned run the same
            # halo program
            series_local = False
        if series_local:
            if in_layout == "time":
                r = _reshard_node(n.inputs[0], "series_local")
                layout[id(r)] = "joint"
                n.inputs = (r,) + n.inputs[1:]
            else:
                n.ann["reshard_eliminated"] = (
                    "producer already series-local — shardings agree, "
                    "the op's all_to_all pair is elided")
            if n.op == "interpolate":
                # interpolate's result is a NEW dense series-local
                # frame in eager too (dist.py): nothing downstream
                # ever reshards it back
                return n
            out = n
            layout[id(out)] = "joint"
            if mode == "explicit":
                out = _reshard_node(n, "time_sharded")
                layout[id(out)] = "time"
            return out
        if in_layout == "joint":
            if n.op in ("collect", "count"):
                n.ann["reshard_eliminated"] = (
                    "trailing reshard elided — collect() materialises "
                    "from any layout")
                layout[id(n)] = "joint"
                return n
            r = _reshard_node(n.inputs[0], "time_sharded")
            layout[id(r)] = "time"
            n.inputs = (r,) + n.inputs[1:]
            if n.op in _RESHARD_SINK_BLOCKERS:
                n.ann["reshard_note"] = (
                    "reshard-back not sunk past EMA: the time-sharded "
                    "carry stitch and the series-local scan differ in "
                    "f32 association (bitwise contract)")
            layout[id(n)] = "time"
            return n
        layout[id(n)] = in_layout
        return n

    return _rewrite(root, fn)


# ----------------------------------------------------------------------
# Pass 3: dead-column pruning before packing
# ----------------------------------------------------------------------

Wanted = Union[None, FrozenSet[str]]  # None == ALL


def _required_inputs(node: ir.Node, wanted: Wanted):
    """Per-input wanted column sets for this node, given what its own
    output must provide."""
    n_in = len(node.inputs)
    if node.op == "count":
        return [frozenset()] * n_in
    if node.op in ("collect", "on_mesh", "source", "dist_source",
                   "reshard", "checkpoint"):
        return [wanted] * n_in
    if node.op == "select":
        sel = node.param("cols", ())
        if "*" in sel:
            return [ALL]
        return [frozenset(sel)]
    if node.op == "sql_project":
        # the node evaluates EVERY projection (its aliases are its
        # output schema), so its input always needs the full resolved
        # ref set — already a strict subset of upstream for any
        # projection that drops columns
        return [frozenset(node.param("cols", ()))]
    if node.op == "sql_filter":
        refs = frozenset(node.param("cols", ()))
        return [ALL if wanted is ALL else frozenset(wanted) | refs]
    if node.op == "ema":
        if wanted is ALL:
            return [ALL]
        return [frozenset(wanted - {f"EMA_{node.param('colName')}"})
                | {node.param("colName")}]
    if node.op == "range_stats":
        pick = node.param("colsToSummarize")
        if wanted is ALL or pick is None:
            return [ALL]
        stats_out = {f"{s}_{c}" for c in pick
                     for s in ir._range_stats_names()}
        return [frozenset(wanted - stats_out) | set(pick)]
    if node.op == "resample":
        pick = node.param("metricCols")
        return [frozenset(pick) if pick else ALL]
    if node.op == "resample_ema":
        return [frozenset({node.param("colName")})]
    if node.op in ("interpolate", "interpolate_resampled"):
        pick = node.param("target_cols")
        return [frozenset(pick) if pick else ALL]
    if node.op == "fourier":
        return [frozenset({node.param("valueCol")})]
    if node.op in ("asof_join", "fused_asof_stats_ema"):
        if node.op == "fused_asof_stats_ema":
            pick = node.param("s_cols")
            extra = set(pick or ())
            if node.param("has_ema"):
                extra.add(node.param("e_col"))
            if wanted is not ALL:
                wanted = frozenset(wanted) | extra
            elif pick is None:
                wanted = ALL
            lp, rp = node.param("j_left_prefix"), node.param("j_right_prefix")
        else:
            lp = node.param("left_prefix")
            rp = node.param("right_prefix") or "right"
        if wanted is ALL:
            return [ALL, ALL]
        l_cols = ir.output_columns(node.inputs[0])
        r_cols = ir.output_columns(node.inputs[1])
        if l_cols is None or r_cols is None:
            return [ALL, ALL]
        ren = (lambda c: f"{lp}_{c}") if lp else (lambda c: c)
        lw = {c for c in l_cols if ren(c) in wanted}
        rw = {c for c in r_cols if f"{rp}_{c}" in wanted}
        return [frozenset(lw), frozenset(rw)]
    # unknown op (with_column, lookback_features, ...): conservative
    return [ALL] * n_in


def _prune_columns(root: ir.Node) -> None:
    wanted: Dict[int, Wanted] = {id(root): ALL}
    order = list(root.walk())
    for n in reversed(order):          # root first (reverse post-order)
        w = wanted.get(id(n), ALL)
        reqs = _required_inputs(n, w)
        for child, req in zip(n.inputs, reqs):
            prev = wanted.get(id(child), "unset")
            if prev == "unset":
                wanted[id(child)] = req
            elif prev is ALL or req is ALL:
                wanted[id(child)] = ALL
            else:
                wanted[id(child)] = frozenset(prev) | frozenset(req)
    for n in order:
        if n.op != "source":
            continue
        w = wanted.get(id(n), ALL)
        if w is ALL:
            continue
        t = n.payload
        structural = {t.ts_col, *t.partitionCols}
        if t.sequence_col:
            structural.add(t.sequence_col)
        keep = [c for c in t.df.columns if c in structural or c in w]
        if len(keep) < len(t.df.columns):
            n.ann["prune_to"] = tuple(keep)
            n.ann["pruned"] = tuple(c for c in t.df.columns
                                    if c not in keep)


# ----------------------------------------------------------------------
# Pass 5: plan-integrated checkpoint barriers (TEMPO_TPU_CKPT_PLACEMENT)
# ----------------------------------------------------------------------

#: frame-producing ops after which a checkpoint barrier may be placed —
#: each materialises a new device/host frame, so the boundary above it
#: is a legal resume point (the saved frame IS the subtree's value)
_CKPT_BOUNDARY_OPS = ("asof_join", "range_stats", "ema", "resample",
                      "resample_ema", "interpolate", "fourier",
                      "fused_asof_stats_ema", "calc_bars")


def _est_ckpt_bytes(node: ir.Node) -> Optional[int]:
    """Estimated on-disk bytes of checkpointing this node's result
    frame (ts plane + mask + value/validity per plane), rendered by
    ``explain()`` next to each placed barrier; None when the geometry
    is not derivable at plan time."""
    try:
        src = next(iter(node.sources()), None)
        if src is None:
            return None
        planes = _device_plane_count(node)
        if planes is None:
            planes = 1
        if src.op == "dist_source":
            K, L = int(src.payload.K_dev), int(src.payload.L)
        else:
            import numpy as np

            from tempo_tpu_torch import packing

            lay = src.payload.layout
            K = lay.n_series
            L = packing.pad_length(int(np.max(lay.lengths, initial=0)))
        return int(K * L * (8 + 1 + planes * 5))
    except Exception:  # pragma: no cover - estimate must never kill a plan
        return None


def _place_checkpoints(root: ir.Node) -> ir.Node:
    """Insert first-class ``checkpoint`` plan nodes when a
    :func:`tempo_tpu_torch.plan.checkpoints.checkpointed` context is active
    (and ``TEMPO_TPU_CKPT_PLACEMENT`` is not ``off``): one barrier
    after every ``every``-th materialization boundary
    (:data:`_CKPT_BOUNDARY_OPS`), one before each placed reshard's
    layout switch (the canonical-layout frame is what gets saved), and
    always one under the terminal materialisation (``collect`` /
    ``count`` / host barriers) so a completed chain's final frame is a
    resume point.  Interiors of series-local reshard regions are never
    checkpointed — their joint layout is not restorable through
    ``checkpoint.load``'s canonical re-placement path.  Uncacheable
    plans (opaque params) are left barrier-free: their signatures are
    not stable across submissions, so stamped barriers could never be
    matched on resume."""
    from tempo_tpu_torch.plan import checkpoints as plan_ckpt

    spec = plan_ckpt.active()
    if spec is None or plan_ckpt.placement_mode() == "off" \
            or root.uncacheable():
        return root
    every = max(1, int(spec.every))
    layout: Dict[int, Optional[str]] = {}
    state = {"ops": 0, "steps": 0}

    def wrap(child: ir.Node) -> ir.Node:
        state["steps"] += 1
        node = ir.Node("checkpoint", params=dict(step=state["steps"]),
                       inputs=(child,))
        node.ann["ckpt"] = (
            "plan barrier: signed step manifest (plan signature + "
            "predecessor CRC), resume point")
        est = _est_ckpt_bytes(child)
        if est:
            node.ann["ckpt_bytes_est"] = est
        layout[id(node)] = layout.get(id(child))
        return node

    def fn(n: ir.Node) -> ir.Node:
        # layout tracking mirrors _place_reshards_impl: barriers must
        # only land on canonically-laid frames
        if n.op == "dist_source":
            p = n.payload
            layout[id(n)] = ("time" if p.time_axis is not None else
                             "joint" if isinstance(p.series_axis, tuple)
                             else None)
            return n
        if n.op == "on_mesh":
            layout[id(n)] = ("time" if n.param("time_axis") is not None
                             else None)
            return n
        if not n.inputs:
            return n
        if n.op == "reshard":
            child = n.inputs[0]
            if n.param("target") == "series_local" \
                    and child.op in _CKPT_BOUNDARY_OPS \
                    and layout.get(id(child)) != "joint":
                n.inputs = (wrap(child),) + n.inputs[1:]
            layout[id(n)] = ("joint" if n.param("target") == "series_local"
                             else "time")
            return n
        layout[id(n)] = layout.get(id(n.inputs[0]))
        if n.op in _CKPT_BOUNDARY_OPS and layout.get(id(n)) != "joint":
            state["ops"] += 1
            if state["ops"] % every == 0:
                return wrap(n)
            return n
        if n.op in ("collect", "count", "lookback_features"):
            child = n.inputs[0]
            if child.op in _CKPT_BOUNDARY_OPS \
                    and layout.get(id(child)) != "joint":
                n.inputs = (wrap(child),) + n.inputs[1:]
            return n
        return n

    return _rewrite(root, fn)


# ----------------------------------------------------------------------
# Pass 4: explicit materialisation barriers
# ----------------------------------------------------------------------

def _mark_barriers(root: ir.Node) -> None:
    for n in root.walk():
        if n.op == "collect":
            n.ann["barrier"] = "device->host materialisation"
        elif n.op == "lookback_features":
            n.ann["barrier"] = ("host materialisation: collect_list "
                                "semantics run on host (dist.py fallback)")
        elif n.op == "fourier" and any(
                c.op in ("resample", "interpolate") for c in n.walk()):
            n.ann["barrier"] = ("host materialisation: fourier on a "
                                "resampled (bucket-head) view collects "
                                "to host (dist.py fallback)")


# ----------------------------------------------------------------------
# Pass 6: whole-chain graph stitching (TEMPO_TPU_STITCH_MAX_OPS)
# ----------------------------------------------------------------------

def _stitch_max_ops() -> int:
    """``TEMPO_TPU_STITCH_MAX_OPS`` — longest run of adjacent
    series-local planned ops collapsed into one ``stitched`` node
    (plan/stitch.py); < 2 disables the pass.  Env knob wins, then the
    tuned profile's winner (tune/space.py ``stitched_chain`` class),
    then the built-in 8."""
    from tempo_tpu_torch import tune

    return tune.resolve("TEMPO_TPU_STITCH_MAX_OPS", 8, "stitched_chain")


def _stitch_chains(root: ir.Node) -> ir.Node:
    """Collapse maximal single-consumer runs of adjacent stitchable
    mesh ops into ONE ``stitched`` node executed as a single captured
    CUDA graph (plan/stitch.py).  Runs after every other pass, so fused
    nodes, placed reshards and checkpoint barriers all act as stitch
    boundaries — a mid-chain barrier splits the chain into two stitch
    groups and resume replays only the downstream one.  Top-down so a
    chain is grouped from its TOPMOST member; interior nodes are
    consumed by the group and never visited."""
    from tempo_tpu_torch.plan import cost as plan_cost
    from tempo_tpu_torch.plan.stitch import STITCHABLE_OPS

    max_ops = _stitch_max_ops()
    if max_ops < 2:
        return root
    counts: Dict[int, int] = {}
    for n in root.walk():
        for c in n.inputs:
            counts[id(c)] = counts.get(id(c), 0) + 1
    memo: Dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        if id(n) in memo:
            return memo[id(n)]
        out = n
        if n.op in STITCHABLE_OPS and _mesh_side(n):
            chain = [n]
            cur = n
            while (cur.inputs and cur.inputs[0].op in STITCHABLE_OPS
                   and counts.get(id(cur.inputs[0]), 0) == 1
                   and len(chain) < max_ops):
                cur = cur.inputs[0]
                chain.append(cur)
            if len(chain) >= 2:
                bottom = chain[-1]
                stitch_costs = None
                worthwhile = True
                if plan_cost.enabled():
                    # cost-decided stitching: one graph vs the
                    # op-by-op chain — both bitwise-identical
                    # (plan/stitch.py pins every op boundary with
                    # optimization_barrier), so the decision is free
                    est = (_est_frame_bytes(bottom.inputs[0])
                           if bottom.inputs else 0)
                    worthwhile, stitch_costs = \
                        plan_cost.stitch_worthwhile(len(chain), est)
                if worthwhile:
                    stitched = ir.Node("stitched", params=dict(
                        stages=tuple((c.op, c.params)
                                     for c in reversed(chain)),
                        n_ops=len(chain)), inputs=bottom.inputs)
                    stitched.ann["rewrite"] = (
                        f"{len(chain)} adjacent series-local ops "
                        f"stitched into ONE captured CUDA graph "
                        f"(plan/stitch.py)")
                    _note_uncaptured(stitched, bottom)
                    # reshard decisions recorded on swallowed members
                    # (pass 2b ran first) must stay visible in the
                    # walked plan and in explain()
                    for c in reversed(chain):
                        for key in ("reshard_eliminated",
                                    "reshard_note"):
                            if key in c.ann:
                                note = f"{c.op}: {c.ann[key]}"
                                prev = stitched.ann.get(key)
                                stitched.ann[key] = (
                                    note if prev is None
                                    else f"{prev}; {note}")
                    if stitch_costs is not None:
                        stitched.ann["stitch_cost"] = dict(
                            stitch_costs, decision="stitched")
                    out = stitched
                else:
                    n.ann["stitch_cost"] = dict(stitch_costs,
                                                decision="op-by-op")
        out.inputs = tuple(rec(c) for c in out.inputs)
        memo[id(n)] = out
        return out

    return rec(root)
