"""Plan executor: replay an optimized plan through the eager API.

Counterpart of ``tempo_tpu/plan/executor.py``.  ``execute(root)`` is
the entry point the lazy terminals call: it looks the plan up in the
executable cache (:mod:`tempo_tpu_torch.plan.cache`), builds an
:class:`Executable` on a miss (the optimizer passes run once per cached
plan) and runs it over the plan's source payloads.  Re-running a
structurally identical chain over same-shape frames is a cache hit: no
re-optimization, no engine re-pick, and the executable's captured CUDA
graphs (fused and stitched nodes) replay instead of capturing again.

Recording is suspended for the whole run, so replaying through the
eager methods never re-records.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

from tempo_tpu_torch.plan import cache, hints, ir, optimizer
from tempo_tpu_torch.plan import checkpoints as plan_ckpt

logger = logging.getLogger(__name__)


def cache_key(root: ir.Node, snap=None) -> Optional[tuple]:
    """The executable-cache key of ``root`` under the cost inputs
    ``snap`` (default: the current ones), None when uncacheable."""
    from tempo_tpu_torch.plan import cost

    key = ir.state_key(root)
    if key is None:
        return None
    # the reshard-placement mode, the active cost-model inputs and the
    # checkpoint-barrier spec all change the OPTIMIZED plan without
    # touching the logical signature — fold them into the cache key so
    # flipping TEMPO_TPU_RESHARD_PLACEMENT, a measured cost input, or a
    # checkpointed() context never replays a plan decided under the
    # other configuration
    snap = cost.snapshot() if snap is None else snap
    return key + (optimizer.reshard_mode(), cost.fingerprint(snap),
                  plan_ckpt.fingerprint())


def execute(root: ir.Node):
    from tempo_tpu_torch.plan import cost

    # snapshot the cost inputs ONCE: the key's fingerprint and the
    # decisions optimize() bakes into the executable must come from
    # the same inputs even if a concurrent set_measured() lands
    # mid-build (cost.pinned below)
    snap = cost.snapshot()
    key = cache_key(root, snap)

    def build():
        t0 = time.perf_counter()
        with cost.pinned(snap):
            exe = Executable(optimizer.optimize(root))
        exe.build_seconds = time.perf_counter() - t0
        # run() binds the caller's payloads positionally, so the
        # build-time frames on the optimized copy are dead weight —
        # drop them or the process-global cache pins up to max_size()
        # full DataFrames/device buffers until eviction
        for s in exe.plan.sources():
            s.payload = None
        return exe

    # single-flight under the shared cache: concurrent tenants missing
    # on the same signature build once (plan/cache.py)
    exe = cache.CACHE.get_or_build(key, build)
    out = exe.run([n.payload for n in root.sources()])
    if key is not None:
        cache.CACHE.trim_graphs(keep=key)
    return out


class Executable:
    """One optimized plan bound to nothing: ``run(payloads)`` supplies
    the source frames (positionally, in plan DFS order), so the same
    executable serves every same-shape instance of the query."""

    def __init__(self, plan: ir.Node):
        self.plan = plan
        self.build_seconds = 0.0
        self.runs = 0

    def release(self) -> None:
        """Free the CUDA graphs (their pools and static tensors) the
        plan's fused and stitched nodes captured: the cache calls this
        when it evicts the executable."""
        from tempo_tpu_torch.plan import fused

        for n in self.plan.walk():
            fused.release(n)

    def graph_bytes(self) -> Dict[str, int]:
        """Bytes the plan's captured graphs keep on each card."""
        from tempo_tpu_torch.plan import fused

        out: Dict[str, int] = {}
        for n in self.plan.walk():
            for d, b in fused.graph_bytes(n).items():
                out[d] = out.get(d, 0) + b
        return out

    def run(self, payloads: List):
        from tempo_tpu_torch import plan as plan_mod

        sources = self.plan.sources()
        if len(sources) != len(payloads):
            raise ValueError(
                f"plan expects {len(sources)} source frame(s); "
                f"got {len(payloads)}")
        self.runs += 1
        env: Dict[int, object] = {}
        spec = plan_ckpt.active()
        # barrier nodes only exist in plans optimized under an active
        # context (the spec is in the cache key), so the hot path —
        # every query-service dispatch — skips the plan walk entirely
        ckpt_nodes = ([n for n in self.plan.walk()
                       if n.op == "checkpoint"]
                      if spec is not None else [])
        sig = None
        resume_id, resume_frame, prev0 = None, None, None
        skip = frozenset()
        if spec is not None and ckpt_nodes:
            from tempo_tpu_torch import checkpoint as ckpt_mod
            from tempo_tpu_torch.resilience import CheckpointError

            os.makedirs(spec.ckpt_dir, exist_ok=True)
            sig = _stamped_signature(self.plan, payloads)
            below = None
            while True:
                # manifest-only resolve; load verifies the arrays ONCE
                # — an unloadable barrier falls back to an older one
                hit = ckpt_mod.resolve_step(
                    spec.ckpt_dir, signature=sig,
                    max_step=len(ckpt_nodes), verify=False,
                    below_step=below)
                if hit is None:
                    break
                step_no, path, _man = hit
                target = next((n for n in ckpt_nodes
                               if n.param("step") == step_no), None)
                if target is None:
                    break
                try:
                    resume_frame = _load_barrier(target, path, payloads,
                                                 sources)
                except (CheckpointError, ValueError) as e:
                    logger.warning(
                        "plan: barrier %s unusable (%s); falling back "
                        "to an older one", path, e)
                    below = step_no
                    continue
                resume_id = id(target)
                prev0 = (step_no, ckpt_mod.manifest_crc(path))
                # skip the resumed subtree — EXCEPT nodes a consumer
                # outside the subtree still needs (a DAG may share a
                # source across the barrier: it must stay live)
                live = set()

                def _mark(n):
                    if id(n) in live or id(n) == resume_id:
                        return
                    live.add(id(n))
                    for c in n.inputs:
                        _mark(c)

                _mark(self.plan)
                skip = (frozenset(id(c) for c in target.walk())
                        - live - {resume_id})
                logger.info(
                    "plan: resuming from barrier step %d (%s); "
                    "%d upstream plan node(s) skipped",
                    step_no, path, len(skip))
                break
        prev: Optional[tuple] = prev0   # (step, manifest CRC) chain link
        with plan_mod.suspended():
            for node in self.plan.walk():
                if id(node) in skip:
                    # everything under the resumed barrier: its value IS
                    # the restored checkpoint — never re-executed
                    env[id(node)] = None
                    continue
                if node.op == "checkpoint":
                    if id(node) == resume_id:
                        env[id(node)] = resume_frame
                    else:
                        env[id(node)], prev = _save_barrier(
                            node, env[id(node.inputs[0])], spec, sig,
                            prev)
                    continue
                if node.is_source():
                    env[id(node)] = _bind_source(
                        node, payloads[sources.index(node)])
                else:
                    with hints.installed(node.ann.get("hints", {})):
                        env[id(node)] = _eval_op(node, [
                            env[id(c)] for c in node.inputs
                        ])
        return env[id(self.plan)]


def _stamped_signature(plan: ir.Node, payloads: List) -> str:
    """What a barrier manifest is stamped with: the optimized-plan
    signature (structure + params + annotations) PLUS each source
    frame's content fingerprint.  Structure alone would let the same
    chain over different same-shape data restore the previous data's
    barriers — the stale-restore variant of the foreign-resume
    hazard."""
    import hashlib

    fps = "|".join(plan_ckpt.source_fingerprint(p) for p in payloads)
    return hashlib.sha1(
        f"{ir.signature(plan)}|{fps}".encode()).hexdigest()[:16]


def _save_barrier(node: ir.Node, frame, spec, sig: str,
                  prev: Optional[tuple]):
    """Write one plan barrier: a ``step_NNNNN`` checkpoint whose
    manifest is stamped with the optimized-plan signature and the
    predecessor barrier's manifest CRC (the chained-manifest scheme);
    the frame passes through unchanged.  A barrier node run OUTSIDE a
    checkpointed context (same cached executable, context since
    exited) is a transparent no-op."""
    if spec is None:
        return frame, prev
    from tempo_tpu_torch import checkpoint as ckpt_mod

    step = int(node.param("step"))
    path = os.path.join(spec.ckpt_dir, f"step_{step:05d}")
    meta = {"pipeline_signature": sig, "step": step,
            "plan_op": node.inputs[0].op}
    if prev is not None:
        meta["prev_step"], meta["prev_manifest_crc"] = prev
    ckpt_mod.save(frame, path, sharded=spec.sharded, meta=meta)
    logger.info("plan: barrier step %d (%s) checkpointed to %s",
                step, node.inputs[0].op, path)
    ckpt_mod.prune(spec.ckpt_dir, keep_last=spec.keep_last)
    return frame, (step, ckpt_mod.manifest_crc(path))


def _load_barrier(node: ir.Node, path: str, payloads: List,
                  sources: List[ir.Node]):
    """Restore the frame a barrier checkpoint holds, re-placed onto the
    mesh the current submission's source frames live on (cached
    executables drop build-time payloads, so the mesh comes from the
    caller's live frames / the recorded on_mesh node), or onto the
    source frame's device for a host chain."""
    from tempo_tpu_torch import checkpoint as ckpt_mod

    mesh, s_ax, t_ax, on_mesh_seen, device = None, "series", None, False, None
    for n in node.walk():
        if n.op == "on_mesh":
            on_mesh_seen = True
            mesh = n.objs.get("mesh") or mesh
            s_ax = n.param("series_axis", "series")
            t_ax = n.param("time_axis")
        elif n.op == "dist_source":
            p = payloads[sources.index(n)]
            mesh, s_ax, t_ax = p.mesh, p.series_axis, p.time_axis
        elif n.op == "source":
            device = payloads[sources.index(n)].device
    if mesh is None and on_mesh_seen:
        from tempo_tpu_torch.parallel.mesh import default_mesh

        mesh = default_mesh(device)
    return ckpt_mod.load(path, mesh=mesh, series_axis=s_ax,
                         time_axis=t_ax, device=device)


def _bind_source(node: ir.Node, payload):
    if node.op == "unified_scan":
        # the unified history + live source: one TSDF over everything
        # ever written (store history plus the live tail), snapshotted
        # at this version under the table's watermark
        return payload.materialize()
    keep = node.ann.get("prune_to")
    if keep is None or node.op != "source":
        return payload
    logger.debug("plan: pruning %s before packing (dead columns: %s)",
                 type(payload).__name__, node.ann.get("pruned"))
    return payload.select(list(keep))


def _eval_op(node: ir.Node, ins: List):
    from tempo_tpu_torch.dist import DistributedTSDF

    op = node.op
    p = node.param
    if op == "reshard":
        # the optimizer's first-class layout switch (plan-placed
        # resharding): one explicit all_to_all program over the whole
        # frame instead of per-op pairs inside every downstream stage
        from tempo_tpu_torch import dist as dist_mod

        return dist_mod.reshard_frame(ins[0], p("target"))
    if op == "on_mesh":
        return ins[0].on_mesh(
            node.objs.get("mesh"), time_axis=p("time_axis"),
            series_axis=p("series_axis", "series"),
            halo_fraction=p("halo_fraction", 0.5))
    if op == "select":
        return ins[0].select(list(p("cols", ())))
    if op in ("sql_project", "sql_filter"):
        from tempo_tpu_torch.plan import sql_compile

        if op == "sql_project":
            return sql_compile.run_project(ins[0], node)
        return sql_compile.run_filter(ins[0], node)
    if op == "with_column":
        return ins[0].withColumn(p("colName"), node.objs["values"])
    if op == "asof_join":
        return ins[0].asofJoin(
            ins[1], left_prefix=p("left_prefix"),
            right_prefix=p("right_prefix") or "right",
            tsPartitionVal=p("tsPartitionVal"),
            fraction=p("fraction", 0.5),
            skipNulls=bool(p("skipNulls", True)),
            sql_join_opt=bool(p("sql_join_opt", False)),
            suppress_null_warning=bool(p("suppress_null_warning", False)),
            maxLookback=int(p("maxLookback", 0) or 0))
    if op == "range_stats":
        cols = p("colsToSummarize")
        cols = list(cols) if cols else None
        if isinstance(ins[0], DistributedTSDF):
            return ins[0].withRangeStats(
                colsToSummarize=cols,
                rangeBackWindowSecs=p("rangeBackWindowSecs", 1000),
                strategy=p("strategy", "exact"))
        return ins[0].withRangeStats(
            type=p("type", "range"), colsToSummarize=cols,
            rangeBackWindowSecs=p("rangeBackWindowSecs", 1000))
    if op == "ema":
        return ins[0].EMA(
            p("colName"), window=int(p("window", 30)),
            exp_factor=p("exp_factor", 0.2), exact=bool(p("exact", False)),
            inclusive_window=bool(p("inclusive_window", False)))
    if op == "ema_stream":
        # the standing-query canonical form of EMA(exact=True): the
        # sequential split-invariant EMA (ops/scan.ema_scan, the
        # csrc/ema_scan.cu kernel on a card) the serving carries resume
        # bitwise (query/split.py)
        from tempo_tpu_torch import rolling

        return rolling.eval_ema_stream(
            ins[0], p("colName"), float(p("exp_factor", 0.2)))
    if op == "resample":
        cols = p("metricCols")
        cols = list(cols) if cols else None
        if isinstance(ins[0], DistributedTSDF):
            return ins[0].resample(p("freq"), p("func"), metricCols=cols)
        return ins[0].resample(p("freq"), p("func"), metricCols=cols,
                               prefix=p("prefix"), fill=p("fill"))
    if op == "resample_ema":
        return ins[0].resampleEMA(p("freq"), p("colName"),
                                  exp_factor=p("exp_factor", 0.2))
    if op == "interpolate":
        cols = p("target_cols")
        cols = list(cols) if cols else None
        if isinstance(ins[0], DistributedTSDF):
            return ins[0].interpolate(
                freq=p("freq"), func=p("func"), method=p("method"),
                target_cols=cols,
                show_interpolated=bool(p("show_interpolated", False)))
        pcols = p("partition_cols")
        return ins[0].interpolate(
            freq=p("freq"), func=p("func"), method=p("method"),
            target_cols=cols, ts_col=p("ts_col"),
            partition_cols=list(pcols) if pcols else None,
            show_interpolated=bool(p("show_interpolated", False)))
    if op == "interpolate_resampled":
        cols = p("target_cols")
        return ins[0].interpolate(
            p("method"), target_cols=list(cols) if cols else None,
            show_interpolated=bool(p("show_interpolated", False)))
    if op == "fourier":
        return ins[0].fourier_transform(p("timestep"), p("valueCol"))
    if op == "lookback_features":
        return ins[0].withLookbackFeatures(
            list(p("featureCols", ())), int(p("lookbackWindowSize")),
            exactSize=bool(p("exactSize", True)),
            featureColName=p("featureColName", "features"))
    if op == "collect":
        return ins[0].collect()
    if op == "count":
        return ins[0].count()
    if op == "calc_bars":
        mc = p("metricCols")
        return ins[0].calc_bars(
            p("freq"), func=p("func"),
            metricCols=list(mc) if mc else None, fill=p("fill"))
    if op == "fused_asof_stats_ema":
        from tempo_tpu_torch.plan import fused

        out = fused.run(ins[0], ins[1], node)
        if out is not None:
            return out
        logger.debug("plan: fused chain guard failed at run time; "
                     "executing the chain op by op")
        return _sequential_chain(node, ins)
    if op == "stitched":
        from tempo_tpu_torch.plan import stitch

        out = stitch.run(ins[0], node)
        if out is not None:
            return out
        logger.debug("plan: stitched chain guard failed at run time; "
                     "executing the chain op by op")
        return stitch.run_sequential(ins[0], node)
    raise ValueError(f"plan executor: unknown op {op!r}")


def _sequential_chain(node: ir.Node, ins: List):
    """Op-by-op fallback for a fused node whose run-time guards failed
    (e.g. a frame grew a sequence column since planning, or the mesh
    spans processes)."""
    p = node.param
    cols = p("s_cols")
    out = ins[0].asofJoin(
        ins[1], left_prefix=p("j_left_prefix"),
        right_prefix=p("j_right_prefix") or "right",
    ).withRangeStats(
        colsToSummarize=list(cols) if cols else None,
        rangeBackWindowSecs=p("s_window", 1000))
    if p("has_ema"):
        out = out.EMA(
            p("e_col"), window=int(p("e_window", 30)),
            exp_factor=p("e_exp_factor", 0.2),
            exact=bool(p("e_exact", False)),
            inclusive_window=bool(p("e_inclusive", False)))
    return out
