"""``explain()`` rendering: logical plan, optimized plan, per-node
engine choices, barriers, and (``cost=True``) what the card states of
the plan's captured device segments.

Counterpart of ``tempo_tpu/plan/render.py``; ``explain(cost=False)``
renders what the reference renders.  Where the reference prints XLA's
compiled cost and memory analysis, the port fills the same keys
(``profiling.compiled_cost``) with what a captured CUDA graph states:
argument and output bytes and the graph pool's bytes as
``temp_bytes``; no flop count.
"""

from __future__ import annotations

from typing import List

from tempo_tpu_torch.plan import ir, optimizer


def _param_str(node: ir.Node) -> str:
    parts = []
    for k, v in node.params:
        if v is None or k == "mesh":
            continue
        if ir.is_opaque(v):
            v = "<opaque>"
        parts.append(f"{k}={v!r}")
    return ", ".join(parts)


def _node_line(node: ir.Node) -> str:
    if node.op == "source":
        t = node.payload
        cols = node.ann.get("prune_to") or tuple(t.df.columns)
        line = (f"source[host] rows={len(t.df)} ts={t.ts_col!r} "
                f"keys={t.partitionCols} cols={list(cols)}")
        if node.ann.get("pruned"):
            line += f"  ! pruned before packing: {list(node.ann['pruned'])}"
        return line
    if node.op == "dist_source":
        p = node.payload
        axes = dict(p.mesh.shape)
        return (f"source[mesh {axes}] packed=[{p.K_dev}, {p.L}] "
                f"cols={list(p.cols)}")
    if node.op == "unified_scan":
        p = node.payload
        return (f"unified_scan[{p.table.name!r} v{p.table.version}] "
                f"history+live under one watermark "
                f"ts={p.ts_col!r} keys={list(p.partitionCols)} "
                f"cols={list(p.columns)}")
    if node.op == "ema_stream":
        return (f"ema_stream[{node.param('colName')!r} "
                f"alpha={node.param('exp_factor')}]  <- CANONICALIZED: "
                f"sequential split-invariant EMA kernel (resumable "
                f"bitwise by the serving carry)")
    if node.op == "reshard":
        line = f"reshard[{node.param('target')}]"
        model = node.ann.get("comm_bytes_model")
        line += ("  <- PLACED: explicit all_to_all layout switch"
                 + (f", ~{model} B/shard modeled comm" if model else ""))
        return line
    if node.op == "checkpoint":
        line = f"checkpoint[step {node.param('step')}]"
        est = node.ann.get("ckpt_bytes_est")
        line += ("  <- PLACED: plan barrier (signed step manifest, "
                 "resume point)"
                 + (f", ~{est} B est" if est else ""))
        return line
    if node.op == "stitched":
        ops = [op for op, _ in (node.param("stages") or ())]
        line = (f"stitched[{' -> '.join(ops)}]  <- STITCHED: "
                f"{len(ops)} ops -> 1 dispatch "
                f"(one captured CUDA graph)")
        if "capture" in node.ann:
            line += f"; {node.ann['capture']}"
        sc = node.ann.get("stitch_cost")
        if sc:
            line += (f"; cost-decided: {sc['decision']} "
                     f"(stitched~{sc['stitched_s'] * 1e6:.1f}us vs "
                     f"chain~{sc['chain_s'] * 1e6:.1f}us)")
        return line
    if node.op == "sql_project":
        aliases = node.param("aliases", ())
        line = f"sql_project[{', '.join(aliases)}]"
    elif node.op == "sql_filter":
        line = f"sql_filter[{node.param('condition')}]"
    else:
        line = f"{node.op}({_param_str(node)})"
    notes = []
    if "sql_eval" in node.ann:
        notes.append(f"eval[sql]={node.ann['sql_eval']}")
    if "reshard_eliminated" in node.ann:
        notes.append(f"reshard ELIMINATED: {node.ann['reshard_eliminated']}")
    if "reshard_note" in node.ann:
        notes.append(node.ann["reshard_note"])
    if "join_engine" in node.ann:
        est = node.ann.get("merged_lanes_est")
        notes.append(f"engine[join]={node.ann['join_engine']}"
                     + (f" (~{est} merged lanes)" if est else ""))
    if "range_engine" in node.ann:
        notes.append(f"engine[stats]={node.ann['range_engine']}")
    if "cost" in node.ann:
        notes.append("est cost: " + ", ".join(
            f"{k}~{v * 1e6:.1f}us" for k, v in node.ann["cost"].items()))
    if "fusion_cost" in node.ann:
        fc = node.ann["fusion_cost"]
        notes.append(
            f"cost-decided fusion: {fc['decision']} "
            f"(fused~{fc['fused_s'] * 1e6:.1f}us vs "
            f"chain~{fc['chain_s'] * 1e6:.1f}us)")
    if "stitch_cost" in node.ann:
        sc = node.ann["stitch_cost"]
        notes.append(
            f"cost-decided stitch: {sc['decision']} "
            f"(stitched~{sc['stitched_s'] * 1e6:.1f}us vs "
            f"chain~{sc['chain_s'] * 1e6:.1f}us)")
    if "rewrite" in node.ann:
        notes.append(f"rewrite: {node.ann['rewrite']}")
    if "capture" in node.ann:
        notes.append(node.ann["capture"])
    if "barrier" in node.ann:
        notes.append(f"BARRIER: {node.ann['barrier']}")
    if notes:
        line += "  <- " + "; ".join(notes)
    return line


def _tree(node: ir.Node, depth: int = 0, out: List[str] = None) -> List[str]:
    out = [] if out is None else out
    prefix = "" if depth == 0 else "   " * (depth - 1) + "+- "
    out.append(prefix + _node_line(node))
    for child in node.inputs:
        _tree(child, depth + 1, out)
    return out


def explain_text(root: ir.Node, cost: bool = False) -> str:
    opt = optimizer.optimize(root)
    lines = ["== Logical plan =="]
    lines += _tree(root)
    lines += ["", "== Optimized plan =="]
    lines += _tree(opt)
    barriers = [n.op for n in opt.walk() if "barrier" in n.ann]
    lines += ["", "barriers: " + (", ".join(barriers) if barriers
                                  else "none (chain stays on device)")]
    rc = opt.ann.get("reshard_cost")
    if rc:
        lines += [f"reshard placement: cost-decided -> {rc['decision']} "
                  f"(placed~{rc['placed_s'] * 1e6:.1f}us vs "
                  f"declarative~{rc['declarative_s'] * 1e6:.1f}us, "
                  f"{rc['n_placed']} placed vs "
                  f"{rc['n_internal_switches']} internal switches)"]
    if cost:
        lines += ["", f"== Captured cost ({_card_name()}) =="]
        lines += _cost_lines(opt)
    from tempo_tpu_torch.plan import cache

    st = cache.CACHE.stats()
    lines += ["plan cache: %d/%s entries, %d hits, %d misses, "
              "%d evictions" % (st["size"], st["max_size"], st["hits"],
                                st["misses"], st["evictions"])]
    return "\n".join(lines)


def _card_name() -> str:
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "no CUDA card: plain versions, uncaptured"


def _cost_lines(opt: ir.Node) -> List[str]:
    """``profiling.compiled_cost`` numbers for the plan's fused device
    segment (host ops have no graph to cost)."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.plan import executor, fused

    out = []
    for n in opt.walk():
        if n.op != "fused_asof_stats_ema":
            continue
        # evaluate the two (source-side) inputs to concrete frames so
        # the segment is captured at the real shapes
        try:
            frames = []
            for child in n.inputs:
                child_exe = executor.Executable(child)
                frames.append(child_exe.run(
                    [s.payload for s in child.sources()]))
            c = fused.compiled_cost(frames[0], frames[1], n)
        except Exception as e:  # pragma: no cover - device-specific
            out.append(f"fused_asof_stats_ema: cost unavailable ({e})")
            continue
        if c is None:
            out.append("fused_asof_stats_ema: cost unavailable "
                       "(run-time guard failed)")
            continue
        out.append("fused_asof_stats_ema: "
                   + ", ".join(f"{k}={v}" for k, v in c.items()
                               if v is not None))
    if not out:
        out.append("no fused device segment in this plan: per-op "
                   "launches are costed by profiling.compiled_cost at "
                   "execution time")
    for n in opt.walk():
        if n.op == "source":
            out.append(f"source[host]: host_bytes="
                       f"{profiling.host_bytes(n.payload.df)}")
    return out
