"""Whole-chain stitching: a maximal run of adjacent series-local planned
mesh ops as one captured CUDA graph.

Counterpart of ``tempo_tpu/plan/stitch.py``.  ``plan/fused.py`` covers
one chain shape (asofJoin -> withRangeStats [-> EMA]); this module
covers the general case the optimizer's ``_stitch_chains`` pass
collapses: any single-consumer run of resample / interpolate / EMA /
withRangeStats / calc_bars over a mesh frame.

The reference replays each stage's host decisions in a metadata
interpreter and traces the shard kernels into one jitted program with
``optimization_barrier`` at every op boundary.  Here the device half is
the eager chain itself (:func:`run_sequential`, the same methods and
kernel wrappers the op-by-op chain calls), captured into one CUDA graph
over a copy of the frame's planes (the graph's static inputs) after one
warm-up run; later calls with the same host decisions copy their planes
in and replay.  The host decisions (column selection, bucket steps, the
layout-derived grid bound and row bounds, engine and kernel-form picks)
are made while the graph is captured, so the graph's key holds what
they depend on: the frame's layout (by identity), its column names and
flags, its plane shapes, dtypes and device, the stages and the knobs
(``config.snapshot``).  A column the chain never rewrites rides through
by reference, as in the eager methods.  Outputs are cloned out of the
graph's pool before the frame holds them.  On the CPU the same chain
runs uncaptured.  Either way the result is bitwise the op-by-op
chain's.

:class:`_Refuse` names what a graph cannot hold; ``run`` then returns
None and the executor replays the chain op by op (still planned and
cached):

* a frame on several cards or several processes (one graph is one
  device's stream; gloo collectives cannot be captured);
* a time-sharded frame (the reshard pass brackets series-local runs);
* a resample with an aggregate (mean / min / max, and calc_bars' low
  and high) on the card where the bucket-stats kernel takes its staged
  form: that form reads its long-row count on the host
  (``ops/bucket.py``) and relaunches the row form on those rows.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List

import torch

from tempo_tpu_torch import config
from tempo_tpu_torch.plan import fused, ir

logger = logging.getLogger(__name__)

#: ops the stitcher may collapse (all single-input, all series-local
#: under the run-time guards; calc_bars is a macro over resample +
#: interpolate)
STITCHABLE_OPS = ("resample", "interpolate", "ema", "range_stats",
                  "calc_bars")


class _Refuse(Exception):
    """A stage cannot run inside a captured graph: fall back to the
    op-by-op replay."""


def _bucket_aggregate(op: str, p: dict) -> bool:
    """Whether a stage runs the bucket-stats kernel."""
    from tempo_tpu_torch.dist import _canon_func
    from tempo_tpu_torch.freq import average, max_func, min_func

    if op == "calc_bars":
        return True                   # its low and high resamples
    if op == "resample":
        return _canon_func(p.get("func")) in (average, min_func, max_func)
    if op == "interpolate":
        # a non-resampled frame's interpolate resamples with ``func``
        return p.get("func") is not None and _canon_func(
            p.get("func")) in (average, min_func, max_func)
    return False


def _guard(frame, stages) -> None:
    from tempo_tpu_torch.ops import stream

    if frame.mesh.n_processes > 1:
        raise _Refuse("the mesh spans processes: gloo collectives cannot "
                      "be captured")
    if frame.time_axis is not None:
        raise _Refuse("time-sharded frame")
    devs = {str(d) for d in frame.devices}
    if len(devs) > 1:
        raise _Refuse(f"shards on {len(devs)} devices: one graph is one "
                      f"device's stream")
    if frame.devices[0].type != "cuda":
        return
    for op, params in stages:
        p = dict(params)
        if _bucket_aggregate(op, p):
            mc = p.get("metricCols") or p.get("target_cols")
            C = len(mc) if mc else len(frame.numeric_columns())
            if stream.bucket_plan(max(C, 1), frame.L) is not None:
                raise _Refuse(
                    f"{op}: the bucket-stats kernel's staged form reads "
                    f"its long-row count on the host (ops/bucket.py) and "
                    f"relaunches the row form, which a captured graph "
                    f"cannot hold")


def _planes(frame) -> List[torch.Tensor]:
    """Every device plane of the frame, in a fixed order."""
    out = list(frame.ts) + list(frame.mask)
    for c in frame.cols.values():
        out += list(c.values) + list(c.valid)
    if frame.seq is not None:
        out += list(frame.seq)
    return out


def _with_planes(frame, planes: List[torch.Tensor]):
    """``frame`` over ``planes`` (in :func:`_planes` order)."""
    n = len(frame.ts)
    it = iter([planes[i:i + n] for i in range(0, len(planes), n)])
    ts, mask = next(it), next(it)
    cols = {name: dataclasses.replace(c, values=next(it), valid=next(it))
            for name, c in frame.cols.items()}
    seq = next(it) if frame.seq is not None else None
    return frame._with(ts=ts, mask=mask, cols=cols, seq=seq)


def _out_tensors(frame, n_inherited: int) -> List[torch.Tensor]:
    """The distinct tensors the result frame holds (its planes and the
    counts of the audits the chain added), in a fixed order."""
    seen: Dict[int, torch.Tensor] = {}
    for t in _planes(frame) + [c for _, cs in frame.audits[n_inherited:]
                               for c in cs]:
        seen.setdefault(id(t), t)
    return list(seen.values())


def run(frame, node: ir.Node):
    """Execute a ``stitched`` node over one DistributedTSDF, or None when
    a run-time guard refuses (the executor then replays the chain op by
    op via :func:`run_sequential`)."""
    from tempo_tpu_torch.dist import DistributedTSDF

    if not isinstance(frame, DistributedTSDF):
        return None
    stages = node.param("stages") or ()
    try:
        _guard(frame, stages)
    except _Refuse as e:
        logger.debug("plan: stitched chain refused at run time (%s)", e)
        return None
    dev = frame.devices[0]
    if dev.type != "cuda":
        return run_sequential(frame, node)
    inputs = _planes(frame)
    key = (stages, tuple(frame.cols), tuple(
        (c.int64, c.ts_chunk) for c in frame.cols.values()),
        frame.resampled, frame._resample_freq, frame.seq is not None,
        len(frame.audits), tuple((tuple(x.shape), x.dtype) for x in inputs),
        config.snapshot())
    shape = {}
    n_in = len(frame.audits)

    def fn(*planes):
        # the eager chain over the static planes; its result's shape
        # (which tensors it holds where) is kept for the rebuild below
        out = run_sequential(_with_planes(frame, list(planes)), node)
        shape["frame"] = out
        shape["planes"] = list(planes)
        return _out_tensors(out, n_in)

    with torch.cuda.device(dev):
        outs, (template, static_in) = fused.run_segment(
            node, dev, key, fn, inputs, keep=frame.layout,
            remember=lambda: (shape["frame"], shape["planes"]))
    # rebuild the captured result frame over this call's tensors: a
    # static input is the caller's plane again, an output its clone
    by_id = {id(t): o for t, o in zip(_out_tensors(template, n_in), outs)}
    by_id.update({id(s): x for s, x in zip(static_in, inputs)})
    sub = lambda ts: [by_id.get(id(t), t) for t in ts]
    cols = {name: dataclasses.replace(c, values=sub(c.values),
                                      valid=sub(c.valid))
            for name, c in template.cols.items()}
    return template._with(
        ts=sub(template.ts), mask=sub(template.mask), cols=cols,
        seq=None if template.seq is None else sub(template.seq),
        audits=list(frame.audits) + [(m, sub(cs)) for m, cs
                                     in template.audits[n_in:]],
        layout=frame.layout, source_df=frame._source_df)


def run_sequential(frame, node: ir.Node):
    """Op-by-op replay of the recorded stages through the eager methods
    (one launch sequence an op, the same results and the eager error
    messages as an unstitched plan)."""
    from tempo_tpu_torch.plan import executor

    cur = frame
    for op, params in node.param("stages") or ():
        cur = executor._eval_op(ir.Node(op, params=dict(params)), [cur])
    return cur
