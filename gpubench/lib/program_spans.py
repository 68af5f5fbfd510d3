"""Reading the program's own spans in a Chrome trace of
``torch.profiler``.

The program opens its spans with ``profiling.annotate``
(``record_function``), named ``tempo.<layer>.<op>[.<phase>]``: the
mesh frame's ops as ``tempo.dist.*`` and each kernel launch as
``tempo.kernel.<kernel>``.  They land in the trace as
``user_annotation`` events on the chain's thread, on the same clock as
the card's records.  Spans of one thread nest, so a sweep with a stack
finds the innermost open at any time.  A trace of a program without
such spans gives nothing here: every reader then returns None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from gpubench.lib.trace import busy_intervals, device

Interval = Tuple[float, float]

#: prefix of every span the program opens
PROGRAM = "tempo."
#: the mesh frame's spans (``dist.py``)
MESH = "tempo.dist."
#: the kernel launch wrappers' spans (``ops/cuda_lib.py``)
KERNEL = "tempo.kernel."
#: CUDA runtime calls that block the host until the card has caught up
#: (the names ``torch.profiler`` gives them in its ``cuda_runtime``
#: records; ``metrics/host_waits.resident.py`` says which occur)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def program_spans(ctx, prefix: str = PROGRAM) -> List[dict]:
    """The program's spans whose names start with ``prefix``, on the
    chain's thread, that overlap the window, sorted by start (an outer
    span before the inner one that starts with it)."""
    w0, w1 = ctx.w0, ctx.w1
    return sorted((e for e in ctx.events
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(prefix)
                   and e.get("tid") == ctx.tid
                   and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))


def union(spans: Iterable[dict], w0: float, w1: float) -> List[Interval]:
    """The union of the spans' intervals clipped to ``[w0, w1]``."""
    merged: List[List[float]] = []
    for s, t in sorted((max(float(e["ts"]), w0),
                        min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in spans):
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def length(intervals: Sequence[Interval]) -> float:
    """Microseconds the disjoint ``intervals`` cover."""
    return sum(t - s for s, t in intervals)


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Microseconds two sorted lists of disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t > s:
            out += t - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def innermost(spans: Sequence[dict], points: Sequence[float]
              ) -> List[Optional[str]]:
    """For each of the ascending ``points``, the name of the innermost of
    ``spans`` (one thread's, sorted as :func:`program_spans` sorts them)
    open there, or None."""
    out: List[Optional[str]] = []
    stack: List[Tuple[float, str]] = []
    i = 0
    for p in points:
        while i < len(spans) and float(spans[i]["ts"]) <= p:
            e = spans[i]
            while stack and stack[-1][0] < float(e["ts"]):
                stack.pop()
            stack.append((float(e["ts"]) + float(e["dur"]), e["name"]))
            i += 1
        while stack and stack[-1][0] < p:
            stack.pop()
        out.append(stack[-1][1] if stack else None)
    return out


def idle_gaps(events: List[dict], w0: float, w1: float) -> List[Interval]:
    """The card's idle intervals inside the window: the complement of
    ``lib/trace.busy_intervals``."""
    gaps = []
    prev = w0
    for s, t in busy_intervals(events, w0, w1) + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    return gaps


def mesh_host_s(ctx):
    """Seconds a chain inside the mesh frame's spans and outside the
    kernel launch spans they hold; None without mesh-frame spans."""
    mesh = program_spans(ctx, MESH)
    if not mesh:
        return None
    m = union(mesh, ctx.w0, ctx.w1)
    k = union(program_spans(ctx, KERNEL), ctx.w0, ctx.w1)
    return (length(m) - overlap(m, k)) / 1e6 / ctx.chains


def mesh_idle_s(ctx):
    """Seconds a chain the card sat idle while the innermost open program
    span (at the gap's midpoint) was a mesh-frame span; None without
    device records or without mesh-frame spans."""
    spans = program_spans(ctx)
    if not device(ctx.events, ctx.w0, ctx.w1) or \
            not any(e["name"].startswith(MESH) for e in spans):
        return None
    gaps = idle_gaps(ctx.events, ctx.w0, ctx.w1)
    names = innermost(spans, [(s + t) / 2 for s, t in gaps])
    idle = sum(t - s for (s, t), name in zip(gaps, names)
               if name is not None and name.startswith(MESH))
    return idle / 1e6 / ctx.chains


def launch_host_s(ctx):
    """Seconds a chain inside the kernel launch spans; None without
    them."""
    spans = program_spans(ctx, KERNEL)
    if not spans:
        return None
    return length(union(spans, ctx.w0, ctx.w1)) / 1e6 / ctx.chains


def host_waits(ctx):
    """Blocking runtime calls a chain (``WAITS``, on the chain's thread
    in the window) made while a program span was open; None without
    runtime records or without program spans."""
    spans = program_spans(ctx)
    runtime = [e for e in ctx.events if e.get("cat") == "cuda_runtime"
               and e.get("tid") == ctx.tid
               and ctx.w0 <= float(e["ts"]) <= ctx.w1]
    if not spans or not runtime:
        return None
    waits = sorted(float(e["ts"]) for e in runtime if e["name"] in WAITS)
    inside = sum(name is not None for name in innermost(spans, waits))
    return inside / ctx.chains
