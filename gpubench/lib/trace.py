"""Reading a Chrome trace of ``torch.profiler``: spans, the card's busy
time, its idle gaps and its heaviest operations.

The busy arithmetic is copied from ``chip_smoke.py``'s
``trace_summary`` (PERF.md section 5's busy share): the union of the
intervals of kernel, copy and memset records, clipped to the window.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

#: Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories whose spans name what the host was doing
HOST_CATS = ("user_annotation", "cpu_op")


def load(path: str) -> List[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def spans(events: Iterable[dict], name: str) -> List[Tuple[float, float]]:
    """``(start, end)`` in microseconds of the host spans named ``name``."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def device(events: Iterable[dict], w0: float, w1: float,
           cats: Tuple[str, ...] = DEVICE_CATS) -> List[dict]:
    """Device records of ``cats`` that start inside ``[w0, w1]``."""
    return [e for e in events if e.get("cat") in cats
            and w0 <= float(e["ts"]) <= w1]


def busy_intervals(events: Iterable[dict], w0: float, w1: float
                   ) -> List[Tuple[float, float]]:
    """The union of the device records' intervals inside ``[w0, w1]``."""
    merged: List[List[float]] = []
    for s, t in sorted((max(float(e["ts"]), w0),
                        min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in events if e.get("cat") in DEVICE_CATS):
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_seconds(events: Iterable[dict], w0: float, w1: float) -> float:
    return sum(t - s for s, t in busy_intervals(events, w0, w1)) / 1e6


def top_device_ops(events: Iterable[dict], w0: float, w1: float,
                   n: int = 10) -> List[list]:
    """``[name, seconds]`` of the ``n`` device operations with the most
    time inside the window."""
    tot: Dict[str, float] = {}
    for e in device(events, w0, w1):
        tot[e["name"]] = tot.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: List[dict], w0: float, w1: float, tid=None,
              n: int = 10) -> List[list]:
    """``[name, seconds]``: the card's idle time inside the window, each
    gap put under the innermost host span (of thread ``tid``, where
    given) open at its midpoint, "host" where none is, summed by name;
    the ``n`` largest.  Spans of one thread nest, so one sweep with a
    stack finds the innermost."""
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and (tid is None or e.get("tid") == tid)
                   and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0
                   and not (float(e["ts"]) <= w0
                            and float(e["ts"]) + float(e["dur"]) >= w1)),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    gaps = []
    prev = w0
    for s, t in busy_intervals(events, w0, w1) + [(w1, w1)]:
        if s > prev:
            gaps.append(((prev + s) / 2, (s - prev) / 1e6))
        prev = max(prev, t)
    tot: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []
    i = 0
    for mid, secs in gaps:
        while i < len(host) and float(host[i]["ts"]) <= mid:
            e = host[i]
            while stack and stack[-1][0] < float(e["ts"]):
                stack.pop()
            stack.append((float(e["ts"]) + float(e["dur"]), e["name"]))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        name = stack[-1][1] if stack else "host"
        tot[name] = tot.get(name, 0.0) + secs
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def mean_span_s(ctx, name: str):
    """Mean seconds of the spans named ``name`` over the traced chains,
    or None where the trace holds none."""
    found = spans(ctx.events, name)
    if not found:
        return None
    return sum(t - s for s, t in found) / 1e6 / len(found)


def kernel_roofline_pct(ctx):
    """The chains' least card time (``lib/roofline``) over the time of
    every kernel in the traced window, in percent; None without kernel
    records."""
    from gpubench.lib import roofline

    ks = device(ctx.events, ctx.w0, ctx.w1, ("kernel",))
    busy = sum(float(e["dur"]) for e in ks) / 1e6
    if busy <= 0:
        return None
    return 100.0 * ctx.chains * roofline.least_seconds(ctx.work) / busy


def idle_share_pct(ctx):
    """The card's idle share of the traced window, in percent; None
    where the trace holds no device record."""
    if not device(ctx.events, ctx.w0, ctx.w1):
        return None
    window = (ctx.w1 - ctx.w0) / 1e6
    return 100.0 * (1.0 - busy_seconds(ctx.events, ctx.w0, ctx.w1) / window)
