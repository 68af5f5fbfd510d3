"""Cost-based plan decisions: engine picks, fusion, stitching, reshard
placement.

Counterpart of ``tempo_tpu/plan/cost.py``.  Every planner choice is an
argmin over estimated seconds computed from byte models (the compulsory
bytes each engine moves) and measured rates, with the old thresholds
demoted to feasibility priors.

The priors are the card's own: :data:`PRIORS` holds rates measured by
``chip_smoke.py`` phase L on one NVIDIA H100 80GB HBM3 (the figures and
the card's power limit are in PERF.md), and the two inputs in
:data:`FIXED` that no run measures; the reference's TPU priors are not
carried.  :func:`set_measured` overlays fresher numbers.

**The bitwise contract bounds what cost may decide.**  The argmin runs
over the bitwise-equal candidate set only:

* the AS-OF join engines (single / chunked / bracket) give the same
  bits, so the join argmin is free within feasibility;
* the range-stats engines differ in float rounding, so the candidate
  set is the rule's singleton (``ops/rolling.pick_range_engine``); the
  estimates are computed and rendered (``explain()``) only;
* fused vs op-by-op, stitched vs op-by-op and placed vs declarative
  resharding are bitwise-equal pairs, so those decisions are free.

``TEMPO_TPU_COST_MODEL=0`` switches every consumer back to the rules.
:func:`fingerprint` folds the active inputs into the executable-cache
key, so flipping an input re-plans instead of replaying a stale
decision.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Dict, Optional, Tuple

#: Per-merged-lane traffic of an AS-OF join engine pass: int64 key read,
#: float32 payload read + bool validity, float32 result write.  One
#: shared constant: the engines move the same compulsory bytes and
#: differ in rate.
JOIN_LANE_BYTES = 17

#: Per-row traffic of a range-stats pass (int64 key + float32 value +
#: bool validity in, 7 float32 stat planes out) at one summarized column.
STATS_ROW_BYTES = 8 + 4 + 1 + 7 * 4

#: Cost priors.  Rates are bytes/sec, overheads are seconds.  Measured
#: by ``chip_smoke.py`` phase L (``measure_cost_priors``) on one NVIDIA
#: H100 80GB HBM3 at HHAR shapes ([1024, 12768]; PERF.md states each
#: figure with the card's power limit), except the names in
#: :data:`FIXED`:
#:
#: * ``hbm_stream_rate`` — range stats (row 2) at a 10 s window:
#:   STATS_ROW_BYTES a lane over its time, so the model's estimate is
#:   the measured time;
#: * ``vmem_pass_rate_multiple`` — the same at a 1000 s window: the
#:   extra time a window row of extent, against 4 bytes a lane at the
#:   stream rate (the shared-memory window walk's counterpart of the
#:   reference's VMEM passes);
#: * ``windowed_gather_penalty`` — the windowed form (rank kernel,
#:   ``cumsum3``, the min/max tables) over the row-bounded kernel's time
#:   on the same planes;
#: * ``join_single_rate`` / ``join_chunked_rate`` — the merge join's row
#:   walk and the lookback kernel's tiles (``max_lookback=0``) on the
#:   same join, JOIN_LANE_BYTES a merged lane over the time;
#: * ``host_bracket_rate`` — the frame-level join forced onto host time
#:   brackets (``join.py``) over 64 of the HHAR series, JOIN_LANE_BYTES
#:   a merged lane over its wall time;
#: * ``dispatch_overhead_s`` — one kernel wrapper call on a [1, 8] row,
#:   launch and synchronise;
#: * ``ici_rate`` — the tiled all-to-all (``parallel/reshard.py``, the
#:   move of a layout switch) of one float32 plane over series 2 x
#:   time 2 entries of the card: the plane's bytes over its time (no
#:   link joins two cards in the measured runs).
#:
#: The reference's ``chunk_overhead_s`` (a grid step a lane chunk of its
#: chunked engine) has no counterpart: the lookback kernel cuts its rows
#: into tiles itself, in one call.
PRIORS: Dict[str, float] = {
    "hbm_stream_rate": 1.9697e12,
    "join_single_rate": 1.4017e12,
    "join_chunked_rate": 0.9825e12,
    "host_bracket_rate": 2.4188e7,
    "ici_rate": 2.8971e11,
    "dispatch_overhead_s": 26.82e-6,
    "fused_overhead_s": 0.0,
    "reshard_dispatch_s": 0.0,
    "windowed_gather_penalty": 57.60,
    "vmem_pass_rate_multiple": 5.184,
}

#: Priors that no run measures, fixed at 0: what one captured graph
#: costs beyond a dispatch (``fused_overhead_s``) and what a placed
#: reshard node costs beyond its bytes (``reshard_dispatch_s``).  At 0
#: fusion, stitching and placement win wherever they save a dispatch or
#: a switch, the reference's rules.
FIXED = ("fused_overhead_s", "reshard_dispatch_s")

_lock = threading.Lock()
_measured: Dict[str, float] = {}  # guarded-by: _lock

#: build-time pin: the executor snapshots the active inputs ONCE when
#: it computes the cache key and installs them here for the whole
#: optimize/build, so a concurrent ``set_measured`` (a live autotuner
#: feeding rates while the query service builds) can never bake
#: decisions into an executable cached under the OLD fingerprint.
_PINNED: contextvars.ContextVar[Optional[Dict[str, float]]] = \
    contextvars.ContextVar("tempo_tpu_cost_pinned", default=None)


@contextlib.contextmanager
def pinned(snapshot: Optional[Dict[str, float]]):
    """Run a block with the cost inputs pinned to ``snapshot`` (a
    :func:`params` result; None = no-op, for the cost-model-off
    path).  Every ``params()`` read inside the block — the optimizer
    passes, the engine picks they call — sees the snapshot."""
    if snapshot is None:
        yield
        return
    token = _PINNED.set(dict(snapshot))
    try:
        yield
    finally:
        _PINNED.reset(token)


def enabled() -> bool:
    """``TEMPO_TPU_COST_MODEL`` (default on).  Off = every consumer
    (``pick_join_engine``, the optimizer's fusion and reshard passes)
    returns to the pure rule-based decision."""
    from tempo_tpu_torch import config

    return config.get_bool("TEMPO_TPU_COST_MODEL", True)


def set_measured(**inputs: float) -> None:
    """Overlay measured cost inputs over the priors (process-wide).
    Unknown names raise — the input space is the documented
    :data:`PRIORS` set.  ``TEMPO_TPU_STREAM_MAX_ROWS`` is deliberately NOT a
    cost input: it gates which range engine is *bitwise-legal* (the
    engines differ in f32 rounding), so overriding it here could flip
    result bits — widen the knob itself instead."""
    known = set(PRIORS)
    for name in inputs:
        if name not in known:
            raise KeyError(
                f"unknown cost input {name!r}: known inputs are "
                f"{sorted(known)}")
    with _lock:
        _measured.update({k: float(v) for k, v in inputs.items()})


def clear_measured() -> None:
    with _lock:
        _measured.clear()


def params() -> Dict[str, float]:
    """The active cost inputs: the priors and any :func:`set_measured`
    overlay on top.  Inside a :func:`pinned` block the snapshot wins
    outright (build-time consistency).  The reference also overlays its
    autotuner's profile; the port has no tuner yet (ROADMAP A14)."""
    pin = _PINNED.get()
    if pin is not None:
        return dict(pin)
    out = dict(PRIORS)
    with _lock:
        out.update(_measured)
    return out


def snapshot() -> Optional[Dict[str, float]]:
    """The active inputs as a build-time pin (None when the model is
    off): the executor keys the cache with
    ``fingerprint(snapshot)`` and optimizes under ``pinned(snapshot)``
    so key and decisions can never diverge mid-build."""
    return params() if enabled() else None


def fingerprint(snap: Optional[Dict[str, float]] = None) -> tuple:
    """Hashable digest of the cost inputs (``snap`` when given, else
    the live ones), folded into the executable-cache key
    (plan/executor.py): flipping an input must re-plan, never replay a
    decision made under the other inputs."""
    if snap is None:
        if not enabled():
            return ("cost-off",)
        snap = params()
    return tuple(sorted(snap.items()))


# ----------------------------------------------------------------------
# AS-OF join engines — the bitwise-free argmin
# ----------------------------------------------------------------------

def join_costs(est_lanes: int, limit: int,
               chunked_ok: bool) -> Dict[str, Optional[float]]:
    """Estimated seconds per join engine at ``est_lanes`` merged lanes;
    ``None`` marks an engine outside its feasibility (the old
    thresholds, now candidate gates): ``single`` past the merged-lane
    limit, ``chunked`` where the caller rules it out."""
    p = params()
    nbytes = float(est_lanes) * JOIN_LANE_BYTES
    out: Dict[str, Optional[float]] = {
        "single": None, "chunked": None, "bracket": None}
    if limit <= 0 or est_lanes <= limit:
        out["single"] = nbytes / p["join_single_rate"] \
            + p["dispatch_overhead_s"]
    if chunked_ok:
        out["chunked"] = nbytes / p["join_chunked_rate"] \
            + p["dispatch_overhead_s"]
    out["bracket"] = nbytes / p["host_bracket_rate"] \
        + p["dispatch_overhead_s"]
    return out


def decide_join_engine(est_lanes: int, limit: int, chunked_ok: bool) -> str:
    """Cheapest feasible join engine.  All three engines give the same
    bits, so the argmin is unconstrained within feasibility; under the
    default priors it reproduces the rule-based pick (single under the
    limit, chunked past it, bracket last), and a measured rate or
    overhead override flips it."""
    costs = join_costs(est_lanes, limit, chunked_ok)
    order = ("single", "chunked", "bracket")   # rule-order tie-break
    best = min((e for e in order if costs[e] is not None),
               key=lambda e: costs[e])
    return best


# ----------------------------------------------------------------------
# Range-stats engines — argmin over the bitwise-safe singleton
# ----------------------------------------------------------------------

def range_costs(W: int, n_elems: int) -> Dict[str, float]:
    """Estimated seconds per range-stats engine over ``n_elems`` rows
    with a (max_behind + max_ahead) row extent of ``W``: the numbers the
    plan-time hoist (``optimizer._hoist_engines``) attaches to
    range_stats nodes for ``explain()``.  The row-bounded kernel
    (``shifted``; ``stream`` is the reference's second name for it)
    crosses global memory once and re-reads its shared-memory window
    once per window row at ``vmem_pass_rate_multiple`` times the stream
    rate; windowed pays the measured gather penalty but is independent
    of ``W``."""
    p = params()
    base = float(n_elems) * STATS_ROW_BYTES / p["hbm_stream_rate"]
    per_pass = (float(n_elems) * 4.0
                / (p["hbm_stream_rate"] * p["vmem_pass_rate_multiple"]))
    passes = max(1, int(W)) * per_pass
    return {
        "shifted": base + passes + p["dispatch_overhead_s"],
        "stream": base + passes + 2 * p["dispatch_overhead_s"],
        "windowed": base * p["windowed_gather_penalty"]
        + p["dispatch_overhead_s"],
    }


def decide_range_engine(W: int, n_elems: int, fits_shifted: bool,
                        fits_stream: bool) -> str:
    """Cheapest *bitwise-safe* range engine.  The engines differ in
    float rounding order, so the candidate set is the rule's singleton
    (shifted iff it fits, else stream iff it fits, else windowed) and an
    argmin over one candidate never flips the rule's pick.  ``W`` and
    ``n_elems`` stay in the signature as the decision's inputs."""
    del W, n_elems                       # singleton candidate set
    if fits_shifted:
        return "shifted"
    if fits_stream:
        return "stream"
    return "windowed"


# ----------------------------------------------------------------------
# Fusion and reshard placement — bitwise-equal program shapes
# ----------------------------------------------------------------------

def fusion_worthwhile(n_ops: int, est_bytes: int) -> Tuple[bool, dict]:
    """Should a mesh ``asofJoin -> withRangeStats [-> EMA]`` run fuse
    into one captured graph (plan/fused.py)?  Both shapes give the same
    bits (the graph runs the same kernels on the same inputs), so the
    decision is free: fused saves ``n_ops - 1`` dispatches and the
    between-op re-reads; ``fused_overhead_s`` charges whatever one graph
    costs extra (0 under the priors: fusion wins, the rule)."""
    p = params()
    re_read = float(est_bytes) / p["hbm_stream_rate"]
    cost_chain = n_ops * p["dispatch_overhead_s"] + (n_ops - 1) * re_read
    cost_fused = p["dispatch_overhead_s"] + p["fused_overhead_s"]
    return cost_fused <= cost_chain, {
        "fused_s": cost_fused, "chain_s": cost_chain, "n_ops": n_ops}


def stitch_worthwhile(n_ops: int, est_bytes: int) -> Tuple[bool, dict]:
    """Should a maximal run of ``n_ops`` adjacent series-local planned
    ops (resample / interpolate / EMA / range stats / calc_bars) stitch
    into one captured graph (plan/stitch.py)?  As
    :func:`fusion_worthwhile`: both forms give the same bits, the chain
    pays ``n_ops`` dispatches plus the between-op re-reads, the graph
    one dispatch plus ``fused_overhead_s``."""
    p = params()
    re_read = float(est_bytes) / p["hbm_stream_rate"]
    cost_chain = n_ops * p["dispatch_overhead_s"] + (n_ops - 1) * re_read
    cost_stitched = p["dispatch_overhead_s"] + p["fused_overhead_s"]
    return cost_stitched <= cost_chain, {
        "stitched_s": cost_stitched, "chain_s": cost_chain,
        "n_ops": n_ops}


def reshard_decision(n_placed: int, placed_bytes: Optional[int],
                     n_internal: int,
                     internal_bytes: Optional[int]) -> Tuple[bool, dict]:
    """Should the optimizer place explicit ``reshard`` plan nodes around
    this plan's series-local runs (vs each op's own switch pair,
    ``declarative``)?  Both placements give the same bits, so the
    decision is free: per-switch seconds from the relayout byte model
    over ``ici_rate``, plus ``reshard_dispatch_s`` a placed node.
    Without byte models (geometry not derivable at plan time) switch
    counts decide.  Under the priors placement wins whenever it
    eliminates a switch (the rule)."""
    p = params()
    if placed_bytes is not None and internal_bytes is not None:
        placed_s = placed_bytes / p["ici_rate"] \
            + n_placed * p["reshard_dispatch_s"]
        internal_s = internal_bytes / p["ici_rate"]
    else:
        # count-only fallback: a nominal 1 MiB per switch (the byte
        # model is unavailable, the *ratio* of switch counts decides)
        per_switch = float(1 << 20) / p["ici_rate"]
        placed_s = n_placed * (per_switch + p["reshard_dispatch_s"])
        internal_s = n_internal * per_switch
    return placed_s <= internal_s, {
        "placed_s": placed_s, "declarative_s": internal_s,
        "n_placed": n_placed, "n_internal_switches": n_internal}
