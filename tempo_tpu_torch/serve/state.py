"""Incremental operator state of the serving engine, one stream.

Counterpart of the single-stream half of ``tempo_tpu/serve/state.py``.
Three operator states, each an ``init / update(batch) / query``
contract, held as tensors on the stream's device and threaded through
the step functions (carries in, carries out):

* **the AS-OF join carry**: the chunked merge kernel's carry as named
  arrays (``ops/merge.asof_carry_init``).  Fills select values and
  compute none, so threading the carry across any push split gives the
  batch join over the concatenated history bit for bit.
* **the EMA carry**: ``ops/scan.ema_scan``'s ``y``, one multiply and one
  add a lane strictly left to right (the hand-written kernel
  ``csrc/ema_scan.cu`` on a card), so resuming from it is exact.
* **the ring-buffer window state**: the last ``rows_bound + 1`` right
  rows of each series (timestamps, values, validity).  A new row's stats
  come from the same masked shifted passes (``_window_passes``) over
  ``[ring | batch]`` that the batch operator :func:`window_stats_batch`
  runs over ``[fill | history]``: the same ops over the same operands,
  hence the same bits.  These are the causal, uncentred window stats:
  ``withRangeStats`` centres each series on its whole-history mean, a
  value that changes as rows arrive, so serving has its own batch form.

The state layout is the reference's, float32 values included, on the
card and on the CPU, so a snapshot either package writes resumes in the
other.  The steps are plain torch over the stream's tensors plus the
``ema_scan`` kernel.  Each ``(cfg.key(), Lb, device_key())`` step is one
entry of the planner's executable cache (``plan/cache.py``): on a card it
is captured once as a CUDA graph (``plan/fused.capture``) and replayed,
so ``graph_captures`` / ``graph_replays`` count it; on the CPU it runs
eagerly and the cache counts its build.  The reference donates the
retired state buffers to its compiled steps (its ``state.py:58-85``);
that has no counterpart here: a replay copies its inputs into the
graph's static inputs and clones its outputs out of the graph's pool, so
the next push's state never aliases the pool.

The cohort half (``serve/cohort.py``) runs the same step functions over
state with a leading ``[S]`` stream axis: the steps are rank-generic
(the reference vmaps them; ``torch.func.vmap`` cannot trace through the
ctypes launch of ``ema_scan``), so a cohort step is one CUDA graph over
``S`` streams whose every slice is a single stream's bits.  The block
programs put the scatter of compact ticks into the padded batch, the
step and the gather of their emissions into one graph.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tempo_tpu_torch import device as device_mod
from tempo_tpu_torch.ops import merge as ops_merge
from tempo_tpu_torch.ops import scan as ops_scan
from tempo_tpu_torch.packing import TS_PAD

_FAR_PAST = np.int64(-(1 << 62))


def window_ns(window_secs) -> int:
    """Window width in integer nanoseconds.  Membership ``ts >= t - w``
    over int64-ns keys equals ``ts >= t - floor(w_ns)``: every float
    width folds to an exact integer compare, and the steps do no float
    timestamp arithmetic."""
    return int(math.floor(float(window_secs) * 1e9))


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration of one stream: everything that shapes the
    step functions (the state layout included)."""

    n_series: int                       # K lane rows, fixed for life
    n_cols: int                         # C metric columns
    skip_nulls: bool = True
    max_lookback: int = 0               # merged-row horizon; 0 = off
    window_ns: Optional[int] = None     # range-stats width; None = off
    rows_bound: int = 64                # ring capacity D (declared max
    #                                     rows any window reaches back)
    ema_alpha: Optional[float] = None   # EMA factor; None = off

    @property
    def has_window(self) -> bool:
        return self.window_ns is not None

    @property
    def has_ema(self) -> bool:
        return self.ema_alpha is not None

    def state_names(self) -> Tuple[str, ...]:
        names = ["last_val", "last_src", "lock_val", "lock_valid",
                 "lock_src", "last_ridx", "r_count", "n_merged"]
        if self.has_ema:
            names.append("ema_y")
        if self.has_window:
            names += ["ring_ts", "ring_x", "ring_valid", "clipped"]
        return tuple(names)

    def emit_keys(self) -> Tuple[str, ...]:
        """Names of the push step's emission planes, in order."""
        return ((("ema",) if self.has_ema else ())
                + (_STAT_KEYS if self.has_window else ()))

    def key(self) -> tuple:
        return (self.n_series, self.n_cols, self.skip_nulls,
                self.max_lookback, self.window_ns, self.rows_bound,
                self.ema_alpha)


def init_state(cfg: StreamConfig) -> Dict[str, np.ndarray]:
    """Fresh carry arrays (numpy) for every operator the config enables:
    the ``init`` leg of the operator contract."""
    C, K = cfg.n_cols, cfg.n_series
    state = ops_merge.asof_carry_init(C, K)
    state["r_count"] = np.zeros((K,), np.int64)
    if cfg.has_ema:
        state["ema_y"] = np.zeros((C, K), np.float32)
    if cfg.has_window:
        R = cfg.rows_bound + 1   # +1 keeps the truncation-audit row
        state["ring_ts"] = np.full((K, R), TS_PAD, np.int64)
        state["ring_x"] = np.zeros((C, K, R), np.float32)
        state["ring_valid"] = np.zeros((C, K, R), bool)
        state["clipped"] = np.zeros((K,), np.int64)
    return {name: state[name] for name in cfg.state_names()}


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host state arrays as tensors on ``device`` (copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


# ----------------------------------------------------------------------
# The window passes shared by the step and the batch form
# ----------------------------------------------------------------------

def _lag(a: torch.Tensor, d: int, n_out: int) -> torch.Tensor:
    """``out[..., i] = a[..., i - d]`` for the trailing ``n_out`` lanes of
    ``a``.  The window passes' prefix (the ring, or the batch form's
    fill) holds ``D + 1`` lanes before them and ``d <= D + 1``, so every
    such lane has its source inside ``a``: a slice (a view), where the
    reference pads with a fill that no emitted lane reads."""
    n = a.shape[-1]
    return a[..., n - n_out - d:n - d]


def _window_passes(ext_ts, ext_xs, ext_valids, w_ns: int, D: int,
                   n_out: int):
    """Causal range-window stats for the trailing ``n_out`` lanes of an
    extended layout ``[prefix(D+1) | rows]``: ``D+1`` masked shifted
    passes (the row itself and up to ``D`` rows before it), accumulated
    in the order d = 0, 1, ..., D.  The prefix is the ring (streaming)
    or inert fill (batch).

    The membership masks of every pass are formed at once (booleans,
    exact), and so is the count (an integer sum, exact); the float sums
    and the min/max fold pass by pass in the reference's order, one op
    each, so a step is about ``4 (D+1)`` ops.

    Rank-generic: ``ext_ts`` is ``[..., K, n]`` and the value planes
    ``[..., C, K, n]`` over the same leading axes (none for one stream,
    ``[S]`` for a cohort); no op mixes entries of the leading axes, so a
    stream's slice of a cohort's result is its own step's bits.

    Returns ``(stats dict of [..., C, K, n_out] planes, clipped [..., K,
    n_out] bool)``: ``clipped`` marks rows whose true window reaches past
    the declared ``D``-row bound (the pass-``D+1`` audit, the reason the
    prefix holds ``D+1`` rows)."""
    f32 = torch.float32
    ts = ext_ts[..., -n_out:]
    lo = ts - int(w_ns)
    x_self = ext_xs[..., -n_out:]
    v_self = ext_valids[..., -n_out:]
    sj = torch.stack([_lag(ext_ts, d, n_out) for d in range(D + 2)])
    in_time = (sj >= lo) & (sj <= ts)              # [D+2, ..., K, n_out]
    vj = torch.stack([_lag(ext_valids, d, n_out) for d in range(D + 1)])
    xj = torch.stack([_lag(ext_xs, d, n_out) for d in range(D + 1)])
    inw = in_time[:D + 1].unsqueeze(-3) & vj       # [D+1, ..., C, K, n]
    cnt = inw.sum(0).to(f32)
    s1_terms = torch.where(inw, xj, 0.0)
    s2_terms = torch.where(inw, xj * xj, 0.0)
    mn_terms = torch.where(inw, xj, math.inf)
    mx_terms = torch.where(inw, xj, -math.inf)
    s1 = torch.zeros_like(x_self)
    s2 = torch.zeros_like(x_self)
    mn = torch.full_like(x_self, math.inf)
    mx = torch.full_like(x_self, -math.inf)
    for d in range(D + 1):
        s1 = s1 + s1_terms[d]
        s2 = s2 + s2_terms[d]
        mn = torch.minimum(mn, mn_terms[d])
        mx = torch.maximum(mx, mx_terms[d])

    nan = math.nan
    one_c = torch.clamp(cnt, min=1.0)
    mean = torch.where(cnt > 0, s1 / one_c, nan)
    var = torch.where(cnt > 1,
                      (s2 - s1 * s1 / one_c) / torch.clamp(cnt - 1.0,
                                                           min=1.0),
                      nan)
    std = torch.where(cnt > 1, torch.sqrt(torch.clamp(var, min=0.0)), nan)
    stats = {
        "mean": mean,
        "count": cnt,
        "min": torch.where(cnt > 0, mn, nan),
        "max": torch.where(cnt > 0, mx, nan),
        "sum": torch.where(cnt > 0, s1, nan),
        "stddev": std,
        "zscore": torch.where(v_self, (x_self - mean) / std, nan),
    }
    vD = _lag(ext_valids, D + 1, n_out)
    clip = in_time[D + 1].unsqueeze(-3) & (v_self | vD)
    return stats, clip.any(-3)


def window_stats_batch(ts, xs, valids, w_ns: int, rows_bound: int,
                       device=None):
    """Batch operator of the serving window stats: the same
    ``_window_passes`` over ``[fill | full history]``.  Streaming the
    same history through any push split gives these planes bit for bit.
    Takes ``ts [K, L]`` int64, ``xs [C, K, L]`` float32 and ``valids [C,
    K, L]`` bool: tensors stay on their device, host arrays go to
    ``device`` (default CUDA; ``"cpu"`` runs there).  Returns ``(stats
    dict of [C, K, L] planes, clipped-row count [K] int64)``."""
    if not all(isinstance(t, torch.Tensor) for t in (ts, xs, valids)):
        dev = device_mod.resolve(device)
        ts, xs, valids = (t if isinstance(t, torch.Tensor)
                          else torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                          for t in (ts, xs, valids))
    C, K, L = xs.shape
    R = int(rows_bound) + 1
    dev = xs.device
    ext_ts = torch.cat([torch.full((K, R), int(TS_PAD), dtype=ts.dtype,
                                   device=dev), ts], -1)
    ext_xs = torch.cat([torch.zeros((C, K, R), dtype=xs.dtype, device=dev),
                        xs], -1)
    ext_valids = torch.cat([torch.zeros((C, K, R), dtype=torch.bool,
                                        device=dev), valids], -1)
    stats, clip = _window_passes(ext_ts, ext_xs, ext_valids, int(w_ns),
                                 int(rows_bound), L)
    return stats, clip.sum(-1).to(torch.int64)


# ----------------------------------------------------------------------
# The step functions
# ----------------------------------------------------------------------

_STAT_KEYS = ("mean", "count", "min", "max", "sum", "stddev", "zscore")

_QUERY_STATE = ("last_val", "last_src", "lock_val", "lock_valid",
                "lock_src", "last_ridx", "r_count", "n_merged")


def _last_lane(cond, lanes):
    """(index of the last True lane, any True) per row: a max over a
    ``where``, no host sync, never arithmetic on values."""
    idx = torch.where(cond, lanes, -1).amax(-1)
    return idx, idx >= 0


def _at_lane(plane, idx):
    """``plane[..., idx]`` per row (idx clamped; callers mask on has)."""
    return torch.take_along_dim(plane, idx.clamp(min=0)[..., None],
                                -1)[..., 0]


def _push_fn(cfg: StreamConfig, Lb: int):
    """The serving step: one function advancing the AS-OF carry, the EMA
    carry and the ring-buffer window state by a right-side micro-batch,
    emitting the stats and EMA planes of exactly the new rows.  ``[K,
    Lb]`` batches are left-aligned per series (``mask`` a prefix mask,
    ``counts`` its row sums); pad lanes carry TS_PAD keys and NaN values
    so every masked op ignores them.  Takes the state tensors in
    ``state_names`` order, then ``ts, xs, mask, counts``; returns the new
    state tensors, then the emission planes stacked ``[E, C, K, Lb]``
    (``cfg.emit_keys()`` order).  Nothing in it syncs with the host, so a
    CUDA graph captures it whole.

    Rank-generic: every operand may carry the same leading axes (a
    cohort's ``[S]`` stream axis: state ``[S, C, K]``, batches ``[S, K,
    Lb]`` and ``[S, C, K, Lb]``, emissions ``[E, S, C, K, Lb]``).  The
    reference vmaps its step over that axis; here the ops index from the
    right and none of them mixes streams, so each stream's slice is the
    single stream's bits, and the EMA is one ``ema_scan`` launch over
    ``S * C * K`` rows."""
    names = cfg.state_names()

    def step(*args):
        st = dict(zip(names, args[:len(names)]))
        ts, xs, mask, counts = args[len(names):]
        lanes = torch.arange(Lb, dtype=torch.int64, device=xs.device)
        valids = mask.unsqueeze(-3) & ~torch.isnan(xs)  # packing invariant
        new = {}

        # ---- AS-OF carry (selection only, bit-exact) -----------------
        lidx, lhas = _last_lane(valids, lanes)            # [..., C, K]
        new["last_val"] = torch.where(lhas, _at_lane(xs, lidx),
                                      st["last_val"])
        new["last_src"] = torch.where(
            lhas, st["n_merged"].unsqueeze(-2) + lidx, st["last_src"])
        rows_has = counts > 0
        last = (counts - 1).clamp(min=0).unsqueeze(-2).expand(lidx.shape)
        new["lock_val"] = torch.where(rows_has.unsqueeze(-2),
                                      _at_lane(xs, last), st["lock_val"])
        new["lock_valid"] = torch.where(rows_has.unsqueeze(-2),
                                        _at_lane(valids, last),
                                        st["lock_valid"])
        new["lock_src"] = torch.where(rows_has, st["n_merged"] + counts - 1,
                                      st["lock_src"])
        new["last_ridx"] = torch.where(rows_has, st["r_count"] + counts - 1,
                                       st["last_ridx"])
        new["r_count"] = st["r_count"] + counts
        new["n_merged"] = st["n_merged"] + counts

        emits: List[torch.Tensor] = []
        # ---- EMA carry ------------------------------------------------
        if cfg.has_ema:
            ys, y_end = ops_scan.ema_scan(xs, valids,
                                          float(np.float32(cfg.ema_alpha)),
                                          y0=st["ema_y"])
            new["ema_y"] = y_end
            emits.append(ys)

        # ---- ring-buffer window stats ---------------------------------
        if cfg.has_window:
            R = cfg.rows_bound + 1
            ext_ts = torch.cat([st["ring_ts"], ts], -1)
            ext_xs = torch.cat([st["ring_x"], xs], -1)
            ext_valids = torch.cat([st["ring_valid"], valids], -1)
            stats, clip = _window_passes(ext_ts, ext_xs, ext_valids,
                                         cfg.window_ns, cfg.rows_bound, Lb)
            emits.extend(stats[k] for k in _STAT_KEYS)
            new["clipped"] = st["clipped"] + (clip & mask).sum(-1)
            # retire the oldest ``counts`` rows: the new ring is the last
            # R real rows of [ring | batch] (batches are left-aligned, so
            # real rows end at lane R + counts - 1)
            ridx = (torch.arange(R, dtype=torch.int64, device=xs.device)
                    + counts.unsqueeze(-1))                # [..., K, R]
            cidx = ridx.unsqueeze(-3).expand(ext_xs.shape[:-1] + (R,))
            new["ring_ts"] = torch.take_along_dim(ext_ts, ridx, -1)
            new["ring_x"] = torch.take_along_dim(ext_xs, cidx, -1)
            new["ring_valid"] = torch.take_along_dim(ext_valids, cidx, -1)

        out = [new[n] for n in names]
        if emits:
            out.append(torch.stack(emits))
        return out

    return step


def _query_fn(cfg: StreamConfig, Lb: int):
    """The AS-OF query step: answers for a left micro-batch straight from
    the carry (every right row in history precedes every row of an
    accepted left batch in merged order: the push-ordering contract),
    with per-row ``maxLookback`` expiry on the carried source positions.
    Left rows take merged positions, so ``n_merged`` advances: a query
    changes the state.  Returns ``(n_merged', vals [C, K, Lb], found,
    idx [K, Lb] int32)``; rank-generic as :func:`_push_fn` (a cohort's
    are ``[S, C, K, Lb]`` and ``[S, K, Lb]``)."""
    ml = int(cfg.max_lookback)

    def step(last_val, last_src, lock_val, lock_valid, lock_src,
             last_ridx, r_count, n_merged, counts):
        lanes = torch.arange(Lb, dtype=torch.int64, device=counts.device)
        pos = n_merged.unsqueeze(-1) + lanes                # [..., K, Lb]
        ok_row = (r_count > 0).unsqueeze(-1).expand(pos.shape)
        if ml:
            ok_row = ok_row & (pos - lock_src.unsqueeze(-1) <= ml)
        if cfg.skip_nulls:
            found = (~torch.isnan(last_val)).unsqueeze(-1).expand(
                last_val.shape + (Lb,))
            if ml:
                found = found & (pos.unsqueeze(-3)
                                 - last_src.unsqueeze(-1) <= ml)
            vals = torch.where(found, last_val.unsqueeze(-1), math.nan)
        else:
            found = ok_row.unsqueeze(-3) & lock_valid.unsqueeze(-1)
            vals = torch.where(found, lock_val.unsqueeze(-1), math.nan)
        idx = torch.where(ok_row, last_ridx.unsqueeze(-1),
                          -1).to(torch.int32)
        return [n_merged + counts, vals, found.contiguous(), idx]

    return step


# ----------------------------------------------------------------------
# Executables through the planner's cache
# ----------------------------------------------------------------------

def cohort_state_init(cfg: StreamConfig, S: int) -> Dict[str, np.ndarray]:
    """Fresh ``[S, ...]`` cohort carry: ``S`` stacked :func:`init_state`s."""
    return {k: np.broadcast_to(v, (S,) + v.shape).copy()
            for k, v in init_state(cfg).items()}


def _fresh_state(cfg: StreamConfig, S: Optional[int], device):
    return to_device(init_state(cfg) if S is None
                     else cohort_state_init(cfg, S), device)


def push_inputs(cfg: StreamConfig, Lb: int, device,
                S: Optional[int] = None) -> List[torch.Tensor]:
    """An inert push (fresh state, an empty batch) on ``device``, with a
    leading ``[S]`` stream axis when ``S`` is given: the example a step
    is captured over."""
    C, K = cfg.n_cols, cfg.n_series
    lead = () if S is None else (S,)
    st = _fresh_state(cfg, S, device)
    return [st[n] for n in cfg.state_names()] + [
        torch.full(lead + (K, Lb), int(TS_PAD), dtype=torch.int64,
                   device=device),
        torch.full(lead + (C, K, Lb), math.nan, dtype=torch.float32,
                   device=device),
        torch.zeros(lead + (K, Lb), dtype=torch.bool, device=device),
        torch.zeros(lead + (K,), dtype=torch.int64, device=device)]


def query_inputs(cfg: StreamConfig, device,
                 S: Optional[int] = None) -> List[torch.Tensor]:
    lead = () if S is None else (S,)
    st = _fresh_state(cfg, S, device)
    return [st[n] for n in _QUERY_STATE] + [
        torch.zeros(lead + (cfg.n_series,), dtype=torch.int64,
                    device=device)]


class StepExecutable:
    """One step of one ``(config, bucket, device)``: on a card a CUDA
    graph captured over an inert example (``plan/fused.capture``, counted
    as a capture) and replayed under a lock (two streams of one config
    on one card share it), each replay copying its inputs in and cloning
    its outputs out; on the CPU the step function itself, run eagerly.
    It has no ``release``: the planner's cache may drop its entry, but a
    stream that pinned it keeps the graph alive until the stream goes."""

    def __init__(self, key, fn, device, example: List[torch.Tensor]):
        from tempo_tpu_torch.plan import fused
        from tempo_tpu_torch.plan.cache import CACHE

        self.fn = fn
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self.graph = None
        if self.device.type == "cuda":
            self.graph = fused.capture(key, self.device, fn, example)
            CACHE.count_graph("capture")

    def __call__(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        if self.graph is None:
            return list(self.fn(*inputs))
        with self._lock:
            return self.graph.replay(inputs)

    @property
    def pool_bytes(self) -> Optional[int]:
        """Bytes the graph's private pool holds (None on the CPU)."""
        return None if self.graph is None else self.graph.pool_bytes

    def graph_bytes(self) -> Dict[str, int]:
        if self.graph is None:
            return {}
        return {str(self.device): self.graph.nbytes()}


def _cache_key(kind: str, cfg: StreamConfig, Lb: int, device):
    from tempo_tpu_torch.plan.cache import device_key

    return ("serve", kind, cfg.key(), Lb, device_key(device=device))


def push_executable(cfg: StreamConfig, Lb: int, device) -> StepExecutable:
    """The push step of one padded-batch bucket on ``device``, through the
    planner's LRU executable cache (hits, misses and builds in
    ``profiling.plan_cache_stats``: the steady state builds nothing)."""
    from tempo_tpu_torch.plan.cache import CACHE

    key = _cache_key("push", cfg, Lb, device)
    return CACHE.get_or_build(key, lambda: StepExecutable(
        key, _push_fn(cfg, Lb), device, push_inputs(cfg, Lb, device)))


def query_executable(cfg: StreamConfig, Lb: int, device) -> StepExecutable:
    from tempo_tpu_torch.plan.cache import CACHE

    key = _cache_key("query", cfg, Lb, device)
    return CACHE.get_or_build(key, lambda: StepExecutable(
        key, _query_fn(cfg, Lb), device, query_inputs(cfg, device)))


# ----------------------------------------------------------------------
# Cohort steps: the same step functions over a leading [S] stream axis
# ----------------------------------------------------------------------

class ShardedStep:
    """One cohort step over a stream mesh: a :class:`StepExecutable` a
    mesh entry along the stream axis, each over its contiguous slot range
    (``dist.stream_shardings``) on its own device, captured apart.  A call
    takes each shard's inputs and returns each shard's outputs; no tensor
    crosses between entries (no op of the step mixes streams)."""

    def __init__(self, steps: List[StepExecutable]):
        self.steps = steps

    def __call__(self, per_shard: List[List[torch.Tensor]]):
        return [step(*inputs) for step, inputs in zip(self.steps, per_shard)]

    @property
    def pool_bytes(self) -> Optional[int]:
        held = [s.pool_bytes for s in self.steps if s.pool_bytes is not None]
        return sum(held) if held else None

    def graph_bytes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.steps:
            for d, b in s.graph_bytes().items():
                out[d] = out.get(d, 0) + b
        return out


def _cohort_cache_key(kind: str, cfg: StreamConfig, S: int, Lb: int,
                      device, mesh):
    from tempo_tpu_torch.plan.cache import device_key

    dk = device_key(mesh=mesh) if mesh is not None else \
        device_key(device=device)
    return ("serve", kind, cfg.key(), S, Lb, dk)


def _cohort_executable(kind: str, cfg: StreamConfig, S: int, Lb: int,
                       device, mesh, stream_axis: str, fn_of, example_of):
    """The cached cohort step ``kind``: one :class:`StepExecutable` over
    ``[S, ...]`` on ``device``, or with a ``mesh`` a :class:`ShardedStep`
    of one a shard of its stream axis.  ``fn_of(S)`` and ``example_of(S,
    device)`` give the step function and its capture example at a shard's
    slot count."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.plan.cache import CACHE

    key = _cohort_cache_key(kind, cfg, S, Lb, device, mesh)

    def build():
        if mesh is None:
            return StepExecutable(key, fn_of(S), device,
                                  example_of(S, device))
        return ShardedStep([
            StepExecutable(key + (i,), fn_of(s1 - s0), dev,
                           example_of(s1 - s0, dev))
            for i, (dev, s0, s1) in enumerate(
                dist.stream_shardings(mesh, stream_axis, S))])

    return CACHE.get_or_build(key, build)


def cohort_push_executable(cfg: StreamConfig, S: int, Lb: int, device=None,
                           mesh=None, stream_axis: str = "streams"):
    """The cohort push step of one (shape bucket, ``S`` slots, padded
    batch ``Lb``) through the planner's cache, keyed ``("serve",
    "cohort_push", cfg.key(), S, Lb, device_key(...))``: :func:`_push_fn`
    over ``[S, ...]``, one CUDA graph (a shard) on a card."""
    return _cohort_executable(
        "cohort_push", cfg, S, Lb, device, mesh, stream_axis,
        lambda n: _push_fn(cfg, Lb),
        lambda n, dev: push_inputs(cfg, Lb, dev, S=n))


def cohort_query_executable(cfg: StreamConfig, S: int, Lb: int, device=None,
                            mesh=None, stream_axis: str = "streams"):
    return _cohort_executable(
        "cohort_query", cfg, S, Lb, device, mesh, stream_axis,
        lambda n: _query_fn(cfg, Lb),
        lambda n, dev: query_inputs(cfg, dev, S=n))


def pack_answers(vals, found, idx) -> torch.Tensor:
    """Gathered query answers (``vals [N, C]`` float32, ``found [N, C]``,
    ``idx [N]`` int32) as one ``[N, 2C + 1]`` int32 tensor, the float
    bits by view, so one copy brings them to the host
    (:func:`unpack_answers`)."""
    return torch.cat([vals.contiguous().view(torch.int32),
                      found.to(torch.int32), idx[:, None]], 1)


def unpack_answers(packed: np.ndarray, C: int):
    """``(vals [N, C] float32, found [N, C] bool, idx [N] int32)`` of a
    host copy of :func:`pack_answers`."""
    return (np.ascontiguousarray(packed[:, :C]).view(np.float32),
            packed[:, C:2 * C].astype(bool), packed[:, 2 * C])


# ----------------------------------------------------------------------
# Block programs: scatter, step and gather as one graph
# ----------------------------------------------------------------------
#
# The per-tick cohort route scatters admitted ticks into the padded
# [S, K, Lb] batch and gathers their emissions with eager ops around the
# step's graph.  A block program takes the ticks in compact form (index
# and value arrays of one power-of-two length Nb), scatters them into the
# padded batch, runs the same step and gathers the emissions back to
# [Nb, ...] inside one graph: host-to-device and device-to-host traffic
# are O(ticks).  The reference pads with an out-of-range slot that
# ``.at[...].set(mode="drop")`` discards; an out-of-range index_put_ is a
# device-side assert on a card, so the padded planes here have a sink
# slot S ([S + 1, ...]): pad ticks land there and the step runs on the
# contiguous leading slice [:S].  One tick a (slot, series) is the
# caller's precondition, on lane 0 like the per-tick route's singles,
# so each slot's batch holds what the per-tick route would build and the
# step is the same function: the bits are the per-tick route's.

def block_lanes() -> int:
    """The block programs' padded per-series lanes: the per-tick route's
    bucket for one row (``stream._bucket(1)``, 8), so both routes run the
    step at one shape."""
    from tempo_tpu_torch.serve import stream as stream_mod

    return stream_mod._bucket(1)


def _sink_counts(sl, rw, S: int, K: int) -> torch.Tensor:
    """``[S + 1, K]`` int64 tick counts of (slot, series) pairs, pad ticks
    in the sink slot ``S`` (an integer scatter-add, exact)."""
    counts = torch.zeros((S + 1) * K, dtype=torch.int64, device=sl.device)
    counts.scatter_add_(0, sl * K + rw, torch.ones_like(sl))
    return counts.view(S + 1, K)


def _block_push_fn(cfg: StreamConfig, S: int, Nb: int):
    C, K = cfg.n_cols, cfg.n_series
    Lb = block_lanes()
    step = _push_fn(cfg, Lb)
    n_state = len(cfg.state_names())

    def prog(*args):
        st = args[:n_state]
        sl, rw, tsv, colv = args[n_state:]
        dev = tsv.device
        where = (sl, rw)
        ts_p = torch.full((S + 1, K, Lb), int(TS_PAD), dtype=torch.int64,
                          device=dev)
        ts_p.select(-1, 0).index_put_(where, tsv)
        mask = torch.zeros((S + 1, K, Lb), dtype=torch.bool, device=dev)
        mask.select(-1, 0).index_put_(where, torch.ones_like(sl,
                                                             dtype=torch.bool))
        xs = torch.full((S + 1, C, K, Lb), math.nan, dtype=torch.float32,
                        device=dev)
        xs.select(-1, 0).transpose(1, 2).index_put_(where, colv.t())
        counts = _sink_counts(sl, rw, S, K)
        out = step(*st, ts_p[:S], xs[:S], mask[:S], counts[:S])
        slg = sl.clamp(max=S - 1)          # pad ticks: any slot; dropped
        if len(out) == n_state:
            return out
        return out[:n_state] + [out[n_state].select(-1, 0)[:, slg, :, rw]]

    return prog


def _block_query_fn(cfg: StreamConfig, S: int, Nb: int):
    K = cfg.n_series
    qstep = _query_fn(cfg, block_lanes())

    def prog(*args):
        st = args[:len(_QUERY_STATE)]
        sl, rw = args[len(_QUERY_STATE):]
        counts = _sink_counts(sl, rw, S, K)
        n_merged, vals, found, idx = qstep(*st, counts[:S])
        slg = sl.clamp(max=S - 1)
        return [n_merged, pack_answers(vals.select(-1, 0)[slg, :, rw],
                                       found.select(-1, 0)[slg, :, rw],
                                       idx.select(-1, 0)[slg, rw])]

    return prog


def block_ticks(Nb: int, S: int, C: int, device):
    """An inert block of ``Nb`` pad ticks (all in the sink slot): ``sl,
    rw, tsv, colv``."""
    return [torch.full((Nb,), S, dtype=torch.int64, device=device),
            torch.zeros((Nb,), dtype=torch.int64, device=device),
            torch.full((Nb,), int(TS_PAD), dtype=torch.int64, device=device),
            torch.full((C, Nb), math.nan, dtype=torch.float32, device=device)]


def _require_meshless(mesh, kind: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"the {kind} block program is the meshless cohort's; a "
            f"mesh-sharded cohort takes the per-tick dispatch route (its "
            f"batch build is already on each shard's device)")


def cohort_block_push_executable(cfg: StreamConfig, S: int, Nb: int,
                                 device=None, mesh=None,
                                 stream_axis: str = "streams"):
    """The block push program of one (shape bucket, ``S``, power-of-two
    tick count ``Nb``): the sink-slot scatter, the step and the compact
    emission gather ``[Nb, E, C]``, one CUDA graph on a card."""
    _require_meshless(mesh, "push")
    n_state = len(cfg.state_names())
    return _cohort_executable(
        "cohort_block_push", cfg, S, Nb, device, None, stream_axis,
        lambda n: _block_push_fn(cfg, n, Nb),
        lambda n, dev: push_inputs(cfg, block_lanes(), dev, S=n)[:n_state]
        + block_ticks(Nb, n, cfg.n_cols, dev))


def cohort_block_query_executable(cfg: StreamConfig, S: int, Nb: int,
                                  device=None, mesh=None,
                                  stream_axis: str = "streams"):
    """The block query program: sink-slot counts, the query step and the
    compact answers packed ``[Nb, 2C + 1]`` (:func:`pack_answers`)."""
    _require_meshless(mesh, "query")
    return _cohort_executable(
        "cohort_block_query", cfg, S, Nb, device, None, stream_axis,
        lambda n: _block_query_fn(cfg, n, Nb),
        lambda n, dev: query_inputs(cfg, dev, S=n)[:len(_QUERY_STATE)]
        + block_ticks(Nb, n, cfg.n_cols, dev)[:2])
