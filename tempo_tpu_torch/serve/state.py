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
the next push's state never aliases the pool.  The cohort half
(``StreamCohort``'s stacked steps) is not ported yet (ROADMAP A12b).
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

    Returns ``(stats dict of [C, K, n_out] planes, clipped [K, n_out]
    bool)``: ``clipped`` marks rows whose true window reaches past the
    declared ``D``-row bound (the pass-``D+1`` audit, the reason the
    prefix holds ``D+1`` rows)."""
    f32 = torch.float32
    ts = ext_ts[:, -n_out:]
    lo = ts - int(w_ns)
    x_self = ext_xs[..., -n_out:]
    v_self = ext_valids[..., -n_out:]
    sj = torch.stack([_lag(ext_ts, d, n_out) for d in range(D + 2)])
    in_time = (sj >= lo) & (sj <= ts)                   # [D+2, K, n_out]
    vj = torch.stack([_lag(ext_valids, d, n_out) for d in range(D + 1)])
    xj = torch.stack([_lag(ext_xs, d, n_out) for d in range(D + 1)])
    inw = in_time[:D + 1, None] & vj                    # [D+1, C, K, n]
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
    clip = in_time[D + 1][None] & (v_self | vD)
    return stats, clip.any(0)


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
    CUDA graph captures it whole."""
    C = cfg.n_cols
    names = cfg.state_names()

    def step(*args):
        st = dict(zip(names, args[:len(names)]))
        ts, xs, mask, counts = args[len(names):]
        lanes = torch.arange(Lb, dtype=torch.int64, device=xs.device)
        valids = mask[None] & ~torch.isnan(xs)          # packing invariant
        new = {}

        # ---- AS-OF carry (selection only, bit-exact) -----------------
        lidx, lhas = _last_lane(valids, lanes)                 # [C, K]
        new["last_val"] = torch.where(lhas, _at_lane(xs, lidx),
                                      st["last_val"])
        new["last_src"] = torch.where(lhas, st["n_merged"][None] + lidx,
                                      st["last_src"])
        rows_has = counts > 0
        last = (counts - 1).clamp(min=0)[None].expand(C, -1)
        new["lock_val"] = torch.where(rows_has[None], _at_lane(xs, last),
                                      st["lock_val"])
        new["lock_valid"] = torch.where(rows_has[None],
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
            ridx = (torch.arange(R, dtype=torch.int64, device=xs.device)[None]
                    + counts[:, None])                     # [K, R]
            cidx = ridx[None].expand(C, -1, -1)
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
    idx [K, Lb] int32)``."""
    ml = int(cfg.max_lookback)
    C, K = cfg.n_cols, cfg.n_series

    def step(last_val, last_src, lock_val, lock_valid, lock_src,
             last_ridx, r_count, n_merged, counts):
        lanes = torch.arange(Lb, dtype=torch.int64, device=counts.device)
        pos = n_merged[:, None] + lanes[None]               # [K, Lb]
        ok_row = (r_count > 0)[:, None].expand(K, Lb)
        if ml:
            ok_row = ok_row & (pos - lock_src[:, None] <= ml)
        if cfg.skip_nulls:
            found = (~torch.isnan(last_val))[:, :, None].expand(C, K, Lb)
            if ml:
                found = found & (pos[None] - last_src[:, :, None] <= ml)
            vals = torch.where(found, last_val[:, :, None], math.nan)
        else:
            found = ok_row[None] & lock_valid[:, :, None]
            vals = torch.where(found, lock_val[:, :, None], math.nan)
        idx = torch.where(ok_row, last_ridx[:, None], -1).to(torch.int32)
        return [n_merged + counts, vals, found.contiguous(), idx]

    return step


# ----------------------------------------------------------------------
# Executables through the planner's cache
# ----------------------------------------------------------------------

def push_inputs(cfg: StreamConfig, Lb: int, device) -> List[torch.Tensor]:
    """An inert push (fresh state, an empty batch) on ``device``: the
    example a step is captured over."""
    C, K = cfg.n_cols, cfg.n_series
    st = to_device(init_state(cfg), device)
    return [st[n] for n in cfg.state_names()] + [
        torch.full((K, Lb), int(TS_PAD), dtype=torch.int64, device=device),
        torch.full((C, K, Lb), math.nan, dtype=torch.float32, device=device),
        torch.zeros((K, Lb), dtype=torch.bool, device=device),
        torch.zeros((K,), dtype=torch.int64, device=device)]


def query_inputs(cfg: StreamConfig, device) -> List[torch.Tensor]:
    st = to_device(init_state(cfg), device)
    return [st[n] for n in _QUERY_STATE] + [
        torch.zeros((cfg.n_series,), dtype=torch.int64, device=device)]


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
