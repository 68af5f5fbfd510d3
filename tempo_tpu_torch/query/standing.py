"""Standing queries: one registered plan, answered forever.

Counterpart of ``tempo_tpu/query/standing.py``.
``StandingQueryEngine.register`` takes a planned method chain or a
SQL statement over :class:`~tempo_tpu_torch.query.unified.StreamTable`
frames and turns it into a **standing query**: every admitted push
fans out to the subscription as an incremental *delta*, and the
accumulated standing result is **bitwise identical** to re-running the
registered plan over the concatenated history at every push boundary.
The split pass (:mod:`tempo_tpu.query.split`) decides how each
subscription is served:

* **stateless** — row-local suffix over the new rows, no device state;
* **delta** — the serving plane's carries: EMA subscriptions ride a
  shared :class:`~tempo_tpu_torch.serve.cohort.StreamCohort` (one
  :class:`~tempo_tpu_torch.serve.cohort.CohortMember` per subscription,
  dispatched through a :class:`~tempo_tpu_torch.serve.executor.CohortExecutor`
  with shape-bucketed steps captured as CUDA graphs, whose EMA carry is
  the hand-written ``csrc/ema_scan.cu`` — the steady state builds
  nothing, observable in ``profiling.plan_cache_stats``);
  AS-OF join subscriptions dispatch the same plane machinery and
  additionally keep exact-dtype host index carries, because the batch
  join gathers right values in their SOURCE dtype (float64, datetimes,
  objects) while the serving plane's state is f32 — the carries are
  per-(series, column) last-valid right-row indices, O(1) per tick;
* **remainder** — the full canonical plan re-runs over the unified
  scan every ``TEMPO_TPU_STANDING_REMAINDER_EVERY`` boundaries
  (``StandingPlan.reason`` names what forced the fallback).

Delivery is asynchronous: ``push`` admits against the engine's
merged-stream feed watermarks (the ``serve.stream.admit_batch`` rule —
late ticks are rejected by name with
:class:`~tempo_tpu_torch.serve.stream.LateTickError`, never reordered),
commits the table tail, and hands the batch to the delivery worker.
The worker submits every subscription's ticks FIRST and awaits them
after — concurrent subscriptions coalesce into batched cohort
dispatches — then pushes a :class:`Notification` into each
subscription's bounded queue.  Backpressure is per subscriber: a full
queue drops the OLDEST notification (counted on
``Subscription.dropped``) instead of stalling the fleet;
``Subscription.result()`` is always exact regardless of drops.
Deadlines (:class:`~tempo_tpu_torch.resilience.Deadline`) ride the push end
to end; an expired delivery fails ONLY the affected subscription (a
missed delta would silently break the bitwise contract, so the
subscription fails loudly instead of drifting).

A delta subscription whose register-time replay the cohort rejects (a
``ValueError``: a late tick, an admission refusal) is demoted to the
remainder, with ``Subscription.reason`` naming why.  Any other failure
of the catch-up, such as a step's capture or launch on the card,
raises from ``register``: nothing serves the query on another path.

``snapshot_subscription`` / ``resume_subscription`` persist a standing
subscription as a ``kind="standing_state"`` artifact (per-table
cursors + the serving plane's slot carries, bit-for-bit) so a killed
engine resumes mid-stream with a byte-identical tail.

A plane runs on its driving table's device (``StreamTable(device=)``).
:meth:`StandingQueryEngine.close` closes the planes' executors and drops
each cohort's pinned step graphs (``_Plane.close``); the planner's
executable cache still holds the same steps (keyed by config, capacity,
bucket and device) until its LRU bound or graph budget evicts them or
``CACHE.clear()`` runs, and the graphs are freed then.  A later plane of
the same config replays them instead of capturing again.
:meth:`StandingQueryEngine.graph_pool_bytes` reports what the planes'
pinned graphs hold in their pools.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from tempo_tpu_torch import config
from tempo_tpu_torch.plan import ir
from tempo_tpu_torch.query import split as qsplit
from tempo_tpu_torch.query.unified import StreamTable
from tempo_tpu_torch.resilience import Deadline
from tempo_tpu_torch.serve.stream import LateTickError, _SIDE_LEFT, _SIDE_RIGHT

__all__ = ["StandingQueryEngine", "Subscription", "Notification",
           "snapshot_subscription", "resume_subscription"]

_REPLAY_CHUNK = 4096


@dataclasses.dataclass
class Notification:
    """One delivery to a subscriber.  ``kind``: ``"catchup"`` (the
    register-time replay of everything already in the tables),
    ``"delta"`` (one push boundary's new result rows, suffix applied),
    ``"refresh"`` (a remainder subscription's periodic full re-run), or
    ``"error"`` (the subscription failed; ``error`` holds why)."""

    kind: str
    boundary: int
    frame: Optional[pd.DataFrame]
    error: Optional[BaseException] = None


def _suffix_df(plan: qsplit.StandingPlan, tsdf):
    """Apply the plan's row-local suffix to a TSDF and return the
    result DataFrame (row-local ops commute with every reordering the
    delta path performs, which is what makes per-delta application ==
    one application over the sorted concatenation)."""
    from tempo_tpu_torch import plan as plan_mod
    from tempo_tpu_torch.plan import executor as pexec

    with plan_mod.suspended():
        for n in plan.suffix:
            tsdf = pexec._eval_op(n, [tsdf])
    return tsdf.df if hasattr(tsdf, "df") else tsdf


def _run_batch(root: ir.Node, pinned: Dict[str, pd.DataFrame]):
    """Execute the canonical plan with every ``unified_scan`` replaced
    by a plain host source over a pinned snapshot — the batch twin /
    remainder program.  Returns the result TSDF."""
    from tempo_tpu_torch.frame import TSDF
    from tempo_tpu_torch.plan import executor as pexec

    memo: Dict[int, ir.Node] = {}

    def rec(n: ir.Node) -> ir.Node:
        got = memo.get(id(n))
        if got is not None:
            return got
        if n.op == "unified_scan":
            t = n.payload.table
            out = ir.Node("source", payload=TSDF(
                pinned[t.name], t.ts_col, t.partitionCols,
                t.sequence_col or None, device=t.device))
        else:
            ins = tuple(rec(c) for c in n.inputs)
            out = ir.Node(n.op, params=dict(n.params), inputs=ins,
                          payload=n.payload, objs=n.objs)
        memo[id(n)] = out
        return out

    clone = rec(root)
    exe = pexec.Executable(clone)
    return exe.run([s.payload for s in clone.sources()])


class _JoinSeries:
    """Exact-dtype AS-OF carries for one series of a join subscription:
    the last right row overall, the per-column last VALID right row
    (``skipNulls``), and — under ``maxLookback`` — the trailing window
    of merged-stream entries (``rowsBetween(-maxLookback, 0)`` on the
    merged stream, the batch kernel's rule)."""

    __slots__ = ("last", "col_last", "recent")

    def __init__(self, n_cols: int, max_lookback: int):
        self.last = -1
        self.col_last = [-1] * n_cols
        self.recent = (collections.deque(maxlen=max_lookback)
                       if max_lookback > 0 else None)

    def on_right(self, ridx: int, valid: Tuple[bool, ...]) -> None:
        if self.recent is not None:
            self.recent.append((ridx, valid))
            return
        self.last = ridx
        for ci, ok in enumerate(valid):
            if ok:
                self.col_last[ci] = ridx

    def on_left(self, n_cols: int):
        """Match indices for one left row: ``(row_idx, [col_idx])``."""
        if self.recent is None:
            return self.last, list(self.col_last)
        row, cols = -1, [-1] * n_cols
        need = n_cols
        for ridx, valid in reversed(self.recent):
            if ridx < 0:
                continue
            if row < 0:
                row = ridx
            for ci in range(n_cols):
                if cols[ci] < 0 and valid[ci]:
                    cols[ci] = ridx
                    need -= 1
            if need == 0 and row >= 0:
                break
        # the left row itself occupies a window slot for FUTURE lefts
        self.recent.append((-1, None))
        return row, cols


class Subscription:
    """One standing query's live handle.  ``get``/iteration consume
    notifications; ``result()`` assembles the full standing result —
    bitwise what re-running the registered plan over the concatenated
    history produces right now.  Mutable state is guarded by the
    owning engine's lock; the delivery worker is the only writer of
    the accumulators."""

    def __init__(self, engine: "StandingQueryEngine", sub_id: int,
                 plan: qsplit.StandingPlan, depth: int):
        self.engine = engine
        self.id = sub_id
        self.plan = plan
        self.mode = plan.mode
        self.reason = plan.reason
        self._q: "queue.Queue[Notification]" = queue.Queue(
            maxsize=max(1, depth))
        # the fields below are written only by the owning engine (and
        # the module-level resume helpers), always under engine._lock;
        # Subscription's own methods read them under the same lock
        self.dropped = 0
        self.boundaries = 0
        self._acc: List[dict] = []
        self._cursors: Dict[str, int] = {}
        self._err: Optional[BaseException] = None
        self._cancelled = False
        self._member = None
        self._plane = None
        self._jstate: Dict[tuple, _JoinSeries] = {}
        self._rrows = 0

    # -- consuming ------------------------------------------------------

    def get(self, timeout: Optional[float] = None) -> Notification:
        """Next notification (blocks; ``queue.Empty`` on timeout)."""
        return self._q.get(timeout=timeout)

    def drain(self) -> List[Notification]:
        """Every currently-queued notification, non-blocking."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def cancel(self) -> None:
        """Stop deliveries and release the subscription's serving-plane
        slot.  Idempotent."""
        self.engine._cancel(self)

    @property
    def live(self) -> bool:
        return self._err is None and not self._cancelled

    # -- the standing result -------------------------------------------

    def result(self, flush: bool = True, timeout: Optional[float] = None):
        """The full standing result as a TSDF — bitwise equal to
        executing the registered (canonical) plan over the tables'
        unified snapshots at the current boundary.  ``flush`` waits for
        the delivery worker to drain first, at most ``timeout`` seconds
        (``TimeoutError`` past it)."""
        if flush and not self.engine.flush(timeout=timeout):
            raise TimeoutError(
                f"standing subscription {self.id}: the delivery worker "
                f"did not drain within {timeout} s")
        with self.engine._lock:
            if self._err is not None:
                raise self._err
            acc = list(self._acc)
            mode = self.mode
        if mode == "remainder":
            pinned = self.engine._pin_snapshots(self.plan.tables)
            return _run_batch(self.plan.root, pinned)
        if mode == "stateless":
            base = self._concat([r["base"] for r in acc],
                                self.plan.table)
            return self._finish(base)
        if self.plan.join is not None:
            return self._join_result(acc)
        return self._ema_result(acc)

    @staticmethod
    def _concat(frames: List[pd.DataFrame], table: StreamTable):
        if not frames:
            return pd.DataFrame({c: pd.Series([], dtype="float64")
                                 for c in table.columns})
        if len(frames) == 1:
            return frames[0].copy()
        return pd.concat(frames, ignore_index=True)

    def _finish(self, df: pd.DataFrame):
        from tempo_tpu_torch.frame import TSDF

        t = self.plan.table
        out = TSDF(df, t.ts_col, t.partitionCols,
                   t.sequence_col or None, device=t.device)
        if self.plan.suffix:
            res = _suffix_df(self.plan, out)
            out = TSDF(res, t.ts_col, t.partitionCols,
                       t.sequence_col or None, device=t.device) \
                if t.ts_col in res.columns else res
        return out

    def _ema_result(self, acc):
        """Accumulated per-push EMA deltas -> the batch twin's frame:
        rows reordered by the SAME (key, ts, seq) stable layout the
        packed batch kernel uses, EMA columns already per-row (the
        serving carry emissions are bitwise the packed scan)."""
        from tempo_tpu_torch.frame import TSDF

        t = self.plan.table
        raw = self._concat([r["base"] for r in acc], t)
        if not len(raw):
            return self._finish(raw)
        lay = TSDF(raw[t.columns], t.ts_col, t.partitionCols,
                   t.sequence_col or None, device=t.device).layout
        out = raw.iloc[lay.order].reset_index(drop=True)
        return self._finish(out)

    def _join_result(self, acc):
        """Accumulated left-row deltas + right index carries -> the
        batch ``asofJoin`` frame: left rows in (key, ts) stable layout
        order, right columns gathered from the right table's snapshot
        in their SOURCE dtype with the batch path's global null rules
        (``join._gather``)."""
        from tempo_tpu_torch import packing
        from tempo_tpu_torch.frame import TSDF
        from tempo_tpu_torch.join import _gather

        js = self.plan.join
        left, right = js.left, js.right
        recs = [r for r in acc if r.get("left") is not None]
        lfs = [r["left"] for r in recs]
        lf = self._concat(lfs, left)
        pcols = left.partitionCols
        rvcols = [c for c in right.columns if c not in pcols]
        if len(lf):
            codes = pd.factorize(
                pd.MultiIndex.from_frame(lf[pcols]) if len(pcols) > 1
                else lf[pcols[0]], use_na_sentinel=False)[0] \
                if pcols else np.zeros(len(lf), np.int64)
            ts_ns = packing.series_to_ns(lf[left.ts_col])
            perm = np.lexsort((ts_ns, codes))
        else:
            perm = np.arange(0)
        left_sorted = lf.iloc[perm].reset_index(drop=True)
        rsnap = right.snapshot_df()
        out = {}
        for c in pcols:
            out[c] = left_sorted[c].to_numpy()
        for c in [c for c in left.columns if c not in pcols]:
            out[c] = left_sorted[c].to_numpy()
        n = len(left_sorted)
        for ci, c in enumerate(rvcols):
            if js.skip_nulls:
                flat = np.concatenate(
                    [r["col_idx"][ci] for r in recs]) if recs else \
                    np.zeros(0, np.int64)
            else:
                flat = np.concatenate(
                    [r["row_idx"] for r in recs]) if recs else \
                    np.zeros(0, np.int64)
            flat = flat[perm]
            ok = flat >= 0
            vals = rsnap[c].to_numpy()
            if not js.skip_nulls:
                valid = (~pd.isna(rsnap[c])).to_numpy()
                ok = ok & valid[np.where(ok, flat, 0)]
            col = _gather(vals, np.where(ok, flat, 0), ok)
            out[f"{js.right_prefix}_{c}"] = col
        res = pd.DataFrame(out, index=range(n))
        tsdf = TSDF(res, left.ts_col, pcols, device=left.device)
        if self.plan.suffix:
            resdf = _suffix_df(self.plan, tsdf)
            tsdf = TSDF(resdf, left.ts_col, pcols, device=left.device) \
                if left.ts_col in resdf.columns else resdf
        return tsdf


class _Plane:
    """One shared serving plane: a :class:`StreamCohort` +
    :class:`CohortExecutor` pair for every subscription with the same
    incremental-operator config (EMA columns + alpha, or join value
    columns + skipNulls + maxLookback) on one device.  A member's first
    contact warms its bucket's step ladder through the planner's
    executable cache, so ``profiling.plan_cache_stats()['builds']`` is
    the standing path's zero-recompile counter too."""

    def __init__(self, key: tuple, value_cols: List[str], *,
                 skip_nulls: bool = True, max_lookback: int = 0,
                 ema_alpha: Optional[float] = None, device=None):
        from tempo_tpu_torch.serve.cohort import StreamCohort
        from tempo_tpu_torch.serve.executor import CohortExecutor

        self.key = key
        self.cohort = StreamCohort(
            value_cols, skip_nulls=skip_nulls,
            max_lookback=max_lookback, ema_alpha=ema_alpha, device=device)
        self.executor = CohortExecutor(self.cohort)
        self.members = 0          # written by the engine under its lock

    def warm(self, member) -> None:
        """Pre-build every group's step-program ladder — the pow2
        tick-count buckets up to the executor's ``batch_rows`` cap,
        built once per (config, capacity, Lb) through
        ``plan/cache.py``, hit forever after.  The executor coalesces
        concurrent subscriptions into variable-width batches; warming
        the whole ladder (not one floor bucket) is what makes the
        steady state zero-recompile under ANY coalescing pattern."""
        if member._group is not None:
            self.cohort.warmup(self.executor.batch_rows)

    def close(self) -> None:
        """Stop the plane's executor and drop the cohort's own references
        to its captured steps: the planner's executable cache is then
        their only holder, and its LRU bound, graph budget or ``clear()``
        frees them (``StepExecutable`` has no release of its own)."""
        self.executor.close()
        for g in list(self.cohort._groups.values()):
            g._exes = {}

    def graph_pool_bytes(self) -> int:
        """Bytes the private pools of this plane's captured step graphs
        hold (0 on the CPU, where steps run uncaptured)."""
        total = 0
        for g in list(self.cohort._groups.values()):
            for exe in list(g._exes.values()):
                total += exe.pool_bytes or 0
        return total


class StandingQueryEngine:
    """See module docstring.  One engine owns a set of
    :class:`StreamTable` feeds, their merged-stream watermarks, the
    shared serving planes, and the delivery worker."""

    def __init__(self, *, queue_depth: Optional[int] = None,
                 remainder_every: Optional[int] = None,
                 push_period: Optional[float] = None):
        if queue_depth is None:
            queue_depth = config.get_int(
                "TEMPO_TPU_STANDING_QUEUE_DEPTH", 1024)
        self.queue_depth = max(1, int(queue_depth))
        if remainder_every is None:
            remainder_every = config.get_int(
                "TEMPO_TPU_STANDING_REMAINDER_EVERY", 64)
        self.remainder_every = max(1, int(remainder_every))
        if push_period is None:
            push_period = config.get_float(
                "TEMPO_TPU_STANDING_PUSH_PERIOD", 0.0)
        self.push_period = float(push_period or 0.0)
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._tables: Dict[str, StreamTable] = {}  # guarded-by: self._lock
        #: merged-stream watermark per feed group per series:
        #: group key -> {series: (ts, seq, side)}
        self._feeds: Dict[tuple, Dict[tuple, tuple]] = {}  # guarded-by: self._lock
        self._subs: Dict[int, Subscription] = {}   # guarded-by: self._lock
        self._by_table: Dict[str, List[Subscription]] = {}  # guarded-by: self._lock
        self._planes: Dict[tuple, _Plane] = {}     # guarded-by: self._lock
        self._closed = False      # guarded-by: self._lock
        self._work: "queue.Queue" = queue.Queue()
        self._enqueued = 0        # guarded-by: self._lock
        self._processed = 0       # guarded-by: self._lock
        self._drained = threading.Condition(self._lock)
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="tempo-standing-delivery")
        self._worker.start()

    # -- registration ---------------------------------------------------

    @staticmethod
    def _as_root(query) -> ir.Node:
        from tempo_tpu_torch.plan import lazy

        if isinstance(query, ir.Node):
            return query
        if isinstance(query, lazy.LazyDistributedTSDF):
            return ir.Node("collect", inputs=(query.plan,))
        if isinstance(query, lazy._LazyBase):
            return query.plan
        raise TypeError(
            f"register() takes a lazy chain over StreamTable.frame() "
            f"(or a plan node), got {type(query).__name__}")

    def register(self, query) -> Subscription:
        """Register a planned method chain as a standing query.
        Returns the live :class:`Subscription`; its first notification
        is the ``"catchup"`` replay of everything the tables already
        hold."""
        root = qsplit.canonicalize(self._as_root(query))
        plan = qsplit.split(root)
        with self._lock:
            if self._closed:
                raise RuntimeError("standing-query engine is closed")
            sub = Subscription(self, next(self._ids), plan,
                               self.queue_depth)
            for t in plan.tables:
                self._adopt(t)
            self._seed_feeds(plan)
            try:
                self._catchup(sub)
            except ValueError as e:
                if sub.mode != "remainder":
                    # the cohort rejected the replay (a LateTickError
                    # or an admission ValueError), so the incremental
                    # catch-up could not be seeded: serve the
                    # subscription correctly from the batch remainder
                    sub.mode = "remainder"
                    sub.reason = (f"catch-up replay failed "
                                  f"({type(e).__name__}: {e}); demoted "
                                  f"to the batch remainder")
                    # the failed incremental catch-up may have claimed
                    # a plane member — release the cohort slot (the
                    # remainder path never uses it) and drop the
                    # half-seeded incremental state
                    self._release_member(sub)
                    sub._plane = None
                    sub._jstate = {}
                    sub._series_seen = set()
                    sub._rrows = 0
                    sub._acc = []
                    self._catchup(sub)
                else:
                    raise
            except Exception:
                # a failed capture or launch is a fault, not a replay
                # rejection: it raises, and no other path serves the
                # subscription; only its claimed cohort slot goes back
                self._release_member(sub)
                raise
            self._subs[sub.id] = sub
            for t in plan.tables:
                self._by_table.setdefault(t.name, []).append(sub)
        return sub

    def register_sql(self, text: str, tables: Dict[str, object]) -> Subscription:
        """Register one SQL statement (``plan/sql_compile.py``) as a standing
        query: ``tables`` maps names to :class:`StreamTable`\\ s (or
        plain frames for static sides); stream tables enter the plan as
        ``unified_scan`` sources, so the statement answers over history
        + live under one watermark."""
        from tempo_tpu_torch.plan import sql_compile

        bound = {name: (t.frame() if isinstance(t, StreamTable) else t)
                 for name, t in tables.items()}
        root = sql_compile.compile_statement(text, bound)
        return self.register(root)

    def _adopt(self, table: StreamTable) -> None:  # guarded-by: self._lock
        have = self._tables.get(table.name)
        if have is None:
            # claim ownership: while adopted, direct table.append()
            # (and adoption by a second engine) is refused — both
            # would commit rows the engine's watermarks and per-push
            # base row counts never saw
            with table._lock:
                if table._engine is not None and table._engine is not self:
                    raise ValueError(
                        f"StreamTable {table.name!r} is already "
                        f"adopted by a different standing-query "
                        f"engine; close it first")
                table._engine = self
            self._tables[table.name] = table
        elif have is not table:
            raise ValueError(
                f"a DIFFERENT StreamTable named {table.name!r} is "
                f"already registered with this engine")

    # -- feed watermarks ------------------------------------------------

    def _groups_of(self, plan: qsplit.StandingPlan) -> List[tuple]:
        if plan.join is not None and plan.mode == "delta":
            return [("j", plan.join.left.name, plan.join.right.name)]
        return [("r", t.name) for t in plan.tables]

    def _seed_feeds(self, plan: qsplit.StandingPlan) -> None:  # guarded-by: self._lock
        """First subscription touching a feed seeds its merged-stream
        watermark from the data already in the tables (per-series max
        (ts, seq, side)) — later pushes admit strictly forward of
        everything the catch-up replay consumed."""
        for gk in self._groups_of(plan):
            wm = self._feeds.setdefault(gk, {})
            if gk[0] == "r":
                tabs = [(self._tables[gk[1]], _SIDE_RIGHT)]
            else:
                tabs = [(self._tables[gk[1]], _SIDE_LEFT),
                        (self._tables[gk[2]], _SIDE_RIGHT)]
            for t, side in tabs:
                df = t.snapshot_df()
                if not len(df):
                    continue
                _, keys, ts_ns, seq = t.prepare(df)
                for i, k in enumerate(keys):
                    key = (int(ts_ns[i]), float(seq[i]), side)
                    if key > wm.get(k, (-(1 << 62), -np.inf, 0)):
                        wm[k] = key

    # -- pushing --------------------------------------------------------

    def push(self, table: StreamTable, df: pd.DataFrame, *,
             deadline=None) -> dict:
        """Admit one batch of events for ``table``: validate against
        every feed watermark the table participates in (ALL groups
        accept before anything commits — a late tick raises
        :class:`LateTickError` and nothing changes), append to the live
        tail, and hand the boundary to the delivery worker.  Returns
        ``{"rows": ..., "boundary_of": [sub ids notified]}``."""
        dl = Deadline.after(deadline)
        with self._lock:
            if self._closed:
                raise RuntimeError("standing-query engine is closed")
            self._adopt(table)
            ndf, keys, ts_ns, seq = table.prepare(df)
            groups = [gk for gk in self._feeds
                      if table.name in gk[1:]]
            # validate EVERY group first (commit-after-success: the
            # admit_batch discipline), then advance the watermarks
            cands: List[Tuple[dict, Dict[tuple, tuple]]] = []
            for gk in groups:
                wm = self._feeds[gk]
                sides = []
                if gk[0] == "r":
                    sides.append(_SIDE_RIGHT)
                else:
                    if gk[2] == table.name:
                        sides.append(_SIDE_RIGHT)
                    if gk[1] == table.name:
                        sides.append(_SIDE_LEFT)
                for side in sides:
                    cand: Dict[tuple, tuple] = {}
                    for i, k in enumerate(keys):
                        key = (int(ts_ns[i]), float(seq[i]), side)
                        prev = cand.get(k, wm.get(k))
                        if prev is not None and key < prev:
                            raise LateTickError(
                                f"{table.name}/{k!r}", key[0], key[1],
                                side, prev)
                        cand[k] = key
                    cands.append((wm, cand))
            for wm, cand in cands:
                wm.update(cand)
            base = table.rows_total()
            table.commit(ndf)
            subs = [s for s in self._by_table.get(table.name, ())
                    if s.live]
            self._enqueued += 1
            # unbounded queue: put_nowait never raises Full, so the
            # enqueue cannot stall other users of the engine lock
            self._work.put_nowait(("push", table, ndf, keys, ts_ns, seq,
                                   base, dl))
        return {"rows": len(ndf), "boundary_of": [s.id for s in subs]}

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until the delivery worker has drained every boundary
        enqueued so far; False when ``timeout`` expired first."""
        with self._lock:
            return self._drained.wait_for(
                lambda: self._processed >= self._enqueued or self._closed,
                timeout=timeout)

    # -- lifecycle ------------------------------------------------------

    def _cancel(self, sub: Subscription) -> None:
        with self._lock:
            if sub._cancelled:
                return
            sub._cancelled = True
            self._release_member(sub)

    def _release_member(self, sub: Subscription) -> None:  # guarded-by: self._lock
        member, plane = sub._member, sub._plane
        sub._member = None
        if member is None or plane is None:
            return
        cohort = plane.cohort
        g = member._group
        if g is not None:
            g.release(member.slot)
            member._group, member.slot = None, None
            cohort._resident -= 1
        cohort._members.pop(member.name, None)
        cohort._lru.pop(member.name, None)
        plane.members -= 1

    def close(self) -> None:
        """Stop the delivery worker and the serving planes.  Standing
        results already accumulated stay readable; adopted tables are
        released back to direct :meth:`StreamTable.append` use."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            planes = list(self._planes.values())
            for t in self._tables.values():
                with t._lock:
                    if t._engine is self:
                        t._engine = None
            self._drained.notify_all()
        self._work.put(None)
        self._worker.join(timeout=30)
        for p in planes:
            p.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def graph_pool_bytes(self) -> int:
        """Bytes the live planes' captured step graphs hold in their
        private pools."""
        with self._lock:
            planes = list(self._planes.values())
        return sum(p.graph_pool_bytes() for p in planes)

    # -- serving planes -------------------------------------------------

    def _plane_for(self, plan: qsplit.StandingPlan) -> Optional[_Plane]:  # guarded-by: self._lock
        if plan.emas:
            key = ("ema", tuple(e.col for e in plan.emas),
                   plan.emas[0].alpha)
            mk = dict(value_cols=[e.col for e in plan.emas],
                      skip_nulls=True, max_lookback=0,
                      ema_alpha=plan.emas[0].alpha)
        elif plan.join is not None:
            js = plan.join
            vcols = [c for c in js.right.value_cols]
            if not vcols:
                return None
            key = ("join", tuple(vcols), js.skip_nulls, js.max_lookback)
            mk = dict(value_cols=vcols, skip_nulls=js.skip_nulls,
                      max_lookback=js.max_lookback, ema_alpha=None)
        else:
            return None
        device = plan.table.device
        key = key + (str(device),)
        plane = self._planes.get(key)
        if plane is None:
            plane = self._planes[key] = _Plane(key, device=device, **mk)
        return plane

    def _ensure_member(self, sub: Subscription,
                       keys: List[tuple]) -> None:  # guarded-by: self._lock
        """Admit any unseen series keys into the subscription's plane
        member (created on first contact — an empty stream has no
        member, so registration against empty tables is free)."""
        plane = sub._plane
        if plane is None:
            return
        seen: set = getattr(sub, "_series_seen", None)
        if seen is None:
            seen = sub._series_seen = set()
        fresh = []
        for k in keys:
            if k not in seen:
                seen.add(k)
                fresh.append(k)
        if not fresh:
            return
        if sub._member is None:
            sub._member = plane.cohort.add_stream(f"sub{sub.id}", fresh)
            plane.members += 1
        else:
            sub._member.add_series(fresh)
        plane.warm(sub._member)

    # -- catch-up -------------------------------------------------------

    def _catchup(self, sub: Subscription) -> None:  # guarded-by: self._lock
        """Register-time replay: everything the tables already hold
        becomes the subscription's boundary-0 state — the plane carries
        seeded bitwise (history replayed per series in the SAME
        (ts, seq) stable order the batch layout sorts), the
        accumulators holding the history rows in arrival order."""
        plan = sub.plan
        for t in plan.tables:
            sub._cursors[t.name] = t.rows_total()
        if sub.mode == "remainder":
            pinned = self._pin_snapshots(plan.tables)
            frame = _run_batch(plan.root, pinned)
            self._notify(sub, Notification("catchup", 0, frame.df))
            return
        if sub.mode == "stateless":
            df = plan.table.snapshot_df()
            if len(df):
                sub._acc.append({"base": df})
            self._notify(sub, Notification(
                "catchup", 0, _suffix_df(plan, self._as_tsdf(df, plan))))
            return
        if plan.join is not None:
            self._catchup_join(sub)
            return
        self._catchup_ema(sub)

    def _as_tsdf(self, df: pd.DataFrame, plan: qsplit.StandingPlan):
        from tempo_tpu_torch.frame import TSDF

        t = plan.table
        return TSDF(df, t.ts_col, t.partitionCols, t.sequence_col or None,
                    device=t.device)

    def _catchup_ema(self, sub: Subscription) -> None:  # guarded-by: self._lock
        t = sub.plan.table
        df = t.snapshot_df()
        sub._plane = self._plane_for(sub.plan)
        if not len(df):
            self._notify(sub, Notification("catchup", 0, df))
            return
        _, keys, ts_ns, seq = t.prepare(df)
        # per-series (ts, seq) stable order: the exact order the batch
        # layout packs, and an always-admissible replay order
        perm = np.lexsort((seq, ts_ns))
        self._ensure_member(sub, [keys[i] for i in perm])
        emas = self._dispatch_ema(sub, df, keys, ts_ns, seq, perm,
                                  Deadline.after(None))
        base = df.copy()
        for e in sub.plan.emas:
            base[f"EMA_{e.col}"] = emas[e.col]
        sub._acc.append({"base": base})
        self._notify(sub, Notification(
            "catchup", 0, _suffix_df(sub.plan, self._as_tsdf(base, sub.plan))))

    def _dispatch_ema(self, sub: Subscription, df, keys, ts_ns, seq,
                      perm, dl) -> Dict[str, np.ndarray]:
        """Push ``df``'s rows (in ``perm`` order) through the
        subscription's plane member and return per-ROW (original
        order) float64 EMA columns from the carry emissions."""
        t = sub.plan.table
        cols = [e.col for e in sub.plan.emas]
        colvals = {c: df[c].to_numpy() for c in cols}
        out = {c: np.empty(len(df), np.float64) for c in cols}
        member = sub._member
        ex = sub._plane.executor
        has_seq = t.sequence_col is not None
        for lo in range(0, len(perm), _REPLAY_CHUNK):
            chunk = perm[lo:lo + _REPLAY_CHUNK]
            ticks = [("right", member, keys[i], int(ts_ns[i]),
                      {c: float(colvals[c][i]) for c in cols},
                      (float(seq[i]) if has_seq else None))
                     for i in chunk]
            tickets = ex.submit_many(ticks, deadline=dl)
            for i, tk in zip(chunk, tickets):
                res = tk.result(timeout=dl.remaining() if dl else None)
                for c in cols:
                    # exact f32 -> f64 widening: bitwise the batch
                    # kernel's unpack .astype(np.float64)
                    out[c][i] = np.float64(
                        np.float32(res[f"{c}_ema"]))
        return out

    def _catchup_join(self, sub: Subscription) -> None:  # guarded-by: self._lock
        js = sub.plan.join
        sub._plane = self._plane_for(sub.plan)
        ldf = js.left.snapshot_df()
        rdf = js.right.snapshot_df()
        _, lkeys, lts, _ = js.left.prepare(ldf)
        _, rkeys, rts, _ = js.right.prepare(rdf)
        pcols = js.left.partitionCols
        rvcols = [c for c in js.right.columns if c not in pcols]
        nrv = len(rvcols)
        valid = np.column_stack(
            [(~pd.isna(rdf[c])).to_numpy() for c in rvcols]) \
            if len(rdf) and nrv else np.zeros((len(rdf), nrv), bool)
        # merged-stream order: (ts, side[right first], within-side pos)
        nl, nr = len(ldf), len(rdf)
        ts_all = np.concatenate([rts, lts])
        side = np.concatenate([np.zeros(nr, np.int8),
                               np.ones(nl, np.int8)])
        pos = np.concatenate([np.arange(nr), np.arange(nl)])
        order = np.lexsort((pos, side, ts_all))
        row_idx = np.full(nl, -1, np.int64)
        col_idx = np.full((nrv, nl), -1, np.int64)
        for j in order:
            if side[j] == 0:
                ridx = int(pos[j])
                st = self._jseries(sub, rkeys[ridx], nrv, js.max_lookback)
                st.on_right(ridx, tuple(valid[ridx]))
            else:
                lidx = int(pos[j])
                st = self._jseries(sub, lkeys[lidx], nrv, js.max_lookback)
                row, cols_m = st.on_left(nrv)
                row_idx[lidx] = row
                for ci in range(nrv):
                    col_idx[ci, lidx] = cols_m[ci]
        sub._rrows = nr
        if nl:
            sub._acc.append({"left": ldf, "row_idx": row_idx,
                             "col_idx": col_idx})
        res = sub._join_result(sub._acc)
        self._notify(sub, Notification(
            "catchup", 0, res.df if hasattr(res, "df") else res))

    def _jseries(self, sub: Subscription, key, nrv, max_lookback) -> _JoinSeries:
        st = sub._jstate.get(key)
        if st is None:
            st = sub._jstate[key] = _JoinSeries(nrv, max_lookback)
        return st

    def _pin_snapshots(self, tables) -> Dict[str, pd.DataFrame]:
        """One consistent snapshot per table, taken under the engine
        lock so a multi-table remainder never sees a torn boundary."""
        with self._lock:
            return {t.name: t.snapshot_df() for t in tables}

    # -- delivery worker ------------------------------------------------

    def _run(self) -> None:
        """The delivery loop: one work item per admitted push (or one
        per coalesced run under ``TEMPO_TPU_STANDING_PUSH_PERIOD``),
        fanned out to every live subscription on the pushed table —
        submits first, awaits after, so concurrent subscriptions
        coalesce into batched cohort dispatches."""
        while True:
            item = self._work.get()
            if item is None:
                with self._lock:
                    self._drained.notify_all()
                return
            items = [item]
            if self.push_period > 0:
                dl = Deadline.after(self.push_period)
                while True:
                    try:
                        nxt = self._work.get(timeout=dl.remaining())
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._work.put(None)
                        break
                    items.append(nxt)
            for it in items:
                try:
                    self._deliver(it)
                finally:
                    with self._lock:
                        self._processed += 1
                        self._drained.notify_all()

    def _deliver(self, item) -> None:
        _, table, ndf, keys, ts_ns, seq, base, dl = item
        with self._lock:
            # a subscription registered (or resumed) AFTER this push
            # committed already holds these rows from its catch-up
            # snapshot — its cursor sits past `base`; delivering the
            # delta again would duplicate the rows in the accumulator
            # and overshoot the cursor past rows_total
            subs = [s for s in self._by_table.get(table.name, ())
                    if s.live and s._cursors.get(table.name, 0) <= base]
            submitted = []
            for sub in subs:
                try:
                    submitted.append(
                        (sub, self._submit_sub(sub, table, ndf, keys,
                                               ts_ns, seq, base, dl)))
                except Exception as e:  # noqa: BLE001 - per subscriber
                    self._fail(sub, e)
        for sub, pending in submitted:
            try:
                self._finish_sub(sub, table, ndf, pending, dl)
            except Exception as e:  # noqa: BLE001 - per subscriber
                with self._lock:
                    self._fail(sub, e)

    def _submit_sub(self, sub, table, ndf, keys, ts_ns, seq, base, dl):  # guarded-by: self._lock
        """Phase 1 (under the lock): update host carries, enqueue the
        subscription's plane ticks.  Returns what phase 2 awaits."""
        plan = sub.plan
        if sub.mode == "remainder":
            return ("remainder",)
        if sub.mode == "stateless":
            return ("stateless",)
        if plan.join is not None:
            return self._submit_join(sub, table, ndf, keys, ts_ns,
                                     base, dl)
        # EMA: one tick per pushed row, in arrival order (admission
        # guarantees per-series (ts, seq) monotone arrival = the batch
        # layout's stable order)
        self._ensure_member(sub, keys)
        cols = [e.col for e in plan.emas]
        has_seq = table.sequence_col is not None
        vals = {c: ndf[c].to_numpy() for c in cols}
        ticks = [("right", sub._member, keys[i], int(ts_ns[i]),
                  {c: float(vals[c][i]) for c in cols},
                  (float(seq[i]) if has_seq else None))
                 for i in range(len(ndf))]
        tickets = sub._plane.executor.submit_many(ticks, deadline=dl)
        return ("ema", tickets)

    def _submit_join(self, sub, table, ndf, keys, ts_ns, base, dl):  # guarded-by: self._lock
        js = sub.plan.join
        pcols = js.left.partitionCols
        rvcols = [c for c in js.right.columns if c not in pcols]
        nrv = len(rvcols)
        if table is js.right:
            valid = np.column_stack(
                [(~pd.isna(ndf[c])).to_numpy() for c in rvcols]) \
                if len(ndf) and nrv else np.zeros((len(ndf), nrv), bool)
            for i, k in enumerate(keys):
                st = self._jseries(sub, k, nrv, js.max_lookback)
                st.on_right(base + i, tuple(valid[i]))
            sub._rrows = base + len(ndf)
            tickets = []
            if sub._plane is not None and js.right.value_cols:
                self._ensure_member(sub, keys)
                vals = {c: ndf[c].to_numpy()
                        for c in js.right.value_cols}
                ticks = [("right", sub._member, keys[i], int(ts_ns[i]),
                          {c: float(vals[c][i])
                           for c in js.right.value_cols}, None)
                         for i in range(len(ndf))]
                tickets = sub._plane.executor.submit_many(ticks,
                                                          deadline=dl)
            return ("join_right", tickets)
        row_idx = np.full(len(ndf), -1, np.int64)
        col_idx = np.full((nrv, len(ndf)), -1, np.int64)
        for i, k in enumerate(keys):
            st = self._jseries(sub, k, nrv, js.max_lookback)
            row, cols_m = st.on_left(nrv)
            row_idx[i] = row
            for ci in range(nrv):
                col_idx[ci, i] = cols_m[ci]
        rec = {"left": ndf, "row_idx": row_idx, "col_idx": col_idx}
        tickets = []
        if (sub._plane is not None and sub._member is not None
                and all(k in sub._series_seen for k in keys)):
            ticks = [("left", sub._member, keys[i], int(ts_ns[i]),
                      None, None) for i in range(len(ndf))]
            tickets = sub._plane.executor.submit_many(ticks, deadline=dl)
        return ("join_left", tickets, rec)

    def _finish_sub(self, sub, table, ndf, pending, dl) -> None:
        """Phase 2 (outside the lock): await the plane tickets,
        assemble the delta (from the EXACT rows this boundary pushed —
        carried in the work item, never re-derived from a racing
        snapshot), append the accumulator and notify."""
        kind = pending[0]
        plan = sub.plan
        if kind == "remainder":
            with self._lock:
                sub.boundaries += 1
                self._bump_cursor(sub, table, len(ndf))
                due = sub.boundaries % self.remainder_every == 0
                bno = sub.boundaries
                tables = plan.tables
            if due:
                pinned = self._pin_snapshots(tables)
                frame = _run_batch(plan.root, pinned)
                self._notify(sub, Notification("refresh", bno, frame.df))
            return
        if kind == "stateless":
            with self._lock:
                sub._acc.append({"base": ndf})
                sub.boundaries += 1
                bno = sub.boundaries
                self._bump_cursor(sub, table, len(ndf))
            self._notify(sub, Notification(
                "delta", bno, _suffix_df(plan, self._as_tsdf(ndf, plan))))
            return
        if kind == "ema":
            tickets = pending[1]
            cols = [e.col for e in plan.emas]
            emas = {c: np.empty(len(ndf), np.float64) for c in cols}
            for i, tk in enumerate(tickets):
                res = tk.result(timeout=dl.remaining() if dl else None)
                for c in cols:
                    emas[c][i] = np.float64(np.float32(res[f"{c}_ema"]))
            base = ndf.copy()
            for e in plan.emas:
                base[f"EMA_{e.col}"] = emas[e.col]
            with self._lock:
                sub._acc.append({"base": base})
                sub.boundaries += 1
                bno = sub.boundaries
                self._bump_cursor(sub, table, len(ndf))
            self._notify(sub, Notification(
                "delta", bno, _suffix_df(plan, self._as_tsdf(base, plan))))
            return
        # join sides: await the plane's merged-stream step (machinery
        # + quarantine semantics); the exact-dtype assembly rides the
        # host carries recorded in phase 1
        tickets = pending[1]
        for tk in tickets:
            tk.result(timeout=dl.remaining() if dl else None)
        if kind == "join_right":
            with self._lock:
                sub.boundaries += 1
                self._bump_cursor(sub, table, len(ndf))
            return
        rec = pending[2]
        with self._lock:
            sub._acc.append(rec)
            sub.boundaries += 1
            bno = sub.boundaries
            self._bump_cursor(sub, table, len(ndf))
        delta = sub._join_result([rec])
        self._notify(sub, Notification(
            "delta", bno, delta.df if hasattr(delta, "df") else delta))

    def _bump_cursor(self, sub, table, rows: int) -> None:  # guarded-by: self._lock
        sub._cursors[table.name] = sub._cursors.get(table.name, 0) + rows

    def _fail(self, sub, exc: BaseException) -> None:  # guarded-by: self._lock
        if sub._err is None:
            sub._err = exc
        self._notify(sub, Notification("error", sub.boundaries, None,
                                       error=exc))
        self._release_member(sub)

    def _notify(self, sub, note: Notification) -> None:
        """Bounded, per-subscriber delivery: a full queue drops the
        OLDEST notification (counted) — one slow consumer never stalls
        the fleet, and ``result()`` stays exact regardless."""
        if sub._cancelled:
            return
        while True:
            try:
                sub._q.put_nowait(note)
                return
            except queue.Full:
                try:
                    sub._q.get_nowait()
                    sub.dropped += 1
                except queue.Empty:
                    continue


# ----------------------------------------------------------------------
# Snapshot / resume: kind="standing_state"
# ----------------------------------------------------------------------

def snapshot_subscription(sub: Subscription, path: str) -> str:
    """Persist one standing subscription as a CRC'd
    ``kind="standing_state"`` artifact: per-table replay cursors plus —
    for EMA subscriptions — the serving plane's slot carries and
    watermark rows, bit-for-bit (the cohort spill recipe).  Resuming
    and pushing the tail is byte-identical to the uninterrupted run."""
    from tempo_tpu_torch import checkpoint as ckpt

    eng = sub.engine
    eng.flush()
    with eng._lock:
        if sub._err is not None:
            raise sub._err
        arrays: Dict[str, np.ndarray] = {
            "cursor_rows": np.asarray(
                [sub._cursors.get(t.name, 0) for t in sub.plan.tables],
                np.int64)}
        meta = {
            "plan_signature": sub.plan.signature,
            "mode": sub.mode,
            "boundaries": int(sub.boundaries),
            "tables": [t.name for t in sub.plan.tables],
            "series_repr": ([repr(s) for s in sub._member.series]
                            if sub._member is not None else []),
        }
        member = sub._member
        if member is not None and member._group is not None:
            g, slot = member._group, member.slot
            for n, a in g.slot_rows(slot).items():
                arrays[f"s.{n}"] = np.ascontiguousarray(a)
            arrays["wm_ts"] = np.ascontiguousarray(g.wm_ts[slot])
            arrays["wm_seq"] = np.ascontiguousarray(g.wm_seq[slot])
            arrays["wm_side"] = np.ascontiguousarray(g.wm_side[slot])
            meta["bucket"] = int(g.bucket)
        ckpt.save_state(arrays, path, meta, kind="standing_state")
    return path


def resume_subscription(engine: StandingQueryEngine, query,
                        path: str) -> Subscription:
    """Re-register ``query`` from a ``kind="standing_state"`` artifact:
    the canonical plan signature must match the artifact's (refused by
    name otherwise), the accumulators are rebuilt from each table's
    snapshot prefix at the saved cursors, the plane carries install
    bit-for-bit, and any rows the tables gained past the cursors replay
    as a catch-up gap.  Subsequent pushes are byte-identical to the
    never-killed subscription."""
    from tempo_tpu_torch import checkpoint as ckpt

    arrays, meta = ckpt.load_state(path, kind="standing_state")
    root = qsplit.canonicalize(engine._as_root(query))
    plan = qsplit.split(root)
    if plan.signature != meta.get("plan_signature"):
        raise ckpt.CheckpointError(
            f"standing-state artifact {path!r} was saved for plan "
            f"signature {meta.get('plan_signature')!r} but the "
            f"registered query canonicalizes to {plan.signature!r}: "
            f"refusing to resume a DIFFERENT standing query from it")
    cursors = {name: int(r) for name, r in
               zip(meta.get("tables", ()),
                   np.asarray(arrays["cursor_rows"]))}
    with engine._lock:
        if engine._closed:
            raise RuntimeError("standing-query engine is closed")
        sub = Subscription(engine, next(engine._ids), plan,
                           engine.queue_depth)
        for t in plan.tables:
            engine._adopt(t)
            if cursors.get(t.name, 0) > t.rows_total():
                raise ckpt.CheckpointError(
                    f"standing-state artifact {path!r} holds a cursor "
                    f"of {cursors[t.name]} rows for table {t.name!r} "
                    f"but the table only has {t.rows_total()}: the "
                    f"artifact outlived this table's data — resume "
                    f"against the original tables")
        engine._seed_feeds(plan)
        engine._resume_state(sub, arrays, meta, cursors)
        engine._subs[sub.id] = sub
        for t in plan.tables:
            engine._by_table.setdefault(t.name, []).append(sub)
    return sub


def _install_slot(plane: _Plane, member, arrays) -> None:
    g, slot = member._group, member.slot
    g.set_slot(slot, {n: arrays[f"s.{n}"] for n in g.cfg.state_names()})
    g.wm_ts[slot] = np.asarray(arrays["wm_ts"], np.int64)
    g.wm_seq[slot] = np.asarray(arrays["wm_seq"], np.float64)
    g.wm_side[slot] = np.asarray(arrays["wm_side"], np.int8)


def _resume_state(self, sub: Subscription, arrays, meta,
                  cursors: Dict[str, int]) -> None:  # guarded-by: self._lock
    """Rebuild a resumed subscription's accumulators from the table
    prefixes at the saved cursors and install the plane carries."""
    from tempo_tpu_torch import checkpoint as ckpt

    plan = sub.plan
    for t in plan.tables:
        sub._cursors[t.name] = cursors.get(t.name, 0)
    if sub.mode == "remainder":
        sub.boundaries = int(meta.get("boundaries", 0))
        self._replay_gap(sub)
        return
    if sub.mode == "stateless":
        t = plan.table
        pre = t.prefix_df(sub._cursors[t.name])
        if len(pre):
            sub._acc.append({"base": pre})
        sub.boundaries = int(meta.get("boundaries", 0))
        self._replay_gap(sub)
        return
    if plan.join is not None:
        # host carries are cheap to rebuild exactly: replay the saved
        # prefix through the merged-stream walk (no device state)
        js = plan.join
        lcur = sub._cursors[js.left.name]
        rcur = sub._cursors[js.right.name]
        sub._plane = self._plane_for(plan)
        self._seed_join_prefix(sub, js.left.prefix_df(lcur),
                               js.right.prefix_df(rcur))
        sub.boundaries = int(meta.get("boundaries", 0))
        self._replay_gap(sub)
        return
    # EMA: accumulator from the prefix (batch kernel — same bits), the
    # carry installed from the artifact (same bits as the live slot)
    t = plan.table
    pre = t.prefix_df(sub._cursors[t.name])
    sub._plane = self._plane_for(plan)
    if len(pre):
        _, keys, ts_ns, seq = t.prepare(pre)
        prefix_series = list(dict.fromkeys(
            keys[i] for i in np.lexsort((seq, ts_ns))))
        # the live member admitted series in push ARRIVAL order, and
        # the slot carries are laid out in that order — rebuild from
        # the artifact's saved series list (any permutation of the
        # prefix's series set is legitimate; a different SET is not)
        saved = meta.get("series_repr") or []
        if saved:
            by_repr = {repr(k): k for k in prefix_series}
            if sorted(saved) != sorted(by_repr):
                raise ckpt.CheckpointError(
                    f"standing-state artifact holds carries for series "
                    f"{sorted(saved)} but the table prefix yields "
                    f"{sorted(by_repr)}: refusing to install "
                    f"FOREIGN carries")
            order = [by_repr[r] for r in saved]
        else:
            order = prefix_series
        sub._series_seen = set(order)
        sub._member = sub._plane.cohort.add_stream(f"sub{sub.id}", order)
        sub._plane.members += 1
        if "wm_ts" in arrays:
            _install_slot(sub._plane, sub._member, arrays)
        sub._plane.warm(sub._member)
        base = pre.copy()
        for c, e in self._batch_ema_cols(plan, pre).items():
            base[c] = e
        sub._acc.append({"base": base})
    sub.boundaries = int(meta.get("boundaries", 0))
    self._replay_gap(sub)


def _batch_ema_cols(self, plan: qsplit.StandingPlan,
                    df: pd.DataFrame) -> Dict[str, np.ndarray]:
    """Per-row (original order) EMA columns via the batch kernel —
    bitwise the carry emissions (ema_scan is the shared kernel)."""
    from tempo_tpu_torch.frame import TSDF

    t = plan.table
    out: Dict[str, np.ndarray] = {}
    tsdf = TSDF(df[t.columns], t.ts_col, t.partitionCols,
                t.sequence_col or None, device=t.device)
    inv = np.empty(len(df), np.int64)
    inv[tsdf.layout.order] = np.arange(len(df))
    for e in plan.emas:
        res = qsplit.eval_ema_stream(tsdf, e.col, e.alpha)
        out[f"EMA_{e.col}"] = res.df[f"EMA_{e.col}"].to_numpy()[inv]
    return out


def _seed_join_prefix(self, sub: Subscription, ldf: pd.DataFrame,
                      rdf: pd.DataFrame) -> None:  # guarded-by: self._lock
    js = sub.plan.join
    _, lkeys, lts, _ = js.left.prepare(ldf)
    _, rkeys, rts, _ = js.right.prepare(rdf)
    pcols = js.left.partitionCols
    rvcols = [c for c in js.right.columns if c not in pcols]
    nrv = len(rvcols)
    valid = np.column_stack(
        [(~pd.isna(rdf[c])).to_numpy() for c in rvcols]) \
        if len(rdf) and nrv else np.zeros((len(rdf), nrv), bool)
    nl, nr = len(ldf), len(rdf)
    ts_all = np.concatenate([rts, lts])
    side = np.concatenate([np.zeros(nr, np.int8), np.ones(nl, np.int8)])
    pos = np.concatenate([np.arange(nr), np.arange(nl)])
    order = np.lexsort((pos, side, ts_all))
    row_idx = np.full(nl, -1, np.int64)
    col_idx = np.full((nrv, nl), -1, np.int64)
    for j in order:
        if side[j] == 0:
            ridx = int(pos[j])
            st = self._jseries(sub, rkeys[ridx], nrv, js.max_lookback)
            st.on_right(ridx, tuple(valid[ridx]))
        else:
            lidx = int(pos[j])
            st = self._jseries(sub, lkeys[lidx], nrv, js.max_lookback)
            row, cols_m = st.on_left(nrv)
            row_idx[lidx] = row
            for ci in range(nrv):
                col_idx[ci, lidx] = cols_m[ci]
    sub._rrows = nr
    if nl:
        sub._acc.append({"left": ldf, "row_idx": row_idx,
                         "col_idx": col_idx})


def _replay_gap(self, sub: Subscription) -> None:  # guarded-by: self._lock
    """Rows the tables gained past the saved cursors (pushes the
    engine admitted after the snapshot, or before resume) replay as
    one catch-up boundary per table — the resumed subscription lands
    exactly at the tables' current edge."""
    for t in sub.plan.tables:
        lo = sub._cursors.get(t.name, 0)
        hi = t.rows_total()
        if hi <= lo:
            continue
        gap = t.snapshot_df().iloc[lo:hi].reset_index(drop=True)
        _, keys, ts_ns, seq = t.prepare(gap)
        pending = self._submit_sub(sub, t, gap, keys, ts_ns, seq, lo,
                                   None)
        self._finish_sub(sub, t, gap, pending, None)


# bind the resume helpers as engine methods (they live at module level
# to keep the class body focused on the live path)
StandingQueryEngine._resume_state = _resume_state
StandingQueryEngine._batch_ema_cols = _batch_ema_cols
StandingQueryEngine._seed_join_prefix = _seed_join_prefix
StandingQueryEngine._replay_gap = _replay_gap
