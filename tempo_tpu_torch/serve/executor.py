"""Async micro-batch executors: the serving front door.

Counterpart of ``tempo_tpu/serve/executor.py``: ``MicroBatchExecutor``
in front of one ``StreamingTSDF``, ``CohortExecutor`` in front of a
``StreamCohort`` (one cohort dispatch a micro-batch, ``submit_many``
chunks and ``submit_block`` column blocks).

A background worker drains a **bounded** tick queue
(``TEMPO_TPU_SERVE_QUEUE_DEPTH``; a full queue blocks ``submit`` — the
backpressure signal) into shape-bucketed, padded micro-batches: ticks
are coalesced greedily, split into side-homogeneous runs **in arrival
order** (a push and a query can never be reordered around each other —
that would change merged-stream positions), capped at
``TEMPO_TPU_SERVE_BATCH_ROWS`` rows per series, and dispatched through
``StreamingTSDF.push`` / ``push_left``.  Padded row counts land on a
handful of power-of-two buckets, so the steady state runs a small
fixed set of cached steps (``plan/cache.py``; CUDA graphs on a card)
and builds nothing new.

Every tick carries latency stamps (submit -> batch completion, queue
wait included — the number a caller actually experiences);
``latency_stats()`` reports p50/p99 per side.  ``close()`` drains
gracefully: everything already submitted completes, then the worker
exits.  A batch failure is delivered on each affected ticket's
``result()``, never swallowed.

**The fault domain** (resilience.py primitives):

* *deadlines* — a :class:`~tempo_tpu_torch.resilience.Deadline` rides each
  ticket from ``submit`` (``deadline=`` seconds, default
  ``TEMPO_TPU_SERVE_DEADLINE_S``); a tick whose budget dies while it
  is still queued fails fast with a stage-named ``DeadlineExceeded``
  and never reaches a dispatch (once dispatched, its state change is
  real, so its result is always delivered).
* *cancellation* — ``Ticket.cancel()`` resolves the ticket with
  :class:`~tempo_tpu_torch.resilience.Cancelled`; the worker drops it on
  sight, so cancelled work never reaches the stream.
* *supervision* — the drain thread runs under a supervisor: an
  unexpected exception escaping the worker loop fails the in-flight
  tickets, restarts the drain (``restarts`` counts them), and the
  plane lives on; a ``BaseException`` (``SimulatedKill`` — modelled
  process death) marks the plane dead, fails every outstanding ticket
  with :class:`~tempo_tpu_torch.resilience.ShutdownError` and closes it.
* *quarantine* — :class:`CohortExecutor` carries a per-stream-member
  :class:`~tempo_tpu_torch.resilience.CircuitBreaker`: a member failing
  repeatedly is quarantined (its tickets fail fast with
  ``QuarantinedError``) until a half-open probe succeeds.
* *shutdown* — ``close(timeout)`` shares ONE deadline across the
  drain; whatever is still pending when it expires (or when the
  worker is dead) is failed with ``ShutdownError`` — a ticket NEVER
  hangs its caller.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

import torch

from tempo_tpu_torch import config
from tempo_tpu_torch.resilience import (Cancelled, CircuitBreaker, Deadline,
                                        DeadlineExceeded, QuarantinedError,
                                        ShutdownError)
from tempo_tpu_torch.serve import stream as stream_mod

logger = logging.getLogger(__name__)

_CLOSE = object()

#: bounded percentile-sample window of the queue-side latency reports
#: (this executor's per-side samples and the cohort executor's): the most
#: recent window of ticks, so a long-lived server never grows a float per
#: tick served forever.
LATENCY_WINDOW = 4096


def latency_percentiles(lats) -> dict:
    """p50/p99 (milliseconds) + count of a latency sample: the one
    percentile reducer behind the queue-side latency reports."""
    if not lats:
        return {"count": 0, "p50_ms": None, "p99_ms": None}
    s = sorted(lats)
    pick = lambda q: s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]
    return {"count": len(s),
            "p50_ms": round(pick(0.50) * 1e3, 3),
            "p99_ms": round(pick(0.99) * 1e3, 3)}


class _ChunkGate:
    """Shared completion gate for a ``submit_many`` chunk: ONE lock
    for the whole chunk.  A per-ticket ``threading.Event`` is an
    allocation a tick, which at fleet rates caps the feeder below the
    dispatch side.  Tickets flip their ``_done``
    flag; the worker rings the gate once per processed batch; waiters
    re-check their own flag (a chunk split across batches wakes some
    waiters early — they just wait again)."""

    __slots__ = ("cv",)

    def __init__(self):
        self.cv = threading.Condition()

    def ring(self):
        with self.cv:
            self.cv.notify_all()

    def wait_for(self, ticket: "Ticket",
                 timeout: Optional[float]) -> bool:
        with self.cv:
            return self.cv.wait_for(lambda: ticket._done, timeout)


class Ticket:
    """One submitted tick: a waitable handle for its per-row result.
    ``member`` is the cohort stream handle on
    :class:`CohortExecutor` tickets, ``None`` on single-stream ones."""

    __slots__ = ("kind", "series", "ts", "seq", "values", "member",
                 "deadline", "t_submit", "t_done", "_event", "_gate",
                 "_done", "_cancelled", "_result", "_exc")

    def __init__(self, kind, series, ts, seq, values, member=None,
                 t_submit=None, gate: Optional[_ChunkGate] = None,
                 deadline: Optional[Deadline] = None):
        self.kind = kind
        self.series = series
        self.ts = ts
        self.seq = seq
        self.values = values
        self.member = member
        self.deadline = deadline
        self.t_submit = (time.perf_counter() if t_submit is None
                         else t_submit)
        self.t_done = None
        self._gate = gate
        self._event = None if gate is not None else threading.Event()
        self._done = False
        self._cancelled = False
        self._result = None
        self._exc = None

    def _finish(self, result=None, exc=None):
        if self._done:      # first outcome wins: a shutdown sweep and
            return          # a still-draining worker may race here
        self._result, self._exc = result, exc
        self.t_done = time.perf_counter()
        self._done = True
        if self._event is not None:
            self._event.set()
        # gate tickets are woken by the worker's per-batch ring()

    def cancel(self) -> bool:
        """Request cancellation (best-effort, asynchronous): the WORKER
        resolves the ticket with :class:`Cancelled` when it reaches it
        still queued — cancelled work never reaches a dispatch.  A tick
        already inside a dispatch cannot be un-run: its real outcome is
        delivered (resolving it Cancelled while the state change lands
        would make an at-least-once feeder double-apply the event).
        Returns ``True`` when the request was registered before the
        ticket resolved; the caller learns the actual outcome from
        ``result()``."""
        if self._done:
            return False
        self._cancelled = True
        return not self._done

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None):
        """Per-row emission dict for this tick (blocks until its
        micro-batch completes); re-raises the batch's failure."""
        if not self._done:
            ok = (self._event.wait(timeout) if self._event is not None
                  else self._gate.wait_for(self, timeout))
            if not ok:
                raise TimeoutError("tick not processed yet")
        if self._exc is not None:
            raise self._exc
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class BlockTicket(Ticket):
    """One submitted columnar tick block
    (:meth:`CohortExecutor.submit_block`): a waitable handle whose
    ``result()`` is the block's full-length columnar emission dict
    (``StreamCohort.dispatch_block``'s ``out``).  Per-tick rejections
    (late tick, unknown series, quarantined member) land in
    :attr:`errors` — index -> exception — with the rejected rows left
    at their fill values; only a BLOCK-level failure raises from
    ``result()``.  ``cancel()``/deadlines drop the whole block before
    dispatch, exactly like a per-tick ticket."""

    __slots__ = ("kinds", "members", "series_ids", "tsv", "seqv",
                 "_errors")

    def __init__(self, kinds, members, series_ids, ts, seq, values,
                 deadline: Optional[Deadline] = None):
        n = len(members)
        ts_span = f"{int(ts[0])}..{int(ts[-1])}" if n else ""
        super().__init__("block", f"<{n} ticks>", ts_span, None,
                         values, deadline=deadline)
        self.kinds = kinds
        self.members = members
        self.series_ids = series_ids
        self.tsv = ts
        self.seqv = seq
        self._errors: Dict[int, Exception] = {}

    @property
    def errors(self) -> Dict[int, Exception]:
        """Per-tick rejections (tick index -> exception), populated by
        the time ``result()`` returns."""
        return self._errors


class MicroBatchExecutor:
    """See module docstring.  While an executor is attached, all
    traffic must go through it (``StreamingTSDF`` itself is
    single-writer)."""

    #: upper bound on a coalesced run before the worker stops waiting
    #: for more ticks and dispatches what it has
    _COALESCE_MAX = 8192

    def __init__(self, stream, queue_depth: Optional[int] = None,
                 batch_rows: Optional[int] = None,
                 coalesce_s: float = 0.0):
        if queue_depth is None:
            queue_depth = config.get_int("TEMPO_TPU_SERVE_QUEUE_DEPTH",
                                         1024)
        if batch_rows is None:
            # the env knob, else the built-in 64 (the reference's
            # autotuner, which may pick another default, is not ported)
            batch_rows = config.get_int("TEMPO_TPU_SERVE_BATCH_ROWS", 64)
        self.stream = stream
        self.batch_rows = max(1, int(batch_rows))
        # micro-batch coalescing window: after the first tick of a
        # run, wait up to this long for more before dispatching.  A
        # dispatch has a real fixed cost (for a cohort, stepping the
        # whole [S, ...] state block); under load, paying it for a
        # handful of ticks caps aggregate throughput — the window
        # trades bounded extra latency for amortization.  0 (the
        # single-stream default) preserves drain-what's-queued
        self.coalesce_s = max(0.0, float(coalesce_s))
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_depth))
        # bounded per-side sample windows: percentiles are over the
        # most recent LATENCY_WINDOW ticks, per ticket (submit ->
        # completion), never per dispatch
        self._latencies: Dict[str, collections.deque] = {
            "right": collections.deque(maxlen=LATENCY_WINDOW),
            "left": collections.deque(maxlen=LATENCY_WINDOW)}
        self.batches = 0
        self.ticks = 0
        self.bucket_hist: Dict[int, int] = {}
        #: default per-ticket deadline budget (seconds); None = none
        self.deadline_s = config.get_float("TEMPO_TPU_SERVE_DEADLINE_S")
        #: drain-thread restarts performed by the supervisor
        self.restarts = 0
        #: tickets failed with a stage-named DeadlineExceeded
        self.deadline_failures = 0
        #: the BaseException that killed the plane, when it is dead
        self.fatal: Optional[BaseException] = None
        self._inflight: List[Ticket] = []
        self._closed = False  # guarded-by: self._submit_lock
        # serializes the closed-check+enqueue against close(): without
        # it a tick can land BEHIND the close sentinel and hang its
        # result() forever
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._supervise,
                                        daemon=True,
                                        name="tempo-serve-executor")
        self._thread.start()

    # -- producer side -------------------------------------------------

    def _deadline(self, deadline) -> Optional[Deadline]:
        """Per-submit override (seconds or a Deadline) over the
        executor default (``TEMPO_TPU_SERVE_DEADLINE_S``)."""
        if deadline is None:
            deadline = self.deadline_s
        return Deadline.after(deadline)

    def submit(self, kind: str, series, ts, values=None, seq=None,
               timeout: Optional[float] = None, deadline=None) -> Ticket:
        """Enqueue one tick (``kind`` 'right' = data, 'left' = query).
        Blocks while the queue is full (backpressure); a ``timeout``
        surfaces ``queue.Full`` instead of waiting forever.
        ``deadline`` (seconds, or a :class:`Deadline`) bounds the
        tick's WHOLE trip: expiry during the backpressure wait or in
        the queue fails it with a stage-named ``DeadlineExceeded``."""
        if kind not in ("right", "left"):
            raise ValueError(f"kind must be 'right' or 'left', got "
                             f"{kind!r}")
        dl = self._deadline(deadline)
        t = Ticket(kind, series, ts, seq, values, deadline=dl)
        self._put(t, timeout, dl)
        return t

    def _put(self, item, timeout: Optional[float],
             dl: Optional[Deadline]) -> None:
        """Closed-checked enqueue; a deadline bounds the backpressure
        wait (stage 'submit backpressure') under the caller timeout."""
        if dl is not None:
            dl.check("submit backpressure")
            rem = dl.remaining()
            timeout = rem if timeout is None else min(timeout, rem)
        with self._submit_lock:
            if self._closed:
                raise ShutdownError("executor is closed")
            try:
                # Deliberate: the closed-check+enqueue must be
                # atomic vs close() or a tick lands BEHIND the close
                # sentinel and its result() hangs forever; the lock's
                # only other users flip the _closed flag, so the stall
                # here is pure backpressure.
                self._q.put(item, block=True, timeout=timeout)  # lint-ok: blocking-under-lock: atomic closed-check+enqueue vs close(); see comment above
            except queue.Full:
                if dl is not None and dl.expired():
                    raise DeadlineExceeded(
                        f"deadline exceeded at stage 'submit "
                        f"backpressure': queue still full after the "
                        f"{dl.budget_s:.3f}s budget",
                        stage="submit backpressure") from None
                raise

    def close(self, timeout: Optional[float] = None):
        """Graceful drain: stop accepting, process everything already
        queued, stop the worker.  ``timeout`` bounds the WHOLE drain
        (one shared deadline);
        tickets still pending when it expires — or when the worker is
        dead — are failed with :class:`ShutdownError`, never left to
        hang their callers."""
        with self._submit_lock:
            sentinel_needed = not self._closed
            self._closed = True
        if sentinel_needed:
            # the sentinel enqueue deliberately sits OUTSIDE the
            # critical section: with _closed already up, submitters
            # fail fast with ShutdownError instead of stacking behind
            # a close() blocked on a full queue, and ordering is
            # preserved — _put's closed-check+enqueue is atomic under
            # the same lock, so nothing can land behind the sentinel
            self._q.put(_CLOSE)
        # idempotent: a second close (e.g. __exit__ after an explicit
        # close) joins the SAME drain within its own timeout — it must
        # never steal queued tickets from a worker that is still
        # draining them gracefully
        dl = Deadline.after(timeout)
        self._thread.join(timeout if dl is None else
                          max(0.0, dl.remaining()))
        if self._thread.is_alive() or self.fatal is not None \
                or not self._q.empty():
            cause = (f" (plane died: {self.fatal})"
                     if self.fatal is not None else
                     " (drain deadline expired)"
                     if self._thread.is_alive() else "")
            self._fail_pending(ShutdownError(
                f"executor closed with this tick still pending{cause}"))

    def _fail_pending(self, exc: BaseException) -> None:
        """Resolve every ticket the worker will never process: the
        queue backlog and the not-yet-finished in-flight group.  A
        still-alive worker finds a fresh close sentinel so it exits at
        its next queue read instead of blocking forever."""
        drained = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            drained = True
            if item is _CLOSE:
                continue
            group: List[Ticket] = []
            self._extend(group, item)
            for t in group:
                t._finish(exc=exc)
                self._on_dropped(t)     # free an abandoned breaker probe
            self._ring(group)
        for t in list(self._inflight):
            if not t._done:
                t._finish(exc=exc)
                self._on_dropped(t)
        self._ring(self._inflight)
        if drained and self._thread.is_alive():
            self._q.put(_CLOSE)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- worker side ---------------------------------------------------

    @staticmethod
    def _extend(group: List[Ticket], item) -> None:
        """Fold one queue entry into the run — a bare ticket or a
        ``submit_many`` chunk (list of tickets)."""
        if type(item) is list:
            group.extend(item)
        else:
            group.append(item)

    @staticmethod
    def _ring(batch):
        gates = {t._gate for t in batch}
        gates.discard(None)
        for gate in gates:
            gate.ring()

    def _supervise(self):  # owns-tickets: _finish, _fail_pending
        """The drain thread's supervisor: an unexpected ``Exception``
        escaping the worker loop (poisoned work already fails inside
        its own batch — this catches plane-level faults) fails the
        in-flight group, restarts the drain, and the executor keeps
        serving.  A ``BaseException`` (``SimulatedKill`` — modelled
        process death, real interpreter teardown) is NOT survivable:
        the plane closes itself, every outstanding ticket resolves
        with :class:`ShutdownError`, and the thread exits.  A stream or
        cohort on a card makes its card the thread's current device
        before the first replay."""
        dev = getattr(self.stream, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            try:
                self._run()
                return                        # clean close
            except Exception as e:  # noqa: BLE001 - supervised restart
                for t in list(self._inflight):
                    t._finish(exc=e)
                self._ring(self._inflight)
                self._inflight = []
                self.restarts += 1
                logger.warning(
                    "serve executor worker died (%s: %s); supervisor "
                    "restart #%d", type(e).__name__, e, self.restarts)
            except BaseException as e:        # the plane is dead
                self.fatal = e
                with self._submit_lock:
                    self._closed = True
                self._fail_pending(ShutdownError(
                    f"executor plane died ({type(e).__name__}: {e}); "
                    f"tick was never processed"))
                logger.error("serve executor plane died: %s", e)
                return

    def _admit_live(self, group: List[Ticket]) -> List[Ticket]:
        """Drop tickets that must never reach a dispatch: cancelled
        ones (resolved HERE with :class:`Cancelled` — the worker is
        the single decision point, so a cancellation can never race a
        dispatch's state change) and those whose deadline died in the
        queue — failed with a stage-named ``DeadlineExceeded``.
        Deadlines are only enforced BEFORE dispatch: once the step
        program ran, the state change is real and the result is
        always delivered."""
        live: List[Ticket] = []
        woke: List[Ticket] = []
        for t in group:
            if t._done:
                continue
            if t._cancelled:
                t._finish(exc=Cancelled(
                    f"tick ({t.kind!r}, series {t.series!r}, ts "
                    f"{t.ts}) cancelled before dispatch"))
                self._on_dropped(t)
                woke.append(t)
                continue
            if t.deadline is not None and t.deadline.expired():
                t._finish(exc=DeadlineExceeded(
                    f"deadline exceeded at stage 'serve queue': tick "
                    f"({t.kind!r}, series {t.series!r}, ts {t.ts}) "
                    f"spent its {t.deadline.budget_s:.3f}s budget "
                    f"waiting for dispatch", stage="serve queue"))
                self.deadline_failures += 1
                self._on_dropped(t)
                woke.append(t)
                continue
            live.append(t)
        self._ring(woke)
        return live

    def _on_dropped(self, t: Ticket) -> None:
        """Hook: a ticket resolved before reaching a dispatch (deadline
        death).  CohortExecutor frees an abandoned breaker probe."""

    def _run(self):
        closing = False
        while not closing:
            item = self._q.get()
            if item is _CLOSE:
                break
            group: List[Ticket] = []
            self._extend(group, item)
            if self.coalesce_s > 0.0:
                deadline = time.monotonic() + self.coalesce_s
                while len(group) < self._COALESCE_MAX:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=rem)
                    except queue.Empty:
                        break
                    if nxt is _CLOSE:
                        closing = True
                        break
                    self._extend(group, nxt)
            if not closing:
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _CLOSE:
                        closing = True
                        break
                    self._extend(group, nxt)
            group = self._admit_live(group)
            # visible to the supervisor/shutdown sweep: anything not
            # finished when this group dies mid-processing gets failed
            # instead of hanging its caller
            self._inflight = group
            for batch in self._split(group):
                self._process(batch)
            self._inflight = []

    @staticmethod
    def _series_key(t: Ticket):
        return t.series

    def _split(self, group: List[Ticket]):
        """Side-homogeneous runs in arrival order, cut when any series
        (per stream, on cohort executors) reaches the per-batch row
        cap."""
        batch: List[Ticket] = []
        counts: Dict[object, int] = {}
        for t in group:
            key = self._series_key(t)
            if batch and (t.kind != batch[0].kind
                          or counts.get(key, 0) >= self.batch_rows):
                yield batch
                batch, counts = [], {}
            batch.append(t)
            counts[key] = counts.get(key, 0) + 1
        if batch:
            yield batch

    def _process(self, batch: List[Ticket]):
        kind = batch[0].kind
        try:
            # conversions live INSIDE the failure boundary: a bad
            # ts/seq/value payload poisons its own batch, not the
            # worker thread
            series = [t.series for t in batch]
            ts = np.array([t.ts for t in batch], np.int64)
            seq = None
            if any(t.seq is not None for t in batch):
                seq = np.array([np.nan if t.seq is None else t.seq
                                for t in batch], np.float64)
            if kind == "right":
                cols = self.stream.value_cols
                values = {c: np.array([t.values[c] for t in batch],
                                      np.float32) for c in cols}
                out = self.stream.push(series, ts, values, seq=seq)
            else:
                out = self.stream.push_left(series, ts, seq=seq)
        except Exception as e:       # delivered on each ticket's
            for t in batch:          # result(); the worker lives on
                t._finish(exc=e)
            return
        self.batches += 1
        self.ticks += len(batch)
        counts: Dict[object, int] = {}
        for t in batch:
            counts[t.series] = counts.get(t.series, 0) + 1
        b = stream_mod._bucket(max(counts.values()))
        self.bucket_hist[b] = self.bucket_hist.get(b, 0) + 1
        for i, t in enumerate(batch):
            t._finish(result={k: v[i] for k, v in out.items()})
            lat = t.latency_s
            if lat is not None:
                self._latencies[kind].append(lat)

    # -- metrics -------------------------------------------------------

    def latency_stats(self) -> Dict[str, dict]:
        """p50/p99 (milliseconds) + count per side, and pooled."""
        out = {}
        pooled: List[float] = []
        for kind, lats in self._latencies.items():
            pooled.extend(lats)
            out[kind] = latency_percentiles(lats)
        out["all"] = latency_percentiles(pooled)
        return out


class CohortExecutor(MicroBatchExecutor):
    """The fleet-serving front door: one executor, N member streams,
    ONE cohort dispatch per micro-batch.

    Same bounded-queue/backpressure/drain machinery as
    :class:`MicroBatchExecutor`, but tickets name a
    :class:`~tempo_tpu_torch.serve.cohort.CohortMember` and a coalesced run
    becomes one :meth:`~tempo_tpu_torch.serve.cohort.StreamCohort.dispatch`
    regardless of how many streams it spans — aggregate throughput is
    bounded by the step program, not by per-stream dispatch count.
    Accounting is **per ticket**: latency is each tick's own
    submit → completion interval (a 10k-stream dispatch contributes 10k
    samples, not one) over the bounded ``LATENCY_WINDOW``, and a
    rejected member's tickets fail individually while the rest of the
    dispatch completes (the cohort's per-stream isolation, surfaced
    per ticket)."""

    def __init__(self, cohort, queue_depth: Optional[int] = None,
                 batch_rows: Optional[int] = None,
                 coalesce_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None):
        if coalesce_s is None:
            # the env knob, else the built-in 2 ms; the reference then
            # asks its autotuner (tune.knob_value), which is not ported
            # yet (ROADMAP A14)
            coalesce_s = config.get_float("TEMPO_TPU_SERVE_COALESCE_S",
                                          0.002)
        super().__init__(cohort, queue_depth=queue_depth,
                         batch_rows=batch_rows, coalesce_s=coalesce_s)
        self.cohort = cohort
        #: per-stream-member circuit breaker: a member whose ticks keep
        #: failing is quarantined (fail-fast QuarantinedError tickets)
        #: until a half-open probe succeeds — one poisoned feed cannot
        #: burn the whole plane's retry budget
        self.breaker = breaker if breaker is not None else CircuitBreaker()

    def _quarantined(self, member, kind, series, ts, seq, values,
                     t_submit=None, gate=None) -> Optional[Ticket]:
        """A pre-resolved QuarantinedError ticket when ``member`` is
        quarantined (it never enters the queue); None when admitted."""
        try:
            self.breaker.allow(member.name, label="stream member")
        except QuarantinedError as e:
            t = Ticket(kind, series, ts, seq, values, member=member,
                       t_submit=t_submit, gate=gate)
            t._finish(exc=e)
            return t
        return None

    def submit(self, member, kind: str, series, ts, values=None,
               seq=None, timeout: Optional[float] = None,
               deadline=None) -> Ticket:
        """Enqueue one tick for ``member`` (``kind`` 'right' = data,
        'left' = query); blocks on a full queue (backpressure).
        ``deadline`` as on :meth:`MicroBatchExecutor.submit`; a
        quarantined member's ticket resolves immediately with
        ``QuarantinedError`` and never reaches the queue."""
        if kind not in ("right", "left"):
            raise ValueError(f"kind must be 'right' or 'left', got "
                             f"{kind!r}")
        bad = self._quarantined(member, kind, series, ts, seq, values)
        if bad is not None:
            return bad
        dl = self._deadline(deadline)
        t = Ticket(kind, series, ts, seq, values, member=member,
                   deadline=dl)
        try:
            self._put(t, timeout, dl)
        except BaseException:
            # the failed enqueue may have been the member's half-open
            # probe: free the slot or the member quarantines forever
            self.breaker.abandon(member.name)
            raise
        return t

    def submit_many(self, ticks, timeout: Optional[float] = None,
                    deadline=None) -> List[Ticket]:
        """Bulk enqueue: ``ticks`` is ``[(kind, member, series, ts,
        values, seq)]`` in arrival order (``values`` None for
        queries; kinds may mix — the worker's member-order-preserving
        split sorts it out).  ONE queue entry and one shared submit
        stamp for the whole chunk — the fleet feeder's path: at
        10k-stream rates, per-tick ``submit()`` overhead (a lock round
        and a queue put per tick) costs more than the whole
        dispatch-side share.  Results, failures and latency stay per
        ticket; a chunk counts as one entry toward the queue bound.
        One shared ``deadline`` covers the chunk; quarantined members'
        tickets resolve immediately with ``QuarantinedError`` while
        the rest of the chunk proceeds."""
        t0 = time.perf_counter()
        gate = _ChunkGate()
        dl = self._deadline(deadline)
        chunk, out = [], []
        for kind, member, series, ts, values, seq in ticks:
            if kind not in ("right", "left"):
                raise ValueError(f"kind must be 'right' or 'left', "
                                 f"got {kind!r}")
            bad = self._quarantined(member, kind, series, ts, seq,
                                    values, t_submit=t0)
            if bad is not None:
                out.append(bad)
                continue
            t = Ticket(kind, series, ts, seq, values, member=member,
                       t_submit=t0, gate=gate, deadline=dl)
            chunk.append(t)
            out.append(t)
        if chunk:
            try:
                self._put(chunk, timeout, dl)
            except BaseException:
                # any of the chunk's members may have been probing;
                # abandon() is a no-op for the rest
                for t in chunk:
                    self.breaker.abandon(t.member.name)
                raise
        return out

    def submit_block(self, kinds, members, series_ids, ts, values=None,
                     seq=None, timeout: Optional[float] = None,
                     deadline=None) -> BlockTicket:
        """Enqueue a columnar tick block: parallel arrays instead of a
        per-tick item list, ONE queue entry, ONE waitable
        :class:`BlockTicket`, dispatched through
        :meth:`~tempo_tpu_torch.serve.cohort.StreamCohort.dispatch_block` —
        at most one device program per side for the single-tick-
        per-(member, series) majority, no per-tick python on either
        side of the queue.  Arguments mirror ``dispatch_block``
        (``kinds`` a side string or per-tick array; ``series_ids``
        scalar or per-tick; ``values`` columnar).  A block is a
        BARRIER in the worker's split: per-tick tickets queued before
        it dispatch before it and vice versa, so mixing
        ``submit``/``submit_many`` with blocks preserves every
        member's arrival order.  Quarantined members are checked at
        dispatch time (their ticks land in :attr:`BlockTicket.errors`
        as ``QuarantinedError`` while the rest of the block proceeds);
        ``deadline`` covers the whole block exactly like a per-tick
        ticket's."""
        if isinstance(kinds, str) and kinds not in ("right", "left"):
            raise ValueError(f"kinds must be 'right' or 'left', got "
                             f"{kinds!r}")
        dl = self._deadline(deadline)
        bt = BlockTicket(kinds, list(members), series_ids,
                         np.asarray(ts, np.int64), seq, values,
                         deadline=dl)
        self._put(bt, timeout, dl)
        return bt

    @staticmethod
    def _series_key(t: Ticket):
        return (id(t.member), t.series)

    def _split(self, group: List[Ticket]):
        """Block tickets are barriers: per-tick runs split on either
        side of each block (``_split_ticks``), the block itself is
        yielded whole — relative order of a member's per-tick and
        block traffic is preserved."""
        run: List[Ticket] = []
        for t in group:
            if isinstance(t, BlockTicket):
                if run:
                    yield from self._split_ticks(run)
                    run = []
                yield t
            else:
                run.append(t)
        if run:
            yield from self._split_ticks(run)

    def _split_ticks(self, group: List[Ticket]):
        """Cohort-aware micro-batching: member streams are independent
        merged streams, so ticks of DIFFERENT members may legally
        reorder around each other — only each member's own order is a
        contract.  Each tick lands in the earliest side-matching batch
        at or after its member's last batch (capped at ``batch_rows``
        rows per (member, series)), so a side-alternating tick mix
        collapses to ~one batch per side instead of a dispatch per
        side flip (which would pay the whole-cohort step cost for a
        handful of ticks).  Yields ``(tickets, max_rows)``."""
        batches: List[list] = []      # [kind, tickets, counts, max]
        last_idx: Dict[int, int] = {}
        cap = self.batch_rows
        for t in group:
            mid = id(t.member)
            key = (mid, t.series)
            placed = -1
            for bi in range(last_idx.get(mid, 0), len(batches)):
                b = batches[bi]
                if b[0] == t.kind and b[2].get(key, 0) < cap:
                    placed = bi
                    break
            if placed < 0:
                batches.append([t.kind, [t], {key: 1}, 1])
                placed = len(batches) - 1
            else:
                b = batches[placed]
                b[1].append(t)
                c = b[2].get(key, 0) + 1
                b[2][key] = c
                if c > b[3]:
                    b[3] = c
            last_idx[mid] = placed
        for b in batches:
            yield b[1], b[3]

    def _on_dropped(self, t: Ticket) -> None:
        # a deadline-dead ticket may have been the member's half-open
        # probe; free the probe slot so the member is not quarantined
        # forever by an outcome that will never arrive
        if t.member is not None:
            self.breaker.abandon(t.member.name)

    def _process(self, batch):
        if isinstance(batch, BlockTicket):
            return self._process_block(batch)
        batch, max_rows = batch
        kind = batch[0].kind
        try:
            items = [(t.member, t.series, t.ts, t.seq, t.values)
                     for t in batch]
            results = self.cohort.dispatch(kind, items)
        except Exception as e:       # dispatch-level failure: delivered
            for t in batch:          # per ticket, worker lives on
                t._finish(exc=e)
                self.breaker.record(t.member.name, ok=False)
            self._ring(batch)
            return
        self.batches += 1
        lats = self._latencies[kind]
        ok = 0
        for t, r in zip(batch, results):
            if isinstance(r, Exception):
                t._finish(exc=r)
                self.breaker.record(t.member.name, ok=False)
                continue
            t._finish(result=r)
            self.breaker.record(t.member.name, ok=True)
            ok += 1
            lats.append(t.t_done - t.t_submit)
        self.ticks += ok
        self._ring(batch)
        b = stream_mod._bucket(max_rows)
        self.bucket_hist[b] = self.bucket_hist.get(b, 0) + 1

    def _process_block(self, bt: BlockTicket):
        """One block ticket -> one ``dispatch_block``.  Breaker
        integration is sized for block rates: the quarantine pre-pass
        only runs when the breaker has EVER tripped (``trips`` never
        decrements, so a healthy fleet pays one integer check per
        block, not a lock round per tick), and successes are recorded
        only for members the breaker already tracks — ``record(ok)``
        setdefaults an entry per key, so blanket per-tick success
        recording would both grow the state dict by fleet size and
        take the breaker lock per tick."""
        members = bt.members
        kinds, series_ids = bt.kinds, bt.series_ids
        tsv, seqv, values = bt.tsv, bt.seqv, bt.values
        n_full = len(members)
        pre: Dict[int, Exception] = {}
        keep = None
        if self.breaker.trips:
            qexc: Dict[str, Exception] = {}
            with self.breaker._lock:
                open_names = {k for k, st in self.breaker._st.items()
                              if st[1] is not None}
            for name in ({m.name for m in members} & open_names):
                try:
                    self.breaker.allow(name, label="stream member")
                except QuarantinedError as e:
                    qexc[name] = e
            if qexc:
                keep = [i for i in range(n_full)
                        if members[i].name not in qexc]
                for i in range(n_full):
                    e = qexc.get(members[i].name)
                    if e is not None:
                        pre[i] = e
                ki = np.asarray(keep, np.intp)
                members = [members[i] for i in keep]
                if not isinstance(kinds, str):
                    kinds = np.asarray(kinds)[ki]
                if isinstance(series_ids, (list, tuple, np.ndarray)):
                    series_ids = [series_ids[i] for i in keep]
                tsv = np.asarray(tsv)[ki]
                if seqv is not None:
                    seqv = np.asarray(seqv)[ki]
                if values is not None:
                    values = {c: np.asarray(v)[ki]
                              for c, v in values.items()}
        try:
            out, errors = self.cohort.dispatch_block(
                kinds, members, series_ids, tsv, seq=seqv,
                values=values)
        except Exception as e:       # block-level failure: one result
            for m in members:
                self.breaker.record(m.name, ok=False)
            bt._errors = pre
            bt._finish(exc=e)
            self._ring([bt])
            return
        if keep is not None:
            # remap the kept-subset columns/errors back to full-length
            # block indices; quarantined rows keep their fill values
            errors = {keep[j]: e for j, e in errors.items()}
            full = {}
            for name, col in out.items():
                self.cohort._out_col(full, name, n_full)[
                    np.asarray(keep, np.intp)] = col
            out = full
        merged = dict(pre)
        merged.update(errors)
        for i, e in errors.items():
            self.breaker.record(bt.members[i].name, ok=False)
        if self.breaker._st:
            with self.breaker._lock:
                hot = {k for k, st in self.breaker._st.items()
                       if st[0] or st[1] is not None}
            if hot:
                for i, m in enumerate(bt.members):
                    if m.name in hot and i not in merged:
                        self.breaker.record(m.name, ok=True)
        bt._errors = merged
        bt._finish(result=out)
        self._ring([bt])
        self.batches += 1
        nok = n_full - len(merged)
        self.ticks += nok
        lat = bt.t_done - bt.t_submit
        if isinstance(bt.kinds, str):
            n_left = nok if bt.kinds == "left" else 0
        else:
            ka = np.asarray(bt.kinds)
            is_left = (ka == "left") if ka.dtype.kind in "UO" \
                else ka.astype(bool)
            ok_mask = np.ones(n_full, bool)
            for i in merged:
                ok_mask[i] = False
            n_left = int((is_left & ok_mask).sum())
        for side, cnt in (("right", nok - n_left), ("left", n_left)):
            if cnt:
                self._latencies[side].extend(
                    [lat] * min(cnt, LATENCY_WINDOW))
        b = stream_mod._bucket(max(1, nok))
        self.bucket_hist[b] = self.bucket_hist.get(b, 0) + 1

    # -- failover ------------------------------------------------------

    @classmethod
    def resume(cls, checkpoint_dir: str, *, verify: bool = True,
               mesh=None, stream_axis: str = "streams",
               queue_depth: Optional[int] = None,
               batch_rows: Optional[int] = None,
               coalesce_s: Optional[float] = None,
               breaker: Optional[CircuitBreaker] = None,
               **overrides) -> "CohortExecutor":
        """Failover in one call: restore the newest intact cohort
        snapshot (full or differential chain —
        :meth:`~tempo_tpu_torch.serve.cohort.StreamCohort.resume`) and stand
        a fresh executor over it.  The resumed cohort's per-stream
        ``acked`` cursors tell each event source where to restart;
        replay the unacked tails through :meth:`submit_many` and the
        emissions are byte-identical to a plane that never died."""
        from tempo_tpu_torch.serve.cohort import StreamCohort

        cohort = StreamCohort.resume(checkpoint_dir, verify=verify,
                                     mesh=mesh, stream_axis=stream_axis,
                                     **overrides)
        return cls(cohort, queue_depth=queue_depth,
                   batch_rows=batch_rows, coalesce_s=coalesce_s,
                   breaker=breaker)
