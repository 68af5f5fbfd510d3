"""Async micro-batch executor: the serving front door of one stream.

Counterpart of ``tempo_tpu/serve/executor.py`` up to
``MicroBatchExecutor``.  ``BlockTicket``, ``CohortExecutor`` and what
only they use (``submit_many``'s shared completion gate, the coalescing
window, the cohort member on a ticket) wait for the cohort engine,
ROADMAP A12b.

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
from tempo_tpu_torch.resilience import (Cancelled, Deadline,
                                        DeadlineExceeded, ShutdownError)
from tempo_tpu_torch.serve import stream as stream_mod

logger = logging.getLogger(__name__)

_CLOSE = object()

#: bounded percentile-sample window of the queue-side latency reports:
#: the most recent window of ticks, so a long-lived server never grows a
#: float per tick served forever.
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


class Ticket:
    """One submitted tick: a waitable handle for its per-row result."""

    __slots__ = ("kind", "series", "ts", "seq", "values", "deadline",
                 "t_submit", "t_done", "_event", "_done", "_cancelled",
                 "_result", "_exc")

    def __init__(self, kind, series, ts, seq, values,
                 deadline: Optional[Deadline] = None):
        self.kind = kind
        self.series = series
        self.ts = ts
        self.seq = seq
        self.values = values
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self.t_done = None
        self._event = threading.Event()
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
        self._event.set()

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
        if not self._done and not self._event.wait(timeout):
            raise TimeoutError("tick not processed yet")
        if self._exc is not None:
            raise self._exc
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class MicroBatchExecutor:
    """See module docstring.  While an executor is attached, all
    traffic must go through it (``StreamingTSDF`` itself is
    single-writer)."""

    def __init__(self, stream, queue_depth: Optional[int] = None,
                 batch_rows: Optional[int] = None):
        if queue_depth is None:
            queue_depth = config.get_int("TEMPO_TPU_SERVE_QUEUE_DEPTH",
                                         1024)
        if batch_rows is None:
            # the env knob, else the built-in 64 (the reference's
            # autotuner, which may pick another default, is not ported)
            batch_rows = config.get_int("TEMPO_TPU_SERVE_BATCH_ROWS", 64)
        self.stream = stream
        self.batch_rows = max(1, int(batch_rows))
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
            if item is not _CLOSE:
                item._finish(exc=exc)
        for t in list(self._inflight):
            t._finish(exc=exc)
        if drained and self._thread.is_alive():
            self._q.put(_CLOSE)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- worker side ---------------------------------------------------

    def _supervise(self):  # owns-tickets: _finish, _fail_pending
        """The drain thread's supervisor: an unexpected ``Exception``
        escaping the worker loop (poisoned work already fails inside
        its own batch — this catches plane-level faults) fails the
        in-flight group, restarts the drain, and the executor keeps
        serving.  A ``BaseException`` (``SimulatedKill`` — modelled
        process death, real interpreter teardown) is NOT survivable:
        the plane closes itself, every outstanding ticket resolves
        with :class:`ShutdownError`, and the thread exits.  A stream on
        a card makes its card the thread's current device before the
        first replay."""
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
        for t in group:
            if t._done:
                continue
            if t._cancelled:
                t._finish(exc=Cancelled(
                    f"tick ({t.kind!r}, series {t.series!r}, ts "
                    f"{t.ts}) cancelled before dispatch"))
                continue
            if t.deadline is not None and t.deadline.expired():
                t._finish(exc=DeadlineExceeded(
                    f"deadline exceeded at stage 'serve queue': tick "
                    f"({t.kind!r}, series {t.series!r}, ts {t.ts}) "
                    f"spent its {t.deadline.budget_s:.3f}s budget "
                    f"waiting for dispatch", stage="serve queue"))
                self.deadline_failures += 1
                continue
            live.append(t)
        return live

    def _run(self):
        closing = False
        while not closing:
            item = self._q.get()
            if item is _CLOSE:
                break
            group: List[Ticket] = [item]
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    closing = True
                    break
                group.append(nxt)
            group = self._admit_live(group)
            # visible to the supervisor/shutdown sweep: anything not
            # finished when this group dies mid-processing gets failed
            # instead of hanging its caller
            self._inflight = group
            for batch in self._split(group):
                self._process(batch)
            self._inflight = []

    def _split(self, group: List[Ticket]):
        """Side-homogeneous runs in arrival order, cut when any series
        reaches the per-batch row cap."""
        batch: List[Ticket] = []
        counts: Dict[object, int] = {}
        for t in group:
            if batch and (t.kind != batch[0].kind
                          or counts.get(t.series, 0) >= self.batch_rows):
                yield batch
                batch, counts = [], {}
            batch.append(t)
            counts[t.series] = counts.get(t.series, 0) + 1
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

