"""Multi-tenant query service: N concurrent clients, one shared
planner.

Counterpart of ``tempo_tpu/service/service.py``.  ``QueryService`` is
the front door of "many analysts, one engine": clients submit
plan-signature-keyed queries (lazy chains: :func:`lazy_frame` wraps any
eager frame without the ``TEMPO_TPU_PLAN`` knob), a bounded worker pool
executes them through the shared executable cache (``plan/cache.py``,
single-flight, so two tenants building the same signature build once,
and a cached executable replays its captured CUDA graphs), and two
policies sit between submit and dispatch:

* **admission control** (``service/admission.py``): a query whose
  projected footprint (shared memory a block, device memory) could never
  fit the declared budgets is rejected with
  :class:`~tempo_tpu_torch.service.admission.AdmissionError` at submit;
  one that merely exceeds the currently free device-memory share stays
  queued and dispatches when running queries release theirs.
* **fair scheduling**: per-tenant token accounting over the
  bounded-queue backpressure pattern of ``serve/executor.py``: each
  dispatch charges the tenant a token, the scheduler always offers the
  lowest-token tenant first, and a tenant at
  ``TEMPO_TPU_SERVICE_TENANT_QUOTA`` pending queries blocks in
  ``submit()`` instead of flooding the shared queue.

A poisoned query (its execution raises) fails its own ticket and
releases its budget; the workers live on.  ``stats()`` reports
per-tenant submitted/completed/failed/rejected counts, p50/p99
latency, the cache's per-tenant traffic, and the max/min
completed-query ratio (the starvation audit).

Several workers may build and capture new signatures while others
replay: ``plan/fused.capture`` captures in ``"thread_local"`` mode under
one process-wide capture lock, so another thread's launches,
allocations and synchronisations never invalidate a capture, and a
failed capture raises on its own ticket (nothing falls back to eager).

**The fault domain** (resilience.py primitives):

* *deadlines* — ``submit(..., deadline_s=...)`` (default
  ``TEMPO_TPU_SERVICE_DEADLINE_S``) carries ONE
  :class:`~tempo_tpu_torch.resilience.Deadline` through the tenant-quota
  wait, the admission queue and dispatch; whichever stage the budget
  dies at raises/fails with a stage-named ``DeadlineExceeded``.
* *cancellation* — ``QueryTicket.cancel()`` removes a still-queued
  query, frees its quota slot, and resolves the ticket with
  :class:`~tempo_tpu_torch.resilience.Cancelled`; it never reaches a worker
  and never acquires budget.
* *quarantine* — a per-plan-signature
  :class:`~tempo_tpu_torch.resilience.CircuitBreaker`: a signature failing
  ``TEMPO_TPU_BREAKER_THRESHOLD`` consecutive times is refused at
  submit with ``QuarantinedError`` until a half-open probe (after
  ``TEMPO_TPU_BREAKER_COOLDOWN_S``) succeeds — a poison-pill query
  cannot burn every worker's time forever.
* *supervision* — worker threads run under a supervisor: an exception
  escaping the scheduler loop (not a query's own failure — those are
  already per-ticket) logs, counts on ``restarts`` and restarts the
  worker, so the plane survives its own bugs and injected faults.
"""

from __future__ import annotations

import collections
import logging
import queue as queue_mod
import threading
import time
from typing import Dict, Optional

from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import ir
from tempo_tpu_torch.resilience import (Cancelled, CircuitBreaker, Deadline,
                                  DeadlineExceeded)
from tempo_tpu_torch.serve.executor import LATENCY_WINDOW
from tempo_tpu_torch.service.admission import (AdmissionController,
                                         Footprint, project_footprint)

logger = logging.getLogger(__name__)


def lazy_frame(frame):
    """Wrap an eager ``TSDF`` / ``DistributedTSDF`` into its lazy
    recording wrapper WITHOUT the ``TEMPO_TPU_PLAN`` knob: service
    clients chain ops on the result and submit it — the service is
    always plan-driven, whatever the process-wide planning mode."""
    from tempo_tpu_torch.plan import lazy

    return lazy.wrap(lazy._as_node(frame))


class QueryTicket:
    """One submitted query: a waitable handle for its result."""

    __slots__ = ("tenant", "signature", "footprint", "deadline",
                 "_service", "t_submit", "t_blocked", "t_start",
                 "t_done", "_root", "_event", "_result", "_exc")

    def __init__(self, tenant: str, root: ir.Node, signature: str,
                 footprint: Footprint,
                 deadline: Optional[Deadline] = None, service=None):
        self.tenant = tenant
        self.signature = signature
        self.footprint = footprint
        self.deadline = deadline
        self._service = service
        self.t_submit = time.perf_counter()
        #: when this query, AT THE HEAD of its tenant's queue, first
        #: failed ``fits_now()`` — the budget-reservation clock (time
        #: spent behind the tenant's own earlier queries is not
        #: starvation and must not trigger a service-wide reserve)
        self.t_blocked: Optional[float] = None
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self._root = root
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def _finish(self, result=None, exc: Optional[BaseException] = None):
        self._result, self._exc = result, exc
        self.t_done = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Cancel this query if it is still queued: it is removed from
        its tenant's queue (freeing the quota slot), never reaches a
        worker, never acquires budget, and ``result()`` raises
        :class:`~tempo_tpu_torch.resilience.Cancelled`.  Returns ``False``
        once the query has been dispatched or resolved."""
        if self._service is None:
            return False
        return self._service._cancel(self)

    def result(self, timeout: Optional[float] = None):
        """The query's result frame (blocks until dispatched and
        executed); re-raises the query's own failure."""
        if not self._event.wait(timeout):
            raise TimeoutError("query not executed yet")
        if self._exc is not None:
            raise self._exc
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class QueryService:
    """See module docstring."""

    #: per-tenant latency samples kept for the percentile report (a
    #: sliding window, not a lifetime log) — the serving executors'
    #: shared bound (serve/executor.py:LATENCY_WINDOW), so every
    #: queue-side percentile in the system is over the same window
    _LATENCY_WINDOW = LATENCY_WINDOW

    def __init__(self, workers: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 hbm_budget: Optional[int] = None,
                 vmem_budget: Optional[int] = None,
                 reserve_after_s: float = 5.0,
                 deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None):
        from tempo_tpu_torch import config

        if workers is None:
            workers = config.get_int("TEMPO_TPU_SERVICE_WORKERS", 4)
        if tenant_quota is None:
            tenant_quota = config.get_int(
                "TEMPO_TPU_SERVICE_TENANT_QUOTA", 64)
        if deadline_s is None:
            deadline_s = config.get_float("TEMPO_TPU_SERVICE_DEADLINE_S")
        #: default end-to-end budget for submitted queries (None = no
        #: deadline unless the submit passes one)
        self.deadline_s = deadline_s
        #: per-plan-signature circuit breaker: repeat-failing
        #: signatures are refused at submit with QuarantinedError
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        #: supervised worker restarts (an exception escaping the
        #: scheduler loop, NOT a query's own failure)
        self.restarts = 0  # guarded-by: self._cond
        self.tenant_quota = max(1, int(tenant_quota))
        #: budget reservation threshold: once a head-of-queue query has
        #: sat unfitting this long, the scheduler stops handing the
        #: freed HBM share to smaller queries until the starved one
        #: fits — without it, a sustained small-query stream could keep
        #: ``hbm_in_use`` high forever and a large admitted query would
        #: never dispatch (admission only rejects what can NEVER fit)
        self.reserve_after_s = float(reserve_after_s)
        self.admission = AdmissionController(hbm_budget, vmem_budget)
        #: per-worker-thread picked-but-unaccounted ticket (supervisor
        #: fails + releases it if the loop dies mid-query)
        self._running: Dict[int, QueryTicket] = {}
        self._cond = threading.Condition()
        self._queues: Dict[str, collections.deque] = {}  # guarded-by: self._cond
        self._tokens: Dict[str, int] = {}  # guarded-by: self._cond
        self._counts: Dict[str, Dict[str, int]] = {}  # guarded-by: self._cond
        self._latencies: Dict[str, "collections.deque"] = {}  # guarded-by: self._cond
        self._closed = False  # guarded-by: self._cond
        self._standing_engine = None  # guarded-by: self._cond
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"tempo-query-service-{i}")
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    # -- client side ---------------------------------------------------

    def _count(self, tenant: str, field: str, by: int = 1) -> None:  # guarded-by: self._cond
        c = self._counts.setdefault(tenant, {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "cancelled": 0, "quarantined": 0})
        c[field] += by

    @staticmethod
    def _as_root(query) -> ir.Node:
        from tempo_tpu_torch.plan import lazy

        if isinstance(query, ir.Node):
            return query
        if isinstance(query, lazy.LazyDistributedTSDF):
            # mesh chains materialise through their collect barrier,
            # exactly like the lazy terminal does
            return ir.Node("collect", inputs=(query.plan,))
        if isinstance(query, lazy._LazyBase):
            return query.plan
        raise TypeError(
            f"submit() takes a lazy chain (service.lazy_frame(frame)"
            f".op()...) or a plan node, got {type(query).__name__}")

    def submit(self, tenant: str, query,
               timeout: Optional[float] = None,
               deadline_s=None) -> QueryTicket:
        """Enqueue one query for ``tenant``.  Raises
        :class:`AdmissionError` when the projected footprint could
        never fit the budgets, and
        :class:`~tempo_tpu_torch.resilience.QuarantinedError` when the plan
        signature's circuit breaker is open (repeat poison pill —
        fail-fast until a half-open probe succeeds); blocks while the
        tenant is at quota (per-tenant backpressure — ``queue.Full``
        after ``timeout``).  ``deadline_s`` (seconds or a
        :class:`Deadline`; default ``TEMPO_TPU_SERVICE_DEADLINE_S``)
        is carried end to end: expiry during the quota wait raises —
        and later, in the admission queue or at dispatch, fails the
        ticket — with a stage-named ``DeadlineExceeded``."""
        root = self._as_root(query)
        footprint = project_footprint(root)
        sig = ir.signature(root)
        dl = Deadline.after(self.deadline_s if deadline_s is None
                            else deadline_s)
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._cond:
            if self._closed:
                raise RuntimeError("query service is closed")
            try:
                self.admission.check(footprint)
            except Exception:
                self._count(tenant, "submitted")
                self._count(tenant, "rejected")
                raise
            try:
                self.breaker.allow(sig, label="plan signature")
            except Exception:
                self._count(tenant, "submitted")
                self._count(tenant, "quarantined")
                raise
            try:
                ticket = self._enqueue_locked(tenant, root, sig,
                                              footprint, dl, deadline)
            except BaseException:
                # this admission may have been the signature's
                # half-open probe; a failed ENQUEUE (quota Full,
                # deadline, close) reports no outcome — free the probe
                # slot or the signature quarantines forever
                self.breaker.abandon(sig)
                raise
        return ticket

    def submit_sql(self, tenant: str, text: str, tables,
                   timeout: Optional[float] = None,
                   deadline_s=None) -> QueryTicket:
        """Submit one SQL statement: ``text`` compiles through the plan
        IR (plan/sql_compile.py — projections, ``ASOF JOIN``,
        ``WHERE``, ``GROUP BY time_bucket``) over the registered
        ``tables`` ({name: TSDF | DistributedTSDF | lazy}), then flows
        through the SAME admission / fairness / dispatch path as a
        lazy-chain submission — so text queries hit the executable
        cache and the sharded dispatch tiers exactly like method
        chains.  The compiled root carries ``_origin='sql'``: its plan
        signature (the quota, breaker and cache identity) is distinct
        from the equivalent method chain's.  ``sql.SqlError`` raises
        here, before anything is enqueued."""
        from tempo_tpu_torch.plan import optimizer, sql_compile

        root = sql_compile.compile_statement(text, tables)
        if optimizer._mesh_side(root):
            root = ir.Node("collect", inputs=(root,))
        return self.submit(tenant, root, timeout=timeout,
                           deadline_s=deadline_s)

    # -- standing queries ----------------------------------------------

    def _standing(self):
        """The service's standing-query engine, created on first
        ``register`` (one engine shared by every tenant — subscriptions
        on the same serving config share one warmed cohort
        plane)."""
        from tempo_tpu_torch.query.standing import StandingQueryEngine

        with self._cond:
            if self._closed:
                raise RuntimeError("query service is closed")
            if self._standing_engine is None:
                self._standing_engine = StandingQueryEngine()
            return self._standing_engine

    def register(self, tenant: str, query):
        """Register a planned method chain over
        :class:`~tempo_tpu_torch.query.unified.StreamTable` frames as a
        **standing query**: where :meth:`submit` answers once,
        ``register`` answers forever — every
        :meth:`~tempo_tpu_torch.query.standing.StandingQueryEngine.push`
        fans out to the returned
        :class:`~tempo_tpu_torch.query.standing.Subscription` as an
        incremental delta, bitwise what re-running the batch query over
        the concatenated history produces.  Counted under the tenant
        like a submission."""
        eng = self._standing()
        sub = eng.register(query)
        with self._cond:
            self._count(tenant, "submitted")
            self._count(tenant, "completed")
        return sub

    def register_sql(self, tenant: str, text: str, tables):
        """Standing twin of :meth:`submit_sql`: compile one SQL
        statement over ``tables`` ({name: StreamTable | TSDF | lazy})
        and register it as a standing query — StreamTable entries enter
        the plan as ``unified_scan`` sources, so the statement answers
        over history + live under one watermark."""
        eng = self._standing()
        sub = eng.register_sql(text, tables)
        with self._cond:
            self._count(tenant, "submitted")
            self._count(tenant, "completed")
        return sub

    def push(self, table, df, *, deadline_s=None):
        """Admit one batch of events for ``table`` and fan it out to
        every standing subscription registered through this service
        (see :meth:`~tempo_tpu_torch.query.standing.StandingQueryEngine.push`)."""
        return self._standing().push(table, df, deadline=deadline_s)

    def _enqueue_locked(self, tenant, root, sig, footprint, dl,
                        deadline) -> QueryTicket:  # guarded-by: self._cond
        """The quota-wait + append half of submit (under the
        scheduler condition)."""
        q = self._queues.setdefault(tenant, collections.deque())
        if tenant not in self._tokens:
            # new (or returning) tenants join at the FLOOR of the
            # live token counts, not 0: starting from zero would
            # hand a newcomer absolute priority until it caught up
            # with tenants that have been served for hours —
            # starving them, the inverse of the fairness contract
            self._tokens[tenant] = min(self._tokens.values(),
                                       default=0)
        # standard condition-variable shape: re-check the predicate
        # after EVERY wake (a timed-out wait may still have had the
        # queue drained just before the deadline — Full only when
        # the quota is genuinely still exhausted past it)
        while len(q) >= self.tenant_quota:
            if dl is not None:
                # the end-to-end budget dies HERE by name, not as
                # an anonymous queue.Full
                dl.check("tenant quota")
            remaining = None if deadline is None else \
                deadline - time.perf_counter()
            if dl is not None:
                rem_dl = dl.remaining()
                remaining = rem_dl if remaining is None \
                    else min(remaining, rem_dl)
            if remaining is not None and remaining <= 0:
                raise queue_mod.Full(
                    f"tenant {tenant!r} is at its pending-query "
                    f"quota ({self.tenant_quota})")
            self._cond.wait(remaining)
            if self._closed:
                raise RuntimeError("query service is closed")
            # the scheduler PRUNES a deque it drains
            # (_dispatch_locked), so the reference captured above
            # may be orphaned by now — re-resolve the live deque
            # before re-checking the predicate, or the append below
            # would land in a deque _pick never scans and silently
            # lose the query
            q = self._queues.setdefault(tenant, q)
        ticket = QueryTicket(tenant, root, sig, footprint,
                             deadline=dl, service=self)
        q.append(ticket)
        self._count(tenant, "submitted")
        self._cond.notify_all()
        return ticket

    def _cancel(self, ticket: QueryTicket) -> bool:
        """Remove a still-queued ticket (QueryTicket.cancel's body):
        frees its quota slot, resolves it with :class:`Cancelled`; a
        dispatched/resolved ticket is not cancellable."""
        with self._cond:
            q = self._queues.get(ticket.tenant)
            if ticket.done() or q is None or ticket not in q:
                return False
            q.remove(ticket)
            if not q:
                del self._queues[ticket.tenant]
            ticket._finish(exc=Cancelled(
                f"query {ticket.signature[:16]}... for tenant "
                f"{ticket.tenant!r} cancelled before dispatch"))
            self._count(ticket.tenant, "cancelled")
            self._cond.notify_all()     # a quota slot freed
        # a cancelled query reports no outcome: free a possible
        # half-open probe slot for its signature
        self.breaker.abandon(ticket.signature)
        return True

    # -- scheduler/worker side ------------------------------------------

    def _dispatch_locked(self, tenant: str) -> QueryTicket:  # guarded-by: self._cond
        ticket = self._queues[tenant].popleft()
        if not self._queues[tenant]:
            # prune drained queues so _pick's sort scans tenants with
            # PENDING work, not every tenant ever seen (tokens/counts
            # persist — they are per-tenant-cardinality, not per-query).
            # Safe against submitters blocked at quota: they re-resolve
            # the live deque after every wake (see submit()), so a
            # pruned reference is never appended into
            del self._queues[tenant]
        self._tokens[tenant] = self._tokens.get(tenant, 0) + 1
        self.admission.acquire(ticket.footprint)
        return ticket

    def _pick(self) -> Optional[QueryTicket]:  # guarded-by: self._cond
        """Next dispatchable ticket under the scheduler lock: tenants
        offered in token order (fewest dispatches first — the fairness
        accounting), first whose head query fits the free HBM share.
        None = nothing dispatchable right now.

        **Budget reservation**: a head that does not fit is only
        *transiently* blocked (admission rejected everything that can
        NEVER fit), but a sustained stream of smaller queries could
        re-consume every freed byte and block it forever.  Once the
        oldest unfitting head has waited ``reserve_after_s``, nothing
        else dispatches until it fits — running queries drain,
        ``hbm_in_use`` falls, and at worst an empty budget admits it.
        The clock starts when the query FIRST fails ``fits_now()`` as
        its tenant's head (``t_blocked``), not at submit: time queued
        behind the same tenant's earlier queries is ordinary waiting,
        and triggering off it would stall the whole service for a query
        that was never budget-starved."""
        self._expire_locked()
        now = time.perf_counter()
        tenants = sorted(
            (t for t, q in self._queues.items() if q),
            key=lambda t: (self._tokens.get(t, 0), t))
        starved: Optional[tuple] = None
        for t in tenants:
            head = self._queues[t][0]
            if not self.admission.fits_now(head.footprint):
                if head.t_blocked is None:
                    head.t_blocked = now
                if starved is None \
                        or head.t_blocked < starved[1].t_blocked:
                    starved = (t, head)
        if starved is not None and (
                now - starved[1].t_blocked >= self.reserve_after_s):
            if self.admission.fits_now(starved[1].footprint):
                return self._dispatch_locked(starved[0])
            return None                      # budget reserved: drain
        for t in tenants:
            if self.admission.fits_now(self._queues[t][0].footprint):
                return self._dispatch_locked(t)
        return None

    def _expire_locked(self) -> None:  # guarded-by: self._cond
        """Fail every queued ticket whose deadline died waiting for
        admission (stage-named) — under the scheduler lock.  Expired
        work must resolve NOW, not when it happens to reach its
        tenant's head."""
        for tenant in list(self._queues):
            q = self._queues[tenant]
            dead = [t for t in q
                    if t.deadline is not None and t.deadline.expired()]
            if not dead:
                continue
            for t in dead:
                q.remove(t)
                t._finish(exc=DeadlineExceeded(
                    f"deadline exceeded at stage 'admission queue': "
                    f"query for tenant {tenant!r} spent its "
                    f"{t.deadline.budget_s:.3f}s budget waiting for "
                    f"budget/workers", stage="admission queue"))
                self._count(tenant, "failed")
                self.breaker.abandon(t.signature)   # vanished probe
            if not q:
                del self._queues[tenant]
            self._cond.notify_all()     # quota slots freed

    def _worker(self) -> None:  # owns-tickets: _finish
        """Supervised scheduler/executor loop: a query's own failure is
        delivered on its ticket (the inner try); an exception escaping
        the LOOP itself (scheduler bug, injected plane fault) restarts
        the worker — the plane outlives it.  A ticket this worker had
        already PICKED when the loop died is failed and its budget
        released here (it would otherwise hang its caller and leak
        admission capacity forever)."""
        tid = threading.get_ident()
        while True:
            try:
                self._worker_loop(tid)
                return                       # clean close
            except Exception as e:  # noqa: BLE001 - supervised restart
                # _running is keyed by thread ident: each worker only
                # ever touches its OWN slot, and dict item ops are
                # atomic under the GIL — taking the scheduler condition
                # here would drag it into the dispatch hot path
                ticket = self._running.pop(tid, None)  # lint-ok: guarded-attr: per-thread-ident slot, GIL-atomic dict item ops
                if ticket is not None and not ticket.done():
                    ticket._finish(exc=e)
                    self.breaker.abandon(ticket.signature)
                    with self._cond:
                        self.admission.release(ticket.footprint)
                        self._count(ticket.tenant, "failed")
                with self._cond:
                    self.restarts += 1
                    n = self.restarts
                    self._cond.notify_all()
                logger.warning(
                    "query-service worker died (%s: %s); supervisor "
                    "restart #%d", type(e).__name__, e, n)

    def _worker_loop(self, tid) -> None:
        from tempo_tpu_torch.plan import executor as plan_executor

        while True:
            with self._cond:
                ticket = self._pick()
                while ticket is None:
                    if self._closed and not any(self._queues.values()):
                        return
                    # reservation is age-triggered: wake periodically
                    # while queries are PENDING so a starved head's
                    # clock is re-read (and deadlines expire by name);
                    # an idle service sleeps until a submit/close
                    # notifies instead of spinning
                    self._cond.wait(
                        timeout=0.25 if any(self._queues.values())
                        else None)
                    ticket = self._pick()
                # a dispatch frees a quota slot: wake blocked
                # submitters (completions notify elsewhere)
                self._cond.notify_all()
            # visible to the supervisor: if this loop dies before the
            # ticket is accounted, the restart fails it and releases
            # its acquired budget instead of hanging its caller
            self._running[tid] = ticket
            if ticket.deadline is not None and ticket.deadline.expired():
                # budget died between pick and dispatch: the budget IS
                # acquired at pick — release it with the failure
                ticket._finish(exc=DeadlineExceeded(
                    f"deadline exceeded at stage 'dispatch': query for "
                    f"tenant {ticket.tenant!r} ran out of its "
                    f"{ticket.deadline.budget_s:.3f}s budget before "
                    f"execution", stage="dispatch"))
                with self._cond:
                    self.admission.release(ticket.footprint)
                    self._count(ticket.tenant, "failed")
                    self._cond.notify_all()
                self.breaker.abandon(ticket.signature)
                self._running.pop(tid, None)
                continue
            ticket.t_start = time.perf_counter()
            try:
                with plan_cache.tenant_scope(ticket.tenant):
                    result = plan_executor.execute(ticket._root)
            except BaseException as e:  # noqa: BLE001 - delivered on the
                ticket._finish(exc=e)   # ticket; the worker lives on
                self.breaker.record(ticket.signature, ok=False)
                with self._cond:
                    self.admission.release(ticket.footprint)
                    self._count(ticket.tenant, "failed")
                    self._cond.notify_all()
                self._running.pop(tid, None)
                continue
            ticket._finish(result=result)
            self.breaker.record(ticket.signature, ok=True)
            with self._cond:
                self.admission.release(ticket.footprint)
                self._count(ticket.tenant, "completed")
                # bounded sample: percentiles are over the most recent
                # window, and a long-lived service does not grow a
                # float per query served forever
                self._latencies.setdefault(
                    ticket.tenant,
                    collections.deque(maxlen=self._LATENCY_WINDOW),
                ).append(ticket.latency_s)
                self._cond.notify_all()
            self._running.pop(tid, None)

    # -- lifecycle / metrics --------------------------------------------

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: stop accepting, execute everything already
        queued, stop the workers.  ``timeout`` bounds the WHOLE drain —
        one shared deadline across the worker joins, not per worker.
        Queries still pending when it expires are failed with
        :class:`~tempo_tpu_torch.resilience.ShutdownError` — a ticket never
        hangs its caller."""
        from tempo_tpu_torch.resilience import ShutdownError

        with self._cond:
            if self._closed:
                return
            self._closed = True
            standing = self._standing_engine
            self._standing_engine = None
            self._cond.notify_all()
        if standing is not None:
            standing.close()
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        for t in self._threads:
            t.join(None if deadline is None else
                   max(0.0, deadline - time.perf_counter()))
        with self._cond:
            for tenant in list(self._queues):
                for ticket in self._queues.pop(tenant):
                    ticket._finish(exc=ShutdownError(
                        f"query service closed with this query "
                        f"(tenant {tenant!r}) still pending"))
                    self._count(tenant, "failed")
                    self.breaker.abandon(ticket.signature)
            self._cond.notify_all()

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def stats(self) -> dict:
        """Per-tenant counts + latency percentiles, the shared cache's
        per-tenant traffic, budget occupancy, and the starvation audit
        (max/min completed-query ratio across tenants that submitted)."""
        from tempo_tpu_torch import profiling
        from tempo_tpu_torch.serve.executor import latency_percentiles

        with self._cond:
            tenants = {
                t: dict(c, **latency_percentiles(
                    list(self._latencies.get(t, ()))))
                for t, c in self._counts.items()
            }
            completed = [c["completed"] for c in self._counts.values()
                         if c["submitted"] > 0]
            ratio = None
            if completed and min(completed) > 0:
                ratio = round(max(completed) / min(completed), 3)
            return {
                "tenants": tenants,
                "starvation_ratio": ratio,
                "hbm_in_use": self.admission.hbm_in_use,
                "hbm_budget": self.admission.hbm_budget,
                "vmem_budget": self.admission.vmem_budget,
                "plan_cache": profiling.plan_cache_stats(),
                "breaker": self.breaker.stats(),
                "restarts": self.restarts,
            }
