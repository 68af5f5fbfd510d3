"""Chaos campaign harness: drive the serving, service, store and ingest
planes through kill / flaky / delay / corrupt schedules under Poisson
load and prove the fault-domain contracts on the way through.

Counterpart of ``tempo_tpu/testing/chaos.py``, campaign for campaign:
a scripted campaign against a live
:class:`~tempo_tpu_torch.serve.StreamCohort` behind a
:class:`~tempo_tpu_torch.serve.CohortExecutor`, and against a
:class:`~tempo_tpu_torch.service.QueryService`, asserting the four
availability invariants the fault-domain runtime promises:

* **no hung tickets** — every submit resolves with a result or a NAMED
  error (``DeadlineExceeded`` / ``QuarantinedError`` / ``Cancelled`` /
  ``ShutdownError`` / the injected fault), within a bounded wait;
* **bounded recovery** — after a :class:`SimulatedKill` of the serving
  plane, ``CohortExecutor.resume`` + warmup completes inside the
  declared bound;
* **zero recompiles after recovery** — the resumed plane's replay and
  steady state build no new executables and capture no new CUDA graphs
  past its warmup (``plan_cache_stats()``'s ``builds`` and
  ``graph_captures``);
* **bitwise tails** — every stream's full emission history (including
  the replayed unacked tail) is byte-identical to an UNINJECTED twin
  cohort fed the same per-stream events.

The campaign is deterministic: injections are call-counted
(:class:`~tempo_tpu_torch.testing.faults.FaultInjector`) on host calls
after each plane's warmup, latency injection
drives the deadline plane against a *known* sleep instead of racing a
wall clock, and the feeder keeps at most one in-flight event per
stream so per-stream order survives retries (an event is re-submitted
only until it is acked — the at-least-once feeder every replayable
event source implements).

Entry points: :func:`run_serving_campaign`,
:func:`run_service_campaign`, and :func:`run_campaign` (both planes,
one report: the reference bench's config 15); the batch plane's
campaign is :func:`run_pipeline_campaign` (config 16): the
Parquet -> mesh -> planned-chain path driven through ingest kills,
row-group corruption, torn writes, deadlines, a flapping file, a
mid-chain plan-barrier kill, and the out-of-core slab sweep killed and
resumed mid-run, every resumed artifact asserted bitwise against an
uninjected twin; the storage plane's is :func:`run_store_campaign`
(config 17).  Every campaign takes ``device=`` (default the CUDA card;
``"cpu"`` runs the plain versions) and the pipeline campaign
``devices=``, its mesh's entries.  After every :class:`SimulatedKill`
the campaign asserts that no CUDA graph capture was left open.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from tempo_tpu_torch import device as device_policy
from tempo_tpu_torch import profiling
from tempo_tpu_torch.resilience import (Cancelled, CheckpointError,
                                        CircuitBreaker, DeadlineExceeded,
                                        QuarantinedError, ShutdownError)
from tempo_tpu_torch.testing import faults

#: per-ticket result() bound: anything still unresolved after this is a
#: HUNG ticket and fails the campaign (the invariant, not a tuning)
RESULT_TIMEOUT_S = 120.0


def _compiles() -> tuple:
    """(executables built, CUDA graphs captured) so far: a plane that
    recovered without recompiling moves neither."""
    st = profiling.plan_cache_stats()
    return st["builds"], st["graph_captures"]


def _no_open_capture(dev: torch.device) -> None:
    """Raise if a kill left a CUDA graph capture open: the capture lock
    held, or this thread's stream still capturing.  A device
    synchronise then proves the card takes work again."""
    if dev.type != "cuda":
        return
    from tempo_tpu_torch.plan import fused

    assert not fused._CAPTURE_LOCK.locked(), (
        "a CUDA graph capture is still open after the kill")
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize(dev)


def _du(path: str) -> int:
    """Recursive byte size of one snapshot directory."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


# ----------------------------------------------------------------------
# Event schedules (Poisson load)
# ----------------------------------------------------------------------

#: trailing streams of a campaign cohort that live in a SECOND shape
#: bucket (3 declared series -> bucket 4) and receive only a quarter
#: of the traffic: once their events run dry, their bucket goes quiet
#: and every later differential snapshot excludes it — the dirty-
#: bucket economics the acceptance measures
COLD_STREAMS = 2


def make_events(rng, n_streams: int, events_per_stream: int,
                left_frac: float = 0.2):
    """Per-stream event lists under Poisson arrivals: exponential
    inter-arrival gaps on a per-stream logical clock (strictly
    increasing, so per-stream merged order holds by construction),
    ~``left_frac`` AS-OF queries, NaN runs in the values.  ``[(kind,
    ts, value_or_None)]`` per stream; every stream's first event is a
    data push (a query against an empty carry is legal but dull).
    The last :data:`COLD_STREAMS` streams get a quarter of the
    traffic — they finish early and leave their shape bucket quiet."""
    out = []
    for s in range(n_streams):
        n_ev = events_per_stream
        if n_streams > COLD_STREAMS and s >= n_streams - COLD_STREAMS:
            n_ev = max(2, events_per_stream // 4)
        gaps = rng.exponential(scale=4e7, size=n_ev).astype(np.int64) + 1
        ts = np.cumsum(gaps) + np.int64(10**9) * (s + 1)
        kinds = rng.random(n_ev) < left_frac
        kinds[0] = False
        vals = rng.standard_normal(n_ev).astype(np.float32)
        vals[rng.random(n_ev) < 0.05] = np.nan
        out.append([("left" if kinds[i] else "right", int(ts[i]),
                     None if kinds[i] else float(vals[i]))
                    for i in range(n_ev)])
    return out


def _mk_cohort(n_streams: int, checkpoint_dir: Optional[str], ckpt_every,
               diff_snapshots: bool, device=None):
    from tempo_tpu_torch.serve import StreamCohort

    cohort = StreamCohort(
        ("px",), window_secs=10.0, window_rows_bound=8, ema_alpha=0.2,
        max_lookback=16, slots=n_streams, checkpoint_dir=checkpoint_dir,
        ckpt_every=ckpt_every, diff_snapshots=diff_snapshots,
        device=device)
    members = []
    for s in range(n_streams):
        cold = (n_streams > COLD_STREAMS
                and s >= n_streams - COLD_STREAMS)
        # cold streams declare 3 series (shape bucket 4) but only feed
        # "s0": a second bucket group exists and goes quiet early
        members.append(cohort.add_stream(
            f"u{s}", ["s0", "s1", "s2"] if cold else ["s0"]))
    return cohort, members


def _golden_run(events, device=None) -> List[List[dict]]:
    """The uninjected twin: a fresh cohort on ``device`` fed the same
    per-stream events directly (no executor, no faults, no checkpoints)
    — the byte-level oracle for every stream's full emission history."""
    cohort, members = _mk_cohort(len(events), None, 0, False, device)
    out: List[List[dict]] = [[] for _ in events]
    pos = [0] * len(events)
    live = list(range(len(events)))
    while live:
        nxt = []
        for s in live:
            kind, ts, val = events[s][pos[s]]
            m = members[s]
            if kind == "right":
                r = m.push(["s0"], [ts], {"px": np.float32([val])})
            else:
                r = m.push_left(["s0"], [ts])
            out[s].append({k: np.asarray(v[0]) for k, v in r.items()})
            pos[s] += 1
            if pos[s] < len(events[s]):
                nxt.append(s)
        live = nxt
    return out


# ----------------------------------------------------------------------
# The serving-plane campaign
# ----------------------------------------------------------------------

class _Feeder:
    """At-least-once, order-preserving feeder: one in-flight event per
    stream, retried until acked; every outcome is categorized and every
    ticket must resolve inside ``RESULT_TIMEOUT_S`` (a hang fails the
    campaign on the spot)."""

    def __init__(self, events, golden):
        self.events = events
        self.golden = golden
        self.pos = [0] * len(events)
        self.emissions: List[List[Optional[dict]]] = [
            [None] * len(ev) for ev in events]
        self.outcomes = {"ok": 0, "deadline": 0, "quarantined": 0,
                         "shutdown": 0, "injected": 0, "retried": 0}
        self.resolved = 0

    def pending(self, s: int) -> bool:
        return self.pos[s] < len(self.events[s])

    def tick_of(self, s: int, members):
        kind, ts, val = self.events[s][self.pos[s]]
        return (kind, members[s], "s0", ts,
                None if val is None else {"px": np.float32(val)}, None)

    def settle(self, s_list, tickets) -> List[int]:
        """Resolve one round's tickets; returns the streams whose event
        must be RETRIED (everything else advanced or terminally
        failed the campaign)."""
        retry: List[int] = []
        for s, t in zip(s_list, tickets):
            try:
                r = t.result(timeout=RESULT_TIMEOUT_S)
            # NB: DeadlineExceeded IS a TimeoutError (and InjectedFault
            # an OSError) — the named outcomes must be caught before
            # the bare TimeoutError that means an actual HANG
            except DeadlineExceeded:
                self.outcomes["deadline"] += 1
                retry.append(s)
            except QuarantinedError:
                self.outcomes["quarantined"] += 1
                retry.append(s)
            except ShutdownError:
                self.outcomes["shutdown"] += 1
                retry.append(s)
            except faults.InjectedFault:
                self.outcomes["injected"] += 1
                retry.append(s)
            except TimeoutError as e:
                raise AssertionError(
                    f"HUNG ticket for stream {s}: {e}") from e
            else:
                i = self.pos[s]
                self.emissions[s][i] = {k: np.asarray(v)
                                        for k, v in r.items()}
                self.pos[s] += 1
                self.outcomes["ok"] += 1
            finally:
                self.resolved += 1
        self.outcomes["retried"] += len(retry)
        return retry

    def round(self, ex, members, streams=None, deadline=None) -> List[int]:
        """Submit one pending event per (given) stream as ONE
        submit_many chunk, settle, return retries."""
        s_list = [s for s in (streams if streams is not None
                              else range(len(self.events)))
                  if self.pending(s)]
        if not s_list:
            return []
        tickets = ex.submit_many([self.tick_of(s, members)
                                  for s in s_list], deadline=deadline)
        return self.settle(s_list, tickets)

    def acked_total(self) -> int:
        return sum(self.pos)

    def audit_tails(self) -> int:
        """Every stream's full emission history bitwise vs golden."""
        checked = 0
        for s, gold in enumerate(self.golden):
            assert self.pos[s] == len(self.events[s]), (
                f"stream {s} incomplete: {self.pos[s]} of "
                f"{len(self.events[s])} events acked")
            for i, want in enumerate(gold):
                got = self.emissions[s][i]
                assert got is not None, (s, i)
                assert set(got) == set(want), (s, i)
                for key in want:
                    assert got[key].tobytes() == want[key].tobytes(), (
                        f"stream {s} event {i} field {key!r}: "
                        f"{got[key]} != {want[key]}")
                checked += 1
        return checked


def run_serving_campaign(checkpoint_dir: str, *, n_streams: int = 12,
                         events_per_stream: int = 24, seed: int = 17,
                         ckpt_every: int = 40,
                         recovery_bound_s: float = 60.0,
                         delay_s: float = 0.5,
                         delay_deadline_s: float = 0.12,
                         device=None) -> dict:
    """The serving-plane chaos campaign (see module docstring).

    Phases: clean warm-up traffic -> flaky dispatches (retried) ->
    a plane-level fault that kills the drain thread (supervised
    restart) -> latency injection against a short deadline (stage-named
    ``DeadlineExceeded``, nothing lost) -> a poison-pill member driven
    into quarantine and recovered through a half-open probe ->
    :class:`SimulatedKill` of a dispatch (plane death: every
    outstanding ticket resolves with ``ShutdownError``) ->
    ``CohortExecutor.resume`` from the differential snapshot chain ->
    replay of every unacked tail -> full bitwise tail audit vs the
    uninjected twin, which runs on the same device."""
    from tempo_tpu_torch.serve import CohortExecutor, StreamCohort

    dev = device_policy.resolve(device)
    rng = np.random.default_rng(seed)
    events = make_events(rng, n_streams, events_per_stream)
    n_total = sum(len(ev) for ev in events)
    golden = _golden_run(events, dev)
    feeder = _Feeder(events, golden)

    breaker = CircuitBreaker(threshold=3, cooldown_s=0.4)
    cohort, members = _mk_cohort(n_streams, checkpoint_dir, ckpt_every,
                                 diff_snapshots=True, device=dev)
    ex = CohortExecutor(cohort, batch_rows=8, queue_depth=256,
                        coalesce_s=0.0, breaker=breaker)
    cohort.warmup(8)
    injected = {"flaky": 0, "supervisor_faults": 0, "delays": 0,
                "poison": 0, "kills": 0}
    t_start = time.perf_counter()

    def pump(frac):
        target = int(frac * n_total)
        guard = 0
        while feeder.acked_total() < target:
            feeder.round(ex, members)
            guard += 1
            assert guard < 10_000, "campaign feeder stopped progressing"

    # -- phase 1: clean traffic ---------------------------------------
    pump(0.15)

    # -- phase 2: flaky dispatches — the whole round fails, the feeder
    # retries, nothing is lost and nothing reorders
    with faults.FaultInjector() as fi:
        fi.flaky(StreamCohort, "dispatch", failures=2)
        pump(0.30)
        injected["flaky"] = sum(r.action == "raise" for r in fi.records)
    assert injected["flaky"] >= 2
    assert feeder.outcomes["injected"] >= 1

    # -- phase 3: a plane-level fault (escapes the worker loop, not a
    # ticket) — the supervisor fails the in-flight group and restarts
    # the drain thread; the plane keeps serving
    with faults.FaultInjector() as fi:
        fi.flaky(CohortExecutor, "_split", failures=1)
        pump(0.40)
        injected["supervisor_faults"] = sum(
            r.action == "raise" for r in fi.records)
    assert ex.restarts >= 1, "supervisor never restarted the drain"

    # -- phase 4: latency injection vs a short deadline.  Half the
    # fleet dispatches behind an injected sleep; the other half is
    # submitted with a budget strictly under it, dies IN THE QUEUE with
    # the stage-named error, and is retried after the delay clears.
    half = [s for s in range(n_streams) if feeder.pending(s)][:n_streams // 2]
    rest = [s for s in range(n_streams)
            if feeder.pending(s) and s not in half]
    with faults.FaultInjector() as fi:
        fi.delay_on_call(StreamCohort, "dispatch", seconds=delay_s,
                         call_no=1)
        a_list = [s for s in half if feeder.pending(s)]
        a_tickets = ex.submit_many([feeder.tick_of(s, members)
                                    for s in a_list])
        # wait until the delayed dispatch has STARTED, then queue the
        # doomed half behind it
        t0 = time.perf_counter()
        while not any(r.action == "delay" for r in fi.records):
            assert time.perf_counter() - t0 < 30, "delay never fired"
            time.sleep(0.002)
        retry_b = feeder.round(ex, members, streams=rest,
                               deadline=delay_deadline_s)
        feeder.settle(a_list, a_tickets)
        injected["delays"] = sum(r.action == "delay" for r in fi.records)
    assert feeder.outcomes["deadline"] >= 1, (
        "latency injection produced no DeadlineExceeded")
    if retry_b:              # nothing was folded: the retries must land
        feeder.round(ex, members, streams=retry_b)
    pump(0.55)

    # -- phase 5: poison-pill member -> quarantine -> half-open probe.
    # Three consecutive bad ticks (unknown series) open the member's
    # circuit; the next tick fails FAST with QuarantinedError; after
    # the cooldown one probe (a real event) closes it again.
    poison = members[0]
    bad = ("right", poison, "no-such-series", 1, {"px": np.float32(1)},
           None)
    for _ in range(3):
        (bad_ticket,) = ex.submit_many([bad])
        try:
            bad_ticket.result(timeout=RESULT_TIMEOUT_S)
            raise AssertionError("poison tick unexpectedly succeeded")
        except ValueError:
            pass
    injected["poison"] = 3
    assert breaker.state(poison.name) == "open"
    assert feeder.pending(0), "campaign sizing: stream 0 ran dry early"
    (q_ticket,) = ex.submit_many([feeder.tick_of(0, members)])
    try:
        q_ticket.result(timeout=RESULT_TIMEOUT_S)
        raise AssertionError("quarantined member's tick ran")
    except QuarantinedError:
        feeder.outcomes["quarantined"] += 1
    time.sleep(breaker.cooldown_s + 0.05)
    feeder.round(ex, members, streams=[0])      # the half-open probe
    assert breaker.state(poison.name) == "closed", (
        "half-open probe did not close the circuit")
    pump(0.75)

    # -- phase 6: SimulatedKill mid-dispatch — the plane dies, every
    # outstanding ticket resolves with ShutdownError, and failover is
    # resume-from-chain + replay of the unacked tails
    with faults.FaultInjector() as fi:
        fi.kill_on_call(StreamCohort, "dispatch", call_no=1)
        live = [s for s in range(n_streams) if feeder.pending(s)]
        tickets = ex.submit_many([feeder.tick_of(s, members)
                                  for s in live])
        retry = feeder.settle(live, tickets)
        assert any(r.action == "kill" for r in fi.records)
        injected["kills"] = 1
    _no_open_capture(dev)
    assert retry, "the killed dispatch should have failed its tickets"
    assert ex.fatal is not None
    restarts_pre_kill = ex.restarts
    t_rec = time.perf_counter()
    ex.close(timeout=5.0)

    ex = CohortExecutor.resume(checkpoint_dir, batch_rows=8,
                               queue_depth=256, coalesce_s=0.0,
                               breaker=breaker, ckpt_every=ckpt_every,
                               diff_snapshots=True, device=dev)
    cohort = ex.cohort
    members = [cohort.stream(f"u{s}") for s in range(n_streams)]
    # the snapshot's acked cursors say where each stream's source
    # restarts; successfully-emitted events past the snapshot REPLAY
    # (their bytes must come out identical — checked by the audit)
    replayed = 0
    for s in range(n_streams):
        acked = cohort.stream(f"u{s}").acked
        assert acked <= feeder.pos[s], (s, acked, feeder.pos[s])
        replayed += feeder.pos[s] - acked
        feeder.pos[s] = acked
    cohort.warmup(8)
    recovery_s = time.perf_counter() - t_rec
    assert recovery_s <= recovery_bound_s, (
        f"recovery took {recovery_s:.1f}s (bound {recovery_bound_s}s)")

    # -- phase 7: replay + finish with ZERO new builds and captures
    builds0 = _compiles()
    pump(1.0)
    builds1 = _compiles()
    assert builds1 == builds0, (
        f"post-recovery steady state recompiled: (builds, captures) "
        f"went {builds0} -> {builds1}")
    wall = time.perf_counter() - t_start
    ex.close(timeout=30.0)

    checked = feeder.audit_tails()

    # snapshot economics: every artifact on disk, split full vs diff
    from tempo_tpu_torch import checkpoint as ckpt
    full_b, diff_b = [], []
    for _, path in ckpt.list_steps(checkpoint_dir):
        mode = StreamCohort._snapshot_mode(path)["mode"]
        (diff_b if mode == "differential" else full_b).append(_du(path))
    assert full_b and diff_b, (
        f"campaign wrote no full+diff chain: {len(full_b)} fulls, "
        f"{len(diff_b)} diffs under {checkpoint_dir!r}")
    # dirty-bucket economics: once the cold streams' bucket went quiet,
    # an incremental snapshot stopped carrying it — at least one diff
    # is strictly smaller than every full artifact
    assert min(diff_b) < min(full_b), (full_b, diff_b)
    assert feeder.resolved >= n_total
    return {
        "ticks_per_sec": round(feeder.outcomes["ok"] / wall, 1),
        "n_streams": n_streams,
        "n_events": n_total,
        "outcomes": dict(feeder.outcomes),
        "injected": injected,
        "restarts": restarts_pre_kill + ex.restarts,
        "recovery_s": round(recovery_s, 3),
        "replayed_ticks": replayed,
        "zero_builds_after_recovery": True,
        "no_hung_tickets": True,
        "snapshot_bytes": {
            "full": full_b, "diff": diff_b,
            "diff_vs_full": (round(min(diff_b) / max(full_b), 3)
                             if full_b and diff_b else None)},
        "tail_audit": (f"all {n_streams} streams bitwise vs uninjected "
                       f"twin ({checked} emissions, replay included)"),
    }


# ----------------------------------------------------------------------
# The query-service campaign
# ----------------------------------------------------------------------

def run_service_campaign(*, n_queries: int = 12, seed: int = 5,
                         delay_s: float = 0.4,
                         deadline_s: float = 0.1,
                         device=None) -> dict:
    """Chaos campaign for the query-service plane: a poison-pill plan
    signature driven into quarantine (and probed half-open), a worker
    killed by a plane-level fault (supervised restart), a delayed
    execution that expires a queued query's deadline by stage name,
    and a cancellation that never reaches a worker — while a good
    tenant's queries keep completing.  Single worker: the scheduling
    is then deterministic."""
    import pandas as pd

    from tempo_tpu_torch import TSDF
    from tempo_tpu_torch.plan import executor as plan_executor
    from tempo_tpu_torch.plan import ir
    from tempo_tpu_torch.service import QueryService, lazy_frame
    from tempo_tpu_torch.service.service import QueryService as _QS

    dev = device_policy.resolve(device)
    rng = np.random.default_rng(seed)
    n = 256
    frame = TSDF(pd.DataFrame({
        "sym": np.repeat(np.arange(4), n // 4),
        "event_ts": np.tile(np.arange(n // 4, dtype=np.int64), 4),
        "x": rng.standard_normal(n),
    }), "event_ts", ["sym"], device=dev)
    good = lambda: lazy_frame(frame).EMA("x", exact=True)
    poison_root = ir.Node("chaos_poison")        # unknown op: always raises

    breaker = CircuitBreaker(threshold=3, cooldown_s=0.4)
    svc = QueryService(workers=1, breaker=breaker)
    outcomes = {"ok": 0, "poison_failed": 0, "quarantined": 0,
                "deadline": 0, "cancelled": 0}

    # steady traffic for the good tenant
    for _ in range(n_queries // 2):
        svc.submit("good", good()).result(timeout=RESULT_TIMEOUT_S)
        outcomes["ok"] += 1

    # -- poison signature -> quarantine -> half-open probe ------------
    sig = ir.signature(poison_root)
    for _ in range(3):
        t = svc.submit("evil", poison_root)
        try:
            t.result(timeout=RESULT_TIMEOUT_S)
            raise AssertionError("poison query unexpectedly succeeded")
        except ValueError:
            outcomes["poison_failed"] += 1
    assert breaker.state(sig) == "open"
    try:
        svc.submit("evil", poison_root)
        raise AssertionError("quarantined signature was admitted")
    except QuarantinedError:
        outcomes["quarantined"] += 1
    time.sleep(breaker.cooldown_s + 0.05)
    probe = svc.submit("evil", poison_root)      # the half-open probe
    try:
        probe.result(timeout=RESULT_TIMEOUT_S)
    except ValueError:
        outcomes["poison_failed"] += 1
    assert breaker.state(sig) == "open"          # failed probe re-opens

    # -- plane-level fault: the scheduler loop dies, the supervisor
    # restarts the worker and service continues
    with faults.FaultInjector() as fi:
        fi.flaky(_QS, "_pick", failures=1)
        t = svc.submit("good", good())
        t.result(timeout=RESULT_TIMEOUT_S)
        outcomes["ok"] += 1
        assert any(r.action == "raise" for r in fi.records)
    assert svc.restarts >= 1, "service supervisor never restarted"

    # -- delayed execution vs a queued query's deadline + cancel ------
    with faults.FaultInjector() as fi:
        fi.delay_on_call(plan_executor, "execute", seconds=delay_s,
                         call_no=1)
        slow = svc.submit("good", good())
        t0 = time.perf_counter()
        while not any(r.action == "delay" for r in fi.records):
            assert time.perf_counter() - t0 < 30, "delay never fired"
            time.sleep(0.002)
        doomed = svc.submit("good", good(), deadline_s=deadline_s)
        victim = svc.submit("good", good())
        assert victim.cancel(), "queued query was not cancellable"
        try:
            victim.result(timeout=RESULT_TIMEOUT_S)
            raise AssertionError("cancelled query returned a result")
        except Cancelled:
            outcomes["cancelled"] += 1
        try:
            doomed.result(timeout=RESULT_TIMEOUT_S)
            raise AssertionError("deadline query returned a result")
        except DeadlineExceeded as e:
            assert e.stage in ("admission queue", "dispatch"), e.stage
            outcomes["deadline"] += 1
        slow.result(timeout=RESULT_TIMEOUT_S)    # the delayed one lands
        outcomes["ok"] += 1

    # the plane still serves after the whole gauntlet
    for _ in range(n_queries // 2):
        svc.submit("good", good()).result(timeout=RESULT_TIMEOUT_S)
        outcomes["ok"] += 1
    st = svc.stats()
    svc.close(timeout=30.0)
    assert st["tenants"]["good"]["completed"] == outcomes["ok"]
    return {
        "outcomes": outcomes,
        "restarts": st["restarts"],
        "breaker": st["breaker"],
        "good_tenant_completed": st["tenants"]["good"]["completed"],
        "no_hung_tickets": True,
    }


def run_campaign(checkpoint_dir: str, *, n_streams: int = 12,
                 events_per_stream: int = 24, seed: int = 17,
                 recovery_bound_s: float = 60.0, device=None) -> dict:
    """Both planes, one report: the reference bench's config 15."""
    serving = run_serving_campaign(
        checkpoint_dir, n_streams=n_streams,
        events_per_stream=events_per_stream, seed=seed,
        recovery_bound_s=recovery_bound_s, device=device)
    service = run_service_campaign(seed=seed + 1, device=device)
    serving["service"] = service
    return serving


# ----------------------------------------------------------------------
# The batch-pipeline campaign (the reference bench's config 16)
# ----------------------------------------------------------------------

def make_parquet_dataset(path: str, *, n_rows: int, n_keys: int,
                         seed: int, n_files: int = 4,
                         row_group_rows: Optional[int] = None) -> str:
    """A real multi-file, multi-row-group Parquet dataset (columns:
    symbol, event_ts, px, qty) — several row groups per file so the
    corruption injections have sibling groups to leave intact."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = max(1, n_rows // n_files)
    rg = row_group_rows or max(64, per // 4)
    for i in range(n_files):
        df = pd.DataFrame({
            "symbol": rng.choice([f"s{k:03d}" for k in range(n_keys)], per),
            "event_ts": pd.to_datetime(
                (np.sort(rng.integers(0, 10 ** 6, per))
                 + np.int64(i) * 10 ** 6) * 1_000_000_000),
            "px": rng.standard_normal(per),
            "qty": rng.integers(1, 9, per).astype(float),
        })
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       os.path.join(path, f"part-{i}.parquet"),
                       row_group_size=rg)
    return path


def _df_crc(df) -> int:
    """CRC-32 of a DataFrame's raw column bytes (sorted column order;
    object columns via their UTF-8 reprs) — the bitwise fingerprint
    the slab digests chain, so 'digest equal' means 'every byte of
    every slab's full output equal'."""
    c = 0
    for col in sorted(df.columns):
        arr = df[col].to_numpy()
        if arr.dtype == object:
            arr = arr.astype(str).astype("S")
        c = zlib.crc32(np.ascontiguousarray(arr).tobytes(), c)
    return c & 0xFFFFFFFF


def _sorted_df(frame_out):
    return frame_out.df.sort_values(
        ["symbol", "event_ts"], kind="stable").reset_index(drop=True)


def run_pipeline_campaign(workdir: str, *, rows_total: int = 360_000,
                          physical_rows: int = 60_000,
                          n_keys: int = 24, seed: int = 29,
                          n_windows: int = 3,
                          ckpt_every: int = 2,
                          recovery_bound_s: float = 120.0,
                          device=None, devices=None) -> dict:
    """The batch-plane chaos campaign — Parquet → resumable OOC ingest
    → mesh → planned streaming AS-OF join + packed range stats, driven
    to ``rows_total`` cumulative rows through the out-of-core slab
    sweep, under a kill/flaky/corrupt schedule.  ``devices`` are the
    mesh's entries (default: every card, at most 8, the ``on_mesh()``
    rule; repeats allowed, so ``["cuda:0"] * 4`` puts four shards on one
    card) and ``device`` the frames' device (default the first entry's).
    Asserted HARD (a violation raises):

    * a mid-file ingest kill resumes from the per-shard progress
      manifest: completed shards are NOT re-read, and the resumed
      frame is bitwise-identical to a fresh ingest;
    * a foreign resume directory / a foreign checkpoint signature is
      refused by name (``CheckpointError``), never silently restored;
    * a corrupt row group and a torn-write file are quarantined with
      the exact ranges named (``CorruptRowGroupError`` in raise mode);
      a flapping file trips its circuit breaker and is quarantined
      instead of burning the pass's retry budget;
    * the end-to-end ingest deadline dies with a STAGE-named
      ``DeadlineExceeded``;
    * a kill mid-chain between plan-placed checkpoint barriers
      resumes from the newest intact signed barrier: ONLY the ops
      above it re-run, ZERO new executables are built, and the final
      frame is bitwise-identical to the uninjected eager twin;
    * the slab sweep (``run_resumable`` over the same signed-barrier
      machinery) killed mid-run resumes from the newest barrier,
      replays only post-barrier slabs with ZERO new executable
      builds, and its final digest — the per-slab CRCs of every
      slab's FULL collected output — is bitwise-identical to an
      uninjected twin sweep's.
    """
    import glob
    import shutil

    import pandas as pd

    from tempo_tpu_torch import TSDF, checkpoint, resilience
    from tempo_tpu_torch.dist import DistributedTSDF
    from tempo_tpu_torch.io import ingest
    from tempo_tpu_torch.parallel.mesh import make_mesh
    from tempo_tpu_torch.plan import checkpoints as plan_ckpt
    from tempo_tpu_torch.service import lazy_frame

    if devices is None:
        device_policy.resolve("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(min(8, torch.cuda.device_count()))]
    devices = [device_policy.resolve(d) for d in devices][:8]
    dev = device_policy.resolve(devices[0] if device is None else device)

    t_start = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    half = physical_rows // 2
    left_path = make_parquet_dataset(
        os.path.join(workdir, "left"), n_rows=half, n_keys=n_keys,
        seed=seed)
    right_path = make_parquet_dataset(
        os.path.join(workdir, "right"), n_rows=half, n_keys=n_keys,
        seed=seed + 1)
    n_shards = len(devices)
    mesh = make_mesh({"series": n_shards}, devices=devices)
    ingest_kw = dict(ts_col="event_ts", partition_cols=["symbol"],
                     mesh=mesh, batch_rows=1 << 14)

    # -- phase 1: transactional ingest — kill mid-stream, resume from
    # the per-shard progress manifest, no completed shard re-read.
    # Needs >= 2 shards so at least one commits before the kill; a
    # 1-device backend records the phase as skipped instead of
    # asserting a kill that can never land
    resume_dir = os.path.join(workdir, "ingest_resume")
    ingest_kill = n_shards >= 2
    committed = restreamed = 0
    if ingest_kill:
        kill_shard = min(max(1, n_shards // 2), n_shards - 1)
        with faults.FaultInjector() as fi:
            fi.kill_on_call(ingest, "_stream_shard",
                            call_no=kill_shard + 1)
            try:
                ingest.from_parquet(left_path, resume_dir=resume_dir,
                                    **ingest_kw)
                raise AssertionError("ingest kill never fired")
            except faults.SimulatedKill:
                pass
        _no_open_capture(dev)
        committed = len(glob.glob(os.path.join(resume_dir,
                                               "shard_*.json")))
        assert committed >= kill_shard, (committed, kill_shard)
        with faults.FaultInjector() as fi:
            fi.flaky(ingest, "_stream_shard", failures=0)  # call counter
            left_f = ingest.from_parquet(left_path,
                                         resume_dir=resume_dir,
                                         **ingest_kw)
            restreamed = len(fi.records)
        assert restreamed == n_shards - committed, (
            f"resume re-read committed shards: {restreamed} streamed, "
            f"{committed} were committed of {n_shards}")
    else:
        left_f = ingest.from_parquet(left_path, resume_dir=resume_dir,
                                     **ingest_kw)
    fresh = ingest.from_parquet(left_path, **ingest_kw)
    pd.testing.assert_frame_equal(
        _sorted_df(left_f.collect()), _sorted_df(fresh.collect()),
        check_exact=True)
    del fresh
    # foreign resume refusal: same dir, different mesh shape.  On a
    # 1-device backend there is no second mesh shape to probe with —
    # the phase is recorded as None (skipped), never a false failure
    foreign_refused = {"ingest": None if n_shards == 1 else False,
                       "plan": False, "sweep": False}
    if n_shards > 1:
        try:
            ingest.from_parquet(
                left_path, resume_dir=resume_dir, ts_col="event_ts",
                partition_cols=["symbol"],
                mesh=make_mesh({"series": max(1, n_shards // 2)},
                               devices=devices[:max(1, n_shards // 2)]),
                batch_rows=1 << 14)
            raise AssertionError("foreign ingest resume was admitted")
        except CheckpointError:
            foreign_refused["ingest"] = True
    right_f = ingest.from_parquet(right_path, **ingest_kw)

    # -- phase 2: corrupt row group + torn write -> quarantine with
    # the exact ranges named; raise mode surfaces ONE named error
    qdir = os.path.join(workdir, "corrupt_ds")
    shutil.copytree(right_path, qdir)
    rec = faults.corrupt_parquet_row_group(
        os.path.join(qdir, "part-1.parquet"), row_group=1)
    try:
        ingest.from_parquet(qdir, **ingest_kw)
        raise AssertionError("corrupt row group was ingested silently")
    except ingest.CorruptRowGroupError as e:
        assert any(r["row_group"] == rec["row_group"]
                   and r["file"].endswith("part-1.parquet")
                   for r in e.ranges), e.ranges
    faults.tear_parquet_footer(os.path.join(qdir, "part-2.parquet"))
    q_frame = ingest.from_parquet(qdir, on_corrupt="quarantine",
                                  **ingest_kw)
    q_ranges = list(q_frame.ingest_quarantined)
    assert any(r["row_group"] == rec["row_group"] for r in q_ranges)
    assert any(r["file"].endswith("part-2.parquet")
               and r["row_group"] is None for r in q_ranges), q_ranges
    clean_rows = int(right_f.collect().df.shape[0])
    q_rows = int(q_frame.collect().df.shape[0])
    assert q_rows < clean_rows
    del q_frame

    # -- phase 3: the end-to-end ingest deadline dies stage-named
    try:
        ingest.from_parquet(left_path, deadline_s=1e-6, **ingest_kw)
        raise AssertionError("ingest deadline never fired")
    except DeadlineExceeded as e:
        assert e.stage, "DeadlineExceeded carried no stage name"
        deadline_stage = e.stage

    # -- phase 4: flapping file -> circuit breaker -> quarantined
    # instead of burning the whole retry budget
    flap_path = os.path.join(left_path, "part-1.parquet")
    flap_breaker = CircuitBreaker(threshold=2, cooldown_s=600.0)
    orig_scan = ingest._scan_fragment

    def _flapping_scan(frag, *a, **k):
        if getattr(frag, "path", "") == flap_path:
            raise faults.InjectedFault(
                f"flapping network read at {flap_path}")
        return orig_scan(frag, *a, **k)

    ingest._scan_fragment = _flapping_scan
    try:
        flap_frame = ingest.from_parquet(
            left_path, on_corrupt="quarantine", breaker=flap_breaker,
            **ingest_kw)
    finally:
        ingest._scan_fragment = orig_scan
    flap_q = [r for r in flap_frame.ingest_quarantined
              if "circuit" in r["reason"]]
    assert flap_q and flap_q[0]["file"] == flap_path, (
        flap_frame.ingest_quarantined)
    assert flap_breaker.stats()["trips"] >= 1
    del flap_frame

    # -- phase 5: plan-integrated checkpoint barriers — kill mid-chain,
    # resume from the newest intact signed barrier
    def chain():
        return (lazy_frame(left_f)
                .asofJoin(lazy_frame(right_f), right_prefix="q",
                          skipNulls=False)
                .withRangeStats(colsToSummarize=["q_px", "q_qty"],
                                rangeBackWindowSecs=60)
                .EMA("q_px", exact=True))

    eager_golden = _sorted_df(
        left_f.asofJoin(right_f, right_prefix="q", skipNulls=False)
        .withRangeStats(colsToSummarize=["q_px", "q_qty"],
                        rangeBackWindowSecs=60)
        .EMA("q_px", exact=True).collect())
    plan_dir = os.path.join(workdir, "plan_ckpt")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(np, "savez", call_no=2)     # dies saving barrier 2
        try:
            with plan_ckpt.checkpointed(plan_dir, every=1):
                chain().collect()
            raise AssertionError("plan-barrier kill never fired")
        except faults.SimulatedKill:
            pass
    _no_open_capture(dev)
    assert checkpoint.latest(plan_dir).endswith("step_00001")
    t_rec = time.perf_counter()
    builds0 = _compiles()
    with faults.FaultInjector() as fi:
        fi.flaky(DistributedTSDF, "asofJoin", failures=0)
        fi.flaky(DistributedTSDF, "withRangeStats", failures=0,
                 label="stats")
        with plan_ckpt.checkpointed(plan_dir, every=1):
            resumed = _sorted_df(chain().collect())
        join_calls = sum(r.target != "stats" for r in fi.records)
        stats_calls = sum(r.target == "stats" for r in fi.records)
    builds1 = _compiles()
    assert join_calls == 0, (
        f"resume re-ran the pre-barrier join ({join_calls} call(s))")
    assert stats_calls == 1, stats_calls
    assert builds1 == builds0, (
        f"plan-barrier resume recompiled: (builds, captures) "
        f"{builds0}->{builds1}")
    pd.testing.assert_frame_equal(resumed, eager_golden,
                                  check_exact=True)
    plan_recovery_s = time.perf_counter() - t_rec
    barriers = sorted(s for s, _ in checkpoint.list_steps(plan_dir))
    assert barriers == [1, 2, 3], barriers
    # foreign plan refusal: a longer chain against the same barrier dir
    try:
        with plan_ckpt.checkpointed(plan_dir, every=1):
            chain().EMA("q_qty", exact=True).collect()
        raise AssertionError("foreign plan resume was admitted")
    except CheckpointError:
        foreign_refused["plan"] = True

    # -- phase 6: the out-of-core slab sweep to rows_total, killed
    # mid-run and resumed via run_resumable (the eager wrapper over
    # the same signed-barrier machinery)
    slab_rows = int(left_f.collect().df.shape[0]
                    + right_f.collect().df.shape[0])
    n_slabs = max(2, -(-rows_total // slab_rows))
    windows = [30.0 + 15.0 * i for i in range(max(1, n_windows))]
    kill_at = max(len(windows) + 1, int(n_slabs * 0.6))
    if kill_at % ckpt_every == 0:
        # never kill exactly ON a barrier: the campaign must prove the
        # REPLAY of the slabs between the newest barrier and the kill
        kill_at += 1
    kill_at = min(kill_at, n_slabs - 1)
    if kill_at % ckpt_every == 0:       # the clamp landed on a barrier
        kill_at -= 1

    def digest_seed():
        return TSDF(pd.DataFrame({
            "event_ts": pd.to_datetime([0]),
            "slab": np.int64([-1]),
            "out_crc": np.int64([0]),
            "out_rows": np.int64([0]),
        }), "event_ts", [], device=dev)

    def make_steps(ran: List[int], kill_slab: Optional[int] = None):
        killed = {"done": False}

        def mk(k):
            w = windows[k % len(windows)]

            def step(digest):
                if k == kill_slab and not killed["done"]:
                    killed["done"] = True
                    raise faults.SimulatedKill(
                        f"simulated kill at slab {k}")
                ran.append(k)
                out = (lazy_frame(left_f)
                       .asofJoin(lazy_frame(right_f), right_prefix="q",
                                 skipNulls=False)
                       .withRangeStats(
                           colsToSummarize=["q_px", "q_qty"],
                           rangeBackWindowSecs=w)
                       .collect())
                df = _sorted_df(out)
                row = pd.DataFrame({
                    "event_ts": pd.to_datetime([(k + 1) * 10 ** 9]),
                    "slab": np.int64([k]),
                    "out_crc": np.int64([_df_crc(df)]),
                    "out_rows": np.int64([len(df)]),
                })
                return TSDF(
                    pd.concat([digest.df, row], ignore_index=True),
                    "event_ts", [], device=dev)

            step.__name__ = f"slab{k}"
            return step

        return [mk(k) for k in range(n_slabs)]

    sweep_dir = os.path.join(workdir, "sweep_ckpt")
    ran_killed: List[int] = []
    t_sweep = time.perf_counter()
    steps = make_steps(ran_killed, kill_slab=kill_at)
    try:
        resilience.run_resumable(digest_seed(), steps, sweep_dir,
                                 every=ckpt_every, keep_last=3)
        raise AssertionError("sweep kill never fired")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    assert ran_killed == list(range(kill_at)), ran_killed
    barrier_slab = (kill_at // ckpt_every) * ckpt_every
    t_rec2 = time.perf_counter()
    builds0 = _compiles()
    ran_resume: List[int] = []
    digest = resilience.run_resumable(
        digest_seed(), make_steps(ran_resume), sweep_dir,
        every=ckpt_every, keep_last=3)
    builds1 = _compiles()
    builds_resume = builds1[0] - builds0[0]
    captures_resume = builds1[1] - builds0[1]
    sweep_recovery_s = time.perf_counter() - t_rec2
    assert ran_resume == list(range(barrier_slab, n_slabs)), (
        f"resume re-ran pre-barrier slabs: {ran_resume[:4]}... "
        f"(barrier at {barrier_slab})")
    assert kill_at > barrier_slab, (
        "campaign sizing bug: the kill landed on a barrier, so no "
        "slab replay was exercised")
    assert builds_resume == 0 and captures_resume == 0, (
        f"sweep resume built {builds_resume} new executable(s) and "
        f"captured {captures_resume} new graph(s); every "
        f"window was compiled before the kill")
    sweep_wall = time.perf_counter() - t_sweep
    assert sweep_recovery_s <= recovery_bound_s, (
        f"sweep recovery took {sweep_recovery_s:.1f}s "
        f"(bound {recovery_bound_s}s)")

    # the uninjected twin (runs entirely on cached executables)
    ran_golden: List[int] = []
    golden = resilience.run_resumable(
        digest_seed(), make_steps(ran_golden),
        os.path.join(workdir, "sweep_golden"), every=ckpt_every,
        keep_last=3)
    assert ran_golden == list(range(n_slabs))
    pd.testing.assert_frame_equal(digest.df.reset_index(drop=True),
                                  golden.df.reset_index(drop=True),
                                  check_exact=True)
    # foreign sweep refusal: a different-length pipeline, same dir
    try:
        resilience.run_resumable(
            digest_seed(), make_steps([])[: n_slabs - 1], sweep_dir,
            every=ckpt_every, keep_last=3)
        raise AssertionError("foreign sweep resume was admitted")
    except CheckpointError:
        foreign_refused["sweep"] = True

    rows_driven = slab_rows * n_slabs
    wall = time.perf_counter() - t_start
    assert all(v for v in foreign_refused.values()
               if v is not None), foreign_refused
    return {
        "rows_per_sec": round(rows_driven / sweep_wall, 1),
        "rows_total": rows_driven,
        "physical_rows": physical_rows,
        "n_slabs": n_slabs,
        "slab_rows": slab_rows,
        "wall_s": round(wall, 1),
        "ingest_resume": {
            "kill": ingest_kill,
            "shards_total": n_shards,
            "shards_committed_before_kill": committed,
            "shards_restreamed_on_resume": restreamed,
            "reread_committed_shards": 0,
            "value_audit": "resumed ingest bitwise == fresh ingest "
                           "(assert_frame_equal check_exact)",
        },
        "quarantine": {
            "named_error": True,
            "corrupt_row_group": {"file": "part-1.parquet",
                                  "row_group": rec["row_group"],
                                  "rows": rec["rows"]},
            "torn_footer_file_quarantined": True,
            "rows_kept": q_rows,
            "rows_clean": clean_rows,
        },
        "ingest_deadline_stage": deadline_stage,
        "flapping_file": {
            "breaker_tripped": True,
            "quarantined": os.path.basename(flap_path),
        },
        "plan_barriers": {
            "placed": len(barriers),
            "resume_from_step": 1,
            "pre_barrier_ops_rerun": join_calls,
            "post_barrier_ops_rerun": stats_calls,
            "zero_builds_after_resume": True,
            "recovery_s": round(plan_recovery_s, 3),
            "value_audit": "resumed planned chain bitwise == "
                           "uninjected eager twin",
        },
        "sweep": {
            "killed_at_slab": kill_at,
            "resumed_from_barrier_slab": barrier_slab,
            "replayed_slabs": kill_at - barrier_slab,
            "new_slabs_after_kill": n_slabs - kill_at,
            "builds_after_resume": builds_resume,
            "recovery_s": round(sweep_recovery_s, 3),
        },
        "foreign_signature_refused": foreign_refused,
        "no_silent_restores": True,
        "tail_audit": (
            f"digest of all {n_slabs} slabs (per-slab CRC-32 of the "
            f"FULL collected output bytes) bitwise == uninjected twin; "
            f"plan-barrier resume bitwise == eager twin"),
    }


# ----------------------------------------------------------------------
# Storage-engine chaos (the reference bench's config 17)
# ----------------------------------------------------------------------

def run_store_campaign(workdir: str, *, rows: int = 20_000,
                       n_keys: int = 8, seed: int = 31,
                       segment_rows: int = 2_000,
                       n_streams: int = 24, resident_budget: int = 6,
                       events_per_stream: int = 14,
                       device=None) -> dict:
    """The storage-plane chaos campaign — transactional clustered
    write-back, background compaction, and the tiered cohort-state
    spill, under a kill/corrupt schedule, the cohorts on ``device``
    (the never-spilled twin on the same one).  Asserted HARD (a
    violation raises):

    * a mid-write kill resumes the staged generation with ZERO
      committed-segment re-writes (segment writes are call-counted),
      and the resumed table is bitwise-identical to an uninjected
      fresh write of the same frame; a kill between the commit record
      and the pointer swing resumes with zero segment writes at all;
    * while a write is staged or killed, readers see EXACTLY the old
      generation — and a foreign resume frame, a torn commit record, a
      corrupt pointer, and a corrupt committed segment are each
      refused BY NAME (classified PERMANENT / CORRUPTED_ARTIFACT,
      never transient);
    * the legacy ``io.writer.write`` overwrite survives kills at every
      stage: mid-build, mid-fsync, and BETWEEN the two swap renames
      (the old table is readable at every probe — the seed-era
      rmtree-then-rewrite data-loss window is gone);
    * a compaction kill leaves the table at exactly generation N; the
      re-issued compaction commits N+1; a reader holding N's dataset
      path stays bitwise-correct after N+1 commits (never a blend);
    * an over-memory cohort sweep (``resident_budget`` slots for
      ``n_streams`` streams under Poisson load) spills cold members to
      CRC'd artifacts and faults them back in on their next tick, with
      the FULL per-tick emission history bitwise-identical to a
      never-spilled twin; corrupt and foreign member artifacts are
      refused by name, rejecting only their own member's ticks.
    """
    import shutil

    import pandas as pd

    from tempo_tpu_torch import resilience
    from tempo_tpu_torch.io import writer
    from tempo_tpu_torch.resilience import FailureKind
    from tempo_tpu_torch.store import engine as store_engine
    from tempo_tpu_torch.store.compact import compact as store_compact

    dev = device_policy.resolve(device)
    t_start = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    wh = os.path.join(workdir, "warehouse")
    store = store_engine.Store(wh)

    def mk_df(salt: float) -> "pd.DataFrame":
        r = np.random.default_rng(seed + int(salt * 1000))
        return pd.DataFrame({
            "symbol": r.choice([f"s{k:03d}" for k in range(n_keys)],
                               rows),
            "event_ts": pd.to_datetime(
                np.sort(r.integers(0, 10 ** 6, rows)) * 1_000_000_000),
            "px": r.standard_normal(rows),
        })

    def sorted_twin(df):
        return df.sort_values(["symbol"], kind="stable").reset_index(
            drop=True)

    # -- phase 1: write kill -> resume, zero committed re-writes ------
    df0 = mk_df(0.0)
    store.write_table("orders", df0, ["symbol"], source_fp="base",
                      segment_rows=segment_rows)
    df1 = mk_df(1.0)
    n_segments = -(-rows // segment_rows)
    kill_at = max(2, n_segments // 2)
    try:
        with faults.FaultInjector().kill_on_call(
                store_engine, "_write_segment", call_no=kill_at):
            store.write_table("orders", df1, ["symbol"],
                              source_fp="v1", segment_rows=segment_rows)
        raise AssertionError("write kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    # killed mid-write: readers still see the OLD generation, bitwise
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  sorted_twin(df0))
    with faults.FaultInjector().flaky(
            store_engine, "_write_segment", failures=0) as fi:
        stats = store.write_table("orders", df1, ["symbol"],
                                  source_fp="v1",
                                  segment_rows=segment_rows)
    rewrites = len(fi.records)
    assert stats["resumed"] and stats["segments_rewritten"] == 0
    assert stats["segments_reused"] == kill_at - 1, stats
    assert rewrites == n_segments - (kill_at - 1), (rewrites, stats)
    # bitwise vs an uninjected fresh write of the same frame
    fresh = store_engine.Store(os.path.join(workdir, "wh_twin"))
    fresh.write_table("orders", df1, ["symbol"], source_fp="v1",
                      segment_rows=segment_rows)
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  fresh.read("orders", verify=True))
    # kill AFTER the commit record, before the pointer swing: the
    # re-issue verifies + swings with ZERO segment writes
    df2 = mk_df(2.0)
    try:
        with faults.FaultInjector().kill_on_call(
                store_engine, "_swing_pointer", call_no=1):
            store.write_table("orders", df2, ["symbol"],
                              source_fp="v2", segment_rows=segment_rows)
        raise AssertionError("pointer-swing kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    pd.testing.assert_frame_equal(store.read("orders"),
                                  sorted_twin(df1))   # still v1
    with faults.FaultInjector().flaky(
            store_engine, "_write_segment", failures=0) as fi:
        stats2 = store.write_table("orders", df2, ["symbol"],
                                   source_fp="v2",
                                   segment_rows=segment_rows)
    assert len(fi.records) == 0, "post-commit resume rewrote segments"
    assert stats2["resumed"] and stats2["segments_reused"] == n_segments
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  sorted_twin(df2))

    # -- phase 2: refusal matrix (all BY NAME, correctly classified) --
    refusals: Dict[str, str] = {}
    df3 = mk_df(3.0)
    try:
        with faults.FaultInjector().kill_on_call(
                store_engine, "_write_segment", call_no=2):
            store.write_table("orders", df3, ["symbol"],
                              source_fp="v3", segment_rows=segment_rows)
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    try:
        store.write_table("orders", mk_df(4.0), ["symbol"],
                          source_fp="OTHER",
                          segment_rows=segment_rows)
        raise AssertionError("foreign staged resume was admitted")
    except store_engine.StoreError as e:
        assert resilience.classify(e) is FailureKind.PERMANENT
        assert "DIFFERENT write" in str(e)
        refusals["foreign_staged_write"] = "PERMANENT"
    assert store.discard_staging("orders")
    gen, _ = store.current("orders")
    gen_dir = os.path.join(store.table_path("orders"), gen)
    commit_path = os.path.join(gen_dir, store_engine.COMMIT_NAME)
    blob = open(commit_path, "rb").read()
    with open(commit_path, "wb") as f:
        f.write(blob[: len(blob) // 2])          # torn commit record
    try:
        store.read("orders")
        raise AssertionError("torn commit record was admitted")
    except store_engine.StoreCommitError as e:
        k = resilience.classify(e)
        assert k is FailureKind.CORRUPTED_ARTIFACT, k
        refusals["torn_commit_record"] = "CORRUPTED_ARTIFACT"
    with open(commit_path, "wb") as f:
        f.write(blob)
    cur_path = os.path.join(store.table_path("orders"),
                            store_engine.CURRENT_NAME)
    cur_blob = open(cur_path, "rb").read()
    with open(cur_path, "wb") as f:
        f.write(b'{"generation": "gen_99999999", "commit_crc": 1}')
    try:
        store.read("orders")
        raise AssertionError("dangling pointer was admitted")
    except store_engine.StoreCommitError:
        refusals["corrupt_pointer"] = "CORRUPTED_ARTIFACT"
    with open(cur_path, "wb") as f:
        f.write(cur_blob)
    seg_path = os.path.join(gen_dir, store_engine._seg_name(0))
    seg_off = max(0, os.path.getsize(seg_path) // 2)
    faults.flip_byte(seg_path, offset=seg_off)
    try:
        store.read("orders", verify=True)
        raise AssertionError("corrupt committed segment passed verify")
    except store_engine.StoreCommitError as e:
        assert store_engine._seg_name(0) in str(e)
        refusals["corrupt_committed_segment"] = "CORRUPTED_ARTIFACT"
    faults.flip_byte(seg_path, offset=seg_off)   # XOR twice = restore
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  sorted_twin(df2))

    # -- phase 3: legacy writer overwrite survives every kill stage --
    from tempo_tpu_torch.frame import TSDF
    base_dir = os.path.join(workdir, "legacy_wh")
    dfa = mk_df(5.0)
    dfb = mk_df(6.0)
    tsa = TSDF(dfa, ts_col="event_ts", partition_cols=["symbol"],
               device=dev)
    tsb = TSDF(dfb, ts_col="event_ts", partition_cols=["symbol"],
               device=dev)
    writer.write(tsa, "legacy", base_dir=base_dir, format="delta")
    old_px = np.sort(dfa.px.to_numpy())

    def legacy_survives(tag: str) -> None:
        got = writer.read("legacy", partition_cols=["symbol"],
                          base_dir=base_dir, device=dev)
        np.testing.assert_array_equal(
            np.sort(got.df.px.to_numpy()), old_px,
            err_msg=f"old table lost after kill {tag}")

    survived = []
    try:                                     # kill mid-build
        with faults.FaultInjector().kill_on_call(
                writer, "_write_delta", call_no=1):
            writer.write(tsb, "legacy", base_dir=base_dir,
                         format="delta")
        raise AssertionError("mid-build kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    legacy_survives("mid-build")
    survived.append("mid-build")
    try:                                     # kill mid-fsync
        with faults.FaultInjector().kill_on_call(
                writer, "_fsync_tree", call_no=1):
            writer.write(tsb, "legacy", base_dir=base_dir,
                         format="delta")
        raise AssertionError("mid-fsync kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    legacy_survives("mid-fsync")
    survived.append("mid-fsync")
    try:                                     # kill BETWEEN the swaps
        with faults.FaultInjector().kill_on_call(
                writer.os, "replace", call_no=2):
            writer.write(tsb, "legacy", base_dir=base_dir,
                         format="delta")
        raise AssertionError("mid-swap kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    legacy_survives("mid-swap (.bak fallback)")
    survived.append("mid-swap")
    writer.write(tsb, "legacy", base_dir=base_dir, format="delta")
    got = writer.read("legacy", partition_cols=["symbol"],
                      base_dir=base_dir, device=dev)
    np.testing.assert_array_equal(np.sort(got.df.px.to_numpy()),
                                  np.sort(dfb.px.to_numpy()))

    # -- phase 4: compaction under live traffic, killed mid-merge ----
    gen_n, commit_n = store.current("orders")
    reader_path = store.dataset_path("orders")   # a live reader on N
    segs_before = len(commit_n["segments"])
    reader_df = store_engine.read_dataset_df(reader_path)
    try:
        with faults.FaultInjector().kill_on_call(
                store_engine, "_write_segment",
                call_no=1):
            store_compact("orders", base_dir=wh, min_segments=2)
        raise AssertionError("compaction kill did not land")
    except faults.SimulatedKill:
        pass
    _no_open_capture(dev)
    # table is EXACTLY generation N (pointer untouched, reads bitwise)
    assert store.current("orders")[0] == gen_n
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  sorted_twin(df2))
    cstats = store_compact("orders", base_dir=wh, min_segments=2)
    gen_n1 = store.current("orders")[0]
    assert gen_n1 != gen_n and cstats["compacted_from"] == gen_n
    assert cstats["segments"] < segs_before
    # reader holding N's path is still bitwise-correct after N+1
    pd.testing.assert_frame_equal(
        store_engine.read_dataset_df(reader_path), reader_df)
    pd.testing.assert_frame_equal(store.read("orders", verify=True),
                                  sorted_twin(df2))

    # -- phase 5: over-memory cohort sweep under Poisson load --------
    from tempo_tpu_torch.serve import StreamCohort

    events = make_events(rng, n_streams, events_per_stream,
                         left_frac=0.15)

    def mk(budget: int, tag: str) -> "StreamCohort":
        return StreamCohort(
            ("px",), window_secs=10.0, window_rows_bound=8,
            ema_alpha=0.2, max_lookback=16, slots=4,
            spill_dir=(os.path.join(workdir, f"spill_{tag}")
                       if budget else None),
            resident_budget=budget, device=dev)

    def feed(cohort, record_lat: bool):
        for s in range(n_streams):
            cohort.add_stream(f"u{s}", ["s0"])
        history = [[] for _ in range(n_streams)]
        cold_lat, hot_lat = [], []
        pos = [0] * n_streams
        live = [s for s in range(n_streams) if events[s]]
        while live:
            nxt = []
            for s in live:
                kind, ts, val = events[s][pos[s]]
                m = cohort.stream(f"u{s}")
                was_cold = not m.resident
                t0 = time.perf_counter()
                if kind == "right":
                    r = m.push(["s0"], [ts],
                               {"px": np.float32(val)})
                else:
                    r = m.push_left(["s0"], [ts])
                dt = time.perf_counter() - t0
                if record_lat:
                    (cold_lat if was_cold else hot_lat).append(dt)
                history[s].append(
                    {k: np.asarray(v).copy() for k, v in r.items()})
                pos[s] += 1
                if pos[s] < len(events[s]):
                    nxt.append(s)
            live = nxt
        return history, cold_lat, hot_lat

    twin = mk(0, "never")
    golden, _, _ = feed(twin, record_lat=False)
    spill_t0 = time.perf_counter()
    cohort = mk(resident_budget, "lru")
    hist, cold_lat, hot_lat = feed(cohort, record_lat=True)
    spill_wall = time.perf_counter() - spill_t0
    st = cohort.spill_stats
    assert st["spills"] > 0 and st["restores"] > 0, st
    assert st["resident"] <= resident_budget, st
    for s in range(n_streams):
        assert len(hist[s]) == len(golden[s])
        for a, b in zip(hist[s], golden[s]):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k], equal_nan=True), \
                    (s, k)

    def p99(lat):
        return (round(float(np.percentile(lat, 99)) * 1e3, 3)
                if lat else None)

    # corrupt member artifact: refused by name, only ITS ticks fail
    victim = next(iter(cohort._spilled))
    art = cohort._spilled[victim]
    npzs = [os.path.join(art, f) for f in os.listdir(art)
            if f.endswith(".npz")]
    faults.flip_byte(npzs[0], offset=os.path.getsize(npzs[0]) // 2)
    try:
        cohort.stream(victim).push(["s0"], [np.int64(10 ** 15)],
                                   {"px": np.float32(1.0)})
        raise AssertionError("corrupt member artifact was admitted")
    except CheckpointError:
        refusals["corrupt_member_artifact"] = "CORRUPTED_ARTIFACT"
    resident_name = next(n for n, m in cohort._members.items()
                         if m.resident)
    r = cohort.stream(resident_name).push(
        ["s0"], [np.int64(10 ** 15)], {"px": np.float32(1.0)})
    assert r and not isinstance(r, Exception)
    # foreign member artifact (another member's state under this
    # member's path): refused by name
    others = [n for n in cohort._spilled if n != victim]
    shutil.rmtree(art)
    shutil.copytree(cohort._spilled[others[0]], art)
    try:
        cohort.stream(victim).push(["s0"], [np.int64(10 ** 15) + 1],
                                   {"px": np.float32(1.0)})
        raise AssertionError("foreign member artifact was admitted")
    except CheckpointError as e:
        assert "FOREIGN" in str(e)
        refusals["foreign_member_artifact"] = "PERMANENT"

    total_ticks = sum(len(h) for h in hist)
    wall = time.perf_counter() - t_start
    return {
        "rows": rows,
        "segments": n_segments,
        "wall_s": round(wall, 1),
        "write_resume": {
            "killed_at_segment": kill_at,
            "segments_reused": kill_at - 1,
            "segments_rewritten_committed": 0,
            "segments_written_on_resume": rewrites,
            "pointer_swing_resume_segment_writes": 0,
            "value_audit": "resumed write bitwise == uninjected "
                           "fresh write (assert_frame_equal "
                           "check_exact)",
        },
        "refusals_by_name": refusals,
        "legacy_overwrite": {
            "kills_survived": survived,
            "old_table_lost": False,
        },
        "compaction": {
            "killed_mid_merge": True,
            "state_after_kill": "generation N exactly",
            "segments_before": segs_before,
            "segments_after": cstats["segments"],
            "reader_on_old_generation": "bitwise after N+1 commit",
        },
        "cohort_spill": {
            "streams_registered": n_streams,
            "resident_budget": resident_budget,
            "ticks": total_ticks,
            "spills": st["spills"],
            "restores": st["restores"],
            "ticks_per_sec": round(total_ticks / spill_wall, 1),
            "cold_tick_p99_ms": p99(cold_lat),
            "hot_tick_p99_ms": p99(hot_lat),
            "value_audit": "full per-tick emission history bitwise "
                           "== never-spilled twin",
        },
        "no_silent_restores": True,
    }
