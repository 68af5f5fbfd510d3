"""The port's multi-tenant query service (``tempo_tpu_torch/service/``)
on the CPU, against the reference's (``tempo_tpu/service/``).

Counterparts of ``tests/test_service.py``'s 23 cases: the shared
single-flight executable cache, admission control, fair scheduling and
failure isolation, with the port's frames on ``device="cpu"`` (the
kernels' plain versions).  Held against the reference in one process:

* device-memory footprints equal the reference's ``hbm_bytes`` for the
  same chains (the same ``K * L * (8 + 5 * planes)`` model);
* the shared-memory projection follows the port's Hopper design
  (``service/admission.py``: the largest block of any form the kernels
  plan, against ``ops.stream.SMEM_LIMIT``), not the TPU's VMEM blocks;
* service answers equal the reference service's within rtol = atol =
  1e-9 (the planner tests' tolerance; keys, timestamps and joined
  values equal), and are bitwise equal across tenants.

Every ``result()`` and ``join()`` carries a timeout.
"""

import queue as queue_mod
import threading
import time

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.plan import cache as ref_cache
from tempo_tpu.service import QueryService as RefQueryService
from tempo_tpu.service import lazy_frame as ref_lazy_frame
from tempo_tpu.service import project_footprint as ref_project_footprint
from tempo_tpu_torch import TSDF, profiling
from tempo_tpu_torch.ops import merge as ops_merge
from tempo_tpu_torch.ops import stream as ops_stream
from tempo_tpu_torch.ops import window as ops_window
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import executor as plan_executor
from tempo_tpu_torch.service import (AdmissionError, QueryService, admission,
                                     lazy_frame, project_footprint)
from tempo_tpu_torch.testing.faults import FaultInjector, InjectedFault

RTOL = ATOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_cache():
    plan_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()


def _df(cols, K=4, L=64, seed=0):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, L)), axis=-1)
    data = {"sym": np.repeat(np.arange(K), L),
            "event_ts": secs.ravel().astype(np.int64)}
    for c in cols:
        data[c] = rng.standard_normal(K * L)
    return pd.DataFrame(data)


def _frame(cols, K=4, L=64, seed=0):
    return TSDF(_df(cols, K, L, seed), "event_ts", ["sym"], device="cpu")


def _ref_frame(cols, K=4, L=64, seed=0):
    return tempo_tpu.TSDF(_df(cols, K, L, seed), "event_ts", ["sym"])


def _query(left, right):
    return (lazy_frame(left).asofJoin(right)
            .withRangeStats(colsToSummarize=["x"],
                            rangeBackWindowSecs=10))


def _ref_query(left, right):
    return (ref_lazy_frame(left).asofJoin(right)
            .withRangeStats(colsToSummarize=["x"],
                            rangeBackWindowSecs=10))


def _assert_close_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        a, b = got[c].to_numpy(), want[c].to_numpy()
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=c)
        else:
            assert (pd.Series(a) == pd.Series(b)).all(), c


# ----------------------------------------------------------------------
# PlanCache: single-flight + per-signature / per-tenant counters
# ----------------------------------------------------------------------

def test_single_flight_builds_once_under_contention():
    cache = plan_cache.PlanCache()
    built = []
    gate = threading.Event()

    def build():
        gate.wait(5)
        time.sleep(0.02)                 # widen the race window
        built.append(object())
        return built[-1]

    results = []

    def worker():
        results.append(cache.get_or_build(("sig", "k"), build))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert len(built) == 1
    assert all(r is built[0] for r in results)
    st = cache.stats()
    assert st["builds"] == 1 and st["misses"] == 1
    assert st["hits"] == 7


def test_single_flight_failed_build_releases_the_claim():
    cache = plan_cache.PlanCache()
    calls = []

    def flaky_build():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("poisoned build")
        return "exe"

    with pytest.raises(RuntimeError, match="poisoned build"):
        cache.get_or_build(("sig",), flaky_build)
    # the claim is released: the next caller retries as the builder
    assert cache.get_or_build(("sig",), flaky_build) == "exe"
    assert len(calls) == 2


def test_insert_failure_releases_single_flight_claim(monkeypatch):
    """insert() raising (malformed cache-size env var) must release
    the build claim — otherwise every waiter on that key hangs."""
    cache = plan_cache.PlanCache()
    monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", "not-a-number")
    with pytest.raises(ValueError):
        cache.get_or_build(("sig",), lambda: "exe")
    monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", "8")
    assert cache.get_or_build(("sig",), lambda: "exe2") == "exe2"


def test_per_signature_and_per_tenant_counters():
    cache = plan_cache.PlanCache()
    with plan_cache.tenant_scope("alice"):
        cache.get_or_build(("sigA",), lambda: "a")
        cache.get_or_build(("sigA",), lambda: "a")
    with plan_cache.tenant_scope("bob"):
        cache.get_or_build(("sigA",), lambda: "a")
        cache.get_or_build(("sigB",), lambda: "b")
    st = cache.stats()
    assert st["by_signature"]["sigA"]["builds"] == 1
    assert st["by_signature"]["sigA"]["hits"] == 2
    assert st["by_signature"]["sigB"]["builds"] == 1
    assert st["by_tenant"]["alice"] == {"hits": 1, "misses": 1,
                                        "builds": 1}
    assert st["by_tenant"]["bob"] == {"hits": 1, "misses": 1,
                                      "builds": 1}


def test_plan_cache_stats_exposes_breakdowns():
    st = profiling.plan_cache_stats()
    assert "by_signature" in st and "by_tenant" in st


# ----------------------------------------------------------------------
# QueryService basics
# ----------------------------------------------------------------------

def test_concurrent_tenants_share_one_build():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with QueryService(workers=4) as svc:
        tickets = [svc.submit(f"t{i % 4}", _query(left, right))
                   for i in range(12)]
        results = [t.result(timeout=120) for t in tickets]
        st = svc.stats()
    pc = st["plan_cache"]
    assert pc["builds"] == 1, pc
    assert pc["hits"] == 11
    assert st["starvation_ratio"] == 1.0
    ref = results[0].df
    for r in results[1:]:
        pd.testing.assert_frame_equal(ref, r.df, check_exact=True)
    # the reference's service on the same inputs: the same counters
    # and the same answer
    ref_cache.CACHE.clear()
    try:
        rl, rr = _ref_frame(["x"], seed=1), _ref_frame(["v"], seed=2)
        with RefQueryService(workers=4) as rsvc:
            rt = [rsvc.submit(f"t{i % 4}", _ref_query(rl, rr))
                  for i in range(12)]
            rres = [t.result(timeout=120) for t in rt]
            rst = rsvc.stats()
    finally:
        ref_cache.CACHE.clear()
    assert rst["plan_cache"]["builds"] == pc["builds"]
    assert rst["plan_cache"]["hits"] == pc["hits"]
    _assert_close_frames(ref, rres[0].df)


def test_submit_after_close_raises():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    svc = QueryService(workers=1)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("t0", _query(left, right))


def test_submit_rejects_non_lazy_queries():
    svc = QueryService(workers=1)
    try:
        with pytest.raises(TypeError, match="lazy chain"):
            svc.submit("t0", _frame(["x"]))
    finally:
        svc.close()


# ----------------------------------------------------------------------
# Admission control
# ----------------------------------------------------------------------

def test_footprint_projection_scales_with_shape():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    small = project_footprint(_query(left, right).plan)
    big_l = _frame(["x"], L=512, seed=1)
    big_r = _frame(["v"], L=512, seed=2)
    big = project_footprint(_query(big_l, big_r).plan)
    assert small.hbm_bytes > 0 and small.vmem_bytes > 0
    assert big.hbm_bytes > small.hbm_bytes
    assert big.vmem_bytes >= small.vmem_bytes
    # device memory: the reference's model, byte for byte
    for L, port_fp in ((64, small), (512, big)):
        ref_fp = ref_project_footprint(_ref_query(
            _ref_frame(["x"], L=L, seed=1),
            _ref_frame(["v"], L=L, seed=2)).plan)
        assert port_fp.hbm_bytes == ref_fp.hbm_bytes
    # shared memory: the largest block of the join's and range stats'
    # forms at the packed length, within one block's limit
    assert small.vmem_bytes == max(admission.ASOF_SMEM,
                                   admission.range_stats_smem(64))
    assert big.vmem_bytes == max(admission.ASOF_SMEM,
                                 admission.range_stats_smem(512))
    assert big.vmem_bytes <= ops_stream.SMEM_LIMIT


def test_host_frame_footprint_counts_real_columns():
    """A bare host frame's HBM projection must scale with its actual
    value-column count, not the 2-plane fallback — a wide frame
    projected at 2 planes lets admission over-admit."""
    from tempo_tpu_torch import packing

    wide = _frame([f"c{i}" for i in range(12)], seed=1)
    narrow = _frame(["x"], seed=1)
    fp_wide = project_footprint(lazy_frame(wide).plan)
    fp_narrow = project_footprint(lazy_frame(narrow).plan)
    assert fp_wide.hbm_bytes > fp_narrow.hbm_bytes
    L = packing.pad_length(64)
    # ts i64 + (value f32 + validity bool) per value column
    assert fp_narrow.hbm_bytes == 4 * L * (8 + 5 * 1)
    assert fp_wide.hbm_bytes == 4 * L * (8 + 5 * 12)
    # intermediates derive from the same model: an op node over the
    # wide host source projects its real plane count, not the 2-plane
    # fallback (the source leaf makes the whole chain derivable)
    from tempo_tpu_torch.plan import optimizer

    stats_node = (lazy_frame(wide)
                  .withRangeStats(colsToSummarize=["c0"],
                                  rangeBackWindowSecs=10).plan)
    assert optimizer._device_plane_count(stats_node) is not None
    assert optimizer._device_plane_count(stats_node) > 12
    for cols, fp in (([f"c{i}" for i in range(12)], fp_wide),
                     (["x"], fp_narrow)):
        ref_fp = ref_project_footprint(
            ref_lazy_frame(_ref_frame(cols, seed=1)).plan)
        assert fp.hbm_bytes == ref_fp.hbm_bytes


def test_over_vmem_query_is_rejected_named_not_queued():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with QueryService(workers=1, vmem_budget=64) as svc:
        t0 = time.perf_counter()
        with pytest.raises(AdmissionError, match="VMEM"):
            svc.submit("t0", _query(left, right))
        assert time.perf_counter() - t0 < 5      # immediate, not queued
        st = svc.stats()
    assert st["tenants"]["t0"]["rejected"] == 1
    assert st["tenants"]["t0"]["completed"] == 0


def test_over_total_hbm_query_is_rejected():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with QueryService(workers=1, hbm_budget=128) as svc:
        with pytest.raises(AdmissionError, match="TOTAL"):
            svc.submit("t0", _query(left, right))


def test_queued_query_runs_after_budget_frees():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    fp = project_footprint(_query(left, right).plan)
    # budget admits exactly ONE query at a time; three must still all
    # complete, serialized by admission (release -> re-check)
    with QueryService(workers=2,
                      hbm_budget=int(fp.hbm_bytes * 1.5)) as svc:
        tickets = [svc.submit("t0", _query(left, right))
                   for _ in range(3)]
        results = [t.result(timeout=120) for t in tickets]
        st = svc.stats()
    assert st["tenants"]["t0"]["completed"] == 3
    assert st["hbm_in_use"] == 0
    ref = results[0].df
    for r in results[1:]:
        pd.testing.assert_frame_equal(ref, r.df, check_exact=True)


# ----------------------------------------------------------------------
# Fairness + backpressure
# ----------------------------------------------------------------------

def _blocked_executor(monkeypatch):
    """Patch plan execution to wait on a gate — lets tests stack the
    queues deterministically before any dispatch completes."""
    gate = threading.Event()
    original = plan_executor.execute

    def gated(root):
        gate.wait(30)
        return original(root)

    monkeypatch.setattr(plan_executor, "execute", gated)
    return gate


def test_tenant_quota_backpressure(monkeypatch):
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    gate = _blocked_executor(monkeypatch)
    svc = QueryService(workers=1, tenant_quota=2)
    try:
        t1 = svc.submit("t0", _query(left, right))
        # wait until the worker has POPPED t1 and sits blocked inside
        # execution — from here the queue can only grow
        deadline = time.perf_counter() + 10
        while t1.t_start is None:
            assert time.perf_counter() < deadline, "worker never started"
            time.sleep(0.005)
        tickets = [t1,
                   svc.submit("t0", _query(left, right)),
                   svc.submit("t0", _query(left, right))]  # at quota
        with pytest.raises(queue_mod.Full, match="quota"):
            svc.submit("t0", _query(left, right), timeout=0.05)
        gate.set()
        for t in tickets:
            t.result(timeout=120)
    finally:
        gate.set()
        svc.close()


def test_quota_blocked_submitter_survives_queue_drain(monkeypatch):
    """A submitter blocked at quota must append into the LIVE deque
    after waking: if the scheduler pruned the tenant's drained deque
    while the submitter slept, the woken append would land in an
    orphaned deque the picker never scans — a silently lost query whose
    ticket blocks forever."""
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    gate = _blocked_executor(monkeypatch)
    svc = QueryService(workers=1, tenant_quota=1)
    try:
        t1 = svc.submit("t0", _query(left, right))
        deadline = time.perf_counter() + 10
        while t1.t_start is None:        # t1 popped; queue is empty
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        t2 = svc.submit("t0", _query(left, right))   # queue at quota
        slot = []

        def blocked_submit():
            slot.append(svc.submit("t0", _query(left, right)))

        th = threading.Thread(target=blocked_submit)
        th.start()
        time.sleep(0.2)                  # t3's submitter is in wait()
        assert not slot                  # …still blocked at quota
        gate.set()                       # t1 completes; t2 dispatches,
        th.join(30)                      # draining the deque; t3 wakes
        assert not th.is_alive()
        assert slot, "blocked submitter never returned"
        for t in (t1, t2, slot[0]):
            t.result(timeout=60)
        st = svc.stats()
    finally:
        gate.set()
        svc.close()
    assert st["tenants"]["t0"]["completed"] == 3


def test_reservation_clock_starts_at_head_not_at_submit(monkeypatch):
    """A query that aged behind its OWN tenant's earlier queries must
    not freeze service-wide dispatch the instant it reaches the head:
    the reservation clock starts when it first fails ``fits_now()`` as
    head, not at submit."""
    small_l, small_r = _frame(["x"], L=64, seed=1), _frame(["v"], L=64,
                                                           seed=2)
    big_l, big_r = _frame(["x"], L=256, seed=3), _frame(["v"], L=256,
                                                        seed=4)
    fp_small = project_footprint(_query(small_l, small_r).plan)
    fp_big = project_footprint(_query(big_l, big_r).plan)
    # geometry: big alone fits; big + one small does not; two smalls do
    budget = fp_big.hbm_bytes + fp_small.hbm_bytes // 2
    assert 2 * fp_small.hbm_bytes <= budget
    sem = threading.Semaphore(0)
    original = plan_executor.execute

    def gated(root):
        assert sem.acquire(timeout=60)
        return original(root)

    monkeypatch.setattr(plan_executor, "execute", gated)
    svc = QueryService(workers=2, hbm_budget=budget, reserve_after_s=2.0)
    try:
        s1 = svc.submit("busy", _query(small_l, small_r))
        s2 = svc.submit("busy", _query(small_l, small_r))
        deadline = time.perf_counter() + 10
        while s1.t_start is None or s2.t_start is None:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        # big queues behind nothing dispatchable and AGES past
        # reserve_after_s before any picker ever sees it as a
        # failing head
        big = svc.submit("busy", _query(big_l, big_r))
        time.sleep(2.5)
        sem.release()                    # one small drains its budget
        deadline = time.perf_counter() + 10
        while not (s1.done() or s2.done()):
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        # big's head-check now fails fits_now with t_submit 2.5 s old:
        # a submit-based clock would reserve instantly and freeze this
        # fitting query; the head-based clock dispatches it promptly
        other = svc.submit("other", _query(small_l, small_r))
        deadline = time.perf_counter() + 1.5    # well under 2.0 s
        while other.t_start is None:
            assert time.perf_counter() < deadline, \
                "fitting query frozen by a never-head-starved reservation"
            time.sleep(0.005)
        sem.release(8)                   # drain everything
        for t in (s1, s2, big, other):
            t.result(timeout=120)
    finally:
        sem.release(16)
        svc.close()


def test_close_timeout_is_a_shared_deadline(monkeypatch):
    """close(timeout) bounds the WHOLE drain: with W gated workers the
    call must return in ~timeout, not W x timeout."""
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    gate = _blocked_executor(monkeypatch)
    svc = QueryService(workers=4)
    tickets = [svc.submit("t0", _query(left, right)) for _ in range(4)]
    t0 = time.perf_counter()
    svc.close(timeout=1.0)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2.5, elapsed        # per-worker joins would be ~4 s
    gate.set()
    for t in tickets:                    # daemon workers still drain
        t.result(timeout=120)


def test_explicit_zero_budget_admits_nothing():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with QueryService(workers=1, hbm_budget=0) as svc:
        with pytest.raises(AdmissionError):
            svc.submit("t0", _query(left, right))


def test_new_tenant_joins_at_token_floor(monkeypatch):
    """A tenant first seen after hours of service must NOT get
    absolute priority until token parity: newcomers join at the floor
    of the live token counts, so dispatch interleaves instead of
    draining the newcomer's whole backlog first."""
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    gate = threading.Event()
    gate.set()
    original = plan_executor.execute

    def gated(root):
        gate.wait(30)
        return original(root)

    monkeypatch.setattr(plan_executor, "execute", gated)
    svc = QueryService(workers=1)
    try:
        for _ in range(4):                    # veteran earns 4 tokens
            svc.submit("vet", _query(left, right)).result(timeout=120)
        gate.clear()                          # block the worker…
        hold = svc.submit("vet", _query(left, right))
        deadline = time.perf_counter() + 10
        while hold.t_start is None:           # …mid-dispatch
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        new = [svc.submit("newbie", _query(left, right))
               for _ in range(3)]
        vet = [svc.submit("vet", _query(left, right))
               for _ in range(3)]
        gate.set()
        for t in new + vet + [hold]:
            t.result(timeout=120)
        # floor join: newbie starts at vet's token count, so vet's
        # queued work interleaves — its first follow-up starts before
        # newbie's backlog fully drains (tokens from 0 would run all
        # three newbie queries first)
        assert min(t.t_start for t in vet) < max(t.t_start for t in new)
    finally:
        gate.set()
        svc.close()


def test_starved_large_query_reserves_budget(monkeypatch):
    """A large admitted query must not be starved by smaller queries
    re-consuming every freed HBM byte: past ``reserve_after_s`` the
    scheduler reserves — nothing smaller dispatches until the starved
    head fits."""
    small_l, small_r = _frame(["x"], L=64, seed=1), _frame(["v"], L=64,
                                                           seed=2)
    big_l, big_r = _frame(["x"], L=256, seed=3), _frame(["v"], L=256,
                                                        seed=4)
    fp_small = project_footprint(_query(small_l, small_r).plan)
    fp_big = project_footprint(_query(big_l, big_r).plan)
    assert fp_big.hbm_bytes > fp_small.hbm_bytes
    gate = _blocked_executor(monkeypatch)
    # budget: big alone fits; big + small does not; small + small does
    budget = fp_big.hbm_bytes + fp_small.hbm_bytes // 2
    svc = QueryService(workers=2, hbm_budget=budget, reserve_after_s=0.0)
    try:
        s1 = svc.submit("flood", _query(small_l, small_r))
        deadline = time.perf_counter() + 10
        while s1.t_start is None:         # worker holds fp_small
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        big = svc.submit("big", _query(big_l, big_r))     # cannot fit
        s2 = svc.submit("flood", _query(small_l, small_r))  # would fit
        time.sleep(0.3)
        # reservation active: s2 fits the free share but must NOT run
        # ahead of the starved big query
        assert s2.t_start is None and big.t_start is None
        gate.set()
        big.result(timeout=120)
        s2.result(timeout=120)
        assert big.t_start < s2.t_start
    finally:
        gate.set()
        svc.close()


def test_fair_scheduler_interleaves_tenants(monkeypatch):
    """A flooding tenant must not starve a light one: with the worker
    gated, 'heavy' enqueues 5 queries before 'light' enqueues 1 — the
    token accounting dispatches light's query second, not sixth."""
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    gate = _blocked_executor(monkeypatch)
    svc = QueryService(workers=1, tenant_quota=16)
    try:
        heavy = [svc.submit("heavy", _query(left, right))
                 for _ in range(5)]
        light = svc.submit("light", _query(left, right))
        gate.set()
        for t in heavy + [light]:
            t.result(timeout=120)
        starts = sorted(t.t_start for t in heavy)
        # light started before heavy's 3rd dispatch (fair interleave,
        # not FIFO behind the flood)
        assert light.t_start < starts[2], (light.t_start, starts)
        st = svc.stats()
    finally:
        gate.set()
        svc.close()
    assert st["tenants"]["light"]["completed"] == 1
    assert st["tenants"]["heavy"]["completed"] == 5


# ----------------------------------------------------------------------
# Failure isolation (chaos)
# ----------------------------------------------------------------------

@pytest.mark.chaos
def test_poisoned_query_fails_its_ticket_not_the_scheduler():
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with QueryService(workers=2) as svc:
        with FaultInjector() as fi:
            fi.flaky(plan_executor, "execute", failures=1)
            poisoned = svc.submit("evil", _query(left, right))
            with pytest.raises(InjectedFault):
                poisoned.result(timeout=120)
            # the scheduler survives: later queries (any tenant) run
            ok = svc.submit("good", _query(left, right))
            assert isinstance(ok.result(timeout=120), object)
        st = svc.stats()
    assert st["tenants"]["evil"]["failed"] == 1
    assert st["tenants"]["good"]["completed"] == 1
    assert st["hbm_in_use"] == 0         # the poisoned query released


@pytest.mark.chaos
def test_poisoned_build_does_not_wedge_single_flight_waiters():
    """Two tenants race the same signature; the first build dies.  The
    waiter must retry as the builder and succeed — nobody hangs."""
    left, right = _frame(["x"], seed=1), _frame(["v"], seed=2)
    with FaultInjector() as fi:
        fi.flaky(plan_executor.Executable, "run", failures=1)
        with QueryService(workers=2) as svc:
            tickets = [svc.submit(f"t{i}", _query(left, right))
                       for i in range(4)]
            outcomes = []
            for t in tickets:
                try:
                    t.result(timeout=120)
                    outcomes.append("ok")
                except InjectedFault:
                    outcomes.append("fault")
    assert outcomes.count("fault") == 1
    assert outcomes.count("ok") == 3


# ----------------------------------------------------------------------
# The shared-memory projection on Hopper (decision of service/admission)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("L", [8, 200, 512, 1000, 2048, 3000])
def test_range_stats_projection_is_the_largest_plannable_block(L):
    """The range-stats projection is the row form's window or the
    largest block ``ops.stream.range_plan`` stages at any row bound
    (every bound tried here), within one block's limit."""
    staged = [p.smem for mb in range(L)
              if (p := ops_stream.range_plan(mb, 0, L)) is not None]
    want = max([admission.RANGE_ROW_SMEM] + staged)
    assert admission.range_stats_smem(L) == want
    assert want <= ops_stream.SMEM_LIMIT


def test_shared_memory_constants_and_ema_ladder():
    # the row form's window and the tile join's tile are the figures
    # the wrappers plan with (chip_smoke.py holds all three projections
    # to the compiler's, cuda_lib.*_smem(), on the card)
    assert admission.RANGE_ROW_SMEM == ops_stream.window_bytes(
        ops_window.ROW_WINDOW) == 16 * 2305
    assert admission.ASOF_TILE_SMEM == (
        ops_merge.LOOKBACK_TILE * 32 + 256 * 4 + 32 * 4)
    assert admission.ASOF_WALK_SMEM > admission.ASOF_TILE_SMEM
    assert admission.ASOF_SMEM == admission.ASOF_WALK_SMEM
    # the EMA ladder: 8 bytes a lane of whole segments up to 16,384
    # lanes (HHAR's 12,760 lanes take 102 KB), then the windowed stages
    assert admission.ema_ladder_smem(12760) == 8 * 32 * 399
    assert admission.ema_ladder_smem(ops_stream.EMA_ROW_MAX) == 131072
    assert admission.ema_ladder_smem(1 << 24) == ops_stream.SMEM_LIMIT
    assert admission.vmem_budget_bytes() == ops_stream.SMEM_LIMIT


@pytest.mark.parametrize("source, name, want", [
    ("range_stats.cu", "kRowWindow", lambda: ops_window.ROW_WINDOW),
    ("asof_merge.cu", "kTileMax", lambda: ops_merge.LOOKBACK_TILE),
    ("asof_merge.cu", "kWalkCols", lambda: admission.WALK_COLS),
    ("asof_merge.cu", "kWalkStep", lambda: admission.WALK_STEP),
    ("asof_merge.cu", "kSegs", lambda: admission._WALK_SEGS),
])
def test_shared_memory_figures_follow_the_kernel_sources(source, name,
                                                         want):
    """The sizes admission's shared-memory figures are built from are
    the kernels' own ``constexpr`` sizes (evaluated from the source's
    arithmetic), so a layout change there fails here before the card's
    check."""
    import re
    from pathlib import Path

    text = (Path(ops_stream.__file__).resolve().parent.parent / "csrc"
            / source).read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    env = {}
    for k, expr in consts.items():
        try:
            env[k] = int(eval(expr, {}, dict(env)))  # noqa: S307
        except (NameError, SyntaxError):
            continue
    assert env[name] == want()


def test_vmem_budget_knob_and_explicit_zero(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_SERVICE_VMEM_BUDGET", "4096")
    assert admission.vmem_budget_bytes() == 4096
    monkeypatch.setenv("TEMPO_TPU_SERVICE_VMEM_BUDGET", "0")
    assert admission.AdmissionController().vmem_budget == 0
    monkeypatch.setenv("TEMPO_TPU_SERVICE_HBM_BUDGET", "123")
    assert admission.AdmissionController().hbm_budget == 123
    monkeypatch.delenv("TEMPO_TPU_SERVICE_HBM_BUDGET")
    assert admission.hbm_budget_bytes() == 2 << 30
