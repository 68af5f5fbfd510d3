"""The port's continuous queries (``tempo_tpu_torch/query/``) on the
CPU, against the reference's (``tempo_tpu/query/``).

Counterparts of ``tests/test_standing.py``'s 21 cases, with every
``StreamTable`` on ``device="cpu"`` (the serving planes' steps and
``ema_scan`` run their plain versions).  The contract under test: a
standing subscription's ``result()`` is bitwise what re-running the
registered canonical plan over the concatenated history produces at the
current push boundary, for every split mode, push split, NaN run,
sequence column and the join matrix, with no builds at steady state and
byte-identical tails across snapshot and resume.

Held against the reference in one process on the same seeded inputs:
keys, timestamps, row order and joined values equal; ``EMA_*`` columns
within the bound ``tests/test_torch_ema_scan.py`` states (XLA:CPU
contracts the reference's ``d * y + i`` into one FMA: ``1 / a`` ulps of
the series' largest ``|y|`` at float32).  Every ``result()``, ``get()``
and ``flush()`` carries a timeout.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu.query as ref_query
from tempo_tpu import checkpoint as ref_ckpt  # noqa: F401
from tempo_tpu_torch import checkpoint as ckpt
from tempo_tpu_torch import profiling
from tempo_tpu_torch.query import (StandingQueryEngine, StreamTable,
                                   resume_subscription,
                                   snapshot_subscription)
from tempo_tpu_torch.query import split as qsplit
from tempo_tpu_torch.query.standing import _run_batch
from tempo_tpu_torch.serve.stream import LateTickError

T_OUT = 120


def _table(*a, **kw):
    return StreamTable(*a, device="cpu", **kw)


def _ema_tol(df: pd.DataFrame, col: str, alpha: float) -> np.ndarray:
    """Per-row bound of an EMA column against the reference: ``1 / a``
    float32 ulps of the largest ``|y|`` of the row's series."""
    y = np.abs(df[col].to_numpy(np.float64))
    peak = pd.Series(np.where(np.isnan(y), 0.0, y)).groupby(
        df["sym"].to_numpy()).transform("max").to_numpy()
    return np.spacing(peak.astype(np.float32)).astype(np.float64) / alpha


def _assert_matches_ref(df, ref_df, alpha=None, ctx=""):
    assert list(df.columns) == list(ref_df.columns), ctx
    assert len(df) == len(ref_df), ctx
    for c in df.columns:
        a, b = df[c].to_numpy(), ref_df[c].to_numpy()
        if c.startswith("EMA_") and alpha is not None:
            tol = _ema_tol(ref_df, c, alpha)
            assert (np.isnan(a) == np.isnan(b)).all(), f"{ctx}{c}"
            ok = ~np.isnan(a)
            assert (np.abs(a[ok] - b[ok]) <= tol[ok]).all(), f"{ctx}{c}"
        elif a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), f"{ctx}{c}"
        else:
            pd.testing.assert_series_equal(df[c], ref_df[c],
                                           check_names=False)


def _mk(rng, n, t0, *, syms=("A", "B"), nan_p=0.0, seq=False):
    df = pd.DataFrame({
        "event_ts": pd.to_datetime(
            t0 + np.sort(rng.integers(0, 1000, n)), unit="s"),
        "sym": rng.choice(list(syms), n),
        "px": rng.normal(100, 5, n).astype(np.float64),
    })
    if nan_p:
        df.loc[rng.random(n) < nan_p, "px"] = np.nan
    if seq:
        df["seqno"] = np.arange(n, dtype=np.float64) + t0
    return df.sort_values("event_ts", kind="stable").reset_index(drop=True)


def _twin(eng, query, tables):
    """The batch twin: the canonical plan over the tables' unified
    snapshots, via the same executor the remainder path uses."""
    root = qsplit.canonicalize(eng._as_root(query))
    return _run_batch(root, {t.name: t.snapshot_df() for t in tables})


def _assert_bitwise(res_df, twin_df, ctx=""):
    assert list(res_df.columns) == list(twin_df.columns), ctx
    assert len(res_df) == len(twin_df), ctx
    for c in res_df.columns:
        a, b = res_df[c], twin_df[c]
        assert a.dtype == b.dtype, f"{ctx}{c}: {a.dtype} vs {b.dtype}"
        if a.dtype.kind == "f":
            assert a.to_numpy().tobytes() == b.to_numpy().tobytes(), \
                f"{ctx}{c} not bitwise"
        else:
            pd.testing.assert_series_equal(a, b, check_names=False)


# ---------------------------------------------------------------------
# EMA delta mode
# ---------------------------------------------------------------------


def test_ema_delta_bitwise_with_nans_and_catchup():
    rng = np.random.default_rng(0)
    t = _table("trades", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 50, 0, syms=("A", "B", "C"), nan_p=0.15))
    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        assert sub.mode == "delta", sub.reason
        for k in range(6):
            eng.push(t, _mk(rng, 17, 2000 + 3000 * k,
                            syms=("A", "B", "C"), nan_p=0.15))
        assert eng.flush(timeout=T_OUT)
        res = sub.result(timeout=T_OUT)
        _assert_bitwise(res.df, _twin(eng, frame, [t]).df)
        kinds = [n.kind for n in sub.drain()]
        assert kinds[0] == "catchup" and kinds.count("delta") == 6


@pytest.mark.parametrize("splits", [
    [95],                        # one push
    [1] * 5 + [30] * 3,          # singleton then chunks
    [10, 40, 10, 20, 15],        # mixed
])
def test_ema_split_invariance(splits):
    """Arbitrary push splits of the SAME row stream produce the same
    bytes — the sequential-scan carry is split-invariant."""
    rng = np.random.default_rng(7)
    rows = _mk(rng, sum(splits), 0, nan_p=0.1)
    ref = None
    t = _table("s", "event_ts", ["sym"], ["px"])
    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        at = 0
        for n in splits:
            eng.push(t, rows.iloc[at:at + n].reset_index(drop=True))
            at += n
        assert eng.flush(timeout=T_OUT)
        res = sub.result(timeout=T_OUT)
        _assert_bitwise(res.df, _twin(eng, frame, [t]).df,
                        ctx=f"splits={splits}: ")
        ref = res.df["EMA_px"].to_numpy().tobytes()
    # and identical to the one-shot batch over the raw rows
    t2 = _table("s", "event_ts", ["sym"], ["px"])
    t2.append(rows)
    with StandingQueryEngine() as eng2:
        twin = _twin(eng2, t2.frame().EMA("px", exp_factor=0.3,
                                          exact=True), [t2])
        assert twin.df["EMA_px"].to_numpy().tobytes() == ref


def test_ema_with_sequence_col_and_select_suffix():
    rng = np.random.default_rng(2)
    t = _table("t3", "event_ts", ["sym"], ["px"],
                    sequence_col="seqno")
    t.append(_mk(rng, 30, 0, seq=True))
    with StandingQueryEngine() as eng:
        frame = (t.frame().EMA("px", exp_factor=0.25, exact=True)
                 .select("event_ts", "sym", "seqno", "EMA_px"))
        sub = eng.register(frame)
        assert sub.mode == "delta", sub.reason
        for k in range(3):
            eng.push(t, _mk(rng, 10, 2000 + 2000 * k, seq=True))
        assert eng.flush(timeout=T_OUT)
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [t]).df)


# ---------------------------------------------------------------------
# stateless and remainder modes
# ---------------------------------------------------------------------


def test_stateless_select_bitwise():
    rng = np.random.default_rng(2)
    t = _table("t1", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 30, 0))
    with StandingQueryEngine() as eng:
        frame = t.frame().select("event_ts", "sym", "px")
        sub = eng.register(frame)
        assert sub.mode == "stateless", sub.reason
        for k in range(3):
            eng.push(t, _mk(rng, 10, 2000 + 2000 * k))
        assert eng.flush(timeout=T_OUT)
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [t]).df)


def test_remainder_bitwise_and_refresh_cadence():
    rng = np.random.default_rng(2)
    t = _table("t2", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 30, 0))
    with StandingQueryEngine(remainder_every=2) as eng:
        frame = t.frame().withRangeStats(colsToSummarize=["px"],
                                         rangeBackWindowSecs=600)
        sub = eng.register(frame)
        assert sub.mode == "remainder" and sub.reason
        for k in range(4):
            eng.push(t, _mk(rng, 10, 2000 + 2000 * k))
        assert eng.flush(timeout=T_OUT)
        res = sub.result(timeout=T_OUT)
        twin = _twin(eng, frame, [t])
        for c in res.df.columns:
            a, b = res.df[c].to_numpy(), twin.df[c].to_numpy()
            if a.dtype.kind == "f":
                assert a.tobytes() == b.tobytes(), c
        kinds = [n.kind for n in sub.drain()]
        # remainder refreshes every 2nd of the 4 boundaries
        assert kinds.count("refresh") == 2


# ---------------------------------------------------------------------
# join delta mode
# ---------------------------------------------------------------------


def _merged_runs(df):
    """Maximal same-side consecutive runs of a merged timeline (ts
    ascending, rights before lefts on ties) — the only admissible push
    order for a standing join's two feeds."""
    side = df["side"].to_numpy()
    bounds = [0] + [i for i in range(1, len(df))
                    if side[i] != side[i - 1]] + [len(df)]
    return [(bool(side[a]), df.iloc[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("mlb", [0, 3])
def test_join_matrix_bitwise(skip, mlb):
    rng = np.random.default_rng(1)
    n = 160
    ts = np.sort(rng.integers(0, 100000, n))
    all_df = pd.DataFrame({
        "event_ts": pd.to_datetime(ts, unit="s"),
        "sym": rng.choice(["A", "B"], n),
        "bid": rng.normal(99, 2, n), "ask": rng.normal(101, 2, n),
        "side": rng.random(n) < 0.45})      # True = left
    all_df.loc[rng.random(n) < 0.2, "bid"] = np.nan
    all_df = all_df.sort_values(["event_ts", "side"],
                                kind="stable").reset_index(drop=True)
    hist, live = all_df.iloc[:60], all_df.iloc[60:]

    L = _table("orders", "event_ts", ["sym"], [])
    R = _table("quotes", "event_ts", ["sym"], ["bid", "ask"])
    L.append(hist[hist["side"]][["event_ts", "sym"]])
    R.append(hist[~hist["side"]][["event_ts", "sym", "bid", "ask"]])
    with StandingQueryEngine() as eng:
        frame = L.frame().asofJoin(R.frame(), right_prefix="right",
                                   skipNulls=skip, maxLookback=mlb)
        sub = eng.register(frame)
        assert sub.mode == "delta", sub.reason
        for is_left, run in _merged_runs(live):
            if is_left:
                eng.push(L, run[["event_ts", "sym"]])
            else:
                eng.push(R, run[["event_ts", "sym", "bid", "ask"]])
        assert eng.flush(timeout=T_OUT)
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [L, R]).df,
                        ctx=f"skip={skip} mlb={mlb}: ")


def test_split_classification_and_rejections():
    t = _table("t1", "event_ts", ["sym"], ["px"])
    ts = _table("t4", "event_ts", ["sym"], ["px"],
                     sequence_col="seqno")
    eng = StandingQueryEngine()
    try:
        root = qsplit.canonicalize(
            eng._as_root(ts.frame().asofJoin(t.frame())))
        p = qsplit.split(root)
        assert p.mode == "remainder" and "sequence column" in p.reason
        p2 = qsplit.split(qsplit.canonicalize(
            eng._as_root(t.frame().asofJoin(t.frame()))))
        assert p2.mode == "remainder" and "self-join" in p2.reason
        # mixed EMA alphas: one serving coefficient per plane
        p3 = qsplit.split(qsplit.canonicalize(eng._as_root(
            t.frame().EMA("px", exp_factor=0.2, exact=True)
            .EMA("EMA_px", exp_factor=0.5, exact=True))))
        assert p3.mode == "remainder"
        # no unified_scan source at all
        p4 = qsplit.split(qsplit.canonicalize(eng._as_root(
            t.frame().withRangeStats(colsToSummarize=["px"],
                                     rangeBackWindowSecs=60))))
        assert p4.mode == "remainder" and p4.reason
    finally:
        eng.close()


# ---------------------------------------------------------------------
# admission, backpressure, cancellation, failure
# ---------------------------------------------------------------------


def test_late_tick_rejected_and_nothing_committed():
    rng = np.random.default_rng(3)
    t = _table("s", "event_ts", ["sym"], ["px"])
    with StandingQueryEngine() as eng:
        eng.register(t.frame().EMA("px", exp_factor=0.3, exact=True))
        eng.push(t, _mk(rng, 10, 5000))
        before = t.rows_total()
        late = _mk(rng, 5, 0)         # strictly behind the watermark
        late["sym"] = "A"
        with pytest.raises(LateTickError):
            eng.push(t, late)
        assert t.rows_total() == before  # admission is all-or-nothing


def test_backpressure_drops_oldest_not_result():
    rng = np.random.default_rng(4)
    t = _table("s", "event_ts", ["sym"], ["px"])
    with StandingQueryEngine(queue_depth=2) as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        for k in range(8):
            eng.push(t, _mk(rng, 6, 2000 * k))
        assert eng.flush(timeout=T_OUT)
        with eng._lock:
            dropped = sub.dropped
        assert dropped > 0              # the queue bounded itself
        assert len(sub.drain()) <= 2
        # ...but the standing accumulator is complete and bitwise
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [t]).df)


def test_cancel_releases_slot_and_stops_delivery():
    rng = np.random.default_rng(5)
    t = _table("s", "event_ts", ["sym"], ["px"])
    with StandingQueryEngine() as eng:
        sub = eng.register(t.frame().EMA("px", exp_factor=0.3,
                                         exact=True))
        eng.push(t, _mk(rng, 10, 0))
        assert eng.flush(timeout=T_OUT)
        sub.cancel()
        assert not sub.live
        sub.drain()     # pre-cancel catchup/delta notifications
        eng.push(t, _mk(rng, 10, 5000))   # still admitted to the table
        assert eng.flush(timeout=T_OUT)
        assert sub.drain() == []          # but no longer delivered
        sub.cancel()                      # idempotent


def test_register_during_inflight_push_not_duplicated():
    """A subscription registered AFTER a push committed but BEFORE the
    delivery worker ran must not receive that boundary as a delta —
    its catch-up snapshot already holds the rows."""
    rng = np.random.default_rng(11)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 20, 0))
    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub1 = eng.register(frame)
        with eng._lock:
            # holding the engine lock stalls the delivery worker: the
            # push below is committed to the table tail but still
            # undelivered when sub2's catch-up snapshots it
            eng.push(t, _mk(rng, 10, 2000))
            sub2 = eng.register(frame)
        assert eng.flush(timeout=T_OUT)
        eng.push(t, _mk(rng, 10, 5000))
        assert eng.flush(timeout=T_OUT)
        twin = _twin(eng, frame, [t])
        _assert_bitwise(sub1.result(timeout=T_OUT).df, twin.df, ctx="sub1: ")
        _assert_bitwise(sub2.result(timeout=T_OUT).df, twin.df, ctx="sub2: ")
        with eng._lock:
            assert sub2._cursors["s"] == t.rows_total()


def test_demotion_on_failed_catchup_releases_plane_member(monkeypatch):
    """When the cohort rejects the catch-up replay and register()
    demotes the subscription to the batch remainder, the half-claimed
    cohort slot is released, not leaked for the subscription's
    lifetime."""
    rng = np.random.default_rng(13)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 10, 0))
    with StandingQueryEngine() as eng:
        monkeypatch.setattr(
            StandingQueryEngine, "_dispatch_ema",
            lambda self, *a, **k: (_ for _ in ()).throw(
                LateTickError(("A",), 1, None, 1, (2, None, 1))))
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        assert sub.mode == "remainder" and "demoted" in sub.reason
        assert sub._member is None and sub._plane is None
        with eng._lock:
            assert all(p.members == 0 for p in eng._planes.values())
            assert all(p.cohort._resident == 0
                       for p in eng._planes.values())
        # the demoted subscription still answers correctly
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [t]).df)


@pytest.mark.parametrize("site", ["warm", "dispatch"])
def test_failed_capture_or_launch_at_catchup_raises(monkeypatch, site):
    """A capture or launch fault during the catch-up is not a replay
    rejection: register() raises it, serves the query on no other path,
    and hands the claimed cohort slot back."""
    from tempo_tpu_torch.query import standing as qstanding

    rng = np.random.default_rng(14)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 10, 0))

    def fault(*a, **k):
        raise RuntimeError(f"injected {site} fault")

    if site == "warm":
        monkeypatch.setattr(qstanding._Plane, "warm", fault)
    else:
        monkeypatch.setattr(StandingQueryEngine, "_dispatch_ema", fault)
    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        with pytest.raises(RuntimeError, match=f"injected {site} fault"):
            eng.register(frame)
        with eng._lock:
            assert not eng._subs
            assert all(p.members == 0 for p in eng._planes.values())
            assert all(p.cohort._resident == 0
                       for p in eng._planes.values())


def test_append_refused_on_adopted_table_released_on_close():
    rng = np.random.default_rng(12)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 10, 0))            # pre-adoption: fine
    eng = StandingQueryEngine()
    try:
        eng.register(t.frame().select("event_ts", "sym", "px"))
        with pytest.raises(RuntimeError, match="adopted"):
            t.append(_mk(rng, 10, 3000))
    finally:
        eng.close()
    # close() releases ownership: direct append works again
    t.append(_mk(rng, 10, 6000))


def test_invalid_query_surfaces_at_register():
    t = _table("s", "event_ts", ["sym"], ["px"],
                    sequence_col="seqno")
    t.append(pd.DataFrame({
        "event_ts": pd.to_datetime([1, 2], unit="s"),
        "sym": ["A", "A"], "px": [1.0, 2.0],
        "seqno": [0.0, 1.0]}))
    with StandingQueryEngine() as eng:
        # select() dropping the declared sequence column is invalid for
        # the batch twin too — register must surface it, not swallow it
        with pytest.raises(Exception):
            eng.register(t.frame().EMA("px", exact=True)
                         .select("event_ts", "sym", "EMA_px"))


def test_push_missing_columns_rejected():
    t = _table("s", "event_ts", ["sym"], ["px"])
    with StandingQueryEngine() as eng:
        eng.register(t.frame().select("event_ts", "sym", "px"))
        with pytest.raises(ValueError, match="missing columns"):
            eng.push(t, pd.DataFrame({
                "event_ts": pd.to_datetime([1], unit="s")}))


# ---------------------------------------------------------------------
# steady state: zero recompiles
# ---------------------------------------------------------------------


def test_zero_recompiles_at_steady_state():
    rng = np.random.default_rng(6)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 40, 0))
    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        # warm-up boundaries build the bucket programs once
        for k in range(2):
            eng.push(t, _mk(rng, 10, 2000 + 2000 * k))
        assert eng.flush(timeout=T_OUT)
        builds0 = profiling.plan_cache_stats()["builds"]
        for k in range(6):
            eng.push(t, _mk(rng, 10, 8000 + 2000 * k))
        assert eng.flush(timeout=T_OUT)
        assert profiling.plan_cache_stats()["builds"] == builds0, \
            "standing steady state must be zero-recompile"
        _assert_bitwise(sub.result(timeout=T_OUT).df, _twin(eng, frame, [t]).df)


# ---------------------------------------------------------------------
# kill -> snapshot -> resume
# ---------------------------------------------------------------------


def test_kill_resume_byte_identical_tail(tmp_path):
    rng = np.random.default_rng(3)
    batches = [_mk(np.random.default_rng(30 + k), 20, 3000 * k,
                   nan_p=0.1) for k in range(8)]
    query = lambda tab: tab.frame().EMA("px", exp_factor=0.3,  # noqa: E731
                                        exact=True)

    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(batches[0])
    with StandingQueryEngine() as eng:
        sub = eng.register(query(t))
        for b in batches[1:]:
            eng.push(t, b)
        assert eng.flush(timeout=T_OUT)
        full = sub.result(timeout=T_OUT).df

    # killed at boundary 3, snapshotted, resumed on a fresh engine
    t2 = _table("s", "event_ts", ["sym"], ["px"])
    t2.append(batches[0])
    path = str(tmp_path / "standing_ckpt")
    with StandingQueryEngine() as eng2:
        sub2 = eng2.register(query(t2))
        for b in batches[1:4]:
            eng2.push(t2, b)
        assert eng2.flush(timeout=T_OUT)
        snapshot_subscription(sub2, path)

    t3 = _table("s", "event_ts", ["sym"], ["px"])
    for b in batches[:4]:
        t3.append(b)
    with StandingQueryEngine() as eng3:
        sub3 = resume_subscription(eng3, query(t3), path)
        for b in batches[4:]:
            eng3.push(t3, b)
        assert eng3.flush(timeout=T_OUT)
        resumed = sub3.result(timeout=T_OUT).df

    assert list(full.columns) == list(resumed.columns)
    for c in full.columns:
        a, b = full[c].to_numpy(), resumed[c].to_numpy()
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), \
                f"{c}: resumed tail not byte-identical"
        else:
            assert (pd.Series(a) == pd.Series(b)).all(), c


def test_resume_with_series_in_push_arrival_order(tmp_path):
    """Live members admit series in push ARRIVAL order, which need not
    match the prefix's (ts, seq) first-appearance order — resume must
    rebuild the member in the artifact's saved order, not refuse."""
    query = lambda tab: tab.frame().EMA("px", exp_factor=0.3,  # noqa: E731
                                        exact=True)

    def b(sym, ts0):
        return pd.DataFrame({
            "event_ts": pd.to_datetime([ts0, ts0 + 1], unit="s"),
            "sym": [sym, sym], "px": [100.0 + ts0, 101.0 + ts0]})

    t = _table("s", "event_ts", ["sym"], ["px"])
    path = str(tmp_path / "ck")
    with StandingQueryEngine() as eng:
        sub = eng.register(query(t))
        eng.push(t, b("B", 100))       # B first in arrival order...
        eng.push(t, b("A", 50))        # ...but A first by timestamp
        assert eng.flush(timeout=T_OUT)
        snapshot_subscription(sub, path)
        eng.push(t, b("B", 200))
        eng.push(t, b("A", 150))
        assert eng.flush(timeout=T_OUT)
        full = sub.result(timeout=T_OUT).df

    t2 = _table("s", "event_ts", ["sym"], ["px"])
    t2.append(pd.concat([b("B", 100), b("A", 50)], ignore_index=True))
    with StandingQueryEngine() as eng2:
        sub2 = resume_subscription(eng2, query(t2), path)
        eng2.push(t2, b("B", 200))
        eng2.push(t2, b("A", 150))
        assert eng2.flush(timeout=T_OUT)
        resumed = sub2.result(timeout=T_OUT).df
    assert list(full.columns) == list(resumed.columns)
    for c in full.columns:
        a, bb = full[c].to_numpy(), resumed[c].to_numpy()
        if a.dtype.kind == "f":
            assert a.tobytes() == bb.tobytes(), c
        else:
            assert (pd.Series(a) == pd.Series(bb)).all(), c


def test_standing_checkpoint_kind_refusals(tmp_path):
    rng = np.random.default_rng(8)
    t = _table("s", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 20, 0))
    path = str(tmp_path / "ck")
    with StandingQueryEngine() as eng:
        sub = eng.register(t.frame().EMA("px", exp_factor=0.3,
                                         exact=True))
        eng.push(t, _mk(rng, 10, 3000))
        assert eng.flush(timeout=T_OUT)
        snapshot_subscription(sub, path)

    # kind mismatch is refused BY NAME
    with pytest.raises(ckpt.CheckpointError, match="standing"):
        ckpt.load_state(path, kind="cohort_state")

    # a different registered plan (other alpha) is refused by signature
    t2 = _table("s", "event_ts", ["sym"], ["px"])
    t2.append(_mk(np.random.default_rng(8), 20, 0))
    with StandingQueryEngine() as eng2:
        with pytest.raises(ckpt.CheckpointError, match="signature"):
            resume_subscription(
                eng2, t2.frame().EMA("px", exp_factor=0.9, exact=True),
                path)


# ---------------------------------------------------------------------
# SQL registration through the service
# ---------------------------------------------------------------------


def test_sql_standing_through_service():
    from tempo_tpu_torch.service.service import QueryService

    rng = np.random.default_rng(5)
    t = _table("trades", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 30, 0))
    svc = QueryService()
    try:
        sub = svc.register_sql(
            "acme",
            "SELECT event_ts, sym, px FROM trades WHERE px > 95",
            {"trades": t})
        assert sub.mode == "stateless", sub.reason
        for k in range(3):
            svc.push(t, _mk(rng, 10, 2000 + 2000 * k))
        assert svc._standing().flush(timeout=T_OUT)
        res = sub.result(timeout=T_OUT)
        twin = _run_batch(sub.plan.root, {t.name: t.snapshot_df()})
        _assert_bitwise(res.df, twin.df)
        counts = svc.stats()["tenants"]["acme"]
        assert counts["submitted"] >= 1 and counts["completed"] >= 1
    finally:
        svc.close()


def test_sql_standing_binds_stream_tables_directly():
    rng = np.random.default_rng(9)
    t = _table("trades", "event_ts", ["sym"], ["px"])
    t.append(_mk(rng, 20, 0))
    with StandingQueryEngine() as eng:
        sub = eng.register_sql(
            "SELECT event_ts, sym, px FROM trades", {"trades": t})
        eng.push(t, _mk(rng, 10, 3000))
        assert eng.flush(timeout=T_OUT)
        twin = _run_batch(sub.plan.root, {t.name: t.snapshot_df()})
        _assert_bitwise(sub.result(timeout=T_OUT).df, twin.df)


# ---------------------------------------------------------------------
# the port against the reference on the same pushes
# ---------------------------------------------------------------------

_PKGS = {"port": (_table, StandingQueryEngine),
         "ref": (ref_query.StreamTable, ref_query.StandingQueryEngine)}


def _both(build, hist, pushes, **table_kw):
    """Run one scenario through the port's and the reference's engines:
    ``build(table)`` gives the lazy query over a table holding ``hist``,
    then each push lands; returns ``{pkg: (result df, mode)}``."""
    out = {}
    for pkg, (Table, Engine) in _PKGS.items():
        t = Table("s", "event_ts", ["sym"], ["px"], **table_kw)
        t.append(hist)
        with Engine() as eng:
            sub = eng.register(build(t))
            for df in pushes:
                eng.push(t, df)
            if pkg == "port":
                res = sub.result(timeout=T_OUT)
            else:
                res = sub.result()
            out[pkg] = (res.df, sub.mode)
    return out


@pytest.mark.parametrize("alpha,seq", [(0.3, False), (0.2, True)])
def test_ema_delta_matches_reference(alpha, seq):
    rng = np.random.default_rng(21)
    hist = _mk(rng, 40, 0, syms=("A", "B", "C"), nan_p=0.15, seq=seq)
    pushes = [_mk(rng, 13, 2000 + 2000 * k, syms=("A", "B", "C"),
                  nan_p=0.15, seq=seq) for k in range(4)]
    kw = {"sequence_col": "seqno"} if seq else {}
    got = _both(lambda t: t.frame().EMA("px", exp_factor=alpha, exact=True),
                hist, pushes, **kw)
    assert got["port"][1] == got["ref"][1] == "delta"
    _assert_matches_ref(got["port"][0], got["ref"][0], alpha=alpha)


@pytest.mark.parametrize("query", ["stateless", "remainder"])
def test_stateless_and_remainder_match_reference(query):
    rng = np.random.default_rng(22)
    hist = _mk(rng, 30, 0)
    pushes = [_mk(rng, 10, 2000 + 2000 * k) for k in range(3)]
    build = {
        "stateless": lambda t: t.frame().select("event_ts", "sym", "px"),
        "remainder": lambda t: t.frame().withRangeStats(
            colsToSummarize=["px"], rangeBackWindowSecs=600),
    }[query]
    got = _both(build, hist, pushes)
    assert got["port"][1] == got["ref"][1] == query
    port, ref = got["port"][0], got["ref"][0]
    assert list(port.columns) == list(ref.columns)
    for c in port.columns:
        a, b = port[c].to_numpy(), ref[c].to_numpy()
        if a.dtype.kind == "f":
            # range stats: the port computes at float64 on the CPU, the
            # reference at its own precision (the planner tests' bound)
            np.testing.assert_allclose(a, b.astype(np.float64), rtol=1e-5,
                                       atol=1e-5, err_msg=c)
        else:
            pd.testing.assert_series_equal(port[c], ref[c],
                                           check_names=False)


@pytest.mark.parametrize("skip,mlb", [(True, 0), (False, 3)])
def test_join_delta_matches_reference(skip, mlb):
    rng = np.random.default_rng(23)
    n = 90
    ts = np.sort(rng.integers(0, 50000, n))
    all_df = pd.DataFrame({
        "event_ts": pd.to_datetime(ts, unit="s"),
        "sym": rng.choice(["A", "B"], n),
        "bid": rng.normal(99, 2, n), "ask": rng.normal(101, 2, n),
        "side": rng.random(n) < 0.45})
    all_df.loc[rng.random(n) < 0.2, "bid"] = np.nan
    all_df = all_df.sort_values(["event_ts", "side"],
                                kind="stable").reset_index(drop=True)
    hist, live = all_df.iloc[:30], all_df.iloc[30:]
    out = {}
    for pkg, (Table, Engine) in _PKGS.items():
        L = Table("orders", "event_ts", ["sym"], [])
        R = Table("quotes", "event_ts", ["sym"], ["bid", "ask"])
        L.append(hist[hist["side"]][["event_ts", "sym"]])
        R.append(hist[~hist["side"]][["event_ts", "sym", "bid", "ask"]])
        with Engine() as eng:
            sub = eng.register(L.frame().asofJoin(
                R.frame(), right_prefix="right", skipNulls=skip,
                maxLookback=mlb))
            assert sub.mode == "delta", sub.reason
            for is_left, run in _merged_runs(live):
                if is_left:
                    eng.push(L, run[["event_ts", "sym"]])
                else:
                    eng.push(R, run[["event_ts", "sym", "bid", "ask"]])
            res = (sub.result(timeout=T_OUT) if pkg == "port"
                   else sub.result())
            out[pkg] = res.df
    _assert_matches_ref(out["port"], out["ref"])


def test_split_decisions_match_reference():
    """The split pass classifies the same queries the same way, with
    the same canonical signatures, in both packages."""
    queries = [
        lambda t, u: t.frame().EMA("px", exp_factor=0.3, exact=True),
        lambda t, u: t.frame().EMA("px", exact=True).select(
            "event_ts", "sym", "EMA_px"),
        lambda t, u: t.frame().select("event_ts", "sym", "px"),
        lambda t, u: t.frame().withRangeStats(colsToSummarize=["px"],
                                              rangeBackWindowSecs=60),
        lambda t, u: t.frame().asofJoin(u.frame()),
        lambda t, u: u.frame().asofJoin(t.frame()),
        lambda t, u: t.frame().asofJoin(t.frame()),
        lambda t, u: t.frame().EMA("px", exp_factor=0.2, exact=True)
        .EMA("EMA_px", exp_factor=0.5, exact=True),
    ]
    for i, q in enumerate(queries):
        got = {}
        for pkg, (Table, Engine) in _PKGS.items():
            t = Table("t1", "event_ts", ["sym"], ["px"])
            u = Table("t4", "event_ts", ["sym"], ["px"],
                      sequence_col="seqno")
            mod = qsplit if pkg == "port" else ref_query.split
            eng = Engine()
            try:
                plan = mod.split(mod.canonicalize(eng._as_root(q(t, u))))
            finally:
                eng.close()
            got[pkg] = (plan.mode, plan.reason, plan.signature,
                        [(e.col, e.alpha) for e in plan.emas])
        assert got["port"] == got["ref"], i
