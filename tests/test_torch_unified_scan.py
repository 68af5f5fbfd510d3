"""The port's unified scan (``tempo_tpu_torch/query/unified.py``) on the
CPU: one plan node unioning the store's history with the live tail under
a single watermark, bitwise equal to the all-batch twin that never went
through a store, including across ``store.compact`` racing a live
subscription.

Counterparts of ``tests/test_unified_scan.py``'s 7 cases, every
``StreamTable`` on ``device="cpu"``.  Two of the reference's cases fail
against ``tempo_tpu`` itself, because of its own store's timestamp
units (ROADMAP C, fault C5, closed in the port): their counterparts
here (``test_snapshot_is_history_union_tail_bitwise`` and
``test_sync_roundtrip_preserves_arrival_order``) hold the port's
``snapshot_df`` and its store round trip against an independent pandas
twin, ``pd.concat`` of the history and tail frames in their source
dtypes, not against ``tempo_tpu``'s output.  The rest also hold the
port's standing EMA and snapshots against the reference's on the same
pushes.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu.query as ref_query
from tempo_tpu_torch.query import StandingQueryEngine, StreamTable
from tempo_tpu_torch.query import split as qsplit
from tempo_tpu_torch.query.standing import _run_batch
from tempo_tpu_torch.store.compact import compact as store_compact
from tempo_tpu_torch.store.engine import Store

T_OUT = 120


def _table(*a, **kw):
    return StreamTable(*a, device="cpu", **kw)


def _mk(rng, n, t0):
    return pd.DataFrame({
        "event_ts": pd.to_datetime(
            t0 + np.sort(rng.integers(0, 1000, n)), unit="s"),
        "sym": rng.choice(["A", "B"], n),
        "px": rng.normal(100, 5, n).astype(np.float64),
    }).sort_values("event_ts", kind="stable").reset_index(drop=True)


def test_snapshot_is_history_union_tail_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    store = Store(str(tmp_path))
    t = _table("ticks", "event_ts", ["sym"], ["px"], store=store)
    batches = [_mk(rng, 25, 3000 * k) for k in range(4)]
    for b in batches[:2]:
        t.append(b)
    t.sync_to_store()
    assert t.tail_rows == 0 and store.current("ticks") is not None
    for b in batches[2:]:
        t.append(b)
    snap = t.snapshot_df()
    twin = pd.concat(batches, ignore_index=True)
    assert list(snap.columns) == list(twin.columns)
    assert snap["px"].to_numpy().tobytes() == \
        twin["px"].to_numpy().tobytes()
    assert (snap["sym"].to_numpy() == twin["sym"].to_numpy()).all()
    assert snap["event_ts"].to_numpy().tobytes() == \
        twin["event_ts"].to_numpy().tobytes()
    assert t.rows_total() == len(twin)


def test_sync_roundtrip_preserves_arrival_order(tmp_path):
    """Arrival order is the table's bitwise identity (it drives the
    packed layouts' key factorization) — the store roundtrip must
    reproduce it verbatim, not re-cluster it."""
    rng = np.random.default_rng(1)
    store = Store(str(tmp_path))
    t = _table("ticks", "event_ts", ["sym"], ["px"], store=store)
    # deliberately interleaved keys, non-sorted arrival
    df = _mk(rng, 60, 0)
    t.append(df)
    before = t.snapshot_df()
    t.sync_to_store()
    after = t.snapshot_df()            # now read back from parquet
    assert t.tail_rows == 0
    pd.testing.assert_frame_equal(before, after)
    # the independent pandas twin: the pushed frame itself, in arrival
    # order and its source dtypes
    twin = pd.concat([df], ignore_index=True)
    pd.testing.assert_frame_equal(after, twin, check_exact=True)
    assert list(after.dtypes) == list(df.dtypes)


def test_unified_scan_vs_all_batch_across_compact(tmp_path, monkeypatch):
    """A standing EMA over store-backed history stays bitwise with the
    all-batch twin while ``store.compact`` rewrites the generation
    mid-subscription — and the compaction must actually run (multiple
    segments via a tiny segment-rows knob), not no-op."""
    monkeypatch.setenv("TEMPO_TPU_STORE_SEGMENT_ROWS", "16")
    rng = np.random.default_rng(4)
    store = Store(str(tmp_path))
    t = _table("ticks", "event_ts", ["sym"], ["px"], store=store)
    batches = [_mk(rng, 25, 3000 * k) for k in range(6)]
    for b in batches[:2]:
        t.append(b)
    t.sync_to_store()                  # 50 rows / 16 -> 4 segments
    t.append(batches[2])

    with StandingQueryEngine() as eng:
        frame = t.frame().EMA("px", exp_factor=0.3, exact=True)
        sub = eng.register(frame)
        eng.push(t, batches[3])
        assert eng.flush(timeout=T_OUT)
        out = store_compact("ticks", base_dir=str(tmp_path))
        assert out is not None, "compact no-opped; test lost its race"
        eng.push(t, batches[4])
        eng.push(t, batches[5])
        assert eng.flush(timeout=T_OUT)
        res = sub.result(timeout=T_OUT)
        twin_src = pd.concat(batches, ignore_index=True)
        twin = _run_batch(qsplit.canonicalize(eng._as_root(frame)),
                          {t.name: twin_src})
        assert res.df["EMA_px"].to_numpy().tobytes() == \
            twin.df["EMA_px"].to_numpy().tobytes()
        assert res.df["px"].to_numpy().tobytes() == \
            twin.df["px"].to_numpy().tobytes()
    # the post-compact unified snapshot is also bitwise the raw concat
    snap = t.snapshot_df()
    assert snap["px"].to_numpy().tobytes() == \
        twin_src["px"].to_numpy().tobytes()


def test_frame_builds_unified_scan_plan_node():
    t = _table("x", "event_ts", ["sym"], ["px"])
    t.append(_mk(np.random.default_rng(2), 20, 0))
    frame = t.frame()
    ops = [n.op for n in frame.plan.walk()]
    assert ops == ["unified_scan"]
    # executing the bare scan through the batch path == the snapshot
    out = _run_batch(frame.plan, {t.name: t.snapshot_df()})
    assert out.df["px"].to_numpy().tobytes() == \
        t.snapshot_df()["px"].to_numpy().tobytes()


def test_storeless_table_has_no_history():
    t = _table("x", "event_ts", ["sym"], ["px"])
    assert t.rows_total() == 0
    assert len(t.snapshot_df()) == 0
    with pytest.raises(ValueError, match="no store"):
        t.sync_to_store()
    df = _mk(np.random.default_rng(3), 10, 0)
    assert t.append(df) == 10
    assert t.rows_total() == 10
    assert "StreamTable" in repr(t) and "rows=10" in repr(t)


def test_schema_validation():
    with pytest.raises(ValueError, match="missing from the schema"):
        _table("x", "event_ts", ["sym"], ["px"],
                    columns=["event_ts", "sym"])
    t = _table("x", "event_ts", ["sym"], ["px"])
    with pytest.raises(ValueError, match="missing columns"):
        t.append(pd.DataFrame({"event_ts": []}))


def test_state_token_tracks_versions(tmp_path):
    rng = np.random.default_rng(5)
    store = Store(str(tmp_path))
    t = _table("ticks", "event_ts", ["sym"], ["px"], store=store)
    tok0 = t.state_token()
    t.append(_mk(rng, 10, 0))
    tok1 = t.state_token()
    assert tok1 != tok0
    t.sync_to_store()
    tok2 = t.state_token()
    assert tok2 != tok1                # new generation + empty tail
    assert t.state_token() == tok2     # stable while nothing changes


def test_store_backed_standing_matches_reference():
    """A standing EMA over store-backed history in the port equals the
    reference engine's over the same rows fed without a store (the
    reference's store is the faulty part, C5): keys, timestamps and
    values bitwise, the EMA within ``tests/test_torch_ema_scan.py``'s
    bound (``1 / a`` float32 ulps of the series' largest ``|y|``)."""
    import tempfile

    rng = np.random.default_rng(6)
    batches = [_mk(rng, 25, 3000 * k) for k in range(4)]
    with tempfile.TemporaryDirectory() as d:
        t = _table("ticks", "event_ts", ["sym"], ["px"], store=Store(d))
        t.append(batches[0])
        t.sync_to_store()
        with StandingQueryEngine() as eng:
            sub = eng.register(t.frame().EMA("px", exp_factor=0.3,
                                             exact=True))
            for b in batches[1:]:
                eng.push(t, b)
            port = sub.result(timeout=T_OUT).df
    rt = ref_query.StreamTable("ticks", "event_ts", ["sym"], ["px"])
    rt.append(batches[0])
    with ref_query.StandingQueryEngine() as reng:
        rsub = reng.register(rt.frame().EMA("px", exp_factor=0.3,
                                            exact=True))
        for b in batches[1:]:
            reng.push(rt, b)
        ref = rsub.result().df
    assert list(port.columns) == list(ref.columns)
    for c in ("event_ts", "sym"):
        pd.testing.assert_series_equal(port[c], ref[c])
    assert port["px"].to_numpy().tobytes() == ref["px"].to_numpy().tobytes()
    y = np.abs(ref["EMA_px"].to_numpy())
    peak = pd.Series(y).groupby(ref["sym"].to_numpy()).transform("max")
    tol = np.spacing(peak.to_numpy().astype(np.float32)).astype(
        np.float64) / 0.3
    assert (np.abs(port["EMA_px"].to_numpy()
                   - ref["EMA_px"].to_numpy()) <= tol).all()
