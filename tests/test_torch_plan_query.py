"""The planner's hooks for the query plane (``unified_scan`` sources and
``ema_stream`` nodes) in the port against the reference, on the CPU.

* ``unified_scan``: its ``explain`` line and ``output_columns`` equal
  the reference's for the same table;
* ``ir._frame_state``: a table's version bump is a cache miss and a
  re-read of the same version a hit, the same hit / miss / build
  sequence as the reference's cache;
* ``ema_stream``: the canonical node evaluates through
  ``ops.scan.ema_scan`` at float32 on every device; against the
  reference's ``split.eval_ema_stream`` the keys, timestamps and row
  order are equal and the EMA is within ``tests/test_torch_ema_scan.
  py``'s bound (``1 / a`` float32 ulps of the series' largest ``|y|``);
  the planned chain is bitwise the direct evaluation.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
import tempo_tpu.query as ref_query
from tempo_tpu.plan import cache as ref_cache
from tempo_tpu.plan import executor as ref_executor
from tempo_tpu.plan import ir as ref_ir
from tempo_tpu.plan import render as ref_render
from tempo_tpu_torch import TSDF
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import executor, ir, render
from tempo_tpu_torch.query import StreamTable
from tempo_tpu_torch.query import split as qsplit


@pytest.fixture(autouse=True)
def _clean_caches():
    plan_cache.CACHE.clear()
    ref_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()
    ref_cache.CACHE.clear()


def _mk(rng, n, t0, nan_p=0.1, syms=("A", "B", "C")):
    df = pd.DataFrame({
        "event_ts": pd.to_datetime(
            t0 + np.sort(rng.integers(0, 1000, n)), unit="s"),
        "sym": rng.choice(list(syms), n),
        "px": rng.normal(100, 5, n),
    })
    df.loc[rng.random(n) < nan_p, "px"] = np.nan
    return df.sort_values("event_ts", kind="stable").reset_index(drop=True)


def _tables(df):
    t = StreamTable("ticks", "event_ts", ["sym"], ["px"], device="cpu")
    r = ref_query.StreamTable("ticks", "event_ts", ["sym"], ["px"])
    t.append(df)
    r.append(df)
    return t, r


def test_unified_scan_explain_and_output_columns():
    t, r = _tables(_mk(np.random.default_rng(0), 20, 0))
    node, ref_node = t.frame().plan, r.frame().plan
    assert node.op == ref_node.op == "unified_scan"
    assert node.is_source()
    assert render._node_line(node) == ref_render._node_line(ref_node)
    assert ir.output_columns(node) == ref_ir.output_columns(ref_node)
    lz = t.frame().EMA("px", exact=True)
    canon = qsplit.canonicalize(lz.plan)
    ref_canon = ref_query.split.canonicalize(
        r.frame().EMA("px", exact=True).plan)
    assert ir.output_columns(canon) == ref_ir.output_columns(ref_canon) \
        == ["event_ts", "sym", "px", "EMA_px"]
    assert render._node_line(canon) == ref_render._node_line(ref_canon)
    text = render.explain_text(canon)
    assert "unified_scan['ticks' v1]" in text and "ema_stream" in text


def test_frame_state_version_bump_misses_same_version_hits():
    rng = np.random.default_rng(1)
    first, more = _mk(rng, 20, 0), _mk(rng, 10, 5000)
    t, r = _tables(first)
    seq = {}
    for pkg, tab, cache, exe_mod in (
            ("port", t, plan_cache, executor),
            ("ref", r, ref_cache, ref_executor)):
        steps = []
        for grow in (False, False, True, False):
            if grow:
                tab.append(more)
            before = cache.CACHE.stats()
            exe_mod.execute(tab.frame().plan)
            after = cache.CACHE.stats()
            steps.append(tuple(after[k] - before[k]
                               for k in ("hits", "misses", "builds")))
        seq[pkg] = steps
    assert seq["port"] == seq["ref"] == [(0, 1, 1), (1, 0, 0), (0, 1, 1),
                                         (1, 0, 0)]
    # the state entry names the version, the store generation, the tail
    # and the device
    state = ir._frame_state(t.frame().plan.payload)
    assert state[0] == "unified" and state[-1] == "cpu"
    assert state[1:5] == ("ticks", t.version, None, t.tail_rows)


def _ema_tol(df, col, alpha):
    y = np.abs(df[col].to_numpy(np.float64))
    peak = pd.Series(np.where(np.isnan(y), 0.0, y)).groupby(
        df["sym"].to_numpy()).transform("max").to_numpy()
    return np.spacing(peak.astype(np.float32)).astype(np.float64) / alpha


@pytest.mark.parametrize("alpha", [0.2, 0.35])
@pytest.mark.parametrize("n", [0, 1, 57, 400])
def test_ema_stream_matches_reference(alpha, n):
    df = _mk(np.random.default_rng(2 + n), n, 0)
    got = qsplit.eval_ema_stream(
        TSDF(df, "event_ts", ["sym"], device="cpu"), "px", alpha).df
    want = ref_query.split.eval_ema_stream(
        tempo_tpu.TSDF(df, "event_ts", ["sym"]), "px", alpha).df
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == n
    for c in ("event_ts", "sym", "px"):
        pd.testing.assert_series_equal(got[c], want[c])
    a, b = got["EMA_px"].to_numpy(), want["EMA_px"].to_numpy()
    assert a.dtype == b.dtype == np.float64
    # every value is a float32 widened exactly
    assert (a.astype(np.float32).astype(np.float64)[~np.isnan(a)]
            == a[~np.isnan(a)]).all()
    assert (np.isnan(a) == np.isnan(b)).all()
    ok = ~np.isnan(a)
    assert (np.abs(a[ok] - b[ok]) <= _ema_tol(want, "EMA_px", alpha)[ok]).all()


def test_ema_stream_runs_ema_scan_at_float32(monkeypatch):
    """The node evaluates through ``ops.scan.ema_scan`` (the kernel's
    wrapper) on float32 planes, and the planned canonical chain is
    bitwise that direct evaluation."""
    df = _mk(np.random.default_rng(3), 120, 0)
    t, _ = _tables(df)
    seen = []
    real = scan.ema_scan

    def spy(x, valid, alpha, y0=None):
        seen.append(x.dtype)
        return real(x, valid, alpha, y0)

    monkeypatch.setattr(scan, "ema_scan", spy)
    canon = qsplit.canonicalize(t.frame().EMA("px", exp_factor=0.3,
                                              exact=True).plan)
    planned = executor.execute(canon).df
    assert seen == [torch.float32]
    direct = qsplit.eval_ema_stream(
        TSDF(t.snapshot_df(), "event_ts", ["sym"], device="cpu"),
        "px", 0.3).df
    assert planned["EMA_px"].to_numpy().tobytes() == \
        direct["EMA_px"].to_numpy().tobytes()
    pd.testing.assert_frame_equal(planned, direct, check_exact=True)
