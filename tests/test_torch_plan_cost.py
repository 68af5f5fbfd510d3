"""The port's cost model (``tempo_tpu_torch/plan/cost.py``) against the
reference's (``tempo_tpu/plan/cost.py``).

* The port's own default priors (the card's measured rates) reproduce
  the rule decisions, as the reference's test requires of its priors
  (``tests/test_cost.py``): the join pick over a grid of widths and
  limits, the range pick, fusion, stitching and reshard placement.
* With both packages' inputs pinned to the same values
  (``set_measured``), every cost function gives the reference's numbers
  and decisions.
* A flipped input flips a decision and the plan stays bitwise the
  rule-based one; the active inputs key the executable cache; no TPU
  rate of the reference is a port prior.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.plan import cost as ref_cost
from tempo_tpu_torch import TSDF, make_mesh, profiling
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import cost, ir, optimizer


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_COST_MODEL", raising=False)
    cost.clear_measured()
    ref_cost.clear_measured()
    plan_cache.CACHE.clear()
    yield
    cost.clear_measured()
    ref_cost.clear_measured()
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


# ----------------------------------------------------------------------
# the card's default priors reproduce the rules
# ----------------------------------------------------------------------

LANES = (1, 100, 184, 10_000, 196_608, 196_609, 10**7)


@pytest.mark.parametrize("limit", (196_608, 1024, 64, 0))
@pytest.mark.parametrize("chunked_ok", (True, False))
def test_default_join_pick_reproduces_rule_everywhere(limit, chunked_ok):
    for lanes in LANES:
        rule = ("single" if (limit <= 0 or lanes <= limit)
                else ("chunked" if chunked_ok else "bracket"))
        assert cost.decide_join_engine(lanes, limit, chunked_ok) == rule
        assert profiling.pick_join_engine(lanes, limit, chunked_ok) == rule


def test_default_fusion_stitch_and_reshard_reproduce_rules():
    for n_ops in (2, 3, 8):
        for est in (0, 10**6, 10**10):
            assert cost.fusion_worthwhile(n_ops, est)[0]
            assert cost.stitch_worthwhile(n_ops, est)[0]
    # placement wins whenever it eliminates a switch (bytes or counts)
    assert cost.reshard_decision(2, 2000, 4, 4000)[0]
    assert cost.reshard_decision(2, None, 4, None)[0]
    assert cost.reshard_decision(2, 2000, 2, 2000)[0]


def test_priors_are_the_cards_not_the_tpus():
    """No TPU rate of the reference (its BENCH r5 stream and join rates,
    its ICI rate, its VMEM pass multiple) is a port prior."""
    measured = set(cost.PRIORS) - set(cost.FIXED)
    for name in measured:
        assert cost.PRIORS[name] > 0
        assert cost.PRIORS[name] != ref_cost.PRIORS[name], name
    assert all(cost.PRIORS[name] == 0.0 for name in cost.FIXED)
    # the lookback kernel tiles its rows in one call: no chunk overhead
    assert set(cost.PRIORS) == set(ref_cost.PRIORS) - {"chunk_overhead_s"}
    with pytest.raises(KeyError, match="unknown cost input"):
        cost.set_measured(chunk_overhead_s=1.0)


def test_cost_model_off_restores_rule_path(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_COST_MODEL", "0")
    assert not cost.enabled() and cost.snapshot() is None
    assert profiling.pick_join_engine(100, 196_608, True) == "single"
    assert cost.fingerprint() == ("cost-off",)


def test_range_engine_cost_pick_is_the_rule_singleton():
    for fits_s, fits_t in ((True, True), (False, True), (False, False)):
        rule = "shifted" if fits_s else ("stream" if fits_t else "windowed")
        assert cost.decide_range_engine(8, 10**6, fits_s, fits_t) == rule
        assert ref_cost.decide_range_engine(8, 10**6, fits_s, fits_t) \
            == rule


def test_set_measured_rejects_unknown_inputs():
    with pytest.raises(KeyError, match="unknown cost input"):
        cost.set_measured(not_a_real_input=1.0)


def test_fingerprint_tracks_measured_inputs():
    fp0 = cost.fingerprint()
    cost.set_measured(join_single_rate=123.0)
    assert cost.fingerprint() != fp0
    cost.clear_measured()
    assert cost.fingerprint() == fp0


def test_pinned_snapshot_wins_over_later_overlays():
    snap = cost.snapshot()
    with cost.pinned(snap):
        cost.set_measured(hbm_stream_rate=1.0)
        assert cost.params()["hbm_stream_rate"] == snap["hbm_stream_rate"]
    assert cost.params()["hbm_stream_rate"] == 1.0


# ----------------------------------------------------------------------
# pinned to the same inputs, the reference's numbers and decisions
# ----------------------------------------------------------------------

@pytest.fixture
def same_inputs():
    same = {k: v * 1.37 for k, v in ref_cost.PRIORS.items()
            if k in cost.PRIORS}
    cost.set_measured(**same)
    # the port's model is the reference's without a chunk overhead
    ref_cost.set_measured(**same, chunk_overhead_s=0.0)
    return same


@pytest.mark.parametrize("lanes", LANES)
def test_join_costs_are_the_reference_ones(same_inputs, lanes):
    for limit in (196_608, 0):
        for ok in (True, False):
            assert cost.join_costs(lanes, limit, ok) == \
                ref_cost.join_costs(lanes, limit, ok)
            assert cost.decide_join_engine(lanes, limit, ok) == \
                ref_cost.decide_join_engine(lanes, limit, ok)


@pytest.mark.parametrize("W,n", [(1, 64), (40, 10**5), (5000, 10**7)])
def test_range_costs_are_the_reference_ones(same_inputs, W, n):
    assert cost.range_costs(W, n) == ref_cost.range_costs(W, n)


@pytest.mark.parametrize("n_ops,est", [(2, 0), (3, 10**8), (8, 10**11)])
def test_fusion_and_stitch_are_the_reference_ones(same_inputs, n_ops, est):
    assert cost.fusion_worthwhile(n_ops, est) == \
        ref_cost.fusion_worthwhile(n_ops, est)
    assert cost.stitch_worthwhile(n_ops, est) == \
        ref_cost.stitch_worthwhile(n_ops, est)


@pytest.mark.parametrize("args", [(2, 2000, 4, 4000), (3, None, 2, None),
                                  (1, 10**9, 2, 10**3)])
def test_reshard_decision_is_the_reference_one(same_inputs, args):
    assert cost.reshard_decision(*args) == ref_cost.reshard_decision(*args)


# ----------------------------------------------------------------------
# flips: cost-decided and bitwise
# ----------------------------------------------------------------------

def test_join_engine_flip_is_bitwise_identical():
    left, right = _frame(["x"], seed=1), _frame(["bid", "ask"], seed=2)
    assert profiling.pick_join_engine(100, 196_608, False) == "single"
    out_single = left.asofJoin(right, right_prefix="r").df
    cost.set_measured(join_single_rate=1e3)
    assert profiling.pick_join_engine(100, 196_608, False) == "bracket"
    out_bracket = left.asofJoin(right, right_prefix="r").df
    pd.testing.assert_frame_equal(out_single, out_bracket, check_exact=True)


def test_forced_knob_beats_cost_model(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_JOIN_ENGINE", "bracket")
    cost.set_measured(host_bracket_rate=1e-3)
    assert profiling.pick_join_engine(100, 196_608, True) == "bracket"


def _mesh_chain(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    mesh = make_mesh({"series": 2}, devices=["cpu"] * 2)
    return (_frame(["x"], seed=3).on_mesh(mesh)
            .asofJoin(_frame(["v"], seed=4).on_mesh(mesh))
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10))


def test_fusion_cost_flip_bitwise(monkeypatch):
    chain = _mesh_chain(monkeypatch)
    root = ir.Node("collect", inputs=(chain.plan,))
    assert any(n.op == "fused_asof_stats_ema"
               for n in optimizer.optimize(root).walk())
    out_fused = chain.collect().df
    cost.set_measured(fused_overhead_s=10.0)
    flipped = optimizer.optimize(root)
    assert not any(n.op == "fused_asof_stats_ema" for n in flipped.walk())
    assert [n.ann["fusion_cost"]["decision"] for n in flipped.walk()
            if "fusion_cost" in n.ann] == ["op-by-op"]
    pd.testing.assert_frame_equal(out_fused, chain.collect().df,
                                  check_exact=True)


def test_fusion_flip_replans_through_cache(monkeypatch):
    chain = _mesh_chain(monkeypatch)
    chain.collect()
    assert (profiling.plan_cache_stats()["builds"],
            profiling.plan_cache_stats()["hits"]) == (1, 0)
    cost.set_measured(fused_overhead_s=10.0)
    chain.collect()
    assert profiling.plan_cache_stats()["builds"] == 2
    cost.clear_measured()
    chain.collect()
    st = profiling.plan_cache_stats()
    assert st["builds"] == 2 and st["hits"] == 1


def _time_sharded_chain(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    mesh = make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    return (_frame(["x"], K=4, L=64, seed=5).on_mesh(mesh, time_axis="time")
            .resample("30 seconds", "mean", metricCols=["x"]))


def test_reshard_cost_flip_bitwise(monkeypatch):
    chain = _time_sharded_chain(monkeypatch)
    root = ir.Node("collect", inputs=(chain.plan,))
    placed = optimizer.optimize(root)
    assert any(n.op == "reshard" for n in placed.walk())
    assert placed.ann["reshard_cost"]["decision"] == "placed"
    out_placed = chain.collect().df
    cost.set_measured(reshard_dispatch_s=10.0)
    decl = optimizer.optimize(root)
    assert not any(n.op == "reshard" for n in decl.walk())
    assert decl.ann["reshard_cost"]["decision"] == "declarative"
    pd.testing.assert_frame_equal(out_placed, chain.collect().df,
                                  check_exact=True)
    assert "cost-decided -> declarative" in chain.explain()


def test_stitch_cost_flip_bitwise(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    mesh = make_mesh({"series": 2}, devices=["cpu"] * 2)
    chain = (_frame(["x"], seed=6).on_mesh(mesh).EMA("x", window=6)
             .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10))
    root = ir.Node("collect", inputs=(chain.plan,))
    assert any(n.op == "stitched" for n in optimizer.optimize(root).walk())
    out = chain.collect().df
    cost.set_measured(fused_overhead_s=10.0)
    flipped = optimizer.optimize(root)
    assert not any(n.op == "stitched" for n in flipped.walk())
    pd.testing.assert_frame_equal(out, chain.collect().df, check_exact=True)


def test_reshard_cost_silent_on_series_only_chains(monkeypatch):
    opt = optimizer.optimize(ir.Node("collect", inputs=(
        _mesh_chain(monkeypatch).plan,)))
    assert "reshard_cost" not in opt.ann


def test_explain_renders_cost_annotations(monkeypatch):
    text = _mesh_chain(monkeypatch).explain()
    assert "est cost:" in text and "cost-decided fusion: fused" in text


def test_explain_renders_range_engine_costs_on_host_chains(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    text = _frame(["x"]).withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=10).explain()
    assert "engine[stats]=shifted" in text and "est cost:" in text
    for eng in ("shifted", "stream", "windowed"):
        assert f"{eng}~" in text


def test_host_value_column_filter_is_shared():
    df = _df(["x", "y"])
    df["seq"] = np.arange(len(df))
    t = TSDF(df, "event_ts", ["sym"], sequence_col="seq", device="cpu")
    assert sorted(optimizer._host_value_cols(t)) == ["x", "y"]
    src = ir.Node("source", payload=t)
    assert optimizer._device_plane_count(
        ir.Node("on_mesh", inputs=(src,))) == 2
    assert optimizer._device_plane_count(src) == 2
    # the reference's filter agrees
    rt = tempo_tpu.TSDF(df, "event_ts", ["sym"], sequence_col="seq")
    from tempo_tpu.plan import optimizer as ref_opt

    assert ref_opt._host_value_cols(rt) == optimizer._host_value_cols(t)
