"""Whole-chain stitching of the port (``tempo_tpu_torch/plan/stitch.py``
and the optimizer's ``_stitch_chains`` pass) against the reference's.

* The stitch groups (stages and op counts) the optimizer forms are the
  reference's for the reference's chain matrix (``tests/test_stitch.py``)
  and under ``TEMPO_TPU_STITCH_MAX_OPS`` and checkpoint barriers.
* A stitched chain is bitwise the op-by-op chain (on the CPU the stages
  run uncaptured through the eager methods; on the card the same
  function is captured once into a CUDA graph, which ``chip_smoke.py``
  phase L checks); a refused chain falls back op by op, bitwise, with
  the eager error messages; an untouched column rides by reference.
* The run-time guards refuse by name what a graph cannot hold: a mesh
  over several processes, a time-sharded frame, and on the card the
  bucket-stats kernel's staged form (it reads its long-row count on the
  host).
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu.plan import checkpoints as ref_ckpt
from tempo_tpu.plan import ir as ref_ir
from tempo_tpu.plan import optimizer as ref_opt
from tempo_tpu_torch import TSDF, checkpoint, make_mesh, profiling
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import checkpoints as plan_ckpt
from tempo_tpu_torch.plan import ir, lazy, optimizer, stitch
from tempo_tpu_torch.testing import faults

K, L = 3, 48


def _df(seed=0, rows=L):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, rows)).astype(np.int64),
                     axis=-1)
    return pd.DataFrame({"sym": np.repeat([f"s{i}" for i in range(K)], rows),
                         "event_ts": secs.ravel(),
                         "x": rng.standard_normal(K * rows),
                         "y": rng.standard_normal(K * rows)})


def mesh_frame(seed=0, shards=2):
    return TSDF(_df(seed), "event_ts", ["sym"], device="cpu").on_mesh(
        make_mesh({"series": shards}, devices=["cpu"] * shards))


def ref_mesh_frame(seed=0, shards=2):
    return tempo_tpu.TSDF(_df(seed), "event_ts", ["sym"]).on_mesh(
        ref_mesh({"series": shards}))


@pytest.fixture
def plan_on(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    plan_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()


CHAINS = {
    "resample_interp": lambda d: d.resample("5 seconds", "mean")
    .interpolate(method="linear"),
    "resample_interp_flags": lambda d: d.resample("5 seconds", "mean")
    .interpolate(method="ffill", show_interpolated=True),
    "interp_ema": lambda d: d.interpolate(
        freq="5 seconds", func="mean", method="linear").EMA("x", window=6),
    "ema_stats": lambda d: d.EMA("x", window=6)
    .withRangeStats(colsToSummarize=["x", "y"], rangeBackWindowSecs=10),
    "ema_ema_stats": lambda d: d.EMA("x", window=4).EMA("y", window=6)
    .withRangeStats(colsToSummarize=["EMA_x", "EMA_y"],
                    rangeBackWindowSecs=12),
    "resample_ema_stats": lambda d: d.resample("5 seconds", "mean")
    .EMA("x", window=6)
    .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=20),
    "floor_interp_ema_stats": lambda d: d.resample("5 seconds", "floor")
    .interpolate(method="linear").EMA("x", exact=True)
    .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=20),
    "bars_interp": lambda d: d.calc_bars("5 seconds", metricCols=["x"])
    .interpolate(method="ffill"),
    "bars_fill_singleton": lambda d: d.calc_bars(
        "5 seconds", metricCols=["x", "y"], fill=True),
}


def _groups(opt):
    return [(tuple(op for op, _ in n.param("stages")), n.param("n_ops"))
            for n in opt.walk() if n.op == "stitched"]


def _port_groups(name):
    root = ir.Node("collect", inputs=(CHAINS[name](mesh_frame()).plan,))
    return _groups(optimizer.optimize(root))


def _ref_groups(name):
    root = ref_ir.Node("collect", inputs=(
        CHAINS[name](ref_mesh_frame()).plan,))
    return _groups(ref_opt.optimize(root))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_stitch_groups_are_the_reference_ones(plan_on, name):
    assert _port_groups(name) == _ref_groups(name)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_stitched_matches_eager_bitwise(plan_on, name, monkeypatch):
    fn = CHAINS[name]
    monkeypatch.setenv("TEMPO_TPU_PLAN", "0")
    eager = fn(mesh_frame()).collect().df
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    lz = fn(mesh_frame())
    device_ops = [n for n in lz.plan.walk() if n.op in stitch.STITCHABLE_OPS]
    groups = _groups(optimizer.optimize(lz.plan))
    if len(device_ops) >= 2:
        assert sum(n for _, n in groups) == len(device_ops)
    else:
        assert not groups
    pd.testing.assert_frame_equal(lz.collect().df, eager, check_exact=True)
    pd.testing.assert_frame_equal(fn(mesh_frame()).collect().df, eager,
                                  check_exact=True)      # a cache hit


def test_explain_renders_stitch_group(plan_on):
    text = CHAINS["resample_ema_stats"](mesh_frame()).explain()
    assert "stitched[resample -> ema -> range_stats]" in text
    assert "3 ops -> 1 dispatch" in text and "captured CUDA graph" in text


@pytest.mark.parametrize("cap", ["0", "1", "2", "3"])
def test_knob_caps_and_disables_like_the_reference(plan_on, monkeypatch,
                                                   cap):
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", cap)
    for name in ("resample_ema_stats", "ema_ema_stats"):
        assert _port_groups(name) == _ref_groups(name)
    if cap in ("0", "1"):
        assert not _port_groups("resample_ema_stats")


def test_knob_off_is_bitwise(plan_on, monkeypatch):
    fn = CHAINS["ema_ema_stats"]
    on = fn(mesh_frame()).collect().df
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", "0")
    plan_cache.CACHE.clear()
    pd.testing.assert_frame_equal(fn(mesh_frame()).collect().df, on,
                                  check_exact=True)


def test_stitched_signature_rekeys_cache(plan_on, monkeypatch):
    fn = CHAINS["resample_ema_stats"]
    fn(mesh_frame()).collect()
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", "0")
    root = ir.Node("collect", inputs=(fn(mesh_frame()).plan,))
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", "8")
    stitched = ir.signature(optimizer.optimize(root))
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", "0")
    assert ir.signature(optimizer.optimize(root)) != stitched


def test_refused_chain_falls_back_bitwise(plan_on, monkeypatch):
    fn = CHAINS["resample_ema_stats"]
    want = fn(mesh_frame()).collect().df

    def refuse(frame, stages):
        raise stitch._Refuse("forced")

    monkeypatch.setattr(stitch, "_guard", refuse)
    plan_cache.CACHE.clear()
    pd.testing.assert_frame_equal(fn(mesh_frame()).collect().df, want,
                                  check_exact=True)


def test_fallback_surfaces_eager_error(plan_on):
    lz = mesh_frame().resample("5 seconds", "mean").interpolate(
        method="cubic")
    assert _groups(optimizer.optimize(lz.plan))
    with pytest.raises(ValueError, match="fill options"):
        lz.collect()


def test_untouched_column_rides_by_reference():
    frame = mesh_frame()
    node = ir.Node("stitched", params=dict(
        stages=(("ema", (("colName", "x"), ("exact", False),
                         ("exp_factor", 0.2), ("inclusive_window", False),
                         ("window", 6))),), n_ops=1))
    out = stitch.run(frame, node)
    assert out.cols["y"] is frame.cols["y"]
    assert out.cols["x"] is frame.cols["x"] and "EMA_x" in out.cols


def test_guards_refuse_by_name():
    stages = (("ema", (("colName", "x"),)),)
    two = make_mesh({"series": 2}, devices=["cpu"] * 2, ranks=[0, 1])
    frame = mesh_frame()
    with pytest.raises(stitch._Refuse, match="processes"):
        stitch._guard(frame._with(mesh=two), stages)
    t = make_mesh({"series": 1, "time": 2}, devices=["cpu"] * 2)
    tf = TSDF(_df(), "event_ts", ["sym"], device="cpu").on_mesh(
        t, time_axis="time")
    with pytest.raises(stitch._Refuse, match="time-sharded"):
        stitch._guard(tf, stages)
    stitch._guard(frame, stages)            # a CPU mesh frame passes
    node = ir.Node("stitched", params=dict(stages=stages, n_ops=1))
    assert stitch.run(tf, node) is None
    # the stages that reach the bucket-stats kernel
    agg = stitch._bucket_aggregate
    assert agg("resample", {"func": "mean"}) and agg("calc_bars", {})
    assert not agg("resample", {"func": "floor"})
    assert agg("interpolate", {"func": "max"})
    assert not agg("interpolate", {"func": None})
    assert not agg("ema", {}) and not agg("range_stats", {})


def test_time_sharded_chain_reshards_then_stitches(plan_on, monkeypatch):
    mesh = make_mesh({"series": 1, "time": 2}, devices=["cpu"] * 2)

    def fn():
        d = TSDF(_df(3), "event_ts", ["sym"], device="cpu").on_mesh(
            mesh, time_axis="time")
        return (d.withRangeStats(colsToSummarize=["x"],
                                 rangeBackWindowSecs=10)
                .resample("5 seconds", "floor").EMA("x", exact=True))

    opt = optimizer.optimize(ir.Node("collect", inputs=(fn().plan,)))
    ops = [n.op for n in opt.walk() if not n.is_source()]
    assert "reshard" in ops and "stitched" in ops
    planned = fn().collect().df
    monkeypatch.setenv("TEMPO_TPU_PLAN", "0")
    pd.testing.assert_frame_equal(planned, fn().collect().df,
                                  check_exact=True)


# ----------------------------------------------------------------------
# Checkpoint barriers inside a stitched chain
# ----------------------------------------------------------------------

def _ckpt_chain(frame, mod=lazy):
    return (mod.wrap(mod._as_node(frame)).resample("5 seconds", "mean")
            .EMA("x", window=6)
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=20)
            .EMA("y", window=4))


def test_checkpoint_barriers_split_stitch_groups(tmp_path):
    from tempo_tpu.plan import lazy as ref_lazy

    with plan_ckpt.checkpointed(str(tmp_path), every=2):
        got = optimizer.optimize(ir.Node("collect", inputs=(
            _ckpt_chain(mesh_frame(7))._node,)))
    with ref_ckpt.checkpointed(str(tmp_path), every=2):
        want = ref_opt.optimize(ref_ir.Node("collect", inputs=(
            _ckpt_chain(ref_mesh_frame(7), ref_lazy)._node,)))
    assert [n for _, n in _groups(got)] == [2, 2]
    assert _groups(got) == _groups(want)
    assert [n.param("step") for n in got.walk() if n.op == "checkpoint"] \
        == [n.param("step") for n in want.walk() if n.op == "checkpoint"]


def test_resume_reruns_only_post_barrier_stitch_group(tmp_path,
                                                      monkeypatch):
    plan_cache.CACHE.clear()
    frame = mesh_frame(8)
    d = str(tmp_path / "ck")
    want = _ckpt_chain(frame).collect().df
    with faults.FaultInjector() as fi:
        fi.kill_on_call(np, "savez", call_no=2)
        with pytest.raises(faults.SimulatedKill):
            with plan_ckpt.checkpointed(d, every=2):
                _ckpt_chain(frame).collect()
    assert checkpoint.latest(d).endswith("step_00001")
    builds0 = profiling.plan_cache_stats()["builds"]
    calls = []
    orig = stitch.run

    def counting(fr, node):
        calls.append([op for op, _ in node.param("stages")])
        return orig(fr, node)

    monkeypatch.setattr(stitch, "run", counting)
    with plan_ckpt.checkpointed(d, every=2):
        got = _ckpt_chain(frame).collect().df
    assert calls == [["range_stats", "ema"]]
    assert profiling.plan_cache_stats()["builds"] == builds0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
