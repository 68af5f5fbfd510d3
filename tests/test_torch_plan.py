"""The port's planner (``tempo_tpu_torch/plan/``) against the reference's
(``tempo_tpu/plan/``), with ``TEMPO_TPU_PLAN=1`` in both.

* **Logical signatures**: the same recorded chains give the same
  ``ir.signature`` strings in both packages (the same sha1 over the
  same text).
* **Optimized plans**: with both packages' cost priors pinned to the
  same values (``cost.set_measured``), the optimizer makes the same
  decisions: node ops in walk order, fused and stitched groups,
  barriers, reshard nodes and hoisted join engines (range engines are
  compared as the port names them: the reference's ``stream`` is the
  port's row-bounded ``shifted`` kernel).
* **Results**: planned results are bitwise the port's eager results
  (``device="cpu"``: the kernels' plain versions, the fused and stitched
  device functions uncaptured), and match the reference's planned
  results within rtol = atol = 1e-9 (the mesh tolerance of
  ``tests/test_torch_dist.py``; keys, timestamps, counts and joined
  values are equal).
* **Cache counters**: the same hit / miss / eviction / build sequence
  in both packages.

The reference's cases of ``tests/test_plan.py`` that concern the port
(recording, rewrites, guards, pruning, hints, the cache, explain) are
mirrored at K = 3 series of L = 48 rows.
"""

import logging
import threading

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.plan import cache as ref_cache
from tempo_tpu.plan import cost as ref_cost
from tempo_tpu.plan import ir as ref_ir
from tempo_tpu.plan import optimizer as ref_opt
from tempo_tpu_torch import TSDF, make_mesh, profiling
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import cost, fused, hints, ir, lazy, optimizer

K, L = 3, 48
WINDOW = 10
RTOL = ATOL = 1e-9


def _dfs(seed=0, nulls=False, seq=False, rows=L):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, rows)).astype(np.int64),
                     axis=-1)
    syms = np.repeat([f"s{i}" for i in range(K)], rows)
    df_l = pd.DataFrame({"sym": syms, "event_ts": secs.ravel(),
                         "x": rng.standard_normal(K * rows)})
    r_secs = np.cumsum(rng.integers(1, 3, size=(K, rows)).astype(np.int64),
                       axis=-1)
    v0 = rng.standard_normal(K * rows)
    if nulls:
        v0[rng.random(K * rows) < 0.15] = np.nan
    df_r = pd.DataFrame({"sym": syms, "event_ts": r_secs.ravel(), "v0": v0,
                         "v1": rng.standard_normal(K * rows)})
    if seq:
        df_r["seq"] = rng.integers(0, 5, size=K * rows)
    return df_l, df_r


def frames(seed=0, nulls=False, seq=False, rows=L, pkg="port"):
    df_l, df_r = _dfs(seed, nulls, seq, rows)
    sc = "seq" if seq else None
    if pkg == "ref":
        return (tempo_tpu.TSDF(df_l, "event_ts", ["sym"]),
                tempo_tpu.TSDF(df_r, "event_ts", ["sym"], sequence_col=sc))
    return (TSDF(df_l, "event_ts", ["sym"], device="cpu"),
            TSDF(df_r, "event_ts", ["sym"], sequence_col=sc, device="cpu"))


def _mesh():
    return make_mesh({"series": 2}, devices=["cpu"] * 2)


@pytest.fixture
def plan_on(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    plan_cache.CACHE.clear()
    ref_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()
    ref_cache.CACHE.clear()


@pytest.fixture
def pinned(plan_on):
    """Both packages' cost inputs pinned to the reference's priors."""
    same = {k: v for k, v in ref_cost.PRIORS.items() if k in cost.PRIORS}
    cost.set_measured(**same)
    # the port's model is the reference's without a chunk overhead (its
    # chunked engine tiles its rows in one call)
    ref_cost.set_measured(**same, chunk_overhead_s=0.0)
    yield same
    cost.clear_measured()
    ref_cost.clear_measured()


def _close(got: pd.DataFrame, want: pd.DataFrame):
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        if c.startswith("zscore_"):
            std = "stddev_" + c[len("zscore_"):]
            g, w = g * got[std], w * want[std]
        elif c.startswith("stddev_"):
            g, w = g * g, w * w
        if pd.api.types.is_float_dtype(w.dtype) \
                and not c.startswith(("count", "is_")):
            np.testing.assert_allclose(g.to_numpy(float), w.to_numpy(float),
                                       rtol=RTOL, atol=ATOL, equal_nan=True,
                                       err_msg=c)
        else:
            pd.testing.assert_series_equal(g, w, check_dtype=False, obj=c)


# ----------------------------------------------------------------------
# Chains recorded in both packages
# ----------------------------------------------------------------------

HOST_CHAINS = {
    "join_select": lambda lt, rt: lt.asofJoin(rt).select(
        ["event_ts", "sym", "x", "right_v0"]),
    "stats_ema": lambda lt, rt: lt.withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=WINDOW).EMA("x"),
    "resample_mean": lambda lt, rt: lt.resample(
        "1 minute", "mean", metricCols=["x"]),
    "resample_ema_fusion": lambda lt, rt: lt.resample(
        "1 minute", "floor", metricCols=["x"]).EMA("x", exact=True),
    "with_column": lambda lt, rt: lt.withColumn("x2", 2).EMA("x"),
    "sql": lambda lt, rt: lt.filter("x > 0.1").selectExpr(
        "sym", "event_ts", "x * 2 AS x2"),
}

MESH_CHAINS = {
    "join_stats_ema": lambda dl, dr: dl.asofJoin(dr).withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=WINDOW).EMA(
        "x", exact=True),
    "join_ema_stats": lambda dl, dr: dl.asofJoin(dr).EMA(
        "right_v0", exact=True).withRangeStats(
        colsToSummarize=["right_v0"], rangeBackWindowSecs=WINDOW),
    "join_all_stats": lambda dl, dr: dl.asofJoin(dr).withRangeStats(
        rangeBackWindowSecs=WINDOW),
    "join_lookback_stats": lambda dl, dr: dl.asofJoin(
        dr, maxLookback=3).withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=WINDOW),
    "resample_interp_ema": lambda dl, dr: dl.resample(
        "10 seconds", "floor").interpolate(method="linear").EMA(
        "x", exact=True),
    "ema_stats": lambda dl, dr: dl.EMA("x", window=6).withRangeStats(
        colsToSummarize=["x"], rangeBackWindowSecs=WINDOW),
    "bars_fourier": lambda dl, dr: dl.calc_bars(
        "10 seconds", metricCols=["x"]).fourier_transform(1.0, "open_x"),
}


def _host_plan(pkg, name, seed=0):
    lt, rt = frames(seed, pkg=pkg)
    return HOST_CHAINS[name](lt, rt)._node


def _mesh_plan(pkg, name, seed=0, terminal="collect"):
    # the default mesh: its plan parameter is the same in both packages
    lt, rt = frames(seed, pkg=pkg)
    lz = MESH_CHAINS[name](lt.on_mesh(), rt.on_mesh())
    mod = ref_ir if pkg == "ref" else ir
    return mod.Node(terminal, inputs=(lz._node,))


def _plans(name):
    if name in HOST_CHAINS:
        return _host_plan("port", name), _host_plan("ref", name)
    return _mesh_plan("port", name), _mesh_plan("ref", name)


@pytest.mark.parametrize("name", sorted(HOST_CHAINS) + sorted(MESH_CHAINS))
def test_logical_signature_is_the_reference_one(plan_on, name):
    port, ref = _plans(name)
    assert ir.signature(port) == ref_ir.signature(ref)
    assert [n.op for n in port.walk()] == [n.op for n in ref.walk()]
    assert port.uncacheable() == ref.uncacheable()


def _decisions(root, host_range=True):
    """What the optimizer decided, package-neutral.  ``host_range=False``
    leaves out a host chain's range engine: the reference on the CPU
    backend takes its windowed XLA form there, its Pallas kernels not
    running on the CPU, where the port picks its row-bounded kernel as
    the reference does on a TPU."""
    eng = {"stream": "shifted"}
    out = []
    for n in root.walk():
        if n.is_source():
            out.append((n.op, n.ann.get("pruned")))
            continue
        out.append((
            n.op,
            tuple(op for op, _ in (n.param("stages") or ())),
            n.ann.get("join_engine"),
            eng.get(n.ann.get("range_engine"), n.ann.get("range_engine"))
            if host_range or optimizer._mesh_side(n) else None,
            "barrier" in n.ann, n.param("target"), n.param("step"),
            n.param("has_ema"),
            (n.ann.get("fusion_cost") or {}).get("decision"),
            (n.ann.get("stitch_cost") or {}).get("decision")))
    return out


@pytest.mark.parametrize("name", sorted(HOST_CHAINS) + sorted(MESH_CHAINS))
def test_optimized_decisions_are_the_reference_ones(pinned, name):
    port, ref = _plans(name)
    got = _decisions(optimizer.optimize(port), host_range=False)
    want = _decisions(ref_opt.optimize(ref), host_range=False)
    assert got == want


def test_time_axis_reshard_placement_is_the_reference_ones(pinned):
    """Reshard nodes, eliminated switches and the sink blocker on a
    time-sharded mesh chain."""
    from tempo_tpu.parallel import make_mesh as ref_mesh

    def chain(lt, rt, mesh):
        return (lt.on_mesh(mesh, time_axis="time")
                .asofJoin(rt.on_mesh(mesh, time_axis="time"))
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=WINDOW)
                .resample("10 seconds", "mean").EMA("x", exact=True))

    lt, rt = frames(5)
    rl, rr = frames(5, pkg="ref")
    port = ir.Node("collect", inputs=(chain(
        lt, rt, make_mesh({"series": 1, "time": 2},
                          devices=["cpu"] * 2))._node,))
    ref = ref_ir.Node("collect", inputs=(chain(
        rl, rr, ref_mesh({"series": 1, "time": 2}))._node,))
    got, want = optimizer.optimize(port), ref_opt.optimize(ref)
    assert _decisions(got) == _decisions(want)
    assert [n.ann.get("reshard_note") for n in got.walk()] == \
        [n.ann.get("reshard_note") for n in want.walk()]
    assert any(n.op == "reshard" for n in got.walk())


# ----------------------------------------------------------------------
# Results: planned == eager bitwise; planned ~ the reference's planned
# ----------------------------------------------------------------------

def _run_mesh(name, monkeypatch, plan, seed=7, nulls=False, seq=False,
              pkg="port"):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1" if plan else "0")
    lt, rt = frames(seed, nulls, seq, pkg=pkg)
    if pkg == "ref":
        from tempo_tpu.parallel import make_mesh as ref_mesh

        mesh = ref_mesh({"series": 2})
    else:
        mesh = _mesh()
    return MESH_CHAINS[name](lt.on_mesh(mesh), rt.on_mesh(mesh)) \
        .collect().df


# the single-frame chains need one data variant
_ONE_FRAME = ("resample_interp_ema", "bars_fourier", "ema_stats")


@pytest.mark.parametrize("name,variant", [
    (n, v) for n in sorted(MESH_CHAINS) for v in ("plain", "nulls", "seq")
    if v == "plain" or n not in _ONE_FRAME])
def test_mesh_chain_planned_is_eager_bitwise(monkeypatch, name, variant):
    kw = dict(nulls=variant == "nulls", seq=variant == "seq")
    plan_cache.CACHE.clear()
    eager = _run_mesh(name, monkeypatch, False, **kw)
    planned = _run_mesh(name, monkeypatch, True, **kw)
    again = _run_mesh(name, monkeypatch, True, **kw)      # a cache hit
    pd.testing.assert_frame_equal(planned, eager, check_exact=True)
    pd.testing.assert_frame_equal(again, eager, check_exact=True)


@pytest.mark.parametrize("name", sorted(HOST_CHAINS))
def test_host_chain_planned_is_eager_bitwise(monkeypatch, name):
    lt, rt = frames(3)
    monkeypatch.setenv("TEMPO_TPU_PLAN", "0")
    eager = (lt.resampleEMA("1 minute", "x")
             if name == "resample_ema_fusion"
             else HOST_CHAINS[name](lt, rt)).df
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    plan_cache.CACHE.clear()
    planned = HOST_CHAINS[name](lt, rt).df
    pd.testing.assert_frame_equal(planned, eager, check_exact=True)


@pytest.mark.parametrize("name", ["join_stats_ema", "join_all_stats",
                                  "resample_interp_ema"])
def test_mesh_chain_planned_matches_the_reference(monkeypatch, name):
    got = _run_mesh(name, monkeypatch, True)
    want = _run_mesh(name, monkeypatch, True, pkg="ref")
    _close(got, want)


@pytest.mark.parametrize("name", ["join_select", "stats_ema", "sql"])
def test_host_chain_planned_matches_the_reference(monkeypatch, name):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    got = HOST_CHAINS[name](*frames(4)).df
    want = HOST_CHAINS[name](*frames(4, pkg="ref")).df
    _close(got, want)


def test_randomized_chain_matrix_bitwise(monkeypatch):
    rng = np.random.default_rng(99)
    pool = [
        lambda d: d.withRangeStats(colsToSummarize=["x"],
                                   rangeBackWindowSecs=WINDOW),
        lambda d: d.EMA("x", exact=True),
        lambda d: d.EMA("x", exact=False),
    ]
    for trial in range(4):
        lt, rt = frames(100 + trial, nulls=bool(trial % 2), seq=trial == 3)
        steps = [pool[i] for i in rng.choice(len(pool), 2, replace=False)]

        def fn(dl, dr):
            out = dl.asofJoin(dr) if trial % 2 else dl
            for s in steps:
                out = s(out)
            return out.collect().df

        monkeypatch.setenv("TEMPO_TPU_PLAN", "0")
        eager = fn(lt.on_mesh(_mesh()), rt.on_mesh(_mesh()))
        monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
        plan_cache.CACHE.clear()
        planned = fn(lt.on_mesh(_mesh()), rt.on_mesh(_mesh()))
        pd.testing.assert_frame_equal(planned, eager, check_exact=True)


# ----------------------------------------------------------------------
# Recording, rewrites, guards
# ----------------------------------------------------------------------

def test_eager_remains_default(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_PLAN", raising=False)
    lt, rt = frames()
    assert isinstance(lt.asofJoin(rt), TSDF)


def test_every_planned_method_records(plan_on):
    """Each method of ``PLANNED_METHODS`` returns a lazy wrapper whose
    node is that method's op."""
    lt, rt = frames()
    d = lt.on_mesh(_mesh())
    with_ops = {
        ("TSDF", "select"): (lambda: lt.select("sym", "event_ts", "x"),
                             "select"),
        ("TSDF", "selectExpr"): (lambda: lt.selectExpr("sym", "x + 1 AS y"),
                                 "sql_project"),
        ("TSDF", "filter"): (lambda: lt.filter("x > 0"), "sql_filter"),
        ("TSDF", "withColumn"): (lambda: lt.withColumn("c", 1),
                                 "with_column"),
        ("TSDF", "asofJoin"): (lambda: lt.asofJoin(rt), "asof_join"),
        ("TSDF", "withRangeStats"): (lambda: lt.withRangeStats(),
                                     "range_stats"),
        ("TSDF", "EMA"): (lambda: lt.EMA("x"), "ema"),
        ("TSDF", "resample"): (lambda: lt.resample("1 minute", "mean"),
                               "resample"),
        ("TSDF", "resampleEMA"): (lambda: lt.resampleEMA("1 minute", "x"),
                                  "resample_ema"),
        ("TSDF", "interpolate"): (lambda: lt.interpolate(
            freq="1 minute", func="mean", method="zero"), "interpolate"),
        ("TSDF", "on_mesh"): (lambda: lt.on_mesh(_mesh()), "on_mesh"),
    }
    d_ops = {"asofJoin": "asof_join", "withRangeStats": "range_stats",
             "EMA": "ema", "resample": "resample",
             "interpolate": "interpolate", "calc_bars": "calc_bars",
             "fourier_transform": "fourier",
             "withLookbackFeatures": "lookback_features"}
    d_calls = {
        "asofJoin": lambda: d.asofJoin(rt.on_mesh(_mesh())),
        "withRangeStats": lambda: d.withRangeStats(),
        "EMA": lambda: d.EMA("x"),
        "resample": lambda: d.resample("1 minute", "mean"),
        "interpolate": lambda: d.interpolate(
            freq="1 minute", func="mean", method="zero"),
        "calc_bars": lambda: d.calc_bars("1 minute"),
        "fourier_transform": lambda: d.fourier_transform(1.0, "x"),
        "withLookbackFeatures": lambda: d.withLookbackFeatures(["x"], 3),
    }
    for cls, names in ir.PLANNED_METHODS.items():
        for m in names:
            if cls == "TSDF":
                call, op = with_ops[(cls, m)]
            else:
                call, op = d_calls[m], d_ops[m]
            out = call()
            assert isinstance(out, lazy._LazyBase), (cls, m)
            assert out.plan.op == op, (cls, m)
    assert ir.PLANNED_METHODS == ref_ir.PLANNED_METHODS


def test_non_recorded_op_materialises_and_delegates(plan_on):
    lt, rt = frames()
    assert isinstance(lt.asofJoin(rt).describe(), pd.DataFrame)


def test_fused_rewrite_fires_and_guards(plan_on):
    lt, rt = frames()
    lz = MESH_CHAINS["join_stats_ema"](lt.on_mesh(_mesh()),
                                       rt.on_mesh(_mesh()))
    opt = optimizer.optimize(lz.plan)
    (f,) = [n for n in opt.walk() if n.op == "fused_asof_stats_ema"]
    assert f.param("has_ema") is True and f.param("e_col") == "x"
    assert "capture" not in f.ann
    lt, rt = frames(seq=True)      # a sequence column blocks the fusion
    lz = MESH_CHAINS["join_stats_ema"](lt.on_mesh(_mesh()),
                                       rt.on_mesh(_mesh()))
    assert not any(n.op == "fused_asof_stats_ema"
                   for n in optimizer.optimize(lz.plan).walk())


def test_mesh_over_processes_is_planned_uncaptured(plan_on):
    """A mesh spanning processes (gloo) runs planned but op by op; the
    node says why, and explain shows it."""
    lt, rt = frames()
    mesh = make_mesh({"series": 2}, devices=["cpu"] * 2, ranks=[0, 1])
    lz = MESH_CHAINS["join_stats_ema"](lt.on_mesh(mesh), rt.on_mesh(mesh))
    (f,) = [n for n in optimizer.optimize(lz.plan).walk()
            if n.op == "fused_asof_stats_ema"]
    assert "spans 2 processes" in f.ann["capture"]
    assert "uncaptured" in lz.explain()


def test_fused_run_refuses_processes_and_time_axis():
    lt, rt = frames()
    node = ir.Node("fused_asof_stats_ema", params=dict(
        s_cols=("x",), s_window=WINDOW, has_ema=False))
    two = make_mesh({"series": 2}, devices=["cpu"] * 2, ranks=[0, 0])
    assert fused.run(lt.on_mesh(two), rt.on_mesh(two), node) is not None
    t = make_mesh({"series": 1, "time": 2}, devices=["cpu"] * 2)
    assert fused.run(lt.on_mesh(t, time_axis="time"),
                     rt.on_mesh(t, time_axis="time"), node) is None


def test_prune_columns_before_packing(plan_on):
    lt, rt = frames()
    opt = optimizer.optimize(
        lt.asofJoin(rt).select(["event_ts", "sym", "right_v0"]).plan)
    pruned = [n.ann.get("pruned") for n in opt.walk() if n.op == "source"]
    assert ("x",) in pruned and ("v1",) in pruned


def test_count_terminal(plan_on):
    lt, rt = frames()
    assert lt.on_mesh(_mesh()).asofJoin(rt.on_mesh(_mesh())).count() \
        == K * L


def test_barrier_marking(plan_on):
    lt, _ = frames()
    lz = (lt.on_mesh(_mesh()).resample("1 minute", "mean", metricCols=["x"])
          .fourier_transform(1.0, "x"))
    opt = optimizer.optimize(ir.Node("collect", inputs=(lz.plan,)))
    barriers = {n.op for n in opt.walk() if "barrier" in n.ann}
    assert {"collect", "fourier"} <= barriers
    opt2 = optimizer.optimize(
        lt.on_mesh(_mesh()).withLookbackFeatures(["x"], 4).plan)
    assert any("barrier" in n.ann for n in opt2.walk()
               if n.op == "lookback_features")


def test_hints_win_only_where_the_bounds_admit_them(plan_on):
    from tempo_tpu_torch.ops import rolling as rk

    with hints.installed({"join_engine": "chunked"}):
        assert profiling.pick_join_engine(10, 10**9, True) == "chunked"
        assert profiling.pick_join_engine(10, 10**9, False) == "single"
    with hints.installed({"join_engine": "single"}):
        assert profiling.pick_join_engine(10**6, 10**3, True) == "chunked"
    # range engines differ in rounding: the pick is the rule, a hint
    # does not enter it
    with hints.installed({"range_engine": "windowed"}):
        assert rk.pick_range_engine(1024, 1, 1) == "shifted"
    with hints.installed({"range_engine": "shifted"}):
        assert rk.pick_range_engine(10**9, 10**6, 10**6) == "windowed"


# ----------------------------------------------------------------------
# Executable cache
# ----------------------------------------------------------------------

def _cache_sequence(pkg, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", "2")
    c = ref_cache.CACHE if pkg == "ref" else plan_cache.CACHE
    c.clear()
    seen = []
    lt, rt = frames(41, pkg=pkg)
    lt2, rt2 = frames(42, pkg=pkg)
    lt3, _ = frames(43, rows=L + 8, pkg=pkg)
    runs = [lambda: lt.asofJoin(rt).df,                         # A miss
            lambda: lt2.asofJoin(rt2).df,                       # A hit
            lambda: lt.withRangeStats(colsToSummarize=["x"]).df,  # B
            lambda: lt3.withRangeStats(colsToSummarize=["x"]).df,  # C: A out
            lambda: lt.asofJoin(rt).df,                         # A miss
            lambda: lt.withColumn("y", lambda df: df.x).df]     # uncacheable
    for run in runs:
        run()
        st = c.stats()
        seen.append(tuple(st[k] for k in ("size", "hits", "misses",
                                          "evictions", "builds",
                                          "uncacheable")))
    return seen


def test_cache_counters_are_the_reference_ones(plan_on, monkeypatch):
    assert _cache_sequence("port", monkeypatch) == \
        _cache_sequence("ref", monkeypatch)
    st = profiling.plan_cache_stats()
    assert set(st) >= {"size", "max_size", "hits", "misses", "evictions",
                       "builds", "graph_captures", "graph_replays",
                       "by_signature", "by_tenant"}


def test_eviction_releases_the_executable(plan_on, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", "1")
    released = []

    class Exe:
        def release(self):
            released.append(self)

    a, b = Exe(), Exe()
    plan_cache.CACHE.insert(("a",), a)
    plan_cache.CACHE.insert(("b",), b)
    assert released == [a]
    plan_cache.CACHE.clear()
    assert released == [a, b]


def test_eviction_releases_outside_the_cache_lock(plan_on, monkeypatch):
    """A release waits for a replay in flight, and a replay counts itself
    under the cache's lock, so the cache releases after dropping it."""
    monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", "1")
    seen = []

    class Exe:
        def release(self):
            seen.append(plan_cache.CACHE._lock.acquire(blocking=False))
            if seen[-1]:
                plan_cache.CACHE._lock.release()

    plan_cache.CACHE.insert(("a",), Exe())
    plan_cache.CACHE.insert(("b",), Exe())
    plan_cache.CACHE.clear()
    assert seen == [True, True]


def test_graph_bytes_bound_evicts_the_oldest(plan_on, monkeypatch):
    """Past the card's share, the least recently used executables holding
    graphs on that card go, the one just run excepted."""
    monkeypatch.setattr(plan_cache, "graph_budget", lambda dev: 250)
    released = []

    class Exe:
        def __init__(self, held):
            self.held = held

        def graph_bytes(self):
            return self.held

        def release(self):
            released.append(self)

    a, b, c = (Exe({"cuda:0": 100}), Exe({"cuda:1": 100}),
               Exe({"cuda:0": 100}))
    for key, exe in ((("a",), a), (("b",), b), (("c",), c)):
        plan_cache.CACHE.insert(key, exe)
    plan_cache.CACHE.trim_graphs(keep=("c",))
    assert released == []                     # 200 bytes on cuda:0
    d = Exe({"cuda:0": 300})
    plan_cache.CACHE.insert(("d",), d)
    plan_cache.CACHE.trim_graphs(keep=("d",))
    # cuda:0 held 500: a, then c go; b holds nothing there; d stays
    assert released == [a, c]
    st = plan_cache.CACHE.stats()
    assert (st["size"], st["evictions"]) == (2, 2)


def test_release_waits_for_the_replay_in_flight():
    """Eviction frees a node's graphs only once the caller holding its
    lock (a copy-in, replay and clone-out) is done."""
    node = ir.Node("stitched")
    freed = []

    class Ent:
        def free(self):
            freed.append(True)

    node.objs["_graphs"] = {"cuda:0": Ent()}
    lock = fused._graph_lock(node)
    lock.acquire()
    t = threading.Thread(target=fused.release, args=(node,))
    t.start()
    t.join(0.2)
    assert t.is_alive() and freed == []
    lock.release()
    t.join(5)
    assert not t.is_alive() and freed == [True]
    assert "_graphs" not in node.objs


def test_cached_executable_drops_source_payloads(plan_on):
    lt, rt = frames(51)
    lt.asofJoin(rt).df
    (exe,) = plan_cache.CACHE._entries.values()
    assert all(s.payload is None for s in exe.plan.sources())


def test_numpy_scalar_params_stay_cacheable(plan_on):
    assert ir.canon(np.int64(7)) == 7 and ir.canon(np.bool_(True)) is True
    lt, _ = frames(61)
    lt.withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=WINDOW).df
    lt.withRangeStats(colsToSummarize=["x"],
                      rangeBackWindowSecs=np.int64(WINDOW)).df
    st = plan_cache.CACHE.stats()
    assert st["uncacheable"] == 0 and (st["hits"], st["builds"]) == (1, 1)


def test_cpu_chains_capture_nothing(plan_on):
    """On the CPU the fused and stitched functions run uncaptured."""
    lt, rt = frames(8)
    for _ in range(2):
        MESH_CHAINS["join_stats_ema"](lt.on_mesh(_mesh()),
                                      rt.on_mesh(_mesh())).collect()
        MESH_CHAINS["resample_interp_ema"](lt.on_mesh(_mesh()),
                                           None).collect()
    st = plan_cache.CACHE.stats()
    assert st["graph_captures"] == st["graph_replays"] == 0
    assert st["hits"] == 2


# ----------------------------------------------------------------------
# explain()
# ----------------------------------------------------------------------

def test_explain_sections_and_cost(plan_on, capsys):
    lt, rt = frames()
    lz = MESH_CHAINS["join_stats_ema"](lt.on_mesh(_mesh()),
                                       rt.on_mesh(_mesh()))
    text = lz.explain()
    for part in ("== Logical plan ==", "== Optimized plan ==",
                 "fused_asof_stats_ema", "engine[join]=", "engine[stats]=",
                 "barriers:"):
        assert part in text
    assert text in capsys.readouterr().out
    text = lz.explain(cost=True)
    assert "== Captured cost (" in text and "XLA" not in text
    assert "fused_asof_stats_ema: output_bytes=" in text
    assert "argument_bytes=" in text and "temp_bytes" not in text
    assert "source[host]: host_bytes=" in text


def test_explain_renders_what_the_reference_renders(pinned):
    """``explain(cost=False)``'s node lines, for a host chain, are the
    reference's."""
    lt, rt = frames()
    rl, rr = frames(pkg="ref")
    got = HOST_CHAINS["join_select"](lt, rt).explain()
    want = HOST_CHAINS["join_select"](rl, rr).explain()
    assert got.splitlines()[:-1] == want.splitlines()[:-1]


def test_eager_frames_explain_a_bare_source(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_PLAN", raising=False)
    lt, _ = frames()
    assert "source[host]" in lt.explain()
    assert "source[mesh" in lt.on_mesh(_mesh()).explain()


def test_eager_mesh_barrier_ops_warn(monkeypatch, caplog):
    monkeypatch.delenv("TEMPO_TPU_PLAN", raising=False)
    lt, _ = frames()
    d = lt.on_mesh(_mesh())
    with caplog.at_level(logging.WARNING, logger="tempo_tpu_torch.dist"):
        d.withLookbackFeatures(["x"], 4)
        d.resample("1 minute", "mean", metricCols=["x"]) \
            .fourier_transform(1.0, "x")
    msgs = [r.message for r in caplog.records
            if "materialization barrier" in r.message]
    assert len(msgs) == 2 and all("explain()" in m for m in msgs)
