"""The readers of the program's own spans (``lib/program_spans.py`` and
``metrics/{mesh_host_s,mesh_idle_s,launch_host_s,host_waits}.resident``)
on a hand-built trace whose values are worked out below, on a trace
without program spans (every reader None), and in one traced CPU run of
the cell."""

from types import SimpleNamespace

import pytest

from gpubench import harness
from gpubench.lib import program_spans as ps

BENCH = harness.spec()
CELL = "hhar_quickstart.resident_chain"
SEED = 2**31 + 9191
NEW = ("mesh_host_s.resident", "mesh_idle_s.resident",
       "launch_host_s.resident", "host_waits.resident")


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _trace():
    """Two chains in a window of 1000 us on thread 1 (times in us).

    Program spans: the join 10-190 (key_perm 10-50, align 50-120,
    merge 120-180 holding a launch 130-140), range stats 210-440
    (compute 300-430 holding a launch 300-310), the EMA 600-700 (a
    launch 610-615); thread 2 holds a span over the whole window.
    Card records 135-150, 160-290, 320-480 and a copy 612-650, so the
    idle gaps are 0-135 (midpoint under align), 150-160 (merge),
    290-320 (the launch 300-310), 480-612 and 650-1000 (no program
    span).  A ``cpu_op`` 60-70 covers the first gap's midpoint."""
    ev = [
        _x("gpubench.window", 0, 1000),
        _x("gpubench.chain", 0, 500),
        _x("gpubench.join", 0, 200),
        _x("tempo.dist.asof_join", 10, 180),
        _x("tempo.dist.asof_join.key_perm", 10, 40),
        _x("tempo.dist.asof_join.align", 50, 70),
        _x("aten::index_select", 60, 10, cat="cpu_op"),
        _x("tempo.dist.asof_join.merge", 120, 60),
        _x("tempo.kernel.asof_merge", 130, 10),
        _x("gpubench.stats", 200, 250),
        _x("tempo.dist.range_stats", 210, 230),
        _x("tempo.dist.range_stats.compute", 300, 130),
        _x("tempo.kernel.range_stats", 300, 10),
        _x("gpubench.chain", 500, 500),
        _x("tempo.dist.ema", 600, 100),
        _x("tempo.kernel.ema_ladder", 610, 5),
        _x("tempo.dist.asof_join", 0, 1000, tid=2),
        _x("k1", 135, 15, cat="kernel", tid=7),
        _x("k2", 160, 130, cat="kernel", tid=7),
        _x("k3", 320, 160, cat="kernel", tid=7),
        _x("Memcpy DtoD", 612, 38, cat="gpu_memcpy", tid=7),
        # waits: three inside program spans count
        _x("cudaStreamSynchronize", 65, 2, cat="cuda_runtime"),
        _x("cudaMemcpy", 315, 3, cat="cuda_runtime"),
        _x("cudaEventSynchronize", 650, 1, cat="cuda_runtime"),
        # not a wait, or outside any program span, or another thread
        _x("cudaLaunchKernel", 131, 1, cat="cuda_runtime"),
        _x("cudaMemcpyAsync", 320, 1, cat="cuda_runtime"),
        _x("cudaDeviceSynchronize", 195, 4, cat="cuda_runtime"),
        _x("cudaDeviceSynchronize", 490, 9, cat="cuda_runtime"),
        _x("cudaStreamSynchronize", 65, 2, cat="cuda_runtime", tid=2),
    ]
    return ev


def _ctx(events):
    return SimpleNamespace(events=events, w0=0.0, w1=1000.0, chains=2,
                           tid=1)


#: hand-computed: mesh union 180 + 230 + 100 = 510 us less the launches'
#: 10 + 10 + 5 = 25; idle under mesh spans 135 + 10 us; three waits
WANT = {
    "mesh_host_s.resident": (510 - 25) / 1e6 / 2,
    "mesh_idle_s.resident": (135 + 10) / 1e6 / 2,
    "launch_host_s.resident": 25 / 1e6 / 2,
    "host_waits.resident": 3 / 2,
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_hand_built_trace(metric):
    assert harness.reader(metric)(_ctx(_trace())) == pytest.approx(
        WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_program_spans_is_none(metric):
    """The parent's trace: the benchmark's spans and the card's records,
    nothing of the program's own."""
    events = [e for e in _trace() if not e["name"].startswith("tempo.")]
    assert harness.reader(metric)(_ctx(events)) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_cpu_trace(metric):
    """No card records and no runtime records: the host spans alone."""
    events = [e for e in _trace()
              if e["cat"] in ("user_annotation", "cpu_op")]
    got = harness.reader(metric)(_ctx(events))
    if metric in ("mesh_idle_s.resident", "host_waits.resident"):
        assert got is None
    else:
        assert got == pytest.approx(WANT[metric], rel=1e-12)


def test_innermost_ignores_other_categories_and_closed_spans():
    spans = ps.program_spans(_ctx(_trace()))
    assert [e["name"] for e in spans][:3] == [
        "tempo.dist.asof_join", "tempo.dist.asof_join.key_perm",
        "tempo.dist.asof_join.align"]
    got = ps.innermost(spans, [5, 65, 135, 185, 305, 650, 800])
    assert got == [None, "tempo.dist.asof_join.align",
                   "tempo.kernel.asof_merge", "tempo.dist.asof_join",
                   "tempo.kernel.range_stats", "tempo.dist.ema", None]


def test_interval_arithmetic():
    a = [(0.0, 10.0), (20.0, 30.0)]
    b = [(5.0, 25.0), (28.0, 40.0)]
    assert ps.length(a) == 20.0
    assert ps.overlap(a, b) == 5.0 + 5.0 + 2.0
    assert ps.union([_x("s", 5, 10), _x("t", 0, 8), _x("u", 40, 100)],
                    0.0, 50.0) == [(0.0, 15.0), (40.0, 50.0)]
    assert ps.idle_gaps(_trace(), 0.0, 1000.0) == [
        (0.0, 135.0), (150.0, 160.0), (290.0, 320.0), (480.0, 612.0),
        (650.0, 1000.0)]


def test_traced_cpu_run_reports_the_mesh_spans():
    """One traced run of the cell on the CPU: the mesh frame's host time
    is read from the program's spans; the CPU has no card records, no
    runtime records and no kernel launch (the kernels' plain versions
    run), so the other three readers give nothing, and none raises."""
    line = harness.run_cell(BENCH, CELL, SEED, 0.2, True, device="cpu",
                            scale=0.001)
    metrics = line["metrics"]
    assert metrics["mesh_host_s.resident"]["value"] > 0
    assert metrics["mesh_host_s.resident"]["unit"] == "s"
    for name in NEW[1:]:
        assert name not in metrics
    # the old per-layer spans still report beside the new ones
    assert "join_step_s.resident" in metrics
    assert "stats_step_s.resident" in metrics
    assert line["correct"] is True
