"""The port's own spans on the CPU: a resident chain on a one-CPU mesh
(``asofJoin`` -> ``withRangeStats`` -> ``EMA(exact=True)`` ->
``collect``) under ``profiling.trace`` writes every mesh-frame span,
each phase inside its op's span on the chain's thread; with no profiler
active ``profiling.annotate`` is one shared no-op and constructs no
``record_function``; a kernel launch and a compile through
``ops/cuda_lib.py`` (a stub library and a stub ``nvcc`` here) are spans
of their own."""

import glob
import json
import os
import stat

import numpy as np
import pandas as pd
import pytest
import torch

from tempo_tpu_torch import TSDF, make_mesh, profiling
from tempo_tpu_torch.ops import cuda_lib

NS = 1_000_000_000

#: op span -> its phase spans, as the chain below crosses them
OPS = {
    "tempo.dist.asof_join": ("key_perm", "right_stacks", "align", "merge",
                             "outputs"),
    "tempo.dist.range_stats": ("engine", "stack", "compute", "outputs"),
    "tempo.dist.ema": (),
    "tempo.dist.collect": ("fetch", "assemble"),
}
SPANS = [op for op in OPS] + [f"{op}.{ph}" for op, phs in OPS.items()
                              for ph in phs]


def _frames(seed=11, n=300, m=200):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({
        "user": rng.choice(["a", "b", "c"], size=n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, size=n))
                                   * NS),
        "x": rng.standard_normal(n),
    })
    right = pd.DataFrame({
        "user": rng.choice(["a", "b", "d"], size=m),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, size=m))
                                   * NS),
        "w": np.where(rng.random(m) > 0.2, rng.standard_normal(m), np.nan),
        "venue": rng.choice(["p", "q"], size=m),     # host-resident col
    })
    mesh = make_mesh({"series": 1}, devices=["cpu"])
    return (TSDF(left, "event_ts", ["user"], device="cpu").on_mesh(mesh),
            TSDF(right, "event_ts", ["user"], device="cpu").on_mesh(mesh))


def _chain(left, right):
    return (left.asofJoin(right, right_prefix="r")
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=30)
            .EMA("x", exp_factor=0.2, exact=True)
            .collect().df)


def _events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _end(e):
    return float(e["ts"]) + float(e["dur"])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The chain's output without a profiler, its output traced, and the
    traced run's spans."""
    left, right = _frames()
    plain = _chain(left, right)
    log_dir = str(tmp_path_factory.mktemp("spans"))
    with profiling.trace(log_dir):
        with profiling.annotate("test.chain"):
            out = _chain(left, right)
    return plain, out, _events(log_dir)


def test_traced_chain_output_unchanged(traced):
    plain, out, _ = traced
    pd.testing.assert_frame_equal(plain, out)


@pytest.mark.parametrize("name", SPANS)
def test_chain_writes_span(traced, name):
    _, _, events = traced
    found = [e for e in events if e["name"] == name]
    assert len(found) == 1, name
    assert float(found[0]["dur"]) >= 0


@pytest.mark.parametrize("name", [s for s in SPANS if s not in OPS])
def test_phase_nests_in_its_op(traced, name):
    _, _, events = traced
    op = name.rsplit(".", 1)[0]
    (ph,) = [e for e in events if e["name"] == name]
    (outer,) = [e for e in events if e["name"] == op]
    assert ph["tid"] == outer["tid"]
    assert float(outer["ts"]) <= float(ph["ts"])
    assert _end(ph) <= _end(outer)


def test_op_spans_nest_in_the_chain_on_its_thread(traced):
    _, _, events = traced
    (chain,) = [e for e in events if e["name"] == "test.chain"]
    ops = [e for e in events if e["name"] in OPS]
    assert len(ops) == len(OPS)
    for e in ops:
        assert e["tid"] == chain["tid"]
        assert float(chain["ts"]) <= float(e["ts"])
        assert _end(e) <= _end(chain)
    # the ops run one after another, each closed before the next opens
    ops.sort(key=lambda e: float(e["ts"]))
    assert [e["name"] for e in ops] == list(OPS)
    for a, b in zip(ops, ops[1:]):
        assert _end(a) <= float(b["ts"])


def test_no_profiler_no_record_function(traced, monkeypatch):
    """Outside a profiler ``annotate`` hands back the one shared no-op
    and never reaches ``record_function`` (which here raises), and the
    chain's output is the same."""
    plain, _, _ = traced

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) constructed")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    assert profiling.annotate("a") is profiling._NO_SPAN
    left, right = _frames()
    pd.testing.assert_frame_equal(_chain(left, right), plain)


# ----------------------------------------------------------------------
# Kernel launches and builds (a stub library and a stub nvcc)
# ----------------------------------------------------------------------

class _StubLib:
    """Entry points that return the code they are built with."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def tempo_range_stats(self, *args):
        self.calls.append(args)
        return self.code

    def tempo_error_string(self, code):
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(cuda_lib, "_lib", lib)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda device: 7)
    monkeypatch.setitem(cuda_lib.launches, "range_stats",
                        cuda_lib.launches["range_stats"])
    return lib


def test_launch_is_a_kernel_span(stub, tmp_path):
    before = cuda_lib.launches["range_stats"]
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("test.launch"):
            # device -1 leaves the current CUDA device alone
            cuda_lib.launch("range_stats", -1, "tempo_range_stats", 1, 2)
    assert stub.calls == [(1, 2, 7)]
    assert cuda_lib.launches["range_stats"] == before + 1
    events = _events(str(tmp_path))
    (k,) = [e for e in events if e["name"] == "tempo.kernel.range_stats"]
    (outer,) = [e for e in events if e["name"] == "test.launch"]
    assert float(outer["ts"]) <= float(k["ts"]) and _end(k) <= _end(outer)


def test_failed_launch_closes_its_span(stub, tmp_path):
    stub.code = 3
    before = cuda_lib.launches["range_stats"]
    with profiling.trace(str(tmp_path)):
        with pytest.raises(RuntimeError, match="stub error"):
            cuda_lib.launch("range_stats", -1, "tempo_range_stats")
    assert cuda_lib.launches["range_stats"] == before
    names = [e["name"] for e in _events(str(tmp_path))]
    assert names.count("tempo.kernel.range_stats") == 1


def test_launch_without_profiler_is_counted(stub, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", None)
    before = cuda_lib.launches["range_stats"]
    cuda_lib.launch("range_stats", -1, "tempo_range_stats", 5)
    assert cuda_lib.launches["range_stats"] == before + 1


def test_build_span_only_around_a_compile(tmp_path, monkeypatch):
    """A compile (a stub ``nvcc`` that writes each ``-o`` file) is one
    ``tempo.kernel.build`` span; loading the library it left is none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "build"
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "build_dir", lambda: out)
    monkeypatch.setattr(cuda_lib, "builds", cuda_lib.builds)
    monkeypatch.setattr(cuda_lib, "build_log", [])
    before = cuda_lib.builds
    traces = tmp_path / "traces"
    with profiling.trace(str(traces / "compile")):
        first = cuda_lib.build()
    with profiling.trace(str(traces / "load")):
        second = cuda_lib.build()
    assert first == second and first.exists()
    assert cuda_lib.builds == before + 1
    compiled = [e["name"] for e in _events(str(traces / "compile"))]
    loaded = [e["name"] for e in _events(str(traces / "load"))]
    assert compiled.count("tempo.kernel.build") == 1
    assert "tempo.kernel.build" not in loaded
