"""Boundaries of the port: it imports neither JAX nor the JAX package,
its entry points default to the CUDA card and refuse to drop to the CPU
on their own, and a CUDA operand reaches the CUDA kernel wrapper (never
a plain version), on every engine, the legacy range-stats engine
included."""

import ast
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu_torch
from tempo_tpu_torch import TSDF, device, interop
from tempo_tpu_torch.ops import asof as asof_ops
from tempo_tpu_torch.ops import (bucket, cuda_lib, merge, rolling, scan,
                                 sortmerge, stats, window, window_utils)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tempo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "tempo_tpu", "__graft_entry__", "bench",
             "bench_frame", "bench_baseline", "tools"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_sources_are_in_the_package_and_name_their_pallas_kernel():
    for name in cuda_lib.SOURCES:
        text = (cuda_lib.CSRC / name).read_text()
        head = text[:2000]
        # ema_scan.cu ports a lax.scan, which no Pallas kernel computes
        pallas = ("Replaces no Pallas kernel: tempo_tpu/ops/"
                  if name == "ema_scan.cu"
                  else "Replaces the Pallas kernel tempo_tpu/ops/pallas_")
        assert pallas in head, name
        assert "Bound on H100" in head, name
    assert set(cuda_lib.launches) == {"asof_merge", "range_stats",
                                      "ema_ladder", "last_valid_index",
                                      "first_valid_index", "last_valid_scan",
                                      "resample_ema", "asof_merge_lookback",
                                      "merge_rank", "cumsum3",
                                      "legacy_stats", "bucket_stats",
                                      "bucket_stats_ring", "range_stats_ring",
                                      "resample_ema_ring", "ema_scan"}


WRAPPER_MODULES = ("merge", "window", "stats", "scan", "bucket")


def _calls(fn: ast.FunctionDef):
    """Dotted names of the calls in a function body (``a.b`` / ``f``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                yield f"{f.value.id}.{f.attr}"
            elif isinstance(f, ast.Name):
                yield f.id


@pytest.mark.parametrize("module", WRAPPER_MODULES)
def test_every_cuda_wrapper_launches_under_the_device_guard(module):
    """Each ``*_cuda`` wrapper of the kernel modules launches through
    ``cuda_lib.launch`` (directly or through a helper that does), which
    makes the operands' device the current CUDA device: a launch onto a
    stream of another device than the current one fails.  Nothing else
    calls into the library or fetches a stream."""
    path = ROOT / "tempo_tpu_torch" / "ops" / f"{module}.py"
    tree = ast.parse(path.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    launching = {name for name, fn in fns.items()
                 if "cuda_lib.launch" in set(_calls(fn))}
    wrappers = [name for name in fns if name.endswith("_cuda")]
    assert wrappers, module
    for name in wrappers:
        calls = set(_calls(fns[name]))
        assert name in launching or calls & launching, name
    text = path.read_text()
    assert "stream_handle" not in text and "lib()." not in text, module


def _frame(**kw):
    df = pd.DataFrame({"sym": ["a", "a"],
                       "event_ts": pd.to_datetime([1, 2], unit="s"),
                       "x": [1.0, 2.0]})
    return TSDF(df, "event_ts", ["sym"], **kw)


@pytest.mark.parametrize("make", [
    lambda: _frame(),
    lambda: interop.from_reference_arrays(np.zeros(3)),
    lambda: device.resolve(None),
])
def test_default_device_is_cuda_and_raises_without_it(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_compute_dtype_policy_and_override():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert device.compute_dtype(cpu) == torch.float64
    assert device.compute_dtype(cuda) == torch.float32
    assert device.compute_dtype(cpu, "float32") == torch.float32
    assert device.compute_dtype(cuda, torch.float64) == torch.float64
    with pytest.raises(ValueError):
        device.compute_dtype(cpu, "int8")


def test_cpu_tensors_run_the_plain_versions_without_launching():
    cuda_lib.reset_launches()
    x = torch.randn(2, 16, dtype=torch.float64)
    valid = torch.ones(2, 16, dtype=torch.bool)
    scan.ema(x, valid, 0.2)
    secs = torch.arange(16, dtype=torch.int32).expand(2, 16).contiguous()
    window.range_stats(secs, x, valid, 3, 4, 0)
    stats.legacy_stats(secs, x, valid, 3, 4, 1)
    ts = torch.arange(16, dtype=torch.int64).expand(2, 16).contiguous()
    merge.asof_merge_values(ts, ts, valid[None], x[None])
    scan.last_valid_index_scan(valid)
    scan.first_valid_index_scan(valid)
    scan.last_valid_scan(x, valid)
    bucket.resample_ema(secs, x, valid, 4, 0.2)
    merge.asof_merge_lookback(ts, ts, valid[None], 3, x[None])
    window_utils.merge_rank(ts, ts)
    window_utils.searchsorted_batched(secs, secs, side="right")
    scan.cumsum3(x, valid)
    rolling.bucket_stats_multi(secs // 4, x[None], valid[None])
    start, end = rolling.range_window_bounds(secs, 3)
    rolling.windowed_stats(x, valid, start, end, max_window=4)
    assert all(n == 0 for n in cuda_lib.launches.values())


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports lying on a CUDA device, so dispatchers
    take their CUDA branch; the wrappers it reaches are spies here."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_CardTensor)


def _spy(monkeypatch, module, name, plain):
    """Replace ``module.name`` (a CUDA wrapper) by a recorder that runs
    the plain version; returns the list of recorded calls."""
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return plain(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _plain(t):
    return t.as_subclass(torch.Tensor)


def _join_case():
    ts = torch.tensor([[1, 2, 2, 5, 9, 12, 13, 20]], dtype=torch.int64)
    rts = torch.tensor([[0, 2, 3, 4, 8, 9, 14, 30]], dtype=torch.int64)
    valid = torch.tensor([[[True, False, True, True, False, True, True,
                            True]]])
    return ts, rts, valid


def _frames():
    """A two-series frame pair on the CPU (float64)."""
    left = pd.DataFrame({"sym": ["a"] * 5 + ["b"] * 4,
                         "event_ts": pd.to_datetime(
                             [1, 2, 4, 8, 9, 1, 3, 5, 7], unit="s"),
                         "x": np.arange(9.0)})
    right = pd.DataFrame({"sym": ["a"] * 4 + ["b"] * 3,
                          "event_ts": pd.to_datetime([0, 2, 3, 7, 2, 4, 6],
                                                     unit="s"),
                          "v": [1.0, np.nan, 3.0, 4.0, 5.0, np.nan, 7.0]})
    return (TSDF(left, "event_ts", ["sym"], device="cpu"),
            TSDF(right, "event_ts", ["sym"], device="cpu"))


def test_windowed_range_engine_raises_on_the_card(monkeypatch):
    """The windowed range engine on a CUDA operand launches the rank
    kernel (twice, for the window bounds) and the cumsum3 kernel; it
    raised there before those kernels were ported."""
    ranks = _spy(monkeypatch, merge, "merge_rank_cuda",
                 merge.merge_rank_plain)
    sums = _spy(monkeypatch, scan, "cumsum3_cuda", scan.cumsum3_plain)
    secs = torch.tensor([[0, 1, 1, 3, 6, 7, 7, 9]], dtype=torch.int32)
    x = torch.tensor([[0.5, -1.0, 2.0, 4.0, 0.0, 1.5, -2.0, 3.0]],
                     dtype=torch.float64)
    valid = torch.tensor([[True, True, False, True, True, True, True,
                           False]])
    start, end = rolling.range_window_bounds(_card(secs), 3)
    got = rolling.windowed_stats(_card(x), _card(valid), start, end,
                                 max_window=4)
    assert [c[0][2] for c in ranks] == ["left", "right"]
    assert len(sums) == 1 and sums[0][0][0].is_cuda
    ws, we = rolling.range_window_bounds(secs, 3)
    assert torch.equal(_plain(start), ws) and torch.equal(_plain(end), we)
    want = rolling.windowed_stats(x, valid, ws, we)
    for k, v in want.items():
        torch.testing.assert_close(_plain(got[k]), v, equal_nan=True,
                                   rtol=0, atol=0, msg=k)


def test_max_lookback_raises_on_the_card(monkeypatch):
    """``maxLookback`` on a CUDA operand launches the lookback kernel
    (it raised there before the kernel was ported); on the CPU the frame
    join runs its plain version with the cap as given."""
    calls = _spy(monkeypatch, merge, "asof_merge_lookback_cuda",
                 merge.asof_merge_lookback_plain)
    ts, rts, valid = _join_case()
    got = sortmerge.asof_indices_lookback(_card(ts), _card(rts),
                                          _card(valid), 3)
    assert len(calls) == 1 and calls[0][0][3] == 3
    want = sortmerge.asof_indices_lookback(ts, rts, valid, 3)
    for g, w in zip(got, want):
        assert torch.equal(_plain(g), w)
    plain = _spy(monkeypatch, merge, "asof_merge_lookback_plain",
                 merge.asof_merge_lookback_plain)
    left, right = _frames()
    left.asofJoin(right, maxLookback=3)
    assert plain and all(c[0][3] == 3 for c in plain)


def test_chunked_join_engine_raises_on_the_card(monkeypatch):
    """The ``chunked`` join engine takes the lookback kernel whatever
    ``maxLookback`` is (0 here), as the reference's chunked engine runs
    its one kernel; it raised on the card before that kernel was
    ported."""
    calls = _spy(monkeypatch, merge, "asof_merge_lookback_cuda",
                 merge.asof_merge_lookback_plain)
    ts, rts, valid = _join_case()
    asof_ops.asof_indices_merge(_card(ts), None, _card(rts), None,
                                _card(valid), 1, engine="chunked")
    assert len(calls) == 1 and calls[0][0][3] == 0
    plain = _spy(monkeypatch, merge, "asof_merge_lookback_plain",
                 merge.asof_merge_lookback_plain)
    left, right = _frames()
    want = left.asofJoin(right).df
    assert not plain
    monkeypatch.setenv("TEMPO_TPU_JOIN_ENGINE", "chunked")
    got = left.asofJoin(right).df
    assert plain and all(c[0][3] == 0 for c in plain)
    pd.testing.assert_frame_equal(got, want)


def test_legacy_window_engine_raises_on_the_card(monkeypatch):
    """``TEMPO_TPU_WINDOW_ENGINE=legacy`` on a CUDA operand launches the
    legacy stats kernel (it raised there before that kernel was ported),
    within the reference's shifted row budget; past it the row-bounded
    kernel runs, as the reference's stream engine does.  On the CPU the
    frame runs the legacy kernel's plain version."""
    monkeypatch.setenv("TEMPO_TPU_WINDOW_ENGINE", "legacy")
    assert rolling.pick_range_engine(64, 4, 0) == "legacy"
    assert rolling.pick_range_engine(64, rolling.SHIFTED_MAX_ROWS, 1) \
        == "shifted"
    assert rolling.pick_range_engine(64, rolling.stream_max_rows() + 1,
                                     0) == "windowed"
    calls = _spy(monkeypatch, stats, "legacy_stats_cuda",
                 stats.legacy_stats_plain)
    secs = torch.tensor([[0, 1, 1, 3, 6, 7, 7, 9]], dtype=torch.int32)
    x = torch.tensor([[0.5, -1.0, 2.0, 4.0, 0.0, 1.5, -2.0, 3.0]],
                     dtype=torch.float64)
    valid = torch.tensor([[True, True, False, True, True, True, True,
                           False]])
    got = rolling.legacy_range_stats(_card(secs), _card(x), _card(valid), 3,
                                     4, 1)
    assert len(calls) == 1 and calls[0][0][0].is_cuda
    want = stats.legacy_stats_plain(secs, x[None], valid[None], 3, 4, 1)
    for k, v in want.items():
        torch.testing.assert_close(_plain(got[k]), v[0], equal_nan=True,
                                   rtol=0, atol=0, msg=k)
    plain = _spy(monkeypatch, stats, "legacy_stats_plain",
                 stats.legacy_stats_plain)
    left, _ = _frames()
    left.withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=3)
    assert len(plain) == 1 and len(calls) == 1


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8, dtype=torch.float32)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        scan.ema_cuda(x, valid, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        window.range_stats_cuda(torch.zeros(2, 8, dtype=torch.int32), x[None],
                                valid[None], 3, 2, 0)
    with pytest.raises(ValueError, match="CUDA"):
        stats.legacy_stats_cuda(torch.zeros(2, 8, dtype=torch.int32),
                                x[None], valid[None], 3, 2, 0)
    ts = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        merge.asof_merge_cuda(ts, ts, valid[None], x[None])
    for scan_cuda in (scan.last_valid_index_scan_cuda,
                      scan.first_valid_index_scan_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            scan_cuda(valid)
    with pytest.raises(ValueError, match="CUDA"):
        scan.last_valid_scan_cuda(x, valid)
    with pytest.raises(ValueError, match="CUDA"):
        bucket.resample_ema_cuda(torch.zeros(2, 8, dtype=torch.int32), x,
                                 valid, 60, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        merge.asof_merge_lookback_cuda(ts, ts, valid[None], 3, x[None])
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_rank_cuda(ts, ts)
    with pytest.raises(ValueError, match="CUDA"):
        scan.cumsum3_cuda(x, valid)
    with pytest.raises(ValueError, match="CUDA"):
        bucket.bucket_stats_cuda(torch.zeros(2, 8, dtype=torch.int32),
                                 x[None], valid[None])


def test_package_exports_the_frame():
    assert tempo_tpu_torch.TSDF is TSDF
