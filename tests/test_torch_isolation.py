"""Boundaries of the port: it imports neither JAX nor the JAX package,
its entry points default to the CUDA card and refuse to drop to the CPU
on their own, and engines whose TPU kernel has no CUDA port yet raise a
named error on the card instead of running plain PyTorch there."""

import ast
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu_torch
from tempo_tpu_torch import TSDF, device, interop, join
from tempo_tpu_torch.ops import (bucket, cuda_lib, merge, rolling, scan,
                                 sortmerge, window)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tempo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "tempo_tpu", "__graft_entry__", "bench",
             "bench_frame", "bench_baseline"}


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
        assert "Replaces the Pallas kernel tempo_tpu/ops/pallas_" in head, name
        assert "Bound on H100" in head, name
    assert set(cuda_lib.launches) == {"asof_merge", "range_stats",
                                      "ema_ladder", "last_valid_index",
                                      "first_valid_index", "last_valid_scan",
                                      "resample_ema"}


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
    ts = torch.arange(16, dtype=torch.int64).expand(2, 16).contiguous()
    merge.asof_merge_values(ts, ts, valid[None], x[None])
    scan.last_valid_index_scan(valid)
    scan.first_valid_index_scan(valid)
    scan.last_valid_scan(x, valid)
    bucket.resample_ema(secs, x, valid, 4, 0.2)
    assert all(n == 0 for n in cuda_lib.launches.values())


def _on_card():
    """A stand-in operand that reports lying on a CUDA device."""
    return types.SimpleNamespace(is_cuda=True)


def test_windowed_range_engine_raises_on_the_card():
    with pytest.raises(sortmerge.KernelNotPortedError, match="cumsum3"):
        rolling.windowed_stats(_on_card(), None, None, None)


def test_max_lookback_raises_on_the_card():
    with pytest.raises(sortmerge.KernelNotPortedError, match="chunked"):
        sortmerge.asof_indices_lookback(_on_card(), None, None, 3)
    left = _frame(device="cpu")
    left.device = torch.device("cuda")
    with pytest.raises(sortmerge.KernelNotPortedError, match="ROADMAP.md"):
        left.asofJoin(_frame(device="cpu"), maxLookback=3)


def test_chunked_join_engine_raises_on_the_card(monkeypatch):
    with pytest.raises(sortmerge.KernelNotPortedError, match="chunked"):
        join._check_engine("chunked", torch.device("cuda"))
    join._check_engine("chunked", torch.device("cpu"))   # plain form runs
    monkeypatch.setenv("TEMPO_TPU_JOIN_ENGINE", "chunked")
    left = _frame(device="cpu")
    left.device = torch.device("cuda")
    with pytest.raises(sortmerge.KernelNotPortedError):
        left.asofJoin(_frame(device="cpu"))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8, dtype=torch.float32)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        scan.ema_cuda(x, valid, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        window.range_stats_cuda(torch.zeros(2, 8, dtype=torch.int32), x[None],
                                valid[None], 3, 2, 0)
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


def test_package_exports_the_frame():
    assert tempo_tpu_torch.TSDF is TSDF
