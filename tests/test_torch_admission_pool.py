"""Admission counts the device bytes of a plan's CUDA graphs
(``service/admission.py``: ``graph_bytes``), on the CPU.

The reference's model (sources plus the two widest op results) leaves
out what a captured graph keeps beside the frames: its private pool and
the clones of its static inputs.  Here a fused mesh chain's projection
is the model plus that term: the cached graph's ``Captured.nbytes`` when
the planner's cache holds one (a stub here: nothing captures on the
CPU), else the estimate from the node's packed geometry.  A budget
between the model and the new projection rejects the query.  On the CPU
nothing is captured, so the term is zero and the reference's model
tests (``tests/test_torch_service.py``) stand as they are.
"""

import numpy as np
import pandas as pd
import pytest

from tempo_tpu_torch import TSDF, make_mesh, packing
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import executor, optimizer
from tempo_tpu_torch.service import (AdmissionController, AdmissionError,
                                     QueryService, admission, lazy_frame,
                                     project_footprint)

K, ROWS = 4, 60


@pytest.fixture(autouse=True)
def _clean_cache():
    plan_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()


def _frame(col, seed):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, ROWS)), axis=-1)
    return TSDF(pd.DataFrame({
        "sym": np.repeat(np.arange(K), ROWS),
        "event_ts": secs.ravel().astype(np.int64),
        col: rng.standard_normal(K * ROWS)}), "event_ts", ["sym"],
        device="cpu")


def _mesh():
    return make_mesh({"series": 2}, devices=["cpu"] * 2)


def _fused_query(mesh=None):
    mesh = mesh or _mesh()
    return (lazy_frame(_frame("x", 1)).on_mesh(mesh)
            .asofJoin(lazy_frame(_frame("v", 2)).on_mesh(mesh))
            .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
            .EMA("x", exact=True))


def _stitched_query():
    return (lazy_frame(_frame("x", 1)).on_mesh(_mesh())
            .resample("1 second", "mean")
            .interpolate(method="linear")
            .EMA("x", exact=True))


class _StubCaptured:
    """What the planner keeps for a captured graph, as far as admission
    reads it."""

    graph = object()
    pool_bytes = 0

    def __init__(self, nbytes):
        self._nbytes = nbytes

    def nbytes(self):
        return self._nbytes

    def free(self):
        pass


def _capture_everywhere(monkeypatch):
    """Treat the CPU mesh as a card's: every graph node would capture."""
    monkeypatch.setattr(admission, "captures",
                        lambda n: n.op in admission.GRAPH_OPS)


def _graph_nodes(root):
    plan = optimizer._stitch_chains(
        optimizer._fuse_mesh_chain(optimizer._copy(root)))
    return [n for n in plan.walk() if n.op in admission.GRAPH_OPS]


def test_cpu_plan_captures_nothing_and_keeps_the_model():
    root = _fused_query().plan
    (node,) = _graph_nodes(root)
    assert node.op == "fused_asof_stats_ema"
    assert not admission.captures(node)
    assert admission.graph_bytes(root) == 0


def test_cached_graph_adds_its_nbytes(monkeypatch):
    root = _fused_query().plan
    model = project_footprint(root).hbm_bytes
    exe = executor.Executable(optimizer.optimize(root))
    (node,) = [n for n in exe.plan.walk()
               if n.op == "fused_asof_stats_ema"]
    node.objs["_graphs"] = {"cuda:0": _StubCaptured(123_457)}
    plan_cache.CACHE.insert(executor.cache_key(root), exe)
    before = plan_cache.CACHE.stats()
    assert project_footprint(root).hbm_bytes == model + 123_457
    # the cached graph wins over the estimate, and reading it counts
    # neither a hit nor a miss
    _capture_everywhere(monkeypatch)
    assert project_footprint(root).hbm_bytes == model + 123_457
    after = plan_cache.CACHE.stats()
    assert (after["hits"], after["misses"]) == (before["hits"],
                                                before["misses"])


def test_uncached_fused_node_adds_the_geometric_estimate(monkeypatch):
    root = _fused_query().plan
    model = project_footprint(root).hbm_bytes
    _capture_everywhere(monkeypatch)
    L = packing.pad_length(ROWS)
    K_dev = K                     # 4 series over 2 shards
    # one left and one right value column, stats over x, the EMA of x:
    # inputs 8 + 1 + 8 + 5 * 1 + 5 * (1 + 3) (keys, mask, left column,
    # right stacks); outputs 5 * (1 + 3) + 4 * 1 + 4 * 7 * 1 + 4 (joined
    # planes and validity, masked right, stats, EMA); intermediates
    # 8 + 3 * 8 + 4 + (6 + 4) * 1 + 4 (row index, seconds, int32
    # seconds, stats stacks and clipped plane, the EMA's decay plane)
    per_lane = (8 + 1 + 8 + 5 + 20) + (20 + 4 + 28 + 4) \
        + (8 + 24 + 4 + 10 + 4)
    assert per_lane == 148
    (node,) = _graph_nodes(root)
    assert admission.fused_graph_estimate(node) == K_dev * L * per_lane
    assert project_footprint(root).hbm_bytes == model + K_dev * L * 148


def test_uncached_stitched_node_adds_its_stages(monkeypatch):
    root = _stitched_query().plan
    model = project_footprint(root).hbm_bytes
    _capture_everywhere(monkeypatch)
    (node,) = _graph_nodes(root)
    assert node.op == "stitched" and node.param("n_ops") == 3
    want = admission._node_hbm_bytes(node.inputs[0])
    cur = node.inputs[0]
    for op, params in node.param("stages"):
        from tempo_tpu_torch.plan import ir

        cur = ir.Node(op, params=dict(params), inputs=(cur,))
        want += admission._node_hbm_bytes(cur)
    assert want > admission._node_hbm_bytes(node.inputs[0])
    assert admission.stitched_graph_estimate(node) == want
    assert project_footprint(root).hbm_bytes == model + want


@pytest.mark.parametrize("path", ["controller", "service"])
def test_budget_between_model_and_projection_rejects(monkeypatch, path):
    root = _fused_query().plan
    model = project_footprint(root).hbm_bytes
    _capture_everywhere(monkeypatch)
    fp = project_footprint(root)
    assert fp.hbm_bytes > model
    budget = (model + fp.hbm_bytes) // 2
    if path == "controller":
        AdmissionController(hbm_budget=model).check(
            admission.Footprint(model, fp.vmem_bytes))
        with pytest.raises(AdmissionError, match="TOTAL"):
            AdmissionController(hbm_budget=budget).check(fp)
        return
    with QueryService(workers=1, hbm_budget=budget) as svc:
        with pytest.raises(AdmissionError, match="TOTAL"):
            svc.submit("t0", root)
        assert svc.stats()["tenants"]["t0"]["rejected"] == 1
