"""The port's several-process layer (``tempo_tpu_torch/parallel/multihost.py``)
against the reference's (``tempo_tpu/parallel/multihost.py``), and one
real two-rank run.

* The routing rule on synthetic device->process grids (the reference's
  ``tests/test_multihost.py`` cases): the same ranges and errors.
* ``distributed_init``'s timeout cases, with ``init_process_group``
  replaced, and one real wait on a coordinator nobody serves
  (``localhost``).
* Two OS processes (this file run as a script, a timeout of their own)
  join a gloo group, route and place their series
  (``process_series_range``, ``shard_series_global``), run chains on a
  ``series: 2`` mesh and on a ``time: 2`` mesh spread over both ranks
  and collect on each rank: bitwise the frames one process computes on
  ``["cpu"] * 2``, and round-trip a sharded checkpoint both ranks write
  (``shard_p0`` / ``shard_p1``) and load, bitwise.
"""

import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from tempo_tpu_torch import TSDF, checkpoint, make_mesh
from tempo_tpu_torch.parallel import multihost as mh
from tempo_tpu_torch.parallel import (distributed_init, process_mesh,
                                      process_series_range,
                                      shard_series_global)
from tempo_tpu_torch.resilience import FailureKind, classify

NS = 1_000_000_000
RANK_TIMEOUT_S = 120


def _frames(seed=7, n=240):
    rng = np.random.default_rng(seed)
    keys = np.repeat(["p1", "p2", "p3", "p4"], n // 4)
    secs = np.concatenate([np.cumsum(rng.integers(1, 3, size=n // 4))
                           for _ in range(4)])
    left = pd.DataFrame({"id": keys, "event_ts": pd.to_datetime(secs * NS),
                         "x": rng.standard_normal(n)})
    right = pd.DataFrame({
        "id": keys,
        "event_ts": pd.to_datetime((secs - rng.integers(0, 2, size=n)) * NS),
        "v": np.where(rng.random(n) > 0.2, rng.standard_normal(n), np.nan)})
    return left, right


def _chains(mesh_s, mesh_t):
    """The frames both runs collect: a series-axis chain and a time-axis
    chain (halo statistics, the EMA carry, the all-to-all join and
    layout switches), on the given meshes."""
    left, right = _frames()
    lt = TSDF(left, "event_ts", ["id"], device="cpu")
    rt = TSDF(right, "event_ts", ["id"], device="cpu")
    out = {}
    d = (lt.on_mesh(mesh_s).asofJoin(rt.on_mesh(mesh_s))
         .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=8)
         .EMA("x", exact=True))
    out["series"] = d.withGroupedStats(metricCols=["x", "right_v", "EMA_x"],
                                       freq="1 minute").collect().df
    out["series_chain"] = d.collect().df
    out["count"] = pd.DataFrame({"n": [d.count()]})
    out["describe"] = d.describe()
    out["autocorr"] = d.autocorr("x", 2)
    out["interpolate"] = d.resample("30 seconds", "mean").interpolate(
        method="linear").collect().df
    out["fourier"] = lt.on_mesh(mesh_s).fourier_transform(1, "x").collect().df
    t = (lt.on_mesh(mesh_t, time_axis="time", halo_fraction=0.5)
         .asofJoin(rt.on_mesh(mesh_t, time_axis="time"))
         .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=8,
                         strategy="halo")
         .EMA("x", exact=True))
    out["time"] = t.collect().df
    out["time_resample"] = t.resample("1 minute", "mean").interpolate(
        method="linear").collect().df
    out["time_audit"] = pd.DataFrame({"n": [t.audit_counts()[-1][1]]})
    return out


def _worker(rank: int, port: int, out_dir: str) -> None:
    distributed_init(f"localhost:{port}", 2, rank, timeout_s=60,
                     backend="gloo")
    mesh_s = process_mesh({"series": 2}, devices=["cpu"])
    mesh_t = process_mesh({"series": 1, "time": 2}, devices=["cpu"])
    assert mesh_s.axis_ranks("series") == [0, 1]
    # ingest routing: this rank's series, placed on its device only
    left, _ = _frames()
    lay = TSDF(left, "event_ts", ["id"], device="cpu").layout
    K = lay.n_series
    plane = np.arange(K * 6, dtype=np.float64).reshape(K, 6)
    lo, hi = process_series_range(K, mesh_s)
    assert (lo, hi) == (rank * K // 2, (rank + 1) * K // 2)
    shards = shard_series_global(plane[lo:hi], mesh_s, K)
    assert shards[rank].device.type == "cpu"
    assert shards[1 - rank].device.type == "meta"
    assert torch.equal(shards[rank], torch.from_numpy(plane[lo:hi]))
    out = _chains(mesh_s, mesh_t)
    for name, df in out.items():
        df.to_pickle(os.path.join(out_dir, f"{name}_rank{rank}.pkl"))
    # the dense lookback tensor lands on rank 0's first device
    vals, mask = TSDF(left, "event_ts", ["id"], device="cpu").on_mesh(
        mesh_t, time_axis="time").lookback_tensor(["x"], 3)
    if rank == 0:
        np.save(os.path.join(out_dir, "lookback.npy"), vals.numpy())
    else:
        assert vals.device.type == "meta" and mask.device.type == "meta"
    frame = TSDF(left, "event_ts", ["id"], device="cpu").on_mesh(mesh_s)
    ck = os.path.join(out_dir, "ck")
    checkpoint.save(frame, ck, sharded=True)
    assert os.path.exists(os.path.join(ck, f"shard_p{rank}.npz"))
    back = checkpoint.load(ck, mesh=mesh_s)
    assert back.ts[1 - rank].device.type == "meta"
    pd.testing.assert_frame_equal(back.collect().df, frame.collect().df,
                                  check_exact=True)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_collect_one_process_frames(tmp_path):
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r),
         str(port), str(tmp_path)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} OK" in out, out[-3000:]
    want = _chains(make_mesh({"series": 2}, devices=["cpu"] * 2),
                   make_mesh({"series": 1, "time": 2}, devices=["cpu"] * 2))
    for name, df in want.items():
        for r in range(2):
            got = pd.read_pickle(tmp_path / f"{name}_rank{r}.pkl")
            pd.testing.assert_frame_equal(got, df, check_exact=True,
                                          obj=f"{name} rank {r}")
    left, _ = _frames()
    vals, _ = TSDF(left, "event_ts", ["id"], device="cpu").on_mesh(
        make_mesh({"series": 1, "time": 2}, devices=["cpu"] * 2),
        time_axis="time").lookback_tensor(["x"], 3)
    np.testing.assert_array_equal(np.load(tmp_path / "lookback.npy"),
                                  vals.numpy())


# ----------------------------------------------------------------------
# Routing on synthetic process grids, against the reference
# ----------------------------------------------------------------------

GRIDS = [
    (np.zeros((4, 2), np.int64), 16),
    (np.array([[0, 0], [0, 0], [1, 1], [1, 1]]), 16),
    (np.array([[0, 1], [1, 1]]), 8),
    (np.array([[0, 0], [0, 0]]), 8),
    (np.array([[0], [1], [0]]), 9),
    (np.zeros((4, 1), np.int64), 10),
    (np.array([[0], [1], [2], [3]]), 12),
]


@pytest.mark.parametrize("grid,n", GRIDS, ids=range(len(GRIDS)))
@pytest.mark.parametrize("proc", [0, 1, 3])
def test_routing_rule_is_the_reference_one(grid, n, proc):
    from tempo_tpu.parallel import multihost as ref_mh

    def run(fn):
        try:
            return fn(proc, grid, n)
        except ValueError as e:
            return ("error", str(e).split(";")[0])

    assert run(mh.series_range_for_process) == \
        run(ref_mh.series_range_for_process)


def test_mesh_ranks_route_ingest():
    mesh = make_mesh({"series": 4, "time": 2}, devices=["cpu"] * 8,
                     ranks=[0, 0, 0, 0, 1, 1, 1, 1])
    grid = mh.mesh_shard_process_ids(mesh)
    np.testing.assert_array_equal(grid, [[0, 0], [0, 0], [1, 1], [1, 1]])
    assert mh.series_range_for_process(1, grid, 16) == (8, 16)
    assert mesh.n_processes == 2 and "ranks" in repr(mesh)
    assert mesh != make_mesh({"series": 4, "time": 2}, devices=["cpu"] * 8)
    one = make_mesh({"series": 4}, devices=["cpu"] * 4)
    assert process_series_range(64, one) == (0, 64)
    with pytest.raises(ValueError, match="divisible"):
        process_series_range(63, one)


def test_shard_series_global_in_one_process():
    mesh = make_mesh({"series": 4}, devices=["cpu"] * 4)
    arr = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    out = shard_series_global(arr, mesh, 16)
    assert len(out) == 4
    np.testing.assert_array_equal(torch.cat(out).numpy(), arr)
    with pytest.raises(ValueError, match="expects all"):
        shard_series_global(arr[:8], mesh, 16)
    assert process_mesh({"series": 2}, devices=["cpu", "cpu"]) == \
        make_mesh({"series": 2}, devices=["cpu"] * 2)


# ----------------------------------------------------------------------
# distributed_init
# ----------------------------------------------------------------------

class TestDistributedInitTimeout:
    @pytest.fixture(autouse=True)
    def _not_initialized(self, monkeypatch):
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: False)

    def test_noop_for_one_process(self, monkeypatch):
        called = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **k: called.append(k))
        distributed_init()
        distributed_init(num_processes=1)
        assert not called

    def test_timeout_and_backend_plumbed(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **k: seen.update(k))
        distributed_init("10.0.0.1:1234", num_processes=2, process_id=0,
                         timeout_s=7)
        assert seen["timeout"] == datetime.timedelta(seconds=7)
        assert seen["init_method"] == "tcp://10.0.0.1:1234"
        assert (seen["world_size"], seen["rank"]) == (2, 0)
        assert seen["backend"] == ("nccl" if torch.cuda.is_available()
                                   else "gloo")
        distributed_init("h:1", num_processes=2, process_id=1,
                         backend="gloo")
        assert seen["backend"] == "gloo" and seen["rank"] == 1

    def test_watchdog_times_out_hung_initializer(self, monkeypatch):
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **k: time.sleep(30))
        t0 = time.perf_counter()
        with pytest.raises(mh.DistributedInitTimeout) as ei:
            distributed_init("10.0.0.9:555", num_processes=2, process_id=1,
                             timeout_s=0.2)
        assert time.perf_counter() - t0 < 5
        msg = str(ei.value)
        assert "10.0.0.9:555" in msg and "num_processes=2" in msg
        assert "process_id=1" in msg

    def test_deadline_shaped_error_becomes_diagnostic(self, monkeypatch):
        def failing(**k):
            raise RuntimeError("DEADLINE_EXCEEDED: barrier timed out")

        monkeypatch.setattr(torch.distributed, "init_process_group",
                            failing)
        with pytest.raises(mh.DistributedInitTimeout, match="coordinator"):
            distributed_init("h:1", num_processes=2, process_id=0,
                             timeout_s=5)

    def test_double_init_still_tolerated(self, monkeypatch):
        def twice(**k):
            raise RuntimeError("trying to initialize the default process "
                               "group twice!")

        monkeypatch.setattr(torch.distributed, "init_process_group", twice)
        distributed_init("h:1", num_processes=2, process_id=0)

    def test_other_errors_propagate(self, monkeypatch):
        def bad(**k):
            raise RuntimeError("invalid coordinator address")

        monkeypatch.setattr(torch.distributed, "init_process_group", bad)
        with pytest.raises(RuntimeError, match="invalid coordinator"):
            distributed_init("h:1", num_processes=2, process_id=0)

    def test_classified_as_deadline(self):
        assert classify(mh.DistributedInitTimeout("x")) is \
            FailureKind.DEADLINE
        assert mh.DistributedInitTimeout.failure_kind is FailureKind.DEADLINE


def test_a_coordinator_nobody_serves_times_out():
    """Rank 1 of 2 waiting on a localhost port where no rank 0 listens:
    a DistributedInitTimeout within the bound, not a hang."""
    t0 = time.perf_counter()
    with pytest.raises(mh.DistributedInitTimeout, match="process_id=1"):
        distributed_init(f"localhost:{_free_port()}", num_processes=2,
                         process_id=1, timeout_s=1.0, backend="gloo")
    assert time.perf_counter() - t0 < 10
    assert not torch.distributed.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
