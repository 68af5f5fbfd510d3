"""Checkpoints and resume across processes (the port's
``checkpoint.save(sharded=True)`` / ``load`` and
``resilience.run_resumable(sharded=True)`` over ``torch.distributed``),
against one process and against the reference.

Two OS processes (this file run as a script, each with a timeout of its
own, as ``tests/test_torch_multihost.py``) join a gloo group on a
``series: 2`` mesh, one CPU shard a rank, and:

* write one sharded checkpoint together (``shard_p0`` / ``shard_p1``,
  process 0's manifest with ``n_processes: 2``) and load it back, each
  rank holding its own shard and a ``meta`` placeholder for the other;
* load a sharded checkpoint ``tempo_tpu`` wrote in one process;
* run a three-step ``run_resumable(sharded=True)`` pipeline killed
  while both ranks save step 2 (``testing.faults``), then resumed from
  step 1.

The parent then checks, bitwise: the two-process checkpoint loads in
one process of ``tempo_tpu`` and of the port as the frame that was
saved; each rank's collect of the reference's checkpoint is the
one-process load of it; the resumed pipeline is the uninterrupted
one-process run.  In one process the same calls keep the reference's
refusals: a dense save of a mesh frame over several processes refuses
by name before anything is on disk.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu import checkpoint as ref_ckpt
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu_torch import TSDF, checkpoint, make_mesh, resilience

NS = 1_000_000_000
RANK_TIMEOUT_S = 120

STEPS = [("withRangeStats", {"colsToSummarize": ["x"],
                             "rangeBackWindowSecs": 8}),
         ("EMA", {"colName": "x", "exact": True}),
         ("resample", {"freq": "30 seconds", "func": "mean"})]


def _df(seed=5, n=240):
    rng = np.random.default_rng(seed)
    keys = np.repeat(["p1", "p2", "p3", "p4"], n // 4)
    secs = np.concatenate([np.cumsum(rng.integers(1, 3, size=n // 4))
                           for _ in range(4)])
    x = rng.standard_normal(n)
    x[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({"id": keys, "event_ts": pd.to_datetime(secs * NS),
                         "x": x, "y": rng.standard_normal(n)})


def _port_frame(mesh):
    return TSDF(_df(), "event_ts", ["id"], device="cpu").on_mesh(mesh)


def _worker(rank: int, port: int, out_dir: str) -> None:
    import torch

    from tempo_tpu_torch.parallel import distributed_init, process_mesh
    from tempo_tpu_torch.testing import faults

    distributed_init(f"localhost:{port}", 2, rank, timeout_s=60,
                     backend="gloo")
    mesh = process_mesh({"series": 2}, devices=["cpu"])
    frame = _port_frame(mesh)
    # one checkpoint written by both ranks, loaded by both
    ck = os.path.join(out_dir, "ck2p")
    checkpoint.save(frame, ck, sharded=True)
    back = checkpoint.load(ck, mesh=mesh)
    assert back.ts[1 - rank].device.type == "meta"
    back.collect().df.to_pickle(os.path.join(out_dir, f"back{rank}.pkl"))
    # the reference's one-process sharded checkpoint over two ranks
    ref = checkpoint.load(os.path.join(out_dir, "ref_ck"), mesh=mesh)
    ref.collect().df.to_pickle(os.path.join(out_dir, f"ref{rank}.pkl"))
    # a pipeline killed while both ranks write step 2, then resumed
    rd = os.path.join(out_dir, "resume")
    with faults.FaultInjector() as fi:
        # rank 0 writes its shard file and host_arrays.npz a step
        fi.kill_on_call(np, "savez", call_no=3 if rank == 0 else 2)
        try:
            resilience.run_resumable(frame, STEPS, rd, sharded=True)
        except faults.SimulatedKill:
            pass
        else:
            raise AssertionError("the injected kill did not fire")
    steps = [s for s, _ in checkpoint.list_steps(rd)]
    assert steps == [1], steps
    out = resilience.run_resumable(frame, STEPS, rd, sharded=True)
    out.collect().df.to_pickle(os.path.join(out_dir, f"resumed{rank}.pkl"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    ref_frame = tempo_tpu.TSDF(_df(), "event_ts", ["id"]).on_mesh(
        ref_mesh({"series": 2}))
    ref_ckpt.save(ref_frame, str(out / "ref_ck"), sharded=True)
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r),
         str(port), str(out)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r} OK" in log, log[-3000:]
    return out


def _one_process():
    return make_mesh({"series": 2}, devices=["cpu"] * 2)


def test_two_process_save_writes_each_ranks_shards(two_ranks):
    import json

    ck = two_ranks / "ck2p"
    man = json.loads((ck / "manifest.json").read_text())
    assert man["kind"] == "dist_sharded" and man["n_processes"] == 2
    assert (ck / "shard_p0.npz").exists() and (ck / "shard_p1.npz").exists()
    for r in range(2):
        blocks = json.loads((ck / f"blocks_p{r}.json").read_text())["blocks"]
        assert {b["key"].rsplit("_b", 1)[1] for b in blocks} == {str(r)}


@pytest.mark.parametrize("rank", [0, 1])
def test_round_trip_on_each_rank_is_the_saved_frame(two_ranks, rank):
    want = _port_frame(_one_process()).collect().df
    got = pd.read_pickle(two_ranks / f"back{rank}.pkl")
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_two_process_save_loads_in_one_reference_process(two_ranks):
    want = _port_frame(_one_process()).collect().df
    ref = ref_ckpt.load(str(two_ranks / "ck2p"), mesh=ref_mesh({"series": 2}))
    pd.testing.assert_frame_equal(ref.collect().df, want, check_exact=True)
    port = checkpoint.load(str(two_ranks / "ck2p"), mesh=_one_process())
    pd.testing.assert_frame_equal(port.collect().df, want, check_exact=True)


@pytest.mark.parametrize("rank", [0, 1])
def test_reference_save_loads_across_two_port_ranks(two_ranks, rank):
    want = checkpoint.load(str(two_ranks / "ref_ck"),
                           mesh=_one_process()).collect().df
    got = pd.read_pickle(two_ranks / f"ref{rank}.pkl")
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("rank", [0, 1])
def test_resumed_pipeline_is_the_one_process_run(two_ranks, rank, tmp_path):
    want = resilience.run_resumable(_port_frame(_one_process()), STEPS,
                                    str(tmp_path / "one"), sharded=True)
    got = pd.read_pickle(two_ranks / f"resumed{rank}.pkl")
    pd.testing.assert_frame_equal(got, want.collect().df, check_exact=True)


def test_dense_save_over_processes_refuses_by_name(tmp_path, monkeypatch):
    import torch.distributed as td

    monkeypatch.setattr(td, "is_initialized", lambda: True)
    monkeypatch.setattr(td, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(td, "get_rank", lambda group=None: 0)
    frame = _port_frame(_one_process())
    with pytest.raises(ValueError, match="must use sharded=True"):
        checkpoint.save(frame, str(tmp_path / "dense"))
    assert not os.path.exists(str(tmp_path / "dense.tmp"))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
