"""The port's checkpoints (``tempo_tpu_torch/checkpoint.py``) against the
reference's (``tempo_tpu/checkpoint.py``): the same on-disk format, so a
host frame, a mesh frame (dense and ``sharded=True``) and a
``save_state`` snapshot written by either package load in the other.

Both packages compute in float64 on the CPU, so every comparison is
bitwise with no cast: frames collected from a loaded checkpoint equal
the frame that was saved, and a chain continued after the load equals
the uninterrupted chain.  The reference runs on its forced 8-device
CPU mesh (``{"series": 4}``), the port on ``["cpu"] * 4`` (and 2 or 3
shards where the load changes the shard count)."""

import json
import os

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu import checkpoint as ref_ckpt
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu.testing import faults as ref_faults
from tempo_tpu_torch import TSDF, checkpoint, make_mesh
from tempo_tpu_torch.resilience import CheckpointError
from tempo_tpu_torch.testing import faults

NS = 1_000_000_000


def _dfs(seed=21, n=160, m=120):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({
        "sym": rng.choice(["a", "b", "c", "d", "e"], n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, n)) * NS),
        "px": rng.standard_normal(n) + 10,
        "tag": [f"t{i % 4}" for i in range(n)],
    })
    right = pd.DataFrame({
        "sym": rng.choice(["a", "b", "c"], m),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, m)) * NS),
        "bid": np.where(rng.random(m) > 0.2, rng.standard_normal(m), np.nan),
        "venue": np.where(rng.random(m) > 0.1,
                          np.array([f"v{i % 3}" for i in range(m)], object),
                          None),
    })
    return left, right


@pytest.fixture(scope="module")
def joined():
    """The same joined mesh frame in both packages (a host-gathered
    object column and the three ts-chunk planes of the right ts)."""
    left, right = _dfs()
    jm = ref_mesh({"series": 4})
    pm = make_mesh({"series": 4}, devices=["cpu"] * 4)
    ref = tempo_tpu.TSDF(left, "event_ts", ["sym"]).on_mesh(jm).asofJoin(
        tempo_tpu.TSDF(right, "event_ts", ["sym"]).on_mesh(jm))
    port = TSDF(left, "event_ts", ["sym"], device="cpu").on_mesh(pm) \
        .asofJoin(TSDF(right, "event_ts", ["sym"], device="cpu").on_mesh(pm))
    return dict(ref=ref, port=port, jm=jm, pm=pm)


def _eq(a: pd.DataFrame, b: pd.DataFrame):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_host_frame_reads_both_ways(tmp_path, writer):
    left, _ = _dfs()
    p = str(tmp_path / "host")
    if writer == "port":
        checkpoint.save(TSDF(left, "event_ts", ["sym"], device="cpu"), p)
        back = ref_ckpt.load(p)
    else:
        ref_ckpt.save(tempo_tpu.TSDF(left, "event_ts", ["sym"]), p)
        back = checkpoint.load(p, device="cpu")
    _eq(back.df, TSDF(left, "event_ts", ["sym"], device="cpu").df)
    assert (back.ts_col, back.partitionCols) == ("event_ts", ["sym"])


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_mesh_frame_reads_both_ways(tmp_path, joined, writer, sharded):
    p = str(tmp_path / "mesh")
    if writer == "port":
        checkpoint.save(joined["port"], p, sharded=sharded)
        back = ref_ckpt.load(p, mesh=joined["jm"])
        want = joined["ref"].collect().df
    else:
        ref_ckpt.save(joined["ref"], p, sharded=sharded)
        back = checkpoint.load(p, mesh=joined["pm"])
        want = joined["port"].collect().df
    _eq(back.collect().df, want)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_a_loaded_mesh_frame_continues_the_chain(tmp_path, joined,
                                                 sharded, n_shards):
    p = str(tmp_path / "mid")
    checkpoint.save(joined["port"], p, sharded=sharded)
    mesh = make_mesh({"series": n_shards}, devices=["cpu"] * n_shards)
    back = checkpoint.load(p, mesh=mesh)
    assert back.K_dev % n_shards == 0

    def chain(d):
        return d.EMA("px", window=5, exact=True).withRangeStats(
            colsToSummarize=["px"], rangeBackWindowSecs=60).collect().df

    _eq(chain(back), chain(joined["port"]))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_state_snapshots_read_both_ways(tmp_path, writer):
    rng = np.random.default_rng(2)
    arrays = {"ts": rng.integers(0, 10**12, (4, 16)),
              "vals": rng.standard_normal((4, 16)),
              "mask": rng.random((4, 16)) > 0.3}
    p = str(tmp_path / "state")
    save, load = ((checkpoint.save_state, ref_ckpt.load_state)
                  if writer == "port" else
                  (ref_ckpt.save_state, checkpoint.load_state))
    save(arrays, p, meta={"tick": 3})
    got, meta = load(p)
    assert meta == {"tick": 3}
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()
    with pytest.raises(ValueError, match="not a 'cohort_state'"):
        checkpoint.load_state(p, kind="cohort_state")


@pytest.mark.parametrize("loader", ["port", "ref"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_flipped_byte_names_the_array(tmp_path, joined, writer, loader):
    p = str(tmp_path / "bad")
    (checkpoint if writer == "port" else ref_ckpt).save(
        joined[writer], p)
    flip = faults if loader == "port" else ref_faults
    name = flip.corrupt_npz_array(os.path.join(p, "arrays.npz"))
    err = CheckpointError if loader == "port" else \
        tempo_tpu.resilience.CheckpointError
    with pytest.raises(err, match=repr(name)):
        if loader == "port":
            checkpoint.load(p, mesh=joined["pm"])
        else:
            ref_ckpt.load(p, mesh=joined["jm"])


def test_state_snapshot_flip_names_the_array(tmp_path):
    p = str(tmp_path / "st")
    checkpoint.save_state({"a": np.arange(8), "b": np.arange(4096.0)}, p)
    name = faults.corrupt_npz_array(os.path.join(p, "state.npz"))
    assert name == "b"
    with pytest.raises(CheckpointError, match="'b'"):
        checkpoint.load_state(p)


def test_step_family_resolve_prune_and_verify(tmp_path):
    left, _ = _dfs()
    frame = TSDF(left, "event_ts", ["sym"], device="cpu")
    parent = str(tmp_path / "fam")
    prev = None
    for step in (1, 2, 3):
        path = os.path.join(parent, f"step_{step:05d}")
        meta = {"pipeline_signature": "sig", "step": step}
        if prev is not None:
            meta["prev_step"], meta["prev_manifest_crc"] = prev
        checkpoint.save(frame, path, meta=meta)
        prev = (step, checkpoint.manifest_crc(path))
    assert [s for s, _ in checkpoint.list_steps(parent)] == [3, 2, 1]
    assert checkpoint.read_meta(os.path.join(parent, "step_00002"))["step"] \
        == 2
    # a torn newest step falls back to the previous one
    faults.truncate_file(os.path.join(parent, "step_00003", "host.parquet"))
    step, path, _ = checkpoint.resolve_step(parent, signature="sig")
    assert step == 2 and checkpoint.latest(parent) == path
    assert ref_ckpt.latest(parent) == path
    with pytest.raises(CheckpointError, match="DIFFERENT"):
        checkpoint.resolve_step(parent, signature="other")
    checkpoint.prune(parent, keep_last=1)
    assert [s for s, _ in checkpoint.list_steps(parent)] == [3]
    with pytest.raises(CheckpointError):
        checkpoint.verify_checkpoint(os.path.join(parent, "step_00003"))


def test_a_kill_mid_save_keeps_the_previous_checkpoint(tmp_path, joined):
    p = str(tmp_path / "ck")
    checkpoint.save(joined["port"], p)
    before = open(os.path.join(p, "manifest.json")).read()
    with faults.FaultInjector() as fi:
        fi.kill_on_call(checkpoint, "_savez")
        with pytest.raises(faults.SimulatedKill):
            checkpoint.save(joined["port"], p, meta={"new": True})
    assert open(os.path.join(p, "manifest.json")).read() == before
    faults.make_stale_tmp(p)
    _eq(checkpoint.load(p, mesh=joined["pm"]).collect().df,
        joined["port"].collect().df)
    assert not os.path.exists(p + ".tmp")


def test_newer_format_and_foreign_manifest_refuse(tmp_path, joined):
    p = str(tmp_path / "ck")
    checkpoint.save(joined["port"], p)
    mp = os.path.join(p, "manifest.json")
    man = json.load(open(mp))
    man["format_version"] = checkpoint.FORMAT_VERSION + 1
    json.dump(man, open(mp, "w"))
    with pytest.raises(CheckpointError, match="newer"):
        checkpoint.load(p, mesh=joined["pm"])
    open(mp, "w").write("{not json")
    with pytest.raises(CheckpointError, match="corrupt"):
        checkpoint.load(p, mesh=joined["pm"])


def test_time_axis_and_several_processes_raise(tmp_path, joined,
                                               monkeypatch):
    p = str(tmp_path / "ck")
    checkpoint.save(joined["port"], p)
    mesh = make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    # a time axis loads now: the blocks of the saved planes, bitwise
    back = checkpoint.load(p, mesh=mesh, time_axis="time")
    assert back.n_time == 2 and len(back.ts) == 4
    _eq(back.collect().df, joined["port"].collect().df)
    import torch.distributed as td

    monkeypatch.setattr(td, "is_initialized", lambda: True)
    monkeypatch.setattr(td, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(td, "get_rank", lambda group=None: 0)
    # several processes: a dense save refuses by name, as the
    # reference's, before anything is on disk
    with pytest.raises(ValueError, match="sharded=True"):
        checkpoint.save(joined["port"], str(tmp_path / "two"))
    assert not os.path.exists(str(tmp_path / "two.tmp"))
