"""The time axis through the port's I/O and durability modules, against
the reference's: checkpoints of time-sharded mesh frames (dense and
``sharded=True``) written by either package load in the other onto the
same mesh shape, bitwise; a port checkpoint loads onto other layouts;
``io.ingest.from_parquet`` onto a time mesh equals the reference's
ingest; ``resilience.run_resumable`` resumes a time-sharded chain
bitwise.

Both packages compute float64 on the CPU: every comparison is exact.
The reference runs on its forced 8-device CPU host, the port on
``["cpu"] * 8``.
"""

import json
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import tempo_tpu
from tempo_tpu import checkpoint as ref_ckpt
from tempo_tpu.io import ingest as ref_ingest
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu_torch import TSDF, checkpoint, make_mesh, resilience
from tempo_tpu_torch.io import ingest
from tempo_tpu_torch.testing import faults

NS = 1_000_000_000
MESHES = [pytest.param({"series": 2, "time": 4}, id="series2xtime4"),
          pytest.param({"series": 1, "time": 8}, id="time8")]


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


def _joined(axes):
    """The same joined time-sharded frame in both packages (a host
    object column and the right ts chunks) and halo statistics (an
    audit)."""
    left, right = _dfs()
    jm, pm = ref_mesh(axes), make_mesh(axes, devices=["cpu"] * 8)
    op = lambda d: d.withRangeStats(colsToSummarize=["px"],
                                    rangeBackWindowSecs=60, strategy="halo")
    ref = op(tempo_tpu.TSDF(left, "event_ts", ["sym"]).on_mesh(
        jm, time_axis="time", halo_fraction=0.25).asofJoin(
        tempo_tpu.TSDF(right, "event_ts", ["sym"]).on_mesh(
            jm, time_axis="time")))
    port = op(TSDF(left, "event_ts", ["sym"], device="cpu").on_mesh(
        pm, time_axis="time", halo_fraction=0.25).asofJoin(
        TSDF(right, "event_ts", ["sym"], device="cpu").on_mesh(
            pm, time_axis="time")))
    return dict(ref=ref, port=port, jm=jm, pm=pm)


def _counts(frame):
    """The deferred audits' counts (either package's frame)."""
    if hasattr(frame, "audit_counts"):
        return [n for _, n in frame.audit_counts()]
    return [int(np.asarray(c)) for _, c in frame.audits]


def _eq(a: pd.DataFrame, b: pd.DataFrame):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_time_sharded_checkpoint_reads_both_ways(tmp_path, axes, writer,
                                                 sharded):
    j = _joined(axes)
    p = str(tmp_path / "mesh")
    if writer == "port":
        want = j["port"]
        checkpoint.save(want, p, sharded=sharded)
        back = ref_ckpt.load(p, mesh=j["jm"], time_axis="time")
    else:
        want = j["ref"]
        ref_ckpt.save(want, p, sharded=sharded)
        back = checkpoint.load(p, mesh=j["pm"], time_axis="time")
        assert back.n_time == axes["time"] and len(back.ts) == 8
    man = json.load(open(os.path.join(p, "manifest.json")))
    assert man["halo_fraction"] == 0.25 == back.halo_fraction
    _eq(back.collect().df, want.collect().df)
    # the halo audit travels with the frame, and both packages count it
    # alike
    assert _counts(back) == _counts(want) == _counts(j["ref"])
    assert _counts(want)[0] > 0


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("target", [{"series": 4}, {"series": 2, "time": 2},
                                    {"series": 1, "time": 4}], ids=str)
def test_a_time_sharded_checkpoint_loads_onto_other_layouts(
        tmp_path, sharded, target):
    j = _joined({"series": 2, "time": 4})
    p = str(tmp_path / "mesh")
    checkpoint.save(j["port"], p, sharded=sharded)
    mesh = make_mesh(target, devices=["cpu"] * 4)
    ta = "time" if "time" in target else None
    back = checkpoint.load(p, mesh=mesh, time_axis=ta)
    _eq(back.collect().df, j["port"].collect().df)
    # and continues the chain: the EMA over its own blocks
    got = back.EMA("px", exact=True).collect().df
    want = j["port"].EMA("px", exact=True).collect().df
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12,
                                  atol=1e-12)


def _dataset(path, seed=3, n_keys=13, files=3, per=300):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(files):
        df = pd.DataFrame({
            "symbol": rng.choice([f"s{k:03d}" for k in range(n_keys)], per),
            "event_ts": pd.to_datetime(
                (np.sort(rng.integers(0, 10**5, per)) + i * 10**5) * NS),
            "px": np.where(rng.random(per) < 0.1, np.nan,
                           rng.standard_normal(per)),
        })
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       os.path.join(path, f"part-{i}.parquet"),
                       row_group_size=100)
    return path


@pytest.mark.parametrize("axes", MESHES)
def test_from_parquet_onto_a_time_mesh_is_the_reference_one(tmp_path, axes):
    path = _dataset(str(tmp_path / "ds"))
    kw = dict(ts_col="event_ts", partition_cols=["symbol"], batch_rows=128,
              time_axis="time")
    got = ingest.from_parquet(path, mesh=make_mesh(axes,
                                                   devices=["cpu"] * 8),
                              **kw)
    want = ref_ingest.from_parquet(path, mesh=ref_mesh(axes), **kw)
    assert got.n_time == axes["time"] and (got.K_dev, got.L) == \
        tuple(want.ts.shape)
    _eq(got.collect().df, want.collect().df)
    # the ingested frame chains on the time axis like the reference's
    op = lambda d: d.EMA("px", exact=True).withRangeStats(
        colsToSummarize=["px"], rangeBackWindowSecs=600).collect().df
    pd.testing.assert_frame_equal(op(got), op(want), check_exact=False,
                                  rtol=1e-9, atol=1e-9)


def test_run_resumable_on_a_time_sharded_frame(tmp_path):
    left, _ = _dfs()
    frame = TSDF(left, "event_ts", ["sym"], device="cpu").on_mesh(
        make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4),
        time_axis="time")
    steps = [("EMA", {"colName": "px", "window": 4, "exact": True}),
             ("withRangeStats", {"colsToSummarize": ["px"],
                                 "rangeBackWindowSecs": 60})]
    ck = str(tmp_path / "ck")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(checkpoint, "_savez", call_no=2)
        with pytest.raises(faults.SimulatedKill):
            resilience.run_resumable(frame, steps, ck)
    assert [s for s, _ in checkpoint.list_steps(ck)] == [1]
    got = resilience.run_resumable(frame, steps, ck)
    assert got.n_time == 2
    want = frame.EMA(**steps[0][1]).withRangeStats(**steps[1][1])
    _eq(got.collect().df, want.collect().df)
