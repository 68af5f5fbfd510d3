"""The port's out-of-core Parquet ingest (``tempo_tpu_torch/io/ingest.py``)
against the reference's (``tempo_tpu/io/ingest.py``).

The same seeded Parquet datasets (a few files, several row groups each)
go through ``from_parquet`` onto the port's ``["cpu"] * 4`` mesh and the
reference's 8-device CPU mesh; the collected frames are equal bitwise
(both compute float64 on the CPU).  A killed ingest resumes and
re-streams only the uncommitted shards (counted), quarantine records the
reference's ranges, and ``sweep_slabs`` gives the same bits at rings 1
to 3."""

import glob
import os
import shutil
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tempo_tpu.io import ingest as ref_ingest
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu_torch import TSDF, dist, make_mesh, resilience
from tempo_tpu_torch.io import ingest
from tempo_tpu_torch.resilience import CheckpointError, DeadlineExceeded
from tempo_tpu_torch.testing import faults

N_ROWS = 2000
N_FILES = 4
KW = dict(ts_col="event_ts", partition_cols=["symbol"], batch_rows=256)


def _make_dataset(path, seed=3, n_keys=13, rg=125):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = N_ROWS // N_FILES
    for i in range(N_FILES):
        df = pd.DataFrame({
            "symbol": rng.choice([f"s{k:03d}" for k in range(n_keys)], per),
            "event_ts": pd.to_datetime(
                (np.sort(rng.integers(0, 10**6, per)) + i * 10**6) * 10**9),
            "px": np.where(rng.random(per) < 0.1, np.nan,
                           rng.standard_normal(per)),
            "qty": rng.integers(1, 9, per).astype(float),
            "note": rng.choice(["x", "y"], per),
        })
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       os.path.join(path, f"part-{i}.parquet"),
                       row_group_size=rg)
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _make_dataset(str(tmp_path_factory.mktemp("ing") / "ds"))


@pytest.fixture(scope="module")
def meshes():
    return make_mesh({"series": 4}, devices=["cpu"] * 4), \
        ref_mesh({"series": 8})


def _srt(frame):
    return frame.collect().df.sort_values(
        ["symbol", "event_ts"], kind="stable").reset_index(drop=True)


@pytest.mark.parametrize("case", ["plain", "columns", "store_table"])
def test_from_parquet_matches_the_reference(dataset, meshes, tmp_path,
                                            case):
    pm, jm = meshes
    path, kw = dataset, dict(KW)
    if case == "columns":
        kw["columns"] = ["px"]
    elif case == "store_table":
        df = pd.concat([pd.read_parquet(p) for p in
                        sorted(glob.glob(os.path.join(dataset, "*.parquet")))])
        path = TSDF(df, "event_ts", ["symbol"], device="cpu").write(
            "t", base_dir=str(tmp_path))
    got = ingest.from_parquet(path, mesh=pm, **kw)
    want = ref_ingest.from_parquet(path, mesh=jm, **kw)
    pd.testing.assert_frame_equal(got.collect().df, want.collect().df,
                                  check_exact=True)
    assert got.n_series_shards == 4 and got.K_dev % 4 == 0


def test_ingested_frame_chains_like_the_packed_frame(dataset, meshes):
    """The ingested mesh frame feeds the mesh ops: its EMA equals that of
    the same rows packed by ``on_mesh`` bitwise, and its range stats
    within rtol = atol = 1e-9.  The ingested layout carries per-series
    offsets only, so range stats take the windowed (prefix-sum) engine,
    as in the reference, where the packed frame takes the row-bounded
    sweep: float64 sums taken in another order."""
    pm, _ = meshes
    got = ingest.from_parquet(dataset, mesh=pm, columns=["px"], **KW)
    src = got.collect()
    ref = TSDF(src.df, "event_ts", ["symbol"], device="cpu").on_mesh(pm)
    chain = [("EMA", dict(colName="px", window=4, exact=True)),
             ("withRangeStats", dict(colsToSummarize=["px"],
                                     rangeBackWindowSecs=600))]
    for name, kw in chain:
        got, ref = getattr(got, name)(**kw), getattr(ref, name)(**kw)
        if name == "EMA":
            pd.testing.assert_frame_equal(_srt(got), _srt(ref),
                                          check_exact=True)
    pd.testing.assert_frame_equal(_srt(got), _srt(ref), check_exact=False,
                                  rtol=1e-9, atol=1e-9)


def test_killed_ingest_resumes_only_uncommitted_shards(dataset, meshes,
                                                       tmp_path):
    pm, _ = meshes
    rd = str(tmp_path / "resume")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(ingest, "_stream_shard", call_no=3)
        with pytest.raises(faults.SimulatedKill):
            ingest.from_parquet(dataset, mesh=pm, resume_dir=rd, ring=1,
                                **KW)
    committed = len(glob.glob(os.path.join(rd, "shard_*.json")))
    assert committed == 2
    with faults.FaultInjector() as fi:
        fi.flaky(ingest, "_stream_shard", failures=0)      # a call counter
        fi.flaky(ingest, "_census", failures=0, label="census")
        frame = ingest.from_parquet(dataset, mesh=pm, resume_dir=rd, **KW)
        streamed = [r for r in fi.records if r.target != "census"]
        assert len(streamed) == 4 - committed
        assert not [r for r in fi.records if r.target == "census"]
    with faults.FaultInjector() as fi:
        fi.flaky(ingest, "_stream_shard", failures=0)
        again = ingest.from_parquet(dataset, mesh=pm, resume_dir=rd, **KW)
        assert fi.records == [], "a committed resume re-read Parquet"
    fresh = ingest.from_parquet(dataset, mesh=pm, **KW)
    for f in (frame, again):
        pd.testing.assert_frame_equal(_srt(f), _srt(fresh),
                                      check_exact=True)
    with pytest.raises(CheckpointError, match="DIFFERENT ingest"):
        ingest.from_parquet(dataset, mesh=make_mesh(
            {"series": 2}, devices=["cpu"] * 2), resume_dir=rd, **KW)


def _ranges(frame_or_err):
    return sorted((os.path.basename(r["file"]), r["row_group"], r["rows"])
                  for r in frame_or_err)


@pytest.mark.parametrize("damage", ["row_group", "footer"])
def test_quarantine_ranges_are_the_reference_ones(dataset, meshes,
                                                  tmp_path, damage):
    pm, jm = meshes
    qd = str(tmp_path / "qds")
    shutil.copytree(dataset, qd)
    if damage == "row_group":
        faults.corrupt_parquet_row_group(
            os.path.join(qd, "part-1.parquet"), row_group=2)
    else:
        faults.tear_parquet_footer(os.path.join(qd, "part-0.parquet"))
    with pytest.raises(ingest.CorruptRowGroupError) as port_err:
        ingest.from_parquet(qd, mesh=pm, **KW)
    with pytest.raises(ref_ingest.CorruptRowGroupError) as ref_err:
        ref_ingest.from_parquet(qd, mesh=jm, **KW)
    assert _ranges(port_err.value.ranges) == _ranges(ref_err.value.ranges)
    got = ingest.from_parquet(qd, mesh=pm, on_corrupt="quarantine", **KW)
    want = ref_ingest.from_parquet(qd, mesh=jm, on_corrupt="quarantine",
                                   **KW)
    assert _ranges(got.ingest_quarantined) == \
        _ranges(want.ingest_quarantined)
    pd.testing.assert_frame_equal(got.collect().df, want.collect().df,
                                  check_exact=True)
    assert any("quarantined" in msg for msg, _ in got.audits)


def test_deadline_dies_at_a_named_stage(dataset, meshes, monkeypatch):
    pm, _ = meshes

    class DiesAtCensus(resilience.Deadline):
        def check(self, stage):
            if stage == "census":
                self.expires_at = self._clock() - 1.0
            return super().check(stage)

    with pytest.raises(DeadlineExceeded) as ei:
        ingest.from_parquet(dataset, mesh=pm,
                            deadline_s=DiesAtCensus(3600.0), **KW)
    assert ei.value.stage == "census"
    monkeypatch.setenv("TEMPO_TPU_INGEST_DEADLINE_S", "0.000001")
    with pytest.raises(DeadlineExceeded) as ei:
        ingest.from_parquet(dataset, mesh=pm, **KW)
    assert ei.value.stage == "dataset open"


def test_a_flapping_file_trips_the_breaker(dataset, meshes):
    pm, _ = meshes
    bad = os.path.join(dataset, "part-2.parquet")
    orig = ingest._scan_fragment

    def flapping(frag, *a, **k):
        if getattr(frag, "path", "") == bad:
            raise faults.InjectedFault(f"flapping read at {bad}")
        return orig(frag, *a, **k)

    brk = resilience.CircuitBreaker(threshold=2, cooldown_s=600.0)
    with faults.FaultInjector() as fi:
        fi._patch(ingest, "_scan_fragment", lambda original: flapping)
        frame = ingest.from_parquet(dataset, mesh=pm,
                                    on_corrupt="quarantine", breaker=brk,
                                    **KW)
    q = [r for r in frame.ingest_quarantined if r["file"] == bad]
    assert q and "circuit" in q[0]["reason"]
    assert len(frame.collect().df) == N_ROWS - N_ROWS // N_FILES


def test_a_time_axis_raises(dataset, meshes, monkeypatch):
    """A time axis ingests now (the blocks of the series-only frame,
    bitwise); several processes raise, naming the reason: the JAX
    package's ingest places every shard from one host too."""
    mesh = make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    frame = ingest.from_parquet(dataset, mesh=mesh, time_axis="time",
                                halo_fraction=0.25, **KW)
    assert frame.n_time == 2 and frame.halo_fraction == 0.25
    pd.testing.assert_frame_equal(
        _srt(frame), _srt(ingest.from_parquet(dataset, mesh=meshes[0], **KW)),
        check_exact=True)
    import torch.distributed as td

    monkeypatch.setattr(td, "is_initialized", lambda: True)
    monkeypatch.setattr(td, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="JAX package has no"):
        ingest.from_parquet(dataset, mesh=mesh, time_axis="time", **KW)


@pytest.mark.parametrize("ring", [1, 2, 3])
def test_sweep_slabs_is_bitwise_at_every_ring(ring):
    """load (a host pack), compute (an upload, withRangeStats-style work
    on the shard's tensors) and drain (a fetch) over 8 slabs: the result
    is the serial loop's at every depth, and the knob sets the default."""
    rng = np.random.default_rng(9)
    slabs = [rng.standard_normal((4, 64)) for _ in range(8)]
    threads = set()

    def load(i):
        threads.add(("load", threading.current_thread().name))
        return np.ascontiguousarray(slabs[i] * 2.0)

    def compute(i, x):
        return dist._upload_planes([x], "cpu")[0].cumsum(1) + i

    def drain(i, y):
        threads.add(("drain", threading.current_thread().name))
        return dist._fetch_planes([y])[0].copy()

    want = [np.cumsum(s * 2.0, axis=1) + i for i, s in enumerate(slabs)]
    got = ingest.sweep_slabs(8, load, compute, drain, ring=ring)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert ref_ingest.sweep_slabs(8, load, compute, drain, ring=ring) \
        is not None
    if ring > 1:
        assert ("load", "slab-load") in threads


def test_sweep_slabs_ring_knob_and_failures(monkeypatch):
    seen = []
    monkeypatch.setenv("TEMPO_TPU_INGEST_RING", "1")
    ingest.sweep_slabs(2, lambda i: seen.append(
        threading.current_thread().name) or i, lambda i, x: x)
    assert set(seen) == {threading.main_thread().name}

    def boom(i):
        if i == 2:
            raise ValueError("slab 2")
        return i

    for ring in (1, 3):
        with pytest.raises(ValueError, match="slab 2"):
            ingest.sweep_slabs(5, boom, lambda i, x: x, ring=ring)


def test_ingest_errors_classify_like_the_reference():
    from tempo_tpu import resilience as ref_res

    got = ingest.CorruptRowGroupError("bad", ranges=[{"file": "f"}])
    want = ref_ingest.CorruptRowGroupError("bad", ranges=[{"file": "f"}])
    assert got.ranges == want.ranges == ({"file": "f"},)
    assert resilience.classify(got).value == ref_res.classify(want).value \
        == "corrupted-artifact"
