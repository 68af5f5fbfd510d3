"""The port's store (``tempo_tpu_torch/store``), table writer
(``io/writer.py``), the frame's I/O methods and the display helpers,
against the reference's on the same seeded frames.

A table either package writes (``TSDF.write`` in both calling orders,
``format="parquet"`` through the store and ``format="delta"``) reads
in the other with every value equal; the store's generations, kill and
resume (zero committed-segment rewrites), refusals by name, retention
and compaction behave as the reference's."""

import json
import os

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.io import writer as ref_writer
from tempo_tpu.store import engine as ref_engine
from tempo_tpu_torch import TSDF, make_mesh, utils
from tempo_tpu_torch.io import writer
from tempo_tpu_torch.store import compact as run_compact
from tempo_tpu_torch.store import engine as se
from tempo_tpu_torch.testing import faults

NS = 1_000_000_000


def _df(n=300, seed=0, n_keys=5):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "symbol": rng.choice([f"s{k}" for k in range(n_keys)], n),
        "event_ts": pd.to_datetime(
            np.sort(rng.integers(0, 3 * 86400, n)) * NS),
        "px": rng.standard_normal(n),
        "qty": rng.integers(0, 100, n),
        "venue": rng.choice(["x", "y"], n).astype(object),
    })
    df.loc[rng.random(n) < 0.1, "px"] = np.nan
    return df


def _srt(df):
    return df.sort_values(["symbol", "event_ts"], kind="stable") \
        .reset_index(drop=True)


@pytest.mark.parametrize("fmt", ["parquet", "delta"])
@pytest.mark.parametrize("writer_pkg", ["port", "ref"])
def test_tables_read_both_ways(tmp_path, writer_pkg, fmt):
    df = _df()
    base = str(tmp_path / "wh")
    if writer_pkg == "port":
        TSDF(df, "event_ts", ["symbol"], device="cpu").write(
            "t", ["px"], base_dir=base, format=fmt)
        got = ref_writer.read("t", partition_cols=["symbol"],
                              base_dir=base).df
    else:
        tempo_tpu.TSDF(df, "event_ts", ["symbol"]).write(
            "t", ["px"], base_dir=base, format=fmt)
        got = writer.read("t", partition_cols=["symbol"], base_dir=base,
                          device="cpu").df
    mine = writer.read("t", partition_cols=["symbol"], base_dir=base,
                       device="cpu").df
    theirs = ref_writer.read("t", partition_cols=["symbol"],
                             base_dir=base).df
    pd.testing.assert_frame_equal(mine, theirs, check_exact=True)
    want = df.astype({"venue": got["venue"].dtype})
    pd.testing.assert_frame_equal(
        _srt(got)[list(df.columns)], _srt(want), check_exact=True,
        check_dtype=False)


def test_store_layout_is_the_reference_one(tmp_path):
    """Both packages stage the same files, the same commit fields and the
    same segment bytes for one frame."""
    df = _df()
    p = TSDF(df, "event_ts", ["symbol"], device="cpu").write(
        "t", base_dir=str(tmp_path / "a"))
    q = tempo_tpu.TSDF(df, "event_ts", ["symbol"]).write(
        "t", base_dir=str(tmp_path / "b"))
    for root in (p, q):
        assert sorted(os.listdir(root)) == ["_CURRENT.json", "gen_00000001"]
    ga, gb = (os.path.join(r, "gen_00000001") for r in (p, q))
    assert sorted(os.listdir(ga)) == sorted(os.listdir(gb))
    ca = json.load(open(os.path.join(ga, "_commit.json")))
    cb = json.load(open(os.path.join(gb, "_commit.json")))
    assert sorted(ca) == sorted(cb)
    assert ca["sort_cols"] == cb["sort_cols"] == ["symbol", "event_time"]
    assert ca["rows"] == cb["rows"] == len(df)
    assert ca["source"] == cb["source"]       # the same content fingerprint
    assert [s["crc"] for s in ca["segments"]] == \
        [s["crc"] for s in cb["segments"]]


def test_write_calling_orders_and_bad_name(tmp_path):
    t = TSDF(_df(), "event_ts", ["symbol"], device="cpu")
    base = str(tmp_path / "wh")
    p1 = t.write("a", ["px"], base_dir=base)
    p2 = t.write(None, "b", ["px"], base_dir=base)     # (spark, name, cols)
    assert (os.path.basename(p1), os.path.basename(p2)) == ("a", "b")
    with pytest.raises(TypeError, match="table name"):
        t.write(None, base_dir=base)
    with pytest.raises(ValueError, match="format"):
        t.write("c", base_dir=base, format="orc")


def test_killed_write_resumes_with_zero_committed_rewrites(tmp_path):
    store = se.Store(str(tmp_path / "wh"))
    df1, df2 = _df(seed=1), _df(seed=2)
    store.write_table("t", df1, ["symbol"], source_fp="a",
                      segment_rows=50)
    with pytest.raises(faults.SimulatedKill):
        with faults.FaultInjector().kill_on_call(se, "_write_segment",
                                                 call_no=3):
            store.write_table("t", df2, ["symbol"], source_fp="b",
                              segment_rows=50)
    pd.testing.assert_frame_equal(store.read("t", verify=True),
                                  df1.sort_values("symbol", kind="stable")
                                  .reset_index(drop=True))
    # the reference reads the old generation too, and sees the staging
    assert ref_engine.Store(store.base_dir).current("t")[0] == "gen_00000001"
    with faults.FaultInjector().flaky(se, "_write_segment",
                                      failures=0) as fi:
        stats = store.write_table("t", df2, ["symbol"], source_fp="b",
                                  segment_rows=50)
    assert stats["resumed"] and stats["segments_reused"] == 2
    assert stats["segments_rewritten"] == 0
    assert len(fi.records) == stats["segments"] - 2


def test_foreign_staging_and_torn_commit_refuse_by_name(tmp_path):
    store = se.Store(str(tmp_path / "wh"))
    store.write_table("t", _df(seed=1), ["symbol"], source_fp="a",
                      segment_rows=100)
    with pytest.raises(faults.SimulatedKill):
        with faults.FaultInjector().kill_on_call(se, "_write_segment",
                                                 call_no=2):
            store.write_table("t", _df(seed=2), ["symbol"], source_fp="b",
                              segment_rows=100)
    with pytest.raises(se.StoreError, match="DIFFERENT write"):
        store.write_table("t", _df(seed=3), ["symbol"], source_fp="c",
                          segment_rows=100)
    assert store.discard_staging("t")
    gen = store.current("t")[0]
    commit = os.path.join(store.table_path("t"), gen, "_commit.json")
    faults.flip_byte(commit, 5)
    with pytest.raises(se.StoreCommitError, match="torn commit"):
        store.read("t")
    with pytest.raises(ref_engine.StoreCommitError, match="torn commit"):
        ref_engine.Store(store.base_dir).read("t")


def test_compaction_and_retention(tmp_path):
    base = str(tmp_path / "wh")
    store = se.Store(base)
    df = _df(n=400)
    store.write_table("t", df, ["symbol"], source_fp="a", segment_rows=50)
    before = store.read("t")
    stats = run_compact("t", base_dir=base, target_rows=1000)
    assert stats["compacted_from"] == "gen_00000001"
    assert stats["segments"] == 1
    pd.testing.assert_frame_equal(store.read("t", verify=True), before)
    assert run_compact("t", base_dir=base) is None   # already compact
    for i in range(3):
        store.write_table("t", _df(seed=10 + i), ["symbol"],
                          source_fp=f"v{i}", keep_generations=2)
    assert store.generations("t") == ["gen_00000004", "gen_00000005"]


@pytest.mark.parametrize("source", ["mesh", "frame", "dataframe"])
def test_write_back_of_every_source(tmp_path, source):
    df = _df()
    frame = TSDF(df, "event_ts", ["symbol"], device="cpu")
    obj = {"frame": frame, "dataframe": df,
           "mesh": frame.on_mesh(make_mesh({"series": 2},
                                           devices=["cpu"] * 2))}[source]
    stats = se.write_back(obj, "t", base_dir=str(tmp_path),
                          ts_col="event_ts", partition_cols=["symbol"])
    got = se.read_dataset_df(se.resolve_dataset_path(stats["path"]))
    assert len(got) == len(df)
    np.testing.assert_array_equal(
        _srt(got)["px"].to_numpy(), _srt(df)["px"].to_numpy())
    again = se.write_back(obj, "t", base_dir=str(tmp_path),
                          ts_col="event_ts", partition_cols=["symbol"])
    assert again["resumed"] and again["segments_rewritten"] == 0


def test_arrow_and_spark_interop():
    df = _df()
    t = TSDF(df, "event_ts", ["symbol"], device="cpu")
    tab = t.to_arrow()
    assert tab.equals(tempo_tpu.TSDF(df, "event_ts", ["symbol"]).to_arrow())
    back = TSDF.from_arrow(tab, "event_ts", ["symbol"], device="cpu")
    pd.testing.assert_frame_equal(back.df, tab.to_pandas())

    class FakeSpark:
        def toPandas(self):
            return df

    s = TSDF.from_spark(FakeSpark(), "event_ts", ["symbol"], device="cpu")
    pd.testing.assert_frame_equal(s.df, df)
    with pytest.raises(RuntimeError, match="pyspark"):
        t.to_spark()


def test_display_prints_the_frame(capsys):
    t = TSDF(_df(n=5), "event_ts", ["symbol"], device="cpu")
    utils.display(t)
    out = capsys.readouterr().out
    assert "symbol" in out and len(out.splitlines()) == 6
    assert utils.PLATFORM == "NON_DATABRICKS"
