"""Timestamp units through the port's store and table writer.

A ``datetime64[s|ms|us|ns]`` column comes back from ``Store.write_table``
-> ``Store.read`` and from ``TSDF.write`` -> ``io.writer.read`` with the
dtype it was written with and the same values, held against the source
pandas frame.  Parquet has no seconds unit, so the store casts back from
the dtype its commit record names.  Tables cross between the packages:
the port reads tables ``tempo_tpu`` wrote with the source dtype, and
``tempo_tpu`` reads the port's tables with the same values (its own read
keeps Parquet's millisecond unit for a seconds column).  ``format="delta"``
coerces timestamps to microseconds for Spark's Parquet reader on
purpose, and reads back so; its test states that."""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.io import writer as ref_writer
from tempo_tpu.store import engine as ref_engine
from tempo_tpu_torch import TSDF
from tempo_tpu_torch.io import writer
from tempo_tpu_torch.store import engine as se

UNITS = ("s", "ms", "us", "ns")


def _df(unit, n=64, seed=3):
    rng = np.random.default_rng(seed)
    secs = np.sort(rng.integers(1_600_000_000, 1_600_000_000 + 3 * 86400, n))
    # sub-second parts that each unit holds exactly
    frac = {"s": 0, "ms": 10**6, "us": 10**3, "ns": 1}[unit]
    ns = secs * 10**9 + rng.integers(0, 1000, n) * frac
    return pd.DataFrame({
        "symbol": rng.choice(["a", "b", "c"], n).astype(object),
        "event_ts": ns.astype("datetime64[ns]").astype(f"datetime64[{unit}]"),
        "px": rng.standard_normal(n),
    })


def _srt(df):
    return df.sort_values(["symbol", "event_ts", "px"], kind="stable") \
        .reset_index(drop=True)


def _same(got, src):
    assert got["event_ts"].dtype == src["event_ts"].dtype
    pd.testing.assert_frame_equal(_srt(got[list(src.columns)]), _srt(src),
                                  check_exact=True)


@pytest.mark.parametrize("unit", UNITS)
def test_store_keeps_the_unit(tmp_path, unit):
    src = _df(unit)
    store = se.Store(str(tmp_path))
    store.write_table("t", src, ["symbol", "event_ts"], source_fp="units")
    _same(store.read("t"), src)
    _same(store.read("t", columns=["event_ts", "symbol", "px"]), src)


@pytest.mark.parametrize("unit", UNITS)
def test_tsdf_write_keeps_the_unit(tmp_path, unit):
    src = _df(unit)
    base = str(tmp_path / "wh")
    TSDF(src, "event_ts", ["symbol"], device="cpu").write(
        "t", ["px"], base_dir=base)
    _same(writer.read("t", partition_cols=["symbol"], base_dir=base,
                      device="cpu").df, src)


@pytest.mark.parametrize("unit", UNITS)
def test_tables_of_the_reference_read_with_the_unit(tmp_path, unit):
    src = _df(unit)
    base = str(tmp_path / "wh")
    tempo_tpu.TSDF(src, "event_ts", ["symbol"]).write(
        "t", ["px"], base_dir=base)
    _same(writer.read("t", partition_cols=["symbol"], base_dir=base,
                      device="cpu").df, src)
    ref_engine.Store(str(tmp_path / "st")).write_table(
        "t", src, ["symbol", "event_ts"], source_fp="units")
    _same(se.Store(str(tmp_path / "st")).read("t"), src)


@pytest.mark.parametrize("unit", UNITS)
def test_the_reference_reads_the_ports_tables(tmp_path, unit):
    """The reference's own read keeps Parquet's unit (ms for a seconds
    column): the values agree, the dtype is its."""
    src = _df(unit)
    base = str(tmp_path / "wh")
    TSDF(src, "event_ts", ["symbol"], device="cpu").write(
        "t", ["px"], base_dir=base)
    got = ref_writer.read("t", partition_cols=["symbol"], base_dir=base).df
    pd.testing.assert_frame_equal(
        _srt(got[list(src.columns)]), _srt(src), check_exact=True,
        check_dtype=False)
    se.Store(str(tmp_path / "st")).write_table(
        "t", src, ["symbol", "event_ts"], source_fp="units")
    got = ref_engine.Store(str(tmp_path / "st")).read("t")
    pd.testing.assert_frame_equal(
        _srt(got[list(src.columns)]), _srt(src), check_exact=True,
        check_dtype=False)


@pytest.mark.parametrize("unit", UNITS)
def test_delta_coerces_to_microseconds_on_purpose(tmp_path, unit):
    """``format="delta"`` writes microseconds for Spark and reads them
    back as microseconds, as the reference does; every source here holds
    whole microseconds, so the values survive."""
    src = _df(unit if unit != "ns" else "us").astype(
        {"event_ts": f"datetime64[{unit}]"})
    base = str(tmp_path / "wh")
    TSDF(src, "event_ts", ["symbol"], device="cpu").write(
        "t", ["px"], base_dir=base, format="delta")
    got = writer.read("t", partition_cols=["symbol"], base_dir=base,
                      device="cpu").df
    theirs = ref_writer.read("t", partition_cols=["symbol"],
                             base_dir=base).df
    assert got["event_ts"].dtype == np.dtype("datetime64[us]")
    pd.testing.assert_frame_equal(got, theirs, check_exact=True)
    pd.testing.assert_frame_equal(
        _srt(got[list(src.columns)]),
        _srt(src.astype({"event_ts": "datetime64[us]"})), check_exact=True)
