"""Timestamps at or past the packed layouts' pad key.

Both packages pad packed ``[K, L]`` rows with the key ``TS_PAD`` = 2^62
ns after the epoch (2116-02-20 23:53:38.427387904).  A real row at or
past it sorts among the pads, so every windowed, joined or ranked
answer from there on is wrong: the reference computes such answers
silently, and the port's windowed range engine gathered out of bounds
on the card (a device-side assert).  The port now refuses such
timestamps by name in ``packing.series_to_ns`` (integer timestamps are
seconds, so past 4,611,686,018 s).  Below the key the port's answers
equal an independent pandas oracle and the reference's; past it the
reference's differ from the oracle while the port raises.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu_torch import TSDF, packing
from tempo_tpu_torch.query import StandingQueryEngine, StreamTable

LIMIT_S = int(packing.TS_PAD) // int(packing.NS_PER_S)      # 4,611,686,018


def _frame(ts, seed=0):
    rng = np.random.default_rng(seed)
    n = len(ts)
    return pd.DataFrame({"event_ts": ts,
                         "sym": np.where(np.arange(n) % 3 == 0, "A", "B"),
                         "px": rng.normal(100.0, 5.0, n)})


def _oracle_counts(df, window):
    out = np.zeros(len(df), np.int64)
    for _, g in df.groupby("sym"):
        ts = g["event_ts"].to_numpy(np.int64)
        for i, idx in zip(range(len(g)), g.index):
            out[idx] = int(((ts >= ts[i] - window) & (ts <= ts[i])).sum())
    return out


def _wide(up_to_limit: bool):
    """20 rows three billion seconds before the key, then 20 a minute
    apart around it: a span past int32 seconds, so both packages keep
    int64 seconds, where the pads' seconds are the key's."""
    ts = np.concatenate([
        LIMIT_S - 3_000_000_000 + np.arange(20, dtype=np.int64) * 60,
        LIMIT_S - 10 * 60 + np.arange(20, dtype=np.int64) * 60])
    df = _frame(ts)
    if up_to_limit:
        df = df[df["event_ts"] < LIMIT_S].reset_index(drop=True)
    return df


def test_below_the_pad_key_matches_the_oracle_and_the_reference():
    df = _wide(up_to_limit=True)
    got = TSDF(df, "event_ts", ["sym"], device="cpu").withRangeStats(
        colsToSummarize=["px"], rangeBackWindowSecs=600).df
    ref = tempo_tpu.TSDF(df, "event_ts", ["sym"]).withRangeStats(
        colsToSummarize=["px"], rangeBackWindowSecs=600).df
    truth = _oracle_counts(got, 600)
    assert (got["count_px"].to_numpy() == truth).all()
    assert (ref["count_px"].to_numpy() == truth).all()
    np.testing.assert_allclose(got["sum_px"].to_numpy(),
                               ref["sum_px"].to_numpy(), rtol=1e-5)


def test_past_the_pad_key_the_reference_is_wrong_and_the_port_raises():
    df = _wide(up_to_limit=False)
    ref = tempo_tpu.TSDF(df, "event_ts", ["sym"]).withRangeStats(
        colsToSummarize=["px"], rangeBackWindowSecs=600).df
    assert (ref["count_px"].to_numpy() != _oracle_counts(ref, 600)).any()
    with pytest.raises(ValueError, match=r"2\^62 ns"):
        TSDF(df, "event_ts", ["sym"], device="cpu").withRangeStats(
            colsToSummarize=["px"], rangeBackWindowSecs=600)


@pytest.mark.parametrize("column", [
    pd.Series([1, LIMIT_S + 1], dtype=np.int64),
    pd.Series([1.5, LIMIT_S + 0.5]),
    pd.to_datetime(pd.Series(["2024-01-01", "2116-02-21"])),
    pd.to_datetime(pd.Series(["2024-01-01", "2117-01-01"])).dt.tz_localize(
        "UTC"),
])
def test_series_to_ns_refuses_the_pad_key(column):
    with pytest.raises(ValueError, match="pad with"):
        packing.series_to_ns(column)
    # the last representable second before the key passes
    assert packing.series_to_ns(pd.Series([LIMIT_S]))[0] < packing.TS_PAD


def test_standing_push_past_the_pad_key_commits_nothing():
    t = StreamTable("s", "event_ts", ["sym"], ["px"], device="cpu")
    with StandingQueryEngine() as eng:
        eng.register(t.frame().EMA("px", exact=True))
        eng.push(t, _frame(np.asarray([LIMIT_S - 10, LIMIT_S - 5])))
        with pytest.raises(ValueError, match="pad with"):
            eng.push(t, _frame(np.asarray([LIMIT_S - 1, LIMIT_S + 1])))
        assert eng.flush(timeout=120)
        assert t.rows_total() == 2
