"""The fourth slice at frame level, chained as a user would: a sequence
column from ordering columns, a SQL filter and its describe table,
``withRangeStats`` under ``TEMPO_TPU_WINDOW_ENGINE=legacy`` (the legacy
kernel's plain version) and grouped stats of its output; and a SQL
projection into vwap, lookback features and autocorrelation.  The port
(``device="cpu"``, float64) against ``tempo_tpu.TSDF`` (JAX on the CPU,
float64, its shifted pick running the legacy XLA form) on the same
pandas inputs.

Keys, timestamps, counts and the describe table are equal; the other
values agree within rtol = atol = 1e-12 (float64 sums taken in other
orders: the row centre, ``index_add_``).
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch.ops import stats

from tests.test_torch_longtail import _assert_frames, _trades


@pytest.fixture(autouse=True)
def _legacy_engine(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_WINDOW_ENGINE", "legacy")
    monkeypatch.setenv("TEMPO_TPU_SORT_KERNELS", "1")
    monkeypatch.setenv("TEMPO_TPU_BINPACK", "0")


def _stats_chain(tsdf_cls, df, **dev):
    t = tsdf_cls.fromOrderingColumns(df, "event_ts", ["event_ts", "volume"],
                                     ["symbol"], **dev)
    filtered = t.filter("x IS NOT NULL OR price > 100.5")
    t = filtered.withRangeStats(colsToSummarize=["x", "price"],
                                rangeBackWindowSecs=900)
    grouped = t.withGroupedStats(metricCols=["mean_x", "price"],
                                 freq="1 hour")
    return filtered.describe(), t, grouped


@pytest.mark.parametrize("seed", [11, 12])
def test_stats_chain_matches_reference(monkeypatch, seed):
    df = _trades(seed, n_keys=5)
    want_d, want_t, want = _stats_chain(tempo_tpu.TSDF, df)
    calls = []
    real = stats.legacy_stats_plain
    monkeypatch.setattr(stats, "legacy_stats_plain",
                        lambda *a: calls.append(a) or real(*a))
    got_d, got_t, got = _stats_chain(PortTSDF, df, device="cpu")
    assert len(calls) == 1 and calls[0][1].shape[0] == 2
    assert got_t.sequence_col == "sequence_num"
    _assert_frames(got_t.df, want_t.df,
                   exact=("count_x", "count_price", "sequence_num"))
    _assert_frames(got.df, want.df)
    pd.testing.assert_frame_equal(got_d, want_d)


def _trade_chain(tsdf_cls, df, **dev):
    t = tsdf_cls(df, "event_ts", ["symbol"], **dev)
    t = t.selectExpr("symbol", "event_ts", "price",
                     "CAST(volume AS int) AS volume", "x * 2 AS x2")
    bars = t.vwap("H", volume_col="volume", price_col="price")
    feats = t.withLookbackFeatures(["x2", "price"], 3, exactSize=False)
    return bars, feats, bars.autocorr("vwap", 1)


def test_trade_chain_matches_reference():
    df = _trades(13, n_keys=5)
    want_bars, want_feats, want_ac = _trade_chain(tempo_tpu.TSDF, df)
    got_bars, got_feats, got_ac = _trade_chain(PortTSDF, df, device="cpu")
    _assert_frames(got_bars.df, want_bars.df)
    _assert_frames(got_feats.df.drop(columns=["features"]),
                   want_feats.df.drop(columns=["features"]))
    for g, w in zip(got_feats.df["features"], want_feats.df["features"]):
        np.testing.assert_array_equal(np.asarray(g, float),
                                      np.asarray(w, float))
    assert len(got_ac) > 0
    _assert_frames(got_ac, want_ac)
