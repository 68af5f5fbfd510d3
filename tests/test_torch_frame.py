"""The frame chain TSDF -> asofJoin -> withRangeStats -> EMA of the port
(``device="cpu"``, float64, the kernels' plain versions) against
``tempo_tpu.TSDF`` (JAX on the CPU, float64) on the same pandas inputs.

Joined columns are selections: equal, nulls included.  ``count`` is an
integer count: equal.  The other statistics and the EMA agree within
rtol = atol = 1e-9: the reference's CPU path takes the windowed
prefix-sum engine and an associative-scan EMA, the port the shifted
sweep and the Hillis-Steele ladder, so float64 sums associate
differently.
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu_torch import TSDF as PortTSDF

T = 1_000_000_000
JOINED = ("event_ts", "sym", "x", "right_v", "right_w", "right_event_ts")
STAT_COLS = ["mean_x", "count_x", "min_x", "max_x", "sum_x", "stddev_x",
             "zscore_x", "EMA_x"]


def _frames(seed, zipf: bool, with_seq: bool):
    rng = np.random.default_rng(seed)
    n_keys = 24 if zipf else 4
    if zipf:
        lens = np.maximum((300 / np.arange(1, n_keys + 1) ** 1.2).astype(int), 2)
    else:
        lens = rng.integers(60, 90, n_keys)
    left, right = [], []
    for k, n in enumerate(lens):
        secs = np.cumsum(rng.integers(0, 3, n))       # ties included
        left.append(pd.DataFrame({
            "sym": f"k{k}", "event_ts": pd.to_datetime(secs * T),
            "x": np.where(rng.random(n) > 0.1, rng.standard_normal(n),
                          np.nan)}))
        nr = max(1, int(n * rng.uniform(0.6, 1.2)))
        rsecs = np.sort(rng.integers(-2, int(secs[-1]) + 2, nr))
        right.append(pd.DataFrame({
            "sym": f"k{k}", "event_ts": pd.to_datetime(rsecs * T),
            "v": np.where(rng.random(nr) > 0.3, rng.standard_normal(nr),
                          np.nan),
            "w": rng.standard_normal(nr),
            "seq": np.where(rng.random(nr) > 0.2,
                            rng.integers(0, 4, nr).astype(float), np.nan)}))
    left = pd.concat(left, ignore_index=True).sample(frac=1.0, random_state=seed)
    right = pd.concat(right, ignore_index=True).sample(frac=1.0,
                                                       random_state=seed)
    if not with_seq:
        right = right.drop(columns=["seq"])
    return left, right


def _chain(tsdf_cls, left, right, with_seq, skip_nulls, **kw):
    lt = tsdf_cls(left, "event_ts", ["sym"], **kw)
    rt = tsdf_cls(right, "event_ts", ["sym"],
                  sequence_col="seq" if with_seq else None, **kw)
    out = (lt.asofJoin(rt, skipNulls=skip_nulls)
           .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
           .EMA("x", exact=True))
    return out.df.sort_values(["sym", "event_ts"], kind="stable") \
        .reset_index(drop=True)


@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("zipf,with_seq", [
    (False, False), (False, True), (True, False), (True, True),
])
def test_frame_chain_matches_reference(monkeypatch, zipf, with_seq,
                                       skip_nulls):
    # both packages read the same knob: force the layout under test
    monkeypatch.setenv("TEMPO_TPU_BINPACK", "1" if zipf else "0")
    left, right = _frames(3 + zipf + 2 * with_seq, zipf, with_seq)
    want = _chain(tempo_tpu.TSDF, left, right, with_seq, skip_nulls)
    got = _chain(PortTSDF, left, right, with_seq, skip_nulls, device="cpu")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in JOINED:
        pd.testing.assert_series_equal(got[c], want[c], check_dtype=False)
    np.testing.assert_array_equal(got["count_x"].to_numpy(),
                                  want["count_x"].to_numpy())
    for c in STAT_COLS:
        np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                   want[c].to_numpy(np.float64), rtol=1e-9,
                                   atol=1e-9, equal_nan=True, err_msg=c)


@pytest.mark.parametrize("variant,kw,env", [
    ("skew_brackets", dict(tsPartitionVal=10, fraction=0.5), {}),
    ("broadcast", dict(sql_join_opt=True), {}),
    ("max_lookback_dense", dict(maxLookback=3), {"TEMPO_TPU_BINPACK": "0"}),
    ("max_lookback_binpacked", dict(maxLookback=3),
     {"TEMPO_TPU_BINPACK": "1"}),
    ("bracket_engine", {}, {"TEMPO_TPU_JOIN_ENGINE": "bracket",
                            "TEMPO_TPU_BINPACK": "0"}),
    ("chunked_engine_on_cpu", {}, {"TEMPO_TPU_JOIN_ENGINE": "chunked",
                                   "TEMPO_TPU_BINPACK": "0"}),
])
def test_join_variants_match_reference(monkeypatch, variant, kw, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    left, right = _frames(17, zipf=True, with_seq=False)

    def run(tsdf_cls, **dev):
        lt = tsdf_cls(left, "event_ts", ["sym"], **dev)
        rt = tsdf_cls(right, "event_ts", ["sym"], **dev)
        out = lt.asofJoin(rt, **kw).df
        return out.sort_values(["sym", "event_ts"], kind="stable") \
            .reset_index(drop=True)

    want = run(tempo_tpu.TSDF)
    got = run(PortTSDF, device="cpu")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in JOINED:
        pd.testing.assert_series_equal(got[c], want[c], check_dtype=False)


@pytest.mark.parametrize("env", [
    {"TEMPO_TPU_WINDOW_ENGINE": "windowed"},
    {"TEMPO_TPU_WINDOW_ENGINE": "stream"},
    {"TEMPO_TPU_STREAM_MAX_ROWS": "1"},      # cut over to the windowed form
], ids=["forced_windowed", "forced_stream", "past_stream_max_rows"])
def test_range_engines_match_reference(monkeypatch, env):
    monkeypatch.setenv("TEMPO_TPU_BINPACK", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    left, _ = _frames(11, zipf=False, with_seq=False)

    def run(tsdf_cls, **dev):
        out = tsdf_cls(left, "event_ts", ["sym"], **dev).withRangeStats(
            colsToSummarize=["x"], rangeBackWindowSecs=10).df
        return out.sort_values(["sym", "event_ts"], kind="stable") \
            .reset_index(drop=True)

    want = run(tempo_tpu.TSDF)
    got = run(PortTSDF, device="cpu")
    np.testing.assert_array_equal(got["count_x"].to_numpy(),
                                  want["count_x"].to_numpy())
    for c in STAT_COLS[:-1]:
        np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                   want[c].to_numpy(np.float64), rtol=1e-9,
                                   atol=1e-9, equal_nan=True, err_msg=c)
