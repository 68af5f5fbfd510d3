"""The plain reference on small hand-checked cases, and against the
port's own plain versions (float64 on the CPU) on generated data."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from gpubench import harness
from gpubench.compare import compare
from gpubench.reference.chain import chain, ema, to_bf16

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

CFG = {"partition_col": "k", "ts_col": "ts",
       "chain": {"right_prefix": "r", "stats_col": "x", "window_secs": 2,
                 "ema_col": "x", "exp_factor": 0.5}}
S = 1_000_000_000


def _ts(ns):
    return pd.to_datetime(np.asarray(ns, dtype=np.int64))


def test_asof_ties_and_nulls():
    left = pd.DataFrame({"k": ["a"] * 4, "ts": _ts([1, 5, 5, 9]),
                         "x": [1.0, 2.0, 3.0, 4.0]})
    right = pd.DataFrame({"k": ["a"] * 5,
                          "ts": _ts([2, 5, 5, 8, 9]),
                          "v": [10.0, 20.0, 21.0, np.nan, 40.0]})
    out = chain(left, right, CFG)
    # ts 1: no right row yet; ts 5: the right rows tied at 5 count, the
    # last in input order wins; ts 9: the right row at 9 counts
    assert np.isnan(out["r_v"][0])
    assert out["r_v"].tolist()[1:] == [21.0, 21.0, 40.0]
    assert out["r_ts"].isna().tolist() == [True, False, False, False]
    assert out["r_ts"].iloc[1] == _ts([5])[0]


def test_skip_nulls_takes_last_valid():
    left = pd.DataFrame({"k": ["a"], "ts": _ts([10]), "x": [1.0]})
    right = pd.DataFrame({"k": ["a", "a", "b"], "ts": _ts([1, 2, 1]),
                          "v": [7.0, np.nan, 9.0]})
    out = chain(left, right, CFG)
    assert out["r_v"].tolist() == [7.0]
    assert out["r_ts"].iloc[0] == _ts([2])[0]


def test_range_window_ties_and_boundary():
    # whole seconds 0, 0, 1, 2, 3, 5 with a 2 s window: a frame takes
    # [s - 2, s] and every row of its own second, following ties too
    secs = [0.1, 0.9, 1.5, 2.0, 3.2, 5.0]
    left = pd.DataFrame({"k": ["a"] * 6,
                         "ts": _ts([int(s * S) for s in secs]),
                         "x": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    right = pd.DataFrame({"k": ["a"], "ts": _ts([0]), "v": [0.0]})
    out = chain(left, right, CFG)
    assert out["count_x"].tolist() == [2, 2, 3, 4, 3, 2]
    assert out["sum_x"].tolist() == [3.0, 3.0, 6.0, 10.0, 12.0, 11.0]
    assert out["min_x"].tolist() == [1.0, 1.0, 1.0, 1.0, 3.0, 5.0]
    assert out["max_x"].tolist() == [2.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    np.testing.assert_allclose(out["mean_x"], [1.5, 1.5, 2.0, 2.5, 4.0, 5.5])
    np.testing.assert_allclose(out["stddev_x"].iloc[2], 1.0)
    np.testing.assert_allclose(out["zscore_x"].iloc[2], 1.0)


def test_ema_exact_and_null_carry():
    x = np.array([2.0, np.nan, 4.0, 0.0])
    y = ema(np.nan_to_num(x), ~np.isnan(x), np.zeros(4, np.int64), 0.5, 1)
    assert y.tolist() == [1.0, 1.0, 2.5, 1.25]


def test_bf16_rounding():
    v = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-9, np.nan], np.float64)
    r = to_bf16(v)
    # 1 + 2^-8 lies halfway between 1 and the next bfloat16, 1 + 2^-7:
    # ties go to the even one
    assert r[0] == 1.0 and r[1] == 1.0
    assert r[2] == 1.0 + 2**-7 and np.isnan(r[3])


@pytest.mark.parametrize("name,scale", [("hhar_quickstart", 0.001),
                                        ("hhar_quickstart", 0.0003)])
def test_reference_equals_port_plain_versions(name, scale):
    """The port's CPU plain versions in float64 are the same semantics:
    every exact column equal, the float ones to float64 rounding."""
    from tempo_tpu_torch import TSDF

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    left, right = harness.generator(cfg["generator"]).make(cfg, 99, scale)
    ch, k, ts = cfg["chain"], [cfg["partition_col"]], cfg["ts_col"]
    got = (TSDF(left, ts, k, device="cpu")
           .asofJoin(TSDF(right, ts, k, device="cpu"),
                     right_prefix=ch["right_prefix"])
           .withRangeStats(colsToSummarize=[ch["stats_col"]],
                           rangeBackWindowSecs=ch["window_secs"])
           .EMA(ch["ema_col"], exp_factor=ch["exp_factor"], exact=True).df)
    ref = chain(left, right, cfg)
    n = compare(got, ref, cfg)
    assert n["rows_bad"] == 0
    assert n["stats_err"] < 1e-9 and n["ema_err"] < 1e-12


def test_zscore_of_a_window_flat_in_float32_is_not_held():
    """Two values one float32 apart at most have a float64 stddev and a
    float32 zscore of 0/0; the comparison lets that null pass, and no
    other."""
    cfg = dict(CFG, chain=dict(CFG["chain"], window_secs=0))
    left = pd.DataFrame({"k": ["a"] * 3,
                         "ts": _ts([0, 1, 5 * S]),
                         "x": [55.0, 55.0 + 1e-6, 54.0]})
    right = pd.DataFrame({"k": ["a"], "ts": _ts([0]), "v": [1.0]})
    ref = chain(left, right, cfg)
    assert np.isfinite(ref["zscore_x"].iloc[0])
    got = ref.copy()
    got.loc[:1, "zscore_x"] = np.nan
    assert compare(got, ref, cfg)["rows_bad"] == 0
    got.loc[2, "mean_x"] = np.nan
    assert compare(got, ref, cfg)["rows_bad"] == 1
