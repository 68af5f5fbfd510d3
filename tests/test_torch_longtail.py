"""The long tail of the single-device frame: grouped stats, vwap,
lookback features, the Fourier transform, autocorrelation and describe,
the port (``device="cpu"``, float64, plain versions) against
``tempo_tpu.TSDF`` (JAX on the CPU, float64) on seeded frames with
nulls.

Keys, timestamps, counts, lookback windows and the describe table (a
table of strings) are equal.  Grouped sums and their moments agree
within rtol = atol = 1e-12 (``index_add_`` and XLA's segment sum add in
their own orders).  The Fourier transform of a series without nulls
agrees with the reference's numpy path within 1e-9 (torch's and numpy's
FFTs factor the lengths their own ways), autocorrelation within 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
from tempo_tpu_torch import TSDF as PortTSDF

T = 1_000_000_000
TOL = dict(rtol=1e-12, atol=1e-12)


def _trades(seed=0, n_keys=4, partitioned=True):
    """Trades-shaped rows over a few hours, ties included: a float with
    nulls, prices (a few null) and integer volumes, shuffled."""
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(n_keys):
        n = int(rng.integers(40, 90))
        secs = np.cumsum(rng.integers(0, 400, n))
        parts.append(pd.DataFrame({
            "symbol": f"s{k}",
            "event_ts": pd.to_datetime((1_600_000_000 + secs) * T),
            "x": np.where(rng.random(n) > 0.15, rng.standard_normal(n),
                          np.nan),
            "price": np.where(rng.random(n) > 0.05,
                              100 + np.abs(rng.standard_normal(n)), np.nan),
            "volume": rng.integers(1, 1000, n).astype(np.float64),
        }))
    df = pd.concat(parts, ignore_index=True).sample(frac=1.0,
                                                    random_state=seed)
    df = df.reset_index(drop=True)
    if not partitioned:
        df = df[df["symbol"] == "s0"].drop(columns=["symbol"])
    return df


def _both(df, partition_cols=("symbol",)):
    pcols = list(partition_cols)
    return (tempo_tpu.TSDF(df, "event_ts", pcols),
            PortTSDF(df, "event_ts", pcols, device="cpu"))


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame, exact=()):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if c in exact or not pd.api.types.is_float_dtype(want[c].dtype):
            pd.testing.assert_series_equal(got[c], want[c], check_dtype=False)
        else:
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64),
                                       equal_nan=True, err_msg=c, **TOL)


@pytest.mark.parametrize("freq", ["1 sec", "1 min", "1 hour"])
def test_grouped_stats_match_reference(freq):
    ref, port = _both(_trades(1))
    want = ref.withGroupedStats(freq=freq).df
    got = port.withGroupedStats(freq=freq).df
    _assert_frames(got, want, exact=("count_x", "count_price"))
    assert len(got) < len(port.df) or freq == "1 sec"


@pytest.mark.parametrize("frequency", ["m", "H", "D"])
def test_vwap_matches_reference(frequency):
    ref, port = _both(_trades(2))
    _assert_frames(port.vwap(frequency).df, ref.vwap(frequency).df)


def test_vwap_rejects_other_frequencies():
    _, port = _both(_trades(2))
    with pytest.raises(ValueError, match="'m', 'H', 'D'"):
        port.vwap("S")


def _assert_feature_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float64),
                                      np.asarray(w, np.float64))


@pytest.mark.parametrize("exact_size", [True, False])
def test_lookback_features_match_reference(exact_size):
    ref, port = _both(_trades(3))
    want = ref.withLookbackFeatures(["x", "price"], 4, exactSize=exact_size)
    got = port.withLookbackFeatures(["x", "price"], 4, exactSize=exact_size)
    # exactSize=True returns a bare DataFrame (reference quirk)
    assert isinstance(got, pd.DataFrame) == exact_size
    gdf, wdf = (got, want) if exact_size else (got.df, want.df)
    _assert_frames(gdf.drop(columns=["features"]),
                   wdf.drop(columns=["features"]))
    _assert_feature_lists(gdf["features"], wdf["features"])


def test_lookback_tensor_matches_reference():
    ref, port = _both(_trades(4))
    want_x, want_m = ref.lookbackTensor(["x", "volume"], 5)
    got_x, got_m = port.lookbackTensor(["x", "volume"], 5)
    assert isinstance(got_x, torch.Tensor) and got_x.device.type == "cpu"
    assert tuple(got_x.shape) == tuple(want_x.shape)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("col,timestep", [("price", 1.0), ("volume", 0.5)])
def test_fourier_transform_matches_reference(col, timestep):
    """Series of many lengths.  A null makes its series' transform
    undefined: NaN in a pattern that depends on the FFT's factorisation
    (numpy's and torch's differ), so those series are held only to a NaN
    sum at frequency 0, the others to 1e-9."""
    df = _trades(5, n_keys=6)
    ref, port = _both(df)
    want = ref.fourier_transform(timestep, col.upper()).df
    got = port.fourier_transform(timestep, col.upper()).df
    assert list(got.columns) == ["symbol", "event_ts", col, "freq",
                                 "ft_real", "ft_imag"]
    _assert_frames(got.drop(columns=["ft_real", "ft_imag"]),
                   want.drop(columns=["ft_real", "ft_imag"]),
                   exact=("freq",))
    nulls = got.groupby("symbol")[col].transform(lambda v: v.isna().any())
    assert nulls.any() == (col == "price")
    dc = nulls & (got["freq"] == 0.0)
    assert got.loc[dc, "ft_real"].isna().all()
    assert want.loc[dc, "ft_real"].isna().all()
    for c in ("ft_real", "ft_imag"):
        np.testing.assert_allclose(got.loc[~nulls, c].to_numpy(),
                                   want.loc[~nulls, c].to_numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=c)
    with pytest.raises(ValueError, match="not found"):
        port.fourier_transform(1.0, "nope")


@pytest.mark.parametrize("lag", [1, 3, 200])
def test_autocorr_matches_reference(lag):
    ref, port = _both(_trades(6))
    want = ref.autocorr("x", lag)
    got = port.autocorr("x", lag)
    assert isinstance(got, pd.DataFrame)
    _assert_frames(got, want)
    if lag == 200:
        assert len(got) == 0


def test_autocorr_without_partition_columns_matches_reference():
    df = _trades(7, partitioned=False)
    ref, port = _both(df, partition_cols=())
    want, got = ref.autocorr("price", 2), port.autocorr("price", 2)
    assert list(got.columns) == ["_dummy_group_col", "autocorr_lag_2"]
    _assert_frames(got, want)


@pytest.mark.parametrize("partitioned", [True, False])
def test_describe_matches_reference(partitioned):
    df = _trades(8, partitioned=partitioned)
    ref, port = _both(df, ("symbol",) if partitioned else ())
    pd.testing.assert_frame_equal(port.describe(), ref.describe())
