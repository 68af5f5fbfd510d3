"""The port's series-sharded ``DistributedTSDF`` against the reference's.

The same seeded pandas frames go through ``tempo_tpu`` (JAX on the CPU,
``on_mesh(make_mesh({"series": 4}))`` over the forced 8-device host) and
``tempo_tpu_torch`` (``device="cpu"``, float64, ``on_mesh`` over
``make_mesh({"series": 4}, devices=["cpu"] * 4)``: four shards on one
device, so the shard logic runs in full).

Tolerances: keys, timestamps, counts, selections (joined values, fills,
floor/ceil picks, flags) and host columns are equal.  Other values agree
within rtol = atol = 1e-9, the reference's own mesh tolerance
(tests/test_dist_frame.py): on the CPU the reference computes range and
bucket statistics by prefix sums over searchsorted bounds
(``windowed_stats``), the port by its kernels' plain versions (the
row-bounded sweep and the segmented bucket ladder), float64 sums taken
in other orders (``stddev`` compared as the variance and ``zscore``
times each side's ``stddev``, as ``x - mean``).  ``describe`` reduces partials a shard and the
reference globally (1e-9 on the parsed numbers); the FFT is cuFFT's /
pocketfft's against the reference's Bluestein DFT (1e-9 * ||x||_2 a
series).  One shard and four shards agree bitwise: every op but the
join's row gather is series-local.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
from tempo_tpu.parallel import make_mesh as jax_mesh
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch import dist, make_mesh
from tempo_tpu_torch.ops import bucket
from tempo_tpu_torch.parallel import Mesh, pad_series_axis, shard_map

RTOL = ATOL = 1e-9
NS = 1_000_000_000


def _frames_df(seed=7, n=400, m=300):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({
        "symbol": rng.choice(["a", "b", "c", "d", "f"], size=n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 900, size=n))
                                   * NS),
        "price": rng.standard_normal(n) + 100,
        "volume": rng.integers(1, 100, size=n),
        "note": [f"n{i % 5}" for i in range(n)],     # host-resident col
    })
    left.loc[rng.random(n) < 0.1, "price"] = np.nan
    right = pd.DataFrame({
        "symbol": rng.choice(["a", "b", "c", "e"], size=m),  # e: right-only
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 900, size=m))
                                   * NS),
        "bid": np.where(rng.random(m) > 0.2, rng.standard_normal(m) + 99,
                        np.nan),
        "ask": rng.standard_normal(m) + 101,
        "venue": np.where(rng.random(m) > 0.3,
                          rng.choice(["x", "y"], size=m), None),
        "seq": rng.integers(0, 4, size=m).astype(float),
    })
    right.loc[rng.random(m) < 0.1, "seq"] = np.nan
    return left, right


@pytest.fixture(scope="module")
def frames():
    left, right = _frames_df()
    ref = dict(l=tempo_tpu.TSDF(left, "event_ts", ["symbol"]),
               r=tempo_tpu.TSDF(right.drop(columns="seq"), "event_ts",
                                ["symbol"]),
               rs=tempo_tpu.TSDF(right, "event_ts", ["symbol"],
                                 sequence_col="seq"))
    port = dict(l=PortTSDF(left, "event_ts", ["symbol"], device="cpu"),
                r=PortTSDF(right.drop(columns="seq"), "event_ts",
                           ["symbol"], device="cpu"),
                rs=PortTSDF(right, "event_ts", ["symbol"],
                            sequence_col="seq", device="cpu"))
    return ref, port


@pytest.fixture(scope="module")
def meshes():
    return (jax_mesh({"series": 4}),
            make_mesh({"series": 4}, devices=["cpu"] * 4))


def _on(frames, mesh):
    return {k: t.on_mesh(mesh) for k, t in frames.items()}


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        if c.startswith("zscore_"):
            # as x - mean: where a window's stddev is near 0 the quotient
            # amplifies the sums' last-bit differences (stddev is held
            # on its own)
            std = "stddev_" + c[len("zscore_"):]
            g, w = g * got[std], w * want[std]
        elif c.startswith("stddev_"):
            # as the variance: where it is near 0 the square root
            # amplifies float64 cancellation in s2 - s1*s1/n (a bucket of
            # equal values: exactly 0 in the port's ladder, 2e-13 in the
            # reference's prefix-sum differences)
            g, w = g * g, w * w
        if pd.api.types.is_float_dtype(w.dtype) \
                and not c.startswith(("count", "is_")):
            np.testing.assert_allclose(g.to_numpy(float), w.to_numpy(float),
                                       rtol=RTOL, atol=ATOL, equal_nan=True,
                                       err_msg=c)
        else:
            pd.testing.assert_series_equal(g, w, check_dtype=False,
                                           obj=c)


# name -> op on the dict of mesh frames (l, r, rs), returning a mesh frame
OPS = {
    "withRangeStats": lambda d: d["l"].withRangeStats(
        colsToSummarize=["price", "volume"], rangeBackWindowSecs=30),
    "withRangeStats_halo": lambda d: d["l"].withRangeStats(
        colsToSummarize=["price"], rangeBackWindowSecs=45, strategy="halo"),
    "EMA_exact": lambda d: d["l"].EMA("price", exact=True),
    "EMA_compat": lambda d: d["l"].EMA("price", window=7,
                                       inclusive_window=True),
    "asofJoin": lambda d: d["l"].asofJoin(d["r"]),
    "asofJoin_skipNulls_false": lambda d: d["l"].asofJoin(
        d["r"], skipNulls=False),
    "asofJoin_seq": lambda d: d["l"].asofJoin(d["rs"], right_prefix="q"),
    "asofJoin_maxLookback": lambda d: d["l"].asofJoin(d["r"], maxLookback=3),
    "asofJoin_resampled_right_maxLookback": lambda d: d["l"].asofJoin(
        d["r"].resample("1 minute", "mean"), maxLookback=2),
    "asofJoin_chained": lambda d: d["l"].asofJoin(
        d["r"].asofJoin(d["rs"], right_prefix="s"), left_prefix="L"),
    "withGroupedStats": lambda d: d["l"].withGroupedStats(
        metricCols=["price", "volume"], freq="1 minute"),
    "vwap": lambda d: d["l"].vwap("m"),
    "resample_floor": lambda d: d["r"].resample("1 minute", "floor"),
    "resample_ceil": lambda d: d["r"].resample("1 minute", "ceil"),
    "resample_mean": lambda d: d["r"].resample("1 minute", "mean"),
    "resample_min": lambda d: d["r"].resample("1 minute", "min"),
    "resample_max": lambda d: d["r"].resample("1 minute", "max"),
    "resample_chained": lambda d: d["r"].resample("30 seconds", "mean")
    .resample("2 minutes", "ceil"),
    "calc_bars_fill": lambda d: d["l"].calc_bars("1 minute",
                                                 metricCols=["price"],
                                                 fill=True),
    "interpolate_zero": lambda d: d["l"].interpolate(
        freq="30 seconds", func="mean", method="zero",
        target_cols=["price"], show_interpolated=True),
    "interpolate_null": lambda d: d["l"].interpolate(
        freq="30 seconds", func="floor", method="null",
        target_cols=["price"]),
    "interpolate_ffill": lambda d: d["r"].resample("30 seconds", "max")
    .interpolate(method="ffill", show_interpolated=True),
    "interpolate_bfill": lambda d: d["r"].interpolate(
        freq="30 seconds", func="min", method="bfill"),
    "interpolate_linear": lambda d: d["r"].resample("30 seconds", "mean")
    .interpolate(method="linear", show_interpolated=True),
    "fourier_transform": lambda d: d["r"].fourier_transform(1, "ask"),
    "chain": lambda d: d["l"].asofJoin(d["r"])
    .withRangeStats(colsToSummarize=["price", "right_ask"],
                    rangeBackWindowSecs=60)
    .EMA("price", exact=True)
    .withGroupedStats(metricCols=["EMA_price", "right_bid"],
                      freq="2 minutes"),
}


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_reference(frames, meshes, name):
    ref, port = frames
    jm, pm = meshes
    op = OPS[name]
    want = op(_on(ref, jm)).collect().df
    got = op(_on(port, pm)).collect().df
    _assert_frames(got, want)


def test_describe_autocorr_lookback_tensor(frames, meshes):
    ref, port = frames
    jm, pm = meshes
    jl, pl = ref["l"].on_mesh(jm), port["l"].on_mesh(pm)
    want, got = jl.describe(), pl.describe()
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        for g, w in zip(got[c], want[c]):
            try:
                gf, wf = float(g), float(w)
            except (TypeError, ValueError):
                assert g == w, (c, g, w)
            else:
                np.testing.assert_allclose(gf, wf, rtol=RTOL, atol=ATOL,
                                           err_msg=c)
    for lag in (1, 3, 10_000):
        _assert_frames(pl.autocorr("price", lag), jl.autocorr("price", lag))
    res = pl.withGroupedStats(freq="1 minute")
    _assert_frames(res.autocorr("mean_price", 2),
                   jl.withGroupedStats(freq="1 minute").autocorr(
                       "mean_price", 2))
    vals, mask = pl.lookback_tensor(["price", "volume"], 4)
    jv, jmask = jl.lookback_tensor(["price", "volume"], 4)
    # one [K_dev, L, w, F] pair, indexed as the reference's own test does
    K = pl.layout.n_series
    assert vals.shape == mask.shape == np.asarray(jv).shape
    assert vals.shape[0] == sum(int(t.shape[0]) for t in pl.ts)
    assert torch.equal(mask[:K], torch.from_numpy(np.array(jmask)[:K]))
    torch.testing.assert_close(vals, torch.from_numpy(np.array(jv)),
                               rtol=0, atol=0, equal_nan=True)
    feats = pl.withLookbackFeatures(["price"], 3, exactSize=False).df
    want = jl.withLookbackFeatures(["price"], 3, exactSize=False).df
    _assert_frames(feats.drop(columns="features"),
                   want.drop(columns="features"))
    for g, w in zip(feats["features"], want["features"]):
        np.testing.assert_array_equal(np.asarray(g, float),
                                      np.asarray(w, float))


def test_fourier_matches_reference_within_norm(frames, meshes):
    ref, port = frames
    jm, pm = meshes
    want = ref["r"].on_mesh(jm).fourier_transform(1, "ask").collect().df
    got = port["r"].on_mesh(pm).fourier_transform(1, "ask").collect().df
    for sym, w in want.groupby("symbol"):
        g = got[got["symbol"] == sym]
        tol = 1e-9 * float(np.linalg.norm(w["ask"]))
        for c in ("ft_real", "ft_imag"):
            np.testing.assert_allclose(g[c].to_numpy(), w[c].to_numpy(),
                                       rtol=0, atol=tol, err_msg=c)
        np.testing.assert_array_equal(g["freq"].to_numpy(),
                                      w["freq"].to_numpy())


def test_one_and_four_shards_bitwise(frames):
    _, port = frames
    outs = []
    for n in (1, 4):
        d = _on(port, make_mesh({"series": n}, devices=["cpu"] * n))
        chain = d["l"].asofJoin(d["r"], skipNulls=False).withRangeStats(
            colsToSummarize=["price"], rangeBackWindowSecs=20).EMA(
            "price", exact=True)
        outs.append([
            chain.withGroupedStats(metricCols=["price", "right_ask"],
                                   freq="1 minute").collect().df,
            chain.resample("1 minute", "mean").interpolate(
                method="linear").collect().df,
            d["l"].vwap("m").collect().df,
            chain.collect().df,
        ])
    for one, four in zip(*outs):
        pd.testing.assert_frame_equal(one, four, check_exact=True)


def test_chain_packs_once_a_side_and_fetches_once(frames, meshes):
    _, port = frames
    _, pm = meshes
    p0, f0 = dist._PACK_EVENTS, dist._FETCH_EVENTS
    left, right = port["l"].on_mesh(pm), port["r"].on_mesh(pm)
    out = (left.asofJoin(right)
           .withRangeStats(colsToSummarize=["price"], rangeBackWindowSecs=10)
           .EMA("price", exact=True)
           .withGroupedStats(metricCols=["price", "right_bid", "EMA_price"],
                             freq="1 minute")
           .collect())
    assert (dist._PACK_EVENTS - p0, dist._FETCH_EVENTS - f0) == (2, 1)
    assert out.device == torch.device("cpu") and out.dtype == torch.float64
    assert out.count() == sum(len(g) for g in [out.df])


def test_time_axis_and_meshes(frames):
    _, port = frames
    two = make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    series = make_mesh({"series": 2}, devices=["cpu"] * 2)
    d2 = port["l"].on_mesh(two, time_axis="time")
    # a [K_dev/2, L/2] block a device, K a multiple of 4, L of 16
    assert (d2.n_time, len(d2.ts), d2.K_dev % 4, d2.L % 16) == (2, 4, 0, 0)
    assert tuple(d2.ts[0].shape) == (d2.K_dev // 2, d2.L // 2)
    pd.testing.assert_frame_equal(d2.collect().df,
                                  port["l"].on_mesh(series).collect().df)
    stats = dict(colsToSummarize=["price"], rangeBackWindowSecs=30)
    pd.testing.assert_frame_equal(
        d2.withRangeStats(**stats).collect().df,
        port["l"].on_mesh(series).withRangeStats(**stats).collect().df)
    flat = make_mesh({"series": 2, "time": 1}, devices=["cpu"] * 2)
    got = port["l"].on_mesh(flat, time_axis="time").EMA(
        "price", exact=True).collect().df
    want = port["l"].on_mesh(make_mesh({"series": 2}, devices=["cpu"] * 2))
    pd.testing.assert_frame_equal(got, want.EMA("price", exact=True)
                                  .collect().df)
    other = port["r"].on_mesh(make_mesh({"series": 2}, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="same mesh"):
        port["l"].on_mesh(make_mesh({"series": 4},
                                    devices=["cpu"] * 4)).asofJoin(other)
    # a default one-shard mesh over the frame's device
    d = port["l"].on_mesh()
    assert d.mesh.shape == {"series": 1} and d.K_dev == 5
    assert "DistributedTSDF" in repr(d) and d.count() == 400


def test_mesh_helpers():
    m = make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    assert m.shape == {"series": 2, "time": 2}
    assert m == make_mesh({"series": 2, "time": 2}, devices=["cpu"] * 4)
    assert m != make_mesh({"series": 4}, devices=["cpu"] * 4)
    assert m.axis_devices("series") == [torch.device("cpu")] * 2
    assert isinstance(m, Mesh)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh({"series": 4}, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    a = np.arange(6).reshape(3, 2)
    p = pad_series_axis(a, 4, -1)
    assert p.shape == (4, 2) and (p[3] == -1).all()
    assert pad_series_axis(a, 3, -1) is a
    seen = shard_map(lambda x, y: x + y, make_mesh(
        {"series": 2}, devices=["cpu"] * 2), [1, 2], [10, 20])
    assert seen == [11, 22]


def test_grouped_stats_run_the_bucket_kernel_path(frames, meshes,
                                                  monkeypatch):
    """The mesh frame's bucket reductions go through
    ``ops/bucket.bucket_stats`` (the plain version on the CPU), never the
    windowed prefix-sum form the reference takes off the TPU."""
    _, port = frames
    _, pm = meshes
    calls = []
    real = bucket.bucket_stats_plain
    monkeypatch.setattr(bucket, "bucket_stats_plain",
                        lambda *a: calls.append(a) or real(*a))
    port["l"].on_mesh(pm).withGroupedStats(metricCols=["price", "volume"],
                                           freq="1 minute").collect()
    assert len(calls) == 4 and all(c[1].shape[0] == 2 for c in calls)
