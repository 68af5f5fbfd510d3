"""The port's ``DistributedTSDF`` on a time axis against the reference's.

The same seeded pandas frames (``test_torch_dist._frames_df``: 400 and
300 rows, the reference fixture's size) go through ``tempo_tpu`` on its
forced 8-device CPU host, ``on_mesh(make_mesh(axes), time_axis="time")``,
and through ``tempo_tpu_torch`` (``device="cpu"``, float64) on
``make_mesh(axes, devices=["cpu"] * 8)``.  This file runs the
``{"series": 2, "time": 4}`` mesh; ``test_torch_time_axis8.py`` runs
the same tests on ``{"series": 1, "time": 8}`` (its ``axes`` fixture).

Tolerances, as ``test_torch_dist.py``'s: keys, timestamps, counts,
selections, flags and host columns equal; other values within
rtol = atol = 1e-9; the truncation audits' counts equal exactly.  The
EMA over time blocks (the port's ladder plus a ``torch.cumprod`` carry
against the reference's associative scan) agrees within
rtol = atol = 1e-12.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
from tempo_tpu.parallel import make_mesh as jax_mesh
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch import dist, make_mesh
from test_torch_dist import _assert_frames, _frames_df

EMA_TOL = 1e-12


@pytest.fixture(scope="module")
def axes():
    return {"series": 2, "time": 4}


@pytest.fixture(scope="module")
def frames():
    left, right = _frames_df()
    venue = np.where(np.arange(len(right)) % 7 == 0, None,
                     np.array([f"v{i % 3}" for i in range(len(right))],
                              object))
    ref = dict(l=tempo_tpu.TSDF(left, "event_ts", ["symbol"]),
               r=tempo_tpu.TSDF(right.drop(columns=["seq", "venue"]),
                                "event_ts", ["symbol"]),
               rv=tempo_tpu.TSDF(right.drop(columns="seq").assign(
                   venue=venue), "event_ts", ["symbol"]),
               rs=tempo_tpu.TSDF(right.drop(columns="venue"), "event_ts",
                                 ["symbol"], sequence_col="seq"))
    port = dict(l=PortTSDF(left, "event_ts", ["symbol"], device="cpu"),
                r=PortTSDF(right.drop(columns=["seq", "venue"]), "event_ts",
                           ["symbol"], device="cpu"),
                rv=PortTSDF(right.drop(columns="seq").assign(venue=venue),
                            "event_ts", ["symbol"], device="cpu"),
                rs=PortTSDF(right.drop(columns="venue"), "event_ts",
                            ["symbol"], sequence_col="seq", device="cpu"))
    return ref, port


@pytest.fixture(scope="module")
def meshes(axes):
    return jax_mesh(axes), make_mesh(axes, devices=["cpu"] * 8)


def _on(frames, mesh, **kw):
    return {k: t.on_mesh(mesh, time_axis="time", **kw)
            for k, t in frames.items()}


def _audits(frame):
    """(message, count) of each halo truncation audit (either package's;
    the row-bound audits of the port's row-bounded engine have no
    counterpart on the reference's CPU engine)."""
    if isinstance(frame, dist.DistributedTSDF):
        pairs = frame.audit_counts()
    else:
        pairs = [(m, int(np.asarray(c))) for m, c in frame.audits]
    return [(m, n) for m, n in pairs if "time-shard halo" in m]


OPS = {
    "withRangeStats": lambda d: d["l"].withRangeStats(
        colsToSummarize=["price", "volume"], rangeBackWindowSecs=30),
    "withRangeStats_halo": lambda d: d["l"].withRangeStats(
        colsToSummarize=["price", "volume"], rangeBackWindowSecs=45,
        strategy="halo"),
    "withRangeStats_halo_wide": lambda d: d["l"].withRangeStats(
        colsToSummarize=["price"], rangeBackWindowSecs=400, strategy="halo"),
    "EMA_exact": lambda d: d["l"].EMA("price", exact=True, exp_factor=0.3),
    "asofJoin": lambda d: d["l"].asofJoin(d["r"]),
    "asofJoin_skipNulls_false": lambda d: d["l"].asofJoin(
        d["r"], skipNulls=False),
    "asofJoin_host_columns": lambda d: d["l"].asofJoin(d["rv"]),
    "asofJoin_host_columns_keep_nulls": lambda d: d["l"].asofJoin(
        d["rv"], skipNulls=False),
    "asofJoin_seq": lambda d: d["l"].asofJoin(d["rs"], right_prefix="q"),
    "asofJoin_maxLookback_1": lambda d: d["l"].asofJoin(d["r"],
                                                        maxLookback=1),
    "asofJoin_maxLookback_3": lambda d: d["l"].asofJoin(d["r"],
                                                        maxLookback=3),
    "asofJoin_resampled_right_maxLookback": lambda d: d["l"].asofJoin(
        d["r"].resample("5 minutes", "mean"), maxLookback=2),
    "asofJoin_resampled_right_keep_nulls": lambda d: d["l"].asofJoin(
        d["r"].resample("5 minutes", "mean"), skipNulls=False),
    "asofJoin_resampled_left_maxLookback": lambda d: d["l"].resample(
        "5 minutes", "mean", metricCols=["price"]).asofJoin(
        d["r"], maxLookback=3),
    "asofJoin_interpolated_right": lambda d: d["l"].asofJoin(
        d["r"].resample("30 seconds", "mean").interpolate(method="ffill")),
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
    "calc_bars": lambda d: d["l"].calc_bars("5 minutes",
                                            metricCols=["price"]),
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
    rd, pd_ = op(_on(ref, jm)), op(_on(port, pm))
    want, got = rd.collect().df, pd_.collect().df
    _assert_frames(got, want)
    for c in want.columns:
        if c.startswith("EMA_"):
            np.testing.assert_allclose(got[c].to_numpy(float),
                                       want[c].to_numpy(float),
                                       rtol=EMA_TOL, atol=EMA_TOL,
                                       equal_nan=True, err_msg=c)
    assert _audits(pd_) == _audits(rd)


def test_describe_autocorr_lookback(frames, meshes):
    ref, port = frames
    jm, pm = meshes
    jl = ref["l"].on_mesh(jm, time_axis="time")
    pl = port["l"].on_mesh(pm, time_axis="time")
    want, got = jl.describe(), pl.describe()
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        for g, w in zip(got[c], want[c]):
            try:
                gf, wf = float(g), float(w)
            except (TypeError, ValueError):
                assert g == w, (c, g, w)
            else:
                np.testing.assert_allclose(gf, wf, rtol=1e-9, atol=1e-9,
                                           err_msg=c)
    for lag in (1, 3, 10_000):
        _assert_frames(pl.autocorr("price", lag), jl.autocorr("price", lag))
    _assert_frames(
        pl.withGroupedStats(freq="1 minute").autocorr("mean_price", 2),
        jl.withGroupedStats(freq="1 minute").autocorr("mean_price", 2))
    vals, mask = pl.lookback_tensor(["price", "volume"], 4)
    jv, jmask = jl.lookback_tensor(["price", "volume"], 4)
    assert vals.shape == np.asarray(jv).shape
    assert torch.equal(mask, torch.from_numpy(np.array(jmask)))
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
    want = ref["r"].on_mesh(jm, time_axis="time").fourier_transform(
        1, "ask").collect().df
    got = port["r"].on_mesh(pm, time_axis="time").fourier_transform(
        1, "ask").collect().df
    assert len(got) == len(want)
    for sym, w in want.groupby("symbol"):
        g = got[got["symbol"] == sym]
        tol = 1e-9 * float(np.linalg.norm(w["ask"]))
        for c in ("ft_real", "ft_imag"):
            np.testing.assert_allclose(g[c].to_numpy(), w[c].to_numpy(),
                                       rtol=0, atol=tol, err_msg=c)
        np.testing.assert_array_equal(g["freq"].to_numpy(),
                                      w["freq"].to_numpy())


def test_chain_packs_once_a_side_and_fetches_once(frames, meshes, axes):
    _, port = frames
    _, pm = meshes
    p0, f0 = dist._PACK_EVENTS, dist._FETCH_EVENTS
    left = port["l"].on_mesh(pm, time_axis="time")
    right = port["r"].on_mesh(pm, time_axis="time")
    assert left.n_time == axes["time"] and len(left.ts) == 8
    out = (left.asofJoin(right)
           .withRangeStats(colsToSummarize=["price"], rangeBackWindowSecs=10)
           .EMA("price", exact=True)
           .withGroupedStats(metricCols=["price", "right_bid", "EMA_price"],
                             freq="1 minute")
           .collect())
    assert (dist._PACK_EVENTS - p0, dist._FETCH_EVENTS - f0) == (2, 1)
    # against the series-only mesh of the port (bitwise on the card, whose
    # kernels order their sums by lane; the CPU's plain versions sum rows
    # of another padded length in another order: within 1e-9)
    series = make_mesh({"series": 2}, devices=["cpu"] * 2)
    want = (port["l"].on_mesh(series).asofJoin(port["r"].on_mesh(series))
            .withRangeStats(colsToSummarize=["price"], rangeBackWindowSecs=10)
            .EMA("price", exact=True)
            .withGroupedStats(metricCols=["price", "right_bid", "EMA_price"],
                              freq="1 minute").collect())
    _assert_frames(out.df, want.df)


def test_truncated_ema_refuses_a_time_axis(frames, meshes):
    _, port = frames
    _, pm = meshes
    with pytest.raises(ValueError, match="exact=True"):
        port["l"].on_mesh(pm, time_axis="time").EMA("price")


class TestHaloStrategy:
    def test_halo_strategy_audits_truncation(self, frames, caplog):
        ref, port = frames
        axes = {"series": 1, "time": 8}
        jd = ref["l"].on_mesh(jax_mesh(axes), time_axis="time",
                              halo_fraction=0.25)
        pdd = port["l"].on_mesh(make_mesh(axes, devices=["cpu"] * 8),
                                time_axis="time", halo_fraction=0.25)
        op = lambda d: d.withRangeStats(colsToSummarize=["price"],
                                        rangeBackWindowSecs=400,
                                        strategy="halo")
        rd, pd_ = op(jd), op(pdd)
        assert pdd._halo(pdd.L) == jd._halo(jd.L)
        counts = _audits(pd_)
        assert counts == _audits(rd) and counts[0][1] > 0
        with caplog.at_level(logging.WARNING, logger="tempo_tpu_torch.dist"):
            got = pd_.collect().df
        assert any("truncated" in r.message for r in caplog.records)
        _assert_frames(got, rd.collect().df)

    def test_halo_strategy_exact_when_window_covered(self, frames, meshes):
        _, port = frames
        _, pm = meshes
        base = port["l"].on_mesh(pm, time_axis="time", halo_fraction=1.0)
        a = base.withRangeStats(colsToSummarize=["price"],
                                rangeBackWindowSecs=2, strategy="halo")
        b = base.withRangeStats(colsToSummarize=["price"],
                                rangeBackWindowSecs=2, strategy="exact")
        assert _audits(a) == [(a.audits[0][0], 0)]
        _assert_frames(a.collect().df, b.collect().df)
