"""The port's resample, calc_bars, resampleEMA and interpolate frames
(``device="cpu"``, float64, the kernels' plain versions) against
``tempo_tpu.TSDF`` (JAX on the CPU, float64) on the same pandas inputs,
and the reference goldens of ``tests/test_resample.py`` and
``tests/test_interpol.py`` run through the port.

Tolerances:

* timestamps, partition columns, floor/ceil picks, min/max and every
  ``is_*interpolated`` flag: bitwise (selections);
* mean, and fills of means: within 1e-12 relative (the segment sums may
  associate differently); the linear fill likewise;
* ``resampleEMA``'s ``EMA_x``: within one float32 ulp.  Both sides round
  a float64 EMA to float32 before unpacking, the reference's from an
  associative scan (its CPU path) and the port's from the Hillis-Steele
  ladder, so the float64 values differ in the last bits and may round
  to neighbouring float32 values.
"""

import functools

import numpy as np
import pandas as pd
import pytest
import torch

import tempo_tpu
import tests.test_interpol as golden_interpol
import tests.test_resample as golden_resample
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch import interpol

T = 1_000_000_000
DAY = 86_400


def _frame(seed, base_secs):
    """Four series (one before 1970), ties, nulls, an int and a string
    column."""
    rng = np.random.default_rng(seed)
    parts = []
    for k, base in enumerate(base_secs):
        n = int(rng.integers(30, 60))
        secs = base + np.cumsum(rng.integers(0, 50, n))
        parts.append(pd.DataFrame({
            "sym": f"k{k}",
            "event_ts": pd.to_datetime(secs * T),
            "x": np.where(rng.random(n) > 0.2, rng.standard_normal(n), np.nan),
            "n": rng.integers(-5, 5, n),
            "tag": rng.choice(["a", "b", "c"], n),
        }))
    return pd.concat(parts, ignore_index=True).sample(frac=1.0,
                                                      random_state=seed)


BASES = {"around_1970": [0, -400 * DAY - 17, 10**9, 7],
         "past_2038": [2**31 + 11, 2**31 + 5000, 2**32, 2**31]}


def _both(df, fn, **kw):
    """``fn`` of the reference frame and of the port's CPU frame, each
    sorted by key and time."""
    out = []
    for t in (tempo_tpu.TSDF(df, "event_ts", ["sym"], **kw),
              PortTSDF(df, "event_ts", ["sym"], device="cpu", **kw)):
        res = fn(t).df
        out.append(res.sort_values(["sym", "event_ts"], kind="stable")
                   .reset_index(drop=True))
    return out


def _assert_frames(got, want, rtol=0.0, ulp32=()):
    """Same columns, dtypes and rows; floats within ``rtol`` (bitwise at
    0), the ``ulp32`` columns within one float32 spacing."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype, c
        if pd.api.types.is_float_dtype(w) and (rtol or c in ulp32):
            gv, wv = g.to_numpy(), w.to_numpy()
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), c)
            ok = ~np.isnan(wv)
            if c in ulp32:
                tol = np.spacing(np.abs(wv[ok]).astype(np.float32))
                assert (np.abs(gv[ok] - wv[ok]) <= tol).all(), c
            else:
                np.testing.assert_allclose(gv[ok], wv[ok], rtol=rtol, atol=0,
                                           err_msg=c)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True)


@pytest.mark.parametrize("func,prefix,fill", [
    ("floor", None, None), ("ceil", "close", None), ("min", None, None),
    ("max", "high", None), ("mean", None, None), ("mean", "avg", True),
    ("closest_lead", None, None),
])
def test_resample_matches_reference(func, prefix, fill):
    df = _frame(1, BASES["around_1970"])
    got, want = _both(df, lambda t: t.resample("1 minute", func,
                                               prefix=prefix, fill=fill))
    _assert_frames(got, want, rtol=1e-12 if func == "mean" else 0.0)


def test_calc_bars_matches_reference():
    df = _frame(2, BASES["around_1970"])
    got, want = _both(df, lambda t: t.calc_bars("5 minutes",
                                                metricCols=["x", "n"]))
    _assert_frames(got, want)


@pytest.mark.parametrize("base", sorted(BASES))
def test_resample_ema_matches_reference(base):
    df = _frame(3, BASES[base])
    got, want = _both(df, lambda t: t.resampleEMA("1 minute", "x",
                                                  exp_factor=0.3))
    _assert_frames(got, want, ulp32=("EMA_x",))


@pytest.mark.parametrize("show", [False, True])
@pytest.mark.parametrize("method", ["zero", "null", "ffill", "bfill",
                                    "linear"])
def test_interpolate_matches_reference(method, show):
    df = _frame(4, BASES["around_1970"]).drop(columns=["tag"])
    got, want = _both(df, lambda t: t.interpolate(
        freq="30 seconds", func="mean", method=method,
        show_interpolated=show))
    _assert_frames(got, want, rtol=1e-12)


@pytest.mark.parametrize("method", ["zero", "null", "ffill", "bfill",
                                    "linear"])
def test_resampled_chain_matches_reference(method):
    # the frame of the test above: the same grid, so the reference's
    # compiled fills are reused
    df = _frame(4, BASES["around_1970"]).drop(columns=["tag"])
    got, want = _both(df, lambda t: t.resample("30 seconds", "floor")
                      .interpolate(method=method, show_interpolated=True))
    _assert_frames(got, want, rtol=1e-12 if method == "linear" else 0.0)


def test_frames_keep_the_source_device_and_dtype():
    df = _frame(6, BASES["around_1970"]).drop(columns=["tag"])
    t = PortTSDF(df, "event_ts", ["sym"], device="cpu", dtype=torch.float32)
    resampled = t.resample("1 minute", "mean")
    for out in (resampled, resampled.interpolate("linear"),
                t.calc_bars("1 minute"), t.resampleEMA("1 minute", "x"),
                t.interpolate(freq="1 minute", func="mean", method="ffill")):
        assert out.device == torch.device("cpu")
        assert out.dtype == torch.float32


def _golden_names(module):
    # the fused-EMA goldens call the JAX package's internals directly
    return [n for n in sorted(vars(module))
            if n.startswith("test_") and "fused" not in n]


@pytest.mark.parametrize("module,name", [
    (m, n) for m in (golden_resample, golden_interpol)
    for n in _golden_names(m)
], ids=lambda v: v if isinstance(v, str) else v.__name__.split(".")[-1])
def test_reference_goldens_through_the_port(monkeypatch, module, name):
    monkeypatch.setattr(module, "TSDF",
                        functools.partial(PortTSDF, device="cpu"))
    if hasattr(module, "Interpolation"):
        monkeypatch.setattr(module, "Interpolation", interpol.Interpolation)
    getattr(module, name)()
