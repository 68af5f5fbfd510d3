"""The port's legacy shifted-window stats (``tempo_tpu_torch.ops.stats``,
plain version on the CPU) against the reference's legacy Pallas kernel
(``pallas_stats.range_stats_pallas``, interpret mode) and its XLA form
(``sortmerge._range_stats_shifted_xla``), in float32; the engine pick
under ``TEMPO_TPU_WINDOW_ENGINE=legacy``; and ``withRangeStats`` under
that knob against the reference frame.

``count``, ``min``, ``max`` and the ``clipped`` audit are selections and
counts: bitwise.  The other statistics agree within rtol = atol = 1e-5:
both sides run ``_make_kernel``'s op sequence, but the per-row centre is
a row sum that the reference and torch reduce in different orders, so
it can differ by a few ULPs and shift every centred term by as much.
``stddev`` is compared as the variance and ``zscore`` times each side's
own ``stddev`` (as ``x - mean``): float32 ``s2 - s1*s1/n`` cancels on
both sides, and the square root and the division by a near-zero
``stddev`` blow a 1e-7 difference up to 1e-3.

Where the data are integers and each row's centre is an integer, every
sum is exact in any order and every output is bitwise equal except
``stddev`` and ``zscore``, which agree within 1 and 2 ULPs: torch's CPU
float32 square root is not correctly rounded (1 ULP off at 148/15, for
one), while XLA's and the CUDA kernel's are.  That pins the masks, the
shift range (``j = 0`` included), the raw-value min/max and the centred
sums.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import tempo_tpu
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu.ops import sortmerge as sm
from tempo_tpu.ops.pallas_stats import range_stats_pallas
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch.ops import rolling, stats, window

from tests.test_torch_frame import STAT_COLS, _frames

KEYS = window.STATS + ("clipped",)
EXACT = ("count", "min", "max", "clipped")
I32_MAX = 2**31 - 1


def _case(seed, K=6, L=256, ties=False, integer=False):
    """``test_pallas_stats``' cases: sorted int32 seconds (ties when
    asked), an all-null row, ragged INT32_MAX pad tails; ``integer``
    makes the values integers whose valid sum in each row is a multiple
    of the row's valid count, so the centre is an exact integer."""
    rng = np.random.default_rng(seed)
    span = 40 if ties else 600
    secs = np.sort(rng.integers(0, span, (K, L)), axis=-1).astype(np.int64)
    x = rng.standard_normal((K, L)).astype(np.float32)
    valid = rng.random((K, L)) > 0.25
    valid[1] = False
    cut = rng.integers(L // 2, L, K)
    for k in range(K):
        secs[k, cut[k]:] = I32_MAX
        valid[k, cut[k]:] = False
    if integer:
        x = np.round(x * 4).astype(np.float32) + np.float32(0.0)
        for k in range(K):
            idx = np.flatnonzero(valid[k])
            if idx.size:
                x[k, idx[-1]] -= int(x[k, idx].sum()) % idx.size
    return secs.astype(np.int32), x, valid


def _port(secs, xs, valids, w, behind, ahead):
    return stats.legacy_stats(torch.from_numpy(secs), torch.from_numpy(xs),
                              torch.from_numpy(valids), w, behind, ahead)


def _ref_args(secs, x, valid, w):
    return (jnp.asarray(secs), jnp.asarray(x), jnp.asarray(valid),
            jnp.asarray(np.int32(w)))


def _compare(got, want, integer=False):
    for k in KEYS:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in EXACT or (integer and k not in ("stddev", "zscore")):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=k)
        elif integer:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(g) & ~np.isinf(g)
            np.testing.assert_array_max_ulp(
                g[ok], w[ok], maxulp=1 if k == "stddev" else 2)
        else:
            if k == "stddev":
                g, w = g * g, w * w
            elif k == "zscore":
                g = g * got["stddev"].numpy()
                w = w * np.asarray(want["stddev"])
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("seed,ties,w,behind,ahead,integer", [
    (0, False, 25, 24, 12, False),     # test_pallas_stats' case 0
    (3, False, 50, 3, 0, True),        # truncating, integers: bitwise
    (2, True, 25, 24, 12, True),       # ties, integers: bitwise
])
def test_plain_matches_pallas_interpret(seed, ties, w, behind, ahead,
                                        integer):
    secs, x, valid = _case(seed, ties=ties, integer=integer)
    want = range_stats_pallas(*_ref_args(secs, x, valid, w), behind, ahead,
                              interpret=True)
    got = _port(secs, x, valid, w, behind, ahead)
    if behind < 24:
        assert float(got["clipped"].sum()) > 0
    _compare(got, want, integer)


@pytest.mark.parametrize("seed,ties,w,behind,ahead,integer,L", [
    (0, False, 25, 24, 12, False, 256),
    (1, True, 25, 24, 12, False, 256),
    (4, True, 10, 6, 2, False, 256),     # truncating both ways
    (5, False, 30, 40, 0, True, 256),
    (6, True, 8, 40, 40, True, 32),      # bounds past the row
])
def test_plain_matches_xla_form(seed, ties, w, behind, ahead, integer, L):
    secs, x, valid = _case(seed, L=L, ties=ties, integer=integer)
    # the XLA form cannot shift past the row; a shift of the row's length
    # or more is all fill, so it takes bounds past the row as L - 1
    want = sm._range_stats_shifted_xla(*_ref_args(secs, x, valid, w),
                                       max_behind=min(behind, L - 1),
                                       max_ahead=min(ahead, L - 1))
    got = _port(secs, x, valid, w, behind, ahead)
    if (behind, ahead) == (6, 2):
        assert float(got["clipped"].sum()) > 0
    _compare(got, want, integer)


def test_column_stack_matches_single_columns():
    """[C, K, L] stacks over one key plane: each column as its own
    call, bitwise."""
    secs, x0, valid0 = _case(7)
    _, x1, valid1 = _case(8)
    valid1 &= secs < I32_MAX
    xs, valids = np.stack([x0, x1]), np.stack([valid0, valid1])
    got = _port(secs, xs, valids, 20, 16, 4)
    assert got["mean"].shape == (2, 6, 256)
    assert got["clipped"].shape == (2, 6, 1)
    for c in range(2):
        want = _port(secs, xs[c], valids[c], 20, 16, 4)
        for k in KEYS:
            assert torch.equal(got[k][c].view(torch.int32),
                               want[k].view(torch.int32)), k


N_GRID = [1024, 1 << 20, 13_062_144, 1024 * 12760, 40_000_000, 10**9]
W_GRID = [(0, 0), (63, 0), (60, 4), (64, 1), (70, 6), (76, 0), (77, 0),
          (500, 12), (512, 1), (300, 300), (16000, 384), (16384, 1),
          (16385, 0)]


@pytest.mark.parametrize("n", N_GRID)
def test_pick_under_legacy_matches_reference(monkeypatch, n):
    """The reference's pick for a shard its kernels can take, mapped to
    the port's engines: its shifted engine (legacy arithmetic under the
    knob) is the legacy kernel, its stream engine the row-bounded one."""
    monkeypatch.setenv("TEMPO_TPU_WINDOW_ENGINE", "legacy")
    names = {"shifted": "legacy", "stream": "shifted",
             "windowed": "windowed"}
    for mb, ma in W_GRID:
        want = ref_rolling.pick_range_engine(n, mb, ma, True, True)
        assert rolling.pick_range_engine(n, mb, ma) == names[want], (n, mb,
                                                                     ma)
    for ok in (False, True):
        assert rolling.shifted_row_budget(n, ok) == \
            ref_rolling.shifted_row_budget(n, ok)
    if n == 13_062_144:
        assert rolling.shifted_row_budget(n, True) == 76


def test_frame_range_stats_under_legacy_matches_reference(monkeypatch):
    """``withRangeStats`` over two columns under ``legacy``: the port
    (``device="cpu"``, float64, the legacy kernel's plain version, once
    for the [2, K, L] stack) against the reference frame (JAX on the
    CPU, float64; its shifted pick there runs the legacy XLA form),
    within 1e-12."""
    monkeypatch.setenv("TEMPO_TPU_WINDOW_ENGINE", "legacy")
    monkeypatch.setenv("TEMPO_TPU_SORT_KERNELS", "1")
    monkeypatch.setenv("TEMPO_TPU_BINPACK", "0")
    left, _ = _frames(19, zipf=False, with_seq=False)
    left["y"] = np.where(np.arange(len(left)) % 7 == 0, np.nan,
                         np.arange(len(left)) % 13 - 6.0)

    def run(tsdf_cls, **dev):
        out = tsdf_cls(left, "event_ts", ["sym"], **dev).withRangeStats(
            colsToSummarize=["x", "y"], rangeBackWindowSecs=10).df
        return out.sort_values(["sym", "event_ts"], kind="stable") \
            .reset_index(drop=True)

    want = run(tempo_tpu.TSDF)
    calls = []
    real = stats.legacy_stats_plain
    monkeypatch.setattr(stats, "legacy_stats_plain",
                        lambda *a: calls.append(a) or real(*a))
    got = run(PortTSDF, device="cpu")
    assert len(calls) == 1
    assert list(got.columns) == list(want.columns)
    for c in ("x", "y"):
        np.testing.assert_array_equal(got[f"count_{c}"].to_numpy(),
                                      want[f"count_{c}"].to_numpy())
        for s in STAT_COLS[:-1]:
            col = s.replace("_x", f"_{c}")
            np.testing.assert_allclose(got[col].to_numpy(np.float64),
                                       want[col].to_numpy(np.float64),
                                       rtol=1e-12, atol=1e-12,
                                       equal_nan=True, err_msg=col)
    pd.testing.assert_series_equal(got["event_ts"], want["event_ts"])
