"""The port's range-stats sweep (``tempo_tpu_torch.ops.window``, plain
version on the CPU) against the Pallas window kernel in interpret mode,
in float32.

``count`` and the ``clipped`` audit are selections and counts: bitwise.
The other statistics agree within rtol = atol = 1e-5: both sides run
``_window_math``'s op sequence, but the per-row centre is a row sum
taken in another order, so it can differ by a few ULPs and shift every
centred term by as much.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_window as pw
from tempo_tpu_torch.ops import window

I32_MAX = 2**31 - 1
TOL = dict(rtol=1e-5, atol=1e-5)
FORMS = {"unrolled": pw.range_stats_unrolled, "stream": pw.range_stats_stream}
PACKED = {"unrolled": pw.range_stats_unrolled_packed,
          "stream": pw.range_stats_stream_packed}


def _case(seed, K=4, L=256, C=1, gap=3):
    """Rebased int32 seconds with ties and ragged INT32_MAX pad tails,
    values and nulls for C columns."""
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(0, gap, (K, L)), axis=1).astype(np.int32)
    for k in range(K):
        secs[k, L - rng.integers(0, L // 4):] = I32_MAX
    xs = rng.standard_normal((C, K, L)).astype(np.float32) * 3
    valids = rng.random((C, K, L)) > 0.15
    valids &= secs[None] < I32_MAX
    return secs, xs, valids


def _compare(got, want):
    for k in window.STATS + ("clipped",):
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("count", "clipped"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, equal_nan=True, err_msg=k, **TOL)


@pytest.mark.parametrize("form", ["unrolled", "stream"])
@pytest.mark.parametrize("seed,w,behind,ahead", [
    (0, 10, 12, 4),
    (1, 5, 6, 6),
    (2, 30, 40, 3),
])
def test_single_column_matches_pallas(form, seed, w, behind, ahead):
    secs, xs, valids = _case(seed)
    want = FORMS[form](jnp.asarray(secs), jnp.asarray(xs[0]),
                       jnp.asarray(valids[0]), w, behind, ahead,
                       interpret=True)
    got = window.range_stats(torch.from_numpy(secs), torch.from_numpy(xs[0]),
                             torch.from_numpy(valids[0]), w, behind, ahead)
    _compare(got, want)


@pytest.mark.parametrize("form", ["unrolled", "stream"])
def test_packed_columns_match_pallas(form):
    secs, xs, valids = _case(7, C=3)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    want = PACKED[form](jnp.asarray(secs), jnp.asarray(xs),
                        jnp.asarray(valids), 8, 10, 3,
                        scales=jnp.asarray(scales), interpret=True)
    got = window.range_stats(torch.from_numpy(secs), torch.from_numpy(xs),
                             torch.from_numpy(valids), 8, 10, 3,
                             scales=torch.from_numpy(scales))
    _compare(got, want)


@pytest.mark.parametrize("form", ["unrolled", "stream"])
def test_truncating_bounds_clip_like_pallas(form):
    """Bounds below the real frame extent truncate frames; the clipped
    audit must count exactly the same rows."""
    secs, xs, valids = _case(11, gap=2)
    want = FORMS[form](jnp.asarray(secs), jnp.asarray(xs[0]),
                       jnp.asarray(valids[0]), 20, 3, 0, interpret=True)
    got = window.range_stats(torch.from_numpy(secs), torch.from_numpy(xs[0]),
                             torch.from_numpy(valids[0]), 20, 3, 0)
    assert float(got["clipped"].sum()) > 0
    _compare(got, want)


def test_window_ahead_and_bounds_past_the_row():
    """rangeBetween(-w, +wa) with row bounds beyond the row length."""
    secs, xs, valids = _case(5, K=3, L=64)
    want = pw.range_stats_stream(jnp.asarray(secs), jnp.asarray(xs[0]),
                                 jnp.asarray(valids[0]), 6, 100, 100,
                                 window_ahead=4, interpret=True)
    got = window.range_stats(torch.from_numpy(secs), torch.from_numpy(xs[0]),
                             torch.from_numpy(valids[0]), 6, 100, 100,
                             window_ahead=4)
    _compare(got, want)
