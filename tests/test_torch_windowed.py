"""The windowed range engine's parts in the port (plain versions on the
CPU) against the reference: the rank (``merge_rank`` /
``searchsorted_batched`` against ``merge_rank_pallas`` in interpret
mode, bitwise), ``cumsum3`` (against ``pallas_kernels.cumsum3`` in
interpret mode) and ``windowed_stats`` (against the reference's, float64).

``cumsum3``: in interpret mode XLA:CPU contracts the first ladder level
of the squares, ``xz*xz + shift(xz*xz)``, into one fused multiply-add,
which rounds once where the port (and its CUDA kernel, built with
-fmad=false and round-to-nearest intrinsics) rounds twice.  The sums of
x and of the counts carry no product and agree bitwise; the squares
differ by at most one rounding at each of the log2(L) levels, hence the
stated bound ``|port - pallas| <= (log2(L) + 1) * spacing(max P2)``.  The
association itself is pinned bitwise against a numpy ladder without
contraction, and the reference against the same ladder with the first
level fused.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu.ops import pallas_merge as pm
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu_torch.ops import merge, rolling, scan, window_utils


# --------------------------------------------------------------------
# rank
# --------------------------------------------------------------------

def _rank_case(K, Lk, Lq, kdt, qdt):
    """Sorted keys and queries with ties and values outside the key
    range, clamped pads like the real callers' (rebased int32 / TS_PAD
    headroom) on row 0."""
    rng = np.random.default_rng(K * 7 + Lk + Lq)
    keys = np.sort(rng.integers(0, 300, (K, Lk)), -1)
    qs = np.sort(rng.integers(-5, 310, (K, Lq)), -1)
    if kdt == qdt == np.int64:
        keys, qs = keys * 10**9, qs * 10**9
    keys, qs = keys.astype(kdt), qs.astype(qdt)
    pad = lambda dt: np.iinfo(dt).max if dt == np.int32 else np.int64(2**62)
    keys[0, Lk // 2:] = pad(kdt)
    qs[0, Lq // 2:] = pad(qdt)
    return keys, qs


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("K,Lk,Lq,kdt,qdt", [
    (4, 128, 128, np.int32, np.int32),
    (3, 200, 136, np.int64, np.int64),
    (5, 384, 128, np.int32, np.int32),
    (2, 128, 300, np.int64, np.int64),
    (3, 160, 96, np.int32, np.int64),     # promoted like the reference
])
def test_rank_matches_pallas_bitwise(K, Lk, Lq, kdt, qdt, side):
    keys, qs = _rank_case(K, Lk, Lq, kdt, qdt)
    want = np.asarray(pm.merge_rank_pallas(jnp.asarray(keys), jnp.asarray(qs),
                                           side=side, interpret=True))
    got = window_utils.merge_rank(torch.from_numpy(keys),
                                  torch.from_numpy(qs), side)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        window_utils.searchsorted_batched(torch.from_numpy(keys),
                                          torch.from_numpy(qs), side).numpy(),
        np.stack([np.searchsorted(keys[k], qs[k], side=side)
                  for k in range(K)]))


def test_rank_refuses_unknown_side():
    t = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="side"):
        merge.merge_rank_plain(t, t, side="middle")


def test_window_bounds_match_the_reference():
    """``range_window_bounds`` (two ranks) over rebased seconds with an
    INT32_MAX pad tail."""
    rng = np.random.default_rng(4)
    secs = np.cumsum(rng.integers(0, 3, (3, 200)), axis=1).astype(np.int32)
    secs[1, 150:] = 2**31 - 1
    want = ref_rolling.range_window_bounds(jnp.asarray(secs), jnp.int32(7))
    got = rolling.range_window_bounds(torch.from_numpy(secs), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------
# cumsum3
# --------------------------------------------------------------------

def _sums_case(seed, K, L):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((K, L)) * 3).astype(np.float32)
    x[0, :3] = -0.0                       # signed zeros survive the ladder
    valid = rng.random((K, L)) > 0.2
    return x, valid


def _numpy_ladder(x, valid, fma_first_square=False):
    """The ladder in float32 numpy, one rounding per operation; with
    ``fma_first_square`` the first level of the squares rounds
    ``xz*xz + shift(xz*xz)`` once, as XLA:CPU's contraction does."""
    K, L = x.shape
    shift = lambda p, s: np.concatenate(
        [np.zeros((K, s), p.dtype), p[:, :-s]], 1)
    xz = np.where(valid, x, np.float32(0)).astype(np.float32)
    sums = [xz, (xz * xz).astype(np.float32), valid.astype(np.float32)]
    span = 1
    while span < L:
        new = [(p + shift(p, span)).astype(np.float32) for p in sums]
        if fma_first_square and span == 1:
            new[1] = (xz.astype(np.float64) ** 2
                      + shift(sums[1], 1).astype(np.float64)).astype(
                          np.float32)
        sums = new
        span *= 2
    return sums


@pytest.mark.parametrize("seed,K,L", [(0, 8, 512), (1, 5, 300), (2, 3, 1),
                                      (3, 4, 129)])
def test_cumsum3_matches_pallas(seed, K, L):
    x, valid = _sums_case(seed, K, L)
    want = [np.asarray(o) for o in pk.cumsum3(jnp.asarray(x),
                                              jnp.asarray(valid),
                                              interpret=True)]
    got = [o.numpy() for o in scan.cumsum3(torch.from_numpy(x),
                                           torch.from_numpy(valid))]
    for i in (0, 2):
        np.testing.assert_array_equal(got[i].view(np.int32),
                                      want[i].view(np.int32))
    bound = (max(1, math.ceil(math.log2(L))) + 1) * np.spacing(
        np.abs(want[1]).max())
    assert np.abs(got[1] - want[1]).max() <= bound


@pytest.mark.parametrize("seed,L", [(5, 512), (6, 77)])
def test_cumsum3_association_is_the_ladder_bitwise(seed, L):
    x, valid = _sums_case(seed, 6, L)
    got = scan.cumsum3(torch.from_numpy(x), torch.from_numpy(valid))
    for g, w in zip(got, _numpy_ladder(x, valid)):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))
    # the reference's only difference is the contracted first level
    want = pk.cumsum3(jnp.asarray(x), jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(
        np.asarray(want[1]).view(np.int32),
        _numpy_ladder(x, valid, fma_first_square=True)[1].view(np.int32))


def test_cumsum3_float64_is_the_prefix_sum():
    """The CPU policy's float64 form against numpy's sequential sums."""
    x, valid = _sums_case(8, 4, 200)
    x = x.astype(np.float64)
    got = scan.cumsum3(torch.from_numpy(x), torch.from_numpy(valid))
    xz = np.where(valid, x, 0.0)
    for g, w in zip(got, (np.cumsum(xz, -1), np.cumsum(xz * xz, -1),
                          np.cumsum(valid, -1))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------
# windowed_stats
# --------------------------------------------------------------------

def _stats_case(seed, K=4, L=256):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(0, 3, (K, L)), axis=1).astype(np.int32)
    x = rng.standard_normal((K, L)) * 3 + 10
    valid = rng.random((K, L)) > 0.15
    return secs, x, valid


@pytest.mark.parametrize("w", [5, 40])
def test_windowed_stats_match_the_reference(w):
    """float64 on both sides: counts equal, the rest within 1e-9 (the
    reference's CPU prefix sums are an associative scan, the port's the
    ladder)."""
    secs, x, valid = _stats_case(w)
    start, end = ref_rolling.range_window_bounds(jnp.asarray(secs),
                                                 jnp.int32(w))
    max_w = 1 << (int(np.max(np.asarray(end) - np.asarray(start))) - 1
                  ).bit_length()
    want = ref_rolling.windowed_stats(jnp.asarray(x), jnp.asarray(valid),
                                      start, end, max_window=max_w)
    ts, tx, tv = (torch.from_numpy(a) for a in (secs, x, valid))
    s, e = rolling.range_window_bounds(ts, w)
    got = rolling.windowed_stats(tx, tv, s, e, max_window=max_w)
    for k, v in want.items():
        g, r = got[k].numpy(), np.asarray(v)
        if k == "count":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=k)


def test_max_window_caps_the_levels_not_the_result():
    """Sparse tables capped at the widest real window give the same
    min/max as the full tables, bitwise."""
    secs, x, valid = _stats_case(9)
    ts, tx, tv = (torch.from_numpy(a) for a in (secs, x, valid))
    s, e = rolling.range_window_bounds(ts, 6)
    max_w = 1 << (int((e - s).max()) - 1).bit_length()
    assert max_w < x.shape[-1] // 2
    capped = rolling.windowed_stats(tx, tv, s, e, max_window=max_w)
    full = rolling.windowed_stats(tx, tv, s, e)
    for k in full:
        torch.testing.assert_close(capped[k], full[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
