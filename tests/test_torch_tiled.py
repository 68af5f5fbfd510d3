"""The tiled designs of two kernels, as their CPU mirrors, against the
plain versions they must reproduce bit for bit:

* ``scan.cumsum3_tiled_plain`` (the ``cumsum3`` kernel's two stages: a
  tile-local ladder with a halo, then a ladder along each residue class)
  against ``scan.cumsum3_plain`` (the whole-row Hillis-Steele ladder);
* ``merge.asof_merge_lookback_tiled_plain`` (the lookback kernel's
  merge-path tiles: co-rank splits, tile-local ranking, the look-back
  carry of each column's last valid row) against
  ``merge.asof_merge_lookback_plain``.

Tolerance: none.  Sums are compared as their integer bit patterns (so
-0.0 and +0.0, and NaN payloads, count), indices exactly, in float32 and
float64.
"""

import numpy as np
import pytest
import torch

from tempo_tpu_torch import packing
from tempo_tpu_torch.ops import merge, scan

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
DTYPES = [torch.float32, torch.float64]


def _same(got, want):
    if got is None or want is None:
        assert got is None and want is None
        return
    if got.is_floating_point():
        got, want = got.view(BITS[got.dtype]), want.view(BITS[want.dtype])
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


# --------------------------------------------------------------------
# cumsum3
# --------------------------------------------------------------------

def _sums_case(seed, K, L, dtype, specials):
    """x over six decades of magnitude, a fifth of the lanes invalid;
    with ``specials`` also -0.0 heads and runs, NaN and +-inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, L)) * 10.0 ** rng.uniform(-3, 4, (K, L))
    valid = rng.random((K, L)) > 0.2
    if specials:
        x[:, 0] = -0.0
        valid[:, 0] = True
        x[rng.random((K, L)) < 0.1] = -0.0
        for v in (np.nan, np.inf, -np.inf):
            x[rng.random((K, L)) < 0.01] = v
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(valid))


# L around tile widths T = 2^t times powers of two, at t = 2, 3, 5 (deep
# second stages) and the kernel's t = 10
_SUMS = [(L, t) for t in (2, 3, 5) for L in (1, 2, 2**t - 1, 2**t,
                                              2**t + 1, 2**t * 4 - 1,
                                              2**t * 4 + 1, 2**t * 16 + 1,
                                              300)] + [
    (1, 10), (7, 10), (1023, 10), (1024, 10), (1025, 10), (4097, 10)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,tile_log2", _SUMS)
def test_cumsum3_tiled_is_the_ladder_bitwise(L, tile_log2, dtype):
    x, valid = _sums_case(L * 31 + tile_log2, 3, L, dtype, specials=False)
    got = scan.cumsum3_tiled_plain(x, valid, tile_log2)
    for g, w in zip(got, scan.cumsum3_plain(x, valid)):
        _same(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,tile_log2", [(1, 3), (5, 3), (8, 3), (9, 3),
                                         (33, 3), (65, 5), (200, 2)])
def test_cumsum3_tiled_keeps_signed_zeros_nan_and_inf(L, tile_log2, dtype):
    """One ladder level too many would add +0.0 and turn a -0.0 sum into
    +0.0; the -0.0 heads and runs show it, NaN and +-inf ride along."""
    x, valid = _sums_case(L + 7, 4, L, dtype, specials=True)
    got = scan.cumsum3_tiled_plain(x, valid, tile_log2)
    want = scan.cumsum3_plain(x, valid)
    for g, w in zip(got, want):
        _same(g, w)
    if L == 1:
        assert torch.equal(got[0].view(BITS[dtype]),
                           torch.full((4, 1), -0.0, dtype=dtype).view(BITS[dtype]))


# --------------------------------------------------------------------
# the lookback merge
# --------------------------------------------------------------------

def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _padded(rng, K, L, span):
    ts = np.sort(rng.integers(0, span, (K, L)), -1).astype(np.int64)
    ts[:, L - L // 8:] = packing.TS_PAD
    return ts


def _binpacked(rng, K, L, seg, span):
    """Series of ``seg`` rows back to back in ascending sid, a pad tail."""
    n = L // seg
    sid = np.repeat(np.arange(K * n, dtype=np.int32).reshape(K, n), seg, 1)
    ts = np.sort(rng.integers(0, span, (K, n, seg)), -1).reshape(K, n * seg)
    ts = ts.astype(np.int64)
    ts[:, L - seg:] = packing.TS_PAD
    sid[:, L - seg:] = packing.SID_PAD
    return ts, sid


def _join_case(layout, seed, dtype):
    """(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key)."""
    rng = np.random.default_rng(seed)
    K = 3
    l_sid = r_sid = l_key = r_key = None
    if layout == "ties":            # few distinct keys, Ll != Lr
        l_ts, r_ts = _padded(rng, K, 96, 30), _padded(rng, K, 120, 30)
    elif layout == "long_ties":     # runs of equal keys many tiles long
        l_ts, r_ts = _padded(rng, K, 160, 3), _padded(rng, K, 140, 3)
    elif layout == "binpack":       # series edges on tile edges (2 * 16)
        l_ts, l_sid = _binpacked(rng, K, 128, 16, 40)
        r_ts, r_sid = _binpacked(rng, K, 128, 16, 40)
    elif layout == "seq":           # a sequence tie-break, -inf nulls
        l_ts, r_ts = _padded(rng, K, 100, 25), _padded(rng, K, 110, 25)
        seq = rng.integers(-3, 4, r_ts.shape).astype(np.float64)
        seq[rng.random(seq.shape) < 0.25] = -np.inf
        for k in range(K):
            seq[k] = seq[k][np.lexsort((seq[k], r_ts[k]))]
        l_key, r_key = merge.seq_keys(None, _t(seq), l_ts.shape, r_ts.shape)
    else:                           # a row of pads only, and a one-lane side
        l_ts, r_ts = _padded(rng, K, 64, 20), _padded(rng, K, 1, 20)
        l_ts[0] = packing.TS_PAD
    C, Lr = 2, r_ts.shape[1]
    r_valids = rng.random((C, K, Lr)) > 0.3
    r_values = np.where(r_valids, rng.standard_normal((C, K, Lr)), np.nan)
    r_values[rng.random(r_values.shape) < 0.05] = np.nan    # NaN, valid bit set
    if layout == "binpack":
        r_valids &= r_ts < packing.TS_PAD
    return (_t(l_ts), _t(r_ts), _t(r_valids), _t(r_values).to(dtype),
            _t(l_sid), _t(r_sid), l_key, r_key)


_LAYOUTS = ["ties", "long_ties", "binpack", "seq", "pads"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("ml", [0, 1, 4])
@pytest.mark.parametrize("tile", [4, 8, 16])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_lookback_tiled_is_the_plain_join_bitwise(layout, tile, ml,
                                                  skip_nulls, dtype):
    l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key = _join_case(
        layout, _LAYOUTS.index(layout) * 100 + tile + ml, dtype)
    args = (l_ts, r_ts, r_valids, ml, r_values, l_sid, r_sid, l_key, r_key)
    got = merge.asof_merge_lookback_tiled_plain(*args, skip_nulls=skip_nulls,
                                                tile=tile)
    want = merge.asof_merge_lookback_plain(*args, skip_nulls=skip_nulls)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("tile", [1, 7, merge.LOOKBACK_TILE])
def test_lookback_tiled_index_form_and_wide_horizon(tile):
    """No values (the index form), a horizon past the row, odd tiles."""
    l_ts, r_ts, r_valids, _, l_sid, r_sid, _, _ = _join_case("binpack", 9,
                                                             torch.float64)
    for ml in (3, 10**6):
        got = merge.asof_merge_lookback_tiled_plain(
            l_ts, r_ts, r_valids, ml, None, l_sid, r_sid, tile=tile)
        want = merge.asof_merge_lookback_plain(l_ts, r_ts, r_valids, ml,
                                               None, l_sid, r_sid)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("tile", [0, merge.LOOKBACK_TILE + 1])
def test_lookback_kernel_refuses_a_tile_it_cannot_hold(tile):
    l_ts, r_ts, r_valids, *_ = _join_case("ties", 1, torch.float32)
    with pytest.raises(ValueError, match="tile"):
        merge.asof_merge_lookback_cuda(l_ts, r_ts, r_valids, 2, _tile=tile)
