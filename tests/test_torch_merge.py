"""The port's AS-OF merge (``tempo_tpu_torch.ops.merge``, plain version
on the CPU) against the Pallas merge kernel in interpret mode.

The outputs are selections, so they must agree bitwise: joined values
(compared as bit patterns), found flags, the last-right-row index and
the per-column indices, pad lanes included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu import packing as ref_packing
from tempo_tpu.ops import pallas_merge as pm
from tempo_tpu_torch.ops import merge

TS_PAD = np.int64(2**62)
T = 10**9


def _case(seed, K, Ll, Lr, C, ties=False):
    """Ragged TS_PAD-padded sides with ties, negative ts and nulls."""
    rng = np.random.default_rng(seed)
    llen = rng.integers(0, Ll + 1, K)
    rlen = rng.integers(0, Lr + 1, K)
    llen[0], rlen[0] = Ll, 0            # no right rows at all
    if K > 1:
        llen[1], rlen[1] = 0, Lr        # no left rows at all
    span = 8 if ties else 50
    l_ts = np.full((K, Ll), TS_PAD, np.int64)
    r_ts = np.full((K, Lr), TS_PAD, np.int64)
    for k in range(K):
        base = rng.integers(-5, 5) * T
        l_ts[k, :llen[k]] = np.sort(base + rng.integers(0, span, llen[k]) * T)
        r_ts[k, :rlen[k]] = np.sort(base + rng.integers(0, span, rlen[k]) * T)
    r_values = rng.standard_normal((C, K, Lr)).astype(np.float32)
    r_valids = rng.random((C, K, Lr)) > 0.3
    if C:
        r_valids[0, min(2, K - 1)] = False   # an all-null column/series
    for k in range(K):
        r_valids[:, k, rlen[k]:] = False
    return rng, l_ts, r_ts, r_valids, r_values


def _seq_plane(rng, r_ts, dtype):
    """Per-row (ts, seq)-ascending right sequence: nulls ride -inf
    (NULLS FIRST), pads +inf."""
    K, Lr = r_ts.shape
    r_seq = np.full((K, Lr), np.inf)
    for k in range(K):
        n = int((r_ts[k] < TS_PAD).sum())
        if dtype == "int64":
            s = 2.0**33 + rng.integers(-(2**32), 2**32, n).astype(np.float64)
        else:
            s = rng.integers(-3, 3, n).astype(np.float64)
        s[rng.random(n) < 0.3] = -np.inf
        r_seq[k, :n] = s[np.lexsort((s, r_ts[k, :n]))]
    return r_seq


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_bitwise(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _check_values(l_ts, r_ts, r_valids, r_values, l_sid=None, r_sid=None,
                  r_seq=None, skip_nulls=True):
    want = pm.asof_merge_values_pallas(
        _j(l_ts), _j(r_ts), _j(r_valids), _j(r_values), _j(l_sid),
        _j(r_sid), r_seq=pm.seq_kernel_form(_j(r_seq)),
        skip_nulls=skip_nulls, interpret=True)
    got = merge.asof_merge_values(
        _t(l_ts), _t(r_ts), _t(r_valids), _t(r_values), _t(l_sid),
        _t(r_sid), r_seq=_t(r_seq), skip_nulls=skip_nulls)
    for g, w, what in zip(got, want, ("vals", "found", "last_row_idx")):
        _assert_bitwise(g.numpy(), w, what)


@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("K,Ll,Lr,C,ties", [
    (4, 128, 128, 2, False),
    (6, 256, 256, 2, True),     # dense timestamp ties
    (3, 200, 136, 1, False),    # right side off the 128-lane grid
    (2, 128, 128, 0, False),    # no right value columns
])
def test_values_match_pallas_bitwise(K, Ll, Lr, C, ties, skip_nulls):
    _, l_ts, r_ts, r_valids, r_values = _case(K * 1000 + Ll + Lr + C, K, Ll,
                                              Lr, C, ties)
    _check_values(l_ts, r_ts, r_valids, r_values, skip_nulls=skip_nulls)


@pytest.mark.parametrize("K,Ll,Lr,C", [(4, 128, 128, 2), (3, 200, 136, 1)])
def test_indices_match_pallas_bitwise(K, Ll, Lr, C):
    _, l_ts, r_ts, r_valids, _ = _case(K + Lr, K, Ll, Lr, C)
    want = pm.asof_merge_indices_pallas(_j(l_ts), _j(r_ts), _j(r_valids),
                                        interpret=True)
    got = merge.asof_merge_indices(_t(l_ts), _t(r_ts), _t(r_valids))
    for g, w, what in zip(got, want, ("last_row_idx", "per_col_idx")):
        _assert_bitwise(g.numpy(), w, what)


@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("seq_form", ["float32", "int64"])
def test_seq_tiebreak_matches_pallas_bitwise(seq_form, skip_nulls):
    """float64 sequence planes re-encode as the kernel takes them:
    float32 when exact, int64 (±inf to the extremes) when integral."""
    rng, l_ts, r_ts, r_valids, r_values = _case(31, 4, 128, 128, 2,
                                                ties=True)
    r_seq = _seq_plane(rng, r_ts, seq_form)
    assert np.dtype(pm.seq_kernel_form(_j(r_seq)).dtype) == np.dtype(seq_form)
    _check_values(l_ts, r_ts, r_valids, r_values, r_seq=r_seq,
                  skip_nulls=skip_nulls)


def test_null_seq_right_row_visible_on_full_tie():
    """Spark order on a full ts tie: right-null-seq < left <
    right-non-null-seq (tsdf.py:117-121)."""
    l_ts = np.pad(np.array([[2 * T]], np.int64), ((0, 0), (0, 7)),
                  constant_values=TS_PAD)
    r_ts = np.pad(np.array([[2 * T, 2 * T]], np.int64), ((0, 0), (0, 6)),
                  constant_values=TS_PAD)
    r_seq = np.full((1, 8), np.inf)
    r_seq[0, :2] = [-np.inf, 5.0]
    r_vals = np.zeros((1, 1, 8), np.float32)
    r_vals[0, 0, :2] = [10.0, 20.0]
    r_valid = np.zeros((1, 1, 8), bool)
    r_valid[0, 0, :2] = True
    vals, found, idx = merge.asof_merge_values(
        _t(l_ts), _t(r_ts), _t(r_valid), _t(r_vals), r_seq=_t(r_seq))
    assert vals[0, 0, 0].item() == 10.0 and idx[0, 0].item() == 0


def _binpacked(seed, S=37, Lmax=96, C=2, W=256):
    """Skew-length series bin-packed into shared lane rows with the
    reference's own packers."""
    rng = np.random.default_rng(seed)
    llen = rng.integers(1, Lmax + 1, S)
    rlen = rng.integers(0, Lmax + 1, S)
    llen[0] = Lmax
    l_ts = np.full((S, Lmax), TS_PAD, np.int64)
    r_ts = np.full((S, Lmax), TS_PAD, np.int64)
    for s in range(S):
        base = rng.integers(-3, 3) * T
        l_ts[s, :llen[s]] = np.sort(base + rng.integers(0, 40, llen[s]) * T)
        r_ts[s, :rlen[s]] = np.sort(base + rng.integers(0, 40, rlen[s]) * T)
    r_values = rng.standard_normal((C, S, Lmax)).astype(np.float32)
    r_valids = rng.random((C, S, Lmax)) > 0.3
    for s in range(S):
        r_valids[:, s, rlen[s]:] = False
    bp = ref_packing.bin_pack_series(llen, rlen, W, W)
    K2 = bp.n_rows
    rows = ref_packing.binpack_rows
    lt2 = rows(l_ts, llen, bp.row, bp.l_off, K2, W, TS_PAD)
    rt2 = rows(r_ts, rlen, bp.row, bp.r_off, K2, W, TS_PAD)
    lsid = ref_packing.binpack_sid(llen, bp.row, bp.l_off, K2, W)
    rsid = ref_packing.binpack_sid(rlen, bp.row, bp.r_off, K2, W)
    rv2 = np.stack([rows(r_values[c], rlen, bp.row, bp.r_off, K2, W, 0.0)
                    for c in range(C)])
    rm2 = np.stack([rows(r_valids[c], rlen, bp.row, bp.r_off, K2, W, False)
                    for c in range(C)])
    return lt2, rt2, lsid, rsid, rv2, rm2


@pytest.mark.parametrize("skip_nulls", [True, False])
def test_binpacked_sid_fence_matches_pallas_bitwise(skip_nulls):
    lt2, rt2, lsid, rsid, rv2, rm2 = _binpacked(3 if skip_nulls else 9)
    _check_values(lt2, rt2, rm2, rv2, l_sid=lsid, r_sid=rsid,
                  skip_nulls=skip_nulls)


def test_seq_kernel_form_matches_reference():
    cases = [
        np.array([[1.0, 2.5, np.inf, -np.inf]]),             # f32-exact
        np.array([[2.0**40 + 1, -3.0, np.inf, -np.inf]]),    # int64 form
        np.array([[0.1 + 2.0**40]]),                         # neither
    ]
    for a in cases:
        want = pm.seq_kernel_form(jnp.asarray(a))
        got = merge.seq_kernel_form(a)
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, np.asarray(want))
