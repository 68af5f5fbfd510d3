"""The port's ``maxLookback`` join (``tempo_tpu_torch.ops.merge.
asof_merge_lookback``, plain version on the CPU) against the reference's
lane-chunked Pallas kernel (``asof_merge_values_chunked`` /
``asof_merge_indices_chunked``) in interpret mode, with 256-lane chunks
so that chunk boundaries (every 128 merged rows) fall inside the data.

The outputs are selections, so they agree bitwise over the real left
lanes (joined values compared as bit patterns, found flags, indices);
the chunked kernel's pad lanes are not part of its contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_merge as pm
from tempo_tpu_torch.ops import merge, sortmerge

from tests.test_torch_merge import TS_PAD, _binpacked, _case

CHUNK = 256


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _seq(rng, r_ts, r_sid=None):
    """A right sequence plane ascending within each (sid?, ts) run: small
    integers with ties, a quarter null (-inf, NULLS FIRST), pads +inf."""
    K, Lr = r_ts.shape
    s = rng.integers(-3, 3, (K, Lr)).astype(np.float64)
    s[rng.random((K, Lr)) < 0.25] = -np.inf
    sid = np.zeros_like(r_ts) if r_sid is None else r_sid
    for k in range(K):
        # the row is sorted by (sid, ts): sorting (sid, ts, s) only
        # permutes s within each run
        s[k] = s[k][np.lexsort((s[k], r_ts[k], sid[k]))]
    return np.where(r_ts < TS_PAD, s, np.inf)


def _inputs(seed, seq, binpack):
    """(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, r_seq) at a small
    shape: a tie-heavy dense case, or skew series bin-packed into shared
    lane rows."""
    rng = np.random.default_rng(seed)
    if binpack:
        l_ts, r_ts, l_sid, r_sid, r_values, r_valids = _binpacked(
            seed, S=23, Lmax=80, C=2)
    else:
        _, l_ts, r_ts, r_valids, r_values = _case(seed, 3, 384, 384, 2,
                                                  ties=True)
        l_sid = r_sid = None
    r_seq = _seq(rng, r_ts, r_sid) if seq else None
    return l_ts, r_ts, r_valids, r_values, l_sid, r_sid, r_seq


def _bitwise(got, want, real, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got[..., real], want[..., real],
                                  err_msg=what)


def _check(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, r_seq, ml,
           skip_nulls):
    want = pm.asof_merge_values_chunked(
        l_ts, r_ts, r_valids, r_values, l_sid=l_sid, r_sid=r_sid,
        r_seq=r_seq, skip_nulls=skip_nulls, max_lookback=ml,
        chunk_lanes=CHUNK, interpret=True)
    last, col_idx, vals = merge.asof_merge_lookback(
        _t(l_ts), _t(r_ts), _t(r_valids), ml, _t(r_values), _t(l_sid),
        _t(r_sid), r_seq=_t(r_seq), skip_nulls=skip_nulls)
    real = l_ts < TS_PAD
    # the reference flattens [C, K, L] / [K, L] by the real mask
    vals_r = np.asarray(want[0])[:, real]
    np.testing.assert_array_equal(vals.numpy()[:, real].view(np.int32),
                                  vals_r.view(np.int32), err_msg="vals")
    np.testing.assert_array_equal((col_idx >= 0).numpy()[:, real],
                                  np.asarray(want[1])[:, real],
                                  err_msg="found")
    np.testing.assert_array_equal(last.numpy()[real],
                                  np.asarray(want[2])[real],
                                  err_msg="last_row_idx")
    return last, col_idx, vals


_MATRIX = [(seq, skip, binpack, ml)
           for seq in (False, True) for skip in (True, False)
           for binpack in (False, True) for ml in (0, 5)]


@pytest.mark.parametrize("seq,skip_nulls,binpack,ml", _MATRIX)
def test_flag_matrix_matches_chunked_pallas_bitwise(seq, skip_nulls, binpack,
                                                    ml):
    """All 16 (seq x skipNulls x binpack x maxLookback) combinations of
    the reference's chunked-join matrix, one seed each."""
    seed = 100 + _MATRIX.index((seq, skip_nulls, binpack, ml))
    _check(*_inputs(seed, seq, binpack), ml, skip_nulls)


@pytest.mark.parametrize("ml", [1, 127, 128, 129, 1000])
def test_horizons_straddling_chunk_rows_match_pallas(ml):
    """Horizons below, at and across the chunked kernel's 128-row chunk
    step: the merged positions are global, not per chunk."""
    _check(*_inputs(ml, seq=False, binpack=False), ml, True)


@pytest.mark.parametrize("binpack", [False, True])
def test_index_form_matches_chunked_pallas(binpack):
    l_ts, r_ts, r_valids, _, l_sid, r_sid, _ = _inputs(7, False, binpack)
    want = pm.asof_merge_indices_chunked(l_ts, r_ts, r_valids, l_sid=l_sid,
                                         r_sid=r_sid, max_lookback=3,
                                         chunk_lanes=CHUNK, interpret=True)
    if binpack:
        got = sortmerge.asof_indices_binpacked(
            _t(l_ts), _t(r_ts), _t(r_valids), _t(l_sid), _t(r_sid),
            max_lookback=3)
    else:
        got = sortmerge.asof_indices_lookback(_t(l_ts), _t(r_ts),
                                              _t(r_valids), 3)
    real = l_ts < TS_PAD
    _bitwise(got[0], want[0], real, "last_row_idx")
    _bitwise(got[1], want[1], real, "per_col_idx")


@pytest.mark.parametrize("skip_nulls", [True, False])
def test_no_horizon_is_the_merge_join_on_every_lane(skip_nulls):
    """``max_lookback = 0`` turns the cap off: the lookback join is the
    plain merge join, pad lanes included (the card's phase B holds the
    two kernels to the same)."""
    l_ts, r_ts, r_valids, r_values, l_sid, r_sid, r_seq = _inputs(
        11, True, True)
    args = (_t(l_ts), _t(r_ts), _t(r_valids))
    kw = dict(r_values=_t(r_values), l_sid=_t(l_sid), r_sid=_t(r_sid),
              r_seq=_t(r_seq), skip_nulls=skip_nulls)
    got = merge.asof_merge_lookback(*args, 0, **kw)
    want = merge.asof_merge(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g,
                           w.view(torch.int32) if w.is_floating_point()
                           else w)


def test_value_form_dispatch_gathers_the_capped_rows():
    """``sortmerge.asof_merge_values(max_lookback=)``, the one-program
    step's form, against the chunked kernel's value form."""
    l_ts, r_ts, r_valids, r_values, _, _, _ = _inputs(5, False, False)
    want = pm.asof_merge_values_chunked(l_ts, r_ts, r_valids, r_values,
                                        max_lookback=2, chunk_lanes=CHUNK,
                                        interpret=True)
    got = sortmerge.asof_merge_values(_t(l_ts), _t(r_ts), _t(r_valids),
                                      _t(r_values), max_lookback=2)
    real = l_ts < TS_PAD
    for g, w, what in zip(got, want, ("vals", "found", "last_row_idx")):
        _bitwise(g.numpy(), w, real, what)


def test_negative_lookback_is_refused():
    l_ts, r_ts, r_valids, _, _, _, _ = _inputs(3, False, False)
    with pytest.raises(ValueError, match="max_lookback"):
        merge.asof_merge_lookback(_t(l_ts), _t(r_ts), _t(r_valids), -1)
