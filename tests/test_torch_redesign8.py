"""The row walk of the merge kernel and the one-block / two-stage EMA
ladder, as their CPU mirrors, against the plain versions they must
reproduce bit for bit and against the Pallas kernels in interpret mode:

* ``scan.ema_tiled_plain`` (a row up to the one-launch limit runs the
  whole ladder; a longer one a tile-local stage over windows with a halo,
  then a ladder along each residue class) against ``scan.ema_plain``;
* ``merge.asof_merge_walk_plain`` (steps of merged positions ranked
  against the next rows of each side alone, each column's last valid row
  carried from step to step) against ``merge.asof_merge_plain``.

Tolerance: none against the plain versions (floats compared as their
integer bit patterns, so -0.0 against +0.0 and NaN payloads count;
indices exactly).  Against the Pallas EMA in interpret mode the bound of
``tests/test_torch_scan.py``: XLA:CPU contracts ``v + d * v_prev`` into
one fused multiply-add, so each of the log2(L) levels may differ by one
rounding of a term no larger than max|x|.  The Pallas merge outputs are
selections: bitwise.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu.ops import pallas_merge as pm
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
# the EMA ladder
# --------------------------------------------------------------------

def _ema_case(seed, K, L, dtype, specials):
    """x over six decades of magnitude, a fifth of the lanes invalid, the
    last row all invalid; with ``specials`` also -0.0 heads and runs, NaN
    and +-inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, L)) * 10.0 ** rng.uniform(-3, 4, (K, L))
    valid = rng.random((K, L)) > 0.2
    valid[-1] = False
    if specials:
        x[:, 0] = -0.0
        valid[:-1, 0] = True
        x[rng.random((K, L)) < 0.1] = -0.0
        for v in (np.nan, np.inf, -np.inf):
            x[rng.random((K, L)) < 0.01] = v
    return torch.from_numpy(x).to(dtype), torch.from_numpy(valid)


# (tile_log2, window_log2, row_log2): small tiles, windows and one-launch
# limits, so both forms and deep second stages show at small L
_FORMS = [(2, 4, 5), (3, 5, 4), (2, 3, 3), (4, 6, 6)]


def _lengths(t, row_log2):
    T = 1 << t
    return sorted({1, 2, T - 1, T, T + 1, (1 << row_log2), (1 << row_log2) + 1,
                   T * 8 - 1, T * 8 + 1, T * 32 + 1, T * 64 - 1, 300})


_EMA = [(f, L) for f in _FORMS for L in _lengths(f[0], f[2])]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form,L", _EMA)
def test_ema_tiled_is_the_ladder_bitwise(form, L, dtype):
    x, valid = _ema_case(L * 31 + form[0], 3, L, dtype, specials=False)
    got = scan.ema_tiled_plain(x, valid, 0.2, *form)
    _same(got, scan.ema_plain(x, valid, 0.2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", [0.2, 1.0])
@pytest.mark.parametrize("L,form", [(1, (2, 4, 5)), (5, (2, 4, 5)),
                                    (33, (2, 4, 5)), (65, (3, 5, 4)),
                                    (129, (2, 3, 3)), (257, (4, 6, 6)),
                                    (200, (2, 4, 5))])
def test_ema_tiled_keeps_signed_zeros_nan_and_inf(L, form, alpha, dtype):
    """One ladder level too many would add d * 0 and turn a -0.0 into
    +0.0; the -0.0 heads and runs show it, NaN and +-inf ride along;
    alpha = 1 makes every valid d exactly 0."""
    x, valid = _ema_case(L + 7, 4, L, dtype, specials=True)
    got = scan.ema_tiled_plain(x, valid, alpha, *form)
    _same(got, scan.ema_plain(x, valid, alpha))
    # the all-invalid row stays +0.0
    assert torch.equal(got[-1].view(BITS[dtype]),
                       torch.zeros(L, dtype=dtype).view(BITS[dtype]))
    if L == 1:
        assert torch.equal(got[:-1, 0].view(BITS[dtype]),
                           torch.full((3,), -0.0, dtype=dtype)
                           .mul(alpha).view(BITS[dtype]))


@pytest.mark.parametrize("L", [1, 1024, 8193, 16384, 16385, 20000])
def test_ema_tiled_at_the_kernel_forms_limits(L):
    """The kernel's own tiles (T = 1024, windows of 8192, one launch up
    to 16,384 lanes) on one row each side of the limits."""
    x, valid = _ema_case(L, 1, L, torch.float32, specials=True)
    x, valid = x.repeat(2, 1), valid.repeat(2, 1)
    valid[1] = ~valid[0]
    _same(scan.ema_tiled_plain(x, valid, 0.3), scan.ema_plain(x, valid, 0.3))


@pytest.mark.parametrize("seed,K,L,alpha,form", [
    (0, 8, 512, 0.2, (2, 4, 5)), (1, 16, 300, 0.05, (3, 5, 4)),
    (2, 5, 129, 0.9, (2, 3, 3)), (3, 3, 1, 0.2, (2, 4, 5)),
])
def test_ema_tiled_matches_pallas_within_fma_bound(seed, K, L, alpha, form):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, L)).astype(np.float32) * 2
    valid = rng.random((K, L)) > 0.2
    want = np.asarray(pk.ema_scan(jnp.asarray(x), jnp.asarray(valid), alpha,
                                  interpret=True))
    got = scan.ema_tiled_plain(torch.from_numpy(x), torch.from_numpy(valid),
                               alpha, *form).numpy()
    bound = max(1, math.ceil(math.log2(L))) * np.spacing(np.abs(x).max())
    assert np.abs(got - want).max() <= bound


def test_ema_kernel_refuses_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        scan.ema_cuda(x, x > 0, 0.2)


# --------------------------------------------------------------------
# the merge join's row walk
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


def _walk_case(layout, seed, dtype):
    """(l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key)."""
    rng = np.random.default_rng(seed)
    K = 3
    l_sid = r_sid = l_key = r_key = None
    if layout == "ties":            # few distinct keys, Ll != Lr
        l_ts, r_ts = _padded(rng, K, 96, 30), _padded(rng, K, 120, 30)
    elif layout == "long_ties":     # runs of equal keys many steps long
        l_ts, r_ts = _padded(rng, K, 160, 3), _padded(rng, K, 140, 3)
    elif layout == "binpack":       # series of 16 a side: edges on step edges
        l_ts, l_sid = _binpacked(rng, K, 128, 16, 40)
        r_ts, r_sid = _binpacked(rng, K, 128, 16, 40)
    elif layout == "seq":           # a sequence tie-break, -inf nulls
        l_ts, r_ts = _padded(rng, K, 100, 25), _padded(rng, K, 110, 25)
        seq = rng.integers(-3, 4, r_ts.shape).astype(np.float64)
        seq[rng.random(seq.shape) < 0.25] = -np.inf
        for k in range(K):
            seq[k] = seq[k][np.lexsort((seq[k], r_ts[k]))]
        l_key, r_key = merge.seq_keys(None, _t(seq), l_ts.shape, r_ts.shape)
    elif layout == "binpack_seq":   # series of 16 a side and a sequence
        l_ts, l_sid = _binpacked(rng, K, 128, 16, 6)
        r_ts, r_sid = _binpacked(rng, K, 128, 16, 6)
        seq = rng.integers(-3, 4, r_ts.shape).astype(np.float64)
        seq[rng.random(seq.shape) < 0.25] = -np.inf
        for k in range(K):
            seq[k] = seq[k][np.lexsort((seq[k], r_ts[k], r_sid[k]))]
        l_key, r_key = merge.seq_keys(None, _t(seq), l_ts.shape, r_ts.shape)
    elif layout == "one_long_row":  # K = 1, many steps
        K = 1
        l_ts, r_ts = _padded(rng, K, 500, 400), _padded(rng, K, 450, 400)
    elif layout == "left_only_tail":  # right rows end early, left go on
        l_ts = _padded(rng, K, 90, 50)
        r_ts = _padded(rng, K, 40, 20)
    else:                           # a row of pads only, and a one-lane side
        l_ts, r_ts = _padded(rng, K, 64, 20), _padded(rng, K, 1, 20)
        l_ts[0] = packing.TS_PAD
    C, Lr = 2, r_ts.shape[1]
    r_valids = rng.random((C, K, Lr)) > 0.3
    r_values = np.where(r_valids, rng.standard_normal((C, K, Lr)), np.nan)
    r_values[rng.random(r_values.shape) < 0.05] = np.nan    # NaN, valid bit set
    if layout.startswith("binpack"):
        r_valids &= r_ts < packing.TS_PAD
    return (_t(l_ts), _t(r_ts), _t(r_valids), _t(r_values).to(dtype),
            _t(l_sid), _t(r_sid), l_key, r_key)


_LAYOUTS = ["ties", "long_ties", "binpack", "seq", "one_long_row",
            "left_only_tail", "pads", "binpack_seq"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("step", [1, 4, 16])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_walk_is_the_plain_join_bitwise(layout, step, skip_nulls, dtype):
    l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key = _walk_case(
        layout, _LAYOUTS.index(layout) * 100 + step, dtype)
    args = (l_ts, r_ts, r_valids, r_values, l_sid, r_sid, l_key, r_key)
    got = merge.asof_merge_walk_plain(*args, skip_nulls=skip_nulls,
                                      step=step)
    want = merge.asof_merge_plain(*args, skip_nulls=skip_nulls)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("step", [3, 8, 1024])
@pytest.mark.parametrize("layout", ["binpack", "seq", "binpack_seq", "ties"])
def test_walk_index_form(layout, step):
    """No values (the index form) at odd and the kernel's own steps."""
    l_ts, r_ts, r_valids, _, l_sid, r_sid, l_key, r_key = _walk_case(
        layout, 9 + step, torch.float64)
    args = (l_ts, r_ts, r_valids, None, l_sid, r_sid, l_key, r_key)
    got = merge.asof_merge_walk_plain(*args, step=step)
    for g, w in zip(got, merge.asof_merge_plain(*args)):
        _same(g, w)


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("layout", ["ties", "binpack", "long_ties"])
def test_walk_matches_pallas_values_bitwise(layout, skip_nulls):
    l_ts, r_ts, r_valids, r_values, l_sid, r_sid, _, _ = _walk_case(
        layout, 5, torch.float32)
    want = pm.asof_merge_values_pallas(
        _j(l_ts), _j(r_ts), _j(r_valids), _j(r_values), _j(l_sid),
        _j(r_sid), skip_nulls=skip_nulls, interpret=True)
    last, col_idx, vals = merge.asof_merge_walk_plain(
        l_ts, r_ts, r_valids, r_values, l_sid, r_sid, skip_nulls=skip_nulls,
        step=8)
    for g, w in zip((vals, col_idx >= 0, last), want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def test_walk_matches_pallas_indices_bitwise():
    l_ts, r_ts, r_valids, *_ = _walk_case("ties", 11, torch.float32)
    want = pm.asof_merge_indices_pallas(_j(l_ts), _j(r_ts), _j(r_valids),
                                        interpret=True)
    got = merge.asof_merge_walk_plain(l_ts, r_ts, r_valids, step=4)[:2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_kernel_refuses_an_unknown_form():
    l_ts, r_ts, r_valids, *_ = _walk_case("ties", 1, torch.float32)
    with pytest.raises(ValueError, match="form"):
        merge.asof_merge_cuda(l_ts, r_ts, r_valids, _form="scan")
