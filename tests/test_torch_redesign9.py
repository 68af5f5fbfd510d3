"""The bucket-stats row form's tiled ladder and the resample EMA's
register ladder, as their CPU mirrors, against the plain versions they
must reproduce bit for bit and against the Pallas kernels in interpret
mode:

* ``bucket.bucket_stats_tiled_plain`` (the forward segmented ladder's
  levels of spans < T on tiles with a T-lane halo, then a ladder along
  each residue class mod T, then each lane's outputs from the planes at
  its bucket's tail) against ``bucket.bucket_stats_plain``, at tiles of
  4 to 32 lanes, so buckets and rows cross many tiles;
* ``bucket.resample_ema_tiled_plain`` (the EMA over the bucket heads by
  the register ladder's one-launch and two-stage forms) against
  ``bucket.resample_ema_plain``.

Tolerance: none against the plain versions; floats are compared as their
integer bit patterns (so -0.0 against +0.0 counts), with every NaN made
the canonical one first, and ``min`` / ``max`` also with every zero made
+0.0: torch's CPU ``minimum`` / ``maximum`` return another NaN payload,
and pick between -0.0 and +0.0 otherwise, in their vectorised loop than
in their scalar tail, so the same two operands give either, by the lane's
position in the tensor (the kernel and the plain version on the card
both use the card's min and max).  Against the Pallas kernels in
interpret mode, the tolerances of ``tests/test_torch_bucket_stats.py``
(``count``, ``min`` and ``max`` bitwise; the rest within 1e-5: the row
centre is summed in another order and interpret mode may contract the
ladders' multiply-adds) and ``tests/test_torch_bucket.py`` (``res``
bitwise; the EMA within ``ceil(log2 L) * spacing(max|x * scale|)``:
XLA:CPU contracts the ladder's ``v + d * v_prev`` into fused
multiply-adds).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_bucket as pb
from tempo_tpu_torch.ops import bucket

STATS = bucket.BUCKET_STATS
BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
DTYPES = [torch.float32, torch.float64]
I32_MAX = 2**31 - 1


def _same(got, want, what, zero_sign=True):
    """Bitwise, NaN payloads aside (and the sign of a zero where
    ``zero_sign`` is False)."""
    def canon(t):
        t = torch.where(torch.isnan(t), float("nan"), t)
        return t if zero_sign else torch.where(t == 0, 0.0, t)
    g, w = canon(got), canon(want)
    assert g.dtype == w.dtype, what
    assert torch.equal(g.view(BITS[g.dtype]), w.view(BITS[w.dtype])), what


def _same_stats(got, want, what):
    for k in STATS:
        _same(got[k], want[k], f"{what} {k}",
              zero_sign=k not in ("min", "max"))


# --------------------------------------------------------------------
# bucket stats: the row form's tiled ladder
# --------------------------------------------------------------------

def _bucket_ids(rng, layout, K, L, T):
    """[K, L] int32 ids, non-decreasing but for the pad tails."""
    if layout == "short":              # buckets shorter than the tile
        runs = rng.integers(1, max(2, T // 2), (K, L))
    elif layout == "tile":             # buckets of exactly the tile
        runs = np.full((K, L), T)
    elif layout == "long":             # buckets longer than the tile
        runs = rng.integers(T + 1, 3 * T + 2, (K, L))
    elif layout == "mixed":            # short runs around one long bucket
        runs = rng.integers(1, 4, (K, L))
        runs[:, min(1, L - 1)] = 2 * T + 3
    else:                              # "one": one bucket spanning the row
        runs = np.full((K, L), L)
    ids = np.stack([np.repeat(np.arange(L), r)[:L] for r in runs])
    if K > 1:                          # a pad tail with an id of its own
        ids[-1, L - L // 4:] = I32_MAX
    return ids.astype(np.int32)


def _bucket_case(seed, layout, K, L, T, C, dtype, specials=True):
    """Ids of ``layout``; values over six decades (standard normal
    without ``specials``), a quarter invalid, row 0 all null; with
    ``specials`` also NaN, +-inf, -0.0 and +0.0 (valid and not)."""
    rng = np.random.default_rng(seed)
    bid = _bucket_ids(rng, layout, K, L, T)
    x = rng.standard_normal((C, K, L))
    if specials:
        x *= 10.0 ** rng.uniform(-3, 4, (C, K, L))
    valid = rng.random((C, K, L)) > 0.25
    valid[:, 0] = False
    if specials:
        for v in (np.nan, np.inf, -np.inf, -0.0, 0.0):
            x[rng.random(x.shape) < 0.03] = v
    if K > 1:
        valid[:, -1, L - L // 4:] = False
        x[:, -1, L - L // 4:] = np.nan
    return (torch.from_numpy(bid), torch.from_numpy(x).to(dtype),
            torch.from_numpy(valid))


def _lengths(T):
    return sorted({1, 2, T - 1, T, T + 1, 3 * T, 8 * T + 1, 33 * T - 1, 300,
                   512})


_LAYOUTS = ["short", "tile", "long", "mixed", "one"]
_TILED = [(t, L) for t in (2, 3, 5) for L in _lengths(1 << t) if L <= 512]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("tile_log2,L", _TILED)
def test_bucket_tiled_is_the_plain_ladder(tile_log2, L, layout, dtype):
    T = 1 << tile_log2
    bid, x, valid = _bucket_case(L * 7 + tile_log2 + _LAYOUTS.index(layout),
                                 layout, 3, L, T, 2, dtype)
    got = bucket.bucket_stats_tiled_plain(bid, x, valid, tile_log2)
    _same_stats(got, bucket.bucket_stats_plain(bid, x, valid),
                f"T={T} L={L} {layout}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_log2", [2, 4, 10])
def test_bucket_tiled_one_lane_and_all_null_rows(tile_log2, dtype):
    """Rows of one lane (each its own bucket), and rows of pads only and
    of nulls only: count 0, NaN elsewhere, as the plain version."""
    for L in (1, 40):
        bid, x, valid = _bucket_case(L, "short", 4, L, 4, 2, dtype,
                                     specials=False)
        bid[1] = I32_MAX                       # an all-pad row
        valid[:, 1:3] = False                  # and an all-null one
        got = bucket.bucket_stats_tiled_plain(bid, x, valid, tile_log2)
        _same_stats(got, bucket.bucket_stats_plain(bid, x, valid), f"L={L}")
        assert (got["count"][:, :3] == 0).all()
        for k in ("mean", "min", "max", "sum", "stddev", "zscore"):
            assert torch.isnan(got[k][:, :3]).all(), k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_log2", [2, 5])
def test_bucket_tiled_stack_equals_single_columns(tile_log2, dtype):
    bid, x, valid = _bucket_case(11, "mixed", 4, 200, 1 << tile_log2, 3,
                                 dtype)
    stacked = bucket.bucket_stats_tiled_plain(bid, x, valid, tile_log2)
    for c in range(3):
        one = bucket.bucket_stats_tiled_plain(bid, x[c:c + 1],
                                              valid[c:c + 1], tile_log2)
        for k in STATS:
            _same(stacked[k][c], one[k][0], f"column {c} {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_bucket_tiled_takes_the_given_centre(dtype):
    """``center`` replaces each row's centre (the card passes its
    kernel's): the same bits as the plain ladder around that centre, and
    the plain version's own centre gives the plain version."""
    bid, x, valid = _bucket_case(5, "long", 3, 300, 8, 2, dtype)
    shift = torch.linspace(-2.0, 3.0, 6, dtype=dtype).reshape(2, 3)
    got = bucket.bucket_stats_tiled_plain(bid, x, valid, 3, center=shift)
    _same_stats(got, bucket._bucket_ladder(bid, x, valid, shift[..., None]),
                "given centre")
    own = bucket._bucket_center(x, valid)[..., 0]
    _same_stats(bucket.bucket_stats_tiled_plain(bid, x, valid, 3, center=own),
                bucket.bucket_stats_plain(bid, x, valid), "own centre")


def _assert_against_pallas(got, want, tol=1e-5):
    for k in STATS:
        g = got[k].double()
        w = torch.from_numpy(np.array(want[k])).double()
        if k in ("count", "min", "max"):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=k)
            continue
        if k == "stddev":
            g, w = g * g, w * w
        elif k == "zscore":
            gs = got["stddev"].double()
            ws = torch.from_numpy(np.array(want["stddev"])).double()
            flat = (gs == 0) | (ws == 0)
            g = torch.where(flat, float("nan"), g * gs)
            w = torch.where(flat, float("nan"), w * ws)
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                   msg=k)


@pytest.mark.parametrize("layout,tile_log2", [("short", 3), ("long", 3),
                                              ("mixed", 4), ("one", 2)])
def test_bucket_tiled_matches_pallas(layout, tile_log2):
    bid, x, valid = _bucket_case(21, layout, 4, 256, 1 << tile_log2, 1,
                                 torch.float32, specials=False)
    want = pb.bucket_stats_pallas(jnp.asarray(bid.numpy()),
                                  jnp.asarray(x[0].numpy()),
                                  jnp.asarray(valid[0].numpy()),
                                  interpret=True)
    got = bucket.bucket_stats_tiled_plain(bid, x, valid, tile_log2)
    _assert_against_pallas({k: v[0] for k, v in got.items()}, want)


def test_bucket_tiled_matches_pallas_packed():
    bid, x, valid = _bucket_case(22, "mixed", 3, 192, 8, 3, torch.float32,
                                 specials=False)
    want = pb.bucket_stats_packed(jnp.asarray(bid.numpy()),
                                  jnp.asarray(x.numpy()),
                                  jnp.asarray(valid.numpy()), interpret=True)
    _assert_against_pallas(bucket.bucket_stats_tiled_plain(bid, x, valid, 3),
                           want)


def test_bucket_kernel_refuses_cpu_tensors():
    bid, x, valid = _bucket_case(1, "short", 2, 64, 8, 1, torch.float32)
    for form in (None, "row"):
        with pytest.raises(ValueError, match="CUDA"):
            bucket.bucket_stats_cuda(bid, x, valid, _form=form)


# --------------------------------------------------------------------
# the resample EMA on the register ladder
# --------------------------------------------------------------------

def _resample_case(seed, K, L, base, gaps, dtype, specials):
    """Seconds from ``base`` (negative: before 1970), x over six decades,
    a quarter invalid, the last row all invalid, a pad tail of wrapped
    seconds on row 0; with ``specials`` also -0.0, NaN and +-inf."""
    rng = np.random.default_rng(seed)
    secs = base + np.cumsum(rng.integers(0, gaps, (K, L)), axis=-1)
    x = rng.standard_normal((K, L)) * 10.0 ** rng.uniform(-3, 4, (K, L))
    valid = rng.random((K, L)) > 0.25
    valid[-1] = False
    secs[0, L - L // 5:] = -(2**31)       # pads: wrapped, never valid
    valid[0, L - L // 5:] = False
    if specials:
        for v in (-0.0, np.nan, np.inf, -np.inf):
            x[rng.random((K, L)) < 0.03] = v
    return (torch.from_numpy(secs.astype(np.int32)),
            torch.from_numpy(x).to(dtype), torch.from_numpy(valid))


# (tile_log2, window_log2, row_log2), as tests/test_torch_redesign8.py
_FORMS = [(2, 4, 5), (3, 5, 4), (2, 3, 3), (4, 6, 6)]
# (base seconds, gap range, step, scale)
_SECS = [(0, 4, 60, None), (-1_000_000_007, 9, 60, 1.5), (-50, 3, 7, 0.3),
         (5, 2, 1, 2.0)]


def _resample_lengths(form):
    T, R = 1 << form[0], 1 << form[2]
    return sorted({1, 2, T + 1, R, R + 1, 8 * T + 1, 300})


_RESAMPLE = [(f, L) for f in _FORMS for L in _resample_lengths(f)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("secs_case", range(len(_SECS)))
@pytest.mark.parametrize("form,L", _RESAMPLE)
def test_resample_tiled_is_the_plain_ladder(form, L, secs_case, dtype):
    base, gaps, step, scale = _SECS[secs_case]
    secs, x, valid = _resample_case(L * 13 + secs_case, 3, L, base, gaps,
                                    dtype, specials=True)
    got = bucket.resample_ema_tiled_plain(secs, x, valid, step, 0.2, scale,
                                          *form)
    want = bucket.resample_ema_plain(secs, x, valid, step, 0.2, scale)
    _same(got[0], want[0], "res")
    _same(got[1], want[1], "ema")


@pytest.mark.parametrize("L", [1, 16384, 16385, 20000])
def test_resample_tiled_at_the_kernel_forms_limits(L):
    """The kernel's own tiles (T = 1024, windows of 8192, one launch up
    to 16,384 lanes) on one row each side of the limit; step 7."""
    secs, x, valid = _resample_case(L, 2, L, -3000, 3, torch.float32,
                                    specials=True)
    got = bucket.resample_ema_tiled_plain(secs, x, valid, 7, 0.3)
    want = bucket.resample_ema_plain(secs, x, valid, 7, 0.3)
    _same(got[0], want[0], "res")
    _same(got[1], want[1], "ema")


@pytest.mark.parametrize("seed,K,L,base,gaps,step,scale,form", [
    (0, 8, 256, 0, 4, 60, None, (2, 4, 5)),
    (1, 4, 200, -1_000_000_007, 9, 60, 1.5, (3, 5, 4)),
    (2, 3, 128, -50, 3, 7, 0.3, (2, 3, 3)),
    (3, 2, 1, 5, 2, 1, 2.0, (2, 4, 5)),
])
def test_resample_tiled_matches_pallas(seed, K, L, base, gaps, step, scale,
                                       form):
    secs, x, valid = _resample_case(seed, K, L, base, gaps, torch.float32,
                                    specials=False)
    want_res, want_ema = pb.resample_ema_pallas(
        jnp.asarray(secs.numpy()), jnp.asarray(x.numpy()),
        jnp.asarray(valid.numpy()), step=step, alpha=0.2,
        scale=None if scale is None else jnp.float32(scale), interpret=True)
    res, ema = bucket.resample_ema_tiled_plain(secs, x, valid, step, 0.2,
                                               scale, *form)
    np.testing.assert_array_equal(res.numpy().view(np.int32),
                                  np.asarray(want_res).view(np.int32))
    xs = x.numpy() * np.float32(1.0 if scale is None else scale)
    bound = max(1, math.ceil(math.log2(L))) * np.spacing(np.abs(xs).max())
    assert np.abs(ema.numpy() - np.asarray(want_ema)).max() <= bound


def test_resample_kernel_refuses_cpu_tensors():
    secs, x, valid = _resample_case(1, 2, 64, 0, 3, torch.float32, False)
    for form in (None, "row"):
        with pytest.raises(ValueError, match="CUDA"):
            bucket.resample_ema_cuda(secs, x, valid, 60, 0.2, _form=form)
