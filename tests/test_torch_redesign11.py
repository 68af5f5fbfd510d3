"""The class stages past a shared-memory class (every row length on the
card) and the bucket-stats staged form's windows, as their CPU mirrors:

* ``scan.class_stages`` (a whole-class ladder along each residue class,
  or the class-index spans < T2 on windows with a T2-entry halo and a
  next stage along the classes mod S T2), run by ``scan.ema_tiled_plain``,
  ``scan.cumsum3_tiled_plain``, ``bucket.resample_ema_tiled_plain`` and
  ``bucket.bucket_stats_tiled_plain`` with ``class_tile_log2`` small, so
  that three stages and more run on rows of at most 512 lanes, against
  the plain ladders they must reproduce bit for bit;
* ``bucket.bucket_windows`` / ``bucket_stats_windowed`` at the kernel's
  span of 1024 lanes: windows that carry their last bucket into the next,
  buckets of up to 1024 lanes across window edges, and rows with a
  longer bucket (left to the row form), against ``bucket_stats_plain``;
* the port against the JAX package's own forms for rows its Pallas
  kernels do not take, on the CPU: ``pallas_kernels.ema_scan`` and
  ``cumsum3`` with ``interpret=False`` (their XLA scans) and
  ``rolling.bucket_stats`` (``windowed_stats`` over the bucket bounds).

Tolerance: none against the plain versions; floats are compared as
their integer bit patterns (so -0.0 against +0.0 counts), every NaN made
the canonical one first, and bucket stats' ``min`` / ``max`` also with
every zero made +0.0 (torch's CPU ``minimum`` / ``maximum`` pick the NaN
payload and the sign of a zero by the lane's position in the tensor, as
``tests/test_torch_redesign9.py`` states).  Against the JAX package, in
float64: its XLA forms associate the sums and products otherwise (an
associative scan, prefix-sum differences), so the EMA and the prefix sums
within 1e-12, bucket stats' count, min and max equal and the rest within
1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu_torch.ops import bucket, scan

STATS = bucket.BUCKET_STATS
BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
DTYPES = [torch.float32, torch.float64]
# tile_log2 = 2 (T = 4 lanes), windows of 16 lanes, one launch to 8
SMALL = dict(tile_log2=2, window_log2=4, row_log2=3)
# the class cut: None (one class stage at these lengths) and T2 = 4, 2
CUTS = [None, 2, 1]
LENGTHS = [9, 64, 65, 257, 500, 512]


def _same(got, want, what, zero_sign=True):
    """Bitwise, NaN payloads aside (and the sign of a zero where
    ``zero_sign`` is False)."""
    def canon(t):
        t = torch.where(torch.isnan(t), float("nan"), t)
        return t if zero_sign else torch.where(t == 0, 0.0, t)
    g, w = canon(got), canon(want)
    assert g.dtype == w.dtype, what
    assert torch.equal(g.view(BITS[g.dtype]), w.view(BITS[w.dtype])), what


def _case(seed, K, L, dtype):
    """Values over six decades, a quarter invalid, with NaN, +-inf, -0.0
    and +0.0 lanes, and a row of -0.0 (its sums and EMA stay -0.0 only if
    no extra level runs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, L)) * 10.0 ** rng.uniform(-3, 4, (K, L))
    for v in (np.nan, np.inf, -np.inf, -0.0, 0.0):
        x[rng.random(x.shape) < 0.03] = v
    x[0] = -0.0
    valid = rng.random((K, L)) > 0.25
    valid[0] = True
    return torch.from_numpy(x).to(dtype), torch.from_numpy(valid)


def test_class_stages_cut():
    """The stages run: one whole-class stage at the kernel's cut; with a
    class tile of 4 entries, windowed stages along the classes mod 4, 16
    and 64 lanes, then a whole one mod 256, at L = 512 and T = 4."""
    seen = []

    def levels(z, end):
        seen.append((tuple(z[0].shape), end))
        return z
    plane = torch.zeros(1, 512)
    scan.class_stages([plane], (0.0,), 512, 4, levels)
    assert seen == [((1, 4, 128), 128)]
    seen.clear()
    scan.class_stages([plane], (0.0,), 512, 4, levels, class_tile_log2=2)
    assert seen == [((1, 4, 32, 8), 4), ((1, 16, 8, 8), 4),
                    ((1, 64, 2, 8), 4), ((1, 256, 2), 2)]
    assert scan.class_whole_max(2) * 1024 == 14_876_672
    assert scan.class_whole_max(3) * 1024 == 9_917_440
    assert scan.class_whole_max(6) * 1024 == 4_958_208


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_ema_class_stages_are_the_ladder(L, cut, dtype):
    x, valid = _case(L + 3, 3, L, dtype)
    for alpha in (0.2, 1.0):
        got = scan.ema_tiled_plain(x, valid, alpha, **SMALL,
                                   class_tile_log2=cut)
        _same(got, scan.ema_plain(x, valid, alpha), f"L={L} cut={cut}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_cumsum3_class_stages_are_the_ladder(L, cut, dtype):
    x, valid = _case(L + 5, 3, L, dtype)
    got = scan.cumsum3_tiled_plain(x, valid, 2, class_tile_log2=cut)
    for g, w in zip(got, scan.cumsum3_plain(x, valid)):
        _same(g, w, f"L={L} cut={cut}")


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_resample_class_stages_are_the_ladder(L, cut):
    rng = np.random.default_rng(L)
    secs = torch.from_numpy(np.cumsum(rng.integers(0, 3, (3, L)), -1)
                            .astype(np.int32))
    x, valid = _case(L + 7, 3, L, torch.float32)
    got = bucket.resample_ema_tiled_plain(secs, x, valid, 3, 0.3, 1.5,
                                          **SMALL, class_tile_log2=cut)
    want = bucket.resample_ema_plain(secs, x, valid, 3, 0.3, 1.5)
    for g, w in zip(got, want):
        _same(g, w, f"L={L} cut={cut}")


def _ids(rng, layout, K, L):
    """[K, L] int32 ids: buckets past T * T2 = 16 lanes (40 lanes, one a
    row), short ones around one long one, and random runs."""
    if layout == "forty":
        runs = np.full((K, L), 40)
    elif layout == "one":
        runs = np.full((K, L), L)
    elif layout == "mixed":
        runs = rng.integers(1, 4, (K, L))
        runs[:, 1] = 3 * 16 + 5
    else:
        runs = rng.integers(1, 70, (K, L))
    return np.stack([np.repeat(np.arange(L), r)[:L] for r in runs]
                    ).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("layout", ["forty", "one", "mixed", "random"])
@pytest.mark.parametrize("L", [65, 300, 512])
def test_bucket_class_stages_are_the_ladder(L, layout, cut, dtype):
    rng = np.random.default_rng(L + len(layout))
    bid = torch.from_numpy(_ids(rng, layout, 3, L))
    x = torch.stack([_case(L + i, 3, L, dtype)[0] for i in range(2)])
    valid = torch.stack([_case(L + i, 3, L, dtype)[1] for i in range(2)])
    got = bucket.bucket_stats_tiled_plain(bid, x, valid, 2,
                                          class_tile_log2=cut)
    want = bucket.bucket_stats_plain(bid, x, valid)
    for k in STATS:
        _same(got[k], want[k], f"{layout} L={L} cut={cut} {k}",
              zero_sign=k not in ("min", "max"))


def _span_rows(rng, L):
    """Rows for the staged form's windows at the kernel's span of 1024:
    buckets of 1 to 1024 lanes that cross window edges, buckets of
    exactly 1024, one of 1025 (long), one bucket a row (long), runs of
    single lanes, and a pad tail."""
    rows = [np.repeat(np.arange(L), rng.integers(1, 1025, L))[:L],
            np.arange(L) // 1024,
            np.repeat(np.arange(L), rng.integers(1, 4, L))[:L],
            np.zeros(L, np.int64),
            np.arange(L)]
    long_row = np.repeat(np.arange(L), rng.integers(1, 300, L))[:L]
    long_row[500:1525] = long_row[500]
    rows.append(np.maximum.accumulate(long_row))
    pad = np.repeat(np.arange(L), rng.integers(1, 600, L))[:L]
    pad[L - 700:] = 2**31 - 1
    rows.append(pad)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("tile", [256, 512, 2048])
def test_staged_windows_at_the_kernel_span(tile):
    """Every window carries its last bucket (open or not) into the next;
    rows with a bucket past 1024 lanes take the whole-row ladder."""
    rng = np.random.default_rng(tile)
    L = 5000
    bid = torch.from_numpy(_span_rows(rng, L))
    K = bid.shape[0]
    regions = [bucket.bucket_windows(bid[k], tile) for k in range(K)]
    assert regions[3] is None and regions[5] is None
    assert all(r is not None for i, r in enumerate(regions) if i not in (3, 5))
    # buckets of exactly 1024 lanes: each window hands one on
    assert all(s % 1024 == 0 and e % 1024 in (0, L % 1024)
               for s, e, _ in regions[1])
    xs = torch.from_numpy(rng.standard_normal((2, K, L)).astype(np.float32)
                          * 10 + 3)
    valids = torch.from_numpy(rng.random((2, K, L)) > 0.25)
    xs[0, 2, ::9] = -0.0
    got = bucket.bucket_stats_windowed(bid, xs, valids, tile)
    want = bucket.bucket_stats_plain(bid, xs, valids)
    for k in STATS:
        _same(got[k], want[k], f"T={tile} {k}", zero_sign=k not in
              ("min", "max"))


def test_ema_matches_reference_xla_form():
    """Rows the reference's Pallas EMA does not take run its XLA
    associative scan (``interpret=False`` on the CPU); the port's
    three-stage mirror within 1e-12 in float64."""
    x, valid = _case(11, 4, 500, torch.float64)
    x = torch.where(torch.isfinite(x), x, 0.0).clamp(-1e3, 1e3)
    want = np.asarray(pk.ema_scan(jnp.asarray(x.numpy()),
                                  jnp.asarray(valid.numpy()), 0.3))
    got = scan.ema_tiled_plain(x, valid, 0.3, **SMALL, class_tile_log2=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_cumsum3_matches_reference_xla_form():
    """The reference's XLA prefix sums (``interpret=False`` on the CPU)
    against the port's three-stage mirror, float64, within 1e-12 of the
    sums' scale."""
    x, valid = _case(12, 4, 500, torch.float64)
    x = torch.where(torch.isfinite(x), x, 0.0).clamp(-1e3, 1e3)
    want = pk.cumsum3(jnp.asarray(x.numpy()), jnp.asarray(valid.numpy()))
    got = scan.cumsum3_tiled_plain(x, valid, 2, class_tile_log2=2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


def test_bucket_stats_match_reference_windowed_form():
    """``rolling.bucket_stats`` on the CPU (``windowed_stats`` over each
    bucket's [start, end)) against the port's three-stage mirror, float64:
    count, min and max equal, the rest within 1e-9."""
    rng = np.random.default_rng(13)
    K, L = 4, 500
    bid = _ids(rng, "random", K, L)
    bid[1] = np.arange(L) // 40
    x = rng.standard_normal((K, L)) * 3 + 10
    valid = rng.random((K, L)) > 0.2
    lanes = np.arange(L)
    head = np.ones((K, L), bool)
    head[:, 1:] = bid[:, 1:] != bid[:, :-1]
    start = np.maximum.accumulate(np.where(head, lanes, 0), axis=1)
    tail = np.ones((K, L), bool)
    tail[:, :-1] = head[:, 1:]
    end = np.minimum.accumulate(np.where(tail, lanes, L)[:, ::-1],
                                axis=1)[:, ::-1] + 1
    want = ref_rolling.bucket_stats(
        jnp.asarray(bid), jnp.asarray(x), jnp.asarray(valid),
        jnp.asarray(start.astype(np.int32)), jnp.asarray(end.astype(np.int32)))
    got = bucket.bucket_stats_tiled_plain(
        torch.from_numpy(bid), torch.from_numpy(x)[None],
        torch.from_numpy(valid)[None], 2, class_tile_log2=2)
    for k in STATS:
        g, w = got[k][0].numpy(), np.asarray(want[k])
        if k in ("count", "min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=k)
