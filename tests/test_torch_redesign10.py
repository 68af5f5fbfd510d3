"""The range-stats kernel's register walk and the valid-index scans'
segmented scan, as their CPU mirrors, against the plain versions they
must reproduce bit for bit and against the Pallas kernels in interpret
mode:

* ``window.range_stats_tiled_plain`` (tiles of ``threads * lanes``
  outputs, ``lanes`` consecutive ones a thread, the shared-memory windows
  over the tile and its halo, the walk's head, middle and tail, steps
  past the row skipped) against ``window.range_stats_plain`` at the same
  centres, with tiles of 4 to 16 outputs and windows of 16 to 40 lanes,
  so halos cross tiles and windows;
* ``scan.index_scan_tiled_plain`` (16-lane segments cut on the row's
  address, the warp and block combine, the carry over tiles) against the
  plain valid-index scans and forward fill.

Tolerance: none against the plain versions.  Floats are compared as
their integer bit patterns with every NaN made the canonical one first
(the card's arithmetic returns one NaN, x86 keeps an operand's payload),
and ``min`` / ``max`` also with every zero made +0.0: torch's CPU
``minimum`` / ``maximum`` pick between -0.0 and +0.0 in their vector loop
otherwise than in their scalar tail, by the lane's position (the kernel
and the plain version on the card both use the card's min and max).
Against the Pallas kernels in interpret mode, the tolerances of
``tests/test_torch_window.py`` (``count`` and ``clipped`` bitwise, the
rest within 1e-5: the row centre is summed in another order) and
``tests/test_torch_index_scan.py`` (bitwise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu.ops import pallas_window as pw
from tempo_tpu_torch.ops import scan, window

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
I32_MAX = 2**31 - 1


def _same(got, want, what, zero_sign=True):
    def canon(t):
        t = torch.where(torch.isnan(t), float("nan"), t)
        return t if zero_sign else torch.where(t == 0, 0.0, t)
    if not got.is_floating_point():
        assert got.dtype == want.dtype and torch.equal(got, want), what
        return
    g, w = canon(got), canon(want)
    assert g.dtype == w.dtype, what
    assert torch.equal(g.view(BITS[g.dtype]), w.view(BITS[w.dtype])), what


def _same_stats(got, want, what):
    for k in window.STATS + ("clipped",):
        _same(got[k], want[k], f"{what} {k}", zero_sign=k not in ("min",
                                                                   "max"))


# --------------------------------------------------------------------
# range stats: the kernel's tiles, windows and register walk
# --------------------------------------------------------------------

def _range_case(seed, C, K, L, dtype, specials, gap=3):
    """Ascending int32 keys with ties and INT32_MAX pad tails; row 0 all
    null and row 1 all pad (K > 2); with ``specials`` also NaN, +-inf,
    -0.0 and +0.0 values (valid and not)."""
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(0, gap, (K, L)), axis=1).astype(np.int32)
    for k in range(K):
        secs[k, L - rng.integers(0, max(1, L // 4)):] = I32_MAX
    x = rng.standard_normal((C, K, L)) * 3
    valid = rng.random((C, K, L)) > 0.2
    if specials:
        for v in (np.nan, np.inf, -np.inf, -0.0, 0.0):
            x[rng.random(x.shape) < 0.03] = v
    valid &= secs[None] < I32_MAX
    if K > 2:
        valid[:, 0] = False
        secs[1] = I32_MAX
        valid[:, 1] = False
    return (torch.from_numpy(secs), torch.from_numpy(x).to(dtype),
            torch.from_numpy(valid))


# (window, rows behind, rows ahead, window ahead)
_BOUNDS = [
    (10, 10, 0, 0),         # phase C/H: head, middle and tail behind
    (10, 4, 2, 6),          # below lanes - 1 both ways: the generic walks
    (30, 40, 0, 0),         # a halo past the tile
    (6, 600, 600, 4),       # bounds past the row
    (8, 12, 9, 5),          # a forward window: head, middle, tail ahead
    (5, 7, 7, 3),           # bounds of exactly lanes - 1: no middle
    (3, 0, 0, 0),           # no neighbour: the own lane only
]
# (threads, lanes a thread, window lanes): one window (the staged form),
# or halos walked over several windows (the row form past its window);
# the kernel's 4 lanes a thread, and 8
_CUTS = [(4, 4, None), (4, 4, 40), (1, 4, 16), (2, 8, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 7, 33, 200])
@pytest.mark.parametrize("bounds", _BOUNDS)
@pytest.mark.parametrize("cut", _CUTS)
def test_range_tiled_is_the_plain_sweep(cut, bounds, L, dtype):
    threads, lanes, cap = cut
    w, mb, ma, wa = bounds
    for specials in (False, True):
        s, x, v = _range_case(L * 31 + mb + threads, 2, 4, L, dtype, specials)
        want = window.range_stats_plain(s, x, v, w, mb, ma, window_ahead=wa)
        got = window.range_stats_tiled_plain(s, x, v, w, mb, ma,
                                             window_ahead=wa, threads=threads,
                                             lanes=lanes, window_cap=cap)
        _same_stats(got, want, f"{cut} {bounds} L={L} specials={specials}")


@pytest.mark.parametrize("cut", _CUTS)
def test_range_tiled_clips_like_the_plain_sweep(cut):
    """Truncating bounds both ways: the audit counts the same rows."""
    s, x, v = _range_case(3, 1, 5, 300, torch.float32, False, gap=2)
    want = window.range_stats_plain(s, x, v, 20, 3, 2, window_ahead=20)
    got = window.range_stats_tiled_plain(s, x, v, 20, 3, 2, window_ahead=20,
                                         threads=cut[0], lanes=cut[1],
                                         window_cap=cut[2])
    assert float(want["clipped"].sum()) > 0
    _same_stats(got, want, "truncating")


def test_range_tiled_kernel_cuts():
    """The kernel's own tiles (256 threads of 4 lanes) and window (2048
    lanes): one window at phase C's bounds, several past them."""
    s, x, v = _range_case(9, 1, 3, 2500, torch.float32, True, gap=2)
    for mb, ma in ((10, 0), (1100, 40), (2600, 0)):
        want = window.range_stats_plain(s, x, v, 900, mb, ma, window_ahead=30)
        for cap in (window.ROW_WINDOW, None):
            got = window.range_stats_tiled_plain(s, x, v, 900, mb, ma,
                                                 window_ahead=30,
                                                 window_cap=cap)
            _same_stats(got, want, f"({mb}, {ma}) cap {cap}")


def test_range_windows_cover_the_offsets():
    """Behind windows partition [-hb, lanes - 1] top down, ahead ones
    [1, lanes - 1 + ha] bottom up, each within the window's lanes."""
    assert window.range_windows(11, 1, 4, 1024, 2048) == [("one", -11, 4)]
    wins = window.range_windows(14576, 1, 4, 1024, 2048)
    behind = [(dl, dh) for k, dl, dh in wins if k == "behind"]
    ahead = [(dl, dh) for k, dl, dh in wins if k == "ahead"]
    assert behind[0][1] == 3 and behind[-1][0] == -14576
    assert all(a[1] == b[0] - 1 for a, b in zip(behind[1:], behind))
    assert ahead == [(1, 4)]
    assert all(1024 - 4 + dh - dl + 1 <= 2048 for _, dl, dh in wins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_range_plain_takes_the_given_centres(dtype):
    """``_centers`` replaces each row's centre: the plain version's own
    centres give the plain version, and a shifted centre gives the same
    bits through the mirror as through the plain sweep."""
    s, x, v = _range_case(4, 2, 4, 120, dtype, True)
    plain = window.range_stats_plain(s, x, v, 12, 9, 3, window_ahead=2)
    own = window._center(x, v)[..., 0]
    _same_stats(window.range_stats_plain(s, x, v, 12, 9, 3, window_ahead=2,
                                         _centers=own), plain, "own centre")
    shift = own + torch.linspace(-2.0, 3.0, 8, dtype=dtype).reshape(2, 4)
    _same_stats(window.range_stats_tiled_plain(s, x, v, 12, 9, 3,
                                               window_ahead=2, threads=2,
                                               window_cap=24, _centers=shift),
                window.range_stats_plain(s, x, v, 12, 9, 3, window_ahead=2,
                                         _centers=shift), "shifted centre")


def _against_pallas(got, want):
    for k in window.STATS + ("clipped",):
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("count", "clipped"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("form,bounds,cut", [
    ("unrolled", (10, 12, 4, 0), (4, 4, None)),
    ("stream", (5, 6, 6, 0), (2, 8, 40)),
    ("stream", (30, 40, 3, 0), (1, 4, 16)),
    ("unrolled", (20, 3, 0, 0), (4, 4, 40)),
])
def test_range_tiled_matches_pallas(form, bounds, cut):
    w, mb, ma, _ = bounds
    s, x, v = _range_case(17, 1, 4, 256, torch.float32, False)
    fn = pw.range_stats_unrolled if form == "unrolled" else \
        pw.range_stats_stream
    want = fn(jnp.asarray(s.numpy()), jnp.asarray(x[0].numpy()),
              jnp.asarray(v[0].numpy()), w, mb, ma, interpret=True)
    got = window.range_stats_tiled_plain(s, x, v, w, mb, ma, threads=cut[0],
                                         lanes=cut[1], window_cap=cut[2])
    _against_pallas({k: t[0] for k, t in got.items()}, want)


def test_range_tiled_matches_pallas_packed():
    s, x, v = _range_case(23, 3, 4, 200, torch.float32, False)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    want = pw.range_stats_stream_packed(
        jnp.asarray(s.numpy()), jnp.asarray(x.numpy()),
        jnp.asarray(v.numpy()), 8, 10, 3, scales=jnp.asarray(scales),
        interpret=True)
    got = window.range_stats_tiled_plain(s, x, v, 8, 10, 3,
                                         scales=torch.from_numpy(scales),
                                         threads=2, window_cap=24)
    _against_pallas(got, want)


def test_range_kernel_refuses_cpu_tensors():
    s, x, v = _range_case(1, 1, 2, 64, torch.float32, False)
    for form in (None, "row"):
        with pytest.raises(ValueError, match="CUDA"):
            window.range_stats_cuda(s, x, v, 10, 4, 0, _form=form)


# --------------------------------------------------------------------
# the valid-index scans and the forward fill
# --------------------------------------------------------------------

def _scan_case(seed, K, L):
    """Masks of every density, an all-False row 0 and an all-True row 1;
    x with NaN at some lanes (copied as they are)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((K, L)) > rng.uniform(0.0, 1.0, (K, 1))
    valid[0] = False
    valid[1] = True
    x = rng.standard_normal((K, L)).astype(np.float32)
    x[rng.random((K, L)) < 0.1] = np.nan
    return torch.from_numpy(valid), torch.from_numpy(x)


_SCANS = ["last_valid_index", "first_valid_index", "last_valid_scan"]


def _scan_plain(kind, valid, x):
    if kind == "last_valid_index":
        return scan.last_valid_index_scan_plain(valid)
    if kind == "first_valid_index":
        return scan.first_valid_index_scan_plain(valid)
    return scan.last_valid_scan_plain(x, valid)


def _scan_tiled(kind, valid, x, **kw):
    if kind == "last_valid_scan":
        return scan.index_scan_tiled_plain(valid, x=x, **kw)
    return scan.index_scan_tiled_plain(valid, kind == "first_valid_index",
                                       **kw)


@pytest.mark.parametrize("kind", _SCANS)
@pytest.mark.parametrize("L", [1, 5, 15, 16, 17, 100, 512])
@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("seg,threads", [(16, 32), (16, 128), (4, 32)])
def test_index_scan_tiled_is_the_plain_scan(seg, threads, offset, L, kind):
    """Rows starting 0 or 8 bytes into a 16-byte word (L = 19,304 puts
    every other row at 8), widths below, at and past one segment, tiles
    of 128 to 2048 lanes (so the carry joins several)."""
    valid, x = _scan_case(L * 3 + offset, 7, L)
    got = _scan_tiled(kind, valid, x, offset=offset, threads=threads, seg=seg)
    want = _scan_plain(kind, valid, x)
    if kind == "last_valid_scan":
        _same(got[0], want[0], "values")
        _same(got[1], want[1], "has")
    else:
        _same(got, want, kind)


@pytest.mark.parametrize("kind", _SCANS)
@pytest.mark.parametrize("seed,K,L", [(0, 8, 256), (1, 5, 200), (2, 3, 1)])
def test_index_scan_tiled_matches_pallas(kind, seed, K, L):
    valid, x = _scan_case(seed, K, L)
    got = _scan_tiled(kind, valid, x, threads=32, seg=4)
    if kind == "last_valid_scan":
        want_v, want_h = pk.last_valid_scan(jnp.asarray(x.numpy()),
                                            jnp.asarray(valid.numpy()),
                                            interpret=True)
        np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                      np.asarray(want_v).view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_h))
    else:
        want = getattr(pk, kind + "_scan")(jnp.asarray(valid.numpy()),
                                           interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_index_scan_kernels_refuse_cpu_tensors():
    valid, x = _scan_case(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        scan.last_valid_index_scan_cuda(valid)
    with pytest.raises(ValueError, match="CUDA"):
        scan.first_valid_index_scan_cuda(valid)
    with pytest.raises(ValueError, match="CUDA"):
        scan.last_valid_scan_cuda(x, valid)
