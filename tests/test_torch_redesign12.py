"""The rank kernel's merge-path tiles and the legacy stats kernel's window
walk, as their CPU mirrors, against the plain versions they must
reproduce bit for bit and against the Pallas kernels in interpret mode:

* ``merge.merge_rank_tiled_plain`` (the splits of tiles of ``tile``
  merged positions, then threads ``per_thread`` positions apart, each
  co-ranking its diagonal inside the tile's slices and merging its
  positions in order) against ``merge.merge_rank_plain`` and
  ``np.searchsorted``, with tiles of 8 to 2048 positions, so tie runs,
  skew and pads cross tiles;
* ``stats.legacy_stats_tiled_plain`` (tiles of ``threads * 4`` outputs,
  four consecutive ones a thread, the shared-memory windows over the tile
  and its halo, the walk's head, middle and tail in the legacy order, the
  min/max rule picked by the centre) against ``stats.legacy_stats_plain``
  at the same centres, with tiles of 4 to 16 outputs and windows of 16 to
  40 lanes, so halos cross tiles and windows.

Tolerance: none against the plain versions.  Floats are compared as
their integer bit patterns with every NaN made the canonical one first
(the card's arithmetic returns one NaN, x86 keeps an operand's payload),
and ``min`` / ``max`` also with every zero made +0.0: torch's CPU
``minimum`` / ``maximum`` pick between -0.0 and +0.0 in their vector loop
otherwise than in their scalar tail, by the lane's position (on the card
the kernel and the plain version use the card's min and max, and
``chip_smoke.py`` compares them bitwise).  Against the Pallas kernels in
interpret mode: the rank bitwise (as ``tests/test_torch_windowed.py``);
the legacy stats with ``count`` and ``clipped`` bitwise, ``min`` and
``max`` equal as values, and the rest within 1e-5, as
``tests/test_torch_legacy_stats.py`` states (the row centre is a row sum
reduced in another order; ``stddev`` compared as the variance, ``zscore``
times each side's own ``stddev``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_merge as pm
from tempo_tpu.ops.pallas_stats import range_stats_pallas
from tempo_tpu_torch.ops import merge, stats

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
I32_MAX = 2**31 - 1
KEYS = stats.STATS + ("clipped",)


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
    for k in KEYS:
        _same(got[k], want[k], f"{what} {k}", zero_sign=k not in ("min", "max"))


# --------------------------------------------------------------------
# rank: merge-path tiles
# --------------------------------------------------------------------

def _pad(dt):
    return np.iinfo(dt).max if dt == np.int32 else np.int64(2**62)


def _rank_case(seed, K, Lk, Lq, kdt, qdt, kind):
    """Ascending keys and queries.  ``kind``: "random" (ties, values
    beyond the keys' range, a pad tail at int32 max / 2^62 on row 0),
    "ties" (four values only: runs longer than any tile), "before" /
    "after" (every query below / above every key)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        keys = rng.integers(0, 4, (K, Lk))
        qs = rng.integers(-1, 5, (K, Lq))
    else:
        keys = rng.integers(0, 3 * (Lk + Lq), (K, Lk))
        qs = rng.integers(-5, 3 * (Lk + Lq) + 5, (K, Lq))
        if kind == "before":
            qs = qs - 3 * (Lk + Lq) - 10
        elif kind == "after":
            qs = qs + 3 * (Lk + Lq) + 10
    keys, qs = np.sort(keys, -1).astype(kdt), np.sort(qs, -1).astype(qdt)
    if kind == "random":
        keys[0, Lk // 2:] = _pad(kdt)
        qs[0, Lq - Lq // 3:] = _pad(qdt)
    return keys, qs


def _searchsorted(keys, qs, side):
    dt = np.promote_types(keys.dtype, qs.dtype)
    return np.stack([np.searchsorted(keys[k].astype(dt), qs[k].astype(dt),
                                     side=side) for k in range(len(keys))])


_RANK_SHAPES = [
    (4, 64, 64),
    (3, 500, 7),          # Lk >> Lq
    (3, 7, 500),          # Lq >> Lk
    (5, 1, 40),           # Lk = 1
    (2, 300, 211),
]
_RANK_TYPES = [(np.int32, np.int32), (np.int64, np.int64),
               (np.int32, np.int64), (np.int64, np.int32)]
# (merged positions a tile, positions a thread): the kernel's, and small
# ones that put tile edges inside every case
_RANK_CUTS = [(8, 2), (16, 4), (32, 8), (merge.RANK_TILE, merge.RANK_PER)]


@pytest.mark.parametrize("cut", _RANK_CUTS)
@pytest.mark.parametrize("kind", ["random", "ties", "before", "after"])
@pytest.mark.parametrize("types", _RANK_TYPES)
@pytest.mark.parametrize("shape", _RANK_SHAPES)
def test_rank_tiled_is_the_plain_merge(shape, types, kind, cut):
    K, Lk, Lq = shape
    keys, qs = _rank_case(Lk * 7 + Lq + len(kind), K, Lk, Lq, *types, kind)
    tk, tq = torch.from_numpy(keys), torch.from_numpy(qs)
    for side in ("left", "right"):
        want = merge.merge_rank_plain(tk, tq, side)
        got = merge.merge_rank_tiled_plain(tk, tq, side, tile=cut[0],
                                           per_thread=cut[1])
        assert got.dtype == torch.int64 and got.shape == (K, Lq)
        _same(got, want, f"{shape} {types} {kind} {cut} {side}")
        np.testing.assert_array_equal(got.numpy(),
                                      _searchsorted(keys, qs, side))


def test_rank_tiled_runs_longer_than_many_tiles():
    """One value repeated across many tiles on both sides, with a
    query equal to it: every tile's split lies inside a tie run."""
    keys = np.full((2, 400), 7, np.int32)
    keys[1, :100] = 3
    qs = np.sort(np.array([[7] * 300 + [2, 8] * 10, [3] * 160 + [7] * 160]),
                 -1).astype(np.int32)
    for side in ("left", "right"):
        got = merge.merge_rank_tiled_plain(torch.from_numpy(keys),
                                           torch.from_numpy(qs), side,
                                           tile=16, per_thread=4)
        np.testing.assert_array_equal(got.numpy(),
                                      _searchsorted(keys, qs, side))


def test_rank_tiled_refuses_bad_arguments():
    t = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="side"):
        merge.merge_rank_tiled_plain(t, t, side="middle")
    with pytest.raises(ValueError, match="whole threads"):
        merge.merge_rank_tiled_plain(t, t, tile=10, per_thread=4)
    empty = torch.zeros(1, 0, dtype=torch.int32)
    assert merge.merge_rank_tiled_plain(empty, t).tolist() == [[0] * 4]
    assert merge.merge_rank_tiled_plain(t, empty).shape == (1, 0)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("K,Lk,Lq,kdt,qdt,kind", [
    (4, 128, 128, np.int32, np.int32, "random"),
    (3, 200, 136, np.int64, np.int64, "ties"),
    (3, 160, 96, np.int32, np.int64, "random"),     # promoted
    (2, 384, 8, np.int32, np.int32, "before"),
    (2, 1, 128, np.int32, np.int32, "after"),
])
def test_rank_tiled_matches_pallas_bitwise(K, Lk, Lq, kdt, qdt, kind, side):
    keys, qs = _rank_case(K + Lk + Lq, K, Lk, Lq, kdt, qdt, kind)
    want = np.asarray(pm.merge_rank_pallas(jnp.asarray(keys), jnp.asarray(qs),
                                           side=side, interpret=True))
    got = merge.merge_rank_tiled_plain(torch.from_numpy(keys),
                                       torch.from_numpy(qs), side, tile=16,
                                       per_thread=4)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------
# legacy stats: the window walk in the legacy order
# --------------------------------------------------------------------

def _legacy_case(seed, C, K, L, dtype, specials, gap=3):
    """Ascending int32 keys with ties and INT32_MAX pad tails, row 1 all
    invalid (K > 2); with ``specials`` +-inf, -0.0 and +0.0 values (valid
    and not) and one valid NaN in row 0, which makes that row's centre NaN
    while windows away from it hold finite values only."""
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(0, gap, (K, L)), axis=1).astype(np.int32)
    for k in range(K):
        secs[k, L - rng.integers(0, max(1, L // 4)):] = I32_MAX
    x = rng.standard_normal((C, K, L)) * 3
    valid = rng.random((C, K, L)) > 0.2
    if specials:
        for v in (np.inf, -np.inf, -0.0, 0.0):
            x[rng.random(x.shape) < 0.03] = v
        x[:, 0, L // 3] = np.nan
        valid[:, 0, L // 3] = True
        secs[0, L // 3:] = np.maximum(secs[0, L // 3:], secs[0, L // 3])
    valid &= secs[None] < I32_MAX
    if K > 2:
        valid[:, 1] = False
    return (torch.from_numpy(secs), torch.from_numpy(x).to(dtype),
            torch.from_numpy(valid))


# (window, rows behind, rows ahead)
_LEGACY_BOUNDS = [
    (5, 0, 0),          # the own lane only
    (10, 10, 0),        # phase G's 10 s: head, middle and tail
    (6, 4, 1),          # truncating both ways
    (30, 40, 7),        # a halo past the tile
    (8, 600, 600),      # bounds past the row
    (4, 1, 1),          # bounds below lanes - 1 together: the generic walk
    (12, 2, 0),
]
# (threads, window lanes): tiles of 4 to 16 outputs (4 a thread), one
# window (None) or halos walked over several
_LEGACY_CUTS = [(1, 16), (2, 24), (3, 40), (4, None), (4, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 13, 100, 256])
@pytest.mark.parametrize("bounds", _LEGACY_BOUNDS)
@pytest.mark.parametrize("cut", _LEGACY_CUTS)
def test_legacy_tiled_is_the_plain_sweep(cut, bounds, L, dtype):
    threads, cap = cut
    w, mb, ma = bounds
    for specials in (False, True):
        s, x, v = _legacy_case(L * 31 + mb + threads, 2, 4, L, dtype,
                               specials)
        want = stats.legacy_stats_plain(s, x, v, w, mb, ma)
        got = stats.legacy_stats_tiled_plain(s, x, v, w, mb, ma,
                                             threads=threads, window_cap=cap)
        _same_stats(got, want, f"{cut} {bounds} L={L} specials={specials}")


def test_legacy_tiled_kernel_cuts():
    """The kernel's own tiles (256 threads of 4 lanes) and window (1536
    lanes): one window at phase G's bounds, two at (600, 40)."""
    s, x, v = _legacy_case(11, 2, 3, 500, torch.float32, True, gap=2)
    assert len(stats.legacy_windows(11, 1, 4, 1024, 1536)) == 1
    assert len(stats.legacy_windows(500, 41, 4, 1024, 1536)) == 2
    for w, mb, ma in ((10, 10, 0), (60, 51, 0), (900, 600, 40)):
        want = stats.legacy_stats_plain(s, x, v, w, mb, ma)
        got = stats.legacy_stats_tiled_plain(s, x, v, w, mb, ma)
        _same_stats(got, want, f"({mb}, {ma})")


def test_legacy_windows_cover_the_offsets():
    """Windows partition [-hb, lanes - 1 + ha] from the top down, each
    within the window's lanes."""
    assert stats.legacy_windows(11, 1, 4, 1024, 1536) == [(-11, 4)]
    wins = stats.legacy_windows(601, 41, 4, 1024, 1536)
    span = 1536 - (1024 - 4)
    assert wins[0][1] == 44 and wins[-1][0] == -601
    for (dl, dh), nxt in zip(wins, wins[1:] + [(None, -602)]):
        assert dh - dl + 1 <= span and nxt[1] == dl - 1


def test_legacy_nan_centre_keeps_finite_windows():
    """A valid NaN makes its row's centre NaN, so every centred sum of
    the row is NaN; min and max are over the raw values and stay finite
    in windows that do not reach the NaN."""
    s, x, v = _legacy_case(5, 1, 3, 200, torch.float32, False, gap=2)
    x[0, 0, 50] = float("nan")
    v[0, 0, 50] = True
    for threads, cap in ((2, 24), (4, None)):
        got = stats.legacy_stats_tiled_plain(s, x, v, 10, 10, 0,
                                             threads=threads, window_cap=cap)
        want = stats.legacy_stats_plain(s, x, v, 10, 10, 0)
        _same_stats(got, want, f"nan centre {threads}")
        far = (s[0] > s[0, 50] + 10) & v[0, 0] & (s[0] < I32_MAX)
        assert bool(far.any())
        assert bool(torch.isfinite(got["min"][0, 0][far]).all())
        assert bool(torch.isfinite(got["max"][0, 0][far]).all())
        assert bool(torch.isnan(got["mean"][0, 0][far]).all())
        assert bool(torch.isnan(got["min"][0, 0, 50:52]).all())


def test_legacy_signed_zero_sums():
    """Rows of valid +-0.0 only: centre 0, every centred value a signed
    zero; the sums start at +0.0 and keep the plain version's bits."""
    s, x, v = _legacy_case(6, 2, 4, 64, torch.float64, False, gap=2)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.where(rng.random(x.shape) < 0.5, -0.0, 0.0))
    for mb, ma in ((10, 0), (4, 1)):
        want = stats.legacy_stats_plain(s, x, v, 8, mb, ma)
        got = stats.legacy_stats_tiled_plain(s, x, v, 8, mb, ma, threads=2,
                                             window_cap=16)
        _same_stats(got, want, f"zeros ({mb}, {ma})")


def test_legacy_tiled_clips_like_the_plain_sweep():
    """Tie-heavy keys with bounds too small both ways: the audit counts
    the same rows, and some."""
    s, x, v = _legacy_case(3, 1, 5, 300, torch.float32, False, gap=2)
    want = stats.legacy_stats_plain(s, x, v, 20, 3, 1)
    for threads, cap in ((1, 16), (4, None)):
        got = stats.legacy_stats_tiled_plain(s, x, v, 20, 3, 1,
                                             threads=threads, window_cap=cap)
        assert float(want["clipped"].sum()) > 0
        _same_stats(got, want, "truncating")


def test_legacy_plain_takes_given_centres():
    """``_centers`` set to the plain version's own centres gives the same
    bits; other centres move only the centred stats."""
    s, x, v = _legacy_case(8, 2, 4, 100, torch.float32, True)
    base = stats.legacy_stats_plain(s, x, v, 10, 6, 2)
    nv = v.to(x.dtype).sum(-1)
    own = torch.where(v, x, 0.0).sum(-1) / torch.clamp(nv, min=1)
    _same_stats(stats.legacy_stats_plain(s, x, v, 10, 6, 2, _centers=own),
                base, "own centres")
    moved = stats.legacy_stats_plain(s, x, v, 10, 6, 2, _centers=own + 1)
    for k in ("count", "min", "max", "clipped"):
        _same(moved[k], base[k], k, zero_sign=k not in ("min", "max"))
    tiled = stats.legacy_stats_tiled_plain(s, x, v, 10, 6, 2, threads=2,
                                           window_cap=24, _centers=own + 1)
    _same_stats(tiled, moved, "moved centres")


def _compare_pallas(got, want):
    for k in KEYS:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("count", "clipped"):
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=k)
        elif k in ("min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            if k == "stddev":
                g, w = g * g, w * w
            elif k == "zscore":
                g = g * got["stddev"].numpy()
                w = w * np.asarray(want["stddev"])
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("w,mb,ma", [(5, 0, 0), (10, 10, 0), (6, 4, 1),
                                     (30, 40, 7)])
def test_legacy_tiled_matches_pallas_interpret(w, mb, ma):
    """Float32 [6, 256] rows with the NaN-centre row, +-inf, signed zeros
    and an all-invalid row; the tiled mirror at tiles of 12 outputs and
    windows of 40 lanes."""
    s, x, v = _legacy_case(w + mb, 1, 6, 256, torch.float32, True, gap=2)
    want = range_stats_pallas(jnp.asarray(s.numpy()), jnp.asarray(x[0].numpy()),
                              jnp.asarray(v[0].numpy()), jnp.int32(w), mb, ma,
                              interpret=True)
    got = stats.legacy_stats_tiled_plain(s, x, v, w, mb, ma, threads=3,
                                         window_cap=40)
    if (mb, ma) == (4, 1):
        assert float(got["clipped"].sum()) > 0
    _compare_pallas({k: t[0] for k, t in got.items()}, want)
