"""The staging ring's redesign in its range-stats and resample-EMA users:
the runs that spread the staged range form over the card
(``ops.stream.ring_runs``), its carried-halo walk
(``ops.window.range_stats_staged_plain``), the resample EMA's ring a warp
(``ops.bucket.resample_ema_warp_runs_plain``), the planners' budgets, and
both staged paths against the reference's engaged ring
(``TEMPO_TPU_DMA_BUFFERS`` 3 and 4, Pallas in interpret mode).

Tolerances: the partition, the budgets and both emulations are exact
(the emulations bitwise against ``range_stats_plain`` and
``resample_ema_plain``, float32 and float64: they run the kernels' op
sequences in the kernels' order).  Against the reference, the tolerances
``tests/test_torch_ring.py`` states: range stats count and clipped
bitwise, the rest within 1e-5; the resample EMA's res bitwise, its EMA
within a log2(L)-spacing bound (interpret mode contracts the ladder into
FMAs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempo_tpu.ops import pallas_window as pw
from tempo_tpu.ops.pallas_bucket import resample_ema_pallas
from tempo_tpu_torch.ops import bucket, stream, window
from tempo_tpu_torch.service import admission

I32_MAX = 2**31 - 1


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(got, want, what):
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    assert torch.equal(_bits(got.nan_to_num(0)), _bits(want.nan_to_num(0))), \
        what


# ----------------------------------------------------------------------
# The runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C, K, L, T, blocks", [
    (1, 1024, 12760, 1024, 528),        # HHAR, four blocks an SM
    (1, 1024, 12760, 1024, 396),        # HHAR, three
    (1, 1, 2**24 + 1, 1024, 528),       # phase I's one series
    (1, 8, 512, 256, 16),               # config 13: a block an item
    (3, 1024, 12760, 512, 924),         # several columns
    (2, 5, 300, 128, 7),                # runs that start mid-row
])
def test_runs_cover_every_item_once_balanced(C, K, L, T, blocks):
    items = C * K * -(-L // T)
    runs = stream.ring_runs(items, min(items, blocks))
    assert runs[0][0] == 0 and runs[-1][1] == items
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))   # contiguous
    sizes = [e - s for s, e in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sum(sizes) == items
    # the kernel's rule: block b starts at b * items // blocks
    B = len(runs)
    assert all(s == b * items // B for b, (s, _) in enumerate(runs))
    # some run starts inside a row: that row's tiles span two blocks
    nt = -(-L // T)
    assert any(s % nt for s, _ in runs)


def test_runs_past_the_items_clamp():
    """The wrapper clamps the grid to the items (the kernel refuses more
    blocks than items); unclamped, a block would get an empty run."""
    assert stream.ring_runs(4, 6).count((0, 0)) >= 1
    runs = stream.ring_runs(4, min(4, 6))
    assert runs == [(0, 1), (1, 2), (2, 3), (3, 4)]


# ----------------------------------------------------------------------
# The carried-halo walk
# ----------------------------------------------------------------------

def _range_case(seed, C=2, K=3, L=300, dt=np.float32):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(0, 3, (K, L)), -1).astype(np.int32)
    secs[-1, L - 17:] = I32_MAX                   # a pad tail
    xs = (rng.standard_normal((C, K, L)) * 5 + 2).astype(dt)
    valids = rng.random((C, K, L)) > 0.2
    valids[0, 1] = False                          # a fully null row
    xs[-1, 0, ::9] = np.nan
    return tuple(torch.from_numpy(a) for a in (secs, xs, valids))


@pytest.mark.parametrize("w, wa, mb, ma, tile, blocks, dt", [
    (10, 0, 10, 0, 32, 1, np.float32),     # narrow halo, one run
    (10, 0, 10, 0, 64, 7, np.float32),     # runs that start mid-row
    (4, 3, 3, 2, 32, 5, np.float32),       # ahead, clipping both sides
    (50, 40, 70, 40, 32, 3, np.float32),   # halos wider than a tile
    (0, 5, 0, 6, 64, 40, np.float32),      # ahead only, a block an item
    (6, 2, 2, 1, 32, 11, np.float64),      # float64, clipping
])
def test_carried_halo_walk_is_bitwise_plain(w, wa, mb, ma, tile, blocks, dt):
    s, x, v = _range_case(tile + blocks, dt=dt)
    scales = [1.0, 2.5]
    want = window.range_stats_plain(s, x, v, w, mb, ma, window_ahead=wa,
                                    scales=scales)
    got = window.range_stats_staged_plain(s, x, v, w, mb, ma,
                                          window_ahead=wa, scales=scales,
                                          tile=tile, blocks=blocks)
    for k in window.STATS + ("clipped",):
        _same(got[k], want[k], k)
    # clipped: the exact count, added across the blocks a row spans
    exact = window.range_stats_plain(s, x.double(), v, w, mb, ma,
                                     window_ahead=wa)["clipped"]
    assert torch.equal(got["clipped"].double(), exact)


def test_carried_halo_walk_at_the_kernels_tiles():
    """A tile of the kernel's (256 lanes, 64 threads of four outputs) with
    rows split across blocks and every lane clipping, at bounds (4, 4)."""
    L, K = 700, 2
    s = (torch.arange(L, dtype=torch.int32) // 2).expand(K, L).contiguous()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, K, L)).astype(np.float32))
    v = torch.ones((1, K, L), dtype=torch.bool)
    want = window.range_stats_plain(s, x, v, 10, 4, 4, window_ahead=10)
    got = window.range_stats_staged_plain(s, x, v, 10, 4, 4,
                                          window_ahead=10, tile=256,
                                          blocks=4)
    for k in window.STATS + ("clipped",):
        _same(got[k], want[k], k)
    assert got["clipped"].flatten().tolist() == [float(L)] * K


# ----------------------------------------------------------------------
# The resample EMA's ring a warp
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("L, tile, depth, offsets, order", [
    (1, 32, 2, (0, 0), "forward"),
    (33, 32, 2, (1, 3), "reverse"),
    (700, 64, 3, (3, 2), "forward"),
    (700, 128, 8, (2, 1), "reverse"),
    (1500, 96, 2, (1, 0), "reverse"),
    (2049, 256, 4, (0, 3), "forward"),
])
def test_warp_runs_are_bitwise_plain(dt, L, tile, depth, offsets, order):
    rng = np.random.default_rng(L + tile)
    K = 2
    secs = torch.from_numpy((np.cumsum(rng.integers(0, 40, (K, L)), -1)
                             - 500).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((K, L)) * 5).to(dt)
    v = torch.from_numpy(rng.random((K, L)) > 0.2)
    want = bucket.resample_ema_plain(secs, x, v, 60, 0.2, 1.5)
    got = bucket.resample_ema_warp_runs_plain(secs, x, v, 60, 0.2, 1.5,
                                              tile=tile, depth=depth,
                                              offsets=offsets, order=order)
    for g, w_, what in zip(got, want, ("res", "ema")):
        _same(g, w_, what)


# ----------------------------------------------------------------------
# The planners' budgets
# ----------------------------------------------------------------------

def test_range_budgets_keep_the_row_forms_threads():
    # 228 KB an SM, 1 KB a block: the row form's 1024 threads an SM in
    # blocks of T / 4 threads
    assert stream.SM_SMEM == 228 * 1024 and stream.BLOCK_RESERVE == 1024
    for T in stream.RANGE_TILES:
        blocks = 4 * 1024 // T
        assert stream.range_smem(T) == stream.SM_SMEM // blocks - 1024
        assert blocks * (stream.range_smem(T) + 1024) <= stream.SM_SMEM
    # the candidates: each tile's own budget, then one block's limit; the
    # asked depth, then 2; the widest tile first
    cand = list(stream.range_candidates(12760, 3))
    assert cand[:3] == [(stream.range_smem(T), T, 3)
                        for T in stream.RANGE_TILES]
    assert cand[3:6] == [(stream.range_smem(T), T, 2)
                         for T in stream.RANGE_TILES]
    assert [c[0] for c in cand[6:]] == [stream.SMEM_LIMIT] * 6
    assert list(stream.range_candidates(256, 8)) == []
    # two windows of the tile and its halo and `depth` slots
    T, mb, ma, L = 512, 10, 0, 12760
    lanes = T + 11 + 1
    assert stream.range_ring_bytes(mb, ma, L, T, 3) == (
        64 + 2 * 16 * (lanes + lanes // 8 + 1)
        + 3 * (2 * (4 * lanes + 16) + (-(-lanes // 16) * 16 + 16)))


@pytest.mark.parametrize("L", [600, 4096, 12760])
def test_range_projection_follows_the_new_candidates(L):
    """Admission's largest range-stats block is still the largest plan
    over every row bound (each bound tried on a grid of them)."""
    step = max(1, L // 400)
    staged = [p.smem for mb in range(0, L, step)
              if (p := stream.range_plan(mb, 0, L)) is not None]
    assert admission.range_stats_smem(L) >= max(
        [admission.RANGE_ROW_SMEM] + staged)
    assert admission.range_stats_smem(L) <= stream.SMEM_LIMIT


@pytest.mark.parametrize("L, plans", [
    (700, [None] * 3),                        # a run of 64 lanes: one item
    (3001, [(128, 2)] * 3),                   # runs of 192 lanes: two items
    (8000, [(256, 2)] * 3),
    (12760, [(256, 2), (256, 3), (256, 2)]),  # depth 8 fits no tile
    (13824, [(128, 2)] * 3),                  # the planes' last fit
    (13825, [None] * 3),
])
def test_resample_plans_within_two_blocks_an_sm(L, plans):
    for depth, want in zip((2, 3, 8), plans):
        p = stream.resample_plan(L, depth)
        assert (None if p is None else (p.tile, p.depth)) == want
        if p is not None:
            assert p.smem == stream.resample_ring_bytes(L, p.tile, p.depth)
            assert p.smem <= stream.BUCKET_SMEM
    # a warp's run: ceil(G / 16) of the row's G segments
    G = -(-L // 32)
    assert stream.resample_run(L) == min(L, 32 * -(-G // 16))


# ----------------------------------------------------------------------
# Against the reference's engaged ring
# ----------------------------------------------------------------------

def _compare_range(got, want):
    for k in window.STATS + ("clipped",):
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("count", "clipped"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("depth", [3, 4])
def test_staged_range_matches_reference_ring(monkeypatch, depth):
    """tests/test_pallas_window.py's ring case (C = 3, K = 4, L = 256,
    ties, NaN runs, pads) against the carried-halo walk at the kernel's
    narrowest tile, rows split over blocks."""
    K, L, C = 4, 256, 3
    rng = np.random.default_rng(depth)
    case = np.random.default_rng(depth)
    secs = np.sort(case.integers(0, 600, (K, L)), axis=-1)
    case.standard_normal((K, L))
    case.random((K, L))
    for k, cut in enumerate(case.integers(L // 2, L, K)):
        secs[k, cut:] = I32_MAX
    secs = secs.astype(np.int32)
    xs = rng.standard_normal((C, K, L)).astype(np.float32)
    valids = rng.random((C, K, L)) > 0.25
    valids[0, -1] = False
    xs[1, 0, ::7] = np.nan
    valids[:, :, L - 32:] = False
    monkeypatch.setenv("TEMPO_TPU_DMA_BUFFERS", str(depth))
    ring_p = pw.range_stats_stream_packed(
        jnp.asarray(secs), jnp.asarray(xs), jnp.asarray(valids),
        jnp.asarray(np.int32(40)), max_behind=30, max_ahead=10,
        interpret=True)
    s, x, v = (torch.from_numpy(a) for a in (secs, xs, valids))
    got = window.range_stats_staged_plain(s, x, v, 40, 30, 10, tile=128,
                                          blocks=5)
    _compare_range(got, ring_p)


@pytest.mark.parametrize("depth", [3, 4])
def test_staged_resample_matches_reference_ring(monkeypatch, depth):
    """tests/test_pallas_bucket.py's ring case, K = 5, L = 256, masked,
    against the ring a warp at the asked depth."""
    rng = np.random.default_rng(33)
    K, L = 5, 256
    secs = np.cumsum(rng.integers(1, 3, (K, L)), -1).astype(np.int32)
    x = rng.standard_normal((K, L)).astype(np.float32)
    valid = rng.random((K, L)) > 0.3
    monkeypatch.setenv("TEMPO_TPU_DMA_BUFFERS", str(depth))
    ring_r = resample_ema_pallas(jnp.asarray(secs), jnp.asarray(x),
                                 jnp.asarray(valid), step=60, alpha=0.2,
                                 interpret=True)
    res, ema = bucket.resample_ema_warp_runs_plain(
        torch.from_numpy(secs), torch.from_numpy(x), torch.from_numpy(valid),
        60, 0.2, tile=32, depth=depth, offsets=(1, 2), order="reverse")
    np.testing.assert_array_equal(res.numpy().view(np.int32),
                                  np.asarray(ring_r[0]).view(np.int32))
    bound = np.ceil(np.log2(L)) * np.spacing(np.abs(x).max())
    assert np.abs(ema.numpy() - np.asarray(ring_r[1])).max() <= bound
