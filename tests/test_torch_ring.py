"""The staging ring's knob and planner (``tempo_tpu_torch.ops.stream``),
the staged bucket form's tile-local ladder (``ops/bucket.
bucket_stats_windowed``), and the plain versions of the ring's three
users against the reference's ring path (``TEMPO_TPU_DMA_BUFFERS`` 3
and 4, Pallas in interpret mode).

Tolerances: the knob, the planner's picks and the window emulation are
exact (the emulation bitwise against ``bucket_stats_plain`` in float32:
a segmented ladder combines a bucket's lanes in a tree fixed by their
offsets from the bucket's head).  Against the reference, the tolerances
the port's tests already state: bucket stats as in
``test_torch_bucket_stats.py`` (count/min/max bitwise, the rest within
1e-5, stddev as the variance, zscore as ``x - mean``), range stats as in
``test_torch_window.py`` (count and clipped bitwise, the rest within
1e-5), the resample EMA as in ``test_torch_resample.py`` (res bitwise,
the EMA within a log2(L)-spacing bound: interpret mode contracts the
ladder into FMAs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempo_tpu.tune
from tempo_tpu.ops import pallas_stream
from tempo_tpu.ops import pallas_window as pw
from tempo_tpu.ops.pallas_bucket import (bucket_stats_pallas,
                                         resample_ema_pallas)
from tempo_tpu_torch.ops import bucket, stream, window

STATS = bucket.BUCKET_STATS
I32_MAX = 2**31 - 1


@pytest.mark.parametrize("env", [None, "1", "2", "5", "8", "12"])
def test_dma_buffers_matches_reference(monkeypatch, env):
    monkeypatch.setattr(tempo_tpu.tune, "knob_value", lambda *a, **k: None)
    if env is None:
        monkeypatch.delenv("TEMPO_TPU_DMA_BUFFERS", raising=False)
    else:
        monkeypatch.setenv("TEMPO_TPU_DMA_BUFFERS", env)
    assert stream.dma_buffers() == pallas_stream.dma_buffers()


@pytest.mark.parametrize("depth,tile", [(2, 2048), (3, 1024), (4, 1024),
                                        (8, 512)])
def test_bucket_plan_at_phase_h_width(depth, tile):
    """[3, 1024, 12760]: a slot holds a window's ids and each column's x
    and valid, T * (4 + 5C) bytes (plus 16 B of alignment slack a plane);
    the rest is the carry (1024 lanes of ids and of each column's x and
    valid), 5 + 2C words a 32-lane segment of the largest region (the
    carry and the tile), four pointers a column and six planes of 512
    bucket totals.  The budget is two blocks an SM (115,712 B):
    T = 2048 fits depth 2 (114,304 B) but not 3; the planner lowers T
    before the depth: T = 1024 at depths 3 and 4, T = 512 at depth 8
    (112,864 B)."""
    plan = stream.bucket_plan(3, 12760, depth)
    assert (plan.tile, plan.depth) == (tile, depth)
    assert plan.smem <= stream.BUCKET_SMEM
    T, C = tile, 3
    slot = stream.bucket_ring_bytes(C, T, depth + 1) - plan.smem
    assert slot - T * (4 + 5 * C) == 16 * (1 + 2 * C)
    G = (stream.BUCKET_SPAN + T) // 32
    segs = 4 * (5 + 2 * C) * G
    assert plan.smem - depth * slot == (64 + 128 + segs + (-segs) % 16
                                        + 32 * C + 24 * 512
                                        + (4 + 5 * C) * stream.BUCKET_SPAN)
    assert stream.bucket_ring_bytes(C, 2048, 3) > stream.BUCKET_SMEM
    assert 2 * (stream.BUCKET_SMEM + 1024) == 228 * 1024


def test_range_and_resample_plans():
    # phase C/H: 10 s window, 10 rows behind, 0 ahead.  Range stats keep
    # the row form's threads an SM (four blocks of 256 at T = 1024):
    # two windows of the tile and its halo (1,036 lanes, 18,656 B each)
    # and two slots (9,376 B each) fit 57,344 B; a third slot does not,
    # nor does any narrower tile at depth 3 or 8 within its own budget,
    # so every depth settles on depth 2
    for depth in (2, 3, 8):
        p = stream.range_plan(10, 0, 12760, depth)
        assert (p.tile, p.depth) == (1024, 2)
        assert p.smem == 64 + 2 * 18_656 + 2 * 9_376
        assert p.smem <= stream.range_smem(1024) == 57_344
    assert [stream.range_smem(T) for T in stream.RANGE_TILES] == [
        57_344, 28_160, 13_568]
    # a halo past the windows' and slots' room: the row form, at every
    # depth (each window takes 18 B a lane of the tile and halo, each slot
    # 9 B more); 4,042 rows behind is the widest that still stages
    assert stream.range_plan(6_500, 0, 102_056, 2) is None
    assert stream.range_plan(6_500, 0, 102_056, 8) is None
    assert stream.range_plan(4_043, 0, 102_056, 8) is None
    assert stream.range_plan(4_042, 0, 102_056, 8) == stream.RingPlan(
        256, 2, stream.range_ring_bytes(4_042, 0, 102_056, 256, 2))
    # phase E: the register ladder takes 102,176 B (8 B a lane and 16 B a
    # plane for the staged words of a row off 16 bytes); beside it, within
    # two blocks an SM (115,712 B), a ring a warp: depth barriers and
    # slots of an item's T valid bytes, 128 d + 16 d (T + 16) bytes
    want = {2: (256, 2), 3: (256, 3), 4: (128, 4), 8: (256, 2)}
    for depth, (tile, d) in want.items():
        p = stream.resample_plan(12760, depth)
        assert (p.tile, p.depth) == (tile, d)
        assert p.smem <= stream.BUCKET_SMEM
        assert stream.resample_ring_bytes(12760, tile, 0) == 102_176
        assert p.smem - 102_176 == 128 * d + 16 * d * (tile + 16)
    # the ladder's planes past two blocks an SM (13,824 lanes), and past
    # the one-launch ladder (16,384 lanes), phase F's rows among them: the
    # row form, at every depth
    assert stream.resample_plan(13_824, 8) == stream.RingPlan(
        128, 2, stream.resample_ring_bytes(13_824, 128, 2))
    assert stream.resample_plan(13_825, 2) is None
    assert stream.resample_plan(16_385, 2) is None
    assert stream.resample_plan(102_056, 2) is None


def test_planner_falls_back_like_plan_with_ring():
    # one tile has nothing to overlap (ring_plan's fewer-than-two-slabs)
    assert stream.bucket_plan(1, 200, 8) is None
    assert stream.range_plan(4, 0, 256, 2) is None
    assert stream.resample_plan(128, 8) is None
    # the widest tile that gives two tiles, the depth clamped to them
    p = stream.range_plan(4, 0, 600, 8)
    assert (p.tile, p.depth) == (512, 2)
    # the knob's depth is the default; out of range clamps
    assert stream.bucket_plan(1, 5000, 99).depth == 3
    # depth 2 when the asked depth fits no tile: C = 10 columns
    p = stream.bucket_plan(10, 12760, 8)
    assert (p.tile, p.depth) == (256, 2)
    assert stream.bucket_plan(14, 12760, 2) is None


def _bucket_rows(rng, L, T):
    """Rows of ids that exercise the window cuts: random runs, a bucket
    longer than T, buckets of T / 2 (windows end exactly at a tail), one
    bucket per row, a fully null row and pad tails."""
    rows = []
    runs = rng.integers(1, T // 2, L)
    rows.append(np.repeat(np.arange(L), runs)[:L])
    long_row = np.repeat(np.arange(L), rng.integers(1, 6, L))[:L]
    long_row[L // 3:L // 3 + T + 5] = long_row[L // 3]
    rows.append(np.maximum.accumulate(long_row))
    rows.append(np.arange(L) // (T // 2))
    rows.append(np.zeros(L, np.int64))
    rows.append(np.repeat(np.arange(L), rng.integers(1, T, L))[:L])
    pad = np.repeat(np.arange(L), rng.integers(1, 9, L))[:L]
    pad[L - L // 5:] = I32_MAX
    rows.append(pad)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("T", [16, 32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_window_emulation_is_bitwise_the_row_ladder(seed, T):
    """The windows at a carry of ``span = T`` lanes, so that rows go long
    at L = 300 (the kernel's span is 1024: test_torch_redesign11.py)."""
    rng = np.random.default_rng(seed)
    L = 300
    bid = _bucket_rows(rng, L, T)
    K = bid.shape[0]
    C = 2
    xs = (rng.standard_normal((C, K, L)) * 10 + 3).astype(np.float32)
    valids = rng.random((C, K, L)) > 0.25
    valids[:, 4] = False                      # a fully null row
    valids[:, 5, L - L // 5:] = False          # the pad tail
    xs[:, 5, L - L // 5:] = np.nan
    b, x, v = (torch.from_numpy(a) for a in (bid, xs, valids))
    assert bucket.bucket_windows(b[1], T, T) is None     # longer than T
    assert bucket.bucket_windows(b[3], T, T) is None     # one bucket
    # buckets of T / 2: each window leaves its last bucket to the next
    h = T // 2
    nw = -(-L // T)
    assert bucket.bucket_windows(b[2], T, T) == [
        (max(0, w * T - h), min(L, (w + 1) * T) if w == nw - 1
         else (w + 1) * T - h, min(L, (w + 1) * T)) for w in range(nw)]
    got = bucket.bucket_stats_windowed(b, x, v, T, T)
    want = bucket.bucket_stats_plain(b, x, v)
    for k in STATS:
        assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k])), k
        assert torch.equal(got[k].nan_to_num(0).view(torch.int32),
                           want[k].nan_to_num(0).view(torch.int32)), k


def test_window_chain_bound():
    """The regions: ceil(L / T) windows, each starting at a bucket head,
    at most span + T lanes long, their outputs cutting [0, L) in order
    (the kernel's carry holds at most span lanes)."""
    rng = np.random.default_rng(3)
    T, L, span = 32, 2000, 40
    for _ in range(20):
        ids = np.repeat(np.arange(L), rng.integers(1, span + 1, L))[:L]
        regions = bucket.bucket_windows(torch.from_numpy(ids), T, span)
        assert regions is not None
        assert len(regions) == -(-L // T)
        assert regions[0][0] == 0 and regions[-1][1:] == (L, L)
        for (s, e, end), nxt in zip(regions, regions[1:] + [(L,)]):
            assert s == 0 or ids[s] != ids[s - 1]
            assert s <= e <= end and end - s <= span + T
            assert nxt[0] == e


def _assert_bucket(got, want, tol=1e-5):
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


@pytest.mark.parametrize("depth", [3, 4])
def test_bucket_and_resample_match_reference_ring(monkeypatch, depth):
    """tests/test_pallas_bucket.py's ring case, K = 5, L = 256, masked."""
    rng = np.random.default_rng(33)
    K, L = 5, 256
    secs = np.cumsum(rng.integers(1, 3, (K, L)), -1).astype(np.int64)
    x = rng.standard_normal((K, L)).astype(np.float32)
    valid = rng.random((K, L)) > 0.3
    bid = (secs // 60).astype(np.int32)
    monkeypatch.setenv("TEMPO_TPU_DMA_BUFFERS", str(depth))
    ring_b = bucket_stats_pallas(jnp.asarray(bid), jnp.asarray(x),
                                 jnp.asarray(valid), interpret=True)
    ring_r = resample_ema_pallas(
        jnp.asarray(secs.astype(np.int32)), jnp.asarray(x),
        jnp.asarray(valid), step=60, alpha=0.2, interpret=True)
    b, xt, vt = (torch.from_numpy(a) for a in (bid, x, valid))
    _assert_bucket(bucket.bucket_stats(b, xt, vt), ring_b)
    # the tile-local emulation at a tile the case's buckets (<= 60 lanes)
    # fit: the same as the whole-row plain version, bitwise
    win = bucket.bucket_stats_windowed(b, xt[None], vt[None], 64)
    _assert_bucket({k: v[0] for k, v in win.items()}, ring_b)
    res, ema = bucket.resample_ema(torch.from_numpy(secs.astype(np.int32)),
                                   xt, vt, 60, 0.2)
    np.testing.assert_array_equal(res.numpy().view(np.int32),
                                  np.asarray(ring_r[0]).view(np.int32))
    bound = np.ceil(np.log2(L)) * np.spacing(np.abs(x).max())
    assert np.abs(ema.numpy() - np.asarray(ring_r[1])).max() <= bound


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
def test_range_stats_match_reference_ring(monkeypatch, depth):
    """tests/test_pallas_window.py's ring case: C = 3, K = 4, L = 256,
    ties, a fully null column row, NaN runs in one column, pads."""
    K, L, C = 4, 256, 3
    rng = np.random.default_rng(depth)
    case = np.random.default_rng(depth)         # the reference's _case
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
    w = jnp.asarray(np.int32(40))
    kw = dict(max_behind=30, max_ahead=10, interpret=True)
    ring = pw.range_stats_stream(jnp.asarray(secs), jnp.asarray(xs[0]),
                                 jnp.asarray(valids[0]), w, **kw)
    ring_p = pw.range_stats_stream_packed(jnp.asarray(secs),
                                          jnp.asarray(xs),
                                          jnp.asarray(valids), w, **kw)
    ring_r = pw.rows_stats_stream(jnp.asarray(xs[0]), jnp.asarray(valids[0]),
                                  6, 3, interpret=True)
    s, x, v = (torch.from_numpy(a) for a in (secs, xs, valids))
    _compare_range(window.range_stats(s, x[0], v[0], 40, 30, 10), ring)
    _compare_range(window.range_stats(s, x, v, 40, 30, 10), ring_p)
    iota = torch.arange(L, dtype=torch.int32).expand(K, L).contiguous()
    _compare_range(window.range_stats(iota, x[0], v[0], 6, 6, 3,
                                      window_ahead=3), ring_r)


def test_pick_forces_and_records_the_form():
    plan = stream.range_plan(10, 0, 4096, 2)
    assert stream.pick("range_stats", plan, None, "x") == plan
    assert stream.last_plan["range_stats"]["form"] == "ring"
    assert stream.pick("range_stats", plan, "row", "x") is None
    assert stream.last_plan["range_stats"] == {"form": "row"}
    with pytest.raises(ValueError, match="no staged plan"):
        stream.pick("range_stats", None, "ring", "bounds (9999, 0)")
    with pytest.raises(ValueError, match="form must be"):
        stream.pick("range_stats", plan, "staged", "x")
