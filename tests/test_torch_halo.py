"""The port's time-axis halo functions (``tempo_tpu_torch/parallel/halo.py``)
against the reference's (``tempo_tpu/parallel/halo.py``).

The same seeded numpy arrays go through the reference's ``shard_map``
programs on its forced 8-device CPU host and through the port's
functions on blocks cut over ``["cpu"] * 8`` meshes of the same shape
(``mesh.place``; reassembled with ``reshard.assemble``), both in
float64.  Meshes: ``{"series": 2, "time": 4}`` and ``{"time": 8}`` (no
series axis).

Tolerances: counts, founds and the truncation audits (``clipped``) are
equal exactly; range statistics agree within rtol = atol = 1e-9 (the
reference takes prefix sums over searchsorted bounds, the port its
rank and ``cumsum3`` kernels' plain versions, in other orders); AS-OF
values are equal (they are selections); the EMA agrees within
rtol = atol = 1e-12 (the reference's associative scan and the port's
ladder plus ``torch.cumprod`` carry associate the products
differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops import rolling as ref_rk
from tempo_tpu.packing import TS_PAD
from tempo_tpu.parallel import asof_time_sharded as ref_asof
from tempo_tpu.parallel import ema_time_sharded as ref_ema
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu.parallel import range_stats_time_sharded as ref_range
from tempo_tpu_torch import make_mesh
from tempo_tpu_torch.parallel import (asof_time_sharded, ema_time_sharded,
                                      range_stats_time_sharded)
from tempo_tpu_torch.parallel import halo as ph
from tempo_tpu_torch.parallel.mesh import place
from tempo_tpu_torch.parallel.reshard import assemble

MESHES = [pytest.param({"series": 2, "time": 4}, id="series2xtime4"),
          pytest.param({"time": 8}, id="time8")]


def _spec(axes, ndim=2):
    s = "series" if "series" in axes else None
    return (None,) * (ndim - 2) + (s, "time")


def _cut(arr, axes):
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    return place(np.asarray(arr), mesh, _spec(axes, np.ndim(arr)))


def _whole(blocks, axes, ndim=2):
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    return assemble(blocks, mesh, _spec(axes, ndim)).numpy()


def _ragged(rng, K, L, density=0.8, span=500):
    lengths = rng.integers(max(1, L // 2), L + 1, size=K)
    ts = np.full((K, L), TS_PAD, dtype=np.int64)
    x = np.zeros((K, L))
    valid = np.zeros((K, L), dtype=bool)
    for k in range(K):
        n = lengths[k]
        ts[k, :n] = np.sort(rng.integers(0, span, size=n))
        x[k, :n] = rng.normal(size=n)
        valid[k, :n] = rng.random(n) < density
    return ts, x, valid


def _tie_rows(K, L, run):
    """Rows 0..L-1 with a run of equal timestamps over ``run`` (lanes
    [a, b)), which the cases put across a block boundary."""
    ts = np.tile(np.arange(L, dtype=np.int64), (K, 1))
    ts[:, run[0]:run[1]] = ts[:, run[0] + 1:run[0] + 2]
    return np.sort(ts, axis=-1)


def _range_case(axes, ts, x, valid, W, halo):
    jm = ref_mesh(axes)
    want, want_clip = ref_range(jm, jnp.asarray(ts), jnp.asarray(x),
                                jnp.asarray(valid), float(W), halo=halo)
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    got, clipped = range_stats_time_sharded(
        mesh, _cut(ts, axes), _cut(x, axes), _cut(valid, axes), float(W),
        halo=halo)
    for k in want:
        g, w = _whole(got[k], axes), np.asarray(want[k])
        if k == "count":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=k)
    assert len(clipped) == 8
    assert sum(int(c) for c in clipped) == int(want_clip)
    return int(want_clip)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("W,halo", [(5, 16), (30, 4), (1000, 2), (0, 1),
                                    (7.5, 8)])
def test_range_stats_and_audit_match(axes, W, halo):
    rng = np.random.default_rng(1)
    ts, x, valid = _ragged(rng, 4, 128, span=200)
    _range_case(axes, ts, x, valid, W, halo)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("run", [(14, 18), (30, 35), (12, 40)])
def test_range_stats_tie_runs_across_blocks(axes, run):
    """Equal timestamps straddling a block boundary: Spark's range frame
    includes following rows that tie, so the right halo must reach them;
    a run longer than the halo is counted."""
    K, L = 2, 128
    ts = _tie_rows(K, L, run)
    x = np.arange(K * L, dtype=np.float64).reshape(K, L)
    valid = np.ones((K, L), dtype=bool)
    for halo in (1, 2, 8):
        _range_case(axes, ts, x, valid, 3, halo)


@pytest.mark.parametrize("axes", MESHES)
def test_range_stats_clip_counts_both_sides(axes):
    K, L = 2, 64
    ts = np.tile(np.arange(L, dtype=np.int64), (K, 1))
    x = np.ones((K, L))
    valid = np.ones((K, L), dtype=bool)
    assert _range_case(axes, ts, x, valid, 1000.0, 2) > 0
    # one tie run over a whole block: its rows reach the right halo's end
    ts2 = ts.copy()
    ts2[:, 8:24] = 8
    assert _range_case(axes, ts2, x, valid, 0, 2) > 0


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("alpha", [0.2, 0.9])
def test_ema_matches(axes, alpha):
    rng = np.random.default_rng(2)
    _, x, valid = _ragged(rng, 4, 64)
    want = np.asarray(ref_ema(ref_mesh(axes), jnp.asarray(x),
                              jnp.asarray(valid), alpha))
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    got = _whole(ema_time_sharded(mesh, _cut(x, axes), _cut(valid, axes),
                                  alpha), axes)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # and the reference's EMA over whole rows
    whole = ref_rk.ema_exact(jnp.asarray(x), jnp.asarray(valid), alpha)
    np.testing.assert_allclose(got, np.asarray(whole), rtol=1e-12,
                               atol=1e-12)


def _asof_case(axes, l_ts, r_ts, r_valids, r_vals, halo):
    want_v, want_f, want_clip = ref_asof(
        ref_mesh(axes), jnp.asarray(l_ts), jnp.asarray(r_ts),
        jnp.asarray(r_valids), jnp.asarray(r_vals), halo=halo)
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    vals, found, clipped = asof_time_sharded(
        mesh, _cut(l_ts, axes), _cut(r_ts, axes), _cut(r_valids, axes),
        _cut(r_vals, axes), halo=halo)
    np.testing.assert_array_equal(_whole(found, axes, 3), np.asarray(want_f))
    np.testing.assert_array_equal(_whole(vals, axes, 3), np.asarray(want_v))
    assert sum(int(c) for c in clipped) == int(want_clip)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("halo", [1, 4, 8])
def test_asof_matches_on_a_shared_grid(axes, halo):
    """Value-aligned blocks (a shared time grid, the documented
    precondition); a sparse column rides the carry across whole
    blocks."""
    rng = np.random.default_rng(4)
    K, L = 4, 64
    ts = np.cumsum(rng.integers(1, 4, size=(K, L)), axis=-1).astype(np.int64)
    v0 = rng.random((K, L)) > 0.9
    v0[:, 0] = True
    v1 = rng.random((K, L)) > 0.3
    r_x = rng.standard_normal((K, L))
    _asof_case(axes, ts, ts, np.stack([v0, v1]),
               np.stack([r_x, r_x * 2 + 1]), halo)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("run", [(5, 10), (14, 18), (4, 20)])
def test_asof_tie_runs_across_blocks(axes, run):
    K, L = 2, 64
    r_ts = _tie_rows(K, L, run)
    r_x = np.arange(K * L, dtype=np.float64).reshape(K, L)
    v0 = np.ones((K, L), dtype=bool)
    v0[:, run[0]:run[0] + 3] = False
    r_valids = np.stack([v0, np.ones((K, L), dtype=bool)])
    for halo in (1, 2, 8):
        _asof_case(axes, r_ts.copy(), r_ts, r_valids,
                   np.stack([r_x, r_x * 3 + 1]), halo)


def test_sentinels_and_validation():
    # seconds-domain sentinels: TS_NEG less a window stays far from
    # int64's end; TS_POS is the packed rows' own padding
    assert ph.TS_NEG == -(2 ** 61) and ph.TS_POS == 2 ** 62
    assert int(ph.TS_NEG) - 10 ** 12 > -(2 ** 63)
    axes = {"series": 2, "time": 4}
    mesh = make_mesh(axes, devices=["cpu"] * 8)
    ts = _cut(np.zeros((2, 32), np.int64), axes)
    x = _cut(np.zeros((2, 32)), axes)
    v = _cut(np.ones((2, 32), bool), axes)
    with pytest.raises(ValueError, match="halo"):
        range_stats_time_sharded(mesh, ts, x, v, 1.0, halo=99)
    with pytest.raises(ValueError, match="halo"):
        range_stats_time_sharded(mesh, ts, x, v, 1.0, halo=0)
    # the halos are the neighbours' edge columns, moved: fills at the ends
    blocks = _cut(np.arange(64).reshape(2, 32), axes)
    left = ph._halo_from_left(mesh, blocks, 2, -1)
    right = ph._halo_from_right(mesh, blocks, 2, -9)
    assert torch.equal(left[0], torch.full((1, 2), -1))
    assert torch.equal(left[1], torch.tensor([[6, 7]]))
    assert torch.equal(right[0], torch.tensor([[8, 9]]))
    assert torch.equal(right[3], torch.full((1, 2), -9))
