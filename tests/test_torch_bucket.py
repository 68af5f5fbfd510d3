"""The port's fused resample + EMA (``tempo_tpu_torch.ops.bucket``), grouped
segment stats and interpolation op, plain versions on the CPU, against
the JAX package on the same seeded inputs.

* ``resample_ema`` against ``pallas_bucket.resample_ema_pallas`` in
  interpret mode: ``res`` bitwise (the same f32 multiply and selection);
  ``ema`` within ``ceil(log2 L) * spacing(max|x * scale|)``, because
  XLA:CPU contracts the ladder's ``v + d * v_prev`` into a fused
  multiply-add in interpret mode and the port rounds twice (see
  ``test_torch_scan.py``).
* ``segment_stats`` and ``interpolate_columns`` in float64 against the
  reference's own functions: within 1e-12 relative (sums may associate
  differently); counts, selections and flags bitwise.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import interpolate as ref_ik
from tempo_tpu.ops import pallas_bucket as pb
from tempo_tpu.ops import rolling as ref_rk
from tempo_tpu_torch import ops
from tempo_tpu_torch.ops import bucket
from tempo_tpu_torch.ops import interpolate as ik


def _ema_case(seed, K, L, base, gaps):
    rng = np.random.default_rng(seed)
    secs = (base + np.cumsum(rng.integers(0, gaps, (K, L)), axis=-1)).astype(
        np.int32)
    x = (rng.standard_normal((K, L)) * 3).astype(np.float32)
    valid = rng.random((K, L)) > 0.25
    # a bucket's first row null: the next rows of that bucket are no heads
    valid[:, 0] = False
    return secs, x, valid


@pytest.mark.parametrize("seed,K,L,base,gaps,step,scale", [
    (0, 8, 256, 0, 4, 60, None),                 # straddles minute buckets
    (1, 4, 200, -1_000_000_007, 9, 60, 1.5),     # negative seconds: floor
    (2, 3, 128, -50, 3, 7, 0.3),                 # crosses 0, step 7
    (3, 2, 1, 5, 2, 1, 2.0),
])
def test_resample_ema_matches_pallas(seed, K, L, base, gaps, step, scale):
    secs, x, valid = _ema_case(seed, K, L, base, gaps)
    want_res, want_ema = pb.resample_ema_pallas(
        jnp.asarray(secs), jnp.asarray(x), jnp.asarray(valid), step=step,
        alpha=0.2, scale=None if scale is None else jnp.float32(scale),
        interpret=True)
    got_res, got_ema = ops.resample_ema(
        torch.from_numpy(secs), torch.from_numpy(x), torch.from_numpy(valid),
        step=step, alpha=0.2, scale=scale)
    np.testing.assert_array_equal(got_res.numpy().view(np.int32),
                                  np.asarray(want_res).view(np.int32))
    xs = x * np.float32(1.0 if scale is None else scale)
    bound = max(1, math.ceil(math.log2(L))) * np.spacing(np.abs(xs).max())
    assert np.abs(got_ema.numpy() - np.asarray(want_ema)).max() <= bound
    if base < 0:   # floor, not truncation: some bucket starts mid-run
        assert (secs < 0).any()


@pytest.mark.parametrize("step", [1.5, 0, 0.5])
def test_resample_ema_rejects_a_non_integral_step(step):
    secs, x, valid = _ema_case(0, 2, 8, 0, 3)
    with pytest.raises(ValueError, match="integral step"):
        bucket.resample_ema(torch.from_numpy(secs), torch.from_numpy(x),
                            torch.from_numpy(valid), step=step, alpha=0.2)


def test_segment_stats_matches_reference():
    rng = np.random.default_rng(4)
    n, n_seg = 300, 23
    seg = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    seg = np.searchsorted(np.unique(seg), seg).astype(np.int32)
    n_seg = int(seg.max()) + 1
    x = rng.standard_normal(n) * 10
    valid = rng.random(n) > 0.3
    x[~valid] = np.nan
    want = ref_rk.segment_stats(jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(seg), n_seg)
    got = ops.segment_stats(torch.from_numpy(x), torch.from_numpy(valid),
                            torch.from_numpy(seg), n_seg)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("count", "min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)


def _grid_case(seed):
    """A [K, G] grid: each series starts at a real slot, ends at one, and
    the columns hold nulls at and between real slots."""
    rng = np.random.default_rng(seed)
    K, G, C = 4, 24, 2
    glen = np.array([24, 17, 1, 9])
    real = rng.random((K, G)) > 0.5
    real[:, 0] = True
    slot = np.arange(G)
    real &= slot[None] < glen[:, None]
    real[np.arange(K), glen - 1] = True
    ts = (1000.0 * (1 + np.arange(K)))[:, None] + 30.0 * slot[None]
    vals = rng.standard_normal((C, K, G))
    valid = real[None] & (rng.random((C, K, G)) > 0.3)
    vals[~valid] = np.nan
    return real, glen.astype(np.int32), ts, vals, valid


@pytest.mark.parametrize("method", ik.METHODS)
def test_interpolate_columns_matches_reference(method):
    real, glen, ts, vals, valid = _grid_case(11)
    want = ref_ik.interpolate_columns(
        jnp.asarray(real), jnp.asarray(glen), jnp.asarray(ts),
        jnp.asarray(np.float64(30.0)), jnp.asarray(vals), jnp.asarray(valid),
        method)
    got = ik.interpolate_columns(
        torch.from_numpy(real), torch.from_numpy(glen), torch.from_numpy(ts),
        30.0, torch.from_numpy(vals), torch.from_numpy(valid), method)
    out_w, ok_w, tsi_w, flag_w = (np.asarray(a) for a in want)
    out_g, ok_g, tsi_g, flag_g = (t.numpy() for t in got)
    np.testing.assert_array_equal(ok_g, ok_w)
    np.testing.assert_array_equal(tsi_g, tsi_w)
    np.testing.assert_array_equal(flag_g, flag_w)
    np.testing.assert_allclose(out_g, out_w, rtol=1e-12, atol=0)
