"""The tumbling-bucket statistics kernel's plain version
(``ops/bucket.bucket_stats_plain``) against the reference's Pallas kernel
(``pallas_bucket.bucket_stats_pallas`` in interpret mode), a numpy
per-bucket oracle, and itself (a column stack against single columns);
and the dispatch of a CUDA tensor to the kernel's wrapper.

Tolerances: in float32 against the Pallas kernel, ``count``, ``min`` and
``max`` are bitwise equal; ``mean``, ``sum``, ``stddev`` (compared as the
variance) and ``zscore`` (compared as ``x - mean``) agree within 1e-5,
relative or absolute: the row centre is summed in another order (torch's
reduction against XLA's), and interpret mode may contract the ladders'
multiply-adds.  The float64 numpy oracle holds the float64 plain version
within 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempo_tpu.ops.pallas_bucket import bucket_stats_pallas
from tempo_tpu_torch.ops import bucket, rolling

STATS = bucket.BUCKET_STATS


def _case(rng, K, L, gap_hi=3, step=60, masked=False):
    """The reference test's case (tests/test_pallas_bucket.py)."""
    secs = np.cumsum(rng.integers(1, gap_hi, (K, L)), -1).astype(np.int64)
    x = rng.standard_normal((K, L)).astype(np.float32)
    valid = rng.random((K, L)) > (0.3 if masked else 0.0)
    bid = (secs // step).astype(np.int32)
    return bid, x, valid


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_stats(got, want, bitwise=("count", "min", "max"), tol=1e-5):
    for k in STATS:
        g = torch.as_tensor(np.asarray(got[k])).double()
        w = torch.as_tensor(np.asarray(want[k])).double()
        if k in bitwise:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=k)
            continue
        if k == "stddev":
            g, w = g * g, w * w
        elif k == "zscore":
            flat = (torch.as_tensor(np.asarray(got["stddev"])) == 0) | \
                (torch.as_tensor(np.asarray(want["stddev"])) == 0)
            g = torch.where(flat, float("nan"), g * torch.as_tensor(
                np.asarray(got["stddev"])).double())
            w = torch.where(flat, float("nan"), w * torch.as_tensor(
                np.asarray(want["stddev"])).double())
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                   msg=k)


@pytest.mark.parametrize("K,L,masked", [(4, 256, False), (3, 512, True),
                                        (6, 128, True)])
def test_plain_matches_pallas_kernel(K, L, masked):
    rng = np.random.default_rng(K * 100 + L)
    bid, x, valid = _case(rng, K, L, masked=masked)
    want = bucket_stats_pallas(jnp.asarray(bid), jnp.asarray(x),
                               jnp.asarray(valid), interpret=True)
    got = bucket.bucket_stats_plain(*_t(bid), *(t[None] for t in _t(x,
                                                                   valid)))
    _assert_stats({k: v[0] for k, v in got.items()}, want)


def test_plain_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    K, L = 3, 256
    bid, x, valid = _case(rng, K, L, masked=True)
    xd = x.astype(np.float64)
    got = bucket.bucket_stats(*_t(bid, xd, valid))
    for k in range(K):
        for b in np.unique(bid[k]):
            rows = np.flatnonzero(bid[k] == b)
            win = xd[k, rows[valid[k, rows]]]
            np.testing.assert_array_equal(got["count"][k, rows], len(win))
            if not len(win):
                assert torch.isnan(got["mean"][k, rows]).all()
                continue
            for name, want in (("mean", win.mean()), ("sum", win.sum()),
                               ("min", win.min()), ("max", win.max())):
                np.testing.assert_allclose(got[name][k, rows], want,
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=name)
            if len(win) > 1:
                sd = win.std(ddof=1)
                np.testing.assert_allclose(got["stddev"][k, rows], sd,
                                           rtol=1e-12, atol=1e-12)
                z = np.where(valid[k, rows], (xd[k, rows] - win.mean()) / sd,
                             np.nan)
                np.testing.assert_allclose(got["zscore"][k, rows], z,
                                           rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stack_equals_single_columns_bitwise(dtype):
    rng = np.random.default_rng(3)
    bid, x0, v0 = _case(rng, 5, 192, masked=True)
    _, x1, v1 = _case(rng, 5, 192, masked=True)
    x2 = (x0 * 1e3).astype(np.float32)
    xs = torch.from_numpy(np.stack([x0, x1, x2])).to(dtype)
    vs = torch.from_numpy(np.stack([v0, v1, ~v0]))
    b = torch.from_numpy(bid)
    stacked = rolling.bucket_stats_multi(b, xs, vs)
    for c in range(3):
        one = rolling.bucket_stats(b, xs[c], vs[c])
        for k in STATS:
            assert torch.equal(stacked[k][c].nan_to_num(7.0),
                               one[k].nan_to_num(7.0)), (c, k)


def test_pad_and_all_null_rows():
    """Pad lanes carry the clamped id INT32_MAX and form their own
    trailing bucket; an all-null row and an all-pad row give count 0 and
    NaN elsewhere; real buckets are untouched by them."""
    rng = np.random.default_rng(5)
    bid, x, valid = _case(rng, 4, 64, masked=True)
    bid[0, 50:] = np.iinfo(np.int32).max           # pads of row 0
    valid[0, 50:] = False
    x[0, 50:] = np.nan
    valid[1] = False                                # all-null row
    bid[2] = np.iinfo(np.int32).max                 # all-pad row
    valid[2] = False
    x[2] = np.nan
    got = bucket.bucket_stats(*_t(bid, x.astype(np.float64), valid))
    for row, lanes in ((0, slice(50, None)), (1, slice(None)),
                       (2, slice(None))):
        assert (got["count"][row, lanes] == 0).all()
        for k in ("mean", "min", "max", "sum", "stddev", "zscore"):
            assert torch.isnan(got[k][row, lanes]).all(), (row, k)
    ref = bucket.bucket_stats(*_t(bid[:1, :50], x[:1, :50].astype(np.float64),
                                  valid[:1, :50]))
    for k in STATS:
        assert torch.equal(got[k][:1, :50].nan_to_num(7.0),
                           ref[k].nan_to_num(7.0)), k


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports lying on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_reaches_the_kernel_wrapper(monkeypatch):
    rng = np.random.default_rng(9)
    bid, x, valid = _case(rng, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        bucket.bucket_stats_cuda(*_t(bid), *(t[None] for t in _t(x, valid)))
    calls = []

    def spy(bid, xs, valids):
        calls.append((bid, xs, valids))
        return bucket.bucket_stats_plain(*(t.as_subclass(torch.Tensor)
                                           for t in (bid, xs, valids)))

    monkeypatch.setattr(bucket, "bucket_stats_cuda", spy)
    b, xt, vt = (t.as_subclass(_CardTensor) for t in _t(bid, x, valid))
    got = rolling.bucket_stats_multi(b, xt[None], vt[None])
    assert len(calls) == 1 and calls[0][1].shape == (1, 2, 32)
    want = bucket.bucket_stats_plain(*_t(bid), *(t[None] for t in _t(x,
                                                                     valid)))
    for k in STATS:
        assert torch.equal(got[k].nan_to_num(7.0), want[k].nan_to_num(7.0))
