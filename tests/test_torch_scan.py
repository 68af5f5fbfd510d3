"""The port's exact-EMA ladder (``tempo_tpu_torch.ops.scan``, plain
version on the CPU) against the Pallas EMA kernel in interpret mode.

In interpret mode XLA:CPU contracts the ladder's ``v + d * v_prev`` into
one fused multiply-add, which rounds once where the port (and its CUDA
kernel, built with -fmad=false and round-to-nearest intrinsics) rounds
twice.  Each of the log2(L) ladder levels can so differ by one rounding
of a term no larger than max|x|, hence the stated bound
``|port - pallas| <= log2(L) * spacing(max|x|)``.  The association
itself is pinned bitwise against a numpy ladder without contraction.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu.ops import rolling as ref_rolling
from tempo_tpu_torch.ops import scan


def _case(seed, K, L):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, L)).astype(np.float32) * 2
    valid = rng.random((K, L)) > 0.2
    return x, valid


def _numpy_ladder(x, valid, alpha):
    """The ladder in float32 numpy, one rounding per operation."""
    a = np.float32(alpha)
    d = np.where(valid, np.float32(1) - a, np.float32(1)).astype(np.float32)
    v = np.where(valid, a * x, np.float32(0)).astype(np.float32)
    K, L = x.shape
    span = 1
    while span < L:
        d_prev = np.concatenate([np.ones((K, span), np.float32), d[:, :-span]], 1)
        v_prev = np.concatenate([np.zeros((K, span), np.float32), v[:, :-span]], 1)
        v = v + d * v_prev
        d = d * d_prev
        span *= 2
    return v


@pytest.mark.parametrize("seed,K,L,alpha", [
    (0, 8, 512, 0.2), (1, 16, 300, 0.05), (2, 5, 128, 0.9), (3, 3, 1, 0.2),
])
def test_ema_matches_pallas_within_fma_bound(seed, K, L, alpha):
    x, valid = _case(seed, K, L)
    want = np.asarray(pk.ema_scan(jnp.asarray(x), jnp.asarray(valid), alpha,
                                  interpret=True))
    got = scan.ema(torch.from_numpy(x), torch.from_numpy(valid), alpha).numpy()
    bound = max(1, math.ceil(math.log2(L))) * np.spacing(np.abs(x).max())
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("seed,L", [(0, 512), (4, 77)])
def test_ema_association_is_the_ladder_bitwise(seed, L):
    x, valid = _case(seed, 6, L)
    got = scan.ema(torch.from_numpy(x), torch.from_numpy(valid), 0.2).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _numpy_ladder(x, valid, 0.2).view(np.int32))


def test_ema_float64_matches_reference_exact_ema():
    """The CPU policy's float64 run against the reference's own float64
    exact EMA (an associative scan, another association: 1e-12)."""
    x, valid = _case(9, 4, 200)
    x = x.astype(np.float64)
    want = np.asarray(ref_rolling.ema_exact(jnp.asarray(x), jnp.asarray(valid),
                                            0.3))
    got = scan.ema(torch.from_numpy(x), torch.from_numpy(valid), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
