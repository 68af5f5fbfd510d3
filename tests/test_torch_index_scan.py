"""The port's valid-index scans and forward fill (``tempo_tpu_torch.ops.
scan``, plain versions on the CPU) against the Pallas kernels
``_last_valid_index_kernel``, ``_first_valid_index_kernel`` and
``_last_valid_kernel`` in interpret mode.

The index scans are integer max / min, and the fill only copies values,
so every comparison is bitwise.  The cases hold all-False and all-True
rows, L = 1 and widths that are not a multiple of 128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as pk
from tempo_tpu_torch import ops
from tempo_tpu_torch.ops import scan, window_utils


def _case(seed, K, L):
    rng = np.random.default_rng(seed)
    valid = rng.random((K, L)) > rng.uniform(0.3, 0.95, (K, 1))
    valid[0] = False
    if K > 1:
        valid[1] = True
    x = rng.standard_normal((K, L)).astype(np.float32)
    x[~valid & (rng.random((K, L)) > 0.5)] = np.nan
    return x, valid


SHAPES = [(0, 8, 256), (1, 5, 200), (2, 3, 1)]


@pytest.mark.parametrize("seed,K,L", SHAPES)
@pytest.mark.parametrize("name", ["last_valid_index_scan",
                                  "first_valid_index_scan"])
def test_index_scan_matches_pallas_bitwise(name, seed, K, L):
    _, valid = _case(seed, K, L)
    want = np.asarray(getattr(pk, name)(jnp.asarray(valid), interpret=True))
    got = getattr(scan, name)(torch.from_numpy(valid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,K,L", SHAPES)
def test_last_valid_scan_matches_pallas_bitwise(seed, K, L):
    x, valid = _case(seed, K, L)
    want_v, want_h = pk.last_valid_scan(jnp.asarray(x), jnp.asarray(valid),
                                        interpret=True)
    got_v, got_h = ops.last_valid_scan(torch.from_numpy(x),
                                       torch.from_numpy(valid))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


@pytest.mark.parametrize("name", ["last_valid_index", "first_valid_index"])
def test_window_utils_scan_the_last_axis_of_any_shape(name):
    """The [C, K, G] masks interpolation scans in one call, against a
    numpy running max / reverse running min."""
    rng = np.random.default_rng(7)
    valid = rng.random((3, 4, 37)) > 0.6
    lanes = np.broadcast_to(np.arange(37, dtype=np.int32), valid.shape)
    if name == "last_valid_index":
        want = np.maximum.accumulate(np.where(valid, lanes, -1), axis=-1)
    else:
        want = np.minimum.accumulate(np.where(valid, lanes, 37)[..., ::-1],
                                     axis=-1)[..., ::-1]
    got = getattr(window_utils, name)(torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
