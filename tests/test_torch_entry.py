"""``tempo_tpu_torch.entry.forward_step`` (on the CPU) against the
reference's one-program step ``__graft_entry__._forward_step`` on the
reference's ``_example_args()``, carried across by
``tempo_tpu_torch.interop``.

The join outputs and the ``count``/``clipped`` planes are selections and
counts: equal bitwise.  The other statistics and the EMA are float32
arithmetic done in another order on the reference's CPU path (its XLA
shifted form sums raw values where the port centres them, and its EMA
is an associative scan, not the ladder): rtol = atol = 1e-5.  The
zscore divides by the window's stddev, which can be tiny (a two-row
window of close values), so it is compared in the data's units:
zscore times the reference's stddev, with the same tolerance.
"""

import numpy as np
import pytest

import jax

import __graft_entry__ as ref_entry
from tempo_tpu_torch import entry, interop

EXACT = ("joined", "last_right_row", "stats_count", "stats_clipped")


@pytest.mark.parametrize("K,Ll,Lr,seed", [(8, 128, 128, 0), (4, 96, 160, 3)])
def test_forward_step_matches_reference(K, Ll, Lr, seed):
    args = ref_entry._example_args(K=K, Ll=Ll, Lr=Lr, seed=seed)
    for mine, theirs in zip(entry.example_args(K, Ll, Lr, seed), args):
        np.testing.assert_array_equal(mine, theirs)
    want = {k: np.asarray(v)
            for k, v in jax.jit(ref_entry._forward_step)(*args).items()}
    tensors = interop.from_reference_arrays(*args, device="cpu")
    for t, a in zip(tensors, args):
        assert str(t.dtype).replace("torch.", "") == np.dtype(a.dtype).name
        assert tuple(t.shape) == a.shape
    got = interop.to_numpy(entry.forward_step(*tensors))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k == "stats_zscore":
            sd = want["stats_stddev"]
            np.testing.assert_allclose(got[k] * sd, want[k] * sd, rtol=1e-5,
                                       atol=1e-5, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)
    assert float(got["stats_clipped"].sum()) == 0.0
