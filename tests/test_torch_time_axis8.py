"""``test_torch_time_axis.py``'s tests on the ``{"series": 1, "time": 8}``
mesh: one series group cut into eight time blocks (its ``axes`` fixture
overrides that file's; tolerances as stated there)."""

import pytest

from test_torch_time_axis import (  # noqa: F401  (collected here too)
    TestHaloStrategy, frames, meshes,
    test_chain_packs_once_a_side_and_fetches_once,
    test_describe_autocorr_lookback,
    test_fourier_matches_reference_within_norm, test_op_matches_reference,
    test_truncated_ema_refuses_a_time_axis,
)


@pytest.fixture(scope="module")
def axes():
    return {"series": 1, "time": 8}
