"""The port's chaos campaigns on the serving and service planes
(tempo_tpu_torch/testing/chaos.py) held against the reference's
(tempo_tpu/testing/chaos.py) in one process, at the reference tests'
smoke sizes, on the CPU.

Each campaign runs once a package (module fixtures).  Its own assertions
hold inside it; here its report is held against the reference's: the
same keys, the same deterministic fields (the injections, the service's
outcome counts), and the timing-dependent fields asserted the way the
reference's ``tests/test_fault_domain.py`` asserts them.  The golden
(uninjected) cohort's emissions are held against the reference's within
rtol 1e-6: both keep the serving state in float32, and XLA fuses the
window arithmetic where the port rounds each op.
"""

import numpy as np
import pytest

from tempo_tpu.testing import chaos as ref_chaos
from tempo_tpu_torch import testing as port_testing
from tempo_tpu_torch.testing import chaos

pytestmark = pytest.mark.chaos

SERVING = dict(n_streams=8, events_per_stream=12, seed=23, ckpt_every=16)


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    port = chaos.run_serving_campaign(str(d / "port"), device="cpu",
                                      **SERVING)
    ref = ref_chaos.run_serving_campaign(str(d / "ref"), **SERVING)
    return port, ref


@pytest.fixture(scope="module")
def service():
    port = chaos.run_service_campaign(n_queries=6, seed=29, device="cpu")
    ref = ref_chaos.run_service_campaign(n_queries=6, seed=29)
    return port, ref


def _keys(rep):
    return {k: (sorted(v) if isinstance(v, dict) else None)
            for k, v in rep.items()}


def test_chaos_is_exported_lazily():
    assert "chaos" in port_testing.__all__
    assert port_testing.chaos is chaos


@pytest.mark.parametrize("seed", [0, 5, 17])
@pytest.mark.parametrize("n_streams", [1, 3, 12])
def test_make_events_matches_reference(seed, n_streams):
    got = chaos.make_events(np.random.default_rng(seed), n_streams, 10)
    want = ref_chaos.make_events(np.random.default_rng(seed), n_streams, 10)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(k, t) for k, t, _ in g] == [(k, t) for k, t, _ in w]
        gv = np.array([np.nan if v is None else v for _, _, v in g])
        wv = np.array([np.nan if v is None else v for _, _, v in w])
        assert gv.tobytes() == wv.tobytes()


@pytest.mark.parametrize("seed", [3, 23])
def test_golden_run_matches_reference(seed):
    events = chaos.make_events(np.random.default_rng(seed), 6, 10)
    got = chaos._golden_run(events, "cpu")
    want = ref_chaos._golden_run(events)
    assert len(got) == len(want)
    for g_s, w_s in zip(got, want):
        assert len(g_s) == len(w_s)
        for g, w in zip(g_s, w_s):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                if w[k].dtype != np.float32 or k.endswith("_count"):
                    assert g[k].tobytes() == w[k].tobytes(), k
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                               atol=1e-7, err_msg=k)


def test_serving_campaign_report_keys_match_reference(serving):
    port, ref = serving
    assert _keys(port) == _keys(ref)


def test_serving_campaign_deterministic_fields_match_reference(serving):
    port, ref = serving
    for key in ("injected", "n_streams", "n_events", "no_hung_tickets",
                "zero_builds_after_recovery"):
        assert port[key] == ref[key], key
    assert port["tail_audit"] == ref["tail_audit"]


def test_serving_campaign_smoke(serving):
    rep, _ = serving
    assert rep["no_hung_tickets"] and rep["zero_builds_after_recovery"]
    assert rep["injected"]["kills"] == 1
    assert rep["outcomes"]["deadline"] >= 1
    assert rep["outcomes"]["quarantined"] >= 1
    assert rep["restarts"] >= 1
    assert rep["snapshot_bytes"]["diff_vs_full"] < 1.0
    assert "bitwise" in rep["tail_audit"]


def test_service_campaign_report_matches_reference(service):
    port, ref = service
    assert _keys(port) == _keys(ref)
    # one worker: the scheduling, and so every count, is deterministic
    for key in ("outcomes", "restarts", "good_tenant_completed",
                "no_hung_tickets"):
        assert port[key] == ref[key], key
    assert port["breaker"]["trips"] == ref["breaker"]["trips"]
    assert len(port["breaker"]["open"]) == len(ref["breaker"]["open"])


def test_service_campaign_smoke(service):
    rep, _ = service
    assert rep["no_hung_tickets"]
    assert rep["outcomes"]["quarantined"] >= 1
    assert rep["outcomes"]["deadline"] >= 1
    assert rep["outcomes"]["cancelled"] >= 1
    assert rep["restarts"] >= 1
