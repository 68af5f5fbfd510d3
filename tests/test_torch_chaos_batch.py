"""The port's batch-plane chaos campaigns, the pipeline
(``run_pipeline_campaign``) and the store (``run_store_campaign``), held
against the reference's in one process at the reference tests' smoke
sizes, on the CPU.  The port's mesh has eight CPU entries, as the
reference's tests have eight JAX CPU devices.

Each campaign runs once a package (module fixtures) and asserts its own
invariants inside.  Here the reports are held against each other: the
same keys, and every deterministic field equal (shard, slab, segment and
re-run counts, quarantined ranges and rows, refusals by name, spills and
restores); seconds and rates are asserted as the reference's
``tests/test_batch_chaos.py`` and ``tests/test_store_chaos.py`` assert
them.
"""

import pytest

from tempo_tpu.testing import chaos as ref_chaos
from tempo_tpu_torch.testing import chaos

pytestmark = pytest.mark.chaos

PIPELINE = dict(rows_total=40_000, physical_rows=10_000, n_keys=16,
                seed=31, n_windows=2, ckpt_every=2)
STORE = dict(rows=4_000, n_keys=6, seed=31, segment_rows=600,
             n_streams=10, resident_budget=3, events_per_stream=6)
TIMING = {"recovery_s", "wall_s", "rows_per_sec", "ticks_per_sec",
          "cold_tick_p99_ms", "hot_tick_p99_ms"}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    port = chaos.run_pipeline_campaign(str(d / "port"), device="cpu",
                                       devices=["cpu"] * 8, **PIPELINE)
    ref = ref_chaos.run_pipeline_campaign(str(d / "ref"), **PIPELINE)
    return port, ref


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    port = chaos.run_store_campaign(str(d / "port"), device="cpu", **STORE)
    ref = ref_chaos.run_store_campaign(str(d / "ref"), **STORE)
    return port, ref


def _untimed(rep):
    if isinstance(rep, dict):
        return {k: _untimed(v) for k, v in rep.items() if k not in TIMING}
    return rep


PIPELINE_FIELDS = ["rows_total", "physical_rows", "n_slabs", "slab_rows",
                   "ingest_resume", "quarantine", "ingest_deadline_stage",
                   "flapping_file", "plan_barriers", "sweep",
                   "foreign_signature_refused", "no_silent_restores",
                   "tail_audit"]
STORE_FIELDS = ["rows", "segments", "write_resume", "refusals_by_name",
                "legacy_overwrite", "compaction", "cohort_spill",
                "no_silent_restores"]


def test_pipeline_report_keys_match_reference(pipeline):
    port, ref = pipeline
    assert set(port) == set(ref) == set(PIPELINE_FIELDS) | {
        "rows_per_sec", "wall_s"}
    for k in PIPELINE_FIELDS:
        if isinstance(ref[k], dict):
            assert set(port[k]) == set(ref[k]), k


@pytest.mark.parametrize("field", PIPELINE_FIELDS)
def test_pipeline_deterministic_fields_match_reference(pipeline, field):
    port, ref = pipeline
    assert _untimed(port[field]) == _untimed(ref[field])


def test_pipeline_campaign_smoke(pipeline):
    rep, _ = pipeline
    assert rep["ingest_resume"]["reread_committed_shards"] == 0
    assert rep["ingest_resume"]["shards_total"] == 8
    assert rep["quarantine"]["named_error"] is True
    assert rep["plan_barriers"]["zero_builds_after_resume"] is True
    assert rep["plan_barriers"]["pre_barrier_ops_rerun"] == 0
    assert rep["sweep"]["builds_after_resume"] == 0
    assert rep["sweep"]["replayed_slabs"] >= 1
    assert all(rep["foreign_signature_refused"].values())
    assert "bitwise" in rep["tail_audit"]
    assert rep["sweep"]["recovery_s"] >= 0 and rep["rows_per_sec"] > 0


def test_store_report_keys_match_reference(store):
    port, ref = store
    assert set(port) == set(ref) == set(STORE_FIELDS) | {"wall_s"}
    for k in STORE_FIELDS:
        if isinstance(ref[k], dict):
            assert set(port[k]) == set(ref[k]), k


@pytest.mark.parametrize("field", STORE_FIELDS)
def test_store_deterministic_fields_match_reference(store, field):
    port, ref = store
    assert _untimed(port[field]) == _untimed(ref[field])


def test_store_campaign_smoke(store):
    rep, _ = store
    wr = rep["write_resume"]
    assert wr["segments_rewritten_committed"] == 0
    assert wr["pointer_swing_resume_segment_writes"] == 0
    assert "bitwise" in wr["value_audit"]
    assert all(rep["refusals_by_name"].values())
    assert rep["legacy_overwrite"]["old_table_lost"] is False
    assert rep["compaction"]["killed_mid_merge"] is True
    assert "bitwise" in rep["compaction"]["reader_on_old_generation"]
    cs = rep["cohort_spill"]
    assert cs["spills"] >= 1 and cs["restores"] >= 1
    assert "bitwise" in cs["value_audit"]
    assert cs["ticks_per_sec"] > 0
    assert rep["no_silent_restores"] is True
