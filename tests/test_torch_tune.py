"""The port's autotuner (tempo_tpu_torch/tune) and window roofline held
against the reference's (tempo_tpu/tune, tempo_tpu.profiling) in one
process.

* Pure functions: ``window_roofline`` and ``payload_crc`` equal the
  reference's exactly over a seeded grid.
* Harness decisions: ``sweep_class`` / ``sweep`` of both packages, fed
  the same scripted ``probe_fn`` over each shared shape class, give the
  same knobs, probes, rejected points and audit failures.
* The reference's ``tests/test_tune.py`` cases, on the port: reader
  priority for each wired reader, every refusal by name (a foreign torch
  or CUDA version in place of a foreign jaxlib), the measured overlay and
  the cache fingerprint, a profile swap re-planning through the cache.
* One real probe child on the CPU at smoke size, whose digest is the
  same at ring depths 2 and 4.
"""

import json
import math
import zlib

import numpy as np
import pandas as pd
import pytest

from tempo_tpu import profiling as ref_profiling
from tempo_tpu.tune import harness as ref_harness
from tempo_tpu.tune import profile as ref_tp
from tempo_tpu.tune import space as ref_space
from tempo_tpu_torch import TSDF, config, profiling, tune
from tempo_tpu_torch.parallel import make_mesh
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import cost
from tempo_tpu_torch.tune import harness, space
from tempo_tpu_torch.tune import profile as tp


@pytest.fixture(autouse=True)
def _clean_tune_state(monkeypatch):
    for k in tp.TUNABLE_KNOBS + ("TEMPO_TPU_TUNE_PROFILE",):
        monkeypatch.delenv(k, raising=False)
    tune.reload()
    cost.clear_measured()
    plan_cache.CACHE.clear()
    yield
    tune.reload()
    cost.clear_measured()
    plan_cache.CACHE.clear()


def _write_profile(path, knobs=None, measured=None, classes=None,
                   fingerprint=None):
    payload = {
        "format_version": tp.FORMAT_VERSION,
        "fingerprint": fingerprint or tp.runtime_fingerprint(),
        "created_unix": 0, "smoke": True, "margin": 0.02,
        "classes": classes or {},
        "knobs": knobs or {},
        "measured": measured or {},
    }
    return tp.write(payload, str(path))


def _frame(cols, K=4, L=64, seed=0):
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, L)), axis=-1)
    data = {"sym": np.repeat(np.arange(K), L),
            "event_ts": secs.ravel().astype(np.int64)}
    for c in cols:
        data[c] = rng.standard_normal(K * L)
    return TSDF(pd.DataFrame(data), "event_ts", ["sym"], device="cpu")


# ----------------------------------------------------------------------
# pure functions against the reference, exactly
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_window_roofline_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        kw = dict(
            n_rows=int(rng.integers(0, 10**7)),
            read_bytes_per_row=float(rng.integers(0, 64)),
            write_bytes_per_row=float(rng.integers(0, 64)),
            restream_bytes_per_row=float(rng.choice([0.0, 4.0, 9.5])),
            t_iter=(None if rng.random() < 0.2
                    else float(rng.uniform(1e-5, 2.0))),
            stream_bytes_per_sec=(None if rng.random() < 0.2
                                  else float(rng.uniform(1e9, 4e12))),
            n_cols=int(rng.integers(1, 5)),
            key_bytes_per_row=float(rng.choice([0.0, 4.0, 8.0])))
        assert profiling.window_roofline(**kw) == \
            ref_profiling.window_roofline(**kw), kw


@pytest.mark.parametrize("seed", range(8))
def test_payload_crc_matches_reference(seed):
    rng = np.random.default_rng(seed)
    payload = {
        "format_version": 1,
        "fingerprint": {"device_kind": f"card-{seed}", "torch": "2.x"},
        "knobs": {k: int(rng.integers(1, 64)) for k in tp.TUNABLE_KNOBS
                  if rng.random() < 0.5},
        "measured": {"hbm_stream_rate": float(rng.uniform(1e9, 4e12))},
        "classes": {c.name: {"speedup": float(rng.uniform(0.5, 2)),
                             "rejected": [], "probes": int(seed)}
                    for c in space.SPACE},
        "crc": int(rng.integers(0, 2**32)),
    }
    assert tp.payload_crc(payload) == ref_tp.payload_crc(payload)
    path_payload = dict(payload)
    path_payload.pop("crc")
    assert tp.payload_crc(path_payload) == tp.payload_crc(payload)


# ----------------------------------------------------------------------
# harness decisions against the reference's, on the same script
# ----------------------------------------------------------------------

SHARED = [c.name for c in space.SPACE]


def _ref_class(port_cls):
    """The reference's class of that name, cut to the axes whose knobs
    the port has (its stream_dense also sweeps TEMPO_TPU_MEGACORE)."""
    ref = {c.name: c for c in ref_space.SPACE}[port_cls.name]
    axes = tuple(a for a in ref.axes if a.knob in tp.TUNABLE_KNOBS)
    owns = tuple(k for k in ref.owns if k in tp.TUNABLE_KNOBS)
    return ref._replace(axes=axes, owns=owns)


def _scripted(seed):
    """A deterministic probe_fn: rates, digests and child deaths drawn
    from a generator keyed by (seed, probe, knobs, the call's ordinal for
    those knobs), so two harnesses that make the same calls in the same
    order see the same records."""
    seen = {}

    def fn(probe, knobs, smoke=False, timeout=None):
        key = tuple(sorted((k, str(v)) for k, v in knobs.items()))
        n = seen[key] = seen.get(key, 0) + 1
        r = np.random.default_rng(
            zlib.crc32(repr((seed, probe, key, n, smoke)).encode()))
        if knobs and r.random() < 0.1:
            return {"error": "child died"}
        flap = seed == 4 and "TEMPO_BENCH_TUNE_NO_SAXPY" in knobs
        digest = 42 if (not knobs or r.random() > 0.15
                        or "TEMPO_BENCH_TUNE_NO_SAXPY" in knobs) else 7
        base = not knobs or "TEMPO_BENCH_TUNE_NO_SAXPY" in knobs
        rate = r.uniform(900, 1100) if base else r.uniform(600, 1800)
        rec = {"class": probe, "rows_per_sec": float(rate),
               "t_iter": 1e-3, "bytes_per_iter": 100,
               "digest": 43 if flap else digest}
        if not knobs:
            rec["stream_gbps"] = 1234.5
        return rec
    return fn


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "sweep_seconds"}


def test_port_ladders_equal_the_reference_ladders():
    for cls in space.SPACE:
        ref = _ref_class(cls)
        assert cls.probe == ref.probe
        assert cls.axes == ref.axes, cls.name
        assert cls.owns == ref.owns, cls.name


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", SHARED)
def test_sweep_class_decisions_match_reference(name, seed, smoke):
    cls = {c.name: c for c in space.SPACE}[name]
    got, got_f = harness.sweep_class(cls, smoke=smoke,
                                     probe_fn=_scripted(seed))
    want, want_f = ref_harness.sweep_class(_ref_class(cls), smoke=smoke,
                                           probe_fn=_scripted(seed))
    assert _strip(got) == _strip(want)
    assert got_f == want_f


@pytest.mark.parametrize("seed", range(3))
def test_sweep_payload_matches_reference(seed, monkeypatch):
    monkeypatch.setattr(ref_space, "SPACE",
                        tuple(_ref_class(c) for c in space.SPACE))
    got, got_f = harness.sweep(probe_fn=_scripted(seed), device="cpu")
    want, want_f = ref_harness.sweep(probe_fn=_scripted(seed))
    assert got_f == want_f
    for key in ("knobs", "measured", "margin", "smoke", "format_version"):
        assert got[key] == want[key], key
    assert {n: _strip(r) for n, r in got["classes"].items()} == \
        {n: _strip(r) for n, r in want["classes"].items()}
    assert got["device"] == "cpu"
    assert set(got["fingerprint"]) == set(tp.FINGERPRINT_KEYS)


# ----------------------------------------------------------------------
# profile lifecycle: roundtrip, priority, refusal by name
# ----------------------------------------------------------------------

def test_no_profile_ships_for_the_cpu():
    assert tp.runtime_fingerprint()["device_kind"] == "cpu"
    assert tune.load(strict=True) is None
    assert tune.stamp() is None
    assert config.snapshot() == ()


def test_profile_roundtrip_and_reader_priority(tmp_path, monkeypatch):
    from tempo_tpu_torch.io import ingest
    from tempo_tpu_torch.ops import rolling, stream
    from tempo_tpu_torch.plan import optimizer

    p = _write_profile(
        tmp_path / "prof.json",
        knobs={"TEMPO_TPU_DMA_BUFFERS": 4,
               "TEMPO_TPU_STREAM_MAX_ROWS": 32768,
               "TEMPO_TPU_STITCH_MAX_OPS": 4,
               "TEMPO_TPU_INGEST_RING": 8})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is not None
    assert tune.active_path() == p
    # the profile beats the built-in defaults...
    assert stream.dma_buffers() == 4
    assert stream.range_plan(100, 2, 4096).depth == 4
    assert rolling.stream_max_rows() == 32768
    assert optimizer._stitch_max_ops() == 4
    assert ingest.ingest_ring() == 8
    # ...and a knob set in the environment beats the profile
    monkeypatch.setenv("TEMPO_TPU_DMA_BUFFERS", "3")
    monkeypatch.setenv("TEMPO_TPU_STREAM_MAX_ROWS", "8192")
    monkeypatch.setenv("TEMPO_TPU_STITCH_MAX_OPS", "1")
    monkeypatch.setenv("TEMPO_TPU_INGEST_RING", "1")
    assert stream.dma_buffers() == 3
    assert rolling.stream_max_rows() == 8192
    assert optimizer._stitch_max_ops() == 1
    assert ingest.ingest_ring() == 1


def test_class_winner_beats_merged_knob(tmp_path, monkeypatch):
    from tempo_tpu_torch.io import ingest
    from tempo_tpu_torch.plan import optimizer

    p = _write_profile(
        tmp_path / "prof.json",
        classes={"stitched_chain": {"knobs": {"TEMPO_TPU_STITCH_MAX_OPS": 16}},
                 "ingest_sweep": {"knobs": {"TEMPO_TPU_INGEST_RING": 4}}},
        knobs={"TEMPO_TPU_STITCH_MAX_OPS": 1, "TEMPO_TPU_INGEST_RING": 1})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert optimizer._stitch_max_ops() == 16
    assert ingest.ingest_ring() == 4
    assert tune.knob_value("TEMPO_TPU_STITCH_MAX_OPS") == 1


def test_serve_executor_batch_rows_from_profile(tmp_path, monkeypatch):
    from tempo_tpu_torch.serve import MicroBatchExecutor, StreamingTSDF

    p = _write_profile(
        tmp_path / "prof.json",
        classes={"serve_batch": {
            "knobs": {"TEMPO_TPU_SERVE_BATCH_ROWS": 16}}},
        knobs={"TEMPO_TPU_SERVE_BATCH_ROWS": 16})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    stream = StreamingTSDF(["s0"], ["v"], window_secs=5.0,
                           window_rows_bound=8, device="cpu")
    ex = MicroBatchExecutor(stream)
    try:
        assert ex.batch_rows == 16
    finally:
        ex.close()
    monkeypatch.setenv("TEMPO_TPU_SERVE_BATCH_ROWS", "32")
    ex2 = MicroBatchExecutor(stream)
    try:
        assert ex2.batch_rows == 32
    finally:
        ex2.close()


def test_cohort_executor_coalesce_from_profile(tmp_path, monkeypatch):
    from tempo_tpu_torch.serve import CohortExecutor, StreamCohort

    cohort = StreamCohort(("px",), window_secs=10.0, window_rows_bound=8,
                          max_lookback=4, slots=2, device="cpu")
    ex = CohortExecutor(cohort)
    try:
        assert ex.coalesce_s == 0.002          # no profile: built-in
    finally:
        ex.close()
    p = _write_profile(
        tmp_path / "prof.json",
        classes={"serve_cohort": {
            "knobs": {"TEMPO_TPU_SERVE_COALESCE_S": 0.0}}},
        knobs={"TEMPO_TPU_SERVE_COALESCE_S": 0.008})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    ex = CohortExecutor(cohort)
    try:
        assert ex.coalesce_s == 0.0            # the class winner
    finally:
        ex.close()
    monkeypatch.setenv("TEMPO_TPU_SERVE_COALESCE_S", "0.004")
    ex = CohortExecutor(cohort)
    try:
        assert ex.coalesce_s == 0.004
    finally:
        ex.close()


def test_off_and_unset_resolution(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", "off")
    assert tune.load() is None
    assert tune.knob_value("TEMPO_TPU_DMA_BUFFERS") is None
    assert tune.measured() == {}
    assert tune.stamp() is None


def test_corrupt_profile_refused_by_name(tmp_path, monkeypatch):
    from tempo_tpu_torch.ops import stream

    p = _write_profile(tmp_path / "prof.json",
                       knobs={"TEMPO_TPU_DMA_BUFFERS": 4})
    raw = json.load(open(p))
    raw["knobs"]["TEMPO_TPU_DMA_BUFFERS"] = 8   # CRC now stale
    json.dump(raw, open(p, "w"))
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is None
    assert stream.dma_buffers() == 2
    with pytest.raises(tp.TuneProfileError, match="CRC mismatch"):
        tune.load(strict=True)
    with pytest.raises(tp.TuneProfileError, match="prof.json"):
        tune.load(strict=True)


@pytest.mark.parametrize("key,value", [("device_kind", "NVIDIA A100"),
                                       ("torch", "1.0.0"),
                                       ("cuda", "11.0")])
def test_foreign_fingerprint_refused_by_name(tmp_path, monkeypatch, key,
                                             value):
    fp = tp.runtime_fingerprint()
    fp[key] = value
    p = _write_profile(tmp_path / "foreign.json",
                       knobs={"TEMPO_TPU_DMA_BUFFERS": 8}, fingerprint=fp)
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is None
    with pytest.raises(tp.TuneProfileError) as ei:
        tune.load(strict=True)
    msg = str(ei.value)
    assert "foreign fingerprint" in msg and key in msg
    assert value in msg and "foreign.json" in msg


def test_reference_profile_refused_by_name(tmp_path, monkeypatch):
    """A profile the reference wrote is keyed by jaxlib, which the port
    never matches, so it is refused by name."""
    raw = json.load(open(ref_tp.default_path("cpu")))
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(raw))
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", str(path))
    with pytest.raises(tp.TuneProfileError, match="foreign fingerprint"):
        tune.load(strict=True)


def test_missing_explicit_path_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE",
                       str(tmp_path / "nope.json"))
    assert tune.load() is None
    with pytest.raises(tp.TuneProfileError, match="does not exist"):
        tune.load(strict=True)


@pytest.mark.parametrize("knob", ["TEMPO_TPU_PLAN", "TEMPO_TPU_PACK_COLS",
                                  "TEMPO_TPU_JOIN_CHUNK_LANES",
                                  "TEMPO_TPU_MEGACORE"])
def test_undeclared_or_dropped_knob_refused(tmp_path, monkeypatch, knob):
    p = _write_profile(tmp_path / "bad.json", knobs={knob: 1})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    with pytest.raises(tp.TuneProfileError,
                       match=f"{knob}.*not a tunable knob"):
        tune.load(strict=True)
    p2 = _write_profile(tmp_path / "bad2.json",
                        classes={"stream_dense": {"knobs": {knob: 1}}})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p2)
    with pytest.raises(tp.TuneProfileError, match="not a tunable knob"):
        tune.load(strict=True)


@pytest.mark.parametrize("name", ["not_a_cost_input", "join_chunk_lanes"])
def test_undeclared_measured_input_refused(tmp_path, monkeypatch, name):
    p = _write_profile(tmp_path / "bad.json", measured={name: 1.0})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is None
    with pytest.raises(tp.TuneProfileError,
                       match="not a cost-model input"):
        tune.load(strict=True)


@pytest.mark.parametrize("bad", ["on", 3.5, True, None])
def test_malformed_knob_value_refused_by_name(tmp_path, monkeypatch, bad):
    from tempo_tpu_torch.ops import stream

    p = _write_profile(tmp_path / "badval.json",
                       knobs={"TEMPO_TPU_DMA_BUFFERS": bad})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is None
    assert stream.dma_buffers() == 2            # reader safe
    with pytest.raises(tp.TuneProfileError,
                       match="TEMPO_TPU_DMA_BUFFERS"):
        tune.load(strict=True)


@pytest.mark.parametrize("bad", [math.inf, "fast", False])
def test_malformed_float_knob_and_measured_refused(tmp_path, monkeypatch,
                                                   bad):
    p = _write_profile(tmp_path / "f.json",
                       knobs={"TEMPO_TPU_SERVE_COALESCE_S": bad})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    with pytest.raises(tp.TuneProfileError,
                       match="TEMPO_TPU_SERVE_COALESCE_S"):
        tune.load(strict=True)
    if not isinstance(bad, float):
        p2 = _write_profile(tmp_path / "m.json",
                            measured={"hbm_stream_rate": bad})
        monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p2)
        with pytest.raises(tp.TuneProfileError, match="non-numeric"):
            tune.load(strict=True)


# ----------------------------------------------------------------------
# cost-model consumption: measured overlay, fingerprint, graph keys
# ----------------------------------------------------------------------

def test_measured_overlay_and_fingerprint(tmp_path, monkeypatch):
    fp_off = cost.fingerprint()
    p = _write_profile(tmp_path / "m.json",
                       measured={"hbm_stream_rate": 123e9})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    params = cost.params()
    assert params["hbm_stream_rate"] == 123e9
    assert params["tune_profile_crc"] == float(tune.load()["crc"])
    assert cost.fingerprint() != fp_off
    cost.set_measured(hbm_stream_rate=9e9)
    assert cost.params()["hbm_stream_rate"] == 9e9
    monkeypatch.setenv("TEMPO_TPU_COST_MODEL", "0")
    assert cost.fingerprint() == ("cost-off", float(tune.load()["crc"]))


def test_graph_key_folds_the_profile_stamp(tmp_path, monkeypatch):
    """A captured graph's key (``config.snapshot()``) changes with the
    profile, so a swap re-captures instead of replaying a graph whose
    kernels were planned under the other profile's ring depth."""
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", "off")
    off = config.snapshot()
    pa = _write_profile(tmp_path / "a.json",
                        knobs={"TEMPO_TPU_DMA_BUFFERS": 4})
    pb = _write_profile(tmp_path / "b.json",
                        knobs={"TEMPO_TPU_DMA_BUFFERS": 6})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", pa)
    a = config.snapshot()
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", pb)
    b = config.snapshot()
    assert len({off, a, b}) == 3
    assert ("tune_profile_crc", float(tune.load()["crc"])) in b


def _chain(seed):
    left = _frame(["x"], seed=seed)
    right = _frame(["v0", "v1"], seed=seed + 1)
    mesh = make_mesh({"series": 1}, devices=["cpu"])
    return (left.on_mesh(mesh).asofJoin(right.on_mesh(mesh))
            .withRangeStats(colsToSummarize=["x"],
                            rangeBackWindowSecs=10)
            .EMA("x", exact=True)
            .collect().df)


def test_tuned_vs_default_bitwise_identity(tmp_path, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", "off")
    want = _chain(7)
    p = _write_profile(
        tmp_path / "t.json",
        knobs={"TEMPO_TPU_DMA_BUFFERS": 4,
               "TEMPO_TPU_STREAM_MAX_ROWS": 32768,
               "TEMPO_TPU_SERVE_BATCH_ROWS": 16},
        measured={"hbm_stream_rate": 7e9})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", p)
    assert tune.load() is not None
    pd.testing.assert_frame_equal(want, _chain(7), check_exact=True)


def test_profile_swap_replans_through_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_PLAN", "1")
    left = _frame(["x"], seed=3)
    right = _frame(["v"], seed=4)
    mesh = make_mesh({"series": 2}, devices=["cpu"] * 2)
    chain = (left.on_mesh(mesh).asofJoin(right.on_mesh(mesh))
             .withRangeStats(colsToSummarize=["x"],
                             rangeBackWindowSecs=10))
    pa = _write_profile(tmp_path / "a.json",
                        knobs={"TEMPO_TPU_DMA_BUFFERS": 4})
    pb = _write_profile(tmp_path / "b.json",
                        knobs={"TEMPO_TPU_DMA_BUFFERS": 6})
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", pa)
    out_a = chain.collect().df
    st = profiling.plan_cache_stats()
    assert (st["builds"], st["hits"]) == (1, 0)
    chain.collect()
    assert profiling.plan_cache_stats()["hits"] == 1
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", pb)
    out_b = chain.collect().df
    st = profiling.plan_cache_stats()
    assert st["builds"] == 2, (
        f"profile swap replayed a stale executable: {st}")
    pd.testing.assert_frame_equal(out_a, out_b, check_exact=True)
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", pa)
    chain.collect()
    st = profiling.plan_cache_stats()
    assert st["builds"] == 2 and st["hits"] >= 2, st


# ----------------------------------------------------------------------
# harness: descent, pruning, audit gate, hardware gating, merge rules
# ----------------------------------------------------------------------

def _cls(axes, owns=(), requires_cuda=False, name="c", probe="p"):
    return space.ShapeClass(name, probe, axes=tuple(axes),
                            owns=tuple(owns), requires_cuda=requires_cuda)


def _fake_probe(rates, digests=None, calls=None):
    def fn(probe, knobs, smoke=False, timeout=None):
        key = tuple(sorted(knobs.items()))
        if calls is not None:
            calls.append(key)
        if key in (rates or {}) and rates[key] is None:
            return {"error": "child died"}
        rate = (rates or {}).get(key, 1000.0)
        digest = (digests or {}).get(key, 42)
        return {"class": probe, "rows_per_sec": rate, "t_iter": 0.001,
                "bytes_per_iter": 100, "digest": digest}
    return fn


def test_harness_picks_winner_and_merges_owned_knobs():
    ax = space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 3, 4), (2, 3, 4))
    rates = {(): 1000.0,
             (("TEMPO_TPU_DMA_BUFFERS", 3),): 1500.0,
             (("TEMPO_TPU_DMA_BUFFERS", 4),): 1400.0}
    cls = _cls([ax], owns=["TEMPO_TPU_DMA_BUFFERS"])
    rec, fails = harness.sweep_class(cls, probe_fn=_fake_probe(rates))
    assert not fails
    assert rec["knobs"] == {"TEMPO_TPU_DMA_BUFFERS": 3}
    assert rec["rows_per_sec"] == 1500.0 and rec["speedup"] == 1.5


def test_harness_merges_only_owned_knobs(monkeypatch):
    ax = space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4))
    owner = _cls([ax], owns=["TEMPO_TPU_DMA_BUFFERS"], name="owner")
    cross = _cls([ax], owns=[], name="cross")
    monkeypatch.setattr(space, "SPACE", (owner, cross))
    rates = {(("TEMPO_TPU_DMA_BUFFERS", 4),): 2000.0}
    payload, fails = harness.sweep(probe_fn=_fake_probe(rates))
    assert not fails
    assert payload["knobs"] == {"TEMPO_TPU_DMA_BUFFERS": 4}
    assert payload["classes"]["cross"]["knobs"] == {
        "TEMPO_TPU_DMA_BUFFERS": 4}


def test_harness_bitwise_audit_rejects_and_flags_neutral_axes():
    ax = space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4))
    digests = {(("TEMPO_TPU_DMA_BUFFERS", 4),): 999}
    rates = {(("TEMPO_TPU_DMA_BUFFERS", 4),): 99999.0}
    cls = _cls([ax], owns=["TEMPO_TPU_DMA_BUFFERS"])
    rec, fails = harness.sweep_class(
        cls, probe_fn=_fake_probe(rates, digests))
    assert rec["knobs"] == {}
    assert "bitwise-audit" in rec["rejected"][0]["reason"]
    assert fails and fails[0]["class"] == "c"


def test_harness_nonneutral_axis_rejection_is_not_a_failure():
    ax = space.Axis("TEMPO_TPU_STREAM_MAX_ROWS", (16384, 32768),
                    (16384, 32768), bitwise_neutral=False)
    digests = {(("TEMPO_TPU_STREAM_MAX_ROWS", 32768),): 7}
    cls = _cls([ax], owns=["TEMPO_TPU_STREAM_MAX_ROWS"])
    rec, fails = harness.sweep_class(cls,
                                     probe_fn=_fake_probe({}, digests))
    assert rec["rejected"] and not fails
    assert rec["knobs"] == {}


def test_harness_nonneutral_axis_never_crowns_a_winner():
    ax = space.Axis("TEMPO_TPU_STREAM_MAX_ROWS", (16384, 32768),
                    (16384, 32768), bitwise_neutral=False)
    rates = {(("TEMPO_TPU_STREAM_MAX_ROWS", 32768),): 99999.0}
    cls = _cls([ax], owns=["TEMPO_TPU_STREAM_MAX_ROWS"])
    rec, fails = harness.sweep_class(cls, probe_fn=_fake_probe(rates))
    assert not fails and rec["knobs"] == {}
    assert rec["rows_per_sec"] == rec["default_rows_per_sec"]
    assert "legality-ceiling" in rec["rejected"][0]["reason"]


def test_harness_baseline_nondeterminism_fails_loudly():
    digests = iter([42, 43, 42, 42])

    def flappy(probe, knobs, smoke=False, timeout=None):
        return {"class": probe, "rows_per_sec": 1000.0, "t_iter": 1e-3,
                "bytes_per_iter": 100, "digest": next(digests)}

    cls = _cls([space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4))],
               owns=["TEMPO_TPU_DMA_BUFFERS"])
    rec, fails = harness.sweep_class(cls, probe_fn=flappy)
    assert "nondeterminism" in rec["error"]
    assert fails and "nondeterminism" in fails[0]["reason"]


def test_harness_prunes_dominated_ladder():
    ax = space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 3, 4, 6, 8),
                    (2, 3, 4, 6, 8))
    calls = []
    cls = _cls([ax], owns=["TEMPO_TPU_DMA_BUFFERS"])
    rec, _ = harness.sweep_class(cls,
                                 probe_fn=_fake_probe({}, calls=calls))
    assert len(calls) == 2 + harness.PRUNE_AFTER
    assert rec["knobs"] == {}


def test_harness_hardware_gates_cuda_classes_on_the_cpu():
    cls = _cls([space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4))],
               owns=["TEMPO_TPU_DMA_BUFFERS"], requires_cuda=True)
    calls = []
    rec, fails = harness.sweep_class(cls, device="cpu",
                                     probe_fn=_fake_probe({}, calls=calls))
    assert "CUDA" in rec["hardware_gated"] and not fails and not calls
    rec, _ = harness.sweep_class(cls, device="cuda",
                                 probe_fn=_fake_probe({}))
    assert "hardware_gated" not in rec


def test_harness_baseline_error_records_class_error():
    cls = _cls([space.Axis("TEMPO_TPU_DMA_BUFFERS", (2, 4), (2, 4))])
    rec, fails = harness.sweep_class(
        cls, probe_fn=_fake_probe({(): None}))
    assert "error" in rec and not fails


def test_smoke_cli_fails_on_errored_class(monkeypatch, capsys):
    from tempo_tpu_torch.tune import __main__ as tune_main

    def broken_sweep(class_names=None, smoke=False, out_path=None,
                     probe_fn=None, device="cuda"):
        return {"classes": {"stream_medium": {
            "error": "baseline probe failed: child rc=1"}}}, []

    monkeypatch.setattr(harness, "sweep", broken_sweep)
    assert tune_main.main(["--smoke", "--device", "cpu"]) != 0
    assert "SWEEP BROKEN" in capsys.readouterr().err

    def partial_sweep(class_names=None, smoke=False, out_path=None,
                      probe_fn=None, device="cuda"):
        assert device == "cpu"
        return {"classes": {
            "stream_medium": {"error": "child rc=1"},
            "serve_batch": {"rows_per_sec": 5000.0,
                            "default_rows_per_sec": 5000.0,
                            "speedup": 1.0, "knobs": {}, "probes": 3,
                            "rejected": []},
        }}, []

    monkeypatch.setattr(harness, "sweep", partial_sweep)
    assert tune_main.main(["--out", "/dev/null", "--device", "cpu"]) == 0
    monkeypatch.setattr(harness, "sweep", broken_sweep)
    assert tune_main.main(["--out", "/dev/null"]) != 0


def test_sweep_payload_roundtrips_through_profile(tmp_path, monkeypatch):
    ax = space.Axis("TEMPO_TPU_SERVE_BATCH_ROWS", (64, 16), (64, 16))
    cls = _cls([ax], owns=["TEMPO_TPU_SERVE_BATCH_ROWS"],
               name="serve_batch")
    monkeypatch.setattr(space, "SPACE", (cls,))
    rates = {(("TEMPO_TPU_SERVE_BATCH_ROWS", 16),): 5000.0}
    out = tmp_path / "swept.json"
    payload, fails = harness.sweep(probe_fn=_fake_probe(rates),
                                   out_path=str(out))
    assert not fails and out.exists()
    monkeypatch.setenv("TEMPO_TPU_TUNE_PROFILE", str(out))
    prof = tune.load(strict=True)
    assert prof["knobs"] == {"TEMPO_TPU_SERVE_BATCH_ROWS": 16}
    assert tune.knob_value("TEMPO_TPU_SERVE_BATCH_ROWS",
                           "serve_batch") == 16


def test_space_registry_is_well_formed():
    names = [c.name for c in space.SPACE]
    assert names == ["stream_dense", "stream_medium", "fused_chain",
                     "serve_batch", "ingest_sweep", "stitched_chain",
                     "serve_cohort"]
    for cls in space.SPACE:
        for axis in cls.axes:
            assert axis.knob in tp.TUNABLE_KNOBS
            assert axis.knob in config.KNOBS
            assert axis.values[0] == axis.smoke_values[0]
        for knob in cls.owns:
            assert any(a.knob == knob for a in cls.axes)
    owned = [k for c in space.SPACE for k in c.owns]
    assert len(owned) == len(set(owned))
    assert set(owned) == set(tp.TUNABLE_KNOBS)
    assert {c.name for c in space.classes(smoke=True)} == {
        "stream_medium", "serve_batch"}
    with pytest.raises(KeyError, match="unknown shape class"):
        space.classes(["nope"])


# ----------------------------------------------------------------------
# one real probe child, on the CPU at smoke size
# ----------------------------------------------------------------------

def test_real_probe_child_digest_is_depth_neutral():
    base = harness.run_probe("stream_medium", {}, smoke=True,
                             device="cpu", timeout=240)
    deep = harness.run_probe("stream_medium",
                             {"TEMPO_TPU_DMA_BUFFERS": 4}, smoke=True,
                             device="cpu", timeout=240)
    assert "error" not in base, base
    assert "error" not in deep, deep
    assert base["digest"] == deep["digest"]
    assert base["device"] == "cpu" and base["knobs"] == {}
    assert deep["knobs"] == {"TEMPO_TPU_DMA_BUFFERS": "4"}
    assert base["rows_per_sec"] > 0 and base["stream_gbps"] > 0
    assert "stream_gbps" not in deep
    assert base["bytes_per_iter"] == 64 * 512 * 37
