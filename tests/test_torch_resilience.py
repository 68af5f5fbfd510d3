"""The port's resilience layer (``tempo_tpu_torch/resilience.py``) and
fault injector (``tempo_tpu_torch/testing/faults.py``) against the
reference's, on the same cases: failure classification, the retry
schedule under a fake clock, deadlines, the circuit breaker's state
machine, the pipeline signatures, and ``run_resumable`` killed and
resumed on host and mesh frames.  Every comparison is exact (kinds,
states, sleep schedules, signatures, frames)."""

import errno
import random
import zipfile

import numpy as np
import pandas as pd
import pytest

from tempo_tpu import resilience as ref_res
from tempo_tpu.testing import faults as ref_faults
from tempo_tpu_torch import TSDF, checkpoint, make_mesh, resilience
from tempo_tpu_torch.testing import faults


def _cases(res, flt):
    timeout = OSError(errno.ETIMEDOUT, "connection timed out")
    tagged = RuntimeError("looks permanent")
    tagged.failure_kind = res.FailureKind.TRANSIENT_IO
    return [
        OSError(errno.EIO, "io"), OSError(errno.ECONNRESET, "rst"),
        ConnectionResetError(), FileNotFoundError(errno.ENOENT, "gone", "f"),
        zipfile.BadZipFile("bad crc"), EOFError(),
        res.CheckpointError("checksum mismatch"),
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 1 byte"),
        RuntimeError("LLVM: Cannot allocate memory"), MemoryError("budget"),
        RuntimeError("DEVICE_LOST: chip halted"), TimeoutError("no"),
        RuntimeError("DEADLINE_EXCEEDED: barrier"), timeout, tagged,
        flt.InjectedFault(), ValueError("bug"),
        RuntimeError("service unavailable, try again"),
        res.DeadlineExceeded("x", stage="s"), res.QuarantinedError("q"),
    ]


@pytest.mark.parametrize("i", range(20))
def test_classify_agrees_with_the_reference(i):
    got = resilience.classify(_cases(resilience, faults)[i])
    want = ref_res.classify(_cases(ref_res, ref_faults)[i])
    assert got.value == want.value


def _schedule(res, flt, policy_kw, failures):
    """(outcome, sleeps) of one retried call under a fake clock."""
    now = {"t": 0.0}
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        now["t"] += s

    calls = {"n": 0}

    @res.retrying(res.RetryPolicy(**policy_kw), sleep=sleep,
                  clock=lambda: now["t"], rng=random.Random(0))
    def op():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise flt.InjectedFault(f"flake {calls['n']}")
        return "ok"

    try:
        out = op()
    except Exception as e:                  # the outcome is compared
        out = type(e).__name__
    return out, sleeps, calls["n"]


@pytest.mark.parametrize("policy_kw,failures", [
    (dict(max_attempts=4, base_delay_s=0.1, max_delay_s=10.0, jitter=0.0), 2),
    (dict(max_attempts=6, base_delay_s=1.0, max_delay_s=3.0, jitter=0.5), 99),
    (dict(max_attempts=100, base_delay_s=10.0, jitter=0.0, deadline_s=15.0),
     99),
    (dict(max_attempts=3, retry_on=frozenset()), 1),
])
def test_retry_schedule_agrees_with_the_reference(policy_kw, failures):
    ref_kw = dict(policy_kw)
    if "retry_on" in ref_kw:
        ref_kw["retry_on"] = frozenset()
    got = _schedule(resilience, faults, policy_kw, failures)
    want = _schedule(ref_res, ref_faults, ref_kw, failures)
    assert got == want


def test_deadline_names_its_stage_like_the_reference():
    for res in (resilience, ref_res):
        now = {"t": 0.0}
        d = res.Deadline.after(2.0, clock=lambda: now["t"])
        assert res.Deadline.after(None) is None
        assert res.Deadline.after(0) is None
        assert res.Deadline.after(d) is d
        d.check("queue")
        now["t"] = 2.5
        assert d.expired() and d.remaining() == pytest.approx(-0.5)
        with pytest.raises(res.DeadlineExceeded) as ei:
            d.check("dispatch")
        assert ei.value.stage == "dispatch"
        assert res.classify(ei.value) is res.FailureKind.DEADLINE


def _breaker_trace(res):
    now = {"t": 0.0}
    br = res.CircuitBreaker(threshold=2, cooldown_s=5.0,
                            clock=lambda: now["t"])
    trace = []

    def step(action, *args):
        try:
            out = getattr(br, action)("k", *args)
        except res.QuarantinedError as e:
            out = ("quarantined", e.retry_after_s)
        trace.append((action, out, br.state("k")))

    step("allow")
    step("record", False)
    step("record", False)           # opens
    step("allow")
    now["t"] = 5.0
    step("allow")                   # the half-open probe
    step("allow")                   # probe in flight: refused
    step("record", False)           # probe failed: re-opens
    now["t"] = 10.5
    step("allow")
    step("abandon")
    step("allow")
    step("record", True)            # closes
    return trace, br.stats()


def test_circuit_breaker_walks_the_reference_states():
    assert _breaker_trace(resilience) == _breaker_trace(ref_res)


def test_breaker_knobs_are_read(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_BREAKER_THRESHOLD", "7")
    monkeypatch.setenv("TEMPO_TPU_BREAKER_COOLDOWN_S", "1.5")
    br = resilience.CircuitBreaker()
    assert (br.threshold, br.cooldown_s) == (7, 1.5)


@pytest.mark.parametrize("steps", [
    [("EMA", {"colName": "x", "window": 5, "exact": True})],
    ["describe", ("withRangeStats", {"rangeBackWindowSecs": np.int64(60)})],
    [lambda f: f, ("resample", {"freq": "1 minute", "func": "mean"})],
])
def test_pipeline_signature_is_the_reference_one(steps):
    assert resilience.pipeline_signature(steps) == \
        ref_res.pipeline_signature(steps)


def test_host_frame_signature_is_the_reference_one():
    """The same frame and chain stamp the same resume signature in both
    packages (the content fingerprint hashes the same pandas data)."""
    import tempo_tpu

    df = _df()
    steps = [("EMA", {"colName": "x", "window": 4, "exact": True})]
    assert resilience.resume_signature(
        TSDF(df, "event_ts", ["sym"], device="cpu"), steps) == \
        ref_res.resume_signature(tempo_tpu.TSDF(df, "event_ts", ["sym"]),
                                 steps)


def _df(seed=4, n=120):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "sym": rng.choice(["a", "b", "c"], n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 900, n)) * 10**9),
        "x": rng.standard_normal(n),
    })


STEPS = [("EMA", {"colName": "x", "window": 4, "exact": True}),
         ("withRangeStats", {"colsToSummarize": ["x"],
                             "rangeBackWindowSecs": 60})]


@pytest.mark.parametrize("on_mesh", [False, True])
def test_run_resumable_killed_then_resumed(tmp_path, on_mesh):
    frame = TSDF(_df(), "event_ts", ["sym"], device="cpu")
    if on_mesh:
        frame = frame.on_mesh(make_mesh({"series": 2},
                                        devices=["cpu"] * 2))
    ck = str(tmp_path / "ck")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(checkpoint, "_savez" if on_mesh
                        else "_write_parquet", call_no=2)
        with pytest.raises(faults.SimulatedKill):
            resilience.run_resumable(frame, STEPS, ck)
    assert [s for s, _ in checkpoint.list_steps(ck)] == [1]
    ran = []
    steps = [lambda f, s=s: ran.append(s[0]) or getattr(f, s[0])(**s[1])
             for s in STEPS]
    sig = resilience.resume_signature(frame, STEPS)
    got = resilience.run_resumable(frame, steps, ck, signature=sig)
    assert ran == ["withRangeStats"], "resume re-ran a committed step"
    want = frame.EMA(**STEPS[0][1]).withRangeStats(**STEPS[1][1])
    if on_mesh:
        got, want = got.collect(), want.collect()
    pd.testing.assert_frame_equal(got.df, want.df, check_exact=True)
    with pytest.raises(resilience.CheckpointError, match="DIFFERENT"):
        resilience.run_resumable(frame, steps, ck, signature="other")


def test_fault_helpers_corrupt_what_they_name(tmp_path):
    p = str(tmp_path / "a.npz")
    np.savez(p, small=np.arange(4), big=np.arange(4096, dtype=np.float64))
    assert faults.corrupt_npz_array(p) == "big"
    with np.load(p) as z, pytest.raises(zipfile.BadZipFile):
        z["big"]
    f = tmp_path / "f.bin"
    f.write_bytes(bytes(100))
    faults.flip_byte(str(f), 3)
    assert f.read_bytes()[3] == 0xFF
    assert faults.truncate_file(str(f), 0.25) == 25
    tmp = faults.make_stale_tmp(str(tmp_path / "ck"))
    assert tmp.endswith(".tmp")
    checkpoint.list_steps(str(tmp_path))     # cleans manifest-less residue
    assert not (tmp_path / "ck.tmp").exists()
