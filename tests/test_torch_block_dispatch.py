"""Block dispatch in the port (``StreamCohort.dispatch_block`` and
``CohortExecutor.submit_block``) on the CPU.

The contract: for the single-tick-a-(member, series) majority of a block,
one block program a side scatters the compact ticks into the padded
batch (pad ticks into the sink slot ``S``), steps and gathers the
emissions back; its results and the state it leaves are BITWISE the
per-tick route's.  Ticks the block programs cannot take (duplicate
(member, series) ticks, spilled cohorts, meshed cohorts) take the
per-tick route in arrival order a member, counted in ``routes``;
rejections are per tick index; the block programs join the warm-up
ladder; a block ticket is a barrier in the executor's split.  Against
``tempo_tpu.serve.StreamCohort.dispatch_block`` on the same blocks: the
selections bitwise, the EMA within one ulp of its largest value over
``alpha`` (XLA:CPU's fused multiply-add, ``test_torch_serve.py``).
"""

import time

import numpy as np
import pytest
import torch

from tempo_tpu import serve as ref_serve
from tempo_tpu_torch import dist, profiling
from tempo_tpu_torch.parallel import mesh as mesh_mod
from tempo_tpu_torch.resilience import (CircuitBreaker, QuarantinedError,
                                        ShutdownError)
from tempo_tpu_torch.serve import (BlockTicket, CohortExecutor,
                                   LateTickError, StreamCohort)
from tempo_tpu_torch.serve import state as sst
from tempo_tpu_torch.testing import faults

S = 8
KW = dict(window_secs=10.0, window_rows_bound=8, ema_alpha=0.2,
          max_lookback=8)
WAIT = 60


def _mk(slots=S, n=S, pkg=StreamCohort, **kw):
    extra = {"device": "cpu"} if pkg is StreamCohort else {}
    cohort = pkg(("px", "qty"), slots=slots, **KW, **extra, **kw)
    members = [cohort.add_stream(f"u{i}", ["ticks"]) for i in range(n)]
    return cohort, members


def _gen_block(rng, n, n_members, t0=0, left_p=0.35):
    mi = rng.integers(0, n_members, n)
    ts = t0 + np.sort(rng.integers(0, 900 * n, n)).astype(np.int64)
    is_left = rng.random(n) < left_p
    vals = {"px": rng.standard_normal(n).astype(np.float32),
            "qty": rng.standard_normal(n).astype(np.float32)}
    return mi, ts, is_left, vals


def _per_tick_ref(cohort, members, mi, ts, is_left, vals):
    """Each block tick as its own dispatch, in block order."""
    out = []
    for i in range(len(mi)):
        side = "left" if is_left[i] else "right"
        row = (None if is_left[i] else
               {c: float(v[i]) for c, v in vals.items()})
        out.append(cohort.dispatch(
            side, [(members[mi[i]], "ticks", int(ts[i]), None, row)])[0])
    return out


def _assert_block_matches(out, errors, ref):
    for i, r in enumerate(ref):
        if isinstance(r, Exception):
            assert type(errors[i]) is type(r), (i, errors.get(i), r)
            continue
        assert i not in errors, (i, errors[i])
        for name, v in r.items():
            got, want = np.asarray(out[name][i]), np.asarray(v)
            assert got.dtype == want.dtype and \
                got.tobytes() == want.tobytes(), (i, name, got, want)


def _same_state(c1, c2):
    for bucket, g in c1._groups.items():
        h = c2._groups[bucket]
        for name, a in g.host_state().items():
            assert a.tobytes() == h.host_state()[name].tobytes(), name
        assert g.wm_ts.tobytes() == h.wm_ts.tobytes()
        assert g.wm_seq.tobytes() == h.wm_seq.tobytes()
        assert g.wm_side.tobytes() == h.wm_side.tobytes()


# ----------------------------------------------------------------------
# dispatch_block against the per-tick route
# ----------------------------------------------------------------------

def test_block_equals_per_tick_unique_members():
    """Every (member, series) once: a mixed block runs as at most one
    push and one query program, bitwise the per-tick route's results
    and state (all slots, watermarks included)."""
    c1, m1 = _mk()
    c2, m2 = _mk()
    rng = np.random.default_rng(0)
    for rnd in range(3):
        perm = rng.permutation(S)
        n = len(perm)
        ts = 10_000 * rnd + np.sort(rng.integers(0, 9_000, n)).astype(np.int64)
        is_left = rng.random(n) < 0.4
        vals = {"px": rng.standard_normal(n).astype(np.float32),
                "qty": rng.standard_normal(n).astype(np.float32)}
        ref = _per_tick_ref(c1, m1, perm, ts, is_left, vals)
        d0, b0 = c2.dispatches, c2.routes["block"]
        out, errors = c2.dispatch_block(
            is_left, [m2[j] for j in perm], "ticks", ts, values=vals)
        assert not errors
        assert c2.dispatches - d0 <= 2 and c2.routes["block"] - b0 <= 2
        _assert_block_matches(out, errors, ref)
    _same_state(c1, c2)
    assert c1.acked_total == c2.acked_total
    assert c2.routes["per_tick"] == 0 and c2.routes["fallback_ticks"] == 0


@pytest.mark.parametrize("nk", [1, 5, 7])
def test_pad_ticks_land_in_the_sink_and_leave_every_state_bit(nk):
    """A block of ``nk`` ticks pads to ``Nb = 8``: the pad ticks go to the
    sink slot and move no bit of any slot (the state equals the per-tick
    twin's over all 8 slots), and an all-pad block program leaves the
    state as it was."""
    c1, m1 = _mk()
    c2, m2 = _mk()
    rng = np.random.default_rng(nk)
    ts = np.arange(nk, dtype=np.int64) * 10 + 100
    vals = {"px": rng.standard_normal(nk).astype(np.float32),
            "qty": rng.standard_normal(nk).astype(np.float32)}
    mi = rng.permutation(S)[:nk]
    ref = _per_tick_ref(c1, m1, mi, ts, np.zeros(nk, bool), vals)
    out, errors = c2.dispatch_block("right", [m2[j] for j in mi], "ticks",
                                    ts, values=vals)
    _assert_block_matches(out, errors, ref)
    _same_state(c1, c2)
    g = c2._groups[1]
    names = g.cfg.state_names()
    before = g.host_state()
    prog = sst._block_push_fn(g.cfg, S, 8)
    outs = prog(*(g.parts[0][n] for n in names),
                *sst.block_ticks(8, S, 2, "cpu"))
    for name, t in zip(names, outs):
        assert t.numpy().tobytes() == before[name].tobytes(), name
    qprog = sst._block_query_fn(g.cfg, S, 8)
    q = qprog(*(g.parts[0][n] for n in sst._QUERY_STATE),
              *sst.block_ticks(8, S, 2, "cpu")[:2])
    assert q[0].numpy().tobytes() == before["n_merged"].tobytes()


def test_block_duplicates_route_per_tick_order_preserved():
    """Multi-tick members keep strict arrival order (the per-tick route,
    counted in ``fallback_ticks``); single-tick members still take the
    block programs; the results are the serialized reference's."""
    c1, m1 = _mk(n=6)
    c2, m2 = _mk(n=6)
    rng = np.random.default_rng(1)
    mi, ts, is_left, vals = _gen_block(rng, 40, 6)
    assert len(set(mi.tolist())) < len(mi)
    ref = _per_tick_ref(c1, m1, mi, ts, is_left, vals)
    out, errors = c2.dispatch_block(is_left, [m2[j] for j in mi], "ticks",
                                    ts, values=vals)
    _assert_block_matches(out, errors, ref)
    dup = np.bincount(mi, minlength=6)[mi] > 1
    assert c2.routes["fallback_ticks"] == int(dup.sum())
    assert c2.routes["block"] == len(set(is_left[~dup].tolist()))
    assert c1.acked_total == c2.acked_total
    for a, b in zip(m1, m2):
        assert a.acked == b.acked


def test_block_side_strings_and_scalar_series():
    c1, m1 = _mk(n=4, slots=4)
    c2, m2 = _mk(n=4, slots=4)
    ts = np.arange(4, dtype=np.int64) * 100 + 100
    vals = {"px": np.float32([1, 2, 3, 4]), "qty": np.float32([5, 6, 7, 8])}
    ref = _per_tick_ref(c1, m1, np.arange(4), ts, np.zeros(4, bool), vals)
    out, errors = c2.dispatch_block("right", m2, "ticks", ts, values=vals)
    _assert_block_matches(out, errors, ref)
    out, errors = c2.dispatch_block(np.array(["left"] * 4), m2, "ticks",
                                    ts + 1000)
    assert not errors and bool(out["px_found"].all())
    assert out["right_row_idx"].dtype == np.int32


def test_block_late_ticks_error_per_index():
    c1, m1 = _mk()
    c2, m2 = _mk()
    ts = np.full(S, 1_000, np.int64)
    vals = {"px": np.ones(S, np.float32), "qty": np.ones(S, np.float32)}
    for c, m in ((c1, m1), (c2, m2)):
        c.dispatch("right", [(m[3], "ticks", 5_000, None,
                              {"px": 0.0, "qty": 0.0})])
    ref = _per_tick_ref(c1, m1, np.arange(S), ts, np.zeros(S, bool), vals)
    assert isinstance(ref[3], LateTickError)
    out, errors = c2.dispatch_block("right", m2, "ticks", ts, values=vals)
    assert set(errors) == {3} and isinstance(errors[3], LateTickError)
    assert np.isnan(out["px_ema"][3]) and not np.isnan(out["px_ema"][0])
    _assert_block_matches(out, errors, ref)
    _same_state(c1, c2)
    out, errors = c2.dispatch_block("left", m2, "ticks", ts + 1)
    assert set(errors) == {3}
    assert not out["px_found"][3] and out["px_found"][0]


def test_block_unknown_series_and_foreign_member():
    c, m = _mk(n=2, slots=2)
    out, errors = c.dispatch_block("left", [m[0], m[1]], ["ticks", "nope"],
                                   np.array([10, 10], np.int64))
    assert set(errors) == {1} and "unknown series" in str(errors[1])
    other, om = _mk(n=1, slots=2)
    with pytest.raises(ValueError, match="different cohort"):
        c.dispatch_block("left", [om[0]], "ticks", np.array([20], np.int64))


def test_block_validation_errors():
    c, m = _mk(n=2, slots=2)
    with pytest.raises(ValueError, match="parallel arrays"):
        c.dispatch_block("left", m, "ticks", np.array([1], np.int64))
    with pytest.raises(ValueError, match="'right' or 'left'"):
        c.dispatch_block("up", m, "ticks", np.array([1, 2], np.int64))
    with pytest.raises(ValueError, match="no values"):
        c.dispatch_block("right", m, "ticks", np.array([1, 2], np.int64))
    with pytest.raises(ValueError, match="missing value column"):
        c.dispatch_block("right", m, "ticks", np.array([1, 2], np.int64),
                         values={"px": np.ones(2, np.float32)})
    assert c.dispatch_block("left", [], "ticks",
                            np.array([], np.int64)) == ({}, {})


# ----------------------------------------------------------------------
# The routes around the block programs: spill tier and mesh
# ----------------------------------------------------------------------

def test_block_spill_dir_takes_the_per_tick_route(tmp_path):
    c1, m1 = _mk(n=6)
    c2, m2 = _mk(n=6, spill_dir=str(tmp_path / "spill"))
    rng = np.random.default_rng(2)
    mi, ts, is_left, vals = _gen_block(rng, 24, 6)
    ref = _per_tick_ref(c1, m1, mi, ts, is_left, vals)
    out, errors = c2.dispatch_block(is_left, [m2[j] for j in mi], "ticks",
                                    ts, values=vals)
    _assert_block_matches(out, errors, ref)
    assert not any(k[0].startswith("block_")
                   for g in c2._groups.values() for k in g._exes)
    assert c2.routes["block"] == 0 and c2.routes["fallback_ticks"] == 24


def test_block_meshed_takes_the_per_tick_route(monkeypatch):
    monkeypatch.setattr(mesh_mod, "transfer", lambda *a, **k: (_ for _ in (
        )).throw(AssertionError("transfer called")))
    mesh = dist.stream_mesh(devices=["cpu"] * 2)
    c1, m1 = _mk(n=4, slots=4)
    c2, m2 = _mk(n=4, slots=4, mesh=mesh)
    rng = np.random.default_rng(3)
    mi, ts, is_left, vals = _gen_block(rng, 16, 4)
    ref = _per_tick_ref(c1, m1, mi, ts, is_left, vals)
    out, errors = c2.dispatch_block(is_left, [m2[j] for j in mi], "ticks",
                                    ts, values=vals)
    _assert_block_matches(out, errors, ref)
    assert c2.routes["block"] == 0 and c2.routes["per_tick"] > 0
    with pytest.raises(NotImplementedError, match="per-tick"):
        sst.cohort_block_push_executable(c2._groups[1].cfg, 4, 8, "cpu",
                                         mesh=mesh)


# ----------------------------------------------------------------------
# Warm-up ladder, zero builds, and the reference's blocks
# ----------------------------------------------------------------------

def test_block_zero_builds_after_warmup():
    c, m = _mk()
    assert c.warmup(8, max_block=64) == 1 + 4   # Lb 8; Nb 8, 16, 32, 64
    rng = np.random.default_rng(4)
    b0 = profiling.plan_cache_stats()["builds"]
    for rnd in range(3):
        perm = rng.permutation(S)
        ts = 100_000 * (rnd + 1) + np.sort(rng.integers(0, 9_000, S)).astype(
            np.int64)
        is_left = rng.random(S) < 0.5
        vals = {"px": rng.standard_normal(S).astype(np.float32),
                "qty": rng.standard_normal(S).astype(np.float32)}
        out, errors = c.dispatch_block(is_left, [m[j] for j in perm],
                                       "ticks", ts, values=vals)
        assert not errors
    assert profiling.plan_cache_stats()["builds"] == b0


@pytest.fixture(scope="module")
def ref_blocks():
    """Three mixed blocks (duplicates included) through the reference's
    ``dispatch_block``: the blocks and its results."""
    rng = np.random.default_rng(40)
    c, m = _mk(pkg=ref_serve.StreamCohort)
    blocks, outs = [], []
    for rnd in range(3):
        mi, ts, is_left, vals = _gen_block(rng, 12, S, t0=10**6 * rnd)
        blocks.append((mi, ts, is_left, vals))
        outs.append(c.dispatch_block(is_left, [m[j] for j in mi], "ticks",
                                     ts, values=vals))
    return blocks, outs


def test_block_results_against_the_reference(ref_blocks):
    blocks, theirs = ref_blocks
    c, m = _mk()
    max_ema = 0.0
    for (out_b, _) in theirs:
        for key in ("px_ema", "qty_ema"):
            max_ema = max(max_ema, float(np.nanmax(np.abs(out_b[key]))))
    for (mi, ts, is_left, vals), (out_b, err_b) in zip(blocks, theirs):
        out_a, err_a = c.dispatch_block(is_left, [m[j] for j in mi],
                                        "ticks", ts, values=vals)
        assert set(err_a) == set(err_b)
        assert set(out_a) == set(out_b)
        for key in out_b:
            a, b = np.asarray(out_a[key]), np.asarray(out_b[key])
            assert a.dtype == b.dtype, key
            if key.endswith(("_ema", "_stddev", "_zscore")):
                continue
            if key.endswith(("_min", "_max")):
                assert np.array_equal(a, b, equal_nan=True), key
                continue
            assert a.tobytes() == b.tobytes(), key
        for key in ("px_ema", "qty_ema"):
            d = np.abs(out_a[key] - out_b[key])
            assert np.nanmax(d, initial=0.0) <= \
                np.spacing(np.float32(max_ema)) / KW["ema_alpha"], key
            assert np.array_equal(np.isnan(out_a[key]), np.isnan(out_b[key]))


# ----------------------------------------------------------------------
# The executor: submit_block, barriers, quarantine, supervision
# ----------------------------------------------------------------------

def test_executor_submit_block_end_to_end():
    c, m = _mk()
    c.warmup(8, max_block=32)
    with CohortExecutor(c, coalesce_s=0.001) as ex:
        t1 = ex.submit(m[0], "right", "ticks", 100,
                       values={"px": 1.0, "qty": 2.0})
        ts = np.arange(200, 200 + S, dtype=np.int64)
        is_left = (np.arange(S) % 3) == 0
        vals = {"px": np.ones(S, np.float32), "qty": np.ones(S, np.float32)}
        bt = ex.submit_block(is_left, m, "ticks", ts, values=vals)
        t2 = ex.submit(m[0], "left", "ticks", 300)
        assert isinstance(bt, BlockTicket)
        out = bt.result(timeout=WAIT)
        assert not bt.errors and out["px_ema"].shape == (S,)
        r1, r2 = t1.result(WAIT), t2.result(WAIT)
        assert not np.isnan(r1["px_ema"])
        assert bool(r2["px_found"]) and float(r2["px"]) == 1.0
        assert ex.ticks == 2 + S
        assert ex.latency_stats()["all"]["count"] == 2 + S
    assert c.routes["block"] >= 1


def test_executor_block_per_index_errors_and_quarantine():
    c, m = _mk(n=4, slots=4)
    breaker = CircuitBreaker(threshold=2, cooldown_s=0.05)
    with CohortExecutor(c, coalesce_s=0.0, breaker=breaker) as ex:
        for _ in range(2):
            t = ex.submit(m[3], "right", "nope", 1,
                          values={"px": 0.0, "qty": 0.0})
            with pytest.raises(ValueError, match="unknown series"):
                t.result(WAIT)
        assert breaker.trips == 1
        ts = np.array([10, 11, 12, 13], np.int64)
        vals = {"px": np.ones(4, np.float32), "qty": np.ones(4, np.float32)}
        bt = ex.submit_block("right", m, "ticks", ts, values=vals)
        out = bt.result(WAIT)
        assert set(bt.errors) == {3}
        assert isinstance(bt.errors[3], QuarantinedError)
        assert not np.isnan(out["px_ema"][0]) and np.isnan(out["px_ema"][3])
        time.sleep(0.06)
        bt = ex.submit_block("right", m, "ticks", ts + 100, values=vals)
        assert bt.result(WAIT) is not None and not bt.errors, bt.errors
        bt = ex.submit_block("right", m, "ticks", ts + 200, values=vals)
        assert bt.result(WAIT) is not None and not bt.errors


def test_executor_block_level_failure_and_plane_death(monkeypatch):
    c, m = _mk(n=2, slots=2)
    with CohortExecutor(c, coalesce_s=0.0) as ex:
        monkeypatch.setattr(
            c, "dispatch_block",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        bt = ex.submit_block("left", m, "ticks", np.array([1, 2], np.int64))
        with pytest.raises(RuntimeError, match="boom"):
            bt.result(WAIT)
    c2, m2 = _mk(n=2, slots=2)
    ex = CohortExecutor(c2, coalesce_s=0.0)
    monkeypatch.setattr(
        c2, "dispatch_block",
        lambda *a, **k: (_ for _ in ()).throw(faults.SimulatedKill("die")))
    bt = ex.submit_block("left", m2, "ticks", np.array([1, 2], np.int64))
    with pytest.raises(ShutdownError):
        bt.result(WAIT)
    assert ex.fatal is not None
    ex.close(timeout=WAIT)


def test_executor_coalesce_knob_default(monkeypatch):
    c, _ = _mk(n=1, slots=2)
    monkeypatch.setenv("TEMPO_TPU_SERVE_COALESCE_S", "0.0075")
    with CohortExecutor(c) as ex:
        assert ex.coalesce_s == pytest.approx(0.0075)
    monkeypatch.delenv("TEMPO_TPU_SERVE_COALESCE_S")
    with CohortExecutor(c) as ex:
        assert ex.coalesce_s == pytest.approx(0.002)
    with CohortExecutor(c, coalesce_s=0.0) as ex:
        assert ex.coalesce_s == 0.0


def test_cohort_defaults_to_the_card():
    """A cohort's entry point runs on the card unless the caller asks for
    the CPU: without a card, the default raises instead of falling back."""
    if torch.cuda.is_available():
        assert StreamCohort(("px",), slots=2, **KW).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamCohort(("px",), slots=2, **KW)
