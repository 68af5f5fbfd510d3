"""Serving cohorts in the port (``tempo_tpu_torch.serve.StreamCohort``) on
the CPU.

* The rank-generic step: ``state._push_fn`` / ``_query_fn`` over state
  and batches with a leading ``[S]`` axis give each stream's slice the
  bits of the single-stream step over that stream alone, the window
  passes and the EMA carry included.
* A cohort of S member streams (mixed series counts, so several shape
  buckets) fed any interleaving of member sub-batches through shared
  dispatches emits, tick for tick, the bits S independent port
  ``StreamingTSDF``s emit (which ``test_torch_serve.py`` holds against
  the batch operators): sequence ties, NaN runs, ``skip_nulls`` both
  ways, ``maxLookback`` expiry.
* Against ``tempo_tpu.serve.StreamCohort`` fed the same dispatches: the
  selections bitwise (join values, ``found``, ``right_row_idx``, window
  ``count``, ``min``, ``max``, ``sum``, ``mean``, ``clipped``); the EMA,
  ``stddev`` and ``zscore`` within the bounds ``test_torch_serve.py``
  states for XLA:CPU's fused multiply-adds.
* Per-stream isolation, unknown series, the ``row_bucket`` ladder,
  migration between buckets, growth inside a bucket and capacity
  doubling; a ``["cpu"] * 2`` stream mesh bitwise the meshless cohort,
  capacity rounded to the axis and ``parallel.mesh.transfer`` never
  called; the executor (identity, per-ticket latency, a late tick
  failing only its ticket, bounded windows, quarantine); snapshots
  (full and differential chains, corrupt links, across the two
  packages) and kills mid-push and mid-dispatch resumed byte-identical;
  zero builds in the steady state.

The reference's ``test_cohort_contract_registered`` has no counterpart:
it checks ``plan/contracts.py``'s registry, which is not ported (ROADMAP
A11b).  Waits on the executor's thread are bounded.
"""

import os

import numpy as np
import pytest
import torch

from tempo_tpu import serve as ref_serve
from tempo_tpu_torch import checkpoint, dist, profiling
from tempo_tpu_torch.parallel import mesh as mesh_mod
from tempo_tpu_torch.resilience import CircuitBreaker, QuarantinedError
from tempo_tpu_torch.serve import (CohortExecutor, LateTickError,
                                   StreamCohort, StreamingTSDF, row_bucket)
from tempo_tpu_torch.serve import executor as serve_executor
from tempo_tpu_torch.serve import state as sst
from tempo_tpu_torch.testing import faults
from tests.test_torch_serve import COLS, C, _gen_events

ML = 7
WINDOW = dict(window_secs=9.0, window_rows_bound=8, ema_alpha=0.2)
WAIT = 60


def _mk_pair(S, *, skip_nulls=True, ml=ML, slots=None, mesh=None,
             k_of=lambda s: 1 + s % 3, **kw):
    """A cohort of S streams and S independent ``StreamingTSDF`` twins of
    the same configs (series counts vary, so several buckets coexist)."""
    cohort = StreamCohort(COLS, skip_nulls=skip_nulls, max_lookback=ml,
                          slots=slots or max(2, S), mesh=mesh, device="cpu",
                          **WINDOW, **kw)
    members, twins = [], []
    for s in range(S):
        series = [f"m{s}s{k}" for k in range(k_of(s))]
        members.append(cohort.add_stream(f"m{s}", series))
        twins.append(StreamingTSDF(series, COLS, skip_nulls=skip_nulls,
                                   max_lookback=ml, device="cpu", **WINDOW))
    return cohort, members, twins


def _member_events(rng, K, n, seq):
    return _gen_events(rng, K, n, tie_heavy=True, seq=seq)


def _run_of(events, pos):
    """Next side-homogeneous run (at most 5 events) of a member's list."""
    if pos >= len(events):
        return None, pos
    side = events[pos][1]
    run = []
    while pos < len(events) and events[pos][1] == side and len(run) < 5:
        run.append(events[pos])
        pos += 1
    return (side, run), pos


def _same(got, want, label):
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
            (label, key, got[key], want[key])


def _rounds(members, evsets, rng):
    """The dispatches of an interleaved feed: per round, each member (in
    a random order) gives its next side-homogeneous run; a dispatch a
    side a round.  ``[(side, [(member index, run)])]``."""
    pos = [0] * len(members)
    out = []
    while any(pos[s] < len(evsets[s]) for s in range(len(members))):
        rounds = {"right": [], "left": []}
        for s in rng.permutation(len(members)):
            nxt, pos[s] = _run_of(evsets[s], pos[s])
            if nxt is not None:
                rounds[nxt[0]].append((int(s), nxt[1]))
        for side in ("right", "left"):
            if rounds[side]:
                out.append((side, rounds[side]))
    return out


def _items(members, side, runs):
    items, spans = [], []
    for s, run in runs:
        m = members[s]
        start = len(items)
        for (k, _, ts, sq, vals) in run:
            items.append((m, m.series[k], ts, sq,
                          {c: vals[ci] for ci, c in enumerate(COLS)}
                          if side == "right" else None))
        spans.append((s, run, start, len(items)))
    return items, spans


def _dispatch_all(cohort, members, plan):
    """Every dispatch of ``plan`` through ``cohort``: per dispatch, its
    spans and results."""
    out = []
    for side, runs in plan:
        items, spans = _items(members, side, runs)
        res = cohort.dispatch(side, items)
        assert not any(isinstance(r, Exception) for r in res), res
        out.append((side, spans, res))
    return out


def _twin_push(twin, side, run):
    ks = [twin.series[e[0]] for e in run]
    ts = [e[2] for e in run]
    sq = [e[3] for e in run]
    sq = None if all(x is None for x in sq) else \
        [np.nan if x is None else x for x in sq]
    if side == "right":
        vals = {c: np.array([e[4][ci] for e in run], np.float32)
                for ci, c in enumerate(COLS)}
        return twin.push(ks, ts, vals, seq=sq)
    return twin.push_left(ks, ts, seq=sq)


def _feed_interleaved(cohort, members, twins, evsets, rng):
    """Feed every member's events through shared dispatches and hold
    each tick against the member's twin fed the same run as one push.
    Returns the number of dispatches that mixed members."""
    plan = _rounds(members, evsets, rng)
    for side, spans, res in _dispatch_all(cohort, members, plan):
        for s, run, lo, hi in spans:
            want = _twin_push(twins[s], side, run)
            for j, i in enumerate(range(lo, hi)):
                _same(res[i], {k: v[j] for k, v in want.items()},
                      (s, side, j))
    return sum(len(runs) > 1 for _, runs in plan)


def _run_matrix(S, *, seq, skip_nulls, ml, seed, n=40):
    rng = np.random.default_rng(seed)
    cohort, members, twins = _mk_pair(S, skip_nulls=skip_nulls, ml=ml)
    evsets = [_member_events(rng, len(m.series), n, seq) for m in members]
    n_mixed = _feed_interleaved(cohort, members, twins, evsets, rng)
    if S > 1:
        assert n_mixed > 0, "no dispatch mixed members"
    for s in range(S):
        assert members[s].clipped == twins[s].clipped, s
        assert members[s].acked == twins[s].acked, s
    assert cohort.acked_total == sum(t.acked for t in twins)
    assert cohort.clipped == sum(t.clipped for t in twins)
    return cohort


# ----------------------------------------------------------------------
# The rank-generic step
# ----------------------------------------------------------------------

def _random_batch(rng, cfg, Lb):
    """A left-aligned ``[K, Lb]`` right batch: keys, values (NaN runs),
    mask, counts."""
    K, C_ = cfg.n_series, cfg.n_cols
    counts = rng.integers(0, Lb + 1, K)
    mask = np.arange(Lb)[None] < counts[:, None]
    ts = np.where(mask, np.sort(rng.integers(0, 40, (K, Lb)), -1) * 10**9,
                  np.int64(sst.TS_PAD)).astype(np.int64)
    xs = rng.standard_normal((C_, K, Lb)).astype(np.float32)
    xs[rng.random((C_, K, Lb)) < 0.25] = np.nan
    xs[:, ~mask] = np.nan
    return [torch.from_numpy(a) for a in (ts, xs, mask, counts.astype(np.int64))]


@pytest.mark.parametrize("skip_nulls,ml", [(True, 0), (False, 5)])
def test_rank_generic_step_is_single_steps(skip_nulls, ml):
    """The step over ``[S, ...]`` gives each stream's slice the bits of
    the single-stream step: push (AS-OF carry, EMA, window passes,
    clipped, ring) and query, from states reached by earlier pushes."""
    rng = np.random.default_rng(17 + ml)
    S, Lb = 4, 8
    cfg = sst.StreamConfig(n_series=3, n_cols=C, skip_nulls=skip_nulls,
                           max_lookback=ml, window_ns=5 * 10**9,
                           rows_bound=4, ema_alpha=0.2)
    names = cfg.state_names()
    push, query = sst._push_fn(cfg, Lb), sst._query_fn(cfg, Lb)
    states = []
    for s in range(S):
        st = sst.to_device(sst.init_state(cfg), "cpu")
        for _ in range(s + 1):
            out = push(*(st[n] for n in names), *_random_batch(rng, cfg, Lb))
            st = dict(zip(names, out[:len(names)]))
        states.append(st)
    batches = [_random_batch(rng, cfg, Lb) for _ in range(S)]
    single = [push(*(states[s][n] for n in names), *batches[s])
              for s in range(S)]
    stacked = push(*(torch.stack([states[s][n] for s in range(S)])
                     for n in names),
                   *(torch.stack([b[i] for b in batches]) for i in range(4)))
    assert stacked[-1].shape == (len(cfg.emit_keys()), S, C, 3, Lb)
    for i, plane in enumerate(stacked):
        for s in range(S):
            got = plane[:, s] if i == len(names) else plane[s]
            assert got.numpy().tobytes() == single[s][i].numpy().tobytes(), \
                (i, s)
    counts = [torch.from_numpy(rng.integers(0, Lb + 1, 3)) for _ in range(S)]
    qs = [query(*(states[s][n] for n in sst._QUERY_STATE), counts[s])
          for s in range(S)]
    qstack = query(*(torch.stack([states[s][n] for s in range(S)])
                     for n in sst._QUERY_STATE), torch.stack(counts))
    for i, plane in enumerate(qstack):
        for s in range(S):
            assert plane[s].numpy().tobytes() == qs[s][i].numpy().tobytes()


def test_window_passes_keep_the_batch_forms_bits():
    """``window_stats_batch`` (the same passes, no leading axis) over a
    stacked history slice is each stream's own batch form."""
    rng = np.random.default_rng(5)
    ts = np.cumsum(rng.integers(0, 3, (2, 3, 30)), -1).astype(np.int64) * 10**9
    xs = rng.standard_normal((2, C, 3, 30)).astype(np.float32)
    xs[rng.random(xs.shape) < 0.2] = np.nan
    R = 5
    ext = lambda a, fill: torch.cat([torch.full(a.shape[:-1] + (R,), fill,
                                                dtype=a.dtype), a], -1)
    t, x = torch.from_numpy(ts), torch.from_numpy(xs)
    stats, clip = sst._window_passes(ext(t, int(sst.TS_PAD)), ext(x, 0.0),
                                     ext(~torch.isnan(x), False), 4 * 10**9,
                                     4, 30)
    for s in range(2):
        one, one_clip = sst.window_stats_batch(ts[s], xs[s], ~np.isnan(xs[s]),
                                               4 * 10**9, 4, device="cpu")
        assert np.array_equal(clip[s].sum(-1).numpy(), one_clip.numpy())
        for key in one:
            assert stats[key][s].numpy().tobytes() == one[key].numpy().tobytes()


# ----------------------------------------------------------------------
# The cohort against independent streams
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("seq,skip_nulls,ml", [
    (False, True, 0), (True, True, ML), (True, False, ML)])
def test_identity_matrix(S, seq, skip_nulls, ml):
    """S streams of mixed series counts, sequence ties, NaN runs,
    maxLookback expiry, member runs interleaved in shared dispatches:
    every member's bits are its independent twin's."""
    _run_matrix(S, seq=seq, skip_nulls=skip_nulls, ml=ml,
                seed=2000 + 17 * S + 2 * seq + skip_nulls + ml)


def test_identity_many_streams():
    """S = 8 at one tick a run: one dispatch spans every stream."""
    _run_matrix(8, seq=False, skip_nulls=True, ml=5, seed=64, n=8)


# ----------------------------------------------------------------------
# Against the reference's cohort
# ----------------------------------------------------------------------

REF_S = 5


@pytest.fixture(scope="module")
def ref_feed():
    """One interleaved feed through ``tempo_tpu.serve.StreamCohort`` (its
    dispatches' results) and the plan that made it."""
    rng = np.random.default_rng(71)
    evsets = [_member_events(rng, 1 + s % 3, 50, s % 2 == 1)
              for s in range(REF_S)]
    cohort = ref_serve.StreamCohort(COLS, skip_nulls=True, max_lookback=ML,
                                    slots=REF_S, **WINDOW)
    members = [cohort.add_stream(f"m{s}", [f"m{s}s{k}"
                                           for k in range(1 + s % 3)])
               for s in range(REF_S)]
    plan = _rounds(members, evsets, np.random.default_rng(72))
    return evsets, plan, _dispatch_all(cohort, members, plan), cohort


def test_against_the_reference_cohort(ref_feed):
    evsets, plan, theirs, ref_cohort = ref_feed
    cohort, members, _ = _mk_pair(REF_S, slots=REF_S)
    mine = _dispatch_all(cohort, members, plan)
    max_x2 = [0.0] * REF_S
    for s, evs in enumerate(evsets):
        for _, side, _, _, vals in evs:
            if side == "right":
                max_x2[s] = max(max_x2[s], float(np.nanmax(
                    vals.astype(np.float64) ** 2, initial=0.0)))
    max_ema = np.zeros((REF_S, C))
    for side, spans, res in theirs:
        if side == "right":
            for s, _, lo, hi in spans:
                for i in range(lo, hi):
                    for ci, c in enumerate(COLS):
                        max_ema[s, ci] = max(max_ema[s, ci],
                                             abs(res[i][f"{c}_ema"]))
    eps = float(np.finfo(np.float32).eps)
    alpha = WINDOW["ema_alpha"]
    n_checked = 0
    for (side, spans, a_res), (_, _, b_res) in zip(mine, theirs):
        for s, _, lo, hi in spans:
            for i in range(lo, hi):
                a, b = a_res[i], b_res[i]
                assert set(a) == set(b)
                n_checked += 1
                for key in a:
                    stat = key.split("_", 1)[1] if "_" in key else "value"
                    if stat in ("stddev", "zscore", "ema", "min", "max"):
                        continue
                    assert np.asarray(a[key]).tobytes() == \
                        np.asarray(b[key]).tobytes(), (s, key)
                if side == "left":
                    continue
                for ci, c in enumerate(COLS):
                    assert abs(a[f"{c}_ema"] - b[f"{c}_ema"]) <= np.spacing(
                        np.float32(max_ema[s, ci])) / alpha, (s, c)
                    for key in ("min", "max"):
                        x, y = a[f"{c}_{key}"], b[f"{c}_{key}"]
                        assert x == y or (np.isnan(x) and np.isnan(y)), key
                    n = float(a[f"{c}_count"])
                    sa, sb = a[f"{c}_stddev"], b[f"{c}_stddev"]
                    if n < 2:
                        assert np.isnan(sa) and np.isnan(sb)
                        continue
                    dvar = 8 * eps * n * max_x2[s] / (n - 1)
                    assert abs(float(sa) ** 2 - float(sb) ** 2) <= dvar
                    za, zb = a[f"{c}_zscore"], b[f"{c}_zscore"]
                    if np.isnan(zb):
                        assert np.isnan(za)
                        continue
                    rel = dvar / max(float(sb) ** 2, 1e-30) / 2
                    assert abs(za - zb) <= abs(zb) * rel + 4 * np.spacing(
                        np.float32(abs(zb)))
    assert n_checked > 100
    assert cohort.clipped == ref_cohort.clipped
    assert cohort.acked == ref_cohort.acked


def test_cohort_state_layout_is_the_references():
    from tempo_tpu.serve import state as ref_state

    cfg = sst.StreamConfig(2, C, window_ns=10**9, rows_bound=4,
                           ema_alpha=0.3)
    rcfg = ref_state.StreamConfig(2, C, window_ns=10**9, rows_bound=4,
                                  ema_alpha=0.3)
    mine = sst.cohort_state_init(cfg, 3)
    theirs = ref_state.cohort_state_init(rcfg, 3)
    assert list(mine) == list(theirs)
    for name in mine:
        assert mine[name].dtype == theirs[name].dtype
        assert mine[name].tobytes() == theirs[name].tobytes()
    assert sst.block_lanes() == ref_state.block_lanes() == 8


# ----------------------------------------------------------------------
# Isolation inside one dispatch
# ----------------------------------------------------------------------

def _v(x):
    return {"px": np.float32(x), "qty": np.float32(x + 1)}


def test_late_tick_isolation_in_one_dispatch():
    """Stream i's late tick rejects only stream i's sub-batch: stream j's
    rows in the same dispatch emit what they would have alone, and stream
    i's state and watermarks stay (its corrected batch replays)."""
    cohort, (mi, mj), (ti, tj) = _mk_pair(2, k_of=lambda s: 2)
    for m, t in ((mi, ti), (mj, tj)):
        got = m.push([m.series[0]], [5 * 10**9],
                     {"px": np.float32([1.0]), "qty": np.float32([2.0])})
        want = t.push([t.series[0]], [5 * 10**9],
                      {"px": np.float32([1.0]), "qty": np.float32([2.0])})
        _same({k: v[0] for k, v in got.items()},
              {k: v[0] for k, v in want.items()}, "warm")
    items = [(mi, mi.series[0], 10**9, None, _v(3.0)),          # late
             (mj, mj.series[0], 9 * 10**9, None, _v(4.0)),
             (mi, mi.series[1], 9 * 10**9, None, _v(5.0))]      # same member
    res = cohort.dispatch("right", items)
    assert isinstance(res[0], LateTickError)
    assert isinstance(res[2], LateTickError)
    want = tj.push([tj.series[0]], [9 * 10**9],
                   {"px": np.float32([4.0]), "qty": np.float32([5.0])})
    _same(res[1], {k: v[0] for k, v in want.items()}, "isolated")
    got = mi.push([mi.series[1]], [9 * 10**9],
                  {"px": np.float32([5.0]), "qty": np.float32([6.0])})
    want = ti.push([ti.series[1]], [9 * 10**9],
                   {"px": np.float32([5.0]), "qty": np.float32([6.0])})
    _same({k: v[0] for k, v in got.items()},
          {k: v[0] for k, v in want.items()}, "replay")
    assert mi.acked == ti.acked


def test_nan_seq_normalizes_nulls_first_any_flavour():
    cohort, (m,), _ = _mk_pair(1, k_of=lambda s: 1)
    v = {"px": np.float32(1), "qty": np.float32(1)}
    for bad_nan in (np.float32(np.nan), np.float64(np.nan), float("nan")):
        res = cohort.dispatch("right", [(m, m.series[0], 10**9, bad_nan, v)])
        assert not isinstance(res[0], Exception), res[0]
        res = cohort.dispatch("right", [(m, m.series[0], 10**9 - 1, None, v)])
        assert isinstance(res[0], LateTickError), (bad_nan, res[0])
        res = cohort.dispatch("right", [
            (m, m.series[0], 2 * 10**9, bad_nan, v),
            (m, m.series[0], 10**9, None, v)])      # late inside the batch
        assert isinstance(res[0], LateTickError)


def test_unknown_series_rejects_only_its_member():
    cohort, (mi, mj), (_, tj) = _mk_pair(2, k_of=lambda s: 1)
    res = cohort.dispatch("right", [
        (mi, "nope", 10**9, None, _v(1.0)),
        (mj, mj.series[0], 10**9, None, {"px": np.float32(2),
                                         "qty": np.float32(3)})])
    assert isinstance(res[0], ValueError) and "nope" in str(res[0])
    want = tj.push([tj.series[0]], [10**9],
                   {"px": np.float32([2]), "qty": np.float32([3])})
    _same(res[1], {k: v[0] for k, v in want.items()}, "unknown-series")
    other, (mo,), _ = _mk_pair(1)
    with pytest.raises(ValueError, match="different cohort"):
        cohort.dispatch("left", [(mo, mo.series[0], 10**9, None, None)])


# ----------------------------------------------------------------------
# Buckets, migration, growth
# ----------------------------------------------------------------------

def test_row_bucket_ladder():
    assert [row_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError):
        row_bucket(0)


def _push1(target, key, ts, i):
    v = {c: np.float32([float(i + ci)]) for ci, c in enumerate(COLS)}
    return {k: x[0] for k, x in target.push([key], [ts], v).items()}


def test_membership_migration_preserves_carries():
    """A stream outgrowing its bucket migrates: its series' carries copy
    bit for bit, the new series behave as a fresh stream, the old slot is
    released (reset to fresh rows)."""
    cohort, (m,), (twin,) = _mk_pair(1, k_of=lambda s: 2)
    rng = np.random.default_rng(3)
    evs = [e for e in _member_events(rng, 2, 30, False) if e[1] == "right"]
    for k, _, ts, _, vals in evs:
        v = {c: np.float32([vals[ci]]) for ci, c in enumerate(COLS)}
        _same({a: b[0] for a, b in m.push([m.series[k]], [ts], v).items()},
              {a: b[0] for a, b in twin.push([twin.series[k]], [ts],
                                             v).items()}, "pre")
    old_group, old_slot = m._group, m.slot
    assert m.bucket == 2
    m.add_series(["extra0", "extra1"])          # 4 series -> bucket 4
    assert m.bucket == 4 and old_group.members[old_slot] is None
    fresh_rows = sst.init_state(old_group.cfg)
    for name, row in old_group.slot_rows(old_slot).items():
        assert row.tobytes() == fresh_rows[name].tobytes(), name
    fresh = StreamingTSDF(["extra0", "extra1"], COLS, max_lookback=ML,
                          device="cpu", **WINDOW)
    t0 = max(e[2] for e in evs) + 10**9
    for i in range(6):
        ts = t0 + i * 10**9
        _same(_push1(m, m.series[0], ts, i), _push1(twin, twin.series[0],
                                                    ts, i), "migrated-old")
        _same(_push1(m, "extra0", ts, i), _push1(fresh, "extra0", ts, i),
              "migrated-new")
    q_got = m.push_left([m.series[1]], [t0 + 10**10])
    q_want = twin.push_left([twin.series[1]], [t0 + 10**10])
    _same({k: x[0] for k, x in q_got.items()},
          {k: x[0] for k, x in q_want.items()}, "migrated-query")


def test_in_bucket_series_growth_needs_no_migration():
    cohort, (m,), _ = _mk_pair(1, k_of=lambda s: 3)   # bucket 4
    g = m._group
    m.add_series(["x"])
    assert m._group is g and m.bucket == 4
    out = m.push(["x"], [10**9], {"px": np.float32([1.0]),
                                  "qty": np.float32([2.0])})
    assert np.float32(out["px_ema"][0]) == np.float32(0.2 * 1.0)
    with pytest.raises(ValueError, match="duplicate"):
        m.add_series(["x"])


def test_capacity_doubling_keeps_bits():
    """Five single-series streams over two slots: the group doubles twice
    (on its device), and every member stays on its twin's bits."""
    cohort, members, twins = _mk_pair(5, slots=2, k_of=lambda s: 1)
    g = members[0]._group
    assert g.capacity == 8 and len(g.parts) == 1
    assert g.parts[0]["last_val"].shape[0] == 8
    rng = np.random.default_rng(10)
    evsets = [_member_events(rng, 1, 20, False) for _ in members]
    _feed_interleaved(cohort, members, twins, evsets, rng)


# ----------------------------------------------------------------------
# The stream axis over a mesh
# ----------------------------------------------------------------------

def test_stream_shardings_are_contiguous_ranges():
    mesh = dist.stream_mesh(devices=["cpu"] * 2)
    assert [(str(d), a, b) for d, a, b in dist.stream_shardings(
        mesh, "streams", 8)] == [("cpu", 0, 4), ("cpu", 4, 8)]
    with pytest.raises(ValueError, match="divide"):
        dist.stream_shardings(mesh, "streams", 5)


def test_stream_mesh_bitwise_and_capacity_rounding(monkeypatch):
    """A cohort over a ``["cpu"] * 2`` stream mesh emits the meshless
    cohort's bits (and its twins'), rounds capacity up to the axis, keeps
    each shard's state apart, survives growth, and never calls
    ``parallel.mesh.transfer``."""
    def no_transfer(*a, **k):
        raise AssertionError("a cohort push moved tensors between entries")

    monkeypatch.setattr(mesh_mod, "transfer", no_transfer)
    mesh = dist.stream_mesh(devices=["cpu"] * 2)
    cohort, members, twins = _mk_pair(3, mesh=mesh, slots=3,
                                      k_of=lambda s: 2)
    plain, p_members, _ = _mk_pair(3, slots=4, k_of=lambda s: 2)
    g = members[0]._group
    assert g.capacity == 4 and len(g.parts) == 2
    assert [p["last_val"].shape[0] for p in g.parts] == [2, 2]
    rng = np.random.default_rng(5)
    evsets = [_member_events(rng, 2, 16, False) for _ in members]
    plan = _rounds(members, evsets, rng)
    a = _dispatch_all(cohort, members, plan)
    b = _dispatch_all(plain, p_members, plan)
    for (_, _, ra), (_, _, rb) in zip(a, b):
        for x, y in zip(ra, rb):
            _same(x, y, "mesh")
    for s, m in enumerate(members):
        for side, run in ((e[1], [e]) for e in evsets[s]):
            _twin_push(twins[s], side, run)
        assert m.clipped == twins[s].clipped
    # growth past the rounded capacity keeps both shards contiguous
    for i in range(3, 6):
        cohort.add_stream(f"m{i}", [f"m{i}s0", f"m{i}s1"])
    assert g.capacity == 8 and [p["last_val"].shape[0] for p in g.parts] \
        == [4, 4]
    for name, t in plain._groups[2].host_state().items():
        assert g.host_state()[name][:4].tobytes() == t.tobytes(), name
    ts = 10**13
    _same(members[1].push([members[1].series[0]], [ts], {
        "px": np.float32([1.5]), "qty": np.float32([2.5])}),
        p_members[1].push([p_members[1].series[0]], [ts], {
            "px": np.float32([1.5]), "qty": np.float32([2.5])}), "grown")


def test_meshless_snapshot_resumes_onto_a_stream_mesh(tmp_path):
    """A meshless cohort's snapshot resumes onto a ``["cpu"] * 2`` stream
    mesh (each shard its slot range) and continues on the same bits; a
    mesh whose axis does not divide a group's capacity is refused."""
    parent = str(tmp_path / "ck")
    cohort, members, _ = _mk_pair(3, slots=4, k_of=lambda s: 2,
                                  checkpoint_dir=parent)
    rng = np.random.default_rng(8)
    evsets = [_member_events(rng, 2, 12, False) for _ in members]
    _dispatch_all(cohort, members, _rounds(members, evsets, rng))
    cohort.snapshot()
    meshed = StreamCohort.resume(parent, device="cpu",
                                 mesh=dist.stream_mesh(devices=["cpu"] * 2))
    assert [p["last_val"].shape[0] for p in meshed._groups[2].parts] == [2, 2]
    for s in range(3):
        a, b = meshed.stream(f"m{s}"), members[s]
        _same(_push1(a, a.series[1], 10**14, s),
              _push1(b, b.series[1], 10**14, s), ("meshed", s))
    with pytest.raises(checkpoint.CheckpointError, match="divid"):
        StreamCohort.resume(parent, device="cpu",
                            mesh=dist.stream_mesh(devices=["cpu"] * 3))


# ----------------------------------------------------------------------
# The cohort executor
# ----------------------------------------------------------------------

def test_cohort_executor_identity_and_per_ticket_latency():
    cohort, members, twins = _mk_pair(4, k_of=lambda s: 1)
    with CohortExecutor(cohort, batch_rows=8) as ex:
        tickets = []
        for t in range(24):
            s = t % 4
            tickets.append((s, t, ex.submit(
                members[s], "right", members[s].series[0],
                (t + 1) * 10**9, {"px": np.float32(t),
                                  "qty": np.float32(t + 1)})))
        for s, t, tk in tickets:
            got = tk.result(timeout=WAIT)
            want = twins[s].push(
                [twins[s].series[0]], [(t + 1) * 10**9],
                {"px": np.float32([t]), "qty": np.float32([t + 1])})
            _same(got, {k: v[0] for k, v in want.items()}, (s, t))
            assert tk.latency_s is not None and tk.latency_s >= 0
        qt = ex.submit(members[0], "left", members[0].series[0], 10**12)
        want = twins[0].push_left([twins[0].series[0]], [10**12])
        _same(qt.result(timeout=WAIT), {k: v[0] for k, v in want.items()},
              "query")
        many = ex.submit_many([("right", members[s], members[s].series[0],
                                10**12 + 1 + s, {"px": 1.0, "qty": 2.0},
                                None)
                               for s in range(4)])
        for s, tk in enumerate(many):
            want = twins[s].push([twins[s].series[0]], [10**12 + 1 + s],
                                 {"px": np.float32([1.0]),
                                  "qty": np.float32([2.0])})
            _same(tk.result(timeout=WAIT), {k: v[0] for k, v in want.items()},
                  ("many", s))
        st = ex.latency_stats()
        assert st["right"]["count"] == 28 and st["left"]["count"] == 1
        assert st["right"]["p50_ms"] is not None


def test_cohort_executor_late_tick_fails_only_its_ticket():
    cohort, members, twins = _mk_pair(2, k_of=lambda s: 1)
    with CohortExecutor(cohort) as ex:
        ex.submit(members[0], "right", members[0].series[0], 5 * 10**9,
                  _v(1.0)).result(timeout=WAIT)
        bad = ex.submit(members[0], "right", members[0].series[0], 10**9,
                        _v(2.0))
        ok1 = ex.submit(members[1], "right", members[1].series[0],
                        9 * 10**9, {"px": np.float32(3),
                                    "qty": np.float32(4)})
        with pytest.raises(LateTickError):
            bad.result(timeout=WAIT)
        want = twins[1].push([twins[1].series[0]], [9 * 10**9],
                             {"px": np.float32([3]), "qty": np.float32([4])})
        _same(ok1.result(timeout=WAIT), {k: v[0] for k, v in want.items()},
              "survivor")


def test_latency_windows_are_bounded():
    cohort, _, _ = _mk_pair(1, k_of=lambda s: 1)
    for ex_cls, arg in ((CohortExecutor, cohort),
                        (serve_executor.MicroBatchExecutor,
                         StreamingTSDF(["a"], COLS, device="cpu"))):
        ex = ex_cls(arg)
        try:
            for d in ex._latencies.values():
                assert d.maxlen == serve_executor.LATENCY_WINDOW
        finally:
            ex.close(timeout=WAIT)


def test_cohort_executor_quarantines_a_failing_member():
    """Repeated failures open a member's breaker: its next tickets fail
    fast with ``QuarantinedError`` while the other member is served; a
    probe after the cooldown closes it again."""
    cohort, members, _ = _mk_pair(2, k_of=lambda s: 1)
    breaker = CircuitBreaker(threshold=2, cooldown_s=0.05)
    with CohortExecutor(cohort, coalesce_s=0.0, breaker=breaker) as ex:
        for _ in range(2):
            t = ex.submit(members[1], "right", "nope", 1, _v(0.0))
            with pytest.raises(ValueError, match="unknown series"):
                t.result(WAIT)
        q = ex.submit(members[1], "right", members[1].series[0], 5, _v(0.0))
        with pytest.raises(QuarantinedError):
            q.result(WAIT)
        ok = ex.submit(members[0], "right", members[0].series[0], 5, _v(0.0))
        assert not np.isnan(ok.result(WAIT)["px_ema"])
        import time as _t
        _t.sleep(0.06)
        probe = ex.submit(members[1], "right", members[1].series[0], 6,
                          _v(1.0))
        assert not np.isnan(probe.result(WAIT)["px_ema"])
        assert breaker.state(members[1].name) == "closed"


# ----------------------------------------------------------------------
# Durability: one artifact for the whole cohort
# ----------------------------------------------------------------------

def test_cohort_snapshot_resume_roundtrip(tmp_path):
    parent = str(tmp_path / "cohort_ckpt")
    cohort, members, twins = _mk_pair(3, k_of=lambda s: 1 + s,
                                      checkpoint_dir=parent, ckpt_every=6)
    rng = np.random.default_rng(11)
    evsets = [_member_events(rng, len(m.series), 20, False) for m in members]
    _feed_interleaved(cohort, members, twins, evsets, rng)
    cohort.snapshot()
    steps = checkpoint.list_steps(parent)
    assert len(steps) > 1, "auto-snapshots never fired"
    r = StreamCohort.resume(parent, device="cpu")
    assert r.acked == cohort.acked and r.n_streams == 3
    for s in range(3):
        m, t = r.stream(f"m{s}"), twins[s]
        _same(_push1(m, m.series[0], 10**14, s),
              _push1(t, t.series[0], 10**14, s), ("resumed", s))
    with pytest.raises(checkpoint.CheckpointError, match="cohort_state"):
        checkpoint.load_state(steps[0][1])
    with pytest.raises(checkpoint.CheckpointError, match="cohort_state"):
        checkpoint.load(steps[0][1])
    with pytest.raises(checkpoint.CheckpointError):
        StreamingTSDF.resume(parent, device="cpu")


def _right_plan(S, n, seed):
    rng = np.random.default_rng(seed)
    return [[e for e in _member_events(rng, 2, n, False) if e[1] == "right"]
            for _ in range(S)]


def _round_robin(evsets, members, skip=None):
    """Push each member's next right event in turn: per member, its
    emissions."""
    S = len(members)
    outs = [[] for _ in range(S)]
    pos = list(skip or [0] * S)
    while any(pos[s] < len(evsets[s]) for s in range(S)):
        for s in range(S):
            if pos[s] >= len(evsets[s]):
                continue
            k, _, ts, _, vals = evsets[s][pos[s]]
            pos[s] += 1
            outs[s].append(members[s].push(
                [members[s].series[k]], [ts],
                {c: np.float32([vals[ci]]) for ci, c in enumerate(COLS)}))
    return outs


def _mk3(pkg=StreamCohort, dir_=None, every=0, **kw):
    extra = {"device": "cpu"} if pkg is StreamCohort else {}
    cohort = pkg(COLS, max_lookback=ML, **WINDOW, checkpoint_dir=dir_,
                 ckpt_every=every, slots=4, **extra, **kw)
    return cohort, [cohort.add_stream(f"m{s}", [f"m{s}s0", f"m{s}s1"])
                    for s in range(3)]


def _same_tails(tails, golden, acked):
    for s in range(len(tails)):
        want_tail = golden[s][acked[f"m{s}"]:]
        assert len(tails[s]) == len(want_tail)
        for got, want in zip(tails[s], want_tail):
            assert set(got) == set(want)
            for key in want:
                assert np.asarray(got[key]).tobytes() == \
                    np.asarray(want[key]).tobytes(), (s, key)


@pytest.mark.parametrize("diff", [False, True])
def test_cohort_kill_mid_push_resume_byte_identical(tmp_path, diff):
    """A kill inside a cohort push; resume restores the newest intact
    snapshot (a differential chain when ``diff``), per-stream ``acked``
    says where each source restarts, and the replayed tails are byte for
    byte a run that never died."""
    evsets = _right_plan(3, 40, 13)
    golden = _round_robin(evsets, _mk3()[1])
    parent = str(tmp_path / "ck")
    cohort, members = _mk3(dir_=parent, every=9, diff_snapshots=diff)
    with faults.FaultInjector() as fi:
        fi.kill_on_call(StreamCohort, "dispatch", call_no=25)
        with pytest.raises(faults.SimulatedKill):
            _round_robin(evsets, members)
    assert any(r.action == "kill" for r in fi.records)
    modes = [StreamCohort._snapshot_mode(p)["mode"]
             for _, p in checkpoint.list_steps(parent)]
    assert ("differential" in modes) == diff
    r = StreamCohort.resume(parent, device="cpu")
    acked = r.acked
    assert 0 < sum(acked.values()) < sum(len(e) for e in evsets)
    tails = _round_robin(evsets, [r.stream(f"m{s}") for s in range(3)],
                         skip=[acked[f"m{s}"] for s in range(3)])
    _same_tails(tails, golden, acked)


def test_differential_chain_bytes_and_broken_link(tmp_path):
    """A differential snapshot writes only the dirty buckets (fewer bytes
    than a full one), and a link whose predecessor's manifest changed is
    refused: resume falls back to the older intact head."""
    parent = str(tmp_path / "ck")
    cohort = StreamCohort(COLS, max_lookback=ML, **WINDOW, device="cpu",
                          checkpoint_dir=parent, slots=4)
    a = cohort.add_stream("a", ["x"])                    # bucket 1
    b = cohort.add_stream("b", ["x", "y", "z"])          # bucket 4
    _push1(a, "x", 10**9, 0)
    _push1(b, "z", 10**9, 0)
    full = cohort.snapshot()
    _push1(a, "x", 2 * 10**9, 1)
    diff = cohort.snapshot(differential=True)
    size = lambda p: os.path.getsize(os.path.join(p, "state.npz"))
    assert StreamCohort._snapshot_mode(diff)["mode"] == "differential"
    assert size(diff) < size(full)
    assert StreamCohort.resume(parent, device="cpu").acked == cohort.acked
    man = os.path.join(full, "manifest.json")
    with open(man) as f:
        text = f.read()
    with open(man, "w") as f:
        f.write(text.replace('"acked_total": 2', '"acked_total": 2 '))
    r = StreamCohort.resume(parent, device="cpu")
    assert r.acked == {"a": 1, "b": 1}      # the full head, the diff refused


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_resume_across_packages(tmp_path, writer, reader):
    """A cohort snapshot either package writes resumes in the other: the
    same acked cursors, the state arrays byte for byte, and the reader
    continues it as a same-package resume of the same snapshot does."""
    wpkg = StreamCohort if writer == "port" else ref_serve.StreamCohort
    rpkg = StreamCohort if reader == "port" else ref_serve.StreamCohort
    evsets = _right_plan(3, 20, 21)
    parent = str(tmp_path / f"ck_{writer}")
    cohort, members = _mk3(wpkg, dir_=parent, every=7)
    _round_robin(evsets, members)
    cohort.snapshot()
    path = checkpoint.list_steps(parent)[0][1]
    arrays, _ = checkpoint.load_state(path, kind="cohort_state")
    extra = {"device": "cpu"} if reader == "port" else {}
    r = rpkg.resume(parent, **extra)
    own = wpkg.resume(parent, **({"device": "cpu"} if writer == "port"
                                 else {}))
    assert r.acked == own.acked == cohort.acked
    for bucket, g in r._groups.items():
        host = (g.host_state() if reader == "port"
                else {n: np.asarray(a) for n, a in g.state.items()})
        for name, a in host.items():
            want = arrays[f"g{bucket}.{name}"]
            assert a.dtype == want.dtype and a.tobytes() == want.tobytes()
        assert g.wm_ts.tobytes() == arrays[f"g{bucket}.wm_ts"].tobytes()
    same = rpkg.resume(parent, **extra)
    more = [[(k, side, ts + 10**13, sq, v) for k, side, ts, sq, v in e]
            for e in evsets]
    for got_s, want_s in zip(
            _round_robin(more, [r.stream(f"m{s}") for s in range(3)]),
            _round_robin(more, [same.stream(f"m{s}") for s in range(3)])):
        for got, want in zip(got_s, want_s):
            for key in want:
                assert np.asarray(got[key]).tobytes() == \
                    np.asarray(want[key]).tobytes(), key


def test_executor_kill_mid_dispatch_resume_replays_byte_identical(tmp_path):
    """A kill inside a dispatch driven by the executor's worker: the
    plane dies, every outstanding ticket resolves with a named shutdown
    error, ``CohortExecutor.resume`` restores the newest snapshot, the
    unacked tails replay through ``submit_many``, and emissions and
    cursors land byte-identical to a plane that never died."""
    from tempo_tpu_torch import resilience

    evsets = _right_plan(3, 30, 31)

    def ticks(s, lo, hi, members):
        return [("right", members[s], members[s].series[e[0]], e[2],
                 {c: np.float32(e[4][ci]) for ci, c in enumerate(COLS)},
                 None) for e in evsets[s][lo:hi]]

    g_cohort, g_members = _mk3()
    golden = [[] for _ in range(3)]
    with CohortExecutor(g_cohort, coalesce_s=0.0) as gex:
        for s in range(3):
            for t in gex.submit_many(ticks(s, 0, len(evsets[s]), g_members)):
                golden[s].append(t.result(timeout=WAIT))
    parent = str(tmp_path / "ck")
    cohort, members = _mk3(dir_=parent, every=9)
    ex = CohortExecutor(cohort, coalesce_s=0.0)
    live = [[] for _ in range(3)]
    pos = [0] * 3
    with faults.FaultInjector() as fi:
        fi.kill_on_call(StreamCohort, "dispatch", call_no=11)
        killed = False
        while not killed and any(pos[s] < len(evsets[s]) for s in range(3)):
            for s in range(3):
                if pos[s] >= len(evsets[s]):
                    continue
                try:
                    (tk,) = ex.submit_many(ticks(s, pos[s], pos[s] + 1,
                                                 members))
                    live[s].append(tk.result(timeout=WAIT))
                    pos[s] += 1
                except resilience.ShutdownError:
                    killed = True
                    break
    assert killed and isinstance(ex.fatal, faults.SimulatedKill)
    ex.close(timeout=5)
    rex = CohortExecutor.resume(parent, coalesce_s=0.0, device="cpu")
    acked = rex.cohort.acked
    assert 0 < sum(acked.values()) < sum(len(e) for e in evsets)
    r_members = [rex.cohort.stream(f"m{s}") for s in range(3)]
    with rex:
        for s in range(3):
            cur = acked[f"m{s}"]
            assert cur <= pos[s]
            del live[s][cur:]
            for tk in rex.submit_many(ticks(s, cur, len(evsets[s]),
                                            r_members)):
                live[s].append(tk.result(timeout=WAIT))
        for s in range(3):
            assert r_members[s].acked == len(evsets[s])
            assert len(live[s]) == len(golden[s])
            for got, want in zip(live[s], golden[s]):
                for key in want:
                    assert np.asarray(got[key]).tobytes() == \
                        np.asarray(want[key]).tobytes(), (s, key)


# ----------------------------------------------------------------------
# The steady state builds nothing
# ----------------------------------------------------------------------

def test_zero_builds_in_the_steady_state():
    """After ``warmup``, pushes and queries from any member of the bucket
    reuse the cohort's cached steps: the planner's builds stay flat, and
    the steps are keyed by slot count and device."""
    cohort, members, _ = _mk_pair(4, k_of=lambda s: 1)
    assert cohort.warmup(8) == 1
    builds0 = profiling.plan_cache_stats()["builds"]
    for t in range(8):
        s = t % 4
        _push1(members[s], members[s].series[0], (t + 1) * 10**9, t)
        members[s].push_left([members[s].series[0]], [(t + 1) * 10**9 + 1])
    assert profiling.plan_cache_stats()["builds"] == builds0
    assert members[0]._group._exes[("push", 8)] is \
        sst.cohort_push_executable(members[0]._group.cfg, 4, 8, "cpu")
    assert cohort.routes["per_tick"] == 16
