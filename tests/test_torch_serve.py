"""Serving one stream in the port (``tempo_tpu_torch.serve``) on the CPU.

* A ``StreamingTSDF`` fed a history in any split of ``push`` /
  ``push_left`` batches emits, for exactly the new rows, the bits the
  port's batch operators give over the concatenated history:
  ``ops/sortmerge.asof_merge_values`` (every flag: sequence ties,
  ``skipNulls`` both ways, ``maxLookback`` expiry across pushes, NaN
  runs), ``serve.state.window_stats_batch`` and ``ops/scan.ema_scan``;
  at single-row, one-big and random splits.
* Against ``tempo_tpu.serve.StreamingTSDF`` on the same events: the
  selections bitwise (join values, ``found``, ``right_row_idx``, the
  window ``count``, ``min``, ``max``, ``sum`` and ``mean``, ``clipped``);
  the rest within stated bounds.  XLA:CPU contracts the reference's
  ``d * y + i`` (EMA) and ``s2 + x * x`` (sum of squares) into fused
  multiply-adds, which the port never does: the EMA within ``1 / a``
  ulps of the series' largest ``|ema|`` (a half-ulp difference a step,
  decaying by ``1 - a``), the variance within 8 ulps of the window's
  largest possible sum of squares (``count * max x^2``, over ``count -
  1``), ``zscore`` within the relative error that bound gives ``std``
  plus 4 ulps.  ``min`` / ``max`` are compared as numbers: the two
  libraries may pick the other sign of a zero.
* The ordering contract (late ticks refused by name), commit after
  success, the executor (identity, backpressure and close, deadlines,
  cancellation, bad payloads), zero builds in the steady state (also
  with the planner's cache off), and snapshots resumed across the two
  packages with a byte-identical tail.

Tests that wait on the executor's thread bound every wait (``result``,
``close`` and ``submit`` timeouts).
"""

import os
import queue as queue_mod
import threading
import time

import numpy as np
import pytest
import torch

from tempo_tpu import serve as ref_serve
from tempo_tpu.serve import state as ref_state
from tempo_tpu.serve import stream as ref_stream
from tempo_tpu_torch import checkpoint, profiling
from tempo_tpu_torch.ops import merge, scan, sortmerge
from tempo_tpu_torch.packing import TS_PAD
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.resilience import Cancelled, DeadlineExceeded
from tempo_tpu_torch.serve import (LateTickError, MicroBatchExecutor,
                                   StreamingTSDF)
from tempo_tpu_torch.serve import state as sst
from tempo_tpu_torch.serve import stream as stream_mod
from tempo_tpu_torch.testing import faults

COLS = ["px", "qty"]
C = len(COLS)
WAIT = 60            # seconds any wait on the executor's thread may take


def _stream(series, **kw):
    return StreamingTSDF(series, COLS, device="cpu", **kw)


# ----------------------------------------------------------------------
# Events and the batch operators over the whole history
# ----------------------------------------------------------------------

def _gen_events(rng, K, n, p_left=0.35, tie_heavy=False, seq=False,
                p_nan=0.3):
    """A valid event list: per series sorted by (ts, seq, side), rights
    before lefts on full ties, then interleaved across series by ts.
    ``[(k, side, ts, seq or None, vals[C])]`` with NaN runs in column
    0."""
    span = 6 if tie_heavy else 40
    per_series = []
    for k in range(K):
        m = int(rng.integers(n // (2 * K), max(n // K, 2) + 1))
        ts = np.sort(rng.integers(-3, span, m)).astype(np.int64) * 10**9
        sq = (np.round(rng.standard_normal(m), 1) if seq
              else np.full(m, np.nan))
        if seq:
            sq = np.where(rng.random(m) < 0.2, np.nan, sq)
        side = (rng.random(m) < p_left).astype(int)           # 1 = left
        order = np.lexsort((side, np.where(np.isnan(sq), -np.inf, sq), ts))
        evs = []
        for i in order:
            vals = rng.standard_normal(C).astype(np.float32)
            if rng.random() < p_nan:
                vals[0] = np.nan
            evs.append((k, "left" if side[i] else "right", ts[i],
                        None if np.isnan(sq[i]) else sq[i], vals))
        per_series.append(evs)
    merged = [e for evs in per_series for e in evs]
    merged.sort(key=lambda e: e[2])          # stable: per-series order kept
    return merged


def _pack(events, K):
    """The concatenated history as packed arrays (pads: TS_PAD keys and
    NaN values, the packing invariant)."""
    lefts = [[] for _ in range(K)]
    rights = [[] for _ in range(K)]
    any_seq = any(e[3] is not None for e in events)
    for k, side, ts, sq, vals in events:
        (lefts if side == "left" else rights)[k].append((ts, sq, vals))
    Ll = max(1, max(len(x) for x in lefts))
    Lr = max(1, max(len(x) for x in rights))
    l_ts = np.full((K, Ll), TS_PAD, np.int64)
    r_ts = np.full((K, Lr), TS_PAD, np.int64)
    l_seq = np.full((K, Ll), -np.inf) if any_seq else None
    r_seq = np.full((K, Lr), -np.inf) if any_seq else None
    r_vals = np.full((C, K, Lr), np.nan, np.float32)
    for k in range(K):
        for j, (t, sq, _) in enumerate(lefts[k]):
            l_ts[k, j] = t
            if any_seq and sq is not None:
                l_seq[k, j] = sq
        for j, (t, sq, v) in enumerate(rights[k]):
            r_ts[k, j] = t
            r_vals[:, k, j] = v
            if any_seq and sq is not None:
                r_seq[k, j] = sq
    return l_ts, l_seq, r_ts, r_seq, r_vals, ~np.isnan(r_vals)


def _batch(events, K, skip_nulls=True, ml=0, window_secs=None,
           rows_bound=24, alpha=None):
    """The port's batch operators over the history: ``(join, stats,
    clipped count, ema)`` as numpy."""
    l_ts, l_seq, r_ts, r_seq, r_vals, r_valids = _pack(events, K)
    t = lambda a: None if a is None else torch.from_numpy(a)
    join = [a.numpy() for a in sortmerge.asof_merge_values(
        t(l_ts), t(r_ts), t(r_valids), t(r_vals), l_seq=t(l_seq),
        r_seq=t(r_seq), skip_nulls=skip_nulls, max_lookback=ml)]
    stats = clip = ema = None
    if window_secs is not None:
        st, clip = sst.window_stats_batch(r_ts, r_vals, r_valids,
                                          sst.window_ns(window_secs),
                                          rows_bound, device="cpu")
        stats = {k: v.numpy() for k, v in st.items()}
        clip = int(clip.sum())
    if alpha is not None:
        ema = scan.ema_scan(t(r_vals), t(r_valids),
                            np.float32(alpha))[0].numpy()
    return join, stats, clip, ema


def _feed(stream, events, rng, max_batch=9):
    """Feed ``events`` in random uneven segments, each cut into
    side-homogeneous runs in order: ``(left emissions, right emissions)``
    as ``[(run, out)]``.  ``max_batch`` 2 pushes one event at a time."""
    emis_l, emis_r = [], []
    i = 0
    while i < len(events):
        j = min(len(events), i + int(rng.integers(1, max_batch)))
        run = []
        for e in events[i:j] + [None]:
            if run and (e is None or e[1] != run[0][1]):
                ks = [f"s{x[0]}" for x in run]
                ts = [x[2] for x in run]
                sq = [x[3] for x in run]
                sq = (None if all(s is None for s in sq)
                      else [np.nan if s is None else s for s in sq])
                if run[0][1] == "right":
                    vals = {c: np.array([x[4][ci] for x in run], np.float32)
                            for ci, c in enumerate(COLS)}
                    emis_r.append((run, stream.push(ks, ts, vals, seq=sq)))
                else:
                    emis_l.append((run, stream.push_left(ks, ts, seq=sq)))
                run = []
            if e is not None:
                run.append(e)
        i = j
    return emis_l, emis_r


def _bits(a) -> bytes:
    return np.asarray(a, np.float32).tobytes()


def _check_join(emis_l, join, K):
    wv, wf, wi = join
    pos = [0] * K
    n = 0
    for run, out in emis_l:
        for i, (k, *_rest) in enumerate(run):
            j = pos[k]
            pos[k] += 1
            for ci, c in enumerate(COLS):
                assert bool(out[f"{c}_found"][i]) == bool(wf[ci, k, j]), \
                    ("found", k, j, c)
                assert _bits(out[c][i]) == _bits(wv[ci, k, j]), \
                    ("value", k, j, c)
            assert int(out["right_row_idx"][i]) == int(wi[k, j]), (k, j)
            n += 1
    return n


def _check_right(emis_r, stats, ema, K):
    pos = [0] * K
    n = 0
    for run, out in emis_r:
        for i, (k, *_rest) in enumerate(run):
            j = pos[k]
            pos[k] += 1
            for ci, c in enumerate(COLS):
                if ema is not None:
                    assert _bits(out[f"{c}_ema"][i]) == _bits(ema[ci, k, j]), \
                        ("ema", k, j, c)
                for key in (sst._STAT_KEYS if stats is not None else ()):
                    assert _bits(out[f"{c}_{key}"][i]) == \
                        _bits(stats[key][ci, k, j]), (key, k, j, c)
            n += 1
    return n


def _run_identity(seed, *, seq, skip_nulls, ml, tie_heavy=True, K=3, n=120,
                  window_secs=9.0, rows_bound=24, alpha=0.2, max_batch=9):
    rng = np.random.default_rng(seed)
    events = _gen_events(rng, K, n, tie_heavy=tie_heavy, seq=seq)
    stream = _stream([f"s{k}" for k in range(K)], skip_nulls=skip_nulls,
                     max_lookback=ml, window_secs=window_secs,
                     window_rows_bound=rows_bound, ema_alpha=alpha)
    emis_l, emis_r = _feed(stream, events, rng, max_batch)
    join, stats, clip, ema = _batch(events, K, skip_nulls, ml, window_secs,
                                    rows_bound, alpha)
    nl = _check_join(emis_l, join, K)
    nr = _check_right(emis_r, stats, ema, K)
    assert stream.clipped == clip
    assert nl > 5 and nr > 5, "degenerate case generated"


# ----------------------------------------------------------------------
# Streamed == batch, bitwise, at every split
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("ml", [0, 7])
def test_identity_matrix(seq, skip_nulls, ml):
    """Uneven splits x sequence ties x NaN runs x maxLookback expiry
    across pushes: streamed emissions are the batch bits."""
    _run_identity(2000 + 100 * seq + 10 * skip_nulls + ml, seq=seq,
                  skip_nulls=skip_nulls, ml=ml)


@pytest.mark.parametrize("seed", [5, 6])
def test_identity_more_series_and_spread_keys(seed):
    _run_identity(seed, seq=(seed % 2 == 0), skip_nulls=True,
                  ml=(17 if seed == 6 else 0), K=5, n=200, tie_heavy=False,
                  rows_bound=6)


@pytest.mark.parametrize("max_batch", [2, 10_000])
def test_identity_single_rows_and_one_big_push(max_batch):
    """Every event its own push, and every run of one side one push."""
    _run_identity(77, seq=True, skip_nulls=False, ml=5, n=90,
                  max_batch=max_batch)


# ----------------------------------------------------------------------
# Against the reference's serving engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_against_the_reference_stream(seed):
    rng = np.random.default_rng(seed)
    K, alpha = 3, 0.2
    events = _gen_events(rng, K, 240, tie_heavy=(seed == 0), seq=(seed == 3))
    kw = dict(skip_nulls=(seed == 0), max_lookback=5, window_secs=9.0,
              window_rows_bound=12, ema_alpha=alpha)
    series = [f"s{k}" for k in range(K)]
    mine = _feed(_stream(series, **kw), events, np.random.default_rng(9))
    ref = ref_serve.StreamingTSDF(series, COLS, **kw)
    theirs = _feed(ref, events, np.random.default_rng(9))
    max_x2 = np.zeros(K)
    for k, side, _, _, vals in events:
        if side == "right":
            max_x2[k] = max(max_x2[k], float(np.nanmax(vals.astype(
                np.float64) ** 2, initial=0.0)))
    max_ema = np.zeros((C, K))
    for run, out in theirs[1]:
        for i, (k, *_r) in enumerate(run):
            for ci, c in enumerate(COLS):
                max_ema[ci, k] = max(max_ema[ci, k], abs(out[f"{c}_ema"][i]))
    eps = float(np.finfo(np.float32).eps)
    for (run, a), (_, b) in zip(mine[0] + mine[1], theirs[0] + theirs[1]):
        assert set(a) == set(b)
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            stat = key.split("_", 1)[1] if "_" in key else "value"
            if stat in ("stddev", "zscore", "ema", "min", "max"):
                continue
            assert x.tobytes() == y.tobytes(), key
        for i, (k, *_r) in enumerate(run):
            for ci, c in enumerate(COLS):
                if f"{c}_ema" not in a:
                    continue
                assert abs(a[f"{c}_ema"][i] - b[f"{c}_ema"][i]) <= \
                    np.spacing(np.float32(max_ema[ci, k])) / alpha, (k, c)
                for key in ("min", "max"):
                    x, y = a[f"{c}_{key}"][i], b[f"{c}_{key}"][i]
                    assert x == y or (np.isnan(x) and np.isnan(y)), key
                n = float(a[f"{c}_count"][i])
                sa, sb = a[f"{c}_stddev"][i], b[f"{c}_stddev"][i]
                if n < 2:
                    assert np.isnan(sa) and np.isnan(sb)
                    continue
                dvar = 8 * eps * n * max_x2[k] / (n - 1)
                assert abs(float(sa) ** 2 - float(sb) ** 2) <= dvar, (k, c)
                za, zb = a[f"{c}_zscore"][i], b[f"{c}_zscore"][i]
                if np.isnan(zb):
                    assert np.isnan(za)
                    continue
                rel = dvar / max(float(sb) ** 2, 1e-30) / 2
                assert abs(za - zb) <= abs(zb) * rel + 4 * np.spacing(
                    np.float32(abs(zb))), (k, c)
    assert _stream(series, **kw).cfg.key() == ref.cfg.key()


def test_carry_and_state_layout_are_the_references():
    from tempo_tpu.ops import pallas_merge

    mine, theirs = merge.asof_carry_init(3, 5), pallas_merge.asof_carry_init(3, 5)
    assert list(mine) == list(theirs)
    for name in mine:
        assert mine[name].dtype == theirs[name].dtype
        np.testing.assert_array_equal(mine[name], theirs[name])
    cfg = sst.StreamConfig(4, 2, window_ns=10**9, rows_bound=6, ema_alpha=0.3)
    rcfg = ref_state.StreamConfig(4, 2, window_ns=10**9, rows_bound=6,
                                  ema_alpha=0.3)
    mine, theirs = sst.init_state(cfg), ref_state.init_state(rcfg)
    assert list(mine) == list(theirs) == list(cfg.state_names())
    for name in mine:
        assert mine[name].dtype == theirs[name].dtype
        assert mine[name].shape == theirs[name].shape
        np.testing.assert_array_equal(mine[name], theirs[name])


def test_window_stats_batch_against_the_reference():
    rng = np.random.default_rng(4)
    K, L = 3, 50
    ts = np.cumsum(rng.integers(0, 3, (K, L)), -1).astype(np.int64) * 10**9
    xs = rng.standard_normal((C, K, L)).astype(np.float32)
    xs[rng.random((C, K, L)) < 0.2] = np.nan
    valids = ~np.isnan(xs)
    mine, mclip = sst.window_stats_batch(ts, xs, valids, 5 * 10**9, 4,
                                         device="cpu")
    theirs, tclip = ref_state.window_stats_batch(ts, xs, valids, 5 * 10**9, 4)
    np.testing.assert_array_equal(mclip.numpy(), np.asarray(tclip))
    assert int(mclip.sum()) > 0
    for key in ("count", "sum", "mean", "min", "max"):
        np.testing.assert_array_equal(mine[key].numpy(),
                                      np.asarray(theirs[key]), err_msg=key)
    np.testing.assert_allclose(mine["stddev"].numpy(),
                               np.asarray(theirs["stddev"]), rtol=2e-6,
                               atol=2e-6)


def test_device_key_and_default_device():
    assert plan_cache.device_key(device="cpu") == ("cpu", None)
    from tempo_tpu_torch import dist

    mesh = dist.stream_mesh(devices=["cpu"] * 2)
    assert plan_cache.device_key(mesh=mesh) == (
        "mesh", (("streams", 2),), (("cpu", None), ("cpu", None)))
    assert plan_cache.device_key(mesh=dist.stream_mesh(
        devices=["cpu"] * 4)) != plan_cache.device_key(mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingTSDF(["a"], COLS)


def test_window_stats_batch_places_host_arrays_on_its_device():
    ts = (np.arange(6, dtype=np.int64) + 1)[None] * 10**9
    xs = np.ones((C, 1, 6), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sst.window_stats_batch(ts, xs, xs == 1, sst.window_ns(3.0), 4)
    want, _ = sst.window_stats_batch(ts, xs, xs == 1, sst.window_ns(3.0), 4,
                                     device="cpu")
    # tensors keep their own device, whatever ``device`` says
    got, _ = sst.window_stats_batch(torch.from_numpy(ts),
                                    torch.from_numpy(xs),
                                    torch.from_numpy(xs == 1),
                                    sst.window_ns(3.0), 4)
    for key, plane in want.items():
        assert plane.device.type == got[key].device.type == "cpu"
        torch.testing.assert_close(got[key], plane, rtol=0, atol=0,
                                   equal_nan=True, msg=key)
    assert want["count"][0, 0].tolist() == [1, 2, 3, 4, 4, 4]


# ----------------------------------------------------------------------
# The ordering contract and commit after success
# ----------------------------------------------------------------------

def test_tie_across_a_push_boundary_right_wins():
    s = _stream(["a"])
    s.push(["a"], [10**9], {"px": [1.0], "qty": [2.0]})
    out = s.push_left(["a"], [10**9])
    assert out["px"][0] == np.float32(1.0) and out["px_found"][0]
    assert out["right_row_idx"][0] == 0


def test_late_right_after_left_tie_refused():
    s = _stream(["a"])
    s.push_left(["a"], [10**9])
    with pytest.raises(LateTickError, match="late right tick.*'a'"):
        s.push(["a"], [10**9], {"px": [1.0], "qty": [1.0]})
    s.push(["a"], [2 * 10**9], {"px": [1.0], "qty": [1.0]})


def test_out_of_order_batch_refused_whole_and_state_untouched():
    s = _stream(["a", "b"], ema_alpha=0.5, window_secs=5.0,
                window_rows_bound=4)
    s.push(["a"], [5 * 10**9], {"px": [1.0], "qty": [1.0]})
    before = {k: v.clone() for k, v in s._state.items()}
    with pytest.raises(LateTickError, match="behind the watermark"):
        s.push(["b", "a", "a"], [10**9, 6 * 10**9, 4 * 10**9],
               {"px": [7.0, 1.0, 2.0], "qty": [7.0, 1.0, 2.0]})
    for k, v in s._state.items():
        assert v.numpy().tobytes() == before[k].numpy().tobytes(), k
    s.push(["a"], [5 * 10**9], {"px": [3.0], "qty": [3.0]})
    assert s.push_left(["a"], [5 * 10**9])["px"][0] == np.float32(3.0)
    s.push(["b"], [10**9], {"px": [9.0], "qty": [9.0]})


def test_seq_order_and_null_seq_first():
    s = _stream(["a"])
    s.push(["a", "a"], [10**9, 10**9], {"px": [1.0, 2.0], "qty": [0.0, 0.0]},
           seq=[np.nan, 1.0])
    with pytest.raises(LateTickError):
        s.push(["a"], [10**9], {"px": [3.0], "qty": [0.0]}, seq=[0.5])
    assert s.push_left(["a"], [10**9], seq=[2.0])["px"][0] == np.float32(2.0)


@pytest.mark.parametrize("seed", range(4))
def test_admission_is_the_references_loop(seed):
    """The vectorised admission gives the reference's per-tick loop's
    lanes, counts and watermarks, and refuses the same first tick."""
    rng = np.random.default_rng(seed)
    K, n = 4, 60
    names = [f"s{k}" for k in range(K)]
    wm_ts = rng.integers(0, 5, K).astype(np.int64)
    wm_seq = np.where(rng.random(K) < 0.5, -np.inf, rng.integers(0, 3, K))
    wm_side = rng.integers(0, 2, K).astype(np.int8)
    for trial in range(30):
        rows = rng.integers(0, K, n)
        ts = np.sort(rng.integers(0, 12, n)).astype(np.int64)
        if trial % 3:
            ts[rng.integers(0, n)] -= int(rng.integers(1, 6))
        seq = np.where(rng.random(n) < 0.3, -np.inf,
                       rng.integers(0, 3, n).astype(np.float64))
        side = int(rng.integers(0, 2))
        args = (names, wm_ts, wm_seq, wm_side, rows, ts, seq, side, K)
        try:
            want = ref_stream.admit_batch(*args)
        except ref_stream.LateTickError as e:
            with pytest.raises(LateTickError) as got:
                stream_mod.admit_batch(*args)
            assert (got.value.series, got.value.ts, got.value.seq) == \
                (e.series, e.ts, e.seq)
            assert str(got.value) == str(e)
            continue
        got = stream_mod.admit_batch(*args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)


def test_unknown_series_and_bad_payload_move_nothing():
    s = _stream(["a"])
    with pytest.raises(ValueError, match="unknown series"):
        s.push(["zz"], [10**9], {"px": [1.0], "qty": [1.0]})
    with pytest.raises(ValueError, match="missing value column"):
        s.push(["a", "a"], [10**9, 2 * 10**9], {"px": [1.0, 2.0]})
    s.push(["a", "a"], [10**9, 2 * 10**9],
           {"px": [1.0, 2.0], "qty": [3.0, 4.0]})
    assert s.acked == 2
    assert s.push_left(["a"], [2 * 10**9])["px"][0] == np.float32(2.0)


def test_failed_step_leaves_the_stream_untouched(monkeypatch):
    s = _stream(["a"], ema_alpha=0.5)
    s.push(["a"], [10**9], {"px": [1.0], "qty": [1.0]})
    before = {k: v.clone() for k, v in s._state.items()}
    wm = s._wm_ts.copy()

    def broken(*a, **k):
        raise RuntimeError("step failed")

    exe = s._executable("push", 8)
    monkeypatch.setattr(exe, "fn", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        s.push(["a"], [2 * 10**9], {"px": [2.0], "qty": [2.0]})
    monkeypatch.undo()
    np.testing.assert_array_equal(s._wm_ts, wm)
    assert s.acked == 1
    for k, v in s._state.items():
        assert v.numpy().tobytes() == before[k].numpy().tobytes(), k
    s.push(["a"], [2 * 10**9], {"px": [2.0], "qty": [2.0]})


def test_lookback_expiry_across_pushes():
    s = _stream(["a"], max_lookback=3)
    s.push(["a"], [10**9], {"px": [7.0], "qty": [7.0]})
    out = s.push_left(["a"] * 3, [2 * 10**9, 3 * 10**9, 4 * 10**9])
    assert list(out["px_found"]) == [True, True, True]
    out = s.push_left(["a"], [5 * 10**9])
    assert not out["px_found"][0] and out["right_row_idx"][0] == -1


def test_clipped_counts_the_declared_bound():
    L = 24
    ts = (np.arange(L, dtype=np.int64) + 1) * 10**9
    s = _stream(["a"], window_secs=10.0, window_rows_bound=4)
    for i in range(L):
        s.push(["a"], [ts[i]], {"px": [1.0], "qty": [1.0]})
    xs = np.ones((C, 1, L), np.float32)
    _, clip = sst.window_stats_batch(ts[None], xs, xs == 1,
                                     sst.window_ns(10.0), 4, device="cpu")
    assert s.clipped == int(clip.sum()) > 0


# ----------------------------------------------------------------------
# The executor
# ----------------------------------------------------------------------

def test_executor_identity_and_latency():
    rng = np.random.default_rng(3)
    K = 3
    events = _gen_events(rng, K, 90, tie_heavy=True)
    stream = _stream([f"s{k}" for k in range(K)], ema_alpha=0.2)
    tickets = []
    with MicroBatchExecutor(stream, batch_rows=8, queue_depth=64) as ex:
        for k, side, ts, _, vals in events:
            if side == "right":
                tickets.append(ex.submit(
                    "right", f"s{k}", ts,
                    {c: vals[ci] for ci, c in enumerate(COLS)}, timeout=WAIT))
            else:
                tickets.append(ex.submit("left", f"s{k}", ts, timeout=WAIT))
        results = [t.result(timeout=WAIT) for t in tickets]
    (wv, wf, wi), _, _, ema = _batch(events, K, alpha=0.2)
    pos = {"left": [0] * K, "right": [0] * K}
    for (k, side, *_r), res in zip(events, results):
        j = pos[side][k]
        pos[side][k] += 1
        for ci, c in enumerate(COLS):
            if side == "right":
                assert _bits(res[f"{c}_ema"]) == _bits(ema[ci, k, j])
            else:
                assert bool(res[f"{c}_found"]) == bool(wf[ci, k, j])
                assert _bits(res[c]) == _bits(wv[ci, k, j])
        if side == "left":
            assert int(res["right_row_idx"]) == int(wi[k, j])
    lat = ex.latency_stats()
    assert lat["all"]["count"] == len(events)
    assert lat["all"]["p99_ms"] >= lat["all"]["p50_ms"] is not None
    assert ex.batches >= 2 and ex.ticks == len(events)
    assert set(ex.bucket_hist) <= {8}


def test_executor_backpressure_and_close():
    stream = _stream(["a"])
    gate = threading.Event()
    orig_push = stream.push

    def slow_push(*a, **k):
        gate.wait(WAIT)
        return orig_push(*a, **k)

    stream.push = slow_push
    ex = MicroBatchExecutor(stream, queue_depth=1)
    tickets = [ex.submit("right", "a", 10**9, {"px": 1.0, "qty": 1.0})]
    with pytest.raises(queue_mod.Full):
        for i in range(3):
            tickets.append(ex.submit("right", "a", (i + 2) * 10**9,
                                     {"px": 1.0, "qty": 1.0}, timeout=0.05))
    gate.set()
    ex.close(timeout=WAIT)
    assert ex.ticks == len(tickets)
    for t in tickets:
        t.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit("right", "a", 10**12, {"px": 1.0, "qty": 1.0})
    with pytest.raises(ValueError, match="kind"):
        ex.submit("sideways", "a", 1)


def test_executor_deadline_cancel_and_close_timeout():
    stream = _stream(["a"])
    gate, entered = threading.Event(), threading.Event()
    orig_push = stream.push

    def slow_push(*a, **k):
        entered.set()
        gate.wait(WAIT)
        return orig_push(*a, **k)

    stream.push = slow_push
    ex = MicroBatchExecutor(stream, queue_depth=16)
    first = ex.submit("right", "a", 10**9, {"px": 1.0, "qty": 1.0})
    assert entered.wait(WAIT)              # the worker is inside push
    doomed = ex.submit("right", "a", 2 * 10**9, {"px": 1.0, "qty": 1.0},
                       deadline=0.01)
    dropped = ex.submit("right", "a", 3 * 10**9, {"px": 1.0, "qty": 1.0})
    assert dropped.cancel()
    kept = ex.submit("right", "a", 4 * 10**9, {"px": 4.0, "qty": 4.0})
    time.sleep(0.05)                       # past doomed's 10 ms budget
    gate.set()
    first.result(timeout=WAIT)
    with pytest.raises(DeadlineExceeded, match="serve queue"):
        doomed.result(timeout=WAIT)
    with pytest.raises(Cancelled):
        dropped.result(timeout=WAIT)
    assert kept.result(timeout=WAIT) == {}      # no operators: no emissions
    assert ex.deadline_failures == 1
    ex.close(timeout=WAIT)
    assert stream.acked == 2          # the dropped ticks never reached it
    # a drain that cannot finish in its timeout fails what is pending
    gate.clear()
    stream2 = _stream(["a"])
    push2 = stream2.push
    stream2.push = lambda *a, **k: gate.wait(WAIT) and push2(*a, **k)
    ex2 = MicroBatchExecutor(stream2, queue_depth=16)
    stuck = [ex2.submit("right", "a", (i + 1) * 10**9,
                        {"px": 1.0, "qty": 1.0}) for i in range(3)]
    ex2.close(timeout=0.2)
    gate.set()
    with pytest.raises(RuntimeError, match="pending"):
        stuck[-1].result(timeout=WAIT)


def test_executor_survives_bad_payload_and_late_ticks():
    stream = _stream(["a"])
    with MicroBatchExecutor(stream) as ex:
        bad = ex.submit("right", "a", "not-a-timestamp",
                        {"px": 1.0, "qty": 1.0})
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        ok = ex.submit("right", "a", 5 * 10**9, {"px": 1.0, "qty": 1.0})
        assert isinstance(ok.result(timeout=WAIT), dict)
        late = ex.submit("right", "a", 10**9, {"px": 2.0, "qty": 2.0})
        with pytest.raises(LateTickError):
            late.result(timeout=WAIT)
        after = ex.submit("right", "a", 6 * 10**9, {"px": 3.0, "qty": 3.0})
        after.result(timeout=WAIT)
    assert ex.ticks == 2 and ex.restarts == 0


# ----------------------------------------------------------------------
# Zero builds in the steady state
# ----------------------------------------------------------------------

def _steady(stream):
    t = 10**9
    for _ in range(8):
        t += 10**9
        stream.push(["a", "b"], [t, t], {"px": [1.0, 2.0], "qty": [3.0, 4.0]})
        t += 10**9
        stream.push_left(["a"], [t])


@pytest.mark.parametrize("cache_size", [None, "0"])
def test_zero_builds_in_the_steady_state(monkeypatch, cache_size):
    if cache_size is not None:
        monkeypatch.setenv("TEMPO_TPU_PLAN_CACHE_SIZE", cache_size)
    stream = StreamingTSDF(["a", "b"], COLS, device="cpu", ema_alpha=0.5,
                           window_secs=4.0, window_rows_bound=8)
    assert stream.warmup(16) == 2
    builds0 = profiling.plan_cache_stats()["builds"]
    _steady(stream)
    assert profiling.plan_cache_stats()["builds"] == builds0


# ----------------------------------------------------------------------
# Snapshots, resume across the packages, a byte-identical tail
# ----------------------------------------------------------------------

def _right_batches(seed, K=2):
    rng = np.random.default_rng(seed)
    events = [e for e in _gen_events(rng, K, 80, tie_heavy=True)
              if e[1] == "right"]
    out, i = [], 0
    while i < len(events):
        j = min(len(events), i + int(rng.integers(1, 6)))
        out.append(events[i:j])
        i = j
    return out


def _push_all(stream, batches):
    outs = []
    for b in batches:
        vals = {c: np.array([x[4][ci] for x in b], np.float32)
                for ci, c in enumerate(COLS)}
        outs.append(stream.push([f"s{x[0]}" for x in b], [x[2] for x in b],
                                vals))
    return outs


KW = dict(ema_alpha=0.2, window_secs=8.0, window_rows_bound=16,
          max_lookback=4, skip_nulls=False)


def test_snapshot_roundtrip_and_corrupt_fallback(tmp_path):
    parent = str(tmp_path / "ck")
    s = _stream(["a", "b"], checkpoint_dir=parent, ckpt_every=4, **KW)
    t = 0
    for i in range(12):
        t += 10**9
        s.push(["a", "b"], [t, t], {"px": [float(i), float(-i)],
                                    "qty": [1.0, 2.0]})
    steps = checkpoint.list_steps(parent)
    assert len(steps) >= 2
    faults.corrupt_npz_array(os.path.join(steps[0][1], "state.npz"))
    r = StreamingTSDF.resume(parent, device="cpu")
    assert 0 < r.acked < s.acked


def _kill_and_resume(tmp_path, writer, reader, batches, series):
    """Run ``batches`` through a stream of ``writer``'s package that is
    killed mid-way, resume its newest snapshot in ``reader``'s package:
    ``(resumed stream, index of the first batch to replay)``."""
    parent = str(tmp_path / f"ck_{writer}_{reader}")
    pkg = StreamingTSDF if writer == "port" else ref_serve.StreamingTSDF
    extra = {"device": "cpu"} if writer == "port" else {}
    s = pkg(series, COLS, checkpoint_dir=parent, ckpt_every=10, **extra,
            **KW)
    with faults.FaultInjector() as fi:
        fi.kill_on_call(pkg, "push", call_no=len(batches) // 2 + 1)
        with pytest.raises(faults.SimulatedKill):
            _push_all(s, batches)
    assert any(r.action == "kill" for r in fi.records)
    if reader == "port":
        r = StreamingTSDF.resume(parent, device="cpu")
    else:
        r = ref_serve.StreamingTSDF.resume(parent)
    done = 0
    for bi, b in enumerate(batches):
        if done == r.acked:
            assert r.acked > 0
            return r, bi, ckpt_arrays(parent)
        done += len(b)
    raise AssertionError("acked is not on a push boundary")


def ckpt_arrays(parent):
    return checkpoint.load_state(checkpoint.latest(parent))[0]


def test_resume_has_a_byte_identical_tail(tmp_path):
    """Kill a stream mid-way, resume its newest snapshot, replay the
    unacknowledged tail: the stitched output equals a run that never
    died, byte for byte."""
    batches, series = _right_batches(9), ["s0", "s1"]
    golden = _push_all(_stream(series, **KW), batches)
    r, tail_from, _ = _kill_and_resume(tmp_path, "port", "port", batches,
                                       series)
    for got, want in zip(_push_all(r, batches[tail_from:]),
                         golden[tail_from:]):
        assert set(got) == set(want)
        for key in want:
            assert np.asarray(got[key]).tobytes() == \
                np.asarray(want[key]).tobytes(), key


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_resume_across_packages(tmp_path, writer, reader):
    """A snapshot either package writes resumes in the other, its arrays
    byte for byte (the same layout and dtypes), and the other package's
    stream continues from it as that package's own resumed stream does:
    the replayed tail of a same-package resume of the same snapshot
    family, byte for byte."""
    batches, series = _right_batches(9), ["s0", "s1"]
    r, tail_from, arrays = _kill_and_resume(tmp_path, writer, reader,
                                            batches, series)
    own, own_from, _ = _kill_and_resume(tmp_path, writer, writer, batches,
                                        series)
    assert (own_from, own.acked) == (tail_from, r.acked)
    for name in r.cfg.state_names():
        got = (r._state[name].numpy() if reader == "port"
               else np.asarray(r._state[name]))
        assert got.dtype == arrays[name].dtype
        assert got.tobytes() == arrays[name].tobytes(), name
    # a same-package continuation of the writer's snapshot, in the reader
    same = (StreamingTSDF(series, COLS, device="cpu", **KW) if reader == "port"
            else ref_serve.StreamingTSDF(series, COLS, **KW))
    for name in same.cfg.state_names():
        same._state[name] = (torch.from_numpy(arrays[name].copy())
                             if reader == "port" else arrays[name].copy())
    same._wm_ts, same._wm_seq, same._wm_side = (
        arrays["wm_ts"], arrays["wm_seq"], arrays["wm_side"])
    for got, want in zip(_push_all(r, batches[tail_from:]),
                         _push_all(same, batches[tail_from:])):
        assert set(got) == set(want)
        for key in want:
            assert np.asarray(got[key]).tobytes() == \
                np.asarray(want[key]).tobytes(), key
