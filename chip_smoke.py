#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # full HHAR scale, needs one CUDA card
    python3 chip_smoke.py --rows 200000 --series 64    # a quicker run

Phases (each raises on failure, and the script then exits non-zero):

A. Build the five CUDA sources of ``tempo_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the build seconds.
B. Hold each kernel against its plain PyTorch version on the card, in
   float32, at the shapes the main paths give it: the merge join
   bitwise, range stats bitwise for ``count``/``clipped`` and within
   1e-5 elsewhere (``stddev`` as the variance; also on a forward window with bounds small enough to
   clip both ways), the EMA ladder bitwise.  Print kernel, plain and
   library times (``torch.searchsorted`` for the join's last-row index,
   timed here only as a yardstick; the port never calls it).  Then the
   second slice's kernels, all bitwise: the valid-index scans on the
   masks of the 1-second interpolation grid of the right frame,
   ``last_valid_scan`` on its packed ``wx`` column, and ``resample_ema``
   at its packed shape, on seconds shifted before 1970, and on rows
   long enough to take the global-scratch ladder (``torch.cummax`` of
   the candidate lanes is the last-valid-index yardstick).
C. The main path at full scale, as a user calls it: pandas frames shaped
   like the reference quickstart's HHAR phone<->watch join (13,062,475
   rows a side, 1024 series) -> ``TSDF`` -> ``asofJoin`` ->
   ``withRangeStats`` (10 s range window; the frame asserts the kernel's
   ``clipped`` audit is zero) -> exact ``EMA`` -> pandas.  The launch
   counters are zeroed just before and read just after; every kernel
   must have launched.  A small slice of the same data is checked
   against the plain versions (``device="cpu"``, float64).
D. ``entry.forward_step`` at [1024, 8192], its counters read the same
   way, ``clipped`` zero, its range stats (20 rows behind, 8 ahead) and
   EMA held against the plain versions on the same card tensors.
E. The resample / interpolate path at the same scale on the right
   (watch) frame, 5% null ``wx``: ``resample("1 second", "mean")
   .interpolate(method="linear")``, ``resampleEMA("1 minute", "wx")``
   and the public op ``ops.last_valid_scan`` on the packed column, the
   counters zeroed before and read after; each of the four kernels must
   have launched.  Then, on 8 users, all five fills (and the
   ``TSDF.interpolate`` form of the linear one) and ``resampleEMA`` on
   the card (float32) against ``device="cpu"`` (float64): timestamps,
   keys and flags equal, values within 1e-4.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``tempo_tpu_torch`` package beside it, it
prints no result and exits with 2.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
NS = 1_000_000_000
# the kernels each main path must launch: phases C and D, phase E
SLICE1_KERNELS = ("asof_merge", "range_stats", "ema_ladder")
SLICE2_KERNELS = ("last_valid_index", "first_valid_index",
                  "last_valid_scan", "resample_ema")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_frames(pd, n_rows: int, n_series: int, seed: int = 0):
    """HHAR-shaped frames (a copy of bench_frame.make_frames): n_series
    (user) keys, 1-2 s accelerometer ticks, phone (left) joined against
    watch (right) with 5% null readings."""
    rng = np.random.default_rng(seed)
    per = n_rows // n_series
    n = per * n_series
    keys = np.repeat(np.arange(n_series), per)
    gaps = rng.integers(1, 3, size=n).astype(np.int64)
    secs = np.cumsum(gaps.reshape(n_series, per), axis=1).reshape(-1)
    ts = pd.to_datetime(secs * np.int64(NS))
    left = pd.DataFrame({"user": keys, "event_ts": ts,
                         "x": rng.standard_normal(n).astype(np.float64)})
    right = pd.DataFrame({
        "user": keys,
        "event_ts": pd.to_datetime(
            (secs - rng.integers(0, 3, size=n)) * np.int64(NS)),
        "wx": np.where(rng.random(n) > 0.05, rng.standard_normal(n), np.nan),
    })
    return left, right, n


def check_range_stats(got, want, what: str) -> float:
    """Raise unless kernel stats ``got`` match the plain ``want``:
    ``count`` and ``clipped`` bitwise, the rest within 1e-5 (abs + rel;
    the centre's block reduction sums in another order).  ``stddev`` is
    compared as its square: both sides take ``s2 - s1*s1/n`` in float32,
    whose cancellation error (~1e-6 at these inputs, the same on both
    sides against float64) the square root blows up to ~1e-3 where the
    variance is near zero.  ``zscore`` is compared times each side's own
    ``stddev``, i.e. as ``x - mean``, where neither stddev is 0.
    Returns the largest absolute difference."""
    err = 0.0
    for k in ("count", "clipped"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: range-stats kernel {k} differs "
                                 f"from its plain version")
    for k in ("mean", "min", "max", "sum", "stddev", "zscore"):
        g, wv = got[k], want[k]
        if k == "stddev":
            g, wv = g * g, wv * wv
        elif k == "zscore":
            # where either side's stddev rounded to exactly 0 the zscore
            # is +-inf or NaN on that side alone: left out here, the
            # stddev comparison above covers those rows
            flat = (got["stddev"] == 0) | (want["stddev"] == 0)
            nan = torch.full_like(g, float("nan"))
            g = torch.where(flat, nan, g * got["stddev"])
            wv = torch.where(flat, nan, wv * want["stddev"])
        if not torch.equal(torch.isnan(g), torch.isnan(wv)):
            raise AssertionError(f"{what}: range-stats kernel {k}: NaN "
                                 f"pattern differs from its plain version")
        diff = (g - wv).abs().nan_to_num(0.0)
        tol = 1e-5 + 1e-5 * wv.abs().nan_to_num(0.0)
        if bool((diff > tol).any()):
            raise AssertionError(f"{what}: range-stats kernel {k} off its "
                                 f"plain version by {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def check_ema(got, want, what: str) -> float:
    """Raise unless the kernel's EMA is bitwise the plain version's."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{what}: EMA kernel differs from its plain "
                             f"version by {float((got - want).abs().max())}")
    return 0.0


def packed_join_inputs(pd, packing, left, right, dev):
    """The packed tensors the frame join hands the merge kernel: int64
    ns [K, Ll]/[K, Lr] and the right columns' validity [C, K, Lr]."""
    l_codes, r_codes, key_frame = packing.encode_keys_joint(left, right,
                                                            ["user"])
    K = len(key_frame)
    ll = packing.build_layout_from_codes(
        l_codes, packing.series_to_ns(left["event_ts"]), None, K)
    rl = packing.build_layout_from_codes(
        r_codes, packing.series_to_ns(right["event_ts"]), None, K)
    Ll = packing.pad_length(int(ll.lengths.max()))
    Lr = packing.pad_length(int(rl.lengths.max()))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    l_ts = up(packing.pack_column(ll.ts_ns, ll, Ll, fill=packing.TS_PAD))
    r_ts = up(packing.pack_column(rl.ts_ns, rl, Lr, fill=packing.TS_PAD))
    valids = [packing.pack_column((~pd.isna(right[c])).to_numpy()[rl.order],
                                  rl, Lr, fill=False)
              for c in ("event_ts", "wx")]
    return l_ts, r_ts, up(np.stack(valids))


def phase_b(pd, left, right, dev, d_args):
    """Each kernel against its plain version; returns the kernels' rows
    of the result line (``launches`` filled in by phase C)."""
    from tempo_tpu_torch import TSDF, packing
    from tempo_tpu_torch import rolling as rolling_frame
    from tempo_tpu_torch.ops import cuda_lib, merge, scan, window

    rows = {}

    # -- merge join, index form (the frame path) at the HHAR shape ----
    l_ts, r_ts, r_valids = packed_join_inputs(pd, packing, left, right, dev)
    K, Ll = l_ts.shape
    C, _, Lr = r_valids.shape
    got = merge.asof_merge_cuda(l_ts, r_ts, r_valids)
    want = merge.asof_merge_plain(l_ts, r_ts, r_valids)
    merge_err = 0.0
    for g, w, what in zip(got[:2], want[:2], ("last_row_idx", "per_col_idx")):
        merge_err = max(merge_err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"merge kernel differs from its plain "
                                 f"version in {what}")
    lib_last = torch.searchsorted(r_ts, l_ts, right=True) - 1
    if not torch.equal(lib_last.to(torch.int32), got[0]):
        raise AssertionError("merge kernel last_row_idx differs from "
                             "torch.searchsorted")
    # the one-program step's value form at phase D's shape
    dl_ts, _, _, _, dr_ts, dr_valids, dr_values = d_args
    vg = merge.asof_merge_values(dl_ts, dr_ts, dr_valids, dr_values)
    vw = merge.asof_merge_plain(dl_ts, dr_ts, dr_valids, dr_values)
    if not (torch.equal(vg[0].view(torch.int32), vw[2].view(torch.int32))
            and torch.equal(vg[2], vw[0])):
        raise AssertionError("merge kernel (value form) differs from its "
                             "plain version")
    nbytes = K * Ll * 8 + K * Lr * 8 + C * K * Lr + K * Ll * 4 * (1 + C)
    nops = K * Ll * math.ceil(math.log2(Lr + 1))
    b, by = bound_ms(nbytes, nops)
    rows["asof_merge"] = dict(
        name="asof_merge", route="cuda",
        source="tempo_tpu_torch/csrc/asof_merge.cu",
        replaces="tempo_tpu/ops/pallas_merge.py:251",
        max_abs_err=merge_err,
        ms=time_ms(lambda: merge.asof_merge_cuda(l_ts, r_ts, r_valids)),
        plain_ms=time_ms(lambda: merge.asof_merge_plain(l_ts, r_ts, r_valids),
                         reps=3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.searchsorted(r_ts, l_ts, right=True)),
        shape=f"[{K}, {Ll}] x [{K}, {Lr}], C={C}")
    log(f"B merge: bitwise equal to plain at [{K}, {Ll}]x[{K}, {Lr}] C={C} "
        f"and at phase D's shape (value form); kernel "
        f"{rows['asof_merge']['ms']:.4f} ms, plain "
        f"{rows['asof_merge']['plain_ms']:.4f} ms, torch.searchsorted "
        f"{rows['asof_merge']['library_ms']:.4f} ms")
    del l_ts, r_ts, r_valids, got, want, lib_last

    # -- range stats at the HHAR shape (the left metric x) -----------
    lt = TSDF(left, "event_ts", ["user"], device=dev, dtype=torch.float32)
    x, valid = lt.packed_numeric("x")
    engine, rb, ts_long, w = rolling_frame.plan_range_engine(lt, 10)
    secs = torch.from_numpy(ts_long).to(dev)
    mb, ma = int(rb[0]), int(rb[1])
    got = window.range_stats_cuda(secs, x[None], valid[None], w, mb, ma)
    want = window.range_stats_plain(secs, x[None], valid[None], w, mb, ma)
    err = check_range_stats(got, want, "HHAR shape")
    # look-ahead rows (a forward window) and truncation both ways, so the
    # kernel's ahead loop and both halves of its clipped audit are held
    # against the plain version too
    dsecs = d_args[1].to(torch.int32)
    dx, dv = d_args[2][None], d_args[3][None]
    got = window.range_stats_cuda(dsecs, dx, dv, 10, 4, 2, window_ahead=6)
    want = window.range_stats_plain(dsecs, dx, dv, 10, 4, 2, window_ahead=6)
    n_clipped = int(want["clipped"].sum())
    if n_clipped == 0:
        raise AssertionError("truncating range-stats case clipped nothing")
    err = max(err, check_range_stats(got, want, "truncating case"))
    Kw, L = x.shape
    nbytes = Kw * L * (4 + 4 + 1) + 7 * Kw * L * 4 + Kw * 4
    nops = Kw * L * ((mb + ma) * 10 + 20)
    b, by = bound_ms(nbytes, nops)
    rows["range_stats"] = dict(
        name="range_stats", route="cuda",
        source="tempo_tpu_torch/csrc/range_stats.cu",
        replaces="tempo_tpu/ops/pallas_window.py:312",
        max_abs_err=err,
        ms=time_ms(lambda: window.range_stats_cuda(secs, x[None], valid[None],
                                                   w, mb, ma)),
        plain_ms=time_ms(lambda: window.range_stats_plain(
            secs, x[None], valid[None], w, mb, ma), reps=3),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"[1, {Kw}, {L}], window {w}s, rows {mb} behind/{ma} ahead, "
              f"engine {engine}")
    log(f"B range_stats: count/clipped bitwise, rest within 1e-5 "
        f"(max abs err {err:.3g}) at [1, {Kw}, {L}] bounds ({mb}, {ma}) and "
        f"at {list(dx.shape)} rangeBetween(-10, +6) bounds (4, 2) with "
        f"{n_clipped} rows clipped; "
        f"kernel {rows['range_stats']['ms']:.4f} ms, plain "
        f"{rows['range_stats']['plain_ms']:.4f} ms")
    del got, want

    # -- exact EMA ladder at the HHAR shape ---------------------------
    ema_err = check_ema(scan.ema_cuda(x, valid, 0.2),
                        scan.ema_plain(x, valid, 0.2), "HHAR shape")
    # rows past the shared-memory ladder take the global-scratch form
    lx = d_args[2].reshape(-1, 2 * d_args[2].shape[1])
    lv = d_args[3].reshape(lx.shape)
    check_ema(scan.ema_cuda(lx, lv, 0.2), scan.ema_plain(lx, lv, 0.2),
              f"global-scratch form {list(lx.shape)}")
    levels = math.ceil(math.log2(max(L, 2)))
    b, by = bound_ms(Kw * L * (4 + 1 + 4), Kw * L * 3 * levels)
    rows["ema_ladder"] = dict(
        name="ema_ladder", route="cuda",
        source="tempo_tpu_torch/csrc/ema_ladder.cu",
        replaces="tempo_tpu/ops/pallas_kernels.py:105",
        max_abs_err=ema_err,
        ms=time_ms(lambda: scan.ema_cuda(x, valid, 0.2)),
        plain_ms=time_ms(lambda: scan.ema_plain(x, valid, 0.2), reps=3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"[{Kw}, {L}]")
    log(f"B ema_ladder: bitwise equal to plain at [{Kw}, {L}] and, through "
        f"global scratch, at {list(lx.shape)}; kernel "
        f"{rows['ema_ladder']['ms']:.4f} ms, plain "
        f"{rows['ema_ladder']['plain_ms']:.4f} ms")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return rows


def check_bitwise(got, want, what: str) -> None:
    """Raise unless two tensors (floats as their bits) are equal."""
    g, w = got, want
    if g.is_floating_point():
        bits = {4: torch.int32, 8: torch.int64}[g.element_size()]
        g, w = g.view(bits), w.view(bits)
    if g.dtype != w.dtype or not torch.equal(g, w):
        raise AssertionError(f"{what}: kernel differs from its plain version")


def phase_b_slice2(right, dev):
    """The second slice's kernels against their plain versions; returns
    their rows of the result line (``launches`` filled in by phase E)."""
    from tempo_tpu_torch import TSDF, interpol, packing
    from tempo_tpu_torch import resample as rs
    from tempo_tpu_torch.ops import bucket, cuda_lib, scan

    rows = {}
    rt = TSDF(right, "event_ts", ["user"], device=dev)

    # -- valid-index scans on the 1 s interpolation grid's masks -------
    sampled = rt._with_df(rs.aggregate(rt, "1 second", "mean"))
    real, _, _, _, valid, _ = interpol.dense_grid(sampled, 1, ["wx"])
    grid = torch.from_numpy(real).to(dev)
    col = torch.from_numpy(valid.reshape(-1, valid.shape[-1])).to(dev)
    K, G = grid.shape
    for mask, what in ((grid, "grid mask"), (col, "wx mask")):
        check_bitwise(scan.last_valid_index_scan_cuda(mask),
                      scan.last_valid_index_scan_plain(mask),
                      f"last_valid_index on the {what}")
        check_bitwise(scan.first_valid_index_scan_cuda(mask),
                      scan.first_valid_index_scan_plain(mask),
                      f"first_valid_index on the {what}")
    lanes = torch.arange(G, dtype=torch.int32, device=dev).expand(K, G)
    cand = torch.where(grid, lanes, -1)
    check_bitwise(torch.cummax(cand, dim=1).values,
                  scan.last_valid_index_scan_cuda(grid), "torch.cummax")
    b, by = bound_ms(K * G * 5, K * G * 2)
    for name, fn, plain, lib_fn in (
            ("last_valid_index", scan.last_valid_index_scan_cuda,
             scan.last_valid_index_scan_plain,
             lambda: torch.cummax(cand, dim=1)),
            ("first_valid_index", scan.first_valid_index_scan_cuda,
             scan.first_valid_index_scan_plain, None)):
        rows[name] = dict(
            name=name, route="cuda",
            source="tempo_tpu_torch/csrc/index_scan.cu",
            replaces="tempo_tpu/ops/pallas_kernels.py:"
                     + ("143" if name.startswith("last") else "152"),
            max_abs_err=0.0,
            ms=time_ms(lambda: fn(grid)),
            plain_ms=time_ms(lambda: plain(grid), reps=3),
            bound_ms=b, bound_by=by,
            library_ms=None if lib_fn is None else time_ms(lib_fn),
            shape=f"[{K}, {G}] bool")
    log(f"B index scans: bitwise equal to plain on the grid mask [{K}, {G}] "
        f"({int(real.sum())} real slots) and the wx mask {list(col.shape)}; "
        f"last {rows['last_valid_index']['ms']:.4f} ms, first "
        f"{rows['first_valid_index']['ms']:.4f} ms, torch.cummax "
        f"{rows['last_valid_index']['library_ms']:.4f} ms")
    del grid, col, cand, lanes, sampled

    # -- forward fill on the packed wx column --------------------------
    x, v = rt.packed_numeric("wx")
    Kx, L = x.shape
    got, want = scan.last_valid_scan_cuda(x, v), scan.last_valid_scan_plain(x, v)
    check_bitwise(got[0], want[0], "last_valid_scan values")
    check_bitwise(got[1], want[1], "last_valid_scan has-valid")
    b, by = bound_ms(Kx * L * 10, Kx * L * 2)
    rows["last_valid_scan"] = dict(
        name="last_valid_scan", route="cuda",
        source="tempo_tpu_torch/csrc/index_scan.cu",
        replaces="tempo_tpu/ops/pallas_kernels.py:121", max_abs_err=0.0,
        ms=time_ms(lambda: scan.last_valid_scan_cuda(x, v)),
        plain_ms=time_ms(lambda: scan.last_valid_scan_plain(x, v), reps=3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"[{Kx}, {L}]")
    log(f"B last_valid_scan: bitwise equal to plain at [{Kx}, {L}]; kernel "
        f"{rows['last_valid_scan']['ms']:.4f} ms")

    # -- fused resample + EMA at the packed shape ----------------------
    real = rt.packed_mask()
    secs64 = rt.packed_ts() // packing.NS_PER_S
    secs = torch.from_numpy(secs64.astype(np.int32)).to(dev)
    # seconds before 1970 (floor division matters), pads left at 0
    neg = torch.from_numpy(
        np.where(real, secs64 - 1_500_000_007, 0).astype(np.int32)).to(dev)
    # rows joined f at a time, past the ladder's shared memory (16 B a
    # lane), take its global-scratch form
    f = 1 << math.ceil(math.log2((cuda_lib.lib().tempo_ema_smem_limit()
                                  // 16 + 1) / L))
    k_long = Kx // f * f

    def long(t):
        return t[:k_long].reshape(k_long // f, f * L)

    cases = [(secs, x, v, 60, None, "HHAR shape"),
             (neg, x, v, 60, 1.5, "negative seconds, scale 1.5"),
             (long(secs), long(x), long(v), 7, None,
              f"global-scratch form [{k_long // f}, {f * L}], step 7")]
    for s_, x_, v_, step, scale, what in cases:
        got = bucket.resample_ema_cuda(s_, x_, v_, step, 0.2, scale)
        want = bucket.resample_ema_plain(s_, x_, v_, step, 0.2, scale)
        check_bitwise(got[0], want[0], f"resample_ema res ({what})")
        check_bitwise(got[1], want[1], f"resample_ema ema ({what})")
    levels = math.ceil(math.log2(max(L, 2)))
    b, by = bound_ms(Kx * L * 17, Kx * L * (3 * levels + 6))
    rows["resample_ema"] = dict(
        name="resample_ema", route="cuda",
        source="tempo_tpu_torch/csrc/resample_ema.cu",
        replaces="tempo_tpu/ops/pallas_bucket.py:378", max_abs_err=0.0,
        ms=time_ms(lambda: bucket.resample_ema_cuda(secs, x, v, 60, 0.2)),
        plain_ms=time_ms(lambda: bucket.resample_ema_plain(secs, x, v, 60,
                                                           0.2), reps=3),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"[{Kx}, {L}]")
    log(f"B resample_ema: res and ema bitwise equal to plain at "
        f"{'; '.join(c[-1] for c in cases)}; kernel "
        f"{rows['resample_ema']['ms']:.4f} ms, plain "
        f"{rows['resample_ema']['plain_ms']:.4f} ms")
    log(f"B launches while comparing (not counted): {dict(cuda_lib.launches)}")
    return rows


def chain(TSDF, left, right, steps=None, **kw):
    """The main path; ``steps`` (a dict) collects each step's wall
    seconds, the card synchronised at every step's end."""
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if steps is not None:
            torch.cuda.synchronize()
            steps[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

    lt = TSDF(left, "event_ts", ["user"], **kw)
    rt = TSDF(right, "event_ts", ["user"], **kw)
    joined = lt.asofJoin(rt)
    mark("asofJoin")
    stats = joined.withRangeStats(colsToSummarize=["x"],
                                  rangeBackWindowSecs=10)
    mark("withRangeStats")
    out = stats.EMA("x", exact=True)
    mark("EMA")
    return out.df


def phase_c(pd, TSDF, left, right, n, n_series):
    from tempo_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    steps = {}
    t0 = time.perf_counter()
    df = chain(TSDF, left, right, steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    missing = [k for k in SLICE1_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if len(df) != n:
        raise AssertionError(f"main path returned {len(df)} rows, not {n}")
    for c in ("right_wx", "mean_x", "count_x", "stddev_x", "EMA_x"):
        if c not in df.columns:
            raise AssertionError(f"main path output lacks {c}")
    if not np.isfinite(df["EMA_x"].to_numpy()).all():
        raise AssertionError("EMA_x has non-finite values")
    if not (df["count_x"].to_numpy() >= 1).all():
        raise AssertionError("count_x below 1 on a valid row")
    if not np.isfinite(df["mean_x"].to_numpy()).all():
        raise AssertionError("mean_x has non-finite values")
    log(f"C main path: {n} rows a side, {n_series} series, "
        f"{seconds:.3f} s pandas->TSDF->asofJoin->withRangeStats->EMA->"
        f"pandas ({n / seconds:.0f} rows/s); clipped audit zero (asserted "
        f"by withRangeStats); launches {launches}")
    log("C steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))

    # the same chain on a small slice: kernels (float32) vs the plain
    # versions on the CPU (float64)
    users = np.arange(min(8, n_series))
    sl = left[left["user"].isin(users)]
    sr = right[right["user"].isin(users)]
    small = chain(TSDF, sl, sr)
    ref = chain(TSDF, sl, sr, device="cpu")
    for c in ("event_ts", "x", "right_event_ts", "right_wx"):
        if not small[c].equals(ref[c]):
            raise AssertionError(f"small-slice {c} differs from the plain "
                                 f"versions")
    np.testing.assert_array_equal(small["count_x"].to_numpy(),
                                  ref["count_x"].to_numpy())
    for c in ("mean_x", "min_x", "max_x", "sum_x", "stddev_x", "EMA_x"):
        np.testing.assert_allclose(small[c].to_numpy(np.float64),
                                   ref[c].to_numpy(np.float64), rtol=1e-4,
                                   atol=1e-4, equal_nan=True, err_msg=c)
    log(f"C small slice ({len(small)} rows): card float32 agrees with the "
        f"CPU float64 plain versions (joins equal, count equal, stats and "
        f"EMA within 1e-4)")
    return launches, seconds


def phase_d(d_args):
    from tempo_tpu_torch import entry
    from tempo_tpu_torch.ops import cuda_lib, scan, window

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = entry.forward_step(*d_args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    if any(launches[k] == 0 for k in SLICE1_KERNELS):
        raise AssertionError(f"forward_step skipped a kernel: {launches}")
    K, Ll = d_args[0].shape
    for k, v in out.items():
        want = (K, 1) if k == "stats_clipped" else (
            (d_args[5].shape[0], K, Ll) if k == "joined" else (K, Ll))
        if tuple(v.shape) != want:
            raise AssertionError(f"forward_step {k} shape {tuple(v.shape)}")
    if float(out["stats_clipped"].sum()) != 0.0:
        raise AssertionError("forward_step clipped audit is not zero")
    if not bool(torch.isfinite(out["ema"]).all()):
        raise AssertionError("forward_step EMA not finite")
    # the step's stats and EMA against the plain versions on the same
    # card tensors, at the step's own bounds (rows behind and ahead)
    _, l_secs, x, valid, _, _, _ = d_args
    want = window.range_stats_plain(
        l_secs.to(torch.int32), x[None], valid[None], int(entry.WINDOW_SECS),
        entry.MAX_WINDOW_ROWS, entry.MAX_TIE_ROWS)
    err = check_range_stats({k: out[f"stats_{k}"][None] for k in want},
                            want, "forward_step")
    check_ema(out["ema"], scan.ema_plain(x, valid, entry.EMA_ALPHA),
              "forward_step")
    log(f"D entry.forward_step at [{K}, {Ll}]: {seconds * 1e3:.3f} ms "
        f"(first call), clipped zero, launches {launches}; stats match the "
        f"plain version at bounds ({entry.MAX_WINDOW_ROWS}, "
        f"{entry.MAX_TIE_ROWS}) (count/clipped bitwise, rest max abs err "
        f"{err:.3g}), EMA bitwise")


def phase_e(TSDF, right, n, n_series):
    """Resample -> interpolate, resampleEMA and the public forward fill
    at full scale; returns the launch counts."""
    from tempo_tpu_torch import ops
    from tempo_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    steps = {}
    t0 = t_all = time.perf_counter()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rt = TSDF(right, "event_ts", ["user"])
    resampled = rt.resample("1 second", "mean")
    mark("resample")
    filled = resampled.interpolate(method="linear").df
    mark("interpolate")
    bars = rt.resampleEMA("1 minute", "wx").df
    mark("resampleEMA")
    x, valid = rt.packed_numeric("wx")
    val, has = ops.last_valid_scan(x, valid)
    mark("last_valid_scan")
    seconds = time.perf_counter() - t_all
    launches = dict(cuda_lib.launches)
    missing = [k for k in SLICE2_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"resample/interpolate path never launched "
                             f"{missing}")

    n_res = len(resampled.df)
    if list(filled.columns) != ["user", "event_ts", "wx"]:
        raise AssertionError(f"interpolate columns {list(filled.columns)}")
    step = filled["event_ts"].diff().dt.total_seconds().to_numpy()
    same = (filled["user"].to_numpy()[1:] == filled["user"].to_numpy()[:-1])
    if not (step[1:][same] == 1.0).all():
        raise AssertionError("interpolated grid is not 1 s within a series")
    if len(filled) <= n_res:
        raise AssertionError("interpolate generated no slots")
    # linear leaves a slot null where the next real row's value is
    # null (the reference's rule), so about the null share of wx
    w = filled["wx"].to_numpy()
    null_share = float(np.isnan(w).mean())
    if not np.isfinite(w[~np.isnan(w)]).all() or null_share > 0.2:
        raise AssertionError(f"interpolated wx not finite or mostly null "
                             f"({null_share:.3f} null)")
    if not np.isfinite(bars["EMA_wx"].to_numpy()).all():
        raise AssertionError("resampleEMA EMA_wx has non-finite values")
    if bars["wx"].isna().mean() > 0.2:
        raise AssertionError("resampleEMA heads mostly null")
    if not bool(torch.isfinite(val[has]).all()):
        raise AssertionError("last_valid_scan filled a non-finite value")
    log(f"E resample/interpolate path: {n} rows, {n_series} series, "
        f"{seconds:.3f} s ({n / seconds:.0f} rows/s); resample -> {n_res} "
        f"rows, interpolate -> {len(filled)} rows "
        f"({1 - n_res / len(filled):.3f} of the slots generated, "
        f"{null_share:.3f} of wx null), "
        f"resampleEMA -> {len(bars)} rows; launches {launches}")
    log("E steps (wall s, card synchronised after each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))

    # all five fills and resampleEMA on 8 users: card (float32) against
    # the plain versions on the CPU (float64)
    sr = right[right["user"].isin(np.arange(min(8, n_series)))]
    runs = {m: lambda t, m=m: t.resample("1 second", "mean").interpolate(
        method=m, show_interpolated=True)
        for m in ("zero", "null", "ffill", "bfill", "linear")}
    runs["TSDF.interpolate linear"] = lambda t: t.interpolate(
        freq="1 second", func="mean", method="linear",
        show_interpolated=True)
    runs["resampleEMA"] = lambda t: t.resampleEMA("1 minute", "wx")
    for what, run in runs.items():
        card = run(TSDF(sr, "event_ts", ["user"])).df
        cpu = run(TSDF(sr, "event_ts", ["user"], device="cpu")).df
        if list(card.columns) != list(cpu.columns) or len(card) != len(cpu):
            raise AssertionError(f"8-user {what}: frames differ in shape")
        for c in card.columns:
            if c in ("wx", "EMA_wx"):
                np.testing.assert_allclose(
                    card[c].to_numpy(np.float64), cpu[c].to_numpy(np.float64),
                    rtol=1e-4, atol=1e-4, equal_nan=True,
                    err_msg=f"8-user {what} {c}")
            elif not card[c].equals(cpu[c]):
                raise AssertionError(f"8-user {what}: {c} differs")
    log(f"E 8-user slice ({len(sr)} rows): {', '.join(runs)} on the card "
        f"(float32) agree with the CPU plain versions (float64): keys, "
        f"timestamps and flags equal, values within 1e-4")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=13_062_475)
    ap.add_argument("--series", type=int, default=1024)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import tempo_tpu_torch
        from tempo_tpu_torch import TSDF, entry, interop
        from tempo_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke.py: the tempo_tpu_torch package is not beside "
              f"it ({e})", file=sys.stderr)
        return 2
    if Path(tempo_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke.py: tempo_tpu_torch was not found beside it",
              file=sys.stderr)
        return 2
    try:
        import pandas as pd
    except ImportError:
        print("chip_smoke.py: pandas is missing; the frame path needs it",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"A build: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if cuda_lib.build_log else 'loaded existing'} "
        f"{', '.join(cuda_lib.SOURCES)})")
    for text in cuda_lib.build_log:
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"A ptxas: {line.strip()}")

    t0 = time.perf_counter()
    left, right, n = make_frames(pd, args.rows, args.series)
    log(f"C data: {n} rows a side in {time.perf_counter() - t0:.2f} s")
    d_args = interop.from_reference_arrays(
        *entry.example_args(K=args.series, Ll=8192, Lr=8192), device=dev)

    rows = phase_b(pd, left, right, dev, d_args)
    rows2 = phase_b_slice2(right, dev)
    launches, _ = phase_c(pd, TSDF, left, right, n, args.series)
    phase_d(d_args)
    launches2 = phase_e(TSDF, right, n, args.series)

    kernels = []
    for found, table in ((launches, rows), (launches2, rows2)):
        for name, row in table.items():
            row = dict(row)
            row["launches"] = found[name]
            kernels.append(row)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
