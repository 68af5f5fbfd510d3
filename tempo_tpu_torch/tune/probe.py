"""One autotuner measurement point: ``python -m tempo_tpu_torch.tune.probe
<class> [--device cuda|cpu]``.

Counterpart of the reference's ``bench.py --only-tune-probe``: the same
workload a shape class names, at the same probe shapes (``min(K, 256) x
min(L, 4096)`` of the reference bench's [1024, 8192], its smoke shapes
under ``TEMPO_BENCH_SMOKE``), driven through the port's public paths:

* ``stream_dense`` / ``stream_medium``: range stats over ~50 Hz / ~10 Hz
  ticks and a 10 s window, the staged form (``range_stats_ring``) at the
  ring depth under test;
* ``fused_chain``: ``entry.forward_step`` (merge join, range stats,
  exact EMA);
* ``serve_batch``: ``MicroBatchExecutor`` under a deterministic tick load;
* ``ingest_sweep``: ``io.ingest.sweep_slabs`` over slabs whose prefix
  sums the ``cumsum3`` kernel computes on the device;
* ``stitched_chain``: a planned resample -> EMA -> range stats chain;
* ``serve_cohort``: ``CohortExecutor`` under a Poisson tick load.

The candidate knobs arrive in the child's environment (the harness
clears every other tunable knob and sets ``TEMPO_TPU_TUNE_PROFILE=off``).
The probe prints ONE JSON line: ``rows_per_sec``, ``t_iter`` (seconds an
iteration: the median of repeated calls timed with CUDA events on a card,
the host clock on the CPU; wall time over the timed ticks for the two
serving classes), ``bytes_per_iter`` and ``digest``, a CRC-32 of the
full outputs on deterministic data, which every admissible knob value
must reproduce.  The first baseline probe of a stream class also reports
``stream_gbps``, a saxpy read+write stream rate on the device (over a
256 MiB plane on a card at full size, past its L2 cache).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from typing import Callable, Dict

import numpy as np
import torch

from tempo_tpu_torch import config
from tempo_tpu_torch import device as device_mod

#: the reference bench's full shape [K, L] and its smoke shape
BENCH_KL = (1024, 8192)
BENCH_KL_SMOKE = (64, 512)

#: bytes a lane of a stream probe: int32 keys, float32 x, bool valid in,
#: seven float32 stat planes out
STREAM_BYTES_ROW = 4 + 4 + 1 + 7 * 4


def smoke() -> bool:
    return bool(config.env_external("TEMPO_BENCH_SMOKE"))


def probe_shape():
    K, L = BENCH_KL_SMOKE if smoke() else BENCH_KL
    return min(K, 256), min(L, 4096)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(fn: Callable, dev: torch.device) -> float:
    """Median seconds of one ``fn()`` call after a warm-up call: CUDA
    events on a card, the host clock on the CPU.  Repeats until about a
    second (a fifth of one at smoke size) has been spent, 5-200 calls."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    est = max(time.perf_counter() - t0, 1e-6)
    target = 0.2 if smoke() else 1.0
    reps = int(np.clip(target / est, 5, 200))
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def digest(out: Dict[str, torch.Tensor]) -> int:
    """CRC-32 of every output's bytes, in key order."""
    h = 0
    for key in sorted(out):
        h = zlib.crc32(np.ascontiguousarray(
            out[key].detach().cpu().numpy()).tobytes(), h)
    return h


def results_digest(results) -> int:
    """CRC-32 of per-tick serving results in submission order, each
    field as float64 (per-tick results are bitwise invariant to the
    micro-batch split, so every admissible value reproduces them)."""
    h = 0
    for res in results:
        for key in sorted(res):
            h = zlib.crc32(np.asarray(res[key], np.float64).tobytes(), h)
    return h


def stream_saxpy_gbps(dev: torch.device, k: int, l: int) -> float:
    """Read+write stream rate (GB/s) of one pass ``y = s * a`` over a
    float32 [k, l] plane into a preallocated ``y`` (the reference's
    ``a * s + 1`` is one fused pass under XLA; eagerly it would be two):
    the rate the cost model's ``hbm_stream_rate`` takes."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((k, l)).astype(np.float32)
                         ).to(dev)
    y = torch.empty_like(a)
    t = time_call(lambda: torch.mul(a, 1.5, out=y), dev)
    return 2 * a.numel() * 4 / t / 1e9


def dense_stats_data(mean_gap_ms: int, k: int, l: int, seed: int = 2):
    """The reference bench's ``_dense_stats_data``: ticks every
    ``mean_gap_ms`` +-25 %, a float32 value, all valid."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(max(3 * mean_gap_ms // 4, 1),
                        max(5 * mean_gap_ms // 4, 2),
                        size=(k, l)).astype(np.int64)
    ms = np.cumsum(gaps, axis=-1)
    x = rng.standard_normal((k, l)).astype(np.float32)
    valid = np.ones((k, l), dtype=bool)
    return ms, x, valid


def row_bounds(secs: np.ndarray, w: int):
    """(behind, ahead) row extents of a rangeBetween(-w, 0) frame over
    each row of ``secs`` (the reference bench's ``_measured_rowbounds``)."""
    behind = ahead = 0
    lanes = np.arange(secs.shape[1])
    for row in secs:
        behind = max(behind, int((lanes - np.searchsorted(
            row, row - w, side="left")).max()))
        ahead = max(ahead, int((np.searchsorted(row, row, side="right")
                                - 1 - lanes).max()))
    return behind, ahead


def probe_stream(name: str, dev: torch.device, out: dict) -> None:
    from tempo_tpu_torch.ops import window

    Kp, Lp = probe_shape()
    gap = 20 if name == "stream_dense" else 100
    ms, x, valid = dense_stats_data(gap, Kp, Lp)
    behind, ahead = row_bounds(ms, 10_000)
    secs = torch.from_numpy(ms.astype(np.int32)).to(dev)
    xs = torch.from_numpy(x).to(dev)[None]
    vs = torch.from_numpy(valid).to(dev)[None]

    def body():
        return window.range_stats(secs, xs, vs, 10_000, behind, ahead)

    t_iter = time_call(body, dev)
    out.update(rows_per_sec=Kp * Lp / t_iter, t_iter=t_iter,
               bytes_per_iter=Kp * Lp * STREAM_BYTES_ROW,
               digest=digest(body()))
    if not out["knobs"] and not config.env_external(
            "TEMPO_BENCH_TUNE_NO_SAXPY"):
        # the saxpy stream rate feeds the profile's measured cost input,
        # read off the FIRST baseline probe only: candidate children
        # (non-empty knobs) and the baseline's re-probe (which sets the
        # marker) skip it
        # on a card at full size the plane (256 MiB) is well past its
        # 50 MB L2 cache, so the rate is the memory's, not the cache's
        wide = 64 if dev.type == "cuda" and not smoke() else 4
        out["stream_gbps"] = round(stream_saxpy_gbps(dev, Kp, wide * Lp),
                                   2)


def probe_fused_chain(dev: torch.device, out: dict) -> None:
    from tempo_tpu_torch import entry

    Kp, Lp = probe_shape()
    # the reference bench's make_data: ~1 tick a second on both sides
    rng = np.random.default_rng(0)
    l_secs = np.cumsum(rng.integers(1, 3, size=(Kp, Lp)).astype(np.int64),
                       axis=-1)
    r_secs = np.cumsum(rng.integers(1, 3, size=(Kp, Lp)).astype(np.int64),
                       axis=-1)
    x = rng.standard_normal((Kp, Lp)).astype(np.float32)
    valid = np.ones((Kp, Lp), dtype=bool)
    r_values = rng.standard_normal((entry.N_RIGHT_COLS, Kp, Lp)
                                   ).astype(np.float32)
    r_valids = rng.random((entry.N_RIGHT_COLS, Kp, Lp)) > 0.1
    args = [torch.from_numpy(a).to(dev) for a in
            (l_secs * np.int64(10**9), l_secs, x, valid,
             r_secs * np.int64(10**9), r_valids, r_values)]

    def body():
        return entry.forward_step(*args)

    t_iter = time_call(body, dev)
    out.update(rows_per_sec=Kp * Lp / t_iter, t_iter=t_iter,
               bytes_per_iter=sum(a.numel() * a.element_size()
                                  for a in args),
               digest=digest(body()))


def probe_serve_batch(dev: torch.device, out: dict) -> None:
    from tempo_tpu_torch.serve import MicroBatchExecutor, StreamingTSDF

    rng = np.random.default_rng(5)
    Ks, cols = 8, ("bid", "ask")
    n = 400 if smoke() else 2500
    stream = StreamingTSDF(
        [f"s{i}" for i in range(Ks)], list(cols), window_secs=10.0,
        window_rows_bound=32, ema_alpha=0.2, max_lookback=64, device=dev)
    # batch_rows=None: the executor reads the knob under test
    ex = MicroBatchExecutor(stream)
    stream.warmup(16)
    gaps = rng.exponential(scale=4e7, size=n).astype(np.int64) + 1
    ts = np.cumsum(gaps) + np.int64(10**9)
    series = rng.integers(0, Ks, n)
    is_left = rng.random(n) < 0.25
    vals = rng.standard_normal((n, len(cols))).astype(np.float32)

    def feed(i0, i1):
        tickets = []
        for i in range(i0, i1):
            sym = f"s{series[i]}"
            if is_left[i]:
                tickets.append(ex.submit("left", sym, ts[i]))
            else:
                tickets.append(ex.submit(
                    "right", sym, ts[i],
                    {c: vals[i, j] for j, c in enumerate(cols)}))
        return tickets

    n_warm = n // 8
    for t in feed(0, n_warm):
        t.result(timeout=120)
    t0 = time.perf_counter()
    results = [t.result(timeout=300) for t in feed(n_warm, n)]
    wall = time.perf_counter() - t0
    ex.close()
    out.update(rows_per_sec=(n - n_warm) / wall,
               t_iter=wall / (n - n_warm), bytes_per_iter=None,
               batch_rows=ex.batch_rows, digest=results_digest(results))


def probe_ingest_sweep(dev: torch.device, out: dict) -> None:
    from tempo_tpu_torch.io import ingest
    from tempo_tpu_torch.ops import scan

    n_slabs = 4 if smoke() else 10
    slab_rows = (1 << 13) if smoke() else (1 << 19)

    def load(i):
        rng = np.random.default_rng(100 + i)
        return np.sort(rng.standard_normal(slab_rows).astype(np.float32),
                       kind="stable")

    def compute(i, x):
        # the prefix sum of the windowed engine's kernel (``cumsum3``,
        # bitwise its plain version): ``torch.cumsum`` on a card does
        # not give the same bits twice
        xs = torch.from_numpy(x).to(dev)[None]
        y = scan.cumsum3(xs, torch.ones_like(xs, dtype=torch.bool))[0][0]
        y = y * 0.5
        sync(dev)
        return y

    def drain(i, y):
        return zlib.crc32(y.cpu().numpy().tobytes())

    # ring=None: sweep_slabs reads the knob under test
    ingest.sweep_slabs(2, load, compute, drain)   # warm
    t0 = time.perf_counter()
    res = ingest.sweep_slabs(n_slabs, load, compute, drain)
    wall = time.perf_counter() - t0
    h = 0
    for c in res:
        h = zlib.crc32(int(c).to_bytes(8, "little"), h)
    out.update(rows_per_sec=n_slabs * slab_rows / wall,
               t_iter=wall / n_slabs, bytes_per_iter=slab_rows * 4,
               digest=h)


def probe_stitched_chain(dev: torch.device, out: dict) -> None:
    import pandas as pd

    from tempo_tpu_torch import TSDF
    from tempo_tpu_torch.parallel import make_mesh
    from tempo_tpu_torch.plan import cache as plan_cache
    from tempo_tpu_torch.service import lazy_frame

    Ks, Ls = (16, 512) if smoke() else (64, 4096)
    rng = np.random.default_rng(7)
    secs = np.cumsum(rng.integers(1, 3, size=(Ks, Ls)).astype(np.int64),
                     axis=-1)
    df = pd.DataFrame({"sym": np.repeat(np.arange(Ks), Ls),
                       "event_ts": secs.ravel(),
                       "x": rng.standard_normal(Ks * Ls)})
    frame = TSDF(df, "event_ts", ["sym"], device=dev).on_mesh(
        make_mesh({"series": 1}, devices=[dev]))

    def chain():
        return (lazy_frame(frame).resample("5 seconds", "mean")
                .EMA("x", window=6)
                .withRangeStats(colsToSummarize=["x"],
                                rangeBackWindowSecs=20)
                .collect().df)

    plan_cache.CACHE.clear()
    ref = chain()                       # plan, capture
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        chain()
        ts.append(time.perf_counter() - t0)
    plan_cache.CACHE.clear()
    t_iter = float(np.median(ts))
    h = 0
    for c in sorted(ref.select_dtypes(include=[np.number])):
        h = zlib.crc32(np.ascontiguousarray(ref[c].to_numpy()).tobytes(), h)
    out.update(rows_per_sec=Ks * Ls / t_iter, t_iter=t_iter,
               bytes_per_iter=Ks * Ls * 12, digest=h)


def probe_serve_cohort(dev: torch.device, out: dict) -> None:
    from tempo_tpu_torch.serve import CohortExecutor, StreamCohort

    Sc = 32
    n = 600 if smoke() else 4000
    rng = np.random.default_rng(9)
    cohort = StreamCohort(("px",), window_secs=10.0, window_rows_bound=8,
                          ema_alpha=0.2, max_lookback=16, slots=Sc,
                          device=dev)
    members = [cohort.add_stream(f"u{i}", ["ticks"]) for i in range(Sc)]
    # coalesce_s=None: the executor reads the knob under test
    ex = CohortExecutor(cohort, batch_rows=16, queue_depth=64)
    cohort.warmup(16)
    gaps = rng.exponential(scale=4e7, size=n).astype(np.int64) + 1
    ts_arr = np.cumsum(gaps) + np.int64(10**9)
    stream_of = np.concatenate([
        rng.permutation(Sc), rng.integers(0, Sc, max(0, n - Sc))])[:n]
    is_left = rng.random(n) < 0.25
    is_left[:Sc] = False
    vals = rng.standard_normal(n).astype(np.float32)

    def feed(i0, i1):
        return ex.submit_many([
            ("left", members[stream_of[q]], "ticks", int(ts_arr[q]), None,
             None)
            if is_left[q] else
            ("right", members[stream_of[q]], "ticks", int(ts_arr[q]),
             {"px": vals[q]}, None)
            for q in range(i0, i1)])

    n_warm = n // 8
    for t in feed(0, n_warm):
        t.result(timeout=120)
    t0 = time.perf_counter()
    results = [t.result(timeout=300) for t in feed(n_warm, n)]
    wall = time.perf_counter() - t0
    ex.close()
    out.update(rows_per_sec=(n - n_warm) / wall,
               t_iter=wall / (n - n_warm), bytes_per_iter=None,
               coalesce_s=ex.coalesce_s, digest=results_digest(results))


PROBES = {
    "stream_dense": lambda dev, out: probe_stream("stream_dense", dev, out),
    "stream_medium": lambda dev, out: probe_stream("stream_medium", dev,
                                                   out),
    "fused_chain": probe_fused_chain,
    "serve_batch": probe_serve_batch,
    "ingest_sweep": probe_ingest_sweep,
    "stitched_chain": probe_stitched_chain,
    "serve_cohort": probe_serve_cohort,
}


def run(name: str, device="cuda") -> dict:
    """Measure the probe ``name`` on ``device``; returns its record."""
    from tempo_tpu_torch import tune

    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = {"class": name, "device": str(dev),
           "knobs": {k: config.get(k) for k in tune.TUNABLE_KNOBS
                     if config.get(k) is not None}}
    if name not in PROBES:
        raise KeyError(f"unknown tune probe {name!r}: known = "
                       f"{sorted(PROBES)}")
    PROBES[name](dev, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tempo_tpu_torch.tune.probe",
        description="one autotuner measurement point, one JSON line")
    ap.add_argument("probe", choices=sorted(PROBES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.probe, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
