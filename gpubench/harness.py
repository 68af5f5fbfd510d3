"""One run of one cell: set-up, a measured window (or a traced one), and
the comparison that decides ``correct``.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (with ``generators/<generator>.py``), its
traffic mix in ``traffic/<traffic>.json`` (with ``paths/<path>.py``,
which says how much work a chain is, and the reference and comparison
the mix names), its limits in ``cells/<workload>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py``.  A reader gets
the trace, the window, the chains, the cell's configuration and mix and
the path's units and least work.  A new cell, mix or metric is new files
and new entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "tempo_tpu")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# Finding things by name
# ----------------------------------------------------------------------

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return _json(HERE / "cells" / f"{workload}.json")["limits"]


def generator(name: str):
    return importlib.import_module(f"gpubench.generators.{name}")


def path_class(name: str):
    return importlib.import_module(f"gpubench.paths.{name}").Path


def entry(name: str) -> Callable:
    """The function ``module:function`` names (a mix's ``reference`` and
    ``compare``)."""
    module, _, func = name.partition(":")
    return getattr(importlib.import_module(module), func)


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py`` (a file named after the
    metric, dots and all, loaded from its path)."""
    file = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{metric.replace('.', '_')}", file)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def end_to_end_of(bench: dict, workload: str) -> list:
    """The cell's end-to-end metric entries."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(bench: dict, workload: str) -> list:
    """The cell's per-layer metric entries: those listing it, and those
    with no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``tempo_tpu_torch`` is not ``tempo_tpu``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ----------------------------------------------------------------------
# The run
# ----------------------------------------------------------------------

def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _worst(results: list, names) -> dict:
    """The worst of several comparisons' numbers (None is worst)."""
    out = {}
    for k in names:
        vals = [r[k] for r in results]
        out[k] = None if any(v is None for v in vals) else max(vals)
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", scale: float = 1.0,
             t0: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``device="cpu"`` and ``scale`` < 1 serve the CPU tests."""
    import torch

    from gpubench.lib import trace as tr

    t0 = time.perf_counter() if t0 is None else t0
    cell = cell_of(bench, workload)
    cfg, mix = config(cell["config"]), traffic(cell["traffic"])
    lim = limits(workload)
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(int(cfg["host_threads"]))
    log(f"host: {os.cpu_count()} CPUs, torch threads "
        f"{torch.get_num_threads()}, native packer threads "
        f"{os.environ.get('TEMPO_TPU_NATIVE_THREADS', 'default')}")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    marks = [("imports", time.perf_counter())]
    left, right = generator(cfg["generator"]).make(cfg, seed, scale)
    marks.append(("inputs", time.perf_counter()))
    path = path_class(mix["path"])(cfg, left, right, device)
    marks.append(("path", time.perf_counter()))
    plain = contextlib.nullcontext
    # warm-up: one whole chain builds or loads every kernel and fills the
    # allocator's pools for the cell's shapes
    out = path.chain(lambda name: plain())
    sync()
    out = None
    gc.collect()
    marks.append(("warm-up chain", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    prev = t0
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"set-up {setup_s:.3f} s ({', '.join(parts)}; {len(left)} left "
        f"rows, {len(right)} right; {path.units} units a chain)")

    kept, device_extra, breakdown = [], {}, None
    if not trace:
        start = time.perf_counter()
        deadline = start + seconds
        n = 0
        ends = [start]
        while True:
            out = path.chain(lambda name: plain())
            sync()
            n += 1
            if n == 1:
                kept.append(out)
            end = time.perf_counter()
            ends.append(end)
            if end >= deadline:
                break
        kept.append(out)
        elapsed = end - start
        metrics = {}
        for m in end_to_end_of(bench, workload):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == mix["rate_metric"]:
                metrics[m["name"]] = {"value": path.units * n / elapsed,
                                      "unit": m["unit"]}
        chain_s = sorted(b - a for a, b in zip(ends, ends[1:]))
        log(f"window: {n} whole chains in {elapsed:.3f} s; a chain min "
            f"{chain_s[0]:.4f}, median {chain_s[len(chain_s) // 2]:.4f}, "
            f"max {chain_s[-1]:.4f} s")
    else:
        n = int(mix["trace_chains"])
        tmp = tempfile.mkdtemp(prefix="gpubench-trace-")
        try:
            events = _traced(path, n, kept, sync, cuda, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        win = [e for e in events if e.get("name") == "gpubench.window"
               and e.get("cat") == "user_annotation"]
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        # what a reader may read: the trace, the window, the chains, the
        # cell's configuration and mix, and the path's units and least work
        ctx = SimpleNamespace(events=events, w0=w0, w1=w1, chains=n,
                              units=path.units, work=path.work(),
                              cfg=cfg, mix=mix, tid=win[0].get("tid"))
        metrics = {}
        for m in per_layer_of(bench, workload):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_extra = {"busy_s": tr.busy_seconds(events, w0, w1),
                        "window_s": (w1 - w0) / 1e6}
        breakdown = {"device_ops": tr.top_device_ops(events, w0, w1),
                     "idle_gaps": tr.idle_gaps(events, w0, w1, ctx.tid)}
        log(f"traced {n} whole chains: window "
            f"{device_extra['window_s']:.6f} s, card busy "
            f"{device_extra['busy_s']:.6f} s")

    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count())) if cuda else 0)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    # the program's outputs to the host, then its state freed, before the
    # reference runs
    t1 = time.perf_counter()
    got = [path.result(o) for o in kept]
    del kept, out
    path.close()
    del path
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        log(f"card: {_card_line()}")
    # the yardstick loads after the window: its imports are no set-up of
    # the program's
    from gpubench.compare import judge

    reference, compare = entry(mix["reference"]), entry(mix["compare"])
    t2 = time.perf_counter()
    ref = reference(left, right, cfg)
    t3 = time.perf_counter()
    # the window's chains compute the same output from the same inputs:
    # where the kept outputs agree bit for bit, one comparison judges both
    if len(got) == 2 and got[0].equals(got[1]):
        got = got[1:]
    numbers = [compare(g, ref, cfg) for g in got]
    log(f"after the window: outputs fetched and freed {t2 - t1:.3f} s, "
        f"reference {t3 - t2:.3f} s, {len(numbers)} comparison(s) "
        f"{time.perf_counter() - t3:.3f} s")
    checks = judge(_worst(numbers, lim), lim)
    failed = sum(not all(judge(x, lim)[k]["ok"] for k in lim)
                 for x in numbers)
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak), **device_extra}
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": n, "failed": failed,
            "metrics": metrics, "device": device_out}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def _traced(path, n: int, kept: list, sync, cuda: bool, tmp: str) -> list:
    """Run ``n`` whole chains under ``torch.profiler``, each step in a
    span that ends with the card synchronised; keep the first and last
    outputs; return the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench.lib import trace as tr

    @contextlib.contextmanager
    def step(name):
        with record_function(name):
            yield
            sync()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function("gpubench.window"):
            for i in range(n):
                with record_function("gpubench.chain"):
                    out = path.chain(step)
                    with step("gpubench.ready"):
                        pass
                if i == 0:
                    kept.append(out)
        sync()
    kept.append(out)
    file = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(file)
    del prof
    torch.cuda.synchronize() if cuda else None
    return tr.load(file)


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec()
    cell = cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 3
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: refused")
        return 4
    for name, c in line["checks"].items():
        print(f"{name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
