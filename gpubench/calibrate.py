"""The readings a cell's limits are set from, on the card:

    python3 -m gpubench.calibrate --workload <config>.<mix> \\
        --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds``, the cell's inputs are generated, one whole
chain runs through the path the window drives (after one warm-up
chain), its output is fetched and the program state freed, and the
output is compared with the float64 reference: the program's reading.
The reference and the comparison are the ones the cell's mix names.
For each of ``--control-seeds``, the reference computed in bfloat16
stands in the program's place: the control's reading.  One JSON line a
reading on standard output, then a summary line: the largest program
reading and the smallest control reading of each number.  The limits in
``cells/<workload>.json`` are set between the two (PERF.md).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from gpubench import harness


def _reading(kind: str, seed: int, numbers: dict) -> dict:
    line = {"kind": kind, "seed": seed, **numbers}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    bench = harness.spec()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    reference = harness.entry(mix["reference"])
    compare = harness.entry(mix["compare"])
    torch.set_num_threads(int(cfg["host_threads"]))
    cuda = torch.device(args.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = harness.generator(cfg["generator"])
    path_cls = harness.path_class(mix["path"])
    plain = lambda name: __import__("contextlib").nullcontext()  # noqa: E731
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    prog, ctl = [], []
    for seed in seeds + controls:
        left, right = gen.make(cfg, seed, args.scale)
        if seed in seeds:
            path = path_cls(cfg, left, right, args.device)
            path.chain(plain)
            out = path.chain(plain)
            sync()
            got = path.result(out)
            del out
            path.close()
            del path
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        ref = reference(left, right, cfg)
        if seed in seeds:
            prog.append(_reading("program", seed, compare(got, ref, cfg)))
            del got
        if seed in controls:
            low = reference(left, right, cfg, precision="bfloat16")
            ctl.append(_reading("control", seed, compare(low, ref, cfg)))
        gc.collect()
    summary = {"workload": args.workload, "device": (
        torch.cuda.get_device_name(0) if cuda else "cpu")}
    for k in harness.limits(args.workload):
        pv = [r[k] for r in prog if r[k] is not None]
        cv = [r[k] for r in ctl if r[k] is not None]
        summary[k] = {"program_max": max(pv) if pv else None,
                      "control_min": min(cv) if cv else None,
                      "control_none": sum(r[k] is None for r in ctl)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
