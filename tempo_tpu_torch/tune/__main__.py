"""``python -m tempo_tpu_torch.tune`` — run the autotuner sweep.

Counterpart of ``python -m tempo_tpu.tune``.  Modes:

* (default) full sweep of every shape class, profile written to the
  checked-in location of this device kind (``--out`` overrides);
* ``--smoke`` — the gate: tiny shapes (``TEMPO_BENCH_SMOKE`` in the
  probe children), the clipped smoke ladders, profile written to
  ``--out`` when given (never to the checked-in path).  **Exits
  non-zero on any bitwise-audit failure**: a contract-bitwise knob
  (ring depth, serve batch rows, slab ring, stitch length, coalescing
  window) that changed result bits is a regression, and the gate's
  whole point;
* ``--show`` — print the profile the current process would load (after
  ``TEMPO_TPU_TUNE_PROFILE`` resolution + refusal checks) and exit.

``--device cuda|cpu`` (default ``cuda``) is where the probe children
run.  The summary and progress go to stderr; stdout carries ONE JSON
line (the sweep record).
"""

from __future__ import annotations

import argparse
import json
import sys

from tempo_tpu_torch.tune import harness, profile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tempo_tpu_torch.tune",
        description="sweep the registered knob space and persist a "
                    "tuned profile")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-shape CI sweep; exit nonzero on any "
                         "bitwise-audit failure")
    ap.add_argument("--out", default=None,
                    help="profile output path (default: the checked-in "
                         "per-device-kind location; --smoke defaults "
                         "to not persisting)")
    ap.add_argument("--classes", default=None,
                    help="comma-separated shape-class subset")
    ap.add_argument("--device", default="cuda",
                    help="where the probe children run: cuda (default) "
                         "or cpu")
    ap.add_argument("--show", action="store_true",
                    help="print the profile this process would load "
                         "and exit")
    args = ap.parse_args(argv)

    if args.show:
        try:
            prof = profile.load(strict=True)
        except profile.TuneProfileError as e:
            print(str(e), file=sys.stderr)
            return 2
        if prof is None:
            print("no tuned profile (TEMPO_TPU_TUNE_PROFILE="
                  "off/unset and no checked-in profile for this "
                  "device kind)", file=sys.stderr)
            return 0
        print(json.dumps(prof, indent=1, sort_keys=True))
        return 0

    names = ([c.strip() for c in args.classes.split(",") if c.strip()]
             if args.classes else None)
    out_path = args.out
    if out_path is None and not args.smoke:
        out_path = profile.default_path()
    payload, failures = harness.sweep(
        class_names=names, smoke=args.smoke, out_path=out_path,
        device=args.device)

    for name, rec in payload["classes"].items():
        if "hardware_gated" in rec:
            print(f"[tune] {name}: HARDWARE-GATED — "
                  f"{rec['hardware_gated']}", file=sys.stderr)
        elif "error" in rec:
            print(f"[tune] {name}: ERROR — {rec['error']}",
                  file=sys.stderr)
        else:
            print(f"[tune] {name}: {rec['rows_per_sec']:,.0f} rows/s "
                  f"(default {rec['default_rows_per_sec']:,.0f}, "
                  f"x{rec['speedup']}) knobs={rec['knobs']} "
                  f"[{rec['probes']} probes, "
                  f"{len(rec['rejected'])} rejected]", file=sys.stderr)
    if out_path:
        print(f"[tune] profile written: {out_path}", file=sys.stderr)
    for f in failures:
        print(f"[tune] BITWISE-AUDIT FAILURE: class {f['class']} "
              f"knobs {f['knobs']}: {f['reason']}", file=sys.stderr)
    print(json.dumps(payload, sort_keys=True))
    if failures:
        return 1
    # the CI gate must not pass green on a broken sweep: any errored
    # class fails --smoke (the smoke probes are tiny deterministic
    # shapes — a dead child there is a regression, not flakiness); a
    # full sweep tolerates individual errors (the child-isolation
    # discipline working, recorded in the profile) but fails when NO
    # class measured anything at all
    errored = [n for n, rec in payload["classes"].items()
               if "error" in rec]
    measured_any = any("rows_per_sec" in rec
                       for rec in payload["classes"].values())
    if errored and (args.smoke or not measured_any):
        print(f"[tune] SWEEP BROKEN: class(es) errored: "
              f"{', '.join(errored)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
