"""The benchmark's entry point:

    python3 -m gpubench.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell
asks for.  It prints one JSON line last on standard output (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics) and exits 0, or exits with another code and prints
no result where there is no card, the run loaded JAX or the JAX
package, or the checkout lacks the program.

The set-up clock starts here, before any import that takes time; the
host's thread counts and the kernels' build directory are fixed before
torch and the program load.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _pin_environment(argv) -> None:
    """Thread counts from the cell's configuration and the kernel build
    directory inside the checkout, before torch is imported."""
    root = Path(__file__).resolve().parent.parent
    os.environ["TEMPO_TPU_KERNEL_BUILD_DIR"] = str(
        root / "tempo_tpu_torch" / "_build")
    try:
        workload = argv[argv.index("--workload") + 1]
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
        cfg_name = next(w["config"] for w in bench["workloads"]
                        if w["name"] == workload)
        with open(root / "gpubench" / "configs" / f"{cfg_name}.json") as f:
            threads = str(int(json.load(f)["host_threads"]))
    except (ValueError, IndexError, StopIteration, OSError, KeyError):
        return      # the harness reports what is missing
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "TEMPO_TPU_NATIVE_THREADS"):
        os.environ[var] = threads


if __name__ == "__main__":
    _pin_environment(sys.argv[1:])
    from gpubench.harness import main

    sys.exit(main(t0=T0))
