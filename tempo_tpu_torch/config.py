"""The ``TEMPO_TPU_*`` environment knobs this package reads.

Counterpart of ``tempo_tpu/config.py``, cut to the knobs the port's
frame and planner consult.  The
names are kept so one environment drives both packages the same way.
Every ``os.environ`` read of the package goes through :func:`get`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

#: name -> one-line contract of every knob read here
KNOBS = {
    "TEMPO_TPU_COMPUTE_DTYPE":
        "float dtype of metric math (float32|float64); default float32 "
        "on CUDA, float64 on the CPU",
    "TEMPO_TPU_SORT_KERNELS":
        "0 routes withRangeStats to the windowed (prefix-sum) engine",
    "TEMPO_TPU_JOIN_ENGINE":
        "force an AS-OF engine: single | chunked | bracket",
    "TEMPO_TPU_MAX_MERGED_LANES":
        "merged-lane limit of a single AS-OF program (0 disables)",
    "TEMPO_TPU_BINPACK":
        "1/0 forces/forbids the bin-packed AS-OF layout",
    "TEMPO_TPU_WINDOW_ENGINE":
        "force a range-stats engine: auto | shifted | stream | windowed | "
        "legacy (the legacy shifted-window kernel within the shifted row "
        "budget, as the reference picks it)",
    "TEMPO_TPU_STREAM_MAX_ROWS":
        "row-extent ceiling of the runtime-width range-stats engine",
    "TEMPO_TPU_DMA_BUFFERS":
        "depth of the staging ring of the bucket-stats, range-stats and "
        "resample-EMA kernels, clamped to [2, 8]; unset: the tuned "
        "profile's value, else 2",
    "TEMPO_TPU_SQL_STRICT":
        "strict SQL: selectExpr/filter raise StrictSqlFallback instead of "
        "falling back to pandas eval/query (per-call strict= wins)",
    "TEMPO_TPU_STRICT_SQL":
        "legacy alias of TEMPO_TPU_SQL_STRICT",
    "TEMPO_TPU_KERNEL_BUILD_DIR":
        "directory the CUDA kernels and the native packer are built into "
        "(default tempo_tpu_torch/_build)",
    "TEMPO_TPU_NATIVE":
        "0 sends packing's sort, gather, pack and unpack to numpy instead "
        "of the C++ packer (default on; read at every call)",
    "TEMPO_TPU_NATIVE_THREADS":
        "worker threads of one native packer call (default os.cpu_count())",
    "TEMPO_TPU_BREAKER_THRESHOLD":
        "consecutive failures of one key that open its circuit breaker "
        "(default 3)",
    "TEMPO_TPU_BREAKER_COOLDOWN_S":
        "seconds an open circuit waits before it admits one half-open "
        "probe (default 5.0)",
    "TEMPO_TPU_WAREHOUSE":
        "base directory of the tables TSDF.write writes and io.writer.read "
        "reads (default tempo_tpu_warehouse)",
    "TEMPO_TPU_STORE_SEGMENT_ROWS":
        "rows a clustered segment of one store generation (default "
        "1048576)",
    "TEMPO_TPU_STORE_KEEP_GENERATIONS":
        "store generations kept on disk, at least 1 (default 2)",
    "TEMPO_TPU_STORE_COMPACT_MIN_SEGMENTS":
        "segment count below which store.compact() does nothing (default "
        "2)",
    "TEMPO_TPU_INGEST_RING":
        "slab-buffer ring depth of io.ingest.sweep_slabs and the "
        "from_parquet shard loop; 1 runs serially (default 2)",
    "TEMPO_TPU_PLAN":
        "1 turns on the lazy query planner: recorded op chains are "
        "optimized (fusion, engine hoisting, column pruning) and executed "
        "at collect(); eager is the default (read live)",
    "TEMPO_TPU_PLAN_CACHE_SIZE":
        "LRU bound of the planner's executable cache (entries keyed by "
        "plan signature + shapes + mesh; 0 disables caching); default 64",
    "TEMPO_TPU_COST_MODEL":
        "0 reverts engine picks, fusion, stitching and reshard placement "
        "to the rule-based decisions; on (default) they are argmins over "
        "estimated cost among bitwise-equal candidates",
    "TEMPO_TPU_CKPT_PLACEMENT":
        "auto | off: checkpoint barrier nodes on planned chains run inside "
        "plan.checkpoints.checkpointed() (default auto)",
    "TEMPO_TPU_STITCH_MAX_OPS":
        "longest run of adjacent series-local planned mesh ops stitched "
        "into one captured CUDA graph; below 2 disables (default 8)",
    "TEMPO_TPU_RESHARD_PLACEMENT":
        "auto | declarative | explicit: plan-placed reshard nodes on "
        "time-sharded mesh chains (default auto)",
    "TEMPO_TPU_SERVE_BATCH_ROWS":
        "per-series row cap of one serving micro-batch: the executor cuts "
        "a coalesced run when any series reaches it, bounding the padded "
        "buckets (and so the cached steps) the steady state cycles "
        "through (default 64)",
    "TEMPO_TPU_SERVE_QUEUE_DEPTH":
        "bound of the serving executor's tick queue; a full queue blocks "
        "submit(), the backpressure signal (default 1024)",
    "TEMPO_TPU_SERVE_CKPT_EVERY":
        "snapshot a StreamingTSDF every N acked events (CRC'd keep-last-K "
        "through checkpoint.save_state; 0, the default, disables automatic "
        "snapshots, snapshot() stays available)",
    "TEMPO_TPU_SERVE_DEADLINE_S":
        "default end-to-end deadline (seconds) of serving tickets: a tick "
        "still queued when its budget dies fails with a stage-named "
        "DeadlineExceeded; unset or 0: none (per-submit deadlines stay "
        "available)",
    "TEMPO_TPU_SERVE_COHORT_SLOTS":
        "initial stream-slot capacity of each cohort shape-bucket group "
        "(grown by doubling when full; rounded up to the mesh's "
        "stream-axis size on sharded cohorts; a capacity change captures "
        "new step graphs, so size it to the expected fleet) (default 1024)",
    "TEMPO_TPU_SERVE_COHORT_CKPT_EVERY":
        "snapshot the whole cohort (one kind=\"cohort_state\" artifact, "
        "per-stream acked cursors in the manifest) every N total acked "
        "events; 0, the default, disables automatic snapshots "
        "(StreamCohort.snapshot() stays available)",
    "TEMPO_TPU_SERVE_COHORT_DIFF":
        "1 makes automatic cohort snapshots differential: only bucket "
        "groups dirty since the previous snapshot are written, chained to "
        "the last full artifact by CRC'd manifests (resume walks the "
        "chain; bytes a snapshot scale with dirty state, not fleet size) "
        "(default 0)",
    "TEMPO_TPU_SERVE_COALESCE_S":
        "dispatch coalescing window (seconds) of the cohort executor: "
        "ticks arriving within it batch into one cohort dispatch; a "
        "per-constructor coalesce_s wins (default 0.002)",
    "TEMPO_TPU_SERVE_COHORT_RESIDENT":
        "LRU resident-member budget of a StreamCohort with a spill_dir: "
        "members beyond it spill their slot state to CRC'd "
        "kind=\"cohort_member\" artifacts and fault back in on their next "
        "tick; 0, the default, is unlimited (no spill)",
    "TEMPO_TPU_INGEST_DEADLINE_S":
        "default end-to-end deadline of from_parquet in seconds (unset: "
        "none)",
    "TEMPO_TPU_STANDING_QUEUE_DEPTH":
        "bound of each standing subscription's notification queue; a full "
        "queue drops the oldest notification (counted on "
        "Subscription.dropped), result() stays exact (default 1024)",
    "TEMPO_TPU_STANDING_REMAINDER_EVERY":
        "push-boundary cadence at which remainder-mode standing queries "
        "re-run the whole canonical plan and emit a refresh notification; "
        "result() always re-runs (default 64)",
    "TEMPO_TPU_STANDING_PUSH_PERIOD":
        "delivery-worker coalescing window in seconds: pushes admitted "
        "within one period are delivered in one worker round; 0 (default) "
        "delivers every push as its own round",
    "TEMPO_TPU_SERVICE_WORKERS":
        "worker threads of the multi-tenant query service (concurrent plan "
        "executions; at least 1) (default 4)",
    "TEMPO_TPU_SERVICE_TENANT_QUOTA":
        "per-tenant pending-query bound: a tenant at quota blocks in "
        "submit() (default 64)",
    "TEMPO_TPU_SERVICE_VMEM_BUDGET":
        "per-query shared-memory admission budget in bytes, the dynamic "
        "shared memory one block of a kernel may take; unset: "
        "ops.stream.SMEM_LIMIT, explicit 0 admits nothing; a query whose "
        "projected block exceeds it is rejected with AdmissionError",
    "TEMPO_TPU_SERVICE_HBM_BUDGET":
        "total device-memory admission budget of the query service in "
        "bytes (default 2 GiB; explicit 0 admits nothing): a query over "
        "the whole budget is rejected, one over the free share queues",
    "TEMPO_TPU_TUNE_PROFILE":
        "tuned-knob profile source (path|off): a path to a profile the "
        "sweep harness wrote, 'off' to load none, unset = the checked-in "
        "profile of this device kind under tempo_tpu_torch/tune/profiles/ "
        "(none ships for the CPU).  Tuned values are priors: a knob set in "
        "the environment always wins; a corrupt or foreign profile is "
        "refused by name and the built-in defaults stand",
    "TEMPO_TPU_CONTRACT_LANES":
        "padded lanes L of the compiled contracts' program shapes "
        "(plan/contracts.py; default 32, clamped to [16, 4096])",
    "TEMPO_TPU_SERVICE_DEADLINE_S":
        "default end-to-end deadline (seconds) of submitted queries, "
        "carried through quota wait, admission wait and dispatch; unset or "
        "0: none",
}

#: environment variables of other systems that the port reads; the two
#: ``TEMPO_BENCH`` names are the tuner probe's, kept from the reference's
#: ``bench.py`` so one environment drives both probes the same way
EXTERNAL_VARS = ("DATABRICKS_RUNTIME_VERSION", "TEMPO_BENCH_SMOKE",
                 "TEMPO_BENCH_TUNE_NO_SAXPY")


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string value of a declared knob (``KeyError`` otherwise)."""
    if name not in KNOBS:
        raise KeyError(f"undeclared knob {name!r}: add it to KNOBS first")
    return os.environ.get(name, default)


def get_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Integer knob; unset or empty -> ``default``."""
    val = get(name)
    if val is None or not val.strip():
        return default
    return int(val)


def get_float(name: str, default: Optional[float] = None
              ) -> Optional[float]:
    """Float knob; unset or empty -> ``default``."""
    val = get(name)
    if val is None or not val.strip():
        return default
    return float(val)


def get_bool(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> ``default``; '', '0', 'false', 'no' and
    'off' -> False; anything else -> True."""
    val = get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("", "0", "false", "no", "off")


def snapshot() -> tuple:
    """``(name, value)`` of every declared knob that is set, and the
    loaded tuned profile's CRC (``tune.stamp()``): what a captured CUDA
    graph's key folds in, since the knobs, and the profile values that
    stand in for the unset ones, pick kernel forms and engines."""
    from tempo_tpu_torch import tune

    out = tuple((k, os.environ[k]) for k in sorted(KNOBS)
                if k in os.environ)
    crc = tune.stamp()
    return out if crc is None else out + (("tune_profile_crc", crc),)


def child_env(overrides: Optional[Dict[str, Optional[str]]] = None
              ) -> Dict[str, str]:
    """The process environment for a child process (the tuner's probe
    children), with ``overrides`` applied: ``None`` removes the name,
    anything else is stringified."""
    env = dict(os.environ)
    for name, value in (overrides or {}).items():
        if value is None:
            env.pop(name, None)
        else:
            env[name] = str(value)
    return env


def env_external(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read of an environment variable of another system (one of
    :data:`EXTERNAL_VARS`)."""
    if name not in EXTERNAL_VARS:
        raise KeyError(f"undeclared external variable {name!r}")
    return os.environ.get(name, default)
