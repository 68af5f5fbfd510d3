"""Several processes over ``torch.distributed``: ingest routing and
process-spanning meshes.

Counterpart of ``tempo_tpu/parallel/multihost.py``.  The reference's
multi-node story is Spark's: the driver holds a logical plan and
executors pull shuffled row partitions over the network (SURVEY.md §5).
Here it splits into two planes:

* **control and ingest**: :func:`distributed_init` stands up the
  process group (gloo on the CPU, NCCL on cards), :func:`process_mesh`
  builds a mesh over every process's devices with each entry's owner
  rank, and each process packs and uploads only the series its devices
  own (:func:`process_series_range`, :func:`shard_series_global`);
* **compute**: a process runs the shard programs of its own devices;
  blocks that cross processes (the join's row gather, the time axis's
  halos and all-to-alls) and the host arrays of ``collect()`` and the
  deferred audits move over the process group with point-to-point
  sends and broadcasts (``parallel/mesh.transfer``, ``host_gather``),
  collectives gloo supports on CPU tensors.

One process (tests, one card) is the same code with every rank 0.
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tempo_tpu_torch.parallel.mesh import (Mesh, make_mesh, meta_like,
                                           process_count, process_index)
from tempo_tpu_torch.resilience import FailureKind, classify

logger = logging.getLogger(__name__)


class DistributedInitTimeout(TimeoutError):
    """``distributed_init`` gave up waiting for the process group: the
    diagnostic alternative to hanging the process forever."""

    failure_kind = FailureKind.DEADLINE


def _watchdog_call(fn, kwargs: dict, timeout_s: float):
    """Run ``fn(**kwargs)`` in a daemon thread with a join timeout: a
    hung initializer (an unreachable coordinator) surfaces as
    ``TimeoutError`` instead of blocking the process.  The stuck thread
    cannot be killed and leaks, but the caller gets a diagnostic and
    keeps control."""
    result: dict = {}

    def target():
        try:
            result["value"] = fn(**kwargs)
        except BaseException as e:
            result["exc"] = e

    t = threading.Thread(target=target, daemon=True,
                         name="tempo-distributed-init")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(f"initializer still blocked after {timeout_s}s")
    if "exc" in result:
        raise result["exc"]
    return result.get("value")


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = 300.0,
                     backend: Optional[str] = None) -> None:
    """Join the ``torch.distributed`` process group (idempotent; a no-op
    for one process).  ``coordinator_address`` is ``host:port`` of rank
    0's store (``tcp://`` rendezvous; nothing on the machine announces a
    cluster, so every process is given the address, the count and its
    rank).  ``backend`` defaults to NCCL where a card is visible and to
    gloo otherwise.

    ``timeout_s`` bounds the wait for the other processes (default
    300 s; ``None`` or 0 blocks forever).  It is passed to
    ``init_process_group`` and enforced by a watchdog thread too; on
    expiry a :class:`DistributedInitTimeout` names the address and the
    process coordinates instead of hanging the job."""
    if num_processes is None or num_processes <= 1:
        return
    dist = torch.distributed
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = dict(backend=backend,
                  init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))

    def _diagnostic(cause: Optional[BaseException]):
        raise DistributedInitTimeout(
            f"distributed_init did not complete (timeout_s={timeout_s}): "
            f"coordinator_address={coordinator_address!r}, "
            f"num_processes={num_processes}, process_id={process_id}. "
            "Check that the coordinator is reachable from this host and "
            "that every process in the job was launched with the same "
            "num_processes.") from cause

    try:
        if timeout_s:
            _watchdog_call(dist.init_process_group, kwargs, timeout_s)
        else:
            dist.init_process_group(**kwargs)
    except DistributedInitTimeout:
        raise
    except TimeoutError as e:
        _diagnostic(e)
    except (RuntimeError, ValueError) as e:
        if "twice" in str(e):
            return      # another caller initialised the group first
        if classify(e) is FailureKind.DEADLINE:
            _diagnostic(e)
        raise


def sync_processes(name: str) -> None:
    """Wait for every process of the group at the barrier ``name`` (the
    reference's ``multihost_utils.sync_global_devices``): a gloo
    ``barrier``; a no-op in one process."""
    if process_count() > 1:
        logger.debug("sync_processes(%s)", name)
        torch.distributed.barrier()


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def process_mesh(axes: Optional[dict] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the devices of every process in the group, in rank
    order (process-major, so each process's series shards are
    contiguous), each entry owned by its process: ``devices`` lists
    this process's devices (default: its visible cards, or the CPU).
    In one process this is :func:`make_mesh`."""
    local = [str(d) for d in (devices if devices is not None
                              else _local_devices())]
    if process_count() == 1:
        return make_mesh(axes, devices=local)
    per = [None] * process_count()
    torch.distributed.all_gather_object(per, local)
    devs = [d for p in per for d in p]
    ranks = [r for r, p in enumerate(per) for _ in p]
    return make_mesh(axes or {"series": len(devs)}, devices=devs,
                     ranks=ranks)


def series_range_for_process(process_index: int,
                             shard_process_ids: np.ndarray,
                             n_series: int) -> Tuple[int, int]:
    """Pure ingest routing rule: the [start, stop) series rows a process
    must supply, given the device->process grid along the series axis
    (``[n_shards, replicas]``).  Kept apart from the live wrapper so the
    branches (partial, zero and non-contiguous ownership) are testable
    with synthetic grids in one process."""
    n_shards = int(shard_process_ids.shape[0])
    if n_series % n_shards != 0:
        raise ValueError(
            f"n_series {n_series} not divisible by series axis {n_shards}; "
            "pad with pad_series_axis first")
    block = n_series // n_shards
    mine = [i for i in range(n_shards)
            if (shard_process_ids[i] == process_index).any()]
    if not mine:
        return 0, 0
    lo, hi = min(mine), max(mine)
    if mine != list(range(lo, hi + 1)):
        raise ValueError(
            "series axis devices of this process are not contiguous; "
            "use a process-major mesh layout")
    return lo * block, (hi + 1) * block


def mesh_shard_process_ids(mesh: Mesh, axis: str = "series") -> np.ndarray:
    """``[n_shards, replicas]`` owner rank of each device, series-major:
    a process owns series shard i if any of its devices sits in the
    mesh slice with series index i (the other axes replicate or cut the
    series block)."""
    ax = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    return np.moveaxis(mesh.ranks, ax, 0).reshape(n, -1)


def process_series_range(n_series: int, mesh: Mesh,
                         axis: str = "series") -> Tuple[int, int]:
    """[start, stop) of the series rows this process must supply for a
    ``[K, ...]`` array sharded over ``axis`` (Spark's hash partitioner
    deciding which executor holds which keys, made static: contiguous
    series blocks a shard, shards in mesh order).  Callers pack only
    their slice and hand it to :func:`shard_series_global`."""
    return series_range_for_process(
        process_index(), mesh_shard_process_ids(mesh, axis), n_series)


def shard_series_global(local_rows: np.ndarray, mesh: Mesh, n_series: int,
                        axis: str = "series"):
    """The shards of a global ``[n_series, ...]`` array sharded over
    ``axis`` from each process's own series block (the rows
    :func:`process_series_range` assigned it): one host-to-device copy a
    shard of this process's devices, a placeholder for each shard of
    another.  No process holds the whole array.  In one process
    ``local_rows`` must be every series (``mesh.shard_series``)."""
    local_rows = np.asarray(local_rows)
    lo, hi = process_series_range(n_series, mesh, axis)
    if local_rows.shape[0] != hi - lo:
        if process_count() == 1:
            raise ValueError(
                f"single-process ingest expects all {n_series} series, "
                f"got {local_rows.shape[0]}")
        raise ValueError(f"process {process_index()} owns series "
                         f"[{lo}, {hi}), got {local_rows.shape[0]} rows")
    devs, ranks = mesh.axis_devices(axis), mesh.axis_ranks(axis)
    n = len(devs)
    block = n_series // n
    me = process_index()
    out = []
    for i, (dev, rank) in enumerate(zip(devs, ranks)):
        rows = local_rows[i * block - lo:(i + 1) * block - lo] \
            if rank == me else None
        if rows is None:
            out.append(meta_like(torch.from_numpy(local_rows[:0]),
                                 (block,) + local_rows.shape[1:]))
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(rows)).to(dev))
    return out
