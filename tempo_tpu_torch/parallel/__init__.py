"""Distribution layer of the port: device meshes, layouts, halo
exchange and several processes.

Counterpart of ``tempo_tpu/parallel/``:

* **series axis (data parallel)**: packed ``[K, L]`` arrays cut along K
  into one shard a device of the mesh's ``series`` axis; every
  per-series op runs on each shard, on its device, with no
  communication (the analog of Spark routing each key to one task).
* **time axis (sequence parallel)**: for series too long for one
  device, the time axis is cut too (``[K/n_s, L/n_t]`` blocks), and
  rolling windows, the EMA carry and the AS-OF join read their history
  from neighbouring blocks (``halo.py``): the reference's
  ``tsPartitionVal`` fraction-overlap brackets as a neighbour exchange.
  ``reshard.py`` switches a frame between that layout and the
  series-local one (whole rows over every device) with a tiled
  all-to-all.
* **several processes** (``multihost.py``): ``torch.distributed`` over
  gloo (CPU) or NCCL (cards); each mesh entry knows its owner rank, a
  process uploads and computes only its own shards, and blocks and
  host arrays cross processes over the process group.
"""

from tempo_tpu_torch.parallel.halo import (
    asof_time_sharded,
    ema_time_sharded,
    range_stats_time_sharded,
)
from tempo_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    device_guard,
    make_mesh,
    pad_series_axis,
    series_sharding,
    shard_map,
    shard_series,
    unzip,
)
from tempo_tpu_torch.parallel.multihost import (
    distributed_init,
    process_mesh,
    process_series_range,
    shard_series_global,
)
from tempo_tpu_torch.parallel.reshard import (
    all_to_all_series_to_time,
    all_to_all_time_to_series,
    reshard,
)

__all__ = [
    "reshard",
    "all_to_all_series_to_time",
    "all_to_all_time_to_series",
    "make_mesh",
    "series_sharding",
    "shard_series",
    "pad_series_axis",
    "range_stats_time_sharded",
    "asof_time_sharded",
    "ema_time_sharded",
    "distributed_init",
    "process_mesh",
    "process_series_range",
    "shard_series_global",
    "Mesh",
    "default_mesh",
    "device_guard",
    "shard_map",
    "unzip",
]
