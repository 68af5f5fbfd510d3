"""Distribution layer of the port: device meshes and the series axis.

Counterpart of ``tempo_tpu/parallel/``, so far its series axis (data
parallel): packed ``[K, L]`` arrays split along K into one shard a
device of the mesh's ``series`` axis, and every per-series op runs on
each shard, on that shard's device, with no communication (the analog
of Spark routing each key to one task).  The time axis (``halo.py``,
``reshard.py``) and multi-process placement (``multihost.py``) are not
ported.
"""

from tempo_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    device_guard,
    make_mesh,
    pad_series_axis,
    shard_map,
    unzip,
)

__all__ = ["Mesh", "default_mesh", "device_guard", "make_mesh",
           "pad_series_axis", "shard_map", "unzip"]
