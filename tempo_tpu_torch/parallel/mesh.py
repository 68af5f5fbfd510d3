"""Device meshes and series-axis sharding.

Counterpart of ``tempo_tpu/parallel/mesh.py``.  Replaces the role of
Spark's cluster manager and hash partitioner (the reference's
``Window.partitionBy(partition_cols)`` routes each key's rows to one
task): packed ``[K, L]`` arrays are cut along the leading (series) axis
into one contiguous block of rows a device of the mesh's ``series``
axis.  Per-series kernels need nothing from other rows, so each shard
runs on its own device without communication.

A mesh may name one device several times (``["cpu"] * 4`` or
``["cuda:0", "cuda:0"]``): the shard logic then runs in full on one
device, the counterpart of the JAX tests' virtual 8-device CPU host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tempo_tpu_torch import device as device_policy


class Mesh:
    """An n-dimensional array of ``torch.device``s with named axes (the
    counterpart of ``jax.sharding.Mesh``)."""

    def __init__(self, device_array: np.ndarray, axis_names: Sequence[str]):
        arr = np.asarray(device_array, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at index 0: the
        devices of the shards of an array sharded over ``axis`` alone
        (replicated over the other axes)."""
        i = self.axis_names.index(axis)
        arr = np.moveaxis(self.devices, i, 0).reshape(self.devices.shape[i],
                                                      -1)
        return list(arr[:, 0])

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a :class:`Mesh`.

    ``axes`` maps axis name -> size, e.g. ``{"series": 4}``; ``devices``
    lists the devices (names or ``torch.device``s, repeats allowed).
    Defaults: every visible CUDA device on one ``('series',)`` axis.
    Asking for CUDA where there is none raises, as the frame's device
    policy does."""
    if devices is None:
        device_policy.resolve("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [device_policy.resolve(d) for d in devices]
    if axes is None:
        axes = {"series": len(devs)}
    shape = tuple(int(v) for v in axes.values())
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, only {len(devs)} "
                         f"available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), tuple(axes.keys()))


def default_mesh(device) -> Mesh:
    """The mesh ``TSDF.on_mesh()`` takes when it is given none.  As the
    reference's (``tempo_tpu/frame.py``: a 1-D ``('series',)`` mesh over
    every local device), a CUDA frame's is :func:`make_mesh` over every
    visible card; a CPU frame keeps one shard on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return make_mesh()
    return Mesh(np.array([dev], dtype=object), ("series",))


def pad_series_axis(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading axis to a multiple of ``n_shards`` so a [K, L]
    batch divides evenly across the mesh.  Padded series are all-padding
    rows; kernels ignore them through their validity masks (the analog
    of Spark having some idle tasks)."""
    K = arr.shape[0]
    rem = (-K) % n_shards
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def device_guard(device: torch.device):
    """``device`` as the current CUDA device for the block (nothing for
    a CPU device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_map(fn: Callable, mesh: Mesh, *shards, axis: str = "series"
              ) -> list:
    """The series-axis counterpart of ``shard_map``: call ``fn`` once a
    shard of ``mesh``'s ``axis``, on the i-th element of every sequence
    in ``shards`` (one per shard), inside that shard's device guard.
    Returns the per-shard results in shard order."""
    devs = mesh.axis_devices(axis)
    for s in shards:
        if len(s) != len(devs):
            raise ValueError(f"{len(s)} shards for {len(devs)} devices")
    out = []
    for i, dev in enumerate(devs):
        with device_guard(dev):
            out.append(fn(*(s[i] for s in shards)))
    return out


def unzip(results: list):
    """Per-shard tuples -> a tuple of per-shard lists (per-shard dicts
    -> a dict of per-shard lists)."""
    if results and isinstance(results[0], dict):
        return {k: [r[k] for r in results] for k in results[0]}
    return tuple(list(t) for t in zip(*results))
