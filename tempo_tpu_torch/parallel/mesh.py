"""Device meshes, shard layouts and the moves between shards.

Counterpart of ``tempo_tpu/parallel/mesh.py``.  Replaces the role of
Spark's cluster manager and hash partitioner (the reference's
``Window.partitionBy(partition_cols)`` routes each key's rows to one
task): packed ``[K, L]`` arrays are cut into one block a device of the
mesh.  A layout is a spec, one entry a dimension, as JAX's
``PartitionSpec``: ``None`` (whole), an axis name, or a tuple of axis
names (a joint axis, flattened series-major as JAX flattens
``P((series, time))``).  The shards of an array are a flat list over the
spec's axes in that order:

* ``("series", None)``: one block of rows a device of the ``series``
  axis (the layout of every per-series op, with no communication);
* ``("series", "time")``: a ``[K/n_s, L/n_t]`` block a device, the
  time-sharded layout of ``parallel/halo.py``;
* ``(("series", "time"), None)``: whole rows, K cut over every device
  (the series-local layout a time-sharded frame switches to,
  ``parallel/reshard.py``).

A mesh may name one device several times (``["cpu"] * 4`` or
``["cuda:0", "cuda:0"]``): the shard logic then runs in full on one
device, the counterpart of the JAX tests' virtual 8-device CPU host.
Each entry of a mesh also records the ``torch.distributed`` rank that
owns it (``Mesh.ranks``, all 0 in one process).  A process computes
only its own shards; another process's shard is a ``meta`` tensor of
the same shape and type, and :func:`transfer` moves blocks between
processes over the process group (CPU tensors through gloo, card
tensors through NCCL).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch import device as device_policy

Axis = Union[str, Tuple[str, ...]]


def process_index() -> int:
    """This process's ``torch.distributed`` rank (0 without a process
    group)."""
    d = torch.distributed
    return d.get_rank() if d.is_available() and d.is_initialized() else 0


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    d = torch.distributed
    return (d.get_world_size() if d.is_available() and d.is_initialized()
            else 1)


def _axes_of(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """An n-dimensional array of ``torch.device``s with named axes (the
    counterpart of ``jax.sharding.Mesh``); ``ranks`` holds the owner
    process of each entry."""

    def __init__(self, device_array: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None):
        arr = np.asarray(device_array, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(arr.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_size(self, axis: Axis) -> int:
        """Size of an axis, or the product over a joint axis."""
        return int(np.prod([self.shape[a] for a in _axes_of(axis)]))

    def _along(self, arr: np.ndarray, axis: Axis) -> list:
        idx = [self.axis_names.index(a) for a in _axes_of(axis)]
        rest = [i for i in range(arr.ndim) if i not in idx]
        n = self.axis_size(axis)
        return list(np.transpose(arr, idx + rest).reshape(n, -1)[:, 0])

    def axis_devices(self, axis: Axis) -> List[torch.device]:
        """The devices along ``axis`` (a name, or a tuple of names: the
        joint axis, series-major), the other axes at index 0: the
        devices of the shards of an array sharded over ``axis`` alone
        (replicated over the other axes)."""
        return self._along(self.devices, axis)

    def axis_ranks(self, axis: Axis) -> List[int]:
        """The owner ranks of :meth:`axis_devices`' entries."""
        return [int(r) for r in self._along(self.ranks, axis)]

    def axis_entries(self, axis: Axis) -> List[int]:
        """The flat indices into ``devices`` of :meth:`axis_devices`'
        entries: which mesh entry a shard is, even where several entries
        name one device."""
        idx = np.arange(self.devices.size).reshape(self.devices.shape)
        return [int(i) for i in self._along(idx, axis)]

    @property
    def n_processes(self) -> int:
        return len(set(int(r) for r in self.ranks.flat))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        ranks = "" if self.n_processes == 1 else \
            f", ranks={[int(r) for r in self.ranks.flat]}"
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{ranks})")


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a :class:`Mesh`.

    ``axes`` maps axis name -> size, e.g. ``{"series": 2, "time": 4}``;
    ``devices`` lists the devices (names or ``torch.device``s, repeats
    allowed), ``ranks`` their owner processes (default all 0;
    ``multihost.process_mesh`` fills them from the process group).
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
    rk = None if ranks is None else np.asarray(list(ranks)[:n], np.int64)
    return Mesh(arr.reshape(shape), tuple(axes.keys()),
                None if rk is None else rk.reshape(shape))


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


# ----------------------------------------------------------------------
# Layouts: specs, blocks, placement
# ----------------------------------------------------------------------

def spec_axes(spec: Sequence) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in spec order: the order of its
    flat shard list."""
    out: List[str] = []
    for e in spec:
        if e is not None:
            out.extend(_axes_of(e))
    return tuple(out)


def block_slices(mesh: Mesh, spec: Sequence, shape: Sequence[int]
                 ) -> List[Tuple[slice, ...]]:
    """Each shard's block of a global array of ``shape`` under ``spec``
    (leading dimensions past the spec's length are whole), in the flat
    shard order."""
    axes = spec_axes(spec)
    sizes = [mesh.shape[a] for a in axes]
    lead = len(shape) - len(spec)
    out = []
    for f in range(int(np.prod(sizes)) if axes else 1):
        coord = dict(zip(axes, np.unravel_index(f, sizes))) if axes else {}
        sl = [slice(0, shape[d]) for d in range(lead)]
        for d, e in enumerate(spec):
            n = shape[lead + d]
            if e is None:
                sl.append(slice(0, n))
                continue
            sub = _axes_of(e)
            parts = [mesh.shape[a] for a in sub]
            idx = int(np.ravel_multi_index([coord[a] for a in sub], parts))
            k = int(np.prod(parts))
            if n % k:
                raise ValueError(f"dimension {n} does not divide over "
                                 f"{sub} ({k} shards)")
            sl.append(slice(idx * (n // k), (idx + 1) * (n // k)))
        out.append(tuple(sl))
    return out


def meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    """A ``meta`` placeholder of ``t``'s type (and its shape, or
    ``shape``): another process's shard."""
    return torch.empty(t.shape if shape is None else tuple(shape),
                       dtype=t.dtype, device="meta")


def is_local(t) -> bool:
    """Whether a shard holds data in this process (not a placeholder)."""
    return not (isinstance(t, torch.Tensor) and t.device.type == "meta")


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def upload_planes(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Host arrays -> tensors on ``device`` with ONE host-to-device copy:
    their bytes concatenated (widest types first, so every plane starts
    at a multiple of its item size), copied, and viewed back."""
    order = sorted(range(len(arrays)), key=lambda i: -arrays[i].itemsize)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    buf = np.concatenate([arrays[i].reshape(-1).view(np.uint8)
                          for i in order]) if arrays else np.zeros(0, np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out: List[Optional[torch.Tensor]] = [None] * len(arrays)
    off = 0
    for i in order:
        a = arrays[i]
        out[i] = dev[off:off + a.nbytes].view(
            _torch_dtype(a.dtype)).reshape(a.shape)
        off += a.nbytes
    return out


def place_planes(planes: Sequence[np.ndarray], mesh: Mesh, spec: Sequence
                 ) -> List[List[torch.Tensor]]:
    """Global host planes of one shape cut into the shards of ``spec``
    on ``mesh``: for each shard (flat order) its planes' blocks, with one
    host-to-device copy a shard of this process and placeholders for a
    shard of another (the counterpart of ``jax.device_put`` with a
    ``NamedSharding``)."""
    axes = spec_axes(spec)
    devs = mesh.axis_devices(axes) if axes else [mesh.devices.flat[0]]
    ranks = mesh.axis_ranks(axes) if axes else [int(mesh.ranks.flat[0])]
    me = process_index()
    out = []
    for sl, dev, rank in zip(block_slices(mesh, spec, planes[0].shape),
                             devs, ranks):
        blocks = [p[sl] for p in planes]
        if rank == me:
            out.append(upload_planes(blocks, dev))
        else:
            out.append([torch.empty(b.shape, dtype=_torch_dtype(b.dtype),
                                    device="meta") for b in blocks])
    return out


def place(arr: np.ndarray, mesh: Mesh, spec: Sequence) -> List[torch.Tensor]:
    """One host array cut into the shards of ``spec``
    (:func:`place_planes`)."""
    return [p[0] for p in place_planes([np.asarray(arr)], mesh, spec)]


def series_sharding(mesh: Mesh, ndim: int = 2, axis: str = "series"
                    ) -> Tuple:
    """The spec that splits the leading (series) axis only (the
    counterpart of the reference's ``NamedSharding`` of
    ``P(axis, None, ...)``)."""
    return (axis,) + (None,) * (ndim - 1)


def shard_series(arr: np.ndarray, mesh: Mesh, axis: str = "series"
                 ) -> List[torch.Tensor]:
    """Place an array on the mesh sharded along its leading axis: the
    host-to-device scatter of the ingest boundary (Spark's shuffle on
    the partition columns)."""
    return place(np.asarray(arr), mesh, series_sharding(mesh, np.ndim(arr),
                                                        axis))


# ----------------------------------------------------------------------
# Moves between shards, within a process and across processes
# ----------------------------------------------------------------------

def _wire_device() -> torch.device:
    """Where tensors cross the process group: the CPU under gloo, the
    current card under NCCL."""
    d = torch.distributed
    if d.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def transfer(moves: Sequence[Tuple[torch.Tensor, int, torch.device, int]],
             kind: Optional[str] = None,
             entries: Optional[Sequence[Tuple[int, int]]] = None
             ) -> List[torch.Tensor]:
    """Move tensors between the devices of a mesh: each move is
    ``(tensor, source rank, destination device, destination rank)``,
    the tensor real on the source process (a placeholder elsewhere).
    ``kind`` names the collective the moves stand for (``all-gather``,
    ``all-to-all``, ``collective-permute``) and ``entries`` gives each
    move's (source, destination) mesh entry (:meth:`Mesh.axis_entries`):
    with both, each move between two distinct entries adds its bytes to
    the active ``profiling.record_program`` record, even where both
    entries are one device and nothing moves physically; a move within
    one entry adds nothing.
    Returns each tensor on its destination device where this process is
    the destination, a placeholder elsewhere.  Within a process a move
    is ``tensor.to(device)``, issued on the current stream of the
    source's device (on one device it is the tensor itself); across
    processes every send and receive is posted at once
    (``isend``/``irecv``, tagged by the move's index, so the processes,
    which all build the same list, match them) and then awaited."""
    if kind is not None and entries is not None:
        from tempo_tpu_torch import profiling

        if profiling.active_record() is not None:
            for (t, *_), (src_e, dst_e) in zip(moves, entries):
                if src_e != dst_e:
                    profiling.note_transfer(kind,
                                            t.numel() * t.element_size())
    me = process_index()
    out: List[Optional[torch.Tensor]] = [None] * len(moves)
    pending, recvs, keep = [], [], []
    for i, (t, src, dst_dev, dst) in enumerate(moves):
        if src == me and dst == me:
            with device_guard(t.device):
                out[i] = t.to(dst_dev)
        elif dst != me and src != me:
            out[i] = meta_like(t)
        elif t.numel() == 0:
            out[i] = (torch.empty(t.shape, dtype=t.dtype, device=dst_dev)
                      if dst == me else meta_like(t))
        elif src == me:
            wire = t.contiguous().reshape(-1).view(torch.uint8).to(
                _wire_device())
            keep.append(wire)
            pending.append(torch.distributed.isend(wire, dst, tag=i))
            out[i] = meta_like(t)
        else:
            buf = torch.empty(t.numel() * t.element_size(),
                              dtype=torch.uint8, device=_wire_device())
            pending.append(torch.distributed.irecv(buf, src, tag=i))
            recvs.append((i, buf, t, dst_dev))
    for r in pending:
        r.wait()
    for i, buf, t, dst_dev in recvs:
        out[i] = buf.view(t.dtype).reshape(t.shape).to(dst_dev)
    return out


def host_gather(per_shard: Sequence[Optional[np.ndarray]],
                ranks: Sequence[int], nbytes: Sequence[int]
                ) -> List[np.ndarray]:
    """Every shard's host bytes (a flat ``uint8`` array, None where
    another process holds it) on every process: one broadcast from the
    owner a shard over the process group; a no-op in one process."""
    me = process_index()
    if process_count() == 1:
        return list(per_shard)
    out = []
    for buf, rank, n in zip(per_shard, ranks, nbytes):
        if rank == me:
            t = torch.from_numpy(np.ascontiguousarray(buf)).to(_wire_device())
        else:
            t = torch.empty(int(n), dtype=torch.uint8, device=_wire_device())
        if n:
            torch.distributed.broadcast(t, src=int(rank))
        out.append(t.cpu().numpy())
    return out


# ----------------------------------------------------------------------
# shard_map
# ----------------------------------------------------------------------

def _placeholder(tree):
    """``tree`` (a shard's results) with every tensor a meta tensor."""
    if isinstance(tree, torch.Tensor):
        return meta_like(tree)
    if isinstance(tree, dict):
        return {k: _placeholder(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placeholder(v) for v in tree)
    return tree


def shard_map(fn: Callable, mesh: Mesh, *shards, axis: Axis = "series"
              ) -> list:
    """The counterpart of ``shard_map``: call ``fn`` once a shard of
    ``mesh``'s ``axis`` (a name or a joint tuple), on the i-th element
    of every sequence in ``shards`` (one per shard), inside that shard's
    device guard.  Returns the per-shard results in shard order.  Only
    this process's shards run; each shard of another process gets a
    placeholder shaped like this process's first result (the shards of a
    layout have equal shapes)."""
    devs = mesh.axis_devices(axis)
    ranks = mesh.axis_ranks(axis)
    for s in shards:
        if len(s) != len(devs):
            raise ValueError(f"{len(s)} shards for {len(devs)} devices")
    me = process_index()
    out, template = [], None
    for i, dev in enumerate(devs):
        if ranks[i] != me:
            out.append(None)
            continue
        with device_guard(dev):
            out.append(fn(*(s[i] for s in shards)))
        if template is None:
            template = out[-1]
    if any(r != me for r in ranks):
        if template is None:
            raise ValueError(f"process {me} holds no shard of axis "
                             f"{axis!r}")
        out = [_placeholder(template) if r != me else o
               for o, r in zip(out, ranks)]
    return out


def unzip(results: list):
    """Per-shard tuples -> a tuple of per-shard lists (per-shard dicts
    -> a dict of per-shard lists)."""
    if results and isinstance(results[0], dict):
        return {k: [r[k] for r in results] for k in results[0]}
    return tuple(list(t) for t in zip(*results))
