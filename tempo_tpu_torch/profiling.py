"""Whole-chain traces, AS-OF join strategy and engine picks, the
planner's counters and the cost probe of a device segment.

Counterpart of ``tempo_tpu/profiling.py`` (``trace``, ``annotate``,
``pick_asof_strategy``, ``join_engine_override``, ``pick_join_engine``,
``compiled_cost``, ``plan_cache_stats``) and of
``tempo_tpu.resilience.max_merged_lanes``.  ``trace`` records the host
and, with a card present, the card's kernels and copies through
``torch.profiler`` into a Chrome trace; ``annotate`` names a span in it
and is the port's one way to open a span.  The port places its own at
its layer boundaries, named ``tempo.<layer>.<op>[.<phase>]``: the mesh
frame's ops (``tempo.dist.asof_join``, ``.range_stats``, ``.ema``,
``.collect`` and their phases, ``dist.py``) and each kernel launch and
build (``tempo.kernel.<kernel>``, ``tempo.kernel.build``,
``ops/cuda_lib.py``).  They land in the same trace as the card's
records, on its clock; with no profiler active they cost one check.
``pick_join_engine`` honours the planner's hoisted hint
(``plan/hints.py``) and, with the cost model on, takes the cost
argmin (``plan/cost.py``), which reproduces the rule under the default
priors.  ``window_roofline`` is the reference's byte accounting of a
windowed pass against a measured stream rate, copied as it is.

The readers of the compiled contracts (``plan/contracts.py``) stand in
for the reference's readers of optimized HLO:

* :func:`record_program` runs a program once under a
  ``TorchDispatchMode`` and keeps what the HLO would have shown: each
  aten op with the types and shapes of its outputs, each scalar read
  (``aten::_local_scalar_dense``) and copy to the CPU from another
  device, and the moves ``parallel/mesh.transfer`` makes between
  distinct mesh entries, by the collective kind the caller names.  The
  hand-written kernels are ctypes calls the mode does not see, but the
  ``torch.empty`` of their outputs it does.
  :func:`comm_bytes_from_record`, :func:`collective_counts_from_record`
  and :func:`host_transfers_from_record` read it.
* :func:`graph_nodes` walks a captured CUDA graph's nodes through the
  CUDA driver API in ``libcuda.so.1`` (one process has one, while each
  ``.so`` nvcc builds links a runtime of its own) into plain records:
  node type, a memcpy's ends, direction and bytes, a kernel's name.
  :func:`host_transfers_from_graph` reads those.

The reference's ``donated_params_from_compiled`` has no counterpart: a
replay copies each input into the graph's static input, so nothing of a
caller's is ever aliased.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import pandas as pd
import torch

from tempo_tpu_torch import config

logger = logging.getLogger(__name__)

#: the reference's shared bound of how far a measured collective may
#: exceed its model (its ``profiling.COLLECTIVE_TOLERANCE``), copied so
#: the port's contracts judge moves by the same rule
COLLECTIVE_TOLERANCE: Dict[str, float] = {
    "collective-permute": 1.25,
    "all-to-all": 1.25,
    "all-gather": 1.25,
    "all-reduce": 2.0,
}

# reference tsdf.py:482-509: broadcast when either side is under 30 MiB
BROADCAST_BYTES_THRESHOLD = 30 * 1024 * 1024

# merged-lane limit of a single AS-OF program (the reference's measured
# compiler ceiling); past it the chunked engine takes the join
DEFAULT_MAX_MERGED_LANES = 196_608


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile everything inside the block into a Chrome trace JSON under
    ``log_dir`` (``trace_<pid>_<ns>.json``; Perfetto and
    ``chrome://tracing`` load it).  CPU activity is always recorded,
    CUDA kernels and copies too when a card is present.  The block
    yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    block.  ``create_perfetto_link`` (an upload to a hosted viewer in
    the reference) raises ``ValueError``: the trace stays local.

    Usage::

        with profiling.trace("/tmp/tempo-trace"):
            tsdf.asofJoin(other).df
    """
    if create_perfetto_link:
        raise ValueError("create_perfetto_link is not supported: the port "
                         "writes the trace file only and uploads nothing")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


#: what :func:`annotate` gives while no profiler records this thread
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span inside a :func:`trace` block (on the host timeline,
    with the kernels it launches beneath it):
    ``with profiling.annotate("asof-join"): ...``.  While a profiler
    records this thread it is ``torch.profiler.record_function(name)``;
    otherwise one shared no-op context, so a span costs the check alone
    (``record_function`` costs its enter and exit even with nothing
    recording)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def max_merged_lanes() -> int:
    """``TEMPO_TPU_MAX_MERGED_LANES`` or the default; 0/negative
    disables the limit."""
    env = config.get_int("TEMPO_TPU_MAX_MERGED_LANES")
    return DEFAULT_MAX_MERGED_LANES if env is None else env


def host_bytes(df: pd.DataFrame) -> int:
    return int(df.memory_usage(deep=True).sum())


def window_roofline(
    n_rows: int,
    read_bytes_per_row: float,
    write_bytes_per_row: float,
    restream_bytes_per_row: float = 0.0,
    t_iter: Optional[float] = None,
    stream_bytes_per_sec: Optional[float] = None,
    n_cols: int = 1,
    key_bytes_per_row: float = 0.0,
) -> Dict[str, float]:
    """Roofline accounting for a windowed/streaming config: bytes-moved
    vs bytes-minimal, and their fractions of a *measured* stream rate.

    * ``bytes_minimal`` — the compulsory traffic of an ideal
      implementation: every input column read ONCE, every output plane
      written ONCE.  ``minimal_frac`` answers "how close is this config
      to the fastest any implementation could possibly be".
    * ``bytes_moved`` — what the current implementation actually
      streams, including re-streamed intermediates (e.g. a cast or
      scale pass that writes a converted copy the kernel then re-reads:
      ``restream_bytes_per_row``).  ``achieved_frac`` answers "what
      fraction of the machine's stream capability is this config
      driving" — the utilization number the hbm-stream bound compares.
    * ``stream_efficiency`` = minimal/moved — 1.0 means no byte is
      moved twice; below 1.0 quantifies exactly the re-streaming that
      kernel fusion (a scale or jitter passed as a kernel argument
      instead of a converted copy) removes.

    **Column packing** (``n_cols`` > 1): the shared key planes
    (``key_bytes_per_row`` — timestamps/bucket ids) are compulsory
    traffic ONCE per pass, while ``read_bytes_per_row`` /
    ``write_bytes_per_row`` count one *column's* payload and scale by
    ``n_cols``.  An unpacked implementation re-streams the keys per
    column — model that by putting the extra (n_cols-1) x key bytes
    into ``restream_bytes_per_row``; a kernel that reads the keys once
    for all its columns reclaims exactly that term.  ``n_rows`` stays the per-column row count; the
    per-row figures below are per base row.
    """
    per_row_min = key_bytes_per_row + n_cols * (
        read_bytes_per_row + write_bytes_per_row)
    bytes_min = float(n_rows) * per_row_min
    bytes_moved = bytes_min + float(n_rows) * restream_bytes_per_row
    out: Dict[str, float] = {
        "bytes_minimal_per_row": per_row_min,
        "bytes_moved_per_row": bytes_moved / max(n_rows, 1),
        "stream_efficiency": round(bytes_min / max(bytes_moved, 1.0), 3),
    }
    if n_cols > 1:
        out["packed_cols"] = n_cols
    if t_iter and stream_bytes_per_sec:
        out["achieved_frac"] = round(
            bytes_moved / t_iter / stream_bytes_per_sec, 3)
        out["minimal_frac"] = round(
            bytes_min / t_iter / stream_bytes_per_sec, 3)
    return out


def join_engine_override() -> Optional[str]:
    """``TEMPO_TPU_JOIN_ENGINE``: ``single``, ``chunked`` or ``bracket``
    (``vmem`` spells ``single``); unset or unknown means auto."""
    env = (config.get("TEMPO_TPU_JOIN_ENGINE") or "").strip().lower()
    if env == "vmem":
        env = "single"
    return env if env in ("single", "chunked", "bracket") else None


def pick_join_engine(est_lanes: int, limit: int, chunked_ok: bool) -> str:
    """'single' | 'chunked' | 'bracket': one program while the merged
    width fits ``limit``, else the lane-chunked engine, else host time
    brackets.  A plan-time hoisted decision (``plan/hints.py``) wins
    while the planner replays the node, when the freshly probed bounds
    still admit it; ``TEMPO_TPU_JOIN_ENGINE`` forces one; with the cost
    model on the unforced pick is the cost argmin (every engine gives
    the same bits)."""
    from tempo_tpu_torch.plan import hints as plan_hints

    hinted = plan_hints.get("join_engine")
    if hinted == "single" and (limit <= 0 or est_lanes <= limit):
        return "single"
    if hinted == "chunked" and chunked_ok:
        return "chunked"
    if hinted == "bracket":
        return "bracket"
    forced = join_engine_override()
    if forced is not None:
        return forced
    from tempo_tpu_torch.plan import cost as plan_cost

    if plan_cost.enabled():
        return plan_cost.decide_join_engine(est_lanes, limit, chunked_ok)
    if limit <= 0 or est_lanes <= limit:
        return "single"
    return "chunked" if chunked_ok else "bracket"


def pick_asof_strategy(left_df: pd.DataFrame, right_df: pd.DataFrame,
                       sql_join_opt: bool, has_sequence: bool,
                       max_lookback: int) -> str:
    """'broadcast' | 'merge' | 'searchsorted', the reference's decision
    tree (tsdf.py:482-509); ``maxLookback`` wins over broadcast."""
    if max_lookback and max_lookback > 0:
        if sql_join_opt:
            logger.warning(
                "asofJoin: sql_join_opt is ignored when maxLookback is "
                "set — the broadcast fast path cannot bound lookback")
        return "merge"
    if sql_join_opt and (
        host_bytes(left_df) < BROADCAST_BYTES_THRESHOLD
        or host_bytes(right_df) < BROADCAST_BYTES_THRESHOLD
    ):
        return "broadcast"
    if has_sequence:
        return "merge"
    return "searchsorted"


def plan_cache_stats() -> Dict[str, object]:
    """Counters of the planner's executable cache (``plan/cache.py``;
    LRU bound ``TEMPO_TPU_PLAN_CACHE_SIZE``): hits, misses, evictions,
    builds, the ``by_signature`` and ``by_tenant`` breakdowns, and the
    CUDA graphs captured (``graph_captures``) and replayed
    (``graph_replays``).  A steady-state query mix should be all hits
    and replays: a miss re-runs the optimizer, a capture re-records a
    graph."""
    from tempo_tpu_torch.plan.cache import CACHE

    return CACHE.stats()


def compiled_cost(fn, *args) -> Dict[str, Optional[float]]:
    """What the card states of ``fn(*args)`` (tensors in, a sequence of
    tensors out), under the reference's keys: ``argument_bytes`` and
    ``output_bytes``, and, for CUDA tensors, ``temp_bytes``, the bytes
    the private pool of a CUDA graph of the call takes (captured after
    one warm-up run, then dropped).  The reference reads XLA's compiled
    cost and memory analysis; a CUDA graph states no flop count, so
    ``flops``, ``bytes_accessed`` and ``generated_code_bytes`` stay
    None, as the reference leaves a key a backend does not report."""
    out: Dict[str, Optional[float]] = {
        "flops": None,
        "bytes_accessed": None,
        "output_bytes": None,
        "temp_bytes": None,
        "argument_bytes": None,
        "generated_code_bytes": None,
    }
    if fn is None:
        return out
    nbytes = lambda ts: int(sum(t.numel() * t.element_size() for t in ts
                                if isinstance(t, torch.Tensor)))
    out["argument_bytes"] = nbytes(args)
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    if dev.type != "cuda":
        out["output_bytes"] = nbytes(fn(*args))
        return out
    from tempo_tpu_torch.plan.fused import capture

    graph = capture(None, dev, fn, args)
    out["temp_bytes"] = graph.pool_bytes
    out["output_bytes"] = nbytes(graph.static_out)
    graph.free()
    return out


# ----------------------------------------------------------------------
# The dispatch record of one program run (the compiled contracts' input)
# ----------------------------------------------------------------------

class ProgramRecord:
    """What one run of a program did, as :func:`record_program` saw it:
    ``ops`` (aten op name, ``((dtype, shape), ...)`` of its tensor
    outputs), ``host_reads`` (one line a scalar read or copy to the CPU
    from another device) and ``transfers`` (``(kind, bytes)`` of each
    move between distinct mesh entries)."""

    def __init__(self):
        self.ops: List[tuple] = []
        self.host_reads: List[str] = []
        self.transfers: List[tuple] = []


_ACTIVE = threading.local()


def active_record() -> Optional[ProgramRecord]:
    """The record this thread is filling, None outside
    :func:`record_program`."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def note_transfer(kind: str, nbytes: int) -> None:
    """Add one move between distinct mesh entries to the active record
    (``parallel/mesh.transfer`` calls it)."""
    rec = active_record()
    if rec is not None:
        rec.transfers.append((kind, int(nbytes)))


def _outputs(out) -> tuple:
    if isinstance(out, torch.Tensor):
        return ((str(out.dtype).replace("torch.", ""), tuple(out.shape)),)
    if isinstance(out, (list, tuple)):
        return tuple(o for x in out for o in _outputs(x))
    return ()


def _host_read(func, args, kwargs) -> Optional[str]:
    aten = torch.ops.aten
    if func is aten._local_scalar_dense.default:
        t = args[0]
        return f"aten::_local_scalar_dense of {t.dtype} on {t.device}"
    if func is aten._to_copy.default:
        src, dst = args[0], kwargs.get("device")
        if dst is not None and torch.device(dst).type == "cpu" \
                and src.device.type != "cpu":
            return (f"aten::_to_copy {src.device} -> cpu "
                    f"{tuple(src.shape)} {src.dtype}")
    if func is aten.copy_.default:
        dst, src = args[0], args[1]
        if dst.device.type == "cpu" and isinstance(src, torch.Tensor) \
                and src.device.type != "cpu":
            return (f"aten::copy_ {src.device} -> cpu "
                    f"{tuple(src.shape)} {src.dtype}")
    return None


def _record_mode(rec: ProgramRecord):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            read = _host_read(func, args, kwargs)
            if read is not None:
                rec.host_reads.append(read)
            out = func(*args, **kwargs)
            rec.ops.append((str(func), _outputs(out)))
            return out

    return _Mode()


@contextlib.contextmanager
def record_program():
    """Record the aten ops, host reads and mesh moves of the block on
    this thread into the :class:`ProgramRecord` it yields.  Run a
    program once under it, at its contract shape: on the card the
    block's ops are those a capture of it would record."""
    rec = ProgramRecord()
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(rec)
    try:
        with _record_mode(rec):
            yield rec
    finally:
        stack.pop()


def comm_bytes_from_record(rec: ProgramRecord) -> Dict[str, int]:
    """Bytes moved between distinct mesh entries in the recorded run, by
    the kind the moving code names (the counterpart of the reference's
    ``comm_bytes_from_compiled``, which sums each collective's per-shard
    result bytes: here each move counts once, its logical bytes, even
    when both entries are one device)."""
    out: Dict[str, int] = {}
    for kind, nbytes in rec.transfers:
        out[kind] = out.get(kind, 0) + nbytes
    return out


def collective_counts_from_record(rec: ProgramRecord) -> Dict[str, int]:
    """Moves between distinct mesh entries in the recorded run, by kind
    (the counterpart of ``collective_counts_from_compiled``)."""
    out: Dict[str, int] = {}
    for kind, _ in rec.transfers:
        out[kind] = out.get(kind, 0) + 1
    return out


def host_transfers_from_record(rec: ProgramRecord) -> List[str]:
    """The recorded run's scalar reads and copies to the CPU from
    another device, empty for a program that never waits on the host.
    On the CPU a scalar read still counts: on the card the same line is
    a device-to-host copy and a synchronisation."""
    return list(rec.host_reads)


def f64_ops_from_record(rec: ProgramRecord) -> List[str]:
    """The recorded ops with a float64 output of at least one dimension
    (a 0-d float64 is tolerated, as the reference tolerates ``f64[]``)."""
    return [f"{name} -> float64{list(shape)}" for name, outs in rec.ops
            for dtype, shape in outs if dtype == "float64" and shape]


# ----------------------------------------------------------------------
# The nodes of a captured CUDA graph (libcuda)
# ----------------------------------------------------------------------

_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")
_MEMORY_HOST, _MEMORY_DEVICE, _MEMORY_ARRAY, _MEMORY_UNIFIED = 1, 2, 3, 4
_POINTER_MEMORY_TYPE = 2


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` (cuda.h)."""

    _end = [("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t),
            ("Z", ctypes.c_size_t), ("LOD", ctypes.c_size_t),
            ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
            ("Device", ctypes.c_uint64), ("Array", ctypes.c_void_p),
            ("reserved", ctypes.c_void_p), ("Pitch", ctypes.c_size_t),
            ("Height", ctypes.c_size_t)]
    _fields_ = ([("src" + n, t) for n, t in _end]
                + [("dst" + n, t) for n, t in _end]
                + [("WidthInBytes", ctypes.c_size_t),
                   ("Height", ctypes.c_size_t), ("Depth", ctypes.c_size_t)])


class _KernelParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("sharedMemBytes", ctypes.c_uint),
                ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_P = ctypes.c_void_p
_LIBCUDA_SYMBOLS = {
    "cuGraphGetNodes": (_P, _P, ctypes.POINTER(ctypes.c_size_t)),
    "cuGraphNodeGetType": (_P, ctypes.POINTER(ctypes.c_int)),
    "cuGraphMemcpyNodeGetParams": (_P, ctypes.POINTER(_Memcpy3D)),
    "cuGraphKernelNodeGetParams_v2": (_P, ctypes.POINTER(_KernelParams)),
    "cuGraphChildGraphNodeGetGraph": (_P, ctypes.POINTER(_P)),
    "cuKernelGetFunction": (ctypes.POINTER(_P), _P),
    "cuFuncGetName": (ctypes.POINTER(ctypes.c_char_p), _P),
    "cuPointerGetAttribute": (_P, ctypes.c_int, ctypes.c_uint64),
    "cuGetErrorString": (ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)),
}
_LIBCUDA = None


def _libcuda():
    """``libcuda.so.1`` with the graph-walk symbols bound; raises if the
    library or a symbol is missing (``cuFuncGetName`` needs CUDA 12.3
    or later)."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name, argtypes in _LIBCUDA_SYMBOLS.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        _LIBCUDA = lib
    return _LIBCUDA


def _check(lib, rc: int, what: str) -> None:
    if rc:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUresult {rc} "
                           f"({(msg.value or b'?').decode()})")


def _memory_kind(lib, declared: int, host, device) -> str:
    """'device', 'pinned' (page-locked host) or 'host' (pageable) of one
    memcpy end: the declared type, resolved through the pointer's own
    attributes where the copy was issued with kind ``Default``."""
    if declared == _MEMORY_ARRAY:
        return "array"
    ptr = host if declared == _MEMORY_HOST else device
    kind = ctypes.c_uint(0)
    rc = lib.cuPointerGetAttribute(ctypes.byref(kind), _POINTER_MEMORY_TYPE,
                                   int(ptr or 0))
    if rc:                       # unknown to CUDA: pageable memory
        return "host"
    return {_MEMORY_HOST: "pinned", _MEMORY_DEVICE: "device"}.get(
        kind.value, "device")


def _walk(lib, graph: int, out: List[dict]) -> None:
    n = ctypes.c_size_t(0)
    _check(lib, lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib, lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        _check(lib, lib.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        kind = (_NODE_TYPES[t.value] if 0 <= t.value < len(_NODE_TYPES)
                else f"type{t.value}")
        rec = {"type": kind}
        if kind == "kernel":
            p = _KernelParams()
            _check(lib, lib.cuGraphKernelNodeGetParams_v2(
                node, ctypes.byref(p)), "cuGraphKernelNodeGetParams")
            func = ctypes.c_void_p(p.func)
            if not p.func and p.kern:
                _check(lib, lib.cuKernelGetFunction(ctypes.byref(func),
                                                    p.kern),
                       "cuKernelGetFunction")
            name = ctypes.c_char_p()
            _check(lib, lib.cuFuncGetName(ctypes.byref(name), func),
                   "cuFuncGetName")
            rec["name"] = (name.value or b"").decode()
        elif kind == "memcpy":
            p = _Memcpy3D()
            _check(lib, lib.cuGraphMemcpyNodeGetParams(node,
                                                       ctypes.byref(p)),
                   "cuGraphMemcpyNodeGetParams")
            src = _memory_kind(lib, p.srcMemoryType, p.srcHost, p.srcDevice)
            dst = _memory_kind(lib, p.dstMemoryType, p.dstHost, p.dstDevice)
            side = lambda k: "D" if k in ("device", "array") else "H"
            rec.update(src=src, dst=dst,
                       direction=f"{side(src)}to{side(dst)}",
                       bytes=int(p.WidthInBytes * max(p.Height, 1)
                                 * max(p.Depth, 1)))
        elif kind == "graph":
            child = ctypes.c_void_p()
            _check(lib, lib.cuGraphChildGraphNodeGetGraph(
                node, ctypes.byref(child)), "cuGraphChildGraphNodeGetGraph")
            _walk(lib, child.value, out)
        out.append(rec)


def graph_nodes(graph) -> List[dict]:
    """Plain records of a captured graph's nodes (a
    ``torch.cuda.CUDAGraph`` captured with ``keep_graph=True``, as
    ``plan/fused.capture`` captures, or a ``plan.fused.Captured``), child
    graphs walked in place: ``{"type": "kernel", "name": ...}``,
    ``{"type": "memcpy", "src", "dst", "direction", "bytes"}`` (ends
    ``device``, ``pinned`` or ``host``), ``{"type": "host"}`` for a host
    callback, and CUDA's other node types by name.  Raises when
    ``libcuda.so.1`` or a symbol is missing."""
    cuda_graph = getattr(graph, "graph", graph)
    lib = _libcuda()
    out: List[dict] = []
    _walk(lib, int(cuda_graph.raw_cuda_graph()), out)
    return out


def host_transfers_from_graph(nodes: Sequence[dict]) -> List[str]:
    """The graph's nodes that touch the host: a memcpy with a pageable or
    pinned end, and a host (callback) node.  Device-to-device copies
    and memsets are fine."""
    out = []
    for n in nodes:
        if n["type"] == "host":
            out.append("host callback node")
        elif n["type"] == "memcpy" and "H" in n["direction"]:
            out.append(f"memcpy {n['direction']} {n['src']} -> {n['dst']} "
                       f"{n['bytes']} B")
    return out


def graph_summary(nodes: Sequence[dict]) -> Dict[str, object]:
    """Node counts by type, kernel names (each once, in first-seen
    order) and memcpy bytes by direction of a walked graph."""
    counts: Dict[str, int] = {}
    names: List[str] = []
    copies: Dict[str, int] = {}
    for n in nodes:
        counts[n["type"]] = counts.get(n["type"], 0) + 1
        if n["type"] == "kernel" and n["name"] not in names:
            names.append(n["name"])
        if n["type"] == "memcpy":
            copies[n["direction"]] = copies.get(n["direction"], 0) \
                + n["bytes"]
    return {"nodes": counts, "kernels": names, "memcpy_bytes": copies}


def short_kernel_name(name: str) -> str:
    """The kernel's own identifier out of its mangled name (the last
    name of a nested name, e.g. ``ema_scan_kernel`` of
    ``_ZN44_GLOBAL__N__..._ema_scan_cu_...15ema_scan_kernelIfEEv...``);
    the name as it is when it is not mangled."""
    if not name.startswith("_Z"):
        return name
    nested = name.startswith("_ZN")
    i, last = (3 if nested else 2), name
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        last, i = name[j:j + n], j + n
        if not nested:
            break
    return last
