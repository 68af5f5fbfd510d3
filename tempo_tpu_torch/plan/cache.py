"""Executable cache: built plan executables keyed by (optimized-plan
signature, source shapes/dtypes/devices, mesh).

Counterpart of ``tempo_tpu/plan/cache.py``.  The second run of a
structurally identical chain over same-shape frames reuses the cached
executable: no re-optimization, no engine re-pick, and no new capture,
because an executable keeps the CUDA graphs its device segments
captured (plan/fused.py, plan/stitch.py) and replays them.  Counters
are surfaced through :func:`tempo_tpu_torch.profiling.plan_cache_stats`.

* **single-flight builds** — two callers missing on the same key build
  once: the first claims the key and builds outside the lock, later
  misses wait on its event and then hit the inserted entry (a failed
  build releases the claim, so a waiter retries and builds);
* **per-signature and per-tenant counters** — ``stats()`` breaks the
  totals down by plan signature (``key[0]``) and by the tenant
  installed via :func:`tenant_scope`;
* **graph counters** — ``graph_captures`` (a device segment captured
  into a CUDA graph) and ``graph_replays`` (a captured graph replayed);
  a capture runs the kernel wrappers once (each counts its launch in
  ``ops.cuda_lib.launches``), a replay runs none of them.

The LRU bound is ``TEMPO_TPU_PLAN_CACHE_SIZE`` (default 64; 0 disables
caching).  A second bound is the card's memory: an executable keeps its
CUDA graphs' pools and static inputs alive, so after each run the least recently used
executables are evicted while the graphs held on a card exceed
:data:`GRAPH_MEMORY_SHARE` of its memory.  An evicted executable
releases its graphs, their pools and static tensors, once a replay in
flight has ended, outside the cache's lock.  A shape, dtype or device
change on any source frame is a different key, a miss by design.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import threading
from typing import Dict, Optional

_DEFAULT_SIZE = 64

#: Share of a card's memory that the cached executables' CUDA graphs
#: (pools and static inputs) may hold before the oldest are evicted.
GRAPH_MEMORY_SHARE = 0.5

_TENANT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "tempo_tpu_torch_plan_cache_tenant", default=None)


def max_size() -> int:
    from tempo_tpu_torch import config

    return config.get_int("TEMPO_TPU_PLAN_CACHE_SIZE", _DEFAULT_SIZE)


def device_key(mesh=None, device=None) -> tuple:
    """Hashable device component of an executable cache key: a CUDA graph
    is pinned to the card it was captured on, so the same step on another
    device is another executable.  The single-device form is ``(device
    type, index)`` of ``device`` (default: the current CUDA device when a
    card is present, else the CPU).  A mesh (the cohort engine's sharded
    steps, one graph a mesh entry) keys its axes and sizes and its
    entries' devices, in mesh order: the same step over another mesh, or
    a stream axis of another size, is another executable."""
    import torch

    if mesh is not None:
        devs = []
        for d in mesh.devices.flat:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append((d.type, d.index))
        return ("mesh", tuple(mesh.shape.items()), tuple(devs))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]):
    """Attribute cache traffic inside the block to ``tenant`` (the
    query service wraps each query execution; contextvars make the
    attribution per-thread, so concurrent tenants never mix)."""
    token = _TENANT.set(tenant)
    try:
        yield
    finally:
        _TENANT.reset(token)


@functools.lru_cache(maxsize=None)
def graph_budget(device: str) -> int:
    """Bytes the cached graphs may hold on ``device``."""
    import torch

    total = torch.cuda.get_device_properties(torch.device(device))
    return int(GRAPH_MEMORY_SHARE * total.total_memory)


def _signature_of(key: Optional[tuple]) -> str:
    if isinstance(key, tuple) and key:
        return str(key[0])
    return "uncacheable"


class PlanCache:  # thread-shared
    """Thread-safe LRU of built executables + hit/miss/evict/build
    counters (totals, per-signature, per-tenant) and single-flight
    ``get_or_build``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # guarded-by: self._lock
        self._building: Dict[tuple, threading.Event] = {}  # guarded-by: self._lock
        self.hits = 0  # guarded-by: self._lock
        self.misses = 0  # guarded-by: self._lock
        self.evictions = 0  # guarded-by: self._lock
        # builds: executables constructed (cache misses + uncacheable)
        self.builds = 0  # guarded-by: self._lock
        # uncacheable: runs that bypassed the cache entirely
        self.uncacheable = 0  # guarded-by: self._lock
        self.by_signature: Dict[str, Dict[str, int]] = {}  # guarded-by: self._lock
        self.by_tenant: Dict[str, Dict[str, int]] = {}  # guarded-by: self._lock
        # CUDA graphs: captures of a device segment and their replays
        self.graph_captures = 0  # guarded-by: self._lock
        self.graph_replays = 0  # guarded-by: self._lock

    # -- counter plumbing (callers hold self._lock) ---------------------

    def _bump(self, key: Optional[tuple], field: str) -> None:  # guarded-by: self._lock
        sig = _signature_of(key)
        self.by_signature.setdefault(
            sig, {"hits": 0, "misses": 0, "builds": 0, "evictions": 0})
        self.by_signature[sig][field] += 1
        tenant = _TENANT.get()
        if tenant is not None and field != "evictions":
            self.by_tenant.setdefault(
                tenant, {"hits": 0, "misses": 0, "builds": 0})
            self.by_tenant[tenant][field] += 1

    def _hit_locked(self, key: tuple):  # guarded-by: self._lock
        """LRU-touch + hit bookkeeping for a present entry (caller
        holds the lock) — the ONE hit path shared by :meth:`lookup`
        and :meth:`get_or_build`, so the counters the zero-recompile
        audits read cannot diverge between them."""
        exe = self._entries.get(key)
        if exe is None:
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        self._bump(key, "hits")
        return exe

    def lookup(self, key: Optional[tuple]):
        with self._lock:
            if key is None:
                self.uncacheable += 1
                return None
            exe = self._hit_locked(key)
            if exe is None:
                self.misses += 1
                self._bump(key, "misses")
            return exe

    def peek(self, key: Optional[tuple]):
        """The executable cached under ``key`` (None when absent or
        uncacheable), leaving the LRU order and every counter as they
        are: admission reads the captured graphs' bytes through it."""
        if key is None:
            return None
        with self._lock:
            return self._entries.get(key)

    def _evict_locked(self, key: tuple):  # guarded-by: self._lock
        exe = self._entries.pop(key)
        self.evictions += 1
        self._bump(key, "evictions")
        return exe

    def insert(self, key: Optional[tuple], exe) -> None:
        evicted = []
        with self._lock:
            self.builds += 1
            self._bump(key, "builds")
            if key is None:
                return
            bound = max_size()
            if bound <= 0:
                return
            self._entries[key] = exe
            self._entries.move_to_end(key)
            while len(self._entries) > bound:
                evicted.append(self._evict_locked(next(iter(self._entries))))
        # outside the lock: a release waits for a replay in flight, and a
        # replay counts itself under this lock
        for old in evicted:
            _release(old)

    def trim_graphs(self, keep: Optional[tuple] = None) -> None:
        """Evict the least recently used executables, ``keep`` (the one
        just run) excepted, while the CUDA graphs the cache holds on a
        card exceed :func:`graph_budget`."""
        evicted = []
        with self._lock:
            held = {k: _graph_bytes(e) for k, e in self._entries.items()}
            total: Dict[str, int] = {}
            for per in held.values():
                for d, b in per.items():
                    total[d] = total.get(d, 0) + b
            over = {d for d, b in total.items() if b > graph_budget(d)}
            for k in list(self._entries):                # oldest first
                if not over:
                    break
                if k == keep or not (held[k].keys() & over):
                    continue
                evicted.append(self._evict_locked(k))
                for d, b in held[k].items():
                    total[d] -= b
                    if total[d] <= graph_budget(d):
                        over.discard(d)
        for old in evicted:
            _release(old)

    def get_or_build(self, key: Optional[tuple], build):
        """Cached executable for ``key``, invoking ``build()`` (and
        recording the build) on a miss.  The lookup/insert pair every
        steady-state consumer wants — the serving engine's per-bucket
        step programs and the query service's per-signature executables
        both go through here, so their zero-recompile claims are
        checkable from the same counters
        (``profiling.plan_cache_stats``).

        SINGLE-FLIGHT: concurrent misses on one key serialize on a
        per-key event — exactly one caller builds, the rest wait and
        take the inserted entry as a (late) hit.  A build that raises
        releases the claim before re-raising, so one waiter builds in
        its place instead of every tenant inheriting the failure."""
        if key is None:
            self.lookup(key)         # counts the uncacheable bypass
            exe = build()
            self.insert(key, exe)
            return exe
        while True:
            claimed: Optional[threading.Event] = None
            with self._lock:
                exe = self._hit_locked(key)
                if exe is not None:
                    return exe
                waiting = self._building.get(key)
                if waiting is None:
                    claimed = self._building[key] = threading.Event()
                    self.misses += 1
                    self._bump(key, "misses")
            if claimed is None:
                waiting.wait()
                continue
            try:
                # insert() stays INSIDE the claim window: if it raises
                # (e.g. a malformed cache-size env var), the claim must
                # still release or every waiter on this key hangs
                # forever in wait()
                exe = build()
                self.insert(key, exe)
                return exe
            finally:
                with self._lock:
                    self._building.pop(key, None)
                claimed.set()

    def count_graph(self, field: str) -> None:
        """Count a CUDA-graph ``capture`` or ``replay``."""
        with self._lock:
            if field == "capture":
                self.graph_captures += 1
            else:
                self.graph_replays += 1

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "size": len(self._entries),
                "max_size": max_size(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "builds": self.builds,
                "uncacheable": self.uncacheable,
                "graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "by_signature": {s: dict(c)
                                 for s, c in self.by_signature.items()},
                "by_tenant": {t: dict(c)
                              for t, c in self.by_tenant.items()},
            }

    def clear(self) -> None:
        with self._lock:
            evicted = list(self._entries.values())
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0
            self.builds = self.uncacheable = 0
            self.graph_captures = self.graph_replays = 0
            self.by_signature = {}
            self.by_tenant = {}
        for exe in evicted:
            _release(exe)


def _graph_bytes(exe) -> Dict[str, int]:
    """Bytes an executable's CUDA graphs keep on each card."""
    held = getattr(exe, "graph_bytes", None)
    return held() if held is not None else {}


def _release(exe) -> None:
    """Free what an evicted executable holds on the card (its captured
    graphs, their pools and static tensors)."""
    release = getattr(exe, "release", None)
    if release is not None:
        release()


#: Process-wide executable cache.
CACHE = PlanCache()
