"""The mesh ``asofJoin -> withRangeStats [-> EMA]`` chain as one CUDA
graph, and the capture machinery the stitched chains share.

Counterpart of ``tempo_tpu/plan/fused.py``, which traces the chain's
shard-local kernels into one jitted XLA program.  Here the optimizer's
``fused_asof_stats_ema`` node runs in two parts:

* **host preparation**, every call, outside the graph: the run-time
  guards, the key permutation (``dist._key_perm``), the range-engine
  choice (``_range_engine_choice``) and the right side's payload and
  validity stacks aligned to the left's series (``dist._align_rows``);
* **the device part**, a function of each shard's tensors that calls
  the same kernel wrappers the eager ops call, in the same order, on
  the same inputs: the merge join (row 1), range stats (row 2, the form
  the eager pick takes) and the EMA (row 3).  On a CUDA device it is
  captured once into a CUDA graph (one a device, kept by the node of
  the cached executable) after one warm-up run on a side stream, so
  kernel builds, ``cudaFuncSetAttribute`` and first allocations happen
  outside the capture; later calls copy their inputs into the graph's
  static inputs, replay it, and clone the outputs out of the graph's
  pool before a frame holds them (the next replay overwrites the pool).
  On the CPU the same function runs uncaptured.

So the result is bitwise the op-by-op chain's, on the card and on the
CPU.  A guard that fails makes :func:`run` return None, and the
executor replays the chain op by op (still planned and cached).  A mesh
that spans several processes runs op by op too: its gloo collectives
cannot be captured (the optimizer notes it on the node).

A node's graphs are shared by every caller of its cached executable,
so one lock a node covers the whole copy-in, replay and clone-out (and
a capture): two threads replaying one plan take turns, and an eviction
(:func:`release`) waits for the replay in flight before it frees the
graph.

Launch counting: a wrapper counts a launch when it returns
(``ops.cuda_lib.check``), so the warm-up and the capture count and a
replay counts nothing; the plan cache counts captures and replays
(``graph_captures`` / ``graph_replays``).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from tempo_tpu_torch import config, packing
from tempo_tpu_torch.plan import ir

logger = logging.getLogger(__name__)

_STATS = packing.RANGE_STATS


# ----------------------------------------------------------------------
# CUDA-graph capture of a device segment
# ----------------------------------------------------------------------

class Captured:
    """One device segment captured into a CUDA graph: its static inputs,
    the graph, its static outputs and the bytes its private pool holds
    (:func:`graph_pool_bytes`)."""

    def __init__(self, key, device, static_in, graph, static_out,
                 pool_bytes: int, keep=None):
        self.key = key
        self.device = device
        self.static_in = static_in
        self.graph = graph
        self.static_out = static_out
        self.pool_bytes = int(pool_bytes)
        self.keep = keep          # a host object the key names by identity
        self.template = None      # what a caller rebuilds its result from
        self.done = None          # event after the last replay's clones

    def replay(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Copy ``inputs`` in, replay, clone the outputs out, on the
        caller's stream, after the last replay's clones (which another
        thread may have queued on its own stream); the caller holds the
        node's graph lock (:func:`run_segment`)."""
        from tempo_tpu_torch.plan.cache import CACHE

        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if self.done is not None:
                stream.wait_event(self.done)
            for dst, src in zip(self.static_in, inputs):
                dst.copy_(src)
            self.graph.replay()
            CACHE.count_graph("replay")
            out = [o.clone() for o in self.static_out]
            self.done = torch.cuda.Event()
            self.done.record(stream)
            return out

    def nbytes(self) -> int:
        """Bytes the graph keeps on the card: its pool and its static
        inputs (clones outside the pool)."""
        return self.pool_bytes + sum(t.numel() * t.element_size()
                                     for t in self.static_in or ())

    def free(self) -> None:
        if self.done is not None:         # the last replay has ended
            self.done.synchronize()
        self.graph = self.template = self.done = None
        self.static_in = self.static_out = None


#: One capture at a time in the process (see :func:`capture`).
_CAPTURE_LOCK = threading.Lock()


def capture(key, device, fn: Callable, inputs: Sequence[torch.Tensor],
            keep=None) -> Captured:
    """``fn(*inputs)`` captured into a CUDA graph over clones of
    ``inputs`` (its static inputs), after one warm-up run on a side
    stream: kernel builds, ``cudaFuncSetAttribute`` and first
    allocations happen outside the capture.

    Other threads may launch, allocate and synchronise while a capture
    runs (the query service's workers, the cohort executors, the
    standing engine's delivery worker).  Two things keep that safe:

    * the capture runs in ``"thread_local"`` mode, so a potentially
      unsafe CUDA call (a ``cudaMalloc``, a synchronisation, a pageable
      copy) is refused only on the capturing thread, whose body is the
      step function alone; in PyTorch's default ``"global"`` mode the
      same call on any other thread would invalidate the capture.  The
      capture stream is a non-blocking stream from PyTorch's pool, so
      work other threads queue on the legacy default stream never joins
      the capture either, and the caching allocator routes only the
      capture stream's allocations to the graph's private pool;
    * :data:`_CAPTURE_LOCK` lets one capture run at a time: the
      ``torch.cuda.graph`` default capture stream is shared by the whole
      process, and the device-wide synchronise before the capture must
      not land inside another thread's capture.

    A capture that fails raises to its caller (a service ticket, a
    cohort dispatch); nothing falls back to eager execution.

    The graph keeps its node graph (``keep_graph=True``, instantiated
    here before the first replay), so ``profiling.graph_nodes`` can walk
    what the capture recorded (the compiled contracts read it)."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        static_in = [t.clone() for t in inputs]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*static_in)            # warm-up, outside the capture
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = list(fn(*static_in))
        graph.instantiate()
        pool = graph_pool_bytes(graph, device)
    return Captured(key, device, static_in, graph, static_out, pool, keep)


def graph_pool_bytes(graph, device) -> int:
    """Bytes of the memory segments the caching allocator holds for a
    captured graph's private pool."""
    pool = tuple(graph.pool())
    return int(sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if seg.get("device") == torch.device(device).index
                   and tuple(seg.get("segment_pool_id", ())) == pool))


def _graph_lock(node: ir.Node) -> threading.Lock:
    # dict.setdefault is atomic: concurrent callers get the same lock
    return node.objs.setdefault("_graph_lock", threading.Lock())


def run_segment(node: ir.Node, device: torch.device, key,
                fn: Callable, inputs: Sequence[torch.Tensor],
                keep=None, remember: Optional[Callable] = None):
    """``(outputs, template)`` of ``fn(*inputs)`` (a list of tensors on
    ``device``): uncaptured on the CPU (template None); on a CUDA device
    through the graph the node keeps for that device, captured first
    when there is none, or its ``key`` (shapes, knobs, host decisions)
    differs, or ``keep`` is another object than the one it was captured
    with; then replayed.  ``remember()``, called just after a capture,
    gives the template the graph keeps for its callers."""
    from tempo_tpu_torch.plan.cache import CACHE

    if device.type != "cuda":
        return list(fn(*inputs)), None
    with _graph_lock(node):
        slots: Dict[str, Captured] = node.objs.setdefault("_graphs", {})
        ent = slots.get(str(device))
        if ent is None or ent.key != key or ent.keep is not keep:
            if ent is not None:
                ent.free()
            ent = slots[str(device)] = capture(key, device, fn, inputs,
                                               keep)
            if remember is not None:
                ent.template = remember()
            CACHE.count_graph("capture")
        return ent.replay(inputs), ent.template


def release(node: ir.Node) -> None:
    """Free the graphs a node captured (cache eviction), once the replay
    in flight, if any, has ended."""
    if "_graphs" not in node.objs:
        return
    with _graph_lock(node):
        for ent in (node.objs.pop("_graphs", None) or {}).values():
            ent.free()


def graph_bytes(node: ir.Node) -> Dict[str, int]:
    """Bytes the node's captured graphs keep on each card, by device."""
    slots = node.objs.get("_graphs") or {}
    return {d: e.nbytes() for d, e in list(slots.items())
            if e.graph is not None}


def pool_bytes(node: ir.Node) -> Optional[int]:
    """Bytes the node's captured graphs' pools hold, None uncaptured."""
    slots = node.objs.get("_graphs") or {}
    if not slots:
        return None
    return sum(e.pool_bytes for e in list(slots.values()))


def by_device(devices: Sequence[torch.device]) -> Dict[torch.device, list]:
    """Shard indices grouped by their device, in shard order."""
    out: Dict[torch.device, list] = {}
    for i, d in enumerate(devices):
        out.setdefault(torch.device(d), []).append(i)
    return out


# ----------------------------------------------------------------------
# The fused mesh chain
# ----------------------------------------------------------------------

def _fusible_frames(dl, dr) -> bool:
    from tempo_tpu_torch.dist import DistributedTSDF

    if not (isinstance(dl, DistributedTSDF)
            and isinstance(dr, DistributedTSDF)):
        return False
    if dl.mesh != dr.mesh or dl.mesh.n_processes > 1:
        return False
    if any(size != 1 for name, size in dl.mesh.shape.items()
           if name != dl.series_axis):
        return False
    if dl.time_axis is not None or dr.time_axis is not None:
        return False
    if isinstance(dl.series_axis, tuple) or dl.series_axis != dr.series_axis:
        return False
    if dl.partitionCols != dr.partitionCols:
        return False
    if dr.seq is not None or dl.resampled or dr.resampled:
        return False
    if dr.host_cols:
        return False
    plain = lambda cols: all(c.ts_chunk is None and c.host_gather is None
                             for c in cols.values())
    return (plain(dl.cols) and plain(dr.cols)
            and len(dl.cols) > 0 and len(dr.cols) > 0)


class _Chain:
    """The host half of one fused call: the column routing, the aligned
    right stacks and the device function of a shard."""

    def __init__(self, dl, dr, node: ir.Node):
        from tempo_tpu_torch import dist
        from tempo_tpu_torch.parallel.mesh import shard_map, unzip

        p = node.param
        self.dl, self.dr = dl, dr
        lp = p("j_left_prefix")
        self.rp = p("j_right_prefix") or "right"
        self.rename = (lambda c: f"{lp}_{c}") if lp else (lambda c: c)
        self.l_names = list(dl.cols)
        self.r_names = list(dr.cols)
        joined = {self.rename(c): ("l", i)
                  for i, c in enumerate(self.l_names)}
        joined.update({f"{self.rp}_{c}": ("r", i)
                       for i, c in enumerate(self.r_names)})
        self.s_cols = list(p("s_cols") or joined)
        self.ok = all(c in joined for c in self.s_cols)
        self.srcs = tuple(joined.get(c) for c in self.s_cols)
        self.ema_src = None
        if p("has_ema"):
            self.ok = self.ok and p("e_col") in joined
            self.ema_src = joined.get(p("e_col"))
        if not self.ok:
            return
        self.w = float(p("s_window", 1000))
        self.engine, self.rowbounds = dl._range_engine_choice(self.w)
        self.alpha = float(p("e_exp_factor", 0.2) or 0.2)
        self.exact = bool(p("e_exact", False))
        self.n_taps = (int(p("e_window", 30) or 0)
                       + (1 if p("e_inclusive") else 0))
        # the eager join's right stacks, aligned to the left's series
        # (host index plans and copies: outside the graph)
        perm, okk = dist._key_perm(dl.layout.key_frame,
                                   dr.layout.key_frame, dl.partitionCols,
                                   dl.K_dev)
        mesh, axes = dl.mesh, dl.series_axis
        n, dt = len(self.r_names), dl.dtype

        def right_stacks(ts, mask, *rest):
            vals, valids = rest[:n], rest[n:2 * n]
            planes = list(vals) + [((ts >> shift) & ((1 << 21) - 1)).to(dt)
                                   for shift in (42, 21, 0)]
            return (torch.stack(planes),
                    torch.stack(list(valids) + [mask] * 3))

        pstack, vstack = unzip(shard_map(
            right_stacks, mesh, dr.ts, dr.mask,
            *[dr.cols[c].values for c in self.r_names],
            *[dr.cols[c].valid for c in self.r_names], axis=axes))

        def align(shards, fill, row_axis=0):
            return dist._align_rows(mesh, shards, axes, axes, perm, okk,
                                    fill, row_axis)

        self.pstack = align(pstack, float("nan"), row_axis=1)
        self.vstack = align(vstack, False, row_axis=1)
        self.r_ts = align(dr.ts, int(packing.TS_PAD))

    def inputs(self, i: int) -> List[torch.Tensor]:
        """Shard ``i``'s device inputs, in :meth:`device_fn` order."""
        dl = self.dl
        return ([dl.ts[i], dl.mask[i], self.r_ts[i], self.vstack[i],
                 self.pstack[i]]
                + [dl.cols[c].values[i] for c in self.l_names]
                + [dl.cols[c].valid[i] for c in self.l_names])

    def device_fn(self, *t: torch.Tensor) -> List[torch.Tensor]:
        """One shard's chain: the eager join, stats and EMA calls."""
        from tempo_tpu_torch.dist import _range_stats_shard
        from tempo_tpu_torch.ops import rolling as rk
        from tempo_tpu_torch.ops import sortmerge as sm

        n_l = len(self.l_names)
        l_ts, l_mask, r_ts, vstack, pstack = t[:5]
        lvals, lvalids = t[5:5 + n_l], t[5 + n_l:5 + 2 * n_l]
        vals, found, _ = sm.asof_merge_values(l_ts, r_ts, vstack, pstack,
                                              r_seq=None, max_lookback=0)
        masked = [torch.where(found[i], vals[i], float("nan"))
                  for i in range(len(self.r_names))]

        def plane(src):
            side, i = src
            if side == "l":
                return lvals[i], lvalids[i]
            return masked[i], found[i]

        xs = torch.stack([plane(s)[0] for s in self.srcs])
        vs = torch.stack([plane(s)[1] for s in self.srcs])
        stats, clipped = _range_stats_shard(l_ts, xs, vs & l_mask, self.w,
                                            self.rowbounds, self.engine)
        out = [vals, found] + masked + [stats[k] for k in _STATS] + [clipped]
        if self.ema_src is not None:
            x, v = plane(self.ema_src)
            out.append(rk.ema_exact(x, v, self.alpha) if self.exact
                       else rk.ema_compat(x, v, self.n_taps, self.alpha))
        return out

    def key(self, inputs: Sequence[torch.Tensor]) -> tuple:
        return (self.srcs, self.w, self.engine, self.rowbounds,
                self.ema_src, self.alpha, self.exact, self.n_taps,
                tuple((tuple(x.shape), x.dtype) for x in inputs),
                config.snapshot())

    def groups(self):
        """For each device: its shard indices, their inputs in one flat
        list, and the device function of all of them."""
        for dev, idx in by_device(self.dl.devices).items():
            flat = [x for i in idx for x in self.inputs(i)]
            width = len(flat) // len(idx)

            def fn(*t, n=len(idx), width=width):
                res = []
                for j in range(n):
                    res += self.device_fn(*t[j * width:(j + 1) * width])
                return res

            yield dev, idx, flat, fn

    def per_shard(self, node: ir.Node):
        """Each shard's device outputs (one graph a device)."""
        from tempo_tpu_torch.parallel.mesh import device_guard

        out: List[Optional[list]] = [None] * len(self.dl.devices)
        for dev, idx, flat, fn in self.groups():
            with device_guard(dev):
                got, _ = run_segment(node, dev, self.key(flat), fn, flat)
            per = len(got) // len(idx)
            for j, i in enumerate(idx):
                out[i] = got[j * per:(j + 1) * per]
        return out


def run(dl, dr, node: ir.Node):
    """Execute the fused node over two DistributedTSDFs, or None when a
    run-time guard fails (the executor then runs the chain op by op)."""
    from tempo_tpu_torch.dist import DistCol

    if not _fusible_frames(dl, dr):
        return None
    ch = _Chain(dl, dr, node)
    if not ch.ok:
        return None
    outs = ch.per_shard(node)
    n = len(ch.r_names)
    col = lambda k: [o[k] for o in outs]
    new_cols = {ch.rename(c): c_ for c, c_ in dl.cols.items()}
    new_host = {ch.rename(c): src for c, src in dl.host_cols.items()}
    found = [o[1] for o in outs]
    for i, c in enumerate(ch.r_names):
        new_cols[f"{ch.rp}_{c}"] = DistCol(
            col(2 + i), [f[i] for f in found], int64=dr.cols[c].int64)
    rts_name = f"{ch.rp}_{dr.ts_col}"
    for j, shift in enumerate((42, 21, 0)):
        new_cols[f"__{rts_name}__c{j}"] = DistCol(
            [o[0][n + j] for o in outs], [f[n + j] for f in found],
            ts_chunk=(rts_name, shift))
    audits = list(dl.audits)
    base = 2 + n
    clipped = col(base + len(_STATS))
    for ci, c in enumerate(ch.s_cols):
        if ch.rowbounds is not None:
            audits.append((
                f"withRangeStats({c}): %d rows had window frames "
                f"extending past the static row bounds {ch.rowbounds}; "
                f"this is a tempo_tpu_torch bug",
                [cl[ci] for cl in clipped]))
        for ki, stat in enumerate(_STATS):
            new_cols[f"{stat}_{c}"] = DistCol(
                [s[ci] for s in col(base + ki)], dl.mask,
                int64=(stat == "count"))
    if ch.ema_src is not None:
        new_cols["EMA_" + node.param("e_col")] = DistCol(
            col(base + len(_STATS) + 1), dl.mask)
    return dl._with(cols=new_cols, audits=audits, host_cols=new_host,
                    ts_col=ch.rename(dl.ts_col), seq=None, seq_col="")


def compiled_cost(dl, dr, node: ir.Node) -> Optional[Dict[str, object]]:
    """What the card states of the fused segment over these frames (the
    ``explain(cost=True)`` numbers): ``profiling.compiled_cost`` of each
    device's part, summed (argument and output bytes; on a CUDA device
    the captured graph's pool bytes as ``temp_bytes``)."""
    from tempo_tpu_torch import profiling
    from tempo_tpu_torch.parallel.mesh import device_guard

    if not _fusible_frames(dl, dr):
        return None
    ch = _Chain(dl, dr, node)
    if not ch.ok:
        return None
    total: Dict[str, object] = {}
    for dev, _, flat, fn in ch.groups():
        with device_guard(dev):
            got = profiling.compiled_cost(fn, *flat)
        for k, v in got.items():
            if v is None:
                total.setdefault(k, None)
            else:
                total[k] = (total.get(k) or 0) + v
    return total
