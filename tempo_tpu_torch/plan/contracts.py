"""Compiled contracts: the guarantees a production program makes about
what it really runs, declared next to the programs and checked by
``plan/contract_rules.py`` (``python -m tempo_tpu_torch.plan.contracts``).

Counterpart of ``tempo_tpu/plan/contracts.py``, which checks the
optimized HLO of each program XLA compiled.  The port compiles nothing;
what stands in for the HLO is

* the **record** of one run of the program at its contract shape
  (``profiling.record_program``: every aten op with the types and shapes
  of its outputs, every scalar read and copy to the CPU, and the bytes
  ``parallel/mesh.transfer`` moves between distinct mesh entries, by
  kind), on the card and on the CPU alike;
* on the card, the **captured CUDA graph** of each program that
  production replays as one (``plan/fused.capture``: the fused and
  service nodes, serving's steps, the cohort and standing planes),
  walked node by node through libcuda (``profiling.graph_nodes``):
  its kernels by name, its copies by direction;
* the **placements** of the program's inputs and outputs (each shard's
  mesh entry and block, ``parallel/mesh.block_slices``), which the
  chain rule holds stage to stage.

Each registry entry builds the port's counterpart of one reference
program at the reference's contract shape: [``CONTRACT_SERIES``,
:func:`contract_lanes`] from the same seeds, on a mesh of eight entries
of one device (the counterpart of the reference's eight virtual host
devices).  Where the reference models a collective and the port moves
the bytes differently, the port's contract states what the port's
program moves, and its builder's docstring names the difference.

The registry (reference program -> port program):

==============================  =======================================
``fused.asof_stats_ema``        the fused node's device part
                                (``plan/fused._Chain.device_fn``)
                                through ``run_segment``: one graph
``plan.mesh_chain``             ``dist._align_rows`` -> the shard join
                                -> ``dist._range_stats_shard`` -> the
                                EMA, and their ``Chain``
``serve.step``                  ``serve/state.StepExecutable`` (push)
``serve.cohort_step``           the cohort push and query steps over an
                                8-entry stream mesh (``ShardedStep``)
                                and the ``serve.cohort_loop`` chain
``service.dispatch``            the service's cached fused dispatch at
                                its two canonical shapes
``dist.range_stats_windowed``   ``_range_stats_shard`` without row
                                bounds (rank + ``cumsum3`` kernels)
``halo.*``                      ``parallel/halo.py``'s three programs
``reshard.*``                   the two all-to-all switches and
                                ``dist.reshard_frame``
``engine.*``                    the merge join's row walk and tiles,
                                range stats' row-bounded kernel, the
                                windowed form, the lookback kernel
``standing.step``               the standing plane's push step
``standing.unified_scan``       ``ops.scan.ema_scan`` at float32
==============================  =======================================

The reference gates ``engine.join_chunked`` to a TPU; here it is an
ordinary entry.  Suppression keeps the reference's convention: a
``# lint-ok: <rule>: <reason>`` comment on (or next to) a builder's
``@register`` line silences that rule for its programs.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: series count of every contract shape: one series a mesh entry
CONTRACT_SERIES = 8

#: static row bounds of the row-bounded range engine's programs (the
#: reference's: ticks every 1-2 s, a 10 s window)
CONTRACT_ROWBOUNDS = (20, 8)

_WINDOW_SECS = 10.0
_HALO = 4


def contract_lanes() -> int:
    """``TEMPO_TPU_CONTRACT_LANES``: padded lanes L of every contract
    shape (default 32, clamped to [16, 4096])."""
    from tempo_tpu_torch import config

    n = config.get_int("TEMPO_TPU_CONTRACT_LANES", 32) or 32
    return max(16, min(int(n), 4096))


class ContractUsageError(RuntimeError):
    """A contract the port cannot check (one that declares donation):
    the runner's usage error, not a finding."""


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declared guarantees of one program.

    * ``collectives``: the kinds of move between distinct mesh entries
      the program must make, with their modeled bytes: the record must
      show each kind with ``model <= measured <= tol * model`` (``tol``
      from ``profiling.COLLECTIVE_TOLERANCE``, or ``tolerances``); a
      declared kind that vanished fails too.
    * ``incidental``: kinds allowed up to a byte ceiling without a
      model; any other kind in the record is unmodeled.
    * ``allow_f64``: float64 outputs tolerated.
    * ``host_transfer_ok``: a declared barrier's reason; None bans scalar
      reads, copies to the CPU and graph nodes with a host end.

    The reference's ``donate_argnums`` has no counterpart (a replay
    copies every input into the graph's static inputs, so no caller's
    tensor is aliased): a contract that declares one is a usage error.
    """

    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    incidental: Dict[str, int] = dataclasses.field(default_factory=dict)
    tolerances: Dict[str, float] = dataclasses.field(default_factory=dict)
    donate_argnums: Tuple[int, ...] = ()
    allow_f64: bool = False
    host_transfer_ok: Optional[str] = None

    def __post_init__(self):
        if self.donate_argnums:
            raise ContractUsageError(
                "donate_argnums has no counterpart in the port: a replay "
                "copies each input into the graph's static input, so no "
                "caller's tensor is ever aliased")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one input or output of a program lives: each shard's mesh
    entry and its block of the global array (``mesh.block_slices``)."""

    entries: Tuple[int, ...]
    blocks: Tuple[Tuple[slice, ...], ...]


def placement(mesh, spec: Sequence, shape: Sequence[int], axis) -> Placement:
    """The placement of a global array of ``shape`` laid out by ``spec``
    in a program run once a shard of ``mesh``'s ``axis`` (the spec's
    axes among the program's): shard ``i`` lives on the ``i``-th entry
    along ``axis`` and holds the block its coordinates pick."""
    from tempo_tpu_torch.parallel.mesh import block_slices, spec_axes

    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    blocks = block_slices(mesh, spec, shape)
    s_axes = spec_axes(spec)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for f in range(int(np.prod(sizes))):
        coord = dict(zip(axes, np.unravel_index(f, sizes)))
        b = (int(np.ravel_multi_index([coord[a] for a in s_axes],
                                      [mesh.shape[a] for a in s_axes]))
             if s_axes else 0)
        out.append(blocks[b])
    return Placement(tuple(mesh.axis_entries(axes)), tuple(out))


@dataclasses.dataclass
class CompiledProgram:
    """One built registry entry: the record of its run, its contract,
    the captured graph(s) production replays (``plan.fused.Captured``,
    a list for a program of one graph a shard, None where it runs
    eagerly or on the CPU), the placements of its inputs and outputs,
    and its builder's source site (for ``# lint-ok``)."""

    name: str
    record: object                    # profiling.ProgramRecord
    contract: Contract
    graph: object = None
    inputs: Tuple[Placement, ...] = ()
    outputs: Tuple[Placement, ...] = ()
    source_file: str = ""
    source_line: int = 0
    _nodes: Optional[List[dict]] = dataclasses.field(default=None,
                                                     repr=False)

    def graphs(self) -> list:
        if self.graph is None:
            return []
        return list(self.graph) if isinstance(self.graph, (list, tuple)) \
            else [self.graph]

    def graph_nodes(self) -> List[dict]:
        """The walked nodes of every graph of the program, read once and
        shared by every rule."""
        if self._nodes is None:
            from tempo_tpu_torch import profiling

            self._nodes = [n for g in self.graphs()
                           for n in profiling.graph_nodes(g)]
        return self._nodes

    def kernels(self) -> List[str]:
        """Names of the program's kernel nodes (each once)."""
        from tempo_tpu_torch import profiling

        return profiling.graph_summary(self.graph_nodes())["kernels"]


@dataclasses.dataclass(frozen=True)
class Link:
    """One declared stage boundary: output ``out_idx`` of ``producer``
    feeds input ``in_idx`` of ``consumer``; ``drop_leading`` leading axes
    of the producer's value are sliced away on the host first (they must
    be unsharded)."""

    producer: str
    out_idx: int
    consumer: str
    in_idx: int
    drop_leading: int = 0


@dataclasses.dataclass
class Chain:
    """Declared stage wiring; the registry stamps the declaring
    builder's ``@register`` site, so chain findings honour ``# lint-ok``
    there too."""

    name: str
    links: Tuple[Link, ...]
    source_file: str = ""
    source_line: int = 0


# ----------------------------------------------------------------------
# Registry machinery
# ----------------------------------------------------------------------

_BUILDERS: Dict[str, Callable] = {}
_DEVICE = torch.device("cpu")


def register(name: str):
    """Declare a contract builder: it returns ``(programs, chains)`` (a
    bare :class:`CompiledProgram` also works) and runs in
    :func:`build_all`."""

    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


def names() -> List[str]:
    return list(_BUILDERS)


def _normalize(name: str, result) -> Tuple[List[CompiledProgram],
                                           List[Chain]]:
    if isinstance(result, CompiledProgram):
        programs, chains = [result], []
    else:
        programs, chains = result
    fn = _BUILDERS[name]
    try:
        src = inspect.getsourcefile(fn) or ""
        line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):  # builders defined in a REPL/exec
        src, line = "", 0
    for p in list(programs) + list(chains):
        p.source_file, p.source_line = src, line
    return list(programs), list(chains)


def check_preconditions() -> None:
    """Raise ``RuntimeError`` unless the programs would be the card's
    production forms: ``TEMPO_TPU_COMPUTE_DTYPE=float32`` (the port's
    CPU default is float64, which would make the f64 check vacuous) and
    the sort kernels on (``TEMPO_TPU_SORT_KERNELS`` unset or 1: ``0``
    sends every ``withRangeStats`` to the windowed form, off the
    row-bounded kernels production runs, the same production forms the
    reference's precondition selects)."""
    from tempo_tpu_torch import config
    from tempo_tpu_torch.ops.sortmerge import use_sort_kernels

    if (config.get("TEMPO_TPU_COMPUTE_DTYPE") or "") != "float32":
        raise RuntimeError(
            "compiled contracts check the card's production programs: "
            "set TEMPO_TPU_COMPUTE_DTYPE=float32 (python -m "
            "tempo_tpu_torch.plan.contracts does) before building")
    if not use_sort_kernels():
        raise RuntimeError(
            "compiled contracts check the card's production programs: "
            "unset TEMPO_TPU_SORT_KERNELS or set it to 1")


def build_all(only: Optional[Sequence[str]] = None, device=None):
    """Build the registry (or the named subset) on ``device`` (default
    the current CUDA device; ``"cpu"`` runs the plain versions and
    captures nothing).  Returns ``(programs, chains, errors)``, where
    ``errors`` maps a builder's name to its exception (a failed build is
    a finding, not a crash).  Raises ``RuntimeError`` when a precondition
    fails (:func:`check_preconditions`, no CUDA device, a
    :class:`ContractUsageError`) and ``KeyError`` for an unknown name."""
    global _DEVICE
    from tempo_tpu_torch import device as device_policy
    from tempo_tpu_torch import plan

    check_preconditions()
    dev = device_policy.resolve("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    wanted = list(only) if only else names()
    unknown = [n for n in wanted if n not in _BUILDERS]
    if unknown:
        raise KeyError(f"unknown contract program(s): {unknown} "
                       f"(known: {sorted(_BUILDERS)})")
    programs: List[CompiledProgram] = []
    chains: List[Chain] = []
    errors: Dict[str, str] = {}
    _DEVICE = dev
    for name in wanted:
        try:
            with plan.suspended():
                ps, cs = _normalize(name, _BUILDERS[name]())
        except ContractUsageError:
            raise
        except Exception as e:  # noqa: BLE001 - reported as build-error
            errors[name] = f"{type(e).__name__}: {e}"
            continue
        programs.extend(ps)
        chains.extend(cs)
    return programs, chains, errors


# ----------------------------------------------------------------------
# Shared builder plumbing
# ----------------------------------------------------------------------

def _nbytes(*arrays) -> int:
    return int(sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
                   else a.size * a.dtype.itemsize for a in arrays))


def _entries(n: int = CONTRACT_SERIES) -> list:
    return [_DEVICE] * n


def _series_mesh():
    from tempo_tpu_torch.parallel import make_mesh

    return make_mesh({"series": CONTRACT_SERIES}, devices=_entries())


def _grid_mesh():
    from tempo_tpu_torch.parallel import make_mesh

    return make_mesh({"series": CONTRACT_SERIES // 2, "time": 2},
                     devices=_entries())


def _arrays(n_cols: int = 2, seed: int = 0) -> dict:
    """The reference's representative operands, from its seed: [K, L]
    int64 ns timestamps (1-2 s ticks), float32 values, all-true
    validity, and [C, K, L] right values and validity."""
    K, L = CONTRACT_SERIES, contract_lanes()
    rng = np.random.default_rng(seed)
    secs = np.cumsum(rng.integers(1, 3, size=(K, L)), axis=-1)
    ts = secs.astype(np.int64) * np.int64(1_000_000_000)
    x = rng.standard_normal((K, L)).astype(np.float32)
    valid = np.ones((K, L), dtype=bool)
    rv = rng.standard_normal((n_cols, K, L)).astype(np.float32)
    rvd = rng.random((n_cols, K, L)) > 0.1
    return dict(ts=ts, x=x, valid=valid, rvals=rv, rvalids=rvd)


def _tensors(a: dict) -> dict:
    """The operands whole on the build device."""
    return {k: torch.from_numpy(v).to(_DEVICE) for k, v in a.items()}


def _right_stacks(a: dict):
    """The fused chain's right stacks: the value planes and the three
    21-bit chunks of the timestamps as float32 planes, and their
    validity (``plan/fused._Chain``'s ``right_stacks``)."""
    ts = a["ts"]
    chunks = [((ts >> s) & ((1 << 21) - 1)).astype(np.float32)
              for s in (42, 21, 0)]
    planes = np.concatenate([a["rvals"], np.stack(chunks)])
    vstack = np.concatenate([a["rvalids"], np.stack([a["valid"]] * 3)])
    return planes, vstack


def _record(fn, *args):
    """``(record, outputs)`` of one run of ``fn(*args)``."""
    from tempo_tpu_torch import profiling

    with profiling.record_program() as rec:
        out = fn(*args)
    return rec, out


def _on_card() -> bool:
    return _DEVICE.type == "cuda"


def _frames(mesh, left_cols=("x",), right_cols=("r0", "r1"),
            time_axis=None):
    """The operands as a left and a right ``DistributedTSDF`` (series
    ``user`` 0..K-1; a right value is null where its validity is False)
    on ``mesh``."""
    import pandas as pd

    from tempo_tpu_torch import TSDF

    a = _arrays()
    K, L = a["ts"].shape
    user = np.repeat(np.arange(K), L)
    ts = pd.to_datetime(a["ts"].reshape(-1), unit="ns")
    left = pd.DataFrame({"user": user, "event_ts": ts})
    for c in left_cols:
        left[c] = a["x"].reshape(-1)
    right = pd.DataFrame({"user": user, "event_ts": ts})
    for i, c in enumerate(right_cols):
        right[c] = np.where(a["rvalids"][i], a["rvals"][i],
                            np.nan).reshape(-1)
    side = lambda df: TSDF(df, "event_ts", ["user"], device=_DEVICE) \
        .on_mesh(mesh, time_axis=time_axis)
    return side(left), side(right)


def _fused_program(name: str, s_cols, ema_col=None) -> CompiledProgram:
    """One fused node's device part over the contract frames: recorded
    once, and on the card captured through ``run_segment`` as the
    executor captures it (the graph the node keeps)."""
    from tempo_tpu_torch.plan import fused, ir

    mesh = _series_mesh()
    dl, dr = _frames(mesh)
    params = dict(j_left_prefix=None, j_right_prefix="right",
                  s_cols=tuple(s_cols), s_window=_WINDOW_SECS,
                  has_ema=ema_col is not None)
    if ema_col is not None:
        params.update(e_col=ema_col, e_exp_factor=0.2, e_exact=True)
    node = ir.Node("fused_asof_stats_ema", params=params)
    ch = fused._Chain(dl, dr, node)
    if not ch.ok:
        raise RuntimeError(f"{name}: the contract frames do not fuse")
    ((dev, _, flat, fn),) = list(ch.groups())
    rec, _ = _record(fn, *flat)
    graph = None
    if _on_card():
        fused.run_segment(node, dev, ch.key(flat), fn, flat)
        graph = node.objs["_graphs"][str(dev)]
    return CompiledProgram(name, rec, Contract(), graph)


# ----------------------------------------------------------------------
# The production-program registry
# ----------------------------------------------------------------------

@register("fused.asof_stats_ema")
def _build_fused():
    """The fused node's device part (stats over x, right_r0 and
    right_r1; the exact EMA of x), one graph over the eight shards of
    the device.  The reference models the right stacks' key alignment
    as an all-gather inside its program; here the alignment
    (``dist._align_rows``) runs in the node's host preparation, outside
    the graph (``plan/fused.py``'s ``_Chain``), and is held by
    ``dist.align3``; the graph moves nothing between entries.  The
    reference's clipped-count all-reduce is a per-shard sum here."""
    return _fused_program("fused.asof_stats_ema",
                          ("x", "right_r0", "right_r1"), ema_col="x")


@register("plan.mesh_chain")
def _build_mesh_chain():
    """The eager mesh chain as four stages and their ``Chain``: the
    right planes' alignment (``dist._align_rows``), the shard join,
    the shard's range stats (row-bounded at ``CONTRACT_ROWBOUNDS``) and
    the EMA.  The alignment moves only the rows a shard lacks; the
    contract's keys are rotated by one series, so every row crosses
    entries and the moved bytes are the reference's all-gather model,
    the right planes' bytes (the reference keeps the keys in place and
    gathers whole rows regardless)."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.ops import rolling as rk
    from tempo_tpu_torch.ops import sortmerge as sm
    from tempo_tpu_torch.parallel.mesh import place

    mesh = _series_mesh()
    a = _arrays()
    planes, vstack = _right_stacks(a)
    K, L = a["ts"].shape
    s2, s3 = ("series", None), (None, "series", None)
    ts = place(a["ts"], mesh, s2)
    pl, vs = place(planes, mesh, s3), place(vstack, mesh, s3)
    perm = (np.arange(K) + 1) % K
    ok = np.ones(K, bool)
    at = lambda spec, shape: placement(mesh, spec, shape, "series")
    P3, P2 = at(s3, planes.shape), at(s2, (K, L))

    rec_a, aligned = _record(lambda: dist._align_rows(
        mesh, pl, "series", "series", perm, ok, float("nan"), row_axis=1))
    align = CompiledProgram(
        "dist.align3", rec_a,
        Contract(collectives={"all-gather": _nbytes(planes)}),
        inputs=(P3,), outputs=(P3,))

    def join():
        return [sm.asof_merge_values(lt, rt, v, p)[:2]
                for lt, rt, v, p in zip(ts, ts, vs, aligned)]

    rec_j, joined = _record(join)
    V3 = at(s3, vstack.shape)
    join_p = CompiledProgram("dist.asof_local", rec_j, Contract(),
                             inputs=(P2, P2, V3, P3), outputs=(P3, V3))

    def stats():
        return [dist._range_stats_shard(t, v, f, _WINDOW_SECS,
                                        CONTRACT_ROWBOUNDS, "shifted")[0]
                for t, (v, f) in zip(ts, joined)]

    rec_s, st = _record(stats)
    stats_p = CompiledProgram("dist.range_stats_local", rec_s, Contract(),
                              inputs=(P2, P3, V3), outputs=(P3,))
    valid = place(a["valid"], mesh, s2)
    rec_e, _ = _record(lambda: [rk.ema_exact(s["mean"][0], v, 0.2)
                                for s, v in zip(st, valid)])
    ema_p = CompiledProgram("dist.ema_local", rec_e, Contract(),
                            inputs=(P2, P2), outputs=(P2,))
    chain = Chain("plan.mesh_chain", (
        Link("dist.align3", 0, "dist.asof_local", 3),
        Link("dist.asof_local", 0, "dist.range_stats_local", 1),
        Link("dist.asof_local", 1, "dist.range_stats_local", 2),
        # a [K, L] stats plane (the column axis sliced on the host)
        Link("dist.range_stats_local", 0, "dist.ema_local", 0,
             drop_leading=1),
    ))
    return [align, join_p, stats_p, ema_p], [chain]


def _serve_cfg(**kw):
    from tempo_tpu_torch.serve import state as serve_state

    base = dict(n_series=CONTRACT_SERIES, n_cols=2, skip_nulls=True,
                max_lookback=16,
                window_ns=serve_state.window_ns(_WINDOW_SECS),
                rows_bound=8, ema_alpha=0.2)
    base.update(kw)
    return serve_state.StreamConfig(**base)


def _push_program(name: str, cfg, Lb: int) -> CompiledProgram:
    from tempo_tpu_torch.serve import state as serve_state

    example = serve_state.push_inputs(cfg, Lb, _DEVICE)
    rec, _ = _record(serve_state._push_fn(cfg, Lb), *example)
    graph = None
    if _on_card():
        graph = serve_state.StepExecutable(("contract", name), serve_state
                                           ._push_fn(cfg, Lb), _DEVICE,
                                           example).graph
    return CompiledProgram(name, rec, Contract(), graph)


@register("serve.step")
def _build_serve_step():
    """The serving push step (``serve/state.StepExecutable``: the AS-OF,
    EMA and window carries a micro-batch of 8 lanes), one graph on the
    card.  The reference pins the retired state's donation; a replay
    here copies its inputs into the graph's static inputs instead."""
    return _push_program("serve.step", _serve_cfg(), 8)


def _stream_placements(mesh, tensors, S: int) -> Tuple[Placement, ...]:
    """Each ``[S/n, ...]`` shard tensor's placement: the stream axis cut
    in contiguous slot ranges over the mesh (``dist.stream_shardings``)."""
    out = []
    for t in tensors:
        spec = ("streams",) + (None,) * (t.dim() - 1)
        out.append(placement(mesh, spec, (S,) + tuple(t.shape[1:]),
                             "streams"))
    return tuple(out)


@register("serve.cohort_step")
def _build_cohort_step():
    """The cohort push and query steps of S = 16 streams over a stream
    mesh of eight entries (``serve/state.ShardedStep``: one graph a
    shard on the card), and the ``serve.cohort_loop`` chain: the push
    step's state outputs are its own state inputs and the query's carry
    inputs.  Zero moves between entries: nothing in a step mixes
    streams."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.serve import state as serve_state

    S, Lb = 2 * CONTRACT_SERIES, 8
    cfg = _serve_cfg(n_series=4)
    mesh = dist.stream_mesh(devices=_entries())
    shards = dist.stream_shardings(mesh, "streams", S)
    n_state = len(cfg.state_names())
    programs = []
    for kind, fn, example in (
            ("cohort_push", serve_state._push_fn(cfg, Lb),
             lambda n, d: serve_state.push_inputs(cfg, Lb, d, S=n)),
            ("cohort_query", serve_state._query_fn(cfg, Lb),
             lambda n, d: serve_state.query_inputs(cfg, d, S=n))):
        ins = [example(s1 - s0, d) for d, s0, s1 in shards]
        rec, outs = _record(lambda: [fn(*i) for i in ins])
        graph = None
        if _on_card():
            make = (serve_state.cohort_push_executable
                    if kind == "cohort_push"
                    else serve_state.cohort_query_executable)
            graph = [s.graph for s in make(cfg, S, Lb, mesh=mesh).steps]
        programs.append(CompiledProgram(
            f"serve.{kind}", rec, Contract(), graph,
            inputs=_stream_placements(mesh, ins[0], S),
            outputs=_stream_placements(mesh, outs[0], S)))
    links = [Link("serve.cohort_push", i, "serve.cohort_push", i)
             for i in range(n_state)]
    # the query's inputs are the first eight carries, in state order
    links += [Link("serve.cohort_push", i, "serve.cohort_query", i)
              for i in range(8)]
    return programs, [Chain("serve.cohort_loop", tuple(links))]


@register("service.dispatch")
def _build_service_dispatch():
    """The query service's cached dispatch: a planner executable whose
    fused node replays its graph (the ``fused.asof_stats_ema`` program),
    at the service's two canonical shapes, stats over one right column
    without EMA and stats over both with the EMA of a right column.  As
    there, the key alignment runs outside the graph."""
    return [_fused_program("service.dispatch_stats", ("right_r0",)),
            _fused_program("service.dispatch_ema",
                           ("right_r0", "right_r1"), ema_col="right_r0")
            ], []


@register("dist.range_stats_windowed")
def _build_stats_windowed():
    """``_range_stats_shard`` without row bounds: the windowed form (the
    rank kernel for the window bounds, ``cumsum3`` and the sparse
    tables), eagerly a shard."""
    from tempo_tpu_torch import dist
    from tempo_tpu_torch.parallel.mesh import place

    mesh = _series_mesh()
    a = _arrays()
    ts = place(a["ts"], mesh, ("series", None))
    xs = place(a["rvals"], mesh, (None, "series", None))
    vs = place(a["rvalids"], mesh, (None, "series", None))
    rec, _ = _record(lambda: [
        dist._range_stats_shard(t, x, v, _WINDOW_SECS, None, "windowed")
        for t, x, v in zip(ts, xs, vs)])
    contract = Contract(host_transfer_ok=(
        "the eager windowed form reads its widest window back to size the "
        "sparse tables (dist._range_stats_shard); inside a capture it "
        "bounds them by the row instead"))
    return CompiledProgram("dist.range_stats_windowed", rec, contract)


def _grid_operands():
    """The operands in blocks of the series x time grid mesh."""
    from tempo_tpu_torch.parallel.mesh import place

    mesh = _grid_mesh()
    a = _arrays()
    s2, s3 = ("series", "time"), (None, "series", "time")
    put = lambda k, spec: place(a[k], mesh, spec)
    ops = dict(ts=put("ts", s2), x=put("x", s2), valid=put("valid", s2),
               rvals=put("rvals", s3), rvalids=put("rvalids", s3))
    n_s, n_t = mesh.shape["series"], mesh.shape["time"]
    return mesh, ops, n_s, n_t, CONTRACT_SERIES // n_s


@register("halo.range_stats")
def _build_halo_range_stats():
    """Halo range stats on the series x time grid (4 x 2): each block's
    left and right halos of int64 seconds, float32 x and bool validity
    cross one time boundary a series group.  The reference models each
    shard's ppermute results (both halos on every shard); here each
    move counts once, at the boundaries that exist."""
    from tempo_tpu_torch.dist import _secs
    from tempo_tpu_torch.parallel import halo as ph

    mesh, o, n_s, n_t, K_loc = _grid_operands()
    secs = [_secs(t) for t in o["ts"]]
    rec, _ = _record(lambda: ph.range_stats_time_sharded(
        mesh, secs, o["x"], o["valid"], 8.0, _HALO))
    model = n_s * (n_t - 1) * 2 * K_loc * _HALO * (8 + 4 + 1)
    contract = Contract(
        collectives={"collective-permute": model},
        host_transfer_ok=(
            "each block reads its widest window back to size the "
            "windowed form's sparse tables (parallel/halo.py)"))
    return CompiledProgram("halo.range_stats", rec, contract)


@register("halo.asof")
def _build_halo_asof():
    """The time-sharded AS-OF join: right halos (int64 keys, bool
    validity and float32 values) across each time boundary, and each
    block's published carry (a float32 [2, C, K] flag and value pair) to
    the later blocks of its series group, the reference's carry
    all-gather."""
    from tempo_tpu_torch.parallel import halo as ph

    mesh, o, n_s, n_t, K_loc = _grid_operands()
    C = int(o["rvals"][0].shape[0])
    rec, _ = _record(lambda: ph.asof_time_sharded(
        mesh, o["ts"], o["ts"], o["rvalids"], o["rvals"], _HALO))
    pairs = n_s * n_t * (n_t - 1) // 2
    contract = Contract(collectives={
        "collective-permute": n_s * (n_t - 1) * K_loc * _HALO
        * (8 + C * (1 + 4)),
        "all-gather": pairs * 2 * C * K_loc * 4})
    return CompiledProgram("halo.asof", rec, contract)


@register("halo.ema")
def _build_halo_ema():
    """The time-sharded EMA: each block's float32 (decay, value) totals
    to the later blocks of its series group (the carry all-gather)."""
    from tempo_tpu_torch.parallel import halo as ph

    mesh, o, n_s, n_t, K_loc = _grid_operands()
    rec, _ = _record(lambda: ph.ema_time_sharded(mesh, o["x"], o["valid"],
                                                 0.2))
    pairs = n_s * n_t * (n_t - 1) // 2
    return CompiledProgram("halo.ema", rec, Contract(
        collectives={"all-gather": pairs * 2 * K_loc * 4}))


def _a2a_bytes(block_bytes: int, n_blocks: int, n_t: int) -> int:
    """Bytes a tiled all-to-all over the time axis moves between distinct
    entries: every block but its own chunk."""
    return n_blocks * block_bytes * (n_t - 1) // n_t


@register("reshard.series_to_time")
def _build_reshard_s2t():
    """``all_to_all_series_to_time`` of the float32 x plane: [2, 16]
    blocks to [1, 32] full rows.  The reference models each shard's
    result; here the bytes that cross entries (a block's own chunk
    stays)."""
    from tempo_tpu_torch.parallel.reshard import all_to_all_series_to_time

    mesh, o, n_s, n_t, _ = _grid_operands()
    rec, _ = _record(lambda: all_to_all_series_to_time(o["x"], mesh))
    model = _a2a_bytes(_nbytes(o["x"][0]), n_s * n_t, n_t)
    return CompiledProgram("reshard.series_to_time", rec,
                           Contract(collectives={"all-to-all": model}))


@register("reshard.time_to_series")
def _build_reshard_t2s():
    """The inverse switch: [1, 32] full rows back to [2, 16] blocks."""
    from tempo_tpu_torch.parallel.mesh import place
    from tempo_tpu_torch.parallel.reshard import all_to_all_time_to_series

    mesh = _grid_mesh()
    x = place(_arrays()["x"], mesh, (("series", "time"), None))
    n_t = mesh.shape["time"]
    rec, _ = _record(lambda: all_to_all_time_to_series(x, mesh))
    model = _a2a_bytes(_nbytes(x[0]), len(x), n_t)
    return CompiledProgram("reshard.time_to_series", rec,
                           Contract(collectives={"all-to-all": model}))


@register("reshard.plan_node")
def _build_reshard_plan_node():
    """The planner's reshard node executor, ``dist.reshard_frame`` to the
    series-local layout, on a time-sharded frame of two right columns:
    ts, mask and each column's values and validity, one all-to-all a
    plane.  The model is ``dist.relayout_comm_bytes`` (the reference's
    per-shard figure) over the entries, less each block's own chunk."""
    from tempo_tpu_torch import dist

    mesh = _grid_mesh()
    _, d = _frames(mesh, time_axis="time")
    rec, _ = _record(lambda: dist.reshard_frame(d,
                                                dist.RESHARD_SERIES_LOCAL))
    n_t = mesh.shape["time"]
    per_shard = dist.relayout_comm_bytes(d.K_dev, d.L, len(d.cols),
                                         CONTRACT_SERIES)
    model = _a2a_bytes(per_shard, CONTRACT_SERIES, n_t)
    return CompiledProgram("reshard.plan_node", rec,
                           Contract(collectives={"all-to-all": model}))


def _join_operands():
    o = _tensors(_arrays())
    return o["ts"], o["rvalids"], o["rvals"]


def _merge_form(form: str):
    """The merge join at the whole contract shape: on the card its
    ``form`` ("walk" or "tiles") forced, on the CPU its plain version."""
    from tempo_tpu_torch.ops import merge

    ts, rvd, rv = _join_operands()
    if _on_card():
        return _record(lambda: merge.asof_merge_cuda(ts, ts, rvd, rv,
                                                     _form=form))[0]
    return _record(lambda: merge.asof_merge_values(ts, ts, rvd, rv))[0]


@register("engine.join_single")
def _build_engine_join_single():
    """The 'single' engine's merge join as its row walk
    (``asof_walk_kernel``; the plain version on the CPU)."""
    return CompiledProgram("engine.join_single", _merge_form("walk"),
                           Contract())


@register("engine.join_bitonic")
def _build_engine_join_bitonic():
    """The reference's bitonic network is its route for joins the one
    program cannot hold; the port's merge join takes its tile form there
    (the lookback kernels at ``max_lookback`` 0, for too few rows to
    fill the card or too many right columns)."""
    return CompiledProgram("engine.join_bitonic", _merge_form("tiles"),
                           Contract())


@register("engine.range_shifted")
def _build_engine_range_shifted():
    """The row-bounded range-stats kernel over int32 rebased seconds at
    ``CONTRACT_ROWBOUNDS``."""
    from tempo_tpu_torch.ops import window

    o = _tensors(_arrays())
    secs = (o["ts"] // 1_000_000_000).to(torch.int32)
    rec, _ = _record(lambda: window.range_stats(
        secs, o["x"][None], o["valid"][None], int(_WINDOW_SECS),
        *CONTRACT_ROWBOUNDS))
    return CompiledProgram("engine.range_shifted", rec, Contract())


@register("engine.range_windowed")
def _build_engine_range_windowed():
    """The windowed form (prefix sums and sparse tables over the rank
    kernel's window bounds), bounded by the row as inside a capture."""
    from tempo_tpu_torch.ops import rolling as rk

    o = _tensors(_arrays())
    secs = o["ts"] // 1_000_000_000

    def fn():
        start, end = rk.range_window_bounds(secs, _WINDOW_SECS)
        return rk.windowed_stats(o["x"], o["valid"], start, end)

    return CompiledProgram("engine.range_windowed", _record(fn)[0],
                           Contract())


@register("standing.step")
def _build_standing_step():
    """The standing plane's push step at the canonical standing config
    (one value column, the EMA carry only: no lookback, no window)."""
    return _push_program("standing.step",
                         _serve_cfg(n_cols=1, max_lookback=0,
                                    window_ns=None, ema_alpha=0.3), 8)


@register("standing.unified_scan")
def _build_standing_unified_scan():
    """The ``ema_stream`` batch kernel (``ops.scan.ema_scan`` at float32,
    ``rolling.eval_ema_stream``'s device part)."""
    from tempo_tpu_torch.ops import scan

    o = _tensors(_arrays())
    rec, _ = _record(lambda: scan.ema_scan(o["x"], o["valid"],
                                           float(np.float32(0.3))))
    return CompiledProgram("standing.unified_scan", rec, Contract())


@register("engine.join_chunked")
def _build_engine_join_chunked():
    """The ``chunked`` engine's join: the lookback kernel at
    ``max_lookback`` 0."""
    from tempo_tpu_torch.ops import merge

    ts, rvd, rv = _join_operands()
    rec, _ = _record(lambda: merge.asof_merge_lookback(ts, ts, rvd, 0, rv))
    return CompiledProgram("engine.join_chunked", rec, Contract())


if __name__ == "__main__":
    from tempo_tpu_torch.plan.contract_rules import main

    sys.exit(main())
