"""The standing-query split pass: one registered plan, two programs.

Counterpart of ``tempo_tpu/query/split.py``.  ``canonicalize`` rewrites
every host-side ``EMA(exact=True)`` node into the ``ema_stream`` IR op,
whose batch kernel is ``ops/scan.ema_scan`` (``csrc/ema_scan.cu`` on a
card) — the sequential (one multiply-add per
element) twin of ``ema_exact`` with an explicit carry.  The sequential
form is **split-invariant bitwise** (feeding the carry across any
batch boundary reproduces the unsplit run bit-for-bit), which is the
contract the serving plane's EMA carry resumes; ``ema_exact``'s
ladder bracketing — and therefore its f32 rounding — depends on the
total length, so it cannot be resumed mid-stream.  The
canonical plan IS the registered query: ``explain()`` renders the
rewrite, and the standing results are bitwise what re-running this
canonical plan over the concatenated history produces.

``split`` then classifies the canonical plan against the incremental
surface:

* **stateless** — row-local ops only (``select`` / ``sql_project`` /
  ``sql_filter``) over one ``unified_scan``: each push's delta is the
  suffix applied to the new rows, no carry at all;
* **delta** — a run of ``ema_stream`` nodes (one shared alpha — the
  serving config carries a single EMA coefficient) or one bottom
  ``asof_join`` between two stream tables, plus a row-local suffix:
  the incremental program reuses the serve-plane carries through the
  cohort executor, its steps captured as CUDA graphs and shape-bucketed
  so the steady state builds nothing;
* **remainder** — everything else (centred/trailing window stats,
  resample, interpolate, mesh chains, seq-bearing join right sides,
  EMA above a join...): the full canonical plan re-runs over the
  unified scan on a periodic cadence — correct by construction, paid
  as a batch job.  ``StandingPlan.reason`` names what forced the
  fallback.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from tempo_tpu_torch.plan import ir
# the batch evaluation of an ``ema_stream`` node lives beside the frame's
# EMA; re-exported under the reference's name
from tempo_tpu_torch.rolling import eval_ema_stream  # noqa: F401

#: Ops whose output rows depend only on their own input row — applying
#: them to a delta frame is bitwise applying them to the same rows of
#: the concatenated history (the SQL parity gate pins planned==eager
#: for all three, so the delta path evaluates them eagerly with zero
#: compiles).
ROW_LOCAL_OPS = ("select", "sql_project", "sql_filter")

__all__ = ["canonicalize", "split", "StandingPlan", "EmaSpec",
           "JoinSpec", "eval_ema_stream", "ROW_LOCAL_OPS"]


@dataclasses.dataclass
class EmaSpec:
    col: str
    alpha: float


@dataclasses.dataclass
class JoinSpec:
    left: object                  # StreamTable
    right: object                 # StreamTable
    right_prefix: str
    skip_nulls: bool
    max_lookback: int


@dataclasses.dataclass
class StandingPlan:
    """The split decision for one registered query."""

    root: ir.Node                 # canonical plan (the registered query)
    mode: str                     # "stateless" | "delta" | "remainder"
    tables: List[object]          # every StreamTable the plan scans
    table: Optional[object] = None       # delta/stateless: driving table
    join: Optional[JoinSpec] = None      # delta join spec
    emas: List[EmaSpec] = dataclasses.field(default_factory=list)
    suffix: List[ir.Node] = dataclasses.field(default_factory=list)
    reason: str = ""              # why the remainder path, when it is

    @property
    def signature(self) -> str:
        return ir.signature(self.root)


def _on_mesh_below(node: ir.Node) -> bool:
    return any(n.op in ("on_mesh", "dist_source") for n in node.walk())


def canonicalize(root: ir.Node) -> ir.Node:
    """Rewrite host-side ``EMA(exact=True)`` nodes to ``ema_stream``
    (see module docstring).  Returns a fresh DAG; recorded nodes are
    never mutated (the caller's lazy frame stays replayable as-is)."""
    memo = {}

    def rec(n: ir.Node) -> ir.Node:
        got = memo.get(id(n))
        if got is not None:
            return got
        ins = tuple(rec(c) for c in n.inputs)
        if (n.op == "ema" and n.param("exact") is True
                and not _on_mesh_below(n)):
            out = ir.Node("ema_stream", params=dict(
                colName=n.param("colName"),
                exp_factor=float(n.param("exp_factor", 0.2))),
                inputs=ins)
        elif any(a is not b for a, b in zip(ins, n.inputs)):
            out = ir.Node(n.op, params=dict(n.params), inputs=ins,
                          payload=n.payload, objs=n.objs)
        else:
            out = n
        memo[id(n)] = out
        return out

    return rec(root)


def _table_of(node: ir.Node):
    if node.op == "unified_scan":
        return node.payload.table
    return None


def split(root: ir.Node) -> StandingPlan:
    """Classify one canonical plan (see module docstring)."""
    tables = [n.payload.table for n in root.walk()
              if n.op == "unified_scan"]

    def remainder(reason: str) -> StandingPlan:
        return StandingPlan(root=root, mode="remainder", tables=tables,
                            reason=reason)

    if not tables:
        return remainder("plan scans no StreamTable (no unified_scan "
                         "source)")

    suffix: List[ir.Node] = []
    n = root
    while n.op in ROW_LOCAL_OPS:
        suffix.append(n)
        n = n.inputs[0]
    suffix.reverse()              # application order, bottom-up

    emas: List[EmaSpec] = []
    while n.op == "ema_stream":
        emas.append(EmaSpec(col=str(n.param("colName")),
                            alpha=float(n.param("exp_factor", 0.2))))
        n = n.inputs[0]
    emas.reverse()

    if n.op == "unified_scan":
        table = n.payload.table
        if not emas:
            return StandingPlan(root=root, mode="stateless",
                                tables=tables, table=table,
                                suffix=suffix)
        cols = [e.col for e in emas]
        bad = [c for c in cols if c not in table.value_cols]
        if bad:
            return remainder(f"EMA over non-streamed column(s) {bad} "
                             f"(table {table.name!r} streams "
                             f"{table.value_cols})")
        if len(set(cols)) != len(cols):
            return remainder(f"repeated EMA column(s) in {cols}: the "
                             f"serving carry holds one EMA per column")
        alphas = {e.alpha for e in emas}
        if len(alphas) != 1:
            return remainder(f"mixed EMA alphas {sorted(alphas)}: the "
                             f"serving config carries a single "
                             f"coefficient")
        return StandingPlan(root=root, mode="delta", tables=tables,
                            table=table, emas=emas, suffix=suffix)

    if n.op == "asof_join" and not emas:
        left_n, right_n = n.inputs[0], n.inputs[1]
        left, right = _table_of(left_n), _table_of(right_n)
        if left is None or right is None:
            return remainder("asof_join over a non-StreamTable side")
        if n.param("tsPartitionVal") is not None:
            return remainder("tsPartitionVal (skew-bracketed join) is "
                             "not an incremental carry")
        if n.param("sql_join_opt"):
            return remainder("sql_join_opt (broadcast inner join) "
                             "changes row semantics; batch remainder")
        if n.param("left_prefix"):
            return remainder("left_prefix renames the left side; "
                             "batch remainder")
        if left is right:
            return remainder(
                "self-join over one stream table: each push's rows "
                "enter BOTH merged sides at once, so per-push arrival "
                "order and the batch merged order diverge; batch "
                "remainder")
        if left.sequence_col:
            return remainder(
                f"left table {left.name!r} carries a sequence column: "
                f"the batch join orders left rows NULLS-FIRST "
                f"regardless of their sequence values, so an "
                f"incremental carry honoring them would diverge "
                f"bitwise; batch remainder")
        if right.sequence_col:
            return remainder(
                f"right table {right.name!r} carries a sequence "
                f"column: the prefixed right seq output column needs "
                f"the merged-stream per-column carry; batch remainder")
        if left.partitionCols != right.partitionCols:
            return remainder("asof_join sides disagree on partition "
                             "columns")
        return StandingPlan(
            root=root, mode="delta", tables=tables, table=left,
            join=JoinSpec(
                left=left, right=right,
                right_prefix=str(n.param("right_prefix") or "right"),
                skip_nulls=bool(n.param("skipNulls", True)),
                max_lookback=int(n.param("maxLookback", 0) or 0)),
            suffix=suffix)

    return remainder(f"op {n.op!r} has no incremental carry")

